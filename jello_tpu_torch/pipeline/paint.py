"""Gradient paints per record and pixel, in torch: the paint math that
the plain versions of kernel B (`cuda/fine_v2.py`) and of kernels G and
H (`pipeline/fine_interp.py`) share, as the kernels share
`csrc/paint.cuh`.
"""

from __future__ import annotations

import torch

from ..pmath import rdiv, sqrt
from . import ops
from .coarse import CMD_LIN_GRAD, CMD_RAD_GRAD, CMD_SWEEP_GRAD
from .drawobjs import (
    RAD_GRAD_KIND_CIRCULAR,
    RAD_GRAD_KIND_FOCAL_ON_CIRCLE,
    RAD_GRAD_KIND_STRIP,
    RAD_GRAD_SWAPPED,
)
from .ops import F32


def extend(t, mode):
    pad = torch.clamp(t, 0.0, 1.0)
    rep = t - torch.floor(t)
    refl = torch.abs(t - 2.0 * torch.round(0.5 * t))
    return torch.where(mode == 0, pad, torch.where(mode == 1, rep, refl))


def eotf(x):
    hi = torch.exp(2.4 * torch.log(torch.clamp(x + 0.055, min=1e-6) * (1.0 / 1.055)))
    return torch.where(x <= 0.04045, x * (1.0 / 12.92), hi)


def gradient_fg(rec, stops, tile, wit):
    """Premultiplied gradient paint per record and pixel, 4 x [n, 256]
    (`tpu/fine_v2.py:216-339`, the same math as `fine_pallas.py:313-396`):
    rec [n, 16] records, stops [NR, W] the stop table, tile [n, 1] i32
    the tile each record paints, wit the width in tiles. Rows that are
    not gradient records hold unspecified finite-or-not values; callers
    select."""
    dev = rec.device
    fr = rec.view(F32)
    kind = rec[:, 0:1]
    is_lin = kind == CMD_LIN_GRAD
    is_rad = kind == CMD_RAD_GRAD
    is_grad = is_lin | is_rad | (kind == CMD_SWEEP_GRAD)

    def fu(k):
        return fr[:, k:k + 1]

    def iu(k):
        return rec[:, k:k + 1]

    one = torch.ones((), dtype=F32, device=dev)
    zero = torch.zeros((), dtype=F32, device=dev)
    p = ops.iota(256, dev)
    gx = ((tile % wit) * 16).to(F32) + (p % 16).to(F32)[None, :]
    gy = (torch.div(tile, wit, rounding_mode="floor") * 16).to(F32) + (p // 16).to(F32)[None, :]

    t_lin = fu(6) * gx + fu(7) * gy + fu(8)

    m0, m1, m2, m3 = fu(6), fu(7), fu(8), fu(9)
    xl, yl = fu(10), fu(11)
    focal_x = fu(12)
    radius = fu(13)
    kf = iu(14)
    rkind = kf & 0x7
    rflags = kf >> 3
    lxr = m0 * gx + m2 * gy + xl
    lyr = m1 * gx + m3 * gy + yl
    xx = lxr * lxr
    yy = lyr * lyr
    is_strip = rkind == RAD_GRAD_KIND_STRIP
    is_circ = rkind == RAD_GRAD_KIND_CIRCULAR
    is_foc = rkind == RAD_GRAD_KIND_FOCAL_ON_CIRCLE
    is_swapped = (rflags & RAD_GRAD_SWAPPED) != 0
    r1r = torch.where(is_circ, zero, rdiv(1.0, torch.where(radius == 0, one, radius)))
    less_scale = torch.where(is_swapped | ((1.0 - focal_x) < 0.0), -one, one)
    t_sign = torch.sign(1.0 - focal_x)
    a_s = radius - yy
    t_strip = sqrt(torch.clamp(a_s, min=0.0)) + lxr
    v_strip = (a_s >= 0.0).to(F32)
    t_foc = (xx + yy) / torch.where(lxr == 0.0, one, lxr)
    v_foc = ((t_foc >= 0.0) & (lxr != 0.0)).to(F32)
    t_big = sqrt(xx + yy) - lxr * r1r
    a_c = xx - yy
    t_cone = less_scale * sqrt(torch.clamp(a_c, min=0.0)) - lxr * r1r
    v_cone = ((a_c >= 0.0) & (t_cone >= 0.0)).to(F32)
    big = radius > 1.0
    t_rad = torch.where(is_strip, t_strip, torch.where(is_foc, t_foc,
                                                       torch.where(big, t_big, t_cone)))
    v_rad = torch.where(is_strip, v_strip, torch.where(is_foc, v_foc,
                                                       torch.where(big, one, v_cone)))
    t_rad = focal_x + t_sign * t_rad

    # Sweep: atan polynomial (fine.wgsl:1035-1067) with its NaN scrub.
    t0s, t1s = fu(12), fu(13)
    xabs = torch.abs(lxr)
    yabs = torch.abs(lyr)
    mx = torch.maximum(xabs, yabs)
    slope = torch.minimum(xabs, yabs) / torch.where(mx == 0, one, mx)
    s2 = slope * slope
    phi = slope * (
        0.15912117063999176025390625
        + s2 * (-5.185396969318389892578125e-2
                + s2 * (2.476101927459239959716796875e-2
                        + s2 * (-7.0547382347285747528076171875e-3))))
    phi = torch.where(xabs < yabs, 0.25 - phi, phi)
    phi = torch.where(lxr < 0.0, 0.5 - phi, phi)
    phi = torch.where(lyr < 0.0, 1.0 - phi, phi)
    phi = torch.where(phi != phi, zero, phi)
    t_sweep = (phi - t0s) / torch.where(t1s == t0s, one, t1s - t0s)

    t = torch.where(is_lin, t_lin, torch.where(is_rad, t_rad, t_sweep))
    t = extend(t, iu(5))
    t = torch.where(is_rad & is_swapped, 1.0 - t, t)
    vmask = torch.where(is_rad, v_rad, one)

    NR, W = stops.shape
    S = (W - 1) // 5
    ramp = rec[:, 15]
    ok = is_grad[:, 0] & (ramp >= 0) & (ramp < NR)
    rows = torch.where(ok[:, None], ops.gather_guarded(stops, ramp), zero)

    def stop_p(k):
        return rows[:, 1 + k:2 + k]

    def stop_c(k, ch):
        return rows[:, 1 + S + 4 * k + ch:2 + S + 4 * k + ch]

    acc = [stop_c(0, ch).expand(-1, 256) for ch in range(4)]
    for k in range(S - 1):
        dk = torch.clamp(stop_p(k + 1) - stop_p(k), min=1e-9)
        u = torch.clamp((t - stop_p(k)) / dk, 0.0, 1.0)
        for ch in range(4):
            acc[ch] = acc[ch] + (stop_c(k + 1, ch) - stop_c(k, ch)) * u
    ga = acc[3] * vmask
    return [eotf(acc[0]) * ga, eotf(acc[1]) * ga, eotf(acc[2]) * ga, ga]
