"""The reference's fine stage, in torch: per-tile command tapes in, the
un-premultiplied image out.

jello_tpu's numpy oracle fine stage (`jello_tpu/pipeline/fine_ref.py`,
area antialiasing) translated to torch, so that it runs on the card: the
same dense walk, one command slot of every tile at a time, the same
analytic area coverage, paints, clip stack and blends. The arrays keep
the dtypes numpy gives them there (float64 where the crossings are), and
`blend_math` and `gradient.sample_stops`, which the oracle calls with an
array namespace, get `TORCH`, torch under numpy's names.

Layout: pixel state [4, GRID, 256] (channel, tile, pixel), pixel
p = local_y * 16 + local_x.
"""

from __future__ import annotations

import numpy as np
import torch

from . import blend_math as bm
from .pipeline.coarse import (
    CMD_BEGIN_CLIP,
    CMD_COLOR,
    CMD_END_CLIP,
    CMD_IMAGE,
    CMD_LIN_GRAD,
    CMD_RAD_GRAD,
    CMD_SWEEP_GRAD,
)
from .pipeline.drawobjs import (
    RAD_GRAD_KIND_CIRCULAR,
    RAD_GRAD_KIND_FOCAL_ON_CIRCLE,
    RAD_GRAD_KIND_STRIP,
    RAD_GRAD_SWAPPED,
)
from .pipeline.gradient import sample_stops

EXTEND_PAD = 0
EXTEND_REPEAT = 1


def _t(x, like):
    return x if isinstance(x, torch.Tensor) else torch.tensor(x, device=like.device,
                                                              dtype=like.dtype)


class _Torch:
    """The numpy names `blend_math` and `sample_stops` call, on tensors
    (a Python number beside a tensor takes the tensor's type)."""

    abs = staticmethod(torch.abs)
    sqrt = staticmethod(torch.sqrt)
    stack = staticmethod(torch.stack)
    ones_like = staticmethod(torch.ones_like)
    zeros_like = staticmethod(torch.zeros_like)

    @staticmethod
    def where(c, a, b):
        return torch.where(c, a, b)

    @staticmethod
    def minimum(a, b):
        a, b = (a, _t(b, a)) if isinstance(a, torch.Tensor) else (_t(a, b), b)
        return torch.minimum(a, b)

    @staticmethod
    def maximum(a, b):
        a, b = (a, _t(b, a)) if isinstance(a, torch.Tensor) else (_t(a, b), b)
        return torch.maximum(a, b)

    @staticmethod
    def clip(a, lo, hi):
        return torch.clamp(a, lo, hi)


TORCH = _Torch()


def _bits_f32(words: torch.Tensor) -> torch.Tensor:
    """int64 tensor of u32 words -> their float32 bit patterns."""
    return words.to(torch.int64).bitwise_and(0xFFFFFFFF).to(torch.int32).view(torch.float32)


def _extend_mode(t, mode):
    pad = torch.clamp(t, 0.0, 1.0)
    rep = t - torch.floor(t)
    refl = torch.abs(t - 2.0 * torch.round(0.5 * t))
    return torch.where(mode == EXTEND_PAD, pad, torch.where(mode == EXTEND_REPEAT, rep, refl))


def _fill_area(seg_start, seg_count, backdrop, even_odd, segs, px, py, chunk):
    """Coverage per pixel of one fill command in every tile: [G, 256]."""
    G = seg_start.shape[0]
    area = backdrop.to(torch.float32)[:, None].expand(G, 256)
    n_chunks = (int(seg_count.max()) + chunk - 1) // chunk
    n_segs = segs["seg_x0"].shape[0]
    k = torch.arange(chunk, device=px.device)[None, :]
    for c in range(n_chunks):
        idx = seg_start[:, None] + c * chunk + k
        valid = k < (seg_count[:, None] - c * chunk)
        gi = torch.clamp(idx, 0, n_segs - 1)
        sx0, sy0 = segs["seg_x0"][gi], segs["seg_y0"][gi]
        sx1, sy1 = segs["seg_x1"][gi], segs["seg_y1"][gi]
        sye = segs["seg_y_edge"][gi]
        dx = (sx1 - sx0)[:, :, None]
        dy = (sy1 - sy0)[:, :, None]
        y = sy0[:, :, None] - py[None, None, :]
        y0c = torch.clamp(y, 0.0, 1.0)
        y1c = torch.clamp(y + dy, 0.0, 1.0)
        dyc = y0c - y1c
        safe_dy = torch.where(dy == 0.0, 1.0, dy)
        vy_recip = 1.0 / safe_dy
        t0 = (y0c - y) * vy_recip
        t1 = (y1c - y) * vy_recip
        startx = sx0[:, :, None] - px[None, None, :]
        x0 = startx + t0 * dx
        x1 = startx + t1 * dx
        xmin0 = torch.minimum(x0, x1)
        xmax0 = torch.maximum(x0, x1)
        xmin = torch.clamp(xmin0, max=1.0) - 1.0e-6
        b = torch.clamp(xmax0, max=1.0)
        c_ = torch.clamp(b, min=0.0)
        d = torch.clamp(xmin, min=0.0)
        denom = xmax0 - xmin
        a = (b + 0.5 * (d * d - c_ * c_) - xmin) / denom
        contrib = torch.where(dyc != 0.0, a * dyc, 0.0)
        y_edge = torch.sign(dx) * torch.clamp(py[None, None, :] - sye[:, :, None] + 1.0, 0.0, 1.0)
        contrib = contrib + y_edge
        contrib = torch.where(valid[:, :, None], contrib, 0.0)
        area = area + torch.sum(contrib, dim=1)
    eo = torch.abs(area - 2.0 * torch.round(0.5 * area))
    nz = torch.clamp(torch.abs(area), max=1.0)
    return torch.where(even_odd[:, None], eo, nz)


def _blend_over(rgba, fg, area):
    fa = fg[3] * area
    return torch.stack([rgba[i] * (1.0 - fa) + fg[i] * area for i in range(4)])


def fine(cmds, segs, ramps, images, layout, caps, low=None):
    """Interpret every tile's command tape (tensors on one device).

    cmds: tile_start, tile_end [GRID]; kind, seg_count, seg_start,
    backdrop, flags, draw [K]; dtab [D, 13] u32 words as int64. segs:
    seg_x0, seg_y0, seg_x1, seg_y1, seg_y_edge. ramps: the stop table;
    images: the atlas [AH, AW, 4] or None. `low`, if given, is applied to
    each command's coverage and to the output (the control).
    Returns (image [4, GRID, 256] un-premultiplied, blend depth overflow)."""
    low = low or (lambda x: x)
    dev = ramps.device
    BD = caps["blend_depth"]
    chunk = caps.get("fine_seg_chunk", 8)
    wit = int(layout["width_in_tiles"])
    GRID = cmds["tile_start"].shape[0]
    K = cmds["kind"].shape[0]
    D = cmds["dtab"].shape[0]
    f32 = torch.float32

    p = torch.arange(256, device=dev)
    lx = (p % 16).to(f32)
    ly = (p // 16).to(f32)
    t_ids = torch.arange(GRID, device=dev)
    gx = ((t_ids % wit) * 16).to(f32)[:, None] + lx[None, :]
    gy = ((t_ids // wit) * 16).to(f32)[:, None] + ly[None, :]

    base = torch.as_tensor(np.asarray(layout["base_color"], dtype=np.float32), device=dev)
    rgba = base[:, None, None].expand(4, GRID, 256) * torch.ones((4, GRID, 256), device=dev)
    stack = None
    clip_depth = torch.zeros(GRID, dtype=torch.int64, device=dev)
    blend_depth = torch.zeros_like(clip_depth)
    zero_depth = torch.zeros_like(clip_depth)
    depth_overflow = torch.zeros((), dtype=torch.bool, device=dev)

    start, end = cmds["tile_start"], cmds["tile_end"]
    n_slots = int((end - start).max()) if GRID else 0
    dtab_f = _bits_f32(cmds["dtab"])
    tiles = torch.arange(GRID, device=dev)
    if images is not None and images.shape[0] > 0:
        AH, AW = images.shape[0], images.shape[1]
        atlas_flat = images.reshape(AH * AW, 4)

    for s in range(n_slots):
        ci = torch.clamp(start + s, 0, K - 1)
        active = (start + s) < end
        kind = torch.where(active, cmds["kind"][ci], 0)
        seg_count = cmds["seg_count"][ci]
        seg_start = cmds["seg_start"][ci]
        backdrop = cmds["backdrop"][ci]
        flags = cmds["flags"][ci]
        di = torch.clamp(cmds["draw"][ci], 0, D - 1)
        drow, drow_f = cmds["dtab"][di], dtab_f[di]

        suppressed = zero_depth > 0
        run = active & ~suppressed

        # ---- coverage ----
        is_fillish = ((kind == CMD_COLOR) | (kind == CMD_LIN_GRAD) | (kind == CMD_RAD_GRAD)
                      | (kind == CMD_SWEEP_GRAD) | (kind == CMD_IMAGE)
                      | (kind == CMD_END_CLIP)) & run
        even_odd = torch.where(kind == CMD_END_CLIP, False, (flags & 1) != 0)
        fill_count = torch.where(is_fillish & (seg_count > 0), seg_count, 0)
        cov = _fill_area(torch.where(fill_count > 0, seg_start, 0), fill_count,
                         torch.where(is_fillish, backdrop, 0), even_odd & is_fillish, segs,
                         lx, ly, chunk)
        area = low(torch.where((is_fillish & (seg_count > 0))[:, None], cov,
                               torch.where(is_fillish[:, None], torch.ones_like(cov), cov)))

        def sc_u(off):
            return drow[:, off]

        def sc_f(off):
            return drow_f[:, off]

        def info_f(off):
            return drow_f[:, 3 + off]

        def info_u(off):
            return drow[:, 3 + off]

        # ---- paints ----
        m = run & (kind == CMD_COLOR)
        if bool(m.any()):
            fg = torch.stack([sc_f(i)[:, None].expand(GRID, 256) for i in range(4)])
            rgba = torch.where(m[None, :, None], _blend_over(rgba, fg, area), rgba)

        m = run & (kind == CMD_LIN_GRAD)
        if bool(m.any()):
            index_mode = sc_u(0)
            d_lin = info_f(1)[:, None] * gx + info_f(2)[:, None] * gy + info_f(3)[:, None]
            t_lin = _extend_mode(d_lin, (index_mode & 3)[:, None])
            fg = _sample_ramp(ramps, index_mode >> 2, t_lin)
            rgba = torch.where(m[None, :, None], _blend_over(rgba, fg, area), rgba)

        m0, m1, m2, m3 = (info_f(i)[:, None] for i in (1, 2, 3, 4))
        xlat_x, xlat_y = info_f(5)[:, None], info_f(6)[:, None]

        m = run & (kind == CMD_RAD_GRAD)
        if bool(m.any()):
            focal_x = info_f(7)[:, None]
            radius = info_f(8)[:, None]
            flags_kind = info_u(9)
            rkind = (flags_kind & 0x7)[:, None]
            rflags = (flags_kind >> 3)[:, None]
            lxr = m0 * gx + m2 * gy + xlat_x
            lyr = m1 * gx + m3 * gy + xlat_y
            xx = lxr * lxr
            yy = lyr * lyr
            is_strip = rkind == RAD_GRAD_KIND_STRIP
            is_circular = rkind == RAD_GRAD_KIND_CIRCULAR
            is_foc = rkind == RAD_GRAD_KIND_FOCAL_ON_CIRCLE
            is_swapped = (rflags & RAD_GRAD_SWAPPED) != 0
            r1_recip = torch.where(is_circular, 0.0,
                                   1.0 / torch.where(radius == 0, 1.0, radius))
            less_scale = torch.where(is_swapped | ((1.0 - focal_x) < 0.0), -1.0, 1.0)
            t_sign = torch.sign(1.0 - focal_x)
            a_s = radius - yy
            t_strip = torch.sqrt(torch.clamp(a_s, min=0.0)) + lxr
            v_strip = a_s >= 0.0
            safe_x = torch.where(lxr == 0.0, 1.0, lxr)
            t_foc = (xx + yy) / safe_x
            v_foc = (t_foc >= 0.0) & (lxr != 0.0)
            t_big = torch.sqrt(xx + yy) - lxr * r1_recip
            a_c = xx - yy
            t_cone = less_scale * torch.sqrt(torch.clamp(a_c, min=0.0)) - lxr * r1_recip
            v_cone = (a_c >= 0.0) & (t_cone >= 0.0)
            t_r = torch.where(is_strip, t_strip,
                              torch.where(is_foc, t_foc,
                                          torch.where(radius > 1.0, t_big, t_cone)))
            valid_r = torch.where(is_strip, v_strip,
                                  torch.where(is_foc, v_foc,
                                              torch.where(radius > 1.0, True, v_cone)))
            t_r = _extend_mode(focal_x + t_sign * t_r, (sc_u(0) & 3)[:, None])
            t_r = torch.where(is_swapped, 1.0 - t_r, t_r)
            fg = _sample_ramp(ramps, sc_u(0) >> 2, t_r) * valid_r[None, :, :]
            new = _blend_over(rgba, fg, torch.where(valid_r, area, 0.0))
            rgba = torch.where(m[None, :, None], new, rgba)

        m = run & (kind == CMD_SWEEP_GRAD)
        if bool(m.any()):
            t0s, t1s = info_f(7)[:, None], info_f(8)[:, None]
            lxs = m0 * gx + m2 * gy + xlat_x
            lys = m1 * gx + m3 * gy + xlat_y
            xabs, yabs = torch.abs(lxs), torch.abs(lys)
            big = torch.maximum(xabs, yabs)
            slope = torch.minimum(xabs, yabs) / torch.where(big == 0, 1.0, big)
            s2 = slope * slope
            phi = slope * (0.15912117063999176025390625 + s2 * (
                -5.185396969318389892578125e-2 + s2 * (
                    2.476101927459239959716796875e-2 + s2 * (-7.0547382347285747528076171875e-3))))
            phi = torch.where(xabs < yabs, 0.25 - phi, phi)
            phi = torch.where(lxs < 0.0, 0.5 - phi, phi)
            phi = torch.where(lys < 0.0, 1.0 - phi, phi)
            phi = torch.where(torch.isnan(phi), 0.0, phi)
            phi = (phi - t0s) / torch.where(t1s == t0s, 1.0, t1s - t0s)
            t_s = _extend_mode(phi, (sc_u(0) & 3)[:, None])
            fg = _sample_ramp(ramps, sc_u(0) >> 2, t_s)
            rgba = torch.where(m[None, :, None], _blend_over(rgba, fg, area), rgba)

        m = run & (kind == CMD_IMAGE)
        if images is not None and images.shape[0] > 0 and bool(m.any()):
            axy = info_u(7)
            ax = (axy & 0xFFFF)[:, None]
            ay = (axy >> 16)[:, None]
            wh = info_u(8)
            iw = (wh >> 16).to(f32)[:, None]
            ih = (wh & 0xFFFF).to(f32)[:, None]
            ux = m0 * gx + m2 * gy + xlat_x
            uy = m1 * gx + m3 * gy + xlat_y
            in_b = (ux < iw) & (uy < ih) & (ux >= 0.0) & (uy >= 0.0)
            x0i, y0i = torch.floor(ux).to(torch.int64), torch.floor(uy).to(torch.int64)
            x1i, y1i = torch.ceil(ux).to(torch.int64), torch.ceil(uy).to(torch.int64)
            fx = ux - torch.floor(ux)
            fy = uy - torch.floor(uy)
            iwm1 = (iw - 1.0).to(torch.int64)
            ihm1 = (ih - 1.0).to(torch.int64)

            def tap(yi, xi):
                yi = ay + torch.minimum(torch.clamp(yi, min=0), ihm1)
                xi = ax + torch.minimum(torch.clamp(xi, min=0), iwm1)
                px4 = atlas_flat[torch.clamp(yi * AW + xi, 0, AH * AW - 1)]
                return torch.stack([px4[..., 0] * px4[..., 3], px4[..., 1] * px4[..., 3],
                                    px4[..., 2] * px4[..., 3], px4[..., 3]])

            aq, bq, cq, dq = tap(y0i, x0i), tap(y1i, x0i), tap(y0i, x1i), tap(y1i, x1i)
            fg = ((aq + (bq - aq) * fy[None]) * (1 - fx[None])
                  + (cq + (dq - cq) * fy[None]) * fx[None])
            fg = fg * in_b[None]
            new = _blend_over(rgba, fg, torch.where(in_b, area, 0.0))
            rgba = torch.where(m[None, :, None], new, rgba)

        # ---- clips ----
        is_begin = kind == CMD_BEGIN_CLIP
        is_end = kind == CMD_END_CLIP
        if not bool((active & (is_begin | is_end)).any()):
            continue
        begin_zero = is_begin & (seg_count < 0)
        clip_depth_new = clip_depth + torch.where(active & is_begin, 1,
                                                  torch.where(active & is_end, -1, 0))
        unsuppress = active & suppressed & is_end & (clip_depth == zero_depth)
        zero_depth = torch.where(unsuppress, 0, zero_depth)
        zero_depth = torch.where(run & begin_zero, clip_depth + 1, zero_depth)

        if stack is None:
            stack = torch.zeros((BD,) + tuple(rgba.shape), dtype=rgba.dtype, device=dev)
        elif stack.dtype != rgba.dtype:
            stack = stack.to(torch.promote_types(stack.dtype, rgba.dtype))
        do_push = run & is_begin & ~begin_zero
        bd_idx = torch.clamp(blend_depth, 0, BD - 1)
        gi = torch.nonzero(do_push).flatten()
        stack[bd_idx[gi], :, gi, :] = rgba[:, gi, :].permute(1, 0, 2).to(stack.dtype)
        rgba = torch.where(do_push[None, :, None], torch.zeros_like(rgba), rgba)
        depth_overflow = depth_overflow | torch.any(do_push & (blend_depth >= BD))
        blend_depth = blend_depth + do_push.to(torch.int64)

        do_pop = run & is_end
        blend_depth = blend_depth - do_pop.to(torch.int64)
        bd_idx = torch.clamp(blend_depth, 0, BD - 1)
        bg = stack[bd_idx, :, tiles, :].permute(1, 0, 2)
        alpha = sc_f(1)[:, None]
        fg = [rgba[i] * area * alpha for i in range(4)]
        popped = torch.stack(bm.blend_mix_compose(TORCH, tuple(bg), tuple(fg),
                                                  sc_u(0)[:, None]))
        rgba = torch.where(do_pop[None, :, None], popped, rgba)
        clip_depth = clip_depth_new

    a_inv = 1.0 / torch.clamp(rgba[3], min=1e-6)
    out = torch.stack([rgba[0] * a_inv, rgba[1] * a_inv, rgba[2] * a_inv, rgba[3]])
    return low(out), bool(depth_overflow)


def _sample_ramp(ramps, ramp_idx, t):
    rows = ramps[torch.clamp(ramp_idx, 0, ramps.shape[0] - 1)]
    return sample_stops(TORCH, rows, t)


def assemble_image(fine_out, layout):
    """[4, GRID, 256] -> [H, W, 4] cropped to the target."""
    wit, hit = int(layout["width_in_tiles"]), int(layout["height_in_tiles"])
    tw, th = int(layout["target_width"]), int(layout["target_height"])
    g = fine_out[:, : wit * hit, :].reshape(4, hit, wit, 16, 16)
    return g.permute(1, 3, 2, 4, 0).reshape(hit * 16, wit * 16, 4)[:th, :tw, :]
