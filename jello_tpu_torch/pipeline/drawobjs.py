"""Draw object stages: monoid scan + per-object info table, in torch.

Counterpart of `jello_tpu/pipeline/drawobjs.py` (`draw_monoid_scan`,
`draw_leaf`). The draw monoid is a 4-component exclusive prefix sum over
draw tags (path_idx, clip_idx, scene_offset, info_offset). `draw_leaf`
turns each draw's brush parameters into the words fine rasterization
reads: the solid info word, the linear gradient line equation, the
focal-form radial parameters, the sweep and image inverse transforms,
and the clip stream (draw index and path index per clip element) that
`clips.clip_leaf_vectorized` resolves.
The info_offset monoid is kept for parity with the reference's stream
layout; the table is indexed by draw.
"""

from __future__ import annotations

import torch

from ..encoding.draw import (
    DRAW_TAG_BEGIN_CLIP,
    DRAW_TAG_COLOR,
    DRAW_TAG_END_CLIP,
    DRAW_TAG_IMAGE,
    DRAW_TAG_LINEAR_GRADIENT,
    DRAW_TAG_NOP,
    DRAW_TAG_RADIAL_GRADIENT,
    DRAW_TAG_SWEEP_GRADIENT,
)

from ..pmath import rdiv, sqrt
from . import ops
from .ops import F32, I32

RAD_GRAD_KIND_CIRCULAR = 1
RAD_GRAD_KIND_STRIP = 2
RAD_GRAD_KIND_FOCAL_ON_CIRCLE = 3
RAD_GRAD_KIND_CONE = 4
RAD_GRAD_SWAPPED = 1

GRADIENT_EPSILON = 1.0 / (1 << 12)


def draw_monoid_scan(draw_tags):
    """Exclusive draw monoid prefix per draw object (int32 columns, one
    column scan: kernel I)."""
    from ..cuda.scan import column_scan

    t = draw_tags
    c = column_scan([(t != DRAW_TAG_NOP).to(I32), t & 1, (t >> 2) & 0x7, (t >> 6) & 0xF],
                    "sum", exclusive=True)
    return {"path_idx": c[0], "clip_idx": c[1], "scene_offset": c[2], "info_offset": c[3]}


def _inverse(t):
    det = t[0] * t[3] - t[1] * t[2]
    inv_det = rdiv(1.0, torch.where(det == 0.0, torch.ones_like(det), det))
    a = t[3] * inv_det
    b = -t[1] * inv_det
    c = -t[2] * inv_det
    d = t[0] * inv_det
    return [a, b, c, d, -(a * t[4] + c * t[5]), -(b * t[4] + d * t[5])]


def _mul(t, o):
    return [
        t[0] * o[0] + t[2] * o[1],
        t[1] * o[0] + t[3] * o[1],
        t[0] * o[2] + t[2] * o[3],
        t[1] * o[2] + t[3] * o[3],
        t[0] * o[4] + t[2] * o[5] + t[4],
        t[1] * o[4] + t[3] * o[5] + t[5],
    ]


def _from_poly2(p0x, p0y, p1x, p1y):
    return [p1y - p0y, p0x - p1x, p1x - p0x, p1y - p0y, p0x, p0y]


def _two_point_to_unit_line(p0x, p0y, p1x, p1y):
    inv = _inverse(_from_poly2(p0x, p0y, p1x, p1y))
    z = torch.zeros_like(p0x)
    one = torch.ones_like(p0x)
    return _mul(_from_poly2(z, z, one, z), inv)


def draw_leaf(scene, layout, monoids, path_trans_idx, path_draw_flags, caps, tag):
    """Per-draw info table and the clip stream.

    Returns (info int32-carried u32 [D, 10], word k of draw i;
    clip_idx_arr [NC] i32, the draw index of each clip element;
    clip_path_idx_arr [NC] i32, its path index for a BeginClip, ~draw
    index for an EndClip)."""
    D = caps["n_draws_cap"]
    NC = caps["n_clips_cap"]
    dev = scene.device
    act = ops.iota(D, dev) < layout["n_draw_objects"]

    m_path = monoids["path_idx"]
    dd = layout["draw_data_base"] + monoids["scene_offset"]

    prow = ops.gather_guarded(torch.stack([path_trans_idx, path_draw_flags], dim=1), m_path)
    trans_idx = prow[:, 0]
    draw_flags = prow[:, 1]

    base = layout["transform_base"] + trans_idx * 6
    gidx = torch.cat([dd + k for k in range(7)] + [base + i for i in range(6)])
    gall = ops.gather_guarded(scene, gidx).reshape(13, D)

    def sc_f(off):
        return ops.bitcast_u32_f32(gall[off])

    T = [sc_f(7 + i) for i in range(6)]
    cols = [torch.zeros(D, dtype=I32, device=dev) for _ in range(10)]

    def wr(mask, offset, value):
        cols[offset] = torch.where(mask, value, cols[offset])

    def wrf(mask, offset, value_f32):
        wr(mask, offset, ops.bitcast_f32_u32(value_f32))

    has_info = (
        (tag == DRAW_TAG_COLOR) | (tag == DRAW_TAG_LINEAR_GRADIENT)
        | (tag == DRAW_TAG_RADIAL_GRADIENT) | (tag == DRAW_TAG_SWEEP_GRADIENT)
        | (tag == DRAW_TAG_IMAGE) | (tag == DRAW_TAG_BEGIN_CLIP)
    ) & act
    wr(has_info & (tag != DRAW_TAG_BEGIN_CLIP), 0, draw_flags)

    # Linear gradient -> line equation.
    lin = has_info & (tag == DRAW_TAG_LINEAR_GRADIENT)
    p0x_, p0y_ = sc_f(1), sc_f(2)
    p1x_, p1y_ = sc_f(3), sc_f(4)
    lp0x = T[0] * p0x_ + T[2] * p0y_ + T[4]
    lp0y = T[1] * p0x_ + T[3] * p0y_ + T[5]
    lp1x = T[0] * p1x_ + T[2] * p1y_ + T[4]
    lp1y = T[1] * p1x_ + T[3] * p1y_ + T[5]
    dxy_x = lp1x - lp0x
    dxy_y = lp1y - lp0y
    denom = dxy_x * dxy_x + dxy_y * dxy_y
    sc = rdiv(1.0, torch.where(denom == 0.0, torch.ones_like(denom), denom))
    line_x = dxy_x * sc
    line_y = dxy_y * sc
    wrf(lin, 1, line_x)
    wrf(lin, 2, line_y)
    wrf(lin, 3, -(lp0x * line_x + lp0y * line_y))

    # Radial gradient -> focal form (Skia scheme).
    rad = has_info & (tag == DRAW_TAG_RADIAL_GRADIENT)
    r0 = sc_f(5)
    r1 = sc_f(6)
    one = torch.ones_like(r0)
    zero = torch.zeros_like(r0)
    user_to_gradient = _inverse(T)
    is_strip = torch.abs(r0 - r1) < GRADIENT_EPSILON
    p0p1_dist = sqrt((p1x_ - p0x_) ** 2 + (p1y_ - p0y_) ** 2)
    scaled = r0 / torch.where(p0p1_dist == 0.0, one, p0p1_dist)
    strip_xform = _mul(_two_point_to_unit_line(p0x_, p0y_, p1x_, p1y_), user_to_gradient)
    strip_radius = scaled * scaled
    centers_eq = (p0x_ == p1x_) & (p0y_ == p1y_)
    cp0x = torch.where(centers_eq, p0x_ + GRADIENT_EPSILON, p0x_)
    cp0y = p0y_
    swapped = r1 == 0.0
    sp0x = torch.where(swapped, p1x_, cp0x)
    sp0y = torch.where(swapped, p1y_, cp0y)
    sp1x = torch.where(swapped, cp0x, p1x_)
    sp1y = torch.where(swapped, cp0y, p1y_)
    sr0 = torch.where(swapped, r1, r0)
    sr1 = torch.where(swapped, r0, r1)
    focal_x = sr0 / torch.where(sr0 == sr1, one, sr0 - sr1)
    cfx = sp0x * (1.0 - focal_x) + sp1x * focal_x
    cfy = sp0y * (1.0 - focal_x) + sp1y * focal_x
    cf_dist = sqrt((cfx - sp1x) ** 2 + (cfy - sp1y) ** 2)
    radius = sr1 / torch.where(cf_dist == 0.0, one, cf_dist)
    user_to_unit_line = _mul(_two_point_to_unit_line(cfx, cfy, sp1x, sp1y), user_to_gradient)
    is_focal_on_circle = torch.abs(radius - 1.0) <= GRADIENT_EPSILON
    foc_scale = 0.5 * torch.abs(1.0 - focal_x)
    xf_foc = _mul([foc_scale, zero, zero, foc_scale, zero, zero], user_to_unit_line)
    a_r = radius * radius - 1.0
    scale_ratio = torch.abs(1.0 - focal_x) / torch.where(a_r == 0.0, one, a_r)
    scale_x = radius * scale_ratio
    scale_y = sqrt(torch.abs(a_r)) * scale_ratio
    xf_cone = _mul([scale_x, zero, zero, scale_y, zero, zero], user_to_unit_line)
    xf_noncone = [torch.where(is_focal_on_circle, xf_foc[i], xf_cone[i]) for i in range(6)]
    kind = torch.where(is_strip, RAD_GRAD_KIND_STRIP,
                       torch.where(centers_eq, RAD_GRAD_KIND_CIRCULAR, RAD_GRAD_KIND_CONE))
    kind = torch.where(~is_strip & is_focal_on_circle, RAD_GRAD_KIND_FOCAL_ON_CIRCLE, kind)
    rflags = torch.where(~is_strip & swapped, RAD_GRAD_SWAPPED, 0)
    for i in range(6):
        wrf(rad, 1 + i, torch.where(is_strip, strip_xform[i], xf_noncone[i]))
    wrf(rad, 7, torch.where(is_strip, zero, focal_x))
    wrf(rad, 8, torch.where(is_strip, strip_radius, radius))
    wr(rad, 9, ((rflags << 3) | kind).to(I32))

    # Sweep gradient.
    swp = has_info & (tag == DRAW_TAG_SWEEP_GRADIENT)
    sw_xform = _inverse(_mul(T, [one, zero, zero, one, p0x_, p0y_]))
    for i in range(6):
        wrf(swp, 1 + i, sw_xform[i])
    wr(swp, 7, gall[3])
    wr(swp, 8, gall[4])

    # Image.
    img = has_info & (tag == DRAW_TAG_IMAGE)
    img_xform = _inverse(T)
    for i in range(6):
        wrf(img, 1 + i, img_xform[i])
    wr(img, 7, gall[0])
    wr(img, 8, gall[1])

    # Clip stream: both columns ride one scatter at the clip monoid.
    di_draw = ops.iota(D, dev)
    is_begin = act & (tag == DRAW_TAG_BEGIN_CLIP)
    is_end = act & (tag == DRAW_TAG_END_CLIP)
    clip_tgt = torch.where(is_begin | is_end, monoids["clip_idx"], NC)
    clip_path = torch.where(is_begin, m_path, ~di_draw)
    both = ops.scatter_set(torch.zeros((NC, 2), dtype=I32, device=dev), clip_tgt,
                           torch.stack([di_draw, clip_path], dim=1))
    return torch.stack(cols, dim=1), both[:, 0], both[:, 1]
