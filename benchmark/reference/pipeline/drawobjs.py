"""Draw object stages: monoid scan + per-object info generation.

(reference: shaders/cpu/cpu.go DrawReduce/DrawLeaf, draw_leaf.wgsl)

The draw monoid is a 4-component exclusive prefix sum over draw tags:
(path_idx, clip_idx, scene_offset, info_offset). `draw_leaf` transforms
each draw object's brush parameters into the form consumed by fine
rasterization (gradient line equations, focal-form radial parameters,
inverse transforms) and writes them into the `info` u32 stream at the
object's info offset — the byte layout matches the reference so the
fine stage semantics carry over unchanged. It also produces the clip
stream input.
"""

from __future__ import annotations

import numpy as _np

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
from . import ops

# Radial gradient kinds/flags (reference: shared/config.wgsl:66-73)
RAD_GRAD_KIND_CIRCULAR = 1
RAD_GRAD_KIND_STRIP = 2
RAD_GRAD_KIND_FOCAL_ON_CIRCLE = 3
RAD_GRAD_KIND_CONE = 4
RAD_GRAD_SWAPPED = 1

GRADIENT_EPSILON = 1.0 / (1 << 12)


def draw_monoid_scan(xp, draw_tags):
    """Exclusive draw monoid prefix per draw object.

    All four components ride ONE column cumsum (cumsums cost per row,
    not per column on the fabric)."""
    t = draw_tags.astype(xp.uint32)
    d = xp.stack(
        [
            (t != DRAW_TAG_NOP).astype(xp.uint32),
            t & 1,
            (t >> 2) & 0x7,
            (t >> 6) & 0xF,
        ],
        axis=1,
    )
    c = xp.cumsum(d, axis=0) - d
    return {
        "path_idx": c[:, 0],
        "clip_idx": c[:, 1],
        "scene_offset": c[:, 2],
        "info_offset": c[:, 3],
    }


def _inverse(xp, t):
    det = t[0] * t[3] - t[1] * t[2]
    safe = xp.where(det == 0.0, xp.float32(1.0), det)
    inv_det = 1.0 / safe
    a = t[3] * inv_det
    b = -t[1] * inv_det
    c = -t[2] * inv_det
    d = t[0] * inv_det
    return [
        a,
        b,
        c,
        d,
        -(a * t[4] + c * t[5]),
        -(b * t[4] + d * t[5]),
    ]


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


def _two_point_to_unit_line(xp, p0x, p0y, p1x, p1y):
    inv = _inverse(xp, _from_poly2(p0x, p0y, p1x, p1y))
    z = xp.zeros_like(p0x)
    one = xp.ones_like(p0x)
    tmp2 = _from_poly2(z, z, one, z)
    return _mul(tmp2, inv)


def draw_leaf(xp, scene, layout, monoids, path_trans_idx, path_draw_flags,
              caps, tag=None):
    """Generate the per-draw info table and clip inputs.

    Info is a dense u32[D, 10] TABLE (word k of draw i), not the
    reference's flat variable-stride stream (draw_leaf.wgsl writes at
    info_offset): every word is a per-draw select, so the whole table
    is one fused stack — zero scatters — and consumers read rows by
    draw index instead of element-gathering via info offsets. The
    info_offset monoid is still computed (reference parity for the
    stream layout contract lives in the encoding, not here).

    Heavy-op budget (the fabric charges ~60-80 us per top-level
    random-access op): ONE merged scene gather (13 index vectors:
    draw data words 0..6 + transform words 0..5), ONE path-table row
    gather, ONE merged clip scatter — vs the 20 gathers + 31 scatters
    of the per-word formulation.

    Returns (info_tab u32[D, 10], clip_idx_arr, clip_path_idx_arr,
    tag, dd, di).
    """
    D = caps["n_draws_cap"]
    NC = caps["n_clips_cap"]
    f32 = xp.float32

    di_draw = xp.arange(D, dtype=xp.int32)
    act = di_draw < layout["n_draw_objects"]
    if tag is None:
        tag = xp.where(
            act,
            ops.gather_guarded(xp, scene, layout["draw_tag_base"] + di_draw),
            xp.uint32(DRAW_TAG_NOP),
        )

    m_path = monoids["path_idx"].astype(xp.int32)
    dd = (layout["draw_data_base"] + monoids["scene_offset"]).astype(xp.int32)
    di = monoids["info_offset"].astype(xp.int32)

    # One row gather for both per-path fields.
    ptab = xp.stack([path_trans_idx, path_draw_flags], axis=1)
    prow = ops.gather_guarded(xp, ptab, m_path)
    trans_idx = prow[:, 0]
    draw_flags = prow[:, 1]

    # ONE merged scene gather: draw-data words dd+0..6 and transform
    # words base+0..5 (indices are all elementwise functions of the
    # monoids; the concat fuses into the gather operand).
    base = layout["transform_base"] + trans_idx.astype(xp.int32) * 6
    gidx = xp.concatenate(
        [dd + k for k in range(7)] + [base + i for i in range(6)]
    )
    gall = ops.gather_guarded(xp, scene, gidx).reshape(13, D)

    def sc_f(off):
        return ops.bitcast_u32_f32(xp, gall[off])

    def sc_u(off):
        return gall[off]

    T = [ops.bitcast_u32_f32(xp, gall[7 + i]) for i in range(6)]

    # info words accumulate as per-column select chains (wr/wrf write
    # column `offset` where mask); the stack at the end is the only
    # materialization.
    cols = [xp.zeros(D, dtype=xp.uint32) for _ in range(10)]

    def wr(mask, offset, value_u32):
        cols[offset] = xp.where(mask, value_u32, cols[offset])

    def wrf(mask, offset, value_f32):
        wr(mask, offset, ops.bitcast_f32_u32(xp, value_f32))

    has_info = (
        (tag == DRAW_TAG_COLOR)
        | (tag == DRAW_TAG_LINEAR_GRADIENT)
        | (tag == DRAW_TAG_RADIAL_GRADIENT)
        | (tag == DRAW_TAG_SWEEP_GRADIENT)
        | (tag == DRAW_TAG_IMAGE)
        | (tag == DRAW_TAG_BEGIN_CLIP)
    ) & act
    # All info-bearing draws write draw_flags at di[0]; BeginClip has
    # info size 0 in the tag table so gets nothing.
    wr(has_info & (tag != DRAW_TAG_BEGIN_CLIP), 0, draw_flags)

    # Linear gradient -> line equation (cpu.go:1336-1353).
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
    safe_denom = xp.where(denom == 0.0, f32(1.0), denom)
    sc = 1.0 / safe_denom
    line_x = dxy_x * sc
    line_y = dxy_y * sc
    line_c = -(lp0x * line_x + lp0y * line_y)
    wrf(lin, 1, line_x)
    wrf(lin, 2, line_y)
    wrf(lin, 3, line_c)

    # Radial gradient -> focal form (cpu.go:1355-1422, Skia scheme).
    rad = has_info & (tag == DRAW_TAG_RADIAL_GRADIENT)
    r0 = sc_f(5)
    r1 = sc_f(6)
    user_to_gradient = _inverse(xp, T)
    # Strip case (r0 ~= r1).
    is_strip = xp.abs(r0 - r1) < GRADIENT_EPSILON
    p0p1_dist = xp.sqrt((p1x_ - p0x_) ** 2 + (p1y_ - p0y_) ** 2)
    safe_dist = xp.where(p0p1_dist == 0.0, f32(1.0), p0p1_dist)
    scaled = r0 / safe_dist
    strip_xform = _mul(
        _two_point_to_unit_line(xp, p0x_, p0y_, p1x_, p1y_), user_to_gradient
    )
    strip_radius = scaled * scaled
    # Cone/circular/focal-on-circle cases.
    centers_eq = (p0x_ == p1x_) & (p0y_ == p1y_)
    cp0x = xp.where(centers_eq, p0x_ + GRADIENT_EPSILON, p0x_)
    cp0y = p0y_
    swapped = r1 == 0.0
    sp0x = xp.where(swapped, p1x_, cp0x)
    sp0y = xp.where(swapped, p1y_, cp0y)
    sp1x = xp.where(swapped, cp0x, p1x_)
    sp1y = xp.where(swapped, cp0y, p1y_)
    sr0 = xp.where(swapped, r1, r0)
    sr1 = xp.where(swapped, r0, r1)
    safe_dr = xp.where(sr0 == sr1, f32(1.0), sr0 - sr1)
    focal_x = sr0 / safe_dr
    cfx = sp0x * (1.0 - focal_x) + sp1x * focal_x
    cfy = sp0y * (1.0 - focal_x) + sp1y * focal_x
    cf_dist = xp.sqrt((cfx - sp1x) ** 2 + (cfy - sp1y) ** 2)
    safe_cf = xp.where(cf_dist == 0.0, f32(1.0), cf_dist)
    radius = sr1 / safe_cf
    user_to_unit_line = _mul(
        _two_point_to_unit_line(xp, cfx, cfy, sp1x, sp1y), user_to_gradient
    )
    is_focal_on_circle = xp.abs(radius - 1.0) <= GRADIENT_EPSILON
    foc_scale = 0.5 * xp.abs(1.0 - focal_x)
    zero = xp.zeros_like(foc_scale)
    xf_foc = _mul([foc_scale, zero, zero, foc_scale, zero, zero], user_to_unit_line)
    a_r = radius * radius - 1.0
    safe_ar = xp.where(a_r == 0.0, f32(1.0), a_r)
    scale_ratio = xp.abs(1.0 - focal_x) / safe_ar
    scale_x = radius * scale_ratio
    scale_y = xp.sqrt(xp.abs(a_r)) * scale_ratio
    xf_cone = _mul([scale_x, zero, zero, scale_y, zero, zero], user_to_unit_line)
    xf_noncone = [xp.where(is_focal_on_circle, xf_foc[i], xf_cone[i]) for i in range(6)]
    kind = xp.where(
        is_strip,
        xp.uint32(RAD_GRAD_KIND_STRIP),
        xp.where(
            centers_eq,
            xp.uint32(RAD_GRAD_KIND_CIRCULAR),
            xp.uint32(RAD_GRAD_KIND_CONE),
        ),
    )
    kind = xp.where(
        ~is_strip & is_focal_on_circle,
        xp.uint32(RAD_GRAD_KIND_FOCAL_ON_CIRCLE),
        kind,
    )
    flags = xp.where(~is_strip & swapped, xp.uint32(RAD_GRAD_SWAPPED), xp.uint32(0))
    xform = [xp.where(is_strip, strip_xform[i], xf_noncone[i]) for i in range(6)]
    out_focal_x = xp.where(is_strip, zero, focal_x)
    out_radius = xp.where(is_strip, strip_radius, radius)
    for i in range(6):
        wrf(rad, 1 + i, xform[i])
    wrf(rad, 7, out_focal_x)
    wrf(rad, 8, out_radius)
    wr(rad, 9, (flags << 3) | kind)

    # Sweep gradient (cpu.go:1424-1439).
    swp = has_info & (tag == DRAW_TAG_SWEEP_GRADIENT)
    sw_xform = _inverse(
        xp, _mul(T, [xp.ones_like(p0x_), zero, zero, xp.ones_like(p0x_), p0x_, p0y_])
    )
    for i in range(6):
        wrf(swp, 1 + i, sw_xform[i])
    wr(swp, 7, sc_u(3))
    wr(swp, 8, sc_u(4))

    # Image (cpu.go:1441-1451).
    img = has_info & (tag == DRAW_TAG_IMAGE)
    img_xform = _inverse(xp, T)
    for i in range(6):
        wrf(img, 1 + i, img_xform[i])
    wr(img, 7, sc_u(0))
    wr(img, 8, sc_u(1))

    # Clip stream inputs (cpu.go:1458-1465): both arrays ride ONE
    # scatter into a [NC, 2] target.
    m_clip = monoids["clip_idx"].astype(xp.int32)
    is_begin = act & (tag == DRAW_TAG_BEGIN_CLIP)
    is_end = act & (tag == DRAW_TAG_END_CLIP)
    clip_tgt = xp.where(is_begin | is_end, m_clip, NC)
    clip_path = xp.where(is_begin, m_path, ~di_draw)
    both = ops.scatter_set(
        xp, xp.zeros((NC, 2), dtype=xp.int32), clip_tgt,
        xp.stack([di_draw, clip_path], axis=1),
    )
    clip_idx_arr = both[:, 0]
    clip_path_idx_arr = both[:, 1]
    info_tab = xp.stack(cols, axis=1)
    return info_tab, clip_idx_arr, clip_path_idx_arr, tag, dd, di
