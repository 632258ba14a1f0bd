"""Flatten stage: paths -> line soup, in torch.

Counterpart of `jello_tpu/pipeline/flatten.py::flatten_stage` and its
helpers (`decode_tag_stream`, `slot_geometry`, `expand_by_counts`,
`euler_line_points`, `finalize_path_bbox`) on jello_tpu's accelerator
route: the per-slot tables come from kernel L, the worklist marks land
through kernel C, the adaptive subdivision walk is kernel D and the
Euler lines come from kernel E (on CPU tensors, their plain versions;
`slot_tables_plain` is L's).

One slot per path tag byte. Fills are flattened in device space with
zero offset; the stroke families (offsets, caps, joins, round arcs)
share the per-slot geometry. Line end points are computed independently
per line and chained watertight by shifting within each (work item,
pass) group.
"""

from __future__ import annotations

import math

import torch

from ..encoding.path import (
    FLAGS_CAP_BITS_ROUND,
    FLAGS_CAP_BITS_SQUARE,
    FLAGS_END_CAP_MASK,
    FLAGS_FILL_BIT,
    FLAGS_JOIN_BITS_BEVEL,
    FLAGS_JOIN_BITS_MITER,
    FLAGS_JOIN_BITS_ROUND,
    FLAGS_JOIN_MASK,
    FLAGS_START_CAP_MASK,
    FLAGS_STYLE_BIT,
    MITER_LIMIT_MASK,
    PATH_TAG_F32_BIT,
    PATH_TAG_PATH,
    PATH_TAG_SEG_TYPE_MASK,
    PATH_TAG_SUBPATH_END_BIT,
)

from .. import flatten_math as fm
from .. import pmath as pm
from ..pmath import rdiv
from . import lockstep, ops
from .ops import F32, I32
from .pathtag import tag_monoid_scan

DRAW_INFO_FLAGS_FILL_RULE_BIT = 1

_SEG_LINE = 1
_SEG_QUAD = 2


def f16_to_f32(bits: torch.Tensor) -> torch.Tensor:
    """IEEE binary16 bits (int32 in [0, 65535]) -> float32."""
    b = torch.where(bits >= 32768, bits - 65536, bits)
    return b.to(torch.int16).view(torch.float16).to(F32)


def decode_tag_stream(scene, path_tag_base, n_slots):
    """Per-byte tag values (int32) for slots [0, n_slots)."""
    i = ops.iota(n_slots, scene.device)
    words = ops.gather_guarded(scene, path_tag_base + (i >> 2))
    return (words >> ((i & 3) << 3)) & 0xFF


def _read_points(scene, base_words, tag):
    """Read a path segment as cubic control points (before normalization).
    Returns (p0x..p3y, seg_type)."""
    is_f32 = (tag & PATH_TAG_F32_BIT) != 0
    seg_type = tag & PATH_TAG_SEG_TYPE_MASK
    N = base_words.shape[0]
    offs = ops.iota(8, scene.device)[:, None]
    W = ops.gather_guarded(scene, (base_words[None, :] + offs).reshape(-1)).reshape(8, N)

    def rdf(off):
        return ops.bitcast_u32_f32(W[off])

    def rdi16(off):
        w = W[off]
        return ((w << 16) >> 16).to(F32), (w >> 16).to(F32)

    out = []
    for k in range(4):
        ix, iy = rdi16(k)
        out.append(torch.where(is_f32, rdf(2 * k), ix))
        out.append(torch.where(is_f32, rdf(2 * k + 1), iy))
    return (*out, seg_type)


def _normalize_segment(pts, seg_type, tag, is_stroke):
    """Cap-marker remap + degree raise."""
    p0x, p0y, p1x, p1y, p2x, p2y, p3x, p3y = pts
    is_marker = is_stroke & ((tag & PATH_TAG_SUBPATH_END_BIT) != 0)
    is_open = seg_type == _SEG_QUAD
    remap = is_marker & is_open
    p0x, p0y, p1x, p1y = (
        torch.where(remap, p1x, p0x),
        torch.where(remap, p1y, p0y),
        torch.where(remap, p2x, p1x),
        torch.where(remap, p2y, p1y),
    )
    seg_type = torch.where(remap, _SEG_LINE, seg_type)

    is_line = seg_type == _SEG_LINE
    is_quad = seg_type == _SEG_QUAD
    third = 1.0 / 3.0
    l3x, l3y = p1x, p1y
    l2x = l3x + (p0x - l3x) * third
    l2y = l3y + (p0y - l3y) * third
    l1x = p0x + (l3x - p0x) * third
    l1y = p0y + (l3y - p0y) * third
    q3x, q3y = p2x, p2y
    q2x = p1x + (p2x - p1x) * third
    q2y = p1y + (p2y - p1y) * third
    q1x = p1x + (p0x - p1x) * third
    q1y = p1y + (p0y - p1y) * third

    def pick(lv, qv, cv):
        return torch.where(is_line, lv, torch.where(is_quad, qv, cv))

    return ((p0x, p0y, pick(l1x, q1x, p1x), pick(l1y, q1y, p1y),
             pick(l2x, q2x, p2x), pick(l2y, q2y, p2y),
             pick(l3x, q3x, p3x), pick(l3y, q3y, p3y)),
            seg_type, is_marker, is_open)


def _transform_read(scene, transform_base, trans_idx):
    base = transform_base + trans_idx * 6
    return [ops.bitcast_u32_f32(ops.gather_guarded(scene, base + i)) for i in range(6)]


def apply_transform(t, x, y):
    return t[0] * x + t[2] * y + t[4], t[1] * x + t[3] * y + t[5]


def expand_by_counts(counts, out_cap, total=None, land=False):
    """For counts[r] items per record, produce for each output slot
    j < out_cap its (record index, index within record, valid flag).

    Every nonzero record marks (its index, its exclusive offset) at its
    exclusive offset (offsets of nonzero records are distinct and
    increasing), and a running max (one column scan of both, kernel I)
    fills both forward across the record's run. The marks are a scatter,
    or with `land` they land through kernel C, as jello_tpu's worklist
    marks do on its accelerator (`flatten.py:396-415`); both give the
    same result.
    Returns (rec, within, valid, excl, total)."""
    from ..cuda.scan import column_scan

    dev = counts.device
    counts = counts.to(I32)
    R = counts.shape[0]
    incl = torch.cumsum(counts, 0, dtype=I32)
    excl = incl - counts
    if total is None:
        total = incl[-1] if R > 0 else torch.zeros((), dtype=I32, device=dev)
    r_ids = ops.iota(R, dev)
    j = ops.iota(out_cap, dev)
    if land:
        from ..cuda.land import monotone_land

        m0, m1 = monotone_land(excl, counts > 0, [r_ids, excl], out_cap)
        m = column_scan([m0.to(I32), m1.to(I32)], "max")
    else:
        marks = ops.scatter_max(
            torch.zeros((out_cap, 2), dtype=I32, device=dev),
            torch.where(counts > 0, excl, out_cap),
            torch.stack([r_ids, excl], dim=1),
        )
        m = column_scan([marks[:, 0], marks[:, 1]], "max")
    return m[0], j - m[1], j < total, excl, total


def _normalize_vec(vx, vy):
    ln = pm.sqrt(vx * vx + vy * vy)
    return vx / ln, vy / ln


def _fix_tangent(tx, ty):
    small = tx * tx + ty * ty < fm.TANGENT_THRESH * fm.TANGENT_THRESH
    return (torch.where(small, torch.full_like(tx, fm.TANGENT_THRESH), tx),
            torch.where(small, torch.zeros_like(ty), ty))


def slot_geometry(tags, tags_next, pts_raw, pts_next_raw, seg_type0,
                  seg_type0_next, is_stroke, is_stroke_next, style_flags,
                  linewidth, miter_limit, T, path_idx, active):
    """Per-slot flatten geometry: segment normalization, stroke offset
    frames, caps/joins/miter spikes, round-join/cap arc records and the
    two 21-column Euler work tables (counterpart of
    `jello_tpu.pipeline.flatten.slot_geometry`)."""
    P, seg_type, is_marker, is_open = _normalize_segment(
        pts_raw, seg_type0, tags, is_stroke)
    seg_mask = active & (seg_type0 != 0)
    offset = 0.5 * linewidth

    v1x, v1y = T[0] + T[3], T[1] - T[2]
    v2x, v2y = T[0] - T[3], T[1] + T[2]
    stroke_scale = 0.5 * pm.sqrt(v1x * v1x + v1y * v1y) + pm.sqrt(
        v2x * v2x + v2y * v2y)
    one = torch.ones_like(offset)
    zero = torch.zeros_like(offset)
    scale = torch.where(is_stroke, stroke_scale, one)

    PD = []
    for k in range(4):
        PD.extend(apply_transform(T, P[2 * k], P[2 * k + 1]))

    P_next, _, _, _ = _normalize_segment(
        pts_next_raw, seg_type0_next, tags_next, is_stroke_next)
    tan_px, tan_py = _fix_tangent(*fm.cubic_end_tangent(*P))
    tan_nx, tan_ny = _fix_tangent(*fm.cubic_start_tangent(*P_next))
    tan_sx, tan_sy = _fix_tangent(*fm.cubic_start_tangent(*P))

    nsx, nsy = _normalize_vec(-tan_sy, tan_sx)
    nsx, nsy = nsx * offset, nsy * offset
    otx, oty = _normalize_vec(tan_px, tan_py)
    otx, oty = otx * offset, oty * offset
    npx, npy = -oty, otx
    nnxn, nnyn = _normalize_vec(tan_nx, tan_ny)
    nnx, nny = -nnyn * offset, nnxn * offset

    next_is_marker = (tags_next & PATH_TAG_SUBPATH_END_BIT) != 0
    next_is_closed = (tags_next & PATH_TAG_SEG_TYPE_MASK) == _SEG_LINE
    do_join = (~next_is_marker) | next_is_closed

    regular = seg_mask & is_stroke & ~is_marker
    start_cap_slot = seg_mask & is_stroke & is_marker & is_open

    PA = [torch.where(is_stroke, P[i], PD[i]) for i in range(8)]
    off_a = torch.where(is_stroke, offset, zero)
    act_a = seg_mask & (~is_stroke | regular)
    tstart_ax = torch.where(is_stroke, P[0] + nsx, PD[0])
    tstart_ay = torch.where(is_stroke, P[1] + nsy, PD[1])
    tend_ax = torch.where(is_stroke, P[6] + npx, PD[6])
    tend_ay = torch.where(is_stroke, P[7] + npy, PD[7])

    off_b = -offset
    act_b = regular
    tstart_bx = P[0] - nsx
    tstart_by = P[1] - nsy
    tend_bx = P[6] - npx
    tend_by = P[7] - npy

    p3x, p3y = P[6], P[7]
    p0x, p0y = P[0], P[1]

    join_kind = style_flags & FLAGS_JOIN_MASK
    cr = tan_px * tan_ny - tan_py * tan_nx
    dd = tan_px * tan_nx + tan_py * tan_ny

    front0x, front0y = p3x + npx, p3y + npy
    front1x, front1y = p3x + nnx, p3y + nny
    back0x, back0y = p3x - nnx, p3y - nny
    back1x, back1y = p3x - npx, p3y - npy

    hyp = pm.sqrt(cr * cr + dd * dd)
    miter_cond = (2.0 * hyp < (hyp + dd) * miter_limit * miter_limit) & (cr != 0.0)
    is_backside = cr > 0.0
    fp_last_x = torch.where(is_backside, back1x, front0x)
    fp_last_y = torch.where(is_backside, back1y, front0y)
    fp_this_x = torch.where(is_backside, back0x, front1x)
    fp_this_y = torch.where(is_backside, back0y, front1y)
    p_mx = torch.where(is_backside, back0x, front0x)
    p_my = torch.where(is_backside, back0y, front0y)
    vx_m = fp_this_x - fp_last_x
    vy_m = fp_this_y - fp_last_y
    safe_cr = torch.where(cr == 0.0, one, cr)
    h_m = (tan_px * vy_m - tan_py * vx_m) / safe_cr
    miter_px = fp_this_x - tan_nx * h_m
    miter_py = fp_this_y - tan_ny * h_m
    is_miter = join_kind == FLAGS_JOIN_BITS_MITER
    apply_miter = is_miter & miter_cond
    front0x = torch.where(apply_miter & ~is_backside, miter_px, front0x)
    front0y = torch.where(apply_miter & ~is_backside, miter_py, front0y)
    back0x_j = torch.where(apply_miter & is_backside, miter_px, back0x)
    back0y_j = torch.where(apply_miter & is_backside, miter_py, back0y)

    is_bevel = join_kind == FLAGS_JOIN_BITS_BEVEL
    is_round_join = join_kind == FLAGS_JOIN_BITS_ROUND
    bevel_valid = ((front0x != front1x) | (front0y != front1y)) & (
        (back0x_j != back1x) | (back0y_j != back1y))

    arcj_0x = torch.where(is_backside, back0x, front0x)
    arcj_0y = torch.where(is_backside, back0y, front0y)
    arcj_1x = torch.where(is_backside, back1x, front1x)
    arcj_1y = torch.where(is_backside, back1y, front1y)
    otherj_0x = torch.where(is_backside, front0x, back0x)
    otherj_0y = torch.where(is_backside, front0y, back0y)
    otherj_1x = torch.where(is_backside, front1x, back1x)
    otherj_1y = torch.where(is_backside, front1y, back1y)

    join_slot = regular & do_join
    cap_end_slot = regular & ~do_join

    ec_style = style_flags & FLAGS_END_CAP_MASK
    ec_c0x, ec_c0y = p3x + npx, p3y + npy
    ec_c1x, ec_c1y = p3x - npx, p3y - npy
    ec_vx, ec_vy = otx, oty

    sc_style = ops.shr(style_flags & FLAGS_START_CAP_MASK, 2)
    sc_otx, sc_oty = _normalize_vec(tan_sx, tan_sy)
    sc_otx, sc_oty = sc_otx * offset, sc_oty * offset
    sc_nx, sc_ny = -sc_oty, sc_otx
    sc_c0x, sc_c0y = p0x - sc_nx, p0y - sc_ny
    sc_c1x, sc_c1y = p0x + sc_nx, p0y + sc_ny
    sc_vx, sc_vy = -sc_otx, -sc_oty

    cap_slot = cap_end_slot | start_cap_slot

    def by_cap(s, e):
        return torch.where(start_cap_slot, s, e)

    cap_style = by_cap(sc_style, ec_style)
    cap_px, cap_py = by_cap(p0x, p3x), by_cap(p0y, p3y)
    cap_0x, cap_0y = by_cap(sc_c0x, ec_c0x), by_cap(sc_c0y, ec_c0y)
    cap_1x, cap_1y = by_cap(sc_c1x, ec_c1x), by_cap(sc_c1y, ec_c1y)
    cap_vx, cap_vy = by_cap(sc_vx, ec_vx), by_cap(sc_vy, ec_vy)
    cap_round = cap_style == FLAGS_CAP_BITS_ROUND
    cap_square = cap_style == FLAGS_CAP_BITS_SQUARE

    def sel3(jc, cc):
        return torch.where(join_slot, jc, torch.where(cap_slot, cc, zero))

    s0_valid = (
        (join_slot & ((is_bevel & bevel_valid) | is_miter | is_round_join))
        | (cap_slot & ~cap_round)
    )
    j0x = torch.where(is_round_join, otherj_0x, front0x)
    j0y = torch.where(is_round_join, otherj_0y, front0y)
    j1x = torch.where(is_round_join, otherj_1x, front1x)
    j1y = torch.where(is_round_join, otherj_1y, front1y)
    c1x = torch.where(cap_square, cap_0x + cap_vx, cap_1x)
    c1y = torch.where(cap_square, cap_0y + cap_vy, cap_1y)
    s0 = (sel3(j0x, cap_0x), sel3(j0y, cap_0y), sel3(j1x, c1x), sel3(j1y, c1y))

    s1_valid = (join_slot & ((is_bevel & bevel_valid) | is_miter)) | (
        cap_slot & cap_square)
    s1 = (sel3(back0x_j, cap_1x + cap_vx), sel3(back0y_j, cap_1y + cap_vy),
          sel3(back1x, cap_1x), sel3(back1y, cap_1y))

    s2_valid = (join_slot & apply_miter) | (cap_slot & cap_square)
    s2 = (sel3(p_mx, cap_0x + cap_vx), sel3(p_my, cap_0y + cap_vy),
          sel3(miter_px, cap_1x + cap_vx), sel3(miter_py, cap_1y + cap_vy))

    arc_valid = (join_slot & is_round_join) | (cap_slot & cap_round)

    def by_join(jv, cv):
        return torch.where(join_slot, jv, cv)

    arc_bx, arc_by = by_join(arcj_0x, cap_0x), by_join(arcj_0y, cap_0y)
    arc_ex, arc_ey = by_join(arcj_1x, cap_1x), by_join(arcj_1y, cap_1y)
    arc_cx, arc_cy = by_join(p3x, cap_px), by_join(p3y, cap_py)
    arc_angle = by_join(torch.abs(pm.arctan2(cr, dd)), zero + math.pi)
    tol = fm.FLATTEN_TOL
    ab_tx, ab_ty = apply_transform(T, arc_bx, arc_by)
    ac_tx, ac_ty = apply_transform(T, arc_cx, arc_cy)
    radius = torch.clamp(
        pm.sqrt((ab_tx - ac_tx) ** 2 + (ab_ty - ac_ty) ** 2), min=tol)
    arc_theta = torch.clamp(
        2.0 * pm.arccos(torch.clamp(1.0 - rdiv(tol, radius), -1.0, 1.0)), min=0.0001)
    arc_n = torch.clamp(torch.ceil(arc_angle / arc_theta), min=1.0)
    arc_n = torch.where(arc_valid, arc_n, zero)

    s_lines = []
    for sv, sc_ in ((s0_valid, s0), (s1_valid, s1), (s2_valid, s2)):
        x0t, y0t = apply_transform(T, sc_[0], sc_[1])
        x1t, y1t = apply_transform(T, sc_[2], sc_[3])
        s_lines.append((sv, x0t, y0t, x1t, y1t))

    fpath = path_idx.to(F32)
    ident = (1.0, 0.0, 0.0, 1.0, 0.0, 0.0)
    TA = [torch.where(is_stroke, T[i], zero + ident[i]) for i in range(6)]
    tabA = PA + [off_a, scale, tstart_ax, tstart_ay, tend_ax, tend_ay] + TA + [fpath]
    tabB = list(P) + [off_b, scale, tstart_bx, tstart_by, tend_bx, tend_by] + list(T) + [fpath]
    return {
        "tabA": tabA, "tabB": tabB, "act_a": act_a, "act_b": act_b,
        "s_lines": s_lines, "arc_n": arc_n, "arc_theta": arc_theta,
        "arc_bx": arc_bx, "arc_by": arc_by, "arc_ex": arc_ex, "arc_ey": arc_ey,
        "arc_cx": arc_cx, "arc_cy": arc_cy,
    }


def slot_tables_plain(scene, layout, tags_e, mono, N, tag_lo, n_paths_cap):
    """Plain version of kernel L (`cuda/slot_tables.py::slot_tables`, its
    CPU route): flatten's per-slot tables. tags_e: the tag bytes of Ne
    slots from tag slot `tag_lo` on (`decode_tag_stream`); mono: the tag
    monoid's exclusive columns (`pathtag.tag_monoid_scan`) over them. For
    each of the stage's N slots it reads its segment, style and
    transform, and its successor's segment: slot i + 1's, or with Ne == N
    slot 0's for the last (`jello_tpu/pipeline/flatten.py:728-780`).
    Returns {"tab2": [2N, 21] f32, the Euler work rows of pass A then B;
    "counts2": [2N] i32, act_a then act_b; "sa": [4N, 15] f32, the three
    simple-line families' rows then the arc rows; "orow": [N, 3] i32, the
    running simple-line counts; "tot4": [N] i32, those and the arc's
    lines; "tgt": [N] i32, the path a path-marker slot sets (n_paths_cap
    elsewhere); "pmeta": [N, 2] i32, its draw flags and transform index;
    "arc_n": [N] f32}."""
    dev = scene.device
    Ne = mono["path_idx"].shape[0]
    if Ne == N:
        def cur(a):
            return a

        def nxt(a):
            return torch.cat([a[1:], a[:1]])
    else:
        def cur(a):
            return a[:N]

        def nxt(a):
            return a[1:N + 1]

    tags = cur(tags_e)
    active = ops.iota(N, dev) + tag_lo < layout["n_path_tags"]

    trans_idx = cur(mono["trans_idx"]) - 1
    style_idx_e = mono["style_idx"] - 2
    path_idx = cur(mono["path_idx"])
    seg_off_e = mono["path_seg_offset"]

    style_flags_e = ops.gather_guarded(scene, layout["style_base"] + style_idx_e)
    style_flags = cur(style_flags_e)
    linewidth = ops.bitcast_u32_f32(
        ops.gather_guarded(scene, layout["style_base"] + cur(style_idx_e) + 1))

    marker = active & ((tags & PATH_TAG_PATH) != 0)
    tgt_idx = torch.where(marker, path_idx, n_paths_cap)

    raw = _read_points(scene, layout["path_data_base"] + seg_off_e, tags_e)
    pts_raw_e, seg_type0_e = raw[:8], raw[8]
    is_stroke_e = (style_flags_e & ops.s32(FLAGS_STYLE_BIT)) != 0
    T = _transform_read(scene, layout["transform_base"], trans_idx)
    miter_limit = f16_to_f32(style_flags & MITER_LIMIT_MASK)

    g = slot_geometry(
        tags, nxt(tags_e), [cur(a) for a in pts_raw_e], [nxt(a) for a in pts_raw_e],
        cur(seg_type0_e), nxt(seg_type0_e), cur(is_stroke_e), nxt(is_stroke_e),
        style_flags, linewidth, miter_limit, T, path_idx, active,
    )

    df = torch.where((style_flags & FLAGS_FILL_BIT) == 0, 0,
                     DRAW_INFO_FLAGS_FILL_RULE_BIT).to(I32)
    act_a32 = g["act_a"].to(I32)
    act_b32 = g["act_b"].to(I32)
    counts2 = torch.cat([act_a32, act_b32])
    tab2 = torch.cat([torch.stack(g["tabA"], dim=1), torch.stack(g["tabB"], dim=1)])

    fpath = path_idx.to(F32)
    zcol = torch.zeros(3 * N, dtype=F32, device=dev)
    stab = torch.stack(
        [torch.cat([g["s_lines"][k][c] for k in range(3)]) for c in range(1, 5)]
        + [zcol] * 10 + [torch.cat([fpath, fpath, fpath])], dim=1)
    arc_n = g["arc_n"]
    atab = torch.stack(
        [g["arc_bx"], g["arc_by"], g["arc_ex"], g["arc_ey"], g["arc_cx"],
         g["arc_cy"], g["arc_theta"], arc_n] + list(T) + [fpath], dim=1)
    c012 = [sl[0].to(I32) for sl in g["s_lines"]]
    o1 = c012[0]
    o2 = o1 + c012[1]
    o3 = o2 + c012[2]
    tot4 = o3 + arc_n.to(I32)
    return {"tab2": tab2, "counts2": counts2, "sa": torch.cat([stab, atab]),
            "orow": torch.stack([o1, o2, o3], dim=1), "tot4": tot4, "tgt": tgt_idx,
            "pmeta": torch.stack([df, trans_idx], dim=1), "arc_n": arc_n}


def flatten_stage(scene, layout, caps, shard=None):
    """Run the flatten stage.

    scene: int32 scene words; layout: the unpacked layout
    (`pipeline.render.unpack_layout`: 0-dim int32 path_tag_base,
    path_data_base, style_base, transform_base, n_path_tags); caps: the
    capacity class (n_tag_slots, max_iters, work_a_cap, work_b_cap,
    euler_line_cap, simple_line_cap, arc_line_cap, line_cap,
    n_paths_cap). Returns the line soup, per-path bboxes/flags, the
    actual-use counters and the overflow flag.

    shard: for a tag-range shard of `cuda/sharded2.py`, {"tag_lo": the
    host int first slot (a multiple of 4), "monoid_base": int32 [5], the
    monoid deltas of the tags before it (`pathtag.tag_monoid_scan`)}: the
    stage then flattens slots [tag_lo, tag_lo + n_tag_slots), decoding 4
    slots more so that the last slot's successor is local
    (`jello_tpu/pipeline/flatten.py:728-780`). Either way it returns the
    raw per-path bbox accumulator `bb_acc` too, for the caller to combine
    across shards by maximum before `finalize_path_bbox`."""
    from ..cuda import expand as kx
    from ..cuda.lockstep import lockstep_walk
    from ..cuda.slot_tables import slot_tables

    dev = scene.device
    N = caps["n_tag_slots"]
    IT = caps["max_iters"]
    n_paths_cap = caps["n_paths_cap"]

    # Slots decoded (_e): the stage's own, and under a shard the 4 past it.
    Ne, tag_lo, base = (N, 0, None) if shard is None else (
        N + 4, shard["tag_lo"], shard["monoid_base"])
    tags_e = decode_tag_stream(scene, layout["path_tag_base"] + tag_lo // 4, Ne)
    mono = tag_monoid_scan(tags_e, base)
    st = slot_tables(scene, layout, tags_e, mono, N, tag_lo, n_paths_cap)

    pmeta = ops.scatter_set(
        torch.zeros((n_paths_cap, 2), dtype=I32, device=dev), st["tgt"], st["pmeta"])
    path_draw_flags = pmeta[:, 0]
    path_trans_idx = pmeta[:, 1]

    # One merged worklist over both Euler passes (A-items in slot order,
    # then B-items), and one lockstep walk over it.
    NWAB = caps["work_a_cap"] + caps["work_b_cap"]
    counts2 = st["counts2"]
    # jello_tpu's accelerator route (`flatten.py:900-954`): the worklist
    # marks land through kernel C, the walk is kernel D and the Euler
    # lines come from kernel E.
    wl, _, wl_valid, _, nab = expand_by_counts(counts2, NWAB, land=True)
    na = counts2[:N].sum()
    nb = counts2[N:].sum()

    rows = ops.gather_guarded(st["tab2"], wl)
    EC = caps["euler_line_cap"]
    rec, count, not_done, lockstep_iters = lockstep_walk(rows, wl_valid, IT)
    # e_total counts one dead slot per zero-count work row (the
    # expansion's clamp): it sizes the stream; e_real is the lines.
    e_x0, e_y0, e_x1, e_y1, e_path, e_valid, e_total = kx.expand_euler(
        rows, rec, count.to(I32), EC, n_paths_cap)
    e_real = count.sum().to(I32)
    overflow_euler = not_done.any() | (nab > NWAB)

    # Simple lines + arc lines: one merged per-slot expansion over the
    # three simple-line families and the arcs, demuxed per output row.
    SC = caps["simple_line_cap"]
    AC = caps["arc_line_cap"]
    sa_slot, sa_w, sa_valid, _, sa_total = expand_by_counts(st["tot4"], SC + AC)
    orow = ops.gather_guarded(st["orow"], sa_slot)
    fam = ((sa_w >= orow[:, 0]).to(I32) + (sa_w >= orow[:, 1]).to(I32)
           + (sa_w >= orow[:, 2]).to(I32))
    sarow = ops.gather_guarded(st["sa"], fam * N + sa_slot)
    is_arc = fam == 3
    a_bx, a_by, a_ex, a_ey = sarow[:, 0], sarow[:, 1], sarow[:, 2], sarow[:, 3]
    a_cx, a_cy, a_theta, a_n = sarow[:, 4], sarow[:, 5], sarow[:, 6], sarow[:, 7]
    Ta = [sarow[:, 8 + i] for i in range(6)]
    sa_path = sarow[:, 14].to(I32)
    r0x = a_bx - a_cx
    r0y = a_by - a_cy

    def arc_pt(i_f):
        ang = i_f * a_theta
        c = pm.cos(ang)
        s = pm.sin(ang)
        return apply_transform(Ta, a_cx + (c * r0x + s * r0y),
                                a_cy + (-s * r0x + c * r0y))

    a_if = (sa_w - orow[:, 2]).to(F32)
    al1x, al1y = arc_pt(a_if + 1.0)
    endx, endy = apply_transform(Ta, a_ex, a_ey)
    last = a_if == a_n - 1.0
    al1x = torch.where(last, endx, al1x)
    al1y = torch.where(last, endy, al1y)
    al0x, al0y = arc_pt(a_if)
    beginx, beginy = apply_transform(Ta, a_bx, a_by)
    al0x = torch.where(a_if == 0.0, beginx, al0x)
    al0y = torch.where(a_if == 0.0, beginy, al0y)
    sa_x0 = torch.where(is_arc, al0x, a_bx)
    sa_y0 = torch.where(is_arc, al0y, a_by)
    sa_x1 = torch.where(is_arc, al1x, a_ex)
    sa_y1 = torch.where(is_arc, al1y, a_ey)

    # The soup: the Euler block then the simple/arc block, padded to LC.
    LC = caps["line_cap"]
    pad = LC - (EC + SC + AC)

    def family(ve, vsa, fill=0.0):
        out = torch.cat([ve, vsa])
        if pad > 0:
            out = torch.cat([out, torch.full((pad,), fill, dtype=out.dtype, device=dev)])
        return out

    lx0 = family(e_x0, sa_x0)
    ly0 = family(e_y0, sa_y0)
    lx1 = family(e_x1, sa_x1)
    ly1 = family(e_y1, sa_y1)
    lpath = family(torch.where(e_valid, e_path, n_paths_cap),
                   torch.where(sa_valid, sa_path, n_paths_cap), fill=n_paths_cap)
    line_valid = lpath < n_paths_cap

    big = 1e30
    pidx = torch.where(line_valid, lpath, n_paths_cap)
    bb_acc = ops.scatter_max(
        torch.full((n_paths_cap, 4), -big, dtype=F32, device=dev), pidx,
        torch.stack([-torch.minimum(lx0, lx1), -torch.minimum(ly0, ly1),
                     torch.maximum(lx0, lx1), torch.maximum(ly0, ly1)], dim=1))

    overflow = (overflow_euler | (e_total > EC) | (sa_total > SC + AC)
                | ((e_total + sa_total) > LC))
    return {
        "line_x0": lx0, "line_y0": ly0, "line_x1": lx1, "line_y1": ly1,
        "line_path": lpath, "line_valid": line_valid,
        "n_lines": e_total + sa_total,
        "n_work_a": na, "n_work_b": nb,
        "e_total": e_total, "e_real": e_real,
        "s_total": st["orow"][:, 2].sum(), "a_total": st["arc_n"].to(I32).sum(),
        "lockstep_iters": lockstep_iters,
        "path_bbox": finalize_path_bbox(bb_acc),
        "bb_acc": bb_acc,
        "path_draw_flags": path_draw_flags,
        "path_trans_idx": path_trans_idx,
        "overflow": overflow,
    }


def finalize_path_bbox(bb_acc):
    """Raw (negated-min, max) accumulator -> floored/ceiled bbox, with
    the sentinel for line-less paths."""
    bb_x0 = -bb_acc[:, 0]
    bb_y0 = -bb_acc[:, 1]
    bb_x1 = bb_acc[:, 2]
    bb_y1 = bb_acc[:, 3]
    empty = bb_x0 > bb_x1
    hi = torch.full_like(bb_x0, 2147483647.0)
    lo = torch.full_like(bb_x0, -2147483648.0)
    return torch.stack([
        torch.where(empty, hi, torch.floor(bb_x0)),
        torch.where(empty, hi, torch.floor(bb_y0)),
        torch.where(empty, lo, torch.ceil(bb_x1)),
        torch.where(empty, lo, torch.ceil(bb_y1)),
    ], dim=1)


def euler_line_points(P8, t0, t1, i, n, offset, scale, tend_x, tend_y):
    """End point of line i (of n) of the Euler segment over [t0, t1],
    recomputing the fit exactly as the lockstep walk did."""
    p0x, p0y, q0x, q0y, _ = lockstep.pq_at(P8, t0)
    p1x, p1y, q1x, q1y, _ = lockstep.pq_at(P8, t1)
    th0, th1, chord_len, _ = fm.cubic_params_from_points_derivs(
        p0x, p0y, p1x, p1y, q0x, q0y, q1x, q1y, t1 - t0)
    k0, k1, ch = fm.euler_params_from_angles(th0, th1)
    _, robust, a, b, int0, integral, norm_off = fm.espc_subdivision(
        k0, k1, ch, chord_len, offset, scale)
    fi = i.to(F32)
    t = (fi + 1.0) / torch.clamp(n, min=1.0)
    s = fm.espc_s_of_t(t, robust, a, b, int0, integral)
    lx, ly = fm.euler_seg_eval_with_offset(p0x, p0y, p1x, p1y, k0, k1, ch, th0, s, norm_off)
    is_last = (fi == n - 1.0) & (t1 == 1.0)
    return torch.where(is_last, tend_x, lx), torch.where(is_last, tend_y, ly)
