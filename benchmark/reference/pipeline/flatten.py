"""Flatten stage: paths -> line soup (reference: shaders/cpu/flatten.go).

One "slot" per path tag byte. Fills are flattened in device space with
zero offset; strokes are flattened in local space with +/- half
line-width offsets via Euler-spiral parallel curves, plus caps, joins
and round-join/cap arcs, then transformed per line.

The reference's data-dependent adaptive subdivision loop
(flatten.go:400-522) becomes a *lockstep* loop over all slots: every
iteration advances each slot's (t0u, dt) interval walk, recording
emitted Euler segments as (t0, t1, n_lines) triples. Line output is then
produced by count -> exclusive scan -> searchsorted expansion, with each
line slot independently recomputing its point — the TPU replacement for
the reference's atomic bump allocation of the line buffer.

Watertightness: the reference chains each line's start point from the
previous line's end. We reproduce this exactly by computing all line
*end* points independently and then shifting within each (slot, pass)
group (the groups are contiguous in the expanded order).
"""

from __future__ import annotations

import numpy as _np

from .. import flatten_math as fm
from ..pmath import poly_xp
from ..encoding.path import (
    FLAGS_END_CAP_MASK,
    FLAGS_FILL_BIT,
    FLAGS_JOIN_BITS_BEVEL,
    FLAGS_JOIN_BITS_MITER,
    FLAGS_JOIN_BITS_ROUND,
    FLAGS_JOIN_MASK,
    FLAGS_START_CAP_MASK,
    FLAGS_STYLE_BIT,
    FLAGS_CAP_BITS_ROUND,
    FLAGS_CAP_BITS_SQUARE,
    MITER_LIMIT_MASK,
    PATH_TAG_F32_BIT,
    PATH_TAG_PATH,
    PATH_TAG_SEG_TYPE_MASK,
    PATH_TAG_SUBPATH_END_BIT,
)
from . import ops
from ..cpu.pathtag import tag_monoid_deltas

DRAW_INFO_FLAGS_FILL_RULE_BIT = 1

_SEG_LINE = 1
_SEG_QUAD = 2
_SEG_CUBIC = 3


def f16_to_f32(xp, bits_u16):
    """IEEE binary16 bits -> float32 (for the miter limit)."""
    return _np.asarray(bits_u16, dtype=_np.uint16).view(_np.float16).astype(_np.float32)


def decode_tag_stream(xp, scene, path_tag_base, n_slots):
    """Per-byte tag values for slots [0, n_slots).

    The tag stream is contiguous, so under jax this is one
    dynamic_slice + an elementwise byte unpack — no gather at all
    (element gathers cost ~10 ns/row on the TPU fabric; a slice is
    bandwidth-only)."""
    word_idx = path_tag_base + (xp.arange(n_slots, dtype=xp.int32) >> 2)
    words = ops.gather_guarded(xp, scene, word_idx)
    shift = (xp.arange(n_slots, dtype=xp.uint32) & 3) << 3
    return (words >> shift) & 0xFF


def exclusive_monoids(xp, tags, base=None):
    """Exclusive prefix of the tag monoid. `base` (optional dict of
    traced uint32 scalars per field) rebases the scan for a tag-range
    shard: local scan + the sum of all preceding shards' deltas — the
    classic two-level scan, with the cross-shard level done by the
    caller (one all_gather of per-shard totals)."""
    deltas = tag_monoid_deltas(tags)
    # All five monoid fields ride ONE column cumsum (cumsums cost per
    # row, not per column on the fabric).
    keys = sorted(deltas)
    d = xp.stack([deltas[k].astype(xp.uint32) for k in keys], axis=1)
    c = xp.cumsum(d, axis=0) - d
    out = {}
    for i, k in enumerate(keys):
        v = c[:, i]
        if base is not None:
            v = v + base[k].astype(xp.uint32)
        out[k] = v
    return out


def _read_points(xp, scene, base_words, tag, S8=None, rows=None):
    """Read and normalize a path segment to cubic control points.

    Returns (p0x..p3y, seg_type) after cap-marker remapping and
    degree-raising (reference: flatten.go readPathSegment).
    `base_words` is path_data_base + path_seg_offset.
    """
    is_f32 = (tag & PATH_TAG_F32_BIT) != 0
    seg_type = (tag & PATH_TAG_SEG_TYPE_MASK).astype(xp.int32)

    N = base_words.shape[0]
    if rows is not None:
        # Precomputed rows from the caller's merged S8 gather.
        W = rows.T
    elif S8 is not None:
        # One N-row gather of the shifted row table (cost ∝ N rows)
        # instead of an 8N-element batched gather (cost ∝ 8N rows).
        W = ops.gather_guarded(xp, S8, base_words).T
    else:
        offs = xp.arange(8, dtype=xp.int32)[:, None]
        idx = (base_words[None, :].astype(xp.int32) + offs).reshape(-1)
        W = ops.gather_guarded(xp, scene, idx).reshape(8, N)

    def rdf(off):
        return ops.bitcast_u32_f32(xp, W[off])

    def rdi16(off):
        w = W[off]
        x = ((w << 16).astype(xp.int32) >> 16).astype(xp.float32)
        y = (w.astype(xp.int32) >> 16).astype(xp.float32)
        return x, y

    # f32 layout: 2 words per point; i16: 1 word per point.
    i0x, i0y = rdi16(0)
    i1x, i1y = rdi16(1)
    i2x, i2y = rdi16(2)
    i3x, i3y = rdi16(3)
    p0x = xp.where(is_f32, rdf(0), i0x)
    p0y = xp.where(is_f32, rdf(1), i0y)
    p1x = xp.where(is_f32, rdf(2), i1x)
    p1y = xp.where(is_f32, rdf(3), i1y)
    p2x = xp.where(is_f32, rdf(4), i2x)
    p2y = xp.where(is_f32, rdf(5), i2y)
    p3x = xp.where(is_f32, rdf(6), i3x)
    p3y = xp.where(is_f32, rdf(7), i3y)
    return p0x, p0y, p1x, p1y, p2x, p2y, p3x, p3y, seg_type


def _normalize_segment(xp, pts, seg_type, tag, is_stroke):
    """Cap-marker remap + degree raise."""
    p0x, p0y, p1x, p1y, p2x, p2y, p3x, p3y = pts
    is_marker = is_stroke & ((tag & PATH_TAG_SUBPATH_END_BIT) != 0)
    is_open = seg_type == _SEG_QUAD
    remap = is_marker & is_open
    # p0 <- p1, p1 <- p2, becomes a line.
    p0x, p0y, p1x, p1y = (
        xp.where(remap, p1x, p0x),
        xp.where(remap, p1y, p0y),
        xp.where(remap, p2x, p1x),
        xp.where(remap, p2y, p1y),
    )
    seg_type = xp.where(remap, _SEG_LINE, seg_type)

    # Degree raise.
    is_line = seg_type == _SEG_LINE
    is_quad = seg_type == _SEG_QUAD
    # line: p3=p1; p2=mix(p3,p0,1/3); p1=mix(p0,p3,1/3)
    l3x, l3y = p1x, p1y
    l2x = l3x + (p0x - l3x) * (1.0 / 3.0)
    l2y = l3y + (p0y - l3y) * (1.0 / 3.0)
    l1x = p0x + (l3x - p0x) * (1.0 / 3.0)
    l1y = p0y + (l3y - p0y) * (1.0 / 3.0)
    # quad: p3=p2; p2=mix(p1,p2,1/3); p1=mix(p1,p0,1/3)
    q3x, q3y = p2x, p2y
    q2x = p1x + (p2x - p1x) * (1.0 / 3.0)
    q2y = p1y + (p2y - p1y) * (1.0 / 3.0)
    q1x = p1x + (p0x - p1x) * (1.0 / 3.0)
    q1y = p1y + (p0y - p1y) * (1.0 / 3.0)

    o1x = xp.where(is_line, l1x, xp.where(is_quad, q1x, p1x))
    o1y = xp.where(is_line, l1y, xp.where(is_quad, q1y, p1y))
    o2x = xp.where(is_line, l2x, xp.where(is_quad, q2x, p2x))
    o2y = xp.where(is_line, l2y, xp.where(is_quad, q2y, p2y))
    o3x = xp.where(is_line, l3x, xp.where(is_quad, q3x, p3x))
    o3y = xp.where(is_line, l3y, xp.where(is_quad, q3y, p3y))
    return (p0x, p0y, o1x, o1y, o2x, o2y, o3x, o3y), seg_type, is_marker, is_open


def _transform_read(xp, scene, transform_base, trans_idx, S8=None, rows=None):
    base = transform_base + trans_idx.astype(xp.int32) * 6
    if rows is not None:
        return [ops.bitcast_u32_f32(xp, rows[:, i]) for i in range(6)]
    if S8 is not None:
        rows = ops.gather_guarded(xp, S8, base)
        return [ops.bitcast_u32_f32(xp, rows[:, i]) for i in range(6)]
    t = [
        ops.bitcast_u32_f32(xp, ops.gather_guarded(xp, scene, base + i))
        for i in range(6)
    ]
    return t


def _apply_transform(t, x, y):
    return t[0] * x + t[2] * y + t[4], t[1] * x + t[3] * y + t[5]


def _pq_at(xp, P, t):
    """Point/derivative at t with the near-zero-derivative resampling
    rule of flatten.go:391-418 (uniform reformulation; see module doc)."""
    p0x, p0y, p1x, p1y, p2x, p2y, p3x, p3y = P
    px, py, qx, qy = fm.eval_cubic_and_deriv(p0x, p0y, p1x, p1y, p2x, p2y, p3x, p3y, t)
    small = qx * qx + qy * qy < fm.DERIV_THRESH * fm.DERIV_THRESH
    ts = xp.where(t == 0.0, xp.float32(fm.DERIV_EPS), t - fm.DERIV_EPS)
    px2, py2, qx2, qy2 = fm.eval_cubic_and_deriv(
        p0x, p0y, p1x, p1y, p2x, p2y, p3x, p3y, ts
    )
    qx = xp.where(small, qx2, qx)
    qy = xp.where(small, qy2, qy)
    interior = small & (t > 0.0) & (t < 1.0)
    px = xp.where(interior, px2, px)
    py = xp.where(interior, py2, py)
    t_adj = xp.where(interior, t - fm.DERIV_EPS, t)
    return px, py, qx, qy, t_adj


def lockstep_euler_pass(xp, P, offset, scale, active, max_emits, max_iters):
    """Run the adaptive subdivision walk for all slots in lockstep.

    P: 8 arrays of cubic control points (flatten space).
    offset: per-slot signed stroke offset (0 for fills).

    Records are stored iteration-major: each loop iteration writes one
    dense row (every slot emits at most one Euler segment per
    iteration; non-emitting slots write n=0). This keeps the loop free
    of scattered writes — dense row updates only — which is what the
    TPU wants. Flattened slot-major ([N, IT]) the records of one slot
    are contiguous and in emission order, which the expansion relies on
    for watertight line chaining.

    Returns (rec_t0, rec_t1, rec_n [IT, N] f32, overflowed bool,
    iters_used i32) where IT == max_iters and iters_used is the number
    of loop iterations actually executed (the host-calibration input
    for shrinking max_iters — the lockstep Pallas kernel and the euler
    expansion's record scan are both unrolled proportionally to it).
    """
    xp = poly_xp(xp)  # shared polynomial transcendentals (pmath.py)
    N = P[0].shape[0]
    IT = max_iters
    f32 = xp.float32
    # Materialize the inputs: without this XLA fuses their (gather-heavy)
    # producers into the while body and recomputes them every iteration.
    P = list(ops.barrier(xp, *P)) if N > 0 else P
    offset, scale, active = ops.barrier(xp, offset, scale, active)
    degenerate = (
        (P[0] == P[2]) & (P[1] == P[3]) & (P[0] == P[4]) & (P[1] == P[5])
        & (P[0] == P[6]) & (P[1] == P[7])
    )
    act = active & ~degenerate

    zero = xp.zeros(N, dtype=f32)
    t0u = xp.zeros(N, dtype=xp.uint32)
    dt = xp.ones(N, dtype=f32)
    lpx, lpy = P[0], P[1]
    lqx, lqy = P[2] - P[0], P[3] - P[1]
    small = lqx * lqx + lqy * lqy < fm.DERIV_THRESH * fm.DERIV_THRESH
    _, _, q2x, q2y = fm.eval_cubic_and_deriv(*P, xp.float32(fm.DERIV_EPS))
    lqx = xp.where(small, q2x, lqx)
    lqy = xp.where(small, q2y, lqy)
    last_t = zero
    done = ~act
    it = 0
    rec_t0 = xp.zeros((IT, N), dtype=f32)
    rec_t1 = xp.zeros((IT, N), dtype=f32)
    rec_n = xp.zeros((IT, N), dtype=f32)

    state = (t0u, dt, lpx, lpy, lqx, lqy, last_t, done, it, rec_t0, rec_t1, rec_n)

    def cond(state):
        done = state[7]
        return ~xp.all(done)

    def body(state):
        (t0u, dt, lpx, lpy, lqx, lqy, last_t, done, it, rec_t0, rec_t1, rec_n) = state
        t0 = t0u.astype(f32) * dt
        done = done | (t0 == 1.0)
        t1 = t0 + dt
        p1x, p1y, q1x, q1y, t1 = _pq_at(xp, P, t1)
        actual_dt = t1 - last_t
        th0, th1, chord_len, err = fm.cubic_params_from_points_derivs(
            xp, lpx, lpy, p1x, p1y, lqx, lqy, q1x, q1y, actual_dt
        )
        emit = (err * scale <= fm.FLATTEN_TOL) | (dt <= fm.SUBDIV_LIMIT)
        do_emit = emit & ~done

        k0, k1, ch = fm.euler_params_from_angles(th0, th1)
        n, _, _, _, _, _, _ = fm.espc_subdivision(
            xp, k0, k1, ch, chord_len, offset, scale
        )
        n = xp.where(xp.isnan(n), f32(1.0), n)

        row = xp.minimum(it, IT - 1)
        rec_t0[row] = _np.where(do_emit, last_t, 0.0)
        rec_t1[row] = _np.where(do_emit, t1, 0.0)
        rec_n[row] = _np.where(do_emit, n, 0.0)
        it = it + 1

        lpx = xp.where(do_emit, p1x, lpx)
        lpy = xp.where(do_emit, p1y, lpy)
        lqx = xp.where(do_emit, q1x, lqx)
        lqy = xp.where(do_emit, q1y, lqy)
        last_t = xp.where(do_emit, t1, last_t)

        t0u_e = t0u + 1
        shift = ops.trailing_zeros32(xp, t0u_e)
        t0u_e = t0u_e >> shift.astype(xp.uint32)
        dt_e = dt * xp.exp2(shift.astype(f32))
        # Subdivide branch (clamped doubling).
        t0u_s = xp.where(t0u > 0x7FFFFFFF, xp.uint32(0xFFFFFFFF), t0u * 2)
        dt_s = dt * 0.5

        advance = emit & ~done
        subdiv = ~emit & ~done
        t0u = xp.where(advance, t0u_e, xp.where(subdiv, t0u_s, t0u))
        dt = xp.where(advance, dt_e, xp.where(subdiv, dt_s, dt))
        return (t0u, dt, lpx, lpy, lqx, lqy, last_t, done, it, rec_t0, rec_t1, rec_n)

    state = ops.while_bounded(xp, max_iters, cond, body, state)
    done = state[7]
    rec_t0, rec_t1, rec_n = ops.barrier(xp, state[9], state[10], state[11])
    overflow = ~xp.all(done)
    return rec_t0, rec_t1, rec_n, overflow, state[8]


def expand_by_counts(xp, counts, out_cap, total=None, land=None):
    """Expansion primitive: for counts[r] items per record, produce for
    each output slot j < out_cap its (record index, index within record,
    valid flag).

    Under jax this uses scatter+cummax instead of a binary search:
    every nonzero record scatters its index at its exclusive offset
    (offsets of nonzero records are distinct), and a cummax fills the
    record id forward across its run — O(R + cap) with sequential
    memory access, where the searchsorted formulation costs
    O(cap * log R) *random* gathers (the dominant cost of the frame
    before this change).

    land: None, or (True, interpret) to land the marks with the
    streaming Pallas kernel (tpu/land_pallas.py) instead of the XLA
    scatter — the scatter costs ~10 ns per *input* row on this fabric
    (9.4 ms for the sa-line marks on config5). ONLY valid when counts
    are {0, 1}: the kernel's bounded landing window requires offsets to
    advance at most 1 per row."""
    counts = counts.astype(xp.int32)
    incl = xp.cumsum(counts)
    excl = incl - counts
    if total is None:
        total = incl[-1] if incl.shape[0] > 0 else xp.int32(0)
    # O(total) repeat, padded with the last record id — C-speed vs
    # the O(cap log R) searchsorted formulation (the host
    # calibration pass is expansion-bound).
    m = int(min(int(total), out_cap))
    rec_c = xp.full(out_cap, max(counts.shape[0] - 1, 0), dtype=xp.int32)
    rec_full = xp.repeat(
        xp.arange(counts.shape[0], dtype=xp.int32),
        xp.maximum(counts, 0),
    )
    rec_c[:m] = rec_full[:m]
    j = xp.arange(out_cap, dtype=xp.int32)
    within = j - excl[rec_c]
    valid = j < total
    return rec_c, within, valid, excl, total


def _normalize_vec(xp, vx, vy):
    ln = xp.sqrt(vx * vx + vy * vy)
    return vx / ln, vy / ln


def _fix_tangent(xp, tx, ty):
    small = tx * tx + ty * ty < fm.TANGENT_THRESH * fm.TANGENT_THRESH
    return (
        xp.where(small, xp.float32(fm.TANGENT_THRESH), tx),
        xp.where(small, xp.float32(0.0), ty),
    )


def slot_geometry(xp, tags, tags_next, pts_raw, pts_next_raw, seg_type0,
                  seg_type0_next, is_stroke, is_stroke_next, style_flags,
                  linewidth, miter_limit, T, path_idx, active, n_paths_cap):
    """Per-slot flatten geometry: segment normalization, stroke offset
    frames, caps/joins/miter spikes, round-join/cap arc records and the
    two Euler work tables (flatten.go:330-690, vectorized per tag slot).

    xp-generic and shape-generic: runs on [N] arrays under XLA/numpy in
    flatten_stage and on (1, C) lane vectors inside the flatten geometry
    megakernel (tpu/flatten_geom_pallas.py) with kmath transcendentals.
    `miter_limit` arrives decoded (each caller does its own f16->f32).

    All output coordinates are DEVICE space except the arc
    begin/end/center (arc lines rotate in local space at expansion
    time). Returns a dict of per-slot columns; tabA/tabB are the
    21-column Euler work tables of the lockstep walk.
    """
    xp = poly_xp(xp)  # shared polynomial transcendentals (pmath.py)
    f32 = xp.float32
    P, seg_type, is_marker, is_open = _normalize_segment(
        xp, pts_raw, seg_type0, tags, is_stroke
    )
    seg_mask = active & (seg_type0 != 0)
    offset = (0.5 * linewidth).astype(f32)

    # Stroke scale factor (flatten.go:366).
    v1x, v1y = T[0] + T[3], T[1] - T[2]
    v2x, v2y = T[0] - T[3], T[1] + T[2]
    stroke_scale = 0.5 * xp.sqrt(v1x * v1x + v1y * v1y) + xp.sqrt(
        v2x * v2x + v2y * v2y
    )
    scale = xp.where(is_stroke, stroke_scale, f32(1.0)).astype(f32)

    # Device-space points for fills.
    PD = []
    for k in range(4):
        dx, dy = _apply_transform(T, P[2 * k], P[2 * k + 1])
        PD.extend([dx, dy])

    # Stroke tangent frame (next slot's points arrive raw and get the
    # same normalization; identical values to shifting the normalized
    # arrays).
    P_next, _, _, _ = _normalize_segment(
        xp, pts_next_raw, seg_type0_next, tags_next, is_stroke_next
    )
    tan_px, tan_py = cubic_end_tangent_arrays(xp, P)
    tan_nx, tan_ny = cubic_start_tangent_arrays(xp, P_next)
    tan_sx, tan_sy = cubic_start_tangent_arrays(xp, P)
    tan_px, tan_py = _fix_tangent(xp, tan_px, tan_py)
    tan_nx, tan_ny = _fix_tangent(xp, tan_nx, tan_ny)
    tan_sx, tan_sy = _fix_tangent(xp, tan_sx, tan_sy)

    nsx, nsy = _normalize_vec(xp, -tan_sy, tan_sx)
    nsx, nsy = nsx * offset, nsy * offset  # nStart
    otx, oty = _normalize_vec(xp, tan_px, tan_py)
    otx, oty = otx * offset, oty * offset  # offsetTangent
    npx, npy = -oty, otx  # nPrev
    nnxn, nnyn = _normalize_vec(xp, tan_nx, tan_ny)
    nnx, nny = -nnyn * offset, nnxn * offset  # nNext

    next_is_marker = (tags_next & PATH_TAG_SUBPATH_END_BIT) != 0
    next_is_closed = (tags_next & PATH_TAG_SEG_TYPE_MASK) == _SEG_LINE
    do_join = (~next_is_marker) | next_is_closed

    regular = seg_mask & is_stroke & ~is_marker
    start_cap_slot = seg_mask & is_stroke & is_marker & is_open

    # Euler pass A: fills (device space, offset 0) and stroke +offset.
    PA = [xp.where(is_stroke, P[i], PD[i]) for i in range(8)]
    off_a = xp.where(is_stroke, offset, f32(0.0)).astype(f32)
    act_a = seg_mask & (~is_stroke | regular)
    tstart_ax = xp.where(is_stroke, P[0] + nsx, PD[0])
    tstart_ay = xp.where(is_stroke, P[1] + nsy, PD[1])
    tend_ax = xp.where(is_stroke, P[6] + npx, PD[6])
    tend_ay = xp.where(is_stroke, P[7] + npy, PD[7])

    # Euler pass B: stroke -offset only.
    off_b = (-offset).astype(f32)
    act_b = regular
    tstart_bx = P[0] - nsx
    tstart_by = P[1] - nsy
    tend_bx = P[6] - npx
    tend_by = P[7] - npy

    # --- Cap / join geometry (simple line slots + arc records) ----------
    p3x, p3y = P[6], P[7]
    p0x, p0y = P[0], P[1]

    join_kind = style_flags & FLAGS_JOIN_MASK
    cr = tan_px * tan_ny - tan_py * tan_nx
    dd = tan_px * tan_nx + tan_py * tan_ny

    front0x, front0y = p3x + npx, p3y + npy
    front1x, front1y = p3x + nnx, p3y + nny
    back0x, back0y = p3x - nnx, p3y - nny
    back1x, back1y = p3x - npx, p3y - npy

    # Miter.
    hyp = xp.sqrt(cr * cr + dd * dd)
    miter_cond = (2.0 * hyp < (hyp + dd) * miter_limit * miter_limit) & (cr != 0.0)
    is_backside = cr > 0.0
    fp_last_x = xp.where(is_backside, back1x, front0x)
    fp_last_y = xp.where(is_backside, back1y, front0y)
    fp_this_x = xp.where(is_backside, back0x, front1x)
    fp_this_y = xp.where(is_backside, back0y, front1y)
    p_mx = xp.where(is_backside, back0x, front0x)
    p_my = xp.where(is_backside, back0y, front0y)
    vx_m = fp_this_x - fp_last_x
    vy_m = fp_this_y - fp_last_y
    safe_cr = xp.where(cr == 0.0, f32(1.0), cr)
    h_m = (tan_px * vy_m - tan_py * vx_m) / safe_cr
    miter_px = fp_this_x - tan_nx * h_m
    miter_py = fp_this_y - tan_ny * h_m
    is_miter = join_kind == FLAGS_JOIN_BITS_MITER
    apply_miter = is_miter & miter_cond
    front0x = xp.where(apply_miter & ~is_backside, miter_px, front0x)
    front0y = xp.where(apply_miter & ~is_backside, miter_py, front0y)
    back0x_j = xp.where(apply_miter & is_backside, miter_px, back0x)
    back0y_j = xp.where(apply_miter & is_backside, miter_py, back0y)

    is_bevel = join_kind == FLAGS_JOIN_BITS_BEVEL
    is_round_join = join_kind == FLAGS_JOIN_BITS_ROUND
    bevel_valid = ((front0x != front1x) | (front0y != front1y)) & (
        (back0x_j != back1x) | (back0y_j != back1y)
    )

    # Round join arc side.
    arcj_0x = xp.where(is_backside, back0x, front0x)
    arcj_0y = xp.where(is_backside, back0y, front0y)
    arcj_1x = xp.where(is_backside, back1x, front1x)
    arcj_1y = xp.where(is_backside, back1y, front1y)
    otherj_0x = xp.where(is_backside, front0x, back0x)
    otherj_0y = xp.where(is_backside, front0y, back0y)
    otherj_1x = xp.where(is_backside, front1x, back1x)
    otherj_1y = xp.where(is_backside, front1y, back1y)

    join_slot = regular & do_join
    cap_end_slot = regular & ~do_join

    # End cap geometry.
    ec_style = style_flags & FLAGS_END_CAP_MASK
    ec_c0x, ec_c0y = p3x + npx, p3y + npy
    ec_c1x, ec_c1y = p3x - npx, p3y - npy
    ec_vx, ec_vy = otx, oty

    # Start cap geometry (marker slots; tangent from remapped points).
    sc_style = (style_flags & FLAGS_START_CAP_MASK) >> 2
    sc_otx, sc_oty = _normalize_vec(xp, tan_sx, tan_sy)
    sc_otx, sc_oty = sc_otx * offset, sc_oty * offset
    sc_nx, sc_ny = -sc_oty, sc_otx
    sc_c0x, sc_c0y = p0x - sc_nx, p0y - sc_ny
    sc_c1x, sc_c1y = p0x + sc_nx, p0y + sc_ny
    sc_vx, sc_vy = -sc_otx, -sc_oty

    # Unified cap fields.
    cap_slot = cap_end_slot | start_cap_slot
    cap_style = xp.where(start_cap_slot, sc_style, ec_style)
    cap_px = xp.where(start_cap_slot, p0x, p3x)
    cap_py = xp.where(start_cap_slot, p0y, p3y)
    cap_0x = xp.where(start_cap_slot, sc_c0x, ec_c0x)
    cap_0y = xp.where(start_cap_slot, sc_c0y, ec_c0y)
    cap_1x = xp.where(start_cap_slot, sc_c1x, ec_c1x)
    cap_1y = xp.where(start_cap_slot, sc_c1y, ec_c1y)
    cap_vx = xp.where(start_cap_slot, sc_vx, ec_vx)
    cap_vy = xp.where(start_cap_slot, sc_vy, ec_vy)
    cap_round = cap_style == FLAGS_CAP_BITS_ROUND
    cap_square = cap_style == FLAGS_CAP_BITS_SQUARE

    # --- Three generic simple-line slots --------------------------------
    zero = xp.zeros_like(P[0])

    def sel3(jc, cc, default=zero):
        return xp.where(join_slot, jc, xp.where(cap_slot, cc, default))

    # Slot 0: join front line / round-join "other" line / cap line 1.
    s0_valid = (
        (join_slot & ((is_bevel & bevel_valid) | is_miter | is_round_join))
        | (cap_slot & ~cap_round)
    )
    j0x = xp.where(is_round_join, otherj_0x, front0x)
    j0y = xp.where(is_round_join, otherj_0y, front0y)
    j1x = xp.where(is_round_join, otherj_1x, front1x)
    j1y = xp.where(is_round_join, otherj_1y, front1y)
    c0x = cap_0x
    c0y = cap_0y
    c1x = xp.where(cap_square, cap_0x + cap_vx, cap_1x)
    c1y = xp.where(cap_square, cap_0y + cap_vy, cap_1y)
    s0 = (sel3(j0x, c0x), sel3(j0y, c0y), sel3(j1x, c1x), sel3(j1y, c1y))

    # Slot 1: join back line / cap square line 2.
    s1_valid = (join_slot & ((is_bevel & bevel_valid) | is_miter)) | (
        cap_slot & cap_square
    )
    s1 = (
        sel3(back0x_j, cap_1x + cap_vx),
        sel3(back0y_j, cap_1y + cap_vy),
        sel3(back1x, cap_1x),
        sel3(back1y, cap_1y),
    )

    # Slot 2: miter spike line / cap square closing line.
    s2_valid = (join_slot & apply_miter) | (cap_slot & cap_square)
    s2 = (
        sel3(p_mx, cap_0x + cap_vx),
        sel3(p_my, cap_0y + cap_vy),
        sel3(miter_px, cap_1x + cap_vx),
        sel3(miter_py, cap_1y + cap_vy),
    )

    # --- Arc records ----------------------------------------------------
    arc_valid = (join_slot & is_round_join) | (cap_slot & cap_round)
    arc_bx = xp.where(join_slot, arcj_0x, cap_0x)
    arc_by = xp.where(join_slot, arcj_0y, cap_0y)
    arc_ex = xp.where(join_slot, arcj_1x, cap_1x)
    arc_ey = xp.where(join_slot, arcj_1y, cap_1y)
    arc_cx = xp.where(join_slot, p3x, cap_px)
    arc_cy = xp.where(join_slot, p3y, cap_py)
    arc_angle = xp.where(
        join_slot, xp.abs(xp.arctan2(cr, dd)), zero + f32(_np.pi)
    )
    # Line count (flatten.go:305-325).
    tol = f32(fm.FLATTEN_TOL)
    ab_tx, ab_ty = _apply_transform(T, arc_bx, arc_by)
    ac_tx, ac_ty = _apply_transform(T, arc_cx, arc_cy)
    radius = xp.maximum(
        tol, xp.sqrt((ab_tx - ac_tx) ** 2 + (ab_ty - ac_ty) ** 2)
    )
    arc_theta = xp.maximum(
        2.0 * xp.arccos(xp.clip(1.0 - tol / radius, -1.0, 1.0)), f32(0.0001)
    )
    arc_n = xp.maximum(xp.ceil(arc_angle / arc_theta), f32(1.0))
    arc_n = xp.where(arc_valid, arc_n, zero)

    # Device-space simple lines (transform applied per slot; exact same
    # formula/order as transforming after the expansion gather).
    s_lines = []
    for sv, sc_ in ((s0_valid, s0), (s1_valid, s1), (s2_valid, s2)):
        x0t, y0t = _apply_transform(T, sc_[0], sc_[1])
        x1t, y1t = _apply_transform(T, sc_[2], sc_[3])
        s_lines.append((sv, x0t, y0t, x1t, y1t))

    fpath = path_idx.astype(f32)
    ident = [f32(1.0), f32(0.0), f32(0.0), f32(1.0), f32(0.0), f32(0.0)]
    # Per-pass line transform: identity for fills (already device space).
    TA = [xp.where(is_stroke, T[i], zero + ident[i]) for i in range(6)]
    tabA = list(PA) + [off_a, scale, tstart_ax, tstart_ay, tend_ax,
                       tend_ay] + list(TA) + [fpath]
    tabB = list(P) + [off_b, scale, tstart_bx, tstart_by, tend_bx,
                      tend_by] + list(T) + [fpath]
    return {
        "tabA": tabA,
        "tabB": tabB,
        "act_a": act_a,
        "act_b": act_b,
        "s_lines": s_lines,
        "arc_valid": arc_valid,
        "arc_n": arc_n,
        "arc_theta": arc_theta,
        "arc_bx": arc_bx, "arc_by": arc_by,
        "arc_ex": arc_ex, "arc_ey": arc_ey,
        "arc_cx": arc_cx, "arc_cy": arc_cy,
        "is_marker": is_marker,
    }


def flatten_stage(xp, scene, layout, caps, shard=None):
    """Run the full flatten stage.

    scene: uint32 scene buffer.
    layout: dict of (traced) scalars — path_tag_base, path_data_base,
        draw_tag_base, style_base, transform_base, n_path_tags, n_paths.
    caps: dict of *static* capacities — n_tag_slots, max_emits,
        max_iters, euler_line_cap, simple_line_cap, arc_line_cap,
        line_cap, n_paths_cap.
    shard: optional tag-range shard context for the multi-chip pipeline
        (tpu/sharded2.py): {"tag_lo": traced i32 slot offset (multiple
        of 4), "monoid_base": dict of traced u32 scalars}. The stage
        then processes slots [tag_lo, tag_lo + n_tag_slots) — with a
        4-slot decode extension so the next-slot geometry peeks across
        the shard boundary — and returns the RAW per-path bbox
        accumulator ("bb_acc") for the caller to pmax across devices
        before finalize_path_bbox.

    Returns a dict with the line soup, per-path bboxes/flags and
    overflow indicators.
    """
    xp = poly_xp(xp)  # shared polynomial transcendentals (pmath.py)
    f32 = xp.float32
    N = caps["n_tag_slots"]
    IT = caps["max_iters"]
    # Host calibration (numpy stats pass): size every expansion to its
    # exact total instead of the Wang-estimate cap — numpy work costs
    # proportionally to capacity, and the counters are what matters.
    exact = bool(caps.get("_stats_only"))

    def _cap(counts, cap):
        if not exact:
            return cap
        return max(int(counts.astype(xp.int64).sum()), 1)

    if shard is None:
        Ne = N
        tag_lo = None
        tags_e = decode_tag_stream(xp, scene, layout["path_tag_base"], N)
        monoids_e = exclusive_monoids(xp, tags_e)
        active_e = xp.arange(N, dtype=xp.int32) < layout["n_path_tags"]
        nxt = lambda a: xp.concatenate([a[1:], a[:1]])
        cur = lambda a: a
    else:
        # Decode a 4-slot extension so every slot's successor is local.
        Ne = N + 4
        tag_lo = shard["tag_lo"]
        tags_e = decode_tag_stream(
            xp, scene, layout["path_tag_base"] + tag_lo // 4, Ne
        )
        monoids_e = exclusive_monoids(xp, tags_e, base=shard["monoid_base"])
        active_e = (
            xp.arange(Ne, dtype=xp.int32) + tag_lo
        ) < layout["n_path_tags"]
        nxt = lambda a: a[1 : N + 1]
        cur = lambda a: a[:N]

    trans_idx_e = (monoids_e["trans_idx"] - 1).astype(xp.uint32)
    style_idx_e = (monoids_e["style_idx"] - 2).astype(xp.uint32)
    path_idx_e = monoids_e["path_idx"].astype(xp.int32)
    seg_off_e = monoids_e["path_seg_offset"].astype(xp.int32)

    _pts_rows = None
    _trf_rows = None
    style_flags_e = ops.gather_guarded(
        xp, scene, layout["style_base"] + style_idx_e.astype(xp.int32)
    )
    linewidth_e = ops.bitcast_u32_f32(
        xp,
        ops.gather_guarded(
            xp, scene, layout["style_base"] + style_idx_e.astype(xp.int32) + 1
        ),
    )

    tags = cur(tags_e)
    active = cur(active_e)
    style_flags = cur(style_flags_e)
    linewidth = cur(linewidth_e)
    trans_idx = cur(trans_idx_e)
    path_idx = cur(path_idx_e)
    seg_off = cur(seg_off_e)

    # Per-path draw flags / transform index, written at path-marker slots
    # (flatten.go:675-683). Under a shard each marker slot lives in
    # exactly one shard, so a cross-device psum combines the arrays.
    n_paths_cap = caps["n_paths_cap"]
    marker = active & ((tags & PATH_TAG_PATH) != 0)
    tgt_idx = xp.where(marker, path_idx, n_paths_cap)
    # (df + the two marker scatters move below the megakernel branch so
    # the decode-fused mode can source the fill bit from the kernel.)

    # Segment decode (over the extended range so nxt() stays local).
    base_words_e = layout["path_data_base"] + seg_off_e
    raw_e = _read_points(xp, scene, base_words_e, tags_e, rows=_pts_rows)
    pts_raw_e, seg_type0_e = raw_e[:8], raw_e[8]
    is_stroke_e = (style_flags_e & xp.uint32(FLAGS_STYLE_BIT)) != 0
    T_e = _transform_read(
        xp, scene, layout["transform_base"], trans_idx_e, rows=_trf_rows,
    )
    miter_limit = f16_to_f32(
        xp, (cur(style_flags_e) & MITER_LIMIT_MASK).astype(xp.uint32)
    )
    pts_raw = [cur(a) for a in pts_raw_e]
    seg_type0 = cur(seg_type0_e)
    is_stroke = cur(is_stroke_e)
    T = [cur(t) for t in T_e]

    g = slot_geometry(
        xp, tags, nxt(tags_e), pts_raw, [nxt(a) for a in pts_raw_e],
        seg_type0, nxt(seg_type0_e), is_stroke, nxt(is_stroke_e),
        style_flags, linewidth, miter_limit, T, path_idx, active,
        n_paths_cap,
    )
    act_a, act_b = g["act_a"], g["act_b"]

    # Per-path draw flags / transform index, written at path-marker
    # slots (flatten.go:675-683). Under a shard each marker slot lives
    # in exactly one shard, so a cross-device psum combines the arrays.
    df = xp.where(
        (style_flags & FLAGS_FILL_BIT) == 0,
        xp.uint32(0),
        xp.uint32(DRAW_INFO_FLAGS_FILL_RULE_BIT),
    )
    # Both per-path marker fields ride ONE scatter into a [P, 2] target.
    pmeta = ops.scatter_set(
        xp, xp.zeros((n_paths_cap, 2), dtype=xp.uint32), tgt_idx,
        xp.stack([df, trans_idx], axis=1),
    )
    path_draw_flags = pmeta[:, 0]
    path_trans_idx = pmeta[:, 1]

    # Compact the euler work to actual segment slots before the
    # lockstep walk: the loop body is transcendental-heavy, so running
    # it over style/transform/marker slots (pass A) or fill slots
    # (pass B - strokes only) wastes most of the VPU.
    NWA = caps["work_a_cap"]
    NWB = caps["work_b_cap"]
    act_a32 = act_a.astype(xp.int32)
    act_b32 = act_b.astype(xp.int32)
    # Both passes share ONE worklist expansion (caps pool: a merged
    # worklist of NWA+NWB slots holds exactly the work the two split
    # lists held) and ONE row gather from the concatenated per-pass
    # tables — and the lockstep walk below runs ONCE over the merged
    # list instead of twice. A-items keep slot order, B-items follow;
    # the dense line-emission order is unchanged.
    counts2 = xp.concatenate([act_a32, act_b32])
    NWAB = NWA + NWB
    # act_a/act_b are 0/1 activity flags, so the worklist marks may
    # land via the streaming kernel on the Pallas route (the XLA
    # scatter costs ~4.6 ms at 344k slot rows on config5).
    _land = None
    wl, _, wl_valid, _, nab = expand_by_counts(
        xp, counts2, _cap(counts2, NWAB), land=_land
    )
    na = xp.sum(act_a32)
    nb = xp.sum(act_b32)

    # One packed [2N, 21] table + one row gather replaces ~21
    # independent element gathers per pass (gathers cost per row, not
    # per byte).
    tab2_N = xp.concatenate(
        [xp.stack(g["tabA"], axis=1), xp.stack(g["tabB"], axis=1)], axis=0
    )
    rows = ops.gather_guarded(xp, tab2_N, wl)
    # Lockstep walk placement: inside a Pallas kernel (the default on
    # the Pallas path — tpu/lockstep_pallas.py) or as the XLA
    # while_loop below.
    P_w = [rows[:, i] for i in range(8)]
    rec_w = lockstep_euler_pass(
        xp, P_w, rows[:, 8], rows[:, 9], wl_valid, IT, IT
    )
    overflow_euler = rec_w[3]
    if not exact:
        overflow_euler = overflow_euler | (nab > NWAB)
    lockstep_iters = rec_w[4]

    # =====================================================================
    # Expansions
    # =====================================================================
    lines = {}

    # Euler lines.
    EC = caps["euler_line_cap"]

    # XLA expansion over the flattened [NW*IT] record stream.
    # Records come back iteration-major [IT, NW]; flatten
    # worklist-major so a work item's records are contiguous in
    # emission order.
    slot_major = lambda r: xp.transpose(r).reshape(-1)
    recs_n = slot_major(rec_w[2])
    recs_t0 = slot_major(rec_w[0])
    recs_t1 = slot_major(rec_w[1])
    rec_idx, within, e_valid, excl, e_total = expand_by_counts(
        xp, recs_n, _cap(recs_n, EC)
    )
    e_work = rec_idx // IT

    row = ops.gather_guarded(xp, rows, e_work)
    P8l = tuple(row[:, i] for i in range(8))
    off_l = row[:, 8]
    scale_l = row[:, 9]
    tsx_l = row[:, 10]
    tsy_l = row[:, 11]
    tex_l = row[:, 12]
    tey_l = row[:, 13]
    Tl = [row[:, 14 + i] for i in range(6)]
    e_path = row[:, 20].astype(xp.int32)
    # Same packing trick for the per-record fields: one row gather
    # instead of three element gathers over the [NW*IT] record
    # arrays (plus one more for the group-start lookup below).
    recs_pack = xp.stack(
        [recs_t0, recs_t1, recs_n.astype(xp.float32),
         excl.astype(xp.float32)],
        axis=1,
    )
    rrow = ops.gather_guarded(xp, recs_pack, rec_idx)
    t0_l = rrow[:, 0]
    t1_l = rrow[:, 1]
    n_l = rrow[:, 2]

    lp1x, lp1y = euler_line_points(
        xp, P8l, t0_l, t1_l, within, n_l, off_l, scale_l, tex_l, tey_l
    )
    # lp0 chaining: previous line's end within the same work-item
    # group (groups are contiguous in the flattened record order).
    group_first_rec = e_work * IT
    group_start_line = ops.gather_guarded(xp, recs_pack, group_first_rec)[
        :, 3
    ].astype(xp.int32)
    j = xp.arange(lp1x.shape[0], dtype=xp.int32)
    is_first = j == group_start_line
    prev1x = xp.concatenate([lp1x[:1] * 0, lp1x[:-1]])
    prev1y = xp.concatenate([lp1y[:1] * 0, lp1y[:-1]])
    lp0x = xp.where(is_first, tsx_l, prev1x)
    lp0y = xp.where(is_first, tsy_l, prev1y)
    # Negative-offset passes swap line direction (flatten.go:488-498).
    swap = off_l < 0.0
    e_x0 = xp.where(swap, lp1x, lp0x)
    e_y0 = xp.where(swap, lp1y, lp0y)
    e_x1 = xp.where(swap, lp0x, lp1x)
    e_y1 = xp.where(swap, lp0y, lp1y)
    e_x0, e_y0 = _apply_transform(Tl, e_x0, e_y0)
    e_x1, e_y1 = _apply_transform(Tl, e_x1, e_y1)
    e_real = e_total

    # Simple lines + arc lines: ONE merged expansion + ONE row gather
    # over the concatenated count/table blocks (simple rows first, so
    # within the merged block simple lines precede arcs; downstream
    # coverage is order-independent and masks by line_valid). Combined
    # table layout (15 wide): cols 0-3 = line endpoints (simple) /
    # bx,by,ex,ey (arc), 4-5 = arc cx,cy, 6 = theta, 7 = n, 8-13 = T,
    # 14 = path.
    SC = caps["simple_line_cap"]
    AC = caps["arc_line_cap"]
    fpath = path_idx.astype(f32)
    s_counts = xp.concatenate(
        [sl[0].astype(xp.int32) for sl in g["s_lines"]]
    )
    arc_n = g["arc_n"]
    N3 = s_counts.shape[0]
    zcol = xp.zeros(N3, dtype=f32)
    stab = xp.stack(
        [xp.concatenate([g["s_lines"][k][c] for k in range(3)])
         for c in range(1, 5)]
        + [zcol] * 10
        + [xp.concatenate([fpath, fpath, fpath])],
        axis=1,
    )  # [3N, 15]
    atab = xp.stack(
        [g["arc_bx"], g["arc_by"], g["arc_ex"], g["arc_ey"],
         g["arc_cx"], g["arc_cy"], g["arc_theta"], arc_n] + list(T)
        + [fpath],
        axis=1,
    )  # [N, 15]
    # Merged per-SLOT expansion: the four count blocks (3 simple-line
    # families + arcs) live on the same slot domain, so expanding one
    # per-slot total and demuxing the family per output row cuts the
    # marks scatter from 4N to N input rows (9.4 -> ~2.4 ms on the
    # config5 trace; scatters cost per input row). Line order within
    # the sa block changes from family-major to slot-major — downstream
    # coverage is order-independent and masks by line_valid.
    c012 = [sl[0].astype(xp.int32) for sl in g["s_lines"]]
    arc_n32 = arc_n.astype(xp.int32)
    o1 = c012[0]
    o2 = o1 + c012[1]
    o3 = o2 + c012[2]
    tot4 = o3 + arc_n32
    N1 = tot4.shape[0]
    sa_slot, sa_w, sa_valid, _, sa_total = expand_by_counts(
        xp, tot4, _cap(tot4, SC + AC)
    )
    offs = xp.stack([o1, o2, o3], axis=1)
    orow = ops.gather_guarded(xp, offs, sa_slot)
    fam = (
        (sa_w >= orow[:, 0]).astype(xp.int32)
        + (sa_w >= orow[:, 1]).astype(xp.int32)
        + (sa_w >= orow[:, 2]).astype(xp.int32)
    )
    sa_rec = fam * N1 + sa_slot
    sa_i = sa_w - orow[:, 2]
    sarow = ops.gather_guarded(
        xp, xp.concatenate([stab, atab], axis=0), sa_rec
    )
    is_arc = fam == 3
    a_bx, a_by, a_ex, a_ey = (sarow[:, 0], sarow[:, 1], sarow[:, 2],
                              sarow[:, 3])
    a_cx, a_cy, a_theta, a_n = (sarow[:, 4], sarow[:, 5], sarow[:, 6],
                                sarow[:, 7])
    Ta = [sarow[:, 8 + i] for i in range(6)]
    sa_path = sarow[:, 14].astype(xp.int32)
    r0x = a_bx - a_cx
    r0y = a_by - a_cy

    def arc_pt(i_f):
        ang = i_f * a_theta
        c = xp.cos(ang)
        s = xp.sin(ang)
        rx = c * r0x + s * r0y
        ry = -s * r0x + c * r0y
        return _apply_transform(Ta, a_cx + rx, a_cy + ry)

    a_if = sa_i.astype(f32)
    al1x, al1y = arc_pt(a_if + 1.0)
    endx, endy = _apply_transform(Ta, a_ex, a_ey)
    last = a_if == a_n - 1.0
    al1x = xp.where(last, endx, al1x)
    al1y = xp.where(last, endy, al1y)
    al0x, al0y = arc_pt(a_if)
    beginx, beginy = _apply_transform(Ta, a_bx, a_by)
    al0x = xp.where(a_if == 0.0, beginx, al0x)
    al0y = xp.where(a_if == 0.0, beginy, al0y)
    sa_x0 = xp.where(is_arc, al0x, a_bx)
    sa_y0 = xp.where(is_arc, al0y, a_by)
    sa_x1 = xp.where(is_arc, al1x, a_ex)
    sa_y1 = xp.where(is_arc, al1y, a_ey)
    # Per-family actuals for calibration (cheap reductions).
    s_total = xp.sum(s_counts)
    a_total = xp.sum(arc_n.astype(xp.int32))

    # --- Combine into the line soup -------------------------------------
    # Each expansion already produces its family's lines densely at
    # positions [0, total): the soup is the two family blocks at
    # *static* offsets [0, EC), [EC, EC+SC+AC) — a concatenation, not a
    # scatter. (The previous element scatters at dynamic offsets cost
    # ~17 ms apiece at 1.4M lines; downstream stages mask with
    # line_valid, so interior gaps are free.)
    LC = caps["line_cap"]

    def family(vals_e, vals_sa, fill=f32(0.0)):
        out = xp.concatenate([vals_e, vals_sa])
        pad = (0 if exact
               else LC - (e_x0.shape[0] + sa_x0.shape[0]))
        if pad > 0:
            out = xp.concatenate([out, xp.full(pad, fill, dtype=out.dtype)])
        return out

    lx0 = family(e_x0, sa_x0)
    ly0 = family(e_y0, sa_y0)
    lx1 = family(e_x1, sa_x1)
    ly1 = family(e_y1, sa_y1)
    sentinel = xp.int32(n_paths_cap)
    lpath = family(
        xp.where(e_valid, e_path, sentinel),
        xp.where(sa_valid, sa_path, sentinel),
        fill=sentinel,
    )

    n_lines = e_total + sa_total
    line_valid = lpath < n_paths_cap

    # --- Path bboxes ----------------------------------------------------
    # One 4-wide scatter-max instead of four element scatters: the mins
    # ride along negated (max(-x) == -min(x)).
    big = xp.float32(1e30)
    pidx = xp.where(line_valid, lpath, n_paths_cap)
    # One 4-wide scatter-max instead of four element scatters: the mins
    # ride along negated (max(-x) == -min(x)). A segmented-max landing
    # KERNEL (per-sub-chunk run reduction + one-hot landings) was built
    # and lost its on-chip A/B in round 5 (9.46 ms vs this scatter's
    # 8.5: the run scans on (512, 1) columns use 1/128 of the VPU
    # lanes, and widening them needs a transpose pipeline that eats the
    # margin) — BASELINE.md round-5.
    bb_acc = ops.scatter_max(
        xp, xp.full((n_paths_cap, 4), -big, dtype=f32), pidx,
        xp.stack(
            [
                -xp.minimum(lx0, lx1),
                -xp.minimum(ly0, ly1),
                xp.maximum(lx0, lx1),
                xp.maximum(ly0, ly1),
            ],
            axis=1,
        ),
    )
    path_bbox = finalize_path_bbox(xp, bb_acc)

    overflow = overflow_euler
    if not exact:
        overflow = (
            overflow
            | (e_total > EC)
            | (sa_total > SC + AC)
            | ((e_total + sa_total) > LC)
        )

    return {
        "line_x0": lx0,
        "line_y0": ly0,
        "line_x1": lx1,
        "line_y1": ly1,
        "line_path": lpath,
        "line_valid": line_valid,
        "n_lines": n_lines,
        # Actual-use counters for host-side capacity calibration.
        "n_work_a": na,
        "n_work_b": nb,
        "e_total": e_total,
        "e_real": e_real,
        "s_total": s_total,
        "a_total": a_total,
        "lockstep_iters": lockstep_iters,
        "path_bbox": path_bbox,
        # Raw (negated-min) bbox accumulator: the sharded pipeline
        # pmax-combines this across devices, then finalize_path_bbox.
        "bb_acc": bb_acc,
        "path_draw_flags": path_draw_flags,
        "path_trans_idx": path_trans_idx,
        "overflow": overflow,
    }


def finalize_path_bbox(xp, bb_acc):
    """Raw (negated-min, max) accumulator -> floored/ceiled bbox with
    the sentinel for line-less paths (reference: bbox_clear)."""
    f32 = xp.float32
    bb_x0 = -bb_acc[:, 0]
    bb_y0 = -bb_acc[:, 1]
    bb_x1 = bb_acc[:, 2]
    bb_y1 = bb_acc[:, 3]
    empty = bb_x0 > bb_x1
    return xp.stack(
        [
            xp.where(empty, f32(2147483647.0), xp.floor(bb_x0)),
            xp.where(empty, f32(2147483647.0), xp.floor(bb_y0)),
            xp.where(empty, f32(-2147483648.0), xp.ceil(bb_x1)),
            xp.where(empty, f32(-2147483648.0), xp.ceil(bb_y1)),
        ],
        axis=1,
    )


def cubic_start_tangent_arrays(xp, P):
    return fm.cubic_start_tangent(
        xp, P[0], P[1], P[2], P[3], P[4], P[5], P[6], P[7]
    )


def cubic_end_tangent_arrays(xp, P):
    return fm.cubic_end_tangent(
        xp, P[0], P[1], P[2], P[3], P[4], P[5], P[6], P[7]
    )


def euler_line_points(xp, P8, t0, t1, i, n, offset, scale, tend_x, tend_y):
    """End point of line i (of n) of the Euler segment over [t0, t1].

    All inputs are per-line gathered arrays. Recomputes the Euler fit
    exactly as the lockstep pass did (same formulas => same f32 values).
    """
    xp = poly_xp(xp)  # shared polynomial transcendentals (pmath.py)
    p0x, p0y, q0x, q0y, _ = _pq_at(xp, P8, t0)
    p1x, p1y, q1x, q1y, t1a = _pq_at(xp, P8, t1)
    actual_dt = t1 - t0
    th0, th1, chord_len, _ = fm.cubic_params_from_points_derivs(
        xp, p0x, p0y, p1x, p1y, q0x, q0y, q1x, q1y, actual_dt
    )
    k0, k1, ch = fm.euler_params_from_angles(th0, th1)
    n2, robust, a, b, int0, integral, norm_off = fm.espc_subdivision(
        xp, k0, k1, ch, chord_len, offset, scale
    )
    # Masked (padding) lanes carry n == 0; give them a safe divisor —
    # their outputs are discarded downstream.
    t = (i.astype(xp.float32) + 1.0) / xp.maximum(n, 1.0)
    s = fm.espc_s_of_t(xp, t, robust, a, b, int0, integral)
    lx, ly = fm.euler_seg_eval_with_offset(
        xp, p0x, p0y, p1x, p1y, k0, k1, ch, th0, s, norm_off
    )
    is_last = (i.astype(xp.float32) == n - 1.0) & (t1 == 1.0)
    lx = xp.where(is_last, tend_x, lx)
    ly = xp.where(is_last, tend_y, ly)
    return lx, ly
