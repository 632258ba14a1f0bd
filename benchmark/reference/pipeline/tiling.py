"""Tile stages: tile allocation, per-tile segment counting/clipping and
backdrop propagation.

(reference: shaders/cpu/cpu.go TileAlloc/PathCount/Backdrop/PathTiling)

The reference rasterizes each line across tiles with a DDA, bumping
per-tile atomic counters and appending SegmentCount records, then runs
an indirect dispatch to scatter clipped segments into per-tile slices.
Here the same DDA math runs as two closed-form expansions:

  lines -> crossings  (count = imax - imin per line, exact)
  lines -> rows       (backdrop column-0 deltas)

followed by a stable sort of crossings by tile slot, which replaces the
atomic slice allocation; segment order within a tile differs from the
reference's nondeterministic atomic order, but fill coverage is a sum
over segments and is order-independent.

Tile slots: each draw object owns a dense rect of tiles (exclusive scan
of rect areas, replacing the `tile` bump counter). Backdrop prefix sums
along tile rows use a global-cumsum-minus-row-start trick.
"""

from __future__ import annotations

import numpy as _np

from . import ops

TILE_WIDTH = 16
TILE_HEIGHT = 16
TILE_SCALE = 1.0 / 16.0
ONE_MINUS_ULP = 0.99999994
ROBUST_EPSILON = 2e-7


def tile_alloc(xp, draw_bbox, tag, layout, caps):
    """Per-draw tile rect + exclusive tile-slot offsets.

    draw_bbox: [D, 4] f32 intersected draw bboxes.
    Returns dict with rect (i32 x0,y0,x1,y1 per draw), tile_offset,
    total tiles, and per-tile metadata arrays.
    """
    from ..encoding.draw import DRAW_TAG_END_CLIP, DRAW_TAG_NOP

    D = caps["n_draws_cap"]
    T = caps["tiles_cap"]
    wit = layout["width_in_tiles"]
    hit = layout["height_in_tiles"]

    has_rect = (tag != DRAW_TAG_NOP) & (tag != DRAW_TAG_END_CLIP)
    nonempty = (draw_bbox[:, 0] < draw_bbox[:, 2]) & (draw_bbox[:, 1] < draw_bbox[:, 3])
    ok = has_rect & nonempty
    x0 = xp.where(ok, xp.floor(draw_bbox[:, 0] * TILE_SCALE), 0.0).astype(xp.int32)
    y0 = xp.where(ok, xp.floor(draw_bbox[:, 1] * TILE_SCALE), 0.0).astype(xp.int32)
    x1 = xp.where(ok, xp.ceil(draw_bbox[:, 2] * TILE_SCALE), 0.0).astype(xp.int32)
    y1 = xp.where(ok, xp.ceil(draw_bbox[:, 3] * TILE_SCALE), 0.0).astype(xp.int32)
    x0 = xp.clip(x0, 0, wit)
    y0 = xp.clip(y0, 0, hit)
    x1 = xp.clip(x1, 0, wit)
    y1 = xp.clip(y1, 0, hit)
    w = x1 - x0
    h = y1 - y0
    counts = (w * h).astype(xp.int32)

    # Per-tile metadata via expansion (packed row table: one gather).
    # The expansion's internal cumsum doubles as the per-draw tile-slot
    # offsets (its `excl` return) — no separate cumsum launch.
    rec, within, valid, tile_offset, total = _expand(xp, counts, T)
    dt = xp.stack([w, x0, y0, tile_offset], axis=1)
    dr = ops.gather_guarded(xp, dt, rec)
    stride = xp.maximum(dr[:, 0], 1)
    ly = within // stride
    lx = within % stride
    tile_draw = rec
    tile_tx = dr[:, 1] + lx
    tile_ty = dr[:, 2] + ly
    row_start = dr[:, 3] + ly * stride
    return {
        "rect_x0": x0,
        "rect_y0": y0,
        "rect_x1": x1,
        "rect_y1": y1,
        "tile_offset": tile_offset,
        "n_tiles": total,
        "tile_draw": tile_draw,
        "tile_tx": tile_tx,
        "tile_ty": tile_ty,
        "tile_row_start": row_start,
        "tile_valid": valid,
        "overflow": total > T,
    }


def _expand(xp, counts, cap, total=None):
    from .flatten import expand_by_counts

    return expand_by_counts(xp, counts, cap, total)


def line_dda_clip(xp, x0, y0, x1, y1, lvalid, bb0, bb1, bb2, bb3, tiles_base):
    """Full per-line DDA setup + bbox i-range clip, all-f32 and
    shape-agnostic (cpu.go:770-941). The single source of the DDA/clip
    f32 op sequence consumed by path_count_params and the profiling
    cuts, so every count and crossing derives from one shared
    evaluation.

    bb0..bb3/tiles_base: per-line path-rect fields (already gathered).
    Returns a dict of f32 blocks; counts are exact integers in f32.
    """
    f32 = xp.float32
    is_down = y1 >= y0
    ax0 = xp.where(is_down, x0, x1)
    ay0 = xp.where(is_down, y0, y1)
    ax1 = xp.where(is_down, x1, x0)
    ay1 = xp.where(is_down, y1, y0)
    s0x = ax0 * TILE_SCALE
    s0y = ay0 * TILE_SCALE
    s1x = ax1 * TILE_SCALE
    s1y = ay1 * TILE_SCALE

    def span_f(a, b):
        return xp.maximum(
            xp.ceil(xp.maximum(a, b)) - xp.floor(xp.minimum(a, b)), 1.0
        )

    count_x = span_f(s0x, s1x) - 1.0
    count = count_x + span_f(s0y, s1y)
    dx = xp.abs(s1x - s0x)
    dy = s1y - s0y
    skip = (dx + dy == 0.0) | ((dy == 0.0) & (xp.floor(s0y) == s0y))
    safe = xp.where(skip, f32(1.0), dx + dy)
    idxdy = 1.0 / safe
    a = dx * idxdy
    is_positive = s1x >= s0x
    sign = xp.where(is_positive, f32(1.0), f32(-1.0))
    xt0 = xp.floor(s0x * sign)
    c = s0x * sign - xt0
    y0i = xp.floor(s0y)
    ytop = xp.where(s0y == s1y, xp.ceil(s0y), y0i + 1.0)
    b = xp.minimum((dy * c + dx * (ytop - s0y)) * idxdy, f32(ONE_MINUS_ULP))
    robust_err = xp.floor(a * (count - 1.0) + b) - count_x
    a = xp.where(
        robust_err != 0.0,
        a - xp.where(robust_err > 0, 1.0, -1.0) * ROBUST_EPSILON,
        a,
    )
    x0f = xt0 * sign + xp.where(is_positive, f32(0.0), f32(-1.0))

    valid = lvalid & ~skip
    stride = bb2 - bb0
    xmin = xp.minimum(s0x, s1x)
    line_dead = (
        (s0y >= bb3) | (s1y < bb1) | (xmin >= bb2) | (stride == 0.0) | ~valid
    )

    # Clip i-range to the path bbox (cpu.go:838-907).
    one_minus_a = 1.0 - a
    safe_oma = xp.where(one_minus_a == 0.0, f32(1e-12), one_minus_a)
    iminf = xp.round((bb1 - y0i + b - a) / safe_oma) - 1.0
    iminf = xp.where(y0i + iminf - xp.floor(a * iminf + b) < bb1, iminf + 1.0, iminf)
    imin = xp.where(s0y < bb1, iminf, f32(0.0))
    imaxf = xp.round((bb3 - y0i + b - a) / safe_oma) - 1.0
    imaxf = xp.where(y0i + imaxf - xp.floor(a * imaxf + b) < bb3, imaxf + 1.0, imaxf)
    imax = xp.where(s1y > bb3, imaxf, count)

    delta = xp.where(is_down, f32(-1.0), f32(1.0))
    ymin = xp.zeros_like(s0y)
    ymax = xp.zeros_like(s0y)

    all_left = xp.maximum(s0x, s1x) < bb0
    ymin = xp.where(all_left, xp.ceil(s0y), ymin)
    ymax = xp.where(all_left, xp.ceil(s1y), ymax)
    imax = xp.where(all_left, imin, imax)

    fudge = xp.where(is_positive, f32(0.0), f32(1.0))
    safe_a = xp.where(a == 0.0, f32(1e-12), a)
    left_case = ~all_left & (xmin < bb0)
    fl = xp.round((sign * (bb0 - x0f) - b + fudge) / safe_a)
    fl = xp.where(
        (x0f + sign * xp.floor(safe_a * fl + b) < bb0) == is_positive, fl + 1.0, fl
    )
    ynext = y0i + fl - xp.floor(safe_a * fl + b) + 1.0
    pos_upd = left_case & is_positive & (fl > imin)
    ymin = xp.where(pos_upd, y0i + xp.where(y0i == s0y, f32(0.0), f32(1.0)), ymin)
    ymax = xp.where(pos_upd, ynext, ymax)
    imin = xp.where(pos_upd, fl, imin)
    neg_upd = left_case & ~is_positive & (fl < imax)
    ymin = xp.where(neg_upd, ynext, ymin)
    ymax = xp.where(neg_upd, xp.ceil(s1y), ymax)
    imax = xp.where(neg_upd, fl, imax)
    right_case = ~all_left & (xp.maximum(s0x, s1x) > bb2)
    fr = xp.round((sign * (bb2 - x0f) - b + fudge) / safe_a)
    fr = xp.where(
        (x0f + sign * xp.floor(safe_a * fr + b) < bb2) == is_positive, fr + 1.0, fr
    )
    imax = xp.where(right_case & is_positive, xp.minimum(imax, fr), imax)
    imin = xp.where(right_case & ~is_positive, xp.maximum(imin, fr), imin)

    imax = xp.maximum(imin, imax)
    ymin = xp.maximum(ymin, bb1)
    ymax = xp.minimum(ymax, bb3)
    zero = f32(0.0)
    imin = xp.where(line_dead, zero, imin)
    imax = xp.where(line_dead, zero, imax)
    ymin = xp.where(line_dead, zero, ymin)
    ymax = xp.where(line_dead, zero, ymax)

    return {
        "a": a,
        "b": b,
        "sign": sign,
        "y0i": y0i,
        "x0f": x0f,
        "s0y": s0y,
        "imin": imin,
        "imax": imax,
        "ymin": ymin,
        "ymax": ymax,
        "count": count,
        "is_down": is_down,
        "is_positive": is_positive,
        "stride": stride,
        "delta": delta,
        "xy0x": ax0,
        "xy0y": ay0,
        "xy1x": ax1,
        "xy1y": ay1,
        "n_cross": xp.maximum(imax - imin, 0.0),
        "n_rows": xp.maximum(ymax - ymin, 0.0),
    }


def path_rect_rows(xp, lines, paths):
    """One row gather for the five per-path rect fields (vs five
    element gathers over the line array): [L, 5] f32 rows of
    (rect_x0, rect_y0, rect_x1, rect_y1, tile_offset)."""
    f32 = xp.float32
    pidx = xp.minimum(lines["line_path"], paths["rect_x0"].shape[0] - 1)
    ptab = xp.stack(
        [
            paths["rect_x0"].astype(f32),
            paths["rect_y0"].astype(f32),
            paths["rect_x1"].astype(f32),
            paths["rect_y1"].astype(f32),
            paths["tile_offset"].astype(f32),
        ],
        axis=1,
    )
    return ops.gather_guarded(xp, ptab, pidx)


def path_count_params(xp, lines, paths, caps, upto=None):
    """Per-line DDA + bbox-clip parameters (the pure per-line half of
    PathCount, shared by the single-chip path and the line-sharded
    multi-chip pipeline in tpu/sharded2.py).

    Returns (P [L,21] f32 table, n_cross [L] i32, n_rows_per_line [L]
    i32, prt: tuple of the five backdrop-row columns).

    upto: profiling cut point — "setup" (DDA line setup only),
    "pgather" (+ per-path row gather), "clip" (+ bbox i-range clip).
    """
    L = lines["line_x0"].shape[0]
    f32 = xp.float32

    if upto in ("setup", "pgather"):
        # Profiling-only cuts: run the SHARED line_dda_clip with dummy
        # whole-plane bbox inputs (one copy of the setup math — a
        # separate _line_setup clone could silently desynchronize from
        # the production DDA).
        f32_ = xp.float32
        d = line_dda_clip(
            xp, lines["line_x0"], lines["line_y0"], lines["line_x1"],
            lines["line_y1"], lines["line_valid"],
            f32_(0.0), f32_(0.0), f32_(1e9), f32_(1e9), f32_(0.0),
        )
        if upto == "setup":
            return (d["a"], d["b"], d["count"], d["imin"])
        prow = path_rect_rows(xp, lines, paths)
        return (d["a"], d["b"], d["count"], d["imin"], prow)

    prow = path_rect_rows(xp, lines, paths)

    d = line_dda_clip(
        xp, lines["line_x0"], lines["line_y0"], lines["line_x1"],
        lines["line_y1"], lines["line_valid"],
        prow[:, 0], prow[:, 1], prow[:, 2], prow[:, 3], prow[:, 4],
    )
    if upto == "clip":
        return (d["imin"], d["imax"], d["ymin"], d["ymax"])

    # ---- Packed per-line parameter table -------------------------------
    # Both expansions below (rows, crossings) and path_tiling read a
    # dozen per-line scalars per expanded record. A dozen independent
    # element gathers over ~10^5-10^6 records are gather-bound on TPU
    # (~0.6 GB/s effective each); packing the scalars into one f32 row
    # per line turns them into a single contiguous row gather (same
    # trick as the flatten expansion's param table). Integer-valued
    # columns (stride, tiles_base, delta, flags) are exact in f32
    # (|value| < 2^24).
    P = xp.stack(
        [
            d["imin"],                             # 0
            d["a"],                                # 1
            d["b"],                                # 2
            d["sign"],                             # 3
            d["y0i"],                              # 4
            d["x0f"],                              # 5
            prow[:, 0],                            # 6  bb0
            prow[:, 1],                            # 7  bb1
            prow[:, 2],                            # 8  bb2
            d["stride"],                           # 9
            prow[:, 4],                            # 10 tiles_base
            d["s0y"],                              # 11
            d["delta"],                            # 12
            d["ymin"],                             # 13
            d["xy0x"],                             # 14  (path_tiling)
            d["xy0y"],                             # 15
            d["xy1x"],                             # 16
            d["xy1y"],                             # 17
            d["is_down"].astype(f32),              # 18
            d["count"],                            # 19
            d["is_positive"].astype(f32),          # 20
        ],
        axis=1,
    )

    n_rows_per_line = d["n_rows"].astype(xp.int32)
    n_cross = d["n_cross"].astype(xp.int32)
    prt = (d["ymin"], prow[:, 4].astype(xp.int32), prow[:, 1],
           d["stride"].astype(xp.int32), d["delta"].astype(xp.int32))
    return P, n_cross, n_rows_per_line, prt


def path_count(xp, lines, paths, caps, upto=None):
    """Per-line crossing/backdrop computation (cpu.go PathCount).

    lines: dict from flatten_stage.
    paths: dict from tile_alloc (+ patched draw path mapping applied by
        the caller: the `line_path` indices address paths[] directly).
    Returns crossing records (sorted by tile slot), per-tile segment
    counts/starts, and the backdrop array (post prefix-sum).

    upto: profiling cut point (tools/profile_path_count.py) — one of
    "params", "compact", "expand", "backdrop", "sort", "bincount";
    returns the intermediate arrays at that point instead.
    """
    L = lines["line_x0"].shape[0]
    T = caps["tiles_cap"]
    SC = caps["seg_cap"]
    f32 = xp.float32

    if upto in ("setup", "pgather", "clip"):
        return path_count_params(xp, lines, paths, caps, upto=upto)

    # Route history (BASELINE.md rounds 4-5): two alternative
    # formulations — a raw-table route (stream-compaction kernel +
    # in-body DDA recompute) and a kernel-compaction hybrid (XLA P
    # table + compaction kernel + precomputed-column bodies) — were
    # built, exact-equality tested, and DELETED after losing their
    # on-chip A/Bs (151.7 / 195.8 ms vs this route's 102.2 ms full
    # path_count on config5). Root cause, confirmed by device traces:
    # a Pallas custom call forces its operand chain to materialize as
    # standalone kernels, while this route's 21-column P evaluation
    # fuses into the consuming XLA gather for free. Kernel inputs must
    # be arrays that already exist or are trivially produced — never
    # the result of a fat fusible chain.
    P, n_cross, n_rows_per_line, (ymin, tiles_base, bb1, stride, delta) = (
        path_count_params(xp, lines, paths, caps)
    )
    RC = caps["row_cap"]
    if upto == "params":
        return (P, n_cross, n_rows_per_line, ymin)

    if caps.get("_stats_only"):
        return _path_count_stats(
            xp, P, n_cross, n_rows_per_line, ymin, tiles_base, bb1, stride,
            delta, paths, caps,
        )

    compact_overflow = False
    binc_pallas = None
    # ---- Backdrop row deltas (column 0 of each path row) -----------
    # Narrow 5-column table: gathering the full 21-wide P here
    # measured ~6x slower (transposed-layout roulette on wide row
    # gathers).
    backdrop = xp.zeros(T + 1, dtype=xp.int32)
    r_rec, r_within, r_valid, _, r_total = _expand(xp, n_rows_per_line, RC)
    PRT = xp.stack(
        [ymin, tiles_base.astype(f32), bb1, stride.astype(f32), delta.astype(f32)],
        axis=1,
    )
    PR = ops.gather_guarded(xp, PRT, r_rec)
    r_y = PR[:, 0].astype(xp.int32) + r_within
    r_slot = PR[:, 1].astype(xp.int32) + (
        r_y - PR[:, 2].astype(xp.int32)
    ) * PR[:, 3].astype(xp.int32)
    r_slot = xp.where(r_valid, r_slot, T)
    backdrop = ops.scatter_add(xp, backdrop, r_slot, PR[:, 4].astype(xp.int32))

    # ---- Crossings -------------------------------------------------
    c_rec, c_within, c_valid, _, c_total = _expand(xp, n_cross, SC)
    PC = ops.gather_guarded(xp, P, c_rec)
    ci = PC[:, 0] + c_within.astype(f32)
    ca, cb, csign = PC[:, 1], PC[:, 2], PC[:, 3]
    cy0, cx0 = PC[:, 4], PC[:, 5]
    zf = ca * ci + cb
    z = xp.floor(zf)
    cy = (cy0 + ci - z).astype(xp.int32)
    cx = (cx0 + csign * z).astype(xp.int32)
    cbb0 = PC[:, 6].astype(xp.int32)
    cbb1 = PC[:, 7].astype(xp.int32)
    cbb2 = PC[:, 8].astype(xp.int32)
    cstride = PC[:, 9].astype(xp.int32)
    cbase = PC[:, 10].astype(xp.int32) + (cy - cbb1) * cstride - cbb0
    last_z = xp.floor(ca * (ci - 1.0) + cb)
    top_edge = xp.where(ci == 0.0, cy0 == PC[:, 11], last_z == z)
    # Top-edge backdrop bumps.
    bump_ok = top_edge & (cx + 1 < cbb2) & c_valid
    x_bump = xp.maximum(cx + 1, cbb0)
    bump_slot = xp.where(bump_ok, cbase + x_bump, T)
    backdrop = ops.scatter_add(xp, backdrop, bump_slot, PC[:, 12].astype(xp.int32))

    tile_slot = cbase + cx
    tile_slot = xp.where(c_valid, tile_slot, T)

    # Tile-relative segment clipping (cpu.go PathTiling), computed
    # here PRE-SORT: all per-line parameters are already in the
    # gathered PC rows (z, last_z, cx, cy reused from the DDA
    # above), so fusing the stage avoids a second 21-wide row
    # gather after the sort.
    ls_c = {
        "a": ca,
        "b": cb,
        "sign": csign,
        "y0i": cy0,
        "x0f": cx0,
        "xy0x": PC[:, 14],
        "xy0y": PC[:, 15],
        "xy1x": PC[:, 16],
        "xy1y": PC[:, 17],
        "is_down": PC[:, 18] > 0.5,
        "count": PC[:, 19],
        "is_positive": PC[:, 20] > 0.5,
    }
    seg_pre = _tile_clip_segments(xp, ls_c, ci, z, last_z, cx, cy)

    stats = {
        # Capacity-independent actuals for calibration (the clamped
        # totals above include one slot per line-cap slot).
        "real_cross": xp.sum(n_cross),
        "real_bd_rows": xp.sum(n_rows_per_line),
        # Nonzero-count line totals sizing the compaction caps.
        "real_cross_lines": xp.sum((n_cross > 0).astype(xp.int32)),
        "real_bd_lines": xp.sum((n_rows_per_line > 0).astype(xp.int32)),
    }
    return _sort_count_tail(
        xp, T, SC, RC, caps, paths, tile_slot, seg_pre, backdrop,
        binc_pallas, c_total, r_total, compact_overflow, stats, upto,
    )



def _sort_count_tail(xp, T, SC, RC, caps, paths, tile_slot, seg_pre,
                     backdrop, binc_pallas, c_total, r_total,
                     compact_overflow, stats, upto):
    """Shared path_count tail: the slot sort, per-tile start/count, and
    the backdrop row prefix."""
    # Sort crossings by tile slot (stable), replacing atomic slice
    # alloc. The payload rides the compare-exchange network directly
    # (one multi-operand lax.sort) — measured ~2x cheaper than
    # argsort + a permutation row gather at this scale. On the pallas
    # route the inline top-edge bump delta rides as a sixth payload so
    # per-run bump sums come from sorted-run boundaries below.
    payloads = [
        seg_pre["seg_x0"],
        seg_pre["seg_y0"],
        seg_pre["seg_x1"],
        seg_pre["seg_y1"],
        seg_pre["seg_y_edge"],
    ]
    sorted_out = ops.sort_multi(
        xp, tile_slot.astype(xp.int32), tuple(payloads))
    sorted_slot, sx0, sy0, sx1, sy1, sye = sorted_out[:6]
    segs = {
        "seg_x0": sx0,
        "seg_y0": sy0,
        "seg_x1": sx1,
        "seg_y1": sy1,
        "seg_y_edge": sye,
    }
    if upto == "sort":
        return (sorted_slot, segs, backdrop)

    # Per-tile start/count: the sort is keyed by slot, so tile t's
    # segments occupy [excl_cumsum(counts)[t], +counts[t]). Intra-tile
    # order is whatever the sort produced; coverage is a sum over
    # segments and order-independent.
    first_cum = None
    if binc_pallas is None:
        binc_pallas = ops.scatter_add(
            xp,
            xp.zeros(T + 1, dtype=xp.int32),
            xp.where((tile_slot >= 0) & (tile_slot < T), tile_slot, T),
            xp.ones(SC, dtype=xp.int32),
        )
    seg_count = binc_pallas[:T]
    bd = backdrop[:T]
    has = (seg_count > 0).astype(xp.int32)
    # All three T-length prefixes (per-tile segment starts, the
    # backdrop row prefix, compact area-row ids) ride ONE column
    # cumsum.
    c3in = xp.stack([seg_count, bd, has], axis=1)
    c3 = xp.cumsum(c3in, axis=0) - c3in
    seg_start = c3[:, 0]
    cume = c3[:, 1]
    row_of_slot = c3[:, 2]

    # ---- Backdrop prefix along rows ------------------------------------
    row_start = paths["tile_row_start"]
    bd_prefix = cume - ops.gather_guarded(xp, cume, row_start) + bd

    # Compact "area row" ids for slots that have segments (consumed by
    # the batched coverage pass + the fine kernel).
    n_rows = row_of_slot[-1] + has[-1]
    if upto == "bincount":
        return (seg_start, bd_prefix, row_of_slot, sorted_slot)

    overflow = (c_total > SC) | (r_total > RC) | compact_overflow
    out = {
        "sorted_slot": sorted_slot,
        "segs": segs,
        "seg_start": seg_start,
        "seg_count": seg_count,
        "backdrop": bd_prefix,
        "row_of_slot": row_of_slot,
        "n_rows": n_rows,
        "n_segs": c_total,
        "r_total": r_total,
        "overflow": overflow,
    }
    if first_cum is not None:
        # Inclusive cumsum of valid-run starts over the sorted stream:
        # the coverage wrapper's per-segment slot-rank (rides this
        # launch instead of an SC-length extra in rank_records).
        out["first_cum"] = first_cum
    out.update(stats)
    return out


def _path_count_stats(xp, P, n_cross, n_rows_per_line, ymin, tiles_base,
                      bb1, stride, delta, paths, caps):
    """Counting-only path_count for the HOST calibration pass (numpy).

    Capacity sizing needs the per-frame counters and the per-tile
    seg_count/backdrop (coarse's include decisions), but not segment
    payloads, the slot sort, or the tile clipping — at calibration-time
    capacities those dominate the numpy pass (~100 s of a 280 s host
    calibration on the config5 profile). The crossing expansion here
    carries only the 13 tile-slot/bump columns and per-tile counts come
    from one bincount instead of sort + boundary scatters."""
    import numpy as np

    T = caps["tiles_cap"]
    SC = caps["seg_cap"]
    RC = caps["row_cap"]
    f32 = xp.float32

    # Exact expansion sizes: the numpy pass costs proportionally to
    # capacity and the counters are exact either way.
    sc_e = max(int(n_cross.astype(xp.int64).sum()), 1)
    rc_e = max(int(n_rows_per_line.astype(xp.int64).sum()), 1)

    # Crossings: tile_slot + top-edge bump only (P cols 0..12).
    c_rec, c_within, c_valid, _, c_total = _expand(xp, n_cross, sc_e)
    PC = P[:, :13][c_rec]
    ci = PC[:, 0] + c_within.astype(f32)
    ca, cb, csign = PC[:, 1], PC[:, 2], PC[:, 3]
    z = xp.floor(ca * ci + cb)
    cy = (PC[:, 4] + ci - z).astype(xp.int32)
    cx = (PC[:, 5] + csign * z).astype(xp.int32)
    cbb0 = PC[:, 6].astype(xp.int32)
    cbb2 = PC[:, 8].astype(xp.int32)
    cstride = PC[:, 9].astype(xp.int32)
    cbase = PC[:, 10].astype(xp.int32) + (cy - PC[:, 7].astype(xp.int32)) * cstride - cbb0
    tile_slot = xp.where(c_valid, cbase + cx, T)
    last_z = xp.floor(ca * (ci - 1.0) + cb)
    top_edge = xp.where(ci == 0.0, PC[:, 4] == PC[:, 11], last_z == z)
    bump_ok = top_edge & (cx + 1 < cbb2) & c_valid
    bump_slot = xp.where(bump_ok, cbase + xp.maximum(cx + 1, cbb0), T)

    backdrop = np.zeros(T + 1, dtype=np.int64)
    # Overflowing frames (estimate class too small) produce slots past
    # T; the device scatter drops them, np.add.at must clamp (the T row
    # is the drop bin either way — the retry path re-renders).
    bump_slot = np.clip(bump_slot, 0, T)
    np.add.at(backdrop, bump_slot, xp.where(bump_ok, PC[:, 12], 0.0).astype(np.int64))

    # Backdrop row deltas.
    r_rec, r_within, r_valid, _, r_total = _expand(xp, n_rows_per_line, RC)
    r_y = ymin[r_rec].astype(xp.int32) + r_within
    r_slot = tiles_base[r_rec] + (r_y - bb1[r_rec].astype(xp.int32)) * stride[r_rec]
    r_slot = np.clip(xp.where(r_valid, r_slot, T), 0, T)
    np.add.at(backdrop, r_slot, xp.where(r_valid, delta[r_rec], 0).astype(np.int64))

    seg_count = np.bincount(
        np.clip(tile_slot, 0, T), minlength=T + 1
    )[:T].astype(xp.int32)

    bd = backdrop[:T].astype(xp.int32)
    cume = ops.exclusive_cumsum(xp, bd)
    row_start = paths["tile_row_start"]
    bd_prefix = cume - cume[np.clip(row_start, 0, T - 1)] + bd

    has = (seg_count > 0).astype(xp.int32)
    row_of_slot = ops.exclusive_cumsum(xp, has)
    n_rows = row_of_slot[-1] + has[-1]
    zeros = xp.zeros(SC, dtype=f32)
    return {
        "sorted_slot": xp.full(SC, T, dtype=xp.int32),
        "segs": {k: zeros for k in
                 ("seg_x0", "seg_y0", "seg_x1", "seg_y1", "seg_y_edge")},
        "seg_start": xp.zeros(T, dtype=xp.int32),
        "seg_count": seg_count,
        "backdrop": bd_prefix,
        "row_of_slot": row_of_slot,
        "n_rows": n_rows,
        "n_segs": c_total,
        "r_total": r_total,
        "real_cross": xp.sum(n_cross),
        "real_bd_rows": xp.sum(n_rows_per_line),
        "real_cross_lines": xp.sum((n_cross > 0).astype(xp.int32)),
        "real_bd_lines": xp.sum((n_rows_per_line > 0).astype(xp.int32)),
        "overflow": (c_total > SC) | (r_total > RC),
    }


def path_tiling(xp, lines, counted, caps):
    """Clip each crossing's line to its tile -> tile-relative segments
    (cpu.go PathTiling). The clipping itself is fused into path_count
    (pre-sort, where the per-line parameter rows are already gathered);
    this stage just hands out the sorted result."""
    return counted["segs"]


def _tile_clip_segments(xp, ls, i, z, z_prev, x, y):
    """Clip one crossing's line to its tile (cpu.go PathTiling body).

    ls: per-crossing line-setup fields; i: DDA index; z/z_prev: floor
    terms (reused from the crossing computation); x/y: tile coords.
    """
    f32 = xp.float32
    a, b, sign = ls["a"], ls["b"], ls["sign"]
    xy0x, xy0y = ls["xy0x"], ls["xy0y"]
    xy1x, xy1y = ls["xy1x"], ls["xy1y"]
    tile_x = x.astype(f32) * TILE_WIDTH
    tile_y = y.astype(f32) * TILE_HEIGHT
    tile_x1 = tile_x + TILE_WIDTH
    tile_y1 = tile_y + TILE_HEIGHT

    # Clip the top (i > 0).
    top_clipped = z == z_prev
    safe_dy = xp.where(xy1y == xy0y, f32(1e-12), xy1y - xy0y)
    xt = xy0x + (xy1x - xy0x) * (tile_y - xy0y) / safe_dy
    xt = xp.clip(xt, tile_x + 1e-3, tile_x1)
    safe_dx = xp.where(xy1x == xy0x, f32(1e-12), xy1x - xy0x)
    x_clip_t = xp.where(ls["is_positive"], tile_x, tile_x1)
    yt = xy0y + (xy1y - xy0y) * (x_clip_t - xy0x) / safe_dx
    yt = xp.clip(yt, tile_y + 1e-3, tile_y1)
    has_top = i > 0.0
    nx0 = xp.where(has_top, xp.where(top_clipped, xt, x_clip_t), xy0x)
    ny0 = xp.where(has_top, xp.where(top_clipped, tile_y, yt), xy0y)

    # Clip the bottom (i < count - 1).
    count_f = ls["count"].astype(f32)
    z_next = xp.floor(a * (i + 1.0) + b)
    bot_clipped = z == z_next
    xtb = xy0x + (xy1x - xy0x) * (tile_y1 - xy0y) / safe_dy
    xtb = xp.clip(xtb, tile_x + 1e-3, tile_x1)
    x_clip_b = xp.where(ls["is_positive"], tile_x1, tile_x)
    ytb = xy0y + (xy1y - xy0y) * (x_clip_b - xy0x) / safe_dx
    ytb = xp.clip(ytb, tile_y + 1e-3, tile_y1)
    has_bot = i < count_f - 1.0
    nx1 = xp.where(has_bot, xp.where(bot_clipped, xtb, x_clip_b), xy1x)
    ny1 = xp.where(has_bot, xp.where(bot_clipped, tile_y1, ytb), xy1y)

    # Numerical robustness nudges (cpu.go:712-746), tile-relative coords.
    p0x = nx0 - tile_x
    p0y = ny0 - tile_y
    p1x = nx1 - tile_x
    p1y = ny1 - tile_y
    EPS = f32(1e-6)
    y_edge = xp.full(p0x.shape, f32(1e9))

    both_zero = (p0x == 0.0) & (p1x == 0.0)
    whole_tile = both_zero & (p0y == 0.0)
    vanish = both_zero & (p0y != 0.0)
    y_edge = xp.where((p0x == 0.0) & (p1x != 0.0) & (p0y != 0.0), p0y, y_edge)
    y_edge = xp.where((p0x != 0.0) & (p1x == 0.0) & (p1y != 0.0), p1y, y_edge)
    p0x = xp.where((p0x == 0.0) & ((p1x == 0.0) | (p0y == 0.0)), EPS, p0x)
    p1x = xp.where((p1x == 0.0) & (p1y == 0.0) & ~both_zero, EPS, p1x)
    p1x = xp.where(whole_tile, EPS, p1x)
    p1y = xp.where(whole_tile, f32(TILE_HEIGHT), p1y)
    p1x = xp.where(vanish, 2.0 * EPS, p1x)
    p1y = xp.where(vanish, p0y, p1y)
    p0x = xp.where((p0x == xp.floor(p0x)) & (p0x != 0.0), p0x - EPS, p0x)
    p1x = xp.where((p1x == xp.floor(p1x)) & (p1x != 0.0), p1x - EPS, p1x)

    # Undo the top-down ordering.
    is_down = ls["is_down"]
    sx0 = xp.where(is_down, p0x, p1x)
    sy0 = xp.where(is_down, p0y, p1y)
    sx1 = xp.where(is_down, p1x, p0x)
    sy1 = xp.where(is_down, p1y, p0y)
    return {
        "seg_x0": sx0,
        "seg_y0": sy0,
        "seg_x1": sx1,
        "seg_y1": sy1,
        "seg_y_edge": y_edge,
    }
