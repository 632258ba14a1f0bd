"""Tile stages, in torch: tile allocation, per-tile segment counting and
clipping, backdrop propagation.

Counterpart of `jello_tpu/pipeline/tiling.py`: `tile_alloc`,
`path_count` on jello_tpu's accelerator route (`tiling.py:389-490` and
`_sort_count_tail`'s sorted runs) and `path_tiling`. The per-line tables
are built by kernel J (`cuda/line_dda.py`; its plain version
`line_tables_plain`); nonzero lines are compacted through kernel C,
expanded into crossings and backdrop rows through kernels E' and E''
(their bodies `crossings` and `backdrop_rows`), and counted per tile
from the sorted stream's run boundaries. Every line is rasterized across
tiles by the reference's closed-form DDA; a stable sort of crossings by
tile slot replaces the atomic slice allocation. All integer outputs
match the oracle exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from ..encoding.draw import DRAW_TAG_END_CLIP, DRAW_TAG_NOP

from ..pmath import rdiv
from . import ops
from .flatten import expand_by_counts
from .ops import F32, F64, I32

TILE_WIDTH = 16
TILE_HEIGHT = 16
TILE_SCALE = 1.0 / 16.0
ONE_MINUS_ULP = 0.99999994
ROBUST_EPSILON = 2e-7
# float32 constants the oracle mixes into float64 arithmetic.
TINY = float(np.float32(1e-12))
SEG_EPS = float(np.float32(1e-6))


def tile_rect(draw_bbox, ok, layout):
    """Each draw's bbox in whole tiles, clamped to the tile grid, 0 where
    not `ok`: (x0, y0, x1, y1) i32 [D]. The grid's size is the layout's,
    device data in a frame: both clamp bounds are device tensors, since a
    clamp between a host number and a device tensor copies the number to
    the device, which a capture refuses."""
    z = torch.zeros_like(draw_bbox[:, 0])
    lo = torch.zeros((), dtype=I32, device=draw_bbox.device)

    def q(v, f, hi):
        return torch.where(ok, f(v * TILE_SCALE), z).to(I32).clamp(lo, hi)

    wit, hit = layout["width_in_tiles"], layout["height_in_tiles"]
    return (q(draw_bbox[:, 0], torch.floor, wit), q(draw_bbox[:, 1], torch.floor, hit),
            q(draw_bbox[:, 2], torch.ceil, wit), q(draw_bbox[:, 3], torch.ceil, hit))


def tile_alloc(draw_bbox, tag, layout, caps):
    """Per-draw tile rect + exclusive tile-slot offsets + per-tile
    metadata (draw, tile coords, row start)."""
    T = caps["tiles_cap"]
    has_rect = (tag != DRAW_TAG_NOP) & (tag != DRAW_TAG_END_CLIP)
    nonempty = (draw_bbox[:, 0] < draw_bbox[:, 2]) & (draw_bbox[:, 1] < draw_bbox[:, 3])
    x0, y0, x1, y1 = tile_rect(draw_bbox, has_rect & nonempty, layout)
    w = x1 - x0
    h = y1 - y0
    rec, within, valid, tile_offset, total = expand_by_counts(w * h, T)
    dr = ops.gather_guarded(torch.stack([w, x0, y0, tile_offset], dim=1), rec)
    stride = dr[:, 0].clamp(min=1)
    ly = torch.div(within, stride, rounding_mode="floor")
    lx = within - ly * stride
    return {
        "rect_x0": x0, "rect_y0": y0, "rect_x1": x1, "rect_y1": y1,
        "tile_offset": tile_offset,
        "n_tiles": total,
        "tile_draw": rec,
        "tile_tx": dr[:, 1] + lx,
        "tile_ty": dr[:, 2] + ly,
        "tile_row_start": dr[:, 3] + ly * stride,
        "tile_valid": valid,
        "overflow": total > T,
    }


def line_dda_clip(x0, y0, x1, y1, lvalid, bb0, bb1, bb2, bb3):
    """Per-line DDA setup + bbox i-range clip (float32 inputs; float64
    from the robustness nudge of `a` on, as in the oracle)."""
    one = torch.ones_like(x0)
    is_down = y1 >= y0
    ax0 = torch.where(is_down, x0, x1)
    ay0 = torch.where(is_down, y0, y1)
    ax1 = torch.where(is_down, x1, x0)
    ay1 = torch.where(is_down, y1, y0)
    s0x = ax0 * TILE_SCALE
    s0y = ay0 * TILE_SCALE
    s1x = ax1 * TILE_SCALE
    s1y = ay1 * TILE_SCALE

    def span_f(a, b):
        return torch.clamp(torch.ceil(torch.maximum(a, b)) - torch.floor(torch.minimum(a, b)),
                           min=1.0)

    count_x = span_f(s0x, s1x) - 1.0
    count = count_x + span_f(s0y, s1y)
    dx = torch.abs(s1x - s0x)
    dy = s1y - s0y
    skip = (dx + dy == 0.0) | ((dy == 0.0) & (torch.floor(s0y) == s0y))
    idxdy = rdiv(1.0, torch.where(skip, one, dx + dy))
    a = dx * idxdy
    is_positive = s1x >= s0x
    sign = torch.where(is_positive, one, -one)
    xt0 = torch.floor(s0x * sign)
    c = s0x * sign - xt0
    y0i = torch.floor(s0y)
    ytop = torch.where(s0y == s1y, torch.ceil(s0y), y0i + 1.0)
    b = torch.clamp((dy * c + dx * (ytop - s0y)) * idxdy, max=ONE_MINUS_ULP)
    robust_err = torch.floor(a * (count - 1.0) + b) - count_x
    # The oracle's nudge `where(err > 0, 1.0, -1.0) * eps` is float64 in
    # numpy, which makes `a` and everything computed from it (the i-range
    # clip, crossings, tile-relative segments) float64. The port keeps
    # that precision so crossings and tile slots match the oracle exactly.
    a = a.to(F64)
    a = torch.where(robust_err != 0.0,
                    a - torch.where(robust_err > 0, 1.0, -1.0).to(F64) * ROBUST_EPSILON, a)
    x0f = xt0 * sign + torch.where(is_positive, 0.0 * one, -one)

    valid = lvalid & ~skip
    stride = bb2 - bb0
    xmin = torch.minimum(s0x, s1x)
    line_dead = (s0y >= bb3) | (s1y < bb1) | (xmin >= bb2) | (stride == 0.0) | ~valid

    one_minus_a = 1.0 - a
    safe_oma = torch.where(one_minus_a == 0.0, torch.full_like(a, TINY), one_minus_a)
    iminf = torch.round((bb1 - y0i + b - a) / safe_oma) - 1.0
    iminf = torch.where(y0i + iminf - torch.floor(a * iminf + b) < bb1, iminf + 1.0, iminf)
    imin = torch.where(s0y < bb1, iminf, 0.0 * one)
    imaxf = torch.round((bb3 - y0i + b - a) / safe_oma) - 1.0
    imaxf = torch.where(y0i + imaxf - torch.floor(a * imaxf + b) < bb3, imaxf + 1.0, imaxf)
    imax = torch.where(s1y > bb3, imaxf, count)

    delta = torch.where(is_down, -one, one)
    ymin = torch.zeros_like(s0y)
    ymax = torch.zeros_like(s0y)

    all_left = torch.maximum(s0x, s1x) < bb0
    ymin = torch.where(all_left, torch.ceil(s0y), ymin)
    ymax = torch.where(all_left, torch.ceil(s1y), ymax)
    imax = torch.where(all_left, imin, imax)

    fudge = torch.where(is_positive, 0.0 * one, one)
    safe_a = torch.where(a == 0.0, torch.full_like(a, TINY), a)
    left_case = ~all_left & (xmin < bb0)
    fl = torch.round((sign * (bb0 - x0f) - b + fudge) / safe_a)
    fl = torch.where((x0f + sign * torch.floor(safe_a * fl + b) < bb0) == is_positive,
                     fl + 1.0, fl)
    ynext = y0i + fl - torch.floor(safe_a * fl + b) + 1.0
    pos_upd = left_case & is_positive & (fl > imin)
    ymin = torch.where(pos_upd, y0i + torch.where(y0i == s0y, 0.0 * one, one), ymin)
    ymax = torch.where(pos_upd, ynext, ymax)
    imin = torch.where(pos_upd, fl, imin)
    neg_upd = left_case & ~is_positive & (fl < imax)
    ymin = torch.where(neg_upd, ynext, ymin)
    ymax = torch.where(neg_upd, torch.ceil(s1y), ymax)
    imax = torch.where(neg_upd, fl, imax)
    right_case = ~all_left & (torch.maximum(s0x, s1x) > bb2)
    fr = torch.round((sign * (bb2 - x0f) - b + fudge) / safe_a)
    fr = torch.where((x0f + sign * torch.floor(safe_a * fr + b) < bb2) == is_positive,
                     fr + 1.0, fr)
    imax = torch.where(right_case & is_positive, torch.minimum(imax, fr), imax)
    imin = torch.where(right_case & ~is_positive, torch.maximum(imin, fr), imin)

    imax = torch.maximum(imin, imax)
    ymin = torch.maximum(ymin, bb1)
    ymax = torch.minimum(ymax, bb3)
    zero = torch.zeros_like(imin)
    imin = torch.where(line_dead, zero, imin)
    imax = torch.where(line_dead, zero, imax)
    ymin = torch.where(line_dead, zero, ymin)
    ymax = torch.where(line_dead, zero, ymax)
    return {
        "a": a, "b": b, "sign": sign, "y0i": y0i, "x0f": x0f, "s0y": s0y,
        "imin": imin, "imax": imax, "ymin": ymin, "ymax": ymax, "count": count,
        "is_down": is_down, "is_positive": is_positive, "stride": stride,
        "delta": delta, "xy0x": ax0, "xy0y": ay0, "xy1x": ax1, "xy1y": ay1,
        "n_cross": torch.clamp(imax - imin, min=0.0),
        "n_rows": torch.clamp(ymax - ymin, min=0.0),
    }


def line_tables_plain(lines, paths):
    """The per-line half of path_count in torch: kernel J's plain version
    (`cuda/line_dda.py::line_tables`) and its CPU route. Each line's DDA
    and bbox-clip parameters (`jello_tpu/pipeline/tiling.py:259-341`).
    Returns (P [L, 21] f64 table, its ROW_COLS columns [L, 5] f64,
    n_cross [L] i32, n_rows_per_line [L] i32)."""
    pidx = torch.clamp(lines["line_path"], max=paths["rect_x0"].shape[0] - 1)
    ptab = torch.stack([paths["rect_x0"], paths["rect_y0"], paths["rect_x1"],
                        paths["rect_y1"], paths["tile_offset"]], dim=1).to(F32)
    prow = ops.gather_guarded(ptab, pidx)
    d = line_dda_clip(lines["line_x0"], lines["line_y0"], lines["line_x1"],
                      lines["line_y1"], lines["line_valid"],
                      prow[:, 0], prow[:, 1], prow[:, 2], prow[:, 3])
    # Packed per-line parameter table (columns as in jello_tpu), float64
    # like the oracle's.
    P = torch.stack([c.to(F64) for c in (
        d["imin"], d["a"], d["b"], d["sign"], d["y0i"], d["x0f"],
        prow[:, 0], prow[:, 1], prow[:, 2], d["stride"], prow[:, 4], d["s0y"],
        d["delta"], d["ymin"], d["xy0x"], d["xy0y"], d["xy1x"], d["xy1y"],
        d["is_down"], d["count"], d["is_positive"])], dim=1)
    return P, row_table(P), d["n_cross"].to(I32), d["n_rows"].to(I32)


# Columns of the P table that the backdrop-row expansion reads: ymin,
# tiles_base, bb1, stride, delta (jello_tpu's PRT table).
ROW_COLS = [13, 10, 7, 9, 12]


def row_table(P):
    """P's ROW_COLS columns, [L, 5] (kernel J writes them beside P on the
    card). Taken column by column: indexing with the list copies it to
    the device, which makes the host wait for the queue."""
    return torch.stack([P[:, c] for c in ROW_COLS], dim=1)


SEG_KEYS = ("seg_x0", "seg_y0", "seg_x1", "seg_y1", "seg_y_edge")


def backdrop_rows(PR, within, valid, T):
    """Backdrop row deltas: the row expansion's body
    (`jello_tpu/tpu/expand_pallas.py::_row_compute`). PR: each output's
    owning line's ROW_COLS row, float64. Returns (r_slot i32, T where
    invalid; r_delta i32, 0 where invalid)."""
    r_y = PR[:, 0].to(I32) + within
    r_slot = PR[:, 1].to(I32) + (r_y - PR[:, 2].to(I32)) * PR[:, 3].to(I32)
    return (torch.where(valid, r_slot, T).to(I32),
            torch.where(valid, PR[:, 4].to(I32), 0).to(I32))


def crossings(PC, within, valid, T):
    """Tile crossings by the closed-form DDA, fused with tile-relative
    segment clipping and top-edge bumps: the crossing expansion's body
    (`jello_tpu/tpu/expand_pallas.py::_crossing_compute`). PC: each
    output's owning line's P row, float64 as in the oracle. Returns
    (tile_slot i32, T where invalid; segments, a dict of float64 columns
    zeroed where invalid (y_edge 1e9); bump_slot i32; bump_delta i32, 0
    where no bump)."""
    ci = PC[:, 0] + within.to(F32)  # float64, as in the oracle
    ca, cb, csign = PC[:, 1], PC[:, 2], PC[:, 3]
    cy0, cx0 = PC[:, 4], PC[:, 5]
    z = torch.floor(ca * ci + cb)
    cy = (cy0 + ci - z).to(I32)
    cx = (cx0 + csign * z).to(I32)
    cbb0 = PC[:, 6].to(I32)
    cbb1 = PC[:, 7].to(I32)
    cbb2 = PC[:, 8].to(I32)
    cstride = PC[:, 9].to(I32)
    cbase = PC[:, 10].to(I32) + (cy - cbb1) * cstride - cbb0
    last_z = torch.floor(ca * (ci - 1.0) + cb)
    top_edge = torch.where(ci == 0.0, cy0 == PC[:, 11], last_z == z)
    bump_ok = top_edge & (cx + 1 < cbb2) & valid
    bump_slot = torch.where(bump_ok, cbase + torch.maximum(cx + 1, cbb0), T).to(I32)
    bump_delta = torch.where(bump_ok, PC[:, 12].to(I32), 0).to(I32)
    tile_slot = torch.where(valid, cbase + cx, T).to(I32)

    ls_c = {
        "a": ca, "b": cb, "sign": csign, "y0i": cy0, "x0f": cx0,
        "xy0x": PC[:, 14], "xy0y": PC[:, 15], "xy1x": PC[:, 16], "xy1y": PC[:, 17],
        "is_down": PC[:, 18] > 0.5, "count": PC[:, 19].to(F32),
        "is_positive": PC[:, 20] > 0.5,
    }
    seg = _tile_clip_segments(ls_c, ci, z, last_z, cx, cy)
    # Invalid slots read a clamped owner's row: keep what they compute
    # (possibly NaN) out of the payloads.
    seg = {k: torch.where(valid, v, 1e9 if k == "seg_y_edge" else 0.0)
           for k, v in seg.items()}
    return tile_slot, seg, bump_slot, bump_delta


def path_count_expansions(P, PRT, n_cross, n_rows_per_line, caps):
    """The lines' crossings and backdrop rows as jello_tpu expands them on
    its accelerator: both nonzero-line compactions land through
    kernel C, and the crossing and row expansions run as kernels E' and
    E'' on the compacted tables (`jello_tpu/pipeline/tiling.py:389-448`
    with `tpu/expand_pallas.py::path_count_expansions(assume_compact=
    True)`) on `line_tables`' P and row table (PRT). Returns (tile_slot,
    segments dict of f64, bump_slot, bump_delta, c_total, r_slot,
    r_delta, r_total, compact_overflow)."""
    from ..cuda import expand as kx
    from ..cuda.land import monotone_land

    dev = P.device
    L = P.shape[0]
    T = caps["tiles_cap"]
    LCC = caps["cross_lines_cap"]
    RLC = caps["row_lines_cap"]

    # Compact to nonzero-count lines: the expansions then carry no dead
    # slot per line, and seg_cap/row_cap size to real outputs.
    nz_c = n_cross > 0
    nz_r = n_rows_per_line > 0
    cum_c = torch.cumsum(nz_c, 0, dtype=I32)
    cum_r = torch.cumsum(nz_r, 0, dtype=I32)
    n_nz_c, n_nz_r = cum_c[-1], cum_r[-1]
    compact_overflow = (n_nz_c > LCC) | (n_nz_r > RLC)
    l_ids = ops.iota(L, dev)
    (idx_c,) = monotone_land(cum_c - nz_c.to(I32), nz_c, [l_ids], LCC)
    (idx_r,) = monotone_land(cum_r - nz_r.to(I32), nz_r, [l_ids], RLC)
    idx_c, idx_r = idx_c.to(I32), idx_r.to(I32)
    # The P table goes to the crossing kernel as float64, which keeps
    # its crossings and tile slots exact against the numpy oracle
    # (ROADMAP queue 3 rule 5); jello_tpu's kernel reads it as float32.
    Pc = ops.gather_guarded(P, idx_c)
    ncc = torch.where(ops.iota(LCC, dev) < n_nz_c, ops.gather_guarded(n_cross, idx_c), 0)
    PRTc = ops.gather_guarded(PRT, idx_r)
    nrr = torch.where(ops.iota(RLC, dev) < n_nz_r,
                      ops.gather_guarded(n_rows_per_line, idx_r), 0)

    crossings = kx.expand_crossings(Pc.contiguous(), ncc.to(I32), caps["seg_cap"], T)
    rows = kx.expand_rows(PRTc.contiguous(), nrr.to(I32), caps["row_cap"], T)
    return crossings + rows + (compact_overflow,)


def path_count(lines, paths, caps):
    """Per-line crossings and backdrop rows -> slot-sorted segments,
    per-tile counts/starts and the backdrop prefix (cpu.go PathCount +
    PathTiling), as jello_tpu runs it on its accelerator
    (`jello_tpu/pipeline/tiling.py:389-490`): kernel J's per-line
    tables, `path_count_expansions`, and the top-edge bumps riding the
    slot sort (`_sort_count_tail`'s sorted-run branch)."""
    from ..cuda.land import monotone_land
    from ..cuda.line_dda import line_tables

    dev = lines["line_x0"].device
    T = caps["tiles_cap"]
    SC = caps["seg_cap"]
    RC = caps["row_cap"]
    P, PRT, n_cross, n_rows_per_line = line_tables(lines, paths)
    stats = {
        "real_cross": n_cross.sum(),
        "real_bd_rows": n_rows_per_line.sum(),
        "real_cross_lines": (n_cross > 0).to(I32).sum(),
        "real_bd_lines": (n_rows_per_line > 0).to(I32).sum(),
    }
    (tile_slot, seg_pre, bump_slot, bump_delta, c_total, r_slot, r_delta, r_total,
     compact_overflow) = path_count_expansions(P, PRT, n_cross, n_rows_per_line, caps)
    backdrop = ops.scatter_add(torch.zeros(T + 1, dtype=I32, device=dev), r_slot, r_delta)

    # Top-edge bumps ride the sort as a sixth payload where the bump
    # lands on the crossing's right neighbour (the common case); the
    # residual case (x_bump clamped off tile_slot + 1) takes the full
    # bump scatter.
    next_slot = bump_slot == tile_slot + 1
    bump_inline = torch.where(next_slot, bump_delta, 0)
    resid_any = ((bump_delta != 0) & ~next_slot).any()
    if caps.get("_pc_force_resid"):
        # Test knob: force the residual branch; with no actual residual
        # both branches must agree exactly.
        resid_any = torch.ones((), dtype=torch.bool, device=dev)
    sorted_out = ops.sort_multi(tile_slot, tuple(seg_pre[k] for k in SEG_KEYS)
                                + (bump_inline,))
    sorted_slot, sbump = sorted_out[0], sorted_out[6]

    # Per-tile counts and bump sums from the sorted stream's run
    # boundaries: run starts land through kernel C (strictly increasing
    # positions), counts are position differences and bump sums prefix
    # differences; all exact integers in f32.
    prev = torch.cat([torch.full((1,), -1, dtype=I32, device=dev), sorted_slot[:-1]])
    is_new = sorted_slot != prev
    first_v = is_new & (sorted_slot >= 0) & (sorted_slot < T)
    # The one >= T (sentinel) run's start lands too: it ends the last
    # valid run.
    keep = first_v | (is_new & (sorted_slot >= T) & (prev < T))
    cum_keep = torch.cumsum(keep, 0, dtype=I32)
    first_cum = torch.cumsum(first_v, 0, dtype=I32)
    cum_bump = torch.cumsum(sbump, 0, dtype=I32)
    bd_excl = cum_bump - sbump
    n_kept, n_ranks, bd_total = cum_keep[-1], first_cum[-1], cum_bump[-1]
    ARL = caps["area_rows_cap"] + 8
    sl_land, pos_land, bd_land = monotone_land(
        cum_keep - keep.to(I32), keep, [sorted_slot, ops.iota(SC, dev), bd_excl], ARL)
    r_i = ops.iota(ARL, dev)
    valid_rank = r_i < n_ranks
    in_kept = r_i < n_kept
    pos_i = torch.where(in_kept, pos_land.to(I32), SC)
    bd_i = torch.where(in_kept, bd_land.to(I32), bd_total)
    nxt = torch.cat([pos_i[1:], torch.full((1,), SC, dtype=I32, device=dev)])
    bd_nxt = torch.cat([bd_i[1:], bd_total[None]])
    cnt = torch.where(valid_rank, nxt - pos_i, 0)
    bsum = torch.where(valid_rank, bd_nxt - bd_i, 0)
    slot_r = torch.where(valid_rank, torch.clamp(sl_land.to(I32), 0, T), T)
    # Run r's bumps land at slot_r + 1 (bump_ok keeps a bump inside its
    # tile row, so slot + 1 is its exact target).
    bump_tgt = torch.where(valid_rank, torch.clamp(slot_r + 1, max=T), T)
    zeros_t1 = torch.zeros(T + 1, dtype=I32, device=dev)
    binc = ops.scatter_add(zeros_t1, slot_r, cnt)
    # jello_tpu picks one branch with lax.cond; both are computed here and
    # one is selected on the device, with no host sync.
    bump = torch.where(resid_any, ops.scatter_add(zeros_t1, bump_slot, bump_delta),
                       ops.scatter_add(zeros_t1, bump_tgt, bsum))
    overflow = (c_total > SC) | (r_total > RC) | compact_overflow | (n_kept > ARL)
    out = _count_tail(sorted_out[:6], binc, backdrop + bump, paths, c_total, r_total,
                      overflow, stats)
    out["first_cum"] = first_cum
    return out


def _count_tail(sorted_out, binc, backdrop, paths, c_total, r_total, overflow, stats):
    """Per-tile segment starts, the backdrop row prefix and the compact
    area-row ids, from the sorted stream, the per-slot counts and the
    per-slot backdrop deltas ([T + 1], the last the dump bin)."""
    from ..cuda.scan import column_scan

    sorted_slot = sorted_out[0]
    T = binc.shape[0] - 1
    seg_count = binc[:T]
    bd = backdrop[:T]
    has = (seg_count > 0).to(I32)
    c3, tot = column_scan([seg_count, bd, has], "sum", exclusive=True, totals=True)
    cume = c3[1]
    row_of_slot = c3[2]
    bd_prefix = cume - ops.gather_guarded(cume, paths["tile_row_start"]) + bd
    return {
        "sorted_slot": sorted_slot,
        "segs": dict(zip(SEG_KEYS, sorted_out[1:6])),
        "seg_start": c3[0],
        "seg_count": seg_count,
        "backdrop": bd_prefix,
        "row_of_slot": row_of_slot,
        "n_rows": tot[2],
        "n_segs": c_total,
        "r_total": r_total,
        "overflow": overflow,
        **stats,
    }


def path_tiling(lines, counted, caps):
    """Tile-relative segments: the clipping is fused into path_count
    (pre-sort); this stage hands out the sorted result."""
    return counted["segs"]


def _tile_clip_segments(ls, i, z, z_prev, x, y):
    """Clip one crossing's line to its tile (cpu.go PathTiling body)."""
    a, b = ls["a"], ls["b"]
    xy0x, xy0y = ls["xy0x"], ls["xy0y"]
    xy1x, xy1y = ls["xy1x"], ls["xy1y"]
    tile_x = x.to(F32) * TILE_WIDTH
    tile_y = y.to(F32) * TILE_HEIGHT
    tile_x1 = tile_x + TILE_WIDTH
    tile_y1 = tile_y + TILE_HEIGHT
    tiny = torch.full_like(xy0x, TINY)

    top_clipped = z == z_prev
    safe_dy = torch.where(xy1y == xy0y, tiny, xy1y - xy0y)
    xt = xy0x + (xy1x - xy0x) * (tile_y - xy0y) / safe_dy
    xt = torch.minimum(torch.maximum(xt, tile_x + 1e-3), tile_x1)
    safe_dx = torch.where(xy1x == xy0x, tiny, xy1x - xy0x)
    x_clip_t = torch.where(ls["is_positive"], tile_x, tile_x1)
    yt = xy0y + (xy1y - xy0y) * (x_clip_t - xy0x) / safe_dx
    yt = torch.minimum(torch.maximum(yt, tile_y + 1e-3), tile_y1)
    has_top = i > 0.0
    nx0 = torch.where(has_top, torch.where(top_clipped, xt, x_clip_t), xy0x)
    ny0 = torch.where(has_top, torch.where(top_clipped, tile_y, yt), xy0y)

    z_next = torch.floor(a * (i + 1.0) + b)
    bot_clipped = z == z_next
    xtb = xy0x + (xy1x - xy0x) * (tile_y1 - xy0y) / safe_dy
    xtb = torch.minimum(torch.maximum(xtb, tile_x + 1e-3), tile_x1)
    x_clip_b = torch.where(ls["is_positive"], tile_x1, tile_x)
    ytb = xy0y + (xy1y - xy0y) * (x_clip_b - xy0x) / safe_dx
    ytb = torch.minimum(torch.maximum(ytb, tile_y + 1e-3), tile_y1)
    has_bot = i < ls["count"] - 1.0
    nx1 = torch.where(has_bot, torch.where(bot_clipped, xtb, x_clip_b), xy1x)
    ny1 = torch.where(has_bot, torch.where(bot_clipped, tile_y1, ytb), xy1y)

    p0x = nx0 - tile_x
    p0y = ny0 - tile_y
    p1x = nx1 - tile_x
    p1y = ny1 - tile_y
    EPS = SEG_EPS
    y_edge = torch.full_like(p0x, 1e9)
    both_zero = (p0x == 0.0) & (p1x == 0.0)
    whole_tile = both_zero & (p0y == 0.0)
    vanish = both_zero & (p0y != 0.0)
    y_edge = torch.where((p0x == 0.0) & (p1x != 0.0) & (p0y != 0.0), p0y, y_edge)
    y_edge = torch.where((p0x != 0.0) & (p1x == 0.0) & (p1y != 0.0), p1y, y_edge)
    eps = torch.full_like(p0x, EPS)
    p0x = torch.where((p0x == 0.0) & ((p1x == 0.0) | (p0y == 0.0)), eps, p0x)
    p1x = torch.where((p1x == 0.0) & (p1y == 0.0) & ~both_zero, eps, p1x)
    p1x = torch.where(whole_tile, eps, p1x)
    p1y = torch.where(whole_tile, torch.full_like(p1y, float(TILE_HEIGHT)), p1y)
    p1x = torch.where(vanish, 2.0 * eps, p1x)
    p1y = torch.where(vanish, p0y, p1y)
    p0x = torch.where((p0x == torch.floor(p0x)) & (p0x != 0.0), p0x - EPS, p0x)
    p1x = torch.where((p1x == torch.floor(p1x)) & (p1x != 0.0), p1x - EPS, p1x)

    is_down = ls["is_down"]
    return {
        "seg_x0": torch.where(is_down, p0x, p1x),
        "seg_y0": torch.where(is_down, p0y, p1y),
        "seg_x1": torch.where(is_down, p1x, p0x),
        "seg_y1": torch.where(is_down, p1y, p0y),
        "seg_y_edge": y_edge,
    }
