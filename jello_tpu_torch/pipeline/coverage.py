"""Fill coverage per fine command (record), in torch.

Counterpart of `jello_tpu/pipeline/coverage.py` (`rank_records`,
`compute_area_rows`) on the route of
`jello_tpu/tpu/coverage_pallas.py::compute_area_rows_pallas`: coverage
accumulates in SLOT-rank order, the order the crossing sort already
produced. Row r holds the r-th (path, tile) slot that has segments; its
segments are one contiguous run [row_start[r], row_end[r]) of the
slot-sorted stream. The two antialiasing families are one row shape:

  - area: each row is the raw analytic winding of the 256 pixels of its
    tile (fine.wgsl:824-864: trapezoid areas plus y_edge terms) plus the
    slot's backdrop; the fine kernels apply the fill rule per record.
  - msaa8 / msaa16: each row is RESOLVED coverage in [0, 1]: per sample
    of the pattern (`sample_offsets`, the patterns of
    `renderer/mask.py`) the exact winding of the row's segments
    (`msaa_contrib`, `jello_tpu/pipeline/fine_ref.py::_seg_winding`)
    plus the backdrop, rounded to an integer, resolved by the row's fill
    rule (`row_eo`; a clip row resolves nonzero), and the mean over the
    samples. The fine kernels read such a row as it is.

`coverage_rows_plain` is the plain version of the per-row sum that the
coverage kernel (`cuda/coverage.py`, `csrc/coverage.cu`) computes on the
GPU in either mode; the rest (run boundaries, backdrops, rules, the
permutation into record order) is shared by both.

The per-record table has record i's row at index i, EndClips
duplicating their BeginClip's row, rowless records zero; it is [PC8,
256], PC rounded up to a multiple of 8.
"""

from __future__ import annotations

import torch

from ..renderer.mask import _MASK8_PATTERN, _MASK16_PATTERN
from . import ops
from .coarse import CMD_BEGIN_CLIP, CMD_END_CLIP
from .ops import F32, I32, I64

# Segments per add in the plain version (bounds its [n, 256] temporaries).
_SEG_BLOCK = 16384


def rank_records(cmds, caps):
    """Coverage-row ranks of records in record order: a record needs a
    row iff it is visible (tile < GRID) and has segments; an EndClip
    shares its BeginClip's row. Returns (area_row [PC] i32 with -1 when
    rowless, n_rows)."""
    GRID = caps["tile_grid_cap"]
    T = caps["tiles_cap"]
    tile = cmds["tile"]
    kind = cmds["kind"]
    segc = cmds["seg_count"]
    valid = tile < GRID
    needs = valid & (segc > 0) & (kind != CMD_END_CLIP)
    ni = needs.to(I32)
    rk = ops.exclusive_cumsum(ni)
    slot2rank = ops.scatter_set(
        torch.full((T + 1,), -1, dtype=I32, device=tile.device),
        torch.where(needs, cmds["tile_slot"], T), rk)
    end_needs = valid & (segc > 0) & (kind == CMD_END_CLIP)
    end_rank = ops.gather_guarded(slot2rank, torch.clamp(cmds["tile_slot"], 0, T))
    area_row = torch.where(needs, rk, torch.where(end_needs, end_rank, -1)).to(I32)
    return area_row, rk[-1] + ni[-1]


def area_contrib(sx0, sy0, sx1, sy1, sye):
    """Per-pixel analytic winding of segments [n] -> [n, 256]."""
    p = torch.arange(256, dtype=I32, device=sx0.device)
    lx = (p % 16).to(F32)[None, :]
    ly = (p // 16).to(F32)[None, :]
    sx0, sy0, sx1, sy1, sye = (v[:, None] for v in (sx0, sy0, sx1, sy1, sye))
    dx = sx1 - sx0
    dy = sy1 - sy0
    y = sy0 - ly
    y0c = torch.clamp(y, 0.0, 1.0)
    y1c = torch.clamp(y + dy, 0.0, 1.0)
    dyc = y0c - y1c
    safe_dy = torch.where(dy == 0.0, torch.ones_like(dy), dy)
    t0 = (y0c - y) / safe_dy
    t1 = (y1c - y) / safe_dy
    startx = sx0 - lx
    x0 = startx + t0 * dx
    x1 = startx + t1 * dx
    xmin0 = torch.minimum(x0, x1)
    xmax0 = torch.maximum(x0, x1)
    xmin = torch.clamp(xmin0, max=1.0) - 1.0e-6
    b = torch.clamp(xmax0, max=1.0)
    cc = torch.clamp(b, min=0.0)
    d = torch.clamp(xmin, min=0.0)
    # jello_tpu sums the numerator as b + (d^2 - c^2)/2 - xmin. Under a
    # vertical edge the quotient is ~1e-6 over ~1e-6, and in float32 the
    # difference of squares loses up to 6% of it (the oracle's segments
    # and coverage are float64). Regrouped, both terms are exact
    # differences.
    a = ((b - xmin) + 0.5 * ((d - cc) * (d + cc))) / (xmax0 - xmin)
    contrib = torch.where(dyc != 0.0, a * dyc, torch.zeros_like(a))
    return contrib + torch.sign(dx) * torch.clamp(ly - sye + 1.0, 0.0, 1.0)


def sample_offsets(aa: str):
    """Subpixel sample positions (ox, oy) of an MSAA mode, None for area
    mode: sample i of n lies at ((pattern[i] + 0.5) / n, (i + 0.5) / n),
    the rotated-grid 8x and the D3D11 16x pattern of `renderer/mask.py`.
    Every offset is a multiple of 1/32, exact in float32."""
    if aa == "msaa8":
        pat, n = _MASK8_PATTERN, 8
    elif aa == "msaa16":
        pat, n = _MASK16_PATTERN, 16
    else:
        return None
    return [((pat[i] + 0.5) / n, (i + 0.5) / n) for i in range(n)]


def msaa_contrib(sx0, sy0, sx1, sy1, sye, ox, oy):
    """Exact winding of segments [n] at the sample (ox, oy) of each of the
    tile's 256 pixels -> [n, 256]: crossings of the sample's row that lie
    left of the sample, plus the y_edge term (the zero-width limit of
    `area_contrib`). Every value is -2 .. 2, so sums of them are exact."""
    p = torch.arange(256, dtype=I32, device=sx0.device)
    xs = ((p % 16).to(F32) + ox)[None, :]
    ys = ((p // 16).to(F32) + oy)[None, :]
    sx0, sy0, sx1, sy1, sye = (v[:, None] for v in (sx0, sy0, sx1, sy1, sye))
    dx = sx1 - sx0
    dy = sy1 - sy0
    covered = (sy0 <= ys) != (sy1 <= ys)
    safe_dy = torch.where(dy == 0.0, torch.ones_like(dy), dy)
    t = (ys - sy0) / safe_dy
    xi = sx0 + t * dx
    w = torch.where(covered & (xi < xs), -torch.sign(dy), torch.zeros_like(xi))
    return w + torch.sign(dx) * (ys >= sye).to(F32)


def resolved_coverage(a):
    """What the fine stages make of a row that was resolved per sample
    (MSAA): the value as it is, clipped to [0, 1], no fill rule
    (`resolved_coverage` of `csrc/paint.cuh`)."""
    return torch.clamp(a, 0.0, 1.0)


def slot_rank_rows(cmds, counted, caps):
    """Inputs of the per-row sum, in slot-rank space.

    Returns (stream [SC, 8] f32: x0, y0, x1, y1, y_edge, valid, 0, 0;
    row_start, row_end [AR] i32; row_bd [AR] f32; row_eo [AR] i32, 1 where
    the row's consumer resolves by the even-odd rule, built only when
    `caps["aa_mode"]` is an MSAA mode (None in area mode, whose rows
    carry no rule); rec_sr [PC] i32, the slot-rank row of each record's
    slot; n_rows_sr)."""
    slot = counted["sorted_slot"]
    dev = slot.device
    AR = caps["area_rows_cap"]
    T = caps["tiles_cap"]
    GRID = caps["tile_grid_cap"]
    SC = slot.shape[0]

    valid = (slot >= 0) & (slot < T)
    prev = torch.cat([torch.full((1,), -1, dtype=I32, device=dev), slot[:-1]])
    nxt = torch.cat([slot[1:], torch.full((1,), -1, dtype=I32, device=dev)])
    first = (slot != prev) & valid
    last = (slot != nxt) & valid
    # path_count's sorted-run branch has this prefix already (as in
    # jello_tpu's coverage wrapper, `coverage_pallas.py:307`).
    c_first = counted.get("first_cum")
    if c_first is None:
        c_first = torch.cumsum(first.to(I32), 0, dtype=I32)
    srank = torch.clamp(c_first - 1, 0, AR - 1)
    pos = ops.iota(SC, dev)
    zeros = torch.zeros(AR, dtype=I32, device=dev)
    row_start = ops.scatter_set(zeros, torch.where(first, srank, AR), pos)
    row_end = ops.scatter_set(zeros, torch.where(last, srank, AR), pos + 1)

    # Each row's backdrop comes from the record that owns its slot.
    has = (counted["seg_count"] > 0).to(I32)
    sr_of_slot = ops.exclusive_cumsum(has)
    rec_sr = ops.gather_guarded(sr_of_slot, torch.clamp(cmds["tile_slot"], 0, T - 1))
    owns = (cmds["tile"] < GRID) & (cmds["seg_count"] > 0)
    tgt = torch.where(owns, torch.clamp(rec_sr, max=AR - 1), AR)
    row_bd = ops.scatter_set(torch.zeros(AR, dtype=F32, device=dev), tgt,
                             cmds["backdrop"].to(F32))
    row_eo = None
    if caps.get("aa_mode", "area") != "area":
        # The rule of the record that reads the row. A clip row resolves
        # nonzero: the BeginClip is forced here, and its EndClip, which
        # lands on the same row, carries flags 0 (coarse), so either
        # writer says so.
        eo_rec = ((cmds["flags"] & 1) != 0) & (cmds["kind"] != CMD_BEGIN_CLIP)
        row_eo = ops.scatter_set(zeros, tgt, eo_rec.to(I32))

    segs = counted["segs"]
    zc = torch.zeros(SC, dtype=F32, device=dev)
    stream = torch.stack([segs[k].to(F32) for k in
                          ("seg_x0", "seg_y0", "seg_x1", "seg_y1", "seg_y_edge")]
                         + [valid.to(F32), zc, zc], dim=1)
    return stream, row_start, row_end, row_bd, row_eo, rec_sr, c_first[-1]


def coverage_rows_plain(stream, row_start, row_end, row_bd, offsets=None, row_eo=None):
    """Plain version of the coverage kernel. Area mode (offsets None):
    out[r] = the summed analytic winding of stream[row_start[r]:row_end[r]]
    + row_bd[r]. MSAA (offsets from `sample_offsets`, row_eo [R] i32): per
    sample the summed exact winding + row_bd[r], rounded half to even,
    inside by the row's rule (odd under even-odd, else nonzero); out[r] =
    the mean over the samples, in [0, 1]."""
    from ..cuda.scan import column_scan

    dev = stream.device
    R = row_start.shape[0]
    SC = stream.shape[0]
    pos = ops.iota(SC, dev)
    # Row of each segment: row ids scattered at run starts, filled
    # forward, kept where the position lies before that row's end.
    marks = ops.scatter_max(torch.full((SC,), -1, dtype=I32, device=dev),
                            torch.where(row_end > row_start, row_start, SC),
                            ops.iota(R, dev))
    seg_row = column_scan([marks], "max")[0]
    inside = (seg_row >= 0) & (pos < ops.gather_guarded(row_end, seg_row))
    idx = torch.where(inside, seg_row, R).to(I64)
    # Segments past the last row's end add into the dropped row R only,
    # so the sums stop there (the same sums, bit for bit). Reading that
    # bound waits for the device's queue; no frame runs this version on
    # a GPU tensor (`cuda/coverage.py` launches the kernel there), and
    # `composite_records_plain` skips its padding the same way.
    used = int(torch.where(row_end > row_start, row_end, 0).amax()) if R else 0

    def row_sums(contrib_fn):
        out = torch.zeros((R + 1, 256), dtype=F32, device=dev)
        for s in range(0, used, _SEG_BLOCK):
            e = min(s + _SEG_BLOCK, used)
            blk = stream[s:e]
            contrib = contrib_fn(blk[:, 0], blk[:, 1], blk[:, 2], blk[:, 3], blk[:, 4])
            out.index_add_(0, idx[s:e], contrib * blk[:, 5:6])
        return out[:R] + row_bd[:, None]

    if offsets is None:
        return row_sums(area_contrib)
    even_odd = (row_eo != 0)[:, None]
    count = torch.zeros((R, 256), dtype=F32, device=dev)
    for ox, oy in offsets:
        wi = torch.round(row_sums(lambda *seg: msaa_contrib(*seg, ox, oy))).to(I32)
        count += torch.where(even_odd, (wi & 1) != 0, wi != 0).to(F32)
    return count * (1.0 / len(offsets))


def compute_area_rows(cmds, counted, caps, rows_fn=coverage_rows_plain):
    """Per-record coverage table, in the mode of `caps["aa_mode"]` (area
    when absent): raw winding rows in area mode, resolved rows under MSAA.

    rows_fn computes the slot-rank rows (`coverage_rows_plain`, or the
    kernel wrapper `cuda.coverage.coverage_rows`). Returns (area [PC8,
    256] f32, area_row_rec [PC] i32 with -1 when rowless, overflow)."""
    AR = caps["area_rows_cap"]
    area_row_rec, n_rows = rank_records(cmds, caps)
    stream, row_start, row_end, row_bd, row_eo, rec_sr, n_rows_sr = slot_rank_rows(
        cmds, counted, caps)
    offsets = sample_offsets(caps.get("aa_mode", "area"))
    if offsets is None:
        rows = rows_fn(stream, row_start, row_end, row_bd)
    else:
        rows = rows_fn(stream, row_start, row_end, row_bd, offsets, row_eo)
    # Gather slot-rank rows into record order (EndClips read their
    # BeginClip's slot); rowless records are zeroed, never read.
    PCn = area_row_rec.shape[0]
    needs = area_row_rec >= 0
    area = ops.gather_guarded(rows, torch.where(needs, torch.clamp(rec_sr, max=AR - 1), 0))
    area = torch.where(needs[:, None], area, torch.zeros((), dtype=F32, device=area.device))
    PC8 = -(-PCn // 8) * 8
    if PC8 != PCn:
        area = torch.cat([area, area.new_zeros((PC8 - PCn, 256))])
    ids = torch.where(needs, ops.iota(PCn, area.device), -1)
    return area, ids, (n_rows > AR) | (n_rows_sr > AR)
