"""The expand sweep: the plain version of kernel E and its three bodies.

Counterpart of `jello_tpu/tpu/expand_pallas.py` (`build_expand_table`,
`make_expand_call` and the bodies `_euler_compute`, `_crossing_compute`,
`_row_compute`), without the TPU's windows: R records expand into
outputs by counts, and each output slot j computes from its owning
record's row and its index within that record.

The contract:
  - incl is the inclusive prefix of max(counts, 1), or of counts under
    `assume_compact` (a caller that compacted its records to a nonzero
    prefix); its last entry is the total, which counts one dead slot per
    zero-count record unless compact;
  - the owner of slot j is searchsorted(incl, j, right=True);
  - within = j - (incl[owner] - max(counts[owner], 1));
  - valid = 0 <= within < counts[owner]; slots past the total are
    invalid.

`cuda/expand.py` wraps the kernel (`csrc/expand.cu`, one template with
the three bodies), which takes these functions' place for CUDA tensors.
"""

from __future__ import annotations

import torch

from . import ops
from .flatten import apply_transform, euler_line_points
from .ops import F32, I32
from .tiling import backdrop_rows, crossings


def expand_prefix(counts, assume_compact=False):
    """(incl [R] int32, total 0-dim int32) of an expansion by counts."""
    c1 = counts if assume_compact else torch.clamp(counts, min=1)
    incl = torch.cumsum(c1, 0, dtype=I32)
    return incl, incl[-1]


def expand_owner(incl, counts, out_cap):
    """Each output slot's owning record (clamped into range), its index
    within the record and its valid flag."""
    R = incl.shape[0]
    j = ops.iota(out_cap, incl.device)
    owner = torch.searchsorted(incl, j, right=True)
    own = torch.clamp(owner, max=R - 1)
    cnt = counts[own]
    within = j - (incl[own] - torch.clamp(cnt, min=1))
    valid = (owner < R) & (within >= 0) & (within < cnt)
    return own, within, valid


def euler_lines(table, rec, incl, counts, EC, sentinel_path):
    """Euler records -> lines (`_euler_compute`).

    table: [NW, 21] f32 work rows (cubic 0..7, offset 8, scale 9, start
    point 10..11, end point 12..13, transform 14..19, path 20); rec: [3,
    IT, NW] f32 lockstep records (t0, t1, n); counts: [NW] int32 lines
    per item. Each line finds its record by a prefix walk over the
    item's iterations, and its start point re-evaluates the item's
    previous line (chaining without communication), so every line end
    point is computed exactly as on the XLA route. Returns (x0, y0, x1,
    y1 f32 [EC], zero where invalid; path i32 [EC], sentinel_path where
    invalid; valid bool [EC])."""
    own, within, valid = expand_owner(incl, counts, EC)
    row = table[own]
    r = rec[:, :, own]

    def rec_at(w):
        zero = torch.zeros(w.shape, dtype=F32, device=w.device)
        acc, t0, t1, n, wr = zero, zero, zero, zero, zero
        wf = w.to(F32)
        for it in range(rec.shape[1]):
            hi = acc + r[2, it]
            sel = (wf >= acc) & (wf < hi)
            t0 = torch.where(sel, r[0, it], t0)
            t1 = torch.where(sel, r[1, it], t1)
            n = torch.where(sel, r[2, it], n)
            wr = torch.where(sel, wf - acc, wr)
            acc = hi
        return t0, t1, n, wr

    P8 = tuple(row[:, k] for k in range(8))
    off, scale = row[:, 8], row[:, 9]

    def point(w):
        t0, t1, n, wr = rec_at(w)
        return euler_line_points(P8, t0, t1, wr, n, off, scale, row[:, 12], row[:, 13])

    lx1, ly1 = point(within)
    px, py = point(torch.clamp(within - 1, min=0))
    first = within == 0
    lp0x = torch.where(first, row[:, 10], px)
    lp0y = torch.where(first, row[:, 11], py)
    swap = off < 0.0
    T6 = [row[:, 14 + k] for k in range(6)]
    x0, y0 = apply_transform(T6, torch.where(swap, lx1, lp0x), torch.where(swap, ly1, lp0y))
    x1, y1 = apply_transform(T6, torch.where(swap, lp0x, lx1), torch.where(swap, lp0y, ly1))
    zero = torch.zeros((), dtype=F32, device=table.device)
    return (torch.where(valid, x0, zero), torch.where(valid, y0, zero),
            torch.where(valid, x1, zero), torch.where(valid, y1, zero),
            torch.where(valid, row[:, 20].to(I32), sentinel_path).to(I32), valid)


def tile_crossings(P, incl, counts, SC, T):
    """Lines -> tile crossings (`_crossing_compute`). P: [L, 21] f64
    compacted per-line table (tiling.py's columns). Returns (tile_slot,
    segments dict of f64 [SC], bump_slot, bump_delta), as
    `tiling.crossings`."""
    own, within, valid = expand_owner(incl, counts, SC)
    return crossings(P[own], within, valid, T)


def row_deltas(PRT, incl, counts, RC, T):
    """Lines -> backdrop rows (`_row_compute`). PRT: [L, 5] f64 compacted
    rows (tiling.ROW_COLS). Returns (r_slot, r_delta) i32 [RC]."""
    own, within, valid = expand_owner(incl, counts, RC)
    return backdrop_rows(PRT[own], within, valid, T)
