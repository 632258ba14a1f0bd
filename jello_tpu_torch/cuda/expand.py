"""Expand-sweep kernel wrappers (kernel E and its bodies E, E', E'';
`csrc/expand.cu`).

Counterpart of `jello_tpu/tpu/expand_pallas.py::make_expand_call` with
its three bodies, as reached from `flatten_lockstep_expansion` (Euler
records -> lines) and `path_count_expansions` (lines -> tile crossings,
lines -> backdrop rows). Each wrapper launches the kernel for CUDA
tensors, or takes the plain version in `pipeline/expand.py` (with the
prefix `pipeline.expand.expand_prefix`) only for CPU tensors; there is
no fallback from one to the other. Each body has its own launch count.

On the card a call is one C entry, which computes the expansion's
inclusive prefix and its total itself (a reduce-then-scan over
SCAN_TILE counts a CTA) and then expands: the wrapper checks its
inputs, allocates the outputs, the prefix scratch and the 0-dim total
with `torch.empty`, and makes one ctypes call. The total is read by no
one on the host.
"""

from __future__ import annotations

import torch

from ..pipeline import expand as plain
from ..pipeline.ops import F32, F64, I32
from ..pipeline.tiling import SEG_KEYS
from .build import check, check_tensor, kernels, stream_of

# Counts a CTA of the prefix scan (csrc/expand.cu kScanTile).
SCAN_TILE = 8192


def _scratch(R, dev):
    """The prefix [R] and the tiles' totals, and the 0-dim total."""
    if R == 0:
        raise ValueError("an expansion needs at least one record")
    return (torch.empty(R + -(-R // SCAN_TILE), dtype=I32, device=dev),
            torch.empty((), dtype=I32, device=dev))


def expand_euler(table, rec, counts, EC, sentinel_path):
    """Euler records -> EC line slots. table [NW, 21] f32, rec [3, IT,
    NW] f32, counts [NW] i32. Returns (x0, y0, x1, y1, path, valid,
    e_total), e_total with one dead slot per zero-count item."""
    dev = table.device
    NW = table.shape[0]
    IT = rec.shape[1]
    check_tensor("table", table, F32, dev, (NW, 21))
    check_tensor("rec", rec, F32, dev, (3, IT, NW))
    check_tensor("counts", counts, I32, dev, (NW,))
    if not table.is_cuda:
        incl, total = plain.expand_prefix(counts)
        return plain.euler_lines(table, rec, incl, counts, EC, sentinel_path) + (total,)
    scratch, total = _scratch(NW, dev)
    xy = [torch.empty(EC, dtype=F32, device=dev) for _ in range(4)]
    path = torch.empty(EC, dtype=I32, device=dev)
    valid = torch.empty(EC, dtype=torch.bool, device=dev)
    check("jello_expand_euler", kernels().jello_expand_euler(
        table.data_ptr(), rec.data_ptr(), counts.data_ptr(), scratch.data_ptr(),
        total.data_ptr(), *[t.data_ptr() for t in xy], path.data_ptr(), valid.data_ptr(), NW,
        IT, EC, sentinel_path, stream_of(table)))
    expand_euler.launches += 1
    return (*xy, path, valid, total)


def expand_crossings(P, counts, SC, T):
    """Compacted lines -> SC tile-crossing slots. P [L, 21] f64, counts
    [L] i32 (nonzero prefix). Returns (tile_slot, segments dict of f64,
    bump_slot, bump_delta, c_total)."""
    dev = P.device
    L = P.shape[0]
    check_tensor("P", P, F64, dev, (L, 21))
    check_tensor("counts", counts, I32, dev, (L,))
    if not P.is_cuda:
        incl, total = plain.expand_prefix(counts, assume_compact=True)
        return plain.tile_crossings(P, incl, counts, SC, T) + (total,)
    scratch, total = _scratch(L, dev)
    seg = [torch.empty(SC, dtype=F64, device=dev) for _ in SEG_KEYS]
    ints = [torch.empty(SC, dtype=I32, device=dev) for _ in range(3)]
    check("jello_expand_crossings", kernels().jello_expand_crossings(
        P.data_ptr(), counts.data_ptr(), scratch.data_ptr(), total.data_ptr(),
        *[t.data_ptr() for t in seg + ints], L, SC, T, stream_of(P)))
    expand_crossings.launches += 1
    return ints[0], dict(zip(SEG_KEYS, seg)), ints[1], ints[2], total


def expand_rows(PRT, counts, RC, T):
    """Compacted lines -> RC backdrop-row slots. PRT [L, 5] f64, counts
    [L] i32 (nonzero prefix). Returns (r_slot, r_delta, r_total)."""
    dev = PRT.device
    L = PRT.shape[0]
    check_tensor("PRT", PRT, F64, dev, (L, 5))
    check_tensor("counts", counts, I32, dev, (L,))
    if not PRT.is_cuda:
        incl, total = plain.expand_prefix(counts, assume_compact=True)
        return plain.row_deltas(PRT, incl, counts, RC, T) + (total,)
    scratch, total = _scratch(L, dev)
    r_slot = torch.empty(RC, dtype=I32, device=dev)
    r_delta = torch.empty(RC, dtype=I32, device=dev)
    check("jello_expand_rows", kernels().jello_expand_rows(
        PRT.data_ptr(), counts.data_ptr(), scratch.data_ptr(), total.data_ptr(),
        r_slot.data_ptr(), r_delta.data_ptr(), L, RC, T, stream_of(PRT)))
    expand_rows.launches += 1
    return r_slot, r_delta, total


expand_euler.launches = 0
expand_crossings.launches = 0
expand_rows.launches = 0
