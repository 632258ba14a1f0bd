"""Expand-sweep kernel wrappers (kernel E and its bodies E, E', E'';
`csrc/expand.cu`).

Counterpart of `jello_tpu/tpu/expand_pallas.py::make_expand_call` with
its three bodies, as reached from `flatten_lockstep_expansion` (Euler
records -> lines) and `path_count_expansions` (lines -> tile crossings,
lines -> backdrop rows). Each wrapper computes the expansion's
inclusive prefix (`pipeline.expand.expand_prefix`), then launches the
kernel for CUDA tensors, or takes the plain version in
`pipeline/expand.py` only for CPU tensors; there is no fallback from
one to the other. Each body has its own launch count.
"""

from __future__ import annotations

import torch

from ..pipeline import expand as plain
from ..pipeline.ops import F32, F64, I32
from ..pipeline.tiling import SEG_KEYS
from .build import check, check_tensor, kernels, stream_of


def _check_counts(incl, counts, R):
    check_tensor("counts", counts, I32, counts.device, (R,))
    check_tensor("incl", incl, I32, counts.device, (R,))


def expand_euler(table, rec, counts, EC, sentinel_path):
    """Euler records -> EC line slots. table [NW, 21] f32, rec [3, IT,
    NW] f32, counts [NW] i32. Returns (x0, y0, x1, y1, path, valid,
    e_total), e_total with one dead slot per zero-count item."""
    dev = table.device
    NW = table.shape[0]
    IT = rec.shape[1]
    check_tensor("table", table, F32, dev, (NW, 21))
    check_tensor("rec", rec, F32, dev, (3, IT, NW))
    incl, total = plain.expand_prefix(counts)
    _check_counts(incl, counts, NW)
    if dev.type == "cpu":
        return plain.euler_lines(table, rec, incl, counts, EC, sentinel_path) + (total,)
    xy = torch.empty((4, EC), dtype=F32, device=dev)
    path = torch.empty(EC, dtype=I32, device=dev)
    valid = torch.empty(EC, dtype=torch.bool, device=dev)
    err = kernels().jello_expand_euler(
        table.data_ptr(), rec.data_ptr(), incl.data_ptr(), counts.data_ptr(),
        xy.data_ptr(), path.data_ptr(), valid.data_ptr(), NW, IT, EC, sentinel_path,
        stream_of(table))
    check("jello_expand_euler", err)
    expand_euler.launches += 1
    return xy[0], xy[1], xy[2], xy[3], path, valid, total


def expand_crossings(P, counts, SC, T):
    """Compacted lines -> SC tile-crossing slots. P [L, 21] f64, counts
    [L] i32 (nonzero prefix). Returns (tile_slot, segments dict of f64,
    bump_slot, bump_delta, c_total)."""
    dev = P.device
    L = P.shape[0]
    check_tensor("P", P, F64, dev, (L, 21))
    incl, total = plain.expand_prefix(counts, assume_compact=True)
    _check_counts(incl, counts, L)
    if dev.type == "cpu":
        return plain.tile_crossings(P, incl, counts, SC, T) + (total,)
    seg = torch.empty((5, SC), dtype=F64, device=dev)
    ints = torch.empty((3, SC), dtype=I32, device=dev)
    err = kernels().jello_expand_crossings(
        P.data_ptr(), incl.data_ptr(), counts.data_ptr(), seg.data_ptr(),
        ints.data_ptr(), L, SC, T, stream_of(P))
    check("jello_expand_crossings", err)
    expand_crossings.launches += 1
    return ints[0], dict(zip(SEG_KEYS, seg)), ints[1], ints[2], total


def expand_rows(PRT, counts, RC, T):
    """Compacted lines -> RC backdrop-row slots. PRT [L, 5] f64, counts
    [L] i32 (nonzero prefix). Returns (r_slot, r_delta, r_total)."""
    dev = PRT.device
    L = PRT.shape[0]
    check_tensor("PRT", PRT, F64, dev, (L, 5))
    incl, total = plain.expand_prefix(counts, assume_compact=True)
    _check_counts(incl, counts, L)
    if dev.type == "cpu":
        return plain.row_deltas(PRT, incl, counts, RC, T) + (total,)
    ints = torch.empty((2, RC), dtype=I32, device=dev)
    err = kernels().jello_expand_rows(
        PRT.data_ptr(), incl.data_ptr(), counts.data_ptr(), ints.data_ptr(), L, RC, T,
        stream_of(PRT))
    check("jello_expand_rows", err)
    expand_rows.launches += 1
    return ints[0], ints[1], total


expand_euler.launches = 0
expand_crossings.launches = 0
expand_rows.launches = 0
