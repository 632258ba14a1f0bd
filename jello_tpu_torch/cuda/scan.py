"""Integer column-scan kernel wrapper (kernel I, `csrc/scan.cu`).

Replaces no Pallas kernel: jello_tpu leaves its prefix scans to XLA.
`column_scan` launches kernel I for CUDA tensors and takes its plain
version, `pipeline.ops.column_scan_plain` (the torch expressions the
stages ran before), only for CPU tensors; there is no fallback from one
to the other.

On the card a call is one ctypes call (one or two kernels): the columns
go to the entry as separate pointers, so nothing is stacked before the
scan, and the exclusive form is written directly. The wrapper allocates
the [k, N] output, the optional totals and the tiles' partials with
`torch.empty`, so inside a captured frame they come from its pool.
"""

from __future__ import annotations

import ctypes

import torch

from ..pipeline import ops
from ..pipeline.ops import I32
from .build import check, kernels, stream_of

# Elements a CTA scans (csrc/scan.cu kTile), and the most columns a call.
TILE = 8192
MAX_COLS = 8
_OPS = {"sum": 0, "max": 1}


def column_scan(cols, op="sum", exclusive=False, totals=False):
    """The inclusive (or exclusive) prefix sum or max of each of the k
    int32 vectors in `cols` (all of one length N, device and stride),
    as an int32 [k, N] tensor whose row i is column i's prefix; sums wrap
    mod 2^32. With `totals`, returns (out, tot): tot [k] int32 holds each
    column's inclusive value at N - 1 (0 or INT32_MIN when N = 0)."""
    if op not in _OPS:
        raise ValueError(f"op: expected 'sum' or 'max', got {op!r}")
    k = len(cols)
    if not 1 <= k <= MAX_COLS:
        raise ValueError(f"cols: expected 1 to {MAX_COLS} columns, got {k}")
    first = cols[0]
    if first.dim() != 1:
        raise ValueError(f"cols[0]: expected a vector, got shape {tuple(first.shape)}")
    N = first.shape[0]
    stride = first.stride(0) if N > 1 else 1
    for i, c in enumerate(cols):
        if (c.dtype != I32 or c.device != first.device or c.shape != first.shape
                or (N > 1 and c.stride(0) != stride)):
            raise ValueError(
                f"cols[{i}]: expected an int32 vector of {N} on {first.device} with stride "
                f"{stride}, got {c.dtype} {tuple(c.shape)} on {c.device}"
                + (f" with stride {c.stride()}" if c.dim() == 1 else ""))
    if not first.is_cuda:
        return ops.column_scan_plain(cols, op, exclusive, totals)
    dev = first.device
    out = torch.empty((k, N), dtype=I32, device=dev)
    tot = torch.empty(k, dtype=I32, device=dev) if totals else None
    tiles = -(-N // TILE)
    partial = torch.empty(k * tiles, dtype=I32, device=dev) if tiles > 1 else None
    ptrs = (ctypes.c_void_p * k)(*[c.data_ptr() for c in cols])
    check("jello_column_scan", kernels().jello_column_scan(
        ptrs, stride, k, N, _OPS[op], int(exclusive), out.data_ptr(),
        None if tot is None else tot.data_ptr(),
        None if partial is None else partial.data_ptr(), stream_of(first)))
    column_scan.launches += 1
    return (out, tot) if totals else out


column_scan.launches = 0
