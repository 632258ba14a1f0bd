"""Monotone landing: the plain version of kernel C.

Counterpart of `jello_tpu/tpu/land_pallas.py::monotone_land`. Kept rows,
whose positions are strictly increasing, land their values at those
positions; nothing else is written. Positions may jump by any amount
from one row to the next (flatten's worklist lands at an exclusive
prefix of counts): jello_tpu's contract that they advance by at most 1
a row bounds its kernel's flush window, and neither this version nor
the CUDA kernel relies on it. `cuda/land.py` wraps the kernel
(`csrc/land.cu`), which takes this version's place for CUDA tensors.

One difference from the TPU kernel: it leaves positions past its last
flush window unwritten, and this version (like the kernel) writes zeros
there. Consumers mask past the landed total either way.
"""

from __future__ import annotations

import torch

from .ops import F32


def monotone_land(pos, keep, vals, out_len):
    """Land vals[k][r] at pos[r] for rows with keep[r] into K zeroed f32
    vectors of length out_len; kept positions outside [0, out_len) are
    dropped.

    pos: [R] int32, strictly increasing on kept rows (each position
    lands at most one row; the call sites pass nondecreasing positions);
    keep: [R] bool; vals: K [R]
    tensors whose values are exact in f32 (|v| < 2^24). Returns a list
    of K [out_len] f32 tensors."""
    vals = torch.stack([v.to(F32) for v in vals])
    lands = keep & (pos >= 0) & (pos < out_len)
    idx = torch.where(lands, pos, out_len).long()
    out = torch.zeros((vals.shape[0], out_len + 1), dtype=F32, device=pos.device)
    out[:, idx] = vals
    return list(out[:, :out_len])
