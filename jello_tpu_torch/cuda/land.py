"""Monotone-landing kernel wrapper (kernel C, `csrc/land.cu`).

Counterpart of `jello_tpu/tpu/land_pallas.py::monotone_land`.
`monotone_land` launches kernel C for CUDA tensors and takes its plain
version, `pipeline.land.monotone_land`, only for CPU tensors; there is
no fallback from one to the other.

A landing on the card is one memset and one kernel and nothing else: the
value vectors go to the kernel as they are (int32 or float32, converted
in registers), and the output is allocated uninitialised and zeroed by
the kernel's entry. The call is so small that the host's work is its
cost, so the checks below read only what they must.
"""

from __future__ import annotations

import torch

from ..pipeline import land as plain
from ..pipeline.ops import F32, I32
from .build import check, check_tensor, kernels, stream_of

# The kernel's value type codes.
_CODES = {I32: 0, F32: 1}
MAX_VALS = 3


def _vector(name, t, dtype, pos):
    """Raise unless t is a contiguous `dtype` vector shaped and placed
    like pos."""
    if (t.dtype != dtype or t.get_device() != pos.get_device() or t.shape != pos.shape
            or not t.is_contiguous()):
        check_tensor(name, t, dtype, pos.device, pos.shape)
        raise ValueError(f"{name}: expected a contiguous {dtype} vector like pos")


def monotone_land(pos, keep, vals, out_len):
    """Land vals[k][r] at pos[r] for kept rows into K zeroed f32 [out_len]
    vectors (the contract of `pipeline.land.monotone_land`). On the card
    the K <= 3 value vectors are int32 or float32 [R] tensors."""
    if pos.dim() != 1:
        raise ValueError(f"pos: expected a vector, got shape {tuple(pos.shape)}")
    _vector("pos", pos, I32, pos)
    _vector("keep", keep, torch.bool, pos)
    if not pos.is_cuda:
        return plain.monotone_land(pos, keep, vals, out_len)
    K = len(vals)
    if not 1 <= K <= MAX_VALS:
        raise ValueError(f"vals: expected 1 to {MAX_VALS} vectors, got {K}")
    ptrs, codes = [None] * MAX_VALS, [0] * MAX_VALS
    for k, v in enumerate(vals):
        code = _CODES.get(v.dtype)
        if code is None:
            raise ValueError(f"vals[{k}]: expected int32 or float32, got {v.dtype}")
        _vector("vals", v, v.dtype, pos)
        ptrs[k], codes[k] = v.data_ptr(), code
    out = torch.empty((K, out_len), dtype=F32, device=pos.device)
    check("jello_monotone_land", kernels().jello_monotone_land(
        pos.data_ptr(), keep.data_ptr(), *ptrs, *codes, out.data_ptr(), pos.shape[0], K,
        out_len, stream_of(pos)))
    monotone_land.launches += 1
    return list(out.unbind(0))


monotone_land.launches = 0
