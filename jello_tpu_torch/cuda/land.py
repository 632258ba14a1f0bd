"""Monotone-landing kernel wrapper (kernel C, `csrc/land.cu`).

Counterpart of `jello_tpu/tpu/land_pallas.py::monotone_land`.
`monotone_land` launches kernel C for CUDA tensors and takes its plain
version, `pipeline.land.monotone_land`, only for CPU tensors; there is
no fallback from one to the other.
"""

from __future__ import annotations

import torch

from ..pipeline import land as plain
from ..pipeline.ops import F32, I32
from .build import check, check_tensor, kernels, stream_of


def monotone_land(pos, keep, vals, out_len):
    """Land vals[k][r] at pos[r] for kept rows into K zeroed f32 [out_len]
    vectors (the contract of `pipeline.land.monotone_land`)."""
    dev = pos.device
    R = pos.shape[0]
    check_tensor("pos", pos, I32, dev, (R,))
    check_tensor("keep", keep, torch.bool, dev, (R,))
    if dev.type == "cpu":
        return plain.monotone_land(pos, keep, vals, out_len)
    v = torch.stack([x.to(F32) for x in vals])
    check_tensor("vals", v, F32, dev, (len(vals), R))
    out = torch.zeros((len(vals), out_len), dtype=F32, device=dev)
    err = kernels().jello_monotone_land(
        pos.data_ptr(), keep.data_ptr(), v.data_ptr(), out.data_ptr(), R, len(vals),
        out_len, stream_of(pos))
    check("jello_monotone_land", err)
    monotone_land.launches += 1
    return list(out)


monotone_land.launches = 0
