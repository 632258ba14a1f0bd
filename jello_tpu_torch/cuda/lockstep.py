"""Lockstep-walk kernel wrapper (kernel D, `csrc/lockstep.cu`).

Counterpart of `jello_tpu/tpu/lockstep_pallas.py::make_lockstep_call`
(the walk `lockstep_walk`). `lockstep_walk` launches kernel D for CUDA
tensors and takes its plain version, `pipeline.lockstep.lockstep_walk`,
only for CPU tensors; there is no fallback from one to the other.

On the card a call is one 4-byte memset (of `iters`) and one kernel:
the kernel writes every element of the record table, so the wrapper
allocates all outputs uninitialised.
"""

from __future__ import annotations

import torch

from ..pipeline import lockstep as plain
from ..pipeline.ops import F32, I32
from .build import check, check_tensor, kernels, stream_of


def lockstep_walk(table, valid, IT):
    """Walk every work item for at most IT iterations (the contract of
    `pipeline.lockstep.lockstep_walk`). table: [NW, 21] f32 work rows."""
    dev = table.device
    NW = table.shape[0]
    check_tensor("table", table, F32, dev, (NW, 21))
    check_tensor("valid", valid, torch.bool, dev, (NW,))
    if not table.is_cuda:
        return plain.lockstep_walk(table, valid, IT)
    rec = torch.empty((3, IT, NW), dtype=F32, device=dev)
    count = torch.empty(NW, dtype=F32, device=dev)
    not_done = torch.empty(NW, dtype=torch.bool, device=dev)
    iters = torch.empty((), dtype=I32, device=dev)
    err = kernels().jello_lockstep_walk(
        table.data_ptr(), valid.data_ptr(), rec.data_ptr(), count.data_ptr(),
        not_done.data_ptr(), iters.data_ptr(), NW, IT, stream_of(table))
    check("jello_lockstep_walk", err)
    lockstep_walk.launches += 1
    return rec, count, not_done, iters


lockstep_walk.launches = 0
