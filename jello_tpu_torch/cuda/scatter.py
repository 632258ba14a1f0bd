"""Drop-scatter kernel wrapper (kernel K, `csrc/scatter.cu`).

Replaces no Pallas kernel: jello_tpu's scatters are XLA's
(`.at[idx].set/add/max/min(mode="drop")`). `drop_scatter` launches
kernel K for CUDA tensors and takes its plain version,
`pipeline.ops.drop_scatter_plain` (torch's scatters onto a copy of the
target with a dump row), only for CPU tensors; there is no fallback from
one to the other. The stages call it through `ops.scatter_set`,
`scatter_add`, `scatter_max` and `scatter_min`.

On the card a call is one ctypes call: a copy of the target into the
output and one kernel. The index goes to the entry as it is (int32 or
int64), so nothing is cast, compared or appended before the scatter; the
output is allocated here with `torch.empty` (inside a captured frame,
from its pool).
"""

from __future__ import annotations

import math

import torch

from ..pipeline import ops
from ..pipeline.ops import F32, I32, I64
from .build import check, kernels, stream_of

# The kernel's op codes (csrc/scatter.cu), by (op, target dtype).
_CODES = {("set", I32): 0, ("set", F32): 0, ("add", I32): 1, ("max", I32): 2,
          ("min", I32): 3, ("max", F32): 4}
# Row widths (words) the kernel moves as vectors, and the alignment each needs.
_VEC_ALIGN = {1: 4, 2: 8, 4: 16, 8: 16, 16: 16}


def drop_scatter(target, idx, values, op):
    """A copy of `target` ([n, ...] int32 or float32) whose row idx[j]
    is combined with row j of `values` (broadcast to idx's length and
    target's row shape) by `op`, for each j with 0 <= idx[j] < n; other
    indices are dropped. `op`: "set" (where targets repeat, one of the
    values wins), "add" (int32, wrapping), "max" (int32 or float32; a NaN
    wins) or "min" (int32). `idx`: an int32 or int64 vector."""
    code = _CODES.get((op, target.dtype))
    if code is None:
        raise ValueError(f"op {op!r} on {target.dtype}: expected set on int32 or float32, "
                         "add or min on int32, or max on int32 or float32")
    if target.dim() < 1:
        raise ValueError("target: expected at least one dimension, got a 0-dim tensor")
    if idx.dim() != 1 or idx.dtype not in (I32, I64):
        raise ValueError(f"idx: expected an int32 or int64 vector, got {idx.dtype} "
                         f"{tuple(idx.shape)}")
    if idx.device != target.device or values.device != target.device:
        raise ValueError(f"idx and values: expected them on {target.device}, got "
                         f"{idx.device} and {values.device}")
    if not target.is_cuda:
        return ops.drop_scatter_plain(target, idx, values, op)
    n, m = target.shape[0], idx.shape[0]
    if n >= 1 << 31:
        raise ValueError(f"target: expected fewer than 2^31 rows, got {n}")
    w = math.prod(target.shape[1:])
    target = target.contiguous()
    idx = idx.contiguous()
    values = torch.broadcast_to(values, (m,) + target.shape[1:]).to(target.dtype).contiguous()
    out = torch.empty(target.shape, dtype=target.dtype, device=target.device)
    align = _VEC_ALIGN.get(w, 0)
    vec = align > 0 and values.data_ptr() % align == 0 and out.data_ptr() % align == 0
    check("jello_drop_scatter", kernels().jello_drop_scatter(
        target.data_ptr(), out.data_ptr(), idx.data_ptr(), int(idx.dtype == I64),
        values.data_ptr(), m, n, w, code, int(vec), stream_of(target)))
    if m > 0 and n * w > 0:
        drop_scatter.launches += 1
    return out


drop_scatter.launches = 0
