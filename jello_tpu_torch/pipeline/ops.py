"""Tensor helpers shared by the torch pipeline stages.

Counterpart of `jello_tpu/pipeline/ops.py`: the scatters with drop
semantics (through kernel K, `cuda.scatter.drop_scatter`, whose plain
version `drop_scatter_plain` is here), the stable multi-operand sort, the
u32 <-> f32 bitcasts, `trailing_zeros32` and `gather_guarded`; and the
plain version of kernel I, the integer column scan (`column_scan_plain`),
which takes the place of `cummax` (the stages call
`cuda.scan.column_scan`).

u32 convention: torch has no `>>`, `+` or `<` on `torch.uint32` on the
CPU, so scene and record words travel as int32 tensors holding the u32
bit pattern. A right shift of such a word is arithmetic, so every shift
is followed by a mask (`shr`). Constants with bit 31 set go through
`s32` before they meet an int32 tensor.
"""

from __future__ import annotations

import torch

I32 = torch.int32
I64 = torch.int64
F32 = torch.float32
F64 = torch.float64
INT32_MIN = -(1 << 31)


def s32(v: int) -> int:
    """The int32 value with the same bit pattern as the u32 constant v."""
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= (1 << 31) else v


def shr(w: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int32-carried u32 words."""
    if k == 0:
        return w
    return (w >> k) & ((1 << (32 - k)) - 1)


def bitcast_u32_f32(w: torch.Tensor) -> torch.Tensor:
    return w.to(I32).view(F32)


def bitcast_f32_u32(v: torch.Tensor) -> torch.Tensor:
    return v.to(F32).view(I32)


def _drop_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Out-of-range indices go to the dump row `n`."""
    idx = idx.to(I64)
    return torch.where((idx >= 0) & (idx < n), idx, n)


def _with_dump_row(target: torch.Tensor) -> torch.Tensor:
    return torch.cat([target, target[:1]], dim=0)


def _expand_idx(idx, values, target):
    """Broadcast per-row indices over the row shape of `values`."""
    shape = idx.shape + target.shape[1:]
    values = torch.broadcast_to(values, shape).to(target.dtype)
    if target.dim() > 1:
        idx = idx.reshape(idx.shape + (1,) * (target.dim() - 1)).expand(shape)
    return idx, values


def drop_scatter_plain(target, idx, values, op):
    """Plain version of kernel K (`cuda.scatter.drop_scatter`, its
    contract): torch's scatter onto a copy of the target with a dump row
    appended, where every out-of-range index lands and is cut off."""
    n = target.shape[0]
    out = _with_dump_row(target)
    i, v = _expand_idx(_drop_index(idx, n), values, out)
    if op == "set":
        out.scatter_(0, i, v)
    elif op == "add":
        out.scatter_add_(0, i, v)
    else:
        out.scatter_reduce_(0, i, v, reduce={"max": "amax", "min": "amin"}[op],
                            include_self=True)
    return out[:n]


def _scatter(target, idx, values, op):
    # Looked up at call time: `cuda.scatter` imports this module.
    from ..cuda.scatter import drop_scatter

    return drop_scatter(target, idx, values, op)


def scatter_set(target, idx, values):
    """target[idx] = values; out-of-range rows are dropped (mode="drop").
    Duplicate in-range indices: one of the values wins (as under XLA)."""
    return _scatter(target, idx, values, "set")


def scatter_add(target, idx, values):
    return _scatter(target, idx, values, "add")


def scatter_max(target, idx, values):
    return _scatter(target, idx, values, "max")


def scatter_min(target, idx, values):
    return _scatter(target, idx, values, "min")


def sort_multi(key, arrays):
    """Stable sort of `arrays` by integer `key`.
    Returns (sorted_key, *sorted_arrays)."""
    sk, order = torch.sort(key, stable=True)
    return (sk,) + tuple(a[order] for a in arrays)


def exclusive_cumsum(v, dim=0):
    return torch.cumsum(v, dim=dim, dtype=v.dtype) - v


def column_scan_plain(cols, op="sum", exclusive=False, totals=False):
    """Plain version of kernel I (`cuda.scan.column_scan`, its contract):
    torch's scan over dim 0 of the stacked columns, read back a column a
    row."""
    d = torch.stack(cols, dim=1)
    if op == "sum":
        incl = torch.cumsum(d, dim=0, dtype=I32)
        c = incl - d if exclusive else incl
    else:
        incl = torch.cummax(d, dim=0).values
        c = torch.cat([torch.full_like(d[:1], INT32_MIN), incl[:-1]]) if exclusive else incl
    if not totals:
        return c.t()
    tot = incl[-1] if d.shape[0] else torch.full(
        (len(cols),), 0 if op == "sum" else INT32_MIN, dtype=I32, device=d.device)
    return c.t(), tot


def trailing_zeros32(v: torch.Tensor) -> torch.Tensor:
    """Trailing zero bits of nonzero u32 values held in an int64 tensor
    (0 for v == 0, where the count is undefined)."""
    low = v & -v
    tz = torch.log2(low.clamp(min=1).to(torch.float64)).round()
    return tz.to(I64)


def gather_guarded(arr, idx):
    """arr[idx] with out-of-range indices clamped (values unspecified but
    in bounds; callers mask)."""
    return arr[idx.to(I64).clamp(0, arr.shape[0] - 1)]


def iota(n, device, dtype=I32):
    return torch.arange(n, dtype=dtype, device=device)


def unbounded_bboxes(n, device, big):
    """[n, 4] f32 rows (-big, -big, big, big): the box that clips nothing.
    Filled on the device: a tensor built from a Python list is copied from
    the host, and that copy makes the host wait for the queued work."""
    return torch.cat([torch.full((n, 2), -big, dtype=F32, device=device),
                      torch.full((n, 2), big, dtype=F32, device=device)], dim=1)
