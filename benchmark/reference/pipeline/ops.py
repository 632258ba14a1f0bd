"""Small backend shim between numpy and jax.numpy.

Only the handful of operations whose APIs differ (scatter, stable sort)
live here; everything else uses the common numpy/jax.numpy surface.
"""

from __future__ import annotations

import numpy as np


def scatter_add(xp, target, idx, values):
    out = np.array(target, copy=True)
    idx = np.asarray(idx)
    values = np.broadcast_to(values, idx.shape + target.shape[1:])
    mask = (idx >= 0) & (idx < out.shape[0])
    np.add.at(out, idx[mask], values[mask])
    return out


def scatter_max(xp, target, idx, values):
    out = np.array(target, copy=True)
    idx = np.asarray(idx)
    values = np.broadcast_to(values, idx.shape + target.shape[1:])
    mask = (idx >= 0) & (idx < out.shape[0])
    np.maximum.at(out, idx[mask], values[mask])
    return out


def scatter_set(xp, target, idx, values):
    out = np.array(target, copy=True)
    idx = np.asarray(idx)
    values = np.broadcast_to(values, idx.shape + target.shape[1:])
    mask = (idx >= 0) & (idx < out.shape[0])
    out[idx[mask]] = values[mask]
    return out


def sort_multi(xp, key, arrays):
    """Stable sort of `arrays` (a tuple) by integer `key`.

    Under jax this is one multi-operand lax.sort (the values ride the
    compare-exchange network — much cheaper on TPU than argsort + a
    permutation gather); under numpy a stable argsort + fancy index.
    Returns (sorted_key, *sorted_arrays)."""
    order = np.argsort(key, kind="stable")
    return (key[order],) + tuple(a[order] for a in arrays)


def exclusive_cumsum(xp, v, axis=-1):
    c = xp.cumsum(v, axis=axis)
    return c - v


def bitcast_u32_f32(xp, v):
    return np.asarray(v, dtype=np.uint32).view(np.float32)


def bitcast_f32_u32(xp, v):
    return np.asarray(v, dtype=np.float32).view(np.uint32)


def trailing_zeros32(xp, v):
    """Count of trailing zero bits of nonzero uint32 v (exact: the
    isolated low bit is a power of two, represented exactly in f32)."""
    v = v.astype(xp.uint32)
    low = v & (~v + xp.uint32(1))
    return xp.log2(low.astype(xp.float32)).astype(xp.int32)


def gather_guarded(xp, arr, idx):
    """arr[idx] with out-of-range indices clamped (values unspecified but
    in-bounds; callers mask)."""
    idx = xp.clip(idx.astype(xp.int64), 0, arr.shape[0] - 1)
    return arr[idx]


def barrier(xp, *arrays):
    """Materialization barrier: stops XLA from duplicating expensive
    producers (e.g. re-running a while loop once per consumer) or fusing
    them into downstream loop bodies. Identity under numpy."""
    return arrays if len(arrays) > 1 else arrays[0]


def cummax(xp, v):
    return np.maximum.accumulate(v)


def fori(xp, n, body, state):
    """Bounded loop: Python loop under numpy, lax.fori_loop under jax."""
    for i in range(n):
        state = body(i, state)
    return state


def while_bounded(xp, max_iters, cond, body, state):
    """while cond(state): state = body(state), at most max_iters times.

    Under numpy runs eagerly; under jax lowers to lax.while_loop with an
    iteration counter bound.
    """
    it = 0
    while it < max_iters and cond(state):
        state = body(state)
        it += 1
    return state
