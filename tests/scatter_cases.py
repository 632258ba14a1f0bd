"""Inputs and a numpy reference for the drop scatter (`ops.scatter_*`,
kernel K and its plain version): shared by the CPU tests in
`test_torch_stages.py` and the card tests in `test_torch_scatter.py`.
Imports neither jello_tpu nor the port's stages."""

from __future__ import annotations

import numpy as np
import torch

# (op, target dtype): every pair the drop scatter takes.
OP_DTYPES = [("set", "int32"), ("set", "float32"), ("add", "int32"), ("max", "int32"),
             ("max", "float32"), ("min", "int32")]
WIDTHS = [1, 2, 4, 16]
IDX_DTYPES = ["int32", "int64"]
CASES = ["mixed", "all_dropped", "one_target", "duplicates"]


def _values(rng, shape, op, dtype):
    """Values for `op`: ints spanning int32 (wrapping sums), zeros among
    them; floats with ties, +-0, -1e30 and a NaN or two."""
    if dtype == "int32":
        v = rng.integers(-(1 << 31), 1 << 31, shape, dtype=np.int64)
        small = rng.random(shape) < 0.5
        v[small] = rng.integers(-6, 7, int(small.sum()))
        v[rng.random(shape) < 0.15] = 0
        return v.astype(np.int32)
    v = rng.choice(np.array([-3.5, -1.0, 0.0, 1.0, 2.25, 7.0, 1e30, -1e30], np.float32), shape)
    v = v + rng.standard_normal(shape).astype(np.float32) * (rng.random(shape) < 0.5)
    v[rng.random(shape) < 0.1] = np.float32(-0.0)
    if op == "max" and v.size > 8:
        v.reshape(-1)[rng.integers(0, v.size, 2)] = np.nan
    return v.astype(np.float32)


def case(name, op, dtype, width, idx_dtype, seed=0, n=37, m=300):
    """(target, idx, values) numpy arrays of one adversarial case: target
    [n] or [n, width], idx [m] (negative, >= n and in range), values
    [m] or [m, width]. `duplicates` repeats in-range targets (for set,
    never: a set's duplicates keep no order)."""
    rng = np.random.default_rng([seed, CASES.index(name), width, len(op), len(dtype)])
    row = () if width == 1 else (width,)
    if dtype == "int32":
        target = rng.integers(-50, 50, (n,) + row).astype(np.int32)
    else:
        target = np.full((n,) + row, -1e30, np.float32)
        target[::3] = rng.standard_normal(target[::3].shape).astype(np.float32)
        target[1::7] = np.float32(-0.0)
    big = (1 << 40) if idx_dtype == "int64" else (1 << 31) - 1
    far = np.array([-1, -5, n, n + 1, big, -big - 1], np.int64)
    if name == "all_dropped":
        idx = rng.choice(far, m)
    elif name == "one_target":
        idx = np.full(m, n // 2, np.int64)
        idx[rng.random(m) < 0.3] = n
    elif name == "duplicates":
        idx = np.sort(rng.integers(0, n, m))
        idx[rng.random(m) < 0.2] = -1
    else:
        idx = rng.integers(-8, n + 8, m)
        far_j = rng.random(m) < 0.1
        idx[far_j] = rng.choice(far, int(far_j.sum()))
    if op == "set" and name != "one_target":
        # One entry a target: later in-range duplicates are dropped.
        seen = set()
        for j, t in enumerate(idx):
            if 0 <= t < n:
                idx[j] = t if t not in seen else n + 3
                seen.add(int(t))
    values = _values(rng, (m,) + row, op, dtype)
    return target, idx.astype(idx_dtype), values


def _combine(op, a, b):
    if op == "set":
        return b
    if op == "add":
        return ((a.astype(np.int64) + b + (1 << 31)) % (1 << 32) - (1 << 31)).astype(np.int32)
    if op == "min":
        return np.minimum(a, b)
    if a.dtype == np.int32:
        return np.maximum(a, b)
    # float max as torch's CPU scatter_reduce amax: a NaN value wins, a
    # NaN already there stays.
    return np.where(np.isnan(b), b, np.where(a < b, b, a))


def reference(target, idx, values, op):
    """The drop contract entry by entry, in index order."""
    out = target.copy()
    n = out.shape[0]
    for j, t in enumerate(idx.astype(np.int64)):
        if 0 <= t < n:
            out[t] = _combine(op, out[t], values[j])
    return out


def assert_held(got, want, op, idx=None, values=None):
    """got (a tensor) against the numpy reference: bit for bit, but for
    which of +0 and -0 a float max keeps and which NaN; a set whose
    targets repeat may keep any of their values."""
    g = got.cpu().numpy()
    assert g.dtype == want.dtype and g.shape == want.shape
    n = len(g)
    live = np.empty(0, np.int64) if idx is None else idx[(idx >= 0) & (idx < n)]
    if op == "set" and len(np.unique(live)) < len(live):
        for t in np.unique(live):
            cand = values[idx == t]
            assert np.all(np.any(cand.view(np.int32) == g[t].view(np.int32), axis=0)), t
        rest = np.setdiff1d(np.arange(n), live)
        assert np.array_equal(g[rest].view(np.int32), want[rest].view(np.int32))
        return
    if g.dtype == np.float32:
        assert np.array_equal(g, want, equal_nan=True)
        nz = ~np.isnan(want) & (want != 0)
        assert np.array_equal(g.view(np.int32)[nz], want.view(np.int32)[nz])
    else:
        assert np.array_equal(g, want)


def to_torch(target, idx, values, device="cpu"):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (target, idx, values))
