"""Kernel C's plain version (jello_tpu_torch.pipeline.land.monotone_land,
what the wrapper runs on CPU tensors) vs jello_tpu's Pallas
monotone_land in interpret mode, and the landed worklist expansion vs
the scatter one. Landed values are exact integers in f32: the
comparisons are exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jello_tpu.tpu.land_pallas import monotone_land as jax_land

from jello_tpu_torch.cuda.land import monotone_land
from jello_tpu_torch.pipeline.flatten import expand_by_counts


def _case(R, density, seed):
    rng = np.random.default_rng(seed)
    counts = (rng.random(R) < density).astype(np.int32)
    excl = (np.cumsum(counts) - counts).astype(np.int32)
    v0 = rng.integers(0, 1 << 20, R).astype(np.int32)
    return counts, excl, counts > 0, [v0, excl]


# The cases of tests/test_land_pallas.py.
@pytest.mark.parametrize(
    "R,out_len,density,seed",
    [
        (5000, 3000, 0.5, 0),
        (4096, 4096, 1.0, 1),   # dense: every row lands
        (8192, 600, 0.07, 2),   # sparse landings
        (700, 200, 0.9, 3),     # overflow: landed > out_len
        (1, 128, 1.0, 4),       # single row
    ],
)
def test_torch_land_matches_jax_interpret(R, out_len, density, seed):
    _, excl, keep, vals = _case(R, density, seed)
    want = jax_land(jnp, jnp.asarray(excl), jnp.asarray(keep),
                    [jnp.asarray(v) for v in vals], out_len, interpret=True)
    got = monotone_land(torch.from_numpy(excl), torch.from_numpy(keep),
                        [torch.from_numpy(v) for v in vals], out_len)
    lim = min(int(keep.sum()), out_len)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == (out_len,)
        np.testing.assert_array_equal(g.numpy()[:lim], np.asarray(w)[:lim])
        # The port writes zeros past the landed prefix (jello_tpu leaves
        # positions past its last flush window unwritten).
        assert not g[lim:].any()


def test_torch_expand_by_counts_landed_matches_scatter():
    counts, _, _, _ = _case(6000, 0.4, 7)
    c = torch.from_numpy(counts)
    base = expand_by_counts(c, 4096)
    landed = expand_by_counts(c, 4096, land=True)
    for a, b in zip(base, landed):
        assert torch.equal(a, b)
