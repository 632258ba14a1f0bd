"""Kernel C's plain version (jello_tpu_torch.pipeline.land.monotone_land,
what the wrapper runs on CPU tensors) vs jello_tpu's Pallas
monotone_land in interpret mode, the landed worklist expansion vs the
scatter one, and the positions the pipeline's four call sites pass.
Landed values are exact integers in f32: the comparisons are exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jello_tpu.tpu.land_pallas import monotone_land as jax_land

from jello_tpu_torch.cuda import land as kland
from jello_tpu_torch.cuda.land import monotone_land
from jello_tpu_torch.cuda.render import upload
from jello_tpu_torch.pipeline.flatten import expand_by_counts
from jello_tpu_torch.pipeline.render import geometry

from .torch_reference import both, prepare


def _case(R, density, seed, counts_of=(1,), weights=None):
    """Rows that land with probability `density`, each landing row
    holding a count drawn from `counts_of`: positions (exclusive prefix
    of the counts) jump by that count."""
    rng = np.random.default_rng(seed)
    counts = (rng.random(R) < density) * rng.choice(counts_of, R, p=weights)
    counts = counts.astype(np.int32)
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


# Positions that jump by more than 1 (counts of 2 and 3, as flatten's
# worklist can give), kept within what jello_tpu's flush window takes
# (about one position a row on average).
@pytest.mark.parametrize(
    "R,out_len,seed",
    [
        (6000, 5000, 10),
        (9000, 2500, 11),   # overflow: landed > out_len
        (300, 1024, 12),    # a single sub-chunk, out_len past every position
    ],
)
def test_torch_land_matches_jax_interpret_with_gaps(R, out_len, seed):
    counts, excl, keep, vals = _case(R, 0.6, seed, (1, 2, 3), (0.6, 0.25, 0.15))
    assert np.diff(excl).max() > 1
    want = jax_land(jnp, jnp.asarray(excl), jnp.asarray(keep),
                    [jnp.asarray(v) for v in vals], out_len, interpret=True)
    got = monotone_land(torch.from_numpy(excl), torch.from_numpy(keep),
                        [torch.from_numpy(v) for v in vals], out_len)
    # A plain scatter of the kept rows: zeros at the gaps.
    lands = keep & (excl < out_len)
    lim = int(excl[lands].max()) + 1
    for g, w, v in zip(got, want, vals):
        ref = np.zeros(out_len, np.float32)
        ref[excl[lands]] = v[lands]
        np.testing.assert_array_equal(g.numpy(), ref)
        np.testing.assert_array_equal(g.numpy()[:lim], np.asarray(w)[:lim])


def test_torch_land_call_sites_pass_monotone_positions(monkeypatch):
    """The four landings of a frame on the expand route (flatten's
    worklist marks, path_count's two nonzero-line compactions, the
    sorted-run starts) pass positions that are nondecreasing and
    strictly increasing on kept rows: the one property kernel C relies
    on. The first paths reach past the frame's left edge, so that some
    lines lie left of their clipped bounding box and make backdrop rows."""
    def build(jt):
        s = jt.Scene()
        for i in range(4):
            x, y = -60 + 60 * i, 40 + 40 * i
            s.fill(jt.Fill.NON_ZERO, jt.Affine.identity(),
                   jt.SolidBrush(jt.Color.rgba(0.2, 0.4, 0.6, 0.8)), None,
                   jt.BezPath().move_to(x, y).cubic_to(x + 150, y - 30, x + 190, y + 170,
                                                        x + 20, y + 120).close())
        return s, jt.RenderParams(width=256, height=256, base_color=jt.Color.rgba(1, 1, 1, 1))

    _, (scene, params) = both(build)
    s, ld, ramps, caps = prepare(scene, params)
    scene_t, layout_t, _, caps = upload(s, ld, ramps, caps, "cpu")
    calls = []
    real = kland.monotone_land

    def spy(*args):
        calls.append(args)
        return real(*args)

    spy.launches = 0
    monkeypatch.setattr(kland, "monotone_land", spy)
    _, flags, _ = geometry(scene_t, layout_t, caps)
    monkeypatch.undo()
    assert not any(bool(v) for v in flags.values())
    assert [len(a[2]) for a in calls] == [2, 1, 1, 3]  # worklist, compactions, runs
    for pos, keep, _, _ in calls:
        assert pos.dtype == torch.int32 and keep.dtype == torch.bool
        assert bool((pos[1:] >= pos[:-1]).all())
        kept = pos[keep]
        assert kept.numel() > 0 and bool((kept[1:] > kept[:-1]).all())


def test_torch_expand_by_counts_landed_matches_scatter():
    counts, _, _, _ = _case(6000, 0.4, 7)
    c = torch.from_numpy(counts)
    base = expand_by_counts(c, 4096)
    landed = expand_by_counts(c, 4096, land=True)
    for a, b in zip(base, landed):
        assert torch.equal(a, b)
