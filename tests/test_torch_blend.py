"""jello_tpu_torch.blend_math vs jello_tpu.blend_math under numpy: every
mix x compose word of `blend_mix_compose`, and `blend_mix` and
`blend_compose` alone, on seeded premultiplied colors that include the
corners (alpha 0 and 1, equal channels, black, white). Tolerance 1e-6."""

import numpy as np
import pytest
import torch

from jello_tpu import blend_math as bm_np

from jello_tpu_torch import blend_math as bm

TOL = 1e-6
MIXES = list(range(16)) + [bm_np.MIX_CLIP]
COMPOSES = list(range(14))


def _colors(seed, n=256):
    """(bg, src): tuples of four premultiplied channel arrays [n] f32."""
    rng = np.random.default_rng(seed)

    def one():
        rgb = rng.random((3, n)).astype(np.float32)
        a = rng.random(n).astype(np.float32)
        # Corners: transparent, opaque, gray (equal channels), black, white.
        a[:8] = [0, 0, 1, 1, 1, 0.5, 1, 1]
        rgb[:, 2] = 0.25
        rgb[:, 3] = [0.5, 0.5, 0.2]
        rgb[:, 4] = [0.2, 0.7, 0.7]
        rgb[:, 6] = 0.0
        rgb[:, 7] = 1.0
        return tuple((rgb[c] * a).astype(np.float32) for c in range(3)) + (a,)

    return one(), one()


def _t(chs):
    return tuple(torch.from_numpy(c) for c in chs)


@pytest.mark.parametrize("mix", MIXES)
def test_torch_blend_mix_compose_matches_numpy(mix):
    bg, src = _colors(mix)
    worst = 0.0
    for compose in COMPOSES:
        word = (mix << 8) | compose
        with np.errstate(all="ignore"):
            want = bm_np.blend_mix_compose(np, bg, src, np.int32(word))
        got = bm.blend_mix_compose(_t(bg), _t(src), word)
        for w, g in zip(want, got):
            assert g.dtype == torch.float32
            worst = max(worst, float(np.abs(np.asarray(w, np.float32) - g.numpy()).max()))
    assert worst <= TOL, worst


def test_torch_blend_mix_compose_takes_a_word_per_element():
    """The word may be a tensor, one blend per row (the lockstep plain
    interpreter passes the records' words)."""
    bg, src = _colors(99, n=17 * 14)
    words = np.array([(m << 8) | c for m in MIXES for c in COMPOSES], np.int32)
    with np.errstate(all="ignore"):
        want = bm_np.blend_mix_compose(np, bg, src, words)
    got = bm.blend_mix_compose(_t(bg), _t(src), torch.from_numpy(words))
    for w, g in zip(want, got):
        assert np.abs(np.asarray(w, np.float32) - g.numpy()).max() <= TOL


@pytest.mark.parametrize("mix", MIXES + [77])
def test_torch_blend_mix_matches_numpy(mix):
    rng = np.random.default_rng(mix)
    cb = [rng.random(128).astype(np.float32) for _ in range(3)]
    cs = [rng.random(128).astype(np.float32) for _ in range(3)]
    cb[1][:4], cs[1][:4] = cb[0][:4], cs[0][:4]  # ties for set_sat
    cb[2][:2], cs[2][2:4] = cb[0][:2], cs[0][2:4]
    cb[0][4:6], cs[0][6:8] = [0.0, 1.0], [0.0, 1.0]
    with np.errstate(all="ignore"):
        want = bm_np.blend_mix(np, *cb, *cs, np.int32(mix))
    got = bm.blend_mix(*_t(cb), *_t(cs), mix)
    for w, g in zip(want, got):
        assert np.abs(np.asarray(w, np.float32) - g.numpy()).max() <= TOL


@pytest.mark.parametrize("compose", COMPOSES + [14, 200])
def test_torch_blend_compose_matches_numpy(compose):
    rng = np.random.default_rng(100 + compose)
    chans = [rng.random(128).astype(np.float32) for _ in range(8)]
    with np.errstate(all="ignore"):
        want = bm_np.blend_compose(np, *chans, np.int32(compose))
    got = bm.blend_compose(*_t(chans), compose)
    for w, g in zip(want, got):
        assert np.abs(np.asarray(w, np.float32) - g.numpy()).max() <= TOL
