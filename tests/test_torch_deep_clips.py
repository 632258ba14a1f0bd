"""Clip layers nested 64 and 65 deep against jello_tpu, on the CPU.

jello_tpu's accelerator route walks `clip_leaf_vectorized` to
`MAX_CLIP_DEPTH` = 64 levels for every scene; the port's routing rounds
the scene's depth up to a power of two and caps it there
(`cuda/render.py::frame_routing`). At 64 levels jello_tpu's two walks
agree. At 65 they do not: the accelerator route leaves the 65th begin its
unbounded box and its EndClip unpatched, while the numpy oracle's
sequential `clip_leaf` clamps the 65th push onto the 64th level
(`jello_tpu/pipeline/clips.py:85`), so the 64th level's EndClip reads the
65th begin's path. The port follows the accelerator route (ROADMAP rule
4): its walk equals `clip_leaf_vectorized` at both depths, and its frame
equals the oracle's frame with that walk in place of `clip_leaf`; the
oracle's own frame at 65 is far from it.

Each oracle frame walks ~140 tape steps with a blend stack of 128
levels (~25 s here); the oracle is given that stack, the class its own
retries reach, so that it renders once."""

import numpy as np
import pytest

from jello_tpu.cpu import render_numpy
from jello_tpu.pipeline import clips as clips_np
from jello_tpu.pipeline import drawobjs, flatten
from jello_tpu.pipeline.render import _draw_tags

from jello_tpu_torch.cuda import Renderer
from jello_tpu_torch.cuda.render import frame_routing
from jello_tpu_torch.pipeline import clips

from .torch_reference import _rect, as_np, both, prepare_with_atlas, to_torch

# The port's frames are 1.2e-7 from the oracle's; at 65 the oracle with
# its sequential walk is 1.0 away, on 2,130 pixels.
TOL = 1e-5
SIZE = 64


def deep_clips(depth):
    """`build(jt)`: `depth` clip layers nested in one another over a
    ground, their rects shrinking by a fraction of a pixel a level, with
    a translucent fill every eighth level and in the two deepest."""
    def build(jt):
        ident = jt.Affine.identity()
        s = jt.Scene()
        s.fill(jt.Fill.NON_ZERO, ident, jt.SolidBrush(jt.Color.rgba(0.9, 0.8, 0.1, 1)), None,
               _rect(jt, 0, 0, SIZE, SIZE))
        for k in range(depth):
            d = 0.37 * k
            s.push_layer(jt.BlendMode(jt.Mix.CLIP, jt.Compose.SRC_OVER), 1.0, ident,
                         _rect(jt, 1 + d, 1.3 + d, SIZE - 1 - 0.5 * d, SIZE - 1.2 - 0.45 * d))
            if k % 8 == 7 or k >= depth - 2:
                s.fill(jt.Fill.NON_ZERO, ident,
                       jt.SolidBrush(jt.Color.rgba((k % 5) / 5, 0.3, 1 - (k % 7) / 7, 0.6)),
                       None, _rect(jt, 0, 0, SIZE, SIZE))
        for _ in range(depth):
            s.pop_layer()
        return s, jt.RenderParams(width=SIZE, height=SIZE, base_color=jt.Color.rgba(1, 1, 1, 1))
    return build


@pytest.mark.parametrize("depth", [1, 3, 4, 5, 63, 64, 65, 100, 128, 1000])
def test_torch_clip_depth_cap_is_at_most_64(depth):
    """The routing's clip walk: the depth rounded up to a power of two, at
    most MAX_CLIP_DEPTH (config 4's depth of 3 walks 4 levels)."""
    want = min(1 << (depth - 1).bit_length(), clips.MAX_CLIP_DEPTH)
    assert frame_routing(1, False, depth)["clip_depth_cap"] == want
    assert "clip_depth_cap" not in frame_routing(0, False, 0)


@pytest.mark.parametrize("depth", [64, 65])
def test_torch_deep_clip_leaf_matches_jello_tpus_walk(depth):
    """The port's walk at its routing's depth on the clip stream of
    jello_tpu's draw_leaf equals jello_tpu's `clip_leaf_vectorized` (clip
    bboxes, patched draw monoid) exactly; the sequential `clip_leaf`
    equals both at 64 and, at 65, differs in the 65th begin's bbox and in
    the monoid of the two deepest EndClips."""
    (scene_j, params_j), (scene_t, params_t) = both(deep_clips(depth))
    r = Renderer(device="cpu")
    prepared = r._prepare(scene_t, params_t)
    caps_t = r._route(prepared, params_t, r._caps)[0]
    assert prepared[3] == depth and caps_t["clip_depth_cap"] == 64

    s, ld, _, _, caps = prepare_with_atlas(scene_j, params_j)
    with np.errstate(all="ignore"):
        fl = flatten.flatten_stage(np, s, ld, caps)
        tags = _draw_tags(np, s, ld, caps["n_draws_cap"])
        dm = drawobjs.draw_monoid_scan(np, tags)
        _, cidx, cpath, _, _, _ = drawobjs.draw_leaf(
            np, s, ld, dm, fl["path_trans_idx"], fl["path_draw_flags"], caps, tag=tags)
        args = (cidx, cpath, fl["path_bbox"], dm["path_idx"].astype(np.int32),
                dm["scene_offset"].astype(np.int32))
        walk = clips_np.clip_leaf_vectorized(np, *args, ld, caps)
        seq = clips_np.clip_leaf(np, *args, ld, caps)
    nc = int(ld["n_clips"])
    assert nc == 2 * depth
    port = clips.clip_leaf_vectorized(*(to_torch(a) for a in args), {"n_clips": nc},
                                      dict(caps, clip_depth_cap=caps_t["clip_depth_cap"]))
    assert np.array_equal(walk[0][:nc], as_np(port[0])[:nc])
    assert np.array_equal(walk[1], as_np(port[1])) and np.array_equal(walk[2], as_np(port[2]))

    rows = np.flatnonzero((seq[0][:nc] != walk[0][:nc]).any(1))
    draws = np.flatnonzero((seq[1] != walk[1]) | (seq[2] != walk[2]))
    if depth == 64:
        assert rows.size == 0 and draws.size == 0
    else:
        # The 65th begin is clip element 64; the EndClips of levels 64
        # and 63 (the clamped push overwrote the 64th level's entry) are
        # the two draws after the deepest fill.
        assert rows.tolist() == [64]
        assert draws.tolist() == [int(cidx[65]), int(cidx[66])]


@pytest.mark.parametrize("depth", [64, 65])
def test_torch_deep_clip_frame_matches_jello_tpu(depth, monkeypatch):
    """The port's frame and flags against the numpy oracle's; at 65 with
    the oracle's clip walk taken by `clip_leaf_vectorized`, jello_tpu's
    accelerator route's walk. The oracle's frame with its own sequential
    walk differs there by far more than TOL (its clip_leaf outputs
    above)."""
    (scene_j, params_j), (scene_t, params_t) = both(deep_clips(depth))
    r = Renderer(device="cpu")
    img = r.render(scene_t, params_t)
    assert not any(r.last_flags.values()), r.last_flags
    assert r.last_stats["legacy_tiles"] > 0
    caps = dict(prepare_with_atlas(scene_j, params_j)[4], blend_depth=128)

    def oracle():
        with np.errstate(all="ignore"):
            ref, flags, _ = render_numpy(scene_j, params_j, caps=caps, max_retries=1)
        assert not any(bool(v) for v in flags.values()), flags
        return ref

    if depth == 65:
        assert np.abs(img - oracle()).max() > 0.5
        monkeypatch.setattr(clips_np, "clip_leaf", clips_np.clip_leaf_vectorized)
    err = np.abs(img - oracle()).max()
    print(f"{depth} deep: max abs error vs the oracle {err:.3e}")
    assert err <= TOL
