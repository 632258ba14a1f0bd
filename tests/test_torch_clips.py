"""Clip layers in the port's geometry stages vs jello_tpu under numpy:
`clip_leaf_vectorized` vs the sequential `clip_leaf` (bboxes and patched
monoids exact), the clip stream of `draw_leaf`, the general coarse branch
and `classify_legacy_tiles` on clip scenes (integers exact), and the
coverage table, whose backdrop a BeginClip and its EndClip now write for
one slot (1e-5). Inputs are seeded numpy; everything runs on the CPU."""

import numpy as np
import pytest
import torch

import jello_tpu
from jello_tpu.pipeline import clips as clips_np
from jello_tpu.pipeline import coarse as coarse_np
from jello_tpu.pipeline import coverage as coverage_np

import jello_tpu_torch
from jello_tpu_torch.cuda import Renderer, upload
from jello_tpu_torch.cuda.render import frame
from jello_tpu_torch.pipeline import clips, coarse, drawobjs
from jello_tpu_torch.pipeline import coverage as coverage_t
from jello_tpu_torch.pipeline.render import geometry
from jello_tpu_torch.scenes import _blob, _rng, _solid, circle

from .torch_reference import (
    CLIP_SCENES,
    as_np,
    full_scene,
    numpy_geometry,
    prepare_with_atlas,
    to_torch,
    tree_to_torch,
    u32,
)

SCENES = dict(CLIP_SCENES, full_scene=full_scene)


def _random_stack(rng, NC=32, P=64):
    """A balanced random nesting of at most NC clip elements."""
    while True:
        seq, depth = [], 0
        for _ in range(int(rng.integers(1, 24))):
            if depth > 0 and rng.random() < 0.4:
                seq.append(0)
                depth -= 1
            else:
                seq.append(1)
                depth += 1
        seq += [0] * depth
        if len(seq) <= NC:
            break
    clip_idx = np.zeros(NC, np.int32)
    clip_path = np.zeros(NC, np.int32)
    for i, s in enumerate(seq):
        clip_idx[i] = i
        clip_path[i] = int(rng.integers(0, P)) if s else ~i
    pb = rng.random((P, 4)).astype(np.float32) * 100
    pb[:, 2:] += pb[:, :2]
    return len(seq), clip_idx, clip_path, pb


@pytest.mark.parametrize("seed", range(4))
def test_torch_clip_leaf_vectorized_matches_sequential(seed):
    rng = np.random.default_rng(seed)
    for trial in range(25):
        n, clip_idx, clip_path, pb = _random_stack(rng)
        layout = {"n_clips": np.int32(n)}
        caps = {"n_clips_cap": 32, "clip_depth_cap": 32}
        dmp = np.arange(128, dtype=np.int32)
        dms = np.arange(128, dtype=np.int32) * 7
        b1, p1, s1 = clips_np.clip_leaf(np, clip_idx, clip_path, pb, dmp.copy(), dms.copy(),
                                        layout, caps)
        b2, p2, s2 = clips.clip_leaf_vectorized(
            to_torch(clip_idx), to_torch(clip_path), to_torch(pb), to_torch(dmp),
            to_torch(dms), {"n_clips": n}, caps)
        assert np.array_equal(b1[:n], as_np(b2)[:n]), trial
        assert np.array_equal(p1, as_np(p2)) and np.array_equal(s1, as_np(s2)), trial


def test_torch_clip_leaf_without_clips_passes_the_monoid_through():
    dmp = torch.arange(8, dtype=torch.int32)
    bboxes, p, s = clips.clip_leaf_vectorized(
        torch.zeros(16, dtype=torch.int32), torch.zeros(16, dtype=torch.int32),
        torch.zeros((4, 4)), dmp, dmp * 3, {"n_clips": 0}, {"n_clips_cap": 16})
    assert bboxes.shape == (16, 4) and torch.equal(p, dmp) and torch.equal(s, dmp * 3)


def _both(name):
    scene_j, params_j = SCENES[name](jello_tpu)
    s, ld, ramps, _, caps = prepare_with_atlas(scene_j, params_j)
    assert "_coarse_dense" not in caps  # a frame with clip layers
    ref = numpy_geometry(s, ld, caps)
    scene_t, layout_t, _, _ = upload(s, ld, ramps, caps, "cpu")
    return ref, scene_t, layout_t, caps


@pytest.mark.parametrize("name", ["nested_clips", "unbalanced_push", "mix_stack", "full_scene"])
def test_torch_draw_leaf_clip_stream_and_clip_leaf_match_numpy(name):
    ref, scene_t, layout_t, caps = _both(name)
    fl = tree_to_torch({k: ref["fl"][k] for k in ("path_trans_idx", "path_draw_flags")})
    tags = to_torch(ref["cmds_tag"])
    dm = drawobjs.draw_monoid_scan(tags)
    info, clip_idx, clip_path = drawobjs.draw_leaf(
        scene_t, layout_t, dm, fl["path_trans_idx"], fl["path_draw_flags"], caps, tags)
    n = layout_t["n_clips"]
    assert n > 0
    assert np.array_equal(u32(ref["info"]), u32(as_np(info)))
    bboxes, dm_path, dm_scene = clips.clip_leaf_vectorized(
        clip_idx, clip_path, to_torch(ref["fl"]["path_bbox"]), dm["path_idx"],
        dm["scene_offset"], layout_t, caps)
    # The oracle's monoid is the sequential walk's, patched.
    assert np.array_equal(ref["dm"]["path_idx"], as_np(dm_path))
    assert np.array_equal(ref["dm"]["scene_offset"], as_np(dm_scene))
    draw_bbox = coarse.binning_bboxes(dict(dm, path_idx=dm_path), to_torch(ref["fl"]["path_bbox"]),
                                      bboxes)
    assert np.array_equal(ref["draw_bbox"], as_np(draw_bbox))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_torch_geometry_with_clips_matches_numpy(name):
    """The port's stages chained on their own outputs land on the
    oracle's command stream (general coarse branch), its flags word with
    the blend bit, and its begin-zero markers."""
    ref, scene_t, layout_t, caps = _both(name)
    got, flags, stats = geometry(scene_t, layout_t, caps)
    assert not any(bool(v) for v in flags.values())
    cmds, gcmds = ref["cmds"], got["cmds"]
    live = cmds["tile"] < caps["tile_grid_cap"]
    assert live.sum() == int(cmds["n_cmds"]) == stats["cmds"]
    for k in ("tile", "kind", "draw", "seg_count", "backdrop", "flags", "tile_slot"):
        assert np.array_equal(u32(cmds[k])[live], u32(as_np(gcmds[k]))[live]), k
    for k in ("tile_start", "tile_end"):
        assert np.array_equal(cmds[k], as_np(gcmds[k])), k
    assert np.array_equal(u32(cmds["dtab"]), u32(as_np(gcmds["dtab"])))
    lt = coarse_np.classify_legacy_tiles(np, cmds, caps)[0]
    assert int(stats["legacy_tiles"]) == int(lt.sum())


@pytest.mark.parametrize("image_tap", [False, True])
@pytest.mark.parametrize("name", ["nested_clips", "blend_multiply", "normal_group",
                                  "mix_stack", "full_scene"])
def test_torch_classify_legacy_tiles_matches_numpy(name, image_tap):
    ref, _, _, caps = _both(name)
    caps = dict(caps, _image_tap=True) if image_tap else caps
    cmds = ref["cmds"]
    want = coarse_np.classify_legacy_tiles(np, cmds, caps)
    got = coarse.classify_legacy_tiles(
        tree_to_torch({k: cmds[k] for k in ("tile", "kind", "flags", "tile_start")}), caps)
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), as_np(g))
    # nested_clips' rects meet on tile edges: no tile holds both clips'
    # records, so none is nested within a tile.
    expected_legacy = {"nested_clips": False, "blend_multiply": True, "normal_group": False,
                       "mix_stack": True, "full_scene": True}[name]
    assert bool(want[0].any()) == expected_legacy


@pytest.mark.parametrize("name", ["partial_coverage_edge", "nested_clips", "full_scene"])
def test_torch_coverage_table_with_clips_matches_numpy(name):
    """A BeginClip and its EndClip share a slot and each writes its
    backdrop (equal values); EndClips read their BeginClip's row. 1e-5,
    the coverage kernel's tolerance against the XLA route."""
    ref, _, _, caps = _both(name)
    cmds, counted = ref["cmds"], ref["counted"]
    want, want_ids, _ = coverage_np.compute_area_rows(np, cmds, counted, caps)
    tcounted = tree_to_torch({k: v for k, v in counted.items()})
    got, got_ids, ovf = coverage_t.compute_area_rows(
        tree_to_torch({k: v for k, v in cmds.items() if k != "dtab"}), tcounted, caps)
    assert not bool(ovf)
    ends = (cmds["kind"] == coarse_np.CMD_END_CLIP) & (cmds["tile"] < caps["tile_grid_cap"])
    assert ends.any()
    want_ids = np.asarray(want_ids)
    assert np.array_equal(want_ids >= 0, as_np(got_ids) >= 0)
    rows = want_ids >= 0
    n = rows.shape[0]
    assert np.abs(np.asarray(want)[:n][rows] - as_np(got)[:n][rows]).max() <= 1e-5


def config4_reduced(jt):
    """Config 4's nested layers (`scenes.config4`: a full-frame gradient
    under stacks of one to three mix-blended layers, each over four blobs),
    8 stacks at 256x256; one of them three deep."""
    from jello_tpu_torch.scenes import _gradient

    rng = _rng(4)
    scene = jt.Scene()
    mixes = [jt.Mix.NORMAL, jt.Mix.MULTIPLY, jt.Mix.SCREEN, jt.Mix.OVERLAY,
             jt.Mix.DARKEN, jt.Mix.LIGHTEN, jt.Mix.DIFFERENCE, jt.Mix.EXCLUSION]
    ident = jt.Affine.identity()
    full = jt.BezPath().move_to(0, 0).line_to(256, 0).line_to(256, 256).line_to(0, 256).close()
    scene.fill(jt.Fill.NON_ZERO, ident, _gradient(rng, 128, 128, 128), None, full)
    for i in range(8):
        cx, cy = rng.random(2) * 256
        r = 16 + 40 * rng.random()
        depth = 3 if i == 5 else 1 + int(rng.integers(0, 3))
        for d in range(depth):
            blend = jt.BlendMode(mixes[int(rng.integers(0, len(mixes)))], jt.Compose.SRC_OVER)
            scene.push_layer(blend, float(0.5 + 0.5 * rng.random()), ident,
                             circle(cx, cy, r * (1 - 0.2 * d)))
        for _ in range(4):
            bx, by = cx + rng.normal(0, r), cy + rng.normal(0, r)
            scene.fill(jt.Fill.NON_ZERO, ident, _solid(rng), None, _blob(rng, bx, by, r * 0.5))
        for _ in range(depth):
            scene.pop_layer()
    return scene, jt.RenderParams(width=256, height=256, base_color=jt.Color.rgba(1, 1, 1, 1))


@pytest.mark.parametrize("name", sorted(SCENES) + ["config4_reduced"])
def test_torch_bucketed_clip_depth_is_bit_equal_to_the_exact_depth(name):
    """The routing's clip walk runs the scene's nesting depth rounded up to
    a power of two (`frame_routing`), so that scenes of nearby depths share
    a class: a level past the deepest begin matches nothing. The frame at
    that bucket, and at jello_tpu's 64 levels, equals the frame walked to
    the exact depth bit for bit (fine output, flags and stats)."""
    build = config4_reduced if name == "config4_reduced" else SCENES[name]
    scene, params = build(jello_tpu_torch)
    r = Renderer(device="cpu")
    prepared = r._prepare(scene, params)
    depth = prepared[3]
    caps, fine_impl = r._route(prepared, params, r._caps)
    exact = max(depth, 1)
    assert caps["clip_depth_cap"] == 1 << (exact - 1).bit_length()
    if name == "config4_reduced":
        assert depth == 3 and caps["clip_depth_cap"] == 4
    outs = [frame(*prepared[2], dict(caps, clip_depth_cap=cap), fine_impl)
            for cap in (exact, caps["clip_depth_cap"], clips.MAX_CLIP_DEPTH)]
    for fine_out, packed, keys in outs[1:]:
        assert keys == outs[0][2] and torch.equal(packed, outs[0][1])
        want = outs[0][0] if isinstance(outs[0][0], tuple) else (outs[0][0],)
        got = fine_out if isinstance(fine_out, tuple) else (fine_out,)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
