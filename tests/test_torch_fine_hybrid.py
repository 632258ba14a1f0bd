"""Frames with clip layers and blend groups through
`jello_tpu_torch.cuda.Renderer(device="cpu")`: the hybrid fine stage
(plain kernel B with its clip-group pass, the plain interpreter on the
legacy tiles, the merge) against jello_tpu.

Tolerance 8e-3 throughout, the tolerance of tests/test_fine_hybrid.py;
the frames are expected within 1e-4 and the tests print what they find.
Under MSAA (the resolved-coverage branch of plain B, G and H) the frames
equal the oracle on float32 segments and leave the float64 oracle only at
sample ties (`torch_reference.check_msaa_frame`).
"""

import numpy as np
import pytest

import jello_tpu
import jello_tpu_torch
from jello_tpu.cpu import render_numpy

from jello_tpu_torch.cuda import Renderer

from .test_fine_hybrid import _run_hybrid
from .torch_reference import (
    CLIP_SCENES,
    _rect,
    both,
    check_frame,
    check_msaa_frame,
    full_scene,
    render_checked,
    with_aa,
)

TOL = 8e-3


def _group_scene(layers, size, ground=None, after=None):
    """`build(jt)`: an optional ground fill, then src-over layers [(mix
    name, alpha, clip rect, [(rgba, rect)])], then an optional fill."""
    def build(jt):
        ident = jt.Affine.identity()
        scene = jt.Scene()

        def fill(rgba, rect):
            scene.fill(jt.Fill.NON_ZERO, ident, jt.SolidBrush(jt.Color.rgba(*rgba)), None,
                       _rect(jt, *rect))

        if ground:
            fill(*ground)
        for mix, alpha, clip, fills in layers:
            scene.push_layer(jt.BlendMode(getattr(jt.Mix, mix), jt.Compose.SRC_OVER), alpha,
                             ident, _rect(jt, *clip))
            for f in fills:
                fill(*f)
            scene.pop_layer()
        if after:
            fill(*after)
        return scene, jt.RenderParams(width=size, height=size,
                                      base_color=jt.Color.rgba(1, 1, 1, 1))
    return build


def _ramp_fills(step):
    return [((step * k, 1 - step * k, 0.3 + step, 0.5),
             (2 + 3 * k, 2 + 2 * k, 40 + 3 * k, 40 + 2 * k)) for k in range(6)]


# The scenes of tests/test_fine_hybrid.py::test_group_scan_*: depth-1
# src-over groups, which stay on kernel B. (name -> (build, v2_chunk))
GROUP_SCENES = {
    "pure_clips": (_group_scene(
        [("CLIP", 1.0, (20.3, 20.7, 100.6, 100.2),
          [((1, 0, 0, 0.6), (10, 10, 80, 80)), ((0, 0, 1, 0.5), (15, 15, 90, 90))])],
        128, after=((0, 1, 0, 0.4), (60, 60, 120, 120))), None),
    "chunk_boundary": (_group_scene(
        [("CLIP", 1.0, (5.4, 5.6, 58.5, 58.4), _ramp_fills(0.1))], 64,
        ground=((0.2, 0.2, 0.2, 1), (0, 0, 64, 64))), 8),
    "alpha_groups": (_group_scene(
        [("NORMAL", 0.6, (8.4, 8.6, 120.3, 120.7),
          [((1, 0, 0, 0.7), (4, 4, 100, 100)), ((0, 1, 0, 0.5), (20, 20, 110, 110))]),
         ("CLIP", 0.35, (40.2, 40.8, 90.5, 90.1), [((0.1, 0.1, 0.1, 0.9), (30, 30, 95, 95))]),
         # A zero-coverage group: the clip lies off to the side of its content.
         ("NORMAL", 0.5, (200, 200, 220, 220), [((1, 1, 0, 1), (0, 0, 64, 64))])],
        128, ground=((0.2, 0.5, 0.9, 1), (0, 0, 128, 128))), None),
    "alpha_group_chunk_boundary": (_group_scene(
        [("NORMAL", 0.7, (5.4, 5.6, 58.5, 58.4), _ramp_fills(0.15))], 64,
        ground=((0.3, 0.3, 0.3, 1), (0, 0, 64, 64))), 8),
}


@pytest.mark.parametrize("name", sorted(GROUP_SCENES))
def test_torch_group_scan_matches_jello_tpu_hybrid(name):
    """Kernel B's plain version with clip groups against the numpy oracle
    and, for the two scenes that between them hold every case (rowless
    and zero-coverage EndClips, group alpha, a group across jello_tpu's
    chunk boundary), against jello_tpu's `fine_hybrid` with its Pallas
    kernels in interpret mode (tens of seconds each). No tile is legacy:
    the groups are B's alone."""
    build, chunk = GROUP_SCENES[name]
    scene_j, params_j = build(jello_tpu)
    with np.errstate(all="ignore"):
        ref, flags, caps = render_numpy(scene_j, params_j)
    assert not any(bool(v) for v in flags.values())
    r = Renderer(device="cpu")
    img = r.render(*build(jello_tpu_torch))
    assert not any(r.last_flags.values()), r.last_flags
    assert r.last_stats["legacy_tiles"] == 0
    err_oracle = np.abs(img - ref).max()
    print(f"{name}: vs the oracle {err_oracle:.3e}")
    assert err_oracle <= TOL
    if name in ("alpha_groups", "chunk_boundary"):
        want = _run_hybrid(scene_j, params_j, dict(caps, v2_chunk=chunk) if chunk else caps)
        err_hybrid = np.abs(img - want).max()
        print(f"{name}: vs jello_tpu's hybrid in interpret mode {err_hybrid:.3e}")
        assert err_hybrid <= TOL


# jello_tpu's resolver leaves an unclosed layer without an EndClip, and on
# such a tape its accelerator route, which the port follows, and its oracle
# disagree: that scene is held only as far as the command stream
# (tests/test_torch_clips.py).
FRAME_SCENES = sorted(set(CLIP_SCENES) - {"unbalanced_push"}) + ["full_scene"]


@pytest.mark.parametrize("name", FRAME_SCENES)
def test_torch_clip_frame_matches_oracle(name):
    build = CLIP_SCENES.get(name, full_scene)
    r = Renderer(device="cpu")
    check_frame(r, build, tol=TOL)
    if name in ("mix_stack", "full_scene", "blend_multiply"):
        assert r.last_stats["legacy_tiles"] > 0


@pytest.mark.parametrize("name", ["mix_stack", "full_scene"])
def test_torch_clip_frame_matches_oracle_with_the_batched_interpreter(name, monkeypatch):
    """JELLO_INTERP_BATCH=1, the reference's switch for the 8-tile
    interpreter: the same frame."""
    build = CLIP_SCENES.get(name, full_scene)
    img, _, built = check_frame(Renderer(device="cpu"), build, tol=TOL)
    monkeypatch.setenv("JELLO_INTERP_BATCH", "1")
    seen = []
    from jello_tpu_torch.cuda import fine_interp as kinterp

    real = kinterp.interpret_tiles

    def spy(*args):
        seen.append(args[8])
        return real(*args)

    monkeypatch.setattr(kinterp, "interpret_tiles", spy)
    r = Renderer(device="cpu")
    img_b = r.render(*built)
    assert seen and all(seen)
    assert np.abs(img_b - img).max() <= 1e-6


def _many_fills_under_a_clip(jt, nested):
    """26 translucent fills over one tile under a clip; `nested` puts a
    second clip inside, which makes the tile legacy."""
    ident = jt.Affine.identity()
    clip = jt.BlendMode(jt.Mix.CLIP, jt.Compose.SRC_OVER)
    scene = jt.Scene()
    scene.push_layer(clip, 1.0, ident, _rect(jt, 1.5, 2.5, 14.5, 13.5))
    if nested:
        scene.push_layer(clip, 1.0, ident, _rect(jt, 3.5, 3.5, 12.5, 12.5))
    for k in range(26):
        scene.fill(jt.Fill.NON_ZERO, ident,
                   jt.SolidBrush(jt.Color.rgba(k / 26, 1 - k / 26, 0.5, 0.3)), None,
                   _rect(jt, 0.3 * k, 0.2 * k, 6 + 0.3 * k, 7 + 0.2 * k))
    if nested:
        scene.pop_layer()
    scene.pop_layer()
    return scene, jt.RenderParams(width=32, height=32, base_color=jt.Color.rgba(1, 1, 1, 1))


@pytest.mark.parametrize("nested", [False, True])
def test_torch_cmd_slab_overflow_only_for_legacy_tiles(nested):
    """A clip tile with more records than `cmds_per_tile`: on kernel B it
    renders right and raises nothing (jello_tpu flags it for its kernel's
    coverage window, which kernel B here does not have); on the
    interpreter the slab must grow."""
    r = Renderer(device="cpu")
    check_frame(r, _many_fills_under_a_clip, tol=TOL, nested=nested)
    assert r.last_stats["max_cmds"] > 16 and r._caps["cmds_per_tile"] >= 32
    assert (r.last_stats["legacy_tiles"] > 0) == nested
    r._caps = dict(r._caps, cmds_per_tile=16)
    check_frame(r, _many_fills_under_a_clip, tol=TOL, nested=nested)
    if nested:
        assert ["cmd_slab_overflow"] in r.last_retries and r._caps["cmds_per_tile"] >= 32
    else:
        assert r.last_retries == [] and r._caps["cmds_per_tile"] == 16


def test_torch_renderer_grows_the_legacy_list_and_the_blend_stack():
    """Starved `legacy_tiles_cap` and `blend_depth`: `legacy_overflow` and
    `blend_depth_overflow` grow them and the frame renders."""
    build = CLIP_SCENES["mix_stack"]
    r = Renderer(device="cpu")
    check_frame(r, build, tol=TOL)
    need = r.last_stats["legacy_tiles"]
    assert need > 8
    r._caps = dict(r._caps, legacy_tiles_cap=8, blend_depth=1)
    check_frame(r, build, tol=TOL)
    assert r._caps["legacy_tiles_cap"] >= need and r._caps["blend_depth"] >= 3
    raised = {k for frame in r.last_retries for k in frame}
    assert {"legacy_overflow", "blend_depth_overflow"} <= raised
    print(f"frames run again for: {r.last_retries}")


def test_torch_first_frame_of_a_clip_scene_settles_inside_the_retry_loop():
    """A scene whose legacy tiles outnumber the first class's 2,048 slots
    twice over (72 x 72 tiles under one MULTIPLY layer): two doublings and
    the calibration fit the default `max_retries`."""
    def build(jt):
        ident = jt.Affine.identity()
        full = _rect(jt, 0, 0, 1152, 1152)
        scene = jt.Scene()
        scene.push_layer(jt.BlendMode(jt.Mix.MULTIPLY, jt.Compose.SRC_OVER), 0.9, ident, full)
        scene.fill(jt.Fill.NON_ZERO, ident, jt.SolidBrush(jt.Color.rgba(0.2, 0.6, 0.9, 0.8)),
                   None, _rect(jt, 100.5, 200.5, 1000, 900))
        scene.pop_layer()
        return scene, jt.RenderParams(width=1152, height=1152,
                                      base_color=jt.Color.rgba(1, 1, 1, 1))

    r = Renderer(device="cpu")
    img = r.render(*build(jello_tpu_torch))
    assert not any(r.last_flags.values())
    assert r.last_stats["legacy_tiles"] == 72 * 72
    assert r.last_retries == [["legacy_overflow"], ["legacy_overflow"], ["calibrated"]]
    assert np.isfinite(img).all()
    # The group covers the tiles it does not paint with nothing: white.
    assert np.allclose(img[50, 50], 1.0) and img[700, 700, 0] < 0.9


# Under MSAA: kernel B's groups with alpha and rowless EndClips, a partial
# clip edge, the interpreter's nested mix blends, and every record kind.
MSAA_CLIP_SCENES = {
    "alpha_groups": GROUP_SCENES["alpha_groups"][0],
    "partial_coverage_edge": CLIP_SCENES["partial_coverage_edge"],
    "mix_stack": CLIP_SCENES["mix_stack"],
    "full_scene": full_scene,
}


@pytest.mark.parametrize("aa", ["msaa8", "msaa16"])
@pytest.mark.parametrize("name", sorted(MSAA_CLIP_SCENES))
def test_torch_clip_frame_msaa_matches_oracle(name, aa):
    r = Renderer(device="cpu")
    check_msaa_frame(render_checked(r), with_aa(both(MSAA_CLIP_SCENES[name]), aa))
    assert (r.last_stats["legacy_tiles"] > 0) == (name in ("mix_stack", "full_scene"))


def test_torch_clip_frame_msaa_with_the_batched_interpreter(monkeypatch):
    """JELLO_INTERP_BATCH=1 under msaa8: the same frame."""
    _, (scene, params) = with_aa(both(CLIP_SCENES["mix_stack"]), "msaa8")
    img = Renderer(device="cpu").render(scene, params)
    monkeypatch.setenv("JELLO_INTERP_BATCH", "1")
    assert np.abs(Renderer(device="cpu").render(scene, params) - img).max() <= 1e-6
