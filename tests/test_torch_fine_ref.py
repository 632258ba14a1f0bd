"""The port's reference fine stage (`jello_tpu_torch/pipeline/fine_ref.py`,
plain torch) against the numpy oracle, whose fine stage is jello_tpu's
`fine_ref.fine` under numpy: a fill scene with both rules, gradients,
clips with blends and an image, in area mode (1e-5) and under msaa8 and
msaa16 (as shipped, and equal to the oracle on float32 segments, off the
float64 oracle only at sample ties: `torch_reference.check_msaa_frame`). Then the
renderer's reroute: a frame whose image minifies past the region windows
of the tap or of the interpreter raises `image_region_overflow`, runs
again through the reference fine stage and matches the oracle (8e-3)."""

import numpy as np
import pytest
import torch

import jello_tpu_torch
from jello_tpu.cpu import render_numpy

from jello_tpu_torch.cuda import Renderer
from jello_tpu_torch.cuda import render as render_mod
from jello_tpu_torch.cuda.render import assemble, frame_routing
from jello_tpu_torch.pipeline import fine_ref
from jello_tpu_torch.pipeline.render import render_frame

from .test_torch_render import _image_scene, _three_kinds
from .torch_reference import (
    CLIP_SCENES,
    both,
    check_msaa_frame,
    full_scene,
    oracle_cbrt,
    over_minified,
    over_minified_in_a_group,
    with_aa,
)

AREA_TOL = 1e-5
REROUTE = ["image_region_overflow: rerouted to fine_ref"]


def _gradients(jt):
    """A linear, a cone radial and a sweep gradient over triangles."""
    def stops(a, b, c):
        return (jt.ColorStop(0.0, jt.Color.rgba(*a, 1)), jt.ColorStop(0.4, jt.Color.rgba(*b, 0.6)),
                jt.ColorStop(1.0, jt.Color.rgba(*c, 1)))

    st = stops((1, 0, 0), (0, 1, 0), (0, 0, 1))
    s = jt.Scene()
    for g, (a, b, c) in (
            (jt.LinearGradient((10, 10), (40, 20), st, jt.Extend.REFLECT),
             ((5, 5), (60, 8), (50, 60))),
            (jt.RadialGradient((20, 90), 4.0, (36, 100), 12, st, jt.Extend.REPEAT),
             ((4, 68), (60, 70), (40, 124))),
            (jt.SweepGradient((64, 64), 0.3, 2.2, st), ((30, 40), (98, 36), (64, 100)))):
        s.fill(jt.Fill.NON_ZERO, jt.Affine.identity(), jt.GradientBrush(g), None,
               jt.BezPath().move_to(*a).line_to(*b).line_to(*c).close())
    return s, jt.RenderParams(width=128, height=128, base_color=jt.Color.rgba(0.2, 0.3, 0.4, 1))


SCENES = {
    "fills_both_rules": _three_kinds,
    "gradients": _gradients,
    "clips_and_blends": CLIP_SCENES["mix_stack"],
    "every_kind": full_scene,
    "image": _image_scene,
}


def _through_fine_ref(scene, params):
    """One frame of the port with the reference fine stage in place of the
    kernels' fine stages, at the scene's estimated class."""
    r = Renderer(device="cpu")
    _, ld, (scene_t, layout_t, ramps_t, atlas_t), depth = r._prepare(scene, params)
    caps = dict(r._caps, **frame_routing(layout_t["n_clips"], atlas_t is not None, depth,
                                         params.antialiasing_method.value))
    fine_out, flags, _ = render_frame(scene_t, layout_t, ramps_t, atlas_t, caps, None)
    assert fine_out.shape == (4, caps["tile_grid_cap"], 256) and fine_out.dtype == torch.float32
    assert "blend_depth_overflow" in flags and "area_rows_overflow" not in flags
    assert not any(bool(v) for v in flags.values()), flags
    return assemble(fine_out, ld).numpy()


@pytest.mark.parametrize("aa", ["area", "msaa8", "msaa16"])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_torch_fine_ref_matches_oracle(name, aa):
    built = with_aa(both(SCENES[name]), aa)
    if aa != "area":
        check_msaa_frame(_through_fine_ref, built)
        return
    (scene_j, params_j), (scene_t, params_t) = built
    # As shipped (2e-3, the tolerance of an area frame: the port's own
    # cbrt moves a curve's end points by up to ~1e-3 px), then fed the
    # oracle's cbrt, where both flatten to the same lines (1e-5).
    shipped = _through_fine_ref(scene_t, params_t)
    with oracle_cbrt():
        img = _through_fine_ref(scene_t, params_t)
    with np.errstate(all="ignore"):
        ref, _, _ = render_numpy(scene_j, params_j)
    err = np.abs(img - ref).max()
    err_own = np.abs(shipped - ref).max()
    print(f"{name}: fine_ref vs the oracle {err:.3e}, with its own cbrt {err_own:.3e}")
    assert img.shape == ref.shape and err <= AREA_TOL and err_own <= 2e-3


def test_torch_fill_coverage_by_hand():
    """`fill_coverage` on one tile: a box [4, 12] x [2, 9] of two segments
    and a backdrop, in the three modes and under both rules: exact per
    sample, within the area formula's 1e-6 edge nudge in area mode."""
    segs = tuple(torch.tensor(v, dtype=torch.float32) for v in
                 ([4.0, 12.0], [9.0, 2.0], [4.0, 12.0], [2.0, 9.0], [1e9, 1e9]))
    one = torch.ones(1, dtype=torch.int32)
    box = torch.zeros((16, 16))
    box[2:9, 4:12] = 1.0
    for aa in ("area", "msaa8", "msaa16"):
        atol = 1e-4 if aa == "area" else 0.0
        for even_odd in (False, True):
            cov = fine_ref.fill_coverage(0 * one, 2 * one, 0 * one, torch.tensor([even_odd]),
                                         segs, aa, chunk=1).reshape(16, 16)
            assert torch.allclose(cov, box, rtol=0, atol=atol)
            shifted = fine_ref.fill_coverage(0 * one, 2 * one, one, torch.tensor([even_odd]),
                                             segs, aa).reshape(16, 16)
            # A backdrop of 1 makes the winding 2 inside and 1 outside.
            want = 1.0 - box if even_odd else torch.ones_like(box)
            assert torch.allclose(shifted, want, rtol=0, atol=atol)


def test_torch_fine_ref_reports_blend_depth_overflow():
    """Its one flag: a push past `blend_depth`."""
    scene, params = CLIP_SCENES["mix_stack"](jello_tpu_torch)
    r = Renderer(device="cpu")
    _, _, (scene_t, layout_t, ramps_t, atlas_t), depth = r._prepare(scene, params)
    caps = dict(r._caps, **frame_routing(layout_t["n_clips"], False, depth), blend_depth=2)
    _, flags, _ = render_frame(scene_t, layout_t, ramps_t, atlas_t, caps, None)
    assert bool(flags["blend_depth_overflow"])
    _, flags, _ = render_frame(scene_t, layout_t, ramps_t, atlas_t, dict(caps, blend_depth=3),
                               None)
    assert not bool(flags["blend_depth_overflow"])


@pytest.mark.parametrize("aa", ["area", "msaa8"])
@pytest.mark.parametrize("name", ["tap", "interpreter"])
def test_torch_renderer_reroutes_an_over_minified_image(name, aa, monkeypatch):
    """The two frames the renderer used to refuse: an image minified past
    the tap's region windows, and one inside a blend group past the
    interpreter's one window. The first frame raises
    `image_region_overflow`, `last_retries` names the reroute, and the
    frame, rendered through the reference fine stage, matches the oracle
    (8e-3; the taps' bilinear terms are summed in another order)."""
    build = {"tap": over_minified, "interpreter": over_minified_in_a_group}[name]
    (scene_j, params_j), (scene_t, params_t) = with_aa(both(build), aa)
    frames = []
    frame = render_mod.render_frame

    def spy(scene, layout, ramps, atlas, caps, fine_impl):
        out = frame(scene, layout, ramps, atlas, caps, fine_impl)
        frames.append((fine_impl, {k: bool(v) for k, v in out[1].items()}))
        return out

    monkeypatch.setattr(render_mod, "render_frame", spy)
    r = Renderer(device="cpu")
    img = r.render(scene_t, params_t)
    assert frames[0][0] is not None and frames[0][1]["image_region_overflow"] is True
    assert frames[1][0] is None and "image_region_overflow" not in frames[1][1]
    assert r.last_retries[0] == REROUTE and not any(r.last_flags.values())
    assert "aa_mode" not in r._caps
    with np.errstate(all="ignore"):
        ref, flags, _ = render_numpy(scene_j, params_j)
    assert not any(bool(v) for v in flags.values())
    err = np.abs(img - ref).max()
    print(f"{name}, {aa}: rerouted frame vs the oracle {err:.3e}; frames run again for "
          f"{r.last_retries}")
    assert img.shape == ref.shape and err <= 8e-3
    assert np.abs(img - 1.0).max() > 0.2  # the image was painted
    # A settled render is two frames, and the surface path takes the dense
    # output too.
    del frames[:]
    u8 = r.render_surface(scene_t, params_t)
    assert [f[0] is None for f in frames] == [False, True] and r.last_retries == [REROUTE]
    assert u8.shape == ref.shape and u8.dtype == np.uint8
    want_u8 = render_mod.present(torch.from_numpy(img)).numpy()
    assert np.array_equal(u8, want_u8)
