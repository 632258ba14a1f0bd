"""Renderer(device="cpu") of jello_tpu_torch, end to end, vs the numpy
oracle: images within 2e-3, no flags, u8 present math, capacity
calibration and overflow retries, and the refusal of MSAA, the one kind
of scene still outside the ported slices. Each scene is built twice, through jello_tpu for the
oracle and through jello_tpu_torch for the port."""

import numpy as np
import pytest
import torch

import jello_tpu
import jello_tpu.scenes
import jello_tpu_torch
import jello_tpu_torch.scenes
from jello_tpu.renderer.surface import to_rgba8

from jello_tpu_torch.cuda import Renderer, upload
from jello_tpu_torch.cuda.render import build_layout_dict, present

from .torch_reference import check_frame as _check
from .torch_reference import prepare


def config1(jt=jello_tpu):
    return jt.scenes.config1()


def _gradient_blobs(jt=jello_tpu, seed=3, n=16, size=128):
    """A small seeded cut of config 3: linear and radial gradient blobs."""
    IDENT = jt.Affine.identity()
    rng = np.random.default_rng(seed)
    s = jt.Scene()
    for i in range(n):
        cx, cy = rng.random(2) * size
        r = 6 + 18 * rng.random()
        p = jt.BezPath().move_to(cx + r, cy)
        for k in range(1, 5):
            a = k * np.pi / 2
            p.cubic_to(cx + r * np.cos(a - 1.2), cy + r * np.sin(a - 1.2) + rng.normal(0, 2),
                       cx + r * np.cos(a - 0.4), cy + r * np.sin(a - 0.4),
                       cx + r * np.cos(a), cy + r * np.sin(a))
        p.close()
        st = tuple(jt.ColorStop(o, jt.Color.rgba(*rng.random(3), 1)) for o in (0.0, 0.5, 1.0))
        g = (jt.LinearGradient((cx - r, cy), (cx + r, cy), st) if i % 2 == 0
             else jt.RadialGradient((cx, cy), 0.0, (cx, cy), r, st))
        s.fill(jt.Fill.NON_ZERO, IDENT, jt.GradientBrush(g), None, p)
    return s, jt.RenderParams(width=size, height=size, base_color=jt.Color.rgba(1, 1, 1, 1))


def test_torch_renderer_config1_matches_oracle():
    _check(Renderer(device="cpu"), config1)


def test_torch_renderer_frames_take_the_expand_route(monkeypatch):
    """Every frame runs jello_tpu's accelerator routing: `_expand_pallas`
    in the caps render_frame is given, never in the kept class."""
    from jello_tpu_torch.cuda import render as render_mod

    seen = []
    frame = render_mod.render_frame

    def spy(scene, layout, ramps, atlas, caps, fine_impl):
        seen.append(caps)
        return frame(scene, layout, ramps, atlas, caps, fine_impl)

    monkeypatch.setattr(render_mod, "render_frame", spy)
    r = Renderer(device="cpu")
    _check(r, _gradient_blobs, seed=9, n=6)
    assert seen and all(c.get("_expand_pallas") is True for c in seen)
    assert all(c.get("_coarse_dense") is True for c in seen)  # a clip-free frame
    assert "_expand_pallas" not in r._caps and "_coarse_dense" not in r._caps


def test_torch_renderer_gradient_blobs_match_oracle():
    _check(Renderer(device="cpu"), _gradient_blobs)


def test_torch_render_surface_matches_present_of_oracle():
    r = Renderer(device="cpu")
    img, ref, (scene, params) = _check(r, _gradient_blobs, seed=8, n=10)
    u8 = r.render_surface(scene, params)
    assert u8.shape == ref.shape and u8.dtype == np.uint8
    # Same present math as the device route: exactly the port's image...
    assert np.array_equal(u8, present(torch.from_numpy(img)).numpy())
    # ...and within one count of jello_tpu's surface conversion of the oracle.
    assert np.abs(u8.astype(int) - to_rgba8(ref).astype(int)).max() <= 1


def test_torch_renderer_calibrates_then_grows_on_overflow():
    r = Renderer(device="cpu")
    s, _, _, est = prepare(*_gradient_blobs(seed=5, n=12))
    _check(r, _gradient_blobs, seed=5, n=12)
    calibrated = dict(r._caps)
    assert calibrated["tiles_cap"] <= est["tiles_cap"]
    assert calibrated["max_iters"] <= est["max_iters"]
    assert calibrated["max_iters"] >= r.last_stats["lockstep_iters"]
    # Starve capacities: the frame overflows, grows and still renders.
    # A grown tiles_cap leaves pair_cap behind, which takes coarse off
    # its dense branch onto the general pair expansion.
    r._caps = dict(calibrated, seg_cap=64, area_rows_cap=16, tiles_cap=32)
    _check(r, _gradient_blobs, seed=5, n=12)
    assert r._caps["seg_cap"] > 64 and r._caps["area_rows_cap"] > 16
    assert 32 < r._caps["tiles_cap"] != r._caps["pair_cap"]


def test_torch_renderer_class_depends_only_on_the_scene():
    """A scene's capacity class is the same whether the renderer drew a
    larger scene before it or not."""
    fresh = Renderer(device="cpu")
    fresh.render(*config1(jello_tpu_torch))
    r = Renderer(device="cpu")
    r.render(*_gradient_blobs(jello_tpu_torch, seed=4, n=8, size=512))
    assert r._caps["tile_grid_cap"] > fresh._caps["tile_grid_cap"]
    _check(r, config1)
    assert r._caps == fresh._caps


def test_torch_renderer_overflow_exhausted_raises():
    scene, params = _gradient_blobs(jello_tpu_torch, seed=6, n=6)
    r = Renderer(device="cpu")
    r.render(scene, params)
    r._caps = dict(r._caps, seg_cap=8)
    with pytest.raises(RuntimeError, match="segs_overflow"):
        r.render(scene, params, max_retries=0)


def _stroke_scene(jt=jello_tpu):
    s = jt.Scene()
    s.stroke(jt.Stroke(width=3.0), jt.Affine.identity(), jt.SolidBrush(jt.Color.rgba(0, 0, 0, 1)),
             None, jt.BezPath().move_to(10, 10).line_to(100, 60))
    return s, jt.RenderParams(width=128, height=128, base_color=jt.Color.rgba(1, 1, 1, 1))


def _clip_scene(jt=jello_tpu):
    IDENT = jt.Affine.identity()
    s = jt.Scene()
    s.push_layer(jt.BlendMode(jt.Mix.NORMAL, jt.Compose.SRC_OVER), 1.0, IDENT,
                 jt.BezPath().move_to(0, 0).line_to(64, 0).line_to(64, 64).close())
    s.fill(jt.Fill.NON_ZERO, IDENT, jt.SolidBrush(jt.Color.rgba(1, 0, 0, 1)), None,
           jt.BezPath().move_to(10, 10).line_to(100, 60).line_to(20, 90).close())
    s.pop_layer()
    return s, jt.RenderParams(width=128, height=128, base_color=jt.Color.rgba(1, 1, 1, 1))


def _image_scene(jt=jello_tpu):
    s = jt.Scene()
    pix = np.full((4, 4, 4), 255, np.uint8)
    pix[1:3, 1:3, :3] = 40
    s.fill(jt.Fill.NON_ZERO, jt.Affine.translate(3.3, 2.7) @ jt.Affine.scale(2.3),
           jt.ImageBrush(jt.Image(pixels=pix)), None,
           jt.BezPath().move_to(0, 0).line_to(8, 0).line_to(8, 8).line_to(0, 8).close())
    return s, jt.RenderParams(width=128, height=128, base_color=jt.Color.rgba(1, 1, 1, 1))


def _msaa_scene(jt=jello_tpu):
    scene, _ = jt.scenes.config1()
    return scene, jt.RenderParams(width=256, height=256,
                                  antialiasing_method=jt.AaConfig.MSAA8)


@pytest.mark.parametrize("case, slice_no", [("clip", "slice 6"), ("msaa", "slice 5")])
def test_torch_renderer_refuses_scenes_outside_the_slice(case, slice_no):
    """MSAA is still refused, by the name of its slice; the clip layer that
    slice 6 used to refuse renders now, on the hybrid fine stage, and
    matches the oracle."""
    if case == "clip":
        r = Renderer(device="cpu")
        _check(r, _clip_scene)
        assert "legacy_overflow" in r.last_flags  # the hybrid stage's flag set
        return
    scene, params = _msaa_scene(jello_tpu_torch)
    with pytest.raises(NotImplementedError, match=slice_no):
        Renderer(device="cpu").render(scene, params)


@pytest.mark.parametrize("case", ["stroke", "image"])
def test_torch_renderer_renders_strokes_and_images(case):
    """The scenes the renderer refused before strokes and image paints
    were ported now render, and match the oracle."""
    r = Renderer(device="cpu")
    _check(r, {"stroke": _stroke_scene, "image": _image_scene}[case])
    assert ("image_region_overflow" in r.last_flags) == (case == "image")


def test_torch_renderer_grows_the_image_record_table():
    """A starved img_recs_cap raises img_recs_overflow, grows and renders."""
    r = Renderer(device="cpu")
    _check(r, _image_scene)
    need = r.last_stats["img_recs"]
    assert need > 2
    r._caps = dict(r._caps, img_recs_cap=2)
    _check(r, _image_scene)
    assert r._caps["img_recs_cap"] >= need


def test_torch_renderer_cuda_device_needs_cuda():
    if torch.cuda.is_available():
        assert Renderer(device="cuda").device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Renderer(device="cuda")


@pytest.mark.parametrize("case", ["config1", "blobs"])
def test_torch_layout_dict_matches_jello_tpu(case):
    from jello_tpu.cpu.pipeline import build_layout_dict as np_build_layout_dict
    from jello_tpu.renderer.resolve import Resolver

    scene, params = config1() if case == "config1" else _gradient_blobs(size=100)
    layout = Resolver().resolve(scene.encoding)[0]
    want = np_build_layout_dict(layout, params)
    got = build_layout_dict(layout, params)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert np.asarray(got[k]).dtype == np.asarray(v).dtype, k
        assert np.array_equal(got[k], v), k


def test_torch_upload_carries_the_numpy_inputs():
    s, ld, ramps, caps = prepare(*config1())
    scene_t, layout_t, ramps_t, caps_t = upload(s, ld, ramps, caps, "cpu")
    assert scene_t.dtype == torch.int32
    assert np.array_equal(scene_t.numpy().view(np.uint32), s)
    assert layout_t["n_path_tags"] == int(ld["n_path_tags"])
    assert np.array_equal(layout_t["base_color"].numpy(), ld["base_color"])
    assert np.array_equal(ramps_t.numpy(), ramps) and caps_t == caps
