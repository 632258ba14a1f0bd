"""Renderer(device="cpu") of jello_tpu_torch, end to end, vs the numpy
oracle: images within 2e-3, no flags, u8 present math, capacity
calibration and overflow retries, and MSAA8/16 frames (8e-3, the
tolerance of jello_tpu's MSAA tests; every pixel off the oracle shown to
be a float32 sample tie). Each scene is built twice, through jello_tpu
for the oracle and through jello_tpu_torch for the port."""

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

from .torch_reference import both, check_msaa_frame, prepare, render_checked, with_aa
from .torch_reference import check_frame as _check


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
    """Every frame runs jello_tpu's accelerator routing, set in the caps
    render_frame is given and never in the kept class: `_coarse_dense`
    on a clip-free frame. The geometry stages have one route and no
    routing key."""
    from jello_tpu_torch.cuda import render as render_mod

    seen = []
    frame = render_mod.render_frame

    def spy(scene, layout, ramps, atlas, caps, fine_impl):
        seen.append(caps)
        return frame(scene, layout, ramps, atlas, caps, fine_impl)

    monkeypatch.setattr(render_mod, "render_frame", spy)
    r = Renderer(device="cpu")
    _check(r, _gradient_blobs, seed=9, n=6)
    assert seen and all(c.get("_coarse_dense") is True for c in seen)  # a clip-free frame
    assert all(c.get("aa_mode") == "area" for c in seen)
    routing = {"_coarse_dense", "_image_tap", "_interp_batch", "aa_mode", "clip_depth_cap"}
    assert not routing & set(r._caps)


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


def test_torch_renderer_renders_the_clip_scene():
    """The clip layer renders on the hybrid fine stage and matches the
    oracle (the MSAA frames are held in
    test_torch_renderer_msaa_matches_oracle)."""
    r = Renderer(device="cpu")
    _check(r, _clip_scene)
    assert "legacy_overflow" in r.last_flags  # the hybrid stage's flag set


def _one_fill(path, rule, rgba=(0, 1, 0, 1), base=(0, 0, 0, 0)):
    def build(jt):
        s = jt.Scene()
        s.fill(getattr(jt.Fill, rule), jt.Affine.identity(),
               jt.SolidBrush(jt.Color.rgba(*rgba)), None, path(jt))
        return s, jt.RenderParams(width=256, height=256, base_color=jt.Color.rgba(*base))
    return build


def _diamond(jt):
    return (jt.BezPath().move_to(128, 28).line_to(228, 128).line_to(128, 228)
            .line_to(28, 128).close())


def _ring(jt):
    return (jt.BezPath()
            .move_to(40, 40).line_to(200, 40).line_to(200, 200).line_to(40, 200).close()
            .move_to(80, 80).line_to(160, 80).line_to(160, 160).line_to(80, 160).close())


def _msaa_scene(jt):
    """config 1's cubic fill on a transparent ground (alpha = coverage)."""
    scene, _ = jt.scenes.config1()
    return scene, jt.RenderParams(width=256, height=256)


def _three_kinds(jt):
    """tests/test_coverage_pallas.py::_scene: a nonzero cubic fill, a
    translucent even-odd triangle over it and a round-capped stroke."""
    scene = jt.Scene()
    ident = jt.Affine.identity()
    path = jt.BezPath().move_to(30, 40).cubic_to(90, 10, 150, 220, 200, 240).close()
    scene.fill(jt.Fill.NON_ZERO, ident, jt.SolidBrush(jt.Color.rgba(1, 0, 0, 1)), None, path)
    tri = jt.BezPath().move_to(10, 10).line_to(200, 30).line_to(60, 200).close()
    scene.fill(jt.Fill.EVEN_ODD, ident, jt.SolidBrush(jt.Color.rgba(0, 0, 1, 0.5)), None, tri)
    st = jt.Stroke(width=3.0, join=jt.Join.ROUND, start_cap=jt.Cap.ROUND, end_cap=jt.Cap.ROUND)
    wavy = jt.BezPath().move_to(20, 200).cubic_to(80, 120, 160, 260, 240, 180)
    scene.stroke(st, ident, jt.SolidBrush(jt.Color.rgba(0, 0.5, 0, 1)), None, wavy)
    return scene, jt.RenderParams(width=256, height=256, base_color=jt.Color.rgba(1, 1, 1, 1))


# The scenes of tests/test_msaa.py and of tests/test_coverage_pallas.py, and
# the frames this file holds in area mode.
MSAA_SCENES = {
    "diamond": _one_fill(_diamond, "NON_ZERO"),
    "ring_even_odd": _one_fill(_ring, "EVEN_ODD"),
    "config1_fill": _msaa_scene,
    "three_kinds": _three_kinds,
    "gradient_blobs": _gradient_blobs,
    "image": _image_scene,
    "clip": _clip_scene,
}


@pytest.mark.parametrize("aa", ["msaa8", "msaa16"])
@pytest.mark.parametrize("name", sorted(MSAA_SCENES))
def test_torch_renderer_msaa_matches_oracle(name, aa):
    r = Renderer(device="cpu")
    img, ref = check_msaa_frame(render_checked(r), with_aa(both(MSAA_SCENES[name]), aa))
    if name in ("diamond", "ring_even_odd", "config1_fill"):
        # One opaque fill on a transparent ground: alpha is the coverage,
        # a whole number of samples, as tests/test_msaa.py holds the oracle.
        n = int(aa[4:])
        a = img[..., 3]
        assert np.array_equal(a * n, np.round(a * n)) and a.min() == 0.0 and a.max() == 1.0
    if name == "ring_even_odd":  # edges on the pixel grid: no partial pixel
        assert img[120, 120, 3] == 0.0 and img[60, 120, 3] == 1.0
        assert a.sum() == 160 * 160 - 80 * 80
    elif name in ("diamond", "config1_fill"):
        assert 0 < ((a > 0) & (a < 1)).sum() < a.size // 10
    if name == "diamond":
        area, _, _ = _check(Renderer(device="cpu"), MSAA_SCENES[name])
        assert abs(a.sum() - area[..., 3].sum()) / area[..., 3].sum() < 0.02
        assert np.abs(a - area[..., 3]).max() <= 0.5 + 1.0 / n


def test_torch_renderer_area_frames_are_unchanged_by_msaa():
    """One renderer alternating between the modes: the antialiasing mode
    rides the frame's routing and the frame cache key, never the kept
    capacity class, so an area frame after an MSAA frame equals a fresh
    renderer's bit for bit, and so does the MSAA frame after it."""
    scene, params = _three_kinds(jello_tpu_torch)
    params_m = _three_kinds(jello_tpu_torch)[1]
    params_m.antialiasing_method = jello_tpu_torch.AaConfig.MSAA8
    fresh_area = Renderer(device="cpu").render(scene, params)
    fresh_msaa = Renderer(device="cpu").render(scene, params_m)
    r = Renderer(device="cpu")
    assert np.array_equal(r.render(scene, params_m), fresh_msaa)
    assert "aa_mode" not in r._caps
    assert np.array_equal(r.render(scene, params), fresh_area)
    assert np.array_equal(r.render(scene, params_m), fresh_msaa)
    assert np.abs(fresh_msaa - fresh_area).max() > 0.05


def test_torch_frame_routing_carries_the_aa_mode():
    from jello_tpu_torch.cuda.render import frame_routing

    assert frame_routing(0, False, 0)["aa_mode"] == "area"
    assert frame_routing(2, True, 3, "msaa16")["aa_mode"] == "msaa16"


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
