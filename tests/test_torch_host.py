"""The port's own host half against jello_tpu's: the same scene built
through `jello_tpu` and through `jello_tpu_torch` resolves to byte-equal
scene words, equal layout fields, ramps, atlas plane and placements, and
equal capacity estimates, key for key; the port's native path encoder
and its Python twin agree byte for byte."""

import dataclasses

import numpy as np
import pytest

import jello_tpu
import jello_tpu.scenes
import jello_tpu_torch
import jello_tpu_torch.scenes
from jello_tpu.cpu.pipeline import build_image_atlas as np_build_image_atlas
from jello_tpu.pipeline.gradient import stops_table_or_empty as np_stops_table
from jello_tpu.renderer.estimate import estimate_caps_from_scene as np_estimate
from jello_tpu.renderer.resolve import Resolver as NpResolver

from jello_tpu_torch.encoding import Encoding
from jello_tpu_torch.encoding.path import PathEncoder
from jello_tpu_torch.native import encode_path_native, get_lib
from jello_tpu_torch.pipeline.gradient import stops_table_or_empty
from jello_tpu_torch.renderer.atlas import build_image_atlas
from jello_tpu_torch.renderer.estimate import estimate_caps_from_scene
from jello_tpu_torch.renderer.resolve import Resolver

from .torch_reference import both


def _config(n, **kw):
    return lambda jt: getattr(jt.scenes, f"config{n}")(**kw)


def _dashed_stroke(jt):
    s = jt.Scene()
    st = jt.Stroke(width=4, dash_pattern=(20.0, 10.0), dash_offset=5.0,
                   join=jt.Join.ROUND).with_caps(jt.Cap.SQUARE)
    s.stroke(st, jt.Affine.rotate(0.2), jt.SolidBrush(jt.Color.rgba(0, 1, 0, 1)), None,
             jt.BezPath().move_to(28, 128).cubic_to(90, 30, 170, 230, 226, 128))
    return s, jt.RenderParams(width=256, height=256, base_color=jt.Color.rgba(1, 1, 1, 1))


def _image_fill(jt):
    rng = np.random.default_rng(7)
    s = jt.Scene()
    for k, size in enumerate((8, 40, 16)):
        pix = (rng.random((size, size + 3 * k, 4)) * 255).astype(np.uint8)
        s.fill(jt.Fill.NON_ZERO, jt.Affine.translate(10 + 30 * k, 20) @ jt.Affine.scale(2.5),
               jt.ImageBrush(jt.Image(pixels=pix)), None,
               jt.BezPath().move_to(0, 0).line_to(size, 0).line_to(size, size).close())
    return s, jt.RenderParams(width=128, height=128, base_color=jt.Color.rgba(1, 1, 1, 1))


def _thirty_stops(jt):
    rng = np.random.default_rng(30)
    st = tuple(jt.ColorStop(float(o), jt.Color.rgba(*rng.random(4)))
               for o in np.linspace(0.0, 1.0, 30))
    s = jt.Scene()
    s.fill(jt.Fill.EVEN_ODD, jt.Affine.identity(),
           jt.GradientBrush(jt.LinearGradient((0, 0), (100, 30), st, jt.Extend.REFLECT)), None,
           jt.BezPath().move_to(5, 5).line_to(120, 10).line_to(100, 120).close())
    return s, jt.RenderParams(width=128, height=128, base_color=jt.Color.rgba(0, 0, 0, 0))


# Config 2 is held in tests/test_torch_stroke.py, which builds it once for
# the host comparison and the frame.
SCENES = {
    "config1": _config(1), "config3": _config(3), "config4": _config(4),
    "config5_200": _config(5, n_paths=200), "dashed_stroke": _dashed_stroke,
    "image_fill": _image_fill, "thirty_stops": _thirty_stops,
}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_torch_host_half_matches_jello_tpu(name):
    check_host_half(*both(SCENES[name]))


def check_host_half(built_j, built_t):
    """One scene built through jello_tpu and through the port resolves to
    the same words, layout, ramps, atlas and capacity estimates."""
    (scene_j, params_j), (scene_t, params_t) = built_j, built_t
    assert (params_j.width, params_j.height) == (params_t.width, params_t.height)
    assert params_j.base_color.values == params_t.base_color.values
    lay_j, ramps_j, images_j, words_j = NpResolver().resolve(scene_j.encoding)
    lay_t, ramps_t, images_t, words_t = Resolver().resolve(scene_t.encoding)
    assert words_j.dtype == words_t.dtype == np.uint32
    assert words_j.tobytes() == words_t.tobytes()
    assert dataclasses.asdict(lay_j) == dataclasses.asdict(lay_t)
    assert np.array_equal(np_stops_table(ramps_j), stops_table_or_empty(ramps_t))
    assert np.array_equal(ramps_j.data, ramps_t.data)
    assert (images_j is None) == (images_t is None)
    if images_j is not None:
        assert images_j.placements == images_t.placements
        assert (images_j.width, images_j.height) == (images_t.width, images_t.height)
        assert np.array_equal(np_build_image_atlas(images_j), build_image_atlas(images_t))
    caps_j = np_estimate(words_j, lay_j, params_j.width, params_j.height)
    caps_t = estimate_caps_from_scene(words_t, lay_t, params_t.width, params_t.height)
    assert caps_j == caps_t
    # The estimate without the expansion floors (the host-calibration form).
    assert (np_estimate(words_j, lay_j, params_j.width, params_j.height, None, floors=False)
            == estimate_caps_from_scene(words_t, lay_t, params_t.width, params_t.height,
                                        None, floors=False))


def test_torch_package_exports_the_scene_api():
    assert set(jello_tpu.__all__) == set(jello_tpu_torch.__all__)
    for name in jello_tpu_torch.__all__:
        assert getattr(jello_tpu_torch, name).__module__.startswith("jello_tpu_torch.")


def _python_encode(path, is_fill):
    enc = Encoding()
    pe = PathEncoder(enc, is_fill)
    pe.path(path)
    nsegs = pe.finish(False)
    return np.array(enc.path_tags, dtype=np.uint8), bytes(enc.path_data), nsegs


def _random_path(rng, n_els, dup_prob=0.15):
    p = jello_tpu_torch.BezPath()
    cur = None
    for _ in range(n_els):
        kind = rng.integers(0, 5)
        c = rng.random(6) * 100
        if rng.random() < dup_prob and cur is not None:
            c[:] = [cur[0], cur[1]] * 3  # degenerate: repeat the current point
        if kind == 0 or cur is None:
            p.move_to(c[0], c[1])
            cur = (c[0], c[1])
        elif kind == 1:
            p.line_to(c[0], c[1])
            cur = (c[0], c[1])
        elif kind == 2:
            p.quad_to(*c[:4])
            cur = (c[2], c[3])
        elif kind == 3:
            p.cubic_to(*c)
            cur = (c[4], c[5])
        else:
            p.close()
    return p


@pytest.mark.parametrize("is_fill", [True, False])
def test_torch_native_encoder_matches_python(is_fill):
    if get_lib() is None:
        pytest.skip("native encoder unavailable (no g++)")
    rng = np.random.default_rng(7)
    for trial in range(60):
        path = _random_path(rng, int(rng.integers(1, 12)))
        tags_n, data_n, nsegs_n = encode_path_native(path, is_fill)
        tags_p, data_p, nsegs_p = _python_encode(path, is_fill)
        assert nsegs_n == nsegs_p, (trial, path.elements)
        assert bytes(tags_n) == bytes(tags_p), (trial, path.elements)
        assert data_n.tobytes() == data_p, (trial, path.elements)


def test_torch_native_encoder_wired_into_encoding(monkeypatch):
    if get_lib() is None:
        pytest.skip("native encoder unavailable (no g++)")
    path = jello_tpu_torch.BezPath().move_to(0, 0).cubic_to(10, 0, 10, 10, 0, 10).close()
    enc_nat = Encoding()
    enc_nat.encode_path(path, True)
    monkeypatch.setenv("JELLO_TPU_NO_NATIVE", "1")
    enc_py = Encoding()
    enc_py.encode_path(path, True)
    assert enc_nat.path_tags == enc_py.path_tags
    assert bytes(enc_nat.path_data) == bytes(enc_py.path_data)
    assert enc_nat.n_paths == enc_py.n_paths == 1


def test_torch_native_library_is_built_outside_the_sources():
    if get_lib() is None:
        pytest.skip("native encoder unavailable (no g++)")
    from pathlib import Path

    import jello_tpu_torch.native as native

    lib = Path(native._LIB_PATH)
    assert lib.parent.name == "_build" and lib.exists()
    assert not list(Path(native.__file__).parent.glob("*.so"))


def test_torch_mask_tables_match_jello_tpu():
    """`renderer/mask.py`, the port's copy: the two sample patterns (which
    the coverage stage's sample offsets are built from) and both half-plane
    mask tables equal jello_tpu's."""
    from jello_tpu.renderer import mask as np_mask
    from jello_tpu_torch.renderer import mask

    assert mask._MASK8_PATTERN == np_mask._MASK8_PATTERN
    assert mask._MASK16_PATTERN == np_mask._MASK16_PATTERN
    for name in ("mask_lut_8", "mask_lut_16"):
        got, want = getattr(mask, name)(), getattr(np_mask, name)()
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert mask.mask_lut_8().shape == (32 * 32,) and mask.mask_lut_16().shape == (64 * 64,)


@pytest.mark.parametrize("premul", [True, False])
@pytest.mark.parametrize("srgb", [True, False])
def test_torch_surface_helpers_match_jello_tpu(premul, srgb):
    """`renderer/surface.py`, the port's copy: `premultiply` and `to_rgba8`
    equal jello_tpu's on seeded pixels that leave [0, 1]."""
    from jello_tpu.renderer import surface as np_surface
    from jello_tpu_torch.renderer import surface

    img = (np.random.default_rng(4).random((9, 7, 4)) * 1.2 - 0.1).astype(np.float32)
    assert np.array_equal(surface.premultiply(img), np_surface.premultiply(img))
    got = surface.to_rgba8(img, premul=premul, srgb=srgb)
    assert got.dtype == np.uint8
    assert np.array_equal(got, np_surface.to_rgba8(img, premul=premul, srgb=srgb))
