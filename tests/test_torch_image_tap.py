"""Image paints in jello_tpu_torch.

The plain version of the image-tap stage (`pipeline/image_tap.py`)
against jello_tpu's Pallas kernel in interpret mode, on the same numpy
records and atlas: the fg table within 1e-5 (the two sum the bilinear
terms in another order), both flags equal. Then whole frames against the
numpy oracle within 8e-3, the tolerance of jello_tpu's own tap tests
(about 1e-4 is expected, and printed), under area antialiasing and, for
jello_tpu's own MSAA tap scene, under msaa8. (A frame whose image
minifies past the tap's region windows renders through the reference
fine stage: tests/test_torch_fine_ref.py.)

Last, a cut of config 5 (300 of its 10,000 paths, at its full 1920x1080
canvas) against the numpy oracle: long fills, thin round-capped strokes,
even-odd glyphs, gradients and image paints in one frame, within 2e-3
and with no flag. The oracle takes over a minute at this canvas; the test
lives in this file of many tests because pytest-xdist's `--dist
loadfile` hands files out by their test counts, most first, and a file
of one long test would start last.
"""

import numpy as np
import pytest
import torch

import jello_tpu
import jello_tpu_torch
from jello_tpu.pipeline import coverage as np_cov
from jello_tpu.tpu.fine_pallas import build_records as np_build_records
from jello_tpu.tpu.image_tap import image_tap as jax_image_tap

from jello_tpu_torch.cuda import Renderer
from jello_tpu_torch.cuda.fine_v2 import build_records
from jello_tpu_torch.cuda.render import upload, upload_atlas
from jello_tpu_torch.cuda.image_tap import tap_records
from jello_tpu_torch.pipeline.image_tap import (
    MAX_WIN,
    atlas_planar,
    image_tap,
    region_windows,
    tap_extent_corners,
    tap_geometry,
)

from .torch_reference import (
    as_np,
    both,
    check_frame,
    check_msaa_frame,
    numpy_geometry,
    over_minified,
    prepare_with_atlas,
    random_tap_records,
    render_checked,
    tree_to_torch,
    u32,
    with_aa,
)

TAP_TOL = 1e-5
FRAME_TOL = 8e-3


def _image(jt, seed=7, size=8, alpha=None):
    rng = np.random.default_rng(seed)
    pix = (rng.random((size, size, 4)) * 255).astype(np.uint8)
    pix[..., 3] = 255 if alpha is None else alpha
    return jt.Image(pixels=pix)


def _rect(jt, x0, y0, x1, y1):
    return jt.BezPath().move_to(x0, y0).line_to(x1, y0).line_to(x1, y1).line_to(x0, y1).close()


def _params(jt, w=128, h=128):
    return jt.RenderParams(width=w, height=h, base_color=jt.Color.rgba(1, 1, 1, 1))


# ---- scenes for the tap alone (few image records) -------------------------

def _upscaled(jt):
    s = jt.Scene()
    s.fill(jt.Fill.NON_ZERO, jt.Affine.translate(9.3, 12.6) @ jt.Affine.scale(4.7),
           jt.ImageBrush(_image(jt, seed=5)), None, _rect(jt, 0, 0, 8, 8))
    return s, _params(jt, 64, 64)


def _rotated_translucent(jt):
    xf = jt.Affine.translate(30, 8) @ jt.Affine.rotate(0.35) @ jt.Affine.scale(2.5)
    s = jt.Scene()
    s.fill(jt.Fill.NON_ZERO, xf, jt.ImageBrush(_image(jt, seed=3, alpha=140)), None,
           _rect(jt, 0, 0, 8, 8))
    return s, _params(jt, 64, 64)


def _minified(jt):
    """A 64x64 source at 1/8 scale: each tile spans several region
    windows of the atlas, under the limit."""
    s = jt.Scene()
    s.fill(jt.Fill.NON_ZERO, jt.Affine.translate(8, 6) @ jt.Affine.scale(1.0 / 8.0),
           jt.ImageBrush(_image(jt, seed=9, size=64, alpha=230)), None,
           _rect(jt, 0, 0, 64, 64))
    return s, _params(jt, 64, 64)


TAP_CASES = {
    # name: (scene, img_recs_cap, image_region_overflow, img_recs_overflow)
    "upscaled": (_upscaled, 16, False, False),
    "rotated_translucent": (_rotated_translucent, 16, False, False),
    "minified_multi_window": (_minified, 8, False, False),
    "over_minified": (over_minified, 8, True, False),
    "table_too_small": (_upscaled, 8, False, True),
}


@pytest.mark.parametrize("name", sorted(TAP_CASES))
def test_torch_image_tap_plain_matches_pallas_interpret(name):
    import jax.numpy as jnp

    build, irc, want_region, want_recs = TAP_CASES[name]
    scene, params = build(jello_tpu)
    s, ld, _, atlas, caps = prepare_with_atlas(scene, params)
    caps = dict(caps, _image_tap=True, img_recs_cap=irc)
    ref = numpy_geometry(s, ld, caps)
    with np.errstate(all="ignore"):
        _, area_row, _ = np_cov.compute_area_rows(np, ref["cmds"], ref["counted"], caps)
        cmds = dict(ref["cmds"], area_row=area_row)
        rec = np_build_records(np, cmds, s, ref["info"], caps)
    n_img = int(((cmds["kind"] == 5) & (cmds["tile"] < caps["tile_grid_cap"])).sum())
    assert n_img > 0 and (n_img > irc) == want_recs

    # The port packs the same records, image ranks included.
    cmds_t = tree_to_torch(cmds)
    rec_t = build_records(cmds_t, caps)
    np.testing.assert_array_equal(u32(as_np(rec_t)), u32(rec))

    jcmds = {k: jnp.asarray(cmds[k]) for k in ("kind", "tile")}
    want_fg, want_region_flag, want_recs_flag = jax_image_tap(
        jnp, jnp.asarray(rec), jcmds, jnp.asarray(atlas), ld, caps, interpret=True)
    want_fg = np.asarray(want_fg)

    layout_t = upload(s, ld, np.zeros((1, 11), np.float32), {}, "cpu")[1]
    atlas_t = upload_atlas(atlas, "cpu")
    fg, region_flag, recs_flag = image_tap(rec_t, cmds_t, atlas_t, layout_t, caps)
    assert fg.shape == (irc, 1024) and fg.dtype == torch.float32
    assert bool(region_flag) == bool(want_region_flag) == want_region
    assert bool(recs_flag) == bool(want_recs_flag) == want_recs
    err = np.abs(as_np(fg) - want_fg[:irc]).max()
    print(f"{name}: {n_img} image records, max|fg diff| {err:.3e}")
    assert err <= TAP_TOL
    # Rows past the image count are zero, and so is the row of a record
    # whose region is over the limit (here the first tile's).
    assert not as_np(fg)[min(n_img, irc):].any()
    assert bool(as_np(fg)[0].any()) == (not want_region)


# ---- the tap's extent from the tile's four corner pixels -------------------

EXTENT_SEEDS = [0, 1, 2, 3]


@pytest.mark.parametrize("seed", EXTENT_SEEDS)
def test_torch_tap_extent_corners_equals_the_256_pixel_extent(seed):
    """The corner extent kernels F and G compute equals the min of the
    clamped floor corners and the max of the clamped ceil corners over
    all 256 pixels, on every one of ~200 random records."""
    rec, _ = random_tap_records(seed)
    r = torch.from_numpy(rec.view(np.int32))
    g = tap_geometry(r, 8, 64)
    want = (g["c0"].amin(dim=1), g["r0"].amin(dim=1), g["c1"].amax(dim=1), g["r1"].amax(dim=1))
    got = tap_extent_corners(r, 8, 64)
    for name, a, b in zip(("rx0", "ry0", "rx1", "ry1"), got, want):
        assert a.dtype == torch.int32 and a.shape == (rec.shape[0],)
        bad = torch.nonzero(a != b).flatten().tolist()
        assert not bad, f"{name} differs on records {bad[:10]}"


@pytest.mark.parametrize("seed", EXTENT_SEEDS)
def test_torch_tap_extent_corners_matches_region_offsets(seed):
    """jello_tpu's `_region_offsets` (numpy) on the same records: the
    window origin, the window count and the region flag taken from the
    corner extent equal the y_lo, x_lo and nyx it returns, and its
    ny * nx > MAX_WIN."""
    from jello_tpu.tpu.image_tap import _region_offsets

    rec, atlas = random_tap_records(seed)
    _, AHp, AWp = atlas.shape
    y_lo, x_lo, nyx = _region_offsets(np, rec, 8, 64, AHp, AWp)
    rx0, ry0, rx1, ry1 = tap_extent_corners(torch.from_numpy(rec.view(np.int32)), 8, 64)
    gx_lo, gy_lo, nx, ny = region_windows(rx0, ry0, rx1, ry1, AHp, AWp)
    np.testing.assert_array_equal(as_np(gx_lo), x_lo)
    np.testing.assert_array_equal(as_np(gy_lo), y_lo)
    np.testing.assert_array_equal(as_np((ny << 8) | nx), nyx)
    want_flag = ((nyx >> 8) * (nyx & 0xFF)) > MAX_WIN
    np.testing.assert_array_equal(as_np(ny * nx > MAX_WIN), want_flag)
    assert want_flag.any() and not want_flag.all()


def test_torch_tap_records_wrapper_contract_on_the_cpu():
    """The wrapper's outputs on CPU tensors (the plain version): the fg
    table [IRC, 1024] f32, zero on rows that are not live image records,
    and the region flag a 0-dim bool, set by a record past MAX_WIN
    windows; inputs of another type or shape raise, the width in tiles
    too (a 0-dim int32 tensor, the layout's word, which the kernel reads
    on the device)."""
    rec, atlas = random_tap_records(0, n=24)
    r = torch.from_numpy(rec.view(np.int32))
    a = torch.from_numpy(atlas)
    rows = torch.cat([r, torch.zeros((8, 16), dtype=torch.int32)])
    wit = torch.tensor(8, dtype=torch.int32)
    fg, flag = tap_records(rows, a, wit, 64)
    assert fg.shape == (32, 1024) and fg.dtype == torch.float32 and fg.is_contiguous()
    assert flag.shape == () and flag.dtype == torch.bool and bool(flag)
    assert not fg[24:].any() and fg[:24].any()
    _, flag_ok = tap_records(rows[1:4], a, wit, 64)
    assert flag_ok.shape == () and not bool(flag_ok)
    with pytest.raises(ValueError):
        tap_records(rows.to(torch.int64), a, wit, 64)
    with pytest.raises(ValueError):
        tap_records(rows[:, :8].contiguous(), a, wit, 64)
    with pytest.raises(ValueError):
        tap_records(rows, a[0], wit, 64)
    with pytest.raises(ValueError):
        tap_records(rows, a, 8, 64)
    with pytest.raises(ValueError):
        tap_records(rows, a, wit.to(torch.int64), 64)


def _three_images(jt):
    """Images of three sizes (three atlas placements) under three transforms."""
    s = jt.Scene()
    for k, size in enumerate((8, 24, 12)):
        xf = jt.Affine.translate(6 + 20 * k, 5 + 9 * k) @ jt.Affine.rotate(0.2 * k) \
            @ jt.Affine.scale(1.5 + k)
        s.fill(jt.Fill.NON_ZERO, xf, jt.ImageBrush(_image(jt, seed=40 + k, size=size, alpha=200)),
               None, _rect(jt, 0, 0, size, size))
    return s, _params(jt, 64, 64)


@pytest.mark.parametrize("build", [_rotated_translucent, _three_images])
def test_torch_image_draw_info_matches_numpy(build):
    """The port's stages on an image draw: the per-draw word table
    (inverse transform, atlas placement ay << 16 | ax, packed w << 16 | h)
    and the command stream equal the numpy stages', and so do the packed
    records with their image ranks."""
    from jello_tpu_torch.pipeline.render import geometry

    scene, params = build(jello_tpu)
    s, ld, ramps, _, caps = prepare_with_atlas(scene, params)
    caps = dict(caps, _image_tap=True)
    ref = numpy_geometry(s, ld, caps)
    scene_t, layout_t, _, _ = upload(s, ld, ramps, {}, "cpu")
    got, flags, stats = geometry(scene_t, layout_t, caps)
    assert not any(bool(v) for v in flags.values())
    cmds, gcmds = ref["cmds"], got["cmds"]
    np.testing.assert_array_equal(u32(cmds["dtab"]), u32(as_np(gcmds["dtab"])))
    live = cmds["tile"] < caps["tile_grid_cap"]
    for k in ("tile", "kind", "draw"):
        np.testing.assert_array_equal(u32(cmds[k])[live], u32(as_np(gcmds[k]))[live])
    assert int(stats["img_recs"]) == int((cmds["kind"][live] == 5).sum()) > 0
    with np.errstate(all="ignore"):
        _, area_row, _ = np_cov.compute_area_rows(np, cmds, ref["counted"], caps)
        want = np_build_records(np, dict(cmds, area_row=area_row), s, ref["info"], caps)
    rec = build_records(dict(gcmds, area_row=torch.from_numpy(area_row.astype(np.int32))), caps)
    np.testing.assert_array_equal(u32(as_np(rec))[live], u32(want)[live])


def test_torch_atlas_planar_matches_jello_tpu():
    from jello_tpu.tpu.fine_pallas import atlas_planar as jax_atlas_planar

    rng = np.random.default_rng(1)
    for shape in ((8, 8), (70, 300), (64, 256)):
        plane = rng.random(shape + (4,)).astype(np.float32)
        want, (AHp, AWp) = jax_atlas_planar(plane)
        got = atlas_planar(plane)
        assert got.shape == (4, AHp, AWp) and got.dtype == np.float32
        np.testing.assert_array_equal(got, np.asarray(want))


# ---- frames: the clip-free scenes of jello_tpu's tap tests ------------------

def _image_over_solid(jt):
    """An image fill with diagonal edges (fractional coverage) over a solid."""
    ident = jt.Affine.identity()
    s = jt.Scene()
    s.fill(jt.Fill.NON_ZERO, ident, jt.SolidBrush(jt.Color.rgba(0.2, 0.4, 0.8, 1)), None,
           _rect(jt, 0, 0, 128, 128))
    tri = jt.BezPath().move_to(20.5, 15.2).line_to(110.7, 40.3).line_to(50.1, 120.6).close()
    s.fill(jt.Fill.NON_ZERO, ident, jt.ImageBrush(_image(jt)), None, tri)
    return s, _params(jt)


def _translucent_transformed(jt):
    xf = jt.Affine.translate(40, 30) @ jt.Affine.rotate(0.35) @ jt.Affine.scale(2.5)
    s = jt.Scene()
    s.fill(jt.Fill.NON_ZERO, jt.Affine.identity(),
           jt.SolidBrush(jt.Color.rgba(0.9, 0.9, 0.2, 1)), None, _rect(jt, 0, 0, 128, 128))
    s.fill(jt.Fill.NON_ZERO, xf, jt.ImageBrush(_image(jt, seed=3, alpha=140)), None,
           _rect(jt, 0, 0, 8, 8))
    return s, _params(jt)


def _many_small_images(jt):
    s = jt.Scene()
    s.fill(jt.Fill.NON_ZERO, jt.Affine.identity(),
           jt.SolidBrush(jt.Color.rgba(0.3, 0.3, 0.3, 1)), None, _rect(jt, 0, 0, 128, 64))
    for k in range(10):
        s.fill(jt.Fill.NON_ZERO, jt.Affine.translate(4 + 12 * k, 8 + (k % 3) * 14),
               jt.ImageBrush(_image(jt, seed=20 + k, alpha=220)), None, _rect(jt, 0, 0, 8, 8))
    return s, _params(jt, 128, 64)


def _scaled_over_solid(jt):
    s = jt.Scene()
    s.fill(jt.Fill.NON_ZERO, jt.Affine.identity(),
           jt.SolidBrush(jt.Color.rgba(0.2, 0.6, 0.4, 1)), None, _rect(jt, 0, 0, 64, 64))
    s.fill(jt.Fill.NON_ZERO, jt.Affine.translate(12, 9) @ jt.Affine.scale(4),
           jt.ImageBrush(_image(jt, seed=5, alpha=210)), None, _rect(jt, 0, 0, 8, 8))
    return s, _params(jt, 64, 64)


def _minified_over_solid(jt):
    s, params = _minified(jt)
    t = jt.Scene()
    t.fill(jt.Fill.NON_ZERO, jt.Affine.identity(),
           jt.SolidBrush(jt.Color.rgba(1, 1, 0.9, 1)), None, _rect(jt, 0, 0, 64, 64))
    t.append(s, jt.Affine.identity())
    return t, params


def _image_between_fills(jt):
    """Solid, image through a triangle, even-odd solid on top: the shape
    of a clip-free production frame with images."""
    ident = jt.Affine.identity()
    s = jt.Scene()
    s.fill(jt.Fill.NON_ZERO, ident, jt.SolidBrush(jt.Color.rgba(0.15, 0.45, 0.75, 1)), None,
           _rect(jt, 0, 0, 128, 128))
    s.fill(jt.Fill.NON_ZERO, jt.Affine.translate(10, 5) @ jt.Affine.scale(14),
           jt.ImageBrush(_image(jt, seed=13, alpha=220)), None,
           jt.BezPath().move_to(0.3, 0.4).line_to(7.6, 2.7).line_to(3.1, 8.2).close())
    tri = jt.BezPath().move_to(14.5, 10.2).line_to(116.7, 42.3).line_to(54.1, 120.6).close()
    s.fill(jt.Fill.EVEN_ODD, ident, jt.SolidBrush(jt.Color.rgba(0.9, 0.3, 0.2, 0.6)), None, tri)
    return s, _params(jt)


FRAMES = {
    "image_over_solid": _image_over_solid,
    "translucent_transformed": _translucent_transformed,
    "many_small_images": _many_small_images,
    "scaled_over_solid": _scaled_over_solid,
    "minified_over_solid": _minified_over_solid,
    "image_between_fills": _image_between_fills,
    # Vertical edges at a fractional x: jello_tpu's grouping of the area
    # formula loses 3.9e-2 here in float32 (pipeline/coverage.py).
    "upscaled_fractional_edges": _upscaled,
}


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_torch_image_frame_matches_oracle(name):
    r = Renderer(device="cpu")
    check_frame(r, FRAMES[name], tol=FRAME_TOL)
    assert r.last_flags["image_region_overflow"] is False
    assert r.last_flags["img_recs_overflow"] is False
    assert 0 < r.last_stats["img_recs"] <= r._caps["img_recs_cap"]


def _dark_image_triangle(jt):
    """tests/test_image_tap.py::test_image_tap_msaa8's scene: a dark image
    scaled 16x through a triangle with diagonal edges, where msaa8 and
    area coverage differ by ~0.15."""
    pix = np.full((8, 8, 4), 255, np.uint8)
    pix[..., :3] = 20
    s = 1.0 / 16.0
    tri = (jt.BezPath().move_to(18.5 * s, 12.2 * s).line_to(112.7 * s, 44.3 * s)
           .line_to(52.1 * s, 118.6 * s).close())
    scene = jt.Scene()
    scene.fill(jt.Fill.NON_ZERO, jt.Affine.scale(16), jt.ImageBrush(jt.Image(pixels=pix)), None,
               tri)
    return scene, _params(jt)


@pytest.mark.parametrize("aa", ["msaa8", "msaa16"])
def test_torch_image_frame_msaa_matches_oracle(aa):
    """Image paints under MSAA: kernel A's resolved rows (plain version)
    modulate the tapped foreground in plain kernel B's resolved branch."""
    r = Renderer(device="cpu")
    img, _ = check_msaa_frame(render_checked(r), with_aa(both(_dark_image_triangle), aa))
    assert r.last_stats["img_recs"] > 0 and r.last_flags["image_region_overflow"] is False
    area, _, _ = check_frame(Renderer(device="cpu"), _dark_image_triangle, tol=FRAME_TOL)
    assert np.abs(img - area).max() > 0.05  # the scene tells the two modes apart


def _config5_300(jt):
    return jt.scenes.config5(n_paths=300)


def test_torch_renderer_reduced_config5_matches_oracle():
    import jello_tpu.scenes  # noqa: F401  (check_frame builds through both packages)
    import jello_tpu_torch.scenes  # noqa: F401

    r = Renderer(device="cpu")
    check_frame(r, _config5_300)
    assert r.last_stats["img_recs"] > 0 and r.last_stats["work_b"] > 0
    assert r.last_stats["arc_lines"] > 0
    assert r._caps["img_recs_cap"] >= r.last_stats["img_recs"]
