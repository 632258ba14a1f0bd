"""Shared inputs and references for the jello_tpu_torch parity tests.

Both packages get the same numpy inputs (resolved scene words, layout
dict, stop table, image atlas, caps); the jello_tpu side runs its stage functions
under numpy, exactly in `pipeline/render.py::render_frame`'s order, and
the port side gets them through `jello_tpu_torch.cuda.upload`.
"""

from __future__ import annotations

import contextlib
import functools
import os

import numpy as np
import torch

import jello_tpu
import jello_tpu_torch
from jello_tpu.cpu.pipeline import build_image_atlas, build_layout_dict
from jello_tpu import pmath as np_pmath
from jello_tpu.pipeline import clips, coarse, drawobjs, flatten, tiling
from jello_tpu.pipeline import fine_ref as np_fine_ref
from jello_tpu.pipeline import ops as np_ops
from jello_tpu.pipeline.gradient import stops_table_or_empty
from jello_tpu.pipeline.render import _draw_tags
from jello_tpu.renderer.estimate import estimate_caps_from_scene
from jello_tpu.renderer.resolve import Resolver


# The suite runs in several worker processes at once; torch's default of
# one intra-op thread per core in each of them oversubscribes the cores.
THREADS = 2
torch.set_num_threads(min(torch.get_num_threads(), THREADS))


def child_env():
    """The environment of a subprocess a test starts: the worker's thread
    budget holds there too."""
    return dict(os.environ, OMP_NUM_THREADS=str(THREADS), MKL_NUM_THREADS=str(THREADS))


def both(build, *args, **kw):
    """One scene built through each package's own scene API, since a
    renderer resolves only its own package's types: ((scene, params) of
    jello_tpu, (scene, params) of jello_tpu_torch). `build(jt, ...)`
    takes the package as `jt`; tests/test_torch_host.py holds the two
    encodings byte-equal."""
    return build(jello_tpu, *args, **kw), build(jello_tpu_torch, *args, **kw)


@functools.lru_cache(maxsize=None)
def config2_both():
    """Config 2 built once through each package (its dashes are flattened
    in Python on the host, tens of seconds a build): ((scene, params) of
    jello_tpu, (scene, params) of jello_tpu_torch)."""
    import jello_tpu.scenes
    import jello_tpu_torch.scenes

    return jello_tpu.scenes.config2(), jello_tpu_torch.scenes.config2()


def check_frame(r, build, tol=2e-3, **kw):
    """Render `build` through the port's renderer `r` and through the
    numpy oracle, hold the port's image to the oracle's within `tol` with
    no flag raised; returns (port image, oracle image, the port's (scene,
    params))."""
    from jello_tpu.cpu import render_numpy

    built = build() if build is config2_both else both(build, **kw)
    (scene_j, params_j), (scene_t, params_t) = built
    img = r.render(scene_t, params_t)
    assert not any(r.last_flags.values()), r.last_flags
    with np.errstate(all="ignore"):
        ref, _, _ = render_numpy(scene_j, params_j)
    assert img.shape == ref.shape and img.dtype == np.float32
    assert np.isfinite(img).all()
    err = np.abs(img - ref).max()
    print(f"{getattr(build, '__name__', build)}: max abs error vs the oracle {err:.3e}")
    assert err <= tol
    return img, ref, (scene_t, params_t)


def with_aa(built, aa):
    """`both(...)`'s pair with the antialiasing method set on both params:
    "area", "msaa8" or "msaa16"."""
    (scene_j, params_j), (scene_t, params_t) = built
    params_j.antialiasing_method = jello_tpu.AaConfig(aa)
    params_t.antialiasing_method = jello_tpu_torch.AaConfig(aa)
    return (scene_j, params_j), (scene_t, params_t)


@contextlib.contextmanager
def oracle_cbrt():
    """While entered, the port's cbrt returns jello_tpu's values (numpy's
    float32 exp/log seed), so that both packages flatten a curve to the
    same lines: with its own cbrt the port's end points move by up to
    ~1e-3 px (tests/test_torch_stages.py), which under MSAA carries a
    sample across an edge now and then."""
    from jello_tpu_torch import pmath as pm

    def cbrt(x):
        with np.errstate(all="ignore"):
            return torch.from_numpy(np.asarray(np_pmath.cbrt(np, x.numpy()), dtype=np.float32))

    own, pm.cbrt = pm.cbrt, cbrt
    try:
        yield
    finally:
        pm.cbrt = own


def render_numpy_f32_segments(scene, params):
    """jello_tpu's numpy oracle twice over one scene: (frame, the frame
    with the tile segments rounded to float32 before the fine stage).
    Under numpy `path_tiling` leaves float64 segments and the oracle's
    coverage runs in float64; the port's coverage kernel, like jello_tpu's
    on its device route, reads float32. Under MSAA a sample that lies
    within an ulp of an edge then falls on the other side, a whole 1/8 or
    1/16 of coverage: the second frame has the port's ties."""
    from jello_tpu.cpu import render_numpy

    fine = np_fine_ref.fine
    frames = []
    for rounded in (False, True):
        def fine_on(xp, scene_, cmds, segs, *rest, **kw):
            if rounded:
                segs = {k: np.asarray(v).astype(np.float32) for k, v in segs.items()}
            return fine(xp, scene_, cmds, segs, *rest, **kw)

        np_fine_ref.fine = fine_on
        try:
            with np.errstate(all="ignore"):
                img, flags, _ = render_numpy(scene, params)
        finally:
            np_fine_ref.fine = fine
        assert not any(bool(v) for v in flags.values()), flags
        frames.append(img)
    return tuple(frames)


def render_checked(r):
    """`render(scene, params) -> image` through the renderer `r`, no flag
    left raised."""
    def render(scene, params):
        img = r.render(scene, params)
        assert not any(r.last_flags.values()), r.last_flags
        return img
    return render


def check_msaa_frame(render, built, tol=8e-3):
    """Render `with_aa(both(...), aa)` through the port (`render(scene,
    params) -> image`, e.g. `render_checked(r)`) and hold it to the numpy
    oracle, twice.

    As shipped, with the port's own cbrt: within `tol` (8e-3, the
    tolerance of jello_tpu's own MSAA tests) of the oracle on
    float32-rounded segments on all but at most 1 pixel in 10,000, and on
    those off by one sample at most: the port's flatten moves a curve's
    end points by up to ~1e-3 px, which carries a sample across an edge
    now and then (found: 0 or 1 pixel a frame, printed).

    Fed the oracle's cbrt, so that both flatten to the same lines: within
    `tol` (~1e-6 expected, printed) of the oracle on float32-rounded
    segments everywhere, and off the float64 oracle by more than 1e-5 only
    where that rounding moves the oracle itself, which shows each such
    pixel to be a float32 sample tie. Returns (that image, the float64
    oracle's image)."""
    (scene_j, params_j), (scene_t, params_t) = built
    shipped = render(scene_t, params_t)
    with oracle_cbrt():
        img = render(scene_t, params_t)
    ref64, ref32 = render_numpy_f32_segments(scene_j, params_j)
    aa = params_t.antialiasing_method.value
    assert shipped.shape == ref64.shape and np.isfinite(shipped).all()
    err_own = np.abs(shipped - ref32).max(-1)
    print(f"{aa}, the port's own flatten: max abs error vs the oracle on float32 segments "
          f"{err_own.max():.3e}, {int((err_own > tol).sum())} of {err_own.size} pixels over "
          f"{tol}")
    assert (err_own > tol).mean() <= 1e-4
    assert err_own.max() <= max(tol, 1.0 / int(aa[4:]) + 1e-6)
    assert img.shape == ref64.shape and np.isfinite(img).all()
    err32 = np.abs(img - ref32).max()
    off = (np.abs(img - ref64) > 1e-5).any(-1)
    tie = (np.abs(ref32 - ref64) > 1e-6).any(-1)
    print(f"{aa}, the oracle's flatten: max abs error vs the oracle on float32 "
          f"segments {err32:.3e}, vs the float64 oracle {np.abs(img - ref64).max():.3e} on "
          f"{int(off.sum())} pixels, {int(tie.sum())} float32 ties")
    assert err32 <= tol
    assert not (off & ~tie).any()
    assert off.mean() <= 2e-3
    return img, ref64


def prepare_with_atlas(scene, params):
    """(scene_u32, ld, ramps, atlas, caps) exactly as the renderers build
    them, from a jello_tpu scene; atlas is the [AH, AW, 4] plane or None."""
    layout, ramps, images, scene_u32 = Resolver().resolve(scene.encoding)
    ld = build_layout_dict(layout, params)
    caps = estimate_caps_from_scene(scene_u32, layout, params.width, params.height)
    # jello_tpu's routing of an area frame (tpu/render.py:341-346), read by
    # its stages and by the port's: the dense coarse branch only without
    # clip layers.
    caps.update(aa_mode="area")
    if layout.n_clips == 0:
        caps["_coarse_dense"] = True
    return scene_u32, ld, stops_table_or_empty(ramps), build_image_atlas(images), caps


def prepare(scene, params):
    """(scene_u32, ld, ramps, caps) of `prepare_with_atlas`."""
    scene_u32, ld, ramps, _, caps = prepare_with_atlas(scene, params)
    return scene_u32, ld, ramps, caps


def numpy_geometry(scene_u32, ld, caps):
    """jello_tpu's stages before fine, under numpy (render_frame order)."""
    xp = np
    with np.errstate(all="ignore"):
        fl = flatten.flatten_stage(xp, scene_u32, ld, caps)
        D = caps["n_draws_cap"]
        tags = _draw_tags(xp, scene_u32, ld, D)
        dm = drawobjs.draw_monoid_scan(xp, tags)
        info, clip_idx, clip_path, tag, dd, di = drawobjs.draw_leaf(
            xp, scene_u32, ld, dm, fl["path_trans_idx"], fl["path_draw_flags"],
            caps, tag=tags)
        clip_bboxes, dm_path, dm_scene = clips.clip_leaf(
            xp, clip_idx, clip_path, fl["path_bbox"], dm["path_idx"].astype(np.int32),
            dm["scene_offset"].astype(np.int32), ld, caps)
        dm = dict(dm, path_idx=dm_path, scene_offset=dm_scene)
        dd = (ld["draw_data_base"] + dm_scene).astype(np.int32)
        sc4 = np_ops.gather_guarded(
            xp, scene_u32, np.concatenate([dd + k for k in range(4)])).reshape(4, D)
        dtab = np.concatenate([sc4.T, info[:, 1:10]], axis=1)
        draw_bbox = coarse.binning_bboxes(xp, dm, fl["path_bbox"], clip_bboxes, ld)
        paths = tiling.tile_alloc(xp, draw_bbox, tag, ld, caps)
        counted = tiling.path_count(xp, fl, paths, caps)
        cmds = coarse.build_commands(xp, scene_u32, ld, dm, tag, dtab, draw_bbox,
                                     paths, counted, fl["path_draw_flags"], caps)
        cmds["dtab"] = dtab
    return {"fl": fl, "dm": dm, "info": info, "paths": paths, "counted": counted,
            "cmds": cmds, "cmds_tag": tag, "draw_bbox": draw_bbox}


def as_np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def u32(a):
    """Bit pattern as uint32 (int32-carried torch words or numpy u32)."""
    return np.asarray(a).astype(np.int64) & 0xFFFFFFFF


def check_flatten_lines(fl, gfl, line_atol, rtol=1e-5):
    """The port's flatten output `gfl` against the oracle's `fl`: the
    counts exact (the port's e_real is the oracle's e_total; the port's
    e_total also counts a dead slot per zero-count work row), the valid
    lines in the oracle's order with their paths equal and their end
    points within `line_atol`, and the per-path tables exact."""
    for k in ("s_total", "a_total", "n_work_a", "n_work_b", "lockstep_iters"):
        assert int(fl[k]) == int(gfl[k]), k
    assert int(gfl["e_real"]) == int(fl["e_total"])
    assert not bool(fl["overflow"]) and not bool(gfl["overflow"])
    v, gv = np.asarray(fl["line_valid"]), as_np(gfl["line_valid"])
    assert int(gv.sum()) == int(v.sum()) == int(fl["n_lines"])
    np.testing.assert_array_equal(as_np(gfl["line_path"])[gv], fl["line_path"][v])
    for k in ("line_x0", "line_y0", "line_x1", "line_y1"):
        np.testing.assert_allclose(as_np(gfl[k])[gv], fl[k][v], rtol=rtol, atol=line_atol,
                                   err_msg=k)
    np.testing.assert_array_equal(fl["path_bbox"], as_np(gfl["path_bbox"]))
    for k in ("path_draw_flags", "path_trans_idx"):
        np.testing.assert_array_equal(u32(fl[k]), u32(as_np(gfl[k])), err_msg=k)


def to_torch(v):
    """numpy -> CPU tensor the way the port carries it: u32 as int32 bit
    patterns, other integers as int32, floats and bools unchanged."""
    a = np.asarray(v)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype.kind in "iu":
        a = a.astype(np.int32)
    return torch.from_numpy(np.ascontiguousarray(a))


def tree_to_torch(d):
    return {k: tree_to_torch(v) if isinstance(v, dict) else to_torch(v)
            for k, v in d.items()}


def _rect(jt, x0, y0, x1, y1):
    return jt.BezPath().move_to(x0, y0).line_to(x1, y0).line_to(x1, y1).line_to(x0, y1).close()


def _clip_scene(body, size=256, base=(0, 0, 0, 0)):
    """`build(jt) -> (scene, params)` from `body(jt, scene)`."""
    def build(jt):
        scene = jt.Scene()
        body(jt, scene)
        return scene, jt.RenderParams(width=size, height=size,
                                      base_color=jt.Color.rgba(*base))
    return build


def _layer(blend, alpha, clip, fills):
    """body: one layer `blend(jt)` with alpha over the clip rect, holding
    solid fills [(rgba, rect)]."""
    def body(jt, scene):
        ident = jt.Affine.identity()
        scene.push_layer(blend(jt), alpha, ident, _rect(jt, *clip))
        for rgba, rect in fills:
            scene.fill(jt.Fill.NON_ZERO, ident, jt.SolidBrush(jt.Color.rgba(*rgba)), None,
                       _rect(jt, *rect))
        scene.pop_layer()
    return body


def _pure_clip(jt):
    return jt.BlendMode(jt.Mix.CLIP, jt.Compose.SRC_OVER)


def _nested_clips(jt, scene):
    ident = jt.Affine.identity()
    scene.push_layer(_pure_clip(jt), 1.0, ident, _rect(jt, 32, 32, 224, 224))
    scene.push_layer(_pure_clip(jt), 1.0, ident, _rect(jt, 96, 96, 256, 256))
    scene.fill(jt.Fill.NON_ZERO, ident, jt.SolidBrush(jt.Color.rgba(1, 0, 0, 1)), None,
               _rect(jt, 0, 0, 256, 256))
    scene.pop_layer()
    scene.pop_layer()


def _blend_multiply(jt, scene):
    ident = jt.Affine.identity()
    full = _rect(jt, 0, 0, 256, 256)
    scene.fill(jt.Fill.NON_ZERO, ident, jt.SolidBrush(jt.Color.rgba(0.5, 0.8, 1, 1)), None, full)
    scene.push_layer(jt.BlendMode(jt.Mix.MULTIPLY, jt.Compose.SRC_OVER), 1.0, ident, full)
    scene.fill(jt.Fill.NON_ZERO, ident, jt.SolidBrush(jt.Color.rgba(0.5, 0.5, 0.5, 1)), None,
               full)
    scene.pop_layer()


def _empty_clip_path(jt, scene):
    ident = jt.Affine.identity()
    scene.push_layer(_pure_clip(jt), 1.0, ident, jt.BezPath())
    scene.fill(jt.Fill.NON_ZERO, ident, jt.SolidBrush(jt.Color.rgba(1, 0, 0, 1)), None,
               _rect(jt, 0, 0, 256, 256))
    scene.pop_layer()


def _unbalanced_push(jt, scene):
    ident = jt.Affine.identity()
    scene.push_layer(_pure_clip(jt), 1.0, ident, _rect(jt, 64, 64, 192, 192))
    scene.fill(jt.Fill.NON_ZERO, ident, jt.SolidBrush(jt.Color.rgba(1, 0, 0, 1)), None,
               _rect(jt, 0, 0, 256, 256))  # no pop: the resolver appends the EndClip


def _mix_stack(jt, scene):
    """Three nested layers with mix and compose blends over a gradient,
    at fractional clip edges: blend depth 3, every tile under them legacy."""
    ident = jt.Affine.identity()
    stops = (jt.ColorStop(0.0, jt.Color.rgba(0.9, 0.2, 0.1, 1)),
             jt.ColorStop(1.0, jt.Color.rgba(0.1, 0.3, 0.9, 0.6)))
    scene.fill(jt.Fill.NON_ZERO, ident,
               jt.GradientBrush(jt.LinearGradient((0, 0), (128, 128), stops)), None,
               _rect(jt, 0, 0, 128, 128))
    layers = ((jt.Mix.SOFT_LIGHT, jt.Compose.SRC_OVER, 0.9, (8.4, 8.6, 120.3, 118.7)),
              (jt.Mix.HUE, jt.Compose.SRC_ATOP, 0.7, (20.5, 24.2, 100.1, 110.6)),
              (jt.Mix.COLOR_DODGE, jt.Compose.XOR, 1.0, (30.3, 40.7, 90.9, 95.2)))
    for k, (mix, compose, alpha, clip) in enumerate(layers):
        scene.push_layer(jt.BlendMode(mix, compose), alpha, ident, _rect(jt, *clip))
        scene.fill(jt.Fill.NON_ZERO, ident,
                   jt.SolidBrush(jt.Color.rgba(0.2 + 0.3 * k, 0.8 - 0.2 * k, 0.4, 0.8)), None,
                   _rect(jt, 12 + 9 * k, 16 + 7 * k, 116 - 5 * k, 112 - 9 * k))
    for _ in layers:
        scene.pop_layer()


RED, GREEN, FULL256 = (1, 0, 0, 1), (0, 1, 0, 1), (0, 0, 256, 256)
_normal = lambda jt: jt.BlendMode()  # noqa: E731

# The scenes of tests/test_clip.py, and one deeper stack of mix blends.
CLIP_SCENES = {
    "basic_clip": _clip_scene(_layer(_pure_clip, 1.0, (64, 64, 192, 192), [(RED, FULL256)])),
    "partial_coverage_edge": _clip_scene(
        _layer(_pure_clip, 1.0, (64.5, 64, 192, 192), [(RED, FULL256)])),
    "nested_clips": _clip_scene(_nested_clips),
    "layer_alpha": _clip_scene(_layer(_normal, 0.5, FULL256, [(RED, FULL256)]),
                               base=(0, 0, 0, 1)),
    "blend_multiply": _clip_scene(_blend_multiply),
    "clip_zero_tiles": _clip_scene(_layer(_pure_clip, 1.0, (16, 16, 32, 32),
                                          [(GREEN, FULL256)])),
    "empty_clip_path": _clip_scene(_empty_clip_path),
    "unbalanced_push": _clip_scene(_unbalanced_push),
    "normal_group": _clip_scene(_layer(_normal, 1.0, (40, 40, 200, 200), [(RED, FULL256)]),
                                base=(0, 0, 1, 1)),
    "mix_stack": _clip_scene(_mix_stack, size=128, base=(1, 1, 1, 1)),
}


def full_scene(jt):
    """tests/test_full_scene.py::full_scene through either package: three
    gradient kinds, an image, a MULTIPLY group with a clip nested in it,
    a dashed stroke; 256x256 on white."""
    from jello_tpu.curve import circle as circle_j
    from jello_tpu_torch.curve import circle as circle_t

    circle = circle_j if jt is jello_tpu else circle_t
    ident = jt.Affine.identity()
    stops = (jt.ColorStop(0.0, jt.Color.rgba(1, 1, 0, 1)),
             jt.ColorStop(0.5, jt.Color.rgba(1, 0, 1, 1)),
             jt.ColorStop(1.0, jt.Color.rgba(0, 0, 1, 1)))
    full = _rect(jt, 0, 0, 256, 256)
    s = jt.Scene()
    s.fill(jt.Fill.NON_ZERO, ident,
           jt.GradientBrush(jt.LinearGradient((0, 0), (256, 0), stops)), None, full)
    s.fill(jt.Fill.EVEN_ODD, ident, jt.GradientBrush(jt.RadialGradient(
        (100, 100), 5.0, (120, 110), 80.0, stops, jt.Extend.REFLECT)), None,
        circle(110, 105, 70))
    s.fill(jt.Fill.NON_ZERO, ident,
           jt.GradientBrush(jt.SweepGradient((180, 180), 0.0, 6.283185, stops)), None,
           circle(180, 180, 50))
    pix = np.zeros((4, 4, 4), np.uint8)
    pix[:2, :2], pix[2:, 2:] = [255, 0, 0, 255], [0, 255, 0, 255]
    pix[:2, 2:], pix[2:, :2] = [0, 0, 255, 255], [255, 255, 0, 128]
    s.fill(jt.Fill.NON_ZERO, jt.Affine.translate(10, 180) @ jt.Affine.scale(12),
           jt.ImageBrush(jt.Image(pixels=pix)), None, _rect(jt, 0, 0, 4, 4))
    s.push_layer(jt.BlendMode(jt.Mix.MULTIPLY, jt.Compose.SRC_OVER), 0.8, ident,
                 circle(128, 128, 100))
    s.fill(jt.Fill.NON_ZERO, ident, jt.SolidBrush(jt.Color.rgba(0.2, 0.9, 0.4, 0.7)), None,
           circle(120, 120, 60))
    s.push_layer(_pure_clip(jt), 1.0, ident, circle(140, 140, 40))
    s.fill(jt.Fill.NON_ZERO, ident, jt.SolidBrush(jt.Color.rgba(0.9, 0.1, 0.1, 1)), None, full)
    s.pop_layer()
    s.pop_layer()
    s.stroke(jt.Stroke(width=5, dash_pattern=(12, 6)).with_caps(jt.Cap.ROUND), ident,
             jt.SolidBrush(jt.Color.rgba(0, 0, 0, 1)), None,
             jt.BezPath().move_to(10, 30).cubic_to(80, 5, 170, 60, 246, 25))
    return s, jt.RenderParams(width=256, height=256, base_color=jt.Color.rgba(1, 1, 1, 1))


def _noise_image(jt, seed, size):
    rng = np.random.default_rng(seed)
    pix = (rng.random((size, size, 4)) * 255).astype(np.uint8)
    pix[..., 3] = 255
    return jt.Image(pixels=pix)


def over_minified(jt):
    """A 512x512 source at 1/32 scale: the first tile spans 8 x 2 region
    windows of the image tap, past its MAX_WIN, so the frame raises
    `image_region_overflow`."""
    s = jt.Scene()
    s.fill(jt.Fill.NON_ZERO, jt.Affine.translate(1, 1) @ jt.Affine.scale(1.0 / 32.0),
           jt.ImageBrush(_noise_image(jt, 2, 512)), None, _rect(jt, 0, 0, 512, 512))
    return s, jt.RenderParams(width=32, height=32, base_color=jt.Color.rgba(1, 1, 1, 1))


def over_minified_in_a_group(jt):
    """An image minified 20x inside a SCREEN group: its tiles are legacy,
    and the interpreter's one region window cannot hold a tile's taps."""
    ident = jt.Affine.identity()
    s = jt.Scene()
    s.push_layer(jt.BlendMode(jt.Mix.SCREEN, jt.Compose.SRC_OVER), 1.0, ident,
                 _rect(jt, 0, 0, 32, 32))
    s.fill(jt.Fill.NON_ZERO, jt.Affine.scale(1.0 / 20.0),
           jt.ImageBrush(_noise_image(jt, 3, 400)), None, _rect(jt, 0, 0, 400, 400))
    s.pop_layer()
    return s, jt.RenderParams(width=32, height=32, base_color=jt.Color.rgba(0.2, 0.3, 0.5, 1))


# ---- hand-built interpreter slabs (kernels G and H) --------------------------

def _fbits(x):
    return int(np.float32(x).view(np.uint32))


def hand_built_slab(seed=0, n=16, MC=16, BD=2, grid=64, wit=8, deep=False):
    """Inputs of the per-tile interpreter, built by hand with numpy: `n`
    programs (the last two pads) whose tapes hold every record kind, clip
    depth up to BD and one past it, a clip-zero group with a nested group
    inside, an image record that fits the region window and one that trips
    it, and seeded random tapes over every mix and compose word.

    With `deep`, the last five programs before the pads hold DEEP_TAPES:
    a push at every depth up to BD ("to_bd"), the same one level deeper
    ("past_bd"), a tape of one record, a tape of exactly MC records with
    rowless fills, and a clip-zero group whose suppression runs past the
    kernel's 32-record staging chunk; MC must hold 3 BD + 4 records and
    should exceed 32.

    Returns a dict: counts [n] i32, tile_ids [n] i32, base [4] f32, slab
    [n, MC, 16] u32, rows [32, 256] f32, stops [NR, W] f32, atlas [4, AHp,
    AWp] f32 (premultiplied planar, padded), wit, grid, BD."""
    from jello_tpu_torch.pipeline.image_tap import atlas_planar

    rng = np.random.default_rng(seed)
    S, NR, R = 3, 4, 32
    stops = np.zeros((NR, 1 + 5 * S), np.float32)
    stops[:, 0] = S
    stops[:, 1:1 + S] = [0.0, 0.45, 1.0]
    stops[:, 1 + S:] = rng.random((NR, 4 * S))
    rows = (rng.random((R, 256)) * 5 - 2.5).astype(np.float32)
    rows[::3] = np.clip(rows[::3], 0, 1)
    atlas = atlas_planar(rng.random((32, 40, 4)).astype(np.float32))
    tile_ids = np.concatenate([rng.permutation(grid)[:n - 2], [grid, grid]]).astype(np.int32)

    def row():
        return int(rng.integers(0, R))

    def xform(tile, scale, rot, ox, oy):
        """Words 6..11 mapping the tile's first pixel to (ox, oy)."""
        c, s_ = np.cos(rot) * scale, np.sin(rot) * scale
        m = np.array([c, s_, -s_, c], np.float32)
        gx0, gy0 = (tile % wit) * 16, (tile // wit) * 16
        xl = ox - (m[0] * gx0 + m[2] * gy0)
        yl = oy - (m[1] * gx0 + m[3] * gy0)
        return [_fbits(v) for v in (*m, xl, yl)]

    def color(even_odd=False, rowless=False):
        w = [1, 0 if rowless else row(), 0 if rowless else 3, 0, int(even_odd)]
        rgba = rng.random(4)
        return w + [_fbits(c * rgba[3]) for c in rgba[:3]] + [_fbits(rgba[3])] + [0] * 7

    def lin(tile, ext):
        gx0, gy0 = (tile % wit) * 16, (tile // wit) * 16
        lx, ly = 0.05, 0.03
        return [2, row(), 2, 0, 0, ext, _fbits(lx), _fbits(ly),
                _fbits(-(lx * gx0 + ly * gy0) - 0.2), 0, 0, 0, 0, 0, 0, int(rng.integers(0, NR))]

    def rad(tile, ext, kind, swapped, focal_x, radius, ox=-0.6):
        return ([3, row(), 4, 0, 0, ext] + xform(tile, 0.09, 0.3, ox, -0.7)
                + [_fbits(focal_x), _fbits(radius), (int(swapped) << 3) | kind,
                   int(rng.integers(0, NR))])

    def sweep(tile, ext):
        return ([4, row(), 1, 0, 1, ext] + xform(tile, 0.2, 0.0, -1.7, -1.4)
                + [_fbits(0.1), _fbits(0.8), 0, int(rng.integers(0, NR))])

    def image(tile, trips=False):
        if trips:  # minified 64x: the taps leave the one region window
            return ([5, row(), 2, 0, 0, 0] + xform(tile, 64.0, 0.0, 0.0, 0.0)
                    + [(5 << 16) | 3, (2048 << 16) | 2048, 0, 0])
        return ([5, row(), 2, 0, 0, 0] + xform(tile, 1.3, 0.2, 1.5, 0.5)
                + [(5 << 16) | 3, (24 << 16) | 20, 0, 0])

    def begin(zero=False):
        return [6, 0, 0xFFFFFFFF if zero else 2, 0, 0] + [0] * 11

    def end(mix=0, compose=0, alpha=1.0, rowless=False):
        return ([7, 0 if rowless else row(), 0 if rowless else 2, 0, 0, (mix << 8) | compose,
                 _fbits(alpha), 1] + [0] * 8)

    def paint(tile):
        k = int(rng.integers(0, 5))
        return [color(bool(rng.integers(0, 2)), k == 0), lin(tile, int(rng.integers(0, 3))),
                rad(tile, int(rng.integers(0, 3)), 1, False, 0.0, 1.0),
                sweep(tile, int(rng.integers(0, 3))), image(tile)][k]

    def random_tape(tile):
        tape, open_words = [], []
        while len(tape) + len(open_words) < MC - 1:
            u = rng.random()
            if u < 0.25 and len(open_words) < BD:
                tape.append(begin())
                open_words.append((int(rng.integers(0, 16)), int(rng.integers(0, 14))))
            elif u < 0.45 and open_words:
                tape.append(end(*open_words.pop(), alpha=float(rng.random()),
                                rowless=bool(rng.integers(0, 2))))
            else:
                tape.append(paint(tile))
        while open_words:
            tape.append(end(*open_words.pop(), alpha=0.8))
        return tape

    t = [int(v) for v in tile_ids]
    tapes = [
        [color(), color(even_odd=True), color(rowless=True)],
        [lin(t[1], 0), rad(t[1], 1, 1, False, 0.0, 1.0), sweep(t[1], 2)],
        [rad(t[2], 0, 2, False, 0.0, 0.8), rad(t[2], 2, 3, False, 0.4, 1.0, ox=0.9),  # focal form divides by x: keep x > 0
        
         rad(t[2], 1, 4, True, 0.3, 0.7), rad(t[2], 0, 4, False, 0.3, 1.6)],
        [image(t[3]), color()],
        [color(), image(t[4], trips=True), color(even_odd=True)],
        [color(), begin(), color(), end(alpha=0.7)],
        [color(), begin(), color(), end(mix=1, alpha=1.0, rowless=True)],
        [color(), begin(), color(), begin(), lin(t[7], 1), end(mix=2, compose=9, alpha=0.9),
         end(mix=12, alpha=0.6)],
        [color(), begin(), color(), begin(), color(), begin(), color(), end(mix=3),
         end(mix=10, compose=4), end(alpha=0.5)],
        [color(), begin(zero=True), color(), begin(), color(), end(mix=5), end(), color()],
    ]
    extra = []
    if deep:
        def nest(d):
            tape = [color()]
            for _ in range(d):
                tape += [begin(), color(rowless=bool(rng.integers(0, 2)))]
            return tape + [end(int(rng.integers(0, 16)), int(rng.integers(0, 14)),
                               alpha=float(rng.random())) for _ in range(d)]

        extra = [nest(BD), nest(BD + 1), [color()],
                 [color(rowless=k % 3 == 0) for k in range(MC - 3)]
                 + [begin(), color(), end(mix=3, alpha=0.9)],
                 [color(), begin(zero=True)] + [color() for _ in range(34)]
                 + [end(), color(even_odd=True)]]
    tapes += [random_tape(t[k]) for k in range(len(tapes), n - 2 - len(extra))]
    tapes += extra + [[], []]
    slab = np.zeros((n, MC, 16), np.uint32)
    for k, tape in enumerate(tapes):
        assert len(tape) <= MC
        for ci, w in enumerate(tape):
            slab[k, ci] = np.array(w, np.uint64).astype(np.uint32)
            slab[k, ci, 3] = t[k]
    return {
        "counts": np.array([len(tp) for tp in tapes], np.int32), "tile_ids": tile_ids,
        "base": np.array([0.9, 0.8, 0.7, 1.0], np.float32), "slab": slab, "rows": rows,
        "stops": stops, "atlas": atlas, "wit": wit, "grid": grid, "BD": BD,
    }


def random_tap_records(seed, n=200, wit=8, grid=64, atlas_hw=(320, 1100)):
    """Image records drawn to probe a tap's extent, with a planar atlas:
    (rec [n, 16] u32, atlas [4, AHp, AWp] f32). In turn: rotations,
    shears, negative scales, magnification, minification (some past
    MAX_WIN region windows), and translations a few ulps either side of a
    texel boundary at the tile's first pixel; images placed inside the
    atlas or at one of its edges or corners."""
    from jello_tpu_torch.pipeline.image_tap import atlas_planar

    rng = np.random.default_rng(seed)
    AH, AW = atlas_hw
    atlas = atlas_planar(rng.random((AH, AW, 4)).astype(np.float32))
    f32 = np.float32
    rec = np.zeros((n, 16), np.uint32)
    for i in range(n):
        t = int(rng.integers(0, grid))
        gx0, gy0 = f32((t % wit) * 16), f32((t // wit) * 16)
        form = i % 6
        if form == 4:  # minified: up to the whole atlas at 4x to 80x
            iw, ih = int(rng.integers(AW // 2, AW + 1)), int(rng.integers(AH // 2, AH + 1))
        else:
            iw, ih = int(rng.integers(1, 200)), int(rng.integers(1, 120))
        place = int(rng.integers(0, 4))  # inside, far edge, near edge, far corner
        ax = [int(rng.integers(0, AW - iw + 1)), AW - iw, 0, AW - iw][place]
        ay = [int(rng.integers(0, AH - ih + 1)), int(rng.integers(0, AH - ih + 1)), AH - ih,
              AH - ih][place]
        s = f32(rng.choice([-1.0, 1.0]) * rng.uniform(0.2, 3.0))
        if form == 0:  # rotation
            a = rng.uniform(0, 2 * np.pi)
            m = [s * np.cos(a), s * np.sin(a), -s * np.sin(a), s * np.cos(a)]
        elif form == 1:  # shear
            m = [s, rng.uniform(-1, 1), rng.uniform(-1.5, 1.5), f32(rng.uniform(0.3, 2.0))]
        elif form == 2:  # negative scales
            m = [-abs(s), 0.0, 0.0, -f32(rng.uniform(0.2, 3.0))]
        elif form == 3:  # magnification
            m = [rng.uniform(0.02, 0.3), 0.0, 0.0, rng.uniform(0.02, 0.3)]
        elif form == 4:  # minification
            k = rng.uniform(4.0, 80.0)
            m = [k, rng.uniform(-1, 1), rng.uniform(-1, 1), k * rng.uniform(0.5, 1.0)]
        else:  # a plain scale, translated to a texel boundary below
            m = [s, 0.0, 0.0, f32(rng.uniform(0.2, 3.0))]
        m = [f32(v) for v in m]
        # The tile's first pixel lands near (cx, cy) of the image (for half
        # the minified records near its first texel, so that the tile
        # spans much of it).
        near = form == 4 and i % 12 == 4
        cx = f32(rng.uniform(-4.0, 0.1 * iw if near else iw + 4.0))
        cy = f32(rng.uniform(-4.0, 0.1 * ih if near else ih + 4.0))
        ux0 = f32(m[0] * gx0) + f32(m[2] * gy0)
        uy0 = f32(m[1] * gx0) + f32(m[3] * gy0)
        if form == 5:
            cx, cy = f32(round(float(cx))), f32(round(float(cy)))
        xl, yl = f32(cx - ux0), f32(cy - uy0)
        if form == 5:  # a few ulps either side of the boundary
            for _ in range(int(rng.integers(1, 4))):
                xl = np.nextafter(xl, f32(np.inf if rng.random() < 0.5 else -np.inf))
                yl = np.nextafter(yl, f32(np.inf if rng.random() < 0.5 else -np.inf))
        words = [5, 0, 2, t, 0, 0] + [_fbits(v) for v in (*m, xl, yl)] + [
            (ay << 16) | ax, (iw << 16) | ih, i, 0]
        rec[i] = np.array(words, np.uint64).astype(np.uint32)
    return rec, atlas


# The programs `hand_built_slab(deep=True)` puts before its two pads.
def solid_image_slab(seed, n=64, MC=24, grid=256, wit=16):
    """Inputs of the per-tile interpreter whose tapes hold solid and image
    records only, no clip pair: the legacy tiles of a clip-free frame with
    image paints under JELLO_IMAGE_TAP=0. Tapes of 1 to MC records; images
    from sub-rectangles of one atlas (up to 120 rows), magnified and
    minified (0.2 to 8 texels a pixel, any rotation; the tallest taps leave
    the 64-row region window, as both versions flag), rowless or on rows
    of raw winding; even-odd and rowless fills. Returns the dict of `hand_built_slab`."""
    from jello_tpu_torch.pipeline.image_tap import atlas_planar

    rng = np.random.default_rng(seed)
    R, AH, AW = 48, 160, 96
    stops = np.zeros((1, 16), np.float32)
    stops[:, 0] = 3
    stops[:, 1:4] = [0.0, 0.5, 1.0]
    rows = (rng.random((R, 256)) * 5 - 2.5).astype(np.float32)
    rows[::2] = np.clip(rows[::2], 0, 1)
    atlas = atlas_planar(rng.random((AH, AW, 4)).astype(np.float32))
    tile_ids = np.concatenate([rng.permutation(grid)[:n - 2], [grid, grid]]).astype(np.int32)

    def cover(rowless):
        return [-1, 0] if rowless else [int(rng.integers(0, R)), 3]

    def color(tile):
        rgba = rng.random(4)
        return ([1] + cover(rng.random() < 0.2) + [0, int(rng.random() < 0.3)]
                + [_fbits(c * rgba[3]) for c in rgba[:3]] + [_fbits(rgba[3])] + [0] * 7)

    def image(tile):
        scale, rot = float(np.exp(rng.uniform(np.log(0.2), np.log(8.0)))), rng.uniform(-3.2, 3.2)
        w, h = int(rng.integers(4, 41)), int(rng.integers(4, 121))
        ax, ay = int(rng.integers(0, AW - w + 1)), int(rng.integers(0, AH - h + 1))
        c, s_ = np.cos(rot) * scale, np.sin(rot) * scale
        m = np.array([c, s_, -s_, c], np.float32)
        gx0, gy0 = (tile % wit) * 16, (tile // wit) * 16
        ox, oy = rng.uniform(-4, w), rng.uniform(-4, h)
        xl = ox - (m[0] * gx0 + m[2] * gy0)
        yl = oy - (m[1] * gx0 + m[3] * gy0)
        return ([5] + cover(rng.random() < 0.3) + [0, 0, 0] + [_fbits(v) for v in (*m, xl, yl)]
                + [(ay << 16) | ax, (w << 16) | h, 0, 0])

    tapes = [[image(int(t)) if rng.random() < 0.5 else color(int(t))
              for _ in range(int(rng.integers(1, MC + 1)))] for t in tile_ids[:n - 2]]
    tapes += [[], []]
    slab = np.zeros((n, MC, 16), np.uint32)
    for k, tape in enumerate(tapes):
        for ci, w in enumerate(tape):
            slab[k, ci] = np.array(w, np.int64).astype(np.uint32)
            slab[k, ci, 3] = tile_ids[k]
    return {
        "counts": np.array([len(tp) for tp in tapes], np.int32), "tile_ids": tile_ids,
        "base": np.array([0.9, 0.8, 0.7, 1.0], np.float32), "slab": slab, "rows": rows,
        "stops": stops, "atlas": atlas, "wit": wit, "grid": grid, "BD": 2,
    }


DEEP_TAPES = ("to_bd", "past_bd", "one_record", "mc_records", "suppressed_past_chunk")


def deep_slab(BD):
    """`hand_built_slab(deep=True)` at blend depth BD: 24 programs, MC 40
    (192 at BD 60), so that long tapes cross the kernel's 32-record
    staging chunk. Returns (h, {DEEP_TAPES name: program})."""
    n = 24
    h = hand_built_slab(seed=5, n=n, MC=40 if BD < 12 else 192, BD=BD, deep=True)
    first = n - 2 - len(DEEP_TAPES)
    return h, {name: first + i for i, name in enumerate(DEEP_TAPES)}


def interpret_args(h, device="cpu"):
    """The arguments of `cuda.fine_interp.interpret_tiles` from a
    `hand_built_slab` dict, on `device` (the width in tiles as the last
    word of the counts)."""
    dev = torch.device(device)
    counts = np.concatenate([h["counts"], [h["wit"]]]).astype(np.int32)
    return (to_torch(counts).to(dev), to_torch(h["tile_ids"]).to(dev),
            to_torch(h["base"]).to(dev), to_torch(h["slab"]).to(dev),
            to_torch(h["rows"]).to(dev), to_torch(h["stops"]).to(dev),
            to_torch(h["atlas"]).to(dev), h["BD"])


# Edge shapes of an expansion by counts (the cases the expand kernel's
# window must get right): one owner with more slots than a CTA holds, so
# that a CTA's first slot has within > 0; runs of zero counts (dead slots
# under the clamp; under assume_compact a trailing run, and with
# `interior`, runs between nonzero counts longer than a CTA's window);
# a total past out_cap; a single record; an out_cap that is no multiple
# of a CTA's slots.
EXPAND_CASES = ("long-owner", "zero-runs", "over-cap", "one-record", "ragged-cap")


def expand_counts(case, compact, interior=False, seed=0):
    """(counts [R] int32, out_cap) of one edge case."""
    rng = np.random.default_rng(seed)
    lo = 1 if compact else 0
    if case == "one-record":
        return np.array([7], np.int32), 100
    R = 900 if case == "zero-runs" else 300
    counts = rng.integers(lo, 6, R).astype(np.int32)
    if case == "long-owner":
        counts[40] = 1000
    if case == "zero-runs":
        if not compact or interior:
            counts[100:400] = 0
            counts[500:520] = 0
        counts[800:] = 0
    total = int((counts if compact else np.maximum(counts, 1)).sum())
    out_cap = {"over-cap": total * 2 // 3, "ragged-cap": total + 77}.get(
        case, -(-total // 512) * 512)
    return counts, out_cap


def euler_inputs(counts, IT=24, seed=0):
    """A work table [NW, 21] f32 and lockstep records [3, IT, NW] f32 whose
    line counts are `counts`: random cubics (some with stroke offsets,
    some negative, which swap a line's ends), each item's lines split
    evenly into records of at most 100 at random iterations (zeros between
    them, as where the walk subdivided), record ends rising to 1.0."""
    rng = np.random.default_rng(seed)
    NW = counts.shape[0]
    table = np.zeros((NW, 21), np.float32)
    table[:, :8] = rng.uniform(0, 200, (NW, 8))
    table[:, 8] = rng.choice([0.0, 0.0, 1.5, -1.5], NW)
    table[:, 9] = rng.choice([1.0, 2.0], NW)
    table[:, 10:12] = table[:, 0:2]
    table[:, 12:14] = table[:, 6:8]
    table[:, 14:20] = [1.0, 0.0, 0.0, 1.0, 0.0, 0.0] + rng.uniform(-0.2, 0.2, (NW, 6))
    table[:, 20] = rng.integers(0, 50, NW)
    rec = np.zeros((3, IT, NW), np.float32)
    for i, c in enumerate(counts):
        if c == 0:
            continue
        m = min(max(-(-int(c) // 100), int(rng.integers(1, 5))), int(c), IT)
        n = int(c) // m + (np.arange(m) < int(c) % m)
        its = np.sort(rng.choice(IT, m, replace=False))
        ts = np.concatenate([[0.0], np.sort(rng.uniform(0, 1, m - 1)), [1.0]]).astype(np.float32)
        rec[0, its, i] = ts[:-1]
        rec[1, its, i] = ts[1:]
        rec[2, its, i] = n
    return table, rec


def crossing_inputs(counts, seed=0):
    """A compacted line table [L, 21] f64 in tiling.py's columns for the
    crossing body: integer tile geometry, random slopes and end points,
    the line's crossing count in column 19."""
    rng = np.random.default_rng(seed)
    L = counts.shape[0]
    P = np.zeros((L, 21), np.float64)
    P[:, 1] = rng.uniform(-1.0, 1.0, L)
    P[:, 2] = rng.uniform(0.0, 5.0, L)
    P[:, 3] = rng.choice([-1.0, 1.0], L)
    P[:, 4] = rng.integers(0, 20, L)
    P[:, 5] = rng.integers(0, 20, L)
    P[:, 8] = 64
    P[:, 9] = 64
    P[:, 10] = rng.integers(0, 1000, L)
    P[:, 11] = np.where(rng.random(L) < 0.5, P[:, 4], P[:, 4] + 1)
    P[:, 12] = rng.choice([-1.0, 1.0], L)
    P[:, 14:18] = rng.uniform(0.0, 300.0, (L, 4))
    P[:, 18] = rng.integers(0, 2, L)
    P[:, 19] = counts
    P[:, 20] = rng.integers(0, 2, L)
    return P


def row_inputs(counts, seed=0):
    """A compacted backdrop-row table [L, 5] f64 (tiling.ROW_COLS: ymin,
    tiles_base, bb1, stride, delta)."""
    rng = np.random.default_rng(seed)
    L = counts.shape[0]
    return np.stack([rng.integers(0, 60, L), rng.integers(0, 1000, L), rng.integers(0, 10, L),
                     rng.integers(1, 64, L), rng.choice([-1, 1], L)], axis=1).astype(np.float64)
