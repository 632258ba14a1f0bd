"""The port's capacity protocol end to end, on the CPU: twins of the
reference's tests of it.

  - tests/test_full_scene.py::test_overflow_retry_recovers: every capacity
    starved, the renderer grows its class on the raised flags and the
    frame comes back as a sized one renders it;
  - tests/test_full_scene.py::test_cmd_cap_live_prefix_slice: a cmd_cap
    just above the live commands slices the sorted stream
    (`pipeline/coarse.py`) without moving a pixel, and one below raises
    pairs_overflow;
  - tests/test_animation.py:55-101: a scene that grows ~40% over a sweep of
    frames leaks no flag to the caller, settles few classes and never
    returns to an earlier one, and compiles few programs. A dozen frames
    here; the reference's 100 are slow-marked, as there.

The port's Renderer builds one program (a captured CUDA graph on the card,
`cuda/program.py`) a settled class, as jello_tpu compiles one executable a
class whatever the scene's layout, so the sweep counts programs as the
reference counts executables (`len(r._compiled) <= 4`), and classes (the
renderer's integer capacities after a frame) beside them.
"""

import numpy as np
import pytest

import jello_tpu
import jello_tpu_torch
from jello_tpu.cpu import render_numpy
from jello_tpu_torch.cuda.render import Renderer, assemble, fetch_flags
from jello_tpu_torch.renderer.estimate import estimate_caps

from .torch_reference import both, full_scene

SCENE_TOL = 1e-4  # tests/test_full_scene.py:84,131
ORACLE_TOL = 2e-3  # tests/test_animation.py:101


@pytest.fixture(scope="module")
def full():
    """full_scene through the port and its frame at the renderer's own
    (estimated, then calibrated) class."""
    (_, _), (scene, params) = both(full_scene)
    r = Renderer(device="cpu")
    img = r.render(scene, params)
    assert not any(r.last_flags.values()), r.last_flags
    return scene, params, img, r


def test_torch_overflow_retry_recovers(full):
    """Every capacity starved (the reference's tiny class, blend depth 1):
    the flags the frames raise grow the class, and within 12 retries the
    frame equals the sized one (SCENE_TOL)."""
    scene, params, sized, _ = full
    r = Renderer(device="cpu")
    r._prepare(scene, params)  # the shape's estimate, replaced below
    tiny = estimate_caps(
        type("L", (), {"n_path_tags": 1, "n_paths": 1, "n_draw_objects": 1, "n_clips": 1})(),
        16, 16)
    tiny.update(
        euler_line_cap=1 << 9, simple_line_cap=1 << 8, arc_line_cap=1 << 8,
        line_cap=1 << 10, seg_cap=1 << 10, row_cap=1 << 9, tiles_cap=1 << 8,
        pair_cap=1 << 8, area_rows_cap=1 << 8, tile_grid_cap=256,
        n_paths_cap=64, n_draws_cap=64, info_cap=1 << 9, n_tag_slots=1024,
        blend_depth=1, aa_mode="area",
    )
    r._caps = tiny
    img = r.render(scene, params, max_retries=12)
    grown = [flags for flags in r.last_retries if flags != ["calibrated"]]
    print(f"retries: {r.last_retries}")
    assert not any(r.last_flags.values()), r.last_flags
    assert len(grown) >= 2 and "flatten_overflow" in grown[0]
    assert np.abs(img - sized).max() < SCENE_TOL


def test_torch_cmd_cap_live_prefix_slice(full):
    """cmd_cap = the live commands + 3 slices the sorted command stream to
    its live prefix and leaves the pixels as they are; cmd_cap = half of
    them raises pairs_overflow."""
    scene, params, sized, r = full
    prepared = r._prepare(scene, params)
    caps = dict(r._caps)
    _, packed = r._enqueue(prepared, params, caps)
    nc = fetch_flags(*packed)[1]["cmds"]
    assert 0 < nc + 3 < caps["pair_cap"]
    out, packed = r._enqueue(prepared, params, dict(caps, cmd_cap=nc + 3))
    flags, _ = fetch_flags(*packed)
    assert not any(flags.values()), flags
    assert np.abs(assemble(out, prepared[1]).numpy() - sized).max() < SCENE_TOL
    _, packed = r._enqueue(prepared, params, dict(caps, cmd_cap=max(nc // 2, 1)))
    assert fetch_flags(*packed)[0]["pairs_overflow"]


def frame_scene(jt, t: float, n_base: int = 24):
    """tests/test_animation.py::_frame_scene through the package `jt`: a
    stroked-and-filled scene whose path and segment counts grow with t
    (t in [0, 1]: about +40% geometry) and whose coordinates move every
    frame."""
    rng = np.random.default_rng(12345)
    scene = jt.Scene()
    n = n_base + int(n_base * 0.4 * t)
    for i in range(n):
        cx, cy = rng.uniform(10, 210, 2)
        r = rng.uniform(4, 22)
        ph = 6.28318 * (t + i / n)
        x0, y0 = cx + r * np.cos(ph), cy + r * np.sin(ph)
        p = jt.BezPath().move_to(x0, y0)
        for k in range(1 + i % 3):
            a = ph + (k + 1) * 2.1
            p = p.cubic_to(
                cx + 2 * r * np.cos(a), cy + 2 * r * np.sin(a),
                cx + 2 * r * np.sin(a), cy - 2 * r * np.cos(a),
                cx + r * np.cos(a + 0.4), cy + r * np.sin(a + 0.4),
            )
        p = p.close()
        if i % 3 == 0:
            st = jt.Stroke(width=1.0 + (i % 5), join=jt.Join.ROUND,
                           start_cap=jt.Cap.ROUND, end_cap=jt.Cap.ROUND)
            scene.stroke(st, jt.Affine.identity(),
                         jt.SolidBrush(jt.Color.rgba(0.2, 0.5, 0.8, 0.9)), None, p)
        else:
            scene.fill(jt.Fill.NON_ZERO, jt.Affine.identity(),
                       jt.SolidBrush(jt.Color.rgba(0.9, 0.3, 0.2, 0.8)), None, p)
    return scene


def sweep(frames, ends_to_oracle):
    """Render `frames` frames of the growing scene, t = 0 to 1, through one
    Renderer(device="cpu"): render_device raises if a flag is still raised
    after the retries, so every frame returning is "no flag reached the
    caller". Holds the classes: at most 4, none returned to. With
    `ends_to_oracle`, the frames at t = 0 and t = 1 within ORACLE_TOL of
    the numpy oracle. Returns (classes, programs built)."""
    jt = jello_tpu_torch
    params = jt.RenderParams(width=224, height=224, base_color=jt.Color.rgba(1, 1, 1, 1))
    r = Renderer(device="cpu")
    classes = []
    for f in range(frames):
        t = f / (frames - 1)
        scene = frame_scene(jt, t)
        fine_out, ld = r.render_device(scene, params)
        assert not any(r.last_flags.values())
        key = tuple(sorted((k, v) for k, v in r._caps.items() if isinstance(v, int)))
        if not classes or classes[-1] != key:
            classes.append(key)
        if ends_to_oracle and f in (0, frames - 1):
            params_j = jello_tpu.RenderParams(width=224, height=224,
                                              base_color=jello_tpu.Color.rgba(1, 1, 1, 1))
            with np.errstate(all="ignore"):
                ref, flags, _ = render_numpy(frame_scene(jello_tpu, t), params_j)
            assert not any(bool(v) for v in flags.values())
            assert np.abs(assemble(fine_out, ld).numpy() - ref).max() < ORACLE_TOL
    programs = len(r.compile_log)
    print(f"{frames} frames, {len(classes)} classes, {programs} programs: {r.compile_log}")
    assert len(classes) <= 4, f"{len(classes)} capacity classes over the sweep"
    assert len(classes) == len(set(classes)), "the capacity class went back to an earlier one"
    return classes, programs


def test_torch_growing_scene_settles_few_classes():
    """A dozen frames of the growing scene: one program a class, whatever
    the frames' layouts (every frame adds paths and moves the stream's
    offsets)."""
    classes, programs = sweep(12, ends_to_oracle=True)
    assert programs == len(classes), f"{programs} programs for {len(classes)} classes"


@pytest.mark.slow
def test_torch_growing_scene_settles_few_classes_100_frames():
    """The reference's 100-frame sweep (slow-marked there too), and its
    bound on compiles: `len(r._compiled) <= 4`."""
    _, programs = sweep(100, ends_to_oracle=True)
    assert programs <= 4, f"{programs} programs over the sweep"
