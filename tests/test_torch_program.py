"""The compiled frame (jello_tpu_torch/cuda/program.py and the renderer's
use of it) on `Renderer(device="cpu")`: a program's frame equals the
eager frame at its class bit for bit and jello_tpu's numpy oracle within
2e-3; `compile_log` has one entry a settled class; a program's static
outputs are never what a caller keeps; size classes and the upload
cache (jello_tpu's `tpu/render.py:276-293, 510-523`); a program keyed as
jello_tpu keys an executable, so scenes of one class with other layouts
(a path removed, cubics drawn as lines, another target inside the tile
grid, frames in flight of two layouts) share one program, and the packed
layout equals jello_tpu's (`pipeline/render.py:24-63`).

On the CPU a program calls its frame function and copies the results
into its static outputs, so outputs alias from frame to frame as the
replays of a CUDA graph do. The test marked `cuda` holds a captured
graph's replay to the eager frame on the card and skips itself without
one (`JELLO_TEST_TPU=1 python -m pytest tests/test_torch_program.py -q -m
cuda` there)."""

import numpy as np
import pytest
import torch

import jello_tpu_torch
from jello_tpu.cpu import render_numpy
from jello_tpu_torch.cuda import Renderer
from jello_tpu_torch.cuda.program import FrameProgram
from jello_tpu_torch.cuda.render import (
    assemble,
    build_layout_dict,
    frame,
    upload,
    upload_layout,
)
from jello_tpu_torch.pipeline.gradient import stops_table_or_empty
from jello_tpu_torch.pipeline.render import LAYOUT_INT_FIELDS, pack_layout, unpack_layout
from jello_tpu_torch.renderer.resolve import Resolver
from jello_tpu_torch.scenes import _blob, _gradient, _rng, circle

from .test_torch_frames import blobs, config3_reduced, image_and_stroke, nested_layers
from .torch_reference import both

ORACLE_TOL = 2e-3  # tests/test_torch_render.py's


def config1(jt):
    return jt.scenes.config1()


def shifted(jt, dx, alpha=0.5):
    """16 translucent discs moved by dx: one stream shape (and, for small
    dx, one class) whatever dx and alpha."""
    rng = np.random.default_rng(5)
    s = jt.Scene()
    for _ in range(16):
        x, y, rad = rng.random(3) * [40, 40, 4] + [10 + dx, 10, 5]
        s.fill(jt.Fill.NON_ZERO, jt.Affine.identity(),
               jt.SolidBrush(jt.Color.rgba(*rng.random(3), alpha)), None, circle(x, y, rad))
    return s, jt.RenderParams(width=64, height=64, base_color=jt.Color.rgba(1, 1, 1, 1))


def eager(r, scene, params):
    """The frame of `scene` at the renderer's class, run eagerly:
    (assembled image, packed flags)."""
    prepared = r._prepare(scene, params)
    caps, fine_impl = r._route(prepared, params, r._caps)
    fine_out, packed, _ = frame(*prepared[2], caps, fine_impl)
    return assemble(fine_out, prepared[1]).cpu().numpy(), packed


@pytest.mark.parametrize("build", [config1, image_and_stroke, nested_layers],
                         ids=["config1", "image_and_stroke", "nested_layers"])
def test_torch_program_frame_equals_the_eager_frame_and_the_oracle(build):
    import jello_tpu.scenes  # noqa: F401  (config1 through jello_tpu)
    import jello_tpu_torch.scenes  # noqa: F401

    (scene_j, params_j), (scene, params) = both(build)
    r = Renderer(device="cpu")
    first = r.render(scene, params)  # estimate and calibration: eager
    assert r.compile_log == [] and r._program is None
    img = r.render(scene, params)
    assert len(r.compile_log) == 1 and r._program is not None and r._program.replays == 1
    want, _ = eager(r, scene, params)
    assert np.array_equal(img, want) and np.array_equal(img, first)
    assert not any(r.last_flags.values())
    with np.errstate(all="ignore"):
        ref, _, _ = render_numpy(scene_j, params_j)
    assert np.abs(img - ref).max() <= ORACLE_TOL
    u8 = r.render_surface(scene, params)
    assert len(r.compile_log) == 1 and r._program.replays == 2
    assert np.array_equal(u8, Renderer(device="cpu").render_surface(scene, params))


def test_torch_compile_log_one_entry_a_settled_class():
    """One entry when a settled class first renders, none on repeat
    frames, one more once a grown class has rendered clean."""
    r = Renderer(device="cpu")
    small, params = blobs(jello_tpu_torch, 1.0)
    r.render_surface(small, params)
    assert r.compile_log == []
    for _ in range(3):
        r.render_surface(small, params)
    assert len(r.compile_log) == 1
    index, seconds, summary = r.compile_log[0]
    assert index == 0 and seconds >= 0 and summary.startswith("tile grid 1024 area fine_v2")
    grown, _ = blobs(jello_tpu_torch, 25.0)
    r.render_surface(grown, params)  # the program's frame overflows, the grown class is eager
    assert "tiles_overflow" in r.last_retries[0] and len(r.compile_log) == 1
    r.render_surface(grown, params)
    r.render_surface(grown, params)
    assert len(r.compile_log) == 2 and r.last_retries == []
    r.render_surface(small, params)  # the first class's program again, kept
    assert len(r._programs) == 2


def test_torch_revisited_shape_builds_no_program_for_its_estimate_class():
    """A shape rendered again after another: its estimate and calibration
    frames run eagerly again, its calibrated class replays the program it
    already has, and the estimate class gets none."""
    r = Renderer(device="cpu")
    a, params = shifted(jello_tpu_torch, 0.0)
    r.render(a, params)
    assert r.last_retries == [["calibrated"]]
    r.render(a, params)
    r.render(*config3_reduced(jello_tpu_torch))
    r.render(a, params)
    assert r.last_retries == [["calibrated"]] and r._program is not None
    assert len(r.compile_log) == 1 and r._program.replays == 2


def test_torch_render_device_result_outlives_the_next_frame():
    r = Renderer(device="cpu")
    a, params = shifted(jello_tpu_torch, 0.0)
    b, _ = shifted(jello_tpu_torch, 6.0)
    r.render_device(a, params)
    fine_a, ld = r.render_device(a, params)
    assert r._program is not None and fine_a[0] is not r._program.fine_out[0]
    img_a = assemble(fine_a, ld).numpy().copy()
    fine_b, _ = r.render_device(b, params)
    assert len(r.compile_log) == 1 and r._program.replays == 2
    assert np.array_equal(assemble(fine_a, ld).numpy(), img_a)
    assert not np.array_equal(assemble(fine_b, ld).numpy(), img_a)


def test_torch_unread_flags_of_a_program_frame_survive_the_next_frame():
    """Two unchecked frames of one program, the first over its class:
    `read_flags()` still reads the first one's flag raised."""
    r = Renderer(device="cpu")
    small, params = blobs(jello_tpu_torch, 1.0)
    r.render_device(small, params)
    r.render_device(small, params)
    r.render_device(blobs(jello_tpu_torch, 25.0)[0], params, check_flags=False)
    r.render_device(small, params, check_flags=False)
    assert r._program.replays == 3 and len(r.compile_log) == 1
    flags = r.read_flags()
    assert flags["tiles_overflow"]


def test_torch_program_frames_in_flight_each_equal_their_own_frame():
    r = Renderer(device="cpu")
    r.render_surface(*shifted(jello_tpu_torch, 0.0))
    scenes = [shifted(jello_tpu_torch, dx, alpha) for dx, alpha in ((0.0, 0.5), (4.0, 0.7))]
    frames = [r.render_surface_async(*s) for s in scenes]
    assert len(r.compile_log) == 1 and r._program.replays == 2
    for f, s in zip(frames, scenes):
        assert np.array_equal(f.result(), Renderer(device="cpu").render_surface(*s))
        assert not any(f.flags.values())
    assert not np.array_equal(frames[0].result(), frames[1].result())


def test_torch_padded_scene_renders_as_the_unpadded_one():
    """The renderer pads the scene words to a power of two (at least 1024)
    and the stop table's rows to a power of two; render_frame on the
    padded inputs equals render_frame on the resolver's own."""
    scene, params = config3_reduced(jello_tpu_torch)
    r = Renderer(device="cpu")
    r.render(scene, params)
    prepared = r._prepare(scene, params)
    layout, ramps, _, scene_u32 = Resolver().resolve(scene.encoding)
    stops = stops_table_or_empty(ramps)
    words, _, ramps_t = prepared[2][:3]
    n = len(scene_u32)
    assert words.shape[0] == 1 << (n - 1).bit_length() > n
    assert ramps_t.shape[0] == 1 << (stops.shape[0] - 1).bit_length() > stops.shape[0]
    assert torch.equal(ramps_t[:stops.shape[0]], torch.from_numpy(stops))
    caps, fine_impl = r._route(prepared, params, r._caps)
    ld = build_layout_dict(layout, params)
    scene_t, _, stops_t, _ = upload(scene_u32, ld, stops, {}, "cpu")
    want = frame(scene_t, upload_layout(ld, "cpu"), stops_t, None, caps, fine_impl)
    got = frame(*prepared[2], caps, fine_impl)
    assert torch.equal(want[1], got[1])
    assert np.array_equal(assemble(want[0], ld).numpy(), assemble(got[0], ld).numpy())


def test_torch_scenes_of_one_bucket_and_layout_share_a_program():
    r = Renderer(device="cpu")
    a, params = shifted(jello_tpu_torch, 0.0)
    b, _ = shifted(jello_tpu_torch, 5.0, alpha=0.9)
    for s in (a, b, a, b):
        r.render(s, params)
    assert len(r.compile_log) == 1 and len(r._programs) == 1
    (prog,) = r._programs.values()
    assert prog.replays == 3
    assert np.array_equal(r.render(b, params), Renderer(device="cpu").render(b, params))


def test_torch_stop_table_and_atlas_upload_again_only_on_new_content():
    jt = jello_tpu_torch

    def imaged(seed):
        rng = np.random.default_rng(seed)
        pix = (rng.random((8, 8, 4)) * 255).astype(np.uint8)
        s = jt.Scene()
        s.fill(jt.Fill.NON_ZERO, jt.Affine.scale(4.0), jt.ImageBrush(jt.Image(pixels=pix)), None,
               jt.BezPath().move_to(0, 0).line_to(8, 0).line_to(8, 8).line_to(0, 8).close())
        rng = _rng(1)
        s.fill(jt.Fill.NON_ZERO, jt.Affine.identity(), _gradient(rng, 40, 40, 9, "linear"), None,
               _blob(rng, 40, 40, 9))
        return s, jt.RenderParams(width=64, height=64, base_color=jt.Color.rgba(1, 1, 1, 1))

    r = Renderer(device="cpu")
    first = r._prepare(*imaged(1))[2]
    again = r._prepare(*imaged(1))[2]  # another Scene, the same content
    other = r._prepare(*imaged(2))[2]  # new pixels, the same atlas shape
    assert again[2] is first[2] and again[3] is first[3]
    assert other[2] is first[2]
    assert other[3] is not first[3] and other[3].shape == first[3].shape
    assert not torch.equal(other[3], first[3])


def test_torch_frame_program_rejects_inputs_of_another_shape():
    r = Renderer(device="cpu")
    scene, params = shifted(jello_tpu_torch, 0.0)
    prepared = r._prepare(scene, params)
    caps, fine_impl = r._route(prepared, params, r._caps)
    prog = FrameProgram(prepared[2], lambda *a: frame(*a, caps, fine_impl))
    prog.run(prepared[2])
    scene_t, layout_t, ramps_t, atlas_t = prepared[2]
    with pytest.raises(ValueError, match="program input 0"):
        prog.run((torch.cat([scene_t, scene_t]), layout_t, ramps_t, atlas_t))


def edited(jt, edit="none", size=(64, 64), dx=0.0, base=(1, 1, 1, 1)):
    """16 translucent discs after one edit of the kind an editing app
    makes, each a new layout of the same class: "none"; "removed", the
    last disc left out (a path fewer: every count and offset after it
    moves); "lines", the first disc's four cubics drawn as lines to the
    same points (the same path tags, fewer path data words: the offsets
    after them move). `size` the target, `dx` a shift, `base` the base
    color (a word of the packed layout too)."""
    rng = np.random.default_rng(5)
    s = jt.Scene()
    for i in range(16):
        x, y, rad = rng.random(3) * [40, 40, 4] + [10 + dx, 10, 5]
        brush = jt.SolidBrush(jt.Color.rgba(*rng.random(3), 0.5))
        if edit == "removed" and i == 15:
            continue
        path = circle(x, y, rad)
        if edit == "lines" and i == 0:
            path = (jt.BezPath().move_to(x + rad, y).line_to(x, y + rad).line_to(x - rad, y)
                    .line_to(x, y - rad).line_to(x + rad, y).close())
        s.fill(jt.Fill.NON_ZERO, jt.Affine.identity(), brush, None, path)
    return s, jt.RenderParams(width=size[0], height=size[1], base_color=jt.Color.rgba(*base))


def _layout_of(scene, params):
    """The host layout dict of a scene (`build_layout_dict`)."""
    return build_layout_dict(Resolver().resolve(scene.encoding)[0], params)


@pytest.mark.parametrize("edit", ["removed", "lines"])
def test_torch_scenes_of_one_class_with_other_layouts_share_a_program(edit):
    """A scene and its edit (a path removed; a cubic path drawn as lines,
    the same tag count) settle one class and run one program: the edit's
    frame is a replay of the first scene's program, not a program of its
    own (the parent built one a layout). Each frame equals its own eager
    frame at the class bit for bit and the numpy oracle within 2e-3."""
    jt = jello_tpu_torch
    r = Renderer(device="cpu")
    for _ in range(2):
        img_a = r.render(*edited(jt))
    prog, cls = r._program, dict(r._caps)
    assert len(r.compile_log) == 1 and prog is not None
    img_b = r.render(*edited(jt, edit))
    ld_a, ld_b = _layout_of(*edited(jt)), _layout_of(*edited(jt, edit))
    changed = sorted(k for k in ld_a if k != "base_color" and int(ld_a[k]) != int(ld_b[k]))
    assert changed and "width_in_tiles" not in changed, changed
    assert r._caps == cls, "the edit settled another class"
    assert r._program is prog and len(r.compile_log) == 1 and prog.replays == 2
    for e, img in (("none", img_a), (edit, img_b)):
        scene, params = edited(jt, e)
        r.render(scene, params)
        assert r._program is prog and not any(r.last_flags.values())
        want, _ = eager(r, scene, params)
        assert np.array_equal(img, want), e
        (scene_j, params_j), _ = both(edited, e)
        with np.errstate(all="ignore"):
            ref, _, _ = render_numpy(scene_j, params_j)
        assert np.abs(img - ref).max() <= ORACLE_TOL, e
    assert len(r.compile_log) == 1
    print(f"{edit}: layout fields changed {changed}; programs {r.compile_log}")


def test_torch_two_targets_in_one_tile_grid_bucket_share_a_frame_program():
    """64x64 (4 x 4 tiles) and 100x40 (7 x 3 tiles) lie in one tile grid
    bucket (256 tiles): one frame program, whose kernels read the width in
    tiles from the frame's layout, and a present program for each output
    geometry; each surface equals a fresh renderer's (eager) bit for bit."""
    jt = jello_tpu_torch
    r = Renderer(device="cpu")
    small, wide = edited(jt), edited(jt, size=(100, 40))
    for _ in range(2):
        u8_small = r.render_surface(*small)
    prog, cls = r._program, dict(r._caps)
    u8_wide = r.render_surface(*wide)
    assert r._caps == cls and r._program is prog and len(r.compile_log) == 1
    assert sorted(prog._presents) == [(4, 4, 64, 64, True, True), (7, 3, 100, 40, True, True)]
    assert u8_wide.shape == (40, 100, 4) and u8_small.shape == (64, 64, 4)
    assert np.array_equal(u8_wide, Renderer(device="cpu").render_surface(*wide))
    assert np.array_equal(u8_small, Renderer(device="cpu").render_surface(*small))
    assert np.array_equal(r.render_surface(*small), u8_small) and len(r.compile_log) == 1


def test_torch_frames_in_flight_of_two_layouts_on_one_program_each_equal_their_own_frame():
    """Two layouts of one stream shape (the base color is a word of the
    packed layout; the discs moved too), enqueued back to back on one
    program: each frame's copy of its layout goes in ahead of its replay,
    so each equals its own frame, and the later one leaves the earlier
    one as it was."""
    jt = jello_tpu_torch
    r = Renderer(device="cpu")
    r.render_surface(*edited(jt))
    scenes = [edited(jt, dx=dx, base=base)
              for dx, base in ((0.0, (1, 1, 1, 1)), (6.0, (0.1, 0.2, 0.5, 1)))]
    frames = [r.render_surface_async(*sc) for sc in scenes]
    assert len(r.compile_log) == 1 and r._program.replays == 2
    got = [f.result() for f in frames]
    for f, px, sc in zip(frames, got, scenes):
        assert not any(f.flags.values())
        assert np.array_equal(px, Renderer(device="cpu").render_surface(*sc))
    assert not np.array_equal(got[0], got[1])


@pytest.mark.parametrize("config", [1, 3, 4, 5])
def test_torch_pack_layout_matches_jello_tpu(config):
    """The port's `pack_layout` equals jello_tpu's word for word on the gate
    scenes (config 2 in tests/test_torch_config2.py, which builds it once),
    and `unpack_layout` reads back what jello_tpu's does."""
    import jello_tpu.scenes  # noqa: F401  (the gate scenes through jello_tpu)

    check_pack_layout(*both(lambda jt: jt.scenes.CONFIGS[config]()))


def check_pack_layout(built_j, built_t):
    """One scene built through both packages: the packed layouts equal, the
    unpacked fields equal jello_tpu's unpacked fields (0-dim int32 views),
    the base color bit for bit."""
    from jello_tpu.cpu.pipeline import build_layout_dict as np_build_layout_dict
    from jello_tpu.pipeline import render as np_render
    from jello_tpu.renderer.resolve import Resolver as NpResolver

    (scene_j, params_j), (scene_t, params_t) = built_j, built_t
    packed_j = np_render.pack_layout(
        np_build_layout_dict(NpResolver().resolve(scene_j.encoding)[0], params_j))
    packed_t = pack_layout(build_layout_dict(Resolver().resolve(scene_t.encoding)[0], params_t))
    assert packed_t.dtype == packed_j.dtype == np.uint32
    assert packed_t.tobytes() == packed_j.tobytes()
    want = np_render.unpack_layout(np, packed_j)
    got = unpack_layout(torch.from_numpy(packed_t.view(np.int32)))
    assert set(got) == set(want) == set(LAYOUT_INT_FIELDS) | {"base_color"}
    for k in LAYOUT_INT_FIELDS:
        assert got[k].shape == () and got[k].dtype == torch.int32 and int(got[k]) == int(want[k])
    assert got["base_color"].numpy().tobytes() == np.asarray(want["base_color"]).tobytes()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")


@pytest.mark.cuda
@pytest.mark.parametrize("build", [config1, image_and_stroke, nested_layers],
                         ids=["config1", "image_and_stroke", "nested_layers"])
def test_torch_program_replay_equals_the_eager_frame_on_the_card(cuda, build):
    """The captured graph's replay, its present's and a frame in flight
    equal the eager frame at the class bit for bit."""
    import jello_tpu_torch.scenes  # noqa: F401

    scene, params = build(jello_tpu_torch)
    r = Renderer(device="cuda")
    first = r.render(scene, params)
    img = r.render(scene, params)
    assert len(r.compile_log) == 1 and r._program.replays == 1
    want, _ = eager(r, scene, params)
    assert np.array_equal(img, want) and np.array_equal(img, first)
    u8 = r.render_surface(scene, params)
    frames = [r.render_surface_async(scene, params) for _ in range(2)]
    assert r._program.replays == 4 and len(r.compile_log) == 1
    assert all(np.array_equal(f.result(), u8) for f in frames)
    plain = Renderer(device="cpu").render_surface(scene, params)
    assert np.abs(u8.astype(np.int32) - plain.astype(np.int32)).max() <= 1
