"""The compiled frame (jello_tpu_torch/cuda/program.py and the renderer's
use of it) on `Renderer(device="cpu")`: a program's frame equals the
eager frame at its class bit for bit and jello_tpu's numpy oracle within
2e-3; `compile_log` has one entry a settled class; a program's static
outputs are never what a caller keeps; size classes and the upload
cache (jello_tpu's `tpu/render.py:276-293, 510-523`).

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
from jello_tpu_torch.cuda.render import assemble, build_layout_dict, frame, upload
from jello_tpu_torch.pipeline.gradient import stops_table_or_empty
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
    return assemble(fine_out, prepared[2][1]).cpu().numpy(), packed


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
    assert index == 0 and seconds >= 0 and summary.startswith("512x512 area fine_v2")
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
    words, layout_t, ramps_t = prepared[2][:3]
    n = len(scene_u32)
    assert words.shape[0] == 1 << (n - 1).bit_length() > n
    assert ramps_t.shape[0] == 1 << (stops.shape[0] - 1).bit_length() > stops.shape[0]
    assert torch.equal(ramps_t[:stops.shape[0]], torch.from_numpy(stops))
    caps, fine_impl = r._route(prepared, params, r._caps)
    unpadded = upload(scene_u32, build_layout_dict(layout, params), stops, {}, "cpu")[:3]
    want = frame(*unpadded, None, caps, fine_impl)
    got = frame(*prepared[2], caps, fine_impl)
    assert torch.equal(want[1], got[1])
    assert np.array_equal(assemble(want[0], layout_t).numpy(), assemble(got[0], layout_t).numpy())


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
