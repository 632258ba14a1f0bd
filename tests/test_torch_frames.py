"""Frames in flight and the renderer's switches (jello_tpu_torch/cuda/
render.py): `render_surface_async` and `Frame`, `render_device(
check_flags=False)`, `flags_history`, and the JELLO_IMAGE_TAP=0 route, on
`Renderer(device="cpu")` (the plain versions of the kernels).

Unlike jello_tpu's settled async frames, which read no flag, a frame in
flight carries its packed flags back with its pixels: a scene that grew
after its class settled is caught in `Frame.result()` and rendered again
from the inputs the frame was enqueued with."""

import numpy as np
import pytest
import torch

import jello_tpu_torch
from jello_tpu.cpu import render_numpy
from jello_tpu_torch.cuda import Frame, Renderer
from jello_tpu_torch.cuda import image_tap as ktap
from jello_tpu_torch.cuda import render as render_mod
from jello_tpu_torch.scenes import GATE_SCENES, _blob, _gradient, _rng, circle

from .test_torch_no_jax import BUILD
from .torch_reference import both

_SCOPE = {"np": np}
exec(BUILD, _SCOPE)
nested_layers = _SCOPE["nested_layers"]
image_and_stroke = _SCOPE["image_and_stroke"]


def config3_reduced(jt):
    """Config 3's gradient blobs (`scenes.config3`), 80 of them at 256x256."""
    rng = _rng(3)
    scene = jt.Scene()
    for i in range(80):
        cx, cy = rng.random(2) * 256
        r = 3 + 10 * rng.random()
        scene.fill(jt.Fill.NON_ZERO, jt.Affine.identity(),
                   _gradient(rng, cx, cy, r, "linear" if i % 2 == 0 else "radial"), None,
                   _blob(rng, cx, cy, r))
    return scene, jt.RenderParams(width=256, height=256, base_color=jt.Color.rgba(1, 1, 1, 1))


def blobs(jt, scale):
    """24 translucent discs under one scale: the stream shape (tags, paths,
    words) is the same at every scale, the tiles it covers are not (at 25
    more than the settled class at 1 holds)."""
    rng = np.random.default_rng(3)
    s = jt.Scene()
    for _ in range(24):
        x, y, rad = rng.random(3) * [14, 14, 3] + [3, 3, 6]
        s.fill(jt.Fill.NON_ZERO, jt.Affine.scale(scale),
               jt.SolidBrush(jt.Color.rgba(*rng.random(3), 0.5)), None, circle(x, y, rad))
    return s, jt.RenderParams(width=512, height=512, base_color=jt.Color.rgba(1, 1, 1, 1))


@pytest.mark.parametrize("build", [lambda jt: GATE_SCENES[1](), config3_reduced, nested_layers],
                         ids=["config1", "config3_reduced", "nested_layers"])
def test_torch_async_frames_equal_render_surface(build):
    scene, params = build(jello_tpu_torch)
    r = Renderer(device="cpu")
    want = r.render_surface(scene, params)
    frames = [r.render_surface_async(scene, params) for _ in range(3)]
    assert all(isinstance(f, Frame) and f.ready() for f in frames)
    for f in frames:
        got = f.result()
        assert got.dtype == np.uint8 and got.shape == want.shape
        assert np.array_equal(got, want)
        # A settled frame read its own flags with its pixels.
        assert f.flags is not None and not any(f.flags.values())
    assert r.last_retries == [] and r.flags_history == []


def test_torch_async_first_frame_settles_the_shape():
    """The first async frame of a shape renders checked (estimate,
    calibrate) and is returned done; it carries no unread flags."""
    scene, params = GATE_SCENES[1]()
    r = Renderer(device="cpu")
    f = r.render_surface_async(scene, params)
    assert r.last_retries == [["calibrated"]] and f.flags == r.last_flags
    assert not any(f.flags.values())
    assert np.array_equal(f.result(), Renderer(device="cpu").render_surface(scene, params))


def test_torch_async_grown_scene_renders_again_from_its_own_inputs():
    """A scene grown past its settled class under the same stream shape:
    the frame in flight raises flags on the device, `result()` grows the
    class and renders again from the inputs the frame was enqueued with,
    although the caller changed the Scene after enqueueing."""
    r = Renderer(device="cpu")
    small, params = blobs(jello_tpu_torch, 1.0)
    r.render_surface(small, params)
    grown, _ = blobs(jello_tpu_torch, 25.0)
    frame = r.render_surface_async(grown, params)
    assert r.last_flags is None  # enqueued, not read
    grown.fill(jello_tpu_torch.Fill.NON_ZERO, jello_tpu_torch.Affine.identity(),
               jello_tpu_torch.SolidBrush(jello_tpu_torch.Color.rgba(0, 0, 0, 1)), None,
               circle(128, 128, 100))
    got = frame.result()
    raised = sorted(k for k, v in frame.flags.items() if v)
    assert "tiles_overflow" in raised
    assert r.flags_history and r.flags_history[0] == raised
    assert r.last_retries[0] == raised and not any(r.last_flags.values())
    want = Renderer(device="cpu").render_surface(*blobs(jello_tpu_torch, 25.0))
    assert np.array_equal(got, want)
    # The grown class stays: the next frame of the grown shape is clean.
    again = r.render_surface_async(*blobs(jello_tpu_torch, 25.0))
    assert np.array_equal(again.result(), want) and not any(again.flags.values())


def test_torch_render_device_unchecked_leaves_the_flags_on_the_device(monkeypatch):
    scene, params = config3_reduced(jello_tpu_torch)
    r = Renderer(device="cpu")
    fine_want, _ = r.render_device(scene, params)
    reads = []
    real_fetch = render_mod.fetch_frame
    monkeypatch.setattr(render_mod, "fetch_frame", lambda *a: reads.append(a) or real_fetch(*a))
    fine_out, ld = r.render_device(scene, params, check_flags=False)
    assert reads == []
    assert r.last_flags is None and r.last_stats is None
    ((fkeys, skeys), packed), = r.unread_flags.items()
    assert packed.dtype == torch.int32 and packed.shape == (len(fkeys) + len(skeys),)
    assert packed.device == r.device
    assert np.array_equal(render_mod.assemble(fine_out, ld).numpy(),
                          render_mod.assemble(fine_want, ld).numpy())
    flags = r.read_flags()
    assert len(reads) == 1 and r.unread_flags == {}
    assert set(flags) == set(fkeys) and not any(flags.values()) and r.last_flags == flags
    assert r.last_stats["tiles"] > 0
    with pytest.raises(RuntimeError):
        r.read_flags()


def test_torch_unchecked_flags_are_kept_until_read():
    """A grown frame rendered unchecked, then a clean unchecked frame and
    a checked one, before `read_flags()`: the grown frame's raised flag is
    still reported by the read."""
    r = Renderer(device="cpu")
    small, params = blobs(jello_tpu_torch, 1.0)
    r.render_device(small, params)
    r.render_device(blobs(jello_tpu_torch, 25.0)[0], params, check_flags=False)
    r.render_device(small, params, check_flags=False)
    r.render_device(small, params)
    assert not any(r.last_flags.values()) and len(r.unread_flags) == 1
    flags = r.read_flags()
    assert flags["tiles_overflow"] and r.last_flags == flags
    assert "tiles_overflow" in r.flags_history[-1]
    assert r.unread_flags == {}


def test_torch_async_frames_in_flight_grow_the_class_once(monkeypatch):
    """Two frames of a grown scene in flight: the first `result()` grows
    the class, the second renders at it without growing it again."""
    r = Renderer(device="cpu")
    r.render_surface(*blobs(jello_tpu_torch, 1.0))
    grown, params = blobs(jello_tpu_torch, 25.0)
    frames = [r.render_surface_async(grown, params) for _ in range(2)]
    want = Renderer(device="cpu").render_surface(*blobs(jello_tpu_torch, 25.0))
    grows = []
    real_grow = render_mod.grow_caps
    monkeypatch.setattr(render_mod, "grow_caps", lambda *a: grows.append(a) or real_grow(*a))
    assert np.array_equal(frames[0].result(), want)
    caps, n_grows = dict(r._caps), len(grows)
    assert n_grows >= 1
    assert np.array_equal(frames[1].result(), want)
    assert len(grows) == n_grows and r._caps == caps
    assert r.last_retries == [r.flags_history[-1]] and "tiles_overflow" in r.last_retries[0]
    assert r._settled_key == r._est_key


def test_torch_async_grown_frame_of_a_left_shape_keeps_the_current_class():
    """A grown frame of shape A in flight while the caller moved to shape
    B: `result()` renders it again at a class of its own, and B's class
    and settled state stay, so B's next frame is only enqueued."""
    r = Renderer(device="cpu")
    r.render_surface(*blobs(jello_tpu_torch, 1.0))
    frame_a = r.render_surface_async(*blobs(jello_tpu_torch, 25.0))
    scene_b, params_b = config3_reduced(jello_tpu_torch)
    want_b = r.render_surface(scene_b, params_b)
    caps_b, key_b = dict(r._caps), r._est_key
    want_a = Renderer(device="cpu").render_surface(*blobs(jello_tpu_torch, 25.0))
    assert np.array_equal(frame_a.result(), want_a)
    assert "tiles_overflow" in r.flags_history[0]
    assert r._caps == caps_b and r._est_key == r._settled_key == key_b
    frame_b = r.render_surface_async(scene_b, params_b)
    assert r.last_flags is None  # enqueued, not rendered checked
    assert np.array_equal(frame_b.result(), want_b) and not any(frame_b.flags.values())


def test_torch_image_tap_off_routes_images_through_the_interpreter(monkeypatch):
    """JELLO_IMAGE_TAP=0: a clip-free frame with an image paint takes
    `fine_hybrid`, its image tiles the interpreter, and the tap is never
    called; the frame stays within 8e-3 of the oracle (the tolerance of
    tests/test_fine_hybrid.py) and 1e-4 of the tap route's frame."""
    ref_built, built = both(image_and_stroke)
    tap_frame = Renderer(device="cpu").render(*built)
    calls = []
    real_tap = ktap.tap_records
    monkeypatch.setattr(ktap, "tap_records", lambda *a: calls.append(a) or real_tap(*a))
    fine_impls = []
    real_frame = render_mod.render_frame
    monkeypatch.setattr(render_mod, "render_frame",
                        lambda *a: fine_impls.append(a[-1]) or real_frame(*a))
    monkeypatch.setenv("JELLO_IMAGE_TAP", "0")
    r = Renderer(device="cpu")
    assert r.use_image_tap is False
    img = r.render(*built)
    assert calls == []
    assert r.last_stats["legacy_tiles"] > 0 and r.last_stats["img_recs"] > 0
    assert r._caps["legacy_tiles_cap"] >= r.last_stats["legacy_tiles"]
    assert not any(r.last_flags.values())
    with np.errstate(all="ignore"):
        ref, _, _ = render_numpy(*ref_built)
    assert np.abs(img - ref).max() <= 8e-3
    assert np.abs(img - tap_frame).max() <= 1e-4
    assert fine_impls and set(fine_impls) == {render_mod.fine_hybrid}
    assert "_image_tap" not in render_mod.frame_routing(0, True, 0, image_tap=False)


def test_torch_renderer_profiler_splits_a_call_into_host_spans():
    """`Renderer.profiler`: each render_surface and render_surface_async
    call is one group of host spans; a settled async call has no flags
    span (it reads nothing) and a copy span (the Frame), and its
    `Frame.result()` is a `result` group of its own with a wait span."""
    from jello_tpu_torch.profiler import Profiler

    scene, params = GATE_SCENES[1]()
    r = Renderer(device="cpu")
    r.render_surface(scene, params)
    r.profiler = Profiler()
    r.render_surface(scene, params)
    r.render_surface_async(scene, params).result()
    sync, flight, result = r.profiler.collect()
    assert sync.label == "render_surface" and flight.label == "render_surface_async"
    assert [c.label for c in sync.children] == ["prepare", "enqueue", "flags", "present", "read"]
    assert [c.label for c in flight.children] == ["prepare", "enqueue", "present", "copy"]
    assert result.label == "result" and [c.label for c in result.children] == ["wait"]
    for res in (sync, flight, result):
        assert sum(c.duration for c in res.children) <= res.duration
    r.profiler = None
    r.render_surface(scene, params)
    assert r._open == []


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")


@pytest.mark.cuda
def test_torch_surface_reads_stay_the_callers_on_the_card(cuda):
    """`build.device_to_host` reads into page-locked memory that the
    returned array keeps: a later read does not overwrite it, and
    `render_surface` returns the frame the CPU renders."""
    from jello_tpu_torch.cuda.build import device_to_host

    a_dev = torch.arange(1920 * 1080 * 4, device="cuda").to(torch.uint8).reshape(1080, 1920, 4)
    a = device_to_host(a_dev)
    b = device_to_host(255 - a_dev)
    assert a.dtype == np.uint8 and a.shape == (1080, 1920, 4)
    assert torch.from_numpy(a).is_pinned()
    assert np.array_equal(a, a_dev.cpu().numpy()) and np.array_equal(b, 255 - a)
    scene, params = GATE_SCENES[1]()
    r = Renderer(device="cuda")
    frames = [r.render_surface(scene, params) for _ in range(3)]
    plain = Renderer(device="cpu").render_surface(scene, params)
    assert all(np.abs(f.astype(int) - plain.astype(int)).max() <= 1 for f in frames)
