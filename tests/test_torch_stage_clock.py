"""The port's in-program tracing: the host span tree of `Renderer.profiler`
(prepare's resolve, layout and upload, upload's release, pad, digest, pin
and copy, the `result` group of a frame in flight), the frame index a call
shares with its result, the counts on the spans and the renderer's running
totals, the "jello." spans a `Profiler` puts into a torch.profiler capture,
and the stage clock (`profiler.stage_clock`, `named_scope`): its stamps'
plumbing on the CPU with the card's clock replaced by a host counter, and
on the card a replayed frame of configs 4 and 5.

The CPU captures ask torch.profiler for the CPU activity only."""

import json

import numpy as np
import pytest
import torch

import jello_tpu_torch as jt
from jello_tpu_torch import profiler as tp
from jello_tpu_torch.cuda import Renderer
from jello_tpu_torch.cuda import render as render_mod
from jello_tpu_torch.pipeline.render import STAGES
from jello_tpu_torch.scenes import GATE_SCENES, circle

UPLOAD_PARTS = ["release", "pad", "digest", "pin", "copy"]


def disc(r=40.0):
    """A new Scene (never cached by the renderer) of one disc and a linear
    gradient (so the frame has a stop table)."""
    s = jt.Scene()
    s.fill(jt.Fill.NON_ZERO, jt.Affine.identity(), jt.SolidBrush(jt.Color.rgba(0.2, 0.4, 0.9, 1)),
           None, circle(64, 48, r))
    grad = jt.GradientBrush(jt.LinearGradient((0.0, 0.0), (128.0, 96.0), [
        jt.ColorStop(0.0, jt.Color.rgba(1, 0, 0, 1)), jt.ColorStop(1.0, jt.Color.rgba(0, 0, 1, 1))]))
    s.fill(jt.Fill.NON_ZERO, jt.Affine.identity(), grad, None, circle(30, 30, 20))
    return s, jt.RenderParams(width=128, height=96, base_color=jt.Color.rgba(1, 1, 1, 1))


def labels(res):
    return [c.label for c in res.children]


def child(res, label):
    (found,) = [c for c in res.children if c.label == label]
    return found


def test_torch_span_tree_of_a_cpu_render():
    """prepare splits into resolve, layout and upload, and upload into
    release, pad, digest, pin and copy, each inside its parent; a frame in
    flight's result() is a `result` group with a wait span."""
    r = Renderer(device="cpu")
    r.render_surface(*disc())
    r.profiler = tp.Profiler()
    r.render_surface(*disc())
    r.render_surface_async(*disc()).result()
    sync, flight, result = r.profiler.collect()
    for call in (sync, flight):
        prep = child(call, "prepare")
        assert labels(prep) == ["resolve", "layout", "upload"]
        upload = child(prep, "upload")
        assert labels(upload) == UPLOAD_PARTS
        for parent in (call, prep, upload):
            assert sum(c.duration for c in parent.children) <= parent.duration
            for c in parent.children:
                assert parent.start <= c.start and c.start + c.duration <= parent.start + \
                    parent.duration
    assert labels(result) == ["wait"]
    assert tp.ProfilerResult("x", 0.0, 0.001).pretty() == "x: 1.000 ms\n"


def test_torch_a_call_and_its_result_share_the_frame_index():
    r = Renderer(device="cpu")
    r.render_surface(*disc())
    r.profiler = tp.Profiler()
    f1 = r.render_surface_async(*disc())
    f2 = r.render_surface_async(*disc())
    r.render_surface(*disc())
    f2.result()
    f1.result()
    calls = r.profiler.collect()
    assert [(c.label, c.frame) for c in calls] == [
        ("render_surface_async", 1), ("render_surface_async", 2), ("render_surface", 3),
        ("result", 2), ("result", 1)]
    assert (f1.index, f2.index) == (1, 2)
    # Every span of a call carries the call's frame index.
    assert {c.frame for c in calls[0].children} == {1}
    assert r.counters["frames"] == 4


def test_torch_counts_on_the_spans_and_the_running_totals():
    """A call counts whether its frame replayed, its retries, the bytes it
    uploaded, the uploads the digest skipped, and its frame's lines,
    commands and deepest tile (`frame_counts`); `counters` keeps the
    running totals."""
    r = Renderer(device="cpu")
    r.profiler = tp.Profiler()
    r.render_surface(*disc())  # estimated, calibrated: eager frames
    retries = len(r.last_retries)
    scene, params = disc()
    r.render_surface(scene, params)  # the settled class's program
    r.render_surface(scene, params)  # the same scene: prepared inputs cached
    first, second, cached = r.profiler.collect()
    assert first.counts["replayed"] == 0 and first.counts["retries"] == retries
    assert first.counts["upload_bytes"] > 0 and first.counts["uploads_skipped"] == 0
    assert second.counts["replayed"] == 1 and second.counts["retries"] == 0
    # The stop table's content is unchanged: only the words and the layout go.
    assert second.counts["uploads_skipped"] == 1
    prepared = r._frame[2][2]
    assert second.counts["upload_bytes"] == prepared[0].nbytes + prepared[1].nbytes
    frame = render_mod.frame_counts(r.last_stats)
    assert frame["lines"] > 0 and frame["cmds"] >= frame["max_tile_cmds"] > 0
    assert first.counts.items() >= frame.items() and second.counts.items() >= frame.items()
    assert cached.counts == dict(replayed=1, retries=0, upload_bytes=0, uploads_skipped=0,
                                 **frame)
    assert r.counters == {"frames": 3, "replays": 2, "eager": 1 + retries,
                          "upload_bytes": first.counts["upload_bytes"]
                          + second.counts["upload_bytes"], "uploads_skipped": 1}


def _capture(fn, path):
    """fn() under a CPU-only torch.profiler capture: its span events
    (`user_annotation`) as (name, start, end)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
            for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def test_torch_jello_spans_nest_in_a_torch_profiler_capture(tmp_path):
    """With a Profiler attached, each group is a `jello.<path>` span of the
    capture, nested as in the tree; Scene.append is a span of its own."""
    r = Renderer(device="cpu")
    r.render_surface(*disc())
    r.profiler = tp.Profiler()
    base, params = disc()

    def frame():
        s = jt.Scene()
        s.append(base, jt.Affine.translate(3.0, 2.0))
        r.render_surface_async(s, params).result()

    spans = _capture(frame, tmp_path / "capture.json")
    by_name = {name: (s, e) for name, s, e in spans}
    tree = r.profiler.collect()
    assert "jello.scene.append" in by_name
    for res in tree:
        stack = [(res, res.label)]
        while stack:
            node, path = stack.pop()
            s, e = by_name[tp.SPAN_PREFIX + path]
            for c in node.children:
                if c.label == "device":
                    continue
                cs, ce = by_name[tp.SPAN_PREFIX + path + "." + c.label]
                assert s <= cs and ce <= e, (path, c.label)
                stack.append((c, path + "." + c.label))
    assert {"jello.render_surface_async.prepare.upload.pin", "jello.result.wait"} <= set(by_name)


def test_torch_no_renderer_span_without_a_profiler(tmp_path):
    r = Renderer(device="cpu")
    r.render_surface(*disc())
    spans = _capture(lambda: r.render_surface_async(*disc()).result(), tmp_path / "c.json")
    names = {name for name, _, _ in spans}
    assert "flatten" in names  # the stage spans are always there
    assert not any(n.startswith(tp.SPAN_PREFIX) for n in names)
    assert r._open == []


@pytest.fixture
def host_clock(monkeypatch):
    """The stage clock on the CPU, each stamp a host counter: the k-th
    stamp of the process writes k * k ms (in ns), so consecutive stages
    read 1, 3, 5, ... ms and every frame's stamps differ. Returns the slots
    stamped, in order."""
    slots = []

    def stamp(buf, slot):
        k = len(slots)
        slots.append(slot)
        buf[slot] = k * k * 1_000_000

    monkeypatch.setattr(render_mod, "stamp_buffer",
                        lambda device, n: torch.zeros(n, dtype=torch.int64, device=device))
    monkeypatch.setattr(tp, "device_stamp", stamp)
    return slots


def _want(frame_no):
    """The stage ms of the frame_no-th stamped frame under `host_clock`."""
    base = frame_no * (len(STAGES) + 1)
    return {s: float(2 * (base + k) + 1) for k, s in enumerate(STAGES)}


def test_torch_stage_clock_plumbing_with_a_host_counter(host_clock):
    """Nine stamps a frame, in stage order; a checked frame's stage ms in
    `last_stage_ms` and, with a profiler, as the `device` span under its
    enqueue span; two frames in flight on one program each read their own
    stamps, their device spans filled in by result()."""
    r = Renderer(device="cpu")
    scene, params = disc()
    r.render_surface(scene, params)
    n = len(host_clock) // (len(STAGES) + 1)
    assert host_clock == list(range(len(STAGES) + 1)) * n
    assert r.last_stage_ms == _want(n - 1)
    r.profiler = tp.Profiler()
    r.render_surface(scene, params)  # the class's program
    assert r._program is not None and r.last_stage_ms == _want(n)
    f1 = r.render_surface_async(scene, params)
    f2 = r.render_surface_async(scene, params)
    assert r.last_stage_ms is None and f1.stage_ms is None
    assert np.array_equal(f2.result(), f1.result())
    assert (f1.stage_ms, f2.stage_ms) == (_want(n + 1), _want(n + 2))
    assert host_clock == list(range(len(STAGES) + 1)) * (n + 3)
    sync, a1, a2, _, _ = r.profiler.collect()
    for call, want in ((sync, _want(n)), (a1, _want(n + 1)), (a2, _want(n + 2))):
        dev = child(child(call, "enqueue"), "device")
        assert labels(dev) == list(STAGES)
        assert {c.label: c.duration * 1e3 for c in dev.children} == pytest.approx(want)
        assert dev.duration * 1e3 == pytest.approx(sum(want.values()))


def test_torch_stage_clock_stays_out_of_the_unread_flags(host_clock):
    """Frames rendered unchecked keep only their flags and stats on the
    device, merged by their maximum; the stamps are read by no one."""
    r = Renderer(device="cpu")
    scene, params = disc()
    r.render_device(scene, params)
    stats = dict(r.last_stats)
    for _ in range(2):
        r.render_device(scene, params, check_flags=False)
        assert r.last_stage_ms is None
    ((fkeys, skeys), packed), = r.unread_flags.items()
    assert packed.shape == (len(fkeys) + len(skeys),)
    assert not any(r.read_flags().values()) and r.last_stats == stats


def test_torch_stage_ms_and_device_result_of_stamps():
    stamps = [10_000_000 + 1_000_000 * k * k for k in range(len(STAGES) + 1)]
    ms = tp.stage_ms(stamps, STAGES)
    assert list(ms) == list(STAGES) and ms["flatten"] == 1.0 and ms["fine"] == 15.0
    dev = tp.device_result(stamps, STAGES)
    assert dev.label == "device" and dev.start == 0.01
    assert dev.duration == pytest.approx(sum(ms.values()) / 1e3)
    assert [c.duration * 1e3 for c in dev.children] == pytest.approx(list(ms.values()))
    packed = torch.tensor(stamps, dtype=torch.int64).view(torch.int32)
    assert render_mod.unpack_stamps([1, 7] + packed.tolist(), ["a"], ["b"]) == stamps
    assert render_mod.unpack_stamps([1, 7], ["a"], ["b"]) is None


def test_torch_frame_rendered_again_has_a_render_again_span():
    """A frame in flight whose class ran short renders again inside its
    result(): the `result` group holds the frame's enqueue and flags spans
    under `render_again`."""
    from .test_torch_frames import blobs

    r = Renderer(device="cpu")
    small, params = blobs(jt, 1.0)
    r.render_surface(small, params)
    r.profiler = tp.Profiler()
    grown, params = blobs(jt, 25.0)
    frame = r.render_surface_async(grown, params)
    assert r.last_flags is None  # enqueued at the settled class, too small for it
    frame.result()
    result = r.profiler.collect()[-1]
    assert result.label == "result" and any(frame.flags.values())
    assert labels(result) == ["wait", "render_again"]
    assert labels(child(result, "render_again"))[:2] == ["enqueue", "flags"]


# ---- on the card -----------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")


def _busy_ms(r, scene, params, frames, log_dir):
    """Busy device ms a frame of `frames` replayed render_surface calls, from
    a torch.profiler capture (the union of the device operations), and the
    stage ms of each frame from its stage clock."""
    from jello_tpu_torch.xtrace import attribute

    stage = []
    with tp.Profiler().device_trace(log_dir, frames=frames):
        for _ in range(frames):
            r.render_surface(scene, params)
            stage.append(dict(r.last_stage_ms))
    (tab,) = attribute(log_dir, frames).values()
    return tab["lines"]["all streams"][1], stage


@pytest.mark.cuda
@pytest.mark.parametrize("config", [4, 5])
def test_torch_stage_clock_of_a_replayed_frame_on_the_card(cuda, config, tmp_path, monkeypatch):
    """A replayed frame of config 4 and 5: its stamps rise, its eight stage
    times come to 90-105% of its busy ms in a trace of the same frames, two
    frames in flight carry their own stamps, and the program's graph is the
    graph of the frame without the clock plus nine stamps, and two more
    where the frame runs the image tap (config 5)."""
    from jello_tpu_torch.cuda.program import graph_ops

    scene, params = GATE_SCENES[config]()
    r = Renderer(device="cuda")
    for _ in range(3):
        r.render_surface(scene, params)
    assert r._program is not None
    ms = r.last_stage_ms
    assert list(ms) == list(STAGES) and all(v > 0 for v in ms.values()), ms

    frames = 3
    busy, stage = _busy_ms(r, scene, params, frames, str(tmp_path / "trace"))
    total = sum(sum(s.values()) for s in stage) / frames
    assert 0.90 * busy <= total <= 1.05 * busy, (total, busy)

    r.profiler = tp.Profiler()
    f1 = r.render_surface_async(scene, params)
    f2 = r.render_surface_async(scene, params)
    f2.result()
    f1.result()
    d1, d2 = (child(child(c, "enqueue"), "device") for c in r.profiler.collect()[:2])
    assert f1.stage_ms != f2.stage_ms
    # The second frame's clock starts after the first one's last stamp.
    assert d1.start + d1.duration <= d2.start
    r.profiler = None

    with_clock = graph_ops(r._program.graph)
    monkeypatch.setattr(render_mod, "stamp_buffer", lambda device, n: None)
    plain = Renderer(device="cuda")
    for _ in range(3):
        plain.render_surface(scene, params)
    without = graph_ops(plain._program.graph)
    extra = {k: with_clock.get(k, 0) - without.get(k, 0) for k in set(with_clock) | set(without)}
    extra = {k: n for k, n in extra.items() if n}
    assert len(extra) == 1, extra
    ((name, n),) = extra.items()
    assert "stamp_kernel" in name and n == len(STAGES) + 1 + (2 if config == 5 else 0)
    assert plain.last_stage_ms is None
