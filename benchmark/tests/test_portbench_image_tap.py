"""The readers of the image tap (`image_tap_ns_per_rec`,
`image_tap_roofline`) on made-up span trees shaped as `Renderer.profiler`'s
`collect()` gives them and made-up traces: the `image_tap` span nested in
each traced call's `fine` span over the call's `img_recs`, kernel F's
share of its byte roofline, and nothing from a program whose calls carry
no such span or count (the parent of the change that added them)."""

from types import SimpleNamespace

import pytest

from metrics import image_tap_ns_per_rec, image_tap_roofline

STAGES = ("flatten", "draw_leaf", "clip_leaf", "tile_alloc", "path_count", "path_tiling",
          "coarse", "fine")


def span(label, duration, *children, counts=None):
    return SimpleNamespace(label=label, start=0.0, duration=duration, children=list(children),
                           counts=counts or {})


def device(ms, tap_ms=None):
    """A `device` span of stage times in ms, with an `image_tap` span of
    `tap_ms` under `fine` unless None."""
    stages = [span(s, m / 1e3) for s, m in zip(STAGES, ms)]
    if tap_ms is not None:
        stages[-1].children.append(span("image_tap", tap_ms / 1e3))
    return span("device", sum(ms) / 1e3, *stages)


def call(tap_ms, img_recs, label="render_surface_async"):
    counts = {"replayed": 1, "lines": 10, "cmds": 100, "max_tile_cmds": 4}
    if img_recs is not None:
        counts["img_recs"] = img_recs
    return span(label, 0.002, span("prepare", 0.0),
                span("enqueue", 0.001, device([1.0] * 8, tap_ms)), span("copy", 0.0),
                counts=counts)


def test_portbench_image_tap_ns_per_rec_sums_the_calls():
    ctx = {"spans": [call(0.5, 1_000_000), span("result", 0.05, span("wait", 0.05)),
                     call(1.5, 1_000_000), call(None, 7), call(9.0, None)]}
    assert image_tap_ns_per_rec.read(ctx) == pytest.approx(2e6 / 2e6)


def test_portbench_image_tap_ns_per_rec_reads_a_calls_last_frame():
    c = call(4.0, 1000, label="render_surface")
    c.children.insert(1, span("enqueue", 0.001, device([1.0] * 8, 99.0)))
    assert image_tap_ns_per_rec.read({"spans": [c]}) == pytest.approx(4e6 / 1000)


def trace(kernel_us, frames=2):
    """A traced window of `frames` frames, one F launch a frame of
    `kernel_us` and a kernel of another kind."""
    events = []
    for k in range(frames):
        t = 100.0 + 1e5 * k
        events.append({"ph": "X", "cat": "kernel", "name": "image_tap_kernel(int const*)",
                       "ts": t, "dur": kernel_us})
        events.append({"ph": "X", "cat": "kernel", "name": "void fine_v2_kernel<1>(int)",
                       "ts": t + 500.0, "dur": 300.0})
    return {"events": events, "start": 0.0, "end": 1e5 * frames, "frames": frames}


def test_portbench_image_tap_roofline_is_the_bytes_over_the_time():
    recs = 870_000
    want_s = recs * (64 + 4096) / 3.35e12
    ctx = {"trace": trace(want_s * 1e6 * 2), "spans": [call(1.0, recs), call(1.0, recs),
                                                       span("result", 0.0)]}
    assert image_tap_roofline.read(ctx) == pytest.approx(50.0)
    assert image_tap_roofline.tap_bytes(1) == 4160


@pytest.mark.parametrize("ctx", [
    {},
    {"trace": None, "spans": [call(1.0, 10)]},
    {"trace": trace(10.0), "spans": [call(1.0, None), call(None, None)]},
    {"trace": trace(0.0), "spans": [call(1.0, 10)]},
    {"trace": dict(trace(10.0), events=[]), "spans": [call(1.0, 10)]},
], ids=["untraced", "no trace", "no img_recs", "no F time", "no device operation"])
def test_portbench_image_tap_readers_read_nothing_where_there_is_nothing(ctx):
    assert image_tap_roofline.read(ctx) is None
    if "img_recs" not in str(ctx.get("spans")):
        assert image_tap_ns_per_rec.read(ctx) is None
