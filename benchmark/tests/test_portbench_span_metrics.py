"""The readers of the program's own spans (`geometry_device_ms`,
`fine_device_ms`, `resolve_ms`, `upload_ms`) on made-up span trees shaped
as `Renderer.profiler`'s `collect()` gives them, and on runs that give
them nothing to read."""

from types import SimpleNamespace

import pytest

from metrics import fine_device_ms, geometry_device_ms, resolve_ms, upload_ms

STAGES = ("flatten", "draw_leaf", "clip_leaf", "tile_alloc", "path_count", "path_tiling",
          "coarse", "fine")
READERS = (geometry_device_ms, fine_device_ms, resolve_ms, upload_ms)


def span(label, duration, *children):
    return SimpleNamespace(label=label, start=0.0, duration=duration, children=list(children))


def device(ms):
    """A `device` span of stage times in ms."""
    return span("device", sum(ms) / 1e3, *(span(s, m / 1e3) for s, m in zip(STAGES, ms)))


def async_call(ms):
    return span("render_surface_async", 0.002, span("prepare", 0.0), span(
        "enqueue", 0.001, device(ms)), span("present", 0.0), span("copy", 0.0))


def pan_call(resolve, layout, upload):
    prepare = span("prepare", (resolve + layout + upload) / 1e3, span("resolve", resolve / 1e3),
                   span("layout", layout / 1e3), span("upload", upload / 1e3, *(
                       span(p, upload / 4e3) for p in ("pad", "digest", "pin", "copy"))))
    return span("render_surface", 0.1, prepare, span("enqueue", 0.001, device([1.0] * 8)),
                span("flags", 0.08))


def test_portbench_stage_readers_take_the_mean_of_the_frames():
    a = [10.0, 1.0, 0.5, 20.0, 3.0, 4.0, 6.0, 2.0]
    b = [12.0, 1.0, 0.5, 22.0, 3.0, 4.0, 6.5, 4.0]
    calls = [async_call(a), span("result", 0.05, span("wait", 0.05)), async_call(b)]
    ctx = {"spans": calls}
    assert geometry_device_ms.read(ctx) == pytest.approx((sum(a[:7]) + sum(b[:7])) / 2)
    assert fine_device_ms.read(ctx) == pytest.approx(3.0)
    assert resolve_ms.read(ctx) is None and upload_ms.read(ctx) is None


def test_portbench_a_retried_call_reads_its_last_frame():
    """A call that rendered twice has two enqueue spans: the frame it
    returned is the last."""
    call = async_call([1.0] * 8)
    call.children.insert(2, span("flags", 0.0))
    call.children.insert(3, span("enqueue", 0.001, device([2.0] * 8)))
    ctx = {"spans": [call]}
    assert geometry_device_ms.read(ctx) == pytest.approx(14.0)
    assert fine_device_ms.read(ctx) == pytest.approx(2.0)


def test_portbench_host_half_readers_take_the_mean_of_the_frames():
    ctx = {"spans": [pan_call(12.0, 1.0, 6.0), pan_call(14.0, 1.0, 8.0),
                     span("render_surface", 0.09, span("prepare", 0.0))]}
    assert resolve_ms.read(ctx) == pytest.approx(13.0)
    assert upload_ms.read(ctx) == pytest.approx(7.0)
    assert geometry_device_ms.read(ctx) == pytest.approx(7.0)


@pytest.mark.parametrize("spans", [None, [], [span("render_surface", 0.1, span("prepare", 0.02),
                                                   span("enqueue", 0.01), span("read", 0.001))]],
                         ids=["untraced", "no frame", "a program without the spans"])
def test_portbench_span_readers_read_nothing_where_there_is_nothing(spans):
    for reader in READERS:
        assert reader.read({"spans": spans}) is None
