"""The readers of a stage's device time per unit of work
(`flatten_ns_per_line`, `fine_ns_per_cmd`) on made-up span trees shaped as
`Renderer.profiler`'s `collect()` gives them: each traced call's stage span
over the count the call carries, and nothing from a call that lacks the
count or the span."""

from types import SimpleNamespace

import pytest

from metrics import fine_ns_per_cmd, flatten_ns_per_line

STAGES = ("flatten", "draw_leaf", "clip_leaf", "tile_alloc", "path_count", "path_tiling",
          "coarse", "fine")
READERS = (flatten_ns_per_line, fine_ns_per_cmd)


def span(label, duration, *children, counts=None):
    return SimpleNamespace(label=label, start=0.0, duration=duration, children=list(children),
                           counts=counts or {})


def device(ms):
    """A `device` span of stage times in ms."""
    return span("device", sum(ms) / 1e3, *(span(s, m / 1e3) for s, m in zip(STAGES, ms)))


def call(ms, counts, label="render_surface_async"):
    return span(label, 0.002, span("prepare", 0.0), span("enqueue", 0.001, device(ms)),
                span("present", 0.0), span("copy", 0.0), counts=counts)


def counts(lines, cmds):
    return {"replayed": 1, "retries": 0, "upload_bytes": 0, "uploads_skipped": 0,
            "lines": lines, "cmds": cmds, "max_tile_cmds": 40}


def test_portbench_stage_per_count_sums_the_calls():
    a = [4.0, 1.0, 0.5, 2.0, 3.0, 4.0, 6.0, 2.0]
    b = [6.0, 1.0, 0.5, 2.0, 3.0, 4.0, 6.0, 4.0]
    ctx = {"spans": [call(a, counts(1_000_000, 200_000)),
                     span("result", 0.05, span("wait", 0.05)),
                     call(b, counts(1_000_000, 200_000))]}
    assert flatten_ns_per_line.read(ctx) == pytest.approx(10e6 / 2e6)
    assert fine_ns_per_cmd.read(ctx) == pytest.approx(6e6 / 4e5)


def test_portbench_stage_per_count_reads_a_calls_last_frame():
    """A call that rendered twice has two enqueue spans: its counts are of
    the frame it returned, the last."""
    c = call([9.0] * 8, counts(500, 100), label="render_surface")
    c.children.insert(2, span("flags", 0.0))
    c.children.insert(3, span("enqueue", 0.001, device([1.0] * 8)))
    ctx = {"spans": [c]}
    assert flatten_ns_per_line.read(ctx) == pytest.approx(1e6 / 500)
    assert fine_ns_per_cmd.read(ctx) == pytest.approx(1e6 / 100)


def test_portbench_stage_per_count_passes_over_a_call_without_both():
    ms = [2.0] * 8
    no_device = span("render_surface", 0.1, span("prepare", 0.0), span("enqueue", 0.01),
                     counts=counts(7, 7))
    ctx = {"spans": [call(ms, {"replayed": 1}), no_device, call(ms, counts(4000, 1000))]}
    assert flatten_ns_per_line.read(ctx) == pytest.approx(2e6 / 4000)
    assert fine_ns_per_cmd.read(ctx) == pytest.approx(2e6 / 1000)


@pytest.mark.parametrize("spans", [
    None, [],
    [call([1.0] * 8, {"replayed": 1, "retries": 0, "upload_bytes": 0, "uploads_skipped": 0})],
    [call([1.0] * 8, {}), span("result", 0.05, span("wait", 0.05))],
    [span("render_surface", 0.1, span("prepare", 0.02), span("enqueue", 0.01),
          span("read", 0.001), counts=counts(100, 10))],
    [SimpleNamespace(label="render_surface_async", start=0.0, duration=0.1, children=[
        span("enqueue", 0.001, device([1.0] * 8))])],
], ids=["untraced", "no frame", "a call without the counts", "counts of none",
        "a call without the stage span", "a call with no counts attribute"])
def test_portbench_stage_per_count_reads_nothing_where_there_is_nothing(spans):
    for reader in READERS:
        assert reader.read({"spans": spans}) is None
