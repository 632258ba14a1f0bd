"""The readers of the Suits cell's per-layer metrics (`fine_ns_per_grad_rec`,
`clip_leaf_ns_per_clip`) on made-up span trees shaped as
`Renderer.profiler`'s `collect()` gives them: each traced call's `fine` or
`clip_leaf` span over the call's `grad_recs` or `clips`, summed over the
calls, and nothing from a call that lacks the count (a program that puts
none on its calls, or a frame with no gradient or clip) or the span."""

from types import SimpleNamespace

import pytest

from metrics import clip_leaf_ns_per_clip, fine_ns_per_grad_rec

STAGES = ("flatten", "draw_leaf", "clip_leaf", "tile_alloc", "path_count", "path_tiling",
          "coarse", "fine")
READERS = {fine_ns_per_grad_rec: ("fine", "grad_recs"),
           clip_leaf_ns_per_clip: ("clip_leaf", "clips")}


def span(label, duration, *children, counts=None):
    return SimpleNamespace(label=label, start=0.0, duration=duration, children=list(children),
                           counts=counts or {})


def device(ms):
    """A `device` span of stage times in ms (`STAGES` order)."""
    return span("device", sum(ms) / 1e3, *(span(s, m / 1e3) for s, m in zip(STAGES, ms)))


def call(ms, grad_recs, clips, label="render_surface_async", stages=True):
    counts = {"replayed": 1, "retries": 0, "lines": 10, "cmds": 100, "max_tile_cmds": 4,
              "img_recs": 0}
    for k, v in (("grad_recs", grad_recs), ("clips", clips)):
        if v is not None:
            counts[k] = v
    enqueue = span("enqueue", 0.001, device(ms)) if stages else span("enqueue", 0.001)
    return span(label, 0.002, span("prepare", 0.0), enqueue, span("copy", 0.0),
                counts=counts)


def test_portbench_suits_readers_sum_the_calls():
    a = [1.0, 0.5, 0.25, 1.0, 1.0, 1.0, 2.0, 6.0]
    b = [1.0, 0.5, 0.75, 1.0, 1.0, 1.0, 2.0, 10.0]
    ctx = {"spans": [call(a, 500_000, 20_000), span("result", 0.05, span("wait", 0.05)),
                     call(b, 500_000, 20_000)]}
    assert fine_ns_per_grad_rec.read(ctx) == pytest.approx(16e6 / 1e6)
    assert clip_leaf_ns_per_clip.read(ctx) == pytest.approx(1e6 / 40_000)


def test_portbench_suits_readers_read_a_calls_last_frame():
    """A call that rendered twice has two enqueue spans: its counts are of
    the frame it returned, the last."""
    c = call([2.0] * 8, 1000, 80, label="render_surface")
    c.children.insert(1, span("enqueue", 0.001, device([9.0] * 8)))
    ctx = {"spans": [c]}
    assert fine_ns_per_grad_rec.read(ctx) == pytest.approx(2e6 / 1000)
    assert clip_leaf_ns_per_clip.read(ctx) == pytest.approx(2e6 / 80)


@pytest.mark.parametrize("reader", list(READERS), ids=lambda r: r.__name__.split(".")[-1])
def test_portbench_suits_readers_pass_over_a_call_without_the_count(reader):
    """A call without its count (the parent's calls), or with a count of 0
    (a frame with no clip), adds nothing; the other calls still read."""
    ms = [1.0, 1.0, 3.0, 1.0, 1.0, 1.0, 1.0, 5.0]
    stage, _ = READERS[reader]
    got = reader.read({"spans": [call(ms, None, None), call(ms, 0, 0), call(ms, 400, 30)]})
    n = 400 if reader is fine_ns_per_grad_rec else 30
    assert got == pytest.approx(ms[STAGES.index(stage)] * 1e6 / n)
    assert reader.read({"spans": [call(ms, None, None), call(ms, 0, 0)]}) is None


@pytest.mark.parametrize("spans", [
    None, [],
    [call([1.0] * 8, None, None)],
    [call([1.0] * 8, 0, 0), span("result", 0.05, span("wait", 0.05))],
    [call([1.0] * 8, 1000, 50, stages=False)],
    [SimpleNamespace(label="render_surface_async", start=0.0, duration=0.1, children=[
        span("enqueue", 0.001, device([1.0] * 8))])],
], ids=["untraced", "no frame", "a call without the counts", "no gradient or clip",
        "a call without the stage span", "a call with no counts attribute"])
def test_portbench_suits_readers_read_nothing_where_there_is_nothing(spans):
    for reader in READERS:
        assert reader.read({"spans": spans}) is None
