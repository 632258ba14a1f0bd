"""The benchmark's `motionmark_paths` configuration (MotionMark's Paths
test: a walk on an 80 x 40 grid stroked as line, quadratic and cubic
segments, bevel joins and butt caps) at a small size on the CPU: the
program (`Renderer(device="cpu")`) against the benchmark's reference
(`benchmark/reference/`), under each stroke style, unmoved and panned; the
generator's walk, widths, splits and seeds; and the counts a profiled
call carries of the frame it returned (`cuda/render.py::frame_counts`).

The generator, the benchmark's draw-command builder and the reference are
loaded by path, as the benchmark loads them."""

import importlib
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jello_tpu_torch as jt
from jello_tpu_torch.cuda import Renderer
from jello_tpu_torch.profiler import Profiler

BENCH = Path(__file__).resolve().parent.parent / "benchmark"
# The reference package's name while loaded (`portbench/compare.py`).
REF_NAME = "portbench_reference"
# A small stage: about 4 x 4 px a grid cell, strokes up to 21 px wide.
SMALL = {"width": 320, "height": 160, "n_elements": 400}
STYLES = [("bevel", "butt"), ("miter", "square"), ("round", "round")]
PAN = (1.0, 0.0, 0.0, 1.0, 37.25, -21.5)


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


gen = _load(BENCH / "configs" / "motionmark_paths.py", "motionmark_paths_generator")
commands = _load(BENCH / "portbench" / "commands.py", "motionmark_paths_commands")
CFG = json.loads((BENCH / "configs" / "motionmark_paths.json").read_text())


def reference():
    """The benchmark's reference package, loaded as `compare.reference`
    loads it."""
    if REF_NAME not in sys.modules:
        path = BENCH / "reference"
        spec = importlib.util.spec_from_file_location(
            REF_NAME, path / "__init__.py", submodule_search_locations=[str(path)])
        module = importlib.util.module_from_spec(spec)
        sys.modules[REF_NAME] = module
        spec.loader.exec_module(module)
        importlib.import_module(REF_NAME + ".frame")
    return sys.modules[REF_NAME]


def small(**kw):
    return {**CFG, **SMALL, **kw}


def scene_of(api, cmds, transform):
    scene = commands.build(api, cmds)
    if transform is None:
        return scene
    panned = api.Scene()
    panned.append(scene, api.Affine(transform))
    return panned


@pytest.mark.parametrize("transform", [None, PAN], ids=["still", "panned"])
@pytest.mark.parametrize("join,cap", STYLES, ids=["-".join(s) for s in STYLES])
def test_torch_motionmark_matches_the_benchmark_reference(join, cap, transform):
    torch.set_num_threads(2)
    cmds = gen.commands(small(join=join, cap=cap), 2 ** 33 + 3)
    r = Renderer(device="cpu")
    got = r.render_surface(scene_of(jt, cmds, transform), commands.params(jt, cmds))
    ref = reference()
    want = ref.frame.render_u8(scene_of(ref, cmds, transform), commands.params(ref, cmds), "cpu")
    assert got.shape == want.shape == (160, 320, 4) and got.dtype == np.uint8
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert d.max() <= 1 and not (d >= 2).any()
    # The strokes cover a good part of the stage, in more than one color.
    assert (got[..., :3] < 250).any(-1).mean() > 0.15
    assert r.last_stats["simple_lines"] > 0
    assert (r.last_stats["arc_lines"] > 0) == (join == "round")


def test_torch_motionmark_seeds_change_only_the_colors():
    a, b = gen.commands(small(), 7), gen.commands(small(), 2 ** 31 + 11)
    assert len(a["draws"]) == len(b["draws"]) > 1
    colors = set()
    for da, db in zip(a["draws"], b["draws"]):
        assert da[0] == db[0] == "stroke"
        assert da[1] == db[1] and da[1]["join"] == "bevel" and da[1]["cap"] == "butt"
        assert da[2] is db[2] is None and da[4] == db[4]
        colors.add(da[3] != db[3])
    assert colors == {True, False}
    assert gen.commands(small(), 7) == a


def test_torch_motionmark_walk_keeps_to_the_grid_and_the_offsets():
    cfg = small(n_elements=5000)
    el = gen.elements(cfg)
    pts, hi = el["points"], np.asarray(cfg["grid"])
    assert tuple(pts[0]) == tuple(cfg["start"])
    assert (pts >= 0).all() and (pts <= hi).all()
    offsets = {tuple(o) for o in cfg["offsets"]}
    for p, q in zip(pts[:-1].tolist(), pts[1:].tolist()):
        step = (q[0] - p[0], q[1] - p[1])
        # Each axis either takes an offset or, where the offset would leave
        # the grid on that axis, its negation.
        assert any(all(s == o or (s == -o and not 0 <= p[a] + o <= hi[a])
                       for a, (s, o) in enumerate(zip(step, off))) for off in offsets)
    assert len(pts) == el["ends"][-1] + 1
    assert set(el["kinds"].tolist()) == {"line", "quad", "cubic"}
    assert 0.45 < (el["kinds"] == "line").mean() < 0.55
    assert (el["widths"] >= 1.0).all() and (el["widths"] <= 21.0).all()
    assert 0.45 < el["splits"].mean() < 0.55


def test_torch_motionmark_paths_follow_the_walk():
    """A path starts at the previous element's end; a quadratic is a cubic
    whose controls lie 2/3 of the way to its control point; the palette
    is the three greys and three accents."""
    cfg = small()
    el, cmds = gen.elements(cfg), gen.commands(cfg, 5)
    gx, gy = cfg["width"] / 81, cfg["height"] / 41
    xy = [((i + 0.5) * gx, (j + 0.5) * gy) for i, j in el["points"].tolist()]
    segs = [s for d in cmds["draws"] for s in d[4][1:]]
    assert len(segs) == cfg["n_elements"]
    assert len(cmds["draws"]) == 1 + int(el["splits"][1:].sum())
    starts = [tuple(d[4][0][1:]) for d in cmds["draws"]]
    firsts = [0] + [k for k in range(1, cfg["n_elements"]) if el["splits"][k]]
    assert starts == [xy[int(el["ends"][k]) - gen.STEPS[el["kinds"][k]]] for k in firsts]
    k = int(np.flatnonzero(el["kinds"] == "quad")[0])
    (x0, y0), (x1, y1), (x2, y2) = xy[int(el["ends"][k]) - 2:int(el["ends"][k]) + 1]
    assert segs[k] == pytest.approx(("C", x0 + 2 / 3 * (x1 - x0), y0 + 2 / 3 * (y1 - y0),
                                     x2 + 2 / 3 * (x1 - x2), y2 + 2 / 3 * (y1 - y2), x2, y2))
    palette = {gen._rgba(c) for c in cfg["colors"][:3] + cfg["accents"]}
    assert {d[3][1] for d in cmds["draws"]} == palette


def test_torch_motionmark_configuration_is_the_deployment():
    assert (CFG["width"], CFG["height"], CFG["n_elements"]) == (1600, 800, 100000)
    assert (CFG["join"], CFG["cap"], CFG["antialiasing"]) == ("bevel", "butt", "area")
    assert CFG["reduced"] == [] and CFG["limits"] == {"max_u8_diff": 16, "px_off_ppm": 100}
    assert CFG["grid"] == [80, 40] and CFG["start"] == [40, 20]
    assert sorted(map(tuple, CFG["offsets"])) == [(-4, 0), (1, -2), (1, 2), (2, 0)]


def test_torch_call_counts_are_the_frames_stats():
    """A checked call and a call in flight each carry `lines`, `cmds` and
    `max_tile_cmds` of the frame it returned; a `result` group carries
    none."""
    torch.set_num_threads(2)
    cmds = gen.commands(small(n_elements=120), 9)
    scene, params = commands.build(jt, cmds), commands.params(jt, cmds)
    r = Renderer(device="cpu")
    r.profiler = Profiler()
    r.render_surface(scene, params)
    stats = r.last_stats
    want = {"lines": stats["euler_lines"] + stats["simple_lines"] + stats["arc_lines"],
            "cmds": stats["cmds"], "max_tile_cmds": stats["max_cmds"]}
    assert want["lines"] > 0 and want["cmds"] >= want["max_tile_cmds"] > 1
    frames = [r.render_surface_async(scene, params) for _ in range(3)]
    assert r.last_stats is None
    for f in frames:
        f.result()
    calls = r.profiler.collect()
    assert [c.label for c in calls] == ["render_surface"] + ["render_surface_async"] * 3 + [
        "result"] * 3
    for c in calls[:4]:
        assert {k: c.counts[k] for k in want} == want
    assert all(not set(want) & set(c.counts) for c in calls[4:])
