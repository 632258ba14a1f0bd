"""The benchmark's `motionmark_suits` configuration (MotionMark's Suits test:
rotated card suits, each filled with a gradient of its own, half of them
drawn as clip paths) at a small size on the CPU: the program
(`Renderer(device="cpu")`) against the benchmark's reference
(`benchmark/reference/`), unmoved and under a fractional pan, on two
seeds; the generator's seeds and particles; the `grad_recs` and `clips`
counts a profiled call carries, against counts made from the draw list by
the reference; and the suits' pure clip groups kept off the interpreter's
(legacy) route. On the card, the program against the reference at 2,000
particles on the full stage.

The generator, the benchmark's draw-command builder and the reference are
loaded by path, as the benchmark loads them (`test_torch_motionmark`'s
loaders)."""

import json
import math

import numpy as np
import pytest
import torch

import jello_tpu_torch as jt
from jello_tpu_torch import profiler as tp
from jello_tpu_torch.cuda import Renderer

from .test_torch_motionmark import BENCH, PAN, _load, commands, reference, scene_of
from .test_torch_stage_clock import cuda  # noqa: F401  (fixture)

# A small stage: 20 x 10 tiles, the particles 30-140 px as deployed.
SMALL = {"width": 320, "height": 160, "n_particles": 60}
SEEDS = [2 ** 33 + 3, 17]
# Gradient record kinds of the command stream (`pipeline/coarse.py`: linear,
# radial, sweep).
GRAD_KINDS = (2, 3, 4)

gen = _load(BENCH / "configs" / "motionmark_suits.py", "motionmark_suits_generator")
CFG = json.loads((BENCH / "configs" / "motionmark_suits.json").read_text())


def small(**kw):
    return {**CFG, **SMALL, **kw}


def diff(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    return np.abs(got.astype(np.int16) - want.astype(np.int16))


def reference_counts(ref, cmds, monkeypatch):
    """The reference's frame of `cmds` and, from the command stream of its
    clean frame (its geometry stages under numpy, spied on), the gradient
    records inside the tile grid."""
    streams = []
    geometry = ref.frame.geometry

    def spy(*args, **kw):
        out = geometry(*args, **kw)
        streams.append(out[0])
        return out

    monkeypatch.setattr(ref.frame, "geometry", spy)
    want = ref.frame.render_u8(commands.build(ref, cmds), commands.params(ref, cmds), "cpu")
    last = streams[-1]
    live = np.asarray(last["tile"]) < len(np.asarray(last["tile_start"]))
    grads = np.isin(np.asarray(last["kind"]), GRAD_KINDS) & live
    return want, int(grads.sum())


@pytest.mark.parametrize("transform", [None, PAN], ids=["still", "panned"])
@pytest.mark.parametrize("seed", SEEDS)
def test_torch_suits_match_the_benchmark_reference(seed, transform):
    torch.set_num_threads(2)
    cmds = gen.commands(small(), seed)
    r = Renderer(device="cpu")
    got = r.render_surface(scene_of(jt, cmds, transform), commands.params(jt, cmds))
    ref = reference()
    want = ref.frame.render_u8(scene_of(ref, cmds, transform), commands.params(ref, cmds), "cpu")
    assert got.shape == (160, 320, 4)
    d = diff(got, want)
    assert d.max() <= 1 and not (d >= 2).any()
    # The suits cover most of the stage, in many colors.
    assert (got[..., :3] < 250).any(-1).mean() > 0.5
    assert len(np.unique(got.reshape(-1, 4), axis=0)) > 1000
    assert r.last_stats["grad_recs"] > 0 and r.last_stats["img_recs"] == 0
    assert not any(r.last_flags.values())


def test_torch_suits_shape_seed_alone_fixes_the_geometry():
    """Two run seeds draw the same ops, transforms, paths, clip outlines and
    gradient geometry, and differ only in the stops; another shape seed
    moves the particles."""
    cfg = small()
    a, b = gen.commands(cfg, 7), gen.commands(cfg, 2 ** 31 + 11)
    assert [d[0] for d in a["draws"]] == [d[0] for d in b["draws"]]
    changed = 0
    for da, db in zip(a["draws"], b["draws"]):
        if da[0] != "fill":
            assert da == db
            continue
        assert da[:3] == db[:3] and da[4] == db[4]
        (ka, *geo_a, stops_a), (kb, *geo_b, stops_b) = da[3], db[3]
        assert (ka, geo_a) == (kb, geo_b) and len(stops_a) == len(stops_b)
        assert [s[0] for s in stops_a][::len(stops_a) - 1] == [0.0, 1.0]
        changed += stops_a != stops_b
    assert changed == cfg["n_particles"]
    assert gen.commands(cfg, 7) == a
    moved = gen.commands(dict(cfg, shape_seed=cfg["shape_seed"] + 1), 7)
    assert [d[2] for d in moved["draws"] if d[0] == "fill"] != \
        [d[2] for d in a["draws"] if d[0] == "fill"]


@pytest.mark.parametrize("cfg", [small(), CFG], ids=["small", "deployment"])
def test_torch_suits_particles_stay_on_the_stage(cfg):
    p = gen.particles(cfg)
    n = cfg["n_particles"]
    assert len(p["size"]) == n and p["centre"].shape == (n, 2)
    assert (p["centre"] >= 0).all() and (p["centre"][:, 0] <= cfg["width"]).all()
    assert (p["centre"][:, 1] <= cfg["height"]).all()
    assert (p["size"] >= 30).all() and (p["size"] <= 140).all()
    assert (p["angle"] >= 0).all() and (p["angle"] < 2 * math.pi).all()
    assert set(p["n_stops"].tolist()) <= {2, 3, 4}
    # Each particle's box maps into the stage with its centre at the centre.
    xf = gen.transform(float(p["size"][0]), p["centre"][0].tolist(), float(p["angle"][0]))
    (_, cx, cy), = gen.mapped([("M", 0.5, 0.5)], xf)
    assert (cx, cy) == pytest.approx(tuple(p["centre"][0]))
    if cfg is CFG:
        assert set(p["suit"].tolist()) == {0, 1, 2, 3} and set(p["kind"].tolist()) == {0, 1}
        assert 0.48 < p["clip"].mean() < 0.52 and 0.48 < p["kind"].mean() < 0.52
        assert set(p["n_stops"].tolist()) == {2, 3, 4}


def test_torch_suits_configuration_is_the_deployment():
    assert (CFG["width"], CFG["height"], CFG["n_particles"]) == (1600, 800, 20000)
    assert CFG["size_px"] == [30, 140] and CFG["stops"] == [2, 4]
    assert CFG["clip_path_share"] == 0.5 and CFG["gradient_kinds"] == ["linear", "radial"]
    assert sorted(CFG["suits"]) == ["club", "diamond", "heart", "spade"]
    assert CFG["reduced"] == [] and CFG["limits"] == {"max_u8_diff": 16, "px_off_ppm": 100}
    assert CFG["antialiasing"] == "area" and CFG["base_color"] == [1.0, 1.0, 1.0, 1.0]


def test_torch_suits_call_counts_carry_gradient_records_and_clips(monkeypatch):
    """A checked call and calls in flight each carry `grad_recs` and
    `clips` of the frame they returned: the reference's gradient records
    of the same draw list, and a BeginClip and an EndClip a clip path."""
    torch.set_num_threads(2)
    cmds = gen.commands(small(), 9)
    scene, params = commands.build(jt, cmds), commands.params(jt, cmds)
    r = Renderer(device="cpu")
    r.profiler = tp.Profiler()
    got = r.render_surface(scene, params)
    frames = [r.render_surface_async(scene, params) for _ in range(2)]
    for f in frames:
        f.result()
    want, grads = reference_counts(reference(), cmds, monkeypatch)
    assert diff(got, want).max() <= 1
    clips = 2 * sum(d[0] == "push" for d in cmds["draws"])
    assert grads > SMALL["n_particles"] and clips > 20
    calls = r.profiler.collect()
    assert [c.label for c in calls[:3]] == ["render_surface"] + ["render_surface_async"] * 2
    for c in calls[:3]:
        assert (c.counts["grad_recs"], c.counts["clips"]) == (grads, clips)
    assert all("grad_recs" not in c.counts for c in calls[3:])


@pytest.mark.parametrize("mix", ["clip", "multiply"])
def test_torch_suits_pure_clips_stay_off_the_legacy_route(mix):
    """The suits' clip paths are pure clip groups (alpha 1, src-over) at
    depth 1: every tile stays on kernel B's route. The same groups as a
    multiply blend are non-affine, and their tiles take the interpreter."""
    torch.set_num_threads(2)
    cmds = gen.commands(small(), 21)
    cmds["draws"] = [("push", mix) + d[2:] if d[0] == "push" else d for d in cmds["draws"]]
    r = Renderer(device="cpu")
    r.render_surface(commands.build(jt, cmds), commands.params(jt, cmds))
    assert r.last_stats["clips"] > 0 and not any(r.last_flags.values())
    assert (r.last_stats["legacy_tiles"] == 0) == (mix == "clip")


@pytest.mark.cuda
def test_torch_suits_match_the_reference_on_the_card(cuda):
    """2,000 particles on the 1600x800 stage: the settled frame in flight
    against the reference's frame on the card."""
    cmds = gen.commands(dict(CFG, n_particles=2000), 2 ** 33 + 5)
    scene, params = commands.build(jt, cmds), commands.params(jt, cmds)
    r = Renderer(device="cuda")
    for _ in range(3):
        got = r.render_surface_async(scene, params).result()
    assert r._program is not None and r.last_stats is None
    ref = reference()
    want = ref.frame.render_u8(commands.build(ref, cmds), commands.params(ref, cmds), "cuda")
    d = diff(got, want)
    assert d.max() <= 1 and not (d >= 2).any()
