"""The benchmark's `bunnymark` configuration (PixiJS's bunny-mark: transparent
26x37 image sprites bouncing under gravity) at a small size on the CPU: the
program (`Renderer(device="cpu")`) against the benchmark's reference
(`benchmark/reference/`), unmoved and under a fractional pan, on two seeds;
the generator's physics and seeds; the image-tap table grown to the
frame's image records in one retry; the `img_recs` count a profiled call
carries; and the stage clock's `image_tap` span inside `fine`, with a host
counter in place of the card's clock here and on the card.

The generator, the benchmark's draw-command builder and the reference are
loaded by path, as the benchmark loads them (`test_torch_motionmark`'s
loaders)."""

import json

import numpy as np
import pytest
import torch

import jello_tpu_torch as jt
from jello_tpu_torch import profiler as tp
from jello_tpu_torch.cuda import Renderer
from jello_tpu_torch.cuda import render as render_mod
from jello_tpu_torch.pipeline.image_tap import IMG_RECS_CAP_DEFAULT
from jello_tpu_torch.pipeline.render import STAGES

from .test_torch_motionmark import BENCH, PAN, _load, commands, reference, scene_of
from .test_torch_stage_clock import cuda, host_clock  # noqa: F401  (fixtures)

# A small stage: 20 x 10 tiles, each sprite on about 9 of them.
SMALL = {"width": 320, "height": 160, "n_sprites": 400}
SEEDS = [2 ** 33 + 3, 17]

gen = _load(BENCH / "configs" / "bunnymark.py", "bunnymark_generator")
CFG = json.loads((BENCH / "configs" / "bunnymark.json").read_text())


def small(**kw):
    return {**CFG, **SMALL, **kw}


@pytest.mark.parametrize("transform", [None, PAN], ids=["still", "panned"])
@pytest.mark.parametrize("seed", SEEDS)
def test_torch_bunnymark_matches_the_benchmark_reference(seed, transform):
    torch.set_num_threads(2)
    cmds = gen.commands(small(), seed)
    r = Renderer(device="cpu")
    got = r.render_surface(scene_of(jt, cmds, transform), commands.params(jt, cmds))
    ref = reference()
    want = ref.frame.render_u8(scene_of(ref, cmds, transform), commands.params(ref, cmds), "cpu")
    assert got.shape == want.shape == (160, 320, 4) and got.dtype == np.uint8
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert d.max() <= 1 and not (d >= 2).any()
    # The sprites cover most of the stage, in the textures' colors.
    assert (got[..., :3] < 250).any(-1).mean() > 0.5
    assert r.last_stats["img_recs"] > IMG_RECS_CAP_DEFAULT
    assert not any(r.last_flags.values())


@pytest.mark.parametrize("cfg", [small(n_sprites=3000), CFG], ids=["small", "deployment"])
def test_torch_bunnymark_anchors_stay_on_the_stage(cfg):
    pos = gen.positions(cfg)
    assert pos.shape == (cfg["n_sprites"], 2)
    assert (pos >= 0).all() and (pos[:, 0] <= cfg["width"]).all()
    assert (pos[:, 1] <= cfg["height"]).all()
    assert len(np.unique(pos, axis=0)) == len(pos)
    if cfg is CFG:
        # Gravity piles them up: most anchors lie in the stage's lowest third.
        assert (pos[:, 1] > cfg["height"] * 2 / 3).mean() > 0.6
    else:
        assert np.array_equal(gen.positions(cfg), pos)


def test_torch_bunnymark_seeds_change_only_the_textures():
    cfg = small()
    a, b = gen.commands(cfg, 7), gen.commands(cfg, 2 ** 31 + 11)
    assert len(a["draws"]) == len(b["draws"]) == cfg["n_sprites"]
    w, h = cfg["sprite_px"]
    picks = set()
    for da, db in zip(a["draws"], b["draws"]):
        assert da[0] == db[0] == "fill" and da[1] == db[1] == "nonzero"
        assert da[2] == db[2] and da[4] == db[4]
        assert da[2][:4] == (1.0, 0.0, 0.0, 1.0)
        assert da[4][1] == ("L", float(w), 0.0) and da[4][2] == ("L", float(w), float(h))
        assert da[3][0] == db[3][0] == "image"
        picks.add(da[3][1])
        picks.add(db[3][1])
    assert picks == set(range(cfg["textures"]))
    assert [da[3] for da in a["draws"]] != [db[3] for db in b["draws"]]
    assert len(a["images"]) == len(b["images"]) == cfg["textures"]
    for ia, ib in zip(a["images"], b["images"]):
        assert ia.shape == ib.shape == (h, w, 4) and ia.dtype == np.uint8
        assert not np.array_equal(ia, ib)
    # Each texture is a silhouette on a transparent ground with soft edges.
    alpha = a["images"][0][..., 3]
    assert alpha[0, 0] == alpha[-1, 0] == alpha[0, -1] == 0 and alpha.max() == 255
    assert ((alpha > 0) & (alpha < 255)).any()
    assert gen.commands(cfg, 7)["draws"] == a["draws"]


def test_torch_bunnymark_configuration_is_the_deployment():
    assert (CFG["width"], CFG["height"], CFG["n_sprites"]) == (1920, 1080, 100000)
    assert CFG["sprite_px"] == [26, 37] and CFG["textures"] == 5
    assert (CFG["add_per_frame"], CFG["settle_frames"]) == (100, 600)
    assert CFG["physics"] == {"speed_x_max": 10.0, "speed_y_max": 5.0, "gravity": 0.5,
                              "bounce": 0.85, "kick_p": 0.5, "kick_max": 6.0}
    assert CFG["reduced"] == [] and CFG["limits"] == {"max_u8_diff": 16, "px_off_ppm": 100}
    assert CFG["antialiasing"] == "area" and CFG["base_color"] == [1.0, 1.0, 1.0, 1.0]


def test_torch_bunnymark_image_table_grows_to_the_frame_in_one_retry():
    """A frame of ~13,000 image records, from the default table of 1,024:
    one `img_recs_overflow` retry grows the table to the frame's records
    (doubling would take four), and the frame renders clean in one call
    at the default `max_retries`."""
    torch.set_num_threads(2)
    cmds = gen.commands(small(n_sprites=1500), 5)
    r = Renderer(device="cpu")
    r.render_surface(commands.build(jt, cmds), commands.params(jt, cmds))
    need = r.last_stats["img_recs"]
    assert need > 8 * IMG_RECS_CAP_DEFAULT
    assert sum("img_recs_overflow" in k for k in r.last_retries) == 1
    assert not any(r.last_flags.values()) and r._caps["img_recs_cap"] >= need


def test_torch_bunnymark_grow_caps_takes_the_frames_image_records():
    from jello_tpu_torch.renderer.estimate import grow_caps

    caps = {"img_recs_cap": 1024, "euler_line_cap": 8, "simple_line_cap": 8,
            "arc_line_cap": 8, "tiles_cap": 64}
    flags = {"img_recs_overflow": True}
    assert grow_caps(caps, flags)["img_recs_cap"] == 2048
    grown = grow_caps(caps, flags, {"img_recs": 870_000})
    assert grown["img_recs_cap"] == -(-(int(870_000 * 1.15) + 1) // 256) * 256
    assert grown["tiles_cap"] == 64 and grown["line_cap"] == 24
    # The stat grows only the flagged table, and never shrinks it.
    assert grow_caps(caps, {"tiles_overflow": True}, {"img_recs": 10 ** 6})["img_recs_cap"] \
        == 1024
    assert grow_caps(dict(caps, img_recs_cap=4096), flags, {"img_recs": 10})["img_recs_cap"] \
        == 8192


def test_torch_bunnymark_call_counts_carry_the_image_records():
    """A checked call and a call in flight each carry `img_recs` of the
    frame it returned, the frame's stat."""
    torch.set_num_threads(2)
    cmds = gen.commands(small(n_sprites=120), 9)
    scene, params = commands.build(jt, cmds), commands.params(jt, cmds)
    r = Renderer(device="cpu")
    r.profiler = tp.Profiler()
    r.render_surface(scene, params)
    want = r.last_stats["img_recs"]
    assert want > 120 and render_mod.frame_counts(r.last_stats)["img_recs"] == want
    frames = [r.render_surface_async(scene, params) for _ in range(2)]
    for f in frames:
        f.result()
    calls = r.profiler.collect()
    assert [c.counts["img_recs"] for c in calls[:3]] == [want] * 3
    assert all("img_recs" not in c.counts for c in calls[3:])


def _tap_inside_fine(call):
    dev = [d for e in call.children if e.label == "enqueue" for d in e.children
           if d.label == "device"][-1]
    assert [c.label for c in dev.children] == list(STAGES)
    fine = dev.children[-1]
    (tap,) = fine.children
    assert tap.label == "image_tap" and tap.duration > 0
    assert fine.start <= tap.start and tap.start + tap.duration <= fine.start + fine.duration
    return dev, fine, tap


def test_torch_bunnymark_stage_clock_nests_the_image_tap_in_fine(host_clock):
    """A frame that runs the tap stamps its entry and exit inside fine's
    (slots 9 and 10, between fine's entry and exit); the `device` span's
    stages keep their times, and fine's still spans the tap; a frame with
    no image stamps the nine as before."""
    torch.set_num_threads(2)
    cmds = gen.commands(small(n_sprites=60), 3)
    scene, params = commands.build(jt, cmds), commands.params(jt, cmds)
    r = Renderer(device="cpu")
    r.profiler = tp.Profiler()
    r.render_surface(scene, params)
    n = len(STAGES) + 3
    frame = list(range(len(STAGES))) + [n - 2, n - 1, len(STAGES)]
    assert len(host_clock) % n == 0 and host_clock == frame * (len(host_clock) // n)
    assert list(r.last_stage_ms) == list(STAGES)
    dev, fine, tap = _tap_inside_fine(r.profiler.collect()[0])
    assert fine.start < tap.start and tap.start + tap.duration < fine.start + fine.duration
    assert r.last_stage_ms["fine"] == pytest.approx(fine.duration * 1e3)
    assert dev.duration == pytest.approx(sum(c.duration for c in dev.children))

    del host_clock[:]
    plain = jt.Scene()
    plain.fill(jt.Fill.NON_ZERO, jt.Affine.identity(), jt.SolidBrush(jt.Color.rgba(1, 0, 0, 1)),
               None, jt.BezPath().move_to(4, 4).line_to(60, 8).line_to(20, 50).close())
    Renderer(device="cpu").render_surface(plain, params)
    assert host_clock == list(range(len(STAGES) + 1)) * (len(host_clock) // (len(STAGES) + 1))


@pytest.mark.cuda
def test_torch_bunnymark_image_tap_span_on_the_card(cuda):
    """On the card, a checked frame and two replayed frames in flight:
    the `image_tap` span lies inside `fine`, its two stamps in order."""
    cmds = gen.commands(small(n_sprites=2000), 11)
    scene, params = commands.build(jt, cmds), commands.params(jt, cmds)
    r = Renderer(device="cuda")
    for _ in range(3):
        r.render_surface(scene, params)
    assert r._program is not None
    r.profiler = tp.Profiler()
    r.render_surface(scene, params)
    frames = [r.render_surface_async(scene, params) for _ in range(2)]
    for f in frames:
        f.result()
    calls = [c for c in r.profiler.collect() if c.label != "result"]
    assert len(calls) == 3
    for call in calls:
        _, _, tap = _tap_inside_fine(call)
        assert call.counts["img_recs"] > 0 and tap.duration < 1.0
