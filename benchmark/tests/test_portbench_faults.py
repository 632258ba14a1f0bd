"""`correct` comes out false: for the control (the reference one
precision down in the program's place) at tiny sizes, and for a run whose
timed path is broken underneath in each way the cells can be: a pixel
altered where it is produced, half of the draws left out, a frame that
returns the previous frame's state. (One chip: no exchange between chips
to leave out.)"""

import numpy as np
import pytest

import jello_tpu_torch.cuda.render as render_mod
import jello_tpu_torch.scene as scene_mod
from jello_tpu_torch.cuda import Renderer
from portbench import compare, harness, spec
from portbench.traffic import view_transform

SEED = 2 ** 31 + 3


@pytest.mark.parametrize("cell", ["tiny_tiger_text.static", "tiny_clip_layers.static",
                                  "tiny_tiger_text.pan"])
def test_portbench_control_fails(tiny, cell):
    bench_dir, bench = tiny
    w = spec.workload(bench, cell)
    cfg, gen = spec.config(w["config"], bench_dir)
    mix = spec.traffic(w["traffic"], bench_dir)
    cmds = gen.commands(cfg, SEED)
    ref = compare.Reference(bench_dir, cmds, "cpu")
    samples = []
    for i in range(mix["sample_frames"]):
        t = (view_transform(mix["motion"], i)
             if mix["scene"] == "append" else None)
        samples.append((i, t, ref.frame(t, low_precision=True)))
    readings = compare.readings(samples, ref)
    assert not compare.passed(compare.checks(0, *readings, cfg["limits"])), readings
    # The reference against itself reads nothing.
    same = [(i, t, ref.frame(t)) for i, t, _ in samples]
    assert compare.readings(same, ref) == (0, 0.0)


def _altered_present(orig):
    def present(img, premul=True, srgb=True):
        out = orig(img, premul, srgb).clone()
        out[:4, :4, :3] ^= 0x40
        return out
    return present


def _half_the_fills(orig):
    count = [0]

    def fill(self, *args, **kwargs):
        count[0] += 1
        if count[0] % 2 == 0:
            return None
        return orig(self, *args, **kwargs)
    return fill


def _stale_frames(orig):
    last = {}

    def render_surface(self, scene, params, **kwargs):
        # A copy: on the CPU the pixels are a view of the present
        # program's output, which the next frame overwrites.
        pixels = orig(self, scene, params, **kwargs).copy()
        out = last.get(id(self), pixels)
        last[id(self)] = pixels
        return out
    return render_surface


FAULTS = {
    "pixel_altered": (render_mod, "present", _altered_present, "tiny_tiger_text.static"),
    "half_the_draws": (scene_mod.Scene, "fill", _half_the_fills, "tiny_clip_layers.static"),
    "stale_frame": (Renderer, "render_surface", _stale_frames, "tiny_tiger_text.pan"),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_portbench_broken_timed_path_is_not_correct(tiny, monkeypatch, fault):
    bench_dir, _ = tiny
    owner, name, make, cell = FAULTS[fault]
    sound, _ = harness.run_cell(cell, SEED, 0.3, False, "cpu", bench_dir=bench_dir)
    assert sound["correct"] is True
    monkeypatch.setattr(owner, name, make(getattr(owner, name)))
    broken, lines = harness.run_cell(cell, SEED, 0.3, False, "cpu", bench_dir=bench_dir)
    assert broken["correct"] is False, lines
    assert np.isfinite(broken["checks"]["max_u8_diff"]["value"])
