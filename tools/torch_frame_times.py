#!/usr/bin/env python3
"""Steady-state frame times of the jello_tpu_torch port on one NVIDIA GPU.

    python3 tools/torch_frame_times.py [--configs 1,3,4,5] [--modes area,msaa8]
                                       [--frames 8] [--tag NAME] [--kernel-a]

Run from the root of a checkout: it renders the gate scenes of the
`jello_tpu_torch` package it finds there (so the same script times two
trees in one call: unpack the other tree into a directory, copy or point
at this script, and run it from there) through
`Renderer(device="cuda").render_device`, and prints for each config and
antialiasing mode the median, minimum and maximum host ms a frame over
`--frames` frames that each end in `torch.cuda.synchronize()`, after two
warm-up frames, and the card's name and power limit. A tree that cannot
render a mode (a frame that raises NotImplementedError) says so and goes
on. Exits non-zero without a GPU. Config 2 takes half a minute to build
and is left out unless asked for.

With --kernel-a it first times kernel A (`cuda.coverage.coverage_rows`)
on config 5's coverage inputs in each of its three modes (CUDA-event
mean of 20 calls after one warm-up) and prints a SHA-256 of each mode's
rows, so that two trees' rows can be compared bit for bit.
"""

import argparse
import dataclasses
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.getcwd())


def main():
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--configs", default="1,3,4,5")
    ap.add_argument("--modes", default="area")
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--kernel-a", action="store_true",
                    help="also time kernel A's three modes on config 5's coverage inputs")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False")
        return 1
    import jello_tpu_torch as jt
    from jello_tpu_torch.cuda import Renderer
    from jello_tpu_torch.scenes import GATE_SCENES

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"{opts.tag}: package {os.path.dirname(jt.__file__)}, on {smi}")
    if opts.kernel_a:
        kernel_a_times(opts.tag, smi)
    r = Renderer(device="cuda")
    for k in (int(v) for v in opts.configs.split(",")):
        scene, params = GATE_SCENES[k]()
        for mode in opts.modes.split(","):
            p = dataclasses.replace(params, antialiasing_method=jt.AaConfig(mode))
            try:
                for _ in range(2):
                    r.render_device(scene, p)
            except NotImplementedError as e:
                print(f"{opts.tag}: config{k} {mode}: not rendered ({e})")
                continue
            torch.cuda.synchronize()
            times = []
            for _ in range(opts.frames):
                t = time.perf_counter()
                r.render_device(scene, p)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t) * 1e3)
            print(f"{opts.tag}: config{k} {mode}: render_device {statistics.median(times):.3f} "
                  f"ms/frame median of {opts.frames} (min {min(times):.3f}, max "
                  f"{max(times):.3f}), on {smi}")
    return 0


def kernel_a_times(tag, smi):
    """Kernel A's area, msaa8 and msaa16 modes on config 5's coverage
    inputs: mean ms of 20 calls (CUDA events) and a digest of the rows."""
    import hashlib

    import torch
    from jello_tpu_torch.cuda import Renderer
    from jello_tpu_torch.cuda.coverage import coverage_rows
    from jello_tpu_torch.cuda.render import frame_routing
    from jello_tpu_torch.pipeline import coverage as cov
    from jello_tpu_torch.pipeline.render import geometry
    from jello_tpu_torch.scenes import GATE_SCENES

    scene, params = GATE_SCENES[5]()
    r = Renderer(device="cuda")
    r.render(scene, params)
    _, _, (scene_t, layout_t, _, atlas_t), _ = r._prepare(scene, params)
    caps = dict(r._caps, **frame_routing(0, atlas_t is not None, 0))
    stages = geometry(scene_t, layout_t, caps)[0]
    stream, rs, re_, bd, eo, _, _ = cov.slot_rank_rows(stages["cmds"], stages["counted"],
                                                       dict(caps, aa_mode="msaa8"))
    for mode in ("area", "msaa8", "msaa16"):
        offsets = cov.sample_offsets(mode)
        args = (stream, rs, re_, bd) + ((offsets, eo) if offsets else ())
        rows = coverage_rows(*args)
        torch.cuda.synchronize()
        digest = hashlib.sha256(rows.cpu().numpy().tobytes()).hexdigest()[:16]
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(20):
            coverage_rows(*args)
        t1.record()
        torch.cuda.synchronize()
        print(f"{tag}: kernel A, {mode}, config 5's {int((re_ - rs).clamp(min=0).sum())} "
              f"segments in {int((re_ > rs).sum())} rows: {t0.elapsed_time(t1) / 20:.4f} ms "
              f"(mean of 20), rows sha256 {digest}, on {smi}")


if __name__ == "__main__":
    sys.exit(main())
