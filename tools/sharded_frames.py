#!/usr/bin/env python3
"""Sharded frames of the gate scenes at full size, one rank a card.

    python3 tools/sharded_frames.py --world 2,4 [--backend nccl] [--configs 5,4,3]
                                    [--frames 8] [--device cuda] [--max-retries 8]
                                    [--paths 19a,19b]

For each config: the single-card frame and its ms/frame (median of
--frames after 2 warm-ups) through `Renderer.render_device` on the first
card, its settled class, then for each world size one spawn of ranks
(`collectives.run_ranks`) that render the config through the stripes
(`cuda/sharded.py`, kernel G) and the geometry-sharded path
(`cuda/sharded2.py`, through `sharded2.RetryingRender`, which renders a
frame again with the ranks that raised a flag grown, up to --max-retries
times; 0 renders it once at `shard_caps`): each frame's max abs
difference from the single-card frame, the flags each rank raised, the
retries and what they grew, and each rank's ms/frame (host clock to an
idle card, median of --frames after 2 warm-ups, the settled frame). With
"nccl" every rank needs a card of its own. Prints every number beside
the first card's name and power limit. Exits non-zero if a frame that
raised no flag differs from the single-card frame by more than 1e-3.
"""

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

FRAME_TOL = 1e-3
WARMUP = 2


def _timed(run, frames, sync):
    """(median, min, max) ms of `frames` calls of run after WARMUP."""
    for _ in range(WARMUP):
        run()
    times = []
    for _ in range(frames):
        sync()
        t = time.perf_counter()
        run()
        sync()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times), min(times), max(times)


def _rank(group, jobs, frames):
    """One rank: each job (tag, make, inputs, caps, options) rendered once
    and timed; with `max_retries` in the options through
    `sharded2.RetryingRender`. Returns {tag: (fine_out, flags, per-rank
    flags, ms, retries or None)}."""
    import torch

    from jello_tpu_torch.cuda.render import upload, upload_atlas
    from jello_tpu_torch.cuda.sharded2 import RetryingRender

    def sync():
        if group.device.type == "cuda":
            torch.cuda.synchronize(group.device)

    out = {}
    for tag, make, inputs, caps, opts in jobs:
        scene_u32, ld, ramps, atlas, _ = inputs
        args = upload(scene_u32, ld, ramps, {}, group.device)[:3] + (
            upload_atlas(atlas, group.device),)
        retry = None
        if "max_retries" in opts:
            retry = RetryingRender(group, opts["max_retries"])
            run = lambda *a, retry=retry, caps=caps: retry(caps, *a)  # noqa: E731
        else:
            run = make(group, caps, **opts)
        res = run(*args)
        retries = None if retry is None else list(retry.last_retries)
        ms = _timed(lambda: run(*args), frames, sync)
        raised = res[2]["raised"].cpu() if len(res) > 2 else None
        out[tag] = (res[0].cpu(), {k: bool(v) for k, v in res[1].items()}, raised, ms, retries)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--world", default="2,4", help="world sizes, comma-separated")
    ap.add_argument("--backend", default="nccl", choices=("nccl", "gloo"))
    ap.add_argument("--configs", default="5,4,3")
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--max-retries", type=int, default=8)
    ap.add_argument("--paths", default="19a,19b", help="19a (stripes), 19b (geometry)")
    opts = ap.parse_args()

    import numpy as np
    import torch

    from jello_tpu_torch.cuda import collectives, sharded, sharded2
    from jello_tpu_torch.cuda.render import Renderer, assemble
    from jello_tpu_torch.scenes import GATE_SCENES

    on_card = opts.device != "cpu"
    card = "the CPU"
    if on_card:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
        print(f"{torch.cuda.device_count()} cards; the first: {card}")

    def sync():
        if on_card:
            torch.cuda.synchronize()

    worst = 0.0
    for k in [int(c) for c in opts.configs.split(",")]:
        scene, params = GATE_SCENES[k]()
        r = Renderer(device=opts.device)
        single = r.render(scene, params)
        med, lo, hi = _timed(lambda: r.render_device(scene, params), opts.frames, sync)
        print(f"config {k}: single card {med:.3f} ms/frame (min {lo:.3f}, max {hi:.3f}), on "
              f"{card}")
        inputs = sharded.frame_inputs(scene, params)
        caps = sharded.sharded_caps(r._caps, inputs)
        del r
        for n in [int(w) for w in opts.world.split(",")]:
            jobs = [(f"config{k}_19a", sharded.make_sharded_render, inputs, caps,
                     {"pallas_fine": True}),
                    (f"config{k}_19b", sharded2.make_sharded_render, inputs, caps,
                     {"max_retries": opts.max_retries} if opts.max_retries else {"report": True})]
            jobs = [j for j in jobs if j[0].split("_")[1] in opts.paths.split(",")]
            t = time.perf_counter()
            per_rank = collectives.run_ranks(_rank, n, opts.backend, opts.device,
                                             (jobs, opts.frames))
            print(f"config {k}, world size {n} over {opts.backend}: "
                  f"{time.perf_counter() - t:.1f} s with the ranks' start")
            for tag, *_ in jobs:
                outs = [pr[tag] for pr in per_rank]
                fine_out, flags, raised, _, retries = outs[0]
                err = float(np.abs(assemble(fine_out, inputs[1]).numpy() - single).max())
                by_rank = {}
                if raised is not None:
                    keys = sorted(flags)
                    by_rank = {rk: [key for key, v in zip(keys, row.tolist()) if v]
                               for rk, row in enumerate(raised) if row.any()}
                clean = not any(flags.values())
                if clean:
                    worst = max(worst, err)
                print(f"{tag}, world size {n}: max|frame diff| vs the single card "
                      f"{err:.3e}" + ("" if clean else f" (flags raised by rank {by_rank})")
                      + ("" if retries is None else f"; retries (flags, grown keys by rank, "
                                                     f"seg_ex_cap) {retries}")
                      + "; ms/frame by rank (median, min, max): " + "; ".join(
                          f"{rk}: {o[3][0]:.3f} ({o[3][1]:.3f}, {o[3][2]:.3f})"
                          for rk, o in enumerate(outs)) + f"; on {card}")
    print(f"largest difference of a clean sharded frame: {worst:.3e}")
    return 0 if worst <= FRAME_TOL else 1


if __name__ == "__main__":
    sys.exit(main())
