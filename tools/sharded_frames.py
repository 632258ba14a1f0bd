#!/usr/bin/env python3
"""Sharded frames of the gate scenes at full size, one rank a card.

    python3 tools/sharded_frames.py --world 2,4 [--backend nccl] [--configs 5,4,3]
                                    [--frames 8] [--device cuda] [--max-retries 8]
                                    [--paths 19a,19a_ref,19b] [--replay]

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
"nccl" every rank needs a card of its own. "19a_ref" takes the stripes
through the reference fine stage instead of kernel G.

--replay holds each path's program as chip_smoke does at world size 1:
the stripes go through `sharded.StripeFrames` too, and after the settling
frame each rank's next frame builds its class's program (over NCCL a
CUDA graph with the collectives inside; over gloo the frame function run
into the program's outputs), which must equal the frame run eagerly at
the same class bit for bit (fine output and packed flags), be the only
program of the class and, over NCCL, be captured; each rank prints its
capture seconds and the ms/frame of replayed and of eager frames (median
of --frames after 2 warm-ups each). Prints every number beside the first
card's name and power limit. Exits non-zero if a frame that raised no
flag differs from the single-card frame by more than 1e-3, or if a
program fails its hold.
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


def _rank(group, jobs, frames, replay=False):
    """One rank: each job (tag, make, inputs, caps, options) rendered once
    and timed; with `max_retries` in the options through
    `sharded2.RetryingRender`, and with `replay` the stripes through
    `sharded.StripeFrames` and each program held to its eager frame.
    Returns {tag: (fine_out, flags, per-rank flags, ms, retries or None,
    the program's hold or None)}."""
    import torch

    from jello_tpu_torch.cuda.sharded import StripeFrames, rank_inputs
    from jello_tpu_torch.cuda.sharded2 import RetryingRender
    from jello_tpu_torch.pipeline.render import unpack_layout

    def sync():
        if group.device.type == "cuda":
            torch.cuda.synchronize(group.device)

    out = {}
    for tag, make, inputs, caps, opts in jobs:
        args = rank_inputs(inputs, group.device)
        holder = None
        if "max_retries" in opts:
            holder = RetryingRender(group, opts["max_retries"])
        elif replay:
            holder = StripeFrames(group, opts["pallas_fine"])
        if holder is None:
            run = lambda s, lay, *a, run=make(group, caps, **opts): run(  # noqa: E731
                s, unpack_layout(lay), *a)
        else:
            run = lambda *a, holder=holder, caps=caps: holder(caps, *a)  # noqa: E731
        res = run(*args)
        frame = (res[0].cpu(), {k: bool(v) for k, v in res[1].items()},
                 res[2]["raised"].cpu() if len(res) > 2 else None)
        retries = list(holder.last_retries) if isinstance(holder, RetryingRender) else None
        held = None
        if replay:
            run(*args)  # builds the class's program
            prog = holder.last_program
            eager = holder.frame_fn(caps, *args)
            same = all(torch.equal(a, b) for a, b in zip(prog.run(args)[:2], eager(*args)[:2]))
            held = {"programs": len(holder.compile_log), "capture_s": holder.compile_log[0][1],
                    "captured": prog.graph is not None, "same": same,
                    "replayed_ms": _timed(lambda: prog.run(args), frames, sync),
                    "eager_ms": _timed(lambda: eager(*args), frames, sync)}
        ms = _timed(lambda: run(*args), frames, sync)
        out[tag] = frame + (ms, retries, held)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--world", default="2,4", help="world sizes, comma-separated")
    ap.add_argument("--backend", default="nccl", choices=("nccl", "gloo"))
    ap.add_argument("--configs", default="5,4,3")
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--max-retries", type=int, default=8)
    ap.add_argument("--paths", default="19a,19b",
                    help="19a (stripes, kernel G), 19a_ref (stripes, the reference fine "
                         "stage), 19b (geometry)")
    ap.add_argument("--replay", action="store_true",
                    help="hold each path's program to its eager frame and time both")
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

    worst, failed = 0.0, []
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
                    (f"config{k}_19a_ref", sharded.make_sharded_render, inputs, caps,
                     {"pallas_fine": False}),
                    (f"config{k}_19b", sharded2.make_sharded_render, inputs, caps,
                     {"max_retries": opts.max_retries} if opts.max_retries else {"report": True})]
            jobs = [j for j in jobs if j[0].split("_", 1)[1] in opts.paths.split(",")]
            t = time.perf_counter()
            per_rank = collectives.run_ranks(_rank, n, opts.backend, opts.device,
                                             (jobs, opts.frames, opts.replay))
            print(f"config {k}, world size {n} over {opts.backend}: "
                  f"{time.perf_counter() - t:.1f} s with the ranks' start")
            for tag, *_ in jobs:
                outs = [pr[tag] for pr in per_rank]
                fine_out, flags, raised, _, retries, _ = outs[0]
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
                for rk, o in enumerate(outs):
                    h = o[5]
                    if h is None:
                        continue
                    kind = "a CUDA graph" if h["captured"] else "its function run"
                    print(f"{tag}, world size {n}, rank {rk}: program {kind} "
                          f"({h['programs']} built, {h['capture_s']:.3f} s), the replay equal "
                          f"to the eager frame at the class: {h['same']}; ms/frame replayed "
                          f"{h['replayed_ms'][0]:.3f} ({h['replayed_ms'][1]:.3f}, "
                          f"{h['replayed_ms'][2]:.3f}), eager {h['eager_ms'][0]:.3f} "
                          f"({h['eager_ms'][1]:.3f}, {h['eager_ms'][2]:.3f}); on {card}")
                    if (not h["same"] or h["programs"] != 1
                            or h["captured"] != (opts.backend == "nccl")):
                        failed.append(f"{tag} rank {rk}")
    print(f"largest difference of a clean sharded frame: {worst:.3e}"
          + (f"; programs that failed their hold: {failed}" if failed else ""))
    return 0 if worst <= FRAME_TOL and not failed else 1


if __name__ == "__main__":
    sys.exit(main())
