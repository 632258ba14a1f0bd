"""The readings the limits of `correct` are set from, on the card, at a
cell's own size: for each seed, the program's (a run of the cell with a
short window, as `run.py` makes it) and the control's (the reference in
the next precision down, `reference/frame.py::lower`, put in the
program's place at the view transforms of frames drawn from the seed).

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 --seconds 3 \\
        [--no-program] [--no-control]

Prints one JSON line a seed and reading: {"seed", "side": "program" or
"control", "max_u8_diff", "px_off_ppm", ...}. The benchmark's own runs do
not run it.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import random  # noqa: E402
import sys  # noqa: E402

from run import BENCH_DIR, forbidden_modules, prepare  # noqa: E402


def control_readings(cell, seed, device):
    """The control's (max_u8_diff, px_off_ppm) for `seed`: as many frames
    as a run samples, at the view transforms of frames drawn from the
    seed over one turn of the traffic's motion."""
    from portbench import compare, spec
    from portbench.traffic import view_transform

    bench = spec.load_benchmark(BENCH_DIR)
    w = spec.workload(bench, cell)
    cfg, gen = spec.config(w["config"], BENCH_DIR)
    mix = spec.traffic(w["traffic"], BENCH_DIR)
    cmds = gen.commands(cfg, seed % 2 ** 63)
    ref = compare.Reference(BENCH_DIR, cmds, device)
    rng = random.Random(seed)
    period = (mix.get("motion") or {}).get("period_frames", 1)
    samples = []
    for _ in range(mix["sample_frames"]):
        i = rng.randrange(period)
        t = (view_transform(mix["motion"], i)
             if mix["scene"] == "append" else None)
        samples.append((i, t, ref.frame(t, low_precision=True)))
    return compare.readings(samples, ref)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--no-program", action="store_true")
    ap.add_argument("--no-control", action="store_true")
    args = ap.parse_args(argv)
    prepare()
    from portbench import harness

    for seed in (int(s) for s in args.seeds.split(",")):
        if not args.no_program:
            t = time.perf_counter()
            result, lines = harness.run_cell(args.workload, seed, args.seconds, False,
                                             "cuda")
            c = result["checks"]
            print(json.dumps({"seed": seed, "side": "program", "correct": result["correct"],
                              "max_u8_diff": c["max_u8_diff"]["value"],
                              "px_off_ppm": c["px_off_ppm"]["value"],
                              "frames_failed": c["frames_failed"]["value"],
                              "metrics": {k: v["value"] for k, v in result["metrics"].items()},
                              "seconds": time.perf_counter() - t, "log": lines[:2]}), flush=True)
        if not args.no_control:
            t = time.perf_counter()
            max_diff, off_ppm = control_readings(args.workload, seed, "cuda")
            print(json.dumps({"seed": seed, "side": "control", "max_u8_diff": max_diff,
                              "px_off_ppm": off_ppm, "seconds": time.perf_counter() - t}),
                  flush=True)
    bad = forbidden_modules()
    if bad:
        print(f"control.py: loaded {bad}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
