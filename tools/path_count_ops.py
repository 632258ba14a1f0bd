#!/usr/bin/env python3
"""The path_count stage of a settled frame, itemized by device operation,
on one NVIDIA GPU.

    python3 tools/path_count_ops.py [--configs motionmark_paths,tiger_text]
                                    [--seed N] [--frames 3] [--stage path_count]
                                    [--kind FRAGMENT]

For each benchmark configuration named (`benchmark/configs/<name>`), the
scene its generator draws for the seed is settled by a fresh
Renderer(device="cuda") up to its class's program, as the benchmark's
`static` cells run it. The stage clock of 20 replayed frames gives the
median device ms of each stage (`Renderer.last_stage_ms`, the spans the
benchmark's stage metrics read). `frames` frames of that class then run eagerly
(the operations the program captured, with the call sites a replay
lacks) under `Profiler.device_trace`, and the stage's device operations
(`xtrace.attribute`'s sites) are printed a frame: device ms and launches
by function and call site and kernel kind, by function, by kind, and
the stage's total. `--stage` takes a comma-separated list of stages, or
`all`; `--kind` keeps only the operations whose kernel kind holds the
fragment (`--stage all --kind scatter_gather`: torch's scatters in every
stage, by call site). Run it from the root of a checkout: it renders with
the `jello_tpu_torch` package it finds there, so one call itemizes two
trees. Prints the card's name and power limit beside the numbers.
"""

import argparse
import ast
import collections
import functools
import os
import shutil
import statistics
import sys
import tempfile

sys.path.insert(0, os.getcwd())

import chip_smoke  # noqa: E402  (blocks JAX and jello_tpu; its frame helpers)


@functools.cache
def _functions(path):
    """[(first line, last line, name)] of the functions in a source file."""
    with open(path) as f:
        tree = ast.parse(f.read())
    return [(n.lineno, n.end_lineno, n.name) for n in ast.walk(tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]


def function_of(site):
    """"pipeline/tiling.py:120 (shim)" -> "pipeline/tiling.py::line_dda_clip":
    the innermost function of the package that holds the call site."""
    if site.startswith("("):
        return site
    where = site.split(" ")[0]
    path, _, line = where.rpartition(":")
    full = os.path.join(os.getcwd(), "jello_tpu_torch", path)
    if not line.isdigit() or not os.path.isfile(full):
        return where
    line = int(line)
    inner = [(lo, name) for lo, hi, name in _functions(full) if lo <= line <= hi]
    return f"{path}::{max(inner)[1]}" if inner else where


def itemize(name, seed, frames, stage, smi, kind_part=""):
    import torch

    import jello_tpu_torch as jt
    from jello_tpu_torch.cuda import Renderer
    from jello_tpu_torch.profiler import NoDeviceEvents, Profiler
    from jello_tpu_torch.xtrace import attribute

    bench = os.path.join(os.getcwd(), "benchmark")
    sys.path.insert(0, bench)
    from portbench import commands, spec

    cfg, gen = spec.config(name, bench)
    cmds = gen.commands(cfg, seed % 2 ** 63)
    scene, params = commands.build(jt, cmds), commands.params(jt, cmds)
    r = Renderer(device="cuda")
    for _ in range(8):
        r.render_surface(scene, params)
        if r._program is not None:
            break
    if r._program is None:
        raise SystemExit(f"{name}: the scene did not settle into a program")
    clock = collections.defaultdict(list)
    for _ in range(20):
        r.render_surface(scene, params)
        for k, v in r.last_stage_ms.items():
            clock[k].append(v)
    print(f"{name} (seed {seed}): the stage clock of 20 replayed frames, median ms: "
          + ", ".join(f"{k} {statistics.median(v):.3f}" for k, v in clock.items())
          + f"; all stages {statistics.median(map(sum, zip(*clock.values()))):.3f}; on {smi}")
    prepared = r._prepare(scene, params)
    chip_smoke._eager_frame(r, prepared, params)
    torch.cuda.synchronize()
    for attempt in range(3):
        logdir = tempfile.mkdtemp(prefix=f"path_count_ops_{name}_")
        try:
            with Profiler().device_trace(logdir, frames):
                for _ in range(frames):
                    chip_smoke._eager_frame(r, prepared, params)
            break
        except NoDeviceEvents:
            shutil.rmtree(logdir, ignore_errors=True)
            if attempt == 2:
                raise
    (tab,) = attribute(logdir, frames).values()
    shutil.rmtree(logdir, ignore_errors=True)
    stages = None if stage == "all" else set(stage.split(","))
    rows = [(function_of(src), src.split(" ")[0], kind, ms, n)
            for (st, src, kind), (ms, n) in tab["sites"].items()
            if (stages is None or st in stages) and kind_part in kind]
    total_ms, total_n = sum(row[3] for row in rows), sum(row[4] for row in rows)
    busy = tab["lines"]["all streams"][1]
    print(f"{name} (seed {seed}), {stage}: {total_ms:.3f} device ms and {total_n:g} "
          f"operations a frame over {frames} eager frames at the settled class; the frame's "
          f"busy {busy:.3f} ms; on {smi}")
    for title, key in (("function", lambda row: row[0]), ("kind", lambda row: row[2])):
        acc = collections.defaultdict(lambda: [0.0, 0.0])
        for row in rows:
            acc[key(row)][0] += row[3]
            acc[key(row)][1] += row[4]
        print(f"{name}, {stage} by {title} (ms, operations a frame):")
        for k, (ms, n) in sorted(acc.items(), key=lambda kv: -kv[1][0]):
            print(f"  {ms:8.4f} ms  x{n:6g}  {k}")
    print(f"{name}, the eager frame by stage (ms, operations a frame): " + "; ".join(
        f"{k} {ms:.3f} x{n:g}" for k, (ms, n) in
        sorted(tab["stages"].items(), key=lambda kv: -kv[1][0])))
    print(f"{name}, {stage} by call site and kind (ms, operations a frame):")
    for fn, src, kind, ms, n in sorted(rows, key=lambda row: (row[0], row[1], -row[3])):
        print(f"  {ms:8.4f} ms  x{n:6g}  {src}  {kind[:80]}")
    del r
    torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--configs", default="motionmark_paths,tiger_text")
    ap.add_argument("--seed", type=int, default=2 ** 31 + 7)
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--stage", default="path_count")
    ap.add_argument("--kind", default="", help="keep only kernel kinds holding this fragment")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        chip_smoke._fail("torch.cuda.is_available() is False")
    smi = chip_smoke._smi()
    for name in args.configs.split(","):
        itemize(name, args.seed, args.frames, args.stage, smi, args.kind)
    return 0


if __name__ == "__main__":
    sys.exit(main())
