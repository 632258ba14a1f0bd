"""One run of one cell: set-up, the measured window, the traced sub-window
(`--trace 1`), the check against the reference, and the result line.

`run_cell` does the work on whatever device it is given (the command,
`run.py`, gives it the card and refuses to run without one, and checks
the process's loaded modules afterwards). It returns the result dict, its
keys in the order of the result line (`checks`, each number compared
beside its limit, last), and the lines for standard error.
"""

from __future__ import annotations

import gc
import random
import time

from . import commands, compare, spec, tracing
from .traffic import Traffic

class Window:
    """What the frames of one measured stretch left: latencies (inf for a
    failed frame), counts, and a sample of their pixels drawn from the
    seed (a reservoir of `keep` frames: (frame index, u8 pixels))."""

    def __init__(self, keep: int, seed: int):
        self.latencies = []
        self.ok = 0
        self.failed = 0
        self.errors = []
        self.samples = []
        self.keep = keep
        self._rng = random.Random(seed)

    def done(self, i, t_submit, t_done, pixels, err):
        if err is not None or pixels is None:
            self.failed += 1
            self.latencies.append(float("inf"))
            self.errors.append(f"frame {i}: {type(err).__name__}: {err}")
            return
        self.ok += 1
        self.latencies.append(t_done - t_submit)
        if len(self.samples) < self.keep:
            self.samples.append((i, pixels.copy()))
        else:
            j = self._rng.randrange(self.ok)
            if j < self.keep:
                self.samples[j] = (i, pixels.copy())


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_start: float | None = None, bench_dir=spec.BENCH_DIR):
    """Returns (result dict, stderr lines)."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench = spec.load_benchmark(bench_dir)
    w = spec.workload(bench, cell)
    cfg, gen = spec.config(w["config"], bench_dir)
    mix = spec.traffic(w["traffic"], bench_dir)
    readers = [(m, spec.metric(m["name"], bench_dir)) for m in spec.cell_metrics(bench, cell, trace)]

    import torch

    import jello_tpu_torch as jt
    from jello_tpu_torch.cuda import Renderer
    from jello_tpu_torch.profiler import Profiler

    cuda = torch.device(device).type == "cuda"
    parts = {"import_s": time.perf_counter() - t_start}
    t = time.perf_counter()
    if cuda:
        from jello_tpu_torch.cuda import build

        build.kernels()
    parts["kernels_s"] = time.perf_counter() - t

    t = time.perf_counter()
    cmds = gen.commands(cfg, seed % 2 ** 63)
    scene = commands.build(jt, cmds)
    params = commands.params(jt, cmds)
    # The commands are made again for the check: the window's process holds
    # what an application would, its scene.
    del cmds
    parts["scene_s"] = time.perf_counter() - t

    renderer = Renderer(device=device)
    span = (lambda label: torch.profiler.record_function(label)) if trace else None
    traffic = Traffic(mix, jt, scene, params, renderer, span)
    warm = Window(0, seed)
    t = time.perf_counter()
    traffic.run(frames=1, done=warm.done)
    parts["first_frame_s"] = time.perf_counter() - t
    t = time.perf_counter()
    traffic.run(frames=max(0, mix["warmup_frames"] - 1), done=warm.done)
    if cuda:
        torch.cuda.synchronize()
    parts["warmup_s"] = time.perf_counter() - t
    parts["programs"] = len(renderer.compile_log)
    parts["classes"] = len(getattr(renderer, "_settled_classes", ()))
    parts["capture_s"] = sum(entry[1] for entry in renderer.compile_log)
    parts["warmup_failed"] = warm.failed
    flags0, progs0 = len(renderer.flags_history), len(renderer.compile_log)

    win = Window(mix["sample_frames"], seed)
    setup_s = time.perf_counter() - t_start
    t0, t1 = traffic.run(seconds=seconds, done=win.done)
    window_s = t1 - t0
    in_window = {"raised_flags": len(renderer.flags_history) - flags0,
                 "programs_built": len(renderer.compile_log) - progs0}

    traced, spans, twin = None, None, None
    if trace:
        twin = Window(0, seed)
        renderer.profiler = Profiler()
        traced = tracing.capture(lambda: traffic.run(frames=mix["trace_frames"], done=twin.done),
                                 cuda)
        traced["frames"] = mix["trace_frames"]
        spans = renderer.profiler.collect()
        renderer.profiler = None

    reserved = torch.cuda.memory_reserved() if cuda else 0
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    samples = [(i, traffic.transform(i), pixels) for i, pixels in win.samples]
    # The program's state is freed before the reference runs on the card.
    del traffic, renderer, scene
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t = time.perf_counter()
    ref = compare.Reference(bench_dir, gen.commands(cfg, seed % 2 ** 63), device)
    max_diff, off_ppm = compare.readings(samples, ref)
    check_s = time.perf_counter() - t
    failed = win.failed + (twin.failed if twin else 0)
    # A frame of set-up that failed fails the run too.
    checks = compare.checks(failed + warm.failed, max_diff, off_ppm, cfg["limits"],
                            in_window["programs_built"])
    correct = compare.passed(checks) and len(samples) > 0

    ctx = {"frames_ok": win.ok, "latencies_s": win.latencies, "window_s": window_s,
           "reserved_bytes": reserved, "setup_s": setup_s, "trace": traced, "spans": spans}
    metrics = {}
    for m, reader in readers:
        v = reader.read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": w["chips"], "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": len(win.latencies) + (
        len(twin.latencies) if twin else 0), "failed": failed, "metrics": metrics,
        "device": dev}
    if traced is not None:
        from metrics._common import device_ops, union

        ops = device_ops(traced)
        dev["busy_s"] = union((s, e) for s, e, _, _ in ops) / 1e6
        dev["window_s"] = (traced["end"] - traced["start"]) / 1e6
        result["breakdown"] = tracing.breakdown(traced)
    result["checks"] = checks

    lines = ["setup: " + " ".join(f"{k}={v}" for k, v in parts.items()) + f" setup_s={setup_s}",
             f"window: frames={win.ok} failed={win.failed} seconds={window_s} "
             + " ".join(f"{k}={v}" for k, v in in_window.items())
             + f" sampled={[s[0] for s in samples]} check_s={check_s}"]
    lines += (warm.errors + win.errors + (twin.errors if twin else []))[:5]
    lines += [f"check {k}: {c['value']} limit {c['limit']}" for k, c in checks.items()]
    return result, lines
