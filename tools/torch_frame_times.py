#!/usr/bin/env python3
"""Steady-state frame times of the jello_tpu_torch port on one NVIDIA GPU.

    python3 tools/torch_frame_times.py [--configs 1,3,4,5] [--modes area,msaa8]
                                       [--frames 8] [--tag NAME] [--kernel-a]
                                       [--kernels-de] [--kernels-fg]

Run from the root of a checkout: it renders the gate scenes of the
`jello_tpu_torch` package it finds there (so the same script times two
trees in one call: unpack the other tree into a directory, copy or point
at this script, and run it from there) through
`Renderer(device="cuda").render_device`, and prints for each config and
antialiasing mode the median, minimum and maximum host ms a frame over
`--frames` frames that each end in `torch.cuda.synchronize()`, after two
warm-up frames, the peak device memory those frames allocate above what
was held before them, and the card's name and power limit. A tree that cannot
render a mode (a frame that raises NotImplementedError) says so and goes
on. Exits non-zero without a GPU. Config 2 takes half a minute to build
and is left out unless asked for.

With --kernel-a it first times kernel A (`cuda.coverage.coverage_rows`)
on config 5's coverage inputs in each of its three modes (CUDA-event
mean of 20 calls after one warm-up) and prints a SHA-256 of each mode's
rows, so that two trees' rows can be compared bit for bit.

With --kernels-de it first times kernels D (the lockstep walk) and E,
E' and E'' (the expand bodies) on the inputs one geometry pass of config
5 and of config 3 gives them (recorded from the wrappers), each through
its wrapper and through its bare C entry on buffers allocated once (the
median of 5 CUDA-event means of 100 calls), with the device time of
each kernel the bare entry launches (torch.profiler), and prints a
SHA-256 of each kernel's outputs. The bare entries follow whichever
entry layout the tree's `cuda/build.py` declares: the prefix computed in
the entry, or (older trees) passed in, computed beforehand.

With --kernels-fg it first times kernel F (the image tap) on the inputs
the tap stage of config 5 gives it, kernel B (record-stream fine) on
config 5's records (with the tap's table) and config 4's (clip groups),
and kernels G and H (the per-tile
interpreter, one tile and eight tiles a CTA) on the inputs config 4's
fine stage gives them in area mode and under msaa8 (the resolved
branch), in the same way: wrapper and bare C entry (medians of 5 means
of 100 calls), device time by kernel and memset, and a SHA-256 of the
outputs (F's table and region flag; B's rows of the records in the
tiles' runs, which are all it writes; G's and H's rows and
overflow words). The bare entries follow the tree's entry layout: F's
flag a zeroed int32 (older trees) or a byte the entry clears; G's stack
scratch as the tree's `cuda.fine_interp.scratch_shape` says, where it
has one; the width in tiles an int argument of B, F, G and H (older
trees) or device data (a pointer for B and F, the counts' last word for
G and H).
`--configs ""` times no frames.

With --geometry-sha it prints a SHA-256 of the geometry stages' outputs
(`pipeline.render.geometry`) of one pass of configs 4 and 5 at their
calibrated classes, on the renderer's route: one over the integer and
boolean tensors, one over the float tensors, each in key order
(`geometry_digest`), so that two trees' stages can be compared bit for
bit.

With --h-sweep it runs kernel H at every point of its design space (a
build of `cuda.fine_interp.H_BUILDS`, W warps a slot and the CTAs a
multiprocessor its register cap is set for; shared stack levels a slot
in 0, 1, 2, 4; `cuda.fine_interp.h_variant`) on config 4's legacy slots, area and
msaa8: each point's outputs must equal kernel G's bit for bit, and it
prints each point's bare ms (median of 5 means of 100 calls), device us,
registers and spills (ptxas, from a forced verbose build), resident CTAs
and scratch, beside G's, and the lockstep efficiency of the parent's
mapping (records walked over 8 x the longest tape of each CTA).
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
    ap.add_argument("--kernels-de", action="store_true",
                    help="also time kernels D, E, E' and E'' on config 5's and config 3's inputs")
    ap.add_argument("--kernels-fg", action="store_true",
                    help="also time kernel F on config 5's inputs, G and H on config 4's")
    ap.add_argument("--h-sweep", action="store_true",
                    help="also run kernel H at every (W, levels) on config 4's legacy slots")
    ap.add_argument("--geometry-sha", action="store_true",
                    help="also digest the geometry stages' outputs of configs 4 and 5")
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
    if opts.kernels_de:
        for k in (5, 3):
            kernels_de_times(opts.tag, smi, k)
    if opts.kernels_fg:
        kernels_fg_times(opts.tag, smi)
    if opts.geometry_sha:
        for k in (4, 5):
            ints, floats, n = geometry_digest(k)
            print(f"{opts.tag}: config{k} geometry outputs: {n} tensors, integer sha256 {ints}, "
                  f"float sha256 {floats}, on {smi}")
    if opts.h_sweep:
        from jello_tpu_torch.cuda import build

        build.build(force=True, verbose=True)
        for mode, (args, resolved) in record_interp_calls().items():
            for line in h_sweep_lines(f"{opts.tag}: config4 {mode}", args, resolved,
                                      h_sweep(args, resolved, build.LOG["fine_interp.cu"]), smi):
                print(line)
    r = Renderer(device="cuda")
    for k in (int(v) for v in opts.configs.split(",") if v):
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
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            times = []
            for _ in range(opts.frames):
                t = time.perf_counter()
                r.render_device(scene, p)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t) * 1e3)
            peak = (torch.cuda.max_memory_allocated() - held) / 2**20
            print(f"{opts.tag}: config{k} {mode}: render_device {statistics.median(times):.3f} "
                  f"ms/frame median of {opts.frames} (min {min(times):.3f}, max "
                  f"{max(times):.3f}), peak device memory a frame {peak:.1f} MiB, on {smi}")
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


GEOMETRY_WRAPPERS = (("lockstep", "lockstep_walk"), ("expand", "expand_euler"),
                     ("expand", "expand_crossings"), ("expand", "expand_rows"))


def record_geometry_calls(k):
    """The arguments of each call of kernels D, E, E' and E'' in one
    geometry pass of config k at its calibrated class, on the card:
    {wrapper name: [args, ...]}."""
    from jello_tpu_torch.cuda import Renderer
    from jello_tpu_torch.cuda.render import frame_routing
    from jello_tpu_torch.pipeline.render import geometry
    from jello_tpu_torch.scenes import GATE_SCENES

    scene, params = GATE_SCENES[k]()
    r = Renderer(device="cuda")
    r.render(scene, params)
    _, _, (scene_t, layout_t, _, atlas_t), _ = r._prepare(scene, params)
    layout_t = prepared_layout(layout_t)
    caps = dict(r._caps, **frame_routing(0, atlas_t is not None, 0))
    return spy_calls(GEOMETRY_WRAPPERS, lambda: geometry(scene_t, layout_t, caps))


def geometry_digest(k):
    """(SHA-256 of the integer and boolean tensors, SHA-256 of the float
    tensors, tensors digested) of the stage dict `geometry` returns for
    one pass of config k at its calibrated class on the card, each tensor
    as C-order bytes, nested dicts in key order."""
    import hashlib

    import torch
    from jello_tpu_torch.cuda import Renderer
    from jello_tpu_torch.cuda.render import frame_routing
    from jello_tpu_torch.pipeline.render import geometry
    from jello_tpu_torch.scenes import GATE_SCENES

    scene, params = GATE_SCENES[k]()
    r = Renderer(device="cuda")
    r.render(scene, params)
    _, ld, (scene_t, layout_t, _, atlas_t), depth = r._prepare(scene, params)
    layout_t = prepared_layout(layout_t)
    caps = dict(r._caps, **frame_routing(int(ld["n_clips"]), atlas_t is not None, depth))
    stages = stage_tensors(geometry(scene_t, layout_t, caps)[0])
    torch.cuda.synchronize()
    hashes = {False: hashlib.sha256(), True: hashlib.sha256()}
    for t in stages:
        hashes[t.is_floating_point()].update(t.detach().cpu().numpy().tobytes())
    return hashes[False].hexdigest()[:16], hashes[True].hexdigest()[:16], len(stages)


def stage_tensors(v, out=None):
    """The tensors of a nest of dicts, lists and tuples (a stage dict), in
    order: dicts in key order, sequences in theirs."""
    import torch

    out = [] if out is None else out
    if isinstance(v, dict):
        for key in sorted(v):
            stage_tensors(v[key], out)
    elif isinstance(v, (list, tuple)):
        for x in v:
            stage_tensors(x, out)
    elif isinstance(v, torch.Tensor):
        out.append(v)
    return out


def prepared_layout(layout_t):
    """The layout dict of a prepared frame's inputs: unpacked on trees that
    upload it packed (one int32 tensor), as it is on older trees."""
    import torch

    if isinstance(layout_t, torch.Tensor):
        from jello_tpu_torch.pipeline.render import unpack_layout

        return unpack_layout(layout_t)
    return layout_t


def spy_calls(wrappers, run):
    """Run `run()` with each (module under jello_tpu_torch.cuda, name)
    wrapper replaced by one that records its arguments: {name: [args,
    ...]}."""
    import importlib

    calls, saved = {}, []
    for mod_name, name in wrappers:
        mod = importlib.import_module(f"jello_tpu_torch.cuda.{mod_name}")
        fn = getattr(mod, name)
        saved.append((mod, name, fn))

        def spy(*args, _fn=fn, _name=name):
            calls.setdefault(_name, []).append(args)
            return _fn(*args)

        spy.launches = 0  # a wrapper counts on its module-level name
        spy.launches_batch = 0
        setattr(mod, name, spy)
    try:
        run()
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return calls


def bare_call(entry, tensors, ints):
    """A call of the kernel library's `entry` on the pointers of `tensors`
    (None: a null pointer; kept alive by the call), then `ints` and the
    current stream, with no check, allocation or other host work."""
    import torch
    from jello_tpu_torch.cuda import build

    fn = getattr(build.kernels(), entry)
    stream = torch.cuda.current_stream().cuda_stream
    args = [None if t is None else t.data_ptr() for t in tensors] + list(ints) + [stream]

    def call():
        build.check(entry, fn(*args))

    call.buffers = tensors  # what the pointers point into
    return call


def bare_entries(calls):
    """{wrapper name: (bare, outputs)}: `bare()` makes the wrapper's one
    ctypes call on the first recorded arguments, into buffers allocated
    once (`outputs`, in the wrapper's order of return values), with no
    check, allocation or other host work around it."""
    import torch
    from jello_tpu_torch.cuda import build
    from jello_tpu_torch.pipeline import expand as plain

    # Older trees pass the prefix in and expect zeroed records.
    prefix_in = len(build.SIGNATURES["jello_expand_euler"]) == 12
    bare = bare_call

    def empty(*shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device="cuda")

    def prefix(counts, compact):
        """(the prefix tensors the entry takes after the table, total)."""
        if prefix_in:
            incl, total = plain.expand_prefix(counts, assume_compact=compact)
            return [incl, counts], total
        from jello_tpu_torch.cuda.expand import SCAN_TILE

        R = counts.shape[0]
        total = empty()
        return [counts, empty(R + -(-R // SCAN_TILE)), total], total

    out = {}
    (table, valid, IT), = calls["lockstep_walk"][:1]
    NW = table.shape[0]
    alloc = torch.zeros if prefix_in else torch.empty
    d_out = (alloc((3, IT, NW), dtype=torch.float32, device="cuda"),
             empty(NW, dtype=torch.float32), empty(NW, dtype=torch.bool),
             torch.zeros((), dtype=torch.int32, device="cuda"))
    out["lockstep_walk"] = (bare("jello_lockstep_walk", [table, valid, *d_out], [NW, IT]),
                            d_out)

    (table, rec, counts, EC, sentinel), = calls["expand_euler"][:1]
    pre, total = prefix(counts, False)
    path, ok = empty(EC), empty(EC, dtype=torch.bool)
    if prefix_in:
        xy = empty(4, EC, dtype=torch.float32)
        tensors, xy = [table, rec, *pre, xy, path, ok], list(xy)
    else:
        xy = [empty(EC, dtype=torch.float32) for _ in range(4)]
        tensors = [table, rec, *pre, *xy, path, ok]
    out["expand_euler"] = (bare("jello_expand_euler", tensors,
                                [table.shape[0], rec.shape[1], EC, sentinel]),
                           (*xy, path, ok, total))

    (P, counts, SC, T), = calls["expand_crossings"][:1]
    pre, total = prefix(counts, True)
    if prefix_in:
        seg, ints = empty(5, SC, dtype=torch.float64), empty(3, SC)
        tensors, seg, ints = [P, *pre, seg, ints], list(seg), list(ints)
    else:
        seg = [empty(SC, dtype=torch.float64) for _ in range(5)]
        ints = [empty(SC) for _ in range(3)]
        tensors = [P, *pre, *seg, *ints]
    out["expand_crossings"] = (bare("jello_expand_crossings", tensors, [P.shape[0], SC, T]),
                               (ints[0], *seg, ints[1], ints[2], total))

    (PRT, counts, RC, T), = calls["expand_rows"][:1]
    pre, total = prefix(counts, True)
    if prefix_in:
        ints = empty(2, RC)
        tensors, ints = [PRT, *pre, ints], list(ints)
    else:
        ints = [empty(RC), empty(RC)]
        tensors = [PRT, *pre, *ints]
    out["expand_rows"] = (bare("jello_expand_rows", tensors, [PRT.shape[0], RC, T]),
                          (*ints, total))
    return out


def flat_outputs(got):
    """A wrapper's return values as a flat tuple of tensors (the crossing
    body's segment dict in its key order)."""
    flat = []
    for v in got:
        flat.extend(v.values() if isinstance(v, dict) else [v])
    return tuple(flat)


def digest(tensors):
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def mean_ms(fn, n=20):
    """Mean device ms a call over n calls, CUDA events, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(n):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / n


def steady_ms(fn):
    """ms a call: the median of 5 CUDA-event means of 100 calls each."""
    return statistics.median(mean_ms(fn, 100) for _ in range(5))


def device_us(fn, n=10, tries=3):
    """{kernel or memset name: device us a call}, torch.profiler over n
    calls of fn (after one warm-up). torch.profiler can drop a session's
    device events, which shows as no event or as a count that is no whole
    number a call; such a session is repeated, up to `tries` sessions
    (the last one's numbers are returned whatever they are)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        out, count = {}, 0
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                name = e.name.replace("(anonymous namespace)::", "").replace("void ", "")
                name = name.split("(")[0].strip()
                out[name] = out.get(name, 0.0) + (e.time_range.end - e.time_range.start) / n
                count += 1
        if count and count % n == 0:
            break
    return out


def kernels_de_times(tag, smi, k):
    """Kernels D, E, E' and E'' on config k's recorded inputs: the
    wrapper and the bare C entry (median of 5 means of 100 calls), the
    device time of each kernel the bare entry launches, and a digest of
    the outputs (the bare entry's must equal the wrapper's)."""
    import importlib

    import torch

    calls = record_geometry_calls(k)
    bare = bare_entries(calls)
    for mod_name, name in GEOMETRY_WRAPPERS:
        fn = getattr(importlib.import_module(f"jello_tpu_torch.cuda.{mod_name}"), name)
        args = calls[name][0]
        got = flat_outputs(fn(*args))
        call, outs = bare[name]
        call()
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, outs))
        device = "; ".join(f"{n} {us:.1f} us" for n, us in device_us(call).items())
        print(f"{tag}: config{k} {name}: wrapper {steady_ms(lambda: fn(*args)):.4f} ms, bare C "
              f"entry {steady_ms(call):.4f} ms (medians of 5 means of 100 calls), device: "
              f"{device}; outputs sha256 {digest(got)}, bare entry "
              f"{'equal' if same else 'DIFFERENT'}, on {smi}")


def record_tap_call():
    """The arguments of kernel F's call in the tap stage of config 5 at
    its calibrated class, on the card."""
    from jello_tpu_torch.cuda import Renderer
    from jello_tpu_torch.cuda.coverage import compute_area_rows
    from jello_tpu_torch.cuda.fine_v2 import build_records
    from jello_tpu_torch.cuda.render import frame_routing
    from jello_tpu_torch.pipeline.image_tap import image_tap
    from jello_tpu_torch.pipeline.render import geometry
    from jello_tpu_torch.scenes import GATE_SCENES

    scene, params = GATE_SCENES[5]()
    r = Renderer(device="cuda")
    r.render(scene, params)
    _, _, (scene_t, layout_t, _, atlas_t), _ = r._prepare(scene, params)
    layout_t = prepared_layout(layout_t)
    caps = dict(r._caps, **frame_routing(0, True, 0))
    stages = geometry(scene_t, layout_t, caps)[0]
    cmds = stages["cmds"]
    _, ids, _ = compute_area_rows(cmds, stages["counted"], caps)
    rec = build_records(dict(cmds, area_row=ids), caps)
    calls = spy_calls([("image_tap", "tap_records")],
                      lambda: image_tap(rec, cmds, atlas_t, layout_t, caps))
    return calls["tap_records"][0]


def record_interp_calls():
    """{"area": args, "msaa8": args}: the arguments (without the batch
    switch and the resolved switch) of kernel G's call in config 4's fine
    stage at its calibrated class, on the card, and the resolved switch."""
    from jello_tpu_torch.cuda import Renderer
    from jello_tpu_torch.cuda.fine_hybrid import fine_hybrid
    from jello_tpu_torch.cuda.render import frame_routing
    from jello_tpu_torch.pipeline.render import geometry
    from jello_tpu_torch.scenes import GATE_SCENES

    scene, params = GATE_SCENES[4]()
    r = Renderer(device="cuda")
    r.render(scene, params)
    _, ld, (scene_t, layout_t, ramps_t, atlas_t), depth = r._prepare(scene, params)
    layout_t = prepared_layout(layout_t)
    caps = dict(r._caps, **frame_routing(int(ld["n_clips"]), atlas_t is not None, depth))
    stages = geometry(scene_t, layout_t, caps)[0]
    out = {}
    for mode in ("area", "msaa8"):
        calls = spy_calls([("fine_interp", "interpret_tiles")], lambda: fine_hybrid(
            stages["cmds"], stages["counted"], ramps_t, atlas_t, layout_t,
            dict(caps, aa_mode=mode)))
        args = calls["interpret_tiles"][0]
        # The arguments before the batch switch (nine where the width in
        # tiles is still one of them, eight where it is the counts' last
        # word), then the resolved switch.
        k = len(args) - 2
        out[mode] = (args[:k], bool(args[k + 1]))
    return out


def record_fine_v2_calls():
    """{"config5": args, "config4": args}: the arguments of kernel B's call
    in config 5's fine stage (the image tap's table) and config 4's (clip
    groups) at their calibrated classes, on the card."""
    from jello_tpu_torch.cuda import Renderer
    from jello_tpu_torch.cuda.fine_hybrid import fine_hybrid
    from jello_tpu_torch.cuda.fine_v2 import fine_v2
    from jello_tpu_torch.cuda.render import frame_routing
    from jello_tpu_torch.pipeline.render import geometry
    from jello_tpu_torch.scenes import GATE_SCENES

    out = {}
    for k, fine in ((5, fine_v2), (4, fine_hybrid)):
        scene, params = GATE_SCENES[k]()
        r = Renderer(device="cuda")
        r.render(scene, params)
        _, ld, (scene_t, layout_t, ramps_t, atlas_t), depth = r._prepare(scene, params)
        layout_t = prepared_layout(layout_t)
        caps = dict(r._caps, **frame_routing(int(ld["n_clips"]), atlas_t is not None, depth))
        stages = geometry(scene_t, layout_t, caps)[0]
        calls = spy_calls([("fine_v2", "composite_records")], lambda: fine(
            stages["cmds"], stages["counted"], ramps_t, atlas_t, layout_t, caps))
        out[f"config{k}"] = calls["composite_records"][0]
    return out


def bare_tap(args):
    """(bare, (out, flag bytes)): kernel F's bare C entry on `args` (the
    wrapper's), into buffers allocated once. The flag is 4 zeroed bytes:
    an int32 the kernel ORs into (older trees) or a byte the entry clears."""
    import torch

    from jello_tpu_torch.cuda import build

    tap_rec, atlas, wit, grid = args
    IRC = tap_rec.shape[0]
    _, AHp, AWp = atlas.shape
    out = torch.empty((IRC, 1024), dtype=torch.float32, device="cuda")
    flag = torch.zeros(4, dtype=torch.uint8, device="cuda")
    if build.SIGNATURES["jello_image_tap"][4] is build.P:  # the width read on the device
        return bare_call("jello_image_tap", [tap_rec, atlas, out, flag, wit],
                         [IRC, int(grid), AHp, AWp]), (out, flag)
    return bare_call("jello_image_tap", [tap_rec, atlas, out, flag],
                     [IRC, int(grid), int(wit), AHp, AWp]), (out, flag)


def bare_fine_v2(args):
    """(bare, (out,)): kernel B's bare C entry on `args` (composite_records'
    own), into an output allocated once. The width in tiles goes as an int
    where the tree's entry takes one, else as the pointer the kernel reads."""
    import torch
    from jello_tpu_torch.cuda import build

    rec, cov, stops, base, start, end, wit, fg_tab, resolved = (
        list(args) + [None, False][len(args) - 7:])
    PC = rec.shape[0]
    NR, W = stops.shape
    n_fg = 0 if fg_tab is None else fg_tab.shape[0]
    out = torch.empty((PC, 4, 256), dtype=torch.float32, device="cuda")
    tensors = [rec, cov, stops, start, end, base, fg_tab, out]
    ints = [start.shape[0], NR, W, n_fg, 1 if resolved else 0]
    if build.SIGNATURES["jello_fine_v2"][8] is build.P:  # the width read on the device
        return bare_call("jello_fine_v2", tensors + [wit], ints), (out,)
    return bare_call("jello_fine_v2", tensors, ints[:3] + [int(wit)] + ints[3:]), (out,)


def bare_interp(args, batch, resolved):
    """(bare, (out, ovf)): kernel G's (or H's) bare C entry on `args`
    (interpret_tiles' arguments before the batch switch), into buffers
    allocated once; H's slots padded to a multiple of eight here, once.
    The width in tiles goes as an int where the tree's entry takes one,
    else it is the counts' last word, read on the device."""
    import torch
    from jello_tpu_torch.cuda import build
    from jello_tpu_torch.cuda import fine_interp as kint

    counts, ids, base, slab, rows, stops, atlas, *wit, BD = args
    wit_arg = [int(wit[0])] if len(build.SIGNATURES["jello_fine_interp"]) == 22 else []
    n, MC, _ = slab.shape
    if batch and n % 8:
        pad = -n % 8
        slab = torch.cat([slab, slab.new_zeros((pad, MC, 16))])
        ids = torch.cat([ids, ids.new_zeros(pad)])
        counts = torch.cat([counts[:n], counts.new_zeros(pad), counts[n:]])
    n_run = ids.shape[0]
    if hasattr(kint, "scratch_shape"):
        shape = kint.scratch_shape(n_run, int(BD), batch)
    else:  # the parent's rule: H always, G when BD levels exceed a CTA
        shape = (n_run, int(BD), 4, 256) if batch or int(BD) * 4096 > 227 * 1024 else None
    scratch = None if shape is None else torch.empty(shape, dtype=torch.float32, device="cuda")
    out = torch.empty((n_run, 4, 256), dtype=torch.float32, device="cuda")
    ovf = torch.empty(n_run, dtype=torch.int32, device="cuda")
    NR, W = stops.shape
    AHp, AWp = (0, 0) if atlas is None else atlas.shape[1:]
    call = bare_call("jello_fine_interp",
                     [counts, ids, base, slab, rows, stops, atlas, scratch, out, ovf],
                     [n_run, MC, rows.shape[0], NR, W, *wit_arg, int(BD), AHp, AWp,
                      1 if batch else 0, 1 if resolved else 0])
    return call, (out[:n], ovf[:n])


H_LEVELS = (0, 1, 2, 4)


def ptxas_kernels(log):
    """{entry function: (registers, spill store bytes, spill load bytes)}
    of one source's `-Xptxas -v` output."""
    import re

    out, name, spills = {}, None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name] = (int(m.group(1)),) + spills
            name, spills = None, (0, 0)
    return out


def lockstep_efficiency(counts, MC, tiles=8):
    """(records walked, records the parent's eight-tile lockstep stepped
    through: 8 x the longest tape of each CTA) of kernel H's slots (counts
    [n] i32, capped at MC; padded to a multiple of 8 with empty slots)."""
    import torch

    c = torch.clamp(counts.long(), 0, MC)
    c = torch.cat([c, c.new_zeros(-c.shape[0] % tiles)])
    return int(c.sum()), int(c.view(-1, tiles).max(1).values.sum()) * tiles


def h_sweep(args, resolved, ptxas_log=None):
    """Kernel H at every point of H_BUILDS x H_LEVELS on `args`
    (interpret_tiles' first eight, CUDA tensors), each point's outputs held
    to kernel G's on the same slots bit for bit (raises on a difference).
    Returns [(W, M, levels, bare ms, device us, registers, spill stores,
    spill loads, resident CTAs, scratch MiB)], then G's row as (0, 0, 0,
    ...): with `ptxas_log` (fine_interp.cu's verbose build) the
    registers, else None."""
    import torch
    from jello_tpu_torch.cuda import fine_interp as kint

    counts, ids, base, slab, rows, stops, atlas, BD = args
    n, MC, _ = slab.shape
    want = kint.interpret_tiles(*args, False, resolved)
    pad = -n % 8
    slab8 = torch.cat([slab, slab.new_zeros((pad, MC, 16))])
    ids8 = torch.cat([ids, ids.new_zeros(pad)])
    counts8 = torch.cat([counts[:n], counts.new_zeros(pad), counts[n:]])
    n8 = n + pad
    regs = ptxas_kernels(ptxas_log) if ptxas_log else {}

    def regs_of(fragment):
        hit = [v for k, v in regs.items() if fragment in k]
        return hit[0] if hit else (None, None, None)

    table = []
    for W, M in kint.H_BUILDS:
        for L in H_LEVELS:
            call = kint.h_variant(W, M, L)
            floats = kint.h_query(0, n8, BD, levels=L)
            scratch = torch.empty(floats, dtype=torch.float32, device="cuda") if floats else None
            out = torch.empty((n8, 4, 256), dtype=torch.float32, device="cuda")
            ovf = torch.empty(n8, dtype=torch.int32, device="cuda")

            def run():
                call(counts8, ids8, base, slab8, rows, stops, atlas, BD, resolved, out, ovf,
                     scratch)

            run()
            torch.cuda.synchronize()
            if not (torch.equal(out[:n], want[0]) and torch.equal(ovf[:n], want[1])):
                raise RuntimeError(f"kernel H at W {W}, M {M}, levels {L} differs from kernel G")
            us = sum(device_us(run).values())
            table.append((W, M, L, steady_ms(run), us)
                         + regs_of(f"interp_batch_kernelILi{W}ELi{M}E")
                         + (kint.h_query(1, n8, BD, W, M, L), 4 * floats / 2**20))
    g_call, _ = bare_interp(args, False, resolved)
    table.append((0, 0, 0, steady_ms(g_call), sum(device_us(g_call).values()))
                 + regs_of("interp_tile_kernel") + (kint.resident_ctas(False, BD), 0.0))
    return table


def h_sweep_lines(tag, args, resolved, table, smi):
    """The printed lines of an `h_sweep` table: one a point, G's last,
    then the lockstep efficiency of the parent's mapping."""
    from jello_tpu_torch.cuda import fine_interp as kint

    counts, slab = args[0], args[3]
    n, MC, _ = slab.shape
    walked, stepped = lockstep_efficiency(counts[:n], MC)
    ship = (kint.h_query(2), kint.h_query(3), kint.h_query(4))
    lines = []
    for W, M, L, ms, us, reg, st, ld, ctas, mib in table:
        what = "kernel G" if W == 0 else (f"kernel H W {W} M {M} levels {L}"
                                          + (" (shipped)" if (W, M, L) == ship else ""))
        lines.append(f"{tag}: {what}: bare {ms:.4f} ms, device {us:.1f} us, registers {reg}, "
                     f"spill stores {st} B, loads {ld} B, {ctas} CTAs a multiprocessor, scratch "
                     f"{mib:.1f} MiB; {n} slots{'' if W == 0 else ', equal to G bit for bit'}; "
                     f"on {smi}")
    lines.append(f"{tag}: lockstep efficiency, records walked over records stepped through: the "
                 f"parent's eight tiles in lockstep {walked} / {stepped} = "
                 f"{walked / max(stepped, 1):.3f}; a warp group a slot {walked} / {walked} = 1.000 "
                 f"(each group steps its own tape; a CTA still holds its slots until the longest "
                 f"ends)")
    return lines


def kernels_fg_times(tag, smi):
    """Kernel F on config 5's recorded inputs, B on config 5's and config
    4's, G and H on config 4's (area and msaa8): the wrapper and the bare
    C entry (median of 5 means of 100
    calls), the device time of each kernel and memset a bare call puts on
    the card, and a digest of the outputs (the bare entry's must equal the
    wrapper's)."""
    import torch
    from jello_tpu_torch.cuda import fine_interp as kint
    from jello_tpu_torch.cuda import fine_v2 as kfine
    from jello_tpu_torch.cuda import image_tap as ktap

    def report(what, fn, call, got, outs):
        call()
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, outs))
        device = "; ".join(f"{n} {us:.1f} us" for n, us in device_us(call).items())
        print(f"{tag}: {what}: wrapper {steady_ms(fn):.4f} ms, bare C entry "
              f"{steady_ms(call):.4f} ms (medians of 5 means of 100 calls), device: {device}; "
              f"outputs sha256 {digest(got)}, bare entry {'equal' if same else 'DIFFERENT'}, "
              f"on {smi}")

    f_args = record_tap_call()
    fg, flag = ktap.tap_records(*f_args)
    call, (out, flag_bytes) = bare_tap(f_args)
    call()
    torch.cuda.synchronize()
    n_img = int((f_args[0][:, 0] == 5).sum())
    report(f"config5 tap_records ({f_args[0].shape[0]} rows, {n_img} image records)",
           lambda: ktap.tap_records(*f_args), call, (fg, flag.reshape(1)),
           (out, flag_bytes.any().reshape(1)))
    for name, b_args in record_fine_v2_calls().items():
        # The rows of the tiles' runs, a prefix of the records: B leaves the
        # rows past them unwritten.
        live = int(b_args[5].max())
        got = kfine.composite_records(*b_args)[:live]
        call, (out,) = bare_fine_v2(b_args)
        report(f"{name} composite_records, kernel B ({live} records in runs of "
               f"{b_args[0].shape[0]})", lambda: kfine.composite_records(*b_args), call, (got,),
               (out[:live],))
    for mode, (args, resolved) in record_interp_calls().items():
        for batch, name in ((False, "G"), (True, "H")):
            got = kint.interpret_tiles(*args, batch, resolved)
            call, outs = bare_interp(args, batch, resolved)
            resident = (f", {kint.resident_ctas(batch, args[-1])} CTAs a multiprocessor"
                        if hasattr(kint, "resident_ctas") else "")
            report(f"config4 {mode} interpret_tiles, kernel {name} ({args[3].shape[0]} slots"
                   f"{resident})", lambda: kint.interpret_tiles(*args, batch, resolved), call,
                   got, outs)


if __name__ == "__main__":
    sys.exit(main())
