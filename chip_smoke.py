#!/usr/bin/env python3
"""Drive the jello_tpu_torch port once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase's failure is caught):
  1. environment: nvidia-smi name and power limit, torch/CUDA versions;
     exits non-zero when CUDA is not available;
  2. build: compiles the CUDA kernels from jello_tpu_torch/csrc, one
     nvcc per source, all at once;
  3. config 3's real kernel inputs: one geometry pass of config 3 at its
     calibrated class on the renderer's route, with every call of the
     kernel wrappers C, D, E, E' and E'' recorded;
  4. kernel A (coverage) vs its plain version on config 3's coverage
     inputs (max abs diff <= 1e-5);
  5. kernel B (record-stream fine) vs its plain version on config 3's
     records (max abs diff <= 1e-4 on the assembled image: sums run in
     another order and un-premultiplying magnifies that near alpha 0);
  6. kernels C (monotone landing: every call, equal), D (the lockstep
     walk: records, counts, not-done flags and iterations equal), E
     (Euler lines: valid and path equal, end points within 1e-5), E'
     (tile crossings) and E'' (backdrop rows: integer outputs equal,
     segments within 1e-5) vs their plain versions on the recorded
     inputs;
  7. main path: Renderer(device="cuda").render() on config 1 (one cubic
     fill, 256x256), then render() and render_surface() on config 3
     (1,000 gradient blobs, 1024x1024), every launch count set to 0
     before each config and read after it; flags must be clear, each of
     the seven kernels must have launched for each config (the JSON line
     gives the sum), and the images must be finite and within 2e-3
     of the reference: the same scenes through Renderer(device="cpu"),
     the plain PyTorch version of every stage and kernel, which the CPU
     tests (tests/test_torch_*.py) hold to the JAX package's numpy
     oracle; then steady-state ms/frame (median of 12 frames after 2
     warm-ups) and the peak device memory those frames allocate.
     Kernel times are CUDA-event means over repeated calls on the same
     inputs, the kernel's wrapper beside its plain version;
  8. one JSON line of kernel results, the nvidia-smi line, and the
     device line.

Imports only the port, torch and numpy; importing JAX is made to fail.
The port itself builds on the JAX-free host half of the JAX package
(scene encoding, resolve, the capacity estimate, the gate scenes); the
run fails if any module of the JAX renderer (jello_tpu.tpu) was loaded.
"""

import sys

sys.modules["jax"] = None  # any import of JAX fails loudly

A_TOL = 1e-5
B_TOL = 1e-4
E_TOL = 1e-5  # E, E': end points and segments vs the plain version
IMG_TOL = 2e-3
FRAMES = 12
WARMUP = 2


def _fail(msg):
    print(f"FAIL: {msg}", flush=True)
    raise SystemExit(1)


def _smi():
    import subprocess

    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return res.stdout.strip().splitlines()[0]


def _time_ms(fn, n):
    """Mean device ms per call over n calls, CUDA events, after one warm-up."""
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


def _frame_ms(fn):
    """(median, min, max) host ms per frame over FRAMES frames after
    WARMUP warm-ups, and the peak device MiB those frames allocated above
    what was already held."""
    import statistics
    import time

    import torch

    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    times = []
    for _ in range(FRAMES):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    peak = (torch.cuda.max_memory_allocated() - held) / 2**20
    return statistics.median(times), min(times), max(times), peak


def _record_calls(wrappers, run):
    """Run `run()` with each (module, name) wrapper replaced by one that
    records its arguments. Returns {name: [args, ...]}."""
    calls = {}
    saved = []
    for mod, name in wrappers:
        fn = getattr(mod, name)
        saved.append((mod, name, fn))

        def spy(*args, _fn=fn, _name=name):
            calls.setdefault(_name, []).append(args)
            return _fn(*args)

        # A wrapper counts its launches on the module's name for itself.
        spy.launches = 0
        setattr(mod, name, spy)
    try:
        run()
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return calls


def _max_diff(a, b, mask=None):
    d = (a.double() - b.double()).abs()
    if mask is not None:
        d = d[mask]
    return d.max().item() if d.numel() else 0.0


def main():
    import json
    import time

    import numpy as np
    import torch

    # ---- 1. environment --------------------------------------------------
    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is False")
    smi = _smi()
    print(f"nvidia-smi: {smi}")
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  device {torch.cuda.get_device_name(0)}")

    from jello_tpu_torch.cuda import build
    from jello_tpu_torch.cuda import expand as kx
    from jello_tpu_torch.cuda import land as kland
    from jello_tpu_torch.cuda import lockstep as kwalk
    from jello_tpu_torch.cuda.coverage import compute_area_rows, coverage_rows
    from jello_tpu_torch.cuda.fine_v2 import (
        assemble_compact,
        build_records,
        composite_records,
        composite_records_plain,
        tile_last_record,
    )
    from jello_tpu_torch.cuda.render import Renderer, present
    from jello_tpu_torch.pipeline import coverage as plain_cov
    from jello_tpu_torch.pipeline import expand as plain_expand
    from jello_tpu_torch.pipeline import land as plain_land
    from jello_tpu_torch.pipeline import lockstep as plain_walk
    from jello_tpu_torch.pipeline.render import geometry
    from jello_tpu_torch.scenes import GATE_SCENES

    config1, config3 = GATE_SCENES[1], GATE_SCENES[3]
    # ---- 2. build --------------------------------------------------------
    t = time.perf_counter()
    build.build(verbose=True)
    build.kernels()
    print(f"build: {time.perf_counter() - t:.1f} s")

    # ---- 3. config 3's real inputs ---------------------------------------
    # Settle config 3's capacity class, then run its geometry once on the
    # renderer's route, recording the new kernels' inputs.
    scene3, params3 = config3()
    warm = Renderer(device="cuda")
    warm.render(scene3, params3)
    _, _, (scene_t, layout_t, ramps_t) = warm._prepare(scene3, params3)
    caps = dict(warm._caps, _expand_pallas=True)
    out = {}
    calls = _record_calls(
        [(kland, "monotone_land"), (kwalk, "lockstep_walk"), (kx, "expand_euler"),
         (kx, "expand_crossings"), (kx, "expand_rows")],
        lambda: out.update(stages=geometry(scene_t, layout_t, caps)[0]))
    stages = out["stages"]
    cmds, counted = stages["cmds"], stages["counted"]
    print(f"config 3 caps: area_rows_cap {caps['area_rows_cap']} seg_cap "
          f"{caps['seg_cap']} row_cap {caps['row_cap']} cmds {cmds['tile'].shape[0]} "
          f"grid {caps['tile_grid_cap']} work rows "
          f"{caps['work_a_cap'] + caps['work_b_cap']} max_iters {caps['max_iters']} "
          f"euler_line_cap {caps['euler_line_cap']} cross_lines_cap "
          f"{caps['cross_lines_cap']} row_lines_cap {caps['row_lines_cap']}")
    print("recorded calls: " + ", ".join(f"{k} x{len(v)}" for k, v in sorted(calls.items())))

    # ---- 4. kernel A vs plain --------------------------------------------
    stream, rs, re_, bd, _, _ = plain_cov.slot_rank_rows(cmds, counted, caps)
    rows_k = coverage_rows(stream, rs, re_, bd)
    rows_p = plain_cov.coverage_rows_plain(stream, rs, re_, bd)
    area_k, ids_k, ovf_k = compute_area_rows(cmds, counted, caps)
    area_p, ids_p, _ = plain_cov.compute_area_rows(cmds, counted, caps)
    torch.cuda.synchronize()
    err_rows = (rows_k - rows_p).abs().max().item()
    err_a = (area_k - area_p).abs().max().item()
    print(f"kernel A: rows {rows_k.shape[0]} segments {stream.shape[0]} "
          f"max|row diff| {err_rows:.3e} max|table diff| {err_a:.3e} "
          f"nan {bool(torch.isnan(area_k).any())}")
    if not (err_a <= A_TOL and err_rows <= A_TOL) or torch.isnan(area_k).any():
        _fail("kernel A disagrees with its plain version")
    if not torch.equal(ids_k, ids_p) or bool(ovf_k):
        _fail("kernel A record ids or overflow flag wrong")
    a_ms = _time_ms(lambda: coverage_rows(stream, rs, re_, bd), 20)
    a_plain_ms = _time_ms(lambda: plain_cov.coverage_rows_plain(stream, rs, re_, bd), 5)
    as_ms = _time_ms(lambda: compute_area_rows(cmds, counted, caps), 20)
    as_plain_ms = _time_ms(lambda: plain_cov.compute_area_rows(cmds, counted, caps), 5)
    print(f"kernel A: {a_ms:.3f} ms vs plain {a_plain_ms:.3f} ms; whole coverage "
          f"stage: {as_ms:.3f} ms vs plain {as_plain_ms:.3f} ms")

    # ---- 5. kernel B vs plain --------------------------------------------
    rec = build_records(dict(cmds, area_row=ids_k))
    b_args = (rec, area_k, ramps_t, layout_t["base_color"], cmds["tile_start"],
              cmds["tile_end"], layout_t["width_in_tiles"])
    out_k = composite_records(*b_args)
    out_p = composite_records_plain(*b_args)
    t2r = tile_last_record(cmds["tile_start"], cmds["tile_end"])
    ld3 = warm._prepare(scene3, params3)[1]
    img_k = assemble_compact(out_k, t2r, ld3)
    img_p = assemble_compact(out_p, t2r, ld3)
    torch.cuda.synchronize()
    err_b = (img_k - img_p).abs().max().item()
    print(f"kernel B: records {rec.shape[0]} max|image diff| {err_b:.3e} "
          f"nan {bool(torch.isnan(img_k).any())}")
    if not err_b <= B_TOL or torch.isnan(img_k).any():
        _fail("kernel B disagrees with its plain version")
    b_ms = _time_ms(lambda: composite_records(*b_args), 20)
    b_plain_ms = _time_ms(lambda: composite_records_plain(*b_args), 3)
    print(f"kernel B: {b_ms:.3f} ms vs plain {b_plain_ms:.3f} ms")
    del (stages, cmds, counted, stream, rs, re_, bd, rows_k, rows_p, area_k, ids_k,
         area_p, ids_p, rec, b_args, out_k, out_p, t2r, img_k, img_p)

    # ---- 6. kernels C, D, E, E', E'' vs plain ------------------------------
    res = {}
    # C, at all three call sites; timed at the sorted-run landing (K = 3).
    err_land = 0.0
    for args in calls["monotone_land"]:
        got = kland.monotone_land(*args)
        want = plain_land.monotone_land(*args)
        err_land = max([err_land] + [_max_diff(g, w) for g, w in zip(got, want)])
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            _fail(f"kernel C differs from its plain version (K={len(args[2])}, "
                  f"rows {args[0].shape[0]}, out {args[3]})")
    land_runs = [a for a in calls["monotone_land"] if len(a[2]) == 3][0]
    res["C"] = (err_land, _time_ms(lambda: kland.monotone_land(*land_runs), 20),
                _time_ms(lambda: plain_land.monotone_land(*land_runs), 20))
    print(f"kernel C: {len(calls['monotone_land'])} calls equal; sorted-run landing "
          f"{land_runs[0].shape[0]} rows -> {land_runs[3]}: {res['C'][1]:.3f} ms vs plain "
          f"{res['C'][2]:.3f} ms")

    (w_args,) = calls["lockstep_walk"]
    got = kwalk.lockstep_walk(*w_args)
    want = plain_walk.lockstep_walk(*w_args)
    names = ("rec (t0, t1, n)", "count", "not_done", "iters")
    for name, g, w in zip(names, got, want):
        if not torch.equal(g, w):
            _fail(f"kernel D: {name} differs from the plain version "
                  f"(max diff {_max_diff(g, w):.3e})")
    res["D"] = (max(_max_diff(g, w) for g, w in zip(got, want)), _time_ms(lambda: kwalk.lockstep_walk(*w_args), 20),
                _time_ms(lambda: plain_walk.lockstep_walk(*w_args), 3))
    print(f"kernel D: {w_args[0].shape[0]} work rows, IT {w_args[2]}, iters "
          f"{int(got[3])}, lines {int(got[1].sum())}, all equal; {res['D'][1]:.3f} ms vs "
          f"plain {res['D'][2]:.3f} ms")

    (e_args,) = calls["expand_euler"]
    table, recs, counts, EC, sentinel = e_args
    incl, _ = plain_expand.expand_prefix(counts)
    got = kx.expand_euler(*e_args)
    want = plain_expand.euler_lines(table, recs, incl, counts, EC, sentinel)
    if not (torch.equal(got[5], want[5]) and torch.equal(got[4], want[4])):
        _fail("kernel E: valid or path differs from the plain version")
    err_e = max(_max_diff(g, w, want[5]) for g, w in zip(got[:4], want[:4]))
    if not err_e <= E_TOL:
        _fail(f"kernel E: end points {err_e:.3e} from the plain version")
    res["E"] = (err_e, _time_ms(lambda: kx.expand_euler(*e_args), 20),
                _time_ms(lambda: plain_expand.euler_lines(table, recs, incl, counts, EC,
                                                          sentinel), 3))
    print(f"kernel E: {EC} slots, {int(want[5].sum())} lines, max|end point diff| "
          f"{err_e:.3e}; {res['E'][1]:.3f} ms vs plain {res['E'][2]:.3f} ms")

    (c_args,) = calls["expand_crossings"]
    Pc, ncc, SC, T = c_args
    incl_c, _ = plain_expand.expand_prefix(ncc, assume_compact=True)
    got = kx.expand_crossings(*c_args)
    want = plain_expand.tile_crossings(Pc, incl_c, ncc, SC, T)
    for name, i in (("tile_slot", 0), ("bump_slot", 2), ("bump_delta", 3)):
        if not torch.equal(got[i], want[i]):
            _fail(f"kernel E': {name} differs from the plain version")
    err_c = max(_max_diff(got[1][k], want[1][k]) for k in want[1])
    if not err_c <= E_TOL:
        _fail(f"kernel E': segments {err_c:.3e} from the plain version")
    res["E'"] = (err_c, _time_ms(lambda: kx.expand_crossings(*c_args), 20),
                 _time_ms(lambda: plain_expand.tile_crossings(Pc, incl_c, ncc, SC, T), 5))
    print(f"kernel E': {Pc.shape[0]} lines -> {SC} slots ({int(ncc.sum())} crossings), "
          f"max|segment diff| {err_c:.3e}; {res["E'"][1]:.3f} ms vs plain "
          f"{res["E'"][2]:.3f} ms")

    (r_args,) = calls["expand_rows"]
    PRTc, nrr, RC, T = r_args
    incl_r, _ = plain_expand.expand_prefix(nrr, assume_compact=True)
    got = kx.expand_rows(*r_args)
    want = plain_expand.row_deltas(PRTc, incl_r, nrr, RC, T)
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        _fail("kernel E'': row slots or deltas differ from the plain version")
    res["E''"] = (max(_max_diff(got[i], want[i]) for i in (0, 1)), _time_ms(lambda: kx.expand_rows(*r_args), 20),
                  _time_ms(lambda: plain_expand.row_deltas(PRTc, incl_r, nrr, RC, T), 5))
    print(f"kernel E'': {PRTc.shape[0]} lines -> {RC} slots ({int(nrr.sum())} rows), "
          f"equal; {res["E''"][1]:.3f} ms vs plain {res["E''"][2]:.3f} ms")
    del calls, w_args, e_args, c_args, r_args, got, want, warm

    # ---- 7. main path ----------------------------------------------------
    counters = {
        "coverage_area": coverage_rows, "fine_v2": composite_records,
        "monotone_land": kland.monotone_land, "lockstep_walk": kwalk.lockstep_walk,
        "expand_euler": kx.expand_euler, "expand_crossings": kx.expand_crossings,
        "expand_rows": kx.expand_rows,
    }

    def zero_counts():
        for fn in counters.values():
            fn.launches = 0

    def read_counts(name):
        got = {k: fn.launches for k, fn in counters.items()}
        print(f"{name} main path launches: {got}")
        if min(got.values()) < 1:
            _fail(f"{name}: a kernel of the main path was never launched")
        return got

    scene1, params1 = config1()
    r = Renderer(device="cuda")
    zero_counts()
    img1 = r.render(scene1, params1)
    flags1 = dict(r.last_flags)
    launches1 = read_counts("config1")
    zero_counts()
    img3 = r.render(scene3, params3)
    flags3 = dict(r.last_flags)
    stats3 = dict(r.last_stats)
    surf3 = r.render_surface(scene3, params3)
    launches3 = read_counts("config3")
    launches = {k: launches1[k] + launches3[k] for k in counters}
    print(f"config 3 frame stats: {stats3}")

    results = {}
    cpu = Renderer(device="cpu")
    for name, img, flags, scene, params in (
            ("config1", img1, flags1, scene1, params1),
            ("config3", img3, flags3, scene3, params3)):
        t = time.perf_counter()
        ref = cpu.render(scene, params)
        ref_s = time.perf_counter() - t
        if any(cpu.last_flags.values()):
            _fail(f"{name}: reference flags raised {cpu.last_flags}")
        err = float(np.abs(img - ref).max())
        finite = bool(np.isfinite(img).all())
        raised = [k for k, v in flags.items() if v]
        note = "  (above 1e-4: look into it)" if err > 1e-4 else ""
        print(f"{name}: shape {img.shape} finite {finite} flags raised {raised} "
              f"max|err| vs the CPU reference {err:.3e}{note} "
              f"(reference took {ref_s:.1f} s)")
        if raised or not finite or not err <= IMG_TOL or img.shape != ref.shape:
            _fail(f"{name} output wrong")
        results[name] = (scene, params, ref)
    ref3 = results["config3"][2]
    ref3_u8 = present(torch.from_numpy(ref3)).numpy()
    du8 = int(np.abs(surf3.astype(np.int32) - ref3_u8.astype(np.int32)).max())
    print(f"render_surface config3: {surf3.shape} {surf3.dtype}, max u8 diff vs "
          f"the CPU reference {du8}")
    if surf3.shape != ref3.shape or surf3.dtype != np.uint8 or du8 > 1:
        _fail("render_surface output wrong")

    for name, (scene, params, _) in results.items():
        for what, fn in (("render_device", r.render_device),
                         ("render_surface", r.render_surface)):
            med, lo, hi, peak = _frame_ms(lambda: fn(scene, params))
            print(f"{name}: {what} {med:.3f} ms/frame median of {FRAMES} "
                  f"(min {lo:.3f}, max {hi:.3f}), peak device memory "
                  f"{peak:.1f} MiB, on {smi}")

    loaded = [m for m in sys.modules if m.startswith("jello_tpu.tpu")]
    if loaded:
        _fail(f"modules of the JAX renderer were imported: {loaded}")

    # ---- 8. results ------------------------------------------------------
    def entry(name, src, replaces, count, err, ms, plain_ms):
        return {"name": name, "route": "cuda", "source": f"jello_tpu_torch/csrc/{src}",
                "replaces": f"jello_tpu/tpu/{replaces}", "launches": launches[count],
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}

    kernels = [
        entry("coverage_area", "coverage.cu", "coverage_pallas.py:266", "coverage_area",
              max(err_rows, err_a), a_ms, a_plain_ms),
        entry("fine_v2", "fine_v2.cu", "fine_v2.py:564", "fine_v2", err_b, b_ms,
              b_plain_ms),
        entry("monotone_land", "land.cu", "land_pallas.py:171", "monotone_land", *res["C"]),
        entry("lockstep_walk", "lockstep.cu", "lockstep_pallas.py:198", "lockstep_walk",
              *res["D"]),
        entry("expand_euler", "expand.cu", "expand_pallas.py:248", "expand_euler",
              *res["E"]),
        entry("expand_crossings", "expand.cu", "expand_pallas.py:248", "expand_crossings",
              *res["E'"]),
        entry("expand_rows", "expand.cu", "expand_pallas.py:248", "expand_rows",
              *res["E''"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
