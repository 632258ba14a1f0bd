#!/usr/bin/env python3
"""Drive the jello_tpu_torch port once on one NVIDIA GPU.

    python3 chip_smoke.py

(--config5-cpu-reference is a one-off audit path, not part of the check:
it also renders config 5 through Renderer(device="cpu"), which takes
minutes, and prints how far the frame and the plain-on-CUDA reference lie
from it.)

Phases (any failure exits non-zero; no phase's failure is caught):
  1. environment: nvidia-smi name and power limit, torch/CUDA versions,
     which path encoder runs (native or its Python twin); exits non-zero
     when CUDA is not available;
  2. build: compiles the CUDA kernels from jello_tpu_torch/csrc, one
     nvcc per source, all at once, and prints ptxas's registers, spills
     and static shared memory for kernels A, C, D, E (E's three bodies),
     F, G, H (each of H's builds), I, J, K and L, and kernel A's
     persistent grid;
  3. config 3's real kernel inputs: one geometry pass of config 3 at its
     calibrated class on the renderer's route, with every call of the
     kernel wrappers C, D, E, E', E'', J and L recorded;
  4. kernel A (coverage) vs its plain version on config 3's coverage
     inputs (max abs diff <= 1e-5; the MSAA body's rows equal), each of
     its three modes timed beside its bound;
  5. kernel B (record-stream fine) vs its plain version on config 3's
     records (max abs diff <= 1e-4 on the assembled image: sums run in
     another order and un-premultiplying magnifies that near alpha 0);
  6. kernels C (monotone landing: every call, equal), D (the lockstep
     walk: records, counts, not-done flags and iterations equal), E
     (Euler lines: valid and path equal, end points within 1e-5), E'
     (tile crossings) and E'' (backdrop rows: integer outputs equal,
     segments within 1e-5) vs their plain versions on the recorded
     inputs; C also beside the one PyTorch call that lands the same rows
     (scatter_ into a zeroed tensor), as a yardstick only, and beside its
     bare C entry on prepared buffers, with the device operations (kernels,
     memsets, copies) a call puts on the card at each call site; D, E, E'
     and E'' timed, each wrapper beside its bare C entry on buffers
     allocated once (outputs equal to the wrapper's) and its bound, with
     its device operations a call (D: one kernel and one 4-byte memset;
     E: one or two prefix-scan kernels and the expansion) and D's lane
     efficiency (iterations entered, over 32 times each warp's largest);
     then J (the per-line DDA table, `_kernel_j`) vs its plain version bit
     for bit (counts and row table on every line, P on every line with a
     crossing or a row) and timed: wrapper, bare C entry, plain version,
     bound, device operations a call (one kernel, nothing else); then L
     (flatten's per-slot tables, `_kernel_l`) vs its plain version bit for
     bit on every table and timed the same way;
  7. config 5 (10,000 paths at 1920x1080: long fills, thin round-capped
     strokes, even-odd glyphs, gradients, image fills) at its calibrated
     class: kernels C, D, E, E', E'' (now with stroke offsets), J, L and A
     held to their plain versions on this frame's recorded inputs as in 4
     and 6 and timed (D, E, E', E'', J as in 6 and A's three modes, beside
     their bounds),
     with the histogram of the coverage rows' run lengths; kernel F
     (image tap) vs its plain version on the frame's
     real image records, recorded from the tap stage (max abs diff <= 1e-6:
     the same products and sums, not contracted; region flag equal), with
     its rows (IRC) beside the live image records, its bare C entry beside
     the wrapper, its device time and resident CTAs, and its device
     operations a call (more than one kernel and one memset fails), and
     kernel B with the tap's table vs its plain version on config 5's
     records (<= 1e-4 on the assembled image); kernel A's MSAA body, S = 8
     and 16, vs its plain version on the same coverage inputs (resolved
     rows equal: <= 1e-6, 0 expected), timed beside the area body; kernel
     B's resolved branch on the msaa8 rows, and, because a row in [0, 1]
     reads the same under either fill rule and under none, once more on
     rows made negative, where only a kernel that reads its `resolved`
     switch agrees with its plain version;
  8. config 4 (nested clip layers with mix blends over a full-frame
     gradient, 1920x1080) at its calibrated class, its fine stage's real
     inputs recorded from one frame: kernel G (the per-tile interpreter)
     vs its plain version on all legacy slots (output rows within 1e-4,
     overflow words equal); kernel H (eight tiles a CTA, a warp group a
     tile) vs G on the same slab (real slots within 1e-6, overflow words
     equal) and vs plain;
     kernel B with clip groups vs its plain version on config 4's records
     (<= 1e-4 on the assembled image); kernel A's three modes vs plain on
     config 4's coverage inputs, timed (the JSON line's two MSAA entries);
     the resolved branch of G, H and B with groups on the inputs the fine
     stage records under msaa8 (same tolerances) and of G and H on
     negative rows; the legacy slots' tape lengths and record kinds; G's
     and H's bare C entries beside their wrappers (area and msaa8), their
     device time, resident CTAs and stack scratch, and their device
     operations a call (more than one kernel, or any memset or copy,
     fails); kernel H at every point of its design space (warps a slot,
     CTAs a multiprocessor its register cap allows, stack levels in shared
     memory; `tools/torch_frame_times.py::h_sweep`), area and msaa8, each
     equal to G bit for bit, its bare ms and device us beside G's with its
     registers, spills, resident CTAs and scratch, and the lockstep
     efficiency of the parent's mapping (records walked over eight times
     the longest tape of each CTA) against a warp group a slot; and G and
     H through fine_interp over the full tile grid of a small scene with
     clips, blends, gradients and an image vs the plain version; and a
     64x64 scene of clip layers nested 65 deep, one more than jello_tpu's
     clip walk takes (`clip_depth_cap` 64, printed), rendered on the card
     (kernel G must launch) and held to Renderer(device="cpu") (image
     within 1e-4, flags equal and clear); then kernel I (the integer
     column scan) at configs 5 and 4 (`_kernel_i`): its calls in a
     settled program's graph (no torch outer-dimension scan may be left),
     every call of one geometry pass held to its plain version bit for
     bit and timed (wrapper, bare C entry, byte bound, plain version,
     `torch.cumsum` of one column), and the SHA-256 of the geometry
     stages' outputs; then kernel K (the drop scatter, `_kernel_k`) in
     the same settled frames: no torch scatter left in the program's
     graph, one K launch there and in an eager frame for each
     `ops.scatter_*` call, each call held to its plain version, the
     largest timed (wrapper, bare C entry, byte bound, plain version);
  9. main path: Renderer(device="cuda") on config 1 (one cubic fill,
     256x256), config 3 (1,000 gradient blobs, 1024x1024), config 2 (100
     stroked and dashed paths, 512x512), config 5 and config 4, render()
     and, for configs 3, 5 and 4, render_surface(); config 4 once more
     under JELLO_INTERP_BATCH=1 (kernel H in G's place, the frame equal
     to G's within 1e-6); then the same five scenes under msaa8, config 4
     also under msaa16 and, msaa8 again, under JELLO_INTERP_BATCH=1
     (render_surface for configs 5 and 4); every launch count is set to 0
     before each config and read after it; flags must be clear, each
     kernel of the config's path must have launched (kernel A's MSAA
     entry and never its area entry under MSAA, and the other way round;
     the JSON line gives the sum), and the images must be finite and
     within 2e-3 of the reference. A count is a call of the kernel's
     wrapper: an eager frame's launch, or the launch a program's capture
     records (the first render_surface at a settled class builds the
     class's program, `cuda/program.py`); a replay calls no wrapper, and
     phase 13 reads the replays' launches from their device trace. Then an
     image minified past the image tap's region windows (512x512): its
     first frame raises image_region_overflow, the frame runs again through
     the reference fine stage (plain torch on the card) and must equal
     Renderer(device="cpu") within 2e-3; once its class is settled a render
     is the class's program and the rerouted frame's program (the
     reference fine stage walked to the class's two bounds; two entries in
     compile_log, fine_ref called once in two renders, by the capture). The
     reference for
     configs 1, 2 and 3 is Renderer(device="cpu"), the plain PyTorch
     version of every stage and kernel, which the CPU tests
     (tests/test_torch_*.py) hold to the JAX package's numpy oracle. At the
     size of configs 4 and 5 that costs minutes on a CPU, so their
     reference is the same plain versions run on CUDA tensors: this
     script's own reference call runs `render_frame` at the class the
     renderer settled, with the plain versions swapped in for the kernel
     wrappers (the main path has no such switch; a program would replay
     what it captured), and checks that no kernel launched meanwhile;
     --config5-cpu-reference also renders and times config 5's CPU
     reference;
 10. frames in flight: for configs 1 to 5 in area mode and config 4
     under msaa8, the shape settled by render_surface, a first round of
     FRAMES + 1 frames in flight (it pins the host buffers), then one
     render_surface_async under torch.cuda.set_sync_debug_mode("warn")
     (any host-device synchronization in a settled call fails; the call is
     a replay, so a kernel wrapper called fails), then ROUNDS rounds of
     FRAMES synchronous frames alternated with ROUNDS rounds of FRAMES
     frames enqueued back to back and fetched: every frame within 1 u8 step
     of render_surface's (differing pixels printed), no flag raised;
     ms/frame of each round, the host ms to enqueue a frame, and each
     call's host ms split into the renderer's spans (prepare, enqueue,
     flags, present, read, copy; `Renderer.profiler`); how many launches
     the host can enqueue behind a busy card before one blocks. Then a
     scene grown after its class settled (400 discs at 1920x1080 scaled 1
     -> 8, the same stream shape): its frame in flight must raise flags on
     the card, render again inside Frame.result() from the inputs it was
     enqueued with (the Scene is changed after the enqueue) and equal a
     fresh renderer's frame (flags_history printed); that frame was the
     settled class's program, and the grown class gets a program of its own
     at its next frame (two entries in compile_log);
 11. JELLO_IMAGE_TAP=0 at config 5: the frame through fine_hybrid, its
     image tiles through kernel G (kernel F must not launch, no flag may
     stay raised), within 1e-4 of the tap route's frame, area and msaa8;
     the legacy slots' tapes and record kinds; kernel G on the recorded
     slab vs its plain version (walk_tapes; <= 1e-5, 0 expected) and timed
     (wrapper, bare C entry, device us, beside its bound), area and msaa8,
     and the frame's ms;
 12. steady-state ms/frame (median after 2 warm-ups; every frame a
     replay of its class's program) and the peak device memory those
     frames allocate, each config's MSAA frames beside its area frame;
     then the rerouted over-minified frame: its rerouted replay equal to
     the eager reroute at the class bit for bit and within 2e-3 of the
     CPU frame, its ms a render and kernels a render (two replays). Kernel times are
     CUDA-event means over repeated calls on the same inputs, the kernel's
     wrapper beside its plain version;
 13. the compiled frame (`_compiled_frames`): for configs 1 to 5 in area
     and msaa8, config 4 in msaa16 and under JELLO_INTERP_BATCH=1, config
     5 under JELLO_IMAGE_TAP=0, each through a fresh renderer: one entry
     in compile_log when the settled class first renders, none on repeat
     frames, with its capture seconds; the replayed frame equal to
     `render_frame` run eagerly at the same class, bit for bit (assembled
     image, tile2rank, u8 surface; SHA-256 printed); 0 host-device
     synchronizations in a replayed render_surface_async; ms/frame and
     the host's ms a call of ROUNDS rounds of FRAMES replayed frames
     alternated with ROUNDS rounds of FRAMES eager ones; one replayed and
     one eager frame traced (Profiler.device_trace, xtrace.attribute):
     device operations equal by name and count, busy ms, kernels, copies
     and memsets a frame, and every kernel of the case's path in the
     replay's trace; for the default area cases the eager frame's
     attribution (a replay has no stage spans): device ms and launches by
     stage (every stage but path_tiling, which launches nothing, must
     launch, and the device ms outside them must stay under OUTSIDE_MAX
     of the busy time), the top call sites and kernel kinds, and the call
     sites of torch's outer-dimension scans (each must lie in pipeline/);
     the device memory with every program alive and the reserved MiB each
     program's capture added; then three frames of one class (the discs of
     phase 10 moved by 0, 16 and 32 pixels) in flight at once, each equal
     to its own eager frame; then configs 3 and 5 edited nine times each in
     one renderer (EDITS: discs appended, a path removed or added, cubics
     turned into lines, the target resized inside the tile grid bucket;
     `_edited_frames`): each edit's frame a replay of its class's program
     (the layout is the frame's data, never part of the program's key),
     equal to its own eager frame bit for bit, no flag, 0 synchronizations
     in a settled async call, one program a class (the parent's tree built
     one an edit), with the reserved MiB after each edit;
 14. multi-GPU (`cuda/sharded.py`, stripes; `cuda/sharded2.py`, geometry):
     configs 5 and 4 at full size, at the class a single-card Renderer
     settled for each; at world size 1 over NCCL in this process, the
     stripes with kernel G and with the reference fine stage
     (`sharded.StripeFrames`), the geometry-sharded frame in area and
     msaa8 mode (`sharded2.RetryingRender`), each as a program: the
     settling frame eager, the next one building the class's program (a
     CUDA graph with the NCCL collectives inside; one compile_log entry,
     capture seconds) whose frame is held to the single-card frame
     (FRAME_TOL, no flag, every kernel of its path launched: counts set to
     0 before, read after, the capture recording each launch), the replay
     equal to the frame run eagerly at the class bit for bit (fine output
     and packed flags), no host-device synchronization in a replay, two
     more frames building nothing; ms/frame and the host's ms a call of
     ROUNDS rounds of FRAMES replayed frames alternated with as many eager
     ones (one round of 2 for the reference fine stage, whose frames take
     seconds); the replay's device operations, read from its graph's
     nodes, equal by name and count (NCCL's included) to those of a traced
     eager frame (`_graph_ops`, `_trace_ops`), and the busy ms of a traced
     replay and eager frame; the replays' kernels added to the JSON's
     launches; every program alive to the block's end; then world size 4
     on the one card over gloo, chosen
     explicitly (NCCL takes one card a rank), in spawned ranks: the three
     dry runs (stripes; geometry with the full-profile scene through the
     image tap, area and msaa8), config 4 through the stripes, configs 4,
     5 and 3 through the geometry-sharded path with the retrying caller
     (`sharded2.RetryingRender`: shard_caps gives a rank beta / n = 1/2 of
     the line and segment capacities and the tag ranges balance tags, not
     lines, so a rank may raise flatten_overflow or segs_overflow; the
     caller grows only the ranks that raised, by their load, and renders
     again), every rank's frame equal, each held to the single-card
     frame with no flag raised and every kernel of its path launched in a
     settled frame; each rank's grown capacities, the retries taken, and
     each rank's ms/frame and peak device memory in the settled frame
     (beside the single card's frame's peak); over gloo a program runs its
     frame function (no graph can hold gloo's host copies), and the run
     says so; a settled frame that grows
     again fails; on rank 1 (a nonzero stripe base) the first call of G
     (the stripes' launch and the legacy slots), A, B and F held to their
     plain versions; each rank's ms/frame, which is four processes
     sharing one card, not a multi-GPU speed;
 15. one JSON line of kernel results, the nvidia-smi line, and the
     device line. A kernel's launches are its wrappers' counts (phases 9 to
     11 and 14) and its launches in the replayed frames of phases 13 and 14
     (from their device traces, and phase 14's from their graphs, times the
     replays). bound_ms is the least time an
     H100 could take for the call: the larger of its bytes (each input read
     once, each output written once; for B, G and H only the rows this
     run's records touch) over 3.35 TB/s and its float operations, counted
     for this run's data, over 67 TFLOP/s (float32 outside the tensor
     cores). D, E, E', E'', F, G, H, I, J and K also carry bare_ms, their
     bare C entry's time (G's and H's in area mode); I, which replaces no
     Pallas kernel, its calls a replayed config 5 frame
     (`launches_a_replay`); J, which replaces none either, its numbers at
     config 5; K, nor it, its numbers at config 5's largest call, its
     launches in config 5's program and its calls a frame.

Imports only the port, torch and numpy; importing JAX or the JAX package
(jello_tpu) is made to fail, and the run fails if either was loaded.
"""

import functools
import sys

sys.modules["jax"] = None  # any import of JAX fails loudly
sys.modules["jello_tpu"] = None  # and so does any import of the JAX package

A_TOL = 1e-5
MSAA_TOL = 1e-6  # A's MSAA body: resolved rows, sums of small integers (0 expected)
B_TOL = 1e-4
E_TOL = 1e-5  # E, E': end points and segments vs the plain version
F_TOL = 1e-6
G_TOL = 1e-4  # G, H vs the plain version, output rows of real slots
H_TOL = 1e-6  # H vs G
G_IMG_TOL = 1e-5  # G's image branch vs the plain version at config 5 (0 expected)
IMG_TOL = 2e-3
FRAME_TOL = 1e-3  # a sharded frame vs the single-card frame (jello_tpu/tpu/sharded.py:250)
FRAMES = 8
WARMUP = 2
ROUNDS = 3  # alternated rounds of synchronous frames and frames in flight
# Device ms of a profiled frame's launches outside the eight stage spans, as
# a share of its busy ms (found 0.1-2.1% at configs 1 to 5 on an H100).
OUTSIDE_MAX = 0.05
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores


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


def _frame_ms(fn, frames=FRAMES):
    """(median, min, max) host ms per frame over `frames` frames after
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
    for _ in range(frames):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    peak = (torch.cuda.max_memory_allocated() - held) / 2**20
    return statistics.median(times), min(times), max(times), peak


def _capture(fn, calls, tries=3):
    """The `xtrace.attribute` table of the device (ms and launches a call)
    for `calls` calls of fn, captured by `Profiler.device_trace` (after
    one warm-up call). torch.profiler can drop a session's device events
    (seen on an H100 host: none of five launches of one kernel, four of
    five of another); a capture without any is repeated, up to `tries`
    sessions, and then raises `NoDeviceEvents`."""
    import tempfile

    import torch

    from jello_tpu_torch.profiler import NoDeviceEvents, Profiler
    from jello_tpu_torch.xtrace import attribute

    fn()
    torch.cuda.synchronize()
    for i in range(tries):
        try:
            with tempfile.TemporaryDirectory() as d:
                with Profiler().device_trace(d, frames=calls):
                    for _ in range(calls):
                        fn()
                (table,) = attribute(d, calls).values()
            return table
        except NoDeviceEvents:
            if i == tries - 1:
                raise


def _is_copy(kind):
    return kind.startswith(("Memcpy", "Memset"))


def _profile(fn, count=()):
    """One profiled call of fn (a frame) through `xtrace.attribute`: (kernels
    launched, copies and memsets, the device's busy ms (the union of the
    device operations' intervals; the stage spans' own device-side
    annotations are no device work), the five kernel kinds with the most
    time as [(kind, ms, launches)], {name fragment in `count`: launches of
    the kinds that hold it}, the attribution table)."""
    tab = _capture(fn, 1)
    kinds = tab["kinds"]
    n_k = sum(n for k, (_, n) in kinds.items() if not _is_copy(k))
    n_c = sum(n for k, (_, n) in kinds.items() if _is_copy(k))
    top = sorted(((k, ms, n) for k, (ms, n) in kinds.items() if not _is_copy(k)),
                 key=lambda t: -t[1])[:5]
    counted = {frag: sum(n for k, (_, n) in kinds.items() if frag in k) for frag in count}
    return n_k, n_c, tab["lines"]["all streams"][1], top, counted, tab


def _device_table(fn, calls=5, tries=3):
    """`_capture` of `calls` calls of fn, or None when no session captured
    a device event. A session whose counts are no whole number a call
    (dropped events) is repeated, up to `tries` sessions, and the last
    one's numbers stand. A dropped event only lowers a count, so an
    operation too many still shows."""
    from jello_tpu_torch.profiler import NoDeviceEvents

    tab = None
    for _ in range(tries):
        try:
            tab = _capture(fn, calls, 1)
        except NoDeviceEvents:
            continue
        if all(round(n * calls) % calls == 0 for _, (_, n) in tab["kinds"].items()):
            break
    return tab


def _device_ops(fn, calls=5):
    """(kernels, memsets and copies) that a call of fn puts on the device
    (`_device_table`; (0, 0) when no event was captured)."""
    tab = _device_table(fn, calls)
    kinds = tab["kinds"] if tab else {}
    return (sum(n for k, (_, n) in kinds.items() if not _is_copy(k)),
            sum(n for k, (_, n) in kinds.items() if _is_copy(k)))


def _device_us(fn, n=10):
    """{device operation: us a launch} of fn (`_device_table` over n calls;
    empty when no event was captured), by name without its argument list:
    the mean over the launches captured, which a dropped event does not
    lower."""
    tab = _device_table(fn, n)
    out = {}
    for _, name, ms, k in tab["ops"] if tab else []:
        name = name.replace("(anonymous namespace)::", "").replace("void ", "")
        out[name.split("(")[0].strip()] = ms / k * 1e3
    return out


def _syncs(fn):
    """(fn's result, the file:line of each host-device synchronization fn
    made), under torch.cuda.set_sync_debug_mode("warn"), which warns at
    every synchronizing CUDA call torch makes."""
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, [f"{w.filename}:{w.lineno}" for w in caught
                 if "called a synchronizing CUDA operation" in str(w.message)]


def _ptxas_summary(log):
    """[(kernel, registers, spill store bytes, spill load bytes, static
    shared memory bytes)] of every entry function in one source's
    `-Xptxas -v` output."""
    import re

    out, name, spills = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", line)
            out.append((name, int(m.group(1))) + spills + (int(smem.group(1)) if smem else 0,))
            name, spills = None, (0, 0)
    return out


def _record_calls(wrappers, run):
    """Run `run()` with each (module, name) wrapper replaced by one that
    records its arguments, keyword ones bound to their positions. Returns
    {name: [args, ...]}."""
    import inspect

    calls = {}
    saved = []
    for mod, name in wrappers:
        fn = getattr(mod, name)
        saved.append((mod, name, fn))

        def spy(*args, _fn=fn, _name=name, _sig=inspect.signature(fn), **kw):
            bound = _sig.bind(*args, **kw)
            calls.setdefault(_name, []).append(bound.args)
            return _fn(*bound.args)

        # A wrapper counts its launches on the module's name for itself.
        for attr in [a for a in vars(fn) if a.startswith("launches")]:
            setattr(spy, attr, 0)
        setattr(mod, name, spy)
    try:
        run()
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return calls


def _nbytes(*tensors):
    """Bytes of the given tensors (nested lists, tuples and dicts of
    tensors included; other values count nothing)."""
    import torch

    n = 0
    for t in tensors:
        if isinstance(t, torch.Tensor):
            n += t.numel() * t.element_size()
        elif isinstance(t, dict):
            n += _nbytes(*t.values())
        elif isinstance(t, (list, tuple)):
            n += _nbytes(*t)
    return n


def _bound(nbytes, flops):
    """(bound_ms, bound_by) of a call that must move `nbytes` and do
    `flops` float operations."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / F32_FLOPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


class _PlainKernels:
    """While entered, every kernel wrapper is replaced by its plain
    PyTorch version, whatever device the tensors lie on: the reference
    call of this script for a frame too large for a CPU reference. The
    pipeline looks the wrappers up at call time, so this takes effect."""

    def __enter__(self):
        from jello_tpu_torch.cuda import coverage as kcov
        from jello_tpu_torch.cuda import expand as kx
        from jello_tpu_torch.cuda import fine_interp as kint
        from jello_tpu_torch.cuda import fine_v2 as kfine
        from jello_tpu_torch.cuda import image_tap as ktap
        from jello_tpu_torch.cuda import land as kland
        from jello_tpu_torch.cuda import line_dda as kline
        from jello_tpu_torch.cuda import lockstep as kwalk
        from jello_tpu_torch.cuda import scan as kscan
        from jello_tpu_torch.cuda import scatter as kscatter
        from jello_tpu_torch.cuda import slot_tables as kslot
        from jello_tpu_torch.pipeline import coverage as plain_cov
        from jello_tpu_torch.pipeline import expand as px
        from jello_tpu_torch.pipeline import ops as plain_ops
        from jello_tpu_torch.pipeline import fine_interp as plain_int
        from jello_tpu_torch.pipeline import flatten as plain_flatten
        from jello_tpu_torch.pipeline import image_tap as plain_tap
        from jello_tpu_torch.pipeline import land as plain_land
        from jello_tpu_torch.pipeline import lockstep as plain_walk
        from jello_tpu_torch.pipeline import tiling as plain_tiling

        def euler(table, rec, counts, EC, sentinel):
            incl, total = px.expand_prefix(counts)
            return px.euler_lines(table, rec, incl, counts, EC, sentinel) + (total,)

        def crossings(P, counts, SC, T):
            incl, total = px.expand_prefix(counts, assume_compact=True)
            return px.tile_crossings(P, incl, counts, SC, T) + (total,)

        def rows(PRT, counts, RC, T):
            incl, total = px.expand_prefix(counts, assume_compact=True)
            return px.row_deltas(PRT, incl, counts, RC, T) + (total,)

        def interpret(counts, tile_ids, base, slab, rows, stops, atlas, depth, batch=False,
                      resolved=False):
            return plain_int.interpret_plain(counts, tile_ids, base, slab, rows, stops, atlas,
                                             depth, resolved)

        swaps = [
            (kint, "interpret_tiles", interpret),
            (kcov, "coverage_rows", plain_cov.coverage_rows_plain),
            (kfine, "composite_records", kfine.composite_records_plain),
            (kland, "monotone_land", plain_land.monotone_land),
            (kwalk, "lockstep_walk", plain_walk.lockstep_walk),
            (kx, "expand_euler", euler), (kx, "expand_crossings", crossings),
            (kx, "expand_rows", rows),
            (ktap, "tap_records", plain_tap.tap_records_plain),
            (kscan, "column_scan", plain_ops.column_scan_plain),
            (kline, "line_tables", plain_tiling.line_tables_plain),
            (kscatter, "drop_scatter", plain_ops.drop_scatter_plain),
            (kslot, "slot_tables", plain_flatten.slot_tables_plain),
        ]
        self.saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
        for mod, name, fn in swaps:
            setattr(mod, name, fn)

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


# Kernel I's call sites, by (columns, op) (`cuda.scan.column_scan`).
_SCAN_SITES = {(5, "sum"): "pathtag.tag_monoid_scan", (4, "sum"): "drawobjs.draw_monoid_scan",
               (3, "sum"): "tiling._count_tail", (2, "max"): "flatten.expand_by_counts",
               (1, "max"): "clips.clip_leaf_vectorized or coverage.coverage_rows_plain"}

# The geometry stages' SHA-256 (integer and boolean tensors, float tensors;
# `tools/torch_frame_times.py::geometry_digest`) of configs 5 and 4 on an
# H100, as torch's own scans gave them before kernel I took their place:
# kernel I leaves every output of the stages as it was.
_GEOMETRY_SHA = {5: ("3e649f1b3b905cce", "71fe168fed50ed0c"),
                 4: ("4db67c1a5b63490c", "100c6a7d8ffdec8c")}


def _innermost_scan(cols, op="sum", exclusive=False, totals=False):
    """Kernel I's contract through torch's innermost-dimension scans of the
    stacked [k, N] columns: the library route kernel I is weighed against
    (the port never calls it)."""
    import torch

    from jello_tpu_torch.pipeline.ops import INT32_MIN

    s = torch.stack(cols)
    if op == "sum":
        incl = torch.cumsum(s, 1, dtype=torch.int32)
        out = incl - s if exclusive else incl
    else:
        incl = torch.cummax(s, 1).values
        out = (torch.cat([torch.full_like(s[:, :1], INT32_MIN), incl[:, :-1]], 1)
               if exclusive else incl)
    return (out, incl[:, -1]) if totals else out


def _kernel_i(config, scene, params, smi):
    """Kernel I (the integer column scan) at one scene's call sites: the
    scene settled and its program built by a fresh renderer, kernel I's
    launches a replayed frame read from the program's graph; one
    geometry pass at the class on the renderer's route with every call
    of `column_scan` recorded, each held to its plain version bit for bit
    (output and totals) and timed: the wrapper, the bare C entry on
    buffers allocated once, the byte bound (2 x 4 x k x N bytes over
    3.35 TB/s) and its share, the plain version, and `torch.cumsum` of
    one contiguous column of the same length as the library's yardstick
    (the port never calls it), and torch's innermost-dimension scans of
    the stacked columns (`_innermost_scan`, held to kernel I bit for bit);
    the settled frame replayed with kernel I and with `_innermost_scan` in
    its place, in alternated rounds; and the SHA-256 of the geometry
    stages' outputs, held to `_GEOMETRY_SHA`; then kernel K on the same
    settled renderer (`_kernel_k`). Returns the JSON line's numbers for
    the call with the most elements: (max abs error over every call, ms,
    plain ms, (bound ms, "bytes"), library ms, bare ms, launches a
    replayed frame, innermost ms), and K's (`_kernel_k`)."""
    import ctypes
    import statistics

    import torch

    from jello_tpu_torch.cuda import build
    from jello_tpu_torch.cuda import scan as kscan
    from jello_tpu_torch.cuda.render import Renderer
    from jello_tpu_torch.pipeline import ops
    from jello_tpu_torch.pipeline.render import geometry
    from tools.torch_frame_times import geometry_digest

    tag = f"config {config}"
    r = Renderer(device="cuda")
    for _ in range(8):
        r.render_surface(scene, params)
        if r._program is not None:
            break
    torch.cuda.synchronize()
    if r._program is None or r._program.graph is None:
        _fail(f"{tag}: the settled frame is no captured program")
    nodes = _graph_ops(r._program.graph)
    applies = sum(v for k, v in nodes.items() if "colscan_apply" in k)
    reduces = sum(v for k, v in nodes.items() if "colscan_reduce" in k)
    outer = sum(v for k, v in nodes.items() if "scan_outer_dim" in k)
    print(f"{tag}: kernel I in the settled program's graph: {applies} calls ({applies} scan "
          f"and {reduces} reduce kernels) of {sum(nodes.values())} nodes; torch's "
          f"outer-dimension scans {outer}")
    if applies < 1 or outer:
        _fail(f"{tag}: the settled frame does not scan its columns through kernel I alone")
    prepared = _prepared(r, scene, params)
    caps, _ = r._route(prepared, params, r._caps)
    scene_t, layout_t = prepared[2][:2]
    calls = _record_calls([(kscan, "column_scan")],
                          lambda: geometry(scene_t, layout_t, caps))["column_scan"]
    lib = build.kernels()
    stream = torch.cuda.current_stream().cuda_stream
    rows, seen, best, err = [], set(), None, 0
    for args in calls:
        cols, op = args[0], args[1] if len(args) > 1 else "sum"
        exclusive = args[2] if len(args) > 2 else False
        totals = args[3] if len(args) > 3 else False
        got = kscan.column_scan(*args)
        want = ops.column_scan_plain(*args)
        inner = _innermost_scan(*args)
        got, want, inner = (got, want, inner) if totals else ((got,), (want,), (inner,))
        err = max([err] + [int((g.long() - w.long()).abs().max()) for g, w in zip(got, want)
                           if g.numel()])
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            _fail(f"{tag}: kernel I differs from its plain version ({len(cols)} columns of "
                  f"{cols[0].shape[0]}, {op}, exclusive {exclusive}, totals {totals})")
        if not all(torch.equal(g, w) for g, w in zip(got, inner)):
            _fail(f"{tag}: torch's innermost-dimension scans differ from kernel I")
        key = (len(cols), op, exclusive, totals, cols[0].shape[0])
        if key in seen:
            continue
        seen.add(key)
        k, N = len(cols), cols[0].shape[0]
        stride = cols[0].stride(0) if N > 1 else 1
        out = torch.empty((k, N), dtype=torch.int32, device=cols[0].device)
        tot = torch.empty(k, dtype=torch.int32, device=cols[0].device)
        tiles = -(-N // kscan.TILE)
        part = torch.empty(k * tiles, dtype=torch.int32, device=cols[0].device)
        ptrs = (ctypes.c_void_p * k)(*[c.data_ptr() for c in cols])

        def bare():
            build.check("jello_column_scan", lib.jello_column_scan(
                ptrs, stride, k, N, 0 if op == "sum" else 1, int(exclusive), out.data_ptr(),
                tot.data_ptr() if totals else None, part.data_ptr() if tiles > 1 else None,
                stream))

        bare()
        if not torch.equal(out, got[0]):
            _fail(f"{tag}: kernel I's bare entry differs from its wrapper")
        column = cols[0].contiguous()
        ms = _time_ms(lambda: kscan.column_scan(*args), 20)
        bare_ms = _time_ms(bare, 20)
        plain_ms = _time_ms(lambda: ops.column_scan_plain(*args), 5)
        library_ms = _time_ms(lambda: torch.cumsum(column, 0, dtype=torch.int32), 20)
        inner_ms = _time_ms(lambda: _innermost_scan(*args), 20)
        bound = (2 * 4 * k * N / HBM_BYTES_PER_S * 1e3, "bytes")
        n_calls = sum(1 for a in calls if (len(a[0]), a[0][0].shape[0]) == (k, N)
                      and (a[1] if len(a) > 1 else "sum") == op)
        site = _SCAN_SITES.get((k, op), "?")
        print(f"{tag}: kernel I at {site}: {k} columns of {N}, {op}, exclusive {exclusive}, "
              f"totals {totals}, x{n_calls} a frame: {ms:.4f} ms (bare {bare_ms:.4f} ms) vs "
              f"plain {plain_ms:.3f} ms, library cumsum of one column {library_ms:.4f} ms, "
              f"torch's innermost scans of the stacked columns {inner_ms:.4f} ms, bound "
              f"{bound[0]:.5f} ms by bytes ({100 * bound[0] / bare_ms:.1f}% of the bare "
              f"entry), on {smi}")
        rows.append((ms, bare_ms, plain_ms, inner_ms, n_calls))
        if best is None or k * N > best[0]:
            best = (k * N, (ms, plain_ms, bound, library_ms, bare_ms, applies, inner_ms))
    ms, bare_ms, plain_ms, inner_ms = (sum(row[i] * row[4] for row in rows) for i in range(4))
    print(f"{tag}: kernel I, {len(calls)} calls a geometry pass: {ms:.3f} ms through the "
          f"wrapper (bare {bare_ms:.3f}) vs plain {plain_ms:.3f} ms, torch's innermost scans "
          f"{inner_ms:.3f} ms; max abs error {err}, on {smi}")

    saved = kscan.column_scan
    kscan.column_scan = _innermost_scan
    try:
        r_inner = Renderer(device="cuda")
        for _ in range(8):
            r_inner.render_surface(scene, params)
            if r_inner._program is not None:
                break
    finally:
        kscan.column_scan = saved
    if r_inner._program is None:
        _fail(f"{tag}: the settled frame with torch's innermost scans is no captured program")
    prep_i, prep_t = r._prepare(scene, params), r_inner._prepare(scene, params)
    frame_ms, _ = _alternated(lambda: r._enqueue(prep_i, params, r._caps),
                              lambda: r_inner._enqueue(prep_t, params, r_inner._caps),
                              rounds=5, frames=20)
    med_i, med_t = (statistics.median(frame_ms[k]) for k in ("replayed", "eager"))
    print(f"{tag}: settled frame replayed, one in flight, ms/frame in alternated rounds: kernel "
          f"I {[round(v, 3) for v in frame_ms['replayed']]} (median {med_i:.3f}), torch's "
          f"innermost scans {[round(v, 3) for v in frame_ms['eager']]} (median {med_t:.3f}): "
          f"kernel I {100 * (med_t - med_i) / med_t:+.2f}% of the frame, on {smi}")
    ints, floats, n = geometry_digest(config)
    print(f"{tag}: geometry outputs: {n} tensors, integer sha256 {ints}, float sha256 "
          f"{floats} (before kernel I: {' / '.join(_GEOMETRY_SHA[config])})")
    if (ints, floats) != _GEOMETRY_SHA[config]:
        _fail(f"{tag}: the geometry stages' outputs differ from the stages' before kernel I")
    k = _kernel_k(tag, r, nodes, scene, params, smi)
    del r, r_inner
    torch.cuda.empty_cache()
    return (err,) + best[1], k


def _kernel_j(calls, tag, smi, n_plain):
    """Kernel J (the per-line DDA table) on one geometry pass's recorded
    calls of `line_tables`: each held to its plain version
    (`tiling.line_tables_plain` on the card) bit for bit, the counts and
    the row table on every line and P on every line with a crossing or a
    row; then the last call timed: the wrapper, the bare C entry on
    buffers allocated once (outputs equal to the wrapper's), the plain
    version (n_plain calls), the bound (the lines, their paths' rows and
    every output once over 3.35 TB/s), and the device operations a call
    (more than one kernel, or any memset or copy, fails). Returns the
    JSON line's numbers: (max abs error, ms, plain ms, (bound ms, by),
    None, bare ms)."""
    import torch

    from jello_tpu_torch.cuda import build
    from jello_tpu_torch.cuda import line_dda as kline
    from jello_tpu_torch.pipeline.tiling import line_tables_plain

    if not calls:
        _fail(f"{tag}: kernel J was not called in a geometry pass")
    err = 0.0
    for lines, paths in calls:
        got = kline.line_tables(lines, paths)
        want = line_tables_plain(lines, paths)
        live = (got[2] > 0) | (got[3] > 0)
        pairs = [(got[0][live], want[0][live])] + list(zip(got[1:], want[1:]))
        err = max([err] + [_max_diff(g, w) for g, w in pairs])
        if not all(g.dtype == w.dtype and torch.equal(g, w) for g, w in pairs):
            _fail(f"{tag}: kernel J differs from its plain version ({got[0].shape[0]} lines)")
        whole = torch.equal(got[0].view(torch.int64), want[0].view(torch.int64))
        print(f"{tag}: kernel J equals its plain version: {got[0].shape[0]} lines, "
              f"{int(live.sum())} with a crossing or a row, {int(got[2].sum())} crossings, "
              f"{int(got[3].sum())} rows; P bit-equal on every line, dead ones too: {whole}")
    lines, paths = calls[-1]
    L, D = lines["line_x0"].shape[0], paths["rect_x0"].shape[0]
    lib = build.kernels()
    outs = (torch.empty((L, kline.N_COLS), dtype=torch.float64, device="cuda"),
            torch.empty((L, kline.N_ROW_COLS), dtype=torch.float64, device="cuda"),
            torch.empty(L, dtype=torch.int32, device="cuda"),
            torch.empty(L, dtype=torch.int32, device="cuda"))
    ins = ([lines[k].data_ptr() for k in kline.LINE_KEYS + ("line_valid", "line_path")]
           + [paths[k].data_ptr() for k in kline.PATH_KEYS])
    stream = torch.cuda.current_stream().cuda_stream

    def bare():
        build.check("jello_line_dda", lib.jello_line_dda(
            *ins, *[o.data_ptr() for o in outs], L, D, stream))

    bare()
    got = kline.line_tables(lines, paths)
    if not all(torch.equal(g.view(torch.int64) if g.dtype == torch.float64 else g,
                           o.view(torch.int64) if o.dtype == torch.float64 else o)
               for g, o in zip(got, outs)):
        _fail(f"{tag}: kernel J's bare entry differs from its wrapper")
    # Bound: each line's ends, flag and path read, its path's five words
    # (at most D rows), P, the row table and both counts written; ~120
    # float operations a line.
    bound = _bound(_nbytes(*[lines[k] for k in kline.LINE_KEYS + ("line_valid", "line_path")],
                           *[paths[k] for k in kline.PATH_KEYS], *outs), L * 120)
    ms = _time_ms(lambda: kline.line_tables(lines, paths), 20)
    bare_ms = _time_ms(bare, 20)
    plain_ms = _time_ms(lambda: line_tables_plain(lines, paths), n_plain)
    n_k, n_c = _device_ops(lambda: kline.line_tables(lines, paths))
    us = _device_us(bare)
    print(f"kernel J, {tag}: {L} lines of {D} paths: {ms:.4f} ms (the bare C entry "
          f"{bare_ms:.4f} ms; device "
          + ("; ".join(f"{k} {v:.1f} us" for k, v in us.items()) or "no event captured")
          + f") vs plain {plain_ms:.3f} ms, bound {bound[0]:.5f} ms by {bound[1]} "
          f"({100 * bound[0] / bare_ms:.1f}% of the bare entry), {n_k:g} kernels and {n_c:g} "
          f"memsets or copies a call, on {smi}")
    if n_k > 1 or n_c > 0:
        _fail(f"{tag}: kernel J: {n_k:g} kernels and {n_c:g} memsets or copies a call")
    return err, ms, plain_ms, bound, None, bare_ms


def _kernel_l(calls, tag, smi, n_plain):
    """Kernel L (flatten's per-slot tables) on one geometry pass's recorded
    calls of `slot_tables`: each held to its plain version
    (`flatten.slot_tables_plain` on the card) bit for bit on every table,
    a NaN equal to a NaN; then the last call timed: the wrapper, the bare
    C entry on tables allocated once (equal to the wrapper's), the plain
    version (n_plain calls), the bound (the slots' monoid words, decoded tags,
    style words, points and transforms read and every table written once
    over 3.35 TB/s), and the device operations a call (more than one
    kernel, or any memset or copy, fails). Returns the JSON line's
    numbers: (max abs error, ms, plain ms, (bound ms, by), None, bare
    ms)."""
    import torch

    from jello_tpu_torch.cuda import build
    from jello_tpu_torch.cuda import slot_tables as kslot
    from jello_tpu_torch.pipeline.flatten import slot_tables_plain

    def bit_equal(g, w):
        if g.dtype != w.dtype or g.shape != w.shape:
            return False
        if g.dtype != torch.float32:
            return torch.equal(g, w)
        return bool(((g.view(torch.int32) == w.view(torch.int32))
                     | (torch.isnan(g) & torch.isnan(w))).all())

    if not calls:
        _fail(f"{tag}: kernel L was not called in a geometry pass")
    for args in calls:
        got = kslot.slot_tables(*args)
        want = slot_tables_plain(*args)
        bad = [k for k in want if not bit_equal(got[k], want[k])]
        if bad:
            _fail(f"{tag}: kernel L differs from its plain version in {bad} ({args[4]} slots)")
        N = args[4]
        print(f"{tag}: kernel L equals its plain version bit for bit on every table: {N} "
              f"slots, {int(got['counts2'][:N].sum())} A and {int(got['counts2'][N:].sum())} B "
              f"work rows, {int(got['orow'][:, 2].sum())} simple lines, "
              f"{int(got['arc_n'].sum())} arc lines")
    args = calls[-1]
    scene, layout, tags, mono, N, tag_lo, n_paths_cap = args
    Ne = mono["path_idx"].shape[0]
    stride = mono["path_idx"].stride(0)
    lib = build.kernels()
    outs = {k: torch.empty_like(v) for k, v in got.items()}
    ins = ([scene.data_ptr(), tags.data_ptr()]
           + [layout[k].data_ptr() for k in kslot.LAYOUT_KEYS]
           + [mono[k].data_ptr() for k in kslot.MONO_KEYS])
    stream = torch.cuda.current_stream().cuda_stream

    def bare():
        build.check("jello_slot_tables", lib.jello_slot_tables(
            *ins, *[o.data_ptr() for o in outs.values()], stride, scene.shape[0], N, Ne,
            tag_lo, n_paths_cap, stream))

    bare()
    got = kslot.slot_tables(*args)
    if not all(bit_equal(outs[k], got[k]) for k in got):
        _fail(f"{tag}: kernel L's bare entry differs from its wrapper")
    # Bound: four monoid words, a decoded tag, two style words, eight point
    # words and six transform words a slot read (an overcount: neighbours
    # share styles and transforms), every table written once; ~400 float
    # operations a slot.
    nbytes = N * (4 * 4 + 4 + 2 * 4 + 8 * 4 + 6 * 4) + _nbytes(*outs.values())
    bound = _bound(nbytes, N * 400)
    ms = _time_ms(lambda: kslot.slot_tables(*args), 20)
    bare_ms = _time_ms(bare, 20)
    plain_ms = _time_ms(lambda: slot_tables_plain(*args), n_plain)
    n_k, n_c = _device_ops(lambda: kslot.slot_tables(*args))
    us = _device_us(bare)
    print(f"kernel L, {tag}: {N} slots ({Ne} decoded): {ms:.4f} ms (the bare C entry "
          f"{bare_ms:.4f} ms; device "
          + ("; ".join(f"{k} {v:.1f} us" for k, v in us.items()) or "no event captured")
          + f") vs plain {plain_ms:.3f} ms, bound {bound[0]:.5f} ms by {bound[1]} "
          f"({100 * bound[0] / bare_ms:.1f}% of the bare entry), {n_k:g} kernels and {n_c:g} "
          f"memsets or copies a call, on {smi}")
    if n_k > 1 or n_c > 0:
        _fail(f"{tag}: kernel L: {n_k:g} kernels and {n_c:g} memsets or copies a call")
    return 0.0, ms, plain_ms, bound, None, bare_ms


def _scatter_rows_equal(got, want, idx, op):
    """Kernel K's output against the plain version's on the card: integer
    words bit for bit, float words by value (which of +0 and -0 a max
    keeps is open) with NaN where NaN; rows that more than one in-range
    entry sets are left out for a set (one of the values wins). Returns
    (equal, rows left out)."""
    import torch

    n = got.shape[0]
    live = idx[(idx >= 0) & (idx < n)].long()
    hits = torch.bincount(live, minlength=n) if live.numel() else torch.zeros(
        n, dtype=torch.int64, device=got.device)
    keep = hits <= 1 if op == "set" else torch.ones(n, dtype=torch.bool, device=got.device)
    g, w = got[keep], want[keep]
    if got.dtype == torch.float32:
        same = bool(((g == w) | (torch.isnan(g) & torch.isnan(w))).all())
    else:
        same = torch.equal(g, w)
    return same, int((~keep).sum())


def _kernel_k(tag, r, nodes, scene, params, smi):
    """Kernel K (the drop scatter) in a settled frame of renderer r: the
    program's graph (`nodes`) holds no torch scatter
    (`_scatter_gather_elementwise_kernel`) and one K launch for each
    `ops.scatter_*` call of an eager frame at the class, whose launches of
    K equal those calls; each of those calls held to its plain version
    (`ops.drop_scatter_plain` on the card; `_scatter_rows_equal`), and the
    call with the most entries timed: the wrapper, the bare C entry on an
    output allocated once, the plain version, the bound (the index, the
    values of the entries in range, and the target copied: read and
    written once over 3.35 TB/s), and the device operations a call (one
    kernel and one copy). Returns the JSON line's numbers: (0, ms, plain
    ms, (bound ms, by), None, bare ms, K's launches a replayed frame, calls
    a frame)."""
    import torch

    from jello_tpu_torch.cuda import build
    from jello_tpu_torch.cuda import scatter as kscatter
    from jello_tpu_torch.pipeline import ops

    torch_scatters = sum(v for k, v in nodes.items() if "scatter_gather" in k)
    in_graph = sum(v for k, v in nodes.items() if "drop_scatter_kernel" in k)
    calls = []
    scatter = ops._scatter

    def spy(target, idx, values, op):
        calls.append((target, idx, values, op))
        return scatter(target, idx, values, op)

    prepared = r._prepare(scene, params)
    ops._scatter = spy
    n0 = kscatter.drop_scatter.launches
    try:
        _eager_frame(r, prepared, params)
        torch.cuda.synchronize()
    finally:
        ops._scatter = scatter
    launched = kscatter.drop_scatter.launches - n0
    print(f"{tag}: kernel K: {in_graph} launches in the settled program's graph of "
          f"{sum(nodes.values())} nodes, torch scatters {torch_scatters}; an eager frame at the "
          f"class: {len(calls)} ops.scatter_* calls ({', '.join(sorted({c[3] for c in calls}))}), "
          f"K launched {launched} times")
    if torch_scatters or not calls or launched != len(calls) or in_graph != len(calls):
        _fail(f"{tag}: the settled frame's scatters do not all run through kernel K, once each")
    multi = 0
    for target, idx, values, op in calls:
        got = kscatter.drop_scatter(target, idx, values, op)
        want = ops.drop_scatter_plain(target, idx, values, op)
        same, left = _scatter_rows_equal(got, want, idx, op)
        multi += left
        if not same:
            _fail(f"{tag}: kernel K differs from its plain version ({op} of {idx.shape[0]} "
                  f"entries onto {tuple(target.shape)} {target.dtype})")
    print(f"{tag}: kernel K equals its plain version at all {len(calls)} calls (a set's rows "
          f"named more than once, {multi}, left out)")
    target, idx, values, op = max(calls, key=lambda c: c[1].shape[0])
    n, m = target.shape[0], idx.shape[0]
    w = target[0].numel()
    values_c = torch.broadcast_to(values, (m,) + target.shape[1:]).to(target.dtype).contiguous()
    out = torch.empty_like(target)
    code = kscatter._CODES[(op, target.dtype)]
    lib = build.kernels()
    stream = torch.cuda.current_stream().cuda_stream

    align = kscatter._VEC_ALIGN.get(w, 0)
    vec = int(align > 0 and values_c.data_ptr() % align == 0 and out.data_ptr() % align == 0)

    def bare():
        build.check("jello_drop_scatter", lib.jello_drop_scatter(
            target.data_ptr(), out.data_ptr(), idx.data_ptr(), int(idx.dtype == torch.int64),
            values_c.data_ptr(), m, n, w, code, vec, stream))

    bare()
    if not _scatter_rows_equal(out, kscatter.drop_scatter(target, idx, values, op), idx, op)[0]:
        _fail(f"{tag}: kernel K's bare entry differs from its wrapper")
    in_range = int(((idx >= 0) & (idx < n)).sum())
    nbytes = m * idx.element_size() + in_range * w * 4 + 2 * n * w * 4
    bound = _bound(nbytes, 0)
    ms = _time_ms(lambda: kscatter.drop_scatter(target, idx, values, op), 20)
    bare_ms = _time_ms(bare, 20)
    plain_ms = _time_ms(lambda: ops.drop_scatter_plain(target, idx, values, op), 20)
    n_k, n_c = _device_ops(lambda: kscatter.drop_scatter(target, idx, values, op))
    us = _device_us(bare)
    print(f"kernel K, {tag}: the largest call, {op} of {m} entries ({in_range} in range) onto "
          f"{tuple(target.shape)} {target.dtype}: {ms:.4f} ms (the bare C entry {bare_ms:.4f} "
          f"ms; device " + ("; ".join(f"{k} {v:.1f} us" for k, v in us.items())
                            or "no event captured")
          + f") vs plain {plain_ms:.4f} ms, bound {bound[0]:.5f} ms by {bound[1]} "
          f"({100 * bound[0] / bare_ms:.1f}% of the bare entry), {n_k:g} kernels and {n_c:g} "
          f"memsets or copies a call, on {smi}")
    if n_k > 1 or n_c > 1:
        _fail(f"{tag}: kernel K: {n_k:g} kernels and {n_c:g} memsets or copies a call")
    return 0.0, ms, plain_ms, bound, None, bare_ms, in_graph, len(calls)


def _counters():
    """{kernel: (wrapper, the attribute that counts its launches)}."""
    from jello_tpu_torch.cuda import coverage as kcov
    from jello_tpu_torch.cuda import expand as kx
    from jello_tpu_torch.cuda import fine_interp as kint
    from jello_tpu_torch.cuda import fine_v2 as kfine
    from jello_tpu_torch.cuda import image_tap as ktap
    from jello_tpu_torch.cuda import land as kland
    from jello_tpu_torch.cuda import line_dda as kline
    from jello_tpu_torch.cuda import lockstep as kwalk
    from jello_tpu_torch.cuda import scan as kscan
    from jello_tpu_torch.cuda import scatter as kscatter
    from jello_tpu_torch.cuda import slot_tables as kslot

    return {
        "coverage_area": (kcov.coverage_rows, "launches"),
        "coverage_msaa": (kcov.coverage_rows, "launches_msaa"),
        "fine_v2": (kfine.composite_records, "launches"),
        "monotone_land": (kland.monotone_land, "launches"),
        "lockstep_walk": (kwalk.lockstep_walk, "launches"),
        "expand_euler": (kx.expand_euler, "launches"),
        "expand_crossings": (kx.expand_crossings, "launches"),
        "expand_rows": (kx.expand_rows, "launches"),
        "image_tap": (ktap.tap_records, "launches"),
        "fine_interp": (kint.interpret_tiles, "launches"),
        "fine_interp_b8": (kint.interpret_tiles, "launches_batch"),
        "column_scan": (kscan.column_scan, "launches"),
        "line_dda": (kline.line_tables, "launches"),
        "drop_scatter": (kscatter.drop_scatter, "launches"),
        "slot_tables": (kslot.slot_tables, "launches"),
    }


def _sharded_kernels(path, aa, has_atlas):
    """The kernels a sharded frame must launch: the geometry's (C, D, E,
    E', E'', I, J, K); with `path` "19a" kernel A in its mode and G over the stripe;
    with "19b" A, B and G (fine_hybrid runs G even without a legacy tile)
    and F with an atlas; with "19a_fine_ref" nothing more."""
    out = {"monotone_land", "lockstep_walk", "expand_euler", "expand_crossings", "expand_rows",
           "column_scan", "line_dda", "drop_scatter", "slot_tables"}
    coverage = "coverage_area" if aa == "area" else "coverage_msaa"
    if path == "19a":
        out |= {coverage, "fine_interp"}
    if path == "19b":
        out |= {coverage, "fine_v2", "fine_interp"} | ({"image_tap"} if has_atlas else set())
    return out


def _hold_stripe_kernels(calls, ld, grid):
    """Each kernel's first recorded call of a sharded frame (`_record_calls`)
    against its plain version on the same inputs: G's output rows of real
    slots and overflow words, A's rows, B's assembled image, F's rows and
    region flag. Fails on a disagreement. Returns {kernel: (max abs diff,
    what was held)}."""
    import torch

    from jello_tpu_torch.cuda import coverage as kcov
    from jello_tpu_torch.cuda import fine_interp as kint
    from jello_tpu_torch.cuda import fine_v2 as kfine
    from jello_tpu_torch.cuda import image_tap as ktap
    from jello_tpu_torch.pipeline import coverage as plain_cov
    from jello_tpu_torch.pipeline import fine_interp as plain_int
    from jello_tpu_torch.pipeline import image_tap as plain_tap

    out = {}
    if calls.get("interpret_tiles"):
        a = calls["interpret_tiles"][0]
        real = a[1] < grid
        got, ovf = kint.interpret_tiles(*a)
        want, ovf_p = plain_int.interpret_plain(*a[:8], resolved=a[9])
        err = _max_diff(got[real], want[real])
        if int(real.sum()) and (not err <= G_TOL or not torch.equal(ovf, ovf_p)):
            _fail(f"kernel G at stripe shapes disagrees with its plain version ({err:.3e})")
        out["G"] = (err, f"{int(real.sum())} real slots of {a[1].shape[0]}, first tile id "
                         f"{int(a[1][0])}")
    if calls.get("coverage_rows"):
        a = calls["coverage_rows"][0]
        err = _max_diff(kcov.coverage_rows(*a), plain_cov.coverage_rows_plain(*a))
        if not err <= (A_TOL if len(a) == 4 else MSAA_TOL):
            _fail(f"kernel A at stripe shapes disagrees with its plain version ({err:.3e})")
        out["A"] = (err, f"{a[1].shape[0]} rows, {'area' if len(a) == 4 else 'msaa'}")
    if calls.get("composite_records"):
        a = calls["composite_records"][0]
        t2r = kfine.tile_last_record(a[4], a[5])
        err = _max_diff(kfine.assemble_compact(kfine.composite_records(*a), t2r, ld),
                        kfine.assemble_compact(kfine.composite_records_plain(*a), t2r, ld))
        if not err <= B_TOL:
            _fail(f"kernel B at stripe shapes disagrees with its plain version ({err:.3e})")
        out["B"] = (err, f"{a[0].shape[0]} records")
    if calls.get("tap_records"):
        a = calls["tap_records"][0]
        (fg, flag), (fg_p, flag_p) = ktap.tap_records(*a), plain_tap.tap_records_plain(*a)
        err = _max_diff(fg, fg_p)
        if not err <= F_TOL or bool(flag) != bool(flag_p):
            _fail(f"kernel F at stripe shapes disagrees with its plain version ({err:.3e})")
        out["F"] = (err, f"{a[0].shape[0]} tap rows")
    return out


def _sharded_rank(group, jobs, frames):
    """One rank of the world-size-4 run: for each job (tag, make, frame
    inputs, caps, options, path), one frame with the kernel wrappers
    recorded, rank 1's calls held to their plain versions
    (`_hold_stripe_kernels`); then the launch counts of one frame, set to
    0 just before it and read just after; then `frames` frames timed
    (host clock to an idle card, after WARMUP) and the peak device memory
    they allocate in this rank's process. With `max_retries` in the
    options the frames go through `sharded2.RetryingRender`: the recorded
    frame settles the class (retries and growth), and the counted and
    timed frames are settled ones. A kernel that disagrees, or any
    exception (a flag still raised after the retries), ends the rank with
    a nonzero exit. Returns {tag: {"frame", "flags", "launches", "ms"
    (median, min, max), "peak_mib", "holds", and for a retried job
    "retries", "grown", "seg_ex_cap", "settled_retries"}} on the host."""
    import statistics
    import time

    import torch

    from jello_tpu_torch.cuda import coverage as kcov
    from jello_tpu_torch.cuda import fine_interp as kint
    from jello_tpu_torch.cuda import fine_v2 as kfine
    from jello_tpu_torch.cuda import image_tap as ktap
    from jello_tpu_torch.cuda.sharded import rank_inputs
    from jello_tpu_torch.cuda.sharded2 import RetryingRender
    from jello_tpu_torch.pipeline.render import unpack_layout

    counters = _counters()
    out = {}
    for tag, make, inputs, caps, opts, _ in jobs:
        ld = inputs[1]
        args = rank_inputs(inputs, group.device)
        retry = None
        if "max_retries" in opts:
            retry = RetryingRender(group, opts["max_retries"])

            def run(retry=retry, caps=caps):
                return retry(caps, *args)
        else:
            run = functools.partial(make(group, caps, **opts), args[0], unpack_layout(args[1]),
                                    *args[2:])
        calls = _record_calls([(kint, "interpret_tiles"), (kcov, "coverage_rows"),
                               (kfine, "composite_records"), (ktap, "tap_records")], run)
        info = {}
        if retry is not None:
            st = retry.state(caps, *args)
            info = {"retries": list(retry.last_retries), "grown": st[1], "seg_ex_cap": st[2]}
        holds = _hold_stripe_kernels(calls, ld, caps["tile_grid_cap"]) if group.rank == 1 else {}
        for fn, attr in counters.values():
            setattr(fn, attr, 0)
        res = run()
        # A program's outputs are its next frame's too: keep copies.
        frame, flags = res[0].cpu(), {k: bool(v) for k, v in res[1].items()}
        torch.cuda.synchronize()
        launches = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
        if retry is not None:
            info["settled_retries"] = list(retry.last_retries)
        for _ in range(WARMUP):
            run()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        times = []
        for _ in range(frames):
            torch.cuda.synchronize()
            t = time.perf_counter()
            run()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        out[tag] = dict(info, frame=frame, flags=flags, launches=launches,
                        ms=(statistics.median(times), min(times), max(times)),
                        peak_mib=(torch.cuda.max_memory_allocated() - held) / 2**20, holds=holds)
    return out


def _max_diff(a, b, mask=None):
    d = (a.double() - b.double()).abs()
    if mask is not None:
        d = d[mask]
    return d.max().item() if d.numel() else 0.0


def _small_clip_scene(jt):
    """A 256x256 scene that holds every record kind: a linear, a radial
    and a sweep gradient, an upscaled image, a nested clip under a
    MULTIPLY group, a src-over group with alpha and a dashed stroke."""
    import numpy as np

    from jello_tpu_torch.scenes import circle

    ident = jt.Affine.identity()
    stops = tuple(jt.ColorStop(o, jt.Color.rgba(*c, 1))
                  for o, c in ((0.0, (1, 1, 0)), (0.5, (1, 0, 1)), (1.0, (0, 0, 1))))
    full = jt.BezPath().move_to(0, 0).line_to(256, 0).line_to(256, 256).line_to(0, 256).close()
    s = jt.Scene()
    s.fill(jt.Fill.NON_ZERO, ident,
           jt.GradientBrush(jt.LinearGradient((0, 0), (256, 0), stops)), None, full)
    s.fill(jt.Fill.EVEN_ODD, ident, jt.GradientBrush(jt.RadialGradient(
        (100, 100), 5.0, (120, 110), 80.0, stops, jt.Extend.REFLECT)), None,
        circle(110, 105, 70))
    s.fill(jt.Fill.NON_ZERO, ident,
           jt.GradientBrush(jt.SweepGradient((180, 180), 0.0, 6.283185, stops)), None,
           circle(180, 180, 50))
    pix = np.zeros((4, 4, 4), np.uint8)
    pix[:2, :2], pix[2:, 2:] = [255, 0, 0, 255], [0, 255, 0, 255]
    pix[:2, 2:], pix[2:, :2] = [0, 0, 255, 255], [255, 255, 0, 128]
    s.fill(jt.Fill.NON_ZERO, jt.Affine.translate(10, 180) @ jt.Affine.scale(12),
           jt.ImageBrush(jt.Image(pixels=pix)), None,
           jt.BezPath().move_to(0, 0).line_to(4, 0).line_to(4, 4).line_to(0, 4).close())
    s.push_layer(jt.BlendMode(jt.Mix.MULTIPLY, jt.Compose.SRC_OVER), 0.8, ident,
                 circle(128, 128, 100))
    s.fill(jt.Fill.NON_ZERO, ident, jt.SolidBrush(jt.Color.rgba(0.2, 0.9, 0.4, 0.7)), None,
           circle(120, 120, 60))
    s.push_layer(jt.BlendMode(jt.Mix.CLIP, jt.Compose.SRC_OVER), 1.0, ident,
                 circle(140, 140, 40))
    s.fill(jt.Fill.NON_ZERO, ident, jt.SolidBrush(jt.Color.rgba(0.9, 0.1, 0.1, 1)), None, full)
    s.pop_layer()
    s.pop_layer()
    s.push_layer(jt.BlendMode(jt.Mix.NORMAL, jt.Compose.SRC_OVER), 0.6, ident,
                 circle(60, 200, 40.3))
    s.fill(jt.Fill.NON_ZERO, ident, jt.SolidBrush(jt.Color.rgba(0.1, 0.1, 0.9, 0.7)), None,
           circle(70, 190, 30))
    s.pop_layer()
    s.stroke(jt.Stroke(width=5, dash_pattern=(12, 6)).with_caps(jt.Cap.ROUND), ident,
             jt.SolidBrush(jt.Color.rgba(0, 0, 0, 1)), None,
             jt.BezPath().move_to(10, 30).cubic_to(80, 5, 170, 60, 246, 25))
    return s, jt.RenderParams(width=256, height=256, base_color=jt.Color.rgba(1, 1, 1, 1))


def _deep_clip_scene(jt, depth, size=64):
    """`depth` clip layers nested in one another over a ground, their rects
    shrinking by a fraction of a pixel a level, with a translucent fill
    every eighth level and in the two deepest (the scene of
    tests/test_torch_deep_clips.py)."""
    def rect(x0, y0, x1, y1):
        return jt.BezPath().move_to(x0, y0).line_to(x1, y0).line_to(x1, y1).line_to(x0, y1).close()

    ident = jt.Affine.identity()
    s = jt.Scene()
    s.fill(jt.Fill.NON_ZERO, ident, jt.SolidBrush(jt.Color.rgba(0.9, 0.8, 0.1, 1)), None,
           rect(0, 0, size, size))
    for k in range(depth):
        d = 0.37 * k
        s.push_layer(jt.BlendMode(jt.Mix.CLIP, jt.Compose.SRC_OVER), 1.0, ident,
                     rect(1 + d, 1.3 + d, size - 1 - 0.5 * d, size - 1.2 - 0.45 * d))
        if k % 8 == 7 or k >= depth - 2:
            s.fill(jt.Fill.NON_ZERO, ident,
                   jt.SolidBrush(jt.Color.rgba((k % 5) / 5, 0.3, 1 - (k % 7) / 7, 0.6)), None,
                   rect(0, 0, size, size))
    for _ in range(depth):
        s.pop_layer()
    return s, jt.RenderParams(width=size, height=size, base_color=jt.Color.rgba(1, 1, 1, 1))


def _over_minified_scene(jt):
    """A 512x512 frame on a gradient ground with four copies of a 512x512
    noise image drawn at 1/32 scale: a tile of such a draw spans 8 x 2 of
    the image tap's region windows, more than it sweeps, so the frame
    raises image_region_overflow."""
    import numpy as np

    ident = jt.Affine.identity()
    stops = (jt.ColorStop(0.0, jt.Color.rgba(0.1, 0.3, 0.8, 1)),
             jt.ColorStop(1.0, jt.Color.rgba(0.9, 0.8, 0.2, 1)))
    rect = jt.BezPath().move_to(0, 0).line_to(512, 0).line_to(512, 512).line_to(0, 512).close()
    pix = (np.random.default_rng(2).random((512, 512, 4)) * 255).astype(np.uint8)
    pix[..., 3] = 255
    brush = jt.ImageBrush(jt.Image(pixels=pix))
    s = jt.Scene()
    s.fill(jt.Fill.NON_ZERO, ident,
           jt.GradientBrush(jt.LinearGradient((0, 0), (512, 512), stops)), None, rect)
    for x, y in ((1, 1), (200.5, 40.25), (77, 301), (420.75, 450.5)):
        s.fill(jt.Fill.NON_ZERO, jt.Affine.translate(x, y) @ jt.Affine.scale(1.0 / 32.0), brush,
               None, rect)
    return s, jt.RenderParams(width=512, height=512, base_color=jt.Color.rgba(1, 1, 1, 1))


def _discs(jt, scale, dx=0.0):
    """A 1920x1080 frame of 400 translucent discs under one scale (then
    moved right by dx): the stream shape (tags, paths, words) is the same
    at every scale, the tiles, segments and coverage rows are not (at 8,
    some 40 times those at 1)."""
    import numpy as np

    from jello_tpu_torch.scenes import circle

    rng = np.random.default_rng(7)
    s = jt.Scene()
    xf = jt.Affine.scale(scale)
    if dx:
        xf = jt.Affine.translate(dx, 0.0) @ xf
    for _ in range(400):
        x, y, rad = rng.random(3) * [220, 120, 6] + [5, 5, 3]
        s.fill(jt.Fill.NON_ZERO, xf,
               jt.SolidBrush(jt.Color.rgba(*rng.random(3), 0.6)), None, circle(x, y, rad))
    return s, jt.RenderParams(width=1920, height=1080, base_color=jt.Color.rgba(1, 1, 1, 1))


def _attribution(tag, tab, med):
    """Print one profiled frame's attribution (`xtrace.attribute`):
    device ms and launches by stage (launches outside every stage
    under their own name), the top 8 call sites, the top 5 kernel
    kinds, and the call sites of torch's outer-dimension scans. Every
    stage but path_tiling (which hands path_count's segments on,
    `pipeline/tiling.py::path_tiling`) must launch, the launches outside the stages must take under
    OUTSIDE_MAX of the busy time, and every scan launch must come from
    a call site in pipeline/."""
    from jello_tpu_torch.pipeline.render import STAGES
    from jello_tpu_torch.xtrace import OUTSIDE

    busy = tab["lines"]["all streams"][1]
    stages = sorted(tab["stages"].items(), key=lambda kv: -kv[1][0])
    calls = tab["lines"]["host launch calls"]
    print(f"{tag}: device busy {busy:.3f} ms of the {med:.3f} ms frame "
          f"({100 * busy / med:.0f}%); the host spent {calls[1]:.3f} ms in {calls[2]:g} "
          f"CUDA launch, copy and memset calls; by stage: "
          + "; ".join(f"{k} {ms:.3f} ms x{n:g}" for k, (ms, n) in stages))
    print(f"{tag}: top call sites: " + "; ".join(
        f"{k} {ms:.3f} ms x{n:g}" for k, (ms, n) in
        sorted(tab["sources"].items(), key=lambda kv: -kv[1][0])[:8]))
    print(f"{tag}: top kernel kinds: " + "; ".join(
        f"{k[:70]} {ms:.3f} ms x{n:g}" for k, (ms, n) in
        sorted(tab["kinds"].items(), key=lambda kv: -kv[1][0])[:5]))
    scans = sorted(((ms, n, st, src, kind) for (st, src, kind), (ms, n)
                    in tab["sites"].items() if "scan_outer_dim" in kind), reverse=True)
    print(f"{tag}: outer-dimension scans, {sum(t[1] for t in scans):g} launches, "
          f"{sum(t[0] for t in scans):.3f} ms: " + "; ".join(
              f"{src} ({st}, {kind.split('::')[-1]}) {ms:.3f} ms x{n:g}"
              for ms, n, st, src, kind in scans))
    quiet = [k for k in STAGES if k != "path_tiling"
             and tab["stages"].get(k, (0.0, 0))[1] == 0]
    outside = tab["stages"].get(OUTSIDE, (0.0, 0))[0]
    if quiet or not outside <= OUTSIDE_MAX * busy:
        _fail(f"{tag}: stages without a launch {quiet}; {outside:.3f} of {busy:.3f} busy "
              f"ms outside the stages, from " + "; ".join(
                  f"{src} ({kind}) {ms:.3f} ms x{n:g}" for (st, src, kind), (ms, n)
                  in sorted(tab["sites"].items(), key=lambda kv: -kv[1][0]) if st == OUTSIDE))
    if any(not src.startswith("pipeline/") for _, _, _, src, _ in scans):
        _fail(f"{tag}: an outer-dimension scan launch has no call site in pipeline/")


# Each kernel's device function in a trace, by fragments of its name.
_KERNEL_NAMES = {
    "coverage_area": ("coverage_kernel", "AreaBody"),
    "coverage_msaa": ("coverage_kernel", "MsaaBody"),
    "fine_v2": ("fine_v2_kernel",),
    "monotone_land": ("land_kernel",),
    "lockstep_walk": ("lockstep_kernel",),
    "expand_euler": ("expand_kernel", "EulerBody"),
    "expand_crossings": ("expand_kernel", "CrossingBody"),
    "expand_rows": ("expand_kernel", "RowBody"),
    "image_tap": ("image_tap_kernel",),
    "fine_interp": ("interp_tile_kernel",),
    "fine_interp_b8": ("interp_batch_kernel",),
    "column_scan": ("colscan_apply",),
    "line_dda": ("line_dda_kernel",),
    "drop_scatter": ("drop_scatter_kernel",),
    "slot_tables": ("slot_tables_kernel",),
}


def _op_counts(tab):
    """{device operation name: launches a call} of an `xtrace.attribute`
    table, over every stream."""
    out = {}
    for _, name, _, n in tab["ops"]:
        out[name] = out.get(name, 0) + n
    return out


def _graph_ops(graph):
    """{device operation: nodes} of a captured CUDA graph
    (`jello_tpu_torch.cuda.program.graph_ops`)."""
    from jello_tpu_torch.cuda.program import graph_ops

    return graph_ops(graph)


def _trace_ops(fn):
    """({device operation: launches}, busy ms) of one call of fn, from a
    torch.profiler trace of the CUDA activity alone (after one warm-up
    call): kernels by name, memcpys and memsets together under "copies and
    memsets" (as `_graph_ops` counts them), busy ms the union of their
    intervals. The session starts with marker kernels (`torch.cuda._sleep`)
    and a pause of 50 ms, and the markers are left out of the count: on an
    H100 a session lost the first dozen kernels launched in it."""
    import json
    import tempfile
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(64):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            time.sleep(0.05)
            fn()
            torch.cuda.synchronize()
        path = f"{d}/trace.json"
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    ops, spans = {}, []
    for e in events:
        cat = e.get("cat")
        if e.get("ph") != "X" or cat not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        if "spin_kernel" in e["name"]:
            continue
        key = e["name"] if cat == "kernel" else "copies and memsets"
        ops[key] = ops.get(key, 0) + 1
        spans.append((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))))
    busy, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return ops, busy / 1e3


# Operations a traced frame holds before torch.profiler starts to lose some
# of them (H100: every frame of up to ~8,000 traced complete; eager 19a
# frames of ~96,000 lost 0 to 70 in a session).
OPS_TRACED_WHOLE = 20_000
OPS_LOST_MAX = 0.005  # the share of a larger frame's operations a trace may lose


def _replay_against_eager(graph, eager, tries=3):
    """A replay's device operations, read from its graph (`_graph_ops`:
    exactly what a replay runs), against the frame run eagerly, traced
    (`_trace_ops`) in up to `tries` sessions: (graph ops, eager ops, the
    eager frame's busy ms, verdict). A lost event only lowers a count, so
    each operation's eager count is the largest of its sessions; the
    sessions stop once every count equals the graph's ("equal"). A trace
    never shows an operation a frame did not run, so an eager count above
    the graph's is a replay that misses work ("differ"). Below
    OPS_TRACED_WHOLE operations the traces are whole and any other
    difference differs too; above it the eager counts may fall short of
    the graph's by events the profiler lost, at most OPS_LOST_MAX of the
    graph's operations ("equal up to lost events")."""
    want = _graph_ops(graph)
    best, busy = {}, None
    for _ in range(tries):
        ops, ms = _trace_ops(eager)
        busy = ms if busy is None else busy
        for k, v in ops.items():
            best[k] = max(best.get(k, 0), v)
        if best == want:
            return want, best, busy, "equal"
    total = sum(want.values())
    lost = sum(v - min(best.get(k, 0), v) for k, v in want.items())
    if (any(v > want.get(k, 0) for k, v in best.items()) or total <= OPS_TRACED_WHOLE
            or lost > OPS_LOST_MAX * total):
        return want, best, busy, "differ"
    return want, best, busy, f"equal up to {lost} lost events of {total}"


def _prepared(r, scene, params):
    """`r._prepare(scene, params)` with the packed layout unpacked into the
    dict of device views the stages read (`pipeline.render.unpack_layout`)."""
    from jello_tpu_torch.pipeline.render import unpack_layout

    est_key, ld, (scene_t, packed, ramps_t, atlas_t), depth = r._prepare(scene, params)
    return est_key, ld, (scene_t, unpack_layout(packed), ramps_t, atlas_t), depth


def _sha(*tensors):
    import hashlib

    import torch

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def _eager_frame(r, prepared, params):
    """`render_frame` and `pack_flags` at the class of `r`, eagerly: what
    the class's program captured. Returns (fine output, packed, keys)."""
    from jello_tpu_torch.cuda.render import frame

    caps, fine_impl = r._route(prepared, params, r._caps)
    return frame(*prepared[2], caps, fine_impl)


def _alternated(replay, eager, rounds=None, frames=None):
    """ROUNDS rounds of FRAMES replayed frames alternated with ROUNDS
    rounds of FRAMES eager frames (or `rounds` of `frames`), each frame
    followed by a synchronize: ({kind: [ms/frame of each round]}, {kind:
    [host ms of each call]})."""
    import time

    import torch

    rounds, frames = rounds or ROUNDS, frames or FRAMES
    ms, enq = {"replayed": [], "eager": []}, {"replayed": [], "eager": []}
    for _ in range(rounds):
        for kind, fn in (("replayed", replay), ("eager", eager)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(frames):
                t = time.perf_counter()
                fn()
                enq[kind].append((time.perf_counter() - t) * 1e3)
                torch.cuda.synchronize()
            ms[kind].append((time.perf_counter() - t0) * 1e3 / frames)
    return ms, enq


def _reserved_by_builds(programs, log):
    """Record in `log`, for each program a `Programs` (`cuda/program.py`)
    builds from now on, (summary, reserved MiB the build added): the
    device memory reserved after the capture minus before it, each read
    after a synchronize, which is the program's own pool (and the warm
    allocations of its capture). The hook holds `programs` weakly, so that
    dropping their owner frees the programs' graphs and pools at once."""
    import weakref

    import torch

    owner, get = weakref.ref(programs), type(programs).get

    def measured(key, build, summary):
        def build_measured():
            torch.cuda.synchronize()
            before = torch.cuda.memory_reserved()
            prog = build()
            torch.cuda.synchronize()
            log.append((summary, (torch.cuda.memory_reserved() - before) / 2**20))
            return prog
        return get(owner(), key, build_measured, summary)

    programs.get = measured


# The gate scenes edited inside one class (phase 13): extra discs appended
# to the scene, each edit a new layout (paths, stream offsets, target).
EDITS = (("as built, two discs appended", 2, 0, 0), ("a path removed", 1, 0, 0),
         ("a path added", 3, 0, 0), ("a cubic path turned into lines", 2, 1, 0),
         ("the target resized inside the tile grid bucket", 2, 0, 1),
         ("two paths added", 4, 0, 0), ("two cubic paths turned into lines", 2, 2, 0),
         ("a path removed at the resized target", 1, 0, 1), ("as built again", 2, 0, 0))


def _edited(jt, scene, params, extra, lines, resized):
    """`scene` with `extra` translucent discs appended (the first `lines` of
    them drawn as four lines to the same points as the disc's four cubics:
    the same path tags, fewer path data words) and, with `resized`, its
    target 16 pixels narrower and 8 lower: the same tile grid bucket
    (`tile_grid_cap`, a power of two of the tiles), another width in tiles.
    Returns (scene, params)."""
    import dataclasses

    from jello_tpu_torch.curve import circle

    s = jt.Scene()
    s.append(scene, jt.Affine.identity())
    for k in range(extra):
        x, y, r = 40.0 + 37.0 * k, 48.0 + 21.0 * k, 9.0 + 2.0 * k
        path = circle(x, y, r)
        if k < lines:
            path = (jt.BezPath().move_to(x + r, y).line_to(x, y + r).line_to(x - r, y)
                    .line_to(x, y - r).line_to(x + r, y).close())
        s.fill(jt.Fill.NON_ZERO, jt.Affine.identity(),
               jt.SolidBrush(jt.Color.rgba(0.1 + 0.2 * k, 0.5, 0.9 - 0.2 * k, 0.6)), None, path)
    if resized:
        params = dataclasses.replace(params, width=params.width - 16, height=params.height - 8)
    return s, params


def _edited_frames(scenes, smi):
    """Phase 13's edited scenes: configs 3 and 5, each edited through
    EDITS in one fresh renderer (a path removed or added, cubics turned
    into lines, the target resized inside the tile grid bucket). Each
    edit is a new stream shape, so its first render estimates and
    calibrates eagerly and then renders its calibrated class: a replay of
    the class's program once the class has one. Holds each edit's replay
    to its own eager frame at the class bit for bit (assembled image and
    u8 surface), no flag raised, 0 host-device synchronizations in a
    settled render_surface_async, and one program a class over the edits
    (the parent's tree keyed a program by the layout too: one an edit).
    Prints the programs built, each capture's reserved MiB and
    memory_reserved after each edit."""
    import hashlib

    import numpy as np
    import torch

    import jello_tpu_torch as jt
    from jello_tpu_torch.cuda.render import (
        Renderer,
        assemble,
        assemble_present,
        output_layout,
        unpack_flags,
    )

    for name in ("config3", "config5"):
        base, params0 = scenes[name]
        rc = Renderer(device="cuda")
        captures = []
        _reserved_by_builds(rc._cache, captures)
        classes, rows = [], []
        for what, extra, lines, resized in EDITS:
            scene, params = _edited(jt, base, params0, extra, lines, resized)
            u8 = rc.render_surface(scene, params)
            if rc._program is None:  # the class's first clean frame settles it
                u8 = rc.render_surface(scene, params)
            prog = rc._program
            flags = dict(rc.last_flags)
            fine_rep, _ = rc.render_device(scene, params)
            prepared = rc._prepare(scene, params)
            cls = rc._class_of(prepared, params, rc._caps)
            if cls not in classes:
                if classes:  # what sets this class apart from the first
                    first, new = dict(classes[0][3]), dict(cls[3])
                    diff = {k: (first.get(k), new.get(k)) for k in first.keys() | new.keys()
                            if first.get(k) != new.get(k)}
                    print(f"{name} edited: {what}: a class of its own, caps {diff} (the first "
                          "class's, this one's)")
                classes.append(cls)
            fine_e, packed_e, keys_e = _eager_frame(rc, prepared, params)
            out_ld = output_layout(prepared[1], prepared[2][1])
            same = (torch.equal(assemble(fine_rep, out_ld), assemble(fine_e, out_ld))
                    and np.array_equal(u8, assemble_present(fine_e, out_ld, True,
                                                            True).cpu().numpy()))
            flags_e = unpack_flags(packed_e.cpu().tolist(), *keys_e)[0]
            f_async, sites = _syncs(lambda: rc.render_surface_async(scene, params))
            async_same = (np.array_equal(f_async.result(), u8)
                          and not any(f_async.flags.values()))
            torch.cuda.synchronize()
            ld = prepared[1]
            rows.append((what, prog is not None, same, async_same, len(sites),
                         [k for k, v in {**flags, **flags_e}.items() if v],
                         hashlib.sha256(u8.tobytes()).hexdigest()[:16],
                         (int(ld["n_paths"]), int(ld["draw_tag_base"]),
                          int(ld["width_in_tiles"]), int(ld["target_width"]),
                          int(ld["target_height"])),
                         len(rc.compile_log), torch.cuda.memory_reserved() / 2**20))
            del fine_rep, fine_e, f_async
        for (what, replayed, same, async_same, n_sync, raised, sha, lay, n_prog,
             reserved) in rows:
            print(f"{name} edited: {what}: (paths, draw tag base, width in tiles, target) "
                  f"{lay}; a replay of the class's program: {replayed}; equal to its own eager "
                  f"frame bit for bit: {same}; frame in flight equal: {async_same}; "
                  f"{n_sync} host-device synchronizations in the settled async call; flags "
                  f"raised {raised}; u8 SHA-256 {sha}; programs built so far {n_prog}; "
                  f"memory_reserved {reserved:.1f} MiB")
        print(f"{name} edited: {len(EDITS)} edits, {len(classes)} classes, "
              f"{len(rc.compile_log)} programs built (the parent's tree: one program an edit, "
              f"{len(EDITS)} here); captures {[(round(mib, 1), k) for k, mib in captures]} "
              f"(reserved MiB each capture added); programs {rc.compile_log}; on {smi}")
        bad = [r[0] for r in rows if not (r[1] and r[2] and r[3]) or r[4] or r[5]]
        if bad or len(rc.compile_log) != len(classes):
            _fail(f"{name} edited: {bad} not a replay equal to its eager frame with no flag and "
                  f"no synchronization, or {len(rc.compile_log)} programs for {len(classes)} "
                  "classes")
        del rc
        torch.cuda.empty_cache()


def _compiled_frames(scenes, msaa_params, launches, on_path, smi):
    """Phase 13: every settled frame is its class's program replayed (a
    CUDA graph, `cuda/program.py`). For configs 1 to 5 in area and msaa8,
    config 4 in msaa16 and under JELLO_INTERP_BATCH=1, config 5 under
    JELLO_IMAGE_TAP=0, each through a fresh renderer: one program built
    when the settled class first renders and none on repeat frames
    (`compile_log`, capture seconds); the replayed frame (assembled image,
    tile2rank, u8 surface) equal to `render_frame` run eagerly at the same
    class, bit for bit (SHA-256); no host-device synchronization in a
    replayed render_surface_async; ms/frame and the host's ms a call in
    alternated rounds, replayed and eager; the replay's device operations,
    by name and count, equal to the eager frame's (both traced; a replay
    has no stage spans, so the stage attribution is the eager frame's), its
    busy ms, and the kernels of its path in the trace (added to
    `launches`, as the replays' launches, under "<case>_replayed"); the
    device memory with every program alive. Then three frames of one class
    moved by whole tiles, in flight at once, each equal to its own eager
    frame."""
    import os
    import statistics

    import numpy as np
    import torch

    import jello_tpu_torch
    from jello_tpu_torch.cuda.render import (
        Renderer,
        assemble,
        assemble_present,
        output_layout,
        unpack_flags,
    )

    cases = [(name, aa, "") for name in scenes for aa in ("area", "msaa8")]
    cases += [("config4", "msaa16", ""), ("config4", "area", "b8"), ("config5", "area", "tap0")]
    switches = {"b8": ("JELLO_INTERP_BATCH", "1"), "tap0": ("JELLO_IMAGE_TAP", "0")}
    kept = []
    torch.cuda.reset_peak_memory_stats()
    for name, aa, switch in cases:
        tag = "_".join(t for t in (name, "" if aa == "area" else aa, switch) if t)
        scene, params = scenes[name]
        if aa != "area":
            params = msaa_params[f"{name}_{aa}"]
        env = switches.get(switch)
        if env:
            os.environ[env[0]] = env[1]
        try:
            rc = Renderer(device="cuda")
            builds = []
            _reserved_by_builds(rc._cache, builds)
            rc.render_surface(scene, params)  # the estimate and the calibration: eager
            settling = len(rc.compile_log)
            u8 = rc.render_surface(scene, params)  # builds the class's program
            for _ in range(2):
                rc.render_surface(scene, params)
            fine_rep, _ = rc.render_device(scene, params)
            prog, flags_rep = rc._program, dict(rc.last_flags)
            prepared = rc._prepare(scene, params)
            fine_e, packed_e, keys_e = _eager_frame(rc, prepared, params)
            out_ld = output_layout(prepared[1], prepared[2][1])
            img_rep, img_e = assemble(fine_rep, out_ld), assemble(fine_e, out_ld)
            u8_e = assemble_present(fine_e, out_ld, True, True).cpu().numpy()
            flags_e = unpack_flags(packed_e.cpu().tolist(), *keys_e)[0]
            hashes = [(_sha(img_rep), _sha(img_e)), (_sha(fine_rep[1]), _sha(fine_e[1])),
                      (_sha(torch.from_numpy(u8)), _sha(torch.from_numpy(u8_e)))]
            del fine_rep, fine_e, img_rep, img_e
            f_async, sites = _syncs(lambda: rc.render_surface_async(scene, params))
            async_equal = np.array_equal(f_async.result(), u8) and not any(f_async.flags.values())
            del f_async

            def replay():
                return rc._enqueue(prepared, params, rc._caps)

            def eager():
                return _eager_frame(rc, prepared, params)

            ms, enq = _alternated(replay, eager)
            for _ in range(3):  # a session may drop device events: take it again
                n_k, n_c, busy, _, _, tab_r = _profile(replay)
                n_ke, n_ce, busy_e, _, _, tab_e = _profile(eager)
                ops_r, ops_e = _op_counts(tab_r), _op_counts(tab_e)
                if ops_r == ops_e:
                    break
            traced = {k: sum(n for op, n in ops_r.items() if all(f in op for f in frags))
                      for k, frags in _KERNEL_NAMES.items()}
            launches[f"{tag}_replayed"] = {k: int(round(n * prog.replays))
                                           for k, n in traced.items()}
            missing = [k for k in traced if on_path(k, tag) and traced[k] < 1]
            med_r, med_e = statistics.median(ms["replayed"]), statistics.median(ms["eager"])
            _, cap_s, summary = rc.compile_log[0]
            print(f"{tag}: compiled frame: the settling render built {settling} programs, the "
                  f"next {len(rc.compile_log)} ({cap_s:.3f} s to capture {summary}), four more "
                  f"frames none; replayed vs eager frame at the class, SHA-256 image "
                  f"{hashes[0][0][:16]} / {hashes[0][1][:16]}, tile2rank {hashes[1][0][:16]} / "
                  f"{hashes[1][1][:16]}, u8 {hashes[2][0][:16]} / {hashes[2][1][:16]}; "
                  f"{len(sites)} host-device synchronizations in a replayed "
                  f"render_surface_async; ms/frame replayed "
                  f"{[round(v, 3) for v in ms['replayed']]} (median {med_r:.3f}), eager "
                  f"{[round(v, 3) for v in ms['eager']]} (median {med_e:.3f}); host ms a call, "
                  f"median: replayed {statistics.median(enq['replayed']):.3f}, eager "
                  f"{statistics.median(enq['eager']):.3f}; the capture added "
                  f"{builds[0][1]:.1f} MiB reserved; on {smi}")
            print(f"{tag}: traced frame, replayed / eager: busy {busy:.3f} / {busy_e:.3f} ms, "
                  f"{n_k:g} / {n_ke:g} kernels and {n_c:g} / {n_ce:g} copies or memsets; device "
                  f"operations equal by name and count: {ops_r == ops_e}; the replay's kernels "
                  f"of the port a frame: {traced}; on {smi}")
            if not ops_r == ops_e:
                diff = {k: (ops_r.get(k, 0), ops_e.get(k, 0)) for k in set(ops_r) | set(ops_e)
                        if ops_r.get(k, 0) != ops_e.get(k, 0)}
                _fail(f"{tag}: the replayed frame's device operations differ from the eager "
                      f"frame's: {diff}")
            if (settling or len(rc.compile_log) != 1 or any(a != b for a, b in hashes)
                    or any(flags_rep.values()) or any(flags_e.values()) or sites
                    or not async_equal or missing):
                _fail(f"{tag}: the compiled frame failed: programs {rc.compile_log} after "
                      f"{settling} settling, hashes equal {[a == b for a, b in hashes]}, flags "
                      f"{flags_e}, synchronizations at {sites}, the async frame equal "
                      f"{async_equal}, kernels of the path not in the replay's trace {missing}")
            if aa == "area" and not switch:
                _attribution(f"{tag} (the eager frame at the program's class: a replay has "
                             f"no stage spans)", tab_e, med_e)
            kept.append(rc)
            del tab_r, tab_e
        finally:
            if env:
                del os.environ[env[0]]
    print(f"compiled frame: {sum(len(k._programs) for k in kept)} programs alive in "
          f"{len(kept)} renderers (beside the other phases' renderers): device memory allocated "
          f"{torch.cuda.memory_allocated() / 2**20:.1f} MiB, reserved "
          f"{torch.cuda.memory_reserved() / 2**20:.1f} MiB, peak in this phase "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; on {smi}")

    # Three frames of one class, the discs moved by whole tiles, in flight
    # at once: each equal to its own eager frame at the class.
    rf = Renderer(device="cuda")
    for _ in range(2):
        rf.render_surface(*_discs(jello_tpu_torch, 1.0))
    moved = [_discs(jello_tpu_torch, 1.0, dx) for dx in (0.0, 16.0, 32.0)]
    before = rf._program.replays
    in_flight = [rf.render_surface_async(*m) for m in moved]
    got = [f.result() for f in in_flight]
    same = []
    for (sc, pr), px in zip(moved, got):
        prepared = rf._prepare(sc, pr)
        fine_e = _eager_frame(rf, prepared, pr)[0]
        same.append(np.array_equal(px, assemble_present(
            fine_e, output_layout(prepared[1], prepared[2][1]), True, True).cpu().numpy()))
    raised = [sorted(k for k, v in f.flags.items() if v) for f in in_flight]
    print(f"compiled frame, frames in flight: 3 frames of one class (400 discs moved 0, 16 and "
          f"32 pixels) enqueued back to back, {rf._program.replays - before} replays; each "
          f"equal to its own eager frame: {same}; flags raised {raised}; programs "
          f"{len(rf.compile_log)}")
    if (not all(same) or any(raised) or rf._program.replays - before != 3
            or len(rf.compile_log) != 1 or np.array_equal(got[0], got[1])):
        _fail("frames in flight of one program differ from their eager frames")
    kept.clear()
    torch.cuda.empty_cache()
    _edited_frames(scenes, smi)


def _multi_gpu(scenes, launches, smi, card_peak):
    """Phase 14: both sharded paths at full size on `scenes` (configs 5, 4
    and 3; config 3 at world size 4 only), at world size 1 over NCCL in
    this process and at world size 4 over gloo in spawned ranks on the
    one card, each frame held to the single-card frame of the same scene
    at the class a single-card Renderer settled for it (FRAME_TOL, no
    flag) and required to launch every kernel of its path; the launch
    counts go into `launches`. At world size 1 every path is a program (a
    CUDA graph over NCCL), held to its eager frame as phase 13 holds the
    single card's (module docstring). At world size 4 the geometry-sharded frames
    go through `sharded2.RetryingRender` (a raised flag grows the ranks
    that raised it), and each rank's peak memory is printed beside
    `card_peak` ({config: the single card's frame's peak MiB}). Returns
    {kernel: max abs diff vs plain at stripe shapes, on rank 1}."""
    import dataclasses
    import statistics
    import tempfile
    import time
    from pathlib import Path

    import torch

    from jello_tpu_torch.cuda import collectives, sharded, sharded2
    from jello_tpu_torch.cuda.render import Renderer, assemble
    from jello_tpu_torch.renderer.params import AaConfig

    counters = _counters()

    def zero_counts():
        for fn, attr in counters.values():
            setattr(fn, attr, 0)

    def sharded_counts():
        return {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}

    def hold_sharded(tag, img, single, flags, launched, path, aa, has_atlas):
        """A gathered frame against the single-card frame, with its flags
        and launches (`_sharded_kernels`). Returns the max abs diff."""
        raised = [k for k, v in flags.items() if v]
        err = _max_diff(img, single)
        missing = sorted(k for k in _sharded_kernels(path, aa, has_atlas) if launched[k] < 1)
        print(f"{tag}: max|frame diff| vs the single-card frame {err:.3e}, flags raised "
              f"{raised}, kernels of the path that never launched {missing}; launches "
              f"{launched}")
        if (raised or not err <= FRAME_TOL or missing or not bool(torch.isfinite(img).all())
                or (launched["coverage_area"] and launched["coverage_msaa"])):
            _fail(f"{tag}: the sharded frame is wrong")
        return err

    full = {}  # (config, aa): (frame inputs, class, the single-card image on the card)
    for name, (scene, params) in scenes.items():
        rs = Renderer(device="cuda")
        inputs = sharded.frame_inputs(scene, params)
        for aa in ("area", "msaa8") if name != "config3" else ("area",):
            img = rs.render(scene, dataclasses.replace(params, antialiasing_method=AaConfig(aa)))
            full[(name, aa)] = (inputs, sharded.sharded_caps(rs._caps, inputs, aa),
                                torch.from_numpy(img).cuda())
        n_tags, n_slots = int(inputs[1]["n_path_tags"]), rs._caps["n_tag_slots"]
        print(f"{name}: {n_tags} path tags in {n_slots} tag slots; at 4 ranks "
              f"{sharded2.shard_caps(rs._caps, 4)['n_tag_slots']} a rank")
        del rs
    modes = (("19a", sharded, {"pallas_fine": True}, "area"),
             ("19a_fine_ref", sharded, {"pallas_fine": False}, "area"),
             ("19b", sharded2, {}, "area"),
             ("19b", sharded2, {}, "msaa8"))
    holders = []  # every program of this block alive until its end (ROADMAP queue 3)
    with tempfile.TemporaryDirectory() as d, collectives.init_group(
            0, 1, "nccl", Path(d) / "store", torch.device("cuda", 0)) as group:
        print(f"world size 1 over NCCL, in this process: each sharded frame is a program, a "
              f"CUDA graph with its collectives inside (the backend is nccl); on {smi}")
        for name in ("config5", "config4"):
            for path, mod, opts, aa in modes:
                inputs, caps_s, single = full[(name, aa)]
                ld, atlas = inputs[1], inputs[3]
                args = sharded.rank_inputs(inputs, "cuda")
                holder = (sharded2.RetryingRender(group) if mod is sharded2
                          else sharded.StripeFrames(group, opts["pallas_fine"]))
                holders.append(holder)
                builds = []
                _reserved_by_builds(holder._programs, builds)
                tag = f"{name}_ws1_{path}_{aa}"
                if not holder.capture:
                    _fail(f"{tag}: over NCCL the sharded frame is not captured")
                holder(caps_s, *args)  # eager: settles the class (and makes NCCL's buffers)
                settling = len(holder.compile_log)
                zero_counts()
                fine_out, flags = holder(caps_s, *args)[:2]  # builds the class's program
                torch.cuda.synchronize()
                launches[tag] = sharded_counts()
                prog = holder.last_program
                hold_sharded(tag, assemble(fine_out, ld), single, flags, launches[tag], path, aa,
                             atlas is not None)
                # The replay against the frame the program captured, run eagerly.
                eager_fn = holder.frame_fn(caps_s, *args)

                def replay():
                    return prog.run(args)

                rep_out = [t.clone() for t in replay()[:2]]
                eager_out = eager_fn(*args)[:2]
                same = [torch.equal(a, b) for a, b in zip(rep_out, eager_out)]
                del rep_out, eager_out
                _, where = _syncs(replay)
                for _ in range(2):
                    holder(caps_s, *args)
                # The reference fine stage's frames take seconds: one round of two.
                cuts = (1, 2) if path == "19a_fine_ref" else (ROUNDS, FRAMES)
                ms, enq = _alternated(replay, lambda: eager_fn(*args), *cuts)
                _, busy = _trace_ops(replay)
                ops_r, ops_e, busy_e, same_ops = _replay_against_eager(
                    prog.graph, lambda: eager_fn(*args))
                if same_ops != "equal":
                    diff = {k[:80]: (ops_r.get(k, 0), ops_e.get(k, 0))
                            for k in set(ops_r) | set(ops_e) if ops_r.get(k, 0) != ops_e.get(k, 0)}
                    print(f"{tag}: operations the eager traces hold other than the graph "
                          f"(graph, eager): {diff}")
                n_k, n_ke = (sum(v for k, v in o.items() if k != "copies and memsets")
                             for o in (ops_r, ops_e))
                n_c, n_ce = (o.get("copies and memsets", 0) for o in (ops_r, ops_e))
                traced = {k: sum(n for op, n in ops_r.items() if all(f in op for f in frags))
                          for k, frags in _KERNEL_NAMES.items()}
                launches[f"{tag}_replayed"] = {k: int(round(n * prog.replays))
                                               for k, n in traced.items()}
                nccl = {op[:60]: n for op, n in ops_r.items() if "nccl" in op.lower()}
                med_r, med_e = statistics.median(ms["replayed"]), statistics.median(ms["eager"])
                _, cap_s, summary = holder.compile_log[0]
                print(f"{tag}: program (a CUDA graph, NCCL inside): the settling frame built "
                      f"{settling}, the next {len(holder.compile_log)} ({cap_s:.3f} s to capture "
                      f"{summary}), three more frames none; the replay vs the eager frame at the "
                      f"class: fine output and packed flags equal {same}; {len(where)} host-device "
                      f"synchronizations in a replay; ms/frame replayed "
                      f"{[round(v, 3) for v in ms['replayed']]} (median {med_r:.3f}), eager "
                      f"{[round(v, 3) for v in ms['eager']]} (median {med_e:.3f}), {cuts[0]} "
                      f"rounds of {cuts[1]}; host ms a call, median: replayed "
                      f"{statistics.median(enq['replayed']):.3f}, eager "
                      f"{statistics.median(enq['eager']):.3f}; the capture added "
                      f"{builds[0][1]:.1f} MiB reserved; on {smi}")
                print(f"{tag}: the replay (its graph's nodes; traced for its busy ms) / the "
                      f"eager frame (traced): busy {busy:.3f} / {busy_e:.3f} ms, {n_k:g} / "
                      f"{n_ke:g} kernels and {n_c:g} / {n_ce:g} copies or memsets; device "
                      f"operations by name and count: {same_ops}; NCCL "
                      f"operations of a replay {nccl}; the replay's kernels of the port a frame: "
                      f"{traced}; peak device memory so far "
                      f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
                if same_ops == "differ":
                    _fail(f"{tag}: the replay's device operations differ from the eager frame's")
                missing = [k for k in _sharded_kernels(path, aa, atlas is not None)
                           if traced[k] < 1]
                if (settling or len(holder.compile_log) != 1 or not all(same) or where
                        or missing or holder.last_program is not prog):
                    _fail(f"{tag}: the sharded program failed: programs {holder.compile_log} "
                          f"after {settling} settling, equal {same}, synchronizations at {where}, "
                          f"kernels of the path not in the replay's trace {missing}")
                del args, fine_out
        torch.cuda.synchronize()
        print(f"world size 1: {sum(len(h.compile_log) for h in holders)} programs alive; device "
              f"memory allocated {torch.cuda.memory_allocated() / 2**20:.1f} MiB, reserved "
              f"{torch.cuda.memory_reserved() / 2**20:.1f} MiB; on {smi}")
        holders.clear()
        torch.cuda.synchronize()
    torch.cuda.empty_cache()

    print(f"world size 4 on one card over gloo, chosen explicitly (NCCL takes one card a "
          f"rank): four processes share the card, so the times below are no multi-GPU "
          f"speed; the frames run eagerly, a program's function run into its outputs, since "
          f"gloo copies through the host and no CUDA graph can hold it; on {smi}")
    for label, dry in (
            ("sharded.dryrun(4)", lambda: sharded.dryrun(4, "cuda", "gloo")),
            ("sharded2.dryrun(4, full_profile=True, image_tap=True)",
             lambda: sharded2.dryrun(4, "cuda", "gloo", full_profile=True, image_tap=True)),
            ("sharded2.dryrun(4, full_profile=True, image_tap=True, aa='msaa8')",
             lambda: sharded2.dryrun(4, "cuda", "gloo", full_profile=True, image_tap=True,
                                     aa="msaa8"))):
        t = time.perf_counter()
        err = dry()
        print(f"{label} over gloo: max|frame diff| vs the single-card frame {err:.3e} "
              f"({time.perf_counter() - t:.1f} s with the ranks' start, on {smi})")
    jobs = [("config4_ws4_19a_area", sharded.make_sharded_render, full[("config4", "area")][0],
             full[("config4", "area")][1], {"pallas_fine": True}, "19a")]
    for name in ("config4", "config5", "config3"):
        inputs, caps_s, _ = full[(name, "area")]
        jobs.append((f"{name}_ws4_19b_area", sharded2.make_sharded_render, inputs, caps_s,
                     {"max_retries": sharded2.MAX_RETRIES}, "19b"))
    t = time.perf_counter()
    stripe_err = {}  # kernel: max abs diff vs plain at stripe shapes, on rank 1
    per_rank = collectives.run_ranks(_sharded_rank, 4, "gloo", "cuda", (jobs, FRAMES))
    print(f"world size 4, configs 4, 5 and 3 at full size: {time.perf_counter() - t:.1f} s "
          f"with the ranks' start, on {smi}")
    for tag, _, inputs, caps_s, _, path in jobs:
        name = tag.split("_")[0]
        outs = [pr[tag] for pr in per_rank]
        fine_out, flags = outs[0]["frame"], outs[0]["flags"]
        launches[tag] = {k: sum(o["launches"][k] for o in outs) for k in counters}
        if any(not torch.equal(o["frame"], fine_out) for o in outs[1:]):
            _fail(f"{tag}: the ranks gathered different frames")
        print(f"{tag}: settled frame, ms/frame by rank (median of {FRAMES}, min, max): "
              + "; ".join(f"rank {r} {o['ms'][0]:.3f} ({o['ms'][1]:.3f}, {o['ms'][2]:.3f})"
                          for r, o in enumerate(outs))
              + "; peak device memory a frame by rank (MiB) "
              + ", ".join(f"{o['peak_mib']:.1f}" for o in outs)
              + f" (the single card's frame: {card_peak.get(name, float('nan')):.1f}); on {smi}")
        if "retries" in outs[0]:
            if any(o["retries"] != outs[0]["retries"] or o["grown"] != outs[0]["grown"]
                   for o in outs[1:]):
                _fail(f"{tag}: the ranks grew different classes")
            cl = sharded2.shard_caps(caps_s, 4)
            grown = {r: {k: f"{cl[k]} -> {v}" for k, v in g.items()}
                     for r, g in outs[0]["grown"].items()}
            print(f"{tag}: {len(outs[0]['retries'])} retries to settle "
                  f"({[(raised, what) for raised, what, _ in outs[0]['retries']]}); grown by "
                  f"rank {grown}; seg_ex_cap {cl['seg_ex_cap']} -> "
                  f"{outs[0]['seg_ex_cap'] or cl['seg_ex_cap']} on every rank; retries of the "
                  f"settled frame {len(outs[0]['settled_retries'])}")
            if outs[0]["settled_retries"]:
                _fail(f"{tag}: a settled frame grew its class again")
        for kernel, (err, what) in outs[1]["holds"].items():
            print(f"{tag}: rank 1, kernel {kernel} at stripe shapes ({what}): max|diff| vs "
                  f"plain {err:.3e}")
            stripe_err[kernel] = max(stripe_err.get(kernel, 0.0), err)
        hold_sharded(tag, assemble(fine_out, inputs[1]).cuda(), full[(name, "area")][2], flags,
                     launches[tag], path, "area", inputs[3] is not None)
    del per_rank, full
    return stripe_err


def main():
    import argparse
    import faulthandler
    import dataclasses
    import json
    import os
    import statistics
    import time

    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config5-cpu-reference", action="store_true",
                    help="also render config 5 through Renderer(device='cpu') and time it")
    opts = ap.parse_args()
    faulthandler.enable(all_threads=True)  # a crash in native code prints the Python stacks

    # ---- 1. environment --------------------------------------------------
    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is False")
    smi = _smi()
    print(f"nvidia-smi: {smi}")
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  device {torch.cuda.get_device_name(0)}")

    from jello_tpu_torch import native
    from jello_tpu_torch.cuda import build
    from jello_tpu_torch.cuda import coverage as kcov
    from jello_tpu_torch.cuda import expand as kx
    from jello_tpu_torch.cuda import fine_hybrid as khybrid
    from jello_tpu_torch.cuda import fine_interp as kint
    from jello_tpu_torch.cuda import fine_v2 as kfine
    from jello_tpu_torch.cuda import image_tap as ktap
    from jello_tpu_torch.cuda import land as kland
    from jello_tpu_torch.cuda import line_dda as kline
    from jello_tpu_torch.cuda import lockstep as kwalk
    from jello_tpu_torch.cuda import slot_tables as kslot
    from jello_tpu_torch.cuda.coverage import compute_area_rows, coverage_rows
    from jello_tpu_torch.cuda.fine_v2 import (
        assemble_compact,
        build_records,
        composite_records,
        composite_records_plain,
        tile_last_record,
    )
    from jello_tpu_torch.cuda.render import (
        Renderer,
        assemble,
        assemble_present,
        frame,
        frame_routing,
        present,
        unpack_flags,
    )
    from jello_tpu_torch.pipeline.render import STAGES
    from jello_tpu_torch.profiler import Profiler
    from jello_tpu_torch.xtrace import OUTSIDE
    from jello_tpu_torch.pipeline import coverage as plain_cov
    from jello_tpu_torch.pipeline import expand as plain_expand
    from jello_tpu_torch.pipeline import fine_interp as plain_int
    from jello_tpu_torch.pipeline import image_tap as plain_tap
    from jello_tpu_torch.pipeline import land as plain_land
    from jello_tpu_torch.pipeline import lockstep as plain_walk
    from jello_tpu_torch.pipeline import render as pipeline_render
    from jello_tpu_torch.pipeline.render import geometry
    from jello_tpu_torch.renderer.params import AaConfig
    from jello_tpu_torch.scenes import GATE_SCENES, circle
    from tools.torch_frame_times import (
        bare_entries,
        bare_interp,
        bare_tap,
        flat_outputs,
        h_sweep,
        h_sweep_lines,
    )

    config1, config2, config3, config4, config5 = (GATE_SCENES[k] for k in (1, 2, 3, 4, 5))
    print("path encoder: " + ("native (g++)" if native.get_lib() is not None
                              else "the Python twin (no native library)"))
    # ---- 2. build --------------------------------------------------------
    t = time.perf_counter()
    build.build(verbose=True, force=True)
    build.kernels()
    print(f"build: {time.perf_counter() - t:.1f} s")
    # Kernels A, C, D and E as ptxas built them: registers, spills and
    # static shared memory a thread or CTA (E's staged window is dynamic
    # shared memory, printed with its calls), and A's persistent grid
    # (resident CTAs a multiprocessor times the multiprocessors, from
    # those registers and its shared memory).
    for src in ("coverage.cu", "land.cu", "lockstep.cu", "expand.cu", "image_tap.cu",
                "fine_interp.cu", "scan.cu", "line_dda.cu", "scatter.cu", "slot_tables.cu"):
        for name, regs, st, ld, smem in _ptxas_summary(build.LOG[src]):
            print(f"ptxas, {src}: {name}: {regs} registers, spill stores {st} B, "
                  f"spill loads {ld} B, static shared memory {smem} B")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for samples, body in ((0, "area"), (8, "msaa8"), (16, "msaa16")):
        n = kcov.persistent_ctas(samples)
        print(f"kernel A, {body} body: {n} persistent CTAs ({n / sms:g} a multiprocessor, "
              f"{sms} multiprocessors)")

    def hold_msaa_rows(aa, stream, rs, re_, bd, eo, tag):
        """Kernel A's MSAA body against its plain version on one frame's
        coverage inputs: the resolved rows must be equal (MSAA_TOL), in
        [0, 1] and multiples of 1 / samples. Returns the max abs diff."""
        offsets = plain_cov.sample_offsets(aa)
        got = coverage_rows(stream, rs, re_, bd, offsets, eo)
        want = plain_cov.coverage_rows_plain(stream, rs, re_, bd, offsets, eo)
        torch.cuda.synchronize()
        err = _max_diff(got, want)
        n = len(offsets)
        live = got[re_ > rs]
        quantized = torch.equal(got * n, torch.round(got * n))
        print(f"{tag}: kernel A, {aa}: {live.shape[0]} rows, {int(eo.sum())} of them "
              f"even-odd, max|row diff| {err:.3e}, mean coverage {float(live.mean()):.4f}, "
              f"multiples of 1/{n}: {quantized}")
        if (not err <= MSAA_TOL or not quantized or torch.isnan(got).any()
                or float(got.min()) < 0.0 or float(got.max()) > 1.0
                or not 0.0 < float(live.mean()) < 1.0):
            _fail(f"{tag}: kernel A's {aa} body disagrees with its plain version")
        return err

    def run_segments(stream, rs, re_):
        """The segments of the stream that lie in some row's run."""
        nonempty = re_ > rs
        edges = torch.zeros(stream.shape[0] + 1, dtype=torch.int32, device=stream.device)
        ones = torch.ones_like(rs[nonempty])
        edges.index_add_(0, rs[nonempty].long(), ones)
        edges.index_add_(0, re_[nonempty].long(), -ones)
        return stream[torch.cumsum(edges, 0)[:-1] > 0]

    def report_a(body, tag, run_seg, nonempty, R, ms, plain_ms, bound, what):
        print(f"kernel A, {body}, {tag}: {run_seg.shape[0]} segments in {nonempty} rows of "
              f"{R}, {what}: {ms:.4f} ms"
              + (f" vs plain {plain_ms:.3f} ms" if plain_ms is not None else "")
              + f", bound {bound[0]:.4f} ms by {bound[1]} ({100 * bound[0] / ms:.1f}% of it), "
              f"on {smi}")

    def time_area_rows(stream, rs, re_, bd, tag, n_plain):
        """Kernel A's area body timed on one frame's coverage inputs, beside
        its plain version (n_plain calls; 0: not timed) and its bound.
        Returns (ms, plain ms or None, (bound_ms, bound_by)).

        The bound counts what the function needs, as the MSAA body's does:
        the terms that depend on the segment and the pixel row only (y,
        the two clips, dyc, the two divisions and their products, the
        y_edge term: 12 operations) once a (segment, pixel row); the rest
        once a (segment, pixel): about 20 (startx, x0, x1, the min/max
        and clamps, the trapezoid and its division, the products and
        sums) where the segment crosses part of the pixel's row (dyc !=
        0, counted from this run's segments), 2 (the y_edge term's sum)
        where it does not. Bytes: the inputs once and the [R, 256] rows
        written."""
        run_seg = run_segments(stream, rs, re_)
        y = run_seg[:, 1:2] - torch.arange(16, device=stream.device, dtype=torch.float32)
        dyc = y.clamp(0, 1) - (y + (run_seg[:, 3:4] - run_seg[:, 1:2])).clamp(0, 1)
        spans = int((dyc != 0).sum())
        pairs = run_seg.shape[0] * 16
        bound = _bound(_nbytes(stream, rs, re_, bd) + rs.shape[0] * 1024,
                       pairs * 12 + spans * 16 * 20 + (pairs - spans) * 16 * 2)
        ms = _time_ms(lambda: coverage_rows(stream, rs, re_, bd), 20)
        plain_ms = None
        if n_plain:
            plain_ms = _time_ms(lambda: plain_cov.coverage_rows_plain(stream, rs, re_, bd),
                                n_plain)
        report_a("area", tag, run_seg, int((re_ > rs).sum()), rs.shape[0], ms, plain_ms, bound,
                 f"{spans} of {pairs} (segment, pixel row) pairs with dyc != 0")
        return ms, plain_ms, bound

    def time_msaa_rows(aa, stream, rs, re_, bd, eo, tag, n_plain):
        """Kernel A's MSAA body timed on one frame's coverage inputs, beside
        its plain version (n_plain calls; 0: not timed) and its bound.
        Returns (ms, plain ms or None, (bound_ms, bound_by)).

        The bound is by float operations unless the rows are few, and it
        counts what the function needs, not what this kernel spends: the
        crossing test, the crossing's x and the y_edge term depend on the
        segment, the pixel row and the sample only, not on the pixel, so
        they are counted once for each (segment, pixel row, sample): two
        comparisons, the y_edge comparison, its product and the valid
        product (5), and where the segment crosses the sample row a
        difference, a division, a product, a sum and the winding's sign
        (5 more); the crossed ones are counted from this run's segments.
        For each (segment, pixel, sample) only `xi < xs` and the
        accumulation are left (2). Bytes: the inputs once and 1 KB for
        every row of the table."""
        offsets = plain_cov.sample_offsets(aa)
        n_s = len(offsets)
        run_seg = run_segments(stream, rs, re_)
        ys = (torch.arange(16, device=stream.device)[:, None]
              + (torch.arange(n_s, device=stream.device)[None, :] + 0.5) / n_s).reshape(1, -1)
        crossed = int(((run_seg[:, 1:2] <= ys) != (run_seg[:, 3:4] <= ys)).sum())
        sample_rows = run_seg.shape[0] * 16 * n_s
        triples = sample_rows * 16
        bound = _bound(_nbytes(stream, rs, re_, bd, eo) + rs.shape[0] * 1024,
                       triples * 2 + sample_rows * 5 + crossed * 5)
        ms = _time_ms(lambda: coverage_rows(stream, rs, re_, bd, offsets, eo), 20)
        plain_ms = None
        if n_plain:
            plain_ms = _time_ms(
                lambda: plain_cov.coverage_rows_plain(stream, rs, re_, bd, offsets, eo), n_plain)
        report_a(aa, tag, run_seg, int((re_ > rs).sum()), rs.shape[0], ms, plain_ms, bound,
                 f"{crossed} crossed (segment, pixel row, sample) triples of {sample_rows}")
        return ms, plain_ms, bound

    # ---- 3. config 3's real inputs ---------------------------------------
    # Settle config 3's capacity class, then run its geometry once on the
    # renderer's route, recording the new kernels' inputs.
    scene3, params3 = config3()
    warm = Renderer(device="cuda")
    warm.render(scene3, params3)
    _, _, (scene_t, layout_t, ramps_t, _), _ = _prepared(warm, scene3, params3)
    caps = dict(warm._caps, **frame_routing(0, False, 0))
    out = {}
    calls = _record_calls(
        [(kland, "monotone_land"), (kwalk, "lockstep_walk"), (kx, "expand_euler"),
         (kx, "expand_crossings"), (kx, "expand_rows"), (kline, "line_tables"),
         (kslot, "slot_tables")],
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
    stream, rs, re_, bd, _, _, _ = plain_cov.slot_rank_rows(cmds, counted, caps)
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
    a_ms, a_plain_ms, a_bound = time_area_rows(stream, rs, re_, bd, "config 3", 5)
    as_ms = _time_ms(lambda: compute_area_rows(cmds, counted, caps), 20)
    as_plain_ms = _time_ms(lambda: plain_cov.compute_area_rows(cmds, counted, caps), 5)
    print(f"whole coverage stage, config 3: {as_ms:.3f} ms vs plain {as_plain_ms:.3f} ms")
    # The MSAA body on the same rows (with the rows' rules), held and timed.
    eo3 = plain_cov.slot_rank_rows(cmds, counted, dict(caps, aa_mode="msaa8"))[4]
    err_msaa3 = {}
    for aa in ("msaa8", "msaa16"):
        err_msaa3[aa] = hold_msaa_rows(aa, stream, rs, re_, bd, eo3, "config 3")
        time_msaa_rows(aa, stream, rs, re_, bd, eo3, "config 3", 0)

    # ---- 5. kernel B vs plain --------------------------------------------
    rec = build_records(dict(cmds, area_row=ids_k), caps)
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
    print(f"kernel B, config 3: {b_ms:.3f} ms vs plain {b_plain_ms:.3f} ms")
    del (stages, cmds, counted, stream, rs, re_, bd, rows_k, rows_p, area_k, ids_k,
         area_p, ids_p, rec, b_args, out_k, out_p, t2r, img_k, img_p)

    # ---- 6. kernels C, D, E, E', E'' vs plain ------------------------------
    def hold_geometry_kernels(calls, tag):
        """Every recorded call of C, D, E, E' and E'' against its plain
        version. Returns {kernel: (max abs diff, got, want)} of the last
        call of each."""
        held = {}
        err_land = 0.0
        for args in calls["monotone_land"]:
            got = kland.monotone_land(*args)
            want = plain_land.monotone_land(*args)
            err_land = max([err_land] + [_max_diff(g, w) for g, w in zip(got, want)])
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                _fail(f"{tag}: kernel C differs from its plain version (K={len(args[2])}, "
                      f"rows {args[0].shape[0]}, out {args[3]})")
        held["C"] = (err_land, None, None)
        for args in calls["lockstep_walk"]:
            got = kwalk.lockstep_walk(*args)
            want = plain_walk.lockstep_walk(*args)
            for name, g, w in zip(("rec (t0, t1, n)", "count", "not_done", "iters"), got, want):
                if not torch.equal(g, w):
                    _fail(f"{tag}: kernel D: {name} differs from the plain version "
                          f"(max diff {_max_diff(g, w):.3e})")
            held["D"] = (max(_max_diff(g, w) for g, w in zip(got, want)), got, want)
        for args in calls["expand_euler"]:
            table, recs, counts, EC, sentinel = args
            incl, _ = plain_expand.expand_prefix(counts)
            got = kx.expand_euler(*args)
            want = plain_expand.euler_lines(table, recs, incl, counts, EC, sentinel)
            if not (torch.equal(got[5], want[5]) and torch.equal(got[4], want[4])):
                _fail(f"{tag}: kernel E: valid or path differs from the plain version")
            err = max(_max_diff(g, w, want[5]) for g, w in zip(got[:4], want[:4]))
            if not err <= E_TOL:
                _fail(f"{tag}: kernel E: end points {err:.3e} from the plain version")
            held["E"] = (err, got, want)
        for args in calls["expand_crossings"]:
            Pc, ncc, SC, T = args
            incl, _ = plain_expand.expand_prefix(ncc, assume_compact=True)
            got = kx.expand_crossings(*args)
            want = plain_expand.tile_crossings(Pc, incl, ncc, SC, T)
            for name, i in (("tile_slot", 0), ("bump_slot", 2), ("bump_delta", 3)):
                if not torch.equal(got[i], want[i]):
                    _fail(f"{tag}: kernel E': {name} differs from the plain version")
            err = max(_max_diff(got[1][k], want[1][k]) for k in want[1])
            if not err <= E_TOL:
                _fail(f"{tag}: kernel E': segments {err:.3e} from the plain version")
            held["E'"] = (err, got, want)
        for args in calls["expand_rows"]:
            PRTc, nrr, RC, T = args
            incl, _ = plain_expand.expand_prefix(nrr, assume_compact=True)
            got = kx.expand_rows(*args)
            want = plain_expand.row_deltas(PRTc, incl, nrr, RC, T)
            if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                _fail(f"{tag}: kernel E'': row slots or deltas differ from the plain version")
            held["E''"] = (max(_max_diff(got[i], want[i]) for i in (0, 1)), got, want)
        return held

    geometry_wrappers = [(kland, "monotone_land"), (kwalk, "lockstep_walk"),
                         (kx, "expand_euler"), (kx, "expand_crossings"), (kx, "expand_rows"),
                         (kline, "line_tables"), (kslot, "slot_tables")]
    held3 = hold_geometry_kernels(calls, "config 3")
    res = {}
    # C, at all three call sites; timed at the sorted-run landing (K = 3).
    land_runs = [a for a in calls["monotone_land"] if len(a[2]) == 3][0]
    # The yardstick: one scatter_ into a zeroed tensor, its index and
    # stacked values made outside the timed call. The port never calls it.
    l_pos, l_keep, l_vals, l_len = land_runs
    l_v = torch.stack([v.to(torch.float32) for v in l_vals])
    l_idx = torch.where(l_keep & (l_pos >= 0) & (l_pos < l_len), l_pos, l_len).long()
    l_idx = l_idx.expand(l_v.shape[0], -1).contiguous()

    def land_library():
        out = torch.zeros((l_v.shape[0], l_len + 1), dtype=torch.float32, device=l_v.device)
        return out.scatter_(1, l_idx, l_v)

    got = kland.monotone_land(*land_runs)
    if not torch.equal(torch.stack(got), land_library()[:, :l_len]):
        _fail("kernel C differs from the library scatter")
    # Bound: positions, keep flags and K value rows read, K output rows
    # written; one comparison a row.
    res["C"] = (held3["C"][0], _time_ms(lambda: kland.monotone_land(*land_runs), 20),
                _time_ms(lambda: plain_land.monotone_land(*land_runs), 20),
                _bound(_nbytes(l_pos, l_keep, l_v, got), l_pos.shape[0]),
                _time_ms(land_library, 20))
    # The bare C entry on prepared buffers: no checks, no allocation, no
    # list of rows; what the wrapper adds is the difference.
    lib = build.kernels()
    l_out = torch.empty((len(l_vals), l_len), dtype=torch.float32, device=l_pos.device)
    l_ptrs = [v.data_ptr() for v in l_vals] + [None] * (3 - len(l_vals))
    l_codes = [0 if v.dtype == torch.int32 else 1 for v in l_vals] + [0] * (3 - len(l_vals))
    l_stream = torch.cuda.current_stream().cuda_stream

    def land_bare():
        build.check("jello_monotone_land", lib.jello_monotone_land(
            l_pos.data_ptr(), l_keep.data_ptr(), *l_ptrs, *l_codes, l_out.data_ptr(),
            l_pos.shape[0], len(l_vals), l_len, l_stream))

    land_bare()
    if not torch.equal(l_out, torch.stack(got)):
        _fail("kernel C's bare entry differs from its wrapper")
    c_bare_ms = _time_ms(land_bare, 20)
    print(f"kernel C: {len(calls['monotone_land'])} calls equal; sorted-run landing "
          f"{land_runs[0].shape[0]} rows -> {land_runs[3]}: {res['C'][1]:.4f} ms (the bare C "
          f"entry {c_bare_ms:.4f} ms) vs plain {res['C'][2]:.3f} ms, library scatter_ "
          f"{res['C'][4]:.4f} ms, bound {res['C'][3][0]:.5f} ms, on {smi}")
    if res["C"][1] > res["C"][4]:
        print("kernel C: NOTE slower than the library scatter_ in this run")
    # Device operations a landing, at each recorded call site.
    for args in calls["monotone_land"]:
        n_k, n_c = _device_ops(lambda: kland.monotone_land(*args))
        print(f"kernel C, K={len(args[2])}, {args[0].shape[0]} rows -> {args[3]}: {n_k:g} "
              f"kernels and {n_c:g} memsets or copies a call")
        if n_k != 1 or n_c > 1:
            _fail("kernel C: a landing is more than one kernel and one memset")

    def time_geometry_kernels(calls, held, tag, n_plain):
        """Kernels D, E, E' and E'' timed on one frame's recorded calls:
        each wrapper beside its bare C entry on buffers allocated once
        (whose outputs must equal the wrapper's), its plain version
        (n_plain calls of it; 0: not timed) and its bound, with the
        device operations a wrapper call puts on the card (D: one kernel
        and at most one memset, of `iters`; E: the prefix scan's one or
        two kernels and the expansion, no memset). Returns {kernel: (max
        abs diff, ms, plain ms or None, (bound_ms, bound_by), None, bare
        ms)}."""
        def plain_time(fn, n):
            return _time_ms(fn, n) if n_plain else None

        bare = bare_entries(calls)
        out = {}
        (w_args,) = calls["lockstep_walk"]
        err_d, got, _ = held["D"]
        # Bound: the work table read, the records, counts and flags
        # written. An item that emits L segments walks a binary
        # subdivision tree of L leaves, 2L - 1 iterations, plus the one
        # that finds it done; ~400 float operations an iteration.
        emits_i = (got[0][2] != 0).sum(0)
        emits = int(emits_i.sum())
        walk_iters = 2 * emits + int(w_args[1].sum())
        out["D"] = (err_d, _time_ms(lambda: kwalk.lockstep_walk(*w_args), 20),
                    plain_time(lambda: plain_walk.lockstep_walk(*w_args), 3),
                    _bound(_nbytes(w_args[0], w_args[1], got), walk_iters * 400), None)
        # The walk's lane efficiency: iterations entered, summed over the
        # items, over 32 times the sum of each warp's largest (a thread an
        # item, warps of 32 consecutive items). An item that finishes
        # entered 2L iterations (the tree's 2L - 1 and the one that finds
        # it done), one that did not, all IT; invalid items none.
        IT = w_args[2]
        entered = torch.where(got[2], IT, 2 * emits_i)
        warps = torch.nn.functional.pad(entered, (0, -entered.shape[0] % 32)).view(-1, 32)
        lane_eff = int(entered.sum()) / max(1, 32 * int(warps.max(1).values.sum()))
        print(f"kernel D, {tag}: {w_args[0].shape[0]} work rows, IT {IT}, iters "
              f"{int(got[3])} (reckoned from the records: {int(entered.max())}), lines "
              f"{int(got[1].sum())}, segments {emits}, lane efficiency {lane_eff:.3f} "
              f"({int(entered.sum())} iterations entered in {int((warps.max(1).values > 0).sum())} "
              f"busy warps)")

        (e_args,) = calls["expand_euler"]
        table, recs, counts, EC, sentinel = e_args
        incl, _ = plain_expand.expand_prefix(counts)
        err_e, got, want = held["E"]
        # Bound: table, records and counts read, six outputs a slot
        # written; one line evaluation of ~120 float operations for each
        # live line (a line's start point is the previous line's end).
        out["E"] = (err_e, _time_ms(lambda: kx.expand_euler(*e_args), 20),
                    plain_time(lambda: plain_expand.euler_lines(table, recs, incl, counts, EC,
                                                                sentinel), 3),
                    _bound(_nbytes(table, recs, counts, got[:6]), int(want[5].sum()) * 120),
                    None)
        # A CTA's dynamic shared memory (csrc/expand.cu: the window's prefix
        # entries and counts, then EulerBody::smem_bytes, 128 slots a CTA).
        e_smem = (2 * 128 + (recs.shape[1] + 4) * 128) * 4
        print(f"kernel E, {tag}: {EC} slots, {int(want[5].sum())} lines, max|end point diff| "
              f"{err_e:.3e}, {e_smem} B of dynamic shared memory a CTA at IT {recs.shape[1]}")

        (c_args,) = calls["expand_crossings"]
        Pc, ncc, SC, T = c_args
        incl_c, _ = plain_expand.expand_prefix(ncc, assume_compact=True)
        err_c, got, _ = held["E'"]
        # Bound: the line table and counts read, five float64 and three
        # int32 a slot written; ~60 operations a crossing (float64 here,
        # held to the float32 rate, so the bound errs low).
        out["E'"] = (err_c, _time_ms(lambda: kx.expand_crossings(*c_args), 20),
                     plain_time(lambda: plain_expand.tile_crossings(Pc, incl_c, ncc, SC, T), 5),
                     _bound(_nbytes(Pc, ncc, got[:4]), int(ncc.sum()) * 60), None)
        print(f"kernel E', {tag}: {Pc.shape[0]} lines -> {SC} slots ({int(ncc.sum())} "
              f"crossings), max|segment diff| {err_c:.3e}")

        (r_args,) = calls["expand_rows"]
        PRTc, nrr, RC, T = r_args
        incl_r, _ = plain_expand.expand_prefix(nrr, assume_compact=True)
        err_r, got, _ = held["E''"]
        # Bound: the line table and counts read, two int32 a slot written;
        # ~10 operations a row.
        out["E''"] = (err_r, _time_ms(lambda: kx.expand_rows(*r_args), 20),
                      plain_time(lambda: plain_expand.row_deltas(PRTc, incl_r, nrr, RC, T), 5),
                      _bound(_nbytes(PRTc, nrr, got[:2]), int(nrr.sum()) * 10), None)
        print(f"kernel E'', {tag}: {PRTc.shape[0]} lines -> {RC} slots ({int(nrr.sum())} rows)")
        wrappers = {"D": (kwalk.lockstep_walk, "lockstep_walk", w_args),
                    "E": (kx.expand_euler, "expand_euler", e_args),
                    "E'": (kx.expand_crossings, "expand_crossings", c_args),
                    "E''": (kx.expand_rows, "expand_rows", r_args)}
        for k, (fn, name, args) in wrappers.items():
            call, outs = bare[name]
            call()
            if not all(torch.equal(a, b) for a, b in zip(flat_outputs(fn(*args)), outs)):
                _fail(f"{tag}: kernel {k}'s bare C entry differs from its wrapper")
            bare_ms = _time_ms(call, 20)
            n_k, n_c = _device_ops(lambda: fn(*args))
            ok = (n_k == 1 and n_c <= 1) if k == "D" else (n_k in (2, 3) and n_c == 0)
            if not ok:
                _fail(f"{tag}: kernel {k}: {n_k:g} kernels and {n_c:g} memsets or copies a call")
            out[k] = out[k] + (bare_ms,)
            ms, plain_ms, (bound, by) = out[k][1], out[k][2], out[k][3]
            print(f"kernel {k}, {tag}: {ms:.4f} ms (the bare C entry {bare_ms:.4f} ms)"
                  + (f" vs plain {plain_ms:.3f} ms" if plain_ms is not None else "")
                  + f", bound {bound:.5f} ms by {by} ({100 * bound / ms:.1f}% of it; the bare "
                  f"entry {100 * bound / bare_ms:.1f}%), {n_k:g} kernels and {n_c:g} memsets or "
                  f"copies a call, on {smi}")
        return out

    res.update(time_geometry_kernels(calls, held3, "config 3", 1))
    j3 = _kernel_j(calls["line_tables"], "config 3", smi, 5)
    l3 = _kernel_l(calls["slot_tables"], "config 3", smi, 5)
    del calls, held3, got, warm

    # ---- 7. config 5: kernel F, and kernel B with the tap's table --------
    t = time.perf_counter()
    scene5, params5 = config5()
    print(f"config 5 scene built in {time.perf_counter() - t:.1f} s")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    warm = Renderer(device="cuda")
    t = time.perf_counter()
    warm.render(scene5, params5)
    print(f"config 5: first render (estimate, grow, calibrate) {time.perf_counter() - t:.1f} s, "
          f"peak device memory {(torch.cuda.max_memory_allocated() - held) / 2**20:.1f} MiB")
    print(f"config 5 calibrated caps: {warm._caps}")
    _, ld5, (scene_t, layout_t, ramps_t, atlas_t), _ = _prepared(warm, scene5, params5)
    if atlas_t is None:
        _fail("config 5 resolved to no image atlas")
    caps = dict(warm._caps, **frame_routing(0, True, 0))
    out = {}
    calls5 = _record_calls(
        geometry_wrappers,
        lambda: out.update(stages=geometry(scene_t, layout_t, caps)[0]))
    stages = out["stages"]
    cmds, counted = stages["cmds"], stages["counted"]
    # The geometry kernels and A at this frame's shapes, the first with
    # stroke offsets: held to their plain versions and timed (the JSON
    # line carries config 3's times for C, D, E, E', E'' and area A).
    held5 = hold_geometry_kernels(calls5, "config 5")
    stream, rs, re_, bd, eo, _, _ = plain_cov.slot_rank_rows(cmds, counted,
                                                             dict(caps, aa_mode="msaa8"))
    lens = (re_ - rs).clamp(min=0)
    bins = (("0", 0, 0), ("1-4", 1, 4), ("5-16", 5, 16), ("17-64", 17, 64),
            ("65-256", 65, 256), ("over 256", 257, 2**31 - 1))
    print("config 5 run lengths, rows of: " + ", ".join(
        f"{label} segments {int(((lens >= lo) & (lens <= hi)).sum())}" for label, lo, hi in bins)
        + f"; {lens.shape[0]} rows, longest {int(lens.max())}")
    err_a5 = _max_diff(coverage_rows(stream, rs, re_, bd),
                       plain_cov.coverage_rows_plain(stream, rs, re_, bd))
    # Kernel A's MSAA body on the same coverage inputs: resolved rows.
    err_msaa = {aa: max(hold_msaa_rows(aa, stream, rs, re_, bd, eo, "config 5"),
                        err_msaa3[aa]) for aa in ("msaa8", "msaa16")}
    # At config 5's 872k segments every body is bound by its operations.
    time_area_rows(stream, rs, re_, bd, "config 5", 0)
    for aa in ("msaa8", "msaa16"):
        time_msaa_rows(aa, stream, rs, re_, bd, eo, "config 5", 0)
    print("config 5 recorded calls: "
          + ", ".join(f"{k} x{len(v)}" for k, v in sorted(calls5.items()))
          + "; max|diff| vs plain: "
          + ", ".join(f"{k} {v[0]:.3e}" for k, v in held5.items())
          + f", A {err_a5:.3e} over {int(lens.sum())} segments in {int((lens > 0).sum())} rows")
    if not err_a5 <= A_TOL:
        _fail("config 5: kernel A disagrees with its plain version")
    for k, v in held5.items():
        res[k] = (max(res[k][0], v[0]),) + res[k][1:]
    time_geometry_kernels(calls5, held5, "config 5", 0)
    res["J"] = _kernel_j(calls5["line_tables"], "config 5", smi, 3)
    res["J"] = (max(res["J"][0], j3[0]),) + res["J"][1:]
    res["L"] = _kernel_l(calls5["slot_tables"], "config 5", smi, 3)
    res["L"] = (max(res["L"][0], l3[0]),) + res["L"][1:]
    del calls5, held5, stream, rs, re_, bd, eo, lens
    area5, ids5, _ = compute_area_rows(cmds, counted, caps)
    rec5 = build_records(dict(cmds, area_row=ids5), caps)
    out = {}
    tap_calls = _record_calls(
        [(ktap, "tap_records")],
        lambda: out.update(tap=plain_tap.image_tap(rec5, cmds, atlas_t, layout_t, caps)))
    (f_args,) = tap_calls["tap_records"]
    fg_tab, region_ovf, recs_ovf = out["tap"]
    if bool(region_ovf) or bool(recs_ovf):
        _fail("config 5's tap stage raised a flag at the calibrated class")
    got_f, flag_f = ktap.tap_records(*f_args)
    want_f, flag_p = plain_tap.tap_records_plain(*f_args)
    torch.cuda.synchronize()
    n_img = int((f_args[0][:, 0] == 5).sum())
    err_f = _max_diff(got_f, want_f)
    print(f"kernel F: {f_args[0].shape[0]} rows, {n_img} image records, atlas "
          f"{tuple(f_args[1].shape)}, max|fg diff| {err_f:.3e}, region flag "
          f"{bool(flag_f)} (plain {bool(flag_p)}), rows past the count zero: "
          f"{not bool(got_f[n_img:].any())}")
    if (not err_f <= F_TOL or bool(flag_f) != bool(flag_p) or n_img < 1
            or bool(got_f[n_img:].any()) or not bool(got_f[:n_img].any())
            or not torch.equal(got_f, fg_tab)):
        _fail("kernel F disagrees with its plain version")
    # Bound: the records and the atlas read once, 4 KB a row written; ~60
    # float operations a pixel of a live record.
    res["F"] = (err_f, _time_ms(lambda: ktap.tap_records(*f_args), 20),
                _time_ms(lambda: plain_tap.tap_records_plain(*f_args), 5),
                _bound(_nbytes(f_args[0], f_args[1], got_f), n_img * 256 * 60), None)
    print(f"kernel F: {res['F'][1]:.3f} ms vs plain {res['F'][2]:.3f} ms, bound "
          f"{res['F'][3][0]:.4f} ms by {res['F'][3][1]}")
    # F's bare C entry on buffers allocated once, its device operations a
    # wrapper call and its device time, and its resident CTAs.
    bare_f, (out_bf, flag_bf) = bare_tap(f_args)
    bare_f()
    if not torch.equal(out_bf, got_f) or bool(flag_bf.any()) != bool(flag_f):
        _fail("kernel F's bare C entry differs from its wrapper")
    f_bare_ms = _time_ms(bare_f, 20)
    res["F"] = res["F"] + (f_bare_ms,)
    f_ops = _device_ops(lambda: ktap.tap_records(*f_args))
    f_us = _device_us(bare_f)
    print(f"kernel F, config 5: IRC {f_args[0].shape[0]} rows for {n_img} live image records; "
          f"wrapper {res['F'][1]:.4f} ms, the bare C entry {f_bare_ms:.4f} ms; {f_ops[0]:g} "
          f"kernels and {f_ops[1]:g} memsets or copies a wrapper call; device: "
          + ("; ".join(f"{k} {us:.1f} us" for k, us in f_us.items()) or "no event captured")
          + f"; {ktap.resident_ctas()} CTAs resident a multiprocessor, on {smi}")
    # More than the design's operations fail; a reading below it is the
    # profiler's dropped events (see _device_ops), not a missing launch,
    # which the launch counts of phase 9 would show.
    if f_ops[0] > 1 or f_ops[1] > 1:
        _fail("kernel F: a call puts more than one kernel and one memset on the device")

    b_args = (rec5, area5, ramps_t, layout_t["base_color"], cmds["tile_start"],
              cmds["tile_end"], layout_t["width_in_tiles"], fg_tab)
    out_k = composite_records(*b_args)
    out_p = composite_records_plain(*b_args)
    t2r = tile_last_record(cmds["tile_start"], cmds["tile_end"])
    img_k = assemble_compact(out_k, t2r, ld5)
    img_p = assemble_compact(out_p, t2r, ld5)
    bare = assemble_compact(composite_records(*b_args[:7]), t2r, ld5)
    torch.cuda.synchronize()
    err_b5 = (img_k - img_p).abs().max().item()
    paints = (img_k - bare).abs().max().item()
    kind5 = rec5[:, 0]
    live5 = (rec5[:, 3] >= 0) & (rec5[:, 3] < caps["tile_grid_cap"]) & ((rec5[:, 4] & 2) == 0)
    n_solid = int((live5 & (kind5 == 1)).sum())
    n_grad = int((live5 & (kind5 >= 2) & (kind5 <= 4)).sum())
    n_image = int((live5 & (kind5 == 5)).sum())
    print(f"kernel B with images: records {rec5.shape[0]} (solid {n_solid}, gradient "
          f"{n_grad}, image {n_image}) max|image diff| {err_b5:.3e} nan "
          f"{bool(torch.isnan(img_k).any())}; the table moves the frame by {paints:.3f}")
    if not err_b5 <= B_TOL or torch.isnan(img_k).any() or not paints > 1e-2:
        _fail("kernel B with the image table disagrees with its plain version")
    # Bound, from what this run's records make the kernel touch: 64 B read
    # and 4 KB written for each record of a tile's run, 1 KB of coverage
    # for each that paints, 4 KB of the image table for each image record
    # among them, the stop table, run boundaries and base color once; ~14
    # float operations a pixel of a solid or image record, ~120 of a
    # gradient record. Capacity rows past the runs are never touched.
    run_len = (cmds["tile_end"] - cmds["tile_start"]).clamp(min=0)
    n_walked = int(run_len.sum())
    edges = torch.zeros(rec5.shape[0] + 1, dtype=torch.int32, device=rec5.device)
    nonempty = run_len > 0
    edges.index_add_(0, cmds["tile_start"][nonempty].long(),
                     torch.ones_like(run_len[nonempty]))
    edges.index_add_(0, cmds["tile_end"][nonempty].long(),
                     -torch.ones_like(run_len[nonempty]))
    walked = torch.cumsum(edges, 0)[:-1] > 0
    paints5 = walked & ((rec5[:, 4] & 2) == 0) & (kind5 >= 1) & (kind5 <= 5)
    n_paint, n_paint_img = int(paints5.sum()), int((paints5 & (kind5 == 5)).sum())
    b_bytes = (n_walked * (64 + 4096) + n_paint * 1024 + n_paint_img * 4096
               + _nbytes(ramps_t, layout_t["base_color"], cmds["tile_start"],
                         cmds["tile_end"]))
    b_bound = _bound(b_bytes, 256 * (14 * (n_solid + n_image) + 120 * n_grad))
    print(f"kernel B, config 5: {n_walked} records in tile runs, {n_paint} paint "
          f"({n_paint_img} image), {b_bytes / 1e6:.1f} MB needed of "
          f"{_nbytes(b_args, out_k) / 1e6:.1f} MB of capacity")
    b5_ms = _time_ms(lambda: composite_records(*b_args), 20)
    b5_plain_ms = _time_ms(lambda: composite_records_plain(*b_args), 2)
    print(f"kernel B, config 5: {b5_ms:.3f} ms vs plain {b5_plain_ms:.3f} ms, bound "
          f"{b_bound[0]:.4f} ms by {b_bound[1]}")
    # Kernel B's resolved branch: the same records over the resolved rows
    # of an msaa8 frame, every row clipped to [0, 1] and no rule applied.
    area5_m, ids5_m, _ = compute_area_rows(cmds, counted, dict(caps, aa_mode="msaa8"))
    if not torch.equal(ids5_m, ids5):
        _fail("config 5: the record ids of the MSAA coverage table differ from area mode's")
    m_args = (rec5, area5_m) + b_args[2:] + (True,)
    img_m = assemble_compact(composite_records(*m_args), t2r, ld5)
    img_mp = assemble_compact(composite_records_plain(*m_args), t2r, ld5)
    torch.cuda.synchronize()
    err_b5m = (img_m - img_mp).abs().max().item()
    moved = (img_m - img_k).abs().max().item()
    print(f"kernel B, resolved branch, config 5 (msaa8 rows): max|image diff| {err_b5m:.3e} "
          f"nan {bool(torch.isnan(img_m).any())}; the msaa8 rows move the frame by {moved:.3f}")
    if not err_b5m <= B_TOL or torch.isnan(img_m).any() or not moved > 1e-2:
        _fail("kernel B's resolved branch disagrees with its plain version")
    # A row in [0, 1] reads the same under either rule and under none, so
    # the switch itself is held on rows that leave [0, 1]: the area rows
    # made negative wherever a path covers.
    n_args = (rec5, -1.5 * area5.abs()) + b_args[2:] + (True,)
    img_n = assemble_compact(composite_records(*n_args), t2r, ld5)
    img_np = assemble_compact(composite_records_plain(*n_args), t2r, ld5)
    by_rule = assemble_compact(composite_records(*n_args[:8]), t2r, ld5)
    torch.cuda.synchronize()
    err_b5n = (img_n - img_np).abs().max().item()
    switched = (img_n - by_rule).abs().max().item()
    print(f"kernel B, resolved branch on negative rows: max|image diff| {err_b5n:.3e}; the "
          f"switch moves the frame by {switched:.3f}")
    if not err_b5n <= B_TOL or not switched > 1e-2:
        _fail("kernel B does not read its resolved switch as its plain version does")
    res["B"] = (max(err_b, err_b5, err_b5m, err_b5n), b5_ms, b5_plain_ms, b_bound, None)
    del area5_m, ids5_m, m_args, img_m, img_mp, n_args, img_n, img_np, by_rule
    del (stages, cmds, counted, area5, ids5, rec5, out, tap_calls, f_args, fg_tab, got_f,
         want_f, b_args, out_k, out_p, t2r, img_k, img_p, bare, kind5, live5, warm,
         run_len, edges, nonempty, walked, paints5)
    torch.cuda.empty_cache()

    # ---- 8. config 4: kernels G and H, and kernel B with clip groups -------
    import jello_tpu_torch

    scene4, params4 = config4()
    warm = Renderer(device="cuda")
    t = time.perf_counter()
    warm.render(scene4, params4)
    print(f"config 4: first render {time.perf_counter() - t:.2f} s, frames run again for: "
          f"{warm.last_retries}; legacy tiles {warm.last_stats['legacy_tiles']} of "
          f"{warm._caps['tile_grid_cap']}, records {warm.last_stats['cmds']}, longest tape "
          f"{warm.last_stats['max_cmds']}")
    print("config 4 calibrated caps: " + ", ".join(f"{k} {warm._caps[k]}" for k in (
        "legacy_tiles_cap", "cmds_per_tile", "blend_depth", "cmd_cap", "pair_cap",
        "tiles_cap", "area_rows_cap", "seg_cap", "n_clips_cap")))
    _, ld4, (scene_t, layout_t, ramps_t, atlas_t), depth4 = _prepared(warm, scene4, params4)
    caps = dict(warm._caps, **frame_routing(int(ld4["n_clips"]), atlas_t is not None, depth4))
    stages = geometry(scene_t, layout_t, caps)[0]
    cmds, counted = stages["cmds"], stages["counted"]
    out = {}
    calls4 = _record_calls(
        [(kint, "interpret_tiles"), (kfine, "composite_records")],
        lambda: out.update(fine=khybrid.fine_hybrid(cmds, counted, ramps_t, atlas_t, layout_t,
                                                    caps)))
    if any(bool(v) for v in out["fine"][1].values()):
        _fail("config 4's fine stage raised a flag at the calibrated class")
    g_args = calls4["interpret_tiles"][0][:8]  # without the batch switch
    (b_args,) = calls4["composite_records"]
    g_counts, g_ids, _, g_slab, g_rows = g_args[:5]
    GRID4, BD4 = caps["tile_grid_cap"], g_args[7]

    def plain_g():
        return plain_int.interpret_plain(*g_args)

    real = g_ids < GRID4
    n_real = int(real.sum())
    got_g, ovf_g = kint.interpret_tiles(*g_args)
    got_h, ovf_h = kint.interpret_tiles(*g_args, batch=True)
    want_g, ovf_p = plain_g()
    torch.cuda.synchronize()
    err_g = _max_diff(got_g[real], want_g[real])
    err_h = _max_diff(got_h[real], want_g[real])
    err_hg = _max_diff(got_h[real], got_g[real])
    print(f"kernel G: {g_slab.shape[0]} slots ({n_real} legacy tiles), tapes of up to "
          f"{int(g_counts[:-1].max())} of {g_slab.shape[1]} records, blend depth {BD4}: "
          f"max|row diff| vs plain {err_g:.3e}; kernel H vs plain {err_h:.3e}, vs G "
          f"{err_hg:.3e}; overflow words equal: G {torch.equal(ovf_g, ovf_p)}, H "
          f"{torch.equal(ovf_h, ovf_g)}; any overflow {bool(ovf_g.any())}; nan "
          f"{bool(torch.isnan(got_g[real]).any())}")
    if (n_real < 1 or not err_g <= G_TOL or not err_h <= G_TOL or not err_hg <= H_TOL
            or not torch.equal(ovf_g, ovf_p) or not torch.equal(ovf_h, ovf_g)
            or torch.isnan(got_g[real]).any()):
        _fail("kernel G or H disagrees with its plain version")
    # Bound, from what this run's tapes make the kernel touch: 64 B a
    # record walked, 1 KB of coverage for each fill, gradient, image or
    # EndClip record with segments, 4 KB and a word written per slot,
    # counts, ids, the stop table and the base color once (no atlas texel:
    # config 4 has no image). Float operations a pixel: ~12 a solid fill,
    # ~120 a gradient, ~45 an EndClip (its blend), none a BeginClip.
    # Suppressed records read no row, so the bound errs high by them.
    steps = torch.arange(g_slab.shape[1], device=g_slab.device)[None, :] < g_counts[:-1, None]
    kinds = g_slab[:, :, 0][steps]
    segs = g_slab[:, :, 2][steps]
    n_walk = int(steps.sum())
    n_rowed = int(((kinds != 6) & (segs > 0)).sum())
    n_solid4 = int((kinds == 1).sum())
    n_grad4 = int(((kinds >= 2) & (kinds <= 4)).sum())
    n_end4 = int((kinds == 7).sum())
    g_bytes = (n_walk * 64 + n_rowed * 1024 + g_slab.shape[0] * (4096 + 4)
               + _nbytes(g_counts, g_ids, g_args[2], ramps_t))
    g_bound = _bound(g_bytes, 256 * (12 * n_solid4 + 120 * n_grad4 + 45 * n_end4))
    g_ms = _time_ms(lambda: kint.interpret_tiles(*g_args), 20)
    h_ms = _time_ms(lambda: kint.interpret_tiles(*g_args, batch=True), 20)
    g_plain_ms = _time_ms(plain_g, 2)
    res["G"] = (err_g, g_ms, g_plain_ms, g_bound, None)
    res["H"] = (max(err_h, err_hg), h_ms, g_plain_ms, g_bound, None)
    print(f"kernels G and H, config 4: {n_walk} records walked ({n_solid4} solid, {n_grad4} "
          f"gradient, {n_end4} EndClip, {int((kinds == 6).sum())} BeginClip; {n_rowed} read a "
          f"row), {g_bytes / 1e6:.1f} MB needed; G {g_ms:.3f} ms, H {h_ms:.3f} ms vs plain "
          f"{g_plain_ms:.3f} ms, bound {g_bound[0]:.4f} ms by {g_bound[1]}")
    # The legacy slots' tape lengths and record kinds (last_stats' max_cmds
    # covers every tile, not only these).
    lens4 = g_counts[:-1][real]
    print("config 4 legacy-slot tapes: " + ", ".join(
        f"{label} records {int(((lens4 >= lo) & (lens4 <= hi)).sum())}"
        for label, lo, hi in (("0", 0, 0), ("1", 1, 1), ("2-3", 2, 3), ("4-7", 4, 7),
                              ("8-15", 8, 15), ("16+", 16, 2**31 - 1)))
        + f"; {n_real} legacy slots of {g_slab.shape[0]}, longest {int(lens4.max())}; records "
        "by kind: " + ", ".join(f"{name} {int((kinds == k).sum())}" for k, name in (
            (1, "solid"), (2, "linear"), (3, "radial"), (4, "sweep"), (5, "image"),
            (6, "BeginClip"), (7, "EndClip"))))

    rec4 = b_args[0]
    out_k = composite_records(*b_args)
    out_p = composite_records_plain(*b_args)
    t2r = tile_last_record(cmds["tile_start"], cmds["tile_end"])
    img_k = assemble_compact(out_k, t2r, ld4)
    img_p = assemble_compact(out_p, t2r, ld4)
    torch.cuda.synchronize()
    err_b4 = (img_k - img_p).abs().max().item()
    in_run = (rec4[:, 3] >= 0) & (rec4[:, 3] < GRID4)
    fl4, kind4 = rec4[:, 4], rec4[:, 0]
    n_legacy_rec = int((in_run & ((fl4 & 2) != 0)).sum())
    n_member = int((in_run & ((fl4 & 16) != 0)).sum())
    n_endg = int((in_run & ((fl4 & 32) != 0)).sum())
    paint4 = in_run & ((fl4 & 2) == 0) & (kind4 >= 1) & (kind4 <= 5)
    n_grad_b4 = int((paint4 & (kind4 >= 2)).sum())
    n_paint4 = int(paint4.sum())
    print(f"kernel B with groups: records {int(in_run.sum())} in tile runs ({n_legacy_rec} of "
          f"legacy tiles, {n_member} group members and BeginClips, {n_endg} group EndClips, "
          f"{n_paint4} paint) max|image diff| {err_b4:.3e} nan "
          f"{bool(torch.isnan(img_k).any())}")
    if not err_b4 <= B_TOL or torch.isnan(img_k).any() or n_endg < 1:
        _fail("kernel B with clip groups disagrees with its plain version")
    # Bound as in phase 7: 64 B read and 4 KB written for each record of a
    # tile's run, 1 KB of coverage for each that paints or ends a group.
    b4_bytes = (int(in_run.sum()) * (64 + 4096) + (n_paint4 + n_endg) * 1024
                + _nbytes(ramps_t, layout_t["base_color"], cmds["tile_start"],
                          cmds["tile_end"]))
    b4_bound = _bound(b4_bytes, 256 * (14 * (n_paint4 - n_grad_b4) + 120 * n_grad_b4
                                       + 14 * n_endg))
    b4_ms = _time_ms(lambda: composite_records(*b_args), 20)
    b4_plain_ms = _time_ms(lambda: composite_records_plain(*b_args), 2)
    res["B groups"] = (err_b4, b4_ms, b4_plain_ms, b4_bound, None)
    print(f"kernel B with groups, config 4: {b4_ms:.3f} ms vs plain {b4_plain_ms:.3f} ms, "
          f"bound {b4_bound[0]:.4f} ms by {b4_bound[1]} ({b4_bytes / 1e6:.1f} MB needed)")
    # Kernel A's three bodies on config 4's coverage inputs, held and timed.
    stream, rs, re_, bd, eo, _, _ = plain_cov.slot_rank_rows(cmds, counted,
                                                             dict(caps, aa_mode="msaa8"))
    err_a4 = _max_diff(coverage_rows(stream, rs, re_, bd),
                       plain_cov.coverage_rows_plain(stream, rs, re_, bd))
    print(f"config 4: kernel A, area: max|row diff| {err_a4:.3e}")
    if not err_a4 <= A_TOL:
        _fail("config 4: kernel A disagrees with its plain version")
    time_area_rows(stream, rs, re_, bd, "config 4", 0)
    for aa in ("msaa8", "msaa16"):
        err = hold_msaa_rows(aa, stream, rs, re_, bd, eo, "config 4")
        res["A " + aa] = (max(err, err_msaa[aa]),) + time_msaa_rows(
            aa, stream, rs, re_, bd, eo, "config 4", 2) + (None,)
    del stream, rs, re_, bd, eo

    # The resolved branch of G, H and B: config 4's fine stage once more
    # with msaa8 in the caps, its real inputs (resolved rows) recorded.
    out = {}
    calls4m = _record_calls(
        [(kint, "interpret_tiles"), (kfine, "composite_records")],
        lambda: out.update(fine=khybrid.fine_hybrid(cmds, counted, ramps_t, atlas_t, layout_t,
                                                    dict(caps, aa_mode="msaa8"))))
    if any(bool(v) for v in out["fine"][1].values()):
        _fail("config 4's msaa8 fine stage raised a flag at the calibrated class")
    gm_all = calls4m["interpret_tiles"][0]
    (bm_args,) = calls4m["composite_records"]
    if gm_all[9] is not True or bm_args[8] is not True:
        _fail("fine_hybrid did not ask for the resolved branch under msaa8")
    gm_args = gm_all[:8]
    got_gm, ovf_gm = kint.interpret_tiles(*gm_args, False, True)
    got_hm, ovf_hm = kint.interpret_tiles(*gm_args, True, True)
    want_gm, ovf_pm = plain_int.interpret_plain(*gm_args, resolved=True)
    torch.cuda.synchronize()
    err_gm = _max_diff(got_gm[real], want_gm[real])
    err_hm = _max_diff(got_hm[real], want_gm[real])
    err_hgm = _max_diff(got_hm[real], got_gm[real])
    moved = _max_diff(got_gm[real], got_g[real])
    print(f"kernels G and H, resolved branch (msaa8 rows): max|row diff| G vs plain "
          f"{err_gm:.3e}, H vs plain {err_hm:.3e}, H vs G {err_hgm:.3e}; overflow words equal: "
          f"{torch.equal(ovf_gm, ovf_pm) and torch.equal(ovf_hm, ovf_gm)}; the msaa8 rows move "
          f"the legacy tiles by {moved:.3f}")
    if (not err_gm <= G_TOL or not err_hm <= G_TOL or not err_hgm <= H_TOL
            or not torch.equal(ovf_gm, ovf_pm) or not torch.equal(ovf_hm, ovf_gm)
            or torch.isnan(got_gm[real]).any() or not moved > 1e-2):
        _fail("the resolved branch of kernel G or H disagrees with its plain version")
    # The switch itself, on rows that leave [0, 1] (as for kernel B).
    gn_args = g_args[:4] + (-1.5 * g_rows.abs(),) + g_args[5:]
    got_gn, _ = kint.interpret_tiles(*gn_args, False, True)
    got_hn, _ = kint.interpret_tiles(*gn_args, True, True)
    want_gn, _ = plain_int.interpret_plain(*gn_args, resolved=True)
    by_rule, _ = kint.interpret_tiles(*gn_args)
    torch.cuda.synchronize()
    err_gn = max(_max_diff(got_gn[real], want_gn[real]), _max_diff(got_hn[real], want_gn[real]))
    switched = _max_diff(got_gn[real], by_rule[real])
    print(f"kernels G and H, resolved branch on negative rows: max|row diff| vs plain "
          f"{err_gn:.3e}; the switch moves the legacy tiles by {switched:.3f}")
    if not err_gn <= G_TOL or not switched > 1e-2:
        _fail("kernel G or H does not read its resolved switch as the plain version does")
    res["G"] = (max(res["G"][0], err_gm, err_gn),) + res["G"][1:]
    res["H"] = (max(res["H"][0], err_hm, err_hgm, err_gn),) + res["H"][1:]
    # G and H: each bare C entry on buffers allocated once (outputs equal
    # to the wrapper's), area and msaa8, with the device operations a
    # wrapper call puts on the card, the device time and resident CTAs.
    for mode, args, resolved, want_g in (("area", g_args, False, (got_g, ovf_g)),
                                         ("msaa8", gm_args, True, (got_gm, ovf_gm))):
        for batch, name in ((False, "G"), (True, "H")):
            call, outs = bare_interp(args, batch, resolved)
            call()
            want = want_g if not batch else kint.interpret_tiles(*args, True, resolved)
            if not all(torch.equal(a, b) for a, b in zip(outs, want)):
                _fail(f"kernel {name}'s bare C entry differs from its wrapper ({mode})")
            w_ms = _time_ms(lambda: kint.interpret_tiles(*args, batch, resolved), 20)
            b_ms = _time_ms(call, 20)
            if mode == "area":
                res[name] = res[name] + (b_ms,)
            n_k, n_c = _device_ops(lambda: kint.interpret_tiles(*args, batch, resolved))
            us = _device_us(call)
            print(f"kernel {name}, config 4, {mode}: wrapper {w_ms:.4f} ms, the bare C entry "
                  f"{b_ms:.4f} ms; {n_k:g} kernels and {n_c:g} memsets or copies a wrapper "
                  "call; device: " + ("; ".join(f"{k} {u:.1f} us" for k, u in us.items())
                                      or "no event captured")
                  + f"; {kint.resident_ctas(batch, BD4)} CTAs resident a multiprocessor at "
                  f"blend depth {BD4}, stack scratch "
                  f"{4 * (kint.scratch_shape(args[3].shape[0], BD4, batch) or (0,))[0] / 2**20:.1f}"
                  f" MiB, on {smi}")
            if n_k > 1 or n_c > 0:  # as F's
                _fail(f"kernel {name}: a call puts more than one kernel on the device, or a "
                      "memset or copy")
    # Kernel H's design space on the same slots, area and msaa8: every point
    # (warps a slot, the CTAs a multiprocessor its register cap allows,
    # stack levels in shared memory) equal to G bit for bit (h_sweep raises
    # otherwise), its bare ms and device us beside G's, with its registers,
    # spills, resident CTAs and scratch; and the lockstep efficiency of the
    # parent's eight tiles in lockstep against a warp group a slot.
    for mode, args, resolved in (("area", g_args, False), ("msaa8", gm_args, True)):
        table = h_sweep(args, resolved, build.LOG["fine_interp.cu"])
        for line in h_sweep_lines(f"kernel H design space, config 4, {mode}", args, resolved,
                                  table, smi):
            print(line)
    del gn_args, got_gn, got_hn, want_gn, by_rule
    img_km = assemble_compact(composite_records(*bm_args), t2r, ld4)
    img_pm = assemble_compact(composite_records_plain(*bm_args), t2r, ld4)
    torch.cuda.synchronize()
    err_b4m = (img_km - img_pm).abs().max().item()
    print(f"kernel B with groups, resolved branch (msaa8 rows): max|image diff| {err_b4m:.3e} "
          f"nan {bool(torch.isnan(img_km).any())}")
    if not err_b4m <= B_TOL or torch.isnan(img_km).any():
        _fail("kernel B's resolved branch with clip groups disagrees with its plain version")
    res["B groups"] = (max(err_b4, err_b4m),) + res["B groups"][1:]
    del (stages, cmds, counted, out, calls4, g_args, b_args, got_g, got_h, want_g, steps,
         kinds, segs, rec4, out_k, out_p, img_k, img_p, warm, g_slab, g_rows, calls4m, gm_all,
         bm_args, gm_args, got_gm, got_hm, want_gm, img_km, img_pm)

    # G and H through fine_interp over the full grid of a small scene whose
    # image, too, goes through the interpreter (no image tap).
    small = _small_clip_scene(jello_tpu_torch)
    warm = Renderer(device="cuda")
    warm.render(*small)
    _, ld_s, (scene_t, layout_t, ramps_t, atlas_t), depth_s = _prepared(warm, *small)
    caps = dict(warm._caps, **frame_routing(int(ld_s["n_clips"]), False, depth_s))
    stages = geometry(scene_t, layout_t, caps)[0]
    fi_args = (stages["cmds"], stages["counted"], ramps_t, atlas_t, layout_t)
    full_g, flags_g = kint.fine_interp(*fi_args, caps)
    full_h, flags_h = kint.fine_interp(*fi_args, dict(caps, _interp_batch=True))
    with _PlainKernels():
        full_p, flags_p = kint.fine_interp(*fi_args, caps)
    torch.cuda.synchronize()
    err_fg, err_fh = _max_diff(full_g, full_p), _max_diff(full_h, full_g)
    kinds_s = sorted(set(stages["cmds"]["kind"][stages["cmds"]["tile"]
                                                < caps["tile_grid_cap"]].tolist()))
    print(f"fine_interp, full grid of the small scene ({caps['tile_grid_cap']} tiles, record "
          f"kinds {kinds_s}): G vs plain {err_fg:.3e}, H vs G {err_fh:.3e}, flags "
          f"{sorted(k for k, v in flags_g.items() if bool(v))}")
    if (not err_fg <= G_TOL or not err_fh <= H_TOL or kinds_s != [1, 2, 3, 4, 5, 6, 7]
            or any(bool(flags_g[k]) != bool(flags_p[k]) or bool(flags_h[k]) != bool(flags_p[k])
                   or bool(flags_p[k]) for k in flags_p)):
        _fail("fine_interp over the full grid disagrees with its plain version")
    res["G"] = (max(res["G"][0], err_fg),) + res["G"][1:]
    res["H"] = (max(res["H"][0], err_fh),) + res["H"][1:]
    del stages, fi_args, full_g, full_h, full_p, warm
    torch.cuda.empty_cache()

    # Clip layers nested one level deeper than jello_tpu's clip walk
    # takes: the routing caps the walk at 64 levels, as jello_tpu's is.
    deep = _deep_clip_scene(jello_tpu_torch, 65)
    r_deep = Renderer(device="cuda")
    _, ld_d, _, depth_d = _prepared(r_deep, *deep)
    cap_d = frame_routing(int(ld_d["n_clips"]), False, depth_d)["clip_depth_cap"]
    g0 = kint.interpret_tiles.launches
    img_d = r_deep.render(*deep)
    g_d = kint.interpret_tiles.launches - g0
    r_cpu = Renderer(device="cpu")
    want_d = r_cpu.render(*deep)
    err_d = float(np.abs(img_d - want_d).max())
    raised_d = sorted(k for k, v in r_deep.last_flags.items() if v)
    print(f"65-deep clip scene: nesting depth {depth_d}, clip_depth_cap {cap_d}, kernel G "
          f"launches {g_d}, max abs error vs Renderer(device='cpu') {err_d:.3e}, flags "
          f"{raised_d}, frames run again for {r_deep.last_retries}")
    if (depth_d != 65 or cap_d != 64 or g_d < 1 or not err_d <= G_TOL or raised_d
            or dict(r_deep.last_flags) != dict(r_cpu.last_flags)):
        _fail("the 65-deep clip scene disagrees with the CPU frame")
    res["G"] = (max(res["G"][0], err_d),) + res["G"][1:]
    del r_deep, r_cpu, img_d, want_d
    torch.cuda.empty_cache()

    # ---- 8b. kernels I and K at configs 5 and 4 ------------------------------
    res["I"], res["K"] = _kernel_i(5, scene5, params5, smi)
    _kernel_i(4, scene4, params4, smi)

    # ---- 9. main path ----------------------------------------------------
    counters = _counters()
    def on_path(kernel, name):
        """Whether the run `name` (a config, then maybe the MSAA mode, then
        maybe b8; "tap0" for config 5 under JELLO_IMAGE_TAP=0) must launch
        `kernel`: each entry of kernel A in its own mode only, F with config
        5's atlas and the tap on, G or H on config 4 and on config 5 with
        the tap off."""
        config, msaa, b8 = name.split("_")[0], "msaa" in name, name.endswith("b8")
        tap0 = "tap0" in name
        return {"coverage_area": not msaa, "coverage_msaa": msaa,
                "image_tap": config == "config5" and not tap0,
                "fine_interp": (config == "config4" or tap0) and not b8,
                "fine_interp_b8": b8}.get(kernel, True)

    def zero_counts():
        for fn, attr in counters.values():
            setattr(fn, attr, 0)

    def any_launch():
        return any(getattr(fn, attr) for fn, attr in counters.values())

    def read_counts(name):
        got = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
        print(f"{name} main path launches: {got}")
        if min(v for k, v in got.items() if on_path(k, name)) < 1:
            _fail(f"{name}: a kernel of the main path was never launched")
        if got["coverage_area"] and got["coverage_msaa"]:
            _fail(f"{name}: both entries of kernel A launched in one antialiasing mode")
        return got

    t = time.perf_counter()
    scene2, params2 = config2()
    print(f"config 2 scene built in {time.perf_counter() - t:.1f} s")
    scene1, params1 = config1()
    scenes = {"config1": (scene1, params1), "config3": (scene3, params3),
              "config2": (scene2, params2), "config5": (scene5, params5),
              "config4": (scene4, params4)}
    r = Renderer(device="cuda")
    frames, surfaces, launches = {}, {}, {}
    for name, (scene, params) in scenes.items():
        zero_counts()
        img = r.render(scene, params)
        frames[name] = (img, dict(r.last_flags), dict(r.last_stats), dict(r._caps))
        if name in ("config3", "config5", "config4"):
            surfaces[name] = r.render_surface(scene, params)
        launches[name] = read_counts(name)
        if name != "config1":
            print(f"{name} frame stats: {frames[name][2]}; frames run again for: "
                  f"{r.last_retries}")
    # Config 4 once more with the reference's own switch for the 8-tile
    # interpreter: kernel H in G's place, the same frame.
    os.environ["JELLO_INTERP_BATCH"] = "1"
    try:
        zero_counts()
        img_b8 = r.render(scene4, params4)
        flags_b8 = dict(r.last_flags)
        launches["config4_b8"] = read_counts("config4_b8")
    finally:
        del os.environ["JELLO_INTERP_BATCH"]
    err_b8 = float(np.abs(img_b8 - frames["config4"][0]).max())
    print(f"config4 under JELLO_INTERP_BATCH=1: kernel G launched "
          f"{launches['config4_b8']['fine_interp']} times, H "
          f"{launches['config4_b8']['fine_interp_b8']}; max|frame diff| vs the G frame "
          f"{err_b8:.3e}; flags raised {[k for k, v in flags_b8.items() if v]}")
    if (not err_b8 <= H_TOL or any(flags_b8.values())
            or launches["config4_b8"]["fine_interp"] != 0):
        _fail("config 4 through kernel H differs from the frame through kernel G")

    # The same five scenes under MSAA: msaa8 everywhere, config 4 also
    # under msaa16 and, msaa8 again, through kernel H. Kernel A's MSAA
    # entry must launch and its area entry must not.
    msaa_frames, msaa_surfaces = {}, {}

    def render_msaa(tag, scene, params, surface):
        zero_counts()
        img = r.render(scene, params)
        msaa_frames[tag] = (scene, params, img, dict(r.last_flags), dict(r._caps))
        if surface:
            msaa_surfaces[tag] = r.render_surface(scene, params)
        launches[tag] = read_counts(tag)
        if r.last_retries:
            print(f"{tag}: frames run again for: {r.last_retries}")

    for name, (scene, params) in scenes.items():
        for aa in ("msaa8", "msaa16") if name == "config4" else ("msaa8",):
            render_msaa(f"{name}_{aa}", scene,
                        dataclasses.replace(params, antialiasing_method=AaConfig(aa)),
                        name in ("config5", "config4"))
    os.environ["JELLO_INTERP_BATCH"] = "1"
    try:
        render_msaa("config4_msaa8_b8", *msaa_frames["config4_msaa8"][:2], False)
    finally:
        del os.environ["JELLO_INTERP_BATCH"]
    err_b8m = float(np.abs(msaa_frames["config4_msaa8_b8"][2]
                           - msaa_frames["config4_msaa8"][2]).max())
    print(f"config4_msaa8 under JELLO_INTERP_BATCH=1: max|frame diff| vs the G frame "
          f"{err_b8m:.3e}")
    if not err_b8m <= H_TOL or launches["config4_msaa8_b8"]["fine_interp"] != 0:
        _fail("config 4 under msaa8 through kernel H differs from the frame through kernel G")

    refs = {}
    cpu = Renderer(device="cpu")
    plain_r = Renderer(device="cuda")  # prepares inputs only, never renders

    def hold_frame(name, scene, params, img, flags, caps):
        """One frame of the main path, rendered at the class `caps`, against
        its reference (within IMG_TOL, finite, no flag). Returns the
        reference image."""
        t = time.perf_counter()
        if name.startswith(("config5", "config4")):
            # This script's own reference call: render_frame at the frame's
            # class with the plain version of every kernel, on CUDA tensors
            # (called directly: a renderer's program would replay the
            # kernels it captured whatever is swapped in).
            zero_counts()
            prepared = plain_r._prepare(scene, params)
            caps_f, fine_impl = plain_r._route(prepared, params, caps)
            with _PlainKernels():
                fine_p, packed_p, keys_p = frame(*prepared[2], caps_f, fine_impl)
                ref = assemble(fine_p, prepared[1]).cpu().numpy()
            if any_launch() or any(unpack_flags(packed_p.cpu().tolist(), *keys_p)[0].values()):
                _fail(f"{name}: the plain reference launched a kernel or raised a flag")
            del fine_p, packed_p
            how = "the plain versions on CUDA tensors"
        else:
            ref = cpu.render(scene, params)
            if any(cpu.last_flags.values()):
                _fail(f"{name}: reference flags raised {cpu.last_flags}")
            how = "the CPU reference"
        ref_s = time.perf_counter() - t
        err = float(np.abs(img - ref).max())
        finite = bool(np.isfinite(img).all())
        raised = [k for k, v in flags.items() if v]
        note = "  (above 1e-4: look into it)" if err > 1e-4 else ""
        print(f"{name}: shape {img.shape} finite {finite} flags raised {raised} "
              f"max|err| vs {how} {err:.3e}{note} (reference took {ref_s:.1f} s)")
        if raised or not finite or not err <= IMG_TOL or img.shape != ref.shape:
            _fail(f"{name} output wrong")
        return ref

    # A config's MSAA frames right after its area frame: the reference
    # renderers then keep the scene's calibrated class.
    for name, (scene, params) in scenes.items():
        refs[name] = hold_frame(name, scene, params, *frames[name][:2], frames[name][3])
        for tag in (f"{name}_msaa8", f"{name}_msaa16"):
            if tag in msaa_frames:
                refs[tag] = hold_frame(tag, *msaa_frames[tag])
    for tag, (_, _, img, _, _) in msaa_frames.items():
        if tag.endswith("b8"):
            continue  # held to the G frame above
        moved = float(np.abs(img - frames[tag.split("_")[0]][0]).max())
        print(f"{tag}: differs from the area frame by up to {moved:.3f}")
        if not moved > 1e-2:
            _fail(f"{tag}: the MSAA frame equals the area frame")
    if opts.config5_cpu_reference:
        t = time.perf_counter()
        ref_cpu = cpu.render(scene5, params5)
        print(f"config5: CPU reference took {time.perf_counter() - t:.1f} s; max|err| of the "
              f"frame vs it {float(np.abs(frames['config5'][0] - ref_cpu).max()):.3e}, of "
              f"the plain-on-CUDA reference vs it "
              f"{float(np.abs(refs['config5'] - ref_cpu).max()):.3e}")
    for name, surf in {**surfaces, **msaa_surfaces}.items():
        ref_u8 = present(torch.from_numpy(refs[name])).numpy()
        du8 = int(np.abs(surf.astype(np.int32) - ref_u8.astype(np.int32)).max())
        print(f"render_surface {name}: {surf.shape} {surf.dtype}, max u8 diff vs "
              f"the reference {du8}")
        if surf.shape != ref_u8.shape or surf.dtype != np.uint8 or du8 > 1:
            _fail("render_surface output wrong")

    # An image minified past the tap's region windows: the first frame
    # raises image_region_overflow and the frame runs again through the
    # reference fine stage, plain torch on the card.
    scene_o, params_o = _over_minified_scene(jello_tpu_torch)
    ref_runs = []
    fine_ref_fine = pipeline_render.fine_ref.fine

    def counted_fine_ref(*args):
        ref_runs.append(1)
        return fine_ref_fine(*args)

    pipeline_render.fine_ref.fine = counted_fine_ref
    try:
        r_o = Renderer(device="cuda")
        r_o.render(scene_o, params_o)
        first = (list(r_o.last_retries), len(ref_runs))
        del ref_runs[:]
        zero_counts()
        img_o = r_o.render(scene_o, params_o)
        surf_o = r_o.render_surface(scene_o, params_o)
    finally:
        pipeline_render.fine_ref.fine = fine_ref_fine
    got_o = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
    ref_o = cpu.render(scene_o, params_o)
    err_o = float(np.abs(img_o - ref_o).max())
    du8_o = int(np.abs(surf_o.astype(np.int32)
                       - present(torch.from_numpy(ref_o)).numpy().astype(np.int32)).max())
    rerouted_programs = [k for _, _, k in r_o.compile_log if "fine_ref" in k]
    print(f"over-minified image, {params_o.width}x{params_o.height}: the first render ran "
          f"again for {first[0]} (fine_ref {first[1]} times); settled, a render runs again "
          f"for {r_o.last_retries}, fine_ref ran {len(ref_runs)} times in two renders (the "
          f"capture of the rerouted frame's program; its replays run no Python), programs "
          f"{[(i, round(sec, 4), k) for i, sec, k in r_o.compile_log]}, image tap launches "
          f"{got_o['image_tap']}, fine_v2 {got_o['fine_v2']}; flags raised "
          f"{[k for k, v in r_o.last_flags.items() if v]}; max|err| vs the CPU reference "
          f"{err_o:.3e}, u8 diff {du8_o}; CPU reference retries {cpu.last_retries}")
    if (r_o.last_retries != [["image_region_overflow: rerouted to fine_ref"]]
            or len(ref_runs) != 1 or len(r_o.compile_log) != 2 or len(rerouted_programs) != 1
            or any(r_o.last_flags.values()) or not err_o <= IMG_TOL
            or du8_o > 1 or not np.isfinite(img_o).all() or got_o["image_tap"] != 2
            or ["image_region_overflow: rerouted to fine_ref"] not in cpu.last_retries):
        _fail("the over-minified image frame did not render through the reference fine stage, "
              "or its rerouted frame is not its program's")

    # ---- 10. frames in flight --------------------------------------------
    # Each scene's shape settled by render_surface (its u8 frame the one
    # every frame in flight must equal), then one render_surface_async
    # under the sync debug mode (no host-device synchronization allowed),
    # then ROUNDS rounds of FRAMES synchronous frames alternated with
    # ROUNDS rounds of FRAMES frames enqueued back to back and then
    # fetched, each call's host time split into the renderer's own spans
    # (`Renderer.profiler`).
    def run_async(tag, scene, params):
        want = r.render_surface(scene, params)
        history = len(r.flags_history)

        def check(px):
            """Hold a frame's pixels to `want` (keeping no reference to them,
            which would keep a frame in flight's pinned host buffer)."""
            d = np.abs(px.astype(np.int32) - want.astype(np.int32)).max(axis=-1)
            diff[0] = max(diff[0], int(d.max()))
            diff[1] = max(diff[1], int((d > 0).sum()))
            diff[2] += 1
            if px.shape != want.shape or px.dtype != np.uint8:
                _fail(f"{tag}: a frame of shape {px.shape}, {px.dtype}")

        def sync_round(n):
            """ms of each of n render_surface frames, each until the card is idle."""
            out = []
            for _ in range(n):
                t1 = time.perf_counter()
                px = r.render_surface(scene, params)
                torch.cuda.synchronize()
                out.append((time.perf_counter() - t1) * 1e3)
                check(px)
            return out

        def in_flight(n):
            """n frames enqueued back to back, then fetched: (host ms of
            each enqueue, ms a frame). The frames go once fetched, so the
            next round reuses their pinned host buffers."""
            torch.cuda.synchronize()
            enq, frames_n = [], []
            t0 = time.perf_counter()
            for _ in range(n):
                t1 = time.perf_counter()
                frames_n.append(r.render_surface_async(scene, params))
                enq.append((time.perf_counter() - t1) * 1e3)
            for f in frames_n:
                f.result()
            ms = (time.perf_counter() - t0) * 1e3 / n
            for f in frames_n:
                check(f.result())
                if any(f.flags.values()):
                    raised.append(f.flags)
            return enq, ms

        def spans():
            """{call label: {span: [host ms of each call]}} of the calls
            since the last read, "total" the whole call."""
            out = {}
            for res in r.profiler.collect():
                parts = out.setdefault(res.label, {})
                parts.setdefault("total", []).append(res.duration * 1e3)
                by = {}
                for c in res.children:
                    by[c.label] = by.get(c.label, 0.0) + c.duration * 1e3
                for k, v in by.items():
                    parts.setdefault(k, []).append(v)
            return out

        diff, raised = [0, 0, 0], []  # max u8 diff, most differing pixels, frames
        in_flight(FRAMES + 1)  # pins the host buffers, kept by the caching host allocator
        zero_counts()
        first, sites = _syncs(lambda: r.render_surface_async(scene, params))
        if sites:
            _fail(f"{tag}: a settled render_surface_async synchronized with the device at "
                  f"{sites}")
        check(first.result())
        del first
        # A settled frame is its class's program replayed: no wrapper runs
        # (phase 13 reads the replays' kernels from their device trace).
        got = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
        if any(got.values()):
            _fail(f"{tag}: a settled render_surface_async called kernel wrappers {got}: not "
                  f"a replay")
        r.profiler = Profiler()
        sync_ms, flight_ms, enq, host = [], [], [], {}
        for _ in range(ROUNDS):
            sync_ms.append(statistics.median(sync_round(FRAMES)))
            e, ms = in_flight(FRAMES)
            enq += e
            flight_ms.append(ms)
            for label, parts in spans().items():
                for k, v in parts.items():
                    host.setdefault(label, {}).setdefault(k, []).extend(v)
        r.profiler = None
        du8, n_diff = diff[:2]
        split = "; ".join(
            f"{label} {statistics.median(parts.pop('total')):.3f} (" + ", ".join(
                f"{k} {statistics.median(v):.3f}" for k, v in parts.items()) + ")"
            for label, parts in host.items())
        print(f"{tag}: {diff[2]} frames (render_surface and render_surface_async), max u8 "
              f"diff vs the first render_surface "
              f"{du8}, differing pixels {n_diff} (of {want.shape[0] * want.shape[1]}); "
              f"{ROUNDS} rounds of {FRAMES} frames each way, alternated: ms/frame synchronous "
              f"{[round(v, 3) for v in sync_ms]} (median {statistics.median(sync_ms):.3f}), in "
              f"flight {[round(v, 3) for v in flight_ms]} (median "
              f"{statistics.median(flight_ms):.3f}); host ms to enqueue a frame: median "
              f"{statistics.median(enq):.3f} (min {min(enq):.3f}, max {max(enq):.3f}); host ms "
              f"a call by span, medians: {split}; 0 host-device synchronizations in a settled "
              f"call; on {smi}")
        if du8 > 1 or raised or len(r.flags_history) != history:
            _fail(f"{tag}: frames in flight differ from render_surface or raised a flag")

    for name, (scene, params) in scenes.items():
        run_async(f"{name}_async", scene, params)
    run_async("config4_msaa8_async", *msaa_frames["config4_msaa8"][:2])

    # How far the host can run ahead: launches enqueued behind a card held
    # busy (torch.cuda._sleep, ~1 s) before one launch blocks the host.
    one = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    torch.cuda._sleep(2_000_000_000)
    queued, blocked_ms = 0, 0.0
    while queued < 50_000:
        t = time.perf_counter()
        one.add_(1)
        blocked_ms = (time.perf_counter() - t) * 1e3
        if blocked_ms > 2.0:
            break
        queued += 1
    torch.cuda.synchronize()
    print(f"launch queue: {queued} one-kernel launches enqueued behind a busy card before a "
          f"launch blocked the host ({blocked_ms:.1f} ms); a frame is ~2,600 launches; on {smi}")

    # A scene grown after its class settled, with the same stream shape:
    # the frame in flight raises flags on the card, and Frame.result()
    # renders it again from the inputs it was enqueued with (the Scene is
    # changed after the enqueue).
    scene_g, params_g = _discs(jello_tpu_torch, 1.0)
    r_g = Renderer(device="cuda")
    r_g.render_surface(scene_g, params_g)
    grown = _discs(jello_tpu_torch, 8.0)[0]
    zero_counts()
    frame_g, sites = _syncs(lambda: r_g.render_surface_async(grown, params_g))
    if sites:
        _fail(f"the grown scene's enqueue synchronized with the device at {sites}")
    grown.fill(jello_tpu_torch.Fill.NON_ZERO, jello_tpu_torch.Affine.identity(),
               jello_tpu_torch.SolidBrush(jello_tpu_torch.Color.rgba(0, 0, 0, 1)), None,
               circle(960, 540, 400))
    got_g = frame_g.result()
    launches["discs_grown_async"] = read_counts("discs_grown_async")
    fresh = Renderer(device="cuda")
    want_g = fresh.render_surface(*_discs(jello_tpu_torch, 8.0))
    raised_g = sorted(k for k, v in frame_g.flags.items() if v)
    du8_g = int(np.abs(got_g.astype(np.int32) - want_g.astype(np.int32)).max())
    # The frame in flight was the settled class's program (its first
    # replay); the grown class it rendered again at eagerly gets its own
    # program at its next frame.
    log_g = len(r_g.compile_log)
    again_g = r_g.render_surface(*_discs(jello_tpu_torch, 8.0))
    du8_again = int(np.abs(again_g.astype(np.int32) - want_g.astype(np.int32)).max())
    print(f"grown scene in flight (400 discs scaled 1 -> 8, 1920x1080): the frame (a replay of "
          f"the settled class's program) raised {raised_g}; flags_history {r_g.flags_history}; "
          f"frames run again for {r_g.last_retries}; max u8 diff vs a fresh renderer's frame "
          f"{du8_g} (the fresh renderer's first render ran again for {fresh.last_retries}); "
          f"programs built: {log_g} by then, {len(r_g.compile_log)} after the next frame of the "
          f"grown class ({[(i, round(sec, 4), k) for i, sec, k in r_g.compile_log]}), which "
          f"differs from the fresh frame by {du8_again}")
    if (not raised_g or r_g.flags_history[:1] != [raised_g] or du8_g > 1
            or any(r_g.last_flags.values()) or log_g != 1 or len(r_g.compile_log) != 2
            or du8_again > 1 or r_g.last_retries):
        _fail("the grown scene was not caught and rendered again in Frame.result(), or its "
              "class got no program of its own")
    # Renderers whose programs must outlive the run: a CUDA graph replayed
    # in a profiler session after another renderer's graphs were destroyed
    # crashed the process in four runs of five on an H100 (a segmentation
    # fault in cudaGraphLaunch at phase 12's over-minified frame, its graph
    # captured before those were destroyed); with them kept alive it ran
    # clean.
    programs_kept = [r_g]
    del scene_g, grown, frame_g, got_g, want_g, r_g, fresh, again_g

    # ---- 11. JELLO_IMAGE_TAP=0: config 5's image paints through kernel G --
    os.environ["JELLO_IMAGE_TAP"] = "0"
    try:
        r0 = Renderer(device="cuda")
    finally:
        del os.environ["JELLO_IMAGE_TAP"]
    if r0.use_image_tap:
        _fail("JELLO_IMAGE_TAP=0 did not turn the image tap off")
    t = time.perf_counter()
    r0.render(scene5, params5)
    print(f"config5_tap0: first render {time.perf_counter() - t:.2f} s, frames run again for "
          f"{r0.last_retries}")
    zero_counts()
    img_t0 = r0.render(scene5, params5)
    launches["config5_tap0"] = read_counts("config5_tap0")
    err_t0 = float(np.abs(img_t0 - frames["config5"][0]).max())
    stats_t0 = dict(r0.last_stats)
    print(f"config5_tap0: legacy tiles {stats_t0['legacy_tiles']} of legacy_tiles_cap "
          f"{r0._caps['legacy_tiles_cap']}, cmds_per_tile {r0._caps['cmds_per_tile']}, image "
          f"records {stats_t0['img_recs']}; max|frame diff| vs the tap route's frame "
          f"{err_t0:.3e}; flags raised {[k for k, v in r0.last_flags.items() if v]}")
    if (not err_t0 <= B_TOL or any(r0.last_flags.values())
            or launches["config5_tap0"]["image_tap"] != 0 or not np.isfinite(img_t0).all()):
        _fail("config 5 under JELLO_IMAGE_TAP=0 differs from the tap route, raised a flag "
              "or launched the tap")
    _, _, (scene_t, layout_t, ramps_t, atlas_t), _ = _prepared(r0, scene5, params5)
    g5 = {}
    for aa in ("area", "msaa8"):
        caps = dict(r0._caps, **frame_routing(0, True, 0, aa, image_tap=False))
        stages = geometry(scene_t, layout_t, caps)[0]
        out = {}
        calls_t0 = _record_calls(
            [(kint, "interpret_tiles")],
            lambda: out.update(fine=khybrid.fine_hybrid(stages["cmds"], stages["counted"],
                                                        ramps_t, atlas_t, layout_t, caps)))
        if any(bool(v) for v in out["fine"][1].values()):
            _fail(f"config5_tap0, {aa}: the fine stage raised a flag at the calibrated class")
        g5[aa] = calls_t0["interpret_tiles"][0][:8]
        del stages, out, calls_t0
    gi_args = g5["area"]
    gi_counts, gi_ids, _, gi_slab, gi_rows = gi_args[:5]
    GRID5 = caps["tile_grid_cap"]
    real5 = gi_ids < GRID5
    steps = torch.arange(gi_slab.shape[1], device=gi_slab.device)[None, :] < gi_counts[:-1, None]
    kinds5 = gi_slab[:, :, 0][steps]
    lens5 = gi_counts[:-1][real5]
    print("config5_tap0 legacy-slot tapes: " + ", ".join(
        f"{label} records {int(((lens5 >= lo) & (lens5 <= hi)).sum())}"
        for label, lo, hi in (("1", 1, 1), ("2-3", 2, 3), ("4-7", 4, 7), ("8-15", 8, 15),
                              ("16-31", 16, 31), ("32+", 32, 2**31 - 1)))
        + f"; {int(real5.sum())} legacy slots of {gi_slab.shape[0]}, longest "
        f"{int(lens5.max())}; records by kind: " + ", ".join(
            f"{nm} {int((kinds5 == k).sum())}" for k, nm in (
                (1, "solid"), (2, "linear"), (3, "radial"), (4, "sweep"), (5, "image"),
                (6, "BeginClip"), (7, "EndClip"))))
    gi_res = {}
    for aa, resolved in (("area", False), ("msaa8", True)):
        args = g5[aa]
        got_gi, ovf_gi = kint.interpret_tiles(*args, False, resolved)
        want_gi, ovf_pi = plain_int.interpret_plain(*args, resolved=resolved)
        torch.cuda.synchronize()
        err_gi = _max_diff(got_gi[real5], want_gi[real5])
        print(f"kernel G with images, config5_tap0, {aa}: max|row diff| vs plain {err_gi:.3e}, "
              f"overflow words equal {torch.equal(ovf_gi, ovf_pi)}, any overflow "
              f"{bool(ovf_gi.any())}")
        if (not err_gi <= G_IMG_TOL or not torch.equal(ovf_gi, ovf_pi) or bool(ovf_gi.any())
                or torch.isnan(got_gi[real5]).any()):
            _fail(f"kernel G's image branch disagrees with its plain version ({aa})")
        # Bound, from what this run's tapes make the kernel touch: 64 B a
        # record walked, 1 KB of coverage for each record with a row, 4 KB
        # and a word written a slot, counts, ids, stops, the base color and
        # the atlas once (as F's bound counts it); ~12 float operations a
        # pixel of a solid record, ~60 of an image record (its four taps
        # and their blend, as F's), ~14 to composite either.
        n_walk5 = int(steps.sum())
        n_rowed5 = int((gi_slab[:, :, 2][steps] > 0).sum())
        n_img5 = int((kinds5 == 5).sum())
        gi_bytes = (n_walk5 * 64 + n_rowed5 * 1024 + gi_slab.shape[0] * (4096 + 4)
                    + _nbytes(args[0], args[1], args[2], args[5], args[6]))
        gi_bound = _bound(gi_bytes, 256 * (26 * (n_walk5 - n_img5) + 74 * n_img5))
        w_ms = _time_ms(lambda: kint.interpret_tiles(*args, False, resolved), 20)
        call, outs = bare_interp(args, False, resolved)
        call()
        if not all(torch.equal(a, b) for a, b in zip(outs, (got_gi, ovf_gi))):
            _fail(f"kernel G's bare C entry differs from its wrapper (config5_tap0, {aa})")
        b_ms = _time_ms(call, 20)
        p_ms = _time_ms(lambda: plain_int.interpret_plain(*args, resolved=resolved), 2)
        us = _device_us(call)
        n_k, n_c = _device_ops(lambda: kint.interpret_tiles(*args, False, resolved))
        gi_res[aa] = (err_gi, w_ms, p_ms, gi_bound, b_ms)
        print(f"kernel G with images, config5_tap0, {aa}: {n_walk5} records walked ({n_img5} "
              f"image), {n_rowed5} read a row, {gi_bytes / 1e6:.1f} MB needed; wrapper "
              f"{w_ms:.4f} ms, the bare C entry {b_ms:.4f} ms, plain {p_ms:.3f} ms; device: "
              + ("; ".join(f"{k} {u:.1f} us" for k, u in us.items()) or "no event captured")
              + f"; bound {gi_bound[0]:.4f} ms by {gi_bound[1]} ({100 * gi_bound[0] / b_ms:.1f}% "
              f"of the bare entry); {n_k:g} kernels and {n_c:g} memsets or copies a call; "
              f"on {smi}")
        if n_k > 1 or n_c > 0:
            _fail("kernel G: a call puts more than one kernel on the device, or a memset or copy")
        del got_gi, want_gi, ovf_gi, ovf_pi, call, outs
    params5_m = msaa_frames["config5_msaa8"][1]
    img_t0m = r0.render(scene5, params5_m)
    err_t0m = float(np.abs(img_t0m - msaa_frames["config5_msaa8"][2]).max())
    if not err_t0m <= B_TOL or any(r0.last_flags.values()):
        _fail("config 5 under msaa8 and JELLO_IMAGE_TAP=0 differs from the tap route")
    for tag, prm in (("config5_tap0", params5), ("config5_tap0_msaa8", params5_m)):
        med, lo, hi, peak = _frame_ms(lambda: r0.render_device(scene5, prm))
        print(f"{tag}: render_device {med:.3f} ms/frame median of {FRAMES} (min {lo:.3f}, max "
              f"{hi:.3f}), peak device memory {peak:.1f} MiB; max|frame diff| vs the tap route's "
              f"{err_t0 if tag == 'config5_tap0' else err_t0m:.3e}; on {smi}")
    programs_kept.append(r0)
    del g5, gi_args, gi_slab, gi_rows, steps, kinds5, img_t0, img_t0m, r0
    torch.cuda.empty_cache()

    # ---- 12. ms/frame of the renderer's calls ------------------------------
    # Every frame here is a replay of its class's program (phase 13 holds
    # them to the eager frames and attributes the device time by stage).
    card_peak = {}  # config: peak device MiB of its render_device frame
    for name, (scene, params) in scenes.items():
        for aa in ("msaa8", "msaa16") if name == "config4" else ("msaa8",):
            params_m = msaa_frames[f"{name}_{aa}"][1]
            med, lo, hi, peak = _frame_ms(lambda: r.render_device(scene, params_m))
            print(f"{name}_{aa}: render_device {med:.3f} ms/frame median of {FRAMES} "
                  f"(min {lo:.3f}, max {hi:.3f}), peak device memory {peak:.1f} MiB; on {smi}")
        for what, fn in (("render_device", r.render_device),
                         ("render_surface", r.render_surface)):
            if name == "config2" and what == "render_surface":
                continue
            med, lo, hi, peak = _frame_ms(lambda: fn(scene, params))
            if what == "render_device":
                card_peak[name] = peak
            print(f"{name}: {what} {med:.3f} ms/frame median of {FRAMES} "
                  f"(min {lo:.3f}, max {hi:.3f}), peak device memory "
                  f"{peak:.1f} MiB, on {smi}")
    # The over-minified frame, rerouted to the reference fine stage on
    # every render: two replays (the class's program raises
    # image_region_overflow, the rerouted frame's program walks to the
    # class's bounds) and two flag reads. The rerouted replay against the
    # eager reroute at the class (its walk's bounds read from the device)
    # and against the CPU reference.
    fine_rep, _ = r_o.render_device(scene_o, params_o)
    prepared_o = r_o._prepare(scene_o, params_o)
    caps_o, _ = r_o._route(prepared_o, params_o, r_o._caps, reroute=True)
    fine_e = frame(*prepared_o[2], caps_o, None)[0]
    same_o = torch.equal(fine_rep, fine_e)
    err_rep = float(np.abs(assemble(fine_rep, prepared_o[1]).cpu().numpy() - ref_o).max())
    del fine_rep, fine_e
    med, lo, hi, peak = _frame_ms(lambda: r_o.render_device(scene_o, params_o))
    n_k, n_c, busy, _, _, tab = _profile(lambda: r_o.render_device(scene_o, params_o))
    print(f"over-minified image (rerouted): the rerouted replay equals the eager reroute at the "
          f"class: {same_o}, max|err| vs the CPU reference {err_rep:.3e}; walk bounds "
          f"{list(r_o._walks.values())}; render_device {med:.3f} ms/render median of {FRAMES} "
          f"(min {lo:.3f}, max {hi:.3f}), two replays a render; profiled: {n_k:g} kernels and "
          f"{n_c:g} copies or memsets a render, busy {busy:.3f} ms; programs "
          f"{len(r_o.compile_log)}; on {smi}")
    if not same_o or not err_rep <= IMG_TOL or len(r_o.compile_log) != 2:
        _fail("the over-minified frame's rerouted replay differs from its eager frame or from "
              "the CPU reference")

    # ---- 13. the compiled frame --------------------------------------------
    _compiled_frames(scenes, {tag: v[1] for tag, v in msaa_frames.items()}, launches,
                     on_path, smi)

    # ---- 14. multi-GPU: the stripe- and geometry-sharded paths ------------
    stripe_err = _multi_gpu({k: scenes[k] for k in ("config5", "config4", "config3")},
                            launches, smi, card_peak)

    loaded = [m for m, v in sys.modules.items() if v is not None
              and m.split(".")[0] in ("jax", "jello_tpu")]
    if loaded:
        _fail(f"modules of JAX or of the JAX package were imported: {loaded}")

    # ---- 15. results -----------------------------------------------------
    def entry(name, src, replaces, err, ms, plain_ms, bound, library_ms, bare_ms=None,
              counter=None, configs=None):
        """One kernel's line; its launches are the main path's, summed over
        `configs` (default: every config). `bare_ms`, where timed: its
        bare C entry on prepared buffers."""
        n = sum(got[counter or name] for cfg, got in launches.items()
                if configs is None or cfg in configs)
        line = {"name": name, "route": "cuda", "source": f"jello_tpu_torch/csrc/{src}",
                "replaces": f"jello_tpu/tpu/{replaces}", "launches": n,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
                "bound_by": bound[1], "library_ms": library_ms}
        return line if bare_ms is None else dict(line, bare_ms=bare_ms)

    # The holds at stripe shapes (phase 14) join each kernel's error.
    for kernel, key in (("B", "B"), ("F", "F"), ("G", "G")):
        res[key] = (max(res[key][0], stripe_err.get(kernel, 0.0)),) + res[key][1:]
    kernels = [
        entry("coverage_area", "coverage.cu", "coverage_pallas.py:266",
              max(err_rows, err_a, err_a5, err_a4, stripe_err.get("A", 0.0)), a_ms, a_plain_ms,
              a_bound, None),
        # Kernel A's MSAA body, at config 4's coverage inputs.
        entry("coverage_msaa8", "coverage.cu", "coverage_pallas.py:266", *res["A msaa8"],
              counter="coverage_msaa", configs=[t for t in launches if "msaa8" in t]),
        entry("coverage_msaa16", "coverage.cu", "coverage_pallas.py:266", *res["A msaa16"],
              counter="coverage_msaa", configs=[t for t in launches if "msaa16" in t]),
        entry("fine_v2", "fine_v2.cu", "fine_v2.py:564", *res["B"]),
        # Kernel B again, at config 4's records: its clip-group pass.
        entry("fine_v2_groups", "fine_v2.cu", "fine_v2.py:564", *res["B groups"],
              counter="fine_v2", configs=[t for t in launches if t.startswith("config4")]),
        entry("monotone_land", "land.cu", "land_pallas.py:171", *res["C"]),
        entry("lockstep_walk", "lockstep.cu", "lockstep_pallas.py:198", *res["D"]),
        entry("expand_euler", "expand.cu", "expand_pallas.py:248", *res["E"]),
        entry("expand_crossings", "expand.cu", "expand_pallas.py:248", *res["E'"]),
        entry("expand_rows", "expand.cu", "expand_pallas.py:248", *res["E''"]),
        entry("image_tap", "image_tap.cu", "image_tap.py:248", *res["F"]),
        entry("fine_interp", "fine_interp.cu", "fine_pallas.py:567", *res["G"]),
        entry("fine_interp_b8", "fine_interp.cu", "fine_pallas.py:1079", *res["H"]),
        # Kernel I replaces no Pallas kernel (jello_tpu leaves its scans to
        # XLA); its numbers at config 5's largest call, launches the calls a
        # replayed frame of config 5, innermost_ms torch's innermost scans
        # of the same call's stacked columns.
        dict(entry("column_scan", "scan.cu", "", *res["I"][:6]), replaces=None,
             launches_a_replay=res["I"][6], innermost_ms=res["I"][7]),
        # Kernel J replaces no Pallas kernel either (jello_tpu leaves the
        # per-line half of path_count to XLA); its numbers at config 5.
        dict(entry("line_dda", "line_dda.cu", "", *res["J"]), replaces=None),
        # Kernel K replaces no Pallas kernel (jello_tpu's scatters are
        # XLA's); its numbers at config 5's largest call, launches_a_replay
        # its launches in config 5's program, calls_a_frame the
        # ops.scatter_* calls of an eager frame there.
        dict(entry("drop_scatter", "scatter.cu", "", *res["K"][:6]), replaces=None,
             launches_a_replay=res["K"][6], calls_a_frame=res["K"][7]),
        # Kernel L replaces no Pallas kernel (jello_tpu leaves flatten's
        # per-slot chain to XLA); its numbers at config 5.
        dict(entry("slot_tables", "slot_tables.cu", "", *res["L"]), replaces=None),
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
