"""Chrome-trace device-trace parsing: per-stage / per-source / per-kind /
per-op device-time attribution from one `Profiler.device_trace` capture.

Counterpart of `jello_tpu/xtrace.py`, which reads an XSpace; here the
capture is torch.profiler's Chrome-trace JSON. One capture answers every
"where do the milliseconds go" question:

  - device events are the kernels, copies and memsets (`kernel`,
    `gpu_memcpy`, `gpu_memset`); each carries the correlation id of the
    host call that launched it (`cuda_runtime`/`cuda_driver` events);
  - stage: the pipeline stage span (`pipeline.render.STAGES`) whose
    device-side interval (`gpu_user_annotation`) contains the event on
    its stream, or else the stage span around the launching host call;
  - source: the call site of the torch call or kernel entry that
    launched it (`profiler.source_spans`, with the shim rule of
    `jello_tpu/xtrace.py`: `pipeline/ops.py` reports its caller, marked
    " (shim)");
  - kind: the kernel's name up to its template or argument list.

Busy time is the union of the device events' intervals; the spans' own
device-side annotation events are not device work and are left out (they
cover whole stages).

Used by `Profiler.device_trace(...)` (jello_tpu_torch/profiler.py) and by
chip_smoke.py. The device time of each stage of every frame, a replayed
CUDA graph's too (whose launches all fall OUTSIDE the stage spans here),
comes from the frames' own stage clock instead (`profiler.stage_clock`).
"""

from __future__ import annotations

import collections
import glob
import json
import os
import re

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# The stage of a device event launched outside every stage span.
OUTSIDE = "(outside the stages)"
# The source of a device event launched from no call site of the package.
NO_SOURCE = "(no call site in the package)"


def load_trace(logdir: str) -> list:
    """The events of the newest Chrome-trace capture under `logdir`."""
    paths = sorted(glob.glob(os.path.join(logdir, "**", "*.pt.trace.json"),
                             recursive=True))
    if not paths:
        raise FileNotFoundError(f"no *.pt.trace.json under {logdir}")
    with open(paths[-1]) as f:
        return json.load(f)["traceEvents"]


def op_kind(name: str) -> str:
    """A device event's name up to its template or argument list
    ("void at::native::foo<int, 4>(...)" -> "at::native::foo",
    "Memcpy DtoD (Device -> Device)" -> "Memcpy DtoD")."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return re.split(r"[<(]", name, maxsplit=1)[0].strip() or name


def union_ms(spans) -> float:
    """Total coverage of possibly-overlapping (start, end) ps spans."""
    spans = sorted(spans)
    tot = 0
    cur_s = cur_e = None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                tot += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        tot += cur_e - cur_s
    return tot / 1e9


def _ps(us) -> int:
    return int(round(float(us) * 1e6))


def _span(ev):
    t = _ps(ev["ts"])
    return t, t + _ps(ev.get("dur", 0))


def _enclosing(spans, points):
    """For nested (start, end, payload) spans on one thread and (t, key)
    points: {key: [payload of each span containing t, outermost first]}."""
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    out, stack, i = {}, [], 0
    for t, key in sorted(points):
        while i < len(spans) and spans[i][0] <= t:
            while stack and stack[-1][1] < spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[key] = [s[2] for s in stack]
    return out


def attribute(logdir: str, frames: int = 1):
    """Parse a capture into attribution tables (all times ms/frame).

    Returns a dict per device ("cuda:<index>"):
      {"lines": {"stream <id>", "all streams" (the device's busy time) or
                 "host launch calls" (the host's time in the calls that
                 launched them, each call once): (sum_ms, union_ms, n/frame)},
       "stages": {stage (or OUTSIDE): (ms, n/frame)},
       "sources": {file:line: (ms, n/frame)},
       "kinds": {kernel kind: (ms, n/frame)},
       "ops": [(line, op_name, ms, n/frame)] sorted desc,
       "sites": {(stage, file:line, kernel kind): (ms, n/frame)}}
    The first five are jello_tpu's tables; "sites" crosses the three
    attributions (which call sites launch a kind of kernel, in which
    stage).
    """
    from .pipeline.render import STAGES
    from .profiler import SOURCE_PREFIX

    events = [e for e in load_trace(logdir) if e.get("ph") == "X"]
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    # Host side, per thread: the stage and source spans; device side, per
    # stream: the stage spans.
    host_spans = collections.defaultdict(list)
    dev_stages = collections.defaultdict(list)
    for e in events:
        cat = e.get("cat")
        if cat == "user_annotation":
            host_spans[(e["pid"], e["tid"])].append(_span(e) + (e["name"],))
        elif cat == "gpu_user_annotation" and e["name"] in STAGES:
            dev_stages[(e["pid"], e["tid"])].append(_span(e) + (e["name"],))

    # The host call that launched each device event, and what encloses it.
    points = collections.defaultdict(list)
    launch_of = {}
    for i, e in enumerate(device):
        rt = launches.get(e.get("args", {}).get("correlation"))
        if rt is not None:
            launch_of[i] = rt
            points[(rt["pid"], rt["tid"])].append((_ps(rt["ts"]), i))
    host_ctx = {}
    for thread, pts in points.items():
        host_ctx.update(_enclosing(host_spans.get(thread, []), pts))
    dev_ctx = {}
    by_stream = collections.defaultdict(list)
    for i, e in enumerate(device):
        by_stream[(e["pid"], e["tid"])].append((_ps(e["ts"]), i))
    for stream, pts in by_stream.items():
        dev_ctx.update(_enclosing(dev_stages.get(stream, []), pts))

    acc = collections.defaultdict(lambda: collections.defaultdict(
        lambda: collections.defaultdict(lambda: [0, 0])))
    spans = collections.defaultdict(list)
    counted_calls = set()
    for i, e in enumerate(device):
        dev = f"cuda:{e['pid']}"
        start, end = _span(e)
        line = f"stream {e['tid']}"
        host = host_ctx.get(i, [])
        stage = (dev_ctx.get(i) or [s for s in host if s in STAGES] or [OUTSIDE])[-1]
        srcs = [s[len(SOURCE_PREFIX):] for s in host if s.startswith(SOURCE_PREFIX)]
        src = (srcs or [NO_SOURCE])[-1]
        for table, key in (("lines", line), ("lines", "all streams"), ("stages", stage),
                           ("sources", src), ("kinds", op_kind(e["name"])),
                           ("ops", (line, e["name"])),
                           ("sites", (stage, src, op_kind(e["name"])))):
            a = acc[dev][table][key]
            a[0] += end - start
            a[1] += 1
        spans[(dev, line)].append((start, end))
        spans[(dev, "all streams")].append((start, end))
        # The host's time in the call that launched it (a launch waits
        # there while the device's launch queue is full), once a call: a
        # CUDA graph's launch puts all of the graph's operations on the
        # device.
        rt = launch_of.get(i)
        if rt is not None and (dev, rt["args"]["correlation"]) not in counted_calls:
            counted_calls.add((dev, rt["args"]["correlation"]))
            start, end = _span(rt)
            a = acc[dev]["lines"]["host launch calls"]
            a[0] += end - start
            a[1] += 1
            spans[(dev, "host launch calls")].append((start, end))

    def per_frame(tab):
        return {k: (ps / 1e9 / frames, n / frames) for k, (ps, n) in tab.items()}

    return {dev: {
        "lines": {ln: (ps / 1e9 / frames, union_ms(spans[(dev, ln)]) / frames, n / frames)
                  for ln, (ps, n) in tab["lines"].items()},
        "stages": per_frame(tab["stages"]),
        "sources": per_frame(tab["sources"]),
        "kinds": per_frame(tab["kinds"]),
        "ops": sorted(((ln, name, ps / 1e9 / frames, n / frames)
                       for (ln, name), (ps, n) in tab["ops"].items()), key=lambda t: -t[2]),
        "sites": per_frame(tab["sites"]),
    } for dev, tab in acc.items()}

