"""The traced sub-window of a `--trace 1` run: a torch.profiler capture of
a few frames, read into the events the per-layer metrics take, and the
`breakdown` of the result line.

The capture goes to a file under TMPDIR, is read and deleted at once.
The window is the host span `portbench.window` around the frames (and a
final synchronisation), so the device's idle time at its edges counts.
"""

from __future__ import annotations

import collections
import json
import os
import tempfile

WINDOW = "portbench.window"


def capture(fn, cuda: bool):
    """Run fn() under torch.profiler (the CUDA activity only with `cuda`)
    inside the window span. Returns {"events", "start", "end"} (us)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        with record_function(WINDOW):
            fn()
            if cuda:
                torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".pt.trace.json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    spans = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW
             and e.get("cat") == "user_annotation"]
    if not spans:
        raise RuntimeError(f"the capture holds no {WINDOW} span")
    start = float(spans[0]["ts"])
    return {"events": events, "start": start, "end": start + float(spans[0]["dur"])}


def _host_events(events, thread):
    """The host events of `thread` (pid, tid) as (start, end, cat, name),
    the window's own span left out."""
    return [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e["cat"], e["name"])
            for e in events
            if e.get("ph") == "X" and (e.get("pid"), e.get("tid")) == thread
            and e.get("cat") in ("user_annotation", "cpu_op") and e.get("name") != WINDOW]


def _doing(host, s, e):
    """What the host was doing in [s, e]: the span (`user_annotation`) and
    the torch op (`cpu_op`) that overlap it most, "span > op"; "host: no
    span" where none does."""
    def most(cat):
        best = max(((min(b, e) - max(a, s), name) for a, b, c, name in host if c == cat),
                   default=(0.0, None))
        return best[1] if best[0] > 0 else None
    parts = [p for p in (most("user_annotation"), most("cpu_op")) if p]
    return " > ".join(parts) or "host: no span"


def breakdown(trace, top: int = 10):
    """{"device_ops": [[kind, seconds]], "idle_gaps": [[host activity,
    seconds]]}: the device operation kinds that took most time in the
    traced window, and its longest device-idle gaps, each named by what
    the host was doing over it (`_doing`)."""
    from metrics._common import device_ops, gaps, op_kind

    ops = device_ops(trace)
    by_kind = collections.Counter()
    for s, e, _, name in ops:
        by_kind[op_kind(name)] += (e - s) / 1e6
    window = [e for e in trace["events"] if e.get("ph") == "X" and e.get("name") == WINDOW]
    host = _host_events(trace["events"], (window[0].get("pid"), window[0].get("tid")))
    longest = sorted(gaps([(a, b) for a, b, _, _ in ops], trace["start"], trace["end"]),
                     key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[k, v] for k, v in by_kind.most_common(top)],
            "idle_gaps": [[_doing(host, s, e), (e - s) / 1e6] for s, e in longest]}
