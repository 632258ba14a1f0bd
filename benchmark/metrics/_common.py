"""The arithmetic the metric readers share: percentiles, the union of
intervals, kernel-name classes, and the traced window's device events.

The interval union and the kernel-name kind are copies of
`jello_tpu_torch/xtrace.py`'s `union_ms` and `op_kind` (the benchmark keeps
its own, so that a change to the program cannot move its yardstick).
Times in a torch.profiler Chrome trace are microseconds.
"""

from __future__ import annotations

import math
import re

# The categories of a Chrome trace's device operations.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def percentile(values, q: float) -> float:
    """The q-th percentile (0..100) of `values`, interpolated linearly
    between the two nearest ranks (numpy's default method). Values may
    be inf (a failed frame)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    if xs[hi] == xs[lo]:
        return xs[lo]
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def union(spans) -> float:
    """Total length covered by possibly-overlapping (start, end) spans."""
    tot = 0.0
    cur_s = cur_e = None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                tot += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        tot += cur_e - cur_s
    return tot


def gaps(spans, start, end) -> list:
    """The (start, end) intervals of [start, end] that no span covers."""
    out = []
    t = start
    for s, e in sorted(spans):
        if s > t:
            out.append((t, min(s, end)))
        t = max(t, e)
        if t >= end:
            break
    if t < end:
        out.append((t, end))
    return [(s, e) for s, e in out if e > s]


def op_kind(name: str) -> str:
    """A device operation's name up to its template or argument list
    ("void at::native::foo<int, 4>(...)" -> "at::native::foo",
    "Memcpy DtoD (Device -> Device)" -> "Memcpy DtoD")."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return re.split(r"[<(]", name, maxsplit=1)[0].strip() or name


def device_ops(trace: dict) -> list:
    """The traced window's device operations as (start, end, cat, name),
    each clipped to the window [trace["start"], trace["end"]] (us)."""
    t0, t1 = trace["start"], trace["end"]
    out = []
    for e in trace["events"]:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        s = float(e["ts"])
        end = s + float(e.get("dur", 0))
        if end <= t0 or s >= t1:
            continue
        out.append((max(s, t0), min(end, t1), e["cat"], e.get("name", "")))
    return out


def kernel_ms_per_frame(trace: dict, keep) -> float | None:
    """Device ms per traced frame in the kernels whose kind `keep` accepts;
    None when the trace holds no device operation."""
    ops = device_ops(trace)
    if not ops:
        return None
    us = sum(e - s for s, e, cat, name in ops if cat == "kernel" and keep(op_kind(name)))
    return us / 1e3 / trace["frames"]
