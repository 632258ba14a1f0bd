"""Profiling (reference: profiler/profiler.go + engine/wgpu_engine/profiler.go).

Counterpart of `jello_tpu/profiler.py`. The reference threads a
dependency-free two-method interface (`Start(label) ProfilerGroup;
End()`) through the renderer and implements it with GPU timestamp
queries. Here:

  - host-side nestable wall-clock spans (`Profiler`/`ProfilerGroup`),
    collected into the same nested result tree shape (the text of
    `jello_tpu/profiler.py`, plain Python);
  - device-side stage annotation via `named_scope`, which is
    `torch.profiler.record_function` (the pipeline's eight stage spans,
    `pipeline/render.py`);
  - whole-trace capture via `Profiler.device_trace(dir)` wrapping
    `torch.profiler.profile`: the capture is exported as a Chrome-trace
    JSON into `dir` (the counterpart of the xplane file) and parsed by
    `xtrace.attribute`.

A `None` group no-ops everywhere, as in the reference.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from dataclasses import dataclass, field


@dataclass
class ProfilerResult:
    label: str
    start: float
    duration: float
    children: list = field(default_factory=list)

    def pretty(self, indent: int = 0) -> str:
        out = f"{'  ' * indent}{self.label}: {self.duration * 1000:.3f} ms\n"
        for c in self.children:
            out += c.pretty(indent + 1)
        return out


class ProfilerGroup:
    """A nestable span. Mirrors the reference's ProfilerGroup
    (Nest/End); use as a context manager or with explicit end()."""

    def __init__(self, label: str, parent: "ProfilerGroup | None" = None):
        self.label = label
        self._parent = parent
        self._start = time.perf_counter()
        self._end: float | None = None
        self.children: list[ProfilerGroup] = []

    def nest(self, label: str) -> "ProfilerGroup":
        child = ProfilerGroup(label, self)
        self.children.append(child)
        return child

    def end(self):
        if self._end is None:
            self._end = time.perf_counter()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.end()

    def result(self) -> ProfilerResult:
        end = self._end if self._end is not None else time.perf_counter()
        return ProfilerResult(
            self.label,
            self._start,
            end - self._start,
            [c.result() for c in self.children],
        )


class Profiler:
    """Collects per-frame span trees (reference: Profiler.Start/Collect).

    `collect()` returns both host span trees and — after a
    `device_trace(...)` scope — per-stage DEVICE timing trees parsed
    from the capture (the analog of the reference's per-pass GPU
    timestamp queries, profiler.go:337-385): one result labeled
    `device:<plane>` whose children are the pipeline's named-scope
    stages with their on-chip ms.
    """

    def __init__(self):
        self._groups: list[ProfilerGroup] = []
        self._device_results: list[ProfilerResult] = []

    def start(self, label: str) -> ProfilerGroup:
        g = ProfilerGroup(label)
        self._groups.append(g)
        return g

    def collect(self) -> list[ProfilerResult]:
        done = [g.result() for g in self._groups if g._end is not None]
        self._groups = [g for g in self._groups if g._end is None]
        done += self._device_results
        self._device_results = []
        return done

    @contextlib.contextmanager
    def device_trace(self, log_dir: str, frames: int = 1):
        """Capture a device trace for the scope and fold its per-stage
        device timings into the next `collect()`.

        `frames`: how many frames the scope renders (times are
        normalized to ms/frame). The CUDA activity is asked for only
        when a CUDA device is present (with it, torch.profiler hangs a
        CPU-only process for tens of minutes); a CPU-only capture has no
        device and adds no result. The capture records, for every torch
        call and kernel launch, its call site (`source_spans`), which
        `xtrace.attribute` reads. A capture that holds device activity
        but no device result raises: a parse failure is never silent."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        cuda = torch.cuda.is_available()
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        os.makedirs(log_dir, exist_ok=True)
        start = time.perf_counter()
        with profile(activities=activities) as prof:
            with source_spans():
                yield
            if cuda:
                torch.cuda.synchronize()
        prof.export_chrome_trace(os.path.join(log_dir, f"{time.time_ns()}.pt.trace.json"))
        results = device_stage_results(log_dir, frames, start=start)
        if cuda and not results:
            raise NoDeviceEvents(f"device_trace: no device event in the capture in {log_dir}")
        self._device_results += results


class NoDeviceEvents(RuntimeError):
    """A capture made with the CUDA activity that holds no device event
    (torch.profiler drops a session's device events now and then)."""


def device_stage_results(log_dir: str, frames: int = 1,
                         start: float = 0.0) -> list[ProfilerResult]:
    """Parse a `Profiler.device_trace` capture into per-stage device
    timing trees (one per device)."""
    from .xtrace import attribute

    out = []
    for device, tabs in attribute(log_dir, frames).items():
        stages = sorted(tabs["stages"].items(), key=lambda kv: -kv[1][0])
        total = sum(ms for _, (ms, _) in stages)
        out.append(ProfilerResult(
            f"device:{device}", start, total / 1e3,
            [ProfilerResult(name, start, ms / 1e3)
             for name, (ms, _) in stages],
        ))
    return out


def named_scope(label: str):
    """Stage annotation: a `torch.profiler.record_function` span, which a
    capture shows on the host and, around the stage's launches, on the
    device."""
    import torch

    return torch.profiler.record_function(label)


# The prefix of the spans `source_spans` opens; `xtrace` reads the rest
# of the name as the call site.
SOURCE_PREFIX = "source "
_PKG = os.path.dirname(os.path.abspath(__file__)) + os.sep
_SHIM = os.path.join(_PKG, "pipeline", "ops.py")


def call_site(frame) -> str | None:
    """The first frame, from `frame` outward, that lies in this package
    and not in `pipeline/ops.py`, as "path/in/package.py:line", marked
    " (shim)" when a frame of `pipeline/ops.py` was passed over (the shim
    rule of `jello_tpu/xtrace.py`: a helper there reports its caller);
    None outside the package."""
    shim = False
    while frame is not None:
        path = frame.f_code.co_filename
        if path == _SHIM:
            shim = True
        elif path.startswith(_PKG):
            return f"{path[len(_PKG):]}:{frame.f_lineno}" + (" (shim)" if shim else "")
        frame = frame.f_back
    return None


@contextlib.contextmanager
def source_spans():
    """While entered, every torch call made from this package, and every
    launch through the kernel library's C entries once it is loaded, runs
    inside a `record_function` span named SOURCE_PREFIX + its call site
    (`call_site`). torch.profiler's own Python stacks (`with_stack`) name
    each function by its first line, not the line of the call, and record
    every Python call of the frame; this gives the line, and costs one span
    a call."""
    import torch
    from torch.overrides import TorchFunctionMode

    from .cuda import build

    def span(frame):
        site = call_site(frame)
        return contextlib.nullcontext() if site is None else torch.profiler.record_function(
            SOURCE_PREFIX + site)

    class _Sources(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            with span(sys._getframe(1)):
                return func(*args, **(kwargs or {}))

    def spanned(entry):
        def call(*args):
            with span(sys._getframe(1)):
                return entry(*args)
        return call

    lib = build.kernels() if build.kernels.cache_info().currsize else None
    entries = {name: getattr(lib, name) for name in build.SIGNATURES} if lib else {}
    for name, entry in entries.items():
        setattr(lib, name, spanned(entry))
    try:
        with _Sources():
            yield
    finally:
        for name, entry in entries.items():
            setattr(lib, name, entry)
