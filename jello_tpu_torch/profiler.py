"""Profiling (reference: profiler/profiler.go + engine/wgpu_engine/profiler.go).

Counterpart of `jello_tpu/profiler.py`. The reference threads a
dependency-free two-method interface (`Start(label) ProfilerGroup;
End()`) through the renderer and implements it with GPU timestamp
queries. Here:

  - host-side nestable wall-clock spans (`Profiler`/`ProfilerGroup`),
    collected into the same nested result tree shape (the text of
    `jello_tpu/profiler.py`, plain Python), each with the frame index and
    the counts its caller put on it. A group of a `Profiler` also opens a
    `torch.profiler.record_function` span named "jello." and its path for
    its life, so that a torch.profiler capture holds the host spans on the
    device trace's clock;
  - device-side stage annotation via `named_scope`, which is
    `torch.profiler.record_function` (the pipeline's eight stage spans,
    `pipeline/render.py`), and the stage clock: inside `stage_clock`, a
    stage span also stamps the card's clock into the frame's stamp buffer
    at its entry (and after the last stage), the counterpart of the
    reference's per-pass GPU timestamp queries (profiler.go:337-385), so
    that every frame, a replayed CUDA graph's too, carries its stages'
    device times (`stage_ms`, `device_result`);
  - whole-trace capture via `Profiler.device_trace(dir)` wrapping
    `torch.profiler.profile`: the capture is exported as a Chrome-trace
    JSON into `dir` (the counterpart of the xplane file) and parsed by
    `xtrace.attribute`.

A `None` group no-ops everywhere, as in the reference.
"""

from __future__ import annotations

import contextlib
import contextvars
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
    # The index of the renderer's frame the span belongs to (a call and
    # the `result` of its frame share it), None where it has none.
    frame: int | None = None
    # Counts of the work done inside the span ({name: int}).
    counts: dict = field(default_factory=dict)

    def pretty(self, indent: int = 0) -> str:
        out = f"{'  ' * indent}{self.label}: {self.duration * 1000:.3f} ms\n"
        for c in self.children:
            out += c.pretty(indent + 1)
        return out


# The prefix of the torch.profiler spans of a `Profiler`'s groups.
SPAN_PREFIX = "jello."


class ProfilerGroup:
    """A nestable span. Mirrors the reference's ProfilerGroup
    (Nest/End); use as a context manager or with explicit end().

    With `trace` (the groups of a `Profiler`, and their children), the
    group is also a `torch.profiler.record_function` span named
    SPAN_PREFIX + its path ("jello.render_surface.prepare.upload") from
    creation to `end()`; groups end in the reverse order of their
    creation, as spans of one thread nest."""

    def __init__(self, label: str, parent: "ProfilerGroup | None" = None,
                 trace: bool = False, frame: int | None = None):
        self.label = label
        self.path = label if parent is None else f"{parent.path}.{label}"
        self.frame = frame
        self.counts: dict = {}
        self._parent = parent
        self._trace = trace
        self._span = None
        if trace:
            import torch

            self._span = torch.profiler.record_function(SPAN_PREFIX + self.path)
            self._span.__enter__()
        self._start = time.perf_counter()
        self._end: float | None = None
        self.children: list = []

    def nest(self, label: str) -> "ProfilerGroup":
        child = ProfilerGroup(label, self, self._trace, self.frame)
        self.children.append(child)
        return child

    def add(self, result: ProfilerResult):
        """Attach a finished span as the last child (the device times of
        the work the group caused, `device_result`)."""
        self.children.append(result)

    def end(self):
        if self._end is None:
            self._end = time.perf_counter()
            if self._span is not None:
                self._span.__exit__(None, None, None)

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
            [c if isinstance(c, ProfilerResult) else c.result() for c in self.children],
            self.frame,
            dict(self.counts),
        )


class Profiler:
    """Collects per-frame span trees (reference: Profiler.Start/Collect):
    `collect()` returns the trees of the groups that have ended."""

    def __init__(self):
        self._groups: list[ProfilerGroup] = []

    def start(self, label: str, frame: int | None = None) -> ProfilerGroup:
        g = ProfilerGroup(label, trace=True, frame=frame)
        self._groups.append(g)
        return g

    def collect(self) -> list[ProfilerResult]:
        done = [g.result() for g in self._groups if g._end is not None]
        self._groups = [g for g in self._groups if g._end is None]
        return done

    @contextlib.contextmanager
    def device_trace(self, log_dir: str, frames: int = 1):
        """Capture a device trace of the scope into `log_dir`, for
        `xtrace.attribute(log_dir, frames)`.

        `frames`: how many frames the scope renders. The CUDA activity is
        asked for only when a CUDA device is present (with it,
        torch.profiler hangs a CPU-only process for tens of minutes). The
        capture records, for every torch call and kernel launch, its call
        site (`source_spans`), which `xtrace.attribute` reads. A capture
        made with the CUDA activity that holds no device event raises
        `NoDeviceEvents`: a dropped session is never silent."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        from .xtrace import attribute

        cuda = torch.cuda.is_available()
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        os.makedirs(log_dir, exist_ok=True)
        with profile(activities=activities) as prof:
            with source_spans():
                yield
            if cuda:
                torch.cuda.synchronize()
        prof.export_chrome_trace(os.path.join(log_dir, f"{time.time_ns()}.pt.trace.json"))
        if cuda and not attribute(log_dir, frames):
            raise NoDeviceEvents(f"device_trace: no device event in the capture in {log_dir}")


class NoDeviceEvents(RuntimeError):
    """A capture made with the CUDA activity that holds no device event
    (torch.profiler drops a session's device events now and then)."""


# The stage clock of the frame being enqueued on this thread: (stamp
# buffer, {span label: (entry slot, exit slot or None)}), set by
# `stage_clock`.
_CLOCK = contextvars.ContextVar("jello_stage_clock", default=None)


def stamp_buffer(device, n: int):
    """A frame's stamp buffer of n slots (int64, written by the stamps,
    so left uninitialised) on a CUDA `device`; None elsewhere: a frame on
    the CPU stamps nothing."""
    import torch

    device = torch.device(device)
    return torch.empty(n, dtype=torch.int64, device=device) if device.type == "cuda" else None


def device_stamp(buf, slot: int):
    """Enqueue the stamp: one thread writes the card's clock (%globaltimer,
    ns) into buf[slot] on the current stream, after the work enqueued
    before it (`csrc/stamp.cu`)."""
    from .cuda import build

    build.check("jello_stamp", build.kernels().jello_stamp(buf.data_ptr(), slot,
                                                           build.stream_of(buf)))


@contextlib.contextmanager
def stage_clock(buf, labels, nested=()):
    """While entered, the stage spans (`named_scope`) of `labels` stamp
    into `buf`: slot k at the entry of labels[k], slot len(labels) at the
    exit of the last label. `nested` holds (stage, label) pairs of spans
    inside a stage that stamp their own entry and exit, the j-th into the
    two slots from len(labels) + 1 + 2j; `buf` has a slot for each stamp.
    `buf` None stamps nothing."""
    if buf is None:
        yield
        return
    n = len(labels)
    slots = {label: (k, n if k == n - 1 else None) for k, label in enumerate(labels)}
    slots.update({label: (n + 1 + 2 * j, n + 2 + 2 * j) for j, (_, label) in enumerate(nested)})
    token = _CLOCK.set((buf, slots))
    try:
        yield
    finally:
        _CLOCK.reset(token)


@contextlib.contextmanager
def named_scope(label: str):
    """Stage annotation: a `torch.profiler.record_function` span, which a
    capture shows on the host and, around the stage's launches, on the
    device; inside a `stage_clock` that knows the label, also the stage's
    stamps."""
    import torch

    clock = _CLOCK.get()
    slots = None if clock is None else clock[1].get(label)
    with torch.profiler.record_function(label):
        if slots is not None:
            device_stamp(clock[0], slots[0])
        yield
        if slots is not None and slots[1] is not None:
            device_stamp(clock[0], slots[1])


def stage_ms(stamps, labels) -> dict:
    """{label: device ms} from a frame's stamps (ints, ns; the stages'
    len(labels) + 1 first): each stage from its entry stamp to the next."""
    return {label: (stamps[k + 1] - stamps[k]) / 1e6 for k, label in enumerate(labels)}


def device_result(stamps, labels, nested=()) -> ProfilerResult:
    """A frame's stamps as a "device" span with one child a stage, each
    lasting its device time, and under a stage the spans of `nested`
    (`stage_clock`'s pairs) whose two stamps the frame has; starts are
    the card's clock in seconds."""
    n = len(labels)
    stages = [ProfilerResult(label, stamps[k] / 1e9, (stamps[k + 1] - stamps[k]) / 1e9)
              for k, label in enumerate(labels)]
    for j, (stage, label) in enumerate(nested):
        s = n + 1 + 2 * j
        if len(stamps) >= s + 2:
            stages[labels.index(stage)].children.append(
                ProfilerResult(label, stamps[s] / 1e9, (stamps[s + 1] - stamps[s]) / 1e9))
    return ProfilerResult("device", stamps[0] / 1e9, (stamps[n] - stamps[0]) / 1e9, stages)


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
