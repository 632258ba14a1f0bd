"""What the readers of a stage's device time per unit of work share: the
stage clock's span of a stage in each traced call (the `device` span under
the call's last `enqueue` span, `_spans.device_spans`), over a count the
call carries of the frame it returned (`ProfilerResult.counts`)."""

from __future__ import annotations

from metrics._spans import calls, children


def stage_ns_per(ctx, stage, count) -> float | None:
    """Device ns of `stage` over the count `count`, summed over the traced
    calls that have both; None where none has (a call without the count,
    as a program that puts none on its calls, or without the stage's
    span)."""
    ns, n = 0.0, 0
    for call in calls(ctx):
        counted = (getattr(call, "counts", None) or {}).get(count)
        found = [d for e in children(call, "enqueue") for d in children(e, "device")]
        spans = children(found[-1], stage) if found else []
        if counted and spans:
            ns += spans[0].duration * 1e9
            n += counted
    return ns / n if n else None
