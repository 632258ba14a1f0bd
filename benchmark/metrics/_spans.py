"""What the readers of the program's own spans share: the call groups of
`Renderer.profiler` over the traced frames (`ctx["spans"]`, a list of
`ProfilerResult` trees: label, duration in seconds, children), the spans
below them found by label, and the mean a traced frame.

A program that has no such span gives nothing to read: the readers then
return None."""

from __future__ import annotations


def calls(ctx) -> list:
    return ctx.get("spans") or []


def children(span, label) -> list:
    return [c for c in getattr(span, "children", None) or [] if c.label == label]


def device_spans(ctx) -> list:
    """The `device` span of each traced call (the stage clock's times of
    the frame it returned: the last of its enqueue spans that has one)."""
    out = []
    for call in calls(ctx):
        found = [d for e in children(call, "enqueue") for d in children(e, "device")]
        if found:
            out.append(found[-1])
    return out


def prepare_part_ms(ctx, label) -> float | None:
    """Mean host ms a traced call in the `prepare` span's child `label`."""
    return mean([c.duration * 1e3 for call in calls(ctx) for p in children(call, "prepare")
                 for c in children(p, label)])


def mean(values) -> float | None:
    return sum(values) / len(values) if values else None
