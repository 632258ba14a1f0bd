"""geometry_device_ms: mean device ms a traced frame from the stage
clock's stamp at flatten's entry to the one at coarse's end (every stage
before fine), read from the `device` span the program puts under each
call's `enqueue` span."""

from metrics._spans import device_spans, mean


def read(ctx):
    return mean([sum(c.duration for c in d.children if c.label != "fine") * 1e3
                 for d in device_spans(ctx)])
