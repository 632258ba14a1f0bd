"""fine_device_ms: mean device ms a traced frame in the fine stage, from
the stage clock's stamp at fine's entry to the one after it, read from the
`device` span the program puts under each call's `enqueue` span."""

from metrics._spans import children, device_spans, mean


def read(ctx):
    return mean([c.duration * 1e3 for d in device_spans(ctx) for c in children(d, "fine")])
