"""device_idle_pct: 100 x (1 - the union of the device operations'
intervals over the traced window's wall time)."""

from metrics._common import device_ops, union


def read(ctx):
    trace = ctx.get("trace")
    if not trace:
        return None
    ops = device_ops(trace)
    if not ops:
        return None
    busy = union((s, e) for s, e, _, _ in ops)
    return 100.0 * (1.0 - busy / (trace["end"] - trace["start"]))
