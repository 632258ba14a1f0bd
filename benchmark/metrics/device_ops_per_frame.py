"""device_ops_per_frame: the device operations (kernels, copies, memsets)
in the traced window, over its frames."""

from metrics._common import device_ops


def read(ctx):
    trace = ctx.get("trace")
    if not trace:
        return None
    ops = device_ops(trace)
    return len(ops) / trace["frames"] if ops else None
