"""flatten_ns_per_line: device ns of the stage clock's `flatten` span (its
stamp at flatten's entry to the next) over the lines the frame flattened
(the call's count `lines`: euler, simple and arc lines), over the traced
calls. A slower flatten reads higher; a larger scene does not."""

from metrics._stage_per_count import stage_ns_per


def read(ctx):
    return stage_ns_per(ctx, "flatten", "lines")
