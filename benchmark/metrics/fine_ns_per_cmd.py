"""fine_ns_per_cmd: device ns of the stage clock's `fine` span over the
coarse commands of the frame (the call's count `cmds`), over the traced
calls. A slower fine stage reads higher; a larger scene does not."""

from metrics._stage_per_count import stage_ns_per


def read(ctx):
    return stage_ns_per(ctx, "fine", "cmds")
