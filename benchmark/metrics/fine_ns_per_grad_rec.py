"""fine_ns_per_grad_rec: device ns of the stage clock's `fine` span over
the frame's gradient records (the call's count `grad_recs`: linear,
radial and sweep records inside the tile grid), summed over the traced
calls that have both. Slower gradient paint reads higher; more gradients
do not. A program whose calls carry no such count gives nothing to
read."""

from metrics._stage_per_count import stage_ns_per


def read(ctx):
    return stage_ns_per(ctx, "fine", "grad_recs")
