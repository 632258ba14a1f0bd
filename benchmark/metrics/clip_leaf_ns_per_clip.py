"""clip_leaf_ns_per_clip: device ns of the stage clock's `clip_leaf` span
over the frame's clip draw objects (the call's count `clips`: a
BeginClip and its EndClip each), summed over the traced calls that have
both. A slower clip stage reads higher; more clips do not. A frame with
no clip, or a program whose calls carry no such count, gives nothing to
read."""

from metrics._stage_per_count import stage_ns_per


def read(ctx):
    return stage_ns_per(ctx, "clip_leaf", "clips")
