"""image_tap_ns_per_rec: device ns of the stage clock's `image_tap` span
(the image tap, from its entry stamp to its exit stamp, nested in the
`fine` span) over the frame's image records (the call's count
`img_recs`), summed over the traced calls that have both. A slower tap
reads higher; more sprites do not. A program whose frames carry no such
span or count gives nothing to read."""

from metrics._spans import calls, children


def tap_span(call):
    """The `image_tap` span under the `fine` span of the call's stage
    clock (the `device` span of its last `enqueue` span), or None."""
    found = [d for e in children(call, "enqueue") for d in children(e, "device")]
    spans = [t for f in children(found[-1], "fine") for t in children(f, "image_tap")] \
        if found else []
    return spans[0] if spans else None


def read(ctx):
    ns, n = 0.0, 0
    for call in calls(ctx):
        counted = (getattr(call, "counts", None) or {}).get("img_recs")
        span = tap_span(call)
        if counted and span is not None:
            ns += span.duration * 1e9
            n += counted
    return ns / n if n else None
