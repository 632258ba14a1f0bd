"""frame_ms_p95: the 95th percentile, over every frame of the window, of
the host time from the call that submitted the frame (for re-encoded
scenes, from before the frame's Scene.append) to its pixels on the host.
A frame that failed counts as infinitely late; the metric is then left
out, and the run is not correct."""

import math

from metrics._common import percentile


def read(ctx):
    p95 = percentile(ctx["latencies_s"], 95.0) * 1e3
    return p95 if math.isfinite(p95) else None
