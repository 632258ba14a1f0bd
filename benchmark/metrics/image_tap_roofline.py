"""image_tap_roofline: kernel F's (`image_tap_kernel`, the image tap)
share of its byte roofline, in %: the least time the bytes every run of
it must move take at the H100's 3.35 TB/s, over its device time a traced
frame. The bytes (`tap_bytes`) are a frame's image records (the traced
calls' count `img_recs`, their mean) times each record's 16 words read
and its 4 x 256 float table row written; the atlas' reads, served from
L2, and the rows past the records are not counted, so the share cannot
pass 100% while F runs. A program that runs no such kernel, or whose
calls carry no `img_recs`, gives nothing to read."""

from metrics._common import kernel_ms_per_frame
from metrics._spans import calls, mean

PEAK_BYTES_PER_S = 3.35e12
KERNEL = "image_tap_kernel"


def tap_bytes(img_recs: float) -> float:
    """Bytes kernel F must move for `img_recs` image records: 64 of record
    words read and a 4,096-byte table row written each."""
    return img_recs * (16 * 4 + 4 * 256 * 4)


def read(ctx):
    trace = ctx.get("trace")
    if not trace:
        return None
    recs = mean([c.counts["img_recs"] for c in calls(ctx)
                 if "img_recs" in (getattr(c, "counts", None) or {})])
    ms = kernel_ms_per_frame(trace, lambda kind: kind == KERNEL)
    if not recs or not ms:
        return None
    return 100.0 * (tap_bytes(recs) / PEAK_BYTES_PER_S) / (ms / 1e3)
