"""Analytic gradient evaluation from color stops.

The reference samples gradients through a 512-texel f16 ramp texture
baked per gradient (renderer/ramp_cache.go:40, fine.wgsl:28). A TPU has
no texture unit: texel fetches become either per-command DMAs or
one-hot matmuls over the whole texture — both scale badly. Instead the
fine stage evaluates the same function the bake evaluates, analytically
per pixel: piecewise-linear interpolation of the color stops in sRGB
component space (what renderer/ramp_cache.go:139-150 interpolates),
then the sRGB EOTF and premultiplication. This is the exact curve the
texture approximates at 512 samples, so it is strictly more accurate
than the reference (no texel quantization), and it vectorizes: the
whole stop table is a few KB and per-segment lerps are dense VPU work.

Stop-table row layout (f32), for a table-wide max stop count S:
  word 0           n_stops (as float)
  words 1..S       stop offsets p_k (padded by repeating the last)
  words 1+S..1+5S  stop colors, sRGB straight alpha, [r,g,b,a] per stop
Total row width 1 + 5*S, padded to ROW_PAD for device alignment.
"""

from __future__ import annotations

import numpy as np

ROW_PAD = 128  # device rows are lane-aligned


def stops_row_width(max_stops: int) -> int:
    return 1 + 5 * max_stops


def bake_stops_row(stops, max_stops: int) -> np.ndarray:
    """One table row (width stops_row_width) from a ColorStop sequence.

    Mirrors make_ramp's stop normalization: a 0-offset stop is prepended
    when missing; colors are stored in sRGB straight alpha
    (ramp_cache.go:139-150 interpolates in sRGB)."""
    from ..gfx import ColorSpace

    stops = list(stops)
    if stops[0].offset != 0.0:
        stops = [type(stops[0])(0.0, stops[0].color)] + stops
    assert len(stops) <= max_stops, (len(stops), max_stops)
    S = max_stops
    row = np.zeros(stops_row_width(S), dtype=np.float32)
    row[0] = len(stops)
    for k in range(S):
        st = stops[min(k, len(stops) - 1)]
        row[1 + k] = st.offset
        vals = st.color.convert(ColorSpace.SRGB).values
        row[1 + S + 4 * k : 1 + S + 4 * k + 4] = vals
    return row


def stops_table_or_empty(ramps) -> np.ndarray:
    """The frame's stop table, or a 1-row placeholder when no gradients."""
    if getattr(ramps, "height", 0) > 0:
        return np.asarray(ramps.stops, dtype=np.float32)
    return np.zeros((1, stops_row_width(2)), dtype=np.float32)


def srgb_eotf(xp, c):
    """sRGB -> linear transfer, elementwise, xp-generic f32."""
    lo = c * np.float32(1.0 / 12.92)
    hi = ((c + np.float32(0.055)) * np.float32(1.0 / 1.055)) ** np.float32(2.4)
    return xp.where(c <= np.float32(0.04045), lo, hi)


def sample_stops(xp, rows, t):
    """Evaluate gradients analytically.

    rows: [G, W] stop-table rows (already gathered per command).
    t:    [G, 256] positions in [0, 1] (post extend-mode).
    Returns [4, G, 256] premultiplied linear RGBA."""
    S = (rows.shape[1] - 1) // 5
    p = [rows[:, 1 + k][:, None] for k in range(S)]
    ch = [
        [rows[:, 1 + S + 4 * k + c][:, None] for k in range(S)]
        for c in range(4)
    ]
    acc = [ch[c][0] * xp.ones_like(t) for c in range(4)]
    for k in range(S - 1):
        denom = xp.maximum(p[k + 1] - p[k], np.float32(1e-9))
        u = xp.clip((t - p[k]) / denom, 0.0, 1.0)
        for c in range(4):
            acc[c] = acc[c] + (ch[c][k + 1] - ch[c][k]) * u
    a = acc[3]
    return xp.stack(
        [srgb_eotf(xp, acc[0]) * a, srgb_eotf(xp, acc[1]) * a,
         srgb_eotf(xp, acc[2]) * a, a]
    )
