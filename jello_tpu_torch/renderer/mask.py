"""MSAA half-plane sample mask LUTs (reference: renderer/mask.go).

Precomputed tables mapping a quantized (slope, translation, direction)
to the multisample coverage mask of one pixel: 32x32 8-sample masks
(rotated-grid pattern) and 64x64 16-sample masks (the D3D11 standard
sample pattern). Consumed by the MSAA fine variants.

The port's own copy of `jello_tpu/renderer/mask.py` (same text), so that the
port imports nothing of `jello_tpu`.
"""

from __future__ import annotations

import functools

import numpy as np

MASK8_WIDTH = 32
MASK8_HEIGHT = 32
_MASK8_PATTERN = (0, 5, 3, 7, 1, 4, 6, 2)

MASK16_WIDTH = 64
MASK16_HEIGHT = 64
# D3D11 standard 16x multisample pattern.
_MASK16_PATTERN = (1, 8, 4, 11, 15, 7, 3, 12, 0, 9, 5, 13, 2, 10, 6, 14)


def _one_mask(pattern, inv_n, slope: float, translation: float, is_pos: bool) -> int:
    if is_pos:
        translation = 1.0 - translation
    result = 0
    for i, item in enumerate(pattern):
        y = (i + 0.5) * inv_n
        x = (item + 0.5) * inv_n
        if not is_pos:
            y = 1.0 - y
        if (x - (1.0 - translation)) * (1.0 - slope) - (y - translation) * slope >= 0.0:
            result |= 1 << i
    return result


def _make_lut(width, height, pattern):
    inv_n = 1.0 / len(pattern)
    half = height // 2
    out = np.zeros(width * height, dtype=np.uint16)
    for i in range(width * height):
        u = i % width
        v = i // width
        is_pos = v >= half
        slope = (v % half + 0.5) / half
        translation = (u + 0.5) / width
        out[i] = _one_mask(pattern, inv_n, slope, translation, is_pos)
    return out


@functools.lru_cache(maxsize=None)
def mask_lut_8() -> np.ndarray:
    """32*32 8-bit masks (one uint8 value per entry)."""
    return _make_lut(MASK8_WIDTH, MASK8_HEIGHT, _MASK8_PATTERN).astype(np.uint8)


@functools.lru_cache(maxsize=None)
def mask_lut_16() -> np.ndarray:
    """64*64 16-bit masks."""
    return _make_lut(MASK16_WIDTH, MASK16_HEIGHT, _MASK16_PATTERN)
