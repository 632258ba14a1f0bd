"""Draw tag stream constants and payload encoding (reference: encoding/draw.go).

A DrawTag is a u32 whose bit fields are the per-object deltas of the draw
monoid:
  - bit 0:        contributes to the clip count,
  - bits 2..4:    number of u32 words of scene draw data,
  - bits 6..9:    number of u32 words of draw "info" generated by
                  draw_leaf for the fine stage (InfoSize).
"""

from __future__ import annotations

DRAW_TAG_NOP = 0x0
DRAW_TAG_COLOR = 0x50
DRAW_TAG_LINEAR_GRADIENT = 0x114
DRAW_TAG_RADIAL_GRADIENT = 0x29C
DRAW_TAG_SWEEP_GRADIENT = 0x254
DRAW_TAG_IMAGE = 0x248
DRAW_TAG_BEGIN_CLIP = 0x9
DRAW_TAG_END_CLIP = 0x21


def info_size(tag: int) -> int:
    return (tag >> 6) & 0xF


def is_clip(tag: int) -> bool:
    return (tag & 1) != 0
