"""Path tag monoid scan (reference: shared/pathtag.wgsl, renderer/path.go).

The path tag stream is decoded by an exclusive prefix scan of a
5-component monoid over tag bytes:
  (trans_idx, path_seg_idx, path_seg_offset, style_idx, path_idx)
`path_seg_offset` counts u32 words of path data (2 words per f32 point,
1 per i16 point; the subpath-end bit accounts for the extra final
point). The reference scans per 4-byte word with SWAR tricks plus an
in-word combine (renderer/path.go:30-45); an exclusive byte-wise scan is
equivalent, and is what both the oracle and the device pipeline use.
"""

from __future__ import annotations

import numpy as np

from ..encoding.path import (
    PATH_TAG_F32_BIT,
    PATH_TAG_PATH,
    PATH_TAG_SEG_TYPE_MASK,
    PATH_TAG_STYLE,
    PATH_TAG_SUBPATH_END_BIT,
    PATH_TAG_TRANSFORM,
    STYLE_SIZE_WORDS,
)


def tag_monoid_deltas(tags):
    """Per-tag-byte monoid deltas; works for numpy and jax arrays.

    tags: uint32/uint8 array of tag bytes.
    Returns dict of delta arrays (same length as tags).
    """
    xp = np
    tags = tags.astype(xp.uint32)
    seg_type = tags & PATH_TAG_SEG_TYPE_MASK
    has_seg = (seg_type != 0).astype(xp.uint32)
    n_points = seg_type + ((tags >> 2) & 1) * has_seg  # subpath end adds a point
    is_f32 = ((tags & PATH_TAG_F32_BIT) != 0).astype(xp.uint32)
    words = n_points * (1 + is_f32)
    return {
        "trans_idx": ((tags & PATH_TAG_TRANSFORM) != 0).astype(xp.uint32),
        "path_seg_idx": has_seg,
        "path_seg_offset": words,
        "style_idx": ((tags & PATH_TAG_STYLE) != 0).astype(xp.uint32) * STYLE_SIZE_WORDS,
        "path_idx": ((tags & PATH_TAG_PATH) != 0).astype(xp.uint32),
    }

