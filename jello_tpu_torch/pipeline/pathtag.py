"""Path tag monoid scan, in torch.

Counterpart of `jello_tpu/cpu/pathtag.py` (`tag_monoid_deltas`,
`tag_monoid_scan`) and of the two-level scan of a tag-range shard in
`jello_tpu/pipeline/flatten.py` (`exclusive_monoids(base=)`,
`monoid_delta_totals`). The path tag stream is decoded by an exclusive
prefix scan of a 5-component monoid over tag bytes: (trans_idx,
path_seg_idx, path_seg_offset, style_idx, path_idx). path_seg_offset
counts u32 words of path data (2 per f32 point, 1 per i16 point; the
subpath-end bit adds the final point).
"""

from __future__ import annotations

import torch

from ..encoding.path import (
    PATH_TAG_F32_BIT,
    PATH_TAG_PATH,
    PATH_TAG_SEG_TYPE_MASK,
    PATH_TAG_STYLE,
    PATH_TAG_TRANSFORM,
    STYLE_SIZE_WORDS,
)

FIELDS = ("path_idx", "path_seg_idx", "path_seg_offset", "style_idx", "trans_idx")


def tag_monoid_deltas(tags: torch.Tensor) -> dict:
    """Per-tag-byte monoid deltas (int32) of int32 tag bytes."""
    tags = tags.to(torch.int32)
    seg_type = tags & PATH_TAG_SEG_TYPE_MASK
    has_seg = (seg_type != 0).to(torch.int32)
    n_points = seg_type + ((tags >> 2) & 1) * has_seg
    is_f32 = ((tags & PATH_TAG_F32_BIT) != 0).to(torch.int32)
    return {
        "trans_idx": ((tags & PATH_TAG_TRANSFORM) != 0).to(torch.int32),
        "path_seg_idx": has_seg,
        "path_seg_offset": n_points * (1 + is_f32),
        "style_idx": ((tags & PATH_TAG_STYLE) != 0).to(torch.int32) * STYLE_SIZE_WORDS,
        "path_idx": ((tags & PATH_TAG_PATH) != 0).to(torch.int32),
    }


def tag_monoid_scan(tags: torch.Tensor, base=None) -> dict:
    """Exclusive prefix monoid per tag byte: all five fields ride one
    column scan (kernel I). `base` (int32 [5] in FIELDS order), for a
    tag-range shard, adds the deltas of every tag before the range
    (`jello_tpu/pipeline/flatten.py:106-125`, `exclusive_monoids`)."""
    from ..cuda.scan import column_scan

    deltas = tag_monoid_deltas(tags)
    c = column_scan([deltas[k] for k in FIELDS], "sum", exclusive=True)
    if base is not None:
        c = c + base[:, None]
    return {k: c[i] for i, k in enumerate(FIELDS)}


def monoid_delta_totals(tags: torch.Tensor) -> torch.Tensor:
    """The sums of the monoid deltas over a tag range, int32 [5] in FIELDS
    order: the per-shard level of the two-level scan
    (`jello_tpu/pipeline/flatten.py:128-131`)."""
    deltas = tag_monoid_deltas(tags)
    return torch.stack([deltas[k].sum(dtype=torch.int32) for k in FIELDS])
