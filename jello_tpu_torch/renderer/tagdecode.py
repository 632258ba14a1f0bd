"""Numpy decode of the packed path streams, for the capacity estimate.

`estimate_caps_from_scene` runs on the host, before anything is on the
device, so it decodes the tag stream with numpy. These are the numpy
branches of the helpers it uses from `jello_tpu/pipeline/flatten.py`
(`decode_tag_stream`, `exclusive_monoids`, `_read_points`,
`_normalize_segment`, `_transform_read`, `_apply_transform`),
`jello_tpu/pipeline/ops.py` (`gather_guarded`, `bitcast_u32_f32`) and
`jello_tpu/cpu/pathtag.py` (`tag_monoid_deltas`), with the same
signatures (the leading `xp` is always numpy here) and the same
arithmetic, so the caps equal jello_tpu's key for key. The device
pipeline's decode is `pipeline/flatten.py`, in torch.
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

_SEG_LINE = 1
_SEG_QUAD = 2


def gather_guarded(xp, arr, idx):
    """arr[idx] with out-of-range indices clamped (callers mask)."""
    return arr[xp.clip(idx.astype(xp.int64), 0, arr.shape[0] - 1)]


def bitcast_u32_f32(xp, v):
    return np.asarray(v, dtype=np.uint32).view(np.float32)


def tag_monoid_deltas(tags):
    """Per-tag-byte monoid deltas (uint32)."""
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


def decode_tag_stream(xp, scene, path_tag_base, n_slots):
    """Per-byte tag values for slots [0, n_slots)."""
    word_idx = path_tag_base + (xp.arange(n_slots, dtype=xp.int32) >> 2)
    words = gather_guarded(xp, scene, word_idx)
    shift = (xp.arange(n_slots, dtype=xp.uint32) & 3) << 3
    return (words >> shift) & 0xFF


def exclusive_monoids(xp, tags):
    """Exclusive prefix of the tag monoid (all five fields ride one
    column cumsum)."""
    deltas = tag_monoid_deltas(tags)
    keys = sorted(deltas)
    d = xp.stack([deltas[k].astype(xp.uint32) for k in keys], axis=1)
    c = xp.cumsum(d, axis=0) - d
    return {k: c[:, i] for i, k in enumerate(keys)}


def _read_points(xp, scene, base_words, tag):
    """Read a path segment as cubic control points (before
    normalization). Returns (p0x..p3y, seg_type); `base_words` is
    path_data_base + path_seg_offset."""
    is_f32 = (tag & PATH_TAG_F32_BIT) != 0
    seg_type = (tag & PATH_TAG_SEG_TYPE_MASK).astype(xp.int32)

    N = base_words.shape[0]
    offs = xp.arange(8, dtype=xp.int32)[:, None]
    idx = (base_words[None, :].astype(xp.int32) + offs).reshape(-1)
    W = gather_guarded(xp, scene, idx).reshape(8, N)

    def rdf(off):
        return bitcast_u32_f32(xp, W[off])

    def rdi16(off):
        w = W[off]
        x = ((w << 16).astype(xp.int32) >> 16).astype(xp.float32)
        y = (w.astype(xp.int32) >> 16).astype(xp.float32)
        return x, y

    # f32 layout: 2 words per point; i16: 1 word per point.
    i0x, i0y = rdi16(0)
    i1x, i1y = rdi16(1)
    i2x, i2y = rdi16(2)
    i3x, i3y = rdi16(3)
    p0x = xp.where(is_f32, rdf(0), i0x)
    p0y = xp.where(is_f32, rdf(1), i0y)
    p1x = xp.where(is_f32, rdf(2), i1x)
    p1y = xp.where(is_f32, rdf(3), i1y)
    p2x = xp.where(is_f32, rdf(4), i2x)
    p2y = xp.where(is_f32, rdf(5), i2y)
    p3x = xp.where(is_f32, rdf(6), i3x)
    p3y = xp.where(is_f32, rdf(7), i3y)
    return p0x, p0y, p1x, p1y, p2x, p2y, p3x, p3y, seg_type


def _normalize_segment(xp, pts, seg_type, tag, is_stroke):
    """Cap-marker remap + degree raise."""
    p0x, p0y, p1x, p1y, p2x, p2y, p3x, p3y = pts
    is_marker = is_stroke & ((tag & PATH_TAG_SUBPATH_END_BIT) != 0)
    is_open = seg_type == _SEG_QUAD
    remap = is_marker & is_open
    # p0 <- p1, p1 <- p2, becomes a line.
    p0x, p0y, p1x, p1y = (
        xp.where(remap, p1x, p0x),
        xp.where(remap, p1y, p0y),
        xp.where(remap, p2x, p1x),
        xp.where(remap, p2y, p1y),
    )
    seg_type = xp.where(remap, _SEG_LINE, seg_type)

    # Degree raise.
    is_line = seg_type == _SEG_LINE
    is_quad = seg_type == _SEG_QUAD
    # line: p3=p1; p2=mix(p3,p0,1/3); p1=mix(p0,p3,1/3)
    l3x, l3y = p1x, p1y
    l2x = l3x + (p0x - l3x) * (1.0 / 3.0)
    l2y = l3y + (p0y - l3y) * (1.0 / 3.0)
    l1x = p0x + (l3x - p0x) * (1.0 / 3.0)
    l1y = p0y + (l3y - p0y) * (1.0 / 3.0)
    # quad: p3=p2; p2=mix(p1,p2,1/3); p1=mix(p1,p0,1/3)
    q3x, q3y = p2x, p2y
    q2x = p1x + (p2x - p1x) * (1.0 / 3.0)
    q2y = p1y + (p2y - p1y) * (1.0 / 3.0)
    q1x = p1x + (p0x - p1x) * (1.0 / 3.0)
    q1y = p1y + (p0y - p1y) * (1.0 / 3.0)

    o1x = xp.where(is_line, l1x, xp.where(is_quad, q1x, p1x))
    o1y = xp.where(is_line, l1y, xp.where(is_quad, q1y, p1y))
    o2x = xp.where(is_line, l2x, xp.where(is_quad, q2x, p2x))
    o2y = xp.where(is_line, l2y, xp.where(is_quad, q2y, p2y))
    o3x = xp.where(is_line, l3x, xp.where(is_quad, q3x, p3x))
    o3y = xp.where(is_line, l3y, xp.where(is_quad, q3y, p3y))
    return (p0x, p0y, o1x, o1y, o2x, o2y, o3x, o3y), seg_type, is_marker, is_open


def _transform_read(xp, scene, transform_base, trans_idx):
    base = transform_base + trans_idx.astype(xp.int32) * 6
    return [bitcast_u32_f32(xp, gather_guarded(xp, scene, base + i)) for i in range(6)]


def _apply_transform(t, x, y):
    return t[0] * x + t[2] * y + t[4], t[1] * x + t[3] * y + t[5]
