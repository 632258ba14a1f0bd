"""Binning + coarse command generation, in torch.

Counterpart of `jello_tpu/pipeline/coarse.py`: `binning_bboxes` and
`build_commands` with its dense branch (`coarse.py:205`, the
clip-free frame: every draw owns its slot rect, so the slot space is
the (draw, tile) pair space) and its general pair expansion (a frame
with clips, where an EndClip shares its BeginClip's slots, or one whose
`tiles_overflow` retry has grown `tiles_cap` past `pair_cap`). A
vectorized include filter and one stable sort by tile id, which keeps
draw order within each tile, produce the command stream; per-tile
command ranges come from its run boundaries. `classify_legacy_tiles`
marks the tiles whose tape the record-stream kernel cannot express.
"""

from __future__ import annotations

import torch

from ..encoding.draw import (
    DRAW_TAG_BEGIN_CLIP,
    DRAW_TAG_COLOR,
    DRAW_TAG_END_CLIP,
    DRAW_TAG_IMAGE,
    DRAW_TAG_LINEAR_GRADIENT,
    DRAW_TAG_NOP,
    DRAW_TAG_RADIAL_GRADIENT,
    DRAW_TAG_SWEEP_GRADIENT,
)

from . import ops
from .flatten import expand_by_counts
from .ops import I32
from .tiling import TILE_SCALE

BIG = 1e9

CMD_COLOR = 1
CMD_LIN_GRAD = 2
CMD_RAD_GRAD = 3
CMD_SWEEP_GRAD = 4
CMD_IMAGE = 5
CMD_BEGIN_CLIP = 6
CMD_END_CLIP = 7

BLEND_PURE_CLIP = 0x8000


def binning_bboxes(dm, path_bbox, clip_bboxes):
    """Intersected draw bboxes."""
    clip_idx = dm["clip_idx"]
    cb = ops.gather_guarded(clip_bboxes, torch.clamp(clip_idx - 1, min=0))
    cb = torch.where((clip_idx > 0)[:, None], cb,
                     ops.unbounded_bboxes(1, path_bbox.device, BIG))
    pb = ops.gather_guarded(path_bbox, dm["path_idx"])
    return torch.stack([
        torch.maximum(cb[:, 0], pb[:, 0]),
        torch.maximum(cb[:, 1], pb[:, 1]),
        torch.minimum(cb[:, 2], pb[:, 2]),
        torch.minimum(cb[:, 3], pb[:, 3]),
    ], dim=1)


def _draw_kind(tag):
    kind = torch.zeros_like(tag)
    for t, k in ((DRAW_TAG_END_CLIP, CMD_END_CLIP), (DRAW_TAG_BEGIN_CLIP, CMD_BEGIN_CLIP),
                 (DRAW_TAG_IMAGE, CMD_IMAGE), (DRAW_TAG_SWEEP_GRADIENT, CMD_SWEEP_GRAD),
                 (DRAW_TAG_RADIAL_GRADIENT, CMD_RAD_GRAD),
                 (DRAW_TAG_LINEAR_GRADIENT, CMD_LIN_GRAD), (DRAW_TAG_COLOR, CMD_COLOR)):
        kind = torch.where(tag == t, k, kind)
    return kind.to(I32)


def build_commands(layout, dm, tag, dtab, draw_bbox, paths, counted, path_draw_flags, caps):
    """The per-tile command SoA, sorted by (tile, draw order), with the
    per-tile ranges and the counters capacity calibration reads."""
    dev = tag.device
    D = caps["n_draws_cap"]
    PC = caps["pair_cap"]
    GRID = caps["tile_grid_cap"]
    wit = layout["width_in_tiles"]
    hit = layout["height_in_tiles"]

    act = (ops.iota(D, dev) < layout["n_draw_objects"]) & (tag != DRAW_TAG_NOP)
    nonempty = (draw_bbox[:, 0] < draw_bbox[:, 2]) & (draw_bbox[:, 1] < draw_bbox[:, 3])
    ok = act & nonempty
    z = torch.zeros_like(draw_bbox[:, 0])

    def q(v, f):
        return torch.where(ok, f(v * TILE_SCALE), z).to(I32)

    rx0 = q(draw_bbox[:, 0], torch.floor).clamp(0, wit)
    ry0 = q(draw_bbox[:, 1], torch.floor).clamp(0, hit)
    rx1 = q(draw_bbox[:, 2], torch.ceil).clamp(0, wit)
    ry1 = q(draw_bbox[:, 3], torch.ceil).clamp(0, hit)
    pp = dm["path_idx"]
    prow_p = ops.gather_guarded(torch.stack(
        [paths["rect_x0"], paths["rect_y0"], paths["rect_x1"], paths["rect_y1"],
         paths["tile_offset"], path_draw_flags], dim=1), pp)
    prx0, pry0, prx1, pry1 = prow_p[:, 0], prow_p[:, 1], prow_p[:, 2], prow_p[:, 3]
    rx0 = torch.maximum(rx0, prx0)
    ry0 = torch.maximum(ry0, pry0)
    rx1 = torch.minimum(rx1, prx1)
    ry1 = torch.minimum(ry1, pry1)
    w = torch.clamp(rx1 - rx0, min=0)
    n_pairs = w * torch.clamp(ry1 - ry0, min=0)

    is_clip_d = (tag == DRAW_TAG_BEGIN_CLIP) | (tag == DRAW_TAG_END_CLIP)
    blend_d = dtab[:, 0]
    alpha_d = ops.bitcast_u32_f32(dtab[:, 1])
    is_blend_d = is_clip_d & ~((blend_d == BLEND_PURE_CLIP) & (alpha_d == 1.0))
    legacy_blend_d = is_clip_d & ((blend_d & 0x7FFF) != 0)
    etab = torch.stack([
        w, rx0, ry0, pp, prx0, pry0, torch.clamp(prx1 - prx0, min=1), prow_p[:, 4],
        _draw_kind(tag), prow_p[:, 5], is_blend_d.to(I32), legacy_blend_d.to(I32),
    ], dim=1)

    # Dense only on a clip-free frame (`_coarse_dense`, set per frame by
    # the renderer): an EndClip owns no slot rect of its own.
    if caps.get("_coarse_dense") and PC == caps["tiles_cap"]:
        rec = paths["tile_draw"]
        valid = paths["tile_valid"]
        pair_total = paths["n_tiles"]
        drow = ops.gather_guarded(etab, rec)
        tile_global = paths["tile_ty"] * wit + paths["tile_tx"]
        tile_slot = ops.iota(PC, dev)
        seg_count = counted["seg_count"]
        seg_start = counted["seg_start"]
        backdrop = counted["backdrop"]
    else:
        rec, within, valid, _, pair_total = expand_by_counts(n_pairs, PC)
        drow = ops.gather_guarded(etab, rec)
        stride = torch.clamp(drow[:, 0], min=1)
        ly = torch.div(within, stride, rounding_mode="floor")
        tx = drow[:, 1] + (within - ly * stride)
        ty = drow[:, 2] + ly
        tile_global = ty * wit + tx
        tile_slot = drow[:, 7] + (ty - drow[:, 5]) * drow[:, 6] + (tx - drow[:, 4])
        crow = ops.gather_guarded(torch.stack(
            [counted["seg_count"], counted["seg_start"], counted["backdrop"]], dim=1),
            tile_slot)
        seg_count, seg_start, backdrop = crow[:, 0], crow[:, 1], crow[:, 2]

    kind = drow[:, 8]
    is_begin = kind == CMD_BEGIN_CLIP
    is_clip = is_begin | (kind == CMD_END_CLIP)
    is_blend = drow[:, 10] != 0
    # bit0 even-odd fill rule; bit3 non-affine blend group.
    flags = torch.where(kind == CMD_END_CLIP, 0, drow[:, 9]) | (drow[:, 11] << 3)
    even_odd = (flags & 1) != 0
    backdrop_clear = torch.where(even_odd, (torch.abs(backdrop) & 1) == 0, backdrop == 0)
    include = ((seg_count != 0) | (backdrop_clear == is_clip) | is_blend) & valid
    begin_zero = is_begin & (seg_count == 0) & (backdrop == 0)

    sort_key = torch.where(include, tile_global, GRID).to(I32)
    n_cmds_true = include.to(I32).sum()
    out = ops.sort_multi(sort_key, (
        kind, seg_start, torch.where(begin_zero, -1, seg_count), backdrop,
        tile_slot, flags, rec))
    # Excluded records sort to the tail; keep the calibrated live prefix.
    CC = min(caps.get("cmd_cap", PC), PC)
    out = tuple(a[:CC] for a in out)
    names = ("tile", "kind", "seg_start", "seg_count", "backdrop", "tile_slot", "flags", "draw")
    cmds = {k: v.to(I32) for k, v in zip(names, out)}

    st = cmds["tile"]
    n = st.shape[0]
    i_ids = ops.iota(n, dev)
    prev = torch.cat([torch.full((1,), -1, dtype=I32, device=dev), st[:-1]])
    nxt = torch.cat([st[1:], torch.full((1,), GRID + 1, dtype=I32, device=dev)])
    first = (st != prev) & (st < GRID)
    last = (st != nxt) & (st < GRID)
    zeros = torch.zeros(GRID, dtype=I32, device=dev)
    cmds["tile_start"] = ops.scatter_set(zeros, torch.where(first, st, GRID), i_ids)
    cmds["tile_end"] = ops.scatter_set(zeros, torch.where(last, st, GRID), i_ids + 1)
    cmds["n_cmds"] = n_cmds_true
    cmds["pair_total"] = pair_total
    cmds["max_cmds"] = (cmds["tile_end"] - cmds["tile_start"]).max()
    cmds["overflow"] = (pair_total > PC) | (n_cmds_true > CC)
    return cmds


def classify_legacy_tiles(cmds, caps):
    """Mark the tiles that need the per-tile interpreter (kernels G, H).

    A tile is legacy iff its tape holds something the record-stream
    kernel's affine formulation cannot express: an image paint (unless
    the image tap feeds kernel B, `_image_tap` in caps), a non-affine
    blend group (flag bit 3 on its Begin or EndClip) or a nested clip
    (within-tile clip depth >= 2). Depth-1 groups whose blend is
    src-over stay on kernel B, which composes the group first.

    Returns (lt_flag [GRID] i32 0/1, d_excl [PC] i32 within-tile clip
    depth before each record, is_begin, is_end [PC] bool)."""
    GRID = caps["tile_grid_cap"]
    tile = cmds["tile"]
    kind = cmds["kind"]
    in_grid = tile < GRID
    is_begin = kind == CMD_BEGIN_CLIP
    is_end = kind == CMD_END_CLIP
    is_blend = (cmds["flags"] & 8) != 0

    # Global exclusive cumsum of (begin - end), rebased at the tile's
    # first record.
    g = ops.exclusive_cumsum(is_begin.to(I32) - is_end.to(I32))
    start_of_tile = ops.gather_guarded(cmds["tile_start"], torch.clamp(tile, 0, GRID - 1))
    d_excl = torch.where(in_grid, g - ops.gather_guarded(g, start_of_tile), 0)

    bad = (is_begin & (d_excl >= 1)) | (is_blend & (is_begin | is_end))
    if not caps.get("_image_tap"):
        bad = bad | (kind == CMD_IMAGE)
    lt = ops.scatter_max(torch.zeros(GRID + 1, dtype=I32, device=tile.device),
                         torch.where(in_grid, tile, GRID), (bad & in_grid).to(I32))
    return lt[:GRID], d_excl, is_begin, is_end
