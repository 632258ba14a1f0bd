"""Hybrid fine stage: kernel B over the whole record stream, kernels G
or H over the tiles B cannot express, merged by tile rank.

Counterpart of `jello_tpu/tpu/fine_hybrid.py::fine_hybrid`, the fine
stage of a frame with clip layers:

  1. classify the legacy tiles (`pipeline.coarse.classify_legacy_tiles`:
     a nested clip, a mix or compose blend; an image paint only without
     the image tap);
  2. pack the record flags kernel B reads: bit 1 a record of a legacy
     tile (the identity), bit 4 a depth-1 group's BeginClip and members,
     bit 5 its EndClip, bits 8+ the group id;
  3. coverage rows and packed records once, shared by both kernels; the
     image tap when the frame has an atlas;
  4. kernel B over the whole stream (legacy tiles come out base-colored);
  5. the legacy tiles compacted into `legacy_tiles_cap` slots, their
     records into a slab [LT, MC, 16], and the interpreter over it
     (kernel G, or H with `_interp_batch` in caps);
  6. the interpreter's rows written over the legacy tiles' rows of the
     compact output (`tile2rank`).

Flags: `legacy_overflow` (more legacy tiles than slots),
`cmd_slab_overflow` (a legacy tile's tape longer than `cmds_per_tile`),
`blend_depth_overflow`, `image_region_overflow`, and the coverage and
tap flags.
"""

from __future__ import annotations

import torch

from ..pipeline import ops
from ..pipeline.coarse import classify_legacy_tiles
from ..pipeline.fine_interp import OVF_BLEND_DEPTH, OVF_IMAGE_REGION, build_records, with_width
from ..pipeline.flatten import expand_by_counts
from ..pipeline.image_tap import image_tap, runs_tap
from ..pipeline.ops import I32
from . import fine_interp as kinterp
from . import fine_v2 as kfine
from .coverage import compute_area_rows


def pack_group_flags(cmds, caps):
    """The record flags word with kernel B's group metadata, and the
    legacy classification it rests on. Returns (flags [PC] i32, lt_flag
    [GRID] i32, rec_legacy [PC] bool).

    A new pass-1 id starts at every record outside a group and at each
    BeginClip, so the ids rise along the stream and a group's records
    share one."""
    GRID = caps["tile_grid_cap"]
    tile = cmds["tile"]
    in_grid = tile < GRID
    lt_flag, d_excl, is_begin, is_end = classify_legacy_tiles(cmds, caps)
    legacy_flag = torch.cat([lt_flag, lt_flag.new_zeros(1)])
    rec_legacy = ops.gather_guarded(legacy_flag, torch.clamp(tile, 0, GRID)) > 0
    non_leg = ~rec_legacy & in_grid
    in_group = non_leg & (is_begin | is_end | (d_excl >= 1))
    end_t = non_leg & is_end
    ident2 = in_group & ~is_end
    seg1 = torch.cumsum((~in_group | is_begin).to(I32), 0, dtype=I32)
    flags = (cmds["flags"] | (rec_legacy.to(I32) << 1) | (ident2.to(I32) << 4)
             | (end_t.to(I32) << 5) | (seg1 << 8))
    return flags, lt_flag, rec_legacy


def fine_hybrid(cmds, counted, ramps, atlas, layout, caps):
    """The fine stage of a frame with clip layers, in the antialiasing
    mode of `caps["aa_mode"]` (under MSAA both kernels read kernel A's
    resolved rows as they are). Returns ((compact
    [PC, 4, 256] un-premultiplied, record-indexed; tile2rank [GRID]),
    flags)."""
    GRID = caps["tile_grid_cap"]
    MC = caps["cmds_per_tile"]
    LT = caps.get("legacy_tiles_cap", 2048)
    tile = cmds["tile"]
    in_grid = tile < GRID
    wit = layout["width_in_tiles"]
    resolved = caps.get("aa_mode", "area") != "area"

    flags_w, lt_flag, rec_legacy = pack_group_flags(cmds, caps)
    cmds = dict(cmds, flags=flags_w)

    area, area_row_rec, rows_overflow = compute_area_rows(cmds, counted, caps)
    cmds["area_row"] = area_row_rec
    rec = build_records(cmds, caps)
    flags = {"area_rows_overflow": rows_overflow}
    fg_tab = None
    tap_region = None
    if runs_tap(caps, atlas):
        fg_tab, tap_region, flags["img_recs_overflow"] = image_tap(
            rec, cmds, atlas, layout, caps)

    # Both kernel wrappers are looked up at call time.
    compact = kfine.composite_records(rec, area, ramps, layout["base_color"], cmds["tile_start"],
                                      cmds["tile_end"], wit, fg_tab, resolved)
    tile2rank = kfine.tile_last_record(cmds["tile_start"], cmds["tile_end"])

    # Compact legacy tile list: slot s holds the s-th legacy tile.
    lrec, _, lvalid, _, n_legacy = expand_by_counts(lt_flag, LT)
    legacy_ids = torch.where(lvalid, lrec, GRID).to(I32)
    flags["legacy_overflow"] = n_legacy > LT

    # Slab slot of a record: legacy rank of its tile * MC + index within
    # the tile's run.
    lidx_of_tile = ops.exclusive_cumsum(lt_flag)
    j = ops.iota(tile.shape[0], tile.device)
    within = j - ops.gather_guarded(cmds["tile_start"], tile)
    lidx = ops.gather_guarded(lidx_of_tile, tile)
    ok = rec_legacy & in_grid & (within < MC) & (lidx < LT)
    slot = torch.where(ok, lidx * MC + within, LT * MC)
    slab = ops.scatter_set(torch.zeros((LT * MC, 16), dtype=I32, device=rec.device),
                           slot, rec).reshape(LT, MC, 16)
    # Only a legacy tile's tape must fit the slab. (jello_tpu also flags a
    # non-legacy clip tile longer than MC, for its kernel's coverage
    # window; kernel B here walks a tile's run whatever its length.)
    n_cmds_tile = cmds["tile_end"] - cmds["tile_start"]
    flags["cmd_slab_overflow"] = ((lt_flag > 0) & (n_cmds_tile > MC)).any()

    counts_tile = torch.clamp(n_cmds_tile, 0, MC).to(I32)
    counts = torch.where(
        legacy_ids < GRID,
        ops.gather_guarded(counts_tile, torch.clamp(legacy_ids, 0, GRID - 1)), 0)
    legacy_out, ovf = kinterp.interpret_tiles(
        with_width(counts, wit), legacy_ids, layout["base_color"], slab, area, ramps, atlas,
        caps["blend_depth"], bool(caps.get("_interp_batch")), resolved)
    flags["blend_depth_overflow"] = ((ovf & OVF_BLEND_DEPTH) != 0).any()
    region = ((ovf & OVF_IMAGE_REGION) != 0).any()
    flags["image_region_overflow"] = region if tap_region is None else region | tap_region

    # Merge: the interpreter's rows over the legacy tiles' rows. The live
    # slots are a prefix of the list; every other slot repeats slot 0's
    # write (or, with no legacy tile, row 0's own value), so that equal
    # values land on equal rows and no row needs a dump slot.
    ranks = ops.gather_guarded(tile2rank, torch.clamp(legacy_ids, 0, GRID - 1))
    live = (legacy_ids < GRID) & (ranks >= 0)
    row0 = torch.where(live[0], ranks[0], 0)
    # (index_select: indexing with a 0-dim device index reads it to the host.)
    val0 = torch.where(live[0], legacy_out[0],
                       compact.index_select(0, row0.long().reshape(1))[0])
    compact.index_copy_(0, torch.where(live, ranks, row0).long(),
                        torch.where(live[:, None, None], legacy_out, val0))
    return (compact, tile2rank), flags
