"""Full-frame pipeline orchestration, in torch.

Counterpart of `jello_tpu/pipeline/render.py::render_frame` (with
`with_stats`). One function from the packed scene words to the fine
output, run eagerly on the device the inputs live on. Capacities
(`caps`) are host ints; every data-dependent allocation reports
overflow through a 0-dim flag instead of failing, and the renderer
re-renders with a larger class.

Stage order: flatten -> draw_leaf -> clip_leaf -> binning
+ tile_alloc -> path_count -> path_tiling -> coarse -> fine, each in a
`profiler.named_scope` span of its name (`STAGES`), which also stamps
the frame's stage clock where the caller set one (`profiler.stage_clock`,
`cuda/render.py::frame`); the image tap is a span of its own inside fine
(`NESTED`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..encoding.draw import DRAW_TAG_NOP
from ..profiler import named_scope

from . import clips, coarse, drawobjs, fine_ref, flatten, ops, tiling

# The stage spans of a frame, in order (`xtrace.attribute` reads them; the
# stage clock stamps at each one's entry and after the last).
STAGES = ("flatten", "draw_leaf", "clip_leaf", "tile_alloc", "path_count", "path_tiling",
          "coarse", "fine")
# The spans inside a stage that the stage clock stamps at their own entry
# and exit in a frame that runs them, as (stage, span) pairs: the image tap
# (`image_tap.image_tap`) inside the fine stage.
NESTED = (("fine", "image_tap"),)

# The layout's integer fields, in the order `pack_layout` packs them
# (`jello_tpu/pipeline/render.py:24-39`).
LAYOUT_INT_FIELDS = (
    "path_tag_base",
    "path_data_base",
    "draw_tag_base",
    "draw_data_base",
    "transform_base",
    "style_base",
    "n_path_tags",
    "n_paths",
    "n_draw_objects",
    "n_clips",
    "width_in_tiles",
    "height_in_tiles",
    "target_width",
    "target_height",
)


def pack_layout(ld: dict) -> np.ndarray:
    """The layout dict as one u32 array: the integer fields, then the base
    color's four f32 bit patterns (`jello_tpu/pipeline/render.py:42-53`),
    so that a frame's layout is one upload and data, not constants, of the
    frame that reads it."""
    out = np.zeros(len(LAYOUT_INT_FIELDS) + 4, dtype=np.uint32)
    for i, k in enumerate(LAYOUT_INT_FIELDS):
        out[i] = np.uint32(int(ld[k]))
    out[len(LAYOUT_INT_FIELDS):] = np.asarray(ld["base_color"], dtype=np.float32).view(np.uint32)
    return out


def unpack_layout(packed: torch.Tensor) -> dict:
    """A packed layout (`pack_layout`'s words as an int32 tensor) as the
    dict the stages read: each integer field a 0-dim int32 tensor, the base
    color a f32 [4]; all views of `packed`, so unpacking launches nothing
    (`jello_tpu/pipeline/render.py:56-63`)."""
    ld = {k: packed[i] for i, k in enumerate(LAYOUT_INT_FIELDS)}
    ld["base_color"] = packed[len(LAYOUT_INT_FIELDS):].view(torch.float32)
    return ld


# The command kinds (`coarse.CMD_*`) a frame counts, as bits: bit k is
# set where kind k is an image record, bit 8 + k where it is a gradient
# record (linear, radial, sweep). Shifted right by a record's kind and
# masked with 0x101, a word holds the record's image bit in its low byte
# and its gradient bit in the next (kind 0, no record, sets neither).
RECORD_BITS = (1 << coarse.CMD_IMAGE) | sum(
    1 << (8 + k) for k in (coarse.CMD_LIN_GRAD, coarse.CMD_RAD_GRAD, coarse.CMD_SWEEP_GRAD))


def draw_stages(scene, layout, fl, caps):
    """The stages between flatten and path_count, on flatten's per-path
    outputs (`path_bbox`, `path_draw_flags`, `path_trans_idx`): draw_leaf,
    clip_leaf, binning and tile_alloc. Returns (dm, info, tag, dtab,
    draw_bbox, paths)."""
    D = caps["n_draws_cap"]
    with named_scope("draw_leaf"):
        i = ops.iota(D, scene.device)
        tag = torch.where(i < layout["n_draw_objects"],
                          ops.gather_guarded(scene, layout["draw_tag_base"] + i),
                          DRAW_TAG_NOP)
        dm = drawobjs.draw_monoid_scan(tag)
        info, clip_idx_arr, clip_path_arr = drawobjs.draw_leaf(
            scene, layout, dm, fl["path_trans_idx"], fl["path_draw_flags"], caps, tag)
    with named_scope("clip_leaf"):
        clip_bboxes, dm_path, dm_scene = clips.clip_leaf_vectorized(
            clip_idx_arr, clip_path_arr, fl["path_bbox"], dm["path_idx"],
            dm["scene_offset"], layout, caps)
    dm = dict(dm, path_idx=dm_path, scene_offset=dm_scene)
    # Per-draw word table read by coarse and the record packing: scene
    # words dd+0..3 and info words 1..9.
    dd = layout["draw_data_base"] + dm_scene
    sc4 = ops.gather_guarded(scene, torch.cat([dd + k for k in range(4)])).reshape(4, D)
    dtab = torch.cat([sc4.t(), info[:, 1:10]], dim=1)

    with named_scope("tile_alloc"):
        draw_bbox = coarse.binning_bboxes(dm, fl["path_bbox"], clip_bboxes)
        paths = tiling.tile_alloc(draw_bbox, tag, layout, caps)
    return dm, info, tag, dtab, draw_bbox, paths


def geometry(scene, layout, caps):
    """Every stage before fine. Returns (stages dict with fl, dm, info,
    paths, counted, segs, cmds; flags; stats), flags and stats as 0-dim
    device tensors."""
    with named_scope("flatten"):
        fl = flatten.flatten_stage(scene, layout, caps)
    dm, info, tag, dtab, draw_bbox, paths = draw_stages(scene, layout, fl, caps)
    with named_scope("path_count"):
        counted = tiling.path_count(fl, paths, caps)
    with named_scope("path_tiling"):
        segs = tiling.path_tiling(fl, counted, caps)
    with named_scope("coarse"):
        cmds = coarse.build_commands(layout, dm, tag, dtab, draw_bbox, paths, counted,
                                     fl["path_draw_flags"], caps)
        cmds["dtab"] = dtab
        # Exact per-frame counters of the commands, read by
        # renderer.estimate.calibrate_caps: img_recs sizes the image-tap
        # table (the predicate of its compaction), legacy_tiles the
        # interpreter's grid (the classification fine_hybrid uses);
        # grad_recs, the gradient records, rides in the same reduction.
        # Inside the coarse span, where the stage clock counts them too.
        tile = cmds["tile"]
        kind = torch.where((tile < caps["tile_grid_cap"]) & (tile >= 0), cmds["kind"], 0)
        hits = (RECORD_BITS >> kind) & 0x101
        # The words' first two bytes (little-endian, on the card and the
        # host), summed as columns: both counts in one reduction.
        img_recs, grad_recs = hits.view(torch.uint8).view(-1, 4)[:, :2].sum(
            0, dtype=torch.int32).unbind()
        # A clip-free frame (`_coarse_dense`, routed on n_clips == 0) whose
        # images ride the tap has no legacy tile.
        if not caps.get("_coarse_dense") or not caps.get("_image_tap"):
            legacy_tiles = coarse.classify_legacy_tiles(cmds, caps)[0].sum()
        else:
            legacy_tiles = torch.zeros((), dtype=torch.int64, device=tile.device)
    flags = {
        "flatten_overflow": fl["overflow"],
        "tiles_overflow": paths["overflow"],
        "segs_overflow": counted["overflow"],
        "pairs_overflow": cmds["overflow"],
    }
    stats = {
        "legacy_tiles": legacy_tiles,
        "img_recs": img_recs,
        "grad_recs": grad_recs,
        # The layout's clip draw objects (a BeginClip and its EndClip
        # each), read back with the stats: a view, no device operation.
        "clips": layout["n_clips"],
        "work_a": fl["n_work_a"],
        "work_b": fl["n_work_b"],
        "euler_lines": fl["e_real"],
        "simple_lines": fl["s_total"],
        "arc_lines": fl["a_total"],
        "tiles": paths["n_tiles"],
        "segs": counted["real_cross"],
        "bd_rows": counted["real_bd_rows"],
        "cross_lines": counted["real_cross_lines"],
        "row_lines": counted["real_bd_lines"],
        "area_rows": counted["n_rows"],
        "pairs": cmds["pair_total"],
        "cmds": cmds["n_cmds"],
        "max_cmds": cmds["max_cmds"],
        "lockstep_iters": fl["lockstep_iters"],
    }
    stages = {"fl": fl, "dm": dm, "info": info, "paths": paths,
              "counted": counted, "segs": segs, "cmds": cmds}
    return stages, flags, stats


def render_frame(scene, layout, ramps, atlas, caps, fine_impl):
    """Render one frame.

    scene: int32 scene words on the device; layout: dict of 0-dim int32
    tensors (or host ints) and `base_color` (f32 [4] premultiplied), on the
    device (`unpack_layout`); ramps: f32
    [NR, W] stop table; atlas: f32 [4, AHp, AWp] premultiplied planar
    image atlas, or None; caps: capacity dict; fine_impl(cmds, counted,
    ramps, atlas, layout, caps) -> (fine_out, flags), or None for the
    reference fine stage (`fine_ref.fine`, dense [4, GRID, 256] output;
    its flags are `blend_depth_overflow` and `ref_walk_overflow`, and its
    stats, the walk's trip counts, join the frame's).
    Returns (fine_out, flags, stats)."""
    stages, flags, stats = geometry(scene, layout, caps)
    with named_scope("fine"):
        if fine_impl is None:
            fine_out, fine_flags, walk = fine_ref.fine(stages["cmds"], stages["segs"], ramps,
                                                       atlas, layout, caps)
            stats.update(walk)
        else:
            fine_out, fine_flags = fine_impl(stages["cmds"], stages["counted"], ramps, atlas,
                                             layout, caps)
    flags.update(fine_flags)
    return fine_out, flags, stats
