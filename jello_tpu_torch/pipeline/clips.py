"""Clip stack resolution, in torch.

Counterpart of `jello_tpu/pipeline/clips.py::clip_leaf_vectorized`: the
intersected bounding box of every clip element, and each EndClip's draw
monoid patched with its BeginClip's path index and scene offset (so an
EndClip reads its group's blend word and alpha, and shares its
BeginClip's tile slots).

The stack walk is expressed per depth level. The active begin of level L
at a stream position is the most recent begin with that level (a
cummax), and the stack-top bbox is the running intersection of the
active begins' path bboxes over levels 0..L. One loop over depth levels,
vectorized over all clip elements, replaces the sequential walk; its
trip count is `clip_depth_cap`, the scene's deepest nesting rounded up to
a power of two when the renderer supplies it, else MAX_CLIP_DEPTH (a
level past the deepest begin matches none and changes nothing). The
clip count is device data (`i < n_clips` masks, as `jello_tpu`'s
`clips.py:119-122`); a clip-free frame's routing (`_coarse_dense`) skips
the walk.
"""

from __future__ import annotations

import torch

from . import ops
from .ops import I32

BIG = 1e9
MAX_CLIP_DEPTH = 64


def clip_leaf_vectorized(clip_idx_arr, clip_path_idx_arr, path_bbox, dm_path, dm_scene,
                         layout, caps):
    """clip_idx_arr, clip_path_idx_arr [NC] i32 from `draw_leaf`; path_bbox
    [P, 4] f32; dm_path, dm_scene [D] i32 draw monoid columns.
    Returns (clip_bboxes [NC, 4] f32, dm_path, dm_scene patched)."""
    NC = caps["n_clips_cap"]
    depth_cap = caps.get("clip_depth_cap", MAX_CLIP_DEPTH)
    dev = path_bbox.device
    out_bbox = ops.unbounded_bboxes(NC, dev, BIG)
    if caps.get("_coarse_dense"):
        # The routing of a clip-free frame (n_clips == 0): no clip to walk.
        return out_bbox, dm_path, dm_scene

    i_idx = ops.iota(NC, dev)
    active = i_idx < layout["n_clips"]
    is_begin = active & (clip_path_idx_arr >= 0)
    is_end = active & ~is_begin
    delta = is_begin.to(I32) - is_end.to(I32)
    depth_before = ops.exclusive_cumsum(delta)
    # Begins occupy level depth_before; ends close level depth_before - 1.
    level = torch.where(is_begin, depth_before, depth_before - 1)

    running = out_bbox
    match_begin = torch.full((NC,), -1, dtype=I32, device=dev)
    for lv in range(depth_cap):
        at_l = is_begin & (level == lv)
        last_begin = ops.cummax(torch.where(at_l, i_idx, -1))
        lb_path = ops.gather_guarded(clip_path_idx_arr, torch.clamp(last_begin, min=0))
        pb = ops.gather_guarded(path_bbox, torch.clamp(lb_path, min=0))
        inter = torch.cat([torch.maximum(running[:, :2], pb[:, :2]),
                           torch.minimum(running[:, 2:], pb[:, 2:])], dim=1)
        running = torch.where((last_begin >= 0)[:, None], inter, running)
        # Begins at this level read the running intersection including
        # themselves; ends one level up read the same value, the stack
        # below them. Ends at level 0 keep the infinite box.
        sel = at_l | (is_end & (level == lv + 1))
        out_bbox = torch.where(sel[:, None], running, out_bbox)
        match_begin = torch.where(is_end & (level == lv), last_begin, match_begin)

    # Patch each matched EndClip's monoid with its begin's path and scene.
    mb = torch.clamp(match_begin, min=0)
    mb_path = ops.gather_guarded(clip_path_idx_arr, mb)
    begin_draw = ops.gather_guarded(clip_idx_arr, mb)
    tgt = torch.where(is_end & (match_begin >= 0), clip_idx_arr, dm_path.shape[0])
    parent_scene = ops.gather_guarded(dm_scene, begin_draw)
    both = ops.scatter_set(torch.stack([dm_path, dm_scene], dim=1), tgt,
                           torch.stack([mb_path, parent_scene], dim=1))
    return out_bbox, both[:, 0], both[:, 1]
