"""Clip stack resolution (reference: clip_reduce/clip_leaf).

Computes per-clip-element intersected bounding boxes and patches the
draw monoid of each EndClip with the matching BeginClip's path index and
scene offset. The reference uses a two-stage stack-monoid scheme for
GPU-parallel execution; clip counts are small, so here this is a
sequential scan with a bounded stack, identical in output.

Note: the reference's Go CPU port (cpu.go:440-448) takes a component-wise
`max` of the parent bbox — a transcription bug; the authoritative WGSL
(clip_leaf.wgsl:125,175) intersects (max of mins, min of maxes), which
is what we implement.
"""

from __future__ import annotations

from . import ops

BIG = 1e9
MAX_CLIP_DEPTH = 64


def clip_leaf(xp, clip_idx_arr, clip_path_idx_arr, path_bbox, dm_path, dm_scene, layout, caps):
    """Sequential clip stack walk.

    clip_idx_arr:      [NC] draw-object index per clip element
    clip_path_idx_arr: [NC] path idx (>=0: begin) or ~draw_idx (end)
    path_bbox:         [P, 4] f32
    dm_path/dm_scene:  [D] draw monoid columns (will be patched)
    Returns (clip_bboxes [NC,4], dm_path, dm_scene).
    """
    NC = caps["n_clips_cap"]
    f32 = xp.float32
    n_clips = layout["n_clips"]

    clip_bboxes = xp.zeros((NC, 4), dtype=f32)

    stack_parent = xp.zeros(MAX_CLIP_DEPTH, dtype=xp.int32)
    stack_path = xp.zeros(MAX_CLIP_DEPTH, dtype=xp.int32)
    stack_bbox = xp.zeros((MAX_CLIP_DEPTH, 4), dtype=f32)
    sp = xp.int32(0)

    init = (clip_bboxes, dm_path, dm_scene, stack_parent, stack_path, stack_bbox, sp)

    def body(i, state):
        clip_bboxes, dm_path, dm_scene, st_par, st_path, st_bbox, sp = state
        active = i < n_clips
        pidx = clip_path_idx_arr[i]
        is_begin = pidx >= 0

        # begin: intersect with stack top.
        pb = ops.gather_guarded(xp, path_bbox, xp.maximum(pidx, 0))
        topb = ops.gather_guarded(xp, st_bbox, xp.maximum(sp - 1, 0))
        inter = xp.stack(
            [
                xp.maximum(pb[0], topb[0]),
                xp.maximum(pb[1], topb[1]),
                xp.minimum(pb[2], topb[2]),
                xp.minimum(pb[3], topb[3]),
            ]
        )
        begin_bbox = xp.where(sp > 0, inter, pb)

        # end: pop; exposed bbox is the new top (or infinite).
        top2 = ops.gather_guarded(xp, st_bbox, xp.maximum(sp - 2, 0))
        endless = xp.asarray([-BIG, -BIG, BIG, BIG], dtype=f32)
        end_bbox = xp.where(sp >= 2, top2, endless)

        bbox = xp.where(is_begin, begin_bbox, end_bbox)
        clip_bboxes = ops.scatter_set(
            xp, clip_bboxes, xp.where(active, i, NC), bbox
        )

        # Patch end-clip draw monoid.
        tos_path = ops.gather_guarded(xp, st_path, xp.maximum(sp - 1, 0))
        tos_parent = ops.gather_guarded(xp, st_par, xp.maximum(sp - 1, 0))
        end_draw = clip_idx_arr[i]
        D = dm_path.shape[0]
        patch_tgt = xp.where(active & ~is_begin, end_draw, D)
        dm_path = ops.scatter_set(xp, dm_path, patch_tgt, tos_path.astype(dm_path.dtype))
        parent_scene = ops.gather_guarded(xp, dm_scene, xp.maximum(tos_parent, 0))
        dm_scene = ops.scatter_set(xp, dm_scene, patch_tgt, parent_scene)

        # Push / pop.
        push_tgt = xp.where(active & is_begin, xp.minimum(sp, MAX_CLIP_DEPTH - 1), MAX_CLIP_DEPTH)
        st_par = ops.scatter_set(xp, st_par, push_tgt, clip_idx_arr[i])
        st_path = ops.scatter_set(xp, st_path, push_tgt, xp.maximum(pidx, 0))
        st_bbox = ops.scatter_set(xp, st_bbox, push_tgt, bbox)
        sp = xp.where(
            active, xp.where(is_begin, sp + 1, xp.maximum(sp - 1, 0)), sp
        ).astype(xp.int32)
        return (clip_bboxes, dm_path, dm_scene, st_par, st_path, st_bbox, sp)

    # Trip count: the actual clip count (clamped to the cap). With no
    # clips the loop body never runs.
    trip = n_clips
    state = ops.fori(xp, trip, body, init)
    clip_bboxes, dm_path, dm_scene = state[0], state[1], state[2]
    return clip_bboxes, dm_path, dm_scene

