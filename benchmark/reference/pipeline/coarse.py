"""Binning + coarse command-list generation.

(reference: shaders/cpu/cpu.go Binning/Coarse, binning.wgsl, coarse.wgsl)

The reference bins draw objects into 256x256-px bins with atomic chunk
lists, then a per-bin workgroup serializes each tile's PTCL command
tape. Here the same result is produced by a flat expansion of
(draw -> covered tiles) pairs, a vectorized include/exclude filter
(coarse.wgsl:295-320 semantics) and one stable sort by tile id, which
preserves draw order within each tile. Commands are a fixed-width SoA
(no jump chaining, no bump allocation); the clip-zero suppression state
machine (coarse.wgsl:406-462) moves into the fine stage, which walks
each tile's commands sequentially anyway.

Divergence from the reference (documented): the reference tests
`blend != (Clip<<8 | 3)` to detect non-trivial blends, but jello swapped
the Compose enum's zero value so a pure clip encodes as 0x8000 and the
test is always true (every clip is treated as an isolated blend group —
slower, same pixels). We use the corrected test
`blend != 0x8000 || alpha != 1.0`, which matches upstream Vello's
intent; pixels are identical, work is smaller. We also read the clip
path's actual fill-rule flags where the reference reads an uninitialized
info word for BeginClip (coarse.wgsl reads info[di] with di pointing
past the clip's zero-size info slot).
"""

from __future__ import annotations

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
from .tiling import TILE_SCALE, _expand

BIG = 1e9

CMD_COLOR = 1
CMD_LIN_GRAD = 2
CMD_RAD_GRAD = 3
CMD_SWEEP_GRAD = 4
CMD_IMAGE = 5
CMD_BEGIN_CLIP = 6
CMD_END_CLIP = 7

# Packed blend word of a pure (non-isolated) clip: (Mix.CLIP << 8) | SRC_OVER.
BLEND_PURE_CLIP = 0x8000


def binning_bboxes(xp, dm, path_bbox, clip_bboxes, layout):
    """Intersected draw bboxes (reference: Binning, cpu.go:343-365)."""
    f32 = xp.float32
    clip_idx = dm["clip_idx"].astype(xp.int32)
    has_clip = clip_idx > 0
    cb = ops.gather_guarded(xp, clip_bboxes, xp.maximum(clip_idx - 1, 0))
    inf = xp.asarray([-BIG, -BIG, BIG, BIG], dtype=f32)
    cb = xp.where(has_clip[:, None], cb, inf[None, :])
    pb = ops.gather_guarded(xp, path_bbox, dm["path_idx"].astype(xp.int32))
    return xp.stack(
        [
            xp.maximum(cb[:, 0], pb[:, 0]),
            xp.maximum(cb[:, 1], pb[:, 1]),
            xp.minimum(cb[:, 2], pb[:, 2]),
            xp.minimum(cb[:, 3], pb[:, 3]),
        ],
        axis=1,
    )


def build_commands(
    xp, scene, layout, dm, tag, dtab, draw_bbox, paths, counted, path_draw_flags, caps
):
    """Produce the per-tile command SoA, sorted by (tile, draw order).

    dtab: the per-draw word table built in render_frame (columns
    scene[dd+0..3] with PATCHED dd + info words 1..9) — blend/alpha
    read from its columns instead of two more scene gathers.
    """
    D = caps["n_draws_cap"]
    PC = caps["pair_cap"]
    GRID = caps["tile_grid_cap"]
    f32 = xp.float32
    wit = layout["width_in_tiles"]
    hit = layout["height_in_tiles"]

    act = (xp.arange(D, dtype=xp.int32) < layout["n_draw_objects"]) & (
        tag != DRAW_TAG_NOP
    )
    nonempty = (draw_bbox[:, 0] < draw_bbox[:, 2]) & (draw_bbox[:, 1] < draw_bbox[:, 3])
    ok = act & nonempty
    rx0 = xp.where(ok, xp.floor(draw_bbox[:, 0] * TILE_SCALE), 0.0).astype(xp.int32)
    ry0 = xp.where(ok, xp.floor(draw_bbox[:, 1] * TILE_SCALE), 0.0).astype(xp.int32)
    rx1 = xp.where(ok, xp.ceil(draw_bbox[:, 2] * TILE_SCALE), 0.0).astype(xp.int32)
    ry1 = xp.where(ok, xp.ceil(draw_bbox[:, 3] * TILE_SCALE), 0.0).astype(xp.int32)
    rx0 = xp.clip(rx0, 0, wit)
    ry0 = xp.clip(ry0, 0, hit)
    rx1 = xp.clip(rx1, 0, wit)
    ry1 = xp.clip(ry1, 0, hit)
    # Constrain to the owning path's allocated tile rect (equal for all
    # reachable cases; see module doc of tiling.py). One [P, 5] row
    # gather for the five per-path fields.
    pp = dm["path_idx"].astype(xp.int32)
    ptab_p = xp.stack(
        [paths["rect_x0"], paths["rect_y0"], paths["rect_x1"],
         paths["rect_y1"], paths["tile_offset"],
         path_draw_flags.astype(xp.int32)],
        axis=1,
    )
    prow_p = ops.gather_guarded(xp, ptab_p, pp)
    prx0, pry0 = prow_p[:, 0], prow_p[:, 1]
    prx1, pry1 = prow_p[:, 2], prow_p[:, 3]
    p_tile_off = prow_p[:, 4]
    p_flags = prow_p[:, 5]
    rx0 = xp.maximum(rx0, prx0)
    ry0 = xp.maximum(ry0, pry0)
    rx1 = xp.minimum(rx1, prx1)
    ry1 = xp.minimum(ry1, pry1)
    w = xp.maximum(rx1 - rx0, 0)
    h = xp.maximum(ry1 - ry0, 0)
    n_pairs = w * h

    # Draw-level paint/blend classification: kind, clip/blend tests and
    # the scene blend/alpha words are all per-DRAW, so they gather at D
    # (16k rows) and ride the pair expansion in the row table — not as
    # per-pair element gathers over pair_cap rows (2 x ~300k-row random
    # gathers measured ~6 ms at config5).
    is_begin_d = tag == DRAW_TAG_BEGIN_CLIP
    is_end_d = tag == DRAW_TAG_END_CLIP
    is_clip_d = is_begin_d | is_end_d
    blend_d = dtab[:, 0]
    alpha_d = ops.bitcast_u32_f32(xp, dtab[:, 1])
    is_blend_d = is_clip_d & ~((blend_d == BLEND_PURE_CLIP) & (alpha_d == 1.0))
    # Groups whose composite is AFFINE in the background: mix NORMAL or
    # CLIP with compose SRC_OVER (blend word & 0x7FFF == 0 — exactly
    # blend_math.blend_mix_compose's fast path), any group alpha. These
    # ride the record-stream kernel's group scan (covc scaled by
    # alpha); only true mix/compose blends need the interpreter.
    legacy_blend_d = is_clip_d & (
        (blend_d & xp.uint32(0x7FFF)) != xp.uint32(0)
    )
    kind_d = xp.where(
        tag == DRAW_TAG_COLOR,
        CMD_COLOR,
        xp.where(
            tag == DRAW_TAG_LINEAR_GRADIENT,
            CMD_LIN_GRAD,
            xp.where(
                tag == DRAW_TAG_RADIAL_GRADIENT,
                CMD_RAD_GRAD,
                xp.where(
                    tag == DRAW_TAG_SWEEP_GRADIENT,
                    CMD_SWEEP_GRAD,
                    xp.where(
                        tag == DRAW_TAG_IMAGE,
                        CMD_IMAGE,
                        xp.where(
                            is_begin_d,
                            CMD_BEGIN_CLIP,
                            xp.where(is_end_d, CMD_END_CLIP, 0),
                        ),
                    ),
                ),
            ),
        ),
    ).astype(xp.int32)

    # Pack the per-draw fields consumed by the pair expansion into one
    # s32 row table: a single row gather per pair instead of ~12 element
    # gathers (u32 columns ride bit-identically through the s32 view).
    # The draw-data/info words themselves are NOT expanded per pair —
    # fine reads them through cmds["dtab"] rows by draw index.
    etab = xp.stack(
        [
            w,
            rx0,
            ry0,
            pp,
            prx0,
            pry0,
            xp.maximum(prx1 - prx0, 1),
            p_tile_off,
            kind_d,
            p_flags,
            is_blend_d.astype(xp.int32),
            legacy_blend_d.astype(xp.int32),
        ],
        axis=1,
    )

    # Dense (clip-free) coarse: without EndClips every draw owns its
    # own slot rect, so the (draw, tile) pair enumeration IS the slot
    # space in the same order — the pair expansion collapses to
    # tile_alloc's per-slot metadata and the per-pair lookups of
    # seg_count/seg_start/backdrop become the arrays themselves
    # (identity, no ~300k-row gather). The reference-spirit analog of
    # resolveSolidPathsOnly (resolve.go:231-283): specialize the
    # common case, keep the general path for clips. ~12 ms of the
    # coarse stage on the config5 trace.
    dense = bool(caps.get("_coarse_dense")) and PC == caps["tiles_cap"]
    if dense:
        rec = paths["tile_draw"]
        valid = paths["tile_valid"]
        pair_total = paths["n_tiles"]
        drow = ops.gather_guarded(xp, etab, rec)
        tx = paths["tile_tx"]
        ty = paths["tile_ty"]
        tile_global = ty * wit + tx
        tile_slot = xp.arange(PC, dtype=xp.int32)
        seg_count = counted["seg_count"]
        seg_start = counted["seg_start"]
        backdrop = counted["backdrop"]
    else:
        rec, within, valid, _, pair_total = _expand(xp, n_pairs, PC)
        drow = ops.gather_guarded(xp, etab, rec)
        stride = xp.maximum(drow[:, 0], 1)
        tx = drow[:, 1] + within % stride
        ty = drow[:, 2] + within // stride
        tile_global = ty * wit + tx

        # Tile slot within the owning path's rect.
        p_x0 = drow[:, 4]
        p_y0 = drow[:, 5]
        pstride = drow[:, 6]
        tile_slot = drow[:, 7] + (ty - p_y0) * pstride + (tx - p_x0)
        ctab = xp.stack(
            [
                counted["seg_count"],
                counted["seg_start"],
                counted["backdrop"],
            ],
            axis=1,
        )
        crow = ops.gather_guarded(xp, ctab, tile_slot)
        seg_count = crow[:, 0]
        seg_start = crow[:, 1]
        backdrop = crow[:, 2]

    kind = drow[:, 8]
    is_begin = kind == CMD_BEGIN_CLIP
    is_end = kind == CMD_END_CLIP
    is_clip = is_begin | is_end
    is_blend = drow[:, 10] != 0
    legacy_blend = drow[:, 11] != 0

    # Flag word layout (payload bit budget): bit0 = even-odd fill rule;
    # bit3 = non-affine blend (mix/compose beyond NORMAL/CLIP x
    # SRC_OVER) — consumed by the legacy-tile classification
    # (classify_legacy_tiles); src-over groups with alpha != 1 stay on
    # the record-stream kernel (covc x alpha). Bits 1/4/5/8+ are packed
    # later by the hybrid fine pass.
    flags = xp.where(is_end, 0, drow[:, 9]).astype(xp.uint32)
    flags = flags | (legacy_blend.astype(xp.uint32) << 3)
    even_odd = (flags & 1) != 0
    backdrop_clear = xp.where(
        even_odd, (xp.abs(backdrop) & 1) == 0, backdrop == 0
    )
    include = (seg_count != 0) | (backdrop_clear == is_clip) | is_blend
    include = include & valid
    begin_zero = is_begin & (seg_count == 0) & (backdrop == 0)

    sort_key = xp.where(include, tile_global, GRID).astype(xp.int32)
    n_cmds_true = xp.sum(include.astype(xp.int32))
    # Payload rides the compare-exchange network (one multi-operand
    # lax.sort) — cheaper than argsort + a permutation row gather.
    (st_, k_, ss_, sc_, bd_, ts_, fl_, dr_) = ops.sort_multi(
        xp,
        sort_key,
        (
            kind,
            seg_start,
            xp.where(begin_zero, -1, seg_count),
            backdrop,
            tile_slot,
            flags.astype(xp.int32),
            rec,
        ),
    )
    # Live-prefix slice: excluded records sort to the tail (key GRID),
    # so everything past the calibrated command count is dead weight —
    # and every downstream per-record cost (coverage ranks, record
    # packing, the fine chunks) scales with this length. cmd_cap is
    # measured n_cmds + margin (renderer/estimate.calibrate_caps); the
    # pre-calibration class leaves it at pair_cap (no slicing).
    CC = min(caps.get("cmd_cap", PC), PC)
    if CC < PC:
        (st_, k_, ss_, sc_, bd_, ts_, fl_, dr_) = (
            a[:CC] for a in (st_, k_, ss_, sc_, bd_, ts_, fl_, dr_)
        )
    cmds = {
        "tile": st_,
        "kind": k_,
        "seg_start": ss_,
        "seg_count": sc_,
        "backdrop": bd_,
        # The record's (path, tile) slot; coverage-row ranks are derived
        # from it post-sort (coverage.rank_records).
        "tile_slot": ts_,
        "flags": fl_.astype(xp.uint32),
        "draw": dr_,
    }
    # Per-tile command ranges from run boundaries (unique scatters).
    st = cmds["tile"]
    PCn = st.shape[0]
    i_ids = xp.arange(PCn, dtype=xp.int32)
    prev = xp.concatenate([xp.full(1, -1, st.dtype), st[:-1]])
    nxt = xp.concatenate([st[1:], xp.full(1, GRID + 1, st.dtype)])
    first = (st != prev) & (st < GRID)
    last = (st != nxt) & (st < GRID)
    tile_start = ops.scatter_set(
        xp, xp.zeros(GRID, dtype=xp.int32),
        xp.where(first, st, GRID), i_ids)
    tile_end = ops.scatter_set(
        xp, xp.zeros(GRID, dtype=xp.int32),
        xp.where(last, st, GRID), i_ids + 1)
    cmds["tile_start"] = tile_start
    cmds["tile_end"] = tile_end
    cmds["n_cmds"] = n_cmds_true
    cmds["pair_total"] = pair_total
    cmds["max_cmds"] = xp.max(tile_end - tile_start)
    cmds["overflow"] = (pair_total > PC) | (n_cmds_true > CC)
    return cmds


def classify_legacy_tiles(xp, cmds, caps):
    """Mark tiles that need the per-tile interpreter kernel.

    A tile is "legacy" iff its command tape contains anything the
    record-stream fine kernel's affine formulation cannot express:
      - an image paint (texture taps) — unless the image-tap kernel is
        on (caps["_image_tap"], tpu/image_tap.py), which feeds fine_v2
        premultiplied per-record fg rows so image paints compose in the
        affine scan like any fill,
      - a non-AFFINE blend group (flags bit 3, packed by
        build_commands: mix/compose beyond NORMAL/CLIP x SRC_OVER;
        src-over groups with alpha != 1 are affine in the background
        and stay on the record-stream kernel, covc scaled by alpha),
      - a NESTED clip (within-tile clip depth >= 2).
    Depth-1 pure clips stay on the record-stream kernel: the group is
    itself an affine map of the background (A' = 1 - cov_c*(1 - A_g),
    B' = cov_c*B_g), evaluated by a first segmented scan over group
    extents (tpu/fine_v2.py). The reference interprets every tile
    uniformly (fine.wgsl:814); this split keeps the scalar tape walk
    off the hot path entirely for clip-only content.

    Returns (lt_flag [GRID] i32 0/1, d_excl [PC] i32 within-tile clip
    depth before each record, is_begin/is_end [PC] bool).
    """
    GRID = caps["tile_grid_cap"]
    tile = cmds["tile"].astype(xp.int32)
    kind = cmds["kind"]
    in_grid = tile < GRID
    is_begin = kind == CMD_BEGIN_CLIP
    is_end = kind == CMD_END_CLIP
    is_img = kind == CMD_IMAGE
    is_blend = ((cmds["flags"] >> 3) & 1) != 0

    # Within-tile clip depth before each record: global exclusive
    # cumsum of (begin - end), rebased at the tile's first record.
    delta = is_begin.astype(xp.int32) - is_end.astype(xp.int32)
    g = ops.exclusive_cumsum(xp, delta)
    start_of_tile = ops.gather_guarded(
        xp, cmds["tile_start"], xp.clip(tile, 0, GRID - 1)
    )
    g0 = ops.gather_guarded(xp, g, start_of_tile)
    d_excl = xp.where(in_grid, g - g0, 0)

    nested = is_begin & (d_excl >= 1)
    bad = nested | (is_blend & (is_begin | is_end))
    if not caps.get("_image_tap"):
        bad = bad | is_img
    bad = bad & in_grid
    lt = ops.scatter_max(
        xp,
        xp.zeros(GRID + 1, dtype=xp.int32),
        xp.where(in_grid, tile, GRID),
        bad.astype(xp.int32),
    )
    return lt[:GRID], d_excl, is_begin, is_end
