"""The per-tile command interpreter in plain torch, and its command slab.

Counterpart of `jello_tpu/tpu/fine_pallas.py`: `build_cmd_slab`, and the
plain version of the interpreter kernels G (`make_fine_kernel`, one tile
a program) and H (`make_fine_kernel_b8`, eight tiles a program in
lockstep), which `csrc/fine_interp.cu` implements on the GPU.

A program walks one tile's tape of at most `cmds_per_tile` 16-word
records (layout in `cuda/fine_v2.py`) over a premultiplied [4, 256] pixel
state that starts at the base color:

  - a fill, gradient or image record reads its coverage row (word 1,
    rowless when word 2 is 0), resolves it by the record's fill rule and
    paints src-over;
  - a BeginClip pushes the state on the blend stack and clears it; one
    whose word 2 is negative covers nothing, and suppresses every record
    up to its EndClip instead;
  - an EndClip resolves its clip path's row by the nonzero rule, pops,
    and blends state * coverage * alpha over the popped background with
    `blend_math.blend_mix_compose` under the record's blend word.

`area`, the resolved coverage, carries over from record to record: a
BeginClip does not set it and a suppressed record leaves it. It starts
at 0.

`interpret_plain` steps all programs together, one pass over the record
index with [n, 4, 256] state (H's lockstep shape over the whole grid), so
that thousands of tiles cost `cmds_per_tile` steps and not one Python
loop each. Each step works on the programs that hold a given record
kind. G and H are one function of their inputs, so this is the plain
version of both.
"""

from __future__ import annotations

import torch

from .. import blend_math
from ..pmath import rdiv
from . import ops
from .coarse import (
    CMD_BEGIN_CLIP,
    CMD_COLOR,
    CMD_END_CLIP,
    CMD_IMAGE,
    CMD_LIN_GRAD,
    CMD_SWEEP_GRAD,
)
from .image_tap import REGH, REGW, bilinear_taps, region_extent, tap_geometry
from .ops import F32, I32
from .paint import gradient_fg

# Bits of a slot's overflow word. The interpreter's image contract is one
# REGH x REGW window of the padded atlas per image record
# (`fine_pallas.py:191,429-439`), not the image tap's, which sweeps up to
# MAX_WIN such windows.
OVF_BLEND_DEPTH = 1
OVF_IMAGE_REGION = 2


def build_cmd_slab(rec, cmds, caps):
    """Scatter the packed records [PC, 16] into the full-grid slab
    [GRID, MC, 16] (slot = tile * MC + index within the tile's run).
    Returns (slab, counts [GRID] i32 clipped to MC, overflow 0-dim bool)."""
    GRID = caps["tile_grid_cap"]
    MC = caps["cmds_per_tile"]
    tile = cmds["tile"]
    j = ops.iota(tile.shape[0], tile.device)
    tc = torch.clamp(tile, 0, GRID - 1)
    within = j - ops.gather_guarded(cmds["tile_start"], tc)
    ok = (tile < GRID) & (within < MC)
    slot = torch.where(ok, tc * MC + within, GRID * MC)
    slab = ops.scatter_set(torch.zeros((GRID * MC, 16), dtype=I32, device=rec.device),
                           slot, rec).reshape(GRID, MC, 16)
    n = cmds["tile_end"] - cmds["tile_start"]
    return slab, torch.clamp(n, 0, MC).to(I32), (n > MC).any()


def _image_fg(rec, tile, atlas, wit):
    """Premultiplied image paint of image records [m, 16] on tiles [m]:
    (fg [m, 4, 256] with the in-bounds mask folded in, zero for a record
    whose taps leave its one region window, `fine_pallas.py:429-439`; bad
    [m] bool)."""
    _, AHp, AWp = atlas.shape
    tap = rec.clone()
    tap[:, 3] = tile
    g = tap_geometry(tap, wit, 1 << 30)
    rx1, ry1, x_lo, y_lo = region_extent(g, AHp, AWp)
    bad = ((rx1 - x_lo) >= REGW) | ((ry1 - y_lo) >= REGH)
    okf = (g["inb"] & ~bad[:, None]).to(F32)
    return (bilinear_taps(g, atlas) * okf).permute(1, 0, 2), bad


def interpret_plain(counts, tile_ids, base, slab, rows, stops, atlas, wit, blend_depth):
    """Plain version of kernels G and H (same inputs and outputs as
    `cuda.fine_interp.interpret_tiles`).

    counts [n] i32 tape lengths; tile_ids [n] i32; base [4] f32
    premultiplied; slab [n, MC, 16] i32;
    rows [R, 256] f32 raw winding rows, indexed by record word 1; stops
    [NR, W] f32; atlas [4, AHp, AWp] f32 premultiplied planar or None;
    wit the width in tiles; blend_depth the stack depth BD.
    Returns (out [n, 4, 256] f32 un-premultiplied, ovf [n] i32: bit 0 a
    push past BD, bit 1 an image record past the region window)."""
    dev = slab.device
    n, MC, _ = slab.shape
    BD = int(blend_depth)
    rgba = base.to(F32)[None, :, None].repeat(n, 1, 256)
    area = torch.zeros((n, 256), dtype=F32, device=dev)
    stack = torch.zeros((n, BD, 4, 256), dtype=F32, device=dev)
    clip_depth = torch.zeros(n, dtype=I32, device=dev)
    blend_d = torch.zeros(n, dtype=I32, device=dev)
    zero_depth = torch.zeros(n, dtype=I32, device=dev)
    ovf = torch.zeros(n, dtype=I32, device=dev)
    counts = torch.clamp(counts.to(I32), max=MC)
    tile_ids = tile_ids.to(I32)
    n_rows = rows.shape[0]

    def over(idx, fg, cov):
        """src-over of fg [m, 4, 256] with coverage cov [m, 256]."""
        cur = rgba[idx]
        rgba[idx] = cur * (1.0 - fg[:, 3] * cov)[:, None] + fg * cov[:, None]

    n_steps = int(counts.max()) if n else 0
    for ci in range(n_steps):
        rec = slab[:, ci]
        fr = rec.view(F32)
        kind = torch.where(ci < counts, rec[:, 0], -1)
        seg_raw = rec[:, 2]
        sup = zero_depth > 0
        is_begin = kind == CMD_BEGIN_CLIP
        is_end = kind == CMD_END_CLIP
        paints = ~sup & (kind >= CMD_COLOR) & (kind <= CMD_IMAGE)
        fillish = paints | (~sup & is_end)

        # Coverage: a record with segments resolves its row (an EndClip
        # always by the nonzero rule), a rowless one covers fully.
        idx = torch.nonzero(fillish & (seg_raw > 0))[:, 0]
        if idx.numel():
            a = rows[torch.clamp(rec[idx, 1], 0, n_rows - 1).long()]
            eo = torch.abs(a - 2.0 * torch.round(0.5 * a))
            nz = torch.clamp(torch.abs(a), max=1.0)
            use_eo = ((rec[idx, 4] & 1) != 0) & (kind[idx] != CMD_END_CLIP)
            area[idx] = torch.where(use_eo[:, None], eo, nz)
        area[fillish & (seg_raw <= 0)] = 1.0

        idx = torch.nonzero(paints & (kind == CMD_COLOR))[:, 0]
        if idx.numel():
            over(idx, fr[idx, 5:9, None].expand(-1, -1, 256), area[idx])
        idx = torch.nonzero(paints & (kind >= CMD_LIN_GRAD) & (kind <= CMD_SWEEP_GRAD))[:, 0]
        if idx.numel():
            fg = gradient_fg(rec[idx], stops, tile_ids[idx, None], wit)
            over(idx, torch.stack(fg, dim=1), area[idx])
        idx = torch.nonzero(paints & (kind == CMD_IMAGE))[:, 0]
        if idx.numel() and atlas is not None:
            fg, bad = _image_fg(rec[idx], tile_ids[idx], atlas, wit)
            over(idx, fg, area[idx])
            ovf[idx] |= bad.to(I32) * OVF_IMAGE_REGION

        # Clips: suppression state first, from the depth before the record.
        begin_zero = is_begin & (seg_raw < 0)
        unsuppress = sup & is_end & (clip_depth == zero_depth)
        zero_depth = torch.where(unsuppress, 0, zero_depth)
        zero_depth = torch.where(~sup & begin_zero, clip_depth + 1, zero_depth)
        clip_depth = clip_depth + is_begin.to(I32) - is_end.to(I32)

        do_push = ~sup & is_begin & ~begin_zero
        ovf |= (do_push & (blend_d >= BD)).to(I32) * OVF_BLEND_DEPTH
        idx = torch.nonzero(do_push)[:, 0]
        if idx.numel():
            stack[idx, torch.clamp(blend_d[idx], 0, BD - 1).long()] = rgba[idx]
            rgba[idx] = 0.0
        blend_d = blend_d + do_push.to(I32)

        do_pop = ~sup & is_end
        blend_d = blend_d - do_pop.to(I32)
        idx = torch.nonzero(do_pop)[:, 0]
        if idx.numel():
            bg = stack[idx, torch.clamp(blend_d[idx], 0, BD - 1).long()]
            a_cov = area[idx] * fr[idx, 6:7]
            src = rgba[idx] * a_cov[:, None]
            out = blend_math.blend_mix_compose(
                tuple(bg[:, c] for c in range(4)), tuple(src[:, c] for c in range(4)),
                rec[idx, 5:6])
            rgba[idx] = torch.stack(out, dim=1)

    a_inv = rdiv(1.0, torch.clamp(rgba[:, 3:4], min=1e-6))
    return torch.cat([rgba[:, :3] * a_inv, rgba[:, 3:4]], dim=1), ovf
