"""The per-tile command interpreter in plain torch, and its command slab.

Counterpart of `jello_tpu/tpu/fine_pallas.py`: `build_cmd_slab`, and the
plain version of the interpreter kernels G (`make_fine_kernel`, one tile
a program) and H (`make_fine_kernel_b8`, eight tiles a program in
lockstep), which `csrc/fine_interp.cu` implements on the GPU.

A program walks one tile's tape of at most `cmds_per_tile` 16-word
records (layout in `cuda/fine_v2.py`) over a premultiplied [4, 256] pixel
state that starts at the base color:

  - a fill, gradient or image record reads its coverage row (word 1,
    rowless when word 2 is 0), resolves it by the record's fill rule
    (with `resolved`, an MSAA frame, the row is resolved already and is
    only clipped to [0, 1]) and paints src-over;
  - a BeginClip pushes the state on the blend stack and clears it; one
    whose word 2 is negative covers nothing, and suppresses every record
    up to its EndClip instead;
  - an EndClip resolves its clip path's row by the nonzero rule, pops,
    and blends state * coverage * alpha over the popped background with
    `blend_math.blend_mix_compose` under the record's blend word.

`area`, the resolved coverage, carries over from record to record: a
BeginClip does not set it and a suppressed record leaves it. It starts
at 0.

`walk_tapes` is that program: it steps all tapes together, one pass over
the record index with [n, 4, 256] state (H's lockstep shape over the
whole grid), so that thousands of tiles cost `cmds_per_tile` steps and
not one Python loop each. Each step works on the tapes that hold a given
record kind. `interpret_plain` runs it on a slab with coverage from a row
table. G and H are one function of their inputs, so this is the plain
version of both. The reference fine stage (`pipeline/fine_ref.py`) runs
the same program on the command stream itself, with coverage summed from
the segments, and walks it densely: each step on every tape, masked, as
jello_tpu's reference does (`jello_tpu/pipeline/fine_ref.py:232-513`).
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
    CMD_RAD_GRAD,
    CMD_SWEEP_GRAD,
)
from .coverage import resolved_coverage
from .image_tap import REGH, REGW, bilinear_taps, region_extent, tap_geometry
from .ops import F32, I32
from .paint import gradient_fg

# Bits of a slot's overflow word. The interpreter's image contract is one
# REGH x REGW window of the padded atlas per image record
# (`fine_pallas.py:191,429-439`), not the image tap's, which sweeps up to
# MAX_WIN such windows.
OVF_BLEND_DEPTH = 1
OVF_IMAGE_REGION = 2


def build_records(cmds, caps):
    """Pack the sorted command stream into dense 16-word records [PC, 16]
    (int32 bit patterns), tile order preserved. With `_image_tap` in caps
    word 14 of an image record is its rank among the image records in
    stream order (the predicate of `pipeline.image_tap.image_tap`'s
    compaction)."""
    kind = cmds["kind"]
    drow = ops.gather_guarded(cmds["dtab"], cmds["draw"])

    def sc_u(off):
        return drow[:, off]

    def info_u(off):
        return drow[:, 3 + off]

    z = torch.zeros_like(kind)
    is_color = kind == CMD_COLOR
    is_lin = kind == CMD_LIN_GRAD
    is_rad = kind == CMD_RAD_GRAD
    is_sweep = kind == CMD_SWEEP_GRAD
    is_img = kind == CMD_IMAGE
    is_end = kind == CMD_END_CLIP
    is_grad = is_lin | is_rad | is_sweep
    is_xf = is_rad | is_sweep | is_img
    lin_xf = is_lin | is_xf

    index_mode = sc_u(0)
    w = [None] * 16
    w[0] = kind
    w[1] = cmds["area_row"]
    w[2] = cmds["seg_count"]
    w[3] = cmds["tile"]
    w[4] = cmds["flags"]
    w[5] = torch.where(is_color | is_end, index_mode,
                       torch.where(is_grad, index_mode & 3, z))
    x6 = torch.where(is_color, sc_u(1), z)
    x6 = torch.where(lin_xf, info_u(1), x6)
    w[6] = torch.where(is_end, sc_u(1), x6)
    w[7] = torch.where(is_end, cmds["backdrop"],
                       torch.where(is_color, sc_u(2), torch.where(lin_xf, info_u(2), z)))
    w[8] = torch.where(is_color, sc_u(3), torch.where(lin_xf, info_u(3), z))
    for k in (9, 10, 11):
        w[k] = torch.where(is_xf, info_u(k - 5), z)
    w[12] = torch.where(is_xf, info_u(7), z)
    w[13] = torch.where(is_xf, info_u(8), z)
    w[14] = torch.where(is_rad, info_u(9), z)
    if caps.get("_image_tap"):
        tile = cmds["tile"]
        P = is_img & (tile < caps["tile_grid_cap"]) & (tile >= 0)
        w[14] = torch.where(P, torch.cumsum(P.to(I32), 0, dtype=I32) - 1, w[14])
    w[15] = torch.where(is_grad, ops.shr(index_mode, 2), z)
    return torch.stack([v.to(I32) for v in w], dim=1)


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


def _image_fg(rec, tile, atlas, wit, one_window=True):
    """Premultiplied image paint of image records [m, 16] on tiles [m]:
    (fg [m, 4, 256] with the in-bounds mask folded in; bad [m] bool). With
    `one_window`, the interpreter kernels' contract, a record whose taps
    leave its one region window paints zero and is bad
    (`fine_pallas.py:429-439`); without it no record is."""
    _, AHp, AWp = atlas.shape
    tap = rec.clone()
    tap[:, 3] = tile
    g = tap_geometry(tap, wit, 1 << 30)
    bad = torch.zeros(rec.shape[0], dtype=torch.bool, device=rec.device)
    if one_window:
        rx1, ry1, x_lo, y_lo = region_extent(g, AHp, AWp)
        bad = ((rx1 - x_lo) >= REGW) | ((ry1 - y_lo) >= REGH)
    okf = (g["inb"] & ~bad[:, None]).to(F32)
    return (bilinear_taps(g, atlas) * okf).permute(1, 0, 2), bad


def walk_tapes(n_steps, fetch, coverage, tile_ids, base, stops, atlas, wit, blend_depth,
               one_window=True, dense=False, clips=True):
    """Step n tapes together, record index by record index: the command
    interpreter itself, shared by `interpret_plain` (tapes in a slab,
    coverage from a row table) and `pipeline.fine_ref.fine` (tapes in the
    command stream, coverage from the segments).

    fetch(ci) -> (rec [n, 16] i32, active [n] bool): each tape's record at
    step ci, and whether the tape has one. coverage(ci, rows, rec, even_odd)
    -> [m, 256] f32: the resolved coverage of the records `rec` [m, 16]
    (even_odd [m] bool; an EndClip comes with False) of the tapes `rows`
    that have segments. tile_ids [n] i32; base [4] f32 premultiplied; stops
    [NR, W] f32; atlas [4, AHp, AWp] f32 premultiplied planar or None; wit
    the width in tiles; blend_depth the stack depth BD; one_window: the
    interpreter kernels' image region contract (`_image_fg`).

    Each step's operation runs on the tapes that hold its record kind,
    gathered by index (`torch.nonzero`; `rows` an index vector, m of
    them), or with `dense` on every tape, its result kept where the kind is
    held (`rows` a bool mask [n], m = n): the same values either way, but a
    dense walk has shapes that the step count alone fixes and reads nothing
    back to the host, so a CUDA graph can hold it. `clips` False says that
    no tape holds a BeginClip or an EndClip (a frame without clip layers):
    the blend stack's pushes and pops, which would touch no tape, are left
    out.
    Returns (out [n, 4, 256] f32 un-premultiplied, ovf [n] i32: bit 0 a
    push past BD, bit 1 an image record past the region window)."""
    n = tile_ids.shape[0]
    dev = tile_ids.device
    BD = int(blend_depth)
    rgba = base.to(F32)[None, :, None].repeat(n, 1, 256)
    area = torch.zeros((n, 256), dtype=F32, device=dev)
    stack = torch.zeros((n, BD, 4, 256), dtype=F32, device=dev)
    clip_depth = torch.zeros(n, dtype=I32, device=dev)
    blend_d = torch.zeros(n, dtype=I32, device=dev)
    zero_depth = torch.zeros(n, dtype=I32, device=dev)
    ovf = torch.zeros(n, dtype=I32, device=dev)
    tile_ids = tile_ids.to(I32)
    every = ops.iota(n, dev).long()
    zero = torch.zeros((), dtype=F32, device=dev)

    def rows(mask):
        """The tapes an operation runs on: the mask itself when dense, else
        the indices where it holds (None when it holds nowhere)."""
        if dense:
            return mask
        idx = torch.nonzero(mask)[:, 0]
        return idx if idx.numel() else None

    def pick(t, r):
        return t if dense else t[r]

    def merge(r, new, old):
        """new on the tapes `r`, old elsewhere (dense; compact: new)."""
        return torch.where(r.view((-1,) + (1,) * (new.dim() - 1)), new, old) if dense else new

    def put(t, r, v):
        if dense:
            t.copy_(merge(r, v, t))
        else:
            t[r] = v

    def slot(r):
        """(tape indices, blend-stack slot) of the tapes `r`, to index `stack`."""
        at = every if dense else r
        return at, torch.clamp(blend_d[at], 0, BD - 1).long()

    def over(r, fg, cov):
        """src-over of fg [m, 4, 256] with coverage cov [m, 256]."""
        cur = pick(rgba, r)
        put(rgba, r, cur * (1.0 - fg[:, 3] * cov)[:, None] + fg * cov[:, None])

    for ci in range(n_steps):
        rec, active = fetch(ci)
        fr = rec.view(F32)
        kind = torch.where(active, rec[:, 0], -1)
        seg_raw = rec[:, 2]
        sup = zero_depth > 0
        is_begin = kind == CMD_BEGIN_CLIP
        is_end = kind == CMD_END_CLIP
        paints = ~sup & (kind >= CMD_COLOR) & (kind <= CMD_IMAGE)
        fillish = paints | (~sup & is_end)

        # Coverage: a record with segments resolves its own (an EndClip
        # always by the nonzero rule), a rowless one covers fully.
        r = rows(fillish & (seg_raw > 0))
        if r is not None:
            rr = pick(rec, r)
            use_eo = ((rr[:, 4] & 1) != 0) & (pick(kind, r) != CMD_END_CLIP)
            put(area, r, coverage(ci, r, rr, use_eo))
        area.masked_fill_((fillish & (seg_raw <= 0))[:, None], 1.0)

        r = rows(paints & (kind == CMD_COLOR))
        if r is not None:
            over(r, pick(fr, r)[:, 5:9, None].expand(-1, -1, 256), pick(area, r))
        r = rows(paints & (kind >= CMD_LIN_GRAD) & (kind <= CMD_SWEEP_GRAD))
        if r is not None:
            fg = gradient_fg(pick(rec, r), stops, pick(tile_ids, r)[:, None], wit)
            over(r, torch.stack(fg, dim=1), pick(area, r))
        r = rows(paints & (kind == CMD_IMAGE)) if atlas is not None else None
        if r is not None:
            fg, bad = _image_fg(pick(rec, r), pick(tile_ids, r), atlas, wit, one_window)
            over(r, fg, pick(area, r))
            put(ovf, r, pick(ovf, r) | bad.to(I32) * OVF_IMAGE_REGION)

        # Clips: suppression state first, from the depth before the record.
        begin_zero = is_begin & (seg_raw < 0)
        unsuppress = sup & is_end & (clip_depth == zero_depth)
        zero_depth = torch.where(unsuppress, 0, zero_depth)
        zero_depth = torch.where(~sup & begin_zero, clip_depth + 1, zero_depth)
        clip_depth = clip_depth + is_begin.to(I32) - is_end.to(I32)

        do_push = ~sup & is_begin & ~begin_zero
        ovf |= (do_push & (blend_d >= BD)).to(I32) * OVF_BLEND_DEPTH
        r = rows(do_push) if clips else None
        if r is not None:
            at, s = slot(r)
            stack[at, s] = merge(r, rgba, stack[at, s]) if dense else rgba[r]
            put(rgba, r, zero.expand(pick(rgba, r).shape))
        blend_d = blend_d + do_push.to(I32)

        do_pop = ~sup & is_end
        blend_d = blend_d - do_pop.to(I32)
        r = rows(do_pop) if clips else None
        if r is not None:
            at, s = slot(r)
            bg = stack[at, s]
            a_cov = pick(area, r) * pick(fr, r)[:, 6:7]
            src = pick(rgba, r) * a_cov[:, None]
            out = blend_math.blend_mix_compose(
                tuple(bg[:, c] for c in range(4)), tuple(src[:, c] for c in range(4)),
                pick(rec, r)[:, 5:6])
            put(rgba, r, torch.stack(out, dim=1))

    a_inv = rdiv(1.0, torch.clamp(rgba[:, 3:4], min=1e-6))
    return torch.cat([rgba[:, :3] * a_inv, rgba[:, 3:4]], dim=1), ovf


def with_width(counts, wit):
    """The slots' tape lengths [n] i32 with the width in tiles (a 0-dim
    int32 tensor, the layout's word) appended, as kernels G and H take
    them: [n + 1] i32, on the device."""
    return torch.cat([counts.to(I32), wit.to(I32).reshape(1)])


def interpret_plain(counts, tile_ids, base, slab, rows, stops, atlas, blend_depth,
                    resolved=False):
    """Plain version of kernels G and H (same inputs and outputs as
    `cuda.fine_interp.interpret_tiles`).

    counts [n + 1] i32: the tape lengths, then the width in tiles;
    tile_ids [n] i32; base [4] f32
    premultiplied; slab [n, MC, 16] i32;
    rows [R, 256] f32 raw winding rows (resolved coverage rows with
    `resolved`), indexed by record word 1; stops
    [NR, W] f32; atlas [4, AHp, AWp] f32 premultiplied planar or None;
    blend_depth the stack depth BD.
    Returns (out [n, 4, 256] f32 un-premultiplied, ovf [n] i32: bit 0 a
    push past BD, bit 1 an image record past the region window)."""
    n, MC, _ = slab.shape
    wit = counts[n]
    counts = torch.clamp(counts[:n].to(I32), max=MC)
    n_rows = rows.shape[0]

    def coverage(ci, idx, rec, even_odd):
        a = rows[torch.clamp(rec[:, 1], 0, n_rows - 1).long()]
        if resolved:
            return resolved_coverage(a)
        eo = torch.abs(a - 2.0 * torch.round(0.5 * a))
        nz = torch.clamp(torch.abs(a), max=1.0)
        return torch.where(even_odd[:, None], eo, nz)

    return walk_tapes(int(counts.max()) if n else 0,
                      lambda ci: (slab[:, ci], ci < counts), coverage, tile_ids, base, stops,
                      atlas, wit, blend_depth)
