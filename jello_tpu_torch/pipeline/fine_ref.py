"""Reference fine stage, in plain torch.

Counterpart of `jello_tpu/pipeline/fine_ref.py` (`fine`, `_fill_area`,
`assemble_image`), the fine stage jello_tpu computes outside any Pallas
kernel: its renderer takes it for a frame whose image draw minifies past
the region windows of the fine kernels (`image_region_overflow`), and in
the MSAA modes it is the oracle of the coverage kernel. It has no kernel
here either, on any device.

Every tile's command tape is walked straight from the tile-sorted
command stream (no slab, so no `cmds_per_tile`), with the interpreter
program the kernels G and H implement (`fine_interp.walk_tapes`: paints
through `pipeline/paint.py`, the clip-zero suppression machine, the
blend stack through `blend_math`). What is its own:

  - coverage comes straight from the tile-ordered segments of
    `path_tiling`, `seg_count` of them from `seg_start`, per record and
    tile, in area mode or per sample (`fill_coverage`), not from the
    coverage stage's row table;
  - an image record taps the atlas wherever its taps fall: there is no
    region window, and so no `image_region_overflow`;
  - the walk is dense, as jello_tpu's is: every step on every tile of the
    grid (or stripe), masked by `(start + s) < end`, and every segment
    chunk on every fill of the step, masked by the fill's count.

Its trip counts: jello_tpu loops over them with `ops.fori` on a bound the
frame reads on the device (`jello_tpu/pipeline/fine_ref.py:157-158,
232-513`, a `lax.while_loop` under jit, `pipeline/ops.py:174-182`), the
tape slots of the longest tape and, in each slot, the segment chunks of
the longest fill. A CUDA graph cannot loop on a device value, so here the
two bounds are capacities of the class instead, `ref_slots_cap` and
`ref_chunks_cap` (powers of two, measured on the eager frame that
settles the class, `cuda/render.py`): the port's counterpart of the
dynamic bound, not a feature of its own. A frame that needs more raises
`ref_walk_overflow` (grown by `grow_caps`, and the frame renders again),
never a cut. Without them in caps the frame reads its bounds from the
device, as the eager frame does.

Its flags are `blend_depth_overflow` and `ref_walk_overflow`; its stats
`ref_slots` and `ref_chunks`, what the frame needed. The output is dense:
[4, GRID, 256] un-premultiplied, tile by tile, assembled by
`assemble_image`.
"""

from __future__ import annotations

import torch

from . import ops
from .coverage import area_contrib, msaa_contrib, sample_offsets
from .fine_interp import OVF_BLEND_DEPTH, build_records, walk_tapes
from .ops import F32, I32

# Segments per step of the coverage sum (`fine_seg_chunk` in caps).
SEG_CHUNK = 8
_SEG_KEYS = ("seg_x0", "seg_y0", "seg_x1", "seg_y1", "seg_y_edge")


def fill_coverage(seg_start, seg_count, backdrop, even_odd, segs, aa="area", chunk=SEG_CHUNK,
                  chunks=None):
    """Resolved coverage [m, 256] of m fills, each over the 256 pixels of
    its tile: seg_start, seg_count, backdrop [m] i32 and even_odd [m] bool
    per fill; segs a tuple of five f32 [NS] tensors (x0, y0, x1, y1,
    y_edge), tile-relative. Area mode sums the analytic winding and
    applies the rule; an MSAA mode sums the exact winding per sample,
    rounds, applies the rule per sample and takes the mean. `chunks`: the
    steps of `chunk` segments to take, at least `chunks_needed` (more add
    nothing); None reads that from the device."""
    m = seg_start.shape[0]
    dev = seg_start.device
    offsets = sample_offsets(aa)
    contribs = ([area_contrib] if offsets is None else
                [lambda *seg, o=o: msaa_contrib(*seg, *o) for o in offsets])
    acc = backdrop.to(F32)[:, None, None].repeat(1, len(contribs), 256)
    k = ops.iota(chunk, dev)[None, :]
    last = segs[0].shape[0] - 1
    if chunks is None:
        chunks = int(chunks_needed(seg_count, chunk)) if m else 0
    for c in range(0, chunks * chunk, chunk):
        valid = ((c + k) < seg_count[:, None])[:, :, None]
        gi = torch.clamp(seg_start[:, None] + c + k, 0, last).long().reshape(-1)
        seg = [f[gi] for f in segs]
        for si, contrib in enumerate(contribs):
            w = contrib(*seg).reshape(m, chunk, 256)
            acc[:, si] += torch.where(valid, w, torch.zeros((), dtype=F32, device=dev)).sum(1)
    if offsets is not None:
        wi = torch.round(acc).to(I32)
        inside = torch.where(even_odd[:, None, None], (wi & 1) != 0, wi != 0)
        return inside.to(F32).mean(1)
    a = acc[:, 0]
    eo = torch.abs(a - 2.0 * torch.round(0.5 * a))
    nz = torch.clamp(torch.abs(a), max=1.0)
    return torch.where(even_odd[:, None], eo, nz)


def chunks_needed(seg_count, chunk=SEG_CHUNK):
    """0-dim i32: the chunks of `chunk` segments the longest fill of
    seg_count [m] takes (0 for none)."""
    most = seg_count.amax() if seg_count.numel() else seg_count.new_zeros(())
    return torch.div(torch.clamp(most, min=0) + (chunk - 1), chunk, rounding_mode="floor")


def fine(cmds, segs, ramps, atlas, layout, caps, tile_base=0):
    """Walk every tile's tape of the command stream into the final tiles.

    cmds: the sorted command stream of `coarse.build_commands` (with
    `dtab`); segs: `path_tiling`'s tile-ordered segments; ramps [NR, W]
    the stop table; atlas f32 [4, AHp, AWp] premultiplied planar or None
    (the same texels jello_tpu's reference premultiplies per tap from its
    [AH, AW, 4] plane); caps: `blend_depth`, `aa_mode`, `fine_seg_chunk`,
    and the walk's bounds `ref_slots_cap` and `ref_chunks_cap` (both or
    neither; without them they are read from the device); tile_base: the
    global id of the first tile of `tile_start`/`tile_end`, nonzero when
    they hold one stripe of the grid (`jello_tpu/pipeline/fine_ref.py:
    194-212`, for `cuda/sharded.py`).
    Returns (fine_out [4, GRID, 256] un-premultiplied, flags
    {blend_depth_overflow, ref_walk_overflow}, stats {ref_slots: the
    longest tape, ref_chunks: the most segment chunks a fill of a step
    took}, each a 0-dim tensor)."""
    start = cmds["tile_start"]
    end = cmds["tile_end"]
    GRID = start.shape[0]
    dev = start.device
    # The records' paint words; coverage is not read through word 1 here.
    rec = build_records(dict(cmds, area_row=torch.zeros_like(cmds["kind"])), caps)
    last = rec.shape[0] - 1
    seg_f32 = tuple(segs[k].to(F32) for k in _SEG_KEYS)
    aa = caps.get("aa_mode", "area")
    chunk = caps.get("fine_seg_chunk", SEG_CHUNK)
    slots_cap, chunks_cap = caps.get("ref_slots_cap"), caps.get("ref_chunks_cap")
    slots = (end - start).amax() if GRID else torch.zeros((), dtype=I32, device=dev)
    need = [torch.zeros((), dtype=I32, device=dev)]  # the chunks of the steps walked

    def at(ci):
        return torch.clamp(start + ci, 0, last).long()

    def coverage(ci, rows, rec_rows, even_odd):
        pos = at(ci)
        count = torch.where(rows, cmds["seg_count"][pos], 0)
        step = chunks_needed(count, chunk)
        need[0] = torch.maximum(need[0], step.to(I32))
        return fill_coverage(cmds["seg_start"][pos], count, cmds["backdrop"][pos], even_odd,
                             seg_f32, aa, chunk, int(step) if chunks_cap is None else chunks_cap)

    out, ovf = walk_tapes(int(slots) if slots_cap is None else slots_cap,
                          lambda ci: (rec[at(ci)], (start + ci) < end), coverage,
                          ops.iota(GRID, dev) + tile_base, layout["base_color"], ramps,
                          atlas, layout["width_in_tiles"], caps["blend_depth"],
                          one_window=False, dense=True, clips=layout["n_clips"] > 0)
    walk_overflow = torch.zeros((), dtype=torch.bool, device=dev)
    if slots_cap is not None:
        walk_overflow = (slots > slots_cap) | (need[0] > chunks_cap)
    flags = {"blend_depth_overflow": ((ovf & OVF_BLEND_DEPTH) != 0).any(),
             "ref_walk_overflow": walk_overflow}
    return out.permute(1, 0, 2), flags, {"ref_slots": slots.to(I32), "ref_chunks": need[0]}


def assemble_image(fine_out, ld):
    """[4, GRID, 256] -> [H, W, 4], cropped to the target size."""
    wit = int(ld["width_in_tiles"])
    hit = int(ld["height_in_tiles"])
    g = fine_out[:, : wit * hit, :].reshape(4, hit, wit, 16, 16)
    img = g.permute(1, 3, 2, 4, 0).reshape(hit * 16, wit * 16, 4)
    return img[: int(ld["target_height"]), : int(ld["target_width"])]
