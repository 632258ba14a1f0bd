"""Per-tile interpreter wrapper (kernels G and H, `csrc/fine_interp.cu`).

Counterpart of the kernel calls `make_fine_kernel` and
`make_fine_kernel_b8` of `jello_tpu/tpu/fine_pallas.py` and of its
full-grid entry `fine_pallas`. `interpret_tiles` launches kernel G (one
tile a CTA), or kernel H with `batch` (eight tiles a CTA in lockstep),
for CUDA tensors, and takes their plain version,
`pipeline.fine_interp.interpret_plain`, only for CPU tensors; there is
no fallback from one to the other.
"""

from __future__ import annotations

import torch

from ..pipeline import fine_interp as plain
from ..pipeline.ops import F32, I32
from .build import check, check_tensor, kernels, stream_of

# A CTA's opt-in dynamic shared memory on sm_90.
SMEM_MAX = 227 * 1024
H_TILES = 8


def interpret_tiles(counts, tile_ids, base, slab, rows, stops, atlas, wit, blend_depth,
                    batch=False, resolved=False):
    """Walk each slot's command tape over its tile's 256 pixels.

    counts [n + 1] i32: the slots' tape lengths, then the width in tiles
    (the scalar-prefetch layout of the Pallas call); tile_ids [n] i32 (a
    pad slot has count 0 and any id; jello_tpu gives it the grid size);
    base [4] f32 premultiplied base color; slab [n, MC, 16] i32 records; rows
    [R, 256] f32 raw winding rows read at record word 1 (with `resolved`,
    an MSAA frame: rows of resolved coverage, taken as they are); stops [NR, W]
    f32; atlas [4, AHp, AWp] f32 premultiplied planar, or None for a
    frame without images (an image record then paints nothing);
    blend_depth: the blend stack's depth BD; batch: kernel H, which pads
    n to a multiple of 8 inside (count 0).
    Returns (out [n, 4, 256] f32 un-premultiplied, ovf [n] i32: bit 0 a
    push past BD, bit 1 an image record past the one region window)."""
    dev = slab.device
    n, MC, _ = slab.shape
    BD = int(blend_depth)
    NR, W = stops.shape
    check_tensor("counts", counts, I32, dev, (n + 1,))
    check_tensor("tile_ids", tile_ids, I32, dev, (n,))
    check_tensor("base", base, F32, dev, (4,))
    check_tensor("slab", slab, I32, dev, (n, MC, 16))
    check_tensor("rows", rows, F32, dev, (rows.shape[0], 256))
    check_tensor("stops", stops, F32, dev, (NR, W))
    AHp = AWp = 0
    if atlas is not None:
        if atlas.dim() != 3:
            raise ValueError(f"atlas: expected [4, AHp, AWp], got {tuple(atlas.shape)}")
        _, AHp, AWp = atlas.shape
        check_tensor("atlas", atlas, F32, dev, (4, AHp, AWp))
    if BD < 1:
        raise ValueError(f"blend_depth {BD} < 1")
    if dev.type == "cpu":
        return plain.interpret_plain(counts[:n], tile_ids, base, slab, rows, stops, atlas,
                                     int(wit), BD, resolved)
    if batch:
        pad = -n % H_TILES
        if pad:
            slab = torch.cat([slab, slab.new_zeros((pad, MC, 16))])
            tile_ids = torch.cat([tile_ids, tile_ids.new_zeros(pad)])
            counts = torch.cat([counts[:n], counts.new_zeros(pad), counts[n:]])
    n_run = tile_ids.shape[0]
    out = torch.empty((n_run, 4, 256), dtype=F32, device=dev)
    ovf = torch.empty(n_run, dtype=I32, device=dev)
    # G keeps a tile's blend stack in shared memory (4 KB a level) while it
    # fits a CTA; H's eight stacks, and a deeper G stack, live in a global
    # scratch of the same layout, each thread touching only its own pixel.
    scratch = None
    if batch or BD * 4096 > SMEM_MAX:
        scratch = torch.empty((n_run, BD, 4, 256), dtype=F32, device=dev)
    err = kernels().jello_fine_interp(
        counts.data_ptr(), tile_ids.data_ptr(), base.data_ptr(), slab.data_ptr(),
        rows.data_ptr(), stops.data_ptr(), None if atlas is None else atlas.data_ptr(),
        None if scratch is None else scratch.data_ptr(), out.data_ptr(), ovf.data_ptr(),
        n_run, MC, rows.shape[0], NR, W, int(wit), BD, AHp, AWp,
        1 if batch else 0, 1 if resolved else 0, stream_of(slab))
    check("jello_fine_interp", err)
    if batch:
        interpret_tiles.launches_batch += 1
    else:
        interpret_tiles.launches += 1
    return out[:n], ovf[:n]


# Launches of kernel G, and of kernel H.
interpret_tiles.launches = 0
interpret_tiles.launches_batch = 0


def fine_interp(cmds, counted, ramps, atlas, layout, caps):
    """The interpreter over the full tile grid (`tile_ids = arange(GRID)`):
    the counterpart of `fine_pallas.fine_pallas`, a whole fine stage that
    walks every tile's tape. The renderer routes only legacy tiles here
    (`fine_hybrid`); this entry holds the kernels alone to the oracle.
    Returns (fine_out [4, GRID, 256] un-premultiplied, flags)."""
    from .coverage import compute_area_rows

    GRID = caps["tile_grid_cap"]
    area, area_row_rec, rows_overflow = compute_area_rows(cmds, counted, caps)
    rec = plain.build_records(dict(cmds, area_row=area_row_rec), caps)
    slab, counts, slab_overflow = plain.build_cmd_slab(rec, cmds, caps)
    wit = layout["width_in_tiles"]
    counts = torch.cat([counts, counts.new_full((1,), int(wit))])
    tile_ids = torch.arange(GRID, dtype=I32, device=rec.device)
    out, ovf = interpret_tiles(counts, tile_ids, layout["base_color"], slab, area, ramps,
                               atlas, wit, caps["blend_depth"],
                               batch=bool(caps.get("_interp_batch")),
                               resolved=caps.get("aa_mode", "area") != "area")
    flags = {
        "cmd_slab_overflow": slab_overflow,
        "area_rows_overflow": rows_overflow,
        "blend_depth_overflow": ((ovf & plain.OVF_BLEND_DEPTH) != 0).any(),
        "image_region_overflow": ((ovf & plain.OVF_IMAGE_REGION) != 0).any(),
    }
    return out.permute(1, 0, 2), flags
