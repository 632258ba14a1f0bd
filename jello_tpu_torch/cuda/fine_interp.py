"""Per-tile interpreter wrapper (kernels G and H, `csrc/fine_interp.cu`).

Counterpart of the kernel calls `make_fine_kernel` and
`make_fine_kernel_b8` of `jello_tpu/tpu/fine_pallas.py` and of its
full-grid entry `fine_pallas`. `interpret_tiles` launches kernel G (one
tile a CTA), or kernel H with `batch` (eight tiles a CTA, a warp group
each that walks its own tape), for CUDA tensors, and takes their plain
version, `pipeline.fine_interp.interpret_plain`, only for CPU tensors;
there is no fallback from one to the other.
"""

from __future__ import annotations

import functools

import torch

from ..pipeline import fine_interp as plain
from ..pipeline.ops import F32, I32
from .build import check, check_tensor, kernels, stream_of

H_TILES = 8


def interpret_tiles(counts, tile_ids, base, slab, rows, stops, atlas, blend_depth,
                    batch=False, resolved=False):
    """Walk each slot's command tape over its tile's 256 pixels.

    counts [n + 1] i32: the slots' tape lengths, then the width in tiles
    (the scalar-prefetch layout of the Pallas call, `counts_smem`: the
    kernels read it on the device); tile_ids [n] i32 (a
    pad slot has count 0 and any id; jello_tpu gives it the grid size);
    base [4] f32 premultiplied base color; slab [n, MC, 16] i32 records; rows
    [R, 256] f32 raw winding rows read at record word 1 (with `resolved`,
    an MSAA frame: rows of resolved coverage, taken as they are); stops [NR, W]
    f32; atlas [4, AHp, AWp] f32 premultiplied planar, or None for a
    frame without images (an image record then paints nothing);
    blend_depth: the blend stack's depth BD; batch: kernel H, which pads
    n to a multiple of 8 inside (count 0). On the card slab and rows
    must start 16-byte aligned (the kernel reads them as 16-byte vectors).
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
        return plain.interpret_plain(counts, tile_ids, base, slab, rows, stops, atlas, BD,
                                     resolved)
    slab_ptr, rows_ptr = slab.data_ptr(), rows.data_ptr()
    if slab_ptr % 16 or rows_ptr % 16:
        raise ValueError("slab and rows must start 16-byte aligned")
    if batch:
        pad = -n % H_TILES
        if pad:
            slab = torch.cat([slab, slab.new_zeros((pad, MC, 16))])
            tile_ids = torch.cat([tile_ids, tile_ids.new_zeros(pad)])
            counts = torch.cat([counts[:n], counts.new_zeros(pad), counts[n:]])
            slab_ptr = slab.data_ptr()
    n_run = tile_ids.shape[0]
    # out and ovf in one allocation; the stack scratch (H's, or G's levels
    # past its shared memory) in a second where there is one.
    buf = torch.empty(n_run * 1025, dtype=F32, device=dev)
    out = buf[:n_run * 1024].view(n_run, 4, 256)
    ovf = buf[n_run * 1024:].view(I32)
    shape = scratch_shape(n_run, BD, batch, dev.index)
    scratch = None if shape is None else torch.empty(shape, dtype=F32, device=dev)
    err = kernels().jello_fine_interp(
        counts.data_ptr(), tile_ids.data_ptr(), base.data_ptr(), slab_ptr, rows_ptr,
        stops.data_ptr(), None if atlas is None else atlas.data_ptr(),
        None if scratch is None else scratch.data_ptr(), buf.data_ptr(),
        buf.data_ptr() + 4 * n_run * 1024, n_run, MC, rows.shape[0], NR, W, BD, AHp, AWp,
        1 if batch else 0, 1 if resolved else 0, stream_of(slab))
    check("jello_fine_interp", err)
    if batch:
        interpret_tiles.launches_batch += 1
        return out[:n], ovf[:n]
    interpret_tiles.launches += 1
    return out, ovf


# Launches of kernel G, and of kernel H.
interpret_tiles.launches = 0
interpret_tiles.launches_batch = 0


@functools.lru_cache(maxsize=64)
def scratch_shape(n, blend_depth, batch, device_index=None):
    """The stack scratch the entry takes for n slots at this blend depth,
    as a shape of floats, or None: H's levels past its shared ones for
    every slot; G's levels past its shared memory for as many tiles as the
    card holds at once (none when BD levels fit shared memory). A query of
    the current device (`device_index` names it for the cache), made once
    for each argument tuple."""
    floats = kernels().jello_fine_interp_scratch(int(n), int(blend_depth), 1 if batch else 0)
    if floats < 0:
        raise RuntimeError("jello_fine_interp_scratch: CUDA error or a scratch past 2**31 floats")
    return (floats,) if floats else None


def resident_ctas(batch, blend_depth):
    """CTAs of kernel G (or H, with `batch`) resident on one
    multiprocessor of the current device at this blend depth (a query,
    no launch)."""
    n = kernels().jello_fine_interp_ctas(1 if batch else 0, int(blend_depth))
    if n < 0:
        raise RuntimeError("jello_fine_interp_ctas: CUDA error")
    return n


# Kernel H's builds: (warps a slot, CTAs a multiprocessor it is built for).
H_BUILDS = ((1, 1), (1, 4), (2, 1), (2, 2), (4, 1))


def h_variant(warps, min_ctas, levels):
    """Kernel H at any point of its design space (a build of H_BUILDS,
    stack levels a slot in shared memory), for measuring the points
    against each other; the renderer's H is `interpret_tiles(...,
    batch=True)` at the shipped point (`h_query(2)`, `(3)`, `(4)`).
    Returns call(counts, tile_ids, base, slab, rows, stops, atlas, BD,
    resolved, out, ovf, scratch) on CUDA tensors: n (slab's slots) a
    multiple of 8, counts [n + 1] (the width in tiles last), out [n, 4,
    256] f32, ovf [n] i32, scratch `h_query(0,
    n, BD, levels=levels)` floats or None where that is 0."""
    lib = kernels()

    def call(counts, tile_ids, base, slab, rows, stops, atlas, BD, resolved, out, ovf,
             scratch):
        n, MC, _ = slab.shape
        NR, W = stops.shape
        AHp, AWp = (0, 0) if atlas is None else atlas.shape[1:]
        err = lib.jello_fine_interp_h(
            counts.data_ptr(), tile_ids.data_ptr(), base.data_ptr(), slab.data_ptr(),
            rows.data_ptr(), stops.data_ptr(), None if atlas is None else atlas.data_ptr(),
            None if scratch is None else scratch.data_ptr(), out.data_ptr(), ovf.data_ptr(), n,
            MC, rows.shape[0], NR, W, int(BD), AHp, AWp, 1 if resolved else 0,
            int(warps), int(min_ctas), int(levels), stream_of(slab))
        check("jello_fine_interp_h", err)

    return call


def h_query(which, n=0, blend_depth=1, warps=1, min_ctas=1, levels=0):
    """Kernel H's design space (`jello_fine_interp_h_query`): which 0, the
    scratch floats of n slots at (blend_depth, levels); 1, the CTAs of the
    build (warps, min_ctas) resident a multiprocessor at (levels,
    blend_depth); 2, 3 and 4, the shipped warps, min_ctas and levels."""
    v = kernels().jello_fine_interp_h_query(which, int(n), int(blend_depth), int(warps),
                                            int(min_ctas), int(levels))
    if v < 0:
        raise RuntimeError("jello_fine_interp_h_query: CUDA error or past 2**31 floats")
    return v


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
    counts = plain.with_width(counts, layout["width_in_tiles"])
    tile_ids = torch.arange(GRID, dtype=I32, device=rec.device)
    out, ovf = interpret_tiles(counts, tile_ids, layout["base_color"], slab, area, ramps,
                               atlas, caps["blend_depth"],
                               batch=bool(caps.get("_interp_batch")),
                               resolved=caps.get("aa_mode", "area") != "area")
    flags = {
        "cmd_slab_overflow": slab_overflow,
        "area_rows_overflow": rows_overflow,
        "blend_depth_overflow": ((ovf & plain.OVF_BLEND_DEPTH) != 0).any(),
        "image_region_overflow": ((ovf & plain.OVF_IMAGE_REGION) != 0).any(),
    }
    return out.permute(1, 0, 2), flags
