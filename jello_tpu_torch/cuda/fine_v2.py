"""Record-stream fine stage (kernel B, `csrc/fine_v2.cu`).

Counterparts in `jello_tpu`:
  - `tpu/fine_pallas.py::build_records`: the 16-word record packing
    (`pipeline/fine_interp.py::build_records`, plain torch, layout below);
  - `tpu/fine_v2.py::fine_v2`, standalone call (clip-free; with the
    image-tap stage inside when the frame has an atlas): coverage,
    records, image foregrounds, compositing; `cuda/fine_hybrid.py` calls
    `composite_records` on a frame with clip layers;
  - `tpu/fine_v2.py::assemble_compact`: tiles -> image.

Painter's-order src-over compositing, v' = v (1 - fa cov) + fg cov, is
an affine map of the running pixel color. `composite_records` launches
kernel B for CUDA tensors (one CTA per tile walks the tile's records in
order) and takes `composite_records_plain` only for CPU tensors: a
vectorized Hillis-Steele segmented scan of the (A, B) affine pairs over
the whole record stream, segments keyed on the tile column.

A depth-1 clip group whose blend is src-over (any alpha) is itself an
affine map of the background, so it stays here: the group's records are
composed first over transparent black into (A_g, B_g), and its EndClip
applies v' = (1 - covc (1 - A_g)) v + covc B_g with covc the clip path's
coverage times the group alpha (`tpu/fine_v2.py:192-214,401-460`).
Record flags (word 4): bit 0 even-odd, bit 1 a record of a legacy tile
(the identity; the interpreter renders that tile), bit 3 a non-affine
blend, bit 4 a group's BeginClip and members, bit 5 its EndClip, bits
8+ the group id (a record outside a group has an id of its own).

Coverage rows arrive as raw winding in area mode, and the record's fill
rule resolves them here; under MSAA kernel A has resolved them per
sample, and `resolved` makes B take them as they are, clipped to [0, 1]
(`tpu/fine_v2.py:182-183,204-205`).

Output contract: compact [PC, 4, 256] f32, every record's
un-premultiplied inclusive composite at its own index, and tile2rank
[GRID] i32, each tile's last record index or -1, from coarse's per-tile
run boundaries. (No chunking here, so PCpad = PC.) Rows of records
outside every tile's run (tile >= GRID) are left unwritten by the
kernel: assembly reads only tile2rank rows.
The table grows with the record cap, not the tile grid: 4 KB per
record.

Record layout (int32-carried u32 words):
  0 kind  1 area_row (-1 rowless)  2 seg_count  3 tile  4 flags
  color:  5..8 rgba f32 bits (premultiplied)
  lin:    5 extend, 6..8 line_x/y/c, 15 ramp row
  rad:    5 extend, 6..11 xform, 12 focal_x, 13 radius, 14 kind|flags<<3,
          15 ramp row
  sweep:  5 extend, 6..11 xform, 12 t0, 13 t1, 15 ramp row
  image:  6..11 xform, 12 atlas placement, 13 packed size, 14 image rank
          in stream order (the fg table row), with `_image_tap` in caps
  end_clip: 5 blend word, 6 alpha f32 bits, 7 tile backdrop
"""

from __future__ import annotations

import numpy as np
import torch

from ..pipeline import ops
from ..pipeline.coarse import (
    CMD_COLOR,
    CMD_IMAGE,
    CMD_LIN_GRAD,
    CMD_RAD_GRAD,
    CMD_SWEEP_GRAD,
)
from ..pipeline.coverage import resolved_coverage
from ..pipeline.fine_interp import build_records
from ..pipeline.image_tap import image_tap
from ..pipeline.ops import F32, I32
from ..pipeline.paint import gradient_fg
from ..pmath import rdiv
from .build import check, check_tensor, host_to_device, kernels, stream_of
from .coverage import compute_area_rows


def tile_last_record(tile_start, tile_end):
    """tile2rank: each tile's last record index, -1 for an empty tile."""
    return torch.where(tile_end > tile_start, tile_end - 1, -1).to(I32)


def composite_records_plain(rec, cov, stops, base, tile_start, tile_end, wit, fg_tab=None,
                            resolved=False):
    """Plain version of kernel B (same inputs and output as
    `composite_records`). The scan is keyed on the records' tile column;
    tile_start/tile_end only bound which tiles are in range."""
    PC = rec.shape[0]
    n_tiles = tile_start.shape[0]
    kind = rec[:, 0:1]
    tile = rec[:, 3]
    flags = rec[:, 4:5]
    fr = rec.view(F32)
    valid = ((tile >= 0) & (tile < n_tiles))[:, None]
    is_color = kind == CMD_COLOR
    is_lin = kind == CMD_LIN_GRAD
    is_rad = kind == CMD_RAD_GRAD
    is_grad = is_lin | is_rad | (kind == CMD_SWEEP_GRAD)
    is_img = (kind == CMD_IMAGE) if fg_tab is not None else torch.zeros_like(is_color)
    live = valid & (is_color | is_grad | is_img) & ((flags & 2) == 0)

    a = cov[:PC]
    if resolved:
        c = nz = resolved_coverage(a)
    else:
        eo = torch.abs(a - 2.0 * torch.round(0.5 * a))
        nz = torch.clamp(torch.abs(a), max=1.0)
        c = torch.where((flags & 1) != 0, eo, nz)
    c = torch.where(rec[:, 1:2] >= 0, c, torch.ones_like(c))
    c = c * live.to(F32)

    gfg = gradient_fg(rec, stops, rec[:, 3:4], wit)
    zero = torch.zeros((), dtype=F32, device=rec.device)
    # Records that paint nothing are the identity, whatever their words.
    fg = [torch.where(live, torch.where(is_color, fr[:, 5 + ch:6 + ch], gfg[ch]), zero)
          for ch in range(4)]
    if fg_tab is not None:
        # Image paints: the record's row of the image-tap table; a rank
        # past the table paints nothing.
        rank = rec[:, 14]
        rows = torch.where(((rank >= 0) & (rank < fg_tab.shape[0]))[:, None],
                           ops.gather_guarded(fg_tab, rank), zero)
        fg = [torch.where(live & is_img, rows[:, 256 * ch:256 * (ch + 1)], fg[ch])
              for ch in range(4)]

    # (A, B) affine pairs of the records.
    A = 1.0 - fg[3] * c
    B = torch.stack([f * c for f in fg], dim=1)  # [PC, 4, 256]

    def scan(A, B, key):
        """Hillis-Steele inclusive scan of the affine pairs within runs of
        equal keys (runs are contiguous, so the first distance with no
        equal pair ends it)."""
        k = 1
        while k < PC:
            same = (key[k:] == key[:-k])[:, None]
            if not bool(same.any()):
                break
            B = torch.cat([B[:k], B[k:] + torch.where(same[:, None], A[k:, None] * B[:-k],
                                                       zero)])
            A = torch.cat([A[:k], torch.where(same, A[k:] * A[:-k], A[k:])])
            k *= 2
        return A, B

    # Pass 1, clip groups: a group's records (flag bit 4 its BeginClip and
    # members, bit 5 its EndClip) share the id in bits 8+, so the scan's
    # value at the EndClip is the group's composite (A_g, B_g) over
    # transparent black. Every other record is a run of its own.
    ident2 = (flags & 16) != 0
    end_t = (flags & 32) != 0
    if bool((ident2 | end_t).any()):
        seg = ops.shr(rec[:, 4], 8).long()
        key = torch.where((ident2 | end_t)[:, 0], 2 * seg,
                          2 * torch.arange(PC, device=rec.device) + 1)
        A, B = scan(A, B, key)
        # The EndClip composes the group over the background as
        # (1 - covc (1 - A_g), covc B_g), covc its clip row by the nonzero
        # rule (a resolved row as it is), or, rowless, full when its tile
        # backdrop (word 7) is not 0, times the group alpha; Begin and
        # members become the identity.
        covc = torch.where(rec[:, 1:2] >= 0, nz,
                           torch.clamp(torch.abs(rec[:, 7:8].to(F32)), max=1.0)) * fr[:, 6:7]
        A = torch.where(end_t, 1.0 - covc * (1.0 - A), A)
        A = torch.where(ident2, torch.ones_like(A), A)
        B = torch.where(end_t[:, None], covc[:, None] * B, B)
        B = torch.where(ident2[:, None], zero, B)
    # Pass 2: compositing within tiles.
    A, B = scan(A, B, tile)
    v = B + A[:, None] * base.to(F32)[None, :, None]
    inv_a = rdiv(1.0, torch.clamp(v[:, 3], min=1e-6))
    return torch.cat([v[:, :3] * inv_a[:, None], v[:, 3:]], dim=1)


def composite_records(rec, cov, stops, base, tile_start, tile_end, wit, fg_tab=None,
                      resolved=False):
    """Kernel B for CUDA tensors, its plain version for CPU tensors.

    rec [PC, 16] i32 tile-sorted records; cov [>= PC, 256] f32
    per-record coverage, raw winding, or with `resolved` the resolved
    coverage of an MSAA frame; stops [NR, W] f32, W = 1 + 5 * stops; base [4] f32
    premultiplied base color; tile_start/tile_end [GRID] i32, each
    tile's run [start, end) of records (coarse's run boundaries); wit []
    i32, the width in tiles (the layout's word: the kernel reads it on the
    device, as the Pallas kernel takes it by scalar prefetch); fg_tab
    [IRC, 1024] f32 or None, the image-tap table read by image records
    (without it an image record is the identity).
    Returns compact [PC, 4, 256] f32."""
    dev = rec.device
    PC = rec.shape[0]
    NR, W = stops.shape
    grid = tile_start.shape[0]
    check_tensor("rec", rec, I32, dev, (PC, 16))
    check_tensor("cov", cov, F32, dev, (max(cov.shape[0], PC), 256))
    check_tensor("stops", stops, F32, dev, (NR, W))
    check_tensor("base", base, F32, dev, (4,))
    check_tensor("tile_start", tile_start, I32, dev, (grid,))
    check_tensor("tile_end", tile_end, I32, dev, (grid,))
    check_tensor("wit", wit, I32, dev, ())
    n_fg = 0 if fg_tab is None else fg_tab.shape[0]
    if fg_tab is not None:
        check_tensor("fg_tab", fg_tab, F32, dev, (n_fg, 1024))
    if dev.type == "cpu":
        return composite_records_plain(rec, cov, stops, base, tile_start, tile_end, wit,
                                       fg_tab, resolved)
    out = torch.empty((PC, 4, 256), dtype=F32, device=dev)
    err = kernels().jello_fine_v2(
        rec.data_ptr(), cov.data_ptr(), stops.data_ptr(), tile_start.data_ptr(),
        tile_end.data_ptr(), base.data_ptr(),
        None if fg_tab is None else fg_tab.data_ptr(), out.data_ptr(), wit.data_ptr(), grid,
        NR, W, n_fg, 1 if resolved else 0, stream_of(rec))
    check("jello_fine_v2", err)
    composite_records.launches += 1
    return out


composite_records.launches = 0


def fine_v2(cmds, counted, ramps, atlas, layout, caps):
    """The fine stage of a clip-free frame, in the antialiasing mode of
    `caps["aa_mode"]`. With `_image_tap` in
    caps and an atlas (f32 [4, AHp, AWp], `pipeline.image_tap.atlas_planar`)
    the image-tap stage runs here and image records paint from its table,
    as in jello_tpu's standalone `fine_v2` (`tpu/fine_v2.py:629-640`).
    Returns ((compact, tile2rank), flags)."""
    area, area_row_rec, rows_overflow = compute_area_rows(cmds, counted, caps)
    flags = {"area_rows_overflow": rows_overflow}
    # No group metadata on this path: every record is its own pass-1
    # segment (ids from 1 in flag bits 8+, as `tpu/fine_v2.py:599-609`).
    ids = ops.iota(cmds["flags"].shape[0], cmds["flags"].device) + 1
    rec = build_records(dict(cmds, area_row=area_row_rec, flags=cmds["flags"] | (ids << 8)),
                        caps)
    fg_tab = None
    if caps.get("_image_tap") and atlas is not None:
        fg_tab, flags["image_region_overflow"], flags["img_recs_overflow"] = image_tap(
            rec, cmds, atlas, layout, caps)
    compact = composite_records(rec, area, ramps, layout["base_color"], cmds["tile_start"],
                                cmds["tile_end"], layout["width_in_tiles"], fg_tab,
                                caps.get("aa_mode", "area") != "area")
    tile2rank = tile_last_record(cmds["tile_start"], cmds["tile_end"])
    return (compact, tile2rank), flags


def assemble_compact(compact, tile2rank, ld):
    """compact per-record rows -> [H, W, 4] un-premultiplied image.

    The premultiplied base color `ld["base_color"]` is un-premultiplied
    on the device. A renderer's layout holds it there already, so the
    function copies nothing from the host and can be captured; a host
    array is uploaded first."""
    wit = int(ld["width_in_tiles"])
    hit = int(ld["height_in_tiles"])
    W = int(ld["target_width"])
    H = int(ld["target_height"])
    base = ld["base_color"]
    if not isinstance(base, torch.Tensor):
        base = host_to_device(torch.from_numpy(np.asarray(base, dtype=np.float32)),
                              compact.device)
    base_un = torch.cat([base[:3] / torch.clamp(base[3:], min=1e-6), base[3:]])
    rank = tile2rank[: wit * hit]
    rows = compact[torch.clamp(rank, 0, compact.shape[0] - 1).long()]
    rows = torch.where((rank >= 0)[:, None, None], rows, base_un[None, :, None])
    img = rows.reshape(hit, wit, 4, 16, 16).permute(0, 3, 1, 4, 2)
    return img.reshape(hit * 16, wit * 16, 4)[:H, :W]
