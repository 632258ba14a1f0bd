"""Image-tap stage: bilinear atlas taps for image paint records.

Counterpart of `jello_tpu/tpu/image_tap.py` (`image_tap`,
`_region_offsets`, the kernel body) and of
`jello_tpu/tpu/fine_pallas.py::atlas_planar`. An image paint is an
ordinary src-over record once its foreground exists per pixel: this
stage produces that foreground, one row of four channel-planar
256-pixel blocks per image record, premultiplied, with the in-bounds
mask folded into all four channels; kernel B then composes it like a
solid.

`image_tap` is the stage: it compacts the image records of the command
stream in stream order (the rank order `build_records` writes into
word 14) and taps them through `cuda.image_tap.tap_records`, which is
kernel F on the card and `tap_records_plain` here on the CPU.

The region-window bookkeeping of the TPU kernel (a REGH x REGW atlas
window per record, up to MAX_WIN sub-windows for minified images) is
kept only as far as it is contract: a record whose taps span more than
MAX_WIN windows writes zeros and raises `image_region_overflow`, so the
port and the reference reroute the same frames.
"""

from __future__ import annotations

import numpy as np
import torch

from ..profiler import named_scope
from . import ops
from .coarse import CMD_IMAGE
from .ops import F32, I32

REGH, REGW = 64, 256
MAX_WIN = 12
IMG_RECS_CAP_DEFAULT = 1024


def atlas_planar(images):
    """numpy [AH, AW, 4] atlas plane (straight alpha) -> premultiplied
    channel-planar f32 [4, AHp, AWp], padded as jello_tpu pads it:
    AHp = ceil8(max(AH, 64)) + 64, AWp = ceil128(max(AW, 256)) + 256.
    The padded shape is part of the region-overflow contract."""
    images = np.asarray(images, dtype=np.float32)
    AH, AW = int(images.shape[0]), int(images.shape[1])
    AHp = -(-max(AH, 64) // 8) * 8 + 64
    AWp = -(-max(AW, 256) // 128) * 128 + 256
    planar = np.zeros((4, AHp, AWp), dtype=np.float32)
    planar[:3, :AH, :AW] = np.transpose(images[..., :3] * images[..., 3:4], (2, 0, 1))
    planar[3, :AH, :AW] = images[..., 3]
    return planar


def tap_geometry(tap_rec, wit, grid, pixels=None):
    """Per record and pixel: the sample position, the four clamped
    atlas-absolute corner coordinates and the validity masks
    (image_tap.py:95-150). All [IRC, 256] unless noted; `pixels` (i32
    indices into the 16x16 tile) takes those pixels instead of all 256."""
    dev = tap_rec.device
    fr = tap_rec.view(F32)
    kind = tap_rec[:, 0]
    t = tap_rec[:, 3]
    valid = (kind == CMD_IMAGE) & (t >= 0) & (t < grid)  # [IRC]
    tc = torch.clamp(t, 0, grid - 1)
    p = ops.iota(256, dev) if pixels is None else pixels
    gx = (p % 16).to(F32)[None, :] + ((tc % wit) * 16).to(F32)[:, None]
    gy = (p // 16).to(F32)[None, :] + (torch.div(tc, wit, rounding_mode="floor")
                                       * 16).to(F32)[:, None]

    def fu(k):
        return fr[:, k:k + 1]

    m0, m1, m2, m3 = fu(6), fu(7), fu(8), fu(9)
    xl, yl = fu(10), fu(11)
    axy = tap_rec[:, 12:13]
    ax = axy & 0xFFFF
    ay = ops.shr(axy, 16)
    wh = tap_rec[:, 13:14]
    iwi = ops.shr(wh, 16)
    ihi = wh & 0xFFFF
    ux = m0 * gx + m2 * gy + xl
    uy = m1 * gx + m3 * gy + yl
    inb = (ux < iwi.to(F32)) & (uy < ihi.to(F32)) & (ux >= 0.0) & (uy >= 0.0)
    x0f = torch.floor(ux)
    y0f = torch.floor(uy)
    xmax = torch.clamp(iwi - 1, min=0)
    ymax = torch.clamp(ihi - 1, min=0)

    def clampi(v, hi):
        return torch.minimum(torch.clamp(v.to(I32), min=0), hi)

    return {
        "valid": valid, "inb": inb, "fx": ux - x0f, "fy": uy - y0f,
        "c0": ax + clampi(x0f, xmax), "c1": ax + clampi(torch.ceil(ux), xmax),
        "r0": ay + clampi(y0f, ymax), "r1": ay + clampi(torch.ceil(uy), ymax),
    }


def region_windows(rx0, ry0, rx1, ry1, AHp, AWp):
    """From a tap extent: the origin (x_lo, y_lo) of the aligned region
    window that holds its near corner, and the windows (nx, ny) it spans
    from there, each capped at 255 (`_region_offsets`,
    image_tap.py:259-306). All [IRC] i32."""
    x_lo = torch.clamp(torch.div(rx0, 128, rounding_mode="floor") * 128, 0, AWp - REGW)
    y_lo = torch.clamp(torch.div(ry0, 8, rounding_mode="floor") * 8, 0, AHp - REGH)
    nx = torch.clamp(torch.div(torch.clamp(rx1 - x_lo, min=0), REGW, rounding_mode="floor")
                     + 1, max=255)
    ny = torch.clamp(torch.div(torch.clamp(ry1 - y_lo, min=0), REGH, rounding_mode="floor")
                     + 1, max=255)
    return x_lo, y_lo, nx, ny


def region_extent(g, AHp, AWp):
    """Per record: the far corner (rx1, ry1) of its taps over all 256
    pixels and the origin (x_lo, y_lo) of the aligned region window that
    holds their near corner. All [IRC] i32."""
    rx1, ry1 = g["c1"].amax(dim=1), g["r1"].amax(dim=1)
    x_lo, y_lo, _, _ = region_windows(g["c0"].amin(dim=1), g["r0"].amin(dim=1), rx1, ry1,
                                      AHp, AWp)
    return rx1, ry1, x_lo, y_lo


def tap_extent_corners(tap_rec, wit, grid):
    """Per record: (rx0, ry0, rx1, ry1), the least floor corner and the
    greatest ceil corner of its taps, from the tile's four corner pixels
    (0, 0), (15, 0), (0, 15) and (15, 15) alone: the extent kernels F
    and G compute (`csrc/paint.cuh`, image_tap_corner_extent, which says
    why it equals the 256-pixel min and max). All [IRC] i32."""
    edge = ops.iota(2, tap_rec.device) * 15  # 0 and 15
    g = tap_geometry(tap_rec, wit, grid, (edge[None, :] + 16 * edge[:, None]).reshape(4))
    return g["c0"].amin(dim=1), g["r0"].amin(dim=1), g["c1"].amax(dim=1), g["r1"].amax(dim=1)


def region_bad(g, AHp, AWp):
    """[IRC] bool: the record's taps span more than MAX_WIN region
    windows of the padded atlas (`_region_offsets`, image_tap.py:259-306,
    and the kernel's `nw > MAX_WIN`)."""
    _, _, nx, ny = region_windows(g["c0"].amin(dim=1), g["r0"].amin(dim=1),
                                  g["c1"].amax(dim=1), g["r1"].amax(dim=1), AHp, AWp)
    return ny * nx > MAX_WIN


def bilinear_taps(g, atlas):
    """The four premultiplied texels of each channel at the corners of
    `tap_geometry`, mixed x first, then y, as the TPU kernels' column
    product and row reduce: [4, IRC, 256], not yet masked."""
    _, AHp, AWp = atlas.shape
    flat = atlas.reshape(4, AHp * AWp)

    def texel(r, c):
        # Rows of zeroed or overflowing records may point anywhere; their
        # taps are masked by the caller, so only keep the read in bounds.
        idx = torch.clamp(r, 0, AHp - 1).long() * AWp + torch.clamp(c, 0, AWp - 1).long()
        return flat[:, idx]

    fx, fy = g["fx"], g["fy"]
    top = texel(g["r0"], g["c0"]) * (1.0 - fx) + texel(g["r0"], g["c1"]) * fx
    bot = texel(g["r1"], g["c0"]) * (1.0 - fx) + texel(g["r1"], g["c1"]) * fx
    return top * (1.0 - fy) + bot * fy


def tap_records_plain(tap_rec, atlas, wit, grid):
    """Plain version of kernel F (same inputs and outputs as
    `cuda.image_tap.tap_records`): (fg [IRC, 1024] f32, region flag
    0-dim bool)."""
    IRC = tap_rec.shape[0]
    _, AHp, AWp = atlas.shape
    g = tap_geometry(tap_rec, wit, grid)
    bad = region_bad(g, AHp, AWp)
    okf = (g["inb"] & (~bad & g["valid"])[:, None]).to(F32)
    fg = bilinear_taps(g, atlas) * okf
    return fg.permute(1, 0, 2).reshape(IRC, 1024).contiguous(), (bad & g["valid"]).any()


def runs_tap(caps, atlas) -> bool:
    """Whether a frame's fine stage runs the tap: its routing takes it
    (`_image_tap`) and the frame has an atlas."""
    return bool(caps.get("_image_tap")) and atlas is not None


def image_tap(rec, cmds, atlas, layout, caps):
    """Run the tap over the command stream's image records.

    rec: the packed [PC, 16] record table (`build_records` with image
    ranks in word 14); atlas: f32 [4, AHp, AWp] from `atlas_planar`.
    Returns (fg_tab [img_recs_cap, 1024], image_region_overflow,
    img_recs_overflow); rows past the image count are zero. The stage is
    the `image_tap` span (`profiler.named_scope`), which the frame's stage
    clock stamps inside fine (`pipeline.render.NESTED`)."""
    from ..cuda.image_tap import tap_records
    from .flatten import expand_by_counts

    grid = caps["tile_grid_cap"]
    IRC = caps.get("img_recs_cap", IMG_RECS_CAP_DEFAULT)
    with named_scope("image_tap"):
        tile = cmds["tile"]
        P = (cmds["kind"] == CMD_IMAGE) & (tile < grid) & (tile >= 0)
        irec, _, ivalid, _, n_img = expand_by_counts(P.to(I32), IRC, land=True)
        tap_rec = torch.where(ivalid[:, None], ops.gather_guarded(rec, irec), 0).contiguous()
        fg_tab, region_ovf = tap_records(tap_rec, atlas, layout["width_in_tiles"], grid)
    return fg_tab, region_ovf, n_img > IRC
