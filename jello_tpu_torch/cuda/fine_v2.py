"""Record-stream fine stage (kernel B, `csrc/fine_v2.cu`).

Counterparts in `jello_tpu`:
  - `tpu/fine_pallas.py::build_records`: the 16-word record packing;
  - `tpu/fine_v2.py::fine_v2`, standalone call (clip-free; with the
    image-tap stage inside when the frame has an atlas): coverage,
    records, image foregrounds, compositing;
  - `tpu/fine_v2.py::assemble_compact`: tiles -> image.

Painter's-order src-over compositing, v' = v (1 - fa cov) + fg cov, is
an affine map of the running pixel color. `composite_records` launches
kernel B for CUDA tensors (one CTA per tile walks the tile's records in
order) and takes `composite_records_plain` only for CPU tensors: a
vectorized Hillis-Steele segmented scan of the (A, B) affine pairs over
the whole record stream, segments keyed on the tile column.

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
    CMD_END_CLIP,
    CMD_IMAGE,
    CMD_LIN_GRAD,
    CMD_RAD_GRAD,
    CMD_SWEEP_GRAD,
)
from ..pipeline.image_tap import image_tap
from ..pipeline.drawobjs import (
    RAD_GRAD_KIND_CIRCULAR,
    RAD_GRAD_KIND_FOCAL_ON_CIRCLE,
    RAD_GRAD_KIND_STRIP,
    RAD_GRAD_SWAPPED,
)
from ..pipeline.ops import F32, I32
from ..pmath import rdiv, sqrt
from .build import check, check_tensor, kernels, stream_of
from .coverage import compute_area_rows


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


def tile_last_record(tile_start, tile_end):
    """tile2rank: each tile's last record index, -1 for an empty tile."""
    return torch.where(tile_end > tile_start, tile_end - 1, -1).to(I32)


def _extend(t, mode):
    pad = torch.clamp(t, 0.0, 1.0)
    rep = t - torch.floor(t)
    refl = torch.abs(t - 2.0 * torch.round(0.5 * t))
    return torch.where(mode == 0, pad, torch.where(mode == 1, rep, refl))


def _eotf(x):
    hi = torch.exp(2.4 * torch.log(torch.clamp(x + 0.055, min=1e-6) * (1.0 / 1.055)))
    return torch.where(x <= 0.04045, x * (1.0 / 12.92), hi)


def _gradient_fg(rec, stops, wit, is_lin, is_rad, is_grad):
    """Premultiplied gradient paint per record and pixel: 4 x [PC, 256]
    (fine_v2.py:216-339)."""
    dev = rec.device
    fr = rec.view(F32)

    def fu(k):
        return fr[:, k:k + 1]

    def iu(k):
        return rec[:, k:k + 1]

    one = torch.ones((), dtype=F32, device=dev)
    zero = torch.zeros((), dtype=F32, device=dev)
    p = ops.iota(256, dev)
    tile = iu(3)
    gx = ((tile % wit) * 16).to(F32) + (p % 16).to(F32)[None, :]
    gy = (torch.div(tile, wit, rounding_mode="floor") * 16).to(F32) + (p // 16).to(F32)[None, :]

    t_lin = fu(6) * gx + fu(7) * gy + fu(8)

    m0, m1, m2, m3 = fu(6), fu(7), fu(8), fu(9)
    xl, yl = fu(10), fu(11)
    focal_x = fu(12)
    radius = fu(13)
    kf = iu(14)
    rkind = kf & 0x7
    rflags = kf >> 3
    lxr = m0 * gx + m2 * gy + xl
    lyr = m1 * gx + m3 * gy + yl
    xx = lxr * lxr
    yy = lyr * lyr
    is_strip = rkind == RAD_GRAD_KIND_STRIP
    is_circ = rkind == RAD_GRAD_KIND_CIRCULAR
    is_foc = rkind == RAD_GRAD_KIND_FOCAL_ON_CIRCLE
    is_swapped = (rflags & RAD_GRAD_SWAPPED) != 0
    r1r = torch.where(is_circ, zero, rdiv(1.0, torch.where(radius == 0, one, radius)))
    less_scale = torch.where(is_swapped | ((1.0 - focal_x) < 0.0), -one, one)
    t_sign = torch.sign(1.0 - focal_x)
    a_s = radius - yy
    t_strip = sqrt(torch.clamp(a_s, min=0.0)) + lxr
    v_strip = (a_s >= 0.0).to(F32)
    t_foc = (xx + yy) / torch.where(lxr == 0.0, one, lxr)
    v_foc = ((t_foc >= 0.0) & (lxr != 0.0)).to(F32)
    t_big = sqrt(xx + yy) - lxr * r1r
    a_c = xx - yy
    t_cone = less_scale * sqrt(torch.clamp(a_c, min=0.0)) - lxr * r1r
    v_cone = ((a_c >= 0.0) & (t_cone >= 0.0)).to(F32)
    big = radius > 1.0
    t_rad = torch.where(is_strip, t_strip, torch.where(is_foc, t_foc,
                                                       torch.where(big, t_big, t_cone)))
    v_rad = torch.where(is_strip, v_strip, torch.where(is_foc, v_foc,
                                                       torch.where(big, one, v_cone)))
    t_rad = focal_x + t_sign * t_rad

    # Sweep: atan polynomial (fine.wgsl:1035-1067) with its NaN scrub.
    t0s, t1s = fu(12), fu(13)
    xabs = torch.abs(lxr)
    yabs = torch.abs(lyr)
    mx = torch.maximum(xabs, yabs)
    slope = torch.minimum(xabs, yabs) / torch.where(mx == 0, one, mx)
    s2 = slope * slope
    phi = slope * (
        0.15912117063999176025390625
        + s2 * (-5.185396969318389892578125e-2
                + s2 * (2.476101927459239959716796875e-2
                        + s2 * (-7.0547382347285747528076171875e-3))))
    phi = torch.where(xabs < yabs, 0.25 - phi, phi)
    phi = torch.where(lxr < 0.0, 0.5 - phi, phi)
    phi = torch.where(lyr < 0.0, 1.0 - phi, phi)
    phi = torch.where(phi != phi, zero, phi)
    t_sweep = (phi - t0s) / torch.where(t1s == t0s, one, t1s - t0s)

    t = torch.where(is_lin, t_lin, torch.where(is_rad, t_rad, t_sweep))
    t = _extend(t, iu(5))
    t = torch.where(is_rad & is_swapped, 1.0 - t, t)
    vmask = torch.where(is_rad, v_rad, one)

    NR, W = stops.shape
    S = (W - 1) // 5
    ramp = rec[:, 15]
    ok = is_grad[:, 0] & (ramp >= 0) & (ramp < NR)
    rows = torch.where(ok[:, None], ops.gather_guarded(stops, ramp), zero)

    def stop_p(k):
        return rows[:, 1 + k:2 + k]

    def stop_c(k, ch):
        return rows[:, 1 + S + 4 * k + ch:2 + S + 4 * k + ch]

    acc = [stop_c(0, ch).expand(-1, 256) for ch in range(4)]
    for k in range(S - 1):
        dk = torch.clamp(stop_p(k + 1) - stop_p(k), min=1e-9)
        u = torch.clamp((t - stop_p(k)) / dk, 0.0, 1.0)
        for ch in range(4):
            acc[ch] = acc[ch] + (stop_c(k + 1, ch) - stop_c(k, ch)) * u
    ga = acc[3] * vmask
    return [_eotf(acc[0]) * ga, _eotf(acc[1]) * ga, _eotf(acc[2]) * ga, ga]


def composite_records_plain(rec, cov, stops, base, tile_start, tile_end, wit, fg_tab=None):
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
    eo = torch.abs(a - 2.0 * torch.round(0.5 * a))
    nz = torch.clamp(torch.abs(a), max=1.0)
    c = torch.where((flags & 1) != 0, eo, nz)
    c = torch.where(rec[:, 1:2] >= 0, c, torch.ones_like(c))
    c = c * live.to(F32)

    gfg = _gradient_fg(rec, stops, wit, is_lin, is_rad, is_grad)
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

    # (A, B) affine pairs; Hillis-Steele inclusive scan within tiles.
    A = 1.0 - fg[3] * c
    B = torch.stack([f * c for f in fg], dim=1)  # [PC, 4, 256]
    k = 1
    while k < PC:
        same = (tile[k:] == tile[:-k])[:, None]
        B = torch.cat([B[:k], B[k:] + torch.where(same[:, None], A[k:, None] * B[:-k], zero)])
        A = torch.cat([A[:k], torch.where(same, A[k:] * A[:-k], A[k:])])
        k *= 2
    v = B + A[:, None] * base.to(F32)[None, :, None]
    inv_a = rdiv(1.0, torch.clamp(v[:, 3], min=1e-6))
    return torch.cat([v[:, :3] * inv_a[:, None], v[:, 3:]], dim=1)


def composite_records(rec, cov, stops, base, tile_start, tile_end, wit, fg_tab=None):
    """Kernel B for CUDA tensors, its plain version for CPU tensors.

    rec [PC, 16] i32 tile-sorted records; cov [>= PC, 256] f32
    per-record coverage; stops [NR, W] f32, W = 1 + 5 * stops; base [4] f32
    premultiplied base color; tile_start/tile_end [GRID] i32, each
    tile's run [start, end) of records (coarse's run boundaries); fg_tab
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
    n_fg = 0 if fg_tab is None else fg_tab.shape[0]
    if fg_tab is not None:
        check_tensor("fg_tab", fg_tab, F32, dev, (n_fg, 1024))
    if dev.type == "cpu":
        return composite_records_plain(rec, cov, stops, base, tile_start, tile_end, wit,
                                       fg_tab)
    out = torch.empty((PC, 4, 256), dtype=F32, device=dev)
    err = kernels().jello_fine_v2(
        rec.data_ptr(), cov.data_ptr(), stops.data_ptr(), tile_start.data_ptr(),
        tile_end.data_ptr(), base.data_ptr(),
        None if fg_tab is None else fg_tab.data_ptr(), out.data_ptr(), grid, NR, W,
        int(wit), n_fg, stream_of(rec))
    check("jello_fine_v2", err)
    composite_records.launches += 1
    return out


composite_records.launches = 0


def fine_v2(cmds, counted, ramps, atlas, layout, caps):
    """The fine stage of a clip-free area-AA frame. With `_image_tap` in
    caps and an atlas (f32 [4, AHp, AWp], `pipeline.image_tap.atlas_planar`)
    the image-tap stage runs here and image records paint from its table,
    as in jello_tpu's standalone `fine_v2` (`tpu/fine_v2.py:629-640`).
    Returns ((compact, tile2rank), flags)."""
    area, area_row_rec, rows_overflow = compute_area_rows(cmds, counted, caps)
    flags = {"area_rows_overflow": rows_overflow}
    rec = build_records(dict(cmds, area_row=area_row_rec), caps)
    fg_tab = None
    if caps.get("_image_tap") and atlas is not None:
        fg_tab, flags["image_region_overflow"], flags["img_recs_overflow"] = image_tap(
            rec, cmds, atlas, layout, caps)
    compact = composite_records(rec, area, ramps, layout["base_color"], cmds["tile_start"],
                                cmds["tile_end"], layout["width_in_tiles"], fg_tab)
    tile2rank = tile_last_record(cmds["tile_start"], cmds["tile_end"])
    return (compact, tile2rank), flags


def assemble_compact(compact, tile2rank, ld):
    """compact per-record rows -> [H, W, 4] un-premultiplied image."""
    wit = int(ld["width_in_tiles"])
    hit = int(ld["height_in_tiles"])
    W = int(ld["target_width"])
    H = int(ld["target_height"])
    base = np.asarray(ld["base_color"], dtype=np.float32)
    ba = max(float(base[3]), 1e-6)
    base_un = torch.tensor([base[0] / ba, base[1] / ba, base[2] / ba, base[3]],
                           dtype=F32, device=compact.device)
    rank = tile2rank[: wit * hit]
    rows = compact[torch.clamp(rank, 0, compact.shape[0] - 1).long()]
    rows = torch.where((rank >= 0)[:, None, None], rows, base_un[None, :, None])
    img = rows.reshape(hit, wit, 4, 16, 16).permute(0, 3, 1, 4, 2)
    return img.reshape(hit * 16, wit * 16, 4)[:H, :W]
