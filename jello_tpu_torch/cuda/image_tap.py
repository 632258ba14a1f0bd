"""Image-tap kernel wrapper (kernel F, `csrc/image_tap.cu`).

Counterpart of the kernel call inside
`jello_tpu/tpu/image_tap.py::image_tap` (`make_image_tap_kernel`).
`tap_records` launches kernel F for CUDA tensors and takes its plain
version, `pipeline.image_tap.tap_records_plain`, only for CPU tensors;
there is no fallback from one to the other.
"""

from __future__ import annotations

import torch

from ..pipeline import image_tap as plain
from ..pipeline.ops import F32, I32
from .build import check, check_tensor, kernels, stream_of


def tap_records(tap_rec, atlas, wit, grid):
    """Premultiplied bilinear atlas taps of compacted image records.

    tap_rec [IRC, 16] i32: image records in stream order, zero rows past
    the image count; atlas [4, AHp, AWp] f32 premultiplied planar
    (`pipeline.image_tap.atlas_planar`); wit [] i32: the width in tiles
    (the layout's word, read by the kernel on the device); grid: the tile
    grid capacity. Returns (fg [IRC, 1024] f32, four 256-pixel
    channel blocks per record with the in-bounds mask folded in, zero for
    rows that are not image records; region-overflow flag, 0-dim bool)."""
    dev = tap_rec.device
    IRC = tap_rec.shape[0]
    check_tensor("tap_rec", tap_rec, I32, dev, (IRC, 16))
    if atlas.dim() != 3:
        raise ValueError(f"atlas: expected [4, AHp, AWp], got {tuple(atlas.shape)}")
    _, AHp, AWp = atlas.shape
    check_tensor("atlas", atlas, F32, dev, (4, AHp, AWp))
    check_tensor("wit", wit, I32, dev, ())
    if dev.type == "cpu":
        return plain.tap_records_plain(tap_rec, atlas, wit, grid)
    out = torch.empty((IRC, 1024), dtype=F32, device=dev)
    # One byte, cleared by the entry's memset and set by the kernel: the
    # flag is a view of it, with no comparison on the device.
    flag = torch.empty(1, dtype=torch.bool, device=dev)
    err = kernels().jello_image_tap(
        tap_rec.data_ptr(), atlas.data_ptr(), out.data_ptr(), flag.data_ptr(), wit.data_ptr(),
        IRC, int(grid), AHp, AWp, stream_of(tap_rec))
    check("jello_image_tap", err)
    tap_records.launches += 1
    return out, flag[0]


tap_records.launches = 0


def resident_ctas():
    """Kernel F's CTAs resident on one multiprocessor of the current
    device (a query, no launch)."""
    n = kernels().jello_image_tap_ctas()
    if n < 0:
        raise RuntimeError("jello_image_tap_ctas: CUDA error")
    return n
