"""The image atlas plane (counterpart of
`jello_tpu/cpu/pipeline.py::build_image_atlas`)."""

from __future__ import annotations

import numpy as np


def build_image_atlas(atlas):
    """Materialize the resolver's shelf-packed ImageAtlas into one
    [AH, AW, 4] f32 plane (values /255, no sRGB decode — the reference
    samples Rgba8Unorm textures; packing scheme of resolve.go:128-149).
    AH/AW are already 8/128-quantized by the packer."""
    if atlas is None or not len(atlas):
        return None
    plane = np.zeros((atlas.height, atlas.width, 4), dtype=np.float32)
    for img, (ax, ay) in zip(atlas.images, atlas.placements):
        plane[ay : ay + img.height, ax : ax + img.width] = (
            np.asarray(img.pixels, dtype=np.float32) / 255.0
        )
    return plane
