"""Surface output conversion (reference: engine blit pipeline,
engine/wgpu_engine/lib.go:109-198).

The reference's fine stage writes non-premultiplied rgba16float; a blit
render pass premultiplies into the surface format. Equivalents for
presenting the TPU fine output.
"""

from __future__ import annotations

import numpy as np


def premultiply(img: np.ndarray) -> np.ndarray:
    """Non-premultiplied float RGBA -> premultiplied (the blit fragment
    shader, lib.go:131-141)."""
    out = np.array(img, dtype=np.float32, copy=True)
    out[..., :3] *= out[..., 3:4]
    return out


def to_rgba8(img: np.ndarray, premul: bool = True, srgb: bool = True) -> np.ndarray:
    """Float linear RGBA -> uint8 surface pixels.

    premul: apply the blit premultiply.
    srgb: encode color channels with the sRGB OETF (for display
    surfaces; the reference's surface formats are *Srgb)."""
    out = premultiply(img) if premul else np.asarray(img, dtype=np.float32)
    rgb = np.clip(out[..., :3], 0.0, 1.0)
    if srgb:
        rgb = np.where(
            rgb <= 0.0031308, rgb * 12.92, 1.055 * rgb ** (1 / 2.4) - 0.055
        )
    a = np.clip(out[..., 3:4], 0.0, 1.0)
    return (np.concatenate([rgb, a], axis=-1) * 255.0 + 0.5).astype(np.uint8)

