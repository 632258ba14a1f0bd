"""The benchmark's plain reference renderer: draw commands in, u8 surface
pixels out.

A frozen copy of jello_tpu's numpy oracle (`jello_tpu.cpu.render_numpy`
and the scene, encoding, resolve, estimate and pipeline code it runs
under numpy), with every JAX and Pallas branch taken out and the native
path encoder left out (the pure Python encoder writes the same words).
Its fine stage (`fine.py`) is the oracle's, translated to torch so that
it runs on the card; `frame.render_u8` drives it all. It shares no code
with the program (jello_tpu_torch) and imports nothing of it or of JAX.
"""

from .curve import Affine, BezPath, Cap, Join, Stroke
from .gfx import (
    BlendMode,
    Color,
    ColorStop,
    Compose,
    Extend,
    Fill,
    GradientBrush,
    Image,
    ImageBrush,
    LinearGradient,
    Mix,
    RadialGradient,
    SolidBrush,
)
from .renderer.params import AaConfig, RenderParams
from .scene import Scene

__all__ = [
    "Affine", "AaConfig", "BezPath", "BlendMode", "Cap", "Color", "ColorStop", "Compose",
    "Extend", "Fill", "GradientBrush", "Image", "ImageBrush", "Join", "LinearGradient", "Mix",
    "RadialGradient", "RenderParams", "Scene", "SolidBrush", "Stroke",
]
