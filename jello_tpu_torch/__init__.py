"""jello_tpu_torch: the jello_tpu renderer ported to PyTorch and CUDA.

The port sits beside `jello_tpu`, which stays the reference. It imports
`torch`, never JAX and nothing of `jello_tpu`: the JAX-free host half
(scene, curve, gfx, encoding with its native path encoder, the
renderer's resolve/estimate/params, the stop-table baking, the
benchmark scenes) is the port's own copy, under the same names. A user
writes `import jello_tpu_torch as jt`, builds a `jt.Scene` and renders
it with `jello_tpu_torch.cuda.Renderer`.

Layout (each module names its jello_tpu counterpart):
  - `scene`, `gfx`, `curve`, `encoding`, `native`: scene construction
    and the binary stream encoding;
  - `renderer/`: host-side resolve (ramps, image atlas), capacity
    estimation, render parameters;
  - `pmath`, `flatten_math`: flatten's numerical core;
  - `scenes`: the benchmark scenes (the port renders configs 1 to 5);
  - `pipeline/`: the backend-generic stages, in torch, and the plain
    versions of the kernels;
  - `cuda/`: the renderer, the kernel wrappers and the kernel loader
    (counterpart of `jello_tpu/tpu/`);
  - `csrc/`: the CUDA kernels for sm_90a.

Entry point: `jello_tpu_torch.cuda.Renderer(device=...)`.
"""

from .scene import Scene
from .gfx import (
    Fill,
    Extend,
    Mix,
    Compose,
    BlendMode,
    Color,
    SolidBrush,
    GradientBrush,
    ImageBrush,
    LinearGradient,
    RadialGradient,
    SweepGradient,
    ColorStop,
    Image,
)
from .curve import (
    Point,
    Affine,
    BezPath,
    Stroke,
    Cap,
    Join,
    Rect,
)
from .renderer.params import RenderParams, AaConfig

__all__ = [
    "Scene",
    "Fill",
    "Extend",
    "Mix",
    "Compose",
    "BlendMode",
    "Color",
    "SolidBrush",
    "GradientBrush",
    "ImageBrush",
    "LinearGradient",
    "RadialGradient",
    "SweepGradient",
    "ColorStop",
    "Image",
    "Point",
    "Affine",
    "BezPath",
    "Stroke",
    "Cap",
    "Join",
    "Rect",
    "RenderParams",
    "AaConfig",
]

__version__ = "0.1.0"
