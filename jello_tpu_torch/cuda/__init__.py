"""The GPU half of the port: counterpart of `jello_tpu/tpu/`.

`render.Renderer` is the entry point; `coverage`, `fine_v2`, `land`,
`lockstep`, `expand` and `image_tap` wrap the hand-written CUDA kernels
in `jello_tpu_torch/csrc/`, and `build` compiles and loads them at first
use.
"""

from .render import Renderer, upload, upload_atlas

__all__ = ["Renderer", "upload", "upload_atlas"]
