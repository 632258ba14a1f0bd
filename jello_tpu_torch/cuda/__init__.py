"""The GPU half of the port: counterpart of `jello_tpu/tpu/`.

`render.Renderer` is the entry point (`render.Frame` a frame in flight); `coverage`, `fine_v2`, `land`,
`lockstep`, `expand`, `image_tap` and `fine_interp` wrap the hand-written
CUDA kernels in `jello_tpu_torch/csrc/`, `fine_hybrid` is the fine stage
of a frame with clip layers, and `build` compiles and loads the kernels
at first use.
"""

from .render import Frame, Renderer, upload, upload_atlas

__all__ = ["Frame", "Renderer", "upload", "upload_atlas"]
