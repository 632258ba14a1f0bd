"""Per-line DDA table kernel wrapper (kernel J, `csrc/line_dda.cu`).

Replaces no Pallas kernel: jello_tpu leaves the per-line half of
path_count to XLA. `line_tables` launches kernel J for CUDA tensors and
takes its plain version, `pipeline.tiling.line_tables_plain` (the torch
chain of `line_dda_clip`, which stays the specification), only for CPU
tensors; there is no fallback from one to the other.

On the card a call is one ctypes call and one kernel: the line and path
vectors go to the entry as they are, and it writes the P table, the row
table and both counts, allocated here with `torch.empty` (inside a
captured frame, from its pool).
"""

from __future__ import annotations

import torch

from ..pipeline import tiling
from ..pipeline.ops import F32, F64, I32
from .build import check, check_tensor, kernels, stream_of

LINE_KEYS = ("line_x0", "line_y0", "line_x1", "line_y1")
PATH_KEYS = ("rect_x0", "rect_y0", "rect_x1", "rect_y1", "tile_offset")
N_COLS = 21  # P's columns
N_ROW_COLS = len(tiling.ROW_COLS)


def line_tables(lines, paths):
    """The per-line half of path_count (`tiling.line_tables_plain`'s
    contract): lines' `line_x0/y0/x1/y1` float32, `line_valid` bool and
    `line_path` int32 [L]; paths' `rect_x0/y0/x1/y1` and `tile_offset`
    int32 [D], D >= 1, all contiguous on one device. Returns (P [L, 21]
    f64, the row table [L, 5] f64, n_cross [L] i32, n_rows [L] i32)."""
    x0, r = lines["line_x0"], paths["rect_x0"]
    for name, t in (("line_x0", x0), ("rect_x0", r)):
        if not isinstance(t, torch.Tensor) or t.dim() != 1:
            raise ValueError(f"{name}: expected a vector, got "
                             + (f"shape {tuple(t.shape)}" if isinstance(t, torch.Tensor)
                                else type(t).__name__))
    L, D, dev = x0.shape[0], r.shape[0], x0.device
    if D < 1:
        raise ValueError("rect_x0: expected at least one path")
    for k in LINE_KEYS:
        check_tensor(k, lines[k], F32, dev, (L,))
    check_tensor("line_valid", lines["line_valid"], torch.bool, dev, (L,))
    check_tensor("line_path", lines["line_path"], I32, dev, (L,))
    for k in PATH_KEYS:
        check_tensor(k, paths[k], I32, dev, (D,))
    if not x0.is_cuda:
        return tiling.line_tables_plain(lines, paths)
    P = torch.empty((L, N_COLS), dtype=F64, device=dev)
    PRT = torch.empty((L, N_ROW_COLS), dtype=F64, device=dev)
    n_cross = torch.empty(L, dtype=I32, device=dev)
    n_rows = torch.empty(L, dtype=I32, device=dev)
    check("jello_line_dda", kernels().jello_line_dda(
        *[lines[k].data_ptr() for k in LINE_KEYS + ("line_valid", "line_path")],
        *[paths[k].data_ptr() for k in PATH_KEYS], P.data_ptr(), PRT.data_ptr(),
        n_cross.data_ptr(), n_rows.data_ptr(), L, D, stream_of(x0)))
    line_tables.launches += 1
    return P, PRT, n_cross, n_rows


line_tables.launches = 0
