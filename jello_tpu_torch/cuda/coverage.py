"""Coverage kernel wrapper (kernel A, `csrc/coverage.cu`).

Counterpart of `jello_tpu/tpu/coverage_pallas.py::compute_area_rows_pallas`
in its three modes: area (raw winding rows) and msaa8 / msaa16 (rows
resolved per sample). `coverage_rows` launches kernel A for CUDA tensors
(persistent CTAs that walk the slot-rank rows; `jello_coverage_area`, or
`jello_coverage_msaa` when sample offsets are given) and takes its plain
version, `pipeline.coverage.coverage_rows_plain`, only for CPU tensors;
there is no fallback from one to the other. `compute_area_rows` is the
coverage stage of the renderer built on it (`pipeline/coverage.py` holds
the shared run-boundary, backdrop, rule and record-order code).
"""

from __future__ import annotations

import torch

from ..pipeline import coverage as cov
from ..pipeline.ops import F32, I32
from .build import check, check_tensor, kernels, stream_of


def coverage_rows(stream, row_start, row_end, row_bd, offsets=None, row_eo=None):
    """Area mode (offsets None): out[r] = summed analytic winding of
    stream[row_start[r]:row_end[r]] + row_bd[r]. MSAA (offsets =
    `pipeline.coverage.sample_offsets("msaa8" or "msaa16")`, the only
    patterns the kernel holds): out[r] = the share of the samples inside
    by the row's rule, in [0, 1]. stream [SC, 8] f32 (x0, y0, x1, y1,
    y_edge, valid, 0, 0); row_start/row_end [R] i32; row_bd [R] f32;
    row_eo [R] i32 (MSAA only), 1 for the even-odd rule. Returns [R, 256]
    f32."""
    dev = stream.device
    R = row_start.shape[0]
    check_tensor("stream", stream, F32, dev, (stream.shape[0], 8))
    check_tensor("row_start", row_start, I32, dev, (R,))
    check_tensor("row_end", row_end, I32, dev, (R,))
    check_tensor("row_bd", row_bd, F32, dev, (R,))
    if offsets is not None:
        if list(offsets) not in (cov.sample_offsets("msaa8"), cov.sample_offsets("msaa16")):
            raise ValueError("offsets: expected sample_offsets('msaa8') or ('msaa16')")
        if row_eo is None:
            raise ValueError("row_eo: needed with sample offsets")
        check_tensor("row_eo", row_eo, I32, dev, (R,))
    if dev.type == "cpu":
        return cov.coverage_rows_plain(stream, row_start, row_end, row_bd, offsets, row_eo)
    if stream.data_ptr() % 16:
        raise ValueError("stream: the kernel copies it in 16-byte pieces; expected 16-byte "
                         "alignment")
    out = torch.empty((R, 256), dtype=F32, device=dev)
    if offsets is None:
        err = kernels().jello_coverage_area(
            stream.data_ptr(), row_start.data_ptr(), row_end.data_ptr(),
            row_bd.data_ptr(), out.data_ptr(), R, stream_of(stream))
        check("jello_coverage_area", err)
        coverage_rows.launches += 1
    else:
        err = kernels().jello_coverage_msaa(
            stream.data_ptr(), row_start.data_ptr(), row_end.data_ptr(),
            row_bd.data_ptr(), row_eo.data_ptr(), out.data_ptr(), R, len(offsets),
            stream_of(stream))
        check("jello_coverage_msaa", err)
        coverage_rows.launches_msaa += 1
    return out


# Launches of the area entry, and of the MSAA entry.
coverage_rows.launches = 0
coverage_rows.launches_msaa = 0


def persistent_ctas(samples=0):
    """The CTAs kernel A starts on the current device for a call with
    enough rows (samples 0: the area body, 8 or 16: the MSAA body)."""
    n = kernels().jello_coverage_grid(samples)
    if n < 0:
        raise RuntimeError("jello_coverage_grid: CUDA error")
    return n


def compute_area_rows(cmds, counted, caps):
    """Per-record coverage table through kernel A, in the mode of
    `caps["aa_mode"]`. Returns (area [PC8, 256] f32, area_row_rec [PC]
    i32, overflow 0-dim bool)."""
    return cov.compute_area_rows(cmds, counted, caps, rows_fn=coverage_rows)
