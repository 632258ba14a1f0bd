"""The metric arithmetic on synthetic values and traces: percentiles,
interval union and gaps, kernel-name classes, and the readers of the
per-layer metrics."""

import math

import numpy as np
import pytest

from metrics import _common, cuda_kernel_ms, device_idle_pct, device_ops_per_frame
from metrics import frame_ms_p95, torch_scan_ms
from portbench import tracing


@pytest.mark.parametrize("values", [[3.0], [1.0, 2.0], list(range(101)), [5, 1, 4, 2, 3, 9, 7]])
@pytest.mark.parametrize("q", [0, 50, 95, 100])
def test_portbench_percentile_matches_numpy(values, q):
    assert _common.percentile(values, q) == pytest.approx(float(np.percentile(values, q)))


def test_portbench_percentile_counts_a_failed_frame_as_late():
    lat = [0.01] * 39 + [math.inf]
    assert _common.percentile(lat, 50) == 0.01
    assert frame_ms_p95.read({"latencies_s": lat}) is not None
    assert frame_ms_p95.read({"latencies_s": [0.01] * 10 + [math.inf] * 2}) is None


def test_portbench_union_and_gaps():
    spans = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (10, 11)]
    assert _common.union(spans) == pytest.approx(3 + 1 + 1)
    assert _common.gaps(spans, 0, 12) == [(3, 5), (6, 10), (11, 12)]
    assert _common.gaps([], 1, 2) == [(1, 2)]
    assert _common.union([]) == 0


def test_portbench_op_kind_and_class():
    assert _common.op_kind("void at::native::foo<int, 4>(int*)") == "at::native::foo"
    assert _common.op_kind("Memcpy DtoD (Device -> Device)") == "Memcpy DtoD"
    assert _common.op_kind("void at::native::(anonymous namespace)::bar<1>()") == \
        "at::native::bar"
    names = cuda_kernel_ms.hand_written()
    assert {"coverage_kernel", "fine_v2_kernel", "interp_tile_kernel", "scan_apply"} <= names
    assert not names & {"elementwise_kernel_with_index", "memset32", "memcpy128"}


def _trace():
    """Two frames in a window [100, 200] us: kernels of three classes, a
    copy, one op straddling the window's start and one outside it."""
    def ev(cat, name, ts, dur):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": 7}
    events = [
        ev("kernel", "void at::native::tensor_kernel_scan_outer_dim<int>(int*)", 110, 20),
        ev("kernel", "void at::native::vectorized_elementwise_kernel<4>()", 130, 10),
        ev("kernel", "interp_tile_kernel(int const*)", 150, 5),
        ev("kernel", "memset32", 155, 0),
        ev("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 160, 10),
        ev("kernel", "void at::native::tensor_kernel_scan_innermost_dim<float>()", 90, 20),
        ev("kernel", "late_kernel", 250, 10),
        {"ph": "X", "cat": "user_annotation", "name": tracing.WINDOW, "ts": 100, "dur": 100,
         "pid": 1, "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 170, "dur": 20,
         "pid": 1, "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "frame.result", "ts": 168, "dur": 40,
         "pid": 1, "tid": 1},
    ]
    return {"events": events, "start": 100.0, "end": 200.0, "frames": 2}


def test_portbench_per_layer_readers_on_a_synthetic_trace():
    ctx = {"trace": _trace()}
    assert device_ops_per_frame.read(ctx) == 6 / 2
    # The straddling scan is clipped to its 10 us inside the window.
    assert torch_scan_ms.read(ctx) == pytest.approx((20 + 10) / 1e3 / 2)
    assert cuda_kernel_ms.read(ctx) == pytest.approx(5 / 1e3 / 2)
    busy = 10 + 20 + 10 + 5 + 10
    assert device_idle_pct.read(ctx) == pytest.approx(100 * (1 - busy / 100))
    for reader in (device_ops_per_frame, torch_scan_ms, cuda_kernel_ms, device_idle_pct):
        assert reader.read({"trace": None}) is None
        assert reader.read({"trace": dict(_trace(), events=[])}) is None


def test_portbench_breakdown_names_gaps_by_host_activity():
    b = tracing.breakdown(_trace())
    assert [k for k, _ in b["device_ops"]][0] == "at::native::tensor_kernel_scan_outer_dim"
    gaps = dict((round(s * 1e6), name) for name, s in b["idle_gaps"])
    # Gaps: 140-150 and 155-160 (no host event), 170-200 (aten::copy_ runs
    # 170-190 inside the harness's frame.result span).
    assert gaps == {10: "host: no span", 5: "host: no span",
                    30: "frame.result > aten::copy_"}
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
