"""Device-trace attribution of the port (jello_tpu_torch/xtrace.py and
Profiler.device_trace, jello_tpu_torch/profiler.py) on a
synthetic Chrome-trace capture shaped as torch.profiler exports one from
a CUDA run: a host thread with the pipeline's stage spans, the call-site
spans of `profiler.source_spans` and the launches (`cuda_runtime`,
correlation ids), and a device stream with kernels, a copy and the
stage spans' device-side annotations, one of them covering the whole
frame. No test here starts a CUDA activity; the CPU capture test asks
torch.profiler for the CPU activity only, as `device_trace` does where
no CUDA device is present."""

import json
import os
import sys

import numpy as np
import pytest

import jello_tpu.profiler as jp
import jello_tpu.xtrace as jx
from jello_tpu_torch import profiler as tp
from jello_tpu_torch import xtrace as tx

SCAN = "void at::native::tensor_kernel_scan_outer_dim<int, std::plus<int> >(int*, int const*, int, int, int, int, std::plus<int>)"
LAND = "void (anonymous namespace)::land_kernel<3>(int const*, bool const*, float*)"


def _write_capture(tmp_path):
    host, dev = (100, 100), (0, 7)
    events = []

    def x(cat, name, pid_tid, ts, dur, **args):
        events.append({"ph": "X", "cat": cat, "name": name, "pid": pid_tid[0],
                       "tid": pid_tid[1], "ts": ts, "dur": dur, "args": args})

    # Host: two frames' worth of launches (frames=2) in one capture.
    x("user_annotation", "flatten", host, 0.0, 100.0)
    x("user_annotation", tp.SOURCE_PREFIX + "pipeline/flatten.py:172 (shim)", host, 10.0, 10.0)
    x("cpu_op", "aten::cummax", host, 11.0, 8.0)
    x("cuda_runtime", "cudaLaunchKernel", host, 12.0, 3.0, correlation=1)
    x("user_annotation", tp.SOURCE_PREFIX + "pipeline/pathtag.py:48", host, 25.0, 10.0)
    x("cuda_runtime", "cudaLaunchKernel", host, 30.0, 3.0, correlation=2)
    x("user_annotation", "fine", host, 200.0, 200.0)
    x("user_annotation", tp.SOURCE_PREFIX + "cuda/land.py:52", host, 240.0, 20.0)
    x("cuda_runtime", "cudaLaunchKernel", host, 250.0, 3.0, correlation=3)
    x("cuda_runtime", "cudaMemcpyAsync", host, 500.0, 3.0, correlation=4)
    # Device: the scan (3 ms) and a second scan (1 ms) inside flatten's
    # device span; the landing kernel (2 ms) launched inside "fine",
    # which has no device span here; a copy (0.5 ms) launched outside
    # every stage; and an annotation that covers the whole frame.
    x("gpu_user_annotation", "frame", dev, 0.0, 10000.0)
    x("gpu_user_annotation", "flatten", dev, 1000.0, 4000.0)
    x("kernel", SCAN, dev, 1000.0, 3000.0, correlation=1, device=0, stream=7)
    x("kernel", SCAN, dev, 4000.0, 1000.0, correlation=2, device=0, stream=7)
    x("kernel", LAND, dev, 6000.0, 2000.0, correlation=3, device=0, stream=7)
    x("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", dev, 9000.0, 500.0, correlation=4,
      device=0, stream=7)
    d = tmp_path / "capture"
    os.makedirs(d)
    with open(d / "1.pt.trace.json", "w") as f:
        json.dump({"schemaVersion": 1, "traceEvents": events}, f)
    return str(d)


def test_torch_attribute_and_stage_times(tmp_path):
    logdir = _write_capture(tmp_path)
    (dev, t), = tx.attribute(logdir, frames=2).items()
    assert dev == "cuda:0"
    assert {k: ms for k, (ms, _) in t["stages"].items()} == pytest.approx(
        {"flatten": 2.0, "fine": 1.0, tx.OUTSIDE: 0.25})
    assert t["stages"]["flatten"] == pytest.approx((2.0, 1.0))
    assert t["kinds"]["at::native::tensor_kernel_scan_outer_dim"] == pytest.approx((2.0, 1.0))
    assert t["kinds"]["land_kernel"] == pytest.approx((1.0, 0.5))
    assert t["kinds"]["Memcpy DtoH"] == pytest.approx((0.25, 0.5))
    assert t["sources"] == pytest.approx({
        "pipeline/flatten.py:172 (shim)": (1.5, 0.5), "pipeline/pathtag.py:48": (0.5, 0.5),
        "cuda/land.py:52": (1.0, 0.5), tx.NO_SOURCE: (0.25, 0.5)})
    assert t["sites"][("flatten", "pipeline/pathtag.py:48",
                       "at::native::tensor_kernel_scan_outer_dim")] == pytest.approx((0.5, 0.5))
    # Busy time is the device work only: the annotation covering the
    # frame (5 ms a frame) is left out, and the stages account for it.
    busy = t["lines"]["all streams"]
    assert busy == pytest.approx((3.25, 3.25, 2.0))
    assert t["lines"]["stream 7"] == busy
    assert t["lines"]["host launch calls"] == pytest.approx((0.006, 0.006, 2.0))
    assert sum(ms for ms, _ in t["stages"].values()) == pytest.approx(busy[1])
    # ops sorted by descending per-frame ms
    assert [o[2] for o in t["ops"]] == sorted((o[2] for o in t["ops"]), reverse=True)
    assert t["ops"][0][:2] == ("stream 7", SCAN)


def test_torch_attribute_of_a_replayed_frame(tmp_path):
    """A CUDA graph's replay: one host call (cudaGraphLaunch) puts every
    kernel and memset of the graph on the device under one correlation
    id, inside no stage span. Busy ms, kernels and kinds come out as for
    an eager frame, the host call counts once, and every launch is
    outside the stages with no call site."""
    host, dev = (100, 100), (0, 7)
    events = [{"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch", "pid": host[0],
               "tid": host[1], "ts": 5.0, "dur": 40.0, "args": {"correlation": 9}}]
    for cat, name, ts, dur in (("kernel", SCAN, 100.0, 3000.0),
                               ("gpu_memset", "Memset (Device)", 3200.0, 1.0),
                               ("kernel", LAND, 3300.0, 2000.0)):
        events.append({"ph": "X", "cat": cat, "name": name, "pid": dev[0], "tid": dev[1],
                       "ts": ts, "dur": dur, "args": {"correlation": 9, "device": 0}})
    d = tmp_path / "replay"
    os.makedirs(d)
    with open(d / "1.pt.trace.json", "w") as f:
        json.dump({"schemaVersion": 1, "traceEvents": events}, f)
    (_, t), = tx.attribute(str(d)).items()
    assert t["lines"]["all streams"] == pytest.approx((5.001, 5.001, 3.0))
    assert t["lines"]["host launch calls"] == pytest.approx((0.04, 0.04, 1.0))
    assert t["kinds"]["land_kernel"] == pytest.approx((2.0, 1.0))
    assert t["kinds"]["Memset"] == pytest.approx((0.001, 1.0))
    assert t["stages"] == pytest.approx({tx.OUTSIDE: (5.001, 3.0)})
    assert t["sources"] == pytest.approx({tx.NO_SOURCE: (5.001, 3.0)})


def test_torch_call_site_shim_reports_the_caller():
    """A torch call made inside `pipeline/ops.py` is attributed to the line
    of the package that called the helper, marked " (shim)"; a call made
    elsewhere in the package to its own line."""
    pkg = os.path.dirname(tp.__file__)
    scope = {"sys": sys, "call_site": tp.call_site}
    exec(compile("def helper():\n    return call_site(sys._getframe())\n",
                 os.path.join(pkg, "pipeline", "ops.py"), "exec"), scope)
    exec(compile("\n\ndef stage():\n    return helper()\n\n\ndef direct():\n"
                 "    return call_site(sys._getframe())\n",
                 os.path.join(pkg, "pipeline", "flatten.py"), "exec"), scope)
    assert scope["stage"]() == "pipeline/flatten.py:4 (shim)"
    assert scope["direct"]() == "pipeline/flatten.py:8"
    assert tp.call_site(sys._getframe()) is None  # a test file is outside the package


def test_torch_device_trace_on_the_cpu_records_call_sites(tmp_path):
    """A capture around a frame on the CPU: no device, so no device table,
    and every torch call of the package inside a span of its call site."""
    import torch

    from jello_tpu_torch.cuda import Renderer
    from jello_tpu_torch.scenes import GATE_SCENES

    if torch.cuda.is_available():
        pytest.skip("holds the CPU-only capture")
    r = Renderer(device="cpu")
    scene, params = GATE_SCENES[1]()
    r.render_device(scene, params)
    p = tp.Profiler()
    with p.device_trace(str(tmp_path)):
        with p.start("frame"):
            r.render_device(scene, params)
    assert [x.label for x in p.collect()] == ["frame"]
    assert tx.attribute(str(tmp_path)) == {}
    names = {e["name"] for e in tx.load_trace(str(tmp_path)) if e.get("cat") == "user_annotation"}
    assert {"flatten", "path_count", "coarse", "fine"} <= names
    sites = {n[len(tp.SOURCE_PREFIX):] for n in names if n.startswith(tp.SOURCE_PREFIX)}
    assert any(s.startswith("pipeline/flatten.py:") for s in sites)
    assert any(s.endswith(" (shim)") for s in sites)
    assert not any(s.startswith("pipeline/ops.py") for s in sites)


def test_torch_union_ms_matches_jello_tpu():
    rng = np.random.default_rng(9)
    for n in (0, 1, 7, 200):
        starts = rng.integers(0, 10**9, n)
        spans = [(int(s), int(s + d)) for s, d in zip(starts, rng.integers(0, 10**8, n))]
        assert tx.union_ms(spans) == jx.union_ms(spans)


def test_torch_profiler_result_pretty_matches_jello_tpu():
    def tree(mod):
        return mod.ProfilerResult("frame", 0.0, 0.0123, [
            mod.ProfilerResult("flatten", 0.0, 0.004),
            mod.ProfilerResult("fine", 0.004, 0.0061,
                               [mod.ProfilerResult("kernel B", 0.004, 0.0005)])])

    assert tree(tp).pretty() == tree(jp).pretty()
