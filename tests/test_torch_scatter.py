"""Kernel K (the drop scatter, `csrc/scatter.cu`) and its wrapper
`cuda/scatter.py::drop_scatter`, the route of `ops.scatter_set`,
`scatter_add`, `scatter_max` and `scatter_min`.

On the CPU: the wrapper's checks (its CPU route, the plain version, is
held to the drop contract in `test_torch_stages.py`). On the card (marker
`cuda`, skipped where torch sees no GPU): kernel K against the plain
version bit for bit (a float max up to the sign of a zero) on the
adversarial cases, on random and sorted indices, on rows too unaligned
for vectors, at the shapes of path_count's residual-bump scatter and of
flatten's path boxes, inside a captured graph, and once a scatter call
of a rendered scene.
"""

import numpy as np
import pytest
import torch

from jello_tpu_torch.cuda import scatter as kscatter
from jello_tpu_torch.pipeline import ops

from . import scatter_cases as sc


@pytest.mark.parametrize("case", [
    ("add", torch.float32, (4,), torch.int32, "op 'add' on torch.float32"),
    ("min", torch.float32, (4,), torch.int32, "op 'min' on torch.float32"),
    ("max", torch.int64, (4,), torch.int32, "op 'max' on torch.int64"),
    ("mul", torch.int32, (4,), torch.int32, "op 'mul'"),
    ("set", torch.int32, (), torch.int32, "0-dim"),
    ("set", torch.int32, (4,), torch.float32, "idx: expected an int32 or int64 vector"),
    ("set", torch.int32, (4,), "2d", "idx: expected an int32 or int64 vector"),
])
def test_torch_drop_scatter_rejects_bad_inputs(case):
    op, dtype, shape, idx_dtype, msg = case
    target = torch.zeros(shape, dtype=dtype)
    idx = (torch.zeros((2, 2), dtype=torch.int32) if idx_dtype == "2d"
           else torch.zeros(2, dtype=idx_dtype))
    with pytest.raises(ValueError, match=msg):
        kscatter.drop_scatter(target, idx, torch.zeros(2, dtype=dtype), op)


# ---- on the card --------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _held(target, idx, values, op):
    """Kernel K on CUDA copies of the inputs (CPU tensors) against the
    plain version on the CPU: one launch; the target left as it was."""
    t, i, v = (a.cuda() for a in (target, idx, values))
    n0 = kscatter.drop_scatter.launches
    got = kscatter.drop_scatter(t, i, v, op)
    assert kscatter.drop_scatter.launches == n0 + 1
    assert got.shape == target.shape and got.dtype == target.dtype and got.is_contiguous()
    assert torch.equal(t.cpu(), target)
    want = ops.drop_scatter_plain(target, idx, values, op).numpy()
    sc.assert_held(got, want, op, idx.numpy(), values.numpy())


def _random_case(rng, op, dtype, width, idx_dtype, n, m, sorted_runs):
    """Random indices in [-50, n + 50), or sorted runs of one target with
    a tenth of the entries dropped; a set's in-range targets distinct."""
    row = () if width == 1 else (width,)
    if op == "set":
        idx = rng.permutation(n + m)[:m] - 25
    elif sorted_runs:
        idx = np.sort(rng.integers(0, n, m))
        idx[rng.random(m) < 0.1] = n
    else:
        idx = rng.integers(-50, n + 50, m)
    target = torch.from_numpy(sc.case("mixed", op, dtype, width, idx_dtype, n=n, m=1)[0])
    values = torch.from_numpy(sc._values(rng, (m,) + row, op, dtype))
    return target, torch.from_numpy(idx.astype(idx_dtype)), values


@pytest.mark.cuda
@pytest.mark.parametrize("op,dtype", sc.OP_DTYPES)
def test_torch_drop_scatter_kernel_matches_plain(cuda, op, dtype):
    """Every op and dtype at row widths 1, 2, 3 (no vectors), 4, 8 and 16
    and int32 and int64 indices: the adversarial cases, random and sorted
    indices over 200,000 entries, and values too unaligned for vectors."""
    rng = np.random.default_rng(len(op) * 7 + len(dtype))
    for width in sc.WIDTHS + [3, 8]:
        for idx_dtype in sc.IDX_DTYPES:
            for name in sc.CASES:
                _held(*sc.to_torch(*sc.case(name, op, dtype, width, idx_dtype)), op)
            for sorted_runs in (False, True):
                _held(*_random_case(rng, op, dtype, width, idx_dtype, 5000, 200_000,
                                    sorted_runs), op)
            target, idx, values = sc.to_torch(*sc.case("mixed", op, dtype, width, idx_dtype))
            flat = torch.empty(values.numel() + 1, dtype=values.dtype, device=cuda)
            shifted = flat[1:].view(values.shape)
            shifted.copy_(values.cuda())
            n0 = kscatter.drop_scatter.launches
            got = kscatter.drop_scatter(target.cuda(), idx.cuda(), shifted, op)
            assert kscatter.drop_scatter.launches == n0 + 1
            want = ops.drop_scatter_plain(target, idx, values, op).numpy()
            sc.assert_held(got, want, op, idx.numpy(), values.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["residual_dump_bin", "residual_dropped", "path_boxes"])
def test_torch_drop_scatter_kernel_at_frame_shapes(cuda, shape):
    """path_count's residual-bump scatter (4,194,304 entries, 95% parked on
    the dump bin T of a [T + 1] target with value 0, or out of range) and
    flatten's path boxes (1.6M lines in sorted runs of one path over
    65,536 [4] float rows, -1e30 fill, a tenth of the lines invalid)."""
    rng = np.random.default_rng(7)
    if shape == "path_boxes":
        n, m = 65536, 1_600_000
        idx = np.sort(rng.integers(0, 50_192, m))
        idx[rng.random(m) < 0.1] = n
        target = torch.full((n, 4), -1e30, dtype=torch.float32)
        values = torch.from_numpy((rng.standard_normal((m, 4)) * 800).astype(np.float32))
        _held(target, torch.from_numpy(idx.astype(np.int32)), values, "max")
        return
    T, m = 400_000, 4 << 20
    idx = np.full(m, T if shape == "residual_dump_bin" else T + 1, np.int64)
    bump = rng.random(m) < 0.05
    idx[bump] = rng.integers(0, T, int(bump.sum()))
    values = np.where(bump, rng.integers(-1, 2, m), 0)
    _held(torch.zeros(T + 1, dtype=torch.int32), torch.from_numpy(idx.astype(np.int32)),
          torch.from_numpy(values.astype(np.int32)), "add")


@pytest.mark.cuda
def test_torch_drop_scatter_kernel_replays_in_a_captured_graph(cuda):
    """Kernel K captured into a CUDA graph (its output from the graph's
    pool) and replayed on new indices and values equals the eager call on
    them; a replay counts no launch."""
    rng = np.random.default_rng(3)
    first, second = (_random_case(rng, "max", "float32", 4, "int32", 5000, 100_000, True)
                     for _ in range(2))
    target, idx, values = (a.cuda() for a in first)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kscatter.drop_scatter(target, idx, values, "max")
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = kscatter.drop_scatter(target, idx, values, "max")
    for static, new in zip((target, idx, values), second):
        static.copy_(new)
    n0 = kscatter.drop_scatter.launches
    graph.replay()
    torch.cuda.synchronize()
    assert kscatter.drop_scatter.launches == n0
    want = kscatter.drop_scatter(target, idx, values, "max")
    assert torch.equal(out.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("config", [3, 4])
def test_torch_scene_scatters_launch_kernel_k_once_each(cuda, monkeypatch, config):
    """Rendering a scene on the card (its eager frames and the capture of
    its program) launches kernel K once for each `ops.scatter_*` call, and
    the settled program's graph holds no torch scatter."""
    from jello_tpu_torch.cuda.program import graph_ops
    from jello_tpu_torch.cuda.render import Renderer
    from jello_tpu_torch.scenes import GATE_SCENES

    calls = []
    scatter = ops._scatter

    def spy(target, idx, values, op):
        calls.append(op)
        return scatter(target, idx, values, op)

    monkeypatch.setattr(ops, "_scatter", spy)
    scene, params = GATE_SCENES[config]()
    r = Renderer(device="cuda")
    n0 = kscatter.drop_scatter.launches
    for _ in range(8):
        r.render_surface(scene, params)
        if r._program is not None:
            break
    assert r._program is not None and r._program.graph is not None
    assert calls and kscatter.drop_scatter.launches - n0 == len(calls)
    nodes = graph_ops(r._program.graph)
    assert not [k for k in nodes if "scatter_gather" in k]
    assert sum(v for k, v in nodes.items() if "drop_scatter_kernel" in k) > 0
