"""Kernel J (the per-line DDA table, `csrc/line_dda.cu`) and its wrapper
`cuda/line_dda.py::line_tables`.

On the CPU: the wrapper's checks, and its CPU route (the plain torch
chain of `pipeline/tiling.py::line_dda_clip`) against jello_tpu's numpy
oracle on an adversarial line set. On the card (marker `cuda`, skipped
where torch sees no GPU): kernel J against that plain version bit for bit
on the same set and on the lines of config 5 and of the benchmark's
`motionmark_paths`, inside a captured graph, and once a path_count.
"""

import numpy as np
import pytest
import torch

from jello_tpu_torch.cuda import line_dda
from jello_tpu_torch.pipeline import tiling
from jello_tpu_torch.pipeline.render import geometry

from .torch_reference import as_np, tree_to_torch

# Tile rects (x0, y0, x1, y1, in tiles) of the set's paths: an interior
# rect, one at the grid's origin, one of zero width (stride 0) and a large
# one; tile offsets are the exclusive prefix of their areas.
RECTS = [(2, 3, 7, 9), (0, 0, 5, 4), (4, 4, 4, 8), (1, 2, 40, 30)]


def _path_lines(X0, Y0, X1, Y1):
    """Lines (x0, y0, x1, y1, in pixels) against one path's pixel bbox."""
    return [
        (X0 + 3.5, Y0 + 20, X1 - 2, Y0 + 20),  # horizontal
        (X0 + 1, Y0 + 32, X1 - 1, Y0 + 32),  # horizontal on a tile edge
        (X0, Y0, X1, Y0),  # along the bbox's top edge
        (X0 + 20, Y0 + 1, X0 + 20, Y1 - 3),  # vertical
        (X0 + 32, Y0 + 2, X0 + 32, Y1 - 2),  # vertical on a tile edge
        (X0, Y0 + 5, X0, Y1 - 5),  # on the left edge
        (X1, Y0 + 5, X1, Y1 - 5),  # on the right edge
        (X0 + 17, Y0 + 17, X0 + 17, Y0 + 17),  # zero length
        (X0 + 32, Y0 + 32, X0 + 32, Y0 + 32),  # zero length on a tile corner
        (X0 + 16, Y0 + 16, X0 + 48, Y0 + 64),  # ends on tile corners
        (X0, Y0, X1, Y1),  # corner to corner
        (X0 - 16, Y0 - 16, X1 + 16, Y1 + 16),  # through tile corners
        (X0 - 30, Y0 + 5, X0 - 10, Y1 - 5),  # wholly left
        (X1 + 5, Y0 + 5, X1 + 40, Y1 - 3),  # wholly right
        (X0 + 5, Y0 - 40, X1 - 5, Y0 - 3),  # wholly above
        (X0 + 5, Y1 + 3, X1 - 5, Y1 + 50),  # wholly below
        (X0 - 25.3, Y0 + 7.1, X1 + 13.7, Y1 - 9.2),  # across, left to right
        (X0 + 9.9, Y0 - 20.5, X1 - 3.1, Y1 + 17.25),  # across, top to bottom
        (X0 - 40, Y1 - 1, X0 + 21.5, Y0 + 3.25),  # in from the left
        (X1 + 33, Y0 + 2, X1 - 7.75, Y1 - 11),  # in from the right
        (X0 - 5, Y0 + 8.001, X1 + 5, Y0 + 8.0),  # nearly horizontal
        (X0 + 8.0, Y0 - 5, X0 + 8.0001, Y1 + 5),  # nearly vertical
        (X0 + 0.5, Y0 - 0.25, X0 + 15.75, Y0 + 0.25),  # inside one tile row
    ]


def adversarial_set(seed=0, n_random=400):
    """(lines, paths) as numpy arrays: every line of `_path_lines` against
    every path, in both directions, then `n_random` lines near the paths
    (half their ends on the tile grid), some marked invalid, some with
    path indices past either end (clamped)."""
    rng = np.random.default_rng(seed)
    area = [(x1 - x0) * (y1 - y0) for x0, y0, x1, y1 in RECTS]
    offsets = np.concatenate([[0], np.cumsum(area)[:-1]])
    rows, path = [], []
    for p, (x0, y0, x1, y1) in enumerate(RECTS):
        for ln in _path_lines(16 * x0, 16 * y0, 16 * x1, 16 * y1):
            rows += [ln, (ln[2], ln[3], ln[0], ln[1])]
            path += [p, p]
    for _ in range(n_random):
        p = int(rng.integers(len(RECTS)))
        x0, y0, x1, y1 = (16 * v for v in RECTS[p])
        xy = rng.uniform([x0 - 40, y0 - 40] * 2, [x1 + 40, y1 + 40] * 2)
        if rng.random() < 0.5:
            xy = np.round(xy / 16) * 16 if rng.random() < 0.5 else np.round(xy * 4) / 4
        rows.append(tuple(xy))
        path.append(p)
    xy = np.asarray(rows, dtype=np.float32)
    path = np.asarray(path, dtype=np.int32)
    valid = rng.random(len(path)) > 0.1
    clamped = rng.random(len(path)) < 0.05
    path = np.where(clamped, np.where(rng.random(len(path)) < 0.5, len(RECTS) + 3, -2), path)
    lines = {"line_x0": xy[:, 0], "line_y0": xy[:, 1], "line_x1": xy[:, 2],
             "line_y1": xy[:, 3], "line_valid": valid, "line_path": path.astype(np.int32)}
    r = np.asarray(RECTS, dtype=np.int32)
    paths = {"rect_x0": r[:, 0], "rect_y0": r[:, 1], "rect_x1": r[:, 2], "rect_y1": r[:, 3],
             "tile_offset": offsets.astype(np.int32)}
    return lines, paths


def _torch_set(device="cpu", seed=0):
    lines, paths = adversarial_set(seed)
    return ({k: v.to(device) for k, v in tree_to_torch(lines).items()},
            {k: v.to(device) for k, v in tree_to_torch(paths).items()})


def _bad(case):
    """An adversarial set with one input made wrong."""
    lines, paths = _torch_set()
    L, D = lines["line_x0"].shape[0], paths["rect_x0"].shape[0]
    wrong = {
        "x0_float64": ("line_x0", lines["line_x0"].double()),
        "valid_uint8": ("line_valid", lines["line_valid"].to(torch.uint8)),
        "path_int64": ("line_path", lines["line_path"].long()),
        "rect_float32": ("rect_y1", paths["rect_y1"].float()),
        "offset_int64": ("tile_offset", paths["tile_offset"].long()),
        "short_y1": ("line_y1", lines["line_y1"][:L - 1]),
        "x0_matrix": ("line_x0", lines["line_x0"].reshape(1, L)),
        "x1_strided": ("line_x1", torch.stack([lines["line_x1"]] * 2, 1)[:, 0]),
        "x1_meta": ("line_x1", torch.empty(L, dtype=torch.float32, device="meta")),
        "long_rect_x1": ("rect_x1", torch.zeros(D + 1, dtype=torch.int32)),
        "no_paths": ("rect_x0", torch.zeros(0, dtype=torch.int32)),
    }
    key, value = wrong[case]
    (lines if key.startswith("line_") else paths)[key] = value
    return lines, paths


BAD_CASES = ["x0_float64", "valid_uint8", "path_int64", "rect_float32", "offset_int64",
             "short_y1", "x0_matrix", "x1_strided", "x1_meta", "long_rect_x1", "no_paths"]


@pytest.mark.parametrize("case", BAD_CASES)
def test_torch_line_tables_reject_bad_inputs(case):
    lines, paths = _bad(case)
    with pytest.raises(ValueError):
        line_dda.line_tables(lines, paths)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_torch_line_tables_cpu_route_matches_oracle(seed):
    """The wrapper's CPU route on the adversarial set against jello_tpu's
    numpy path_count_params: counts exact, P equal on the valid lines, and
    the row table P's ROW_COLS columns; no launch."""
    from jello_tpu.pipeline import tiling as np_tiling

    lines_np, paths_np = adversarial_set(seed)
    with np.errstate(all="ignore"):
        P_j, nc_j, nr_j, prt_j = np_tiling.path_count_params(np, lines_np, paths_np, {})
    lines, paths = _torch_set(seed=seed)
    n0 = line_dda.line_tables.launches
    P, PRT, n_cross, n_rows = line_dda.line_tables(lines, paths)
    assert line_dda.line_tables.launches == n0
    assert (P.dtype, PRT.dtype, n_cross.dtype, n_rows.dtype) == (
        torch.float64, torch.float64, torch.int32, torch.int32)
    np.testing.assert_array_equal(as_np(n_cross), np.asarray(nc_j))
    np.testing.assert_array_equal(as_np(n_rows), np.asarray(nr_j))
    # The set reaches every branch of the clip that it should.
    assert 0 < int((n_cross > 0).sum()) < n_cross.shape[0]
    assert 0 < int((n_rows > 0).sum()) < n_rows.shape[0]
    live = lines_np["line_valid"]
    np.testing.assert_array_equal(as_np(P)[live], np.asarray(P_j, dtype=np.float64)[live])
    assert torch.equal(PRT, P[:, tiling.ROW_COLS])
    for a, b in zip(prt_j, (PRT[:, i] for i in range(5))):
        np.testing.assert_array_equal(np.asarray(a, dtype=np.float64), as_np(b))


def test_torch_path_count_params_returns_the_tables_columns():
    """line_tables' P, counts and row table against jello_tpu's numpy
    path_count_params: the five backdrop-row columns, read in the
    oracle's own dtypes (ymin f64, tiles_base i32, bb1 f32, stride i32,
    delta i32, as the row expansion reads them), equal the oracle's and
    lose nothing to the cast."""
    from jello_tpu.pipeline import tiling as np_tiling

    lines_np, paths_np = adversarial_set(0)
    with np.errstate(all="ignore"):
        P_j, nc_j, nr_j, prt_j = np_tiling.path_count_params(np, lines_np, paths_np, {})
    lines, paths = _torch_set()
    P, PRT, n_cross, n_rows = line_dda.line_tables(lines, paths)
    np.testing.assert_array_equal(as_np(n_cross), np.asarray(nc_j))
    np.testing.assert_array_equal(as_np(n_rows), np.asarray(nr_j))
    live = lines_np["line_valid"]
    np.testing.assert_array_equal(as_np(P)[live], np.asarray(P_j, dtype=np.float64)[live])
    assert [np.asarray(c).dtype for c in prt_j] == [np.float64, np.int32, np.float32, np.int32,
                                                  np.int32]
    for i, c in enumerate(prt_j):
        c = np.asarray(c)
        got = as_np(PRT[:, i])
        np.testing.assert_array_equal(got.astype(c.dtype), c)
        np.testing.assert_array_equal(got.astype(c.dtype).astype(np.float64), got)


# ---- on the card --------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _settled(scene, params):
    """(scene, layout, caps) of one geometry pass of a scene on the card,
    at the class a renderer settles."""
    from jello_tpu_torch.cuda.render import Renderer
    from jello_tpu_torch.pipeline.render import unpack_layout

    r = Renderer(device="cuda")
    r.render(scene, params)
    prepared = r._prepare(scene, params)
    caps, _ = r._route(prepared, params, r._caps)
    return prepared[2][0], unpack_layout(prepared[2][1]), caps


def _scene_lines(scene, params, monkeypatch):
    """The (lines, paths) kernel J is given in one geometry pass of a scene
    at the class a renderer on the card settles."""
    scene_t, layout_t, caps = _settled(scene, params)
    calls = []
    fn = line_dda.line_tables

    def spy(lines, paths):
        calls.append((lines, paths))
        return fn(lines, paths)

    # The wrapper counts its launches on the module's name: the spy's.
    spy.launches = 0
    monkeypatch.setattr(line_dda, "line_tables", spy)
    geometry(scene_t, layout_t, caps)
    monkeypatch.undo()
    assert len(calls) == 1
    return calls[0]


def _config5(monkeypatch):
    from jello_tpu_torch.scenes import GATE_SCENES

    return _scene_lines(*GATE_SCENES[5](), monkeypatch)


def _motionmark(monkeypatch):
    import jello_tpu_torch as jt

    from .test_torch_motionmark import CFG, commands, gen

    cmds = gen.commands(CFG, 2**31 + 11)
    return _scene_lines(commands.build(jt, cmds), commands.params(jt, cmds), monkeypatch)


def _held(lines, paths):
    """Kernel J against its plain version on the card: counts and the row
    table on every line, P on every line with a crossing or a row; one
    launch."""
    n0 = line_dda.line_tables.launches
    got = line_dda.line_tables(lines, paths)
    assert line_dda.line_tables.launches == n0 + 1
    want = tiling.line_tables_plain(lines, paths)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape and g.is_contiguous()
    P, PRT, n_cross, n_rows = got
    assert torch.equal(n_cross, want[2]) and torch.equal(n_rows, want[3])
    assert torch.equal(PRT, want[1])
    live = (n_cross > 0) | (n_rows > 0)
    assert int(live.sum()) > 0
    assert torch.equal(P[live], want[0][live])
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["adversarial", "config5", "motionmark_paths"])
def test_torch_line_dda_kernel_matches_plain(cuda, monkeypatch, case):
    if case == "adversarial":
        for seed in (0, 1, 2):
            _held(*_torch_set(cuda, seed))
    else:
        _held(*(_config5 if case == "config5" else _motionmark)(monkeypatch))


@pytest.mark.cuda
def test_torch_line_dda_kernel_replays_in_a_captured_graph(cuda):
    """Kernel J captured into a CUDA graph and replayed on new lines equals
    the eager call on them; a replay counts no launch."""
    (lines, paths), (lines2, _) = _torch_set(cuda, 0), _torch_set(cuda, 1)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        line_dda.line_tables(lines, paths)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = line_dda.line_tables(lines, paths)
    for k, v in lines.items():
        v.copy_(lines2[k])
    n0 = line_dda.line_tables.launches
    graph.replay()
    torch.cuda.synchronize()
    assert line_dda.line_tables.launches == n0
    for g, w in zip(out, line_dda.line_tables(lines, paths)):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_torch_path_count_launches_kernel_j_once(cuda):
    """A geometry pass on the card runs path_count's per-line half as one
    launch of kernel J."""
    from jello_tpu_torch.scenes import GATE_SCENES

    scene_t, layout_t, caps = _settled(*GATE_SCENES[3]())
    n0 = line_dda.line_tables.launches
    geometry(scene_t, layout_t, caps)
    assert line_dda.line_tables.launches == n0 + 1
