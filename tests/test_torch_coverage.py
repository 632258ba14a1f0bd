"""The port's coverage stage (plain row sums on the CPU) vs
jello_tpu.pipeline.coverage.compute_area_rows under numpy, on the same
command and segment streams, its per-record output contract, and the one
place where its arithmetic leaves jello_tpu's on purpose (the regrouped
numerator under vertical edges), against a float64 oracle."""

import functools

import numpy as np
import pytest
import torch

import jello_tpu as jt
from jello_tpu.pipeline import coverage as np_cov
from jello_tpu.renderer.params import RenderParams
from jello_tpu.scenes import config1

from jello_tpu_torch.cuda.coverage import compute_area_rows, coverage_rows
from jello_tpu_torch.pipeline import coverage as cov

from .torch_reference import as_np, numpy_geometry, prepare, tree_to_torch

IDENT = jt.Affine.identity()
TOL = 1e-5


def _overlaps():
    """Overlapping fills of both rules, paths sharing tiles, a path
    covering whole tiles (backdrop-only, rowless records)."""
    s = jt.Scene()
    s.fill(jt.Fill.NON_ZERO, IDENT, jt.SolidBrush(jt.Color.rgba(1, 0, 0, 1)), None,
           jt.BezPath().move_to(2, 2).line_to(126, 4).line_to(124, 126).line_to(3, 120).close())
    s.fill(jt.Fill.EVEN_ODD, IDENT, jt.SolidBrush(jt.Color.rgba(0, 0, 1, 0.5)), None,
           jt.BezPath().move_to(30, 30).cubic_to(120, 0, 120, 128, 30, 100)
           .line_to(100, 60).line_to(20, 60).close())
    s.fill(jt.Fill.NON_ZERO, IDENT, jt.SolidBrush(jt.Color.rgba(0, 1, 0, 0.7)), None,
           jt.BezPath().move_to(60, 10).line_to(70, 10).line_to(70, 118).line_to(60, 118).close())
    return s, RenderParams(width=128, height=128, base_color=jt.Color.rgba(1, 1, 1, 1))


SCENES = {"overlaps": _overlaps, "config1": config1}


@functools.lru_cache(maxsize=None)
def _inputs(name):
    scene, params = SCENES[name]()
    s, ld, ramps, caps = prepare(scene, params)
    ref = numpy_geometry(s, ld, caps)
    with np.errstate(all="ignore"):
        want = np_cov.compute_area_rows(np, ref["cmds"], ref["counted"], caps)
    cmds = tree_to_torch({k: v for k, v in ref["cmds"].items()})
    counted = tree_to_torch(ref["counted"])
    return want, cmds, counted, caps


@pytest.mark.parametrize("name", sorted(SCENES))
def test_torch_coverage_matches_numpy(name):
    (area_w, ids_w, ovf_w), cmds, counted, caps = _inputs(name)
    area, ids, ovf = compute_area_rows(cmds, counted, caps)
    assert area.shape == area_w.shape and area.dtype == torch.float32
    np.testing.assert_array_equal(as_np(ids), ids_w)
    assert bool(ovf) == bool(ovf_w) is False
    assert np.abs(as_np(area) - area_w).max() <= TOL


@pytest.mark.parametrize("name", sorted(SCENES))
def test_torch_coverage_record_contract(name):
    _, cmds, counted, caps = _inputs(name)
    area, ids, _ = compute_area_rows(cmds, counted, caps)
    PC = cmds["tile"].shape[0]
    assert area.shape == (-(-PC // 8) * 8, 256) and ids.shape == (PC,)
    assert not torch.isnan(area).any()
    rowless = torch.cat([ids < 0, torch.ones(area.shape[0] - PC, dtype=torch.bool)])
    assert bool((area[rowless] == 0).all())
    has = ids >= 0
    assert torch.equal(ids[has], torch.nonzero(has).flatten().to(torch.int32))
    live = (cmds["tile"] < caps["tile_grid_cap"]) & (cmds["seg_count"] > 0)
    assert torch.equal(has, live)


def test_torch_coverage_rows_plain_row_ranges():
    """Row ranges select exactly their segments; empty rows get only the
    backdrop; segments outside every range add nothing."""
    rng = np.random.default_rng(3)
    n = 40
    seg = np.zeros((n, 8), np.float32)
    seg[:, 0:4] = rng.random((n, 4)) * 16
    seg[:, 4] = 1e9
    seg[:, 5] = 1.0
    stream = torch.from_numpy(seg)
    row_start = torch.tensor([0, 5, 5, 17, 0], dtype=torch.int32)
    row_end = torch.tensor([5, 5, 17, 30, 0], dtype=torch.int32)
    row_bd = torch.tensor([0.0, 2.0, -1.0, 0.0, 3.0])
    got = coverage_rows(stream, row_start, row_end, row_bd)
    contrib = cov.area_contrib(*(stream[:, k] for k in range(5)))
    for r in range(5):
        s, e = int(row_start[r]), int(row_end[r])
        want = contrib[s:e].sum(0) + row_bd[r]
        assert torch.allclose(got[r], want, atol=1e-5), r


def _area_numpy(seg, dtype, regrouped):
    """The area formula on vertical-edge segments [n, 5] in `dtype`, the
    numerator summed as jello_tpu's kernels do (b + (d^2 - c^2)/2 - xmin)
    or regrouped as the port does ((b - xmin) + (d - c)(d + c)/2)."""
    sx0, sy0, sx1, sy1, sye = (seg[:, k].astype(dtype)[:, None] for k in range(5))
    p = np.arange(256)
    lx, ly = (p % 16).astype(dtype)[None, :], (p // 16).astype(dtype)[None, :]
    one, zero, half, eps = (dtype(v) for v in (1.0, 0.0, 0.5, 1.0e-6))
    dx, dy = sx1 - sx0, sy1 - sy0
    y = sy0 - ly
    y0c, y1c = np.clip(y, zero, one), np.clip(y + dy, zero, one)
    dyc = y0c - y1c
    safe_dy = np.where(dy == zero, one, dy)
    startx = sx0 - lx
    x0 = startx + (y0c - y) / safe_dy * dx
    x1 = startx + (y1c - y) / safe_dy * dx
    xmin0, xmax0 = np.minimum(x0, x1), np.maximum(x0, x1)
    xmin = np.minimum(xmin0, one) - eps
    b = np.minimum(xmax0, one)
    cc, d = np.maximum(b, zero), np.maximum(xmin, zero)
    if regrouped:
        num = (b - xmin) + half * ((d - cc) * (d + cc))
    else:
        num = (b + half * (d * d - cc * cc)) - xmin
    a = num / (xmax0 - xmin)
    contrib = np.where(dyc != zero, a * dyc, zero)
    return contrib + np.sign(dx) * np.clip(ly - sye + one, zero, one)


def test_torch_coverage_vertical_edges_keep_the_regrouped_numerator():
    """Where the port leaves jello_tpu's arithmetic on purpose. Under a
    vertical edge at a fractional x the area quotient is ~1e-6 over
    ~1e-6; jello_tpu's float32 grouping of the numerator cancels there
    and lands percent off the float64 oracle, the port's regrouping
    stays at rounding error. Both errors are measured on the same stream
    so that a later regrouping back shows here."""
    rng = np.random.default_rng(11)
    n = 64
    x = (rng.integers(0, 16, n) + rng.uniform(0.05, 0.95, n)).astype(np.float32)
    seg = np.zeros((n, 5), np.float32)
    seg[:, 0] = seg[:, 2] = x
    seg[:, 1], seg[:, 3] = 0.0, 16.0  # top to bottom of the tile
    seg[:, 4] = 1e9
    oracle = _area_numpy(seg, np.float64, regrouped=False)
    assert np.abs(_area_numpy(seg, np.float64, regrouped=True) - oracle).max() <= 1e-9
    err_old = np.abs(_area_numpy(seg, np.float32, regrouped=False) - oracle).max()
    err_numpy = np.abs(_area_numpy(seg, np.float32, regrouped=True) - oracle).max()
    got = cov.area_contrib(*(torch.from_numpy(seg[:, k].copy()) for k in range(5)))
    err_port = np.abs(as_np(got).astype(np.float64) - oracle).max()
    print(f"vertical edges: jello_tpu's grouping {err_old:.3e}, regrouped {err_numpy:.3e}, "
          f"area_contrib {err_port:.3e} from the float64 oracle")
    assert err_old > 5e-3  # the fault that the regrouping removes
    assert err_numpy <= 1e-6 and err_port <= 1e-6
