"""The expand route of jello_tpu_torch (kernels D and E/E'/E'' through
their plain versions, what the wrappers run on CPU tensors) vs
jello_tpu's Pallas kernels in interpret mode, and the route at stage
level (the one route of the port's geometry stages) vs the numpy oracle.

Tolerances: the expansion contract, line counts, paths, tile slots and
bumps are exact. Euler line end points: 2e-3, the JAX package's own
tolerance for its kernel (tests/test_expand_pallas.py; jello_tpu's
kernel uses its Mosaic transcendental shims, the port pmath). Tile
segments: 1e-5 plus 1e-6 relative (jello_tpu clips in float32, the
port in float64 like the oracle). At stage level the route is held bit for bit.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import jello_tpu as jt
from jello_tpu.pipeline import tiling as np_tiling
from jello_tpu.renderer.params import RenderParams
from jello_tpu.tpu.expand_pallas import (
    EXPAND_CHUNK,
    _crossing_compute,
    _euler_compute,
    _row_compute,
    build_expand_table,
    make_expand_call,
)
from jello_tpu.tpu.lockstep_pallas import make_lockstep_call

from jello_tpu_torch.cuda import expand as kx
from jello_tpu_torch.cuda import lockstep as kwalk
from jello_tpu_torch.cuda.render import upload
from jello_tpu_torch.pipeline import expand, flatten, tiling
from jello_tpu_torch.pipeline.ops import F64
from jello_tpu_torch.pipeline.render import geometry

from .test_torch_stages import SCENES, _both
from .torch_reference import (
    EXPAND_CASES,
    as_np,
    expand_counts,
    numpy_geometry,
    prepare,
    tree_to_torch,
)

IDENT = jt.Affine.identity()
LINE_TOL = 2e-3
SEG_TOL = 1e-5
# jello_tpu clips segments in float32, whose ulp is ~1e-6 at 8-16 px, and
# its cancellations (x0 + dx * (y - y0) / dy) leave it up to ~10 ulps
# from the port's float64 (1.08e-5 at 11.3 px measured here).
SEG_RTOL = 1e-6


def _jax_expand(cols, counts, out_cap, compute, n_out, assume_compact=False):
    """jello_tpu's expand sweep, one sub-chunk per grid step (sub=1)."""
    tab, ws, total, n_chunks = build_expand_table(
        jnp, [jnp.asarray(c, dtype=jnp.float32) for c in cols], jnp.asarray(counts),
        out_cap, assume_compact=assume_compact)
    call = make_expand_call(len(cols), n_out, n_chunks, compute, interpret=True, sub=1)
    return np.asarray(call(ws, tab)), int(total)


@pytest.mark.parametrize("assume_compact, case", [
    pytest.param(False, "toy", id="False"),
    pytest.param(True, "toy", id="True"),
    *[pytest.param(compact, case, id=f"{case}-{'compact' if compact else 'clamp'}")
      for case in EXPAND_CASES for compact in (False, True)],
])
def test_torch_expand_contract_matches_jax(assume_compact, case):
    """Owner, within and valid of every output slot equal jello_tpu's, on
    the toy of tests/test_expand_pallas.py and on the edge shapes the
    kernel's per-CTA window must get right (`torch_reference.
    expand_counts`; under assume_compact the zero counts trail, as
    jello_tpu's window requires). jello_tpu expands into a multiple of
    its chunk; a ragged out_cap is compared on its first out_cap slots."""
    rng = np.random.default_rng(3)
    if case == "toy":
        counts = rng.integers(0, 6, 50).astype(np.int32)
        if assume_compact:
            counts = np.concatenate([np.maximum(counts[:40], 1), np.zeros(10, np.int32)])
        out_cap = 512
    else:
        counts, out_cap = expand_counts(case, assume_compact)
    vals = rng.standard_normal(counts.shape[0]).astype(np.float32)

    def compute(p, j, within, valid):
        return [p(0) * valid, within * valid, valid]

    jax_cap = -(-out_cap // EXPAND_CHUNK) * EXPAND_CHUNK
    want, total = _jax_expand([vals], counts, jax_cap, compute, 3, assume_compact)
    c = torch.from_numpy(counts)
    incl, got_total = expand.expand_prefix(c, assume_compact)
    own, within, valid = expand.expand_owner(incl, c, out_cap)
    assert int(got_total) == total
    assert (total > out_cap) == (case == "over-cap")
    vf = valid.to(torch.float32)
    got = np.stack([(torch.from_numpy(vals)[own] * vf).numpy(),
                    (within.to(torch.float32) * vf).numpy(), vf.numpy()])
    np.testing.assert_array_equal(got, want[:, :out_cap])


def _curvy_and_stroke():
    """The curvy fill and the stroked wavy path of
    tests/test_expand_pallas.py (the stroke gives offset != 0)."""
    s = jt.Scene()
    s.fill(jt.Fill.NON_ZERO, IDENT, jt.SolidBrush(jt.Color.rgba(1, 0, 0, 1)), None,
           jt.BezPath().move_to(30, 40).cubic_to(90, 10, 150, 220, 200, 240).close())
    st = jt.Stroke(width=6.0, join=jt.Join.ROUND, start_cap=jt.Cap.ROUND,
                   end_cap=jt.Cap.ROUND)
    s.stroke(st, IDENT, jt.SolidBrush(jt.Color.rgba(0, 0.5, 0, 1)), None,
             jt.BezPath().move_to(20, 200).cubic_to(80, 120, 160, 260, 240, 180))
    return s, RenderParams(width=256, height=256, base_color=jt.Color.rgba(1, 1, 1, 1))


@functools.lru_cache(maxsize=None)
def _work_table(nw=128):
    """The scene's lockstep work table, as the port's flatten builds it
    (its first nw rows; the live items come first)."""
    s, ld, ramps, caps = prepare(*_curvy_and_stroke())
    scene_t, layout_t, _, caps_t = upload(s, ld, ramps, caps, "cpu")
    seen = []
    walk = kwalk.lockstep_walk

    def spy(*args):
        seen.append(args)
        return walk(*args)

    kwalk.lockstep_walk = spy
    try:
        flatten.flatten_stage(scene_t, layout_t, caps_t)
    finally:
        kwalk.lockstep_walk = walk
    rows, valid, _ = seen[0]
    return rows[:nw].numpy(), valid[:nw].numpy(), caps["n_paths_cap"]


def test_torch_lockstep_records_match_jax():
    """The plain walk (what kernel D is held to, bit for bit, on the card)
    against jello_tpu's walk kernel in interpret mode on the same work
    table at IT = 4, where items end not done with records on all four
    iterations: every (t0, t1, n) record, line count and not-done flag
    equal."""
    table, valid, _ = _work_table()
    NW, C, IT = table.shape[0], 128, 4
    tab_in = np.zeros((C, 128), np.float32)
    tab_in[:NW, :21] = table
    tab_in[:NW, 21] = valid
    walked = np.asarray(make_lockstep_call(IT, 1, chunk=C, sub=1, interpret=True)(
        jnp.asarray(tab_in)))[:NW]
    rec, cnt, not_done, iters = kwalk.lockstep_walk(
        torch.from_numpy(table), torch.from_numpy(valid), IT)
    want_rec = np.stack([walked[:, 21 + k * IT:21 + (k + 1) * IT].T for k in range(3)])
    np.testing.assert_array_equal(rec.numpy(), want_rec)
    np.testing.assert_array_equal(cnt.numpy(), walked[:, 22 + 3 * IT])
    np.testing.assert_array_equal(not_done.numpy(), walked[:, 23 + 3 * IT] > 0)
    assert bool(not_done.any()) and int(iters) == IT
    assert bool((rec[2, IT - 1] != 0).any())


def test_torch_lockstep_and_euler_lines_match_jax():
    """D + E on the same [NW, 21] table: line counts, not-done flags,
    valid and path equal; end points within LINE_TOL."""
    table, valid, n_paths = _work_table()
    assert np.any(table[valid, 8] != 0.0)  # stroke offsets
    NW, IT, C = table.shape[0], 16, 128
    # jello_tpu: the walk kernel over one (C, 128) block, then the Euler
    # body over its expansion-ready table (lockstep_pallas.py:216-280,
    # sub=1), padded with the zero rows the walk leaves for zero input.
    tab_in = np.zeros((C, 128), np.float32)
    tab_in[:NW, :21] = table
    tab_in[:NW, 21] = valid
    walked = np.asarray(make_lockstep_call(IT, 1, chunk=C, sub=1, interpret=True)(
        jnp.asarray(tab_in)))
    Rp = -(-(NW + EXPAND_CHUNK + 32) // C) * C
    tab = np.concatenate([walked, np.zeros((Rp - C, 128), np.float32)])
    cnt_j = tab[:NW, 22 + 3 * IT]
    nd_j = tab[:NW, 23 + 3 * IT] > 0
    incl = np.cumsum(np.maximum(cnt_j.astype(np.int32), 1))
    EC = -(-int(incl[-1]) // EXPAND_CHUNK) * EXPAND_CHUNK
    tab[:, 21 + 3 * IT] = np.concatenate([incl, np.full(Rp - NW, 3e38)])
    starts = np.searchsorted(incl, np.arange(EC // EXPAND_CHUNK) * EXPAND_CHUNK,
                             side="right")
    ws = (np.maximum(starts - 8, 0) // 8 * 8).astype(np.int32)
    call = make_expand_call(21 + 3 * IT, 6, EC // EXPAND_CHUNK,
                            _euler_compute(IT, n_paths), interpret=True, sub=1)
    out_j = np.asarray(call(jnp.asarray(ws), jnp.asarray(tab)))

    rec, cnt, not_done, iters = kwalk.lockstep_walk(
        torch.from_numpy(table), torch.from_numpy(valid), IT)
    np.testing.assert_array_equal(cnt.numpy(), cnt_j)
    np.testing.assert_array_equal(not_done.numpy(), nd_j)
    assert not nd_j.any() and 0 < int(iters) <= IT
    x0, y0, x1, y1, path, lvalid, total = kx.expand_euler(
        torch.from_numpy(table), rec, cnt.to(torch.int32), EC, n_paths)
    assert int(total) == int(incl[-1])
    v = out_j[5] > 0
    np.testing.assert_array_equal(lvalid.numpy(), v)
    np.testing.assert_array_equal(path.numpy(), out_j[4].astype(np.int32))
    diff = max(np.abs(g.numpy()[v] - out_j[k][v]).max() for k, g in enumerate((x0, y0, x1, y1)))
    print(f"largest end point difference from jello_tpu's kernel: {diff:.3e}")
    assert diff <= LINE_TOL


def _fill_and_triangle():
    """The two fills of tests/test_expand_pallas.py::test_path_count_pallas_matches_xla,
    and a third reaching past the left edge, whose lines there give
    backdrop rows."""
    s = jt.Scene()
    s.fill(jt.Fill.NON_ZERO, IDENT, jt.SolidBrush(jt.Color.rgba(0, 1, 0, 1)), None,
           jt.BezPath().move_to(-40, 50).line_to(70, 90).line_to(-25, 180).close())
    s.fill(jt.Fill.NON_ZERO, IDENT, jt.SolidBrush(jt.Color.rgba(1, 0, 0, 1)), None,
           jt.BezPath().move_to(30, 40).cubic_to(90, 10, 150, 220, 200, 240).close())
    s.fill(jt.Fill.EVEN_ODD, IDENT, jt.SolidBrush(jt.Color.rgba(0, 0, 1, 0.5)), None,
           jt.BezPath().move_to(10, 10).line_to(200, 30).line_to(60, 200).close())
    return s, RenderParams(width=256, height=256, base_color=jt.Color.rgba(1, 1, 1, 1))


def test_torch_tile_crossings_and_rows_match_jax():
    """E' and E'' on the same compacted path_count_params tables: tile
    slots, bumps, row slots and deltas equal; segments within SEG_TOL."""
    s, ld, _, caps = prepare(*_fill_and_triangle())
    ref = numpy_geometry(s, ld, caps)
    with np.errstate(all="ignore"):
        P, n_cross, n_rows, _ = np_tiling.path_count_params(np, ref["fl"], ref["paths"], caps)
    P = P.astype(np.float32)  # both sides read the same float32 table
    T = caps["tiles_cap"]
    for counts, kind in ((n_cross, "cross"), (n_rows, "rows")):
        keep = counts > 0
        assert keep.sum() > 2, kind
        Pc = P[keep]
        cnt = counts[keep].astype(np.int32)
        pad = -(-len(cnt) // 64) * 64 - len(cnt)
        Pc = np.concatenate([Pc, np.zeros((pad, 21), np.float32)])
        cnt = np.concatenate([cnt, np.zeros(pad, np.int32)])
        cap = -(-int(cnt.sum()) // EXPAND_CHUNK) * EXPAND_CHUNK
        if kind == "cross":
            want, _ = _jax_expand(list(Pc.T), cnt, cap, _crossing_compute(T), 8, True)
            slot, seg, bslot, bdelta, total = kx.expand_crossings(
                torch.from_numpy(Pc).to(F64), torch.from_numpy(cnt), cap, T)
            assert int(total) == int(cnt.sum())
            for got, k in ((slot, 0), (bslot, 6), (bdelta, 7)):
                np.testing.assert_array_equal(got.numpy(), want[k].astype(np.int32))
            for k, name in enumerate(tiling.SEG_KEYS):
                np.testing.assert_allclose(seg[name].numpy(), want[1 + k], rtol=SEG_RTOL,
                                           atol=SEG_TOL)
        else:
            cols = np.ascontiguousarray(Pc[:, tiling.ROW_COLS])
            want, _ = _jax_expand(list(cols.T), cnt, cap, _row_compute(T), 2, True)
            r_slot, r_delta, _ = kx.expand_rows(torch.from_numpy(cols).to(F64),
                                                torch.from_numpy(cnt), cap, T)
            np.testing.assert_array_equal(r_slot.numpy(), want[0].astype(np.int32))
            np.testing.assert_array_equal(r_delta.numpy(), want[1].astype(np.int32))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_torch_flatten_expand_route_matches_plain_route(name, monkeypatch):
    """The line stream flatten_stage lays out (the route every frame
    takes) against the oracle's (jello_tpu's plain-array route): the
    Euler block's valid lines and then the simple and arc block's, each
    in the oracle's order and on the oracle's paths; the Euler block's
    e_total is the oracle's plus one dead slot per zero-count work row
    (the expansion's clamp), all inside it, and e_real is the oracle's;
    no overflow, and the walk's iterations equal."""
    ref, scene_t, layout_t, caps = _both(name)
    fl = ref["fl"]
    counts = []
    euler = kx.expand_euler

    def spy(table, rec, count, *args):
        counts.append(count)
        return euler(table, rec, count, *args)

    monkeypatch.setattr(kx, "expand_euler", spy)
    g = flatten.flatten_stage(scene_t, layout_t, caps)
    (count,) = counts
    EC = caps["euler_line_cap"]
    dead = int((count == 0).sum())
    assert dead > 0
    assert int(g["e_real"]) == int(count.sum()) == int(fl["e_total"])
    assert int(g["e_total"]) == int(fl["e_total"]) + dead
    v, gv = fl["line_valid"], as_np(g["line_valid"])
    assert not gv[int(g["e_total"]):EC].any()
    for lo, hi in ((0, EC), (EC, None)):
        np.testing.assert_array_equal(as_np(g["line_path"])[lo:hi][gv[lo:hi]],
                                      fl["line_path"][lo:hi][v[lo:hi]])
        for k in ("line_x0", "line_y0", "line_x1", "line_y1"):
            np.testing.assert_allclose(as_np(g[k])[lo:hi][gv[lo:hi]], fl[k][lo:hi][v[lo:hi]],
                                       rtol=1e-5, atol=LINE_TOL, err_msg=k)
    assert int(gv[:EC].sum()) == int(fl["e_total"])
    assert int(g["lockstep_iters"]) == int(fl["lockstep_iters"])
    assert not bool(fl["overflow"]) and not bool(g["overflow"])


@pytest.mark.parametrize("force_resid", [False, True])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_torch_path_count_expand_route_matches_numpy(name, force_resid):
    """path_count (jello_tpu's expand route, the port's one) lands on the
    oracle exactly, and the same again when the residual bump branch is
    forced."""
    ref, _, _, caps = _both(name)
    lines = tree_to_torch({k: ref["fl"][k] for k in (
        "line_x0", "line_y0", "line_x1", "line_y1", "line_path", "line_valid")})
    c = ref["counted"]
    gc = tiling.path_count(lines, tree_to_torch(ref["paths"]),
                           dict(caps, _pc_force_resid=force_resid))
    T = caps["tiles_cap"]
    s_want, s_got = c["sorted_slot"], as_np(gc["sorted_slot"])
    n = int((s_want < T).sum())
    assert int((s_got < T).sum()) == n
    np.testing.assert_array_equal(s_got[:n], s_want[:n])
    for k in ("seg_start", "seg_count", "backdrop", "row_of_slot"):
        np.testing.assert_array_equal(as_np(gc[k]), c[k])
    for k in tiling.SEG_KEYS:
        np.testing.assert_array_equal(as_np(gc["segs"][k])[:n], c["segs"][k][:n])
    for k in ("n_rows", "real_cross", "real_bd_rows", "real_cross_lines", "real_bd_lines"):
        assert int(gc[k]) == int(c[k]), k
    assert int(gc["n_segs"]) == int(c["real_cross"])
    np.testing.assert_array_equal(as_np(gc["first_cum"])[:n], np.cumsum(
        np.diff(np.concatenate([[-1], s_want[:n]])) != 0))
    assert not bool(gc["overflow"])


def test_torch_euler_lines_stat_counts_real_lines():
    """stats["euler_lines"] feeds calibrate_caps' euler_line_cap, which
    adds the work rows itself: it is the oracle's Euler line count, not
    e_total with its dead slots."""
    ref, scene_t, layout_t, caps = _both("curvy")
    real = int(ref["fl"]["e_total"])
    stages, flags, stats = geometry(scene_t, layout_t, caps)
    assert not any(bool(v) for v in flags.values())
    assert stats["euler_lines"].item() == real
    assert int(stages["fl"]["e_total"]) > real
