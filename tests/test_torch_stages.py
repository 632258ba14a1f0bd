"""jello_tpu_torch's pipeline stages vs jello_tpu's under numpy, on the
same inputs: integer fields exactly, float fields with
allclose(rtol=1e-5, atol=1e-5)."""

import functools

import numpy as np
import pytest
import torch

import jello_tpu as jt
from jello_tpu import flatten_math as np_fm
from jello_tpu import pmath as np_pm
from jello_tpu.renderer.params import RenderParams
from jello_tpu.scenes import config1

from jello_tpu_torch import flatten_math as fm
from jello_tpu_torch import pmath as pm
from jello_tpu_torch.cuda.render import upload
from jello_tpu.pipeline import coarse as coarse_np
from jello_tpu_torch.pipeline import coarse, drawobjs, flatten, ops, tiling
from jello_tpu_torch.pipeline.pathtag import tag_monoid_scan
from jello_tpu_torch.pipeline.render import geometry

from . import scatter_cases
from .torch_reference import (
    as_np,
    check_flatten_lines,
    numpy_geometry,
    prepare,
    to_torch,
    tree_to_torch,
    u32,
)

IDENT = jt.Affine.identity()
RTOL = ATOL = 1e-5
# Euler line end points with the port's own cbrt: its exp/log seed is the
# one transcendental pmath cannot pin (numpy's float32 exp/log and
# torch's differ by an ulp in ~5% of inputs), and where the arclength
# map divides by a curvature k1 near its 1e-3 threshold that moves a
# point by up to ~1e-3 px. Fed the oracle's cbrt values, the port's end
# points are held to ATOL (test_torch_flatten_matches_numpy).
LINE_ATOL = 2e-3


def _fills():
    s = jt.Scene()
    s.fill(jt.Fill.NON_ZERO, IDENT, jt.SolidBrush(jt.Color.rgba(1, 0, 0, 0.8)), None,
           jt.BezPath().move_to(10, 10).cubic_to(80, 0, 120, 100, 60, 120).close())
    s.fill(jt.Fill.EVEN_ODD, IDENT, jt.SolidBrush(jt.Color.rgba(0, 0, 1, 0.5)), None,
           jt.BezPath().move_to(30, 30).line_to(120, 40).line_to(90, 110).close())
    s.fill(jt.Fill.NON_ZERO, jt.Affine.translate(20, 10) @ jt.Affine.scale(0.5),
           jt.SolidBrush(jt.Color.rgba(0, 1, 0, 1)), None,
           jt.BezPath().move_to(0, 0).quad_to(100, 0, 100, 100).line_to(0, 100).close())
    return s, RenderParams(width=128, height=128, base_color=jt.Color.rgba(1, 1, 1, 1))


def _curvy():
    """Many random cubics: exercises the Euler subdivision decisions."""
    rng = np.random.default_rng(5)
    s = jt.Scene()
    for _ in range(12):
        p = jt.BezPath().move_to(*(rng.random(2) * 128))
        for _ in range(4):
            p.cubic_to(*(rng.random(6) * 128))
        p.close()
        s.fill(jt.Fill.NON_ZERO, IDENT, jt.SolidBrush(jt.Color.rgba(*rng.random(3), 0.6)),
               None, p)
    return s, RenderParams(width=128, height=128, base_color=jt.Color.rgba(1, 1, 1, 1))


def _gradients():
    st = (jt.ColorStop(0.0, jt.Color.rgba(1, 0, 0, 1)),
          jt.ColorStop(0.4, jt.Color.rgba(0, 1, 0, 0.6)),
          jt.ColorStop(1.0, jt.Color.rgba(0, 0, 1, 1)))
    s = jt.Scene()
    s.fill(jt.Fill.NON_ZERO, IDENT, jt.GradientBrush(jt.LinearGradient((0, 0), (128, 0), st)),
           None, jt.BezPath().move_to(5, 5).line_to(120, 10).line_to(100, 120).close())
    s.fill(jt.Fill.NON_ZERO, IDENT,
           jt.GradientBrush(jt.RadialGradient((64, 64), 0.0, (64, 64), 50, st)), None,
           jt.BezPath().move_to(20, 60).line_to(110, 50).line_to(70, 115).close())
    s.fill(jt.Fill.NON_ZERO, IDENT, jt.GradientBrush(jt.SweepGradient((64, 64), 0.1, 0.9, st)),
           None, jt.BezPath().move_to(40, 20).line_to(90, 25).line_to(80, 70).close())
    return s, RenderParams(width=128, height=128, base_color=jt.Color.rgba(1, 1, 1, 1))


SCENES = {"fills": _fills, "curvy": _curvy, "gradients": _gradients, "config1": config1}


@functools.lru_cache(maxsize=None)
def _both(name):
    """numpy stage outputs and the inputs the port's stages share."""
    scene, params = SCENES[name]()
    s, ld, ramps, caps = prepare(scene, params)
    ref = numpy_geometry(s, ld, caps)
    scene_t, layout_t, _, caps_t = upload(s, ld, ramps, caps, "cpu")
    return ref, scene_t, layout_t, caps_t


def _exact(a, b):
    np.testing.assert_array_equal(np.asarray(a).astype(np.int64), as_np(b).astype(np.int64))


def _close(a, b):
    np.testing.assert_allclose(as_np(b), np.asarray(a), rtol=RTOL, atol=ATOL)


def test_torch_pmath_matches_numpy_bit_for_bit():
    rng = np.random.default_rng(0)
    x = np.concatenate([(rng.random(4000) - 0.5) * 40, (rng.random(1000) - 0.5) * 2.2,
                        [0.0, -0.0, 1.0, -1.0, np.pi, -np.pi / 2]]).astype(np.float32)
    y = ((rng.random(x.shape[0]) - 0.5) * 10).astype(np.float32)
    y[:50] = 0.0
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    with np.errstate(all="ignore"):
        for name in ("sin", "cos", "arctan"):
            got = getattr(pm, name)(tx).numpy()
            want = getattr(np_pm, name)(np, x)
            assert got.tobytes() == want.astype(np.float32).tobytes(), name
        assert pm.arctan2(ty, tx).numpy().tobytes() == np_pm.arctan2(np, y, x).tobytes()
        u = np.clip(x / 20, -1.2, 1.2).astype(np.float32)
        for name in ("arcsin", "arccos"):
            got = getattr(pm, name)(torch.from_numpy(u)).numpy()
            assert got.tobytes() == getattr(np_pm, name)(np, u).tobytes(), name
        np.testing.assert_allclose(pm.cbrt(tx).numpy(), np_pm.cbrt(np, x), rtol=1e-6)


def test_torch_espc_line_counts_match_numpy():
    """The subdivision count is a ceil of pmath values: it must agree
    exactly, or whole lines move."""
    rng = np.random.default_rng(1)
    n = 20000
    th0 = ((rng.random(n) - 0.5) * 3).astype(np.float32)
    th1 = ((rng.random(n) - 0.5) * 3).astype(np.float32)
    chord = (rng.random(n) * 200 + 0.01).astype(np.float32)
    offset = np.where(rng.random(n) < 0.5, 0.0, (rng.random(n) - 0.5) * 8).astype(np.float32)
    scale = (0.5 + rng.random(n) * 2).astype(np.float32)
    with np.errstate(all="ignore"):
        k0, k1, ch = np_fm.euler_params_from_angles(th0, th1)
        want = np_fm.espc_subdivision(np, k0, k1, ch, chord, offset, scale)[0]
    tk0, tk1, tch = fm.euler_params_from_angles(torch.from_numpy(th0), torch.from_numpy(th1))
    got = fm.espc_subdivision(tk0, tk1, tch, torch.from_numpy(chord),
                              torch.from_numpy(offset), torch.from_numpy(scale))[0]
    assert got.numpy().tobytes() == want.tobytes()


def test_torch_tag_monoid_matches_numpy():
    from jello_tpu.cpu.pathtag import tag_monoid_scan as np_scan

    tags = np.random.default_rng(2).integers(0, 256, 3000).astype(np.uint32)
    want = np_scan(tags)
    got = tag_monoid_scan(torch.from_numpy(tags.astype(np.int32)))
    for k, v in want.items():
        _exact(v, got[k])


def test_torch_ops_scatter_drop_and_sort_stability():
    tgt = torch.zeros(4, dtype=torch.int32)
    idx = torch.tensor([0, 3, 4, -1, 3])
    val = torch.tensor([1, 2, 5, 7, 3], dtype=torch.int32)
    assert ops.scatter_add(tgt, idx, val).tolist() == [1, 0, 0, 5]
    assert ops.scatter_max(tgt, idx, val).tolist() == [1, 0, 0, 3]
    assert ops.scatter_min(tgt, idx, -val).tolist() == [-1, 0, 0, -3]
    key = torch.tensor([2, 1, 2, 1, 0], dtype=torch.int32)
    sk, pay = ops.sort_multi(key, (torch.arange(5),))
    assert sk.tolist() == [0, 1, 1, 2, 2] and pay.tolist() == [4, 1, 3, 0, 2]
    v = torch.tensor([1, 2, 12, 1 << 31, 0x80000000 | 8], dtype=torch.int64)
    assert ops.trailing_zeros32(v).tolist() == [0, 1, 2, 31, 3]
    w = torch.tensor([ops.s32(0xF0000000)], dtype=torch.int32)
    assert ops.shr(w, 28).tolist() == [15]


@pytest.mark.parametrize("idx_dtype", scatter_cases.IDX_DTYPES)
@pytest.mark.parametrize("width", scatter_cases.WIDTHS)
@pytest.mark.parametrize("op,dtype", scatter_cases.OP_DTYPES)
def test_torch_ops_scatter_drop_contract(op, dtype, width, idx_dtype):
    """`ops.scatter_*` on CPU tensors (kernel K's plain version) against
    the drop contract entry by entry: negative and >= n indices dropped,
    every entry dropped, every entry on one in-range target, and repeated
    targets for add, max and min (a set's repeats keep one of the values);
    int32 sums wrap, a float max keeps a NaN."""
    fn = getattr(ops, f"scatter_{op}")
    for name in scatter_cases.CASES:
        target, idx, values = scatter_cases.case(name, op, dtype, width, idx_dtype)
        want = scatter_cases.reference(target, idx, values, op)
        t, i, v = scatter_cases.to_torch(target, idx, values)
        got = fn(t, i, v)
        assert torch.equal(t, torch.from_numpy(target)), "the target itself is left as it was"
        scatter_cases.assert_held(got, want, op, idx, values)


def _oracle_cbrt(x):
    """jello_tpu's cbrt (numpy's float32 exp/log seed) on a CPU tensor."""
    with np.errstate(all="ignore"):
        return torch.from_numpy(np.asarray(np_pm.cbrt(np, x.numpy()), dtype=np.float32))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_torch_flatten_matches_numpy(name, monkeypatch):
    """Fed the oracle's cbrt values, the port's flatten lands on the
    oracle's lines: end points within ATOL, counts and integers exact."""
    monkeypatch.setattr(pm, "cbrt", _oracle_cbrt)
    _check_flatten(name, ATOL)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_torch_flatten_own_cbrt_matches_numpy(name):
    """With the port's own cbrt only end points move, within LINE_ATOL."""
    _check_flatten(name, LINE_ATOL)


def _check_flatten(name, line_atol):
    ref, scene_t, layout_t, caps = _both(name)
    # Line counts guard the pmath transcendentals: a flipped ceil of the
    # subdivision count moves whole lines.
    check_flatten_lines(ref["fl"], flatten.flatten_stage(scene_t, layout_t, caps), line_atol,
                        rtol=RTOL)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_torch_draw_leaf_matches_numpy(name):
    ref, scene_t, layout_t, caps = _both(name)
    fl = tree_to_torch({k: ref["fl"][k] for k in ("path_trans_idx", "path_draw_flags")})
    i = torch.arange(caps["n_draws_cap"], dtype=torch.int32)
    tag = torch.where(i < layout_t["n_draw_objects"],
                      scene_t[(layout_t["draw_tag_base"] + i).long().clamp(max=scene_t.shape[0] - 1)],
                      0)
    dm = drawobjs.draw_monoid_scan(tag)
    for k in ("path_idx", "clip_idx", "scene_offset", "info_offset"):
        _exact(ref["dm"][k], dm[k])
    info, clip_idx, clip_path = drawobjs.draw_leaf(
        scene_t, layout_t, dm, fl["path_trans_idx"], fl["path_draw_flags"], caps, tag)
    _exact(u32(ref["info"]), u32(as_np(info)))
    # These scenes hold no clip: the clip stream stays empty.
    assert clip_idx.shape == clip_path.shape == (caps["n_clips_cap"],)
    assert not clip_idx.any() and not clip_path.any()


@pytest.mark.parametrize("name", sorted(SCENES))
def test_torch_tiling_matches_numpy(name):
    ref, _, layout_t, caps = _both(name)
    paths = ref["paths"]
    draw_bbox = to_torch(coarse_np.binning_bboxes(
        np, ref["dm"], ref["fl"]["path_bbox"],
        np.zeros((caps["n_clips_cap"], 4), np.float32), None))
    tags = to_torch(ref["cmds_tag"])
    gpaths = tiling.tile_alloc(draw_bbox, tags, layout_t, caps)
    for k in ("rect_x0", "rect_y0", "rect_x1", "rect_y1", "tile_offset"):
        _exact(paths[k], gpaths[k])
    assert int(paths["n_tiles"]) == int(gpaths["n_tiles"])
    tv = paths["tile_valid"]
    _exact(tv, gpaths["tile_valid"])
    for k in ("tile_draw", "tile_tx", "tile_ty", "tile_row_start"):
        _exact(paths[k][tv], as_np(gpaths[k])[tv])

    lines = tree_to_torch({k: ref["fl"][k] for k in (
        "line_x0", "line_y0", "line_x1", "line_y1", "line_path", "line_valid")})
    c = ref["counted"]
    gc = tiling.path_count(lines, tree_to_torch(paths), caps)
    assert tiling.path_tiling(lines, gc, caps) is gc["segs"]
    for k in ("sorted_slot", "seg_start", "seg_count", "backdrop", "row_of_slot"):
        _exact(c[k], gc[k])
    for k in ("n_rows", "n_segs", "r_total", "real_cross", "real_bd_rows",
              "real_cross_lines", "real_bd_lines"):
        assert int(c[k]) == int(gc[k]), k
    live = c["sorted_slot"] < caps["tiles_cap"]
    for k in ("seg_x0", "seg_y0", "seg_x1", "seg_y1", "seg_y_edge"):
        _close(c["segs"][k][live], as_np(gc["segs"][k])[live])


@pytest.mark.parametrize("name", sorted(SCENES))
def test_torch_coarse_matches_numpy(name):
    ref, _, layout_t, caps = _both(name)
    cmds = ref["cmds"]
    gcmds = coarse.build_commands(
        layout_t, tree_to_torch(ref["dm"]), to_torch(ref["cmds_tag"]),
        to_torch(cmds["dtab"]), to_torch(ref["draw_bbox"]), tree_to_torch(ref["paths"]),
        tree_to_torch({k: v for k, v in ref["counted"].items() if k != "segs"}),
        to_torch(ref["fl"]["path_draw_flags"]), caps)
    live = cmds["tile"] < caps["tile_grid_cap"]
    assert live.sum() == int(cmds["n_cmds"]) == int(gcmds["n_cmds"])
    for k in ("tile", "kind", "draw", "flags", "seg_start", "seg_count", "backdrop",
              "tile_slot"):
        _exact(u32(cmds[k])[live], u32(as_np(gcmds[k]))[live])
    for k in ("tile_start", "tile_end"):
        _exact(cmds[k], gcmds[k])
    for k in ("pair_total", "max_cmds"):
        assert int(cmds[k]) == int(gcmds[k]), k
    assert not bool(gcmds["overflow"])


@pytest.mark.parametrize("name", sorted(SCENES))
def test_torch_geometry_chain_matches_numpy(name):
    """The port's stages chained on its own outputs (the slice before
    fine) land on the oracle's command stream."""
    ref, scene_t, layout_t, caps = _both(name)
    got, flags, stats = geometry(scene_t, layout_t, caps)
    assert not any(bool(v) for v in flags.values())
    cmds, gcmds = ref["cmds"], got["cmds"]
    live = cmds["tile"] < caps["tile_grid_cap"]
    for k in ("tile", "kind", "draw", "seg_count", "backdrop"):
        _exact(u32(cmds[k])[live], u32(as_np(gcmds[k]))[live])
    _exact(u32(cmds["dtab"]), u32(as_np(gcmds["dtab"])))
    assert stats["cmds"] == int(cmds["n_cmds"])
    assert stats["lockstep_iters"] == int(ref["fl"]["lockstep_iters"])


def test_torch_stages_make_no_tensor_from_host_data():
    """A stage that runs inside a frame builds its constants on the
    device: `torch.tensor([...], device=...)` copies from the host, and
    on a GPU that copy makes the host wait for everything queued."""
    import pathlib
    import re

    call = re.compile(r"torch\.(as_)?tensor\([^()]*(\([^()]*\)[^()]*)*device=")
    pipeline = pathlib.Path(ops.__file__).parent
    for path in sorted(pipeline.glob("*.py")):
        assert not call.search(path.read_text()), path.name
    box = ops.unbounded_bboxes(3, torch.device("cpu"), 1e9)
    assert box.dtype == torch.float32
    assert box.tolist() == [[-1e9, -1e9, 1e9, 1e9]] * 3


def _numpy_column_scan(cols, op="sum", exclusive=False, totals=False):
    """Kernel I's contract computed apart from torch, in its layout: the
    prefixes in int64, wrapped to int32, a contiguous row a column."""
    x = np.stack([c.numpy() for c in cols]).astype(np.int64)
    ident = 0 if op == "sum" else ops.INT32_MIN
    incl = np.cumsum(x, axis=1) if op == "sum" else np.maximum.accumulate(x, axis=1)
    incl = (incl + 2**31) % 2**32 - 2**31
    if exclusive:
        incl_before = np.concatenate([np.full((len(cols), 1), ident), incl], axis=1)
        out = incl_before[:, :x.shape[1]]
    else:
        out = incl
    out = torch.from_numpy(np.ascontiguousarray(out.astype(np.int32)))
    if not totals:
        return out
    tot = incl[:, -1] if x.shape[1] else np.full(len(cols), ident)
    return out, torch.from_numpy(tot.astype(np.int32))


def _replaced_expression(cols, op, exclusive):
    """What the call sites computed before kernel I, [N, k]: the stacked
    columns' `torch.cumsum(d, 0) - d` or `torch.cummax(d, 0).values`."""
    d = torch.stack(cols, dim=1)
    if op == "sum":
        return torch.cumsum(d, dim=0, dtype=torch.int32) - (d if exclusive else 0)
    assert not exclusive
    return torch.cummax(d, dim=0).values


@pytest.mark.parametrize("name", sorted(SCENES))
def test_torch_column_scan_sites_match_replaced_expressions(name, monkeypatch):
    """Every call of kernel I's wrapper in a geometry pass, on the plain
    route and on the accelerator's: its result equals the expression the
    call site ran before (the stacked columns' cumsum minus the deltas,
    or cummax), bit for bit, the totals the old `[-1] + d[-1]`; and the
    stages fed kernel I's layout (a contiguous row a column, computed in
    numpy) give every output the plain run gives."""
    from jello_tpu_torch.cuda import scan as kscan
    from jello_tpu_torch.cuda.render import frame_routing
    from tools.torch_frame_times import stage_tensors

    _, scene_t, layout_t, caps = _both(name)
    for routed in (caps, dict(caps, **frame_routing(0, False, 0))):
        want = stage_tensors(geometry(scene_t, layout_t, routed))
        calls = []

        def spy(cols, op="sum", exclusive=False, totals=False):
            calls.append((cols, op, exclusive, totals))
            return _numpy_column_scan(cols, op, exclusive, totals)

        monkeypatch.setattr(kscan, "column_scan", spy)
        got = stage_tensors(geometry(scene_t, layout_t, routed))
        monkeypatch.undo()
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)
        sites = {(len(c[0]), c[1], c[2], c[3]) for c in calls}
        assert {(5, "sum", True, False), (4, "sum", True, False), (3, "sum", True, True),
                (2, "max", False, False)} <= sites
        for cols, op, exclusive, totals in calls:
            old = _replaced_expression(cols, op, exclusive)
            new = _numpy_column_scan(cols, op, exclusive, totals)
            assert torch.equal((new[0] if totals else new).t(), old)
            if totals:
                d = torch.stack(cols, dim=1)
                assert torch.equal(new[1], old[-1] + d[-1])


@pytest.mark.parametrize("op", ["sum", "max"])
def test_torch_column_scan_keeps_cpu_tensors_on_the_plain_version(op, monkeypatch):
    """On CPU tensors the wrapper takes the plain version (torch's own
    scans): no kernel library is loaded and no launch is counted; the
    plain version keeps the contract (sums wrap, max from INT32_MIN,
    totals, N = 0) and the wrapper rejects what the kernel would not
    take."""
    from jello_tpu_torch.cuda import scan as kscan

    def no_library():
        raise AssertionError("the kernel library was loaded for a CPU tensor")

    monkeypatch.setattr(kscan, "kernels", no_library)
    rng = np.random.default_rng(19)
    i32 = np.iinfo(np.int32)
    before = kscan.column_scan.launches
    for k in (1, 3, 8):
        for N in (0, 1, 37, 9000):
            raw = rng.integers(i32.min, i32.max, (N, k), dtype=np.int64, endpoint=True)
            raw[rng.random((N, k)) < 0.2] = -1
            raw[rng.random((N, k)) < 0.05] = i32.min
            x = torch.from_numpy(raw.astype(np.int32))
            cols = list(x.unbind(1))  # strided views, as the marks' columns are
            for exclusive in (False, True):
                out, tot = kscan.column_scan(cols, op, exclusive, totals=True)
                want_out, want_tot = _numpy_column_scan(cols, op, exclusive, True)
                assert torch.equal(out, want_out) and torch.equal(tot, want_tot)
                assert torch.equal(kscan.column_scan(cols, op, exclusive), want_out)
                if op == "sum" or not exclusive:
                    assert torch.equal(out.t(), _replaced_expression(cols, op, exclusive))
    v = torch.from_numpy(rng.integers(-50, 50, 500).astype(np.int32))
    assert torch.equal(kscan.column_scan([v], "max")[0], torch.cummax(v, 0).values)
    assert kscan.column_scan.launches == before
    good = torch.zeros(4, dtype=torch.int32)
    bad = [([], op), ([good] * 9, op), ([good.long()], op), ([good, good[:3]], op),
           ([good, torch.zeros((4, 2), dtype=torch.int32)[:, 0]], op),
           ([good.reshape(2, 2)], op), ([good], "min")]
    for cols, bad_op in bad:
        with pytest.raises(ValueError):
            kscan.column_scan(cols, bad_op)
