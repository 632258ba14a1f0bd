"""The port's coverage stage (plain row sums on the CPU) vs
jello_tpu.pipeline.coverage.compute_area_rows under numpy, on the same
command and segment streams, its per-record output contract, and the one
place where its arithmetic leaves jello_tpu's on purpose (the regrouped
numerator under vertical edges), against a float64 oracle. Then the MSAA
modes: the plain resolved rows against jello_tpu's `fine_ref._fill_area`
under numpy on the same float32 segments and against its Pallas coverage
kernel in interpret mode (equal: per-sample sums of small integers), the
rows' rule table, and the sample tables of the port and of the CUDA
source against `renderer/mask.py`."""

import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jello_tpu as jt
from jello_tpu.pipeline import coverage as np_cov
from jello_tpu.pipeline import fine_ref as np_fine_ref
from jello_tpu.renderer import mask as np_mask
from jello_tpu.renderer.params import RenderParams
from jello_tpu.scenes import config1

from jello_tpu_torch.cuda.coverage import compute_area_rows, coverage_rows
from jello_tpu_torch.pipeline import coverage as cov

from .torch_reference import CLIP_SCENES, as_np, numpy_geometry, prepare, tree_to_torch

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


SCENES = {"overlaps": _overlaps, "config1": config1,
          "clip_edge": lambda: CLIP_SCENES["partial_coverage_edge"](jt)}


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


AREA_SCENES = ["config1", "overlaps"]


@pytest.mark.parametrize("name", AREA_SCENES)
def test_torch_coverage_matches_numpy(name):
    (area_w, ids_w, ovf_w), cmds, counted, caps = _inputs(name)
    area, ids, ovf = compute_area_rows(cmds, counted, caps)
    assert area.shape == area_w.shape and area.dtype == torch.float32
    np.testing.assert_array_equal(as_np(ids), ids_w)
    assert bool(ovf) == bool(ovf_w) is False
    assert np.abs(as_np(area) - area_w).max() <= TOL


@pytest.mark.parametrize("name", AREA_SCENES)
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


def _bits(x):
    return x.view(torch.int32)  # -0 and +0 differ, as do NaNs


@pytest.mark.parametrize("aa", ["area", "msaa8", "msaa16"])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_torch_coverage_rows_plain_stops_at_the_last_row_bit_for_bit(name, aa):
    """`coverage_rows_plain` stops its sums at the last row's end, before
    the class's padding. Held to the walk of the whole stream, which one
    more segment and a row reading it force (every other row sums the
    same segments in the same order), bit for bit; and so on a stream
    whose rows are all empty, which sums nothing."""
    _, cmds, counted, caps = _inputs(name)
    stream, rs, re_, bd, eo, _, _ = cov.slot_rank_rows(cmds, counted, dict(caps, aa_mode=aa))
    offsets = cov.sample_offsets(aa)

    def rows(stream, rs, re_, bd, eo):
        return cov.coverage_rows_plain(stream, rs, re_, bd,
                                       *(() if offsets is None else (offsets, eo)))

    def whole(stream, rs, re_, bd, eo):
        at = torch.tensor([stream.shape[0]], dtype=rs.dtype)
        return rows(torch.cat([stream, stream[:1]]), torch.cat([rs, at]), torch.cat([re_, at + 1]),
                    torch.cat([bd, bd[:1]]), None if eo is None else torch.cat([eo, eo[:1]]))

    R = rs.shape[0]
    assert int(torch.where(re_ > rs, re_, 0).amax()) < stream.shape[0]  # padding to skip
    got = rows(stream, rs, re_, bd, eo)
    assert torch.equal(_bits(got), _bits(whole(stream, rs, re_, bd, eo)[:R]))
    empty = rows(stream, rs, rs, bd, eo)
    assert not torch.equal(got, empty)
    assert torch.equal(_bits(empty), _bits(whole(stream, rs, rs, bd, eo)[:R]))


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


# ---- MSAA --------------------------------------------------------------------

def test_torch_sample_offsets_match_jello_tpu_and_the_cuda_source():
    """`sample_offsets` equals jello_tpu's, every offset is exact in
    float32, and the pattern tables written into csrc/coverage.cu are the
    patterns of renderer/mask.py."""
    from jello_tpu_torch.renderer import mask

    assert mask._MASK8_PATTERN == np_mask._MASK8_PATTERN
    assert mask._MASK16_PATTERN == np_mask._MASK16_PATTERN
    for aa, n in (("msaa8", 8), ("msaa16", 16)):
        offs = cov.sample_offsets(aa)
        assert offs == np_fine_ref.sample_offsets(aa) and len(offs) == n
        assert all(float(np.float32(v)) == v for o in offs for v in o)
    assert cov.sample_offsets("area") is None and np_fine_ref.sample_offsets("area") is None
    src = (Path(cov.__file__).parent.parent / "csrc" / "coverage.cu").read_text()
    for name, n, pat in (("kMask8Pattern", 8, mask._MASK8_PATTERN),
                         ("kMask16Pattern", 16, mask._MASK16_PATTERN)):
        (table,) = re.findall(rf"{name}\[{n}\] = \{{([0-9, ]+)\}};", src)
        assert tuple(int(v) for v in table.split(",")) == pat
    # The kernel places sample i at ((pattern[i] + 0.5) / S, (i + 0.5) / S).
    assert "((float)sample_pattern<S>(i) + 0.5f) * (1.0f / S)" in src
    assert "((float)i + 0.5f) * (1.0f / S)" in src


@pytest.mark.parametrize("name", sorted(SCENES))
def test_torch_coverage_row_rules(name):
    """`row_eo`: the even-odd flag of the record that reads the row; a clip
    row (read by a BeginClip and its EndClip) resolves nonzero."""
    _, cmds, counted, caps = _inputs(name)
    assert cov.slot_rank_rows(cmds, counted, caps)[4] is None  # area rows carry no rule
    _, _, _, row_bd, row_eo, rec_sr, _ = cov.slot_rank_rows(cmds, counted,
                                                            dict(caps, aa_mode="msaa16"))
    assert row_eo.dtype == torch.int32 and row_eo.shape == row_bd.shape
    live = (cmds["tile"] < caps["tile_grid_cap"]) & (cmds["seg_count"] > 0)
    is_clip = (cmds["kind"] == 6) | (cmds["kind"] == 7)
    want = ((cmds["flags"] & 1) != 0) & ~is_clip
    assert torch.equal(row_eo[rec_sr[live].long()] != 0, want[live])
    assert torch.equal(row_bd[rec_sr[live].long()], cmds["backdrop"][live].float())
    if name == "overlaps":
        assert bool(want[live].any()) and not bool(want[live].all())
    if name == "clip_edge":
        assert bool((is_clip & live).any())


def _numpy_msaa_rows(cmds, counted, caps, aa):
    """jello_tpu's `fine_ref._fill_area` under numpy for every record with
    segments, on the float32-rounded segments: [n, 256] resolved coverage
    and the records' indices. An EndClip resolves nonzero
    (`fine_ref.py:258`)."""
    live = np.nonzero((cmds["tile"] < caps["tile_grid_cap"]) & (cmds["seg_count"] > 0))[0]
    segs = {k: np.asarray(v).astype(np.float32) for k, v in counted["segs"].items()}
    p = np.arange(256, dtype=np.int32)
    even_odd = ((cmds["flags"][live] & 1) != 0) & (cmds["kind"][live] != 7)
    with np.errstate(all="ignore"):
        rows = np_fine_ref._fill_area(
            np, cmds["seg_start"][live].astype(np.int32), cmds["seg_count"][live].astype(np.int32),
            cmds["backdrop"][live], even_odd, segs, (p % 16).astype(np.float32),
            (p // 16).astype(np.float32), dict(caps, aa_mode=aa))
    return rows, live


@pytest.mark.parametrize("aa", ["msaa8", "msaa16"])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_torch_coverage_msaa_rows_match_fill_area(name, aa):
    """The plain MSAA rows, gathered into record order, equal jello_tpu's
    per-record `_fill_area` on the same float32 segments: both round
    per-sample sums of small integers, so equal means equal."""
    scene, params = SCENES[name]()
    s, ld, _, caps = prepare(scene, params)
    ref = numpy_geometry(s, ld, caps)
    want, live = _numpy_msaa_rows(ref["cmds"], ref["counted"], caps, aa)
    _, cmds, counted, _ = _inputs(name)
    area, ids, ovf = compute_area_rows(cmds, counted, dict(caps, aa_mode=aa))
    assert not bool(ovf) and np.array_equal(np.nonzero(as_np(ids) >= 0)[0], live)
    got = as_np(area)[live]
    n = int(aa[4:])
    assert np.array_equal(got * n, np.round(got * n)) and got.min() >= 0 and got.max() <= 1
    assert np.array_equal(got, want.astype(np.float32))
    assert 0 < ((got > 0) & (got < 1)).sum()
    # Area mode's table has the same rows filled, with raw winding in them.
    raw, ids_a, _ = compute_area_rows(cmds, counted, caps)
    assert torch.equal(ids_a, ids) and not torch.equal(raw, area)


@pytest.mark.parametrize("aa", ["msaa8", "msaa16"])
def test_torch_coverage_msaa_rows_match_pallas_interpret(aa):
    """The plain MSAA rows against jello_tpu's Pallas coverage kernel in
    interpret mode, on the stage dicts of the overlaps scene: the
    per-record tables agree on every live row but for a sample tie or two.
    XLA on the CPU contracts the crossing's `sx0 + t * dx`; numpy does not,
    nor does the port (the CUDA kernel is built with -fmad=false), and the
    port equals numpy's `_fill_area` everywhere
    (test_torch_coverage_msaa_rows_match_fill_area). Found: msaa8 equal,
    msaa16 one sample of one pixel."""
    import jax.numpy as jnp
    from jello_tpu.tpu.coverage_pallas import compute_area_rows_pallas

    scene, params = SCENES["overlaps"]()
    s, ld, _, caps = prepare(scene, params)
    ref = numpy_geometry(s, ld, caps)
    caps = dict(caps, aa_mode=aa, _expand_interpret=True)

    def to_jnp(d):
        return {k: to_jnp(v) if isinstance(v, dict)
                else jnp.asarray(np.asarray(v, np.float32) if np.asarray(v).dtype == np.float64
                                 else v) for k, v in d.items()}

    want, want_ids, want_ovf = compute_area_rows_pallas(
        jnp, to_jnp({k: v for k, v in ref["cmds"].items() if k != "dtab"}),
        to_jnp(ref["counted"]), caps)
    _, cmds, counted, _ = _inputs("overlaps")
    area, ids, ovf = compute_area_rows(cmds, counted, caps)
    assert bool(ovf) == bool(want_ovf) is False
    np.testing.assert_array_equal(as_np(ids), np.asarray(want_ids))
    live = as_np(ids) >= 0
    assert live.sum() > 50
    diff = np.abs(as_np(area)[: len(live)][live] - np.asarray(want)[: len(live)][live])
    print(f"{aa}: {int((diff > 0).sum())} of {diff.size} entries differ, by up to {diff.max()}")
    assert (diff > 0).sum() <= 2 and diff.max() <= 1.0 / int(aa[4:])


def test_torch_coverage_rows_plain_msaa_by_hand():
    """One axis-aligned box [4, 12] x [2.25, 9] wound clockwise in a tile,
    by hand: a pixel inside is covered at every sample, the top pixel row
    (y from 2 to 3) at the samples below y = 2.25, and the even-odd rule
    on a backdrop of 1 inverts the picture."""
    def seg(x0, y0, x1, y1):
        return [x0, y0, x1, y1, 1e9, 1.0, 0.0, 0.0]

    # The left edge runs up and counts +1 for the samples to its right, the
    # right edge runs down and takes it back. One copy of the box a row.
    box = [seg(4, 9, 4, 2.25), seg(12, 2.25, 12, 9)]
    stream = torch.tensor(box + box, dtype=torch.float32)
    start = torch.tensor([0, 2], dtype=torch.int32)
    end = torch.tensor([2, 4], dtype=torch.int32)
    bd = torch.tensor([0.0, 1.0])
    eo = torch.tensor([0, 1], dtype=torch.int32)
    for aa, n in (("msaa8", 8), ("msaa16", 16)):
        rows = coverage_rows(stream, start, end, bd, cov.sample_offsets(aa), eo)
        nz = rows[0].reshape(16, 16)
        assert bool((nz[3:9, 4:12] == 1).all()) and bool((nz[:2] == 0).all())
        assert bool((nz[:, :4] == 0).all()) and bool((nz[:, 12:] == 0).all())
        # Samples at y = 2 + (i + 0.5) / n lie inside the box from y = 2.25.
        inside = sum(2 + (i + 0.5) / n >= 2.25 for i in range(n))
        assert bool((nz[2, 4:12] == inside / n).all())
        assert torch.equal(rows[1].reshape(16, 16), 1.0 - nz)
