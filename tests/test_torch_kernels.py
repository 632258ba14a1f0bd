"""The CUDA kernels of jello_tpu_torch on the card vs their plain
versions, and the renderer's main path through them.

These need an NVIDIA GPU (marker `cuda`); each test skips itself where
torch sees none. Run them on the card with
`python -m pytest tests/test_torch_kernels.py -q`.
"""

import numpy as np
import pytest
import torch

import jello_tpu
import jello_tpu_torch
from jello_tpu.cpu import render_numpy

from jello_tpu_torch.cuda import build
from jello_tpu_torch.cuda import expand as kx
from jello_tpu_torch.cuda import fine_hybrid as khybrid
from jello_tpu_torch.cuda import fine_interp as kint
from jello_tpu_torch.cuda import fine_v2 as kfine
from jello_tpu_torch.cuda import land as kland
from jello_tpu_torch.cuda import lockstep as kwalk
from jello_tpu_torch.cuda import scan as kscan
from jello_tpu_torch.cuda.coverage import compute_area_rows, coverage_rows
from jello_tpu_torch.cuda.fine_v2 import (
    assemble_compact,
    build_records,
    composite_records,
    composite_records_plain,
    tile_last_record,
)
from jello_tpu_torch.cuda import image_tap as ktap
from jello_tpu_torch.cuda.render import Renderer, upload, upload_atlas
from jello_tpu_torch.pipeline import coverage as plain_cov
from jello_tpu_torch.pipeline import expand as plain_expand
from jello_tpu_torch.pipeline import fine_interp as plain_int
from jello_tpu_torch.pipeline import image_tap as plain_tap
from jello_tpu_torch.pipeline import land as plain_land
from jello_tpu_torch.pipeline import lockstep as plain_walk
from jello_tpu_torch.pipeline import ops as plain_ops
from jello_tpu_torch.pipeline.render import geometry

from .torch_reference import (
    CLIP_SCENES,
    EXPAND_CASES,
    crossing_inputs,
    deep_slab,
    euler_inputs,
    expand_counts,
    full_scene,
    hand_built_slab,
    interpret_args,
    over_minified,
    prepare,
    prepare_with_atlas,
    random_tap_records,
    row_inputs,
    solid_image_slab,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _gradient_scene(jt=jello_tpu):
    IDENT = jt.Affine.identity()
    rng = np.random.default_rng(11)
    s = jt.Scene()
    for i in range(24):
        cx, cy = rng.random(2) * 120 + 4
        r = 6 + 14 * rng.random()
        p = (jt.BezPath().move_to(cx - r, cy).cubic_to(cx - r, cy - r, cx + r, cy - r, cx + r, cy)
             .line_to(cx, cy + r).close())
        st = (jt.ColorStop(0.0, jt.Color.rgba(*rng.random(3), 1)),
              jt.ColorStop(0.5, jt.Color.rgba(*rng.random(3), 0.5)),
              jt.ColorStop(1.0, jt.Color.rgba(*rng.random(3), 1)))
        if i == 1:
            # 30 stops: stop-table rows wider than 128 words.
            st = tuple(jt.ColorStop(o, jt.Color.rgba(*rng.random(3), 1))
                       for o in np.linspace(0.0, 1.0, 30))
        ext = [jt.Extend.PAD, jt.Extend.REPEAT, jt.Extend.REFLECT][i % 3]
        kind = i % 4
        if kind == 0:
            brush = jt.GradientBrush(jt.LinearGradient((cx - r, cy), (cx + r, cy), st, ext))
        elif kind == 1:
            brush = jt.GradientBrush(jt.RadialGradient((cx, cy), 0.0, (cx, cy), r, st, ext))
        elif kind == 2:
            brush = jt.GradientBrush(jt.SweepGradient((cx, cy), 0.1, 0.9, st, ext))
        else:
            brush = jt.SolidBrush(jt.Color.rgba(*rng.random(3), 0.7))
        rule = jt.Fill.EVEN_ODD if i % 5 == 0 else jt.Fill.NON_ZERO
        s.fill(rule, IDENT, brush, None, p)
    return s, jt.RenderParams(width=128, height=128, base_color=jt.Color.rgba(1, 1, 1, 1))


def _image_scene(jt=jello_tpu):
    """Solid ground, three image fills (upscaled, rotated and translucent,
    minified over several region windows) and a thin round stroke."""
    IDENT = jt.Affine.identity()
    rng = np.random.default_rng(17)

    def image(size, alpha):
        pix = (rng.random((size, size, 4)) * 255).astype(np.uint8)
        pix[..., 3] = alpha
        return jt.ImageBrush(jt.Image(pixels=pix))

    def rect(w, h):
        return jt.BezPath().move_to(0, 0).line_to(w, 0).line_to(w, h).line_to(0, h).close()

    s = jt.Scene()
    s.fill(jt.Fill.NON_ZERO, IDENT, jt.SolidBrush(jt.Color.rgba(0.2, 0.5, 0.7, 1)), None,
           rect(128, 128))
    s.fill(jt.Fill.NON_ZERO, jt.Affine.translate(6.3, 4.6) @ jt.Affine.scale(5.7),
           image(8, 255), None, rect(8, 8))
    s.fill(jt.Fill.EVEN_ODD, jt.Affine.translate(70, 20) @ jt.Affine.rotate(0.4)
           @ jt.Affine.scale(2.2), image(16, 150), None, rect(16, 16))
    s.fill(jt.Fill.NON_ZERO, jt.Affine.translate(10, 70) @ jt.Affine.scale(1.0 / 6.0),
           image(96, 230), None, rect(96, 96))
    st = jt.Stroke(width=0.8, join=jt.Join.ROUND).with_caps(jt.Cap.ROUND)
    s.stroke(st, IDENT, jt.SolidBrush(jt.Color.rgba(0.9, 0.1, 0.1, 0.9)), None,
             jt.BezPath().move_to(8, 120).cubic_to(40, 10, 90, 130, 122, 30))
    return s, jt.RenderParams(width=128, height=128, base_color=jt.Color.rgba(1, 1, 1, 1))


def _image_inputs(cuda):
    """Stages, records and the image-tap table of `_image_scene` on the
    card, with the tap's compacted records as recorded from the stage."""
    s, ld, ramps, atlas, caps = prepare_with_atlas(*_image_scene())
    caps = dict(caps, _image_tap=True)
    scene_t, layout_t, ramps_t, _ = upload(s, ld, ramps, {}, cuda)
    atlas_t = upload_atlas(atlas, cuda)
    stages, flags, stats = geometry(scene_t, layout_t, caps)
    assert not any(bool(v) for v in flags.values())
    assert int(stats["img_recs"]) > 0
    cmds = stages["cmds"]
    area, ids, _ = compute_area_rows(cmds, stages["counted"], caps)
    rec = build_records(dict(cmds, area_row=ids), caps)
    return cmds, area, rec, atlas_t, layout_t, ramps_t, caps, ld


def _inputs(cuda):
    scene, params = _gradient_scene()
    s, ld, ramps, caps = prepare(scene, params)
    scene_t, layout_t, ramps_t, caps = upload(s, ld, ramps, caps, cuda)
    stages, flags, _ = geometry(scene_t, layout_t, caps)
    assert not any(bool(v) for v in flags.values())
    return stages, layout_t, ramps_t, caps, ld


WRAPPERS = ((kland, "monotone_land"), (kwalk, "lockstep_walk"), (kx, "expand_euler"),
            (kx, "expand_crossings"), (kx, "expand_rows"))


def _route_calls(cuda, monkeypatch):
    """The arguments of every kernel-wrapper call of one geometry pass on
    the expand route, on the card."""
    scene, params = _gradient_scene()
    s, ld, ramps, caps = prepare(scene, params)
    scene_t, layout_t, _, caps = upload(s, ld, ramps, caps, cuda)
    calls = {}
    for mod, name in WRAPPERS:
        fn = getattr(mod, name)

        def spy(*args, _fn=fn, _name=name):
            calls.setdefault(_name, []).append(args)
            return _fn(*args)

        spy.launches = 0
        monkeypatch.setattr(mod, name, spy)
    _, flags, _ = geometry(scene_t, layout_t, caps)
    assert not any(bool(v) for v in flags.values())
    monkeypatch.undo()
    return calls


def test_torch_land_kernel_matches_plain(cuda, monkeypatch):
    calls = _route_calls(cuda, monkeypatch)
    assert len(calls["monotone_land"]) == 4  # worklist, two compactions, runs
    for args in calls["monotone_land"]:
        n0 = kland.monotone_land.launches
        got = kland.monotone_land(*args)
        assert kland.monotone_land.launches == n0 + 1
        for g, w in zip(got, plain_land.monotone_land(*args)):
            assert torch.equal(g, w)


def test_torch_lockstep_kernel_matches_plain(cuda, monkeypatch):
    (args,) = _route_calls(cuda, monkeypatch)["lockstep_walk"]
    n0 = kwalk.lockstep_walk.launches
    got = kwalk.lockstep_walk(*args)
    assert kwalk.lockstep_walk.launches == n0 + 1
    want = plain_walk.lockstep_walk(*args)
    for g, w in zip(got, want):  # records, counts, not-done flags, iterations
        assert torch.equal(g, w)
    assert int(got[3]) > 0


@pytest.mark.parametrize("body", ["expand_euler", "expand_crossings", "expand_rows"])
def test_torch_expand_kernel_matches_plain(cuda, monkeypatch, body):
    """Integer outputs equal, float outputs within 1e-5 (end points:
    cbrt's expf/logf and powf may round otherwise than torch's)."""
    (args,) = _route_calls(cuda, monkeypatch)[body]
    fn = getattr(kx, body)
    n0 = fn.launches
    got = fn(*args)
    assert fn.launches == n0 + 1
    if body == "expand_euler":
        table, rec, counts, EC, sentinel = args
        incl, _ = plain_expand.expand_prefix(counts)
        want = plain_expand.euler_lines(table, rec, incl, counts, EC, sentinel)
        assert torch.equal(got[4], want[4]) and torch.equal(got[5], want[5])
        floats = [(g[want[5]], w[want[5]]) for g, w in zip(got[:4], want[:4])]
    elif body == "expand_crossings":
        P, counts, SC, T = args
        incl, _ = plain_expand.expand_prefix(counts, assume_compact=True)
        want = plain_expand.tile_crossings(P, incl, counts, SC, T)
        for i in (0, 2, 3):
            assert torch.equal(got[i], want[i])
        floats = [(got[1][k], want[1][k]) for k in want[1]]
    else:
        PRT, counts, RC, T = args
        incl, _ = plain_expand.expand_prefix(counts, assume_compact=True)
        want = plain_expand.row_deltas(PRT, incl, counts, RC, T)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        floats = []
    assert int(got[-1]) == int(incl[-1])
    for g, w in floats:
        assert (g.double() - w.double()).abs().max().item() <= 1e-5


@pytest.mark.parametrize("case", EXPAND_CASES)
@pytest.mark.parametrize("body", ["expand_euler", "expand_crossings", "expand_rows"])
def test_torch_expand_kernel_synthetic(cuda, body, case):
    """Each expand body on the edge shapes of `torch_reference.expand_counts`
    against its plain version: valid flags, paths, tile and row slots,
    bumps and the total equal, end points and segments within 1e-5 (0.0
    expected: the same operations on the same operands). The Euler body
    expands under the clamp (zero counts are dead slots, 1,000 lines of
    one item fill several CTAs); the crossing and row bodies under
    assume_compact, with zero runs between nonzero counts longer than a
    CTA's window as well as at the end."""
    compact = body != "expand_euler"
    counts, cap = expand_counts(case, compact, interior=compact)
    c = torch.from_numpy(counts).to(cuda)
    fn = getattr(kx, body)
    if body == "expand_euler":
        table, rec = (torch.from_numpy(a).to(cuda) for a in euler_inputs(counts))
        args = (table, rec, c, cap, 51)
        incl, total = plain_expand.expand_prefix(c)
        want = plain_expand.euler_lines(table, rec, incl, c, cap, 51)
        ints, floats = (4, 5), (0, 1, 2, 3)
    elif body == "expand_crossings":
        P = torch.from_numpy(crossing_inputs(counts)).to(cuda)
        args = (P, c, cap, 4096)
        incl, total = plain_expand.expand_prefix(c, assume_compact=True)
        want = plain_expand.tile_crossings(P, incl, c, cap, 4096)
        want = (want[0], *want[1].values(), want[2], want[3])
        ints, floats = (0, 6, 7), (1, 2, 3, 4, 5)
    else:
        PRT = torch.from_numpy(row_inputs(counts)).to(cuda)
        args = (PRT, c, cap, 4096)
        incl, total = plain_expand.expand_prefix(c, assume_compact=True)
        want = plain_expand.row_deltas(PRT, incl, c, cap, 4096)
        ints, floats = (0, 1), ()
    n0 = fn.launches
    got = fn(*args)
    assert fn.launches == n0 + 1
    if body == "expand_crossings":
        got = (got[0], *got[1].values(), got[2], got[3], got[4])
    torch.cuda.synchronize()
    assert got[-1].shape == () and int(got[-1]) == int(total)
    assert (int(total) > cap) == (case == "over-cap")
    for i in ints:
        assert torch.equal(got[i], want[i]), i
    for i in floats:
        assert got[i].shape == (cap,)
        assert (got[i].double() - want[i].double()).abs().max().item() <= 1e-5, i


def test_torch_lockstep_entry_writes_every_record(cuda, monkeypatch):
    """Kernel D's bare C entry on outputs filled with what they must not
    hold (records and counts NaN, flags inverted, iters 12345) at half the
    iterations the walk needs, so that some items end not done: every
    record slot, count, flag and the iteration count equal the plain
    walk's, so the entry writes each element itself (the wrapper
    allocates them uninitialised)."""
    (args,) = _route_calls(cuda, monkeypatch)["lockstep_walk"]
    table, valid, IT = args
    NW, IT = table.shape[0], max(1, int(plain_walk.lockstep_walk(table, valid, IT)[3]) // 2)
    want = plain_walk.lockstep_walk(table, valid, IT)
    assert bool(want[2].any()) and not bool(want[2].all())
    rec = torch.full((3, IT, NW), float("nan"), device=cuda)
    count = torch.full((NW,), float("nan"), device=cuda)
    not_done = ~want[2]
    iters = torch.full((), 12345, dtype=torch.int32, device=cuda)
    build.check("jello_lockstep_walk", build.kernels().jello_lockstep_walk(
        table.data_ptr(), valid.data_ptr(), rec.data_ptr(), count.data_ptr(),
        not_done.data_ptr(), iters.data_ptr(), NW, IT, torch.cuda.current_stream().cuda_stream))
    torch.cuda.synchronize()
    for g, w in zip((rec, count, not_done, iters), want):
        assert torch.equal(g, w)


def test_torch_coverage_kernel_matches_plain(cuda):
    stages, _, _, caps, _ = _inputs(cuda)
    cmds, counted = stages["cmds"], stages["counted"]
    stream, rs, re_, bd, _, _, _ = plain_cov.slot_rank_rows(cmds, counted, caps)
    n0 = coverage_rows.launches
    got = coverage_rows(stream, rs, re_, bd)
    assert coverage_rows.launches == n0 + 1
    want = plain_cov.coverage_rows_plain(stream, rs, re_, bd)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-5
    area, ids, ovf = compute_area_rows(cmds, counted, caps)
    area_p, ids_p, _ = plain_cov.compute_area_rows(cmds, counted, caps)
    assert torch.equal(ids, ids_p) and not bool(ovf)
    assert not torch.isnan(area).any()
    assert (area - area_p).abs().max().item() <= 1e-5


@pytest.mark.parametrize("aa", ["msaa8", "msaa16"])
def test_torch_coverage_msaa_kernel_matches_plain(cuda, aa):
    """Kernel A's MSAA body: resolved rows equal to the plain version's
    (the per-sample sums are small integers, exact in any order; 1e-6
    allowed), multiples of 1 / samples, and only the MSAA entry counts."""
    stages, _, _, caps, _ = _inputs(cuda)
    cmds, counted = stages["cmds"], stages["counted"]
    stream, rs, re_, bd, eo, _, _ = plain_cov.slot_rank_rows(cmds, counted,
                                                             dict(caps, aa_mode=aa))
    assert bool(eo.any()) and not bool(eo.all())
    offsets = plain_cov.sample_offsets(aa)
    n0, n1 = coverage_rows.launches, coverage_rows.launches_msaa
    got = coverage_rows(stream, rs, re_, bd, offsets, eo)
    assert (coverage_rows.launches, coverage_rows.launches_msaa) == (n0, n1 + 1)
    want = plain_cov.coverage_rows_plain(stream, rs, re_, bd, offsets, eo)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-6
    n = len(offsets)
    assert torch.equal(got * n, torch.round(got * n)) and 0 <= got.min() and got.max() <= 1
    assert 0 < float(got[re_ > rs].mean()) < 1
    area, ids, ovf = compute_area_rows(cmds, counted, dict(caps, aa_mode=aa))
    area_p, ids_p, _ = plain_cov.compute_area_rows(cmds, counted, dict(caps, aa_mode=aa))
    assert torch.equal(ids, ids_p) and not bool(ovf)
    assert (area - area_p).abs().max().item() <= 1e-6


def _synthetic_rows(seed, long_run):
    """Coverage inputs built to reach the kernel's corners: rows of 0
    and 1 segments, a row longer than one shared-memory chunk (`long_run`
    segments), horizontal (dy = 0) and vertical (dx = 0) segments,
    pixel-aligned end points, y_edge terms, invalid segments inside runs,
    segments between runs that belong to no row, and backdrops of -3 to 3
    (rows made negative, so that the even-odd and nonzero rules differ).
    Runs follow row order, as the pipeline makes them and as the plain
    version assumes. Returns (stream, rs, re, bd, eo) as numpy arrays."""
    rng = np.random.default_rng(seed)
    lens = np.array([0, 1, long_run, 0, 2, 7, 1, 33, 0, 16, 3]
                    + list(rng.integers(0, 24, 60)), np.int32)
    gaps = rng.integers(0, 3, lens.shape[0]).astype(np.int32)
    SC = int(lens.sum() + gaps.sum()) + 5
    xy = rng.uniform(-2.0, 18.0, (SC, 4)).astype(np.float32)
    snap = rng.random((SC, 4)) < 0.2
    xy[snap] = np.round(xy[snap])
    flat = rng.random(SC) < 0.1
    xy[flat, 3] = xy[flat, 1]
    upright = rng.random(SC) < 0.15
    xy[upright, 2] = xy[upright, 0]
    y_edge = np.where(rng.random(SC) < 0.3, rng.uniform(0.0, 16.0, SC), 1e9).astype(np.float32)
    valid = (rng.random(SC) < 0.95).astype(np.float32)
    stream = np.zeros((SC, 8), np.float32)
    stream[:, :4], stream[:, 4], stream[:, 5] = xy, y_edge, valid
    ends = np.cumsum(lens + gaps).astype(np.int32)
    rs, re_ = ends - lens, ends
    bd = rng.integers(-3, 4, lens.shape[0]).astype(np.float32)
    eo = rng.integers(0, 2, lens.shape[0]).astype(np.int32)
    return stream, rs, re_, bd, eo


@pytest.mark.parametrize("aa", ["area", "msaa8", "msaa16"])
def test_torch_coverage_kernel_synthetic_rows(cuda, aa):
    """Kernel A, each body, on `_synthetic_rows` (a run of 300 segments
    spans five of the area body's chunks and ten of the MSAA body's):
    area rows within 1e-5 of the plain version, relative to the largest
    row value where that exceeds 1 (float32 sums of up to 300 terms, in
    another order), MSAA rows equal (sums of small integers); under MSAA the
    row's rule shows (flipping `row_eo` moves the rows) and the kernel
    reads it as the plain version does."""
    stream, rs, re_, bd, eo = (torch.from_numpy(a).to(cuda) for a in _synthetic_rows(3, 300))
    offsets = plain_cov.sample_offsets(aa)
    n0 = coverage_rows.launches + coverage_rows.launches_msaa
    got = coverage_rows(stream, rs, re_, bd, offsets, eo if offsets else None)
    assert coverage_rows.launches + coverage_rows.launches_msaa == n0 + 1
    want = plain_cov.coverage_rows_plain(stream, rs, re_, bd, offsets, eo)
    torch.cuda.synchronize()
    assert not torch.isnan(got).any()
    if offsets is None:
        scale = max(1.0, want.abs().max().item())
        assert (got - want).abs().max().item() <= 1e-5 * scale
        empty = re_ == rs
        assert torch.equal(got[empty], bd[empty, None].expand(-1, 256))
        return
    assert torch.equal(got, want)
    flip = 1 - eo
    got_f = coverage_rows(stream, rs, re_, bd, offsets, flip)
    assert torch.equal(got_f, plain_cov.coverage_rows_plain(stream, rs, re_, bd, offsets, flip))
    assert (got_f - got).abs().max().item() > 0.5


@pytest.mark.parametrize("out_len", ["below", "above"])
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
@pytest.mark.parametrize("K", [1, 2, 3])
def test_torch_land_kernel_synthetic(cuda, K, dtype, out_len):
    """Kernel C against its plain version (equal): K value vectors of one
    type, positions with flatten-style gaps (the exclusive prefix of
    counts of 0 to 40) shifted so that the first kept ones are negative,
    `out_len` below R (the tail of the kept rows lands past it) or above
    the last position; one kernel launch."""
    rng = np.random.default_rng(K)
    R = 5000
    counts = rng.choice([0, 1, 2, 5, 40], R, p=[0.4, 0.3, 0.15, 0.1, 0.05]).astype(np.int32)
    pos = (np.cumsum(counts) - counts - 50).astype(np.int32)
    keep = counts > 0
    n = R // 3 if out_len == "below" else int(pos[-1]) + 1000
    if dtype == torch.int32:
        vals = [rng.integers(-(1 << 23), 1 << 23, R).astype(np.int32) for _ in range(K)]
    else:
        vals = [rng.standard_normal(R).astype(np.float32) for _ in range(K)]
    args = (torch.from_numpy(pos).to(cuda), torch.from_numpy(keep).to(cuda),
            [torch.from_numpy(v).to(cuda) for v in vals], n)
    n0 = kland.monotone_land.launches
    got = kland.monotone_land(*args)
    assert kland.monotone_land.launches == n0 + 1
    want = plain_land.monotone_land(*args)
    assert len(got) == K
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == (n,) and torch.equal(g, w)
    assert bool((pos < 0)[keep].any()) and bool((pos >= n)[keep].any()) == (out_len == "below")


def _scan_columns(rng, N, k, op):
    """[N, k] int32 column data: for sums values over the whole int32
    range (the sums wrap); for max mostly negatives, with -1 fills and
    INT32_MIN."""
    i32 = np.iinfo(np.int32)
    if op == "sum":
        x = rng.integers(i32.min, i32.max, (N, k), dtype=np.int64, endpoint=True)
        return x.astype(np.int32)
    x = rng.integers(-(1 << 30), 1 << 20, (N, k), dtype=np.int64)
    x[rng.random((N, k)) < 0.3] = -1
    x[rng.random((N, k)) < 0.05] = i32.min
    return x.astype(np.int32)


@pytest.mark.parametrize("op", ["sum", "max"])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 8])
@pytest.mark.parametrize("N", [1, 31, 8191, 8192, 8193, 3 * 8192 + 5, (1 << 20) + 3])
def test_torch_column_scan_kernel_matches_plain(cuda, N, k, op):
    """Kernel I against its plain version, bit for bit, on the card's
    tensors and on CPU copies: inclusive and exclusive, with and without
    totals, the columns separate vectors or strided views of one [N, k]
    tensor (as expand_by_counts' marks are); one launch a call."""
    x = torch.from_numpy(_scan_columns(np.random.default_rng(N * 16 + k), N, k, op))
    xc = x.to(cuda)
    for cols in ([c.contiguous() for c in xc.unbind(1)], list(xc.unbind(1))):
        cpu = [c.cpu() for c in cols]
        for exclusive in (False, True):
            for totals in (False, True):
                n0 = kscan.column_scan.launches
                got = kscan.column_scan(cols, op, exclusive, totals)
                assert kscan.column_scan.launches == n0 + 1
                want = plain_ops.column_scan_plain(cols, op, exclusive, totals)
                want_cpu = kscan.column_scan(cpu, op, exclusive, totals)
                got, want, want_cpu = ((got, want, want_cpu) if totals
                                       else ((got,), (want,), (want_cpu,)))
                assert got[0].shape == (k, N) and got[0].is_contiguous()
                for g, w, wc in zip(got, want, want_cpu):
                    assert g.dtype == torch.int32
                    assert torch.equal(g, w) and torch.equal(g.cpu(), wc)


@pytest.mark.parametrize("op", ["sum", "max"])
def test_torch_column_scan_kernel_replays_in_a_captured_graph(cuda, op):
    """Kernel I captured into a CUDA graph (its scratch from the graph's
    pool) and replayed on new column data equals the eager call on that
    data; a replay counts no launch."""
    rng = np.random.default_rng(23)
    N, k = 3 * 8192 + 5, 3
    first, second = (torch.from_numpy(_scan_columns(rng, N, k, op)).to(cuda) for _ in range(2))
    static = [c.contiguous() for c in first.unbind(1)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kscan.column_scan(static, op, True, True)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out, tot = kscan.column_scan(static, op, True, True)
    for st, c in zip(static, second.unbind(1)):
        st.copy_(c)
    n0 = kscan.column_scan.launches
    graph.replay()
    torch.cuda.synchronize()
    assert kscan.column_scan.launches == n0
    want_out, want_tot = kscan.column_scan([c.contiguous() for c in second.unbind(1)], op,
                                           True, True)
    assert torch.equal(out, want_out) and torch.equal(tot, want_tot)


def test_torch_fine_kernel_resolved_matches_plain(cuda):
    """Kernel B's resolved branch on an MSAA frame's resolved rows, and on
    rows made negative wherever a path covers: a row in [0, 1] reads the
    same under either rule and under none, so only rows that leave [0, 1]
    show that the switch is read."""
    stages, layout_t, ramps_t, caps, ld = _inputs(cuda)
    cmds, counted = stages["cmds"], stages["counted"]
    t2r = tile_last_record(cmds["tile_start"], cmds["tile_end"])
    for mode in ("msaa8", "area"):
        area, ids, _ = compute_area_rows(cmds, counted, dict(caps, aa_mode=mode))
        if mode == "area":
            area = -1.5 * area.abs()
        rec = build_records(dict(cmds, area_row=ids), caps)
        args = (rec, area, ramps_t, layout_t["base_color"], cmds["tile_start"],
                cmds["tile_end"], layout_t["width_in_tiles"], None)
        img = assemble_compact(composite_records(*args, True), t2r, ld)
        img_p = assemble_compact(composite_records_plain(*args, True), t2r, ld)
        by_rule = assemble_compact(composite_records(*args, False), t2r, ld)
        torch.cuda.synchronize()
        assert not torch.isnan(img).any()
        assert (img - img_p).abs().max().item() <= 1e-4
        assert ((img - by_rule).abs().max().item() > 1e-3) == (mode == "area")


def test_torch_fine_kernel_matches_plain(cuda):
    stages, layout_t, ramps_t, caps, ld = _inputs(cuda)
    cmds, counted = stages["cmds"], stages["counted"]
    area, ids, _ = compute_area_rows(cmds, counted, caps)
    rec = build_records(dict(cmds, area_row=ids), caps)
    args = (rec, area, ramps_t, layout_t["base_color"], cmds["tile_start"], cmds["tile_end"],
            layout_t["width_in_tiles"])
    n0 = composite_records.launches
    out = composite_records(*args)
    assert composite_records.launches == n0 + 1
    out_p = composite_records_plain(*args)
    t2r = tile_last_record(cmds["tile_start"], cmds["tile_end"])
    img = assemble_compact(out, t2r, ld)
    img_p = assemble_compact(out_p, t2r, ld)
    torch.cuda.synchronize()
    assert not torch.isnan(img).any()
    assert (img - img_p).abs().max().item() <= 1e-4


def test_torch_image_tap_kernel_matches_plain(cuda, monkeypatch):
    """Kernel F on the tap's own compacted records: within 1e-6 of the
    plain version (the same four products and three sums per channel, not
    contracted), region flag equal, zero rows past the image count."""
    cmds, _, rec, atlas_t, layout_t, _, caps, _ = _image_inputs(cuda)
    calls = []
    tap = ktap.tap_records

    def spy(*args):
        calls.append(args)
        return tap(*args)

    spy.launches = 0
    monkeypatch.setattr(ktap, "tap_records", spy)
    fg_tab, region_ovf, recs_ovf = plain_tap.image_tap(rec, cmds, atlas_t, layout_t, caps)
    monkeypatch.undo()
    (args,) = calls
    assert not bool(region_ovf) and not bool(recs_ovf)
    n0 = ktap.tap_records.launches
    got, got_flag = ktap.tap_records(*args)
    assert ktap.tap_records.launches == n0 + 1
    want, want_flag = plain_tap.tap_records_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, fg_tab)
    assert bool(got_flag) == bool(want_flag) is False
    assert (got - want).abs().max().item() <= 1e-6
    n_img = int((args[0][:, 0] == 5).sum())
    assert 0 < n_img < got.shape[0] and not got[n_img:].any() and got[:n_img].any()
    # A record that minifies past the region windows: zeros and the flag.
    bad = args[0].clone()
    bad[0, 6:10] = torch.tensor([64.0, 0.0, 0.0, 64.0]).view(torch.int32).to(cuda)
    bad[0, 13] = (2048 << 16) | 2048
    got, got_flag = ktap.tap_records(bad, *args[1:])
    want, want_flag = plain_tap.tap_records_plain(bad, *args[1:])
    assert bool(got_flag) and bool(want_flag) and not got[0].any()
    assert (got - want).abs().max().item() <= 1e-6


@pytest.mark.parametrize("seed", [0, 1])
def test_torch_image_tap_kernel_synthetic(cuda, seed):
    """Kernel F on random records (rotated, sheared, mirrored, magnified,
    minified past MAX_WIN windows, a few ulps off a texel boundary; images
    at every atlas edge) with zero rows past them: equal to the plain
    version (the same operations in the same order), region flag equal,
    zero rows past the count and for the records past MAX_WIN; without
    those records the flag is clear."""
    rec, atlas = random_tap_records(seed)
    rows = torch.cat([torch.from_numpy(rec.view(np.int32)),
                      torch.zeros((40, 16), dtype=torch.int32)]).to(cuda)
    a = torch.from_numpy(atlas).to(cuda)
    wit = torch.full((), 8, dtype=torch.int32, device=cuda)  # the layout's width in tiles
    n0 = ktap.tap_records.launches
    got, flag = ktap.tap_records(rows, a, wit, 64)
    assert ktap.tap_records.launches == n0 + 1
    want, want_flag = plain_tap.tap_records_plain(rows, a, wit, 64)
    torch.cuda.synchronize()
    assert flag.shape == () and flag.dtype == torch.bool
    assert bool(flag) and bool(want_flag)
    assert torch.equal(got, want)
    assert not got[rec.shape[0]:].any()
    g = plain_tap.tap_geometry(rows, 8, 64)
    bad = plain_tap.region_bad(g, a.shape[1], a.shape[2]) & g["valid"]
    assert bad.any() and not got[bad].any()
    got2, flag2 = ktap.tap_records(rows[~bad].contiguous(), a, wit, 64)
    want2, _ = plain_tap.tap_records_plain(rows[~bad].contiguous(), a, wit, 64)
    torch.cuda.synchronize()
    assert not bool(flag2) and torch.equal(got2, want2)


def test_torch_fine_kernel_with_images_matches_plain(cuda):
    cmds, area, rec, atlas_t, layout_t, ramps_t, caps, ld = _image_inputs(cuda)
    fg_tab, _, _ = plain_tap.image_tap(rec, cmds, atlas_t, layout_t, caps)
    args = (rec, area, ramps_t, layout_t["base_color"], cmds["tile_start"], cmds["tile_end"],
            layout_t["width_in_tiles"])
    n0 = composite_records.launches
    out = composite_records(*args, fg_tab)
    assert composite_records.launches == n0 + 1
    out_p = composite_records_plain(*args, fg_tab)
    t2r = tile_last_record(cmds["tile_start"], cmds["tile_end"])
    img = assemble_compact(out, t2r, ld)
    img_p = assemble_compact(out_p, t2r, ld)
    torch.cuda.synchronize()
    assert not torch.isnan(img).any()
    assert (img - img_p).abs().max().item() <= 1e-4
    # The table is what paints the image records: without it they are the
    # identity and the frame differs.
    bare = assemble_compact(composite_records(*args), t2r, ld)
    assert (img - bare).abs().max().item() > 0.05


@pytest.mark.parametrize("depth", [2, 60])
def test_torch_interpreter_kernels_match_plain(cuda, depth):
    """Kernels G and H on the hand-built slab (every record kind, depth up
    to BD and one past it at BD 2, a clip-zero group, a tripped image
    record): premultiplied rows within 1e-5 of the plain version, H within
    1e-6 of G, overflow words equal. At BD 60 G's stack exceeds a CTA's
    shared memory and lives in the global scratch."""
    h = dict(hand_built_slab(seed=5), BD=depth)
    args = interpret_args(h, cuda)
    n0, n1 = kint.interpret_tiles.launches, kint.interpret_tiles.launches_batch
    got_g, ovf_g = kint.interpret_tiles(*args)
    got_h, ovf_h = kint.interpret_tiles(*args, batch=True)
    assert kint.interpret_tiles.launches == n0 + 1
    assert kint.interpret_tiles.launches_batch == n1 + 1
    want, ovf_p = plain_int.interpret_plain(*args)
    torch.cuda.synchronize()

    def premul(o):
        return torch.cat([o[:, :3] * o[:, 3:4], o[:, 3:4]], dim=1)

    assert torch.equal(ovf_g, ovf_p) and torch.equal(ovf_h, ovf_p)
    assert int(ovf_g[4]) == 2 and int(ovf_g[8]) == (1 if depth == 2 else 0)
    assert not torch.isnan(got_g).any()
    assert (premul(got_g) - premul(want)).abs().max().item() <= 1e-5
    assert (premul(got_h) - premul(got_g)).abs().max().item() <= 1e-6


@pytest.mark.parametrize("depth", [2, 8, 60])
def test_torch_interpreter_kernels_deep_tapes(cuda, depth):
    """Kernels G and H on the deep tapes (a push at every depth up to BD
    and one past it: at BD 2 in G's shared levels, at 8 and 60 also in its
    global scratch; tapes of 0, 1 and MC records, MC 40 or 192, across
    G's 32-record staging chunks; a clip-zero group past a chunk; rowless
    fills; the hand-built programs with a tripped image record):
    premultiplied rows within 1e-5 of the plain version, H within 1e-6 of
    G, overflow words equal."""
    h, k = deep_slab(depth)
    args = interpret_args(h, cuda)
    got_g, ovf_g = kint.interpret_tiles(*args)
    got_h, ovf_h = kint.interpret_tiles(*args, batch=True)
    want, ovf_p = plain_int.interpret_plain(*args)
    torch.cuda.synchronize()

    def premul(o):
        return torch.cat([o[:, :3] * o[:, 3:4], o[:, 3:4]], dim=1)

    assert torch.equal(ovf_g, ovf_p) and torch.equal(ovf_h, ovf_p)
    assert int(ovf_g[k["past_bd"]]) == 1 and int(ovf_g[k["to_bd"]]) == 0
    assert int(ovf_g[4]) == 2
    assert not torch.isnan(got_g).any()
    assert (premul(got_g) - premul(want)).abs().max().item() <= 1e-5
    assert (premul(got_h) - premul(got_g)).abs().max().item() <= 1e-6


@pytest.mark.parametrize("seed", [1, 2])
def test_torch_interpreter_kernel_image_branch_matches_plain(cuda, seed):
    """Kernel G's image branch on tapes of solid and image records with no
    clip pair (the legacy tiles of a clip-free image frame under
    JELLO_IMAGE_TAP=0): premultiplied rows within 1e-5 of the plain
    version (`walk_tapes`), overflow words equal; images sample the atlas
    and the largest minifications raise the region bit in both."""
    h = solid_image_slab(seed)
    args = interpret_args(h, cuda)
    got, ovf = kint.interpret_tiles(*args)
    want, ovf_p = plain_int.interpret_plain(*args)
    no_atlas, _ = plain_int.interpret_plain(*args[:6], None, *args[7:])
    torch.cuda.synchronize()

    def premul(o):
        return torch.cat([o[:, :3] * o[:, 3:4], o[:, 3:4]], dim=1)

    kinds = h["slab"][:, :, 0][np.arange(h["slab"].shape[1]) < h["counts"][:, None]]
    assert (kinds == 5).sum() > 100 and (kinds == 1).sum() > 100
    assert torch.equal(ovf, ovf_p) and bool((ovf != 0).any()) and bool((ovf == 0).any())
    assert not torch.isnan(got).any()
    assert (premul(got) - premul(want)).abs().max().item() <= 1e-5
    assert (premul(want) - premul(no_atlas)).abs().max().item() > 1e-2


def test_torch_interpreter_kernels_resolved_match_plain(cuda):
    """The resolved branch of G and H on the hand-built slab, whose rows
    range over [-2.5, 2.5]: a row is clipped to [0, 1] whatever the rule
    and the kind."""
    args = interpret_args(hand_built_slab(seed=5), cuda)
    got_g, ovf_g = kint.interpret_tiles(*args, False, True)
    got_h, ovf_h = kint.interpret_tiles(*args, True, True)
    want, ovf_p = plain_int.interpret_plain(*args, resolved=True)
    by_rule, _ = kint.interpret_tiles(*args)
    torch.cuda.synchronize()
    assert torch.equal(ovf_g, ovf_p) and torch.equal(ovf_h, ovf_p)
    assert not torch.isnan(got_g).any()
    assert (got_g - want).abs().max().item() <= 1e-4
    assert (got_h - got_g).abs().max().item() <= 1e-6
    assert (got_g - by_rule).abs().max().item() > 1e-2


def _clip_inputs(cuda, build):
    """Stages of a clip scene on the card, with the calls of the two fine
    kernels recorded from one pass of the hybrid fine stage."""
    s, ld, ramps, atlas, caps = prepare_with_atlas(*build(jello_tpu))
    caps = dict(caps, clip_depth_cap=4)
    if atlas is not None:
        caps["_image_tap"] = True
    scene_t, layout_t, ramps_t, _ = upload(s, ld, ramps, {}, cuda)
    atlas_t = upload_atlas(atlas, cuda)
    stages, flags, _ = geometry(scene_t, layout_t, caps)
    assert not any(bool(v) for v in flags.values())
    return stages, ramps_t, atlas_t, layout_t, caps, ld


def test_torch_fine_kernel_with_clip_groups_matches_plain(cuda, monkeypatch):
    """Kernel B's clip-group pass on the records the hybrid stage packs
    for a scene with depth-1 src-over groups (alpha, rowless EndClips, a
    zero-coverage group): the assembled image within 1e-4 of the plain
    version's two scans."""
    from .test_torch_fine_hybrid import GROUP_SCENES

    stages, ramps_t, atlas_t, layout_t, caps, ld = _clip_inputs(
        cuda, GROUP_SCENES["alpha_groups"][0])
    calls = []
    real = kfine.composite_records

    def spy(*args):
        calls.append(args)
        return real(*args)

    spy.launches = 0
    monkeypatch.setattr(kfine, "composite_records", spy)
    (compact, t2r), flags = khybrid.fine_hybrid(stages["cmds"], stages["counted"], ramps_t,
                                                atlas_t, layout_t, caps)
    monkeypatch.undo()
    assert not any(bool(v) for v in flags.values())
    (args,) = calls
    assert int(((args[0][:, 4] & 32) != 0).sum()) > 0  # group EndClips
    n0 = composite_records.launches
    out = composite_records(*args)
    assert composite_records.launches == n0 + 1
    out_p = composite_records_plain(*args)
    img = assemble_compact(out, t2r, ld)
    img_p = assemble_compact(out_p, t2r, ld)
    torch.cuda.synchronize()
    assert not torch.isnan(img).any()
    assert (img - img_p).abs().max().item() <= 1e-4
    assert torch.equal(assemble_compact(compact, t2r, ld), img)  # no legacy tile


@pytest.mark.parametrize("case", ["gradients", "images_and_stroke", "clips_and_blends",
                                  "mix_stack"])
def test_torch_cuda_renderer_matches_oracle(cuda, case, monkeypatch):
    build = {"gradients": _gradient_scene, "images_and_stroke": _image_scene,
             "clips_and_blends": full_scene, "mix_stack": CLIP_SCENES["mix_stack"]}[case]
    ref, _, _ = render_numpy(*build(jello_tpu))
    fns = [coverage_rows, composite_records] + [getattr(m, n) for m, n in WRAPPERS]
    if case in ("images_and_stroke", "clips_and_blends"):
        fns.append(ktap.tap_records)
    if case in ("clips_and_blends", "mix_stack"):
        fns.append(kint.interpret_tiles)
        # The same frame through kernel H.
        monkeypatch.setenv("JELLO_INTERP_BATCH", "1")
        n_h = kint.interpret_tiles.launches_batch
        r_h = Renderer(device="cuda")
        img_h = r_h.render(*build(jello_tpu_torch))
        assert kint.interpret_tiles.launches_batch > n_h and not any(r_h.last_flags.values())
        assert np.abs(img_h - ref).max() <= 2e-3
        monkeypatch.delenv("JELLO_INTERP_BATCH")
    before = [fn.launches for fn in fns]
    r = Renderer(device="cuda")
    img = r.render(*build(jello_tpu_torch))
    assert not any(r.last_flags.values())
    assert all(fn.launches > n for fn, n in zip(fns, before))
    assert np.abs(img - ref).max() <= 2e-3


@pytest.mark.parametrize("aa", ["MSAA8", "MSAA16"])
@pytest.mark.parametrize("case", ["gradients", "images_and_stroke", "clips_and_blends"])
def test_torch_cuda_renderer_msaa_matches_plain(cuda, case, aa):
    """An MSAA frame on the card against `Renderer(device="cpu")`, the
    plain versions: 2e-3 (the paints' transcendentals; coverage is equal).
    Kernel A's MSAA entry runs, the area entry does not."""
    build = {"gradients": _gradient_scene, "images_and_stroke": _image_scene,
             "clips_and_blends": full_scene}[case]
    scene, params = build(jello_tpu_torch)
    params.antialiasing_method = getattr(jello_tpu_torch.AaConfig, aa)
    ref = Renderer(device="cpu").render(scene, params)
    n0, n1 = coverage_rows.launches, coverage_rows.launches_msaa
    r = Renderer(device="cuda")
    img = r.render(scene, params)
    assert not any(r.last_flags.values())
    assert coverage_rows.launches == n0 and coverage_rows.launches_msaa > n1
    assert np.abs(img - ref).max() <= 2e-3


def test_torch_cuda_renderer_reroutes_an_over_minified_image(cuda):
    """`image_region_overflow` on the card: the frame runs again through
    the reference fine stage and matches the CPU's."""
    scene, params = over_minified(jello_tpu_torch)
    ref = Renderer(device="cpu").render(scene, params)
    r = Renderer(device="cuda")
    img = r.render(scene, params)
    assert ["image_region_overflow: rerouted to fine_ref"] in r.last_retries
    assert not any(r.last_flags.values())
    assert np.abs(img - ref).max() <= 2e-3


def test_torch_kernel_wrappers_reject_bad_inputs(cuda):
    stages, layout_t, ramps_t, caps, _ = _inputs(cuda)
    stream, rs, re_, bd, eo, _, _ = plain_cov.slot_rank_rows(
        stages["cmds"], stages["counted"], dict(caps, aa_mode="msaa8"))
    with pytest.raises(ValueError):  # only the two built-in sample patterns
        coverage_rows(stream, rs, re_, bd, [(0.5, 0.5)], eo)
    with pytest.raises(ValueError):
        coverage_rows(stream, rs, re_, bd, plain_cov.sample_offsets("msaa8"), eo.float())
    with pytest.raises(ValueError):
        coverage_rows(stream.double(), rs, re_, bd)
    with pytest.raises(ValueError):
        coverage_rows(stream, rs.cpu(), re_, bd)
    table = torch.zeros((64, 21), dtype=torch.float32, device=cuda)
    valid = torch.ones(64, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError):
        kwalk.lockstep_walk(table.double(), valid, 8)
    with pytest.raises(ValueError):
        kland.monotone_land(valid.to(torch.int64), valid, [valid], 64)
    pos = torch.zeros(64, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):  # values of another type than int32 or float32
        kland.monotone_land(pos, valid, [valid], 64)
    with pytest.raises(ValueError):  # at most three value vectors
        kland.monotone_land(pos, valid, [pos] * 4, 64)
    with pytest.raises(ValueError):  # int32 columns only
        kscan.column_scan([pos.long()], "sum")
    with pytest.raises(ValueError):  # at most eight columns, all on one device
        kscan.column_scan([pos] * 9, "sum")
    with pytest.raises(ValueError):
        kscan.column_scan([pos, pos.cpu()], "max")
    args = list(interpret_args(hand_built_slab(), cuda))
    with pytest.raises(ValueError):
        kint.interpret_tiles(*args[:4], args[4].cpu(), *args[5:])
    with pytest.raises(ValueError):
        kint.interpret_tiles(*args[:3], args[3][:, :, :8].contiguous(), *args[4:])
    with pytest.raises(ValueError):  # rows not 16-byte aligned
        kint.interpret_tiles(*args[:4], args[4].view(-1)[1:257].view(1, 256), *args[5:])
