"""The port's record-stream fine stage (plain version on the CPU): record
packing vs jello_tpu's, the assembled image vs the numpy oracle
(render_numpy) within 2e-3, the segmented scan vs a record-by-record
walk, and the resolved-coverage branch (an MSAA frame's rows, read as they
are) vs the oracle under msaa8 and msaa16."""

import numpy as np
import pytest
import torch

import jello_tpu as jt
from jello_tpu.cpu import render_numpy
from jello_tpu.pipeline import coverage as np_cov
from jello_tpu.renderer.params import RenderParams

from jello_tpu_torch.cuda import fine_v2 as fv
from jello_tpu_torch.cuda.fine_v2 import (
    assemble_compact,
    build_records,
    composite_records,
    fine_v2,
    tile_last_record,
)
from jello_tpu_torch.cuda.render import upload
from jello_tpu_torch.pipeline.render import geometry

from .torch_reference import (
    as_np,
    check_msaa_frame,
    numpy_geometry,
    prepare,
    tree_to_torch,
    u32,
)

IDENT = jt.Affine.identity()
WHITE = jt.Color.rgba(1, 1, 1, 1)
TOL = 2e-3


def _solid_rules():
    s = jt.Scene()
    s.fill(jt.Fill.NON_ZERO, IDENT, jt.SolidBrush(jt.Color.rgba(1, 0, 0, 0.8)), None,
           jt.BezPath().move_to(10, 10).cubic_to(80, 0, 120, 100, 60, 120).close())
    star = jt.BezPath().move_to(64, 4).line_to(100, 120).line_to(4, 44).line_to(124, 44)
    s.fill(jt.Fill.EVEN_ODD, IDENT, jt.SolidBrush(jt.Color.rgba(0, 0, 1, 0.5)), None,
           star.line_to(28, 120).close())
    s.fill(jt.Fill.NON_ZERO, IDENT, jt.SolidBrush(jt.Color.rgba(0, 0.6, 0, 0.6)), None,
           jt.BezPath().move_to(64, 4).line_to(100, 120).line_to(4, 44).line_to(124, 44)
           .line_to(28, 120).close())
    return s, RenderParams(width=128, height=128, base_color=WHITE)


def _gradients(extend):
    def stops(a, b, c):
        return (jt.ColorStop(0.0, jt.Color.rgba(*a, 1)), jt.ColorStop(0.4, jt.Color.rgba(*b, 0.6)),
                jt.ColorStop(1.0, jt.Color.rgba(*c, 1)))

    st = stops((1, 0, 0), (0, 1, 0), (0, 0, 1))
    st2 = stops((1, 1, 0), (0, 1, 1), (1, 0, 1))
    tri = [((5, 5), (60, 8), (50, 60)), ((68, 4), (124, 10), (100, 60)),
           ((4, 68), (60, 70), (40, 124)), ((68, 68), (124, 70), (100, 124)),
           ((30, 40), (98, 36), (64, 100))]
    brushes = [
        jt.LinearGradient((10, 10), (40, 20), st, extend),
        jt.RadialGradient((96, 30), 0.0, (96, 30), 14, st2, extend),          # circular
        jt.RadialGradient((20, 90), 4.0, (36, 100), 12, st, extend),          # cone
        jt.RadialGradient((90, 90), 10.0, (100, 96), 0.0, st2, extend),       # swapped
        jt.SweepGradient((64, 64), 0.3, 2.2, st, extend),
    ]
    s = jt.Scene()
    for (a, b, c), g in zip(tri, brushes):
        s.fill(jt.Fill.NON_ZERO, IDENT, jt.GradientBrush(g), None,
               jt.BezPath().move_to(*a).line_to(*b).line_to(*c).close())
    s.fill(jt.Fill.NON_ZERO, IDENT,
           jt.GradientBrush(jt.RadialGradient((64, 64), 8.0, (80, 64), 8.0, st2, extend)),
           None, jt.BezPath().move_to(56, 56).line_to(90, 56).line_to(90, 72)
           .line_to(56, 72).close())                                           # strip
    return s, RenderParams(width=128, height=128, base_color=jt.Color.rgba(0.2, 0.3, 0.4, 1))


def _many_small_paths():
    rng = np.random.default_rng(7)
    s = jt.Scene()
    for _ in range(120):
        cx, cy = rng.random(2) * 240
        r = 4 + 10 * rng.random()
        p = (jt.BezPath().move_to(cx - r, cy).line_to(cx, cy - r)
             .line_to(cx + r, cy).line_to(cx, cy + r).close())
        s.fill(jt.Fill.NON_ZERO, IDENT,
               jt.SolidBrush(jt.Color.rgba(*rng.random(3), 0.7)), None, p)
    return s, RenderParams(width=256, height=256, base_color=WHITE)


def _many_stops():
    """Gradients of 30 stops: stop-table rows wider than the 128 words
    of the TPU kernel's lane row."""
    rng = np.random.default_rng(9)
    st = tuple(jt.ColorStop(o, jt.Color.rgba(*rng.random(3), 0.4 + 0.6 * rng.random()))
               for o in np.sort(rng.random(30)))
    s = jt.Scene()
    for g, (a, b, c) in (
            (jt.LinearGradient((4, 4), (60, 30), st), ((5, 5), (120, 10), (60, 60))),
            (jt.RadialGradient((64, 90), 0.0, (64, 90), 40, st, jt.Extend.REFLECT),
             ((4, 60), (124, 64), (64, 124))),
            (jt.SweepGradient((64, 64), 0.0, 1.0, st, jt.Extend.REPEAT),
             ((30, 30), (100, 40), (70, 110)))):
        s.fill(jt.Fill.NON_ZERO, IDENT, jt.GradientBrush(g), None,
               jt.BezPath().move_to(*a).line_to(*b).line_to(*c).close())
    return s, RenderParams(width=128, height=128, base_color=WHITE)


CASES = {
    "solid_rules": _solid_rules,
    "grad_30_stops": _many_stops,
    "grad_pad": lambda: _gradients(jt.Extend.PAD),
    "grad_repeat": lambda: _gradients(jt.Extend.REPEAT),
    "grad_reflect": lambda: _gradients(jt.Extend.REFLECT),
    "many_small_paths": _many_small_paths,
}


def _port_fine(scene, params):
    """The port's stages and `fine_v2` on a jello_tpu scene, in the
    antialiasing mode of its params."""
    s, ld, ramps, caps = prepare(scene, params)
    caps["aa_mode"] = params.antialiasing_method.value
    scene_t, layout_t, ramps_t, caps = upload(s, ld, ramps, caps, "cpu")
    stages, flags, _ = geometry(scene_t, layout_t, caps)
    (compact, t2r), fflags = fine_v2(stages["cmds"], stages["counted"], ramps_t, None,
                                     layout_t, caps)
    flags.update(fflags)
    assert not any(bool(v) for v in flags.values()), flags
    return as_np(assemble_compact(compact, t2r, ld))


@pytest.mark.parametrize("name", sorted(CASES))
def test_torch_fine_plain_matches_oracle(name):
    scene, params = CASES[name]()
    img = _port_fine(scene, params)
    ref, flags, _ = render_numpy(scene, params)
    assert not any(bool(v) for v in flags.values())
    assert img.shape == ref.shape
    assert np.abs(img - ref).max() <= TOL


@pytest.mark.parametrize("name", ["solid_rules", "grad_reflect"])
def test_torch_build_records_matches_jello_tpu(name):
    from jello_tpu.tpu.fine_pallas import build_records as np_build_records

    scene, params = CASES[name]()
    s, ld, _, caps = prepare(scene, params)
    ref = numpy_geometry(s, ld, caps)
    with np.errstate(all="ignore"):
        _, area_row, _ = np_cov.compute_area_rows(np, ref["cmds"], ref["counted"], caps)
        cmds = dict(ref["cmds"], area_row=area_row)
        want = np_build_records(np, cmds, s, ref["info"], caps)
    got = build_records(tree_to_torch(cmds), caps)
    np.testing.assert_array_equal(u32(as_np(got)), u32(want))


@pytest.mark.parametrize("aa", ["msaa8", "msaa16"])
@pytest.mark.parametrize("name", ["solid_rules", "grad_reflect"])
def test_torch_fine_plain_resolved_matches_oracle(name, aa):
    """Plain kernel B's resolved branch on the plain MSAA rows: both fill
    rules (an even-odd star whose winding reaches 2), and gradient paints.
    The port's stages take jello_tpu's scene words here, so one scene
    serves both sides."""
    scene, params = CASES[name]()
    params.antialiasing_method = jt.AaConfig(aa)
    built = ((scene, params), (scene, params))
    img, _ = check_msaa_frame(_port_fine, built)
    params_area = CASES[name]()[1]
    assert np.abs(img - _port_fine(scene, params_area)).max() > 0.05


def _bits(x):
    return x.view(torch.int32)  # -0 and +0 differ, as do NaNs


@pytest.mark.parametrize("aa", ["area", "msaa8", "msaa16"])
@pytest.mark.parametrize("name", ["solid_rules", "grad_reflect"])
def test_torch_fine_plain_skips_the_padding_bit_for_bit(name, aa, monkeypatch):
    """`composite_records_plain` paints and scans only the records before
    the class's padding. Held, on a frame's records, to the scan of every
    record, which one more record in range at the end forces (a record's
    output reads only the records before it), bit for bit; so on the
    stream cut after its last record in range (the last record valid);
    and so on the records all out of range, a stream that is all
    padding."""
    calls = []
    plain = fv.composite_records_plain
    monkeypatch.setattr(fv, "composite_records_plain",
                        lambda *a: calls.append(a) or plain(*a))
    scene, params = CASES[name]()
    params.antialiasing_method = jt.AaConfig(aa)
    _port_fine(scene, params)
    assert calls
    for rec, cov, *rest in calls:
        PC, n_tiles = rec.shape[0], rest[2].shape[0]
        tile = rec[:, 3]
        assert not bool(((tile >= 0) & (tile < n_tiles))[-1])  # padding to skip
        first = int(torch.nonzero((tile >= 0) & (tile < n_tiles))[0, 0])

        def whole(rec):
            more = rec[first:first + 1].clone()
            more[:, 3] = n_tiles - 1
            return plain(torch.cat([rec, more]), torch.cat([cov[:PC], cov[first:first + 1]]),
                         *rest)[:PC]

        got = plain(rec, cov, *rest)
        assert torch.equal(_bits(got), _bits(whole(rec)))
        # Cut after the last record in range: no padding, the last tile's
        # run painted and scanned as before.
        m = int(torch.nonzero((tile >= 0) & (tile < n_tiles))[-1, 0]) + 1
        assert torch.equal(_bits(plain(rec[:m], cov[:m], *rest)), _bits(got[:m]))
        padding = rec.clone()
        padding[:, 3] = n_tiles
        assert not torch.equal(got, plain(padding, cov, *rest))
        assert torch.equal(_bits(plain(padding, cov, *rest)), _bits(whole(padding)))


def test_torch_fine_resolved_switch_clips_rows_and_applies_no_rule():
    """`resolved` on hand-made rows that leave [0, 1]: coverage is the row
    clipped to [0, 1] whatever the record's rule; a rowless record still
    covers fully. (On a row inside [0, 1] both rules and the clip agree, so
    a real MSAA frame cannot show that the switch is read.)"""
    rng = np.random.default_rng(8)
    PC = 12
    rec = np.zeros((PC, 16), np.int32)
    rec[:, 0] = 1
    rec[:, 1] = np.where(np.arange(PC) % 4 == 3, -1, np.arange(PC))
    rec[:, 3] = np.arange(PC)  # one record a tile
    rec[:, 4] = np.arange(PC) % 2  # even-odd on every other record
    rgba = np.array([0.2, 0.4, 0.6, 0.8], np.float32)
    rec[:, 5:9] = rgba.view(np.int32)
    cov = ((rng.random((PC, 256)) - 0.4) * 4).astype(np.float32)
    base = np.array([0.0, 0.0, 0.0, 0.0], np.float32)
    start = torch.arange(PC, dtype=torch.int32)
    wit = torch.tensor(4, dtype=torch.int32)
    out = composite_records(torch.from_numpy(rec), torch.from_numpy(cov),
                            torch.zeros((1, 11)), torch.from_numpy(base), start, start + 1, wit,
                            None, True)
    c = np.where(rec[:, 1:2] >= 0, np.clip(cov, 0.0, 1.0), 1.0)
    np.testing.assert_allclose(as_np(out)[:, 3], rgba[3] * c, atol=1e-6)
    by_rule = composite_records(torch.from_numpy(rec), torch.from_numpy(cov),
                                torch.zeros((1, 11)), torch.from_numpy(base), start, start + 1,
                                wit)
    assert (out - by_rule).abs().max() > 0.1


def test_torch_fine_scan_matches_record_walk():
    """The plain version's segmented scan equals compositing each tile's
    records one by one (solid colors, both fill rules, rowless records,
    tiles out of range)."""
    rng = np.random.default_rng(4)
    PC, grid, wit = 60, 6, 3
    tiles = np.sort(rng.integers(0, grid + 1, PC)).astype(np.int32)
    rec = np.zeros((PC, 16), np.int32)
    rec[:, 0] = 1  # CMD_COLOR
    rec[:, 1] = np.where(rng.random(PC) < 0.2, -1, np.arange(PC))
    rec[:, 3] = tiles
    rec[:, 4] = (rng.random(PC) < 0.5).astype(np.int32)
    a = rng.random((PC, 1)).astype(np.float32)
    rgba = (rng.random((PC, 3)) * a).astype(np.float32)
    rec[:, 5:8] = rgba.view(np.int32)
    rec[:, 8:9] = a.view(np.int32)
    cov = ((rng.random((PC, 256)) - 0.5) * 5).astype(np.float32)
    base = np.array([0.1, 0.2, 0.3, 0.9], np.float32)
    stops = np.zeros((1, 11), np.float32)
    start = np.zeros(grid, np.int32)
    end = np.zeros(grid, np.int32)
    for t in range(grid):
        idx = np.nonzero(tiles == t)[0]
        if len(idx):
            start[t], end[t] = idx[0], idx[-1] + 1
    start_t, end_t = torch.from_numpy(start), torch.from_numpy(end)
    out = composite_records(torch.from_numpy(rec), torch.from_numpy(cov),
                            torch.from_numpy(stops), torch.from_numpy(base), start_t, end_t,
                            torch.tensor(wit, dtype=torch.int32))
    out = as_np(out)
    v = np.zeros((grid, 4, 256), np.float32)
    v[:] = base[None, :, None]
    for i in range(PC):
        t = tiles[i]
        if t >= grid:
            continue
        c = cov[i]
        c = np.abs(c - 2 * np.round(c / 2)) if rec[i, 4] & 1 else np.minimum(np.abs(c), 1)
        if rec[i, 1] < 0:
            c = np.ones(256, np.float32)
        fg = np.concatenate([rgba[i], a[i]])[:, None]
        v[t] = v[t] * (1 - fg[3] * c) + fg * c
        want = np.concatenate([v[t][:3] / np.maximum(v[t][3], 1e-6), v[t][3:]])
        np.testing.assert_allclose(out[i], want, atol=1e-5)
    t2r = tile_last_record(start_t, end_t)
    assert t2r.tolist() == [int(e) - 1 if e > s_ else -1 for s_, e in zip(start, end)]
