"""jello_tpu_torch's multi-GPU paths against jello_tpu, on the CPU.

The stage entry points of the sharded paths against jello_tpu's under
numpy, in this process: the two-level tag monoid scan and the tag-range
flatten for every shard at n = 2 and 4 (integer fields exact, lines as
tests/test_torch_stages.py holds them), `shard_caps`, `line_tables`
against the oracle's `path_count_params` and the reference fine stage
over one stripe. Then both paths, stripes (`cuda/sharded.py`) and
geometry (`cuda/sharded2.py`), at world size 4 over gloo in spawned
ranks, one spawn for every frame of the file: 19a
frames within 1e-3 of the numpy oracle, 19b frames within 8e-3 of it (under
MSAA of the oracle on float32 segments, as the port's MSAA tests hold it), and
each within 1e-3 of the port's single-device frame, with no flag raised;
the exchanged crossings reach other ranks; a small exchange raises
segs_overflow. A scene whose path tags all lie in rank 0's range, as
config 4's do, raises flatten_overflow or segs_overflow on rank 0 at the
calibrated class, and through `sharded2.RetryingRender` renders clean with
only rank 0 grown. And at world size 1, in this process.

The geometry path needs tags in every shard: a scene of fewer than
(n - 1) * 1024 path tags lies wholly in shard 0 (shard_caps aligns a
shard's tag slots to 1024), so its cross-shard monoid base is zero and no
line crosses a shard boundary. The 900-fill scene holds 3,301 tags, and
its frames run at 4,096 tag slots (1,024 a shard at n = 4), the class
jello_tpu's `estimate_caps` gives that stream: the renderer's own class
rounds tag slots up to 8,192, which would leave ranks 2 and 3 none.
"""

import dataclasses
import datetime
import functools

import numpy as np
import pytest
import torch

import jello_tpu
import jello_tpu_torch
from jello_tpu.cpu import render_numpy
from jello_tpu.pipeline import fine_ref as np_fine_ref
from jello_tpu.pipeline import flatten as np_flatten
from jello_tpu.pipeline import tiling as np_tiling
from jello_tpu.tpu import sharded2 as jax_sharded2

from jello_tpu_torch.cuda import collectives, line_dda, sharded, sharded2
from jello_tpu_torch.cuda.render import Renderer, assemble, upload, upload_atlas
from jello_tpu_torch.pipeline import fine_ref, flatten, pathtag
from jello_tpu_torch.pipeline.render import geometry
from jello_tpu_torch.renderer.estimate import estimate_caps_from_scene
from jello_tpu_torch.renderer.resolve import Resolver
from jello_tpu_torch.scenes import GATE_SCENES

from .torch_reference import (
    as_np,
    both,
    check_flatten_lines,
    full_scene,
    numpy_geometry,
    oracle_cbrt,
    prepare,
    prepare_with_atlas,
    render_numpy_f32_segments,
    tree_to_torch,
    u32,
)

WORLD = 4
TAG_SLOTS = 4096
RTOL = ATOL = 1e-5  # lines fed the oracle's cbrt (tests/test_torch_stages.py)
ORACLE_TOL = 8e-3  # the geometry-sharded frame vs the oracle (sharded2.py:576)
FRAME_TOL = 1e-3  # a sharded frame vs a single-device one (sharded.py:250)
# The limits of the waits, about three times what each takes in the suite
# (an 8-core machine under six workers): the spawn of WORLD ranks that
# renders every frame of FRAMES (the `world4` fixture, 40 s), and a
# collective of an in-process group of one rank (none waits).
SPAWN_TIMEOUT = 120.0
GROUP_TIMEOUT = datetime.timedelta(seconds=60)


def fills900(jt):
    """900 small cubic fills over 256x256, one in three even-odd: 3,301
    path tags."""
    rng = np.random.default_rng(7)
    s = jt.Scene()
    for i in range(900):
        x, y = rng.random(2) * 240
        p = jt.BezPath().move_to(x, y).cubic_to(*(np.r_[x, y, x, y, x, y]
                                                  + rng.normal(0, 12, 6))).close()
        s.fill(jt.Fill.NON_ZERO if i % 3 else jt.Fill.EVEN_ODD, jt.Affine.identity(),
               jt.SolidBrush(jt.Color.rgba(*rng.random(3), 0.7)), None, p)
    return s, jt.RenderParams(width=256, height=256, base_color=jt.Color.rgba(1, 1, 1, 1))


def rank0_lines(jt):
    """60 fills of eight random cubics over 256x256: ~600 path tags, all in
    rank 0's 2,048 tag slots at world size 4, and more Euler lines and
    crossings than half of the calibrated single-device class (what
    shard_caps gives a rank at n = 4) holds."""
    rng = np.random.default_rng(3)
    s = jt.Scene()
    for i in range(60):
        p = jt.BezPath().move_to(*(rng.random(2) * 200 + 28))
        for _ in range(8):
            p = p.cubic_to(*(rng.random(6) * 256))
        s.fill(jt.Fill.NON_ZERO if i % 2 else jt.Fill.EVEN_ODD, jt.Affine.identity(),
               jt.SolidBrush(jt.Color.rgba(*rng.random(3), 0.5)), None, p.close())
    return s, jt.RenderParams(width=256, height=256, base_color=jt.Color.rgba(1, 1, 1, 1))


@functools.lru_cache(maxsize=None)
def _fills():
    """The 900-fill scene through both packages, and jello_tpu's inputs
    at TAG_SLOTS tag slots."""
    built = both(fills900)
    s, ld, ramps, caps = prepare(*built[0])
    assert int(ld["n_path_tags"]) > 3 * 1024
    caps["n_tag_slots"] = TAG_SLOTS
    return built, s, ld, ramps, caps


def _exact(a, b):
    np.testing.assert_array_equal(np.asarray(a).astype(np.int64), as_np(b).astype(np.int64))


def _line_rows(fl):
    """The valid lines of a flatten output as sorted rows (path, x0, y0,
    x1, y1), float64."""
    v = as_np(fl["line_valid"])
    rows = np.stack([as_np(fl["line_path"])[v].astype(np.float64)]
                    + [as_np(fl[k])[v].astype(np.float64)
                       for k in ("line_x0", "line_y0", "line_x1", "line_y1")], 1)
    return rows[np.lexsort(rows.T[::-1])]


@pytest.mark.parametrize("n", [2, 4])
def test_torch_flatten_shards_match_numpy(n):
    """Every shard's delta totals, rebased monoid scan and tag-range
    flatten equal jello_tpu's (the valid lines in its order,
    `check_flatten_lines`); the shards' lines together are the
    unsharded flatten's, and their bbox accumulators and marker fields
    combine into its per-path outputs."""
    _, s, ld, ramps, caps = _fills()
    scene_t, layout_t, _, _ = upload(s, ld, ramps, caps, "cpu")
    caps_l = sharded2.shard_caps(caps, n)
    N = caps_l["n_tag_slots"]
    assert int(ld["n_path_tags"]) > (n - 1) * N  # tags in every shard
    base_j = {k: np.uint32(0) for k in pathtag.FIELDS}
    base_t = torch.zeros(5, dtype=torch.int32)
    rows, bb, meta = [], None, 0
    for d in range(n):
        ptb = int(ld["path_tag_base"]) + d * N // 4
        tags_j = np_flatten.decode_tag_stream(np, s, ptb, N + 4)
        tags_t = flatten.decode_tag_stream(scene_t, ptb, N + 4)
        _exact(tags_j, tags_t)
        mono_j = np_flatten.exclusive_monoids(np, tags_j, base=base_j)
        mono_t = pathtag.tag_monoid_scan(tags_t, base_t)
        for k in pathtag.FIELDS:
            _exact(u32(mono_j[k]), u32(as_np(mono_t[k])))
        with np.errstate(all="ignore"):
            fj = np_flatten.flatten_stage(np, s, ld, caps_l,
                                          shard={"tag_lo": d * N, "monoid_base": base_j})
        with oracle_cbrt():
            ft = flatten.flatten_stage(scene_t, layout_t, caps_l,
                                       shard={"tag_lo": d * N, "monoid_base": base_t})
        check_flatten_lines(fj, ft, ATOL, rtol=RTOL)
        assert int(fj["n_lines"]) > 0
        np.testing.assert_allclose(as_np(ft["bb_acc"]), fj["bb_acc"], rtol=RTOL, atol=ATOL)
        # The next shard's base: this shard's delta totals added (the
        # cross-shard level of the scan, an all_gather in the ranks).
        tot_j = np_flatten.monoid_delta_totals(np, tags_j[:N])
        tot_t = pathtag.monoid_delta_totals(tags_t[:N])
        assert tot_t.tolist() == [int(np.int32(np.uint32(tot_j[k]).view(np.int32)))
                                  for k in pathtag.FIELDS]
        base_j = {k: np.uint32(base_j[k] + tot_j[k]) for k in pathtag.FIELDS}
        base_t = base_t + tot_t
        rows.append(_line_rows(ft))
        bb = ft["bb_acc"] if bb is None else torch.maximum(bb, ft["bb_acc"])
        meta = meta + torch.stack([ft["path_draw_flags"], ft["path_trans_idx"]], 1)
    with oracle_cbrt():
        whole = flatten.flatten_stage(scene_t, layout_t, caps)
    union = np.concatenate(rows)
    np.testing.assert_array_equal(union[np.lexsort(union.T[::-1])], _line_rows(whole))
    assert torch.equal(flatten.finalize_path_bbox(bb), whole["path_bbox"])
    assert torch.equal(meta[:, 0], whole["path_draw_flags"])
    assert torch.equal(meta[:, 1], whole["path_trans_idx"])


@pytest.mark.parametrize("config", [1, 3, 4, 5])
def test_torch_shard_caps_match_jello_tpu(config):
    """shard_caps on a gate scene's estimated class equals jello_tpu's,
    key for key (config 2 in tests/test_torch_stroke.py, which builds it
    once)."""
    check_shard_caps(*GATE_SCENES[config]())


def check_shard_caps(scene, params):
    layout, _, _, scene_u32 = Resolver().resolve(scene.encoding)
    caps = estimate_caps_from_scene(scene_u32, layout, params.width, params.height)
    for n in (2, 4, 8):
        assert sharded2.shard_caps(caps, n) == jax_sharded2.shard_caps(caps, n), n


def test_torch_path_count_params_match_numpy():
    """The per-line half of path_count (`line_tables`) on the oracle's
    lines: counts and the row table's backdrop-row columns exact, the P
    table equal."""
    _, s, ld, _, caps = _fills()
    ref = numpy_geometry(s, ld, caps)
    with np.errstate(all="ignore"):
        P_j, nc_j, nr_j, prt_j = np_tiling.path_count_params(np, ref["fl"], ref["paths"], caps)
    lines = tree_to_torch({k: ref["fl"][k] for k in (
        "line_x0", "line_y0", "line_x1", "line_y1", "line_path", "line_valid")})
    P_t, PRT_t, nc_t, nr_t = line_dda.line_tables(lines, tree_to_torch(ref["paths"]))
    assert int(nc_t.sum()) > 0 and int(nr_t.sum()) > 0
    _exact(nc_j, nc_t)
    _exact(nr_j, nr_t)
    for i, a in enumerate(prt_j):
        a = np.asarray(a)
        np.testing.assert_array_equal(a, as_np(PRT_t[:, i]).astype(a.dtype))
    live = as_np(lines["line_valid"])
    np.testing.assert_array_equal(as_np(P_t)[live], np.asarray(P_j, dtype=np.float64)[live])


def test_torch_fine_ref_stripe_matches_numpy():
    """The reference fine stage over one stripe of the grid (tile_base
    set) equals jello_tpu's on that stripe, and the same stripe of the
    port's whole-grid output; the scene has every paint kind, a clip
    inside a blend group and an image."""
    (scene_j, params_j), _ = both(full_scene)
    s, ld, ramps, atlas, caps = prepare_with_atlas(scene_j, params_j)
    ref = numpy_geometry(s, ld, caps)
    GRID = caps["tile_grid_cap"]
    local = GRID // WORLD
    base = local  # rank 1: a nonzero stripe base
    cmds = ref["cmds"]
    cmds_l = dict(cmds, tile_start=cmds["tile_start"][base:base + local],
                  tile_end=cmds["tile_end"][base:base + local])
    assert int((cmds_l["tile_end"] - cmds_l["tile_start"]).sum()) > 0
    segs = ref["counted"]["segs"]
    with np.errstate(all="ignore"):
        out_j, ovf_j = np_fine_ref.fine(np, s, cmds_l, segs, ref["info"], ramps, atlas, ld,
                                        caps, tile_base=base)
    _, layout_t, ramps_t, _ = upload(s, ld, ramps, caps, "cpu")
    atlas_t = upload_atlas(atlas, "cpu")
    cmds_t, segs_t = tree_to_torch(cmds), tree_to_torch(segs)
    stripe = dict(cmds_t, tile_start=cmds_t["tile_start"][base:base + local],
                  tile_end=cmds_t["tile_end"][base:base + local])
    out_t, flags_t, _ = fine_ref.fine(stripe, segs_t, ramps_t, atlas_t, layout_t, caps,
                                      tile_base=base)
    assert out_t.shape == (4, local, 256)
    assert bool(flags_t["blend_depth_overflow"]) == bool(ovf_j)
    np.testing.assert_allclose(out_t.numpy(), out_j, rtol=1e-5, atol=1e-5)
    whole, _, _ = fine_ref.fine(cmds_t, segs_t, ramps_t, atlas_t, layout_t, caps)
    assert torch.equal(whole[:, base:base + local], out_t)


# ---- both paths at world size 4, spawned ranks over gloo ----------------

def _dryrun(jt):
    return sharded.dryrun_scene(jt)


def _full(jt):
    return sharded2.dryrun_scene(jt, full_profile=True)


# name: (scene, antialiasing, path, options)
FRAMES = {
    "stripes_kernel": (_dryrun, "area", sharded, {"pallas_fine": True}),
    "stripes_fine_ref": (_dryrun, "area", sharded, {"pallas_fine": False}),
    "fills900": (fills900, "area", sharded2, {"debug": True}),
    "fills900_msaa8": (fills900, "msaa8", sharded2, {}),
    "full_tap": (_full, "area", sharded2, {}),
    "full_tap_msaa8": (_full, "msaa8", sharded2, {}),
    "fills900_small_exchange": (fills900, "area", sharded2, {"seg_ex_cap": 512}),
    "rank0_lines": (rank0_lines, "area", sharded2, {"report": True}),
    "rank0_lines_retry": (rank0_lines, "area", sharded2, {"max_retries": 8, "debug": True}),
}
# A class's next frame through the same call's StripeFrames and
# RetryingRender: its program's (over gloo, the frame function run into
# the program's static outputs). 128x128 frames, to keep the spawn short.
FRAMES["geometry_retry"] = (_dryrun, "area", sharded2, {"max_retries": 8})
PROGRAMS = ("stripes_kernel", "stripes_fine_ref", "geometry_retry")
FRAMES.update({f"{name}_again": FRAMES[name] for name in PROGRAMS})


def _frame_setup(build, aa):
    """(jello_tpu's (scene, params), the port's single-device CPU frame,
    the frame's inputs, its class on the renderer's routing)."""
    (scene_j, params_j), (scene_t, params_t) = both(build)
    params_j = dataclasses.replace(params_j, antialiasing_method=jello_tpu.AaConfig(aa))
    params_t = dataclasses.replace(params_t, antialiasing_method=jello_tpu_torch.AaConfig(aa))
    r = Renderer(device="cpu")
    img = r.render(scene_t, params_t)
    assert not any(r.last_flags.values()), r.last_flags
    inputs = sharded.frame_inputs(scene_t, params_t)
    caps = sharded.sharded_caps(r._caps, inputs, aa)
    if build is fills900:
        caps["n_tag_slots"] = TAG_SLOTS
    return (scene_j, params_j), img, inputs, caps


@pytest.fixture(scope="module")
def world4():
    """Every frame of FRAMES rendered by one spawn of WORLD ranks:
    {name: (setup, [each rank's (fine_out, flags, debug)])}."""
    made = {}
    for build, aa, _, _ in FRAMES.values():
        if (build, aa) not in made:
            made[(build, aa)] = _frame_setup(build, aa)
    setups = {name: made[(build, aa)] for name, (build, aa, _, _) in FRAMES.items()}
    jobs = [(mod.make_sharded_render, setups[name][2], setups[name][3], opts)
            for name, (_, _, mod, opts) in FRAMES.items()]
    per_rank = collectives.run_ranks(sharded.rank_frames, WORLD, "gloo", "cpu", (jobs,),
                                     timeout=SPAWN_TIMEOUT)
    return {name: (setups[name], [res[i] for res in per_rank])
            for i, name in enumerate(FRAMES)}


def _oracle(scene_j, params_j):
    """The numpy oracle's frame; under MSAA with the tile segments rounded
    to float32, as the port's coverage and jello_tpu's device route read
    them (`torch_reference.render_numpy_f32_segments`: on float64
    segments a sample within an ulp of an edge may fall on the other side,
    1/8 of a pixel's coverage)."""
    if params_j.antialiasing_method.value != "area":
        return render_numpy_f32_segments(scene_j, params_j)[1]
    with np.errstate(all="ignore"):
        ref, flags, _ = render_numpy(scene_j, params_j)
    assert not any(bool(v) for v in flags.values())
    return ref


@pytest.mark.parametrize("name", ["stripes_kernel", "stripes_fine_ref", "fills900",
                                  "fills900_msaa8", "full_tap", "full_tap_msaa8",
                                  "rank0_lines_retry"])
def test_torch_sharded_frame_matches_oracle_and_single_device(world4, name):
    """The gathered frame, the same on every rank: no flag, within 1e-3 of
    the port's single-device frame, and within 1e-3 (stripes) or 8e-3
    (geometry) of the numpy oracle (`_oracle`)."""
    (built_j, single, inputs, _), ranks = world4[name]
    frame, flags, _ = ranks[0]
    assert not any(flags.values()), flags
    for other, _, _ in ranks[1:]:
        assert torch.equal(other, frame)
    img = assemble(frame, inputs[1]).numpy()
    assert img.shape == single.shape and np.isfinite(img).all()
    err_single = np.abs(img - single).max()
    err_oracle = np.abs(img - _oracle(*built_j)).max()
    print(f"{name}: max abs error vs the single-device frame {err_single:.3e}, vs the oracle "
          f"{err_oracle:.3e}")
    assert err_single <= FRAME_TOL
    assert err_oracle <= (FRAME_TOL if name.startswith("stripes") else ORACLE_TOL)


@pytest.mark.parametrize("name", PROGRAMS)
def test_torch_sharded_programs_equal_the_eager_frame(world4, name):
    """A class's first clean frame runs eagerly and settles it; the next
    frame of the class is its program's, built once: on every rank equal
    to the eager frame bit for bit, with no flag (later frames building
    none: `tests/test_torch_sharded_programs.py`, at world size 1)."""
    ranks = [world4[n][1] for n in (name, f"{name}_again")]
    for r in range(WORLD):
        (first, flags0, d0), (again, flags1, d1) = (f[r] for f in ranks)
        assert (d0["programs"], d0["replayed"]) == (0, False), d0
        assert (d1["programs"], d1["replayed"]) == (1, True), d1
        assert torch.equal(again, first)
        assert not any(flags0.values()) and not any(flags1.values())


def test_torch_exchange_reaches_every_rank(world4):
    """Each rank received crossings from some other rank; the per-tile
    segment counts and the backdrop prefix the ranks combine equal the
    single-device path_count's."""
    (_, _, inputs, caps), ranks = world4["fills900"]
    dbg = ranks[0][2]
    T = caps["tiles_cap"]
    live = dbg["recv"][..., 0] < T  # [destination, source, row]
    for dst in range(WORLD):
        assert any(bool(live[dst, src].any()) for src in range(WORLD) if src != dst), dst
    assert (dbg["cnt"] > 0).all() and int(dbg["lo"][0]) == 0
    scene_t, layout_t, _, _ = upload(*inputs[:3], {}, "cpu")
    counted = geometry(scene_t, layout_t, caps)[0]["counted"]
    assert torch.equal(dbg["seg_count"], counted["seg_count"])
    assert torch.equal(dbg["backdrop"], counted["backdrop"])


def test_torch_small_exchange_raises_segs_overflow(world4):
    """More crossings from one rank to another than seg_ex_cap rows: the
    frame that was clean at shard_caps's exchange raises segs_overflow."""
    (_, _, _, caps), ranks = world4["fills900_small_exchange"]
    assert sharded2.shard_caps(caps, WORLD)["seg_ex_cap"] > 512
    flags = ranks[0][1]
    assert [k for k, v in flags.items() if v] == ["segs_overflow"]


def test_torch_rank0_lines_raise_without_the_retry(world4):
    """Every path tag in rank 0's range, at the calibrated class: rank 0
    raises flatten_overflow or segs_overflow (its line and crossing
    capacities are half the single device's) and no other rank raises a
    flag; its load shows what ran out."""
    (_, _, inputs, caps), ranks = world4["rank0_lines"]
    N_l = sharded2.shard_caps(caps, WORLD)["n_tag_slots"]
    assert int(inputs[1]["n_path_tags"]) <= N_l
    flags, rep = ranks[0][1], ranks[0][2]
    raised = {k for k, v in flags.items() if v}
    assert raised and raised <= {"flatten_overflow", "segs_overflow"}, raised
    keys = sorted(flags)
    by_rank = [{k for k, v in zip(keys, row.tolist()) if v} for row in rep["raised"]]
    assert by_rank[0] == raised and not any(by_rank[1:]), by_rank
    cl = sharded2.rank_caps(caps, WORLD, 0)
    need = dict(zip(sharded2.LOAD_KEYS, rep["load"][0].tolist()))
    assert any(need[k] > cl[k] for k in sharded2.LOAD_KEYS), need


def test_torch_retry_grows_only_the_raising_rank(world4):
    """The same frame through RetryingRender: clean (held to the oracle and
    the single device in the frame test above) after at least one retry;
    only rank 0's capacities grew, each at least to what its first frame
    needed (work items, and simple and arc lines, by the capacity each pair
    shares), and every rank ran with the same n_tag_slots and seg_ex_cap."""
    (_, _, _, caps), ranks = world4["rank0_lines_retry"]
    dbg = ranks[0][2]
    print(f"retries {dbg['retries']}; grown {dbg['grown']}; seg_ex_cap {dbg['seg_ex_cap']}")
    assert dbg["retries"] and set(dbg["retries"][0][0]) <= {"flatten_overflow", "segs_overflow"}
    assert list(dbg["grown"]) == [0], dbg["grown"]
    assert all("class" not in what for _, what, _ in dbg["retries"])
    for _, _, other in ranks[1:]:
        assert other["grown"] == dbg["grown"] and other["seg_ex_cap"] == dbg["seg_ex_cap"]
        assert torch.equal(other["classes"], dbg["classes"])
    assert (dbg["classes"] == dbg["classes"][0]).all(), dbg["classes"]
    first = dict(zip(sharded2.LOAD_KEYS, world4["rank0_lines"][1][0][2]["load"][0].tolist()))
    cl = sharded2.rank_caps(caps, WORLD, 0, dbg["grown"], dbg["seg_ex_cap"])
    pairs = (("work_a_cap", "work_b_cap"), ("simple_line_cap", "arc_line_cap"))
    for pair in pairs:
        first[pair] = sum(first.pop(k) for k in pair)
        cl[pair] = sum(cl[k] for k in pair)
    assert not [(k, cl[k], v) for k, v in first.items() if cl[k] < v]
    base = sharded2.shard_caps(caps, WORLD)
    for r in range(1, WORLD):
        grown_r = sharded2.rank_caps(caps, WORLD, r, dbg["grown"], dbg["seg_ex_cap"])
        assert all(grown_r[k] == base[k] for k in sharded2.RANK_KEYS)


FLAG_KEYS = ["flatten_overflow", "legacy_overflow", "pairs_overflow", "segs_overflow",
             "tiles_overflow"]


def _load(**need):
    return [need.get(k, 0) for k in sharded2.LOAD_KEYS]


@pytest.mark.parametrize("case", ["one_family", "exchange", "fine_flag", "replicated"])
def test_torch_grow_ranks_grows_what_ran_out(case):
    """grow_ranks on made-up loads at config 1's class split over four
    ranks: rank 2 overflows one line family while its line total fits (as
    config 5's rank 2 does on the card): only that family grows, on rank 2
    only; a full exchange slice grows seg_ex_cap for every rank; a fine
    stage's flag doubles its one capacity on the rank that raised it; a
    replicated stage's flag grows the single-device class."""
    caps = estimate_caps_from_scene(*_class_inputs())
    cl = sharded2.shard_caps(caps, WORLD)
    raised = [[0] * len(FLAG_KEYS) for _ in range(WORLD)]
    load = [_load() for _ in range(WORLD)]
    flag = {"one_family": "flatten_overflow", "exchange": "segs_overflow",
            "fine_flag": "legacy_overflow", "replicated": "tiles_overflow"}[case]
    raised[2][FLAG_KEYS.index(flag)] = 1
    if case == "one_family":
        load[2] = _load(euler_line_cap=cl["euler_line_cap"] + 1,
                        simple_line_cap=cl["simple_line_cap"] // 2)
    if case == "exchange":
        load[2] = _load(seg_ex_cap=cl["seg_ex_cap"] * 3)
    new_caps, grown, pex, what = sharded2.grow_ranks(caps, WORLD, {}, None, FLAG_KEYS, raised,
                                                     load)
    if case == "one_family":
        assert grown == {2: {"euler_line_cap": 2 * cl["euler_line_cap"],
                             "line_cap": cl["line_cap"] + cl["euler_line_cap"]}}
        assert what == {2: ["euler_line_cap"]} and pex is None and new_caps == caps
    if case == "exchange":
        assert grown == {} and pex == cl["seg_ex_cap"] * 3 and new_caps == caps
        for r in range(WORLD):
            assert sharded2.rank_caps(caps, WORLD, r, grown, pex)["seg_ex_cap"] == pex
    if case == "fine_flag":
        assert grown == {2: {"legacy_tiles_cap": 2 * cl["legacy_tiles_cap"]}} and pex is None
    if case == "replicated":
        assert grown == {} and what == {"class": ["tiles_overflow"]}
        assert new_caps["tiles_cap"] == 2 * caps["tiles_cap"]
    with pytest.raises(ValueError):
        sharded2.rank_caps(caps, WORLD, 0, {0: {"n_tag_slots": 1 << 20}})


def _class_inputs():
    scene, params = GATE_SCENES[1]()
    layout, _, _, scene_u32 = Resolver().resolve(scene.encoding)
    return scene_u32, layout, params.width, params.height


def test_torch_world_size_1_equals_single_device(tmp_path):
    """One rank, in this process: each path's frame is the single-device
    frame."""
    with collectives.init_group(0, 1, "gloo", tmp_path / "store", "cpu", GROUP_TIMEOUT) as g:
        for build, mod, opts in ((_dryrun, sharded, {"pallas_fine": True}),
                                 (_dryrun, sharded, {"pallas_fine": False}),
                                 (_full, sharded2, {})):
            _, single, inputs, caps = _frame_setup(build, "area")
            ((frame, flags, _),) = sharded.rank_frames(
                g, [(mod.make_sharded_render, inputs, caps, opts)])
            assert not any(flags.values()), flags
            err = np.abs(assemble(frame, inputs[1]).numpy() - single).max()
            print(f"{mod.__name__} {opts}: max abs difference {err:.3e}")
            assert err <= 1e-6
