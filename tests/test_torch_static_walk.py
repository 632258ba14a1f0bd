"""The reference fine stage's static walk and the rerouted frame as a
program, on the CPU.

`pipeline/fine_ref.py` walks every tile's tape densely, to two bounds of
the class (`ref_slots_cap`, `ref_chunks_cap`) or, without them, to bounds
read from the device. Held here: the walk to the class's bounds equals
the walk to the read bounds bit for bit, and both equal the walk the port
took before it was dense (the tapes of each record kind gathered by index,
`walk_tapes` without `dense`); the frame equals the numpy oracle in area
mode and under msaa8 and msaa16, and on a stripe with a nonzero tile base
equals jello_tpu's `fine_ref.fine` under numpy; bounds too small raise
`ref_walk_overflow`, and the bounds `grow_caps` grows give the eager frame
again. Then the renderer: a rerouted frame at a settled class is a
program of its own, built once, equal to the eager reroute, and a walk
that runs short grows and renders again."""

import numpy as np
import pytest
import torch

import jello_tpu_torch
from jello_tpu.cpu import render_numpy
from jello_tpu.pipeline import fine_ref as np_fine_ref

from jello_tpu_torch.cuda import Renderer
from jello_tpu_torch.cuda import render as render_mod
from jello_tpu_torch.cuda.render import (
    WALK_KEYS,
    assemble,
    frame,
    frame_routing,
    upload,
    upload_atlas,
    walk_bounds,
)
from jello_tpu_torch.pipeline import fine_ref, ops
from jello_tpu_torch.pipeline.fine_interp import build_records, walk_tapes
from jello_tpu_torch.pipeline.ops import F32
from jello_tpu_torch.pipeline.render import geometry, render_frame, unpack_layout
from jello_tpu_torch.renderer.estimate import grow_caps
from jello_tpu_torch.scenes import circle

from .torch_reference import (
    both,
    check_msaa_frame,
    full_scene,
    numpy_geometry,
    oracle_cbrt,
    over_minified,
    prepare_with_atlas,
    tree_to_torch,
    with_aa,
)

AREA_TOL = 1e-5  # tests/test_torch_fine_ref.py's
REROUTE = ["image_region_overflow: rerouted to fine_ref"]


def compact_fine(cmds, segs, ramps, atlas, layout, caps, tile_base=0):
    """The reference fine stage as the port walked it before its walk was
    dense: each step only on the tapes that hold a record kind, gathered by
    index, to bounds read from the device. Returns the [4, GRID, 256]
    output."""
    start, end = cmds["tile_start"], cmds["tile_end"]
    rec = build_records(dict(cmds, area_row=torch.zeros_like(cmds["kind"])), caps)
    last = rec.shape[0] - 1
    segs = tuple(segs[k].to(F32) for k in ("seg_x0", "seg_y0", "seg_x1", "seg_y1",
                                            "seg_y_edge"))

    def at(ci):
        return torch.clamp(start + ci, 0, last).long()

    def coverage(ci, idx, rec_idx, even_odd):
        pos = at(ci)[idx]
        return fine_ref.fill_coverage(cmds["seg_start"][pos], cmds["seg_count"][pos],
                                      cmds["backdrop"][pos], even_odd, segs,
                                      caps.get("aa_mode", "area"))

    out, _ = walk_tapes(int((end - start).max()), lambda ci: (rec[at(ci)], (start + ci) < end),
                        coverage, ops.iota(start.shape[0], rec.device) + tile_base,
                        layout["base_color"], ramps, atlas, layout["width_in_tiles"],
                        caps["blend_depth"], one_window=False)
    return out.permute(1, 0, 2)


def _settled(scene, params):
    """A scene's stages at the class a CPU renderer settled, on its route:
    (cmds, segs, (scene, layout, ramps, atlas), caps)."""
    r = Renderer(device="cpu")
    r.render(scene, params)
    _, ld, (scene_t, packed, ramps_t, atlas_t), depth = r._prepare(scene, params)
    caps = dict(r._caps, **frame_routing(ld["n_clips"], atlas_t is not None, depth,
                                         params.antialiasing_method.value))
    inputs = (scene_t, unpack_layout(packed), ramps_t, atlas_t)
    stages = geometry(inputs[0], inputs[1], caps)[0]
    return stages["cmds"], stages["segs"], inputs, caps


def _static_frame(scene, params):
    """The frame through the reference fine stage walked to its measured
    bounds (each a power of two), held bit for bit to the walk to the read
    bounds and to the compact walk. Returns the assembled image."""
    cmds, segs, (s, layout, ramps, atlas), caps = _settled(scene, params)
    eager, flags_e, need = fine_ref.fine(cmds, segs, ramps, atlas, layout, caps)
    bounds = walk_bounds({k: int(v) for k, v in need.items()})
    static, flags_s, need_s = fine_ref.fine(cmds, segs, ramps, atlas, layout,
                                            dict(caps, **bounds))
    assert bounds["ref_slots_cap"] >= int(need["ref_slots"]) > 0
    assert bounds["ref_chunks_cap"] >= int(need["ref_chunks"]) > 0
    assert {k: int(v) for k, v in need_s.items()} == {k: int(v) for k, v in need.items()}
    assert not bool(flags_s["ref_walk_overflow"]) and not bool(flags_e["ref_walk_overflow"])
    assert torch.equal(static, eager)
    assert torch.equal(eager, compact_fine(cmds, segs, ramps, atlas, layout, caps))
    fine_out, flags, _ = render_frame(s, layout, ramps, atlas, dict(caps, **bounds), None)
    assert torch.equal(fine_out, static) and not any(bool(v) for v in flags.values())
    return assemble(static, layout).numpy()


@pytest.mark.parametrize("aa", ["area", "msaa8", "msaa16"])
def test_torch_static_walk_equals_the_eager_walk_and_the_oracle(aa):
    """Every paint kind, a clip inside a blend group and an image: the walk
    to the class's bounds equals the eager and the compact walk bit for
    bit, and the frame the oracle (area: 1e-5 fed the oracle's cbrt, 2e-3
    with the port's own; MSAA: `check_msaa_frame`)."""
    built = with_aa(both(full_scene), aa)
    if aa != "area":
        check_msaa_frame(_static_frame, built)
        return
    (scene_j, params_j), (scene_t, params_t) = built
    shipped = _static_frame(scene_t, params_t)
    with oracle_cbrt():
        img = _static_frame(scene_t, params_t)
    with np.errstate(all="ignore"):
        ref, _, _ = render_numpy(scene_j, params_j)
    assert np.abs(img - ref).max() <= AREA_TOL and np.abs(shipped - ref).max() <= 2e-3


def test_torch_static_walk_on_a_stripe_matches_numpy():
    """One stripe of the grid with a nonzero tile base (`cuda/sharded.py`'s
    rank 1 of 4): the walk to the stripe's bounds equals jello_tpu's
    `fine_ref.fine` under numpy within 1e-5 and the eager walk bit for
    bit."""
    (scene_j, params_j), _ = both(full_scene)
    s, ld, ramps, atlas, caps = prepare_with_atlas(scene_j, params_j)
    ref = numpy_geometry(s, ld, caps)
    local = caps["tile_grid_cap"] // 4
    base = local
    cmds = ref["cmds"]
    with np.errstate(all="ignore"):
        out_j, _ = np_fine_ref.fine(
            np, s, dict(cmds, tile_start=cmds["tile_start"][base:base + local],
                        tile_end=cmds["tile_end"][base:base + local]),
            ref["counted"]["segs"], ref["info"], ramps, atlas, ld, caps, tile_base=base)
    _, layout_t, ramps_t, _ = upload(s, ld, ramps, caps, "cpu")
    atlas_t = upload_atlas(atlas, "cpu")
    cmds_t, segs_t = tree_to_torch(cmds), tree_to_torch(ref["counted"]["segs"])
    stripe = dict(cmds_t, tile_start=cmds_t["tile_start"][base:base + local],
                  tile_end=cmds_t["tile_end"][base:base + local])
    eager, _, need = fine_ref.fine(stripe, segs_t, ramps_t, atlas_t, layout_t, caps,
                                   tile_base=base)
    bounds = walk_bounds({k: int(v) for k, v in need.items()})
    static, flags, _ = fine_ref.fine(stripe, segs_t, ramps_t, atlas_t, layout_t,
                                     dict(caps, **bounds), tile_base=base)
    assert int(need["ref_slots"]) > 0 and not any(bool(v) for v in flags.values())
    assert torch.equal(static, eager)
    np.testing.assert_allclose(static.numpy(), out_j, rtol=AREA_TOL, atol=AREA_TOL)


@pytest.mark.parametrize("short", ["slots", "chunks"])
def test_torch_short_walk_raises_and_the_grown_walk_equals_the_eager_one(short):
    """Bounds below what the frame needs (the longest tape's slots, or the
    segment chunks of its longest fill) raise `ref_walk_overflow`; the
    bounds `grow_caps` doubles on that flag clear it, and the frame then
    equals the eager one bit for bit."""
    cmds, segs, (_, layout, ramps, atlas), caps = _settled(*full_scene(jello_tpu_torch))
    eager, _, need = fine_ref.fine(cmds, segs, ramps, atlas, layout, caps)
    bounds = walk_bounds({k: int(v) for k, v in need.items()})
    key = "ref_slots_cap" if short == "slots" else "ref_chunks_cap"
    bounds[key] = int(need["ref_" + short]) // 2
    grows = 0
    while True:
        out, flags, _ = fine_ref.fine(cmds, segs, ramps, atlas, layout, dict(caps, **bounds))
        if not bool(flags["ref_walk_overflow"]):
            break
        grows += 1
        grown = grow_caps(dict(caps, **bounds), {k: bool(v) for k, v in flags.items()})
        bounds = {k: grown[k] for k in WALK_KEYS}
    assert grows >= 1 and torch.equal(out, eager)


def test_torch_rerouted_render_is_a_program():
    """An over-minified image: once its class is settled, a render is the
    class's program and the rerouted frame's program (one each, none on
    later renders), equal to the eager reroute at the class and to the
    compact walk bit for bit; its surface comes through the rerouted
    program's present."""
    scene, params = over_minified(jello_tpu_torch)
    r = Renderer(device="cpu")
    first = r.render(scene, params)
    assert REROUTE in r.last_retries and r._walks
    logs = []
    for _ in range(3):
        img = r.render(scene, params)
        logs.append([k for _, _, k in r.compile_log])
        assert r.last_retries == [REROUTE] and not any(r.last_flags.values())
    assert len(logs[0]) == 1 and "fine_ref" in logs[0][0] and "walk" in logs[0][0]
    assert len(logs[1]) == 2 and logs[2] == logs[1]
    assert r._program is not None and r._program.fine_out.shape[0] == 4
    prepared = r._prepare(scene, params)
    caps, fine_impl = r._route(prepared, params, r._caps, reroute=True)
    eager_out, _, _ = frame(*prepared[2], caps, fine_impl)
    _, packed, ramps, atlas = prepared[2]
    layout = unpack_layout(packed)
    cmds, segs = (lambda st: (st["cmds"], st["segs"]))(
        geometry(prepared[2][0], layout, caps)[0])
    assert torch.equal(r._program.fine_out, eager_out)
    assert torch.equal(eager_out, compact_fine(cmds, segs, ramps, atlas, layout, caps))
    assert np.array_equal(img, assemble(eager_out, prepared[1]).numpy())
    assert np.array_equal(img, first)
    u8 = r.render_surface(scene, params)
    assert len(r.compile_log) == 2
    assert np.array_equal(u8, render_mod.present(torch.from_numpy(img)).numpy())


def minified_on_a_ground(jt):
    """`over_minified` over a full-frame fill and under a disc: tapes of
    three records, and fills of more than one segment chunk."""
    scene, params = over_minified(jt)
    ground = jt.Scene()
    ground.fill(jt.Fill.NON_ZERO, jt.Affine.identity(),
                jt.SolidBrush(jt.Color.rgba(0.1, 0.6, 0.3, 1)), None,
                jt.BezPath().move_to(0, 0).line_to(32, 0).line_to(32, 32).line_to(0, 32).close())
    ground.append(scene, jt.Affine.identity())
    ground.fill(jt.Fill.NON_ZERO, jt.Affine.identity(),
                jt.SolidBrush(jt.Color.rgba(0.9, 0.2, 0.1, 0.5)), None, circle(16, 16, 13))
    return ground, params


def test_torch_rerouted_program_grows_a_short_walk():
    """A settled class's walk bounds set below the frame's need: the
    rerouted program's frame raises `ref_walk_overflow`, the render grows
    the bounds and renders again (one more program a grown walk) and
    returns the eager frame."""
    scene, params = minified_on_a_ground(jello_tpu_torch)
    r = Renderer(device="cpu")
    for _ in range(2):
        want = r.render(scene, params)
    cls = r._class_of(r._prepare(scene, params), params, r._caps)
    r._walks[cls] = {"ref_slots_cap": 1, "ref_chunks_cap": 1}
    img = r.render(scene, params)
    assert r.last_retries[0] == REROUTE and ["ref_walk_overflow"] in r.last_retries
    assert not any(r.last_flags.values()) and np.array_equal(img, want)
    assert r._walks[cls]["ref_slots_cap"] > 1 or r._walks[cls]["ref_chunks_cap"] > 1
    assert sum("fine_ref" in k for _, _, k in r.compile_log) >= 2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")


@pytest.mark.cuda
def test_torch_rerouted_program_on_the_card(cuda):
    """On the card the rerouted frame's program is a captured CUDA graph:
    its replay equals the eager reroute at the class bit for bit, and the
    frame the plain versions' CPU frame within 2e-3."""
    scene, params = minified_on_a_ground(jello_tpu_torch)
    r = Renderer(device="cuda")
    for _ in range(3):
        img = r.render(scene, params)
    prog = r._program
    assert prog is not None and prog.graph is not None and len(r.compile_log) == 2
    prepared = r._prepare(scene, params)
    caps, fine_impl = r._route(prepared, params, r._caps, reroute=True)
    assert torch.equal(prog.fine_out, frame(*prepared[2], caps, fine_impl)[0])
    want = Renderer(device="cpu").render(scene, params)
    assert np.abs(img - want).max() <= 2e-3
