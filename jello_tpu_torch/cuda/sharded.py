"""Multi-GPU rendering with the fine stage sharded by tile stripes.

Counterpart of `jello_tpu/tpu/sharded.py`. Every rank runs the geometry
(flatten through coarse) replicated, on the same inputs, through
`pipeline/render.py::geometry`; rank r then rasterizes the contiguous
stripe of tiles [r * GRID / n, (r + 1) * GRID / n), either through the
reference fine stage (`pipeline/fine_ref.py::fine` with `tile_base`) or
through kernel G over the stripe's slab (tile ids = stripe base +
arange), and one `all_gather` assembles the frame. Only the stripes cross
ranks; the overflow words combine by maximum.

Also the helpers the multi-GPU paths share: the host inputs of a frame
as the ranks take them (`frame_inputs`, `sharded_caps`) and a rank's
part of a list of frames (`rank_frames`, a `collectives.run_ranks`
target).
"""

from __future__ import annotations

import numpy as np
import torch

from ..pipeline import fine_ref, ops
from ..pipeline.fine_interp import (
    OVF_BLEND_DEPTH,
    OVF_IMAGE_REGION,
    build_cmd_slab,
    build_records,
)
from ..pipeline.gradient import stops_table_or_empty
from ..pipeline.ops import I32
from ..pipeline.render import geometry
from ..renderer.atlas import build_image_atlas
from ..renderer.resolve import Resolver
from . import fine_interp as kinterp
from .collectives import all_gather, pmax
from .coverage import compute_area_rows
from .render import build_layout_dict, clip_nesting_depth, frame_routing, upload, upload_atlas


def make_sharded_render(group, caps, pallas_fine=False):
    """The stripe-sharded frame of this rank (`sharded.py:71-199`).

    caps: the single-device class with the frame's routing (`sharded_caps`);
    `tile_grid_cap` must divide among the ranks. Returns run(scene,
    layout, ramps, atlas=None) -> (fine_out [4, GRID, 256]
    un-premultiplied, flags {name: 0-dim bool}): the whole frame on every
    rank, which must all call it with the same inputs. Flags:
    jello_tpu's (pairs_overflow, blend_depth_overflow; with `pallas_fine`
    also cmd_slab_overflow, area_rows_overflow, image_region_overflow),
    and the geometry's flatten, tiles and segs flags, which jello_tpu's
    sharded frame drops."""
    n = group.world
    GRID = caps["tile_grid_cap"]
    if GRID % n:
        raise ValueError(f"tile_grid_cap {GRID} does not divide among {n} ranks")
    local = GRID // n
    base = group.rank * local
    stripe = slice(base, base + local)

    def run(scene, layout, ramps, atlas=None):
        stages, flags, _ = geometry(scene, layout, caps)
        cmds = stages["cmds"]
        if pallas_fine:
            area, area_row_rec, flags["area_rows_overflow"] = compute_area_rows(
                cmds, stages["counted"], caps)
            rec = build_records(dict(cmds, area_row=area_row_rec), caps)
            slab, counts, flags["cmd_slab_overflow"] = build_cmd_slab(rec, cmds, caps)
            wit = layout["width_in_tiles"]
            counts = torch.cat([counts[stripe], counts.new_full((1,), int(wit))])
            out, ovf = kinterp.interpret_tiles(
                counts, ops.iota(local, scene.device) + base, layout["base_color"],
                slab[stripe], area, ramps, atlas, wit, caps["blend_depth"],
                bool(caps.get("_interp_batch")), caps.get("aa_mode", "area") != "area")
            # Each bit on its own: jello_tpu takes the maximum of the words.
            bits = pmax(group, torch.stack([((ovf & OVF_BLEND_DEPTH) != 0).any(),
                                            ((ovf & OVF_IMAGE_REGION) != 0).any()]).to(I32))
            flags["blend_depth_overflow"] = bits[0] > 0
            flags["image_region_overflow"] = bits[1] > 0
            fine_out = all_gather(group, out).reshape(GRID, 4, 256).permute(1, 0, 2)
        else:
            cmds_l = dict(cmds, tile_start=cmds["tile_start"][stripe],
                          tile_end=cmds["tile_end"][stripe])
            out, depth = fine_ref.fine(cmds_l, stages["segs"], ramps, atlas, layout, caps,
                                       tile_base=base)
            flags["blend_depth_overflow"] = pmax(group, depth.to(I32).reshape(1))[0] > 0
            fine_out = all_gather(group, out).permute(1, 0, 2, 3).reshape(4, GRID, 256)
        return fine_out, flags

    return run


def frame_inputs(scene, params):
    """A frame's host inputs as the ranks take them (numpy, picklable):
    (scene words u32, the layout dict, the stop table, the atlas plane or
    None, the clip nesting depth)."""
    layout, ramps, images, scene_u32 = Resolver().resolve(scene.encoding)
    return (scene_u32, build_layout_dict(layout, params), stops_table_or_empty(ramps),
            build_image_atlas(images), clip_nesting_depth(scene_u32, layout))


def sharded_caps(caps, inputs, aa="area", image_tap=True):
    """The class `caps` (a single-device renderer's, `Renderer._caps`) with
    the routing the renderer gives this frame (`render.frame_routing`)."""
    _, ld, _, atlas, depth = inputs
    return dict(caps, **frame_routing(int(ld["n_clips"]), atlas is not None, depth, aa,
                                      image_tap))


def rank_frames(group, jobs):
    """This rank's part of each frame of `jobs`, a list of (make, inputs,
    caps, options): `make(group, caps, **options)` is this module's or
    `sharded2`'s `make_sharded_render`, `inputs` a `frame_inputs` tuple.
    Returns [(fine_out, flags {name: bool}, debug or None)] on the host."""
    out = []
    for make, inputs, caps, opts in jobs:
        scene_u32, ld, ramps, atlas, _ = inputs
        scene, layout, ramps_t, _ = upload(scene_u32, ld, ramps, {}, group.device)
        res = make(group, caps, **opts)(scene, layout, ramps_t,
                                        upload_atlas(atlas, group.device))
        dbg = res[2] if len(res) > 2 else None
        out.append((res[0].cpu(), {k: bool(v) for k, v in res[1].items()},
                    None if dbg is None else {k: v.cpu() for k, v in dbg.items()}))
    return out


def dryrun_scene(jt):
    """`sharded.py::dryrun`'s scene (`:207-227`) through the package `jt`:
    a filled cubic and a round-capped stroke, 128x128 on white."""
    scene = jt.Scene()
    path = jt.BezPath().move_to(5, 5).cubic_to(30, 2, 50, 60, 90, 70).line_to(60, 10).close()
    scene.fill(jt.Fill.NON_ZERO, jt.Affine.identity(),
               jt.SolidBrush(jt.Color.rgba(0, 0.7, 0.2, 1)), None, path)
    scene.stroke(jt.Stroke(width=3).with_caps(jt.Cap.ROUND), jt.Affine.identity(),
                 jt.SolidBrush(jt.Color.rgba(0.8, 0.1, 0.1, 1)), None,
                 jt.BezPath().move_to(10, 80).line_to(110, 90))
    return scene, jt.RenderParams(width=128, height=128, base_color=jt.Color.rgba(1, 1, 1, 1))


def dryrun(n, device="cuda", backend="nccl"):
    """Render `dryrun_scene` on n ranks with kernel G over the stripes
    (`sharded.py::dryrun`) and hold the frame to the single-device
    renderer's on `device` (within 1e-3, as `:244-250`). Returns the
    max abs difference; raises on a larger one or on a raised flag."""
    import jello_tpu_torch as jt

    from .collectives import run_ranks
    from .render import Renderer, assemble

    scene, params = dryrun_scene(jt)
    r = Renderer(device=device)
    ref = r.render(scene, params)
    inputs = frame_inputs(scene, params)
    caps = sharded_caps(r._caps, inputs)
    caps["tile_grid_cap"] = max(caps["tile_grid_cap"], 8 * n)
    job = (make_sharded_render, inputs, caps, {"pallas_fine": True})
    fine_out, flags, _ = run_ranks(rank_frames, n, backend, device, ([job],))[0][0]
    raised = [k for k, v in flags.items() if v]
    err = float(np.abs(assemble(fine_out, inputs[1]).numpy() - ref).max())
    if raised or not err < 1e-3:
        raise RuntimeError(f"sharded render: flags {raised}, max abs error {err}")
    return err
