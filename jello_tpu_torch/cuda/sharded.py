"""Multi-GPU rendering with the fine stage sharded by tile stripes.

Counterpart of `jello_tpu/tpu/sharded.py`. Every rank runs the geometry
(flatten through coarse) replicated, on the same inputs, through
`pipeline/render.py::geometry`; rank r then rasterizes the contiguous
stripe of tiles [r * GRID / n, (r + 1) * GRID / n), either through the
reference fine stage (`pipeline/fine_ref.py::fine` with `tile_base`) or
through kernel G over the stripe's slab (tile ids = stripe base +
arange), and one `all_gather` assembles the frame. Only the stripes cross
ranks; the overflow words combine by maximum.

`StripeFrames` keeps this rank's frames as programs, the port of the
`jax.jit` around the frame (`sharded.py:192`): a class's first frame runs
eagerly, and once a frame of it comes back with no flag raised, its next
frame builds the class's `FrameProgram` (`cuda/program.py`) over
`make_sharded_render`'s frame, collectives inside, which every later
frame of the class replays. The class is the single-device class with the
frame's routing, the fine stage (kernel G or the reference fine stage)
and, for the reference fine stage, its walk's bounds (measured by the
eager frame, combined by maximum over the ranks; `pipeline/fine_ref.py`).
Over NCCL the program is a captured CUDA graph; over gloo, whose
collectives copy through the host, and on the CPU it runs the frame
function into the program's static outputs: the group's backend decides.

Also the helpers the multi-GPU paths share: the host inputs of a frame
as the ranks take them (`frame_inputs`, `sharded_caps`), the flags of a
frame packed as a program returns them and read (`packed_frame`,
`read_flags`), and a rank's part of a list of frames (`rank_frames`, a
`collectives.run_ranks` target).
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
    with_width,
)
from ..pipeline.gradient import stops_table_or_empty
from ..pipeline.ops import I32
from ..pipeline.render import geometry, unpack_layout
from ..renderer.atlas import build_image_atlas
from ..renderer.estimate import grow_caps
from ..renderer.resolve import Resolver
from . import fine_interp as kinterp
from .collectives import all_gather, pmax
from .coverage import compute_area_rows
from .program import FrameProgram, Programs, key_summary, program_key
from .render import (
    WALK_KEYS,
    build_layout_dict,
    clip_nesting_depth,
    frame_routing,
    pack_flags,
    upload,
    upload_atlas,
    upload_layout,
    walk_bounds,
)


def make_sharded_render(group, caps, pallas_fine=False, report=False):
    """The stripe-sharded frame of this rank (`sharded.py:71-199`).

    caps: the single-device class with the frame's routing (`sharded_caps`;
    for the reference fine stage also its walk's bounds, WALK_KEYS, or
    none to read them from the device); `tile_grid_cap` must divide among
    the ranks. What jello_tpu's jit takes as static (the class, the
    routing, the stripe) is fixed here; what it traces (scene words, the
    layout's fields, stop table, atlas) is `run`'s data: the layout a dict
    of 0-dim device tensors (`unpack_layout`), the width in tiles read by
    kernel G on the device. Returns run(scene, layout, ramps, atlas=None)
    -> (fine_out [4, GRID, 256] un-premultiplied, flags {name: 0-dim bool}), with
    `report` also the walk's trip counts {ref_slots, ref_chunks}, the
    largest of any rank (empty with `pallas_fine`): the whole frame on
    every rank, which must all call it with the same inputs. Flags:
    jello_tpu's (pairs_overflow, blend_depth_overflow; with `pallas_fine`
    also cmd_slab_overflow, area_rows_overflow, image_region_overflow;
    else ref_walk_overflow), and the geometry's flatten, tiles and segs
    flags, which jello_tpu's sharded frame drops."""
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
            out, ovf = kinterp.interpret_tiles(
                with_width(counts[stripe], layout["width_in_tiles"]),
                ops.iota(local, scene.device) + base, layout["base_color"],
                slab[stripe], area, ramps, atlas, caps["blend_depth"],
                bool(caps.get("_interp_batch")), caps.get("aa_mode", "area") != "area")
            # Each bit on its own: jello_tpu takes the maximum of the words.
            bits = pmax(group, torch.stack([((ovf & OVF_BLEND_DEPTH) != 0).any(),
                                            ((ovf & OVF_IMAGE_REGION) != 0).any()]).to(I32))
            flags["blend_depth_overflow"] = bits[0] > 0
            flags["image_region_overflow"] = bits[1] > 0
            fine_out = all_gather(group, out).reshape(GRID, 4, 256).permute(1, 0, 2)
            stats = {}
        else:
            cmds_l = dict(cmds, tile_start=cmds["tile_start"][stripe],
                          tile_end=cmds["tile_end"][stripe])
            out, ref_flags, walk = fine_ref.fine(cmds_l, stages["segs"], ramps, atlas, layout,
                                                 caps, tile_base=base)
            # The flags and the walk's trip counts, each the largest of any rank.
            most = pmax(group, torch.stack([ref_flags["blend_depth_overflow"].to(I32),
                                            ref_flags["ref_walk_overflow"].to(I32),
                                            walk["ref_slots"], walk["ref_chunks"]]))
            flags["blend_depth_overflow"] = most[0] > 0
            flags["ref_walk_overflow"] = most[1] > 0
            stats = {"ref_slots": most[2], "ref_chunks": most[3]}
            fine_out = all_gather(group, out).permute(1, 0, 2, 3).reshape(4, GRID, 256)
        return (fine_out, flags, stats) if report else (fine_out, flags)

    return run


def packed_frame(run):
    """A sharded frame `run` (returning fine_out, flags and a report) as a
    program's function: fn(scene, packed layout, ramps, atlas) ->
    (fine_out, packed flags, flag keys, report), the layout unpacked into
    views inside, as a program takes it (`cuda/program.py`)."""
    def frame_fn(scene, layout, ramps, atlas):
        fine_out, flags, rep = run(scene, unpack_layout(layout), ramps, atlas)
        packed, fkeys, _ = pack_flags(flags, {})
        return fine_out, packed, fkeys, rep
    return frame_fn


def read_flags(packed, fkeys):
    """{name: bool} of a packed frame's flags (one read to the host)."""
    return dict(zip(fkeys, (bool(v) for v in packed.cpu().tolist())))


class StripeFrames:
    """This rank's stripe-sharded frames, one program a settled class
    (module docstring): kernel G over the stripe with `pallas_fine`, else
    the reference fine stage. Every rank calls it with the same inputs, so
    every rank builds its programs at the same frames, and their
    collectives meet.

    `compile_log`: one entry a program built (index, seconds to build it,
    its class); `last_program`: the last frame's program, None when it ran
    eagerly. A program's outputs are overwritten by its next frame: a
    caller that keeps one copies it."""

    # Renders of a frame whose walk ran short, as the single-card renderer's
    # `max_retries`.
    MAX_RETRIES = 4

    def __init__(self, group, pallas_fine=False):
        self.group = group
        self.pallas_fine = pallas_fine
        # Captured over NCCL; over gloo and on the CPU the function runs.
        self.capture = group.backend == "nccl"
        self._programs = Programs()
        self.compile_log = self._programs.compile_log
        # A settled class's walk bounds ({} with kernel G).
        self._settled = {}
        self.last_program = None
        self._name = "stripes, kernel G" if pallas_fine else "stripes, fine_ref"

    def __call__(self, caps, scene, layout, ramps, atlas=None):
        """One frame at the class `caps` (`sharded_caps`) of the inputs
        `rank_inputs` gives (the layout packed, `upload_layout`): (fine_out,
        flags {name: bool}). The class's program serves every layout. A
        frame of a program whose walk ran short
        (`ref_walk_overflow`) grows the walk's bounds and renders again,
        up to MAX_RETRIES times; any other raised flag comes back."""
        inputs = (scene, layout, ramps, atlas)
        cls = program_key(inputs, caps, self._name)
        for _ in range(self.MAX_RETRIES + 1):
            walk = self._settled.get(cls)
            self.last_program = None
            if walk is None:
                fine_out, packed, fkeys, stats = self.frame_fn(caps, *inputs)(*inputs)
            else:
                key = program_key(inputs, dict(caps, **walk), self._name)
                self.last_program = self._programs.get(key, lambda: FrameProgram(
                    inputs, self.frame_fn(caps, *inputs), capture=self.capture),
                    key_summary(key))
                fine_out, packed, fkeys, stats = self.last_program.run(inputs)
            flags = read_flags(packed, fkeys)
            if walk and flags.get("ref_walk_overflow"):
                grown = grow_caps(dict(caps, **walk), flags)
                self._settled[cls] = {k: grown[k] for k in WALK_KEYS}
                continue
            if walk is None and not any(flags.values()):
                self._settled[cls] = {} if self.pallas_fine else walk_bounds(
                    {k: int(v) for k, v in stats.items()})
            return fine_out, flags
        raise RuntimeError(f"stripe-sharded render: the walk ran short after {self.MAX_RETRIES} "
                           "retries")

    def frame_fn(self, caps, scene, layout, ramps, atlas=None):
        """The frame at the class `caps` of these inputs (with the walk
        bounds of a settled class) as its program runs it: fn(scene,
        layout, ramps, atlas) -> (fine_out, packed flags, flag keys,
        stats)."""
        inputs = (scene, layout, ramps, atlas)
        walk = self._settled.get(program_key(inputs, caps, self._name)) or {}
        return packed_frame(make_sharded_render(self.group, dict(caps, **walk),
                                                self.pallas_fine, report=True))


def rank_inputs(inputs, device):
    """A `frame_inputs` tuple as a rank's frames take it on `device`:
    (scene words, packed layout, stop table, atlas or None), each copied
    without a host wait (`render.upload`, `upload_layout`, `upload_atlas`)."""
    scene_u32, ld, ramps, atlas, _ = inputs
    scene, _, ramps_t, _ = upload(scene_u32, ld, ramps, {}, device)
    return scene, upload_layout(ld, device), ramps_t, upload_atlas(atlas, device)


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
    caps, options): `make` is this module's or `sharded2`'s
    `make_sharded_render`, `inputs` a `frame_inputs` tuple.

    A stripe-sharded frame goes through a `StripeFrames` (its one option
    `pallas_fine`), one for each fine stage, serving every such job of the
    call: a class's first clean frame settles it and its later frames are
    its program's. With `max_retries` in the options (`sharded2` only) the
    frame goes through `sharded2.RetryingRender`, which renders it again on
    a raised flag with the ranks that raised it grown (its one other
    option: `debug`), and which keeps the grown class and the programs; one
    RetryingRender serves every such job of the call. Any other
    geometry-sharded frame (the diagnostic options `debug`, `report`,
    `seg_ex_cap`) runs eagerly, `make(group, caps, **options)` once.

    Returns [(fine_out, flags {name: bool}, debug or None)] on the host.
    A frame through StripeFrames or RetryingRender has a debug dict with
    `programs` (the programs built so far) and `replayed` (whether the
    frame was a program's); a retried frame's also holds `retries` (its
    `RetryingRender.last_retries`), `grown` and `seg_ex_cap` (its class)."""
    from . import sharded2

    out, holders = [], {}
    for make, inputs, caps, opts in jobs:
        args = (caps,) + rank_inputs(inputs, group.device)
        extra, holder = {}, None
        if make is make_sharded_render:
            if set(opts) - {"pallas_fine"}:
                raise ValueError(f"options {sorted(opts)}: a stripe-sharded frame takes "
                                 "pallas_fine")
            fine = bool(opts.get("pallas_fine"))
            holder = holders.setdefault(("stripes", fine), StripeFrames(group, fine))
            res = holder(*args)
        elif "max_retries" in opts:
            if set(opts) - {"max_retries", "debug"}:
                raise ValueError(f"options {sorted(opts)}: a retried frame takes max_retries "
                                 "and debug")
            key = (opts["max_retries"], bool(opts.get("debug")))
            holder = holders.setdefault(key, sharded2.RetryingRender(group, *key))
            res = holder(*args)
            st = holder.state(*args)
            extra = {"retries": holder.last_retries, "grown": st[1], "seg_ex_cap": st[2]}
        else:
            scene, layout, ramps_t, atlas_t = args[1:]
            res = make(group, caps, **opts)(scene, unpack_layout(layout), ramps_t, atlas_t)
        if holder is not None:
            extra.update(programs=len(holder.compile_log),
                         replayed=holder.last_program is not None)
        dbg = res[2] if len(res) > 2 else None
        if dbg is not None or extra:
            dbg = {k: v.cpu() for k, v in (dbg or {}).items()} | extra
        out.append((res[0].cpu(), {k: bool(v) for k, v in res[1].items()}, dbg))
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
