"""Renderer on a torch device (CUDA, or the CPU when asked).

Counterpart of `jello_tpu/tpu/render.py::Renderer` (`render`,
`render_surface`, the retry/grow/calibrate loop, the device-side present,
the compiled frame of each class and `compile_log`). Capacities are
calibrated from the device's own run: the first frame of a scene shape
runs at the estimated class with its exact counters, `calibrate_caps`
shrinks the class, and the frame runs again (the protocol of
`tpu/render.py:445-461`; jello_tpu calibrates on the host instead,
`_host_calibrate`, which is not ported). Overflow flags grow the
implicated capacities (`grow_caps`) and retry. A frame's flags and stats
come back packed in one int32 vector (`pack_flags`, as
`tpu/render.py:114-121` packs them) and are read to the host once a
frame by `render`, `render_surface` and `render_device`, or kept on the
device by `render_device(check_flags=False)` until `read_flags()`.

The compiled frame (`cuda/program.py`): those first frames run eagerly.
A class whose frame has come back with no capacity flag raised is
settled, and its next frame builds the class's `FrameProgram`, one
captured CUDA graph (`tpu/render.py::_get_compiled`), which every later
frame of the class replays; `compile_log` records each build. A class is
keyed as jello_tpu keys an executable (`program.caps_key`), never by the
scene's layout: the layout is packed into one int32 device tensor a scene
(`upload_layout`) that the program copies in and reads, so scenes of one
class with different layouts (paths added or removed, segments changed,
a target resized inside the tile grid) share one program, and a new
stream shape whose calibrated class is settled replays its program. The
present of a program's frame is a program too, one for each output
geometry (`_get_present`). The scene
words and the stop table's rows are padded to power-of-two size classes
(`tpu/render.py:276-293`), so that scenes of one bucket share a program,
and the stop table and atlas are uploaded again only when their content
changes (`_upload`, `tpu/render.py:510-523`). A frame rerouted to
the reference fine stage at a settled class is a program of its own too
(jello_tpu runs that class's compiled program with `_no_pallas_fine`,
`tpu/render.py:428-434`): its walk's two bounds (`pipeline/fine_ref.py`)
are measured by the first, eager, rerouted frame of the class, rounded
up to powers of two and kept beside the class, and grown on
`ref_walk_overflow`. The decision to reroute is made per render and never
kept in the class (`tpu/render.py:436-442`). A program's outputs are
overwritten by its next frame: what a caller gets (`render_device`,
`unread_flags`, a `Frame`) is a copy.

Frames in flight (`render_surface_async`, `Frame`; `tpu/render.py:162-190,
526-547`): once a scene shape is settled, a frame is only enqueued, and
its pixels and packed flags come back in one asynchronous copy. Unlike
jello_tpu, whose settled async frames read no flag, `Frame.result()`
reads the frame's flags with its pixels, and on a raised flag grows the
class and renders that frame again from the inputs it was enqueued with.

The stage clock: on the card every frame, eager or replayed, stamps the
card's clock at the entry of each pipeline stage and after the last
(`frame`, `profiler.stage_clock`; nine one-thread kernels, graph nodes in
a program), and the stamps come back with the frame's flags, in the read
or the copy that brings those back: `last_stage_ms` of a checked frame,
`Frame.stage_ms` of a frame in flight, and with a `profiler` a `device`
span under the call's `enqueue` span. `counters` keeps running totals of
calls, replays, eager frames, bytes uploaded and uploads skipped.

Every single-device frame jello_tpu renders: fills and strokes with
solid, gradient and image paints, clip layers and blend groups, under
area antialiasing or MSAA8/16 (`RenderParams.antialiasing_method`; under
MSAA the coverage kernel resolves its rows per sample and the fine
kernels read them as they are). A clip-free frame takes the
record-stream fine stage (`fine_v2`) and the dense coarse branch, a
frame with clip layers the hybrid one (`fine_hybrid`: kernel B plus the
per-tile interpreter). A frame whose image minifies past the region
windows of the tap or of the interpreter raises `image_region_overflow`
and runs again through the reference fine stage (`pipeline/fine_ref.py`,
plain torch on any device), as jello_tpu reroutes it
(`tpu/render.py:428-434`). Under JELLO_IMAGE_TAP=0 (jello_tpu's kill
switch, `tpu/render.py:58-65`) image paints skip the tap: a clip-free
frame with images takes `fine_hybrid`, its image tiles the interpreter.
"""

from __future__ import annotations

import contextlib
import functools
import hashlib
import os

import numpy as np
import torch

from ..encoding.draw import DRAW_TAG_BEGIN_CLIP, DRAW_TAG_END_CLIP
from ..gfx import premul32
from ..pipeline.clips import MAX_CLIP_DEPTH
from ..pipeline.fine_ref import assemble_image
from ..pipeline.gradient import stops_table_or_empty
from ..pipeline.image_tap import atlas_planar, runs_tap
from ..pipeline.render import NESTED, STAGES, pack_layout, render_frame, unpack_layout
from ..profiler import device_result, stage_clock, stage_ms, stamp_buffer
from ..renderer.atlas import build_image_atlas
from ..renderer.estimate import (
    calibrate_caps,
    caps_shrank,
    estimate_caps_from_scene,
    grow_caps,
)
from ..renderer.params import RenderParams
from ..renderer.resolve import Resolver
from .build import copy_to, device_to_host, host_to_device, pinned, pinned_read
from .fine_hybrid import fine_hybrid
from .fine_v2 import assemble_compact, fine_v2
from .program import FrameProgram, Programs, caps_key, key_summary, map_tensors, program_key

# The reference fine stage's walk bounds (`pipeline/fine_ref.py`), kept
# beside a settled class.
WALK_KEYS = ("ref_slots_cap", "ref_chunks_cap")
# The layout fields that fix the shape of the assembled image: the present
# keeps them as host ints and is keyed on them (`tpu/render.py:196-200`).
OUTPUT_FIELDS = ("width_in_tiles", "height_in_tiles", "target_width", "target_height")


def frame_counts(stats) -> dict:
    """The counts a profiled call carries of the frame it returned, from
    the frame's stats as read with its flags (host ints): `lines` (euler,
    simple and arc lines together), `cmds`, `max_tile_cmds` (the
    deepest tile's commands), `img_recs` (its image records, the rows
    of the image tap's table), `grad_recs` (its linear, radial and sweep
    gradient records) and `clips` (the layout's clip draw objects, a
    BeginClip and its EndClip each)."""
    return {"lines": stats["euler_lines"] + stats["simple_lines"] + stats["arc_lines"],
            "cmds": stats["cmds"], "max_tile_cmds": stats["max_cmds"],
            "img_recs": stats["img_recs"], "grad_recs": stats["grad_recs"],
            "clips": stats["clips"]}


def walk_bounds(stats) -> dict:
    """The walk bounds of a class from its rerouted frame's stats (host
    ints): each trip count rounded up to a power of two."""
    return {"ref_slots_cap": _pow2(stats["ref_slots"]),
            "ref_chunks_cap": _pow2(stats["ref_chunks"])}


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def build_layout_dict(layout, params: RenderParams) -> dict:
    """The layout dict of `jello_tpu/cpu/pipeline.py::build_layout_dict`:
    the resolver's stream offsets and counts, the target in pixels and
    16-pixel tiles, and the premultiplied base color. Built here, so that
    the port does not import jello_tpu's numpy pipeline with it."""
    fields = ("path_tag_base", "path_data_base", "draw_tag_base", "draw_data_base",
              "transform_base", "style_base", "n_path_tags", "n_paths", "n_draw_objects",
              "n_clips")
    ld = {k: np.int32(getattr(layout, k)) for k in fields}
    ld.update(width_in_tiles=np.int32((params.width + 15) // 16),
              height_in_tiles=np.int32((params.height + 15) // 16),
              target_width=np.int32(params.width), target_height=np.int32(params.height),
              base_color=premul32(params.base_color))
    return ld


def upload_atlas(atlas, device):
    """The numpy [AH, AW, 4] atlas plane `jello_tpu` feeds `render_frame`
    (`build_image_atlas`) as the premultiplied channel-planar padded f32
    [4, AHp, AWp] tensor on `device` that the image tap reads; None for
    no atlas."""
    if atlas is None:
        return None
    return host_to_device(torch.from_numpy(atlas_planar(atlas)), device)


def upload_layout(ld, device):
    """A layout dict (`build_layout_dict`) as one int32 tensor on `device`,
    `pack_layout`'s words (the u32 fields and the base color's bit
    patterns), copied without a host wait: what a frame and its program
    take, and unpack into 0-dim views (`pipeline.render.unpack_layout`)."""
    return host_to_device(torch.from_numpy(pack_layout(ld).view(np.int32)), device)


def output_layout(ld, packed):
    """What assembly and the present read of a frame's layout: the output
    geometry (OUTPUT_FIELDS) as host ints from the layout dict `ld`, and
    the base color, a view of the frame's packed layout on the device."""
    return dict({k: int(ld[k]) for k in OUTPUT_FIELDS},
                base_color=unpack_layout(packed)["base_color"])


def upload(scene_u32, ld, ramps, caps, device):
    """The inputs `jello_tpu` feeds `render_frame`, as torch inputs on
    `device` (copied without a host wait): scene words as int32 bit
    patterns, the layout as the stages read it (`upload_layout`, unpacked:
    0-dim int32 tensors and the base color), the stop table as f32. The
    atlas goes through `upload_atlas`.
    Returns (scene, layout, ramps, caps)."""
    device = torch.device(device)
    scene = torch.from_numpy(np.asarray(scene_u32, dtype=np.uint32).view(np.int32).copy())
    ramps_t = torch.from_numpy(np.ascontiguousarray(ramps, dtype=np.float32))
    return (host_to_device(scene, device), unpack_layout(upload_layout(ld, device)),
            host_to_device(ramps_t, device), dict(caps))


def clip_nesting_depth(scene_u32, layout) -> int:
    """The deepest nesting of the resolved scene's clip layers (host-side,
    from its draw tags): the trip count of `clips.clip_leaf_vectorized`."""
    tags = np.asarray(scene_u32[layout.draw_tag_base:
                                layout.draw_tag_base + layout.n_draw_objects])
    delta = (tags == DRAW_TAG_BEGIN_CLIP).astype(np.int64) - (tags == DRAW_TAG_END_CLIP)
    return int(np.cumsum(delta).max(initial=0))


def frame_routing(n_clips: int, has_atlas: bool, clip_depth: int,
                  aa_mode: str = "area", image_tap: bool = True) -> dict:
    """jello_tpu's routing on its accelerator (`tpu/render.py:332-365`),
    set per frame and never kept in the class that calibrate_caps and
    grow_caps see: the antialiasing mode ("area", "msaa8", "msaa16"), read
    by the coverage and fine stages; for a scene with an atlas the image
    tap (kernel F) unless `image_tap` is off (JELLO_IMAGE_TAP=0); for a
    clip-free frame the dense coarse branch; the 8-tile interpreter
    (kernel H) under JELLO_INTERP_BATCH=1, the reference's own switch.
    `clip_depth_cap`, the clip walk's trip count, is the scene's
    own nesting depth rounded up to a power of two, so that scenes of
    nearby depths share a class (a level past the deepest begin changes
    nothing), and at most `clips.MAX_CLIP_DEPTH` = 64: jello_tpu's
    accelerator route walks `caps.get("clip_depth_cap", MAX_CLIP_DEPTH)`
    levels for every scene (`jello_tpu/pipeline/clips.py:117`), so a
    begin nested deeper matches no level there, nor here."""
    routing = {"aa_mode": aa_mode}
    if has_atlas and image_tap:
        routing["_image_tap"] = True
    if n_clips == 0:
        routing["_coarse_dense"] = True
    else:
        routing["clip_depth_cap"] = min(_pow2(max(int(clip_depth), 1)), MAX_CLIP_DEPTH)
    if os.environ.get("JELLO_INTERP_BATCH", "0") == "1":
        routing["_interp_batch"] = True
    return routing


def pack_flags(flags: dict, stats: dict, stamps=None):
    """A frame's flags and stats as one int32 vector on their device,
    flags then stats, each in sorted key order (`tpu/render.py:114-121`),
    then the frame's stage clock (`stamps`, int64, as int32 pairs) if it
    has one, so that one read brings both back.
    Returns (packed, flag keys, stat keys)."""
    fkeys, skeys = sorted(flags), sorted(stats)
    packed = torch.stack([flags[k].to(torch.int32).reshape(()) for k in fkeys]
                         + [stats[k].to(torch.int32).reshape(()) for k in skeys]
                         + ([] if stamps is None else list(stamps.view(torch.int32).unbind())))
    return packed, fkeys, skeys


def unpack_flags(values, fkeys, skeys):
    """Host values of a `pack_flags` vector (a sequence of ints) ->
    (flags {name: bool}, stats {name: int})."""
    values = [int(v) for v in values]
    return ({k: bool(v) for k, v in zip(fkeys, values)},
            dict(zip(skeys, values[len(fkeys):])))


def unpack_stamps(values, fkeys, skeys):
    """The stage clock of a `pack_flags` vector's host values: its stamps
    (ns on the card's clock) as ints, None for a frame that has none."""
    tail = values[len(fkeys) + len(skeys):]
    return np.asarray(tail, dtype=np.int32).view(np.int64).tolist() if tail else None


def fetch_frame(packed, fkeys, skeys):
    """Read a `pack_flags` vector to the host (one copy; the host waits
    for the frame) -> (flags, stats, the frame's stamps or None,
    `unpack_stamps`)."""
    values = packed.cpu().tolist()
    return unpack_flags(values, fkeys, skeys) + (unpack_stamps(values, fkeys, skeys),)


def frame(scene, layout, ramps, atlas, caps, fine_impl):
    """One frame as a program captures it: the packed layout unpacked
    (`upload_layout`; views, no launch), `render_frame` under the stage
    clock (on the card: a stamp at each stage's entry and one after the
    last, `profiler.stage_clock`) and `pack_flags` (the body of
    `tpu/render.py::_get_compiled`). Returns (fine output, packed flags,
    stats and stamps, (flag keys, stat keys)). A frame that runs the image
    tap (an atlas on the tap's route, not rerouted) also stamps the tap's
    entry and exit inside fine (`NESTED`)."""
    nested = NESTED if fine_impl is not None and runs_tap(caps, atlas) else ()
    stamps = stamp_buffer(scene.device, len(STAGES) + 1 + 2 * len(nested))
    with stage_clock(stamps, STAGES, nested):
        fine_out, flags, stats = render_frame(scene, unpack_layout(layout), ramps, atlas, caps,
                                              fine_impl)
    packed, fkeys, skeys = pack_flags(flags, stats, stamps)
    return fine_out, packed, (fkeys, skeys)


def assemble(fine_out, ld):
    """A frame's fine output -> [H, W, 4] un-premultiplied image on its
    device: (compact, tile2rank) of the record-stream stages, or the
    dense [4, GRID, 256] of the reference fine stage. `ld`: a layout dict
    whose OUTPUT_FIELDS are host values (they fix the image's shape), its
    base color on the device or the host (`output_layout`)."""
    if isinstance(fine_out, tuple):
        return assemble_compact(*fine_out, ld)
    return assemble_image(fine_out, ld)


def present(img, premul: bool = True, srgb: bool = True):
    """Un-premultiplied linear RGBA -> u8 surface pixels on the device
    (the math of `jello_tpu/tpu/render.py::_get_present`)."""
    out = img
    if premul:
        out = torch.cat([out[..., :3] * out[..., 3:4], out[..., 3:4]], dim=-1)
    rgb = torch.clamp(out[..., :3], 0.0, 1.0)
    if srgb:
        rgb = torch.where(
            rgb <= 0.0031308, rgb * 12.92,
            1.055 * torch.exp(torch.log(torch.clamp(rgb, min=1e-12)) / 2.4) - 0.055)
    a = torch.clamp(out[..., 3:4], 0.0, 1.0)
    return (torch.cat([rgb, a], dim=-1) * 255.0 + 0.5).to(torch.uint8)


def assemble_present(fine_out, layout, premul, srgb):
    """`present(assemble(...))`: the eager present of a frame."""
    return present(assemble(fine_out, layout), premul, srgb)


def present_packed(fine_out, packed, geometry, premul, srgb):
    """What a present program captures: `assemble_present` of a frame's
    fine output at the output geometry (OUTPUT_FIELDS' host ints, the
    program's key), the base color read from the packed layout."""
    ld = dict(zip(OUTPUT_FIELDS, geometry), base_color=unpack_layout(packed)["base_color"])
    return assemble_present(fine_out, ld, premul, srgb)


class Renderer:
    """Renders `jello_tpu_torch.Scene`s with the torch pipeline on
    `device`.

    Keeps the resolver (ramp cache), the uploaded frame inputs of the
    last scene revision, the stop table and image atlas of each shape
    (uploaded again when their content changes), the capacity class, and
    a program for every settled class it has rendered since it was made
    (`compile_log` records each)."""

    def __init__(self, device="cuda"):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Renderer(device='cuda'): CUDA is not available")
        if device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {device}")
        self.device = device
        self._resolver = Resolver()
        self._caps = None
        self._est_key = None
        self._calib_key = None
        # The stream shape whose class the last checked frame found clean:
        # its async frames are only enqueued.
        self._settled_key = None
        self._frame = None
        # A `Profiler` (jello_tpu_torch.profiler): each render call is a
        # group of it, and each `Frame.result()` a `result` group, with
        # host spans for their parts (module README: prepare and its
        # resolve, layout and upload; enqueue and the frame's device times;
        # flags, present, read, copy; wait, render_again).
        self.profiler = None
        # The open groups of the current call, outermost first.
        self._open: list = []
        # The enqueue span of the last frame enqueued (None without a
        # profiler): the frame's device times join it when read.
        self._enqueue_span = None
        # Running totals: render calls (`frames`, each call's index), the
        # frames they enqueued as a program's replay or eagerly, the bytes
        # copied to the device, and the stop tables and atlases whose
        # upload the content digest skipped (`_upload`).
        self.counters = {"frames": 0, "replays": 0, "eager": 0, "upload_bytes": 0,
                         "uploads_skipped": 0}
        # jello_tpu's kill switch for the image tap (`tpu/render.py:58-65`),
        # read once: with JELLO_IMAGE_TAP=0 image paints take the
        # interpreter (kernel G).
        self.use_image_tap = os.environ.get("JELLO_IMAGE_TAP", "1") != "0"
        # None after a frame whose flags were not read (check_flags=False
        # or an async frame): such a frame is never reported clean.
        self.last_flags: dict | None = {}
        self.last_stats: dict | None = {}
        # The device ms by stage (`pipeline.render.STAGES`) of the last
        # frame whose flags were read, from its stage clock; None for a
        # frame with no clock (the CPU) and while flags are unread.
        self.last_stage_ms: dict | None = None
        # What made each frame of the last render run again: the raised
        # flags of a grown class, ["calibrated"], or the reroute of an
        # `image_region_overflow` frame to the reference fine stage.
        self.last_retries: list = []
        # The raised flags of every frame that raised one, in order
        # (`tpu/render.py:421-427`).
        self.flags_history: list = []
        # The packed flags and stats of every frame rendered with
        # check_flags=False since the last `read_flags()`, on the device:
        # {(flag keys, stat keys): packed}, the frames of one key set merged
        # by their maximum (a flag raised by any of them stays raised).
        self.unread_flags: dict = {}
        # The programs, by `program.program_key` (`_programs`), with one
        # entry in `compile_log` a program built (`tpu/render.py:66-70,
        # 411-416`: index, seconds to capture it, `program.key_summary` of
        # its class), and the classes (`_class_of`: `program.caps_key`)
        # whose frame came back with no capacity flag raised: their next
        # frame builds a program.
        self._cache = Programs()
        self._settled_classes: set = set()
        self._program = None  # the program of the last frame, None if it ran eagerly
        # The reference fine stage's walk bounds for a class (as in
        # `_settled_classes`), from its first rerouted frame: {class:
        # {key of WALK_KEYS: bound}}.
        self._walks: dict = {}
        # {(kind, shape, dtype): (content digest, tensor on the device)}:
        # `_upload`.
        self._uploads: dict = {}

    @property
    def compile_log(self) -> list:
        return self._cache.compile_log

    @property
    def _programs(self) -> dict:
        return self._cache.by_key

    def render(self, scene, params: RenderParams, max_retries: int = 4) -> np.ndarray:
        """Render to a host [H, W, 4] float32 un-premultiplied image."""
        with self._call("render"):
            prepared = self._prepare(scene, params)
            fine_out = self._render_checked(prepared, params, max_retries)
            return assemble(fine_out, output_layout(prepared[1], prepared[2][1])).cpu().numpy()

    def render_surface(self, scene, params: RenderParams, premul: bool = True,
                       srgb: bool = True, max_retries: int = 4) -> np.ndarray:
        """Render to u8 [H, W, 4] surface pixels; assembly, premultiply,
        sRGB and quantization run on the device."""
        with self._call("render_surface"):
            prepared = self._prepare(scene, params)
            fine_out = self._render_checked(prepared, params, max_retries)
            with self._span("present"):
                u8 = self._present(prepared, fine_out, premul, srgb)
            with self._span("read"):
                return device_to_host(u8)

    def render_surface_async(self, scene, params: RenderParams, premul: bool = True,
                             srgb: bool = True, max_retries: int = 4) -> "Frame":
        """Enqueue a frame and return a `Frame` in flight: the host can
        encode frame N+1 while frame N renders (`tpu/render.py:162-190`).

        The first render of a scene shape settles its class as
        `render_surface` does (blocking, with retry, grow and calibrate).
        After that a call only enqueues: the frame, its present, and one
        asynchronous copy of the u8 surface and the packed flags into
        pinned host memory. The flags are read by `Frame.result()`."""
        with self._call("render_surface_async") as index:
            prepared = self._prepare(scene, params)
            unread, span = None, None
            if self._settled_key == prepared[0] == self._est_key:
                fine_out, unread = self._enqueue(prepared, params, self._caps)
                span = self._enqueue_span
                self.last_flags = self.last_stats = self.last_stage_ms = None
                self.last_retries = []
            else:
                fine_out = self._render_checked(prepared, params, max_retries)
            with self._span("present"):
                u8 = self._present(prepared, fine_out, premul, srgb)
            with self._span("copy"):
                return Frame(self, prepared, params, dict(self._caps),
                             (premul, srgb, max_retries), u8, unread, self.last_flags,
                             index, span, self.last_stage_ms,
                             self._open[0] if unread is not None and self._open else None)

    def _present(self, prepared, fine_out, premul, srgb):
        """The u8 surface of a frame's fine output: through the present
        program of the frame's program for the frame's output geometry
        when it came from one (a static output, overwritten by that
        program's next present), else eagerly."""
        ld, packed = prepared[1], prepared[2][1]
        prog = self._program
        if prog is not None and fine_out is prog.fine_out:
            geometry = tuple(int(ld[k]) for k in OUTPUT_FIELDS)
            return prog.present(geometry + (premul, srgb), functools.partial(
                present_packed, geometry=geometry, premul=premul, srgb=srgb))
        return assemble_present(fine_out, output_layout(ld, packed), premul, srgb)

    @contextlib.contextmanager
    def _call(self, label):
        """One render call: takes the next frame index (yielded), counts
        it, and with a `profiler` is a group of it labeled `label` that
        carries the index and the call's counts: `replayed` (whether the
        frame it returns is a program's replay), `retries` (the length of
        `last_retries`), `upload_bytes` and `uploads_skipped`, and, once
        the frame's stats are read with its flags (here for a checked
        frame, in `Frame.result()` for one in flight), `frame_counts`."""
        index = self.counters["frames"]
        self.counters["frames"] += 1
        before = dict(self.counters)
        with self._group_of(label, index) as group:
            yield index
            if group is not None:
                group.counts.update(
                    replayed=int(self._program is not None), retries=len(self.last_retries),
                    **{k: self.counters[k] - before[k] for k in ("upload_bytes",
                                                                 "uploads_skipped")})
                if self.last_stats:
                    group.counts.update(frame_counts(self.last_stats))

    @contextlib.contextmanager
    def _group_of(self, label, index):
        """A top-level group of `profiler` for frame `index`, whose parts
        `_span` times (yields None, and times nothing, without one)."""
        if self.profiler is None:
            yield None
            return
        outer = self._open
        group = self.profiler.start(label, index)
        self._open = [group]
        try:
            yield group
        finally:
            self._open = outer
            group.end()

    def _span(self, label):
        """A host span nested in the innermost open span of the current
        group (none without one); yields the span's group."""
        return contextlib.nullcontext() if not self._open else self._nested(label)

    @contextlib.contextmanager
    def _nested(self, label):
        group = self._open[-1].nest(label)
        self._open.append(group)
        try:
            yield group
        finally:
            self._open.pop()
            group.end()

    def _read_clock(self, span, stamps):
        """A checked frame's stamps, read with its flags: its device ms by
        stage as `last_stage_ms`, and its `device` span under the enqueue
        `span` that caused the work (with a profiler)."""
        self.last_stage_ms = None if stamps is None else stage_ms(stamps, STAGES)
        if span is not None and stamps is not None:
            span.add(device_result(stamps, STAGES, NESTED))

    def _prepare(self, scene, params):
        """Resolve and upload (cached per scene revision and params), in
        the spans `resolve`, `layout` (the layout dict, the estimate of a
        new stream shape, the clip depth) and `upload` (the last scene's
        frame released, then `_upload`)."""
        with self._span("prepare"):
            rev = getattr(scene, "_rev", None)
            key = None
            if rev is not None:
                key = (id(scene), rev, params.width, params.height,
                       params.antialiasing_method.value, params.base_color)
                if self._frame is not None and self._frame[0] == key:
                    return self._frame[2]
            enc = scene.encoding if hasattr(scene, "encoding") else scene
            with self._span("resolve"):
                layout, ramps, images, scene_u32 = self._resolver.resolve(enc)
            with self._span("layout"):
                ld = build_layout_dict(layout, params)
                est_key = (layout.n_path_tags, layout.n_paths, len(scene_u32),
                           params.width, params.height)
                if self._est_key != est_key:
                    # A new stream shape starts from its own estimate, as
                    # jello_tpu's host calibration does: the class settled
                    # (or grown) for the previous shape says nothing about
                    # this one.
                    self._caps = estimate_caps_from_scene(
                        scene_u32, layout, params.width, params.height)
                    self._est_key = est_key
                depth = clip_nesting_depth(scene_u32, layout)
            with self._span("upload"):
                with self._span("release"):
                    # The last scene's uploaded frame goes before this one's
                    # is made (and its Scene with it, once the caller has
                    # let go of that).
                    self._frame = None
                inputs = self._upload(scene_u32, ld, ramps, images)
            frame = (est_key, ld, inputs, depth)
            if key is not None:
                # Hold the scene so its id() stays unique while cached.
                self._frame = (key, scene, frame)
            return frame

    def _upload(self, scene_u32, ld, ramps, images):
        """A resolved scene's frame inputs on the device: (scene words,
        packed layout, stop table, atlas or None), in the spans `pad`,
        `digest`, `pin` and `copy` (after `_prepare`'s `release`).

        Size classes (`tpu/render.py:276-293`): the scene words padded with
        zeros to a power of two of at least 1024, the stop table to a power
        of two of rows. The layout is the frame's data, one packed upload a
        scene (`tpu/render.py:294`, `upload_layout`), not a part of its
        program's key. The stop table and atlas are uploaded again only
        when their content differs from the last of their kind, shape and
        dtype (`tpu/render.py:510-523`; the digest is BLAKE2b's)."""
        with self._span("pad"):
            words = np.zeros(_pow2(max(len(scene_u32), 1024)), dtype=np.uint32)
            words[:len(scene_u32)] = scene_u32
            stops = stops_table_or_empty(ramps)
            stops = np.concatenate([stops, np.zeros((_pow2(stops.shape[0]) - stops.shape[0],
                                                     stops.shape[1]), dtype=np.float32)])
            atlas = build_image_atlas(images)
            arrays = [words.view(np.int32), pack_layout(ld).view(np.int32), stops,
                      None if atlas is None else atlas_planar(atlas)]
        with self._span("digest"):
            digests = {i: self._digest(kind, arrays[i])
                       for i, kind in ((2, "ramps"), (3, "atlas")) if arrays[i] is not None}
        kept = {i: d[2] for i, d in digests.items() if d[2] is not None}
        with self._span("pin"):
            host = {i: pinned(torch.from_numpy(np.ascontiguousarray(arr)), self.device)
                    for i, arr in enumerate(arrays) if arr is not None and i not in kept}
        with self._span("copy"):
            out = {i: copy_to(t, self.device) for i, t in host.items()}
        for i, (key, digest, _) in digests.items():
            if i in out:
                self._uploads[key] = (digest, out[i])
        self.counters["upload_bytes"] += sum(t.nbytes for t in host.values())
        self.counters["uploads_skipped"] += len(kept)
        out.update(kept)
        return tuple(out.get(i) for i in range(len(arrays)))

    def _digest(self, kind, arr):
        """(key, BLAKE2b digest, the tensor on the device when the last
        upload of `arr`'s kind, shape and dtype had that content, else
        None) for a stop table or atlas."""
        key = (kind, arr.shape, str(arr.dtype))
        digest = hashlib.blake2b(np.ascontiguousarray(arr).data, digest_size=16).digest()
        kept = self._uploads.get(key)
        return key, digest, kept[1] if kept is not None and kept[0] == digest else None

    def _route(self, prepared, params, caps, reroute=False):
        """A frame's class with its routing (`frame_routing`) and its fine
        stage: (caps, fine_impl); fine_impl None for `reroute`, the
        reference fine stage."""
        _, ld, (_, _, _, atlas_t), clip_depth = prepared
        has_atlas = atlas_t is not None
        routing = frame_routing(int(ld["n_clips"]), has_atlas, clip_depth,
                                params.antialiasing_method.value, self.use_image_tap)
        # The record-stream stage alone takes a clip-free frame whose images,
        # if any, ride the tap; any other frame the hybrid (kernel B and the
        # interpreter; `tpu/render.py:342-351`).
        alone = routing.get("_coarse_dense") and routing.get("_image_tap", not has_atlas)
        return dict(caps, **routing), None if reroute else fine_v2 if alone else fine_hybrid

    def _class_of(self, prepared, params, caps):
        """The settled-class key of a frame at `caps`: `program.caps_key` of
        its inputs and its class with routing, as jello_tpu keys its
        executables. The stream shape is not in it (it chooses when to
        estimate and calibrate again, `_prepare`): a new shape whose
        calibrated class is settled replays that class's program."""
        return caps_key(prepared[2], self._route(prepared, params, caps)[0])

    def _enqueue(self, prepared, params, caps, reroute=False):
        """Enqueue one frame of `prepared` at the class `caps`: (fine
        output, (packed flags and stats, flag keys, stat keys)), nothing
        read. At a settled class the frame is its program's (built on first
        use; the outputs are the program's static ones), else it runs
        eagerly. `reroute` takes the reference fine stage: a program of its
        own once the class has walk bounds (`_walks`), else eagerly."""
        inputs = prepared[2]
        caps_f, fine_impl = self._route(prepared, params, caps, reroute)
        cls = self._class_of(prepared, params, caps)
        walk = self._walks.get(cls) if reroute else {}
        with self._span("enqueue") as span:
            self._enqueue_span = span
            if cls not in self._settled_classes or walk is None:
                self._program = None
                self.counters["eager"] += 1
                fine_out, packed, keys = frame(*inputs, caps_f, fine_impl)
                return fine_out, (packed,) + keys
            caps_f = dict(caps_f, **walk)
            key = program_key(inputs, caps_f, "fine_ref" if reroute else fine_impl.__name__)
            self._program = self._cache.get(key, lambda: FrameProgram(inputs, functools.partial(
                frame, caps=caps_f, fine_impl=fine_impl)), key_summary(key))
            self.counters["replays"] += 1
            fine_out, packed, keys = self._program.run(inputs)
            return fine_out, (packed,) + tuple(keys)

    def _render_checked(self, prepared, params, max_retries, caps=None):
        """Render `prepared`, reading each frame's flags: grow and retry
        on a raised flag, reroute an `image_region_overflow` frame to the
        reference fine stage, calibrate a new shape's class once.

        `caps` None renders at the renderer's class, which the call grows,
        calibrates and, once a frame is clean, settles; a class given (a
        frame of a shape the renderer has left since) is grown for this
        call only. Returns the fine output of the first clean frame;
        raises if flags are still raised after `max_retries`."""
        est_key = prepared[0]
        own = caps is None
        if own:
            caps = self._caps
        calibrated = not own or self._calib_key == est_key
        reroute = False
        flags = {}
        self.last_retries = []
        for _ in range(max_retries + 2):
            fine_out, packed = self._enqueue(prepared, params, caps, reroute)
            span = self._enqueue_span
            with self._span("flags"):
                flags, stats, stamps = fetch_frame(*packed)
            self.last_flags, self.last_stats = flags, stats
            self._read_clock(span, stamps)
            raised = sorted(k for k, v in flags.items() if v)
            if raised:
                self.flags_history.append(raised)
            if calibrated and not reroute and set(raised) <= {"image_region_overflow"}:
                # No capacity ran short at a class calibration will not
                # replace: the class is settled (a reroute is no matter of
                # capacity).
                self._settled_classes.add(self._class_of(prepared, params, caps))
            if reroute and not raised:
                # The walk bounds of the class's rerouted program, from the
                # first clean rerouted frame (`pipeline/fine_ref.py`).
                self._walks.setdefault(self._class_of(prepared, params, caps),
                                       walk_bounds(stats))
            if flags.get("ref_walk_overflow"):
                # The rerouted program's walk ran short: grow its bounds
                # (`grow_caps`) and render again.
                cls = self._class_of(prepared, params, caps)
                grown = grow_caps(dict(caps, **self._walks[cls]), flags)
                self._walks[cls] = {k: grown[k] for k in WALK_KEYS}
            if flags.get("image_region_overflow"):
                # No capacity to grow: the frame runs again through the
                # reference fine stage, as jello_tpu reroutes it
                # (`tpu/render.py:428-434`). The decision lives in this
                # call only (`render_frame` takes `fine_ref.fine`), never
                # in the kept class.
                self.last_retries.append(["image_region_overflow: rerouted to fine_ref"])
                reroute = True
                continue
            if raised:
                self.last_retries.append(raised)
                caps = grow_caps(caps, flags, stats)
                if own:
                    self._caps = caps
                continue
            if not calibrated:
                calibrated = True
                self._calib_key = est_key
                new_caps = calibrate_caps(caps, stats)
                if caps_shrank(new_caps, caps):
                    self.last_retries.append(["calibrated"])
                    caps = self._caps = new_caps
                    continue
                self._settled_classes.add(self._class_of(prepared, params, caps))
            break
        if any(flags.values()):
            raise RuntimeError(
                f"render overflowed after {max_retries} retries; flags still raised: "
                f"{[k for k, v in flags.items() if v]}")
        if own:
            self._settled_key = est_key
        return fine_out

    def render_device(self, scene, params: RenderParams, max_retries: int = 4,
                      check_flags: bool = True):
        """Render and return (the fine output on the device, ld): (compact,
        tile2rank), or the dense [4, GRID, 256] of a frame that was rerouted
        to the reference fine stage (`assemble` takes either).

        check_flags=False renders one frame at the current class and reads
        nothing to the host (`tpu/render.py:247,406-408`): the frame's
        packed flags stay on the device in `unread_flags` (merged with
        those of the other unread frames), `last_flags` is None, and
        `read_flags()` reads them.

        The fine output is the caller's: a frame of a program is copied
        out of the program's static outputs."""
        with self._call("render_device"):
            prepared = self._prepare(scene, params)
            if check_flags:
                fine_out = self._render_checked(prepared, params, max_retries)
            else:
                fine_out, (packed, fkeys, skeys) = self._enqueue(prepared, params, self._caps)
                keys = (tuple(fkeys), tuple(skeys))
                # The flags and stats only: the stage clock is no flag.
                packed = packed[:len(fkeys) + len(skeys)]
                kept = self.unread_flags.get(keys)
                self.unread_flags[keys] = (packed.clone() if kept is None
                                           else torch.maximum(kept, packed))
                self.last_flags = self.last_stats = self.last_stage_ms = None
                self.last_retries = []
            if self._program is not None and fine_out is self._program.fine_out:
                fine_out = map_tensors(fine_out, torch.clone)
            return fine_out, prepared[1]

    def read_flags(self) -> dict:
        """Read the flags of every frame rendered with check_flags=False
        since the last read to the host (the host waits for them): sets
        `last_flags` (a flag raised by any of those frames is raised) and
        `last_stats` (each the largest), records raised flags in
        `flags_history`, and returns the flags."""
        if not self.unread_flags:
            raise RuntimeError("read_flags: no frame rendered with check_flags=False is unread")
        flags, stats = {}, {}
        for (fkeys, skeys), packed in self.unread_flags.items():
            f, s, _ = fetch_frame(packed, fkeys, skeys)
            raised = sorted(k for k, v in f.items() if v)
            if raised:
                self.flags_history.append(raised)
            for k, v in f.items():
                flags[k] = flags.get(k, False) or v
            for k, v in s.items():
                stats[k] = max(stats.get(k, v), v)
        self.unread_flags = {}
        self.last_flags, self.last_stats = flags, stats
        return flags

    def _render_again(self, prepared, params, caps, flags, max_retries, stats=None):
        """An enqueued frame came back with `flags` raised at the class
        `caps` (and `stats`, its counters): render it again, checked, from
        the same inputs. For the shape the renderer holds, its class is
        grown (`grow_caps`, with the frame's stats) if it is still the
        frame's (an earlier frame in flight, or a checked render, may
        have moved it since); a frame of a shape the renderer has left
        grows its own class for this call only. Returns the fine output."""
        raised = sorted(k for k, v in flags.items() if v)
        self.flags_history.append(raised)
        if prepared[0] != self._est_key:
            fine_out = self._render_checked(prepared, params, max_retries,
                                            grow_caps(caps, flags, stats))
        else:
            if self._caps == caps:
                self._caps = grow_caps(caps, flags, stats)
            fine_out = self._render_checked(prepared, params, max_retries)
        self.last_retries.insert(0, raised)
        return fine_out


class Frame:
    """A frame in flight, from `Renderer.render_surface_async`: its u8
    surface pixels and packed flags and stamps in one device buffer,
    copied to pinned host memory behind a CUDA event (`tpu/render.py:
    526-547`; on the CPU the frame is done when enqueued). `ready()` polls
    without blocking; `result()` waits, reads the flags and the stage
    clock and, if a flag is raised, grows the class and renders the frame
    again from the inputs it was enqueued with (not from the Scene, which
    the caller may have changed since). `index` is the frame index of the
    call that made it, which its `result` group shares."""

    def __init__(self, renderer, prepared, params, caps, present_args, u8, unread, flags,
                 index=None, span=None, stage_times=None, group=None):
        self._renderer = renderer
        self.index = index
        # The call's group (with a profiler, for a frame whose flags are
        # unread), which gets the frame's counts (`frame_counts`) when
        # `result()` reads its stats.
        self._group = group
        # The call's enqueue span (with a profiler), which the frame's
        # device times join when `result()` reads them.
        self._span = span
        self._prepared = prepared
        self._params = params
        self._caps = caps
        self._present_args = present_args
        self._shape = tuple(u8.shape)
        self._n = u8.numel()
        self._keys = None
        parts = [u8.reshape(-1)]
        if unread is not None:
            packed, fkeys, skeys = unread
            parts.append(packed.view(torch.uint8))
            self._keys = (fkeys, skeys)
        self._host, self._event = pinned_read(torch.cat(parts))
        self._pixels = None
        # The frame's flags, and its device ms by stage (None for a frame
        # with no stage clock): read when the frame was rendered checked
        # (the first of a shape), else None until `result()` reads them.
        self.flags = flags
        self.stage_ms = stage_times

    def ready(self) -> bool:
        """Whether `result()` would not wait."""
        return self._pixels is not None or self._event is None or self._event.query()

    def result(self) -> np.ndarray:
        """The frame's u8 [H, W, 4] surface pixels on the host. With the
        renderer's profiler, a `result` group of the frame's index, with
        the spans `wait` and, for a frame rendered again, `render_again`."""
        if self._pixels is not None:
            return self._pixels
        r = self._renderer
        with r._group_of("result", self.index):
            with r._span("wait"):
                if self._event is not None:
                    self._event.synchronize()
            pixels = self._host[:self._n].view(self._shape).numpy()
            if self._keys is not None:
                values = self._host[self._n:].view(torch.int32).tolist()
                flags, stats = unpack_flags(values, *self._keys)
                stamps = unpack_stamps(values, *self._keys)
                self.flags = flags
                if stamps is not None:
                    self.stage_ms = stage_ms(stamps, STAGES)
                    if self._span is not None:
                        self._span.add(device_result(stamps, STAGES, NESTED))
                if any(flags.values()):
                    premul, srgb, max_retries = self._present_args
                    with r._span("render_again"):
                        fine_out = r._render_again(self._prepared, self._params, self._caps,
                                                   flags, max_retries, stats)
                        pixels = device_to_host(r._present(self._prepared, fine_out,
                                                           premul, srgb))
                    stats = r.last_stats
                if self._group is not None:
                    self._group.counts.update(frame_counts(stats))
        self._pixels = pixels
        return pixels
