"""Renderer on a torch device (CUDA, or the CPU when asked).

Counterpart of `jello_tpu/tpu/render.py::Renderer` (`render`,
`render_surface`, the retry/grow/calibrate loop and the device-side
present). The pipeline runs eagerly, so there is no compile per
capacity class, and capacities are calibrated from the device's own
run: the first frame of a scene shape runs at the estimated class with
its exact counters, `calibrate_caps` shrinks the class, and the frame
runs again (the protocol of `tpu/render.py:445-461`). Overflow flags
grow the implicated capacities (`grow_caps`) and retry. Flags are read
on every frame.

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
(`tpu/render.py:428-434`).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..encoding.draw import DRAW_TAG_BEGIN_CLIP, DRAW_TAG_END_CLIP
from ..gfx import premul32
from ..pipeline.fine_ref import assemble_image
from ..pipeline.gradient import stops_table_or_empty
from ..pipeline.image_tap import atlas_planar
from ..pipeline.render import render_frame
from ..renderer.atlas import build_image_atlas
from ..renderer.estimate import (
    calibrate_caps,
    caps_shrank,
    estimate_caps_from_scene,
    grow_caps,
)
from ..renderer.params import RenderParams
from ..renderer.resolve import Resolver
from .fine_hybrid import fine_hybrid
from .fine_v2 import assemble_compact, fine_v2


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
    return torch.from_numpy(atlas_planar(atlas)).to(torch.device(device))


def upload(scene_u32, ld, ramps, caps, device):
    """The inputs `jello_tpu` feeds `render_frame`, as torch inputs on
    `device`: scene words as int32 bit patterns, the layout's integer
    fields as host ints plus `base_color` as a f32 [4] tensor, the stop
    table as f32. The atlas goes through `upload_atlas`.
    Returns (scene, layout, ramps, caps)."""
    device = torch.device(device)
    scene = torch.from_numpy(np.asarray(scene_u32, dtype=np.uint32).view(np.int32).copy())
    layout = {k: int(v) for k, v in ld.items() if k != "base_color"}
    layout["base_color"] = torch.tensor(np.asarray(ld["base_color"], dtype=np.float32),
                                        device=device)
    ramps_t = torch.from_numpy(np.ascontiguousarray(ramps, dtype=np.float32))
    return scene.to(device), layout, ramps_t.to(device), dict(caps)


def clip_nesting_depth(scene_u32, layout) -> int:
    """The deepest nesting of the resolved scene's clip layers (host-side,
    from its draw tags): the trip count of `clips.clip_leaf_vectorized`."""
    tags = np.asarray(scene_u32[layout.draw_tag_base:
                                layout.draw_tag_base + layout.n_draw_objects])
    delta = (tags == DRAW_TAG_BEGIN_CLIP).astype(np.int64) - (tags == DRAW_TAG_END_CLIP)
    return int(np.cumsum(delta).max(initial=0))


def frame_routing(n_clips: int, has_atlas: bool, clip_depth: int,
                  aa_mode: str = "area") -> dict:
    """jello_tpu's routing on its accelerator (`tpu/render.py:332-365`),
    set per frame and never kept in the class that calibrate_caps and
    grow_caps see: the antialiasing mode ("area", "msaa8", "msaa16"), read
    by the coverage and fine stages; the streaming expansions (kernels C,
    D, E) always; for
    a scene with an atlas the image tap (kernel F); for a clip-free frame
    the dense coarse branch, and with it the record-stream fine stage
    alone (a frame with clip layers takes `fine_hybrid`); the 8-tile
    interpreter (kernel H) under JELLO_INTERP_BATCH=1, the reference's own
    switch. `clip_depth_cap` is the scene's own nesting depth."""
    routing = {"_expand_pallas": True, "aa_mode": aa_mode}
    if has_atlas:
        routing["_image_tap"] = True
    if n_clips == 0:
        routing["_coarse_dense"] = True
    else:
        routing["clip_depth_cap"] = max(int(clip_depth), 1)
        if os.environ.get("JELLO_INTERP_BATCH", "0") == "1":
            routing["_interp_batch"] = True
    return routing


def assemble(fine_out, ld):
    """A frame's fine output -> [H, W, 4] un-premultiplied image on its
    device: (compact, tile2rank) of the record-stream stages, or the
    dense [4, GRID, 256] of the reference fine stage."""
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


class Renderer:
    """Renders `jello_tpu_torch.Scene`s with the torch pipeline on
    `device`.

    Keeps the resolver (ramp cache), the uploaded frame inputs of the
    last scene revision (stop table and image atlas included, uploaded
    once per revision) and the capacity class across frames."""

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
        self._frame = None
        self.last_flags: dict = {}
        self.last_stats: dict = {}
        # What made each frame of the last render run again: the raised
        # flags of a grown class, ["calibrated"], or the reroute of an
        # `image_region_overflow` frame to the reference fine stage.
        self.last_retries: list = []

    def render(self, scene, params: RenderParams, max_retries: int = 4) -> np.ndarray:
        """Render to a host [H, W, 4] float32 un-premultiplied image."""
        fine_out, ld = self.render_device(scene, params, max_retries)
        return assemble(fine_out, ld).cpu().numpy()

    def render_surface(self, scene, params: RenderParams, premul: bool = True,
                       srgb: bool = True, max_retries: int = 4) -> np.ndarray:
        """Render to u8 [H, W, 4] surface pixels; assembly, premultiply,
        sRGB and quantization run on the device."""
        fine_out, ld = self.render_device(scene, params, max_retries)
        return present(assemble(fine_out, ld), premul, srgb).cpu().numpy()

    def _prepare(self, scene, params):
        """Resolve and upload (cached per scene revision and params)."""
        rev = getattr(scene, "_rev", None)
        key = None
        if rev is not None:
            key = (id(scene), rev, params.width, params.height,
                   params.antialiasing_method.value, params.base_color)
            if self._frame is not None and self._frame[0] == key:
                return self._frame[2]
        enc = scene.encoding if hasattr(scene, "encoding") else scene
        layout, ramps, images, scene_u32 = self._resolver.resolve(enc)
        ld = build_layout_dict(layout, params)
        est_key = (layout.n_path_tags, layout.n_paths, len(scene_u32),
                   params.width, params.height)
        if self._est_key != est_key:
            # A new stream shape starts from its own estimate, as
            # jello_tpu's host calibration does: the class settled (or
            # grown) for the previous shape says nothing about this one.
            self._caps = estimate_caps_from_scene(
                scene_u32, layout, params.width, params.height)
            self._est_key = est_key
        inputs = upload(scene_u32, ld, stops_table_or_empty(ramps), {}, self.device)[:3]
        inputs += (upload_atlas(build_image_atlas(images), self.device),)
        frame = (est_key, ld, inputs, clip_nesting_depth(scene_u32, layout))
        if key is not None:
            # Hold the scene so its id() stays unique while cached.
            self._frame = (key, scene, frame)
        return frame

    def render_device(self, scene, params: RenderParams, max_retries: int = 4):
        """Render and return (the fine output on the device, ld): (compact,
        tile2rank), or the dense [4, GRID, 256] of a frame that was rerouted
        to the reference fine stage (`assemble` takes either)."""
        est_key, ld, (scene_t, layout_t, ramps_t, atlas_t), clip_depth = self._prepare(
            scene, params)
        routing = frame_routing(layout_t["n_clips"], atlas_t is not None, clip_depth,
                                params.antialiasing_method.value)
        fine_impl = fine_v2 if routing.get("_coarse_dense") else fine_hybrid
        calibrated = self._calib_key == est_key
        flags = {}
        self.last_retries = []
        for _ in range(max_retries + 2):
            fine_out, flags_t, stats_t = render_frame(
                scene_t, layout_t, ramps_t, atlas_t, dict(self._caps, **routing), fine_impl)
            fkeys, skeys = sorted(flags_t), sorted(stats_t)
            vals = torch.stack([flags_t[k].to(torch.int64).reshape(()) for k in fkeys]
                               + [stats_t[k].to(torch.int64).reshape(()) for k in skeys]).cpu()
            flags = {k: bool(v) for k, v in zip(fkeys, vals[:len(fkeys)].tolist())}
            stats = {k: int(v) for k, v in zip(skeys, vals[len(fkeys):].tolist())}
            self.last_flags, self.last_stats = flags, stats
            if flags.get("image_region_overflow"):
                # No capacity to grow: the frame runs again through the
                # reference fine stage, as jello_tpu reroutes it
                # (`tpu/render.py:428-434`). The decision lives in this
                # call's `fine_impl` only (None: `render_frame` takes
                # `fine_ref.fine`), never in the kept class.
                self.last_retries.append(["image_region_overflow: rerouted to fine_ref"])
                fine_impl = None
                continue
            if any(flags.values()):
                self.last_retries.append(sorted(k for k, v in flags.items() if v))
                self._caps = grow_caps(self._caps, flags)
                continue
            if not calibrated:
                calibrated = True
                self._calib_key = est_key
                new_caps = calibrate_caps(self._caps, stats)
                if caps_shrank(new_caps, self._caps):
                    self.last_retries.append(["calibrated"])
                    self._caps = new_caps
                    continue
            break
        if any(flags.values()):
            raise RuntimeError(
                f"render overflowed after {max_retries} retries; flags still raised: "
                f"{[k for k, v in flags.items() if v]}")
        return fine_out, ld
