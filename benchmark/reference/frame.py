"""One reference frame: a Scene -> u8 [H, W, 4] surface pixels.

The oracle's frame (`jello_tpu/cpu/pipeline.py::render` with the stages
of `jello_tpu/pipeline/render.py::render_frame`): resolve, estimate the
capacity class from the scene, run the geometry stages under numpy on
the host, the fine stage in torch (`fine.py`) on `device`, grow the class
on a raised capacity flag and render again; then assemble and present
(`renderer/surface.py::to_rgba8`).

`low_precision` makes the control: every floating array that passes
from one stage to the next (flatten's lines, the draw tables, the tile
crossings and commands, the stop table, each command's coverage, the
fine output) is rounded to the next precision down, float32 to bfloat16
and float64 to float32, as if each stage computed in it.
"""

from __future__ import annotations

import numpy as np
import torch

from .fine import assemble_image, fine
from .gfx import premul32
from .pipeline import clips as clips_mod
from .pipeline import coarse as coarse_mod
from .pipeline import drawobjs, ops, tiling
from .pipeline import flatten as flatten_mod
from .pipeline.gradient import stops_table_or_empty
from .encoding.draw import DRAW_TAG_NOP
from .renderer.estimate import estimate_caps_from_scene, grow_caps
from .renderer.resolve import Resolver
from .renderer.surface import to_rgba8


def build_layout_dict(layout, params) -> dict:
    """The resolver's stream offsets and counts, the target in pixels and
    16-pixel tiles, and the premultiplied base color."""
    keys = ("path_tag_base", "path_data_base", "draw_tag_base", "draw_data_base",
            "transform_base", "style_base", "n_path_tags", "n_paths", "n_draw_objects",
            "n_clips")
    ld = {k: np.int32(getattr(layout, k)) for k in keys}
    ld.update(width_in_tiles=np.int32((params.width + 15) // 16),
              height_in_tiles=np.int32((params.height + 15) // 16),
              target_width=np.int32(params.width), target_height=np.int32(params.height),
              base_color=premul32(params.base_color))
    return ld


def build_image_atlas(atlas):
    """The resolver's shelf-packed atlas as one [AH, AW, 4] float32 plane
    (values / 255, no sRGB decode), or None."""
    if atlas is None or not len(atlas):
        return None
    plane = np.zeros((atlas.height, atlas.width, 4), dtype=np.float32)
    for img, (ax, ay) in zip(atlas.images, atlas.placements):
        plane[ay: ay + img.height, ax: ax + img.width] = (
            np.asarray(img.pixels, dtype=np.float32) / 255.0)
    return plane


def _bf16(a: np.ndarray) -> np.ndarray:
    """float32 values rounded to bfloat16 (to nearest, ties to even)."""
    u = a.view(np.uint32).astype(np.uint64)
    return ((u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000).astype(np.uint32).view(np.float32)


def lower(x):
    """x with every float32 array or tensor rounded to bfloat16 and every
    float64 one to float32 (dicts, lists and tuples walked)."""
    if isinstance(x, dict):
        return {k: lower(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(lower(v) for v in x)
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.float32:
            return x.to(torch.bfloat16).to(torch.float32)
        if x.dtype == torch.float64:
            return x.to(torch.float32).to(torch.float64)
        return x
    if isinstance(x, np.ndarray) and x.dtype == np.float32:
        return _bf16(np.ascontiguousarray(x)).reshape(x.shape)
    if isinstance(x, np.ndarray) and x.dtype == np.float64:
        return x.astype(np.float32).astype(np.float64)
    return x


def geometry(scene, layout, caps, low=None):
    """The geometry stages of `render_frame` under numpy, `low` (None or
    `lower`) applied to each stage's outputs before the next reads them.
    Returns (cmds, segs, flags)."""
    xp = np
    low = low or (lambda v: v)
    fl = low(flatten_mod.flatten_stage(xp, scene, layout, caps))
    D = caps["n_draws_cap"]
    i = xp.arange(D, dtype=xp.int32)
    t = ops.gather_guarded(xp, scene, layout["draw_tag_base"] + i)
    draw_tags = xp.where(i < layout["n_draw_objects"], t, xp.uint32(DRAW_TAG_NOP))
    dm = drawobjs.draw_monoid_scan(xp, draw_tags)
    info, clip_idx, clip_path, tag, dd, di = low(drawobjs.draw_leaf(
        xp, scene, layout, dm, fl["path_trans_idx"], fl["path_draw_flags"], caps,
        tag=draw_tags))
    clip_bboxes, dm_path, dm_scene = low(clips_mod.clip_leaf(
        xp, clip_idx, clip_path, fl["path_bbox"], dm["path_idx"].astype(xp.int32),
        dm["scene_offset"].astype(xp.int32), layout, caps))
    dm = dict(dm, path_idx=dm_path, scene_offset=dm_scene)
    dd = (layout["draw_data_base"] + dm_scene).astype(xp.int32)
    sc4 = ops.gather_guarded(xp, scene, xp.concatenate([dd + k for k in range(4)])).reshape(4, D)
    dtab = xp.concatenate([xp.transpose(sc4), info[:, 1:10]], axis=1)
    draw_bbox = low(coarse_mod.binning_bboxes(xp, dm, fl["path_bbox"], clip_bboxes, layout))
    paths = low(tiling.tile_alloc(xp, draw_bbox, tag, layout, caps))
    counted = low(tiling.path_count(xp, fl, paths, caps))
    segs = low(tiling.path_tiling(xp, fl, counted, caps))
    cmds = low(coarse_mod.build_commands(xp, scene, layout, dm, tag, dtab, draw_bbox, paths,
                                         counted, fl["path_draw_flags"], caps))
    cmds["dtab"] = dtab
    flags = {"flatten_overflow": fl["overflow"], "tiles_overflow": paths["overflow"],
             "segs_overflow": counted["overflow"], "pairs_overflow": cmds["overflow"]}
    return cmds, segs, flags


FINE_CMD_KEYS = ("tile_start", "tile_end", "kind", "seg_count", "seg_start", "backdrop",
                 "flags", "draw", "dtab")
SEG_KEYS = ("seg_x0", "seg_y0", "seg_x1", "seg_y1", "seg_y_edge")


def _on(device, a):
    a = np.asarray(a)
    if a.dtype.kind in "iub":
        a = a.astype(np.int64) if a.dtype.kind != "b" else a
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def render_u8(scene, params, device, low_precision: bool = False,
              max_retries: int = 8) -> np.ndarray:
    """Render `scene` (this package's Scene) at `params`: u8 [H, W, 4].
    Raises if a capacity flag is still raised after `max_retries` grows."""
    if params.antialiasing_method.value != "area":
        raise ValueError("the reference fine stage renders area antialiasing only")
    device = torch.device(device)
    layout, ramps, images, scene_u32 = Resolver().resolve(scene.encoding)
    ld = build_layout_dict(layout, params)
    caps = estimate_caps_from_scene(scene_u32, layout, params.width, params.height)
    caps.setdefault("aa_mode", "area")
    low = lower if low_precision else None
    ramps_np = stops_table_or_empty(ramps)
    ramps_t = _on(device, lower(ramps_np) if low_precision else ramps_np)
    atlas = build_image_atlas(images)
    atlas_t = None if atlas is None else _on(device, atlas)
    flags = {}
    with np.errstate(all="ignore"):
        for _ in range(max_retries + 1):
            cmds, segs, flags = geometry(scene_u32, ld, caps, low)
            flags = {k: bool(v) for k, v in flags.items()}
            if not any(flags.values()):
                out, depth_overflow = fine(
                    {k: _on(device, cmds[k]) for k in FINE_CMD_KEYS},
                    {k: _on(device, segs[k]) for k in SEG_KEYS},
                    ramps_t, atlas_t, ld, caps, low)
                flags["blend_depth_overflow"] = depth_overflow
                if not depth_overflow:
                    break
            caps = grow_caps(caps, flags)
    raised = sorted(k for k, v in flags.items() if v)
    if raised:
        raise RuntimeError(f"reference frame still overflows: {raised}")
    img = assemble_image(out, ld).cpu().numpy()
    return to_rgba8(img)
