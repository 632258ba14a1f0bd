"""Shared inputs and references for the jello_tpu_torch parity tests.

Both packages get the same numpy inputs (resolved scene words, layout
dict, stop table, image atlas, caps); the jello_tpu side runs its stage functions
under numpy, exactly in `pipeline/render.py::render_frame`'s order, and
the port side gets them through `jello_tpu_torch.cuda.upload`.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

import jello_tpu
import jello_tpu_torch
from jello_tpu.cpu.pipeline import build_image_atlas, build_layout_dict
from jello_tpu.pipeline import clips, coarse, drawobjs, flatten, tiling
from jello_tpu.pipeline import ops as np_ops
from jello_tpu.pipeline.gradient import stops_table_or_empty
from jello_tpu.pipeline.render import _draw_tags
from jello_tpu.renderer.estimate import estimate_caps_from_scene
from jello_tpu.renderer.resolve import Resolver


# The suite runs in several worker processes at once; torch's default of
# one intra-op thread per core in each of them oversubscribes the cores.
torch.set_num_threads(min(torch.get_num_threads(), 2))


def both(build, *args, **kw):
    """One scene built through each package's own scene API, since a
    renderer resolves only its own package's types: ((scene, params) of
    jello_tpu, (scene, params) of jello_tpu_torch). `build(jt, ...)`
    takes the package as `jt`; tests/test_torch_host.py holds the two
    encodings byte-equal."""
    return build(jello_tpu, *args, **kw), build(jello_tpu_torch, *args, **kw)


@functools.lru_cache(maxsize=None)
def config2_both():
    """Config 2 built once through each package (its dashes are flattened
    in Python on the host, tens of seconds a build): ((scene, params) of
    jello_tpu, (scene, params) of jello_tpu_torch)."""
    import jello_tpu.scenes
    import jello_tpu_torch.scenes

    return jello_tpu.scenes.config2(), jello_tpu_torch.scenes.config2()


def check_frame(r, build, tol=2e-3, **kw):
    """Render `build` through the port's renderer `r` and through the
    numpy oracle, hold the port's image to the oracle's within `tol` with
    no flag raised; returns (port image, oracle image, the port's (scene,
    params))."""
    from jello_tpu.cpu import render_numpy

    built = build() if build is config2_both else both(build, **kw)
    (scene_j, params_j), (scene_t, params_t) = built
    img = r.render(scene_t, params_t)
    assert not any(r.last_flags.values()), r.last_flags
    with np.errstate(all="ignore"):
        ref, _, _ = render_numpy(scene_j, params_j)
    assert img.shape == ref.shape and img.dtype == np.float32
    assert np.isfinite(img).all()
    err = np.abs(img - ref).max()
    print(f"{getattr(build, '__name__', build)}: max abs error vs the oracle {err:.3e}")
    assert err <= tol
    return img, ref, (scene_t, params_t)


def prepare_with_atlas(scene, params):
    """(scene_u32, ld, ramps, atlas, caps) exactly as the renderers build
    them, from a jello_tpu scene; atlas is the [AH, AW, 4] plane or None."""
    layout, ramps, images, scene_u32 = Resolver().resolve(scene.encoding)
    ld = build_layout_dict(layout, params)
    caps = estimate_caps_from_scene(scene_u32, layout, params.width, params.height)
    # jello_tpu's routing of a clip-free area frame (tpu/render.py:341-346),
    # read by its stages; the port's stages take that route always.
    caps.update(aa_mode="area", _coarse_dense=True)
    return scene_u32, ld, stops_table_or_empty(ramps), build_image_atlas(images), caps


def prepare(scene, params):
    """(scene_u32, ld, ramps, caps) of `prepare_with_atlas`."""
    scene_u32, ld, ramps, _, caps = prepare_with_atlas(scene, params)
    return scene_u32, ld, ramps, caps


def numpy_geometry(scene_u32, ld, caps):
    """jello_tpu's stages before fine, under numpy (render_frame order)."""
    xp = np
    with np.errstate(all="ignore"):
        fl = flatten.flatten_stage(xp, scene_u32, ld, caps)
        D = caps["n_draws_cap"]
        tags = _draw_tags(xp, scene_u32, ld, D)
        dm = drawobjs.draw_monoid_scan(xp, tags)
        info, clip_idx, clip_path, tag, dd, di = drawobjs.draw_leaf(
            xp, scene_u32, ld, dm, fl["path_trans_idx"], fl["path_draw_flags"],
            caps, tag=tags)
        clip_bboxes, dm_path, dm_scene = clips.clip_leaf(
            xp, clip_idx, clip_path, fl["path_bbox"], dm["path_idx"].astype(np.int32),
            dm["scene_offset"].astype(np.int32), ld, caps)
        dm = dict(dm, path_idx=dm_path, scene_offset=dm_scene)
        dd = (ld["draw_data_base"] + dm_scene).astype(np.int32)
        sc4 = np_ops.gather_guarded(
            xp, scene_u32, np.concatenate([dd + k for k in range(4)])).reshape(4, D)
        dtab = np.concatenate([sc4.T, info[:, 1:10]], axis=1)
        draw_bbox = coarse.binning_bboxes(xp, dm, fl["path_bbox"], clip_bboxes, ld)
        paths = tiling.tile_alloc(xp, draw_bbox, tag, ld, caps)
        counted = tiling.path_count(xp, fl, paths, caps)
        cmds = coarse.build_commands(xp, scene_u32, ld, dm, tag, dtab, draw_bbox,
                                     paths, counted, fl["path_draw_flags"], caps)
        cmds["dtab"] = dtab
    return {"fl": fl, "dm": dm, "info": info, "paths": paths, "counted": counted,
            "cmds": cmds, "cmds_tag": tag, "draw_bbox": draw_bbox}


def as_np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def u32(a):
    """Bit pattern as uint32 (int32-carried torch words or numpy u32)."""
    return np.asarray(a).astype(np.int64) & 0xFFFFFFFF


def to_torch(v):
    """numpy -> CPU tensor the way the port carries it: u32 as int32 bit
    patterns, other integers as int32, floats and bools unchanged."""
    a = np.asarray(v)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype.kind in "iu":
        a = a.astype(np.int32)
    return torch.from_numpy(np.ascontiguousarray(a))


def tree_to_torch(d):
    return {k: tree_to_torch(v) if isinstance(v, dict) else to_torch(v)
            for k, v in d.items()}
