"""Multi-GPU rendering with the geometry sharded too.

Counterpart of `jello_tpu/tpu/sharded2.py`, step by step:

  - flatten by tag ranges: rank r flattens slots [r * N_l, (r + 1) *
    N_l) with the tag monoid as a two-level scan (its own exclusive scan
    plus the deltas of the ranks before it, from one `all_gather` of the
    per-rank totals); the per-path bboxes combine by maximum, the
    per-path marker fields by sum (each marker lies in one rank's range);
  - draw_leaf, clip_leaf, binning and tile_alloc replicated;
  - path_count on the rank's own lines: the compactions through kernel
    C, the crossings and backdrop rows through kernels E' and E''; the
    backdrop deltas combine by sum, and the crossings travel to the rank
    that owns their tile's stripe through one fixed-capacity
    `all_to_all` ([n, seg_ex_cap, 8] rows, `exchange_overflow` past
    seg_ex_cap), then sort by slot on the owner;
  - per-tile segment counts and starts by sum; coarse replicated;
  - the stripe's slice of the command stream, gathered at positions
    computed on the device (no host read inside a frame);
  - `fine_hybrid` on the stripe (kernels A, B, G, and F under the image
    tap), the stripe's tile rows, one `all_gather`.

`shard_caps` derives the per-rank capacities from the single-device
class, with the same numbers as jello_tpu's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..pipeline import coarse, ops
from ..pipeline.flatten import decode_tag_stream, finalize_path_bbox, flatten_stage
from ..pipeline.ops import F32, I32
from ..pipeline.pathtag import monoid_delta_totals
from ..pipeline.render import draw_stages
from ..pipeline.tiling import SEG_KEYS, path_count_expansions, path_count_params
from .collectives import all_gather, all_to_all, pmax, psum
from .fine_hybrid import fine_hybrid


def _align(v, q):
    return -(-int(v) // q) * q


def shard_caps(caps: dict, n: int, beta: float = 2.0) -> dict:
    """The per-rank capacity class from the single-device one
    (`sharded2.py:58-89`). Line, tag, work, segment, command-slice,
    legacy-tile and image-record capacities scale by beta / n (content is
    not spread evenly over tag ranges or stripes); tile, draw, path and
    pair capacities stay (those stages run replicated). Tag slots align to
    1024, expansion outputs to 512. `seg_ex_cap` is one (source,
    destination) slice of the crossing exchange."""
    c = dict(caps)
    c["n_tag_slots"] = _align(caps["n_tag_slots"] // n, 1024)
    for k in ("work_a_cap", "work_b_cap"):
        c[k] = _align(caps[k] * beta / n, 256)
    for k in ("euler_line_cap", "simple_line_cap", "arc_line_cap"):
        c[k] = _align(caps[k] * beta / n, 512)
    c["line_cap"] = c["euler_line_cap"] + c["simple_line_cap"] + c["arc_line_cap"]
    for k in ("seg_cap", "row_cap", "area_rows_cap"):
        c[k] = _align(caps[k] * beta / n, 512)
    for k in ("cross_lines_cap", "row_lines_cap"):
        c[k] = _align(caps[k] * beta / n, 512)
    c["cmd_cap"] = _align(caps.get("cmd_cap", caps["pair_cap"]) * beta / n, 512)
    c["legacy_tiles_cap"] = _align(caps.get("legacy_tiles_cap", 2048) * beta / n, 256)
    c["img_recs_cap"] = _align(caps.get("img_recs_cap", 1024) * beta / n, 256)
    c["seg_ex_cap"] = _align(caps["seg_cap"] * beta / (n * n), 512)
    return c


def make_sharded_render(group, caps_global, debug=False, seg_ex_cap=None):
    """The geometry-sharded frame of this rank (`sharded2.py:92-458`).

    caps_global: the single-device class with the frame's routing
    (`sharded.sharded_caps`); the rank's own capacities come from
    `shard_caps`. seg_ex_cap: the exchange slice's rows in place of
    `shard_caps`'s (a test forces a small one to show its flag). Returns
    run(scene, layout, ramps, atlas=None) -> (fine_out [4, GRID, 256]
    un-premultiplied, flags {name: 0-dim bool}), plus with `debug` a dict
    of the exchanged state: seg_count, backdrop (the prefix), recv
    [n, n, seg_ex_cap, 8] (every rank's received rows, by source), lo and
    cnt [n] (each stripe's slice of the command stream), raised [n, K]
    (each rank's own flags before they combine, in the flags' order),
    load [n, 3] (each rank's Euler work items, line slots and crossings)."""
    n, d = group.world, group.rank
    caps = dict(caps_global)
    GRID = caps["tile_grid_cap"]
    if GRID % n:
        raise ValueError(f"tile_grid_cap {GRID} does not divide among {n} ranks")
    T = caps["tiles_cap"]
    if T >= 1 << 24:
        raise ValueError(f"tiles_cap {T}: the exchange carries slots as float32, exact "
                         "below 2**24")
    local_tiles = GRID // n
    caps_l = dict(shard_caps(caps, n), _expand_pallas=True)
    N_l = caps_l["n_tag_slots"]
    PEX = seg_ex_cap or caps_l["seg_ex_cap"]
    CC_l = caps_l["cmd_cap"]
    SC_l = caps_l["seg_cap"]
    tag_lo = d * N_l
    stripe_lo = d * local_tiles

    def run(scene, layout, ramps, atlas=None):
        dev = scene.device

        # ---- flatten: two-level tag monoid scan ------------------------
        tags = decode_tag_stream(scene, layout["path_tag_base"] + tag_lo // 4, N_l)
        totals = all_gather(group, monoid_delta_totals(tags))
        base = (torch.cumsum(totals, 0, dtype=I32) - totals)[d]
        fl = flatten_stage(scene, layout, caps_l,
                           shard={"tag_lo": tag_lo, "monoid_base": base})
        meta = psum(group, torch.stack([fl["path_draw_flags"], fl["path_trans_idx"]], 1))
        fl = dict(fl, path_bbox=finalize_path_bbox(pmax(group, fl["bb_acc"])),
                  path_draw_flags=meta[:, 0], path_trans_idx=meta[:, 1])

        # ---- replicated: draw_leaf, clip_leaf, binning, tile_alloc -----
        dm, info, tag, dtab, draw_bbox, paths = draw_stages(scene, layout, fl, caps)

        # ---- path_count on the rank's lines ----------------------------
        P, n_cross, n_rows, _ = path_count_params(fl, paths, caps_l)
        (tile_slot, seg_pre, bump_slot, bump_delta, c_total, r_slot, r_delta, r_total,
         compact_overflow) = path_count_expansions(P, n_cross, n_rows, caps_l)
        bd = torch.zeros(T + 1, dtype=I32, device=dev)
        bd = ops.scatter_add(ops.scatter_add(bd, r_slot, r_delta), bump_slot, bump_delta)
        bd = psum(group, bd[:T])

        # ---- crossings to their stripe's rank: one all_to_all ----------
        slot_ok = (tile_slot >= 0) & (tile_slot < T)
        s_clip = torch.clamp(tile_slot, 0, T - 1)
        g_id = (ops.gather_guarded(paths["tile_ty"], s_clip) * layout["width_in_tiles"]
                + ops.gather_guarded(paths["tile_tx"], s_clip))
        dest = torch.where(slot_ok, torch.clamp(g_id // local_tiles, 0, n - 1), n).to(I32)
        ds, *payload = ops.sort_multi(dest, (tile_slot.to(F32),)
                                      + tuple(seg_pre[k].to(F32) for k in SEG_KEYS))
        dsc = torch.clamp(ds, 0, n)
        start_dest = ops.exclusive_cumsum(ops.scatter_add(
            torch.zeros(n + 1, dtype=I32, device=dev), dsc,
            torch.ones(SC_l, dtype=I32, device=dev)))
        within = ops.iota(SC_l, dev) - ops.gather_guarded(start_dest, dsc)
        exchange_overflow = ((ds < n) & (within >= PEX)).any()
        # Unwritten rows carry the dead slot T.
        send = torch.cat([torch.full((n * PEX, 1), float(T), dtype=F32, device=dev),
                          torch.zeros((n * PEX, 7), dtype=F32, device=dev)], 1)
        zc = torch.zeros(SC_l, dtype=F32, device=dev)
        send = ops.scatter_set(send, torch.where((ds < n) & (within < PEX), ds * PEX + within,
                                                 n * PEX),
                               torch.stack(payload + [zc, zc], 1))
        recv = all_to_all(group, send.reshape(n, PEX, 8)).reshape(n * PEX, 8)

        # ---- the owner's slot sort and per-tile counts -----------------
        sorted_slot, *segs = ops.sort_multi(recv[:, 0].to(I32),
                                            tuple(recv[:, 1 + i] for i in range(5)))
        segs_local = dict(zip(SEG_KEYS, segs))
        live = (sorted_slot >= 0) & (sorted_slot < T)
        count_local = ops.scatter_add(
            torch.zeros(T + 1, dtype=I32, device=dev), torch.where(live, sorted_slot, T),
            torch.ones(n * PEX, dtype=I32, device=dev))[:T]
        start_local = ops.exclusive_cumsum(count_local)
        owned = count_local > 0
        # seg_start is global: the owner's position plus its block's base.
        cs = psum(group, torch.stack(
            [count_local, torch.where(owned, start_local + d * n * PEX, 0)], 1))
        seg_count, seg_start = cs[:, 0], cs[:, 1]
        cume = ops.exclusive_cumsum(bd)
        bd_prefix = cume - ops.gather_guarded(cume, paths["tile_row_start"]) + bd
        has = (seg_count > 0).to(I32)
        row_of_slot = ops.exclusive_cumsum(has)
        counted = {"seg_count": seg_count, "seg_start": seg_start, "backdrop": bd_prefix,
                   "row_of_slot": row_of_slot, "n_rows": row_of_slot[-1] + has[-1]}

        # ---- coarse (replicated) ---------------------------------------
        cmds = coarse.build_commands(layout, dm, tag, dtab, draw_bbox, paths, counted,
                                     fl["path_draw_flags"], caps)

        # ---- the stripe's slice of the command stream ------------------
        st = cmds["tile"]
        lo = (st < stripe_lo).sum(dtype=I32)
        cnt = ((st >= stripe_lo) & (st < stripe_lo + local_tiles)).sum(dtype=I32)
        j = ops.iota(CC_l, dev)
        pos, in_slice = lo + j, j < cnt

        def slc(name, fill):
            return torch.where(in_slice, ops.gather_guarded(cmds[name], pos), fill)

        cmds_l = {k: slc(k, fill) for k, fill in (
            ("tile", GRID), ("kind", 0), ("seg_count", 0), ("backdrop", 0),
            ("tile_slot", T), ("flags", 0), ("draw", 0))}
        cmds_l["seg_start"] = slc("seg_start", 0) - d * n * PEX
        cmds_l["dtab"] = dtab
        stl = cmds_l["tile"]
        prev = torch.cat([torch.full((1,), -1, dtype=I32, device=dev), stl[:-1]])
        nxt = torch.cat([stl[1:], torch.full((1,), GRID + 1, dtype=I32, device=dev)])
        zeros = torch.zeros(GRID, dtype=I32, device=dev)
        cmds_l["tile_start"] = ops.scatter_set(
            zeros, torch.where((stl != prev) & (stl < GRID), stl, GRID), j)
        cmds_l["tile_end"] = ops.scatter_set(
            zeros, torch.where((stl != nxt) & (stl < GRID), stl, GRID), j + 1)
        counted_l = {"segs": segs_local, "sorted_slot": sorted_slot,
                     "seg_count": torch.where(owned, seg_count, 0), "seg_start": start_local,
                     "backdrop": bd_prefix, "n_rows": counted["n_rows"]}

        # ---- the stripe's fine stage, its tile rows, one all_gather ----
        (compact, tile2rank), fine_flags = fine_hybrid(cmds_l, counted_l, ramps, atlas,
                                                       layout, caps_l)
        ranks = ops.gather_guarded(tile2rank, stripe_lo + ops.iota(local_tiles, dev))
        rows = ops.gather_guarded(compact, torch.clamp(ranks, 0, compact.shape[0] - 1))
        b = layout["base_color"]
        base_un = torch.cat([b[:3] / torch.clamp(b[3:], min=1e-6), b[3:]])
        rows = torch.where((ranks >= 0)[:, None, None], rows, base_un[None, :, None])
        fine_out = all_gather(group, rows).reshape(GRID, 4, 256).permute(1, 0, 2)

        flags = {
            "flatten_overflow": fl["overflow"],
            "tiles_overflow": paths["overflow"],
            "segs_overflow": ((c_total > SC_l) | (r_total > caps_l["row_cap"])
                              | compact_overflow | exchange_overflow),
            "pairs_overflow": cmds["overflow"] | (cnt > CC_l),
            **fine_flags,
        }
        if caps_l.get("_image_tap"):
            flags.setdefault("img_recs_overflow", torch.zeros((), dtype=torch.bool,
                                                              device=dev))
        keys = sorted(flags)
        own = torch.stack([flags[k].to(I32).reshape(()) for k in keys])
        raised = pmax(group, own)
        flags = {k: raised[i] > 0 for i, k in enumerate(keys)}
        if not debug:
            return fine_out, flags
        return fine_out, flags, {
            "seg_count": seg_count, "backdrop": bd_prefix,
            "recv": all_gather(group, recv.reshape(n, PEX, 8)),
            "lo": all_gather(group, lo), "cnt": all_gather(group, cnt),
            "raised": all_gather(group, own),
            "load": all_gather(group, torch.stack([
                (fl["n_work_a"] + fl["n_work_b"]).to(I32), fl["n_lines"].to(I32),
                c_total.to(I32)]))}

    return run


def dryrun_scene(jt, full_profile=False):
    """`sharded2.py::dryrun`'s scene (`:494-532`) through the package `jt`:
    a filled cubic and a stroke, 128x128; with `full_profile` 256x256 and
    also a pure clip layer taller than every stripe, a linear gradient and
    an upscaled image."""
    scene = jt.Scene()
    W = H = 256 if full_profile else 128
    ident = jt.Affine.identity()
    path = (jt.BezPath().move_to(5, 5).cubic_to(30, 2, 50, 60, W - 30, H - 50)
            .line_to(60, 10).close())
    scene.fill(jt.Fill.NON_ZERO, ident, jt.SolidBrush(jt.Color.rgba(0, 0.7, 0.2, 1)), None,
               path)
    scene.stroke(jt.Stroke(width=3).with_caps(jt.Cap.ROUND), ident,
                 jt.SolidBrush(jt.Color.rgba(0.8, 0.1, 0.1, 1)), None,
                 jt.BezPath().move_to(10, H - 40).line_to(W - 10, H - 30))
    if full_profile:
        clipr = (jt.BezPath().move_to(30.5, 8.3).line_to(90.5, 8.3)
                 .line_to(90.5, H - 8.7).line_to(30.5, H - 8.7).close())
        scene.push_layer(jt.BlendMode(jt.Mix.CLIP, jt.Compose.SRC_OVER), 1.0, ident, clipr)
        scene.fill(jt.Fill.NON_ZERO, ident, jt.SolidBrush(jt.Color.rgba(0.1, 0.2, 0.9, 0.6)),
                   None, (jt.BezPath().move_to(20, 20).line_to(110, 40)
                          .line_to(60, H - 20).close()))
        scene.pop_layer()
        stops = (jt.ColorStop(0.0, jt.Color.rgba(1, 0, 0, 1)),
                 jt.ColorStop(1.0, jt.Color.rgba(0, 0, 1, 1)))
        scene.fill(jt.Fill.NON_ZERO, ident,
                   jt.GradientBrush(jt.LinearGradient((120, 10), (200, 200), stops)), None,
                   (jt.BezPath().move_to(120, 10).line_to(220, 10).line_to(220, 210)
                    .line_to(120, 210).close()))
        pix = (np.arange(8 * 8 * 4, dtype=np.uint32).reshape(8, 8, 4) % 256).astype(np.uint8)
        pix[..., 3] = 255
        scene.fill(jt.Fill.NON_ZERO, jt.Affine.translate(160, 60) @ jt.Affine.scale(6.0),
                   jt.ImageBrush(jt.Image(pixels=pix)), None,
                   (jt.BezPath().move_to(0, 0).line_to(8, 0).line_to(8, 8).line_to(0, 8)
                    .close()))
    return scene, jt.RenderParams(width=W, height=H, base_color=jt.Color.rgba(1, 1, 1, 1))


def dryrun(n, device="cuda", backend="nccl", full_profile=False, image_tap=False, aa="area"):
    """Render `dryrun_scene` on n ranks (`sharded2.py::dryrun`; `image_tap`
    routes its image through kernel F, `aa` "area", "msaa8" or "msaa16")
    and hold the frame to the single-device renderer's on `device`
    (within 1e-3). Returns the max abs difference; raises on a larger one
    or on a raised flag."""
    import dataclasses

    import jello_tpu_torch as jt

    from .collectives import run_ranks
    from .render import Renderer, assemble
    from .sharded import frame_inputs, rank_frames, sharded_caps

    scene, params = dryrun_scene(jt, full_profile)
    params = dataclasses.replace(params, antialiasing_method=jt.AaConfig(aa))
    r = Renderer(device=device)
    r.use_image_tap = image_tap
    ref = r.render(scene, params)
    inputs = frame_inputs(scene, params)
    job = (make_sharded_render, inputs, sharded_caps(r._caps, inputs, aa, image_tap), {})
    fine_out, flags, _ = run_ranks(rank_frames, n, backend, device, ([job],))[0][0]
    raised = [k for k, v in flags.items() if v]
    err = float(np.abs(assemble(fine_out, inputs[1]).numpy() - ref).max())
    if raised or not err < 1e-3:
        raise RuntimeError(f"geometry-sharded render: flags {raised}, max abs error {err}")
    return err
