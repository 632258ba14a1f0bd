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
class, with the same numbers as jello_tpu's. Content is not spread evenly
over tag ranges (config 4 puts every tag in rank 0's range), so a rank can
run out of what beta / n gives it: `make_sharded_render` takes a per-rank
table of grown capacities on top of `shard_caps` (`rank_caps`), each frame
reports every rank's raised flags and its load (what it needed of each
capacity), and `RetryingRender` renders a frame again on a raised flag,
growing only the ranks that raised and only what their load shows ran
out (`grow_ranks`): the single-card renderer's retry protocol
(`cuda/render.py`, `renderer/estimate.py::grow_caps`), which jello_tpu's
sharded frame lacks.
"""

from __future__ import annotations

import numpy as np
import torch

from ..pipeline import coarse, ops
from ..pipeline.flatten import decode_tag_stream, finalize_path_bbox, flatten_stage
from ..pipeline.ops import F32, I32
from ..pipeline.pathtag import monoid_delta_totals
from ..pipeline.render import draw_stages
from ..pipeline.tiling import SEG_KEYS, path_count_expansions
from . import line_dda
from .collectives import all_gather, all_to_all, pmax, psum
from .fine_hybrid import fine_hybrid
from .program import FrameProgram, Programs, caps_key, key_summary, program_key
from .render import fetch_frame
from .sharded import packed_frame


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


# The capacities a rank may grow on its own (`rank_caps`). n_tag_slots and
# seg_ex_cap are not among them: tag_lo = rank * n_tag_slots, and every rank
# sends and receives [n, seg_ex_cap, 8] rows in the exchange.
RANK_KEYS = ("work_a_cap", "work_b_cap", "euler_line_cap", "simple_line_cap", "arc_line_cap",
             "line_cap", "seg_cap", "row_cap", "area_rows_cap", "cross_lines_cap",
             "row_lines_cap", "cmd_cap", "legacy_tiles_cap", "img_recs_cap")
LINE_KEYS = ("euler_line_cap", "simple_line_cap", "arc_line_cap")
# The columns of a frame's `load`: what each rank needed of a rank-local
# capacity in that frame (the last, of the exchange's slice to one rank).
# A count taken after a stage that overflowed is a lower bound.
LOAD_KEYS = ("work_a_cap", "work_b_cap", "euler_line_cap", "simple_line_cap", "arc_line_cap",
             "seg_cap", "row_cap", "cross_lines_cap", "row_lines_cap", "cmd_cap", "seg_ex_cap")
# The flags each load column can explain.
LOAD_FLAGS = {"flatten_overflow": LOAD_KEYS[:5], "segs_overflow": LOAD_KEYS[5:9] + LOAD_KEYS[10:],
              "pairs_overflow": ("cmd_cap",)}
# The retries RetryingRender allows a frame by default: a stage a retry,
# since a count past an overflowed stage is a lower bound.
MAX_RETRIES = 8
# Flags of the fine stage whose capacity is one rank-local key.
GROW_ONE = {"area_rows_overflow": "area_rows_cap", "legacy_overflow": "legacy_tiles_cap",
            "img_recs_overflow": "img_recs_cap"}


def rank_caps(caps: dict, n: int, rank: int, grown=None, seg_ex_cap=None) -> dict:
    """Rank `rank`'s class: `shard_caps(caps, n)` with `grown[rank]` on top
    (grown: {rank: {key: value}}, the same table on every rank; each value
    raises that rank's capacity to at least itself, for a key of
    RANK_KEYS), line_cap at least the sum of the three line families, and
    `seg_ex_cap` (the same on every rank) in place of shard_caps's."""
    c = shard_caps(caps, n)
    for k, v in (grown or {}).get(rank, {}).items():
        if k not in RANK_KEYS:
            raise ValueError(f"{k}: not a rank-local capacity (one of {RANK_KEYS})")
        c[k] = max(c[k], int(v))
    c["line_cap"] = max(c["line_cap"], sum(c[k] for k in LINE_KEYS))
    if seg_ex_cap:
        c["seg_ex_cap"] = int(seg_ex_cap)
    return c


def make_sharded_render(group, caps_global, debug=False, seg_ex_cap=None, grown=None,
                        report=False):
    """The geometry-sharded frame of this rank (`sharded2.py:92-458`).

    caps_global: the single-device class with the frame's routing
    (`sharded.sharded_caps`); the rank's own capacities come from
    `rank_caps`: `shard_caps` with the rank's entries of `grown` on top.
    seg_ex_cap: the exchange slice's rows in place of `shard_caps`'s, the
    same on every rank (a test forces a small one to show its flag).
    What jello_tpu's jit takes as static (the classes, the rank's tag range
    and stripe) is fixed here; what it traces (scene words, the packed
    layout, stop table, atlas) is `run`'s data, the layout a dict of 0-dim
    device tensors (`unpack_layout`).
    Returns run(scene, layout, ramps, atlas=None) -> (fine_out [4, GRID,
    256] un-premultiplied, flags {name: 0-dim bool}); with `report` or
    `debug` also a dict with raised [n, K] (each rank's own flags before
    they combine, in the flags' sorted order) and load [n, len(LOAD_KEYS)]
    (what each rank needed of each capacity), both from the one all_gather
    the flags combine through, and with `debug` the exchanged state too:
    seg_count, backdrop (the prefix), recv [n, n, seg_ex_cap, 8] (every
    rank's received rows, by source), lo and cnt [n] (each stripe's slice
    of the command stream), classes [n, 2] (each rank's n_tag_slots and
    seg_ex_cap). Nothing is read to the host inside the frame."""
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
    # Only rank-local capacities differ between ranks: every collective of
    # the frame has a shape that none of them sets (the monoid totals [5],
    # the per-path psum and pmax [P], the backdrop and segment psums [T],
    # the exchange [n, seg_ex_cap, 8], the stripes [GRID / n, 4, 256], the
    # flags and loads [K + len(LOAD_KEYS)]), and tag_lo and the exchange
    # read n_tag_slots and seg_ex_cap, which are the same on every rank.
    caps_l = rank_caps(caps, n, d, grown, seg_ex_cap)
    N_l = caps_l["n_tag_slots"]
    PEX = caps_l["seg_ex_cap"]
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
        P, PRT, n_cross, n_rows = line_dda.line_tables(fl, paths)
        (tile_slot, seg_pre, bump_slot, bump_delta, c_total, r_slot, r_delta, r_total,
         compact_overflow) = path_count_expansions(P, PRT, n_cross, n_rows, caps_l)
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
        ex_need = (start_dest[1:n + 1] - start_dest[:n]).max()
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
        need = torch.stack([v.to(I32).reshape(()) for v in (
            fl["n_work_a"], fl["n_work_b"], fl["e_total"], fl["s_total"], fl["a_total"], c_total,
            r_total, (n_cross > 0).sum(), (n_rows > 0).sum(), cnt, ex_need)])
        # One all_gather in place of a pmax of the flags: every rank gets
        # every rank's flags and load, and combines the flags itself.
        table = all_gather(group, torch.cat([own, need]))
        raised = table[:, :len(keys)].amax(0)
        flags = {k: raised[i] > 0 for i, k in enumerate(keys)}
        rep = {"raised": table[:, :len(keys)], "load": table[:, len(keys):]}
        if debug:
            rep.update(seg_count=seg_count, backdrop=bd_prefix,
                       recv=all_gather(group, recv.reshape(n, PEX, 8)),
                       lo=all_gather(group, lo), cnt=all_gather(group, cnt),
                       classes=all_gather(group, torch.stack([
                           torch.full((), N_l, dtype=I32, device=dev),
                           torch.full((), PEX, dtype=I32, device=dev)])))
        elif not report:
            return fine_out, flags
        return fine_out, flags, rep

    return run


def grow_ranks(caps, n, grown, seg_ex_cap, keys, raised, load):
    """The class after a frame that raised flags, from every rank's
    `raised` [n, K] (flags in `keys`' order) and `load` [n,
    len(LOAD_KEYS)] (host values; the same on every rank, so each rank
    derives the same class with no exchange of its own).

    Only a rank that raised a flag grows, and only what its load shows ran
    out: a capacity of a raised flag's stage (LOAD_FLAGS) whose need
    exceeds it grows to the larger of twice itself and the need (a need
    counted after an overflowed stage is a lower bound, so a frame may
    take a retry a stage); the Euler lines double with the work items
    when those ran out (the walk stopped at the work capacity); a fine
    stage's flag doubles its one capacity (GROW_ONE). The exchange's slice
    is one size on every rank: it grows to the largest rank's need. A
    raised flag that no load explains (the replicated stages' tiles,
    pairs, blend depth or tape length, the lockstep walk's iterations)
    grows the single-device class `caps` as `grow_caps` does.

    Returns (caps, grown {rank: {key: value}}, seg_ex_cap, what grew:
    {rank: sorted keys}, and under "class" the flags `caps` grew for))."""
    from ..renderer.estimate import grow_caps

    grown = {r: dict(v) for r, v in grown.items()}
    pex = rank_caps(caps, n, 0, grown, seg_ex_cap)["seg_ex_cap"]
    ex_need = max(int(row[-1]) for row in load)
    what, unexplained = {}, set()
    for r in range(n):
        own = {k for k, v in zip(keys, raised[r]) if int(v)}
        if not own:
            continue
        cl = rank_caps(caps, n, r, grown, seg_ex_cap)
        need = {k: int(v) for k, v in zip(LOAD_KEYS, load[r])}
        short = {k for k in LOAD_KEYS[:-1] if need[k] > cl[k]}
        # Work items and the simple and arc lines overflow as pairs (one
        # capacity each pair shares): grow a member only if its pair ran out.
        for pair in (("work_a_cap", "work_b_cap"), ("simple_line_cap", "arc_line_cap")):
            if sum(need[k] for k in pair) <= sum(cl[k] for k in pair):
                short -= set(pair)
        short = {k for k in short if any(k in LOAD_FLAGS[f] for f in own if f in LOAD_FLAGS)}
        g = grown.setdefault(r, {})
        for k in short:
            g[k] = max(2 * cl[k], _align(need[k], 512))
        if short & {"work_a_cap", "work_b_cap"} and "euler_line_cap" not in short:
            g["euler_line_cap"] = 2 * cl["euler_line_cap"]
            short.add("euler_line_cap")
        for f, k in GROW_ONE.items():
            if f in own:
                g[k] = 2 * cl[k]
                short.add(k)
        if short & set(LINE_KEYS):
            g["line_cap"] = sum(g.get(k, cl[k]) for k in LINE_KEYS)
        explained = {f for f in own if f in LOAD_FLAGS and short & set(LOAD_FLAGS[f])}
        explained |= {f for f in own if f in GROW_ONE}
        if "segs_overflow" in own and ex_need > pex:
            explained.add("segs_overflow")
        unexplained |= own - explained
        if not g:
            del grown[r]
        if short:
            what[r] = sorted(short)
    if ex_need > pex:
        seg_ex_cap = max(2 * pex, _align(ex_need, 512))
    if unexplained:
        caps = grow_caps(caps, {f: True for f in unexplained})
        what["class"] = sorted(unexplained)
    return caps, grown, seg_ex_cap, what


class RetryingRender:
    """The geometry-sharded frame of this rank, rendered again on a raised
    flag: the single-card `Renderer`'s loop (`cuda/render.py`,
    `max_retries`, a RuntimeError naming the flags once the retries are
    spent) over `make_sharded_render`, and its frames as programs.

    A frame reads its combined flags to the host once; a frame that raised
    one reads every rank's raised flags and load (which the frame's one
    all_gather of its flags already carries) and grows the class with
    `grow_ranks`. Every rank derives the same class from the same gathered
    values, so the ranks stay in step with no exchange of their own. The
    grown class is kept for the frame's class (`program.caps_key`: padded
    scene length, stop table and atlas shapes, the single-device class it
    started from), so that a settled frame of that class renders once and
    grows nothing; not for its layout, which is the frame's data: scenes of
    one class share their grown class and its programs.

    The port of the `jax.jit` around the frame (`sharded2.py:469`): a
    class (the single-device class, `grown`, `seg_ex_cap`: `state`) runs
    eagerly until a frame of it comes back with no flag raised; its next
    frame builds the class's `FrameProgram` (`cuda/program.py`) over the
    frame, collectives inside, and later frames of the class replay it. A
    grown class gets a program of its own. Over NCCL the program is a
    captured CUDA graph; over gloo, whose collectives copy through the
    host, and on the CPU it runs the frame function into the program's
    static outputs: the group's backend decides. `compile_log`: one entry
    a program built (index, seconds to build it, its class);
    `last_program`: the last frame's program, None when it ran eagerly. A
    program's outputs are overwritten by its next frame: a caller that
    keeps one copies it."""

    def __init__(self, group, max_retries=MAX_RETRIES, debug=False):
        self.group = group
        self.max_retries = max_retries
        self.debug = debug
        # caps_key -> [caps, grown, seg_ex_cap]
        self.classes = {}
        # The last frame's retries: [(raised flags, {rank: grown keys},
        # seg_ex_cap)], one a frame that ran again.
        self.last_retries = []
        self.capture = group.backend == "nccl"
        self._programs = Programs()
        self.compile_log = self._programs.compile_log
        self._settled = set()  # the program keys of classes that rendered clean
        self.last_program = None

    def state(self, caps, scene, layout, ramps, atlas=None):
        """The class kept for this frame's class (`caps_key` of its inputs
        at `caps`): [single-device class, grown {rank: {key: value}},
        seg_ex_cap or None]."""
        key = caps_key((scene, layout, ramps, atlas), caps)
        return self.classes.setdefault(key, [dict(caps), {}, None])

    def __call__(self, caps, scene, layout, ramps, atlas=None):
        """Render one frame at `caps` (the single-device class with the
        frame's routing) or the class grown from it for this shape; every
        rank calls it with the same inputs (`sharded.rank_inputs`: the
        layout packed). Returns (fine_out, flags {name: bool}, report: the
        frame's `make_sharded_render` report dict)."""
        st = self.state(caps, scene, layout, ramps, atlas)
        n = self.group.world
        inputs = (scene, layout, ramps, atlas)
        self.last_retries = []
        for attempt in range(self.max_retries + 1):
            key = program_key(inputs, st[0], "geometry") + (
                tuple(sorted((r, tuple(sorted(g.items()))) for r, g in st[1].items())), st[2])
            self.last_program = None
            if key in self._settled:
                self.last_program = self._programs.get(key, lambda: FrameProgram(
                    inputs, self.frame_fn(caps, *inputs), capture=self.capture),
                    key_summary(key) + f", grown {st[1]}, seg_ex_cap {st[2]}")
                fine_out, packed, keys, rep = self.last_program.run(inputs)
            else:
                fine_out, packed, keys, rep = self.frame_fn(caps, *inputs)(*inputs)
            flags = fetch_frame(packed, keys, ())[0]
            raised = [k for k in keys if flags[k]]
            if not raised:
                self._settled.add(key)
                return fine_out, flags, rep
            if attempt == self.max_retries:
                break
            st[0], st[1], st[2], what = grow_ranks(
                st[0], n, st[1], st[2], keys, rep["raised"].cpu().tolist(),
                rep["load"].cpu().tolist())
            self.last_retries.append((raised, what, st[2]))
        raise RuntimeError(f"geometry-sharded render overflowed after {self.max_retries} "
                           f"retries; flags still raised: {raised}")

    def frame_fn(self, caps, scene, layout, ramps=None, atlas=None):
        """The frame at the class the shape of these inputs holds (`state`)
        as its program runs it: fn(scene, layout, ramps, atlas) ->
        (fine_out, packed flags, flag keys, report)."""
        st = self.state(caps, scene, layout, ramps, atlas)
        return packed_frame(make_sharded_render(self.group, dict(st[0]), debug=self.debug,
                                                seg_ex_cap=st[2], grown=st[1], report=True))


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


def dryrun(n, device="cuda", backend="nccl", full_profile=False, image_tap=False, aa="area",
           timeout=900.0):
    """Render `dryrun_scene` on n ranks (`sharded2.py::dryrun`; `image_tap`
    routes its image through kernel F, `aa` "area", "msaa8" or "msaa16")
    through `RetryingRender` (a raised flag grows the ranks that raised it
    and renders again, up to MAX_RETRIES times) and hold the frame to the
    single-device renderer's on `device` (within 1e-3). `timeout` bounds
    the ranks' run (`collectives.run_ranks`). Returns the max abs
    difference; raises on a larger one or on a flag still raised."""
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
    job = (make_sharded_render, inputs, sharded_caps(r._caps, inputs, aa, image_tap),
           {"max_retries": MAX_RETRIES})
    fine_out, flags, _ = run_ranks(rank_frames, n, backend, device, ([job],),
                                   timeout=timeout)[0][0]
    raised = [k for k, v in flags.items() if v]
    err = float(np.abs(assemble(fine_out, inputs[1]).numpy() - ref).max())
    if raised or not err < 1e-3:
        raise RuntimeError(f"geometry-sharded render: flags {raised}, max abs error {err}")
    return err
