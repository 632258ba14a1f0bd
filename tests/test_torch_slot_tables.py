"""Kernel L (flatten's per-slot tables, `csrc/slot_tables.cu`) and its
wrapper `cuda/slot_tables.py::slot_tables`.

On the CPU: the wrapper's checks, and its CPU route, which hands its
arguments to the plain torch chain (`pipeline/flatten.py::slot_tables_plain`)
and returns its tables unchanged, on the whole tag stream and on a
tag-range shard (`test_torch_stroke.py` holds flatten to jello_tpu's
numpy oracle). On the card (marker `cuda`,
skipped where torch sees no GPU): kernel L against that plain version bit
for bit (NaN equal to NaN) on every table, on the stroke scenes of
`test_torch_stroke.py` (butt, round and square caps; bevel, miter, round
and fallen-back miter joins; dashes; a scaled transform), on config 5, on
the first 4,096 sprites of the benchmark's `bunnymark` and on a
`sharded2` tag-range shard past slot 0; inside a captured graph; and once
a geometry pass.
"""

import json

import pytest
import torch

import jello_tpu as jtn
import jello_tpu_torch as jt
from jello_tpu_torch.cuda import sharded2
from jello_tpu_torch.cuda import slot_tables as kst
from jello_tpu_torch.cuda.render import upload
from jello_tpu_torch.pipeline import flatten
from jello_tpu_torch.pipeline.pathtag import monoid_delta_totals, tag_monoid_scan
from jello_tpu_torch.pipeline.render import geometry

from .test_torch_line_dda import _settled, cuda  # noqa: F401  (fixture)
from .test_torch_stroke import SCENES
from .torch_reference import prepare

SHARDS = 4


def _args(scene_t, layout_t, caps, shard=None):
    """slot_tables' arguments for a prepared scene as flatten_stage builds
    them: the whole tag stream, or with `shard` d the d-th of SHARDS tag
    ranges of `sharded2.shard_caps` (its monoid's base the deltas of the
    tags before it)."""
    N = caps["n_tag_slots"]
    Ne, tag_lo, base = N, 0, None
    if shard is not None:
        N = sharded2.shard_caps(caps, SHARDS)["n_tag_slots"]
        Ne, tag_lo = N + 4, shard * N
        before = flatten.decode_tag_stream(scene_t, layout_t["path_tag_base"], tag_lo)
        base = monoid_delta_totals(before)
    tags = flatten.decode_tag_stream(scene_t, layout_t["path_tag_base"] + tag_lo // 4, Ne)
    return scene_t, layout_t, tags, tag_monoid_scan(tags, base), N, tag_lo, caps["n_paths_cap"]


def _cpu_args(name, shard=None):
    scene, params = SCENES[name](jtn)
    s, ld, ramps, caps = prepare(scene, params)
    scene_t, layout_t, _, caps_t = upload(s, ld, ramps, caps, "cpu")
    return _args(scene_t, layout_t, caps_t, shard)


def _bit_equal(a, b):
    """Equal bit for bit, a NaN equal to any NaN."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype != torch.float32:
        return torch.equal(a, b)
    return bool(((a.view(torch.int32) == b.view(torch.int32))
                 | (torch.isnan(a) & torch.isnan(b))).all())


def _bad(case):
    """The butt-caps scene's arguments with one made wrong."""
    scene, layout, tags, mono, N, tag_lo, npc = _cpu_args("butt_caps")
    layout, mono = dict(layout), dict(mono)
    Ne = mono["path_idx"].shape[0]
    wrong = {
        "tags_int64": lambda: (scene, tags.long(), N, tag_lo),
        "tags_short": lambda: (scene, tags[:Ne - 1], N, tag_lo),
        "tags_strided": lambda: (scene, torch.stack([tags] * 2, 1)[:, 0], N, tag_lo),
        "scene_float32": lambda: (scene.float(), tags, N, tag_lo),
        "scene_matrix": lambda: (scene.reshape(1, -1), tags, N, tag_lo),
        "scene_strided": lambda: (torch.stack([scene] * 2, 1)[:, 0], tags, N, tag_lo),
        "scene_empty": lambda: (scene[:0], tags, N, tag_lo),
        "scene_meta": lambda: (torch.empty(scene.shape, dtype=torch.int32, device="meta"),
                               tags, N, tag_lo),
        "layout_int64": lambda: layout.update(style_base=layout["style_base"].long()),
        "layout_vector": lambda: layout.update(n_path_tags=layout["n_path_tags"].reshape(1)),
        "layout_host_int": lambda: layout.update(path_data_base=int(layout["path_data_base"])),
        "mono_int64": lambda: mono.update(style_idx=mono["style_idx"].long()),
        "mono_short": lambda: mono.update(trans_idx=mono["trans_idx"][:Ne - 1]),
        "mono_stride": lambda: mono.update(
            path_seg_offset=torch.stack([mono["path_seg_offset"]] * 2, 1)[:, 0]),
        "mono_meta": lambda: mono.update(
            path_idx=torch.empty(Ne, dtype=torch.int32, device="meta")),
        "too_few_slots": lambda: (scene, tags, Ne + 1, tag_lo),
        "no_slots": lambda: (scene, tags, 0, tag_lo),
        "tag_lo_unaligned": lambda: (scene, tags, N, 2),
    }
    got = wrong[case]()
    if got is not None:
        scene, tags, N, tag_lo = got
    return scene, layout, tags, mono, N, tag_lo, npc


BAD_CASES = ["scene_float32", "scene_matrix", "scene_strided", "scene_empty", "scene_meta",
             "layout_int64", "layout_vector", "layout_host_int", "mono_int64", "mono_short",
             "mono_stride", "mono_meta", "too_few_slots", "no_slots", "tag_lo_unaligned",
             "tags_int64", "tags_short", "tags_strided"]


@pytest.mark.parametrize("case", BAD_CASES)
def test_torch_slot_tables_reject_bad_inputs(case):
    with pytest.raises(ValueError):
        kst.slot_tables(*_bad(case))


# (scene, shard): the whole tag stream of stroke scenes, and tag-range
# shards past slot 0 (Ne = N + 4, the last slot's successor decoded past
# the range).
CPU_CASES = [("round_joins_zigzag", None), ("dashed", None), ("scaled_transform", None),
             ("dashed", 1), ("dashed", SHARDS - 1)]


@pytest.mark.parametrize("name,shard", CPU_CASES)
def test_torch_slot_tables_cpu_route_is_the_plain_version(name, shard, monkeypatch):
    """The wrapper's CPU route is one call of slot_tables_plain on its own
    arguments, whose tables it returns as they are, with the dtypes and
    shapes kernel L writes; no launch."""
    args = _cpu_args(name, shard)
    N = args[4]
    calls = []
    plain = flatten.slot_tables_plain

    def spy(*a):
        calls.append((a, plain(*a)))
        return calls[-1][1]

    monkeypatch.setattr(flatten, "slot_tables_plain", spy)
    n0 = kst.slot_tables.launches
    got = kst.slot_tables(*args)
    assert kst.slot_tables.launches == n0
    assert len(calls) == 1 and got is calls[0][1]
    assert len(calls[0][0]) == len(args) and all(a is b for a, b in zip(calls[0][0], args))
    shapes = {"tab2": ((2 * N, kst.EULER_COLS), torch.float32),
              "counts2": ((2 * N,), torch.int32), "sa": ((4 * N, kst.SA_COLS), torch.float32),
              "orow": ((N, 3), torch.int32), "tot4": ((N,), torch.int32),
              "tgt": ((N,), torch.int32), "pmeta": ((N, 2), torch.int32),
              "arc_n": ((N,), torch.float32)}
    assert set(got) == set(shapes)
    for k, (shape, dtype) in shapes.items():
        assert tuple(got[k].shape) == shape and got[k].dtype == dtype, k
    if shard is None:
        # The scene's strokes reach the B pass and the simple or arc tables.
        assert int(got["counts2"][N:].sum()) > 0
        assert int(got["tot4"].sum()) > 0


# ---- on the card --------------------------------------------------------


def _scene_args(scene, params, monkeypatch):
    """The arguments kernel L is given in one geometry pass of a scene at the
    class a renderer on the card settles, and that class."""
    scene_t, layout_t, caps = _settled(scene, params)
    calls = []
    fn = kst.slot_tables

    def spy(*args):
        calls.append(args)
        return fn(*args)

    # The wrapper counts its launches on the module's name: the spy's.
    spy.launches = 0
    monkeypatch.setattr(kst, "slot_tables", spy)
    geometry(scene_t, layout_t, caps)
    monkeypatch.undo()
    assert len(calls) == 1
    return calls[0], caps


def _config5(monkeypatch):
    from jello_tpu_torch.scenes import GATE_SCENES

    return _scene_args(*GATE_SCENES[5](), monkeypatch)


def _bunnymark(monkeypatch):
    from .test_torch_motionmark import BENCH, _load, commands

    gen = _load(BENCH / "configs" / "bunnymark.py", "bunnymark_generator")
    cfg = json.loads((BENCH / "configs" / "bunnymark.json").read_text())
    cmds = gen.commands(cfg, 2**31 + 7)
    cmds = dict(cmds, draws=cmds["draws"][:4096])
    return _scene_args(commands.build(jt, cmds), commands.params(jt, cmds), monkeypatch)


def _held(args):
    """Kernel L against its plain version on the card, every table bit for
    bit; one launch."""
    n0 = kst.slot_tables.launches
    got = kst.slot_tables(*args)
    assert kst.slot_tables.launches == n0 + 1
    want = flatten.slot_tables_plain(*args)
    assert set(got) == set(want)
    for k in want:
        assert got[k].is_contiguous() and _bit_equal(got[k], want[k]), k
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(SCENES) + ["config5", "bunnymark", "sharded"])
def test_torch_slot_tables_kernel_matches_plain(cuda, monkeypatch, case):
    if case in SCENES:
        got = _held(_scene_args(*SCENES[case](jt), monkeypatch)[0])
        N = got["tot4"].shape[0]
        assert int(got["counts2"][N:].sum()) > 0  # a stroke's B pass
    elif case == "sharded":
        (scene_t, layout_t, *_), caps = _config5(monkeypatch)
        for d in range(1, SHARDS):
            args = _args(scene_t, layout_t, caps, d)
            assert args[5] > 0 and args[3]["path_idx"].shape[0] == args[4] + 4
            assert int(_held(args)["counts2"].sum()) > 0
    else:
        got = _held((_config5 if case == "config5" else _bunnymark)(monkeypatch)[0])
        assert int(got["counts2"].sum()) > 0


@pytest.mark.cuda
def test_torch_slot_tables_kernel_replays_in_a_captured_graph(cuda, monkeypatch):
    """Kernel L captured into a CUDA graph and replayed after the layout's
    tag count (read on the device) changed equals the eager call on the
    changed inputs; a replay counts no launch."""
    args, _ = _scene_args(*SCENES["round_joins_zigzag"](jt), monkeypatch)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kst.slot_tables(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = kst.slot_tables(*args)
    before = {k: v.clone() for k, v in kst.slot_tables(*args).items()}
    n_tags = args[1]["n_path_tags"]
    n_tags.copy_(n_tags // 2)
    n0 = kst.slot_tables.launches
    graph.replay()
    torch.cuda.synchronize()
    assert kst.slot_tables.launches == n0
    want = kst.slot_tables(*args)
    for k in want:
        assert _bit_equal(out[k], want[k]), k
    assert not torch.equal(out["counts2"], before["counts2"])


@pytest.mark.cuda
def test_torch_flatten_launches_kernel_l_once(cuda):
    """A geometry pass on the card builds flatten's per-slot tables as one
    launch of kernel L."""
    from jello_tpu_torch.scenes import GATE_SCENES

    scene_t, layout_t, caps = _settled(*GATE_SCENES[3]())
    n0 = kst.slot_tables.launches
    geometry(scene_t, layout_t, caps)
    assert kst.slot_tables.launches == n0 + 1
