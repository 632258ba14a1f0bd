"""The plain version of the per-tile interpreter (kernels G and H,
`jello_tpu_torch/pipeline/fine_interp.py`) vs jello_tpu's Pallas kernels
`make_fine_kernel` and `make_fine_kernel_b8` in interpret mode, on
hand-built slabs of 16 programs and 16 records a tape that hold every
record kind, clip depth up to BD and one past it, a clip-zero group, and
an image record that trips the region bit. Premultiplied result within
1e-5, overflow words equal. Also `build_cmd_slab` and the full-grid
`fine_interp` against the numpy oracle's frame, in area mode and, through
the resolved-coverage branch, under msaa8 and msaa16."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jello_tpu
from jello_tpu.cpu import render_numpy
from jello_tpu.tpu import fine_pallas

from jello_tpu_torch.cuda import upload, upload_atlas
from jello_tpu_torch.cuda.fine_interp import fine_interp, interpret_tiles
from jello_tpu_torch.cuda.fine_v2 import assemble_compact
from jello_tpu_torch.pipeline.render import geometry

from .torch_reference import (
    CLIP_SCENES,
    check_msaa_frame,
    deep_slab,
    full_scene,
    hand_built_slab,
    interpret_args,
    prepare_with_atlas,
)

TOL = 1e-5


def _premul(out):
    out = np.asarray(out)
    return np.concatenate([out[:, :3] * out[:, 3:4], out[:, 3:4]], axis=1)


def _pallas(h, batch):
    n, MC, _ = h["slab"].shape
    NR, W = h["stops"].shape
    caps = {"tile_grid_cap": h["grid"], "cmds_per_tile": MC, "blend_depth": h["BD"],
            "max_stops": (W - 1) // 5}
    make = fine_pallas.make_fine_kernel_b8 if batch else fine_pallas.make_fine_kernel
    call = make(caps, tuple(h["atlas"].shape[1:]), interpret=True, n_ramp_rows=NR,
                n_programs=n)
    stops_pad = np.zeros((NR, 128), np.float32)
    stops_pad[:, :W] = h["stops"]
    counts = np.concatenate([h["counts"], [h["wit"]]]).astype(np.int32)
    out, ovf = call(jnp.asarray(counts), jnp.asarray(h["tile_ids"]), jnp.asarray(h["base"]),
                    jnp.asarray(h["slab"]), jnp.asarray(h["rows"]), jnp.asarray(stops_pad),
                    jnp.asarray(h["atlas"]))
    return np.asarray(out), np.asarray(ovf)[:, 0, 0]


@pytest.mark.parametrize("batch", [False, True], ids=["G", "H"])
def test_torch_interpreter_plain_matches_pallas_interpret(batch):
    h = hand_built_slab(seed=5)
    want, want_ovf = _pallas(h, batch)
    got, got_ovf = interpret_tiles(*interpret_args(h), batch=batch)
    assert got.shape == (16, 4, 256) and got.dtype == torch.float32
    assert np.isfinite(got.numpy()).all()
    assert np.array_equal(got_ovf.numpy(), want_ovf)
    # The slab trips both bits, each on its own program.
    assert got_ovf[4] == 2 and got_ovf[8] == 1 and int((got_ovf != 0).sum()) == 2
    err = np.abs(_premul(got.numpy()) - _premul(want)).max()
    print(f"plain vs Pallas interpret ({'H' if batch else 'G'}): {err:.3e}")
    assert err <= TOL


@pytest.mark.parametrize("depth", [2, 8])
def test_torch_interpreter_plain_matches_pallas_interpret_on_deep_tapes(depth):
    """The deep tapes (a push at every depth up to BD and one past it, one
    record, MC records, suppression past a staging chunk) and the ten
    hand-built programs through the plain version and jello_tpu's one-tile
    kernel in interpret mode. The seeded random programs between them are
    left out of the row comparison: at MC 40 one of them (program 14 at BD
    8) paints a repeating linear gradient whose t is 1.0 at a pixel, where
    XLA's contraction in interpret mode and the port's separate roundings
    land on either side of the seam (0.46 apart); overflow words are
    compared for every program."""
    h, k = deep_slab(depth)
    want, want_ovf = _pallas(h, False)
    got, got_ovf = interpret_tiles(*interpret_args(h))
    assert np.array_equal(got_ovf.numpy(), want_ovf)
    assert int(got_ovf[k["past_bd"]]) == 1 and int(got_ovf[k["to_bd"]]) == 0
    held = list(range(10)) + list(k.values())
    err = np.abs(_premul(got.numpy())[held] - _premul(want)[held]).max()
    print(f"plain vs Pallas interpret, deep tapes at BD {depth}: {err:.3e}")
    assert err <= TOL


@pytest.mark.parametrize("depth", [2, 8, 60])
def test_torch_interpreter_deep_tapes_on_the_plain_version(depth):
    """What the deep tapes are built to show: overflow bit 0 on the push
    past BD and on no other program's nesting, a one-record and an
    MC-record tape, a clip-zero group past the staging chunk that paints
    nothing (the tape without it gives the same row), pads at the base
    color."""
    h, k = deep_slab(depth)
    MC = h["slab"].shape[1]
    assert h["counts"][k["one_record"]] == 1 and h["counts"][k["mc_records"]] == MC
    assert h["counts"][k["to_bd"]] == 3 * depth + 1
    out, ovf = interpret_tiles(*interpret_args(h))
    assert torch.isfinite(out).all()
    assert int(ovf[k["past_bd"]]) == 1 and int(ovf[k["to_bd"]]) == 0
    assert int((ovf & 1).sum()) == 1 + (depth == 2)  # at BD 2 the original program 8 too
    assert np.allclose(out[-1].numpy(), h["base"][:, None])
    j = k["suppressed_past_chunk"]
    h2 = dict(h, slab=h["slab"].copy(), counts=h["counts"].copy())
    h2["slab"][j, 1] = h["slab"][j, h["counts"][j] - 1]
    h2["counts"][j] = 2
    out2, _ = interpret_tiles(*interpret_args(h2))
    assert torch.equal(out[j], out2[j])


def test_torch_interpreter_semantics_on_the_hand_built_slab():
    """What the tapes are built to show, held on the plain version alone:
    a suppressed group paints nothing, a tripped image record paints
    nothing, a pad slot stays at the base color."""
    h = hand_built_slab(seed=5)
    args = interpret_args(h)
    out, _ = interpret_tiles(*args)
    base = h["base"]
    assert np.allclose(out[15].numpy(), base[:, None])
    # Program 9 without its clip-zero group (records 1..6) is the same.
    h2 = dict(h, slab=h["slab"].copy(), counts=h["counts"].copy())
    h2["slab"][9, 1] = h["slab"][9, 7]
    h2["counts"][9] = 2
    out2, _ = interpret_tiles(*interpret_args(h2))
    assert torch.equal(out[9], out2[9])
    # Program 4 without its tripped image record.
    h3 = dict(h, slab=h["slab"].copy(), counts=h["counts"].copy())
    h3["slab"][4, 1] = h["slab"][4, 2]
    h3["counts"][4] = 2
    out3, ovf3 = interpret_tiles(*interpret_args(h3))
    assert torch.equal(out[4], out3[4]) and int(ovf3[4]) == 0


def test_torch_interpret_tiles_rejects_bad_inputs():
    args = list(interpret_args(hand_built_slab()))
    with pytest.raises(ValueError):
        interpret_tiles(*args[:3], args[3].to(torch.int64), *args[4:])
    with pytest.raises(ValueError):
        interpret_tiles(args[0][:-1], *args[1:])
    with pytest.raises(ValueError):
        interpret_tiles(*args[:7], 0)


@pytest.mark.parametrize("name", ["mix_stack", "full_scene"])
def test_torch_fine_interp_full_grid_matches_oracle(name):
    """The interpreter alone as the whole fine stage (every tile's tape,
    images through it too) against the numpy oracle's frame: 8e-3, the
    tolerance of tests/test_fine_hybrid.py; expected <= 1e-4."""
    build = CLIP_SCENES.get(name, full_scene)
    scene_j, params_j = build(jello_tpu)
    with np.errstate(all="ignore"):
        ref, _, _ = render_numpy(scene_j, params_j)
    s, ld, ramps, atlas, caps = prepare_with_atlas(scene_j, params_j)
    caps = dict(caps, _expand_pallas=True, cmds_per_tile=16)
    scene_t, layout_t, ramps_t, _ = upload(s, ld, ramps, caps, "cpu")
    atlas_t = upload_atlas(atlas, "cpu")
    stages, flags, _ = geometry(scene_t, layout_t, caps)
    assert not any(bool(v) for v in flags.values())
    for batch in (False, True):
        out, fl = fine_interp(stages["cmds"], stages["counted"], ramps_t, atlas_t, layout_t,
                              dict(caps, _interp_batch=batch))
        assert not any(bool(v) for v in fl.values()), fl
        GRID = caps["tile_grid_cap"]
        t2r = torch.arange(GRID, dtype=torch.int32)
        img = assemble_compact(out.permute(1, 0, 2).contiguous(), t2r, ld).numpy()
        err = np.abs(img - ref).max()
        print(f"{name}: full-grid interpreter vs the oracle {err:.3e}")
        assert err <= 8e-3


def test_torch_interpreter_resolved_switch_on_the_hand_built_slab():
    """`resolved` on the hand-built slab, whose rows range over [-2.5,
    2.5]: every row is clipped to [0, 1], whatever the record's rule and
    kind, as jello_tpu's kernels do with `aa_mode` in their caps (G and H
    in interpret mode, 1e-5); the frame differs from the one by the rules,
    and the overflow words do not."""
    h = hand_built_slab(seed=5)
    got, ovf = interpret_tiles(*interpret_args(h), False, True)
    by_rule, ovf_rule = interpret_tiles(*interpret_args(h))
    assert torch.equal(ovf, ovf_rule) and np.isfinite(got.numpy()).all()
    assert (got - by_rule).abs().max() > 0.1
    # The same tapes over the rows clipped beforehand, read by the rules: a
    # row in [0, 1] is its own coverage under either rule.
    h01 = dict(h, rows=np.clip(h["rows"], 0.0, 1.0))
    clipped, _ = interpret_tiles(*interpret_args(h01))
    assert (got - clipped).abs().max() <= 1e-6
    for batch in (False, True):
        n, MC, _ = h["slab"].shape
        NR, W = h["stops"].shape
        caps = {"tile_grid_cap": h["grid"], "cmds_per_tile": MC, "blend_depth": h["BD"],
                "max_stops": (W - 1) // 5, "aa_mode": "msaa8"}
        make = fine_pallas.make_fine_kernel_b8 if batch else fine_pallas.make_fine_kernel
        call = make(caps, tuple(h["atlas"].shape[1:]), interpret=True, n_ramp_rows=NR,
                    n_programs=n)
        stops_pad = np.zeros((NR, 128), np.float32)
        stops_pad[:, :W] = h["stops"]
        counts = np.concatenate([h["counts"], [h["wit"]]]).astype(np.int32)
        want, _ = call(jnp.asarray(counts), jnp.asarray(h["tile_ids"]), jnp.asarray(h["base"]),
                       jnp.asarray(h["slab"]), jnp.asarray(h["rows"]), jnp.asarray(stops_pad),
                       jnp.asarray(h["atlas"]))
        err = np.abs(_premul(got.numpy()) - _premul(want)).max()
        print(f"resolved branch, plain vs Pallas interpret ({'H' if batch else 'G'}): {err:.3e}")
        assert err <= TOL


@pytest.mark.parametrize("aa", ["msaa8", "msaa16"])
def test_torch_fine_interp_full_grid_msaa_matches_oracle(aa):
    """The interpreter alone as the whole fine stage of an MSAA frame (G's
    and H's plain version, the resolved branch) against the numpy oracle."""
    scene_j, params_j = full_scene(jello_tpu)
    params_j.antialiasing_method = jello_tpu.AaConfig(aa)

    def render(scene, params, batch=False):
        s, ld, ramps, atlas, caps = prepare_with_atlas(scene, params)
        caps = dict(caps, _expand_pallas=True, cmds_per_tile=16, aa_mode=aa,
                    _interp_batch=batch)
        scene_t, layout_t, ramps_t, _ = upload(s, ld, ramps, caps, "cpu")
        stages, flags, _ = geometry(scene_t, layout_t, caps)
        out, fl = fine_interp(stages["cmds"], stages["counted"], ramps_t,
                              upload_atlas(atlas, "cpu"), layout_t, caps)
        assert not any(bool(v) for v in {**flags, **fl}.values())
        t2r = torch.arange(caps["tile_grid_cap"], dtype=torch.int32)
        return assemble_compact(out.permute(1, 0, 2).contiguous(), t2r, ld).numpy()

    img, _ = check_msaa_frame(render, ((scene_j, params_j), (scene_j, params_j)))
    assert np.abs(render(scene_j, params_j, batch=True) - img).max() <= 1e-6


def test_torch_build_cmd_slab_places_records_and_flags_long_tapes():
    """Slot = tile * MC + index within the tile's run; a tape longer than
    MC is cut to MC records and raises the overflow flag."""
    from jello_tpu_torch.pipeline.fine_interp import build_cmd_slab

    tile = torch.tensor([0, 0, 0, 2, 2, 5, 9, 9], dtype=torch.int32)  # 9: past the grid
    rec = torch.arange(8 * 16, dtype=torch.int32).reshape(8, 16)
    cmds = {"tile": tile,
            "tile_start": torch.tensor([0, 0, 3, 0, 0, 5], dtype=torch.int32),
            "tile_end": torch.tensor([3, 0, 5, 0, 0, 6], dtype=torch.int32)}
    slab, counts, ovf = build_cmd_slab(rec, cmds, {"tile_grid_cap": 6, "cmds_per_tile": 2})
    assert slab.shape == (6, 2, 16) and bool(ovf)
    assert counts.tolist() == [2, 0, 2, 0, 0, 1]
    assert torch.equal(slab[0], rec[0:2]) and torch.equal(slab[2], rec[3:5])
    assert torch.equal(slab[5, 0], rec[5]) and not slab[1].any() and not slab[5, 1].any()
    _, counts4, ovf4 = build_cmd_slab(rec, cmds, {"tile_grid_cap": 6, "cmds_per_tile": 4})
    assert counts4.tolist() == [3, 0, 2, 0, 0, 1] and not bool(ovf4)
