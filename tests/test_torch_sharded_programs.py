"""The sharded frames as programs, at world size 1 in this process, over
gloo on the CPU.

A class's first clean frame settles it, its next frame builds the class's
program (`cuda/program.py`; over gloo, which copies through the host, the
program runs its frame function into its static outputs, as on the CPU
every program does; over NCCL on the card it is a CUDA graph), and later
frames replay it: one program a settled class, none on later frames,
every frame equal to the eager frame at the class bit for bit and to the
single-device frame. A geometry-sharded class that grows gets a program
of its own. World size 4 runs in `tests/test_torch_sharded.py`'s spawn."""

import numpy as np
import pytest
import torch

import jello_tpu_torch
from jello_tpu_torch.cuda import collectives, sharded, sharded2
from jello_tpu_torch.cuda.render import Renderer, assemble

from .test_torch_frames import blobs

SINGLE_TOL = 1e-6  # tests/test_torch_sharded.py's world size 1


def _setup(scene, params):
    """(the single-device CPU frame, the frame's inputs on the CPU as a rank
    takes them, its class on the renderer's routing, its layout dict)."""
    r = Renderer(device="cpu")
    single = r.render(scene, params)
    inputs = sharded.frame_inputs(scene, params)
    args = sharded.rank_inputs(inputs, "cpu")
    return single, args, sharded.sharded_caps(r._caps, inputs), inputs[1]


@pytest.mark.parametrize("path", ["stripes_kernel", "stripes_fine_ref", "geometry"])
def test_torch_sharded_frames_are_programs_once_settled(tmp_path, path):
    """Four frames of one class: the first eager, the second builds the
    program, the last two replay it; each equals the eager frame at the
    class bit for bit and the single-device frame within 1e-6."""
    scene, params = sharded2.dryrun_scene(jello_tpu_torch, full_profile=path == "geometry")
    single, args, caps, ld = _setup(scene, params)
    with collectives.init_group(0, 1, "gloo", tmp_path / "store", "cpu") as g:
        holder = (sharded2.RetryingRender(g) if path == "geometry"
                  else sharded.StripeFrames(g, path == "stripes_kernel"))
        assert not holder.capture
        frames, programs = [], []
        for _ in range(4):
            fine_out, flags = holder(caps, *args)[:2]
            assert not any(flags.values()), flags
            frames.append(fine_out.clone())
            programs.append((len(holder.compile_log), holder.last_program is not None))
        eager = holder.frame_fn(caps, *args)(*args)[0]
    assert programs == [(0, False), (1, True), (1, True), (1, True)]
    assert holder.last_program.graph is None
    for f in frames:
        assert torch.equal(f, eager)
    err = np.abs(assemble(frames[-1], ld).numpy() - single).max()
    print(f"{path}: programs {holder.compile_log}; max abs difference from the single device "
          f"{err:.3e}")
    assert err <= SINGLE_TOL


def test_torch_grown_geometry_class_builds_a_program_of_its_own(tmp_path):
    """The geometry-sharded frame of a scene grown after its class got a
    program (the same stream shape): the program's frame raises flags, the
    frame renders again at the grown class, eagerly, and the grown class's
    next frame builds a second program, which a later frame of the shape
    replays (the shape keeps its grown class)."""
    small, params = blobs(jello_tpu_torch, 1.0)
    grown, _ = blobs(jello_tpu_torch, 25.0)
    _, args, caps, _ = _setup(small, params)
    single_g, args_g, _, ld_g = _setup(grown, params)
    with collectives.init_group(0, 1, "gloo", tmp_path / "store", "cpu") as g:
        holder = sharded2.RetryingRender(g)
        for _ in range(2):
            holder(caps, *args)
        assert len(holder.compile_log) == 1
        holder(caps, *args_g)
        retried = list(holder.last_retries)
        assert retried and holder.last_program is None and len(holder.compile_log) == 1
        fine_out, flags = holder(caps, *args_g)[:2]
        assert holder.last_program is not None and len(holder.compile_log) == 2
        assert not any(flags.values())
        err = np.abs(assemble(fine_out, ld_g).numpy() - single_g).max()
        holder(caps, *args)
        assert len(holder.compile_log) == 2
    print(f"grown: retries {retried}; programs {holder.compile_log}; max abs difference from "
          f"the single device {err:.3e}")
    assert err <= SINGLE_TOL


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")


@pytest.mark.cuda
def test_torch_sharded_programs_over_nccl_on_the_card(cuda, tmp_path):
    """Over NCCL on the card each path's program is a CUDA graph with its
    collectives inside: the replay equals the eager frame at the class bit
    for bit, and the frame the single-device CPU frame within 1e-3."""
    with collectives.init_group(0, 1, "nccl", tmp_path / "store", "cuda") as g:
        for path in ("stripes_kernel", "stripes_fine_ref", "geometry"):
            scene, params = sharded2.dryrun_scene(jello_tpu_torch,
                                                  full_profile=path == "geometry")
            single, args, caps, ld = _setup(scene, params)
            args = tuple(None if a is None else a.cuda() for a in args)
            holder = (sharded2.RetryingRender(g) if path == "geometry"
                      else sharded.StripeFrames(g, path == "stripes_kernel"))
            assert holder.capture
            for _ in range(3):
                fine_out, flags = holder(caps, *args)[:2]
            prog = holder.last_program
            assert prog is not None and prog.graph is not None and len(holder.compile_log) == 1
            assert not any(flags.values())
            assert torch.equal(prog.run(args)[0], holder.frame_fn(caps, *args)(*args)[0])
            err = np.abs(assemble(fine_out, ld).cpu().numpy() - single).max()
            assert err <= 1e-3, (path, err)
