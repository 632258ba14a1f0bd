"""The draw commands give the program's Scene and the reference's own
scene code the same encoded scene, and the reference renders what the
program renders on the CPU."""

import numpy as np
import pytest

import jello_tpu_torch as jt
from jello_tpu_torch.cuda import Renderer
from jello_tpu_torch.renderer.resolve import Resolver
from portbench import commands, compare, spec
from portbench.traffic import view_transform

from portbench_helpers import BENCH, TINY


def _cmds(name, seed):
    cfg, gen = spec.config(name, BENCH)
    cfg.update(TINY[name])
    return gen.commands(cfg, seed)


@pytest.mark.parametrize("name", sorted(TINY))
def test_portbench_commands_encode_alike(name):
    cmds = _cmds(name, 2 ** 31 + 7)
    ref = compare.reference(BENCH)
    ours = commands.build(jt, cmds)
    theirs = commands.build(ref, cmds)
    a = Resolver().resolve(ours.encoding)
    b = ref.renderer.resolve.Resolver().resolve(theirs.encoding)
    np.testing.assert_array_equal(np.asarray(a[3]), np.asarray(b[3]))
    np.testing.assert_array_equal(a[1].data, b[1].data)
    assert ours.encoding.n_paths == theirs.encoding.n_paths > 0


@pytest.mark.parametrize("name", sorted(TINY))
def test_portbench_sizes_do_not_depend_on_the_seed(name):
    """Every seed draws the same amount of work: the same draws and path
    verbs (for clip_layers the same stacks, in another order)."""
    def verbs(cmds):
        return sorted((d[0], tuple(el[0] for el in d[-1])) for d in cmds["draws"])
    a, b = _cmds(name, 1), _cmds(name, 99)
    assert verbs(a) == verbs(b)
    assert a["draws"] != b["draws"]


@pytest.mark.parametrize("name", sorted(TINY))
@pytest.mark.parametrize("moved", [False, True])
def test_portbench_reference_matches_the_program_on_the_cpu(name, moved):
    cmds = _cmds(name, 12345)
    scene = commands.build(jt, cmds)
    t = None
    if moved:
        t = view_transform({"radius_px": 64, "period_frames": 120}, 17)
        outer = jt.Scene()
        outer.append(scene, jt.Affine(t))
        scene = outer
    got = Renderer(device="cpu").render_surface(scene, commands.params(jt, cmds))
    want = compare.Reference(BENCH, cmds, "cpu").frame(t)
    max_diff, off, _ = compare.diff_readings(got, want)
    assert max_diff <= 1 and off == 0
