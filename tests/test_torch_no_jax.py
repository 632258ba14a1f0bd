"""jello_tpu_torch imports neither JAX nor anything of jello_tpu: with
`jax` and `jello_tpu` both blocked in sys.modules, the port imports and
renders config 1 (its second frame through the program of its class,
`cuda/program.py`), a small image-plus-stroke scene and a scene with
nested blend layers on the CPU (and imports the profiler, the trace
parser, the multi-GPU paths and the entry points). The
comparison with the oracle runs in this process, which may import
jello_tpu, on the image the blocked process saved."""

import subprocess
import sys
from pathlib import Path

import numpy as np

from .torch_reference import child_env

REPO = Path(__file__).resolve().parent.parent
# About three times what the blocked process takes in the suite (10.9 s on
# an 8-core machine under six workers).
TIMEOUT = 40

BUILD = """
def image_and_stroke(jt):
    rng = np.random.default_rng(11)
    pix = (rng.random((8, 8, 4)) * 255).astype(np.uint8)
    pix[..., 3] = 200
    s = jt.Scene()
    s.fill(jt.Fill.NON_ZERO, jt.Affine.translate(9.4, 7.7) @ jt.Affine.scale(5.3),
           jt.ImageBrush(jt.Image(pixels=pix)), None,
           jt.BezPath().move_to(0, 0).line_to(8, 0).line_to(8, 8).line_to(0, 8).close())
    st = jt.Stroke(width=2.5, join=jt.Join.ROUND).with_caps(jt.Cap.ROUND)
    s.stroke(st, jt.Affine.identity(), jt.SolidBrush(jt.Color.rgba(0.1, 0.2, 0.7, 0.8)), None,
             jt.BezPath().move_to(6, 50).cubic_to(20, 5, 40, 60, 58, 12))
    return s, jt.RenderParams(width=64, height=64, base_color=jt.Color.rgba(1, 1, 1, 1))


def nested_layers(jt):
    def rect(x0, y0, x1, y1):
        return jt.BezPath().move_to(x0, y0).line_to(x1, y0).line_to(x1, y1).line_to(x0, y1).close()

    ident = jt.Affine.identity()
    s = jt.Scene()
    s.fill(jt.Fill.NON_ZERO, ident, jt.SolidBrush(jt.Color.rgba(0.9, 0.7, 0.2, 1)), None,
           rect(0, 0, 64, 64))
    s.push_layer(jt.BlendMode(jt.Mix.MULTIPLY, jt.Compose.SRC_OVER), 0.8, ident,
                 rect(4.5, 6.5, 58.5, 60.5))
    s.fill(jt.Fill.NON_ZERO, ident, jt.SolidBrush(jt.Color.rgba(0.2, 0.6, 0.9, 0.7)), None,
           rect(10, 10, 50, 40))
    s.push_layer(jt.BlendMode(jt.Mix.CLIP, jt.Compose.SRC_OVER), 1.0, ident,
                 rect(20.3, 20.7, 44.2, 52.9))
    s.fill(jt.Fill.NON_ZERO, ident, jt.SolidBrush(jt.Color.rgba(0.8, 0.1, 0.3, 0.9)), None,
           rect(0, 0, 64, 64))
    s.pop_layer()
    s.pop_layer()
    return s, jt.RenderParams(width=64, height=64, base_color=jt.Color.rgba(1, 1, 1, 1))
"""

SCRIPT = """
import sys
sys.modules["jax"] = None
sys.modules["jello_tpu"] = None
import numpy as np
import jello_tpu_torch as jt
import jello_tpu_torch.cuda
import jello_tpu_torch.cuda.program
import jello_tpu_torch.profiler
import jello_tpu_torch.xtrace
import jello_tpu_torch.cuda.sharded
import jello_tpu_torch.cuda.sharded2
import jello_tpu_torch.entry
from jello_tpu_torch.cuda import Renderer
from jello_tpu_torch.scenes import GATE_SCENES
""" + BUILD + """
r = Renderer(device="cpu")
r.render(*GATE_SCENES[1]())
img1 = r.render(*GATE_SCENES[1]())  # the settled class's program
assert not any(r.last_flags.values()), r.last_flags
assert len(r.compile_log) == 1
img2 = r.render(*image_and_stroke(jt))
assert not any(r.last_flags.values()), r.last_flags
assert r.last_stats["img_recs"] > 0 and r.last_stats["work_b"] > 0
img3 = r.render(*nested_layers(jt))
assert not any(r.last_flags.values()), r.last_flags
assert r.last_stats["legacy_tiles"] > 0
loaded = [k for k, v in sys.modules.items() if v is not None
          and (k == "jax" or k.startswith("jax.") or k == "jello_tpu"
               or k.startswith("jello_tpu."))]
assert not loaded, loaded
np.savez(sys.argv[1], config1=img1, image_and_stroke=img2, nested_layers=img3)
"""


def test_torch_port_runs_without_jax_and_jello_tpu(tmp_path):
    out = tmp_path / "frames.npz"
    res = subprocess.run([sys.executable, "-c", SCRIPT, str(out)], cwd=REPO,
                         capture_output=True, text=True, timeout=TIMEOUT, env=child_env())
    assert res.returncode == 0, res.stderr
    import jello_tpu
    import jello_tpu.scenes
    from jello_tpu.cpu import render_numpy

    scope = {"np": np}
    exec(BUILD, scope)
    frames = np.load(out)
    for name, built in (("config1", jello_tpu.scenes.config1()),
                        ("image_and_stroke", scope["image_and_stroke"](jello_tpu)),
                        ("nested_layers", scope["nested_layers"](jello_tpu))):
        with np.errstate(all="ignore"):
            ref, _, _ = render_numpy(*built)
        assert np.abs(frames[name] - ref).max() <= 2e-3, name


def test_torch_port_sources_do_not_import_jax_or_jello_tpu():
    import re

    jello = re.compile(r"^\s*(import|from)\s+jello_tpu(\.|\s|$)", re.M)
    files = [p for p in (REPO / "jello_tpu_torch").rglob("*.py") if "_build" not in p.parts]
    # chip_smoke.py imports its bare-entry helpers from the frame-times tool.
    for path in files + [REPO / "chip_smoke.py", REPO / "tools" / "torch_frame_times.py",
                         REPO / "tools" / "sharded_frames.py", REPO / "tools" / "nccl_one_card.py",
                         REPO / "tools" / "compiled_frames.py", REPO / "tools" / "replay_crash.py",
                         REPO / "tools" / "graph_kernels.py", REPO / "tools" / "path_count_ops.py",
                         REPO / "examples" / "render_demo_torch.py"]:
        text = path.read_text()
        assert "import jax" not in text and "from jax" not in text, path
        assert not jello.search(text), path


def test_torch_run_ranks_refuses_nccl_without_a_card_per_rank():
    """NCCL is asked for and there are fewer cards than ranks (none here):
    run_ranks raises before it starts a rank and does not switch to gloo."""
    import pytest

    from jello_tpu_torch.cuda import collectives
    from jello_tpu_torch.cuda.sharded import rank_frames

    for device in ("cuda", "cpu"):
        with pytest.raises(RuntimeError, match="needs a card per rank"):
            collectives.run_ranks(rank_frames, 2, "nccl", device, ([],))
    with pytest.raises(ValueError, match="backend"):
        collectives.run_ranks(rank_frames, 2, "mpi", "cpu", ([],))
