"""The port's entry points on the CPU: `jello_tpu_torch.entry.entry()`'s
frame is the renderer's, the demo (`examples/render_demo_torch.py`)
writes a PPM of its size with `--device cpu`, and
`entry.dryrun_multichip` runs the geometry-sharded dry run on two
spawned ranks over gloo."""

import subprocess
import sys
from pathlib import Path

import numpy as np

from jello_tpu_torch.cuda import Renderer
from jello_tpu_torch.cuda.render import assemble
from jello_tpu_torch.entry import dryrun_multichip, entry
from jello_tpu_torch.scenes import config1

from .torch_reference import child_env

REPO = Path(__file__).resolve().parent.parent
# Limits of about three times what each takes in the suite (8.8 s and
# 7.9 s on an 8-core machine under six workers).
DEMO_TIMEOUT = 30
DRYRUN_TIMEOUT = 30.0


def test_torch_entry_frame_is_the_renderers():
    fn, args = entry(device="cpu")
    img = assemble(fn(*args), args[1]).numpy()
    r = Renderer(device="cpu")
    ref = r.render(*config1())
    assert not any(r.last_flags.values())
    assert img.shape == ref.shape == (256, 256, 4)
    np.testing.assert_array_equal(img, ref)


def test_torch_demo_writes_a_ppm_on_the_cpu(tmp_path):
    out = tmp_path / "demo.ppm"
    res = subprocess.run([sys.executable, str(REPO / "examples" / "render_demo_torch.py"),
                          str(out), "--device", "cpu", "--size", "96"],
                         capture_output=True, text=True, timeout=DEMO_TIMEOUT, env=child_env())
    assert res.returncode == 0, res.stderr
    data = out.read_bytes()
    header = b"P6 96 96 255\n"
    assert data.startswith(header) and len(data) == len(header) + 96 * 96 * 3
    pixels = np.frombuffer(data[len(header):], np.uint8).reshape(96, 96, 3)
    assert len(np.unique(pixels.reshape(-1, 3), axis=0)) > 50  # the scene, not a blank


def test_torch_dryrun_multichip_two_ranks_over_gloo():
    assert dryrun_multichip(2, device="cpu", backend="gloo", timeout=DRYRUN_TIMEOUT) < 1e-3
