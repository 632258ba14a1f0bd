"""Strokes in jello_tpu_torch.

The flatten stage on stroked scenes (butt, square and round caps; bevel,
miter and round joins; open and closed subpaths; a dash; thin and wide)
against jello_tpu's stage under numpy on the same inputs: the valid
lines in the oracle's order (`torch_reference.check_flatten_lines`),
line counts and every integer field equal, end points within 1e-5 when
the port is fed the oracle's cbrt values (as in test_torch_stages.py; with its own
cbrt they move by up to 2e-3 px). Then stroked frames against the numpy
oracle within 2e-3.

Config 2 (100 stroked cubic chains with every cap and join, dashes on one
in four, 512x512): the host half and the packed layout against
jello_tpu's, the sharded class against jello_tpu's, and the frame
against the numpy oracle within 2e-3. The scene is built once per
package and shared (`torch_reference.config2_both`): its dashes are
flattened in Python on the host, tens of seconds a build. Its tests live
in this file, which holds many, because pytest-xdist's `--dist loadfile`
hands files out in the order of their test counts, most first: a file of
four tests and minutes of work would start last and end the run late.
"""

import numpy as np
import pytest
import torch

import jello_tpu as jt
from jello_tpu import pmath as np_pm
from jello_tpu.pipeline import flatten as np_flatten

from jello_tpu_torch import pmath as pm
from jello_tpu_torch.cuda import Renderer
from jello_tpu_torch.cuda.render import upload
from jello_tpu_torch.pipeline import flatten

from .test_torch_host import check_host_half
from .test_torch_program import check_pack_layout
from .test_torch_sharded import check_shard_caps
from .torch_reference import check_flatten_lines, check_frame, config2_both, prepare

ATOL = 1e-5
FRAME_TOL = 2e-3

LINE = [("M", 28, 128), ("L", 228, 128)]
ELBOW = [("M", 50, 50), ("L", 200, 50), ("L", 200, 200)]
ZIGZAG = [("M", 20, 200), ("L", 70, 40), ("L", 120, 200), ("L", 170, 40), ("L", 220, 200)]
SQUARE = [("M", 64, 64), ("L", 192, 64), ("L", 192, 192), ("L", 64, 192), ("Z",)]
CURVE = [("M", 30, 128), ("C", 90, 30, 170, 230, 226, 128)]
LOOP = [("M", 60, 60), ("C", 220, 20, 240, 240, 128, 200), ("Q", 20, 180, 60, 60), ("Z",)]


def _path(j, els):
    p = j.BezPath()
    for e in els:
        {"M": p.move_to, "L": p.line_to, "Q": p.quad_to, "C": p.cubic_to,
         "Z": p.close}[e[0]](*e[1:])
    return p


def _stroke(j, width, join="BEVEL", cap="BUTT", **kw):
    return j.Stroke(width=width, join=getattr(j.Join, join), **kw).with_caps(getattr(j.Cap, cap))


def _scene(strokes, size=256, transform=None):
    """strokes: [(path elements, stroke keyword arguments), ...]; returns
    build(jt) -> (Scene, RenderParams) for either package."""
    def build(j):
        s = j.Scene()
        for k, (els, kw) in enumerate(strokes):
            xf = transform(j) if transform else j.Affine.identity()
            color = j.Color.rgba(0.1 + 0.2 * (k % 4), 0.8 - 0.15 * (k % 5), 0.3, 0.85)
            s.stroke(_stroke(j, **kw), xf, j.SolidBrush(color), None, _path(j, els))
        return s, j.RenderParams(width=size, height=size, base_color=j.Color.rgba(1, 1, 1, 1))
    return build


SCENES = {
    "butt_caps": _scene([(LINE, dict(width=10))]),
    "square_caps": _scene([(LINE, dict(width=10, cap="SQUARE"))]),
    "round_caps": _scene([(LINE, dict(width=10, join="ROUND", cap="ROUND"))]),
    "miter_join": _scene([(ELBOW, dict(width=8, join="MITER", miter_limit=10))]),
    "bevel_join": _scene([(ELBOW, dict(width=8))]),
    "round_joins_zigzag": _scene([(ZIGZAG, dict(width=7, join="ROUND", cap="ROUND"))]),
    "miter_limit_falls_back": _scene([(ZIGZAG, dict(width=6, join="MITER", miter_limit=2))]),
    "closed_no_caps": _scene([(SQUARE, dict(width=8, join="MITER", miter_limit=10,
                                            cap="ROUND"))]),
    "curve": _scene([(CURVE, dict(width=6, join="ROUND"))]),
    "closed_curve_round": _scene([(LOOP, dict(width=5, join="ROUND", cap="ROUND"))]),
    "thin_round": _scene([(CURVE, dict(width=0.4, join="ROUND", cap="ROUND")),
                          (ZIGZAG, dict(width=0.9, join="ROUND", cap="ROUND"))]),
    "dashed": _scene([(LINE, dict(width=4, dash_pattern=(20.0, 10.0))),
                      (CURVE, dict(width=3, join="ROUND", cap="ROUND",
                                   dash_pattern=(12.0, 7.0), dash_offset=5.0))]),
    "scaled_transform": _scene(
        [([("M", -72, 28), ("L", 128, 28), ("L", 140, 180)], dict(width=10, join="ROUND"))],
        transform=lambda j: j.Affine.scale(0.5) @ j.Affine.translate(100, 100)),
}


def _oracle_cbrt(x):
    with np.errstate(all="ignore"):
        return torch.from_numpy(np.asarray(np_pm.cbrt(np, x.numpy()), dtype=np.float32))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_torch_stroke_flatten_matches_numpy(name, monkeypatch):
    monkeypatch.setattr(pm, "cbrt", _oracle_cbrt)
    scene, params = SCENES[name](jt)
    s, ld, ramps, caps = prepare(scene, params)
    with np.errstate(all="ignore"):
        fl = np_flatten.flatten_stage(np, s, ld, caps)
    scene_t, layout_t, _, caps_t = upload(s, ld, ramps, caps, "cpu")
    gfl = flatten.flatten_stage(scene_t, layout_t, caps_t)
    assert int(fl["n_work_b"]) > 0  # the stroke offsets' side of the worklist
    check_flatten_lines(fl, gfl, ATOL)


FRAMES = ["butt_caps", "round_caps", "miter_join", "round_joins_zigzag", "closed_no_caps",
          "thin_round", "dashed", "scaled_transform"]


@pytest.mark.parametrize("name", FRAMES)
def test_torch_stroke_frame_matches_oracle(name):
    r = Renderer(device="cpu")
    check_frame(r, SCENES[name], tol=FRAME_TOL)
    assert r.last_stats["work_b"] > 0


def test_torch_config2_host_half_matches_jello_tpu():
    check_host_half(*config2_both())


def test_torch_config2_frame_matches_oracle():
    r = Renderer(device="cpu")
    check_frame(r, config2_both, tol=2e-3)
    assert r.last_stats["work_b"] > 0 and r.last_stats["arc_lines"] > 0
    assert r.last_stats["simple_lines"] > 0  # the dashes' line segments


def test_torch_config2_pack_layout_matches_jello_tpu():
    """The packed layout of config 2 equals jello_tpu's word for word (the
    other gate scenes: tests/test_torch_program.py)."""
    check_pack_layout(*config2_both())


def test_torch_config2_shard_caps_match_jello_tpu():
    """`cuda/sharded2.py::shard_caps` on config 2's estimated class equals
    jello_tpu's (the other gate scenes: tests/test_torch_sharded.py)."""
    check_shard_caps(*config2_both()[1])
