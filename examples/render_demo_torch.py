"""End-to-end demo of the PyTorch/CUDA port: the scene of
`examples/render_demo.py` (every brush and feature family), rendered by
`jello_tpu_torch.cuda.Renderer` and written to a PPM image.

Renders on the GPU; `--device cpu` takes the plain PyTorch version of
every kernel on the CPU instead.

    python examples/render_demo_torch.py out.ppm [--device cpu] [--size 512]
"""

from __future__ import annotations

import argparse
import math
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jello_tpu_torch as jt
from jello_tpu_torch.cuda import Renderer
from jello_tpu_torch.renderer.params import RenderParams
from jello_tpu_torch.renderer.surface import write_ppm


def circle(cx, cy, r):
    k = 0.5519150244935105707435627 * r
    return (
        jt.BezPath()
        .move_to(cx + r, cy)
        .cubic_to(cx + r, cy + k, cx + k, cy + r, cx, cy + r)
        .cubic_to(cx - k, cy + r, cx - r, cy + k, cx - r, cy)
        .cubic_to(cx - r, cy - k, cx - k, cy - r, cx, cy - r)
        .cubic_to(cx + k, cy - r, cx + r, cy - k, cx + r, cy)
        .close()
    )


def rect(x0, y0, x1, y1):
    return (
        jt.BezPath().move_to(x0, y0).line_to(x1, y0).line_to(x1, y1).line_to(x0, y1).close()
    )


def build_scene(s: float) -> jt.Scene:
    scene = jt.Scene()
    ident = jt.Affine.identity()

    # Linear-gradient sky.
    sky = jt.LinearGradient(
        (0, 0),
        (0, 0.6 * s),
        [
            jt.ColorStop(0.0, jt.Color.rgba(0.45, 0.70, 0.95, 1)),
            jt.ColorStop(1.0, jt.Color.rgba(0.90, 0.95, 1.00, 1)),
        ],
    )
    scene.fill(jt.Fill.NON_ZERO, ident, jt.GradientBrush(sky), None, rect(0, 0, s, 0.62 * s))

    # Radial-gradient sun.
    sun = jt.RadialGradient(
        (0.78 * s, 0.18 * s), 0.0, (0.78 * s, 0.18 * s), 0.12 * s,
        [
            jt.ColorStop(0.0, jt.Color.rgba(1.0, 0.95, 0.6, 1)),
            jt.ColorStop(1.0, jt.Color.rgba(1.0, 0.8, 0.2, 0)),
        ],
    )
    scene.fill(jt.Fill.NON_ZERO, ident, jt.GradientBrush(sun), None,
               circle(0.78 * s, 0.18 * s, 0.13 * s))

    # Ground.
    scene.fill(jt.Fill.NON_ZERO, ident,
               jt.SolidBrush(jt.Color.rgba(0.35, 0.6, 0.3, 1)), None,
               rect(0, 0.6 * s, s, s))

    # Even-odd star (winding rule).
    star = jt.BezPath().move_to(0.2 * s, 0.12 * s)
    for i in range(1, 5):
        ang = i * 4 * math.pi / 5 - math.pi / 2
        star.line_to(0.2 * s + 0.1 * s * math.cos(ang), 0.22 * s + 0.1 * s * math.sin(ang))
    star.close()
    scene.fill(jt.Fill.EVEN_ODD, ident,
               jt.SolidBrush(jt.Color.rgba(0.9, 0.3, 0.2, 1)), None, star)

    # Dashed stroked path with round caps/joins (Euler-spiral expansion).
    road = (
        jt.BezPath()
        .move_to(0.05 * s, 0.95 * s)
        .cubic_to(0.3 * s, 0.7 * s, 0.6 * s, 1.0 * s, 0.95 * s, 0.72 * s)
    )
    scene.stroke(
        jt.Stroke(width=0.02 * s, join=jt.Join.ROUND, start_cap=jt.Cap.ROUND,
                  end_cap=jt.Cap.ROUND, dash_pattern=[0.05 * s, 0.02 * s]),
        ident, jt.SolidBrush(jt.Color.rgba(1, 1, 1, 0.9)), None, road,
    )

    # Clipped, blended group: a MULTIPLY layer inside a circular clip.
    scene.push_layer(jt.BlendMode(jt.Mix.MULTIPLY, jt.Compose.SRC_OVER), 0.85,
                     ident, circle(0.45 * s, 0.45 * s, 0.2 * s))
    scene.fill(jt.Fill.NON_ZERO, ident,
               jt.SolidBrush(jt.Color.rgba(0.8, 0.5, 0.9, 1)), None,
               rect(0.2 * s, 0.3 * s, 0.7 * s, 0.6 * s))
    sweep = jt.SweepGradient(
        (0.45 * s, 0.45 * s), 0.0, 2 * math.pi,
        [
            jt.ColorStop(0.0, jt.Color.rgba(1, 0, 0, 0.7)),
            jt.ColorStop(0.5, jt.Color.rgba(0, 0, 1, 0.7)),
            jt.ColorStop(1.0, jt.Color.rgba(1, 0, 0, 0.7)),
        ],
    )
    scene.fill(jt.Fill.NON_ZERO, ident, jt.GradientBrush(sweep), None,
               circle(0.45 * s, 0.45 * s, 0.19 * s))
    scene.pop_layer()
    return scene


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("out", nargs="?", default="demo.ppm")
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--device", default="cuda",
                    help="torch device; cpu runs the plain versions of the kernels")
    args = ap.parse_args()

    scene = build_scene(float(args.size))
    params = RenderParams(width=args.size, height=args.size,
                          base_color=jt.Color.rgba(1, 1, 1, 1))
    r = Renderer(device=args.device)
    img = r.render(scene, params)
    if any(r.last_flags.values()):
        raise RuntimeError(f"overflow flags raised: {r.last_flags}")
    write_ppm(args.out, img)
    print(f"wrote {args.out} ({args.size}x{args.size}, {r.device})")


if __name__ == "__main__":
    main()
