"""Procedural benchmark scenes for the five BASELINE.json configs.

The Ghostscript tiger asset is not available in this environment (no
network egress), so config 5 is a deterministic procedural scene with
the same structural profile: >10k paths mixing multi-segment cubic
fills, stroked outlines, gradients and image brushes at 1080p.

The port's own copy of `jello_tpu/scenes.py` (same text; only the imports
stay inside `jello_tpu_torch`), so that the port imports nothing of
`jello_tpu`.
"""

from __future__ import annotations

import math

import numpy as np

import jello_tpu_torch as jt
from .curve import circle
from .renderer.params import RenderParams

IDENT = jt.Affine.identity()


def _rng(seed=1234):
    return np.random.default_rng(seed)


def _blob(rng, cx, cy, r, n_segs=4):
    """A closed blob of n cubic segments around (cx, cy)."""
    p = jt.BezPath()
    angles = np.linspace(0, 2 * math.pi, n_segs, endpoint=False)
    radii = r * (0.6 + 0.8 * rng.random(n_segs))
    pts = [(cx + rr * math.cos(a), cy + rr * math.sin(a)) for a, rr in zip(angles, radii)]
    p.move_to(*pts[0])
    for i in range(n_segs):
        a, b = pts[i], pts[(i + 1) % n_segs]
        c1 = (a[0] + (b[0] - a[0]) / 3 + rng.normal(0, r * 0.2), a[1] + (b[1] - a[1]) / 3 + rng.normal(0, r * 0.2))
        c2 = (a[0] + 2 * (b[0] - a[0]) / 3 + rng.normal(0, r * 0.2), a[1] + 2 * (b[1] - a[1]) / 3 + rng.normal(0, r * 0.2))
        p.cubic_to(c1[0], c1[1], c2[0], c2[1], b[0], b[1])
    p.close()
    return p


def _solid(rng):
    return jt.SolidBrush(jt.Color.rgba(rng.random(), rng.random(), rng.random(), 0.3 + 0.7 * rng.random()))


def _gradient(rng, cx, cy, r, kind="linear"):
    stops = (
        jt.ColorStop(0.0, jt.Color.rgba(rng.random(), rng.random(), rng.random(), 1)),
        jt.ColorStop(0.5, jt.Color.rgba(rng.random(), rng.random(), rng.random(), 1)),
        jt.ColorStop(1.0, jt.Color.rgba(rng.random(), rng.random(), rng.random(), 1)),
    )
    if kind == "linear":
        return jt.GradientBrush(jt.LinearGradient((cx - r, cy), (cx + r, cy), stops))
    return jt.GradientBrush(jt.RadialGradient((cx, cy), 0.0, (cx, cy), r, stops))


def config1():
    """Single solid-fill cubic path @256x256."""
    scene = jt.Scene()
    path = jt.BezPath().move_to(30, 40).cubic_to(90, 10, 150, 220, 200, 240).line_to(180, 50).close()
    scene.fill(jt.Fill.NON_ZERO, IDENT, jt.SolidBrush(jt.Color.rgba(0.8, 0.1, 0.2, 1)), None, path)
    return scene, RenderParams(width=256, height=256, base_color=jt.Color.rgba(1, 1, 1, 1))


def config2():
    """100 stroked paths with joins/caps/dashes @512x512."""
    rng = _rng(2)
    scene = jt.Scene()
    caps = [jt.Cap.BUTT, jt.Cap.SQUARE, jt.Cap.ROUND]
    joins = [jt.Join.BEVEL, jt.Join.MITER, jt.Join.ROUND]
    for i in range(100):
        x0, y0 = rng.random(2) * 512
        p = jt.BezPath().move_to(x0, y0)
        for _ in range(3):
            x1, y1, x2, y2, x3, y3 = rng.random(6) * 512
            p.cubic_to(x1, y1, x2, y2, x3, y3)
        dash = (10.0, 6.0) if i % 4 == 0 else ()
        st = jt.Stroke(
            width=1 + 6 * rng.random(),
            join=joins[i % 3],
            miter_limit=4.0,
            start_cap=caps[i % 3],
            end_cap=caps[(i + 1) % 3],
            dash_pattern=dash,
        )
        scene.stroke(st, IDENT, _solid(rng), None, p)
    return scene, RenderParams(width=512, height=512, base_color=jt.Color.rgba(1, 1, 1, 1))


def config3():
    """1k gradient-filled paths @1024x1024."""
    rng = _rng(3)
    scene = jt.Scene()
    for i in range(1000):
        cx, cy = rng.random(2) * 1024
        r = 10 + 40 * rng.random()
        path = _blob(rng, cx, cy, r)
        kind = "linear" if i % 2 == 0 else "radial"
        scene.fill(jt.Fill.NON_ZERO, IDENT, _gradient(rng, cx, cy, r, kind), None, path)
    return scene, RenderParams(width=1024, height=1024, base_color=jt.Color.rgba(1, 1, 1, 1))


def config4():
    """Nested clip stack + mix/compose blend modes @1080p."""
    rng = _rng(4)
    scene = jt.Scene()
    mixes = [jt.Mix.NORMAL, jt.Mix.MULTIPLY, jt.Mix.SCREEN, jt.Mix.OVERLAY,
             jt.Mix.DARKEN, jt.Mix.LIGHTEN, jt.Mix.DIFFERENCE, jt.Mix.EXCLUSION]
    W, H = 1920, 1080
    full = jt.BezPath().move_to(0, 0).line_to(W, 0).line_to(W, H).line_to(0, H).close()
    scene.fill(jt.Fill.NON_ZERO, IDENT, _gradient(rng, W / 2, H / 2, W / 2), None, full)
    for i in range(40):
        cx, cy = rng.random() * W, rng.random() * H
        r = 60 + 200 * rng.random()
        clip = circle(cx, cy, r)
        depth = 1 + int(rng.integers(0, 3))
        for d in range(depth):
            blend = jt.BlendMode(mixes[int(rng.integers(0, len(mixes)))], jt.Compose.SRC_OVER)
            scene.push_layer(blend, float(0.5 + 0.5 * rng.random()), IDENT, circle(cx, cy, r * (1 - 0.2 * d)))
        for _ in range(4):
            bx, by = cx + rng.normal(0, r), cy + rng.normal(0, r)
            scene.fill(jt.Fill.NON_ZERO, IDENT, _solid(rng), None, _blob(rng, bx, by, r * 0.5))
        for d in range(depth):
            scene.pop_layer()
    return scene, RenderParams(width=W, height=H, base_color=jt.Color.rgba(1, 1, 1, 1))


def _long_blob(rng, cx, cy, r, n_segs):
    """A closed wavy contour of n_segs cubic segments — matches the
    long-path profile of the tiger's fur/outline paths (tens of cubic
    segments tracing one feature)."""
    p = jt.BezPath()
    angles = np.linspace(0, 2 * math.pi, n_segs, endpoint=False)
    radii = r * (0.7 + 0.5 * rng.random(n_segs) + 0.15 * np.sin(angles * rng.integers(2, 7)))
    pts = [(cx + rr * math.cos(a), cy + rr * math.sin(a)) for a, rr in zip(angles, radii)]
    p.move_to(*pts[0])
    jitter = r * 2.0 * math.pi / n_segs * 0.5
    for i in range(n_segs):
        a, b = pts[i], pts[(i + 1) % n_segs]
        c1 = (a[0] + (b[0] - a[0]) / 3 + rng.normal(0, jitter), a[1] + (b[1] - a[1]) / 3 + rng.normal(0, jitter))
        c2 = (a[0] + 2 * (b[0] - a[0]) / 3 + rng.normal(0, jitter), a[1] + 2 * (b[1] - a[1]) / 3 + rng.normal(0, jitter))
        p.cubic_to(c1[0], c1[1], c2[0], c2[1], b[0], b[1])
    p.close()
    return p


def _glyph(rng, cx, cy, size):
    """An even-odd glyph-like path: an outer contour plus a counter
    (hole) subpath, like a lowercase 'o'/'e' outline. Two subpaths,
    10-16 cubic segments total."""
    n_out = int(rng.integers(6, 10))
    n_in = int(rng.integers(4, 7))
    p = jt.BezPath()
    for n, rr in ((n_out, size * 0.5), (n_in, size * 0.22)):
        angles = np.linspace(0, 2 * math.pi, n, endpoint=False)
        radii = rr * (0.8 + 0.4 * rng.random(n))
        pts = [(cx + q * math.cos(a), cy + q * math.sin(a) * 1.4) for a, q in zip(angles, radii)]
        p.move_to(*pts[0])
        for i in range(n):
            a, b = pts[i], pts[(i + 1) % n]
            c1 = (a[0] + (b[0] - a[0]) / 3, a[1] + (b[1] - a[1]) / 3 + rng.normal(0, rr * 0.1))
            c2 = (a[0] + 2 * (b[0] - a[0]) / 3, a[1] + 2 * (b[1] - a[1]) / 3 + rng.normal(0, rr * 0.1))
            p.cubic_to(c1[0], c1[1], c2[0], c2[1], b[0], b[1])
        p.close()
    return p


def config5(n_paths=10000):
    """Tiger + text profile scene @1080p (BASELINE.json configs[4]).

    The Ghostscript tiger asset is unavailable (no egress), so this is a
    procedural scene matched to its structural profile rather than its
    geometry:
      - 35% "artwork" fills with a long-tailed segment distribution
        (4-64 cubic segments/path, log-uniform — the tiger's paths are
        long feature outlines, not 4-segment blobs);
      - 25% thin strokes (0.2-1.0 px wide, 4-24 segments — the tiger's
        whiskers/fur detail);
      - 30% even-odd glyph outlines (2 subpaths with a counter hole,
        10-16 segments, 8-22 px) laid out in text lines at text density;
      - 5% gradient fills and 5% image fills.
    The realized segment histogram is printed by
    `python -m jello_tpu_torch.scenes`.
    """
    rng = _rng(5)
    scene = jt.Scene()
    W, H = 1920, 1080
    full = jt.BezPath().move_to(0, 0).line_to(W, 0).line_to(W, H).line_to(0, H).close()
    scene.fill(jt.Fill.NON_ZERO, IDENT, jt.SolidBrush(jt.Color.rgba(0.95, 0.95, 0.9, 1)), None, full)
    pix = (rng.random((8, 8, 4)) * 255).astype(np.uint8)
    pix[..., 3] = 255
    image = jt.Image(pixels=pix)

    n_art = int(n_paths * 0.35)
    n_stroke = int(n_paths * 0.25)
    n_glyph = int(n_paths * 0.30)
    n_grad = int(n_paths * 0.05)
    n_img = n_paths - n_art - n_stroke - n_glyph - n_grad

    # Artwork block: long closed contours, log-uniform 4-64 segments.
    for _ in range(n_art):
        cx, cy = rng.random() * W, rng.random() * H
        n_segs = int(round(4 * (16.0 ** rng.random())))  # 4..64
        r = (6 + 70 * rng.random() ** 2) * (0.5 + n_segs / 64.0)
        scene.fill(jt.Fill.NON_ZERO, IDENT, _solid(rng), None,
                   _long_blob(rng, cx, cy, r, n_segs))

    # Thin strokes: whisker/fur detail, width 0.2-1.0 px.
    for _ in range(n_stroke):
        cx, cy = rng.random() * W, rng.random() * H
        n_segs = int(rng.integers(4, 25))
        p = jt.BezPath().move_to(cx, cy)
        x, y = cx, cy
        ang = rng.random() * 2 * math.pi
        for _ in range(n_segs):
            step = 4 + 20 * rng.random()
            ang += rng.normal(0, 0.6)
            nx, ny = x + step * math.cos(ang), y + step * math.sin(ang)
            p.cubic_to(x + step * 0.3 * math.cos(ang + 0.4), y + step * 0.3 * math.sin(ang + 0.4),
                       x + step * 0.7 * math.cos(ang - 0.3), y + step * 0.7 * math.sin(ang - 0.3),
                       nx, ny)
            x, y = nx, ny
        scene.stroke(
            jt.Stroke(width=0.2 + 0.8 * rng.random(), join=jt.Join.ROUND).with_caps(jt.Cap.ROUND),
            IDENT, _solid(rng), None, p,
        )

    # Text block: even-odd glyphs in lines (text density: ~9-22 px glyphs,
    # advance ~0.7*size, line pitch ~1.6*size).
    placed = 0
    y = 18.0
    while placed < n_glyph and y < H - 10:
        size = float(8 + 14 * rng.random())
        x = 8.0 + 10.0 * rng.random()
        while x < W - 10 and placed < n_glyph:
            scene.fill(jt.Fill.EVEN_ODD, IDENT, _solid(rng), None,
                       _glyph(rng, x, y, size))
            x += size * (0.65 + 0.2 * rng.random())
            if rng.random() < 0.12:
                x += size * 0.8  # word gap
            placed += 1
        y += size * 1.6
    # Overflow (very large n_paths): scatter the remainder.
    for _ in range(n_glyph - placed):
        scene.fill(jt.Fill.EVEN_ODD, IDENT, _solid(rng), None,
                   _glyph(rng, rng.random() * W, rng.random() * H, 8 + 14 * rng.random()))

    for i in range(n_grad):
        cx, cy = rng.random() * W, rng.random() * H
        r = 15 + 60 * rng.random()
        kind = "linear" if i % 2 == 0 else "radial"
        n_segs = int(rng.integers(4, 17))
        scene.fill(jt.Fill.NON_ZERO, IDENT, _gradient(rng, cx, cy, r, kind), None,
                   _long_blob(rng, cx, cy, r, n_segs))

    for _ in range(n_img):
        cx, cy = rng.random() * W, rng.random() * H
        r = 3 + 25 * rng.random() ** 2
        scene.fill(
            jt.Fill.NON_ZERO,
            jt.Affine.translate(cx, cy) @ jt.Affine.scale(r / 4),
            jt.ImageBrush(image),
            None,
            jt.BezPath().move_to(0, 0).line_to(8, 0).line_to(8, 8).line_to(0, 8).close(),
        )
    return scene, RenderParams(width=W, height=H, base_color=jt.Color.rgba(1, 1, 1, 1))


CONFIGS = {1: config1, 2: config2, 3: config3, 4: config4, 5: config5}

# The configs the port renders, config number -> () -> (Scene, RenderParams):
# all of them.
GATE_SCENES = dict(CONFIGS)


def _profile_config5(n_paths=10000):
    """Print the realized structural profile of config5 (documented in
    BASELINE.md next to the bench number)."""
    scene, params = config5(n_paths)
    enc = scene.encoding
    tags = np.asarray(enc.path_tags, dtype=np.uint8)
    seg_kind = tags & 0x3  # PATH_TAG segment kind bits (0 = no segment)
    n_segs_total = int((seg_kind != 0).sum())
    n_paths_enc = int(((tags & 0x10) != 0).sum())  # PATH bit
    # per-path segment counts
    path_id = np.cumsum((tags & 0x10) != 0) - ((tags & 0x10) != 0)
    segs_per_path = np.bincount(path_id[seg_kind != 0], minlength=n_paths_enc)
    hist_edges = [0, 4, 8, 16, 32, 64, 128, 1 << 30]
    hist = np.histogram(segs_per_path, bins=hist_edges)[0]
    print(f"paths: {n_paths_enc}, segments: {n_segs_total}, "
          f"mean segs/path: {n_segs_total / max(n_paths_enc, 1):.1f}")
    print("segs/path histogram:")
    for lo, hi, c in zip(hist_edges[:-1], hist_edges[1:], hist):
        label = f"{lo}-{hi - 1}" if hi < 1 << 29 else f"{lo}+"
        print(f"  {label:>8}: {c}")


if __name__ == "__main__":
    import sys

    _profile_config5(int(sys.argv[1]) if len(sys.argv) > 1 else 10000)
