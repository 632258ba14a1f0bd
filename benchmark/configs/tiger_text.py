"""tiger_text: the draw commands of the tiger-and-text scene at 1080p.

A frozen copy of the program's `scenes.py::config5` generator, made into
a list of draw commands (`portbench.commands`). Two random streams: the
configuration's `shape_seed` draws every path (kind, size, place), and
the run's seed draws the paint (colors, gradient stops, the image's
pixels) and the order the paths are drawn in over the background. So
every seed renders the same paths, overlapping in another order: the
same work, which settles the same capacity class.
"""

from __future__ import annotations

import math

import numpy as np


def _color(place):
    return (place.random(), place.random(), place.random(), 0.3 + 0.7 * place.random())


def _long_blob(shape, cx, cy, r, n_segs):
    """A closed wavy contour of n_segs cubic segments around (cx, cy)."""
    angles = np.linspace(0, 2 * math.pi, n_segs, endpoint=False)
    radii = r * (0.7 + 0.5 * shape.random(n_segs) + 0.15 * np.sin(angles * shape.integers(2, 7)))
    pts = [(cx + rr * math.cos(a), cy + rr * math.sin(a)) for a, rr in zip(angles, radii)]
    path = [("M", *pts[0])]
    jitter = r * 2.0 * math.pi / n_segs * 0.5
    for i in range(n_segs):
        a, b = pts[i], pts[(i + 1) % n_segs]
        path.append(("C",
                     a[0] + (b[0] - a[0]) / 3 + shape.normal(0, jitter),
                     a[1] + (b[1] - a[1]) / 3 + shape.normal(0, jitter),
                     a[0] + 2 * (b[0] - a[0]) / 3 + shape.normal(0, jitter),
                     a[1] + 2 * (b[1] - a[1]) / 3 + shape.normal(0, jitter),
                     b[0], b[1]))
    path.append(("Z",))
    return path


def _glyph(shape, cx, cy, size):
    """An even-odd glyph-like path: an outer contour and a counter."""
    n_out = int(shape.integers(6, 10))
    n_in = int(shape.integers(4, 7))
    path = []
    for n, rr in ((n_out, size * 0.5), (n_in, size * 0.22)):
        angles = np.linspace(0, 2 * math.pi, n, endpoint=False)
        radii = rr * (0.8 + 0.4 * shape.random(n))
        pts = [(cx + q * math.cos(a), cy + q * math.sin(a) * 1.4) for a, q in zip(angles, radii)]
        path.append(("M", *pts[0]))
        for i in range(n):
            a, b = pts[i], pts[(i + 1) % n]
            path.append(("C",
                         a[0] + (b[0] - a[0]) / 3, a[1] + (b[1] - a[1]) / 3 + shape.normal(0, rr * 0.1),
                         a[0] + 2 * (b[0] - a[0]) / 3,
                         a[1] + 2 * (b[1] - a[1]) / 3 + shape.normal(0, rr * 0.1),
                         b[0], b[1]))
        path.append(("Z",))
    return path


def _stops(place):
    return tuple((off, (place.random(), place.random(), place.random(), 1.0))
                 for off in (0.0, 0.5, 1.0))


def commands(cfg: dict, seed: int) -> dict:
    """The scene of `cfg` (this configuration's JSON) for the run's seed."""
    shape = np.random.default_rng(cfg["shape_seed"])
    place = np.random.default_rng(seed)
    W, H = cfg["width"], cfg["height"]
    n = cfg["n_paths"]
    shares = cfg["shares"]
    n_art, n_stroke = int(n * shares["art"]), int(n * shares["stroke"])
    n_glyph, n_grad = int(n * shares["glyph"]), int(n * shares["gradient"])
    n_img = n - n_art - n_stroke - n_glyph - n_grad
    a_lo, a_hi = cfg["art_segments"]
    s_lo, s_hi = cfg["stroke_segments"]
    w_lo, w_hi = cfg["stroke_width_px"]
    g_lo, g_hi = cfg["glyph_size_px"]
    q_lo, q_hi = cfg["gradient_segments"]
    px = cfg["image_px"]

    pix = (place.random((px, px, 4)) * 255).astype(np.uint8)
    pix[..., 3] = 255
    full = [("M", 0, 0), ("L", W, 0), ("L", W, H), ("L", 0, H), ("Z",)]
    draws = [("fill", "nonzero", None, ("solid", (0.95, 0.95, 0.9, 1.0)), full)]

    for _ in range(n_art):
        cx, cy = shape.random() * W, shape.random() * H
        n_segs = int(round(a_lo * ((a_hi / a_lo) ** shape.random())))
        r = (6 + 70 * shape.random() ** 2) * (0.5 + n_segs / 64.0)
        draws.append(("fill", "nonzero", None, ("solid", _color(place)),
                      _long_blob(shape, cx, cy, r, n_segs)))

    for _ in range(n_stroke):
        x, y = shape.random() * W, shape.random() * H
        n_segs = int(shape.integers(s_lo, s_hi + 1))
        ang = shape.random() * 2 * math.pi
        path = [("M", x, y)]
        for _ in range(n_segs):
            step = 4 + 20 * shape.random()
            ang += shape.normal(0, 0.6)
            nx, ny = x + step * math.cos(ang), y + step * math.sin(ang)
            path.append(("C", x + step * 0.3 * math.cos(ang + 0.4),
                         y + step * 0.3 * math.sin(ang + 0.4),
                         x + step * 0.7 * math.cos(ang - 0.3), y + step * 0.7 * math.sin(ang - 0.3),
                         nx, ny))
            x, y = nx, ny
        width = w_lo + (w_hi - w_lo) * shape.random()
        draws.append(("stroke", {"width": width, "join": "round", "cap": "round"}, None,
                      ("solid", _color(place)), path))

    # Text lines: glyph sizes, advances, word gaps and line pitch all drawn
    # from `shape`.
    placed = 0
    y = 18.0
    while placed < n_glyph and y < H - 10:
        size = float(g_lo + (g_hi - g_lo) * shape.random())
        x = 8.0 + 10.0 * shape.random()
        while x < W - 10 and placed < n_glyph:
            draws.append(("fill", "evenodd", None, ("solid", _color(place)),
                          _glyph(shape, x, y, size)))
            x += size * (0.65 + 0.2 * shape.random())
            if shape.random() < 0.12:
                x += size * 0.8
            placed += 1
        y += size * 1.6
    for _ in range(n_glyph - placed):
        cx, cy = shape.random() * W, shape.random() * H
        draws.append(("fill", "evenodd", None, ("solid", _color(place)),
                      _glyph(shape, cx, cy, g_lo + (g_hi - g_lo) * shape.random())))

    for i in range(n_grad):
        cx, cy = shape.random() * W, shape.random() * H
        r = 15 + 60 * shape.random()
        n_segs = int(shape.integers(q_lo, q_hi + 1))
        brush = (("linear", (cx - r, cy), (cx + r, cy), _stops(place)) if i % 2 == 0
                 else ("radial", (cx, cy), r, _stops(place)))
        draws.append(("fill", "nonzero", None, brush, _long_blob(shape, cx, cy, r, n_segs)))

    square = [("M", 0, 0), ("L", px, 0), ("L", px, px), ("L", 0, px), ("Z",)]
    for _ in range(n_img):
        cx, cy = shape.random() * W, shape.random() * H
        s = (3 + 25 * shape.random() ** 2) / (px / 2)
        draws.append(("fill", "nonzero", (s, 0.0, 0.0, s, cx, cy), ("image", 0), square))

    draws = draws[:1] + [draws[1 + k] for k in place.permutation(len(draws) - 1)]
    return {"width": W, "height": H, "base_color": tuple(cfg["base_color"]),
            "antialiasing": cfg["antialiasing"], "images": [pix], "draws": draws}
