"""motionmark_suits: the draw commands of MotionMark's Suits test.

Card suits (spade, heart, club, diamond) over the stage, each moved and
rotated, each filled with a gradient of its own, about half drawn as an
SVG clip-path. The scene is the particles at one instant, in creation
order. A particle has a box of side `size_px` (uniform), a centre
uniform over the stage and an angle uniform in [0, 2 pi); its transform
R maps the unit box [0, 1]^2 onto that box, turned about its centre.

A plain particle is one nonzero fill of its suit's outline (`OUTLINES`,
closed paths of cubics and lines in the unit box) under R. A clip-path
particle (`clip_path_share` of them) pushes a pure clip layer of the
suit's outline, already mapped into stage coordinates by R, fills the
unit square under R, and pops the layer. Either way the brush is the
particle's own gradient in the unit box: linear from the box's left edge
to its right edge (SVG's `objectBoundingBox` default), or radial,
centred, with a radius of half the box; 2 to 4 stops (`stops`), the
first at offset 0 and the last at 1.

Two random streams: the configuration's `shape_seed` draws each
particle's suit, size, centre, angle, clip-path choice, gradient kind and
stop count, so that every seed renders the same geometry and settles the
same capacity class; the run's seed draws the inner stop offsets and the
stops' colors.
"""

from __future__ import annotations

import math

import numpy as np

# A circle's cubic control distance for a quarter turn.
KAPPA = 4.0 * (math.sqrt(2.0) - 1.0) / 3.0


def _circle(cx, cy, r):
    """A closed circle of four cubics, turning the same way as the stems."""
    k = KAPPA * r
    return [("M", cx + r, cy),
            ("C", cx + r, cy + k, cx + k, cy + r, cx, cy + r),
            ("C", cx - k, cy + r, cx - r, cy + k, cx - r, cy),
            ("C", cx - r, cy - k, cx - k, cy - r, cx, cy - r),
            ("C", cx + k, cy - r, cx + r, cy - k, cx + r, cy), ("Z",)]


# The suit outlines in the unit box (y down), each a closed path.
OUTLINES = {
    "heart": [("M", 0.5, 0.28),
              ("C", 0.42, 0.04, 0.0, 0.04, 0.02, 0.35),
              ("C", 0.04, 0.6, 0.35, 0.76, 0.5, 0.97),
              ("C", 0.65, 0.76, 0.96, 0.6, 0.98, 0.35),
              ("C", 1.0, 0.04, 0.58, 0.04, 0.5, 0.28), ("Z",)],
    "spade": [("M", 0.5, 0.02),
              ("C", 0.35, 0.22, 0.02, 0.38, 0.04, 0.6),
              ("C", 0.06, 0.82, 0.38, 0.86, 0.47, 0.68),
              ("L", 0.38, 0.98), ("L", 0.62, 0.98), ("L", 0.53, 0.68),
              ("C", 0.62, 0.86, 0.94, 0.82, 0.96, 0.6),
              ("C", 0.98, 0.38, 0.65, 0.22, 0.5, 0.02), ("Z",)],
    "club": (_circle(0.5, 0.29, 0.23) + _circle(0.29, 0.55, 0.23) + _circle(0.71, 0.55, 0.23)
             + [("M", 0.5, 0.45), ("L", 0.62, 0.98), ("L", 0.38, 0.98), ("Z",)]),
    "diamond": [("M", 0.5, 0.02), ("L", 0.86, 0.5), ("L", 0.5, 0.98), ("L", 0.14, 0.5),
                ("Z",)],
}
SQUARE = [("M", 0.0, 0.0), ("L", 1.0, 0.0), ("L", 1.0, 1.0), ("L", 0.0, 1.0), ("Z",)]


def particles(cfg: dict) -> dict:
    """The seed-independent part of the scene, from `shape_seed`, one
    entry a particle: `suit` (an index into `suits`), `size` (px),
    `centre` [n, 2], `angle`, `clip` (drawn as a clip-path), `kind` (an
    index into `gradient_kinds`) and `n_stops`."""
    shape = np.random.default_rng(cfg["shape_seed"])
    n = cfg["n_particles"]
    lo, hi = cfg["size_px"]
    s_lo, s_hi = cfg["stops"]
    return {
        "suit": shape.integers(0, len(cfg["suits"]), n),
        "size": lo + (hi - lo) * shape.random(n),
        "centre": shape.random((n, 2)) * np.asarray([cfg["width"], cfg["height"]], float),
        "angle": 2.0 * math.pi * shape.random(n),
        "clip": shape.random(n) < cfg["clip_path_share"],
        "kind": shape.integers(0, len(cfg["gradient_kinds"]), n),
        "n_stops": shape.integers(s_lo, s_hi + 1, n),
    }


def transform(size, centre, angle):
    """The affine coefficients (xx, yx, xy, yy, x0, y0) mapping the unit
    box onto a particle's box: scaled by `size`, turned by `angle` about
    the box's centre, the centre at `centre`."""
    c, s = size * math.cos(angle), size * math.sin(angle)
    return (c, s, -s, c, centre[0] - 0.5 * (c - s), centre[1] - 0.5 * (s + c))


def mapped(path, xf):
    """`path` with its points mapped by the affine `xf`."""
    a, b, c, d, e, f = xf
    out = []
    for el in path:
        pts = el[1:]
        out.append((el[0],) + tuple(v for x, y in zip(pts[0::2], pts[1::2])
                                    for v in (a * x + c * y + e, b * x + d * y + f)))
    return out


def commands(cfg: dict, seed: int) -> dict:
    """The scene of `cfg` (this configuration's JSON) for the run's seed."""
    p = particles(cfg)
    place = np.random.default_rng(seed)
    kinds = cfg["gradient_kinds"]
    draws = []
    for k in range(cfg["n_particles"]):
        n = int(p["n_stops"][k])
        offsets = [0.0] + sorted(place.random(n - 2).tolist()) + [1.0]
        colors = place.random((n, 3)).tolist()
        stops = tuple((off, (r, g, b, 1.0)) for off, (r, g, b) in zip(offsets, colors))
        if kinds[p["kind"][k]] == "linear":
            brush = ("linear", (0.0, 0.5), (1.0, 0.5), stops)
        else:
            brush = ("radial", (0.5, 0.5), 0.5, stops)
        xf = transform(float(p["size"][k]), p["centre"][k].tolist(), float(p["angle"][k]))
        outline = OUTLINES[cfg["suits"][p["suit"][k]]]
        if p["clip"][k]:
            draws.append(("push", "clip", 1.0, mapped(outline, xf)))
            draws.append(("fill", "nonzero", xf, brush, SQUARE))
            draws.append(("pop",))
        else:
            draws.append(("fill", "nonzero", xf, brush, outline))
    return {"width": cfg["width"], "height": cfg["height"],
            "base_color": tuple(cfg["base_color"]), "antialiasing": cfg["antialiasing"],
            "images": [], "draws": draws}
