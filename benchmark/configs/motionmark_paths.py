"""motionmark_paths: the draw commands of MotionMark's Paths test.

A walk on an 80 x 40 grid, stroked as line, quadratic and cubic segments
of random widths, cut into new paths at random, with bevel joins and butt
caps. Grid point (i, j) sits at ((i + 0.5) W / 81, (j + 0.5) H / 41).
The walk starts at the configuration's `start`; each step adds one of the
four `offsets`, drawn uniformly, and an axis on which the step would leave
[0, 80] x [0, 40] takes the offset's negation instead. An element is one
of `kinds`, drawn uniformly: a line takes one step (its end), a quadratic
two (control, end) and is elevated exactly to a cubic, a cubic three (two
controls, end). Each element draws a width 1 + 20 u^5 and a split u' >
`split_above`: a split element strokes the path so far and starts a new
one at the previous end, with the split element's width and color (the
first element starts the first path).

Two random streams: the configuration's `shape_seed` draws the walk, the
kinds, the widths and the splits, so that every seed renders the same
strokes and settles the same capacity class; the run's seed draws each
element's color, one of the three greys or, a quarter of the time, one of
the three accents.
"""

from __future__ import annotations

import numpy as np

# Grid steps an element of each kind takes.
STEPS = {"line": 1, "quad": 2, "cubic": 3}


def _rgba(hex_color):
    v = int(hex_color.lstrip("#"), 16)
    return ((v >> 16 & 255) / 255.0, (v >> 8 & 255) / 255.0, (v & 255) / 255.0, 1.0)


def walk(cfg: dict, n_steps: int, shape) -> np.ndarray:
    """[n_steps + 1, 2] grid points of the walk from `start`, the offsets
    drawn from `shape`."""
    offsets = np.asarray(cfg["offsets"], dtype=np.int64)
    picks = offsets[shape.integers(0, len(offsets), n_steps)]
    hi = cfg["grid"]
    pts = np.empty((n_steps + 1, 2), dtype=np.int64)
    x, y = cfg["start"]
    pts[0] = x, y
    for k, (dx, dy) in enumerate(picks.tolist()):
        x = x + dx if 0 <= x + dx <= hi[0] else x - dx
        y = y + dy if 0 <= y + dy <= hi[1] else y - dy
        pts[k + 1] = x, y
    return pts


def elements(cfg: dict) -> dict:
    """The seed-independent part of the scene, from `shape_seed`: each
    element's kind, its grid points (the walk, start included) and the
    index of its last point, its width and its split."""
    shape = np.random.default_rng(cfg["shape_seed"])
    n = cfg["n_elements"]
    kinds = np.asarray(cfg["kinds"])[shape.integers(0, len(cfg["kinds"]), n)]
    steps = np.asarray([STEPS[k] for k in kinds.tolist()], dtype=np.int64)
    ends = np.cumsum(steps)
    pts = walk(cfg, int(ends[-1]) if n else 0, shape)
    w = cfg["width_px"]
    widths = w["base"] + w["scale"] * shape.random(n) ** w["power"]
    splits = shape.random(n) > cfg["split_above"]
    return {"kinds": kinds, "points": pts, "ends": ends, "widths": widths, "splits": splits}


def commands(cfg: dict, seed: int) -> dict:
    """The scene of `cfg` (this configuration's JSON) for the run's seed."""
    el = elements(cfg)
    place = np.random.default_rng(seed)
    n = cfg["n_elements"]
    palette = [_rgba(c) for c in cfg["colors"] if c != "accent"]
    accents = [_rgba(c) for c in cfg["accents"]]
    picks = place.integers(0, len(cfg["colors"]), n)
    accent = place.integers(0, len(accents), n)
    W, H = cfg["width"], cfg["height"]
    gx, gy = W / (cfg["grid"][0] + 1), H / (cfg["grid"][1] + 1)
    xy = [((i + 0.5) * gx, (j + 0.5) * gy) for i, j in el["points"].tolist()]
    style = {"join": cfg["join"], "cap": cfg["cap"]}

    draws = []
    path, brush = None, None
    for k in range(n):
        end = int(el["ends"][k])
        start = end - STEPS[el["kinds"][k]]
        if path is None or el["splits"][k]:
            if path is not None:
                draws.append(("stroke", stroke, None, brush, path))
            color = palette[picks[k]] if picks[k] < len(palette) else accents[accent[k]]
            path, brush = [("M", *xy[start])], ("solid", color)
            stroke = dict(style, width=float(el["widths"][k]))
        kind = el["kinds"][k]
        if kind == "line":
            path.append(("L", *xy[end]))
        elif kind == "quad":
            (x0, y0), (x1, y1), (x2, y2) = xy[start:end + 1]
            path.append(("C", x0 + 2.0 / 3.0 * (x1 - x0), y0 + 2.0 / 3.0 * (y1 - y0),
                         x2 + 2.0 / 3.0 * (x1 - x2), y2 + 2.0 / 3.0 * (y1 - y2), x2, y2))
        else:
            path.append(("C", *xy[start + 1], *xy[start + 2], *xy[end]))
    if path is not None:
        draws.append(("stroke", stroke, None, brush, path))
    return {"width": W, "height": H, "base_color": tuple(cfg["base_color"]),
            "antialiasing": cfg["antialiasing"], "images": [], "draws": draws}
