"""clip_layers: the draw commands of the nested-clip, blend-mode scene at
1080p.

A frozen copy of the program's `scenes.py::config4` generator, made into
a list of draw commands (`portbench.commands`). The configuration's
`shape_seed` draws the stacks (centre, radius, depth, blend modes, the
blobs and their offsets); the run's seed draws the order the stacks are
drawn in, their alphas, the colors and the gradient's stops. So every
seed renders the same set of stacks, which overlap differently: the same
tiles, records and clip depths, in another order.
"""

from __future__ import annotations

import math

import numpy as np

# 4/3 * tan(pi/8): a circle as four cubic arcs (kurbo's constant).
_K = 0.5519150244935105707435627


def _circle(cx, cy, r):
    k = _K
    return [("M", cx + r, cy),
            ("C", cx + r, cy + r * k, cx + r * k, cy + r, cx, cy + r),
            ("C", cx - r * k, cy + r, cx - r, cy + r * k, cx - r, cy),
            ("C", cx - r, cy - r * k, cx - r * k, cy - r, cx, cy - r),
            ("C", cx + r * k, cy - r, cx + r, cy - r * k, cx + r, cy),
            ("Z",)]


def _blob(shape, cx, cy, r, n_segs):
    """A closed blob of n_segs cubic segments around (cx, cy)."""
    angles = np.linspace(0, 2 * math.pi, n_segs, endpoint=False)
    radii = r * (0.6 + 0.8 * shape.random(n_segs))
    pts = [(cx + rr * math.cos(a), cy + rr * math.sin(a)) for a, rr in zip(angles, radii)]
    path = [("M", *pts[0])]
    for i in range(n_segs):
        a, b = pts[i], pts[(i + 1) % n_segs]
        path.append(("C",
                     a[0] + (b[0] - a[0]) / 3 + shape.normal(0, r * 0.2),
                     a[1] + (b[1] - a[1]) / 3 + shape.normal(0, r * 0.2),
                     a[0] + 2 * (b[0] - a[0]) / 3 + shape.normal(0, r * 0.2),
                     a[1] + 2 * (b[1] - a[1]) / 3 + shape.normal(0, r * 0.2),
                     b[0], b[1]))
    path.append(("Z",))
    return path


def commands(cfg: dict, seed: int) -> dict:
    """The scene of `cfg` (this configuration's JSON) for the run's seed."""
    shape = np.random.default_rng(cfg["shape_seed"])
    place = np.random.default_rng(seed)
    W, H = cfg["width"], cfg["height"]
    d_lo, d_hi = cfg["stack_depth"]
    r_lo, r_hi = cfg["clip_radius_px"]
    mixes = cfg["mixes"]

    full = [("M", 0, 0), ("L", W, 0), ("L", W, H), ("L", 0, H), ("Z",)]
    stacks = []
    for _ in range(cfg["n_stacks"]):
        cx, cy = shape.random() * W, shape.random() * H
        r = r_lo + (r_hi - r_lo) * shape.random()
        depth = int(shape.integers(d_lo, d_hi + 1))
        clips = [(mixes[int(shape.integers(0, len(mixes)))], _circle(cx, cy, r * (1 - 0.2 * d)))
                 for d in range(depth)]
        blobs = [_blob(shape, cx + shape.normal(0, r), cy + shape.normal(0, r), r * 0.5,
                       cfg["blob_segments"]) for _ in range(cfg["fills_per_stack"])]
        stacks.append((clips, blobs))

    stops = tuple((off, (place.random(), place.random(), place.random(), 1.0))
                  for off in (0.0, 0.5, 1.0))
    draws = [("fill", "nonzero", None, ("linear", (0.0, H / 2), (W, H / 2), stops), full)]
    for k in place.permutation(len(stacks)):
        clips, blobs = stacks[k]
        for mix, clip in clips:
            draws.append(("push", mix, float(0.5 + 0.5 * place.random()), clip))
        for blob in blobs:
            color = (place.random(), place.random(), place.random(), 0.3 + 0.7 * place.random())
            draws.append(("fill", "nonzero", None, ("solid", color), blob))
        draws += [("pop",)] * len(clips)
    return {"width": W, "height": H, "base_color": tuple(cfg["base_color"]),
            "antialiasing": cfg["antialiasing"], "images": [], "draws": draws}
