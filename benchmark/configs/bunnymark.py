"""bunnymark: the draw commands of PixiJS's bunny-mark, after Iain Lobb's
BunnyMark.

Transparent sprites bounce under gravity on a white stage. Each frame of
the source adds `add_per_frame` bunnies at the top-left corner until
`n_sprites` are in, and moves every bunny one step: the position takes the
speed, the vertical speed takes `gravity`, a side wall flips the
horizontal speed, the floor multiplies the vertical speed by `bounce` and,
with probability `kick_p`, takes up to `kick_max` more off it, the ceiling
stops it. Every position is clamped to the stage [0, W] x [0, H]. After
the last bunny is in, `settle_frames` more steps run, and the scene is the
state then: each bunny, in creation order, one image fill of its
texture's rectangle with the anchor (bottom centre) at its position.

Two random streams: the configuration's `shape_seed` draws the physics
(entry speeds, the floor's kicks), so that every seed renders the same
rectangles and settles the same capacity class; the run's seed draws the
five textures' pixels (a bunny silhouette each, straight alpha with
antialiased edges, on a transparent ground) and each bunny's texture.
"""

from __future__ import annotations

import numpy as np


def positions(cfg: dict) -> np.ndarray:
    """[n_sprites, 2] float64 anchor positions, in creation order, after
    the bunnies were added and `settle_frames` more steps ran."""
    shape = np.random.default_rng(cfg["shape_seed"])
    n, add = cfg["n_sprites"], cfg["add_per_frame"]
    W, H = float(cfg["width"]), float(cfg["height"])
    ph = cfg["physics"]
    pos = np.zeros((n, 2))
    vel = np.zeros((n, 2))
    live = 0
    steps = -(-n // add) + cfg["settle_frames"]
    for _ in range(steps):
        if live < n:
            k = min(add, n - live)
            vel[live:live + k, 0] = shape.random(k) * ph["speed_x_max"]
            vel[live:live + k, 1] = (shape.random(k) - 0.5) * 2.0 * ph["speed_y_max"]
            live += k
        p, v = pos[:live], vel[:live]
        p += v
        v[:, 1] += ph["gravity"]
        wall = (p[:, 0] > W) | (p[:, 0] < 0.0)
        v[wall, 0] *= -1.0
        np.clip(p[:, 0], 0.0, W, out=p[:, 0])
        floor = np.flatnonzero(p[:, 1] > H)
        kick, lift = shape.random((2, len(floor)))
        v[floor, 1] *= -ph["bounce"]
        v[floor, 1] -= np.where(kick < ph["kick_p"], lift * ph["kick_max"], 0.0)
        p[floor, 1] = H
        ceiling = p[:, 1] < 0.0
        v[ceiling, 1] = 0.0
        p[ceiling, 1] = 0.0
    return pos


def texture(cfg: dict, place) -> np.ndarray:
    """A bunny silhouette, u8 [h, w, 4] straight alpha: head, body and two
    ears (ellipses whose sizes `place` jitters), coverage from 4 x 4
    samples a pixel, a fur color with a darker belly, two dark eyes."""
    w, h = cfg["sprite_px"]
    ss = 4
    ys, xs = np.mgrid[0:h * ss, 0:w * ss]
    x = (xs + 0.5) / ss
    y = (ys + 0.5) / ss

    def ellipse(cx, cy, rx, ry, tilt=0.0):
        c, s = np.cos(tilt), np.sin(tilt)
        u, v = (x - cx) * c + (y - cy) * s, -(x - cx) * s + (y - cy) * c
        return (u / rx) ** 2 + (v / ry) ** 2 <= 1.0

    j = 1.0 + 0.08 * (place.random(6) - 0.5)
    cx = w / 2.0
    body = ellipse(cx, h * 0.72, w * 0.40 * j[0], h * 0.26 * j[1])
    head = ellipse(cx, h * 0.40, w * 0.30 * j[2], h * 0.17 * j[3])
    ears = (ellipse(cx - w * 0.15, h * 0.17, w * 0.09, h * 0.16 * j[4], -0.25)
            | ellipse(cx + w * 0.15, h * 0.17, w * 0.09, h * 0.16 * j[5], 0.25))
    eyes = (ellipse(cx - w * 0.12, h * 0.38, 1.2, 1.4) | ellipse(cx + w * 0.12, h * 0.38, 1.2, 1.4))
    inside = body | head | ears

    def down(mask):
        return mask.reshape(h, ss, w, ss).mean(axis=(1, 3))

    alpha = down(inside)
    fur = 0.55 + 0.45 * place.random(3)
    belly = fur * 0.8
    rgb = np.where(down(body & ~head)[..., None] > 0.5, belly, fur)
    eye = down(eyes & inside)[..., None]
    rgb = rgb * (1.0 - eye) + 0.1 * eye
    out = np.concatenate([rgb, alpha[..., None]], axis=-1)
    return np.round(out * 255.0).astype(np.uint8)


def commands(cfg: dict, seed: int) -> dict:
    """The scene of `cfg` (this configuration's JSON) for the run's seed."""
    pos = positions(cfg)
    place = np.random.default_rng(seed)
    images = [texture(cfg, place) for _ in range(cfg["textures"])]
    which = place.integers(0, cfg["textures"], len(pos))
    w, h = cfg["sprite_px"]
    rect = [("M", 0.0, 0.0), ("L", float(w), 0.0), ("L", float(w), float(h)),
            ("L", 0.0, float(h)), ("Z",)]
    draws = [("fill", "nonzero", (1.0, 0.0, 0.0, 1.0, x - w / 2.0, y - h), ("image", int(k)),
              rect) for (x, y), k in zip(pos.tolist(), which.tolist())]
    return {"width": cfg["width"], "height": cfg["height"],
            "base_color": tuple(cfg["base_color"]), "antialiasing": cfg["antialiasing"],
            "images": images, "draws": draws}
