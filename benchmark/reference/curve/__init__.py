"""Bézier path geometry (the slice of honnef.co/go/curve the renderer uses).

The reference depends on an external kurbo port for paths, affine
transforms, stroke styles and CPU dashing (see scene.go:11,156-178).
This module provides the equivalent surface, numpy-based.

Affine layout follows kurbo: coefficients (xx, yx, xy, yy, x0, y0) with
  x' = xx*x + xy*y + x0
  y' = yx*x + yy*y + y0
which is also the flat 6-float layout of the encoded transform stream
(reference: jmath.Transform / shaders' transform_read).
"""

from __future__ import annotations

import enum
import math
from dataclasses import dataclass, field, replace

import numpy as np


@dataclass(frozen=True)
class Point:
    x: float = 0.0
    y: float = 0.0

    def __iter__(self):
        yield self.x
        yield self.y

    def __getitem__(self, i: int) -> float:
        return (self.x, self.y)[i]

    def __add__(self, o: "Point") -> "Point":
        return Point(self.x + o.x, self.y + o.y)

    def __sub__(self, o: "Point") -> "Point":
        return Point(self.x - o.x, self.y - o.y)

    def __mul__(self, s: float) -> "Point":
        return Point(self.x * s, self.y * s)

    __rmul__ = __mul__

    def lerp(self, o: "Point", t: float) -> "Point":
        return Point(self.x + (o.x - self.x) * t, self.y + (o.y - self.y) * t)

    def hypot(self) -> float:
        return math.hypot(self.x, self.y)


def Pt(x: float, y: float) -> Point:
    return Point(float(x), float(y))


@dataclass(frozen=True)
class Affine:
    """2D affine transform, kurbo coefficient order (xx, yx, xy, yy, x0, y0)."""

    coeffs: tuple = (1.0, 0.0, 0.0, 1.0, 0.0, 0.0)

    @staticmethod
    def identity() -> "Affine":
        return Affine()

    @staticmethod
    def translate(x: float, y: float) -> "Affine":
        return Affine((1.0, 0.0, 0.0, 1.0, float(x), float(y)))

    @staticmethod
    def scale(sx: float, sy: float | None = None) -> "Affine":
        if sy is None:
            sy = sx
        return Affine((float(sx), 0.0, 0.0, float(sy), 0.0, 0.0))

    @staticmethod
    def rotate(theta: float) -> "Affine":
        c, s = math.cos(theta), math.sin(theta)
        return Affine((c, s, -s, c, 0.0, 0.0))

    @staticmethod
    def rotate_about(theta: float, center: Point) -> "Affine":
        return (
            Affine.translate(center.x, center.y)
            @ Affine.rotate(theta)
            @ Affine.translate(-center.x, -center.y)
        )

    def __matmul__(self, other: "Affine") -> "Affine":
        """self * other: apply `other` first, then `self`."""
        a = self.coeffs
        b = other.coeffs
        return Affine(
            (
                a[0] * b[0] + a[2] * b[1],
                a[1] * b[0] + a[3] * b[1],
                a[0] * b[2] + a[2] * b[3],
                a[1] * b[2] + a[3] * b[3],
                a[0] * b[4] + a[2] * b[5] + a[4],
                a[1] * b[4] + a[3] * b[5] + a[5],
            )
        )

    def apply(self, p: Point) -> Point:
        c = self.coeffs
        return Point(c[0] * p.x + c[2] * p.y + c[4], c[1] * p.x + c[3] * p.y + c[5])

    def as_f32(self) -> np.ndarray:
        return np.array(self.coeffs, dtype=np.float32)


IDENTITY = Affine.identity()


class ElKind(enum.IntEnum):
    MOVE_TO = 0
    LINE_TO = 1
    QUAD_TO = 2
    CUBIC_TO = 3
    CLOSE_PATH = 4


@dataclass(frozen=True)
class PathEl:
    kind: ElKind
    # Up to 3 points, meaning depends on kind.
    points: tuple = ()


def MoveTo(p: Point) -> PathEl:
    return PathEl(ElKind.MOVE_TO, (p,))


def LineTo(p: Point) -> PathEl:
    return PathEl(ElKind.LINE_TO, (p,))


def QuadTo(p1: Point, p2: Point) -> PathEl:
    return PathEl(ElKind.QUAD_TO, (p1, p2))


def CubicTo(p1: Point, p2: Point, p3: Point) -> PathEl:
    return PathEl(ElKind.CUBIC_TO, (p1, p2, p3))


def ClosePath() -> PathEl:
    return PathEl(ElKind.CLOSE_PATH, ())


class BezPath:
    """A sequence of path elements with a builder API."""

    def __init__(self, elements=()):
        self.elements: list[PathEl] = list(elements)

    # -- builder ---------------------------------------------------------
    def move_to(self, x: float, y: float) -> "BezPath":
        self.elements.append(MoveTo(Pt(x, y)))
        return self

    def line_to(self, x: float, y: float) -> "BezPath":
        self.elements.append(LineTo(Pt(x, y)))
        return self

    def quad_to(self, x1, y1, x2, y2) -> "BezPath":
        self.elements.append(QuadTo(Pt(x1, y1), Pt(x2, y2)))
        return self

    def cubic_to(self, x1, y1, x2, y2, x3, y3) -> "BezPath":
        self.elements.append(CubicTo(Pt(x1, y1), Pt(x2, y2), Pt(x3, y3)))
        return self

    def close(self) -> "BezPath":
        self.elements.append(ClosePath())
        return self

    def push(self, el: PathEl) -> "BezPath":
        self.elements.append(el)
        return self

    # -- protocol --------------------------------------------------------
    def __iter__(self):
        return iter(self.elements)

    def __len__(self):
        return len(self.elements)

    def __bool__(self):
        return True

    def transformed(self, affine: Affine) -> "BezPath":
        out = BezPath()
        for el in self.elements:
            out.push(PathEl(el.kind, tuple(affine.apply(p) for p in el.points)))
        return out


@dataclass(frozen=True)
class Rect:
    x0: float = 0.0
    y0: float = 0.0
    x1: float = 0.0
    y1: float = 0.0

    def path_elements(self, tolerance: float = 0.1) -> BezPath:
        return BezPath(
            [
                MoveTo(Pt(self.x0, self.y0)),
                LineTo(Pt(self.x1, self.y0)),
                LineTo(Pt(self.x1, self.y1)),
                LineTo(Pt(self.x0, self.y1)),
                ClosePath(),
            ]
        )


def circle(cx: float, cy: float, r: float) -> BezPath:
    """A circle approximated by 4 cubic Béziers (kurbo's constant)."""
    k = 0.5519150244935105707435627  # 4/3 * tan(pi/8)
    p = BezPath()
    p.move_to(cx + r, cy)
    p.cubic_to(cx + r, cy + r * k, cx + r * k, cy + r, cx, cy + r)
    p.cubic_to(cx - r * k, cy + r, cx - r, cy + r * k, cx - r, cy)
    p.cubic_to(cx - r, cy - r * k, cx - r * k, cy - r, cx, cy - r)
    p.cubic_to(cx + r * k, cy - r, cx + r, cy - r * k, cx + r, cy)
    p.close()
    return p


class Cap(enum.IntEnum):
    BUTT = 0
    SQUARE = 1
    ROUND = 2


class Join(enum.IntEnum):
    BEVEL = 0
    MITER = 1
    ROUND = 2


@dataclass(frozen=True)
class Stroke:
    """Stroke style (the slice of kurbo::Stroke the reference encodes)."""

    width: float = 1.0
    miter_limit: float = 4.0
    join: Join = Join.ROUND
    start_cap: Cap = Cap.ROUND
    end_cap: Cap = Cap.ROUND
    dash_pattern: tuple = ()
    dash_offset: float = 0.0

    def with_caps(self, cap: Cap) -> "Stroke":
        return replace(self, start_cap=cap, end_cap=cap)


from .dash import dash  # noqa: E402  (re-export, depends on types above)

__all__ = [
    "Point",
    "Pt",
    "Affine",
    "IDENTITY",
    "ElKind",
    "PathEl",
    "MoveTo",
    "LineTo",
    "QuadTo",
    "CubicTo",
    "ClosePath",
    "BezPath",
    "Rect",
    "circle",
    "Cap",
    "Join",
    "Stroke",
    "dash",
]
