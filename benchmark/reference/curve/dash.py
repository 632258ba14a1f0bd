"""CPU dashing of Bézier paths.

The reference does not support dashing on the GPU; dashed strokes are
expanded on the host via the kurbo Dash iterator (scene.go:156-178).
This module provides the equivalent: given a path and a dash pattern,
produce a new path consisting of the "on" dashes only, each emitted as
an open subpath, which is then stroked normally.

Arc-length evaluation uses adaptive Gauss-Legendre quadrature and
t-at-arclength inversion uses bisection; results are behaviorally
equivalent to (though not bit-identical with) the kurbo implementation.

Closed-subpath seam handling matches kurbo's Dash iterator: when the
subpath joint falls inside an "on" dash, the final dash is merged with
the initial one (one continuous dash across the seam — a join, not two
butt caps); a fully-"on" closed subpath stays closed (joins everywhere,
no caps).
"""

from __future__ import annotations

import math

from . import BezPath, ElKind, PathEl, Point, MoveTo, LineTo, QuadTo, CubicTo

# 8-point Gauss-Legendre nodes/weights on [0, 1].
_GL_X = [
    0.01985507175123188,
    0.10166676129318664,
    0.2372337950418355,
    0.40828267875217505,
    0.5917173212478249,
    0.7627662049581645,
    0.8983332387068134,
    0.9801449282487681,
]
_GL_W = [
    0.05061426814518813,
    0.11119051722668723,
    0.15685332293894372,
    0.18134189168918097,
    0.18134189168918097,
    0.15685332293894372,
    0.11119051722668723,
    0.05061426814518813,
]


class _Seg:
    """A cubic segment (lines/quads degree-raised) with arclength helpers."""

    __slots__ = ("p0", "p1", "p2", "p3", "kind")

    def __init__(self, kind: ElKind, p0: Point, pts: tuple):
        self.kind = kind
        if kind == ElKind.LINE_TO:
            p3 = pts[0]
            self.p0, self.p3 = p0, p3
            self.p1 = p0.lerp(p3, 1 / 3)
            self.p2 = p0.lerp(p3, 2 / 3)
        elif kind == ElKind.QUAD_TO:
            p1, p3 = pts
            self.p0, self.p3 = p0, p3
            self.p1 = p0.lerp(p1, 2 / 3)
            self.p2 = p3.lerp(p1, 2 / 3)
        else:
            self.p0, self.p1, self.p2, self.p3 = p0, pts[0], pts[1], pts[2]

    def deriv(self, t: float) -> Point:
        mt = 1.0 - t
        d = (
            (self.p1 - self.p0) * (3 * mt * mt)
            + (self.p2 - self.p1) * (6 * mt * t)
            + (self.p3 - self.p2) * (3 * t * t)
        )
        return d

    def point(self, t: float) -> Point:
        mt = 1.0 - t
        return (
            self.p0 * (mt * mt * mt)
            + self.p1 * (3 * mt * mt * t)
            + self.p2 * (3 * mt * t * t)
            + self.p3 * (t * t * t)
        )

    def arclen(self, t0: float = 0.0, t1: float = 1.0, depth: int = 4) -> float:
        span = t1 - t0
        est = sum(w * self.deriv(t0 + x * span).hypot() for x, w in zip(_GL_X, _GL_W)) * span
        if depth == 0:
            return est
        tm = 0.5 * (t0 + t1)
        left = sum(w * self.deriv(t0 + x * (tm - t0)).hypot() for x, w in zip(_GL_X, _GL_W)) * (tm - t0)
        right = sum(w * self.deriv(tm + x * (t1 - tm)).hypot() for x, w in zip(_GL_X, _GL_W)) * (t1 - tm)
        if abs(left + right - est) < 1e-9 * max(1.0, est):
            return left + right
        return self.arclen(t0, tm, depth - 1) + self.arclen(tm, t1, depth - 1)

    def t_at_arclen(self, s: float, t0: float = 0.0) -> float:
        """Find t >= t0 such that arclen(t0, t) == s (bisection)."""
        lo, hi = t0, 1.0
        for _ in range(40):
            mid = 0.5 * (lo + hi)
            if self.arclen(t0, mid) < s:
                lo = mid
            else:
                hi = mid
        return 0.5 * (lo + hi)

    def subsegment(self, t0: float, t1: float):
        """De Casteljau subdivision: the cubic restricted to [t0, t1]."""
        # Reparametrize via blossoming.
        def split(p0, p1, p2, p3, t):
            q0 = p0.lerp(p1, t)
            q1 = p1.lerp(p2, t)
            q2 = p2.lerp(p3, t)
            r0 = q0.lerp(q1, t)
            r1 = q1.lerp(q2, t)
            s = r0.lerp(r1, t)
            return (p0, q0, r0, s), (s, r1, q2, p3)

        _, right = split(self.p0, self.p1, self.p2, self.p3, t0)
        if t0 >= 1.0:
            u = 0.0
        else:
            u = (t1 - t0) / (1.0 - t0)
        left, _ = split(*right, u)
        return left


def _subpaths(path: BezPath):
    """Split a path into subpaths: lists of (_Seg), plus closed flag."""
    start: Point | None = None
    cur: Point | None = None
    segs: list[_Seg] = []
    for el in path:
        if el.kind == ElKind.MOVE_TO:
            if segs:
                yield segs, False
            segs = []
            start = cur = el.points[0]
        elif el.kind == ElKind.CLOSE_PATH:
            if cur is not None and start is not None:
                if cur.x != start.x or cur.y != start.y:
                    segs.append(_Seg(ElKind.LINE_TO, cur, (start,)))
                cur = start
            if segs:
                yield segs, True
            segs = []
        else:
            if cur is None:
                cur = el.points[-1]
                start = cur
                continue
            segs.append(_Seg(el.kind, cur, el.points))
            cur = el.points[-1]
    if segs:
        yield segs, False


def _emit_cubic(dash_els: list, pts, first: bool):
    if first:
        dash_els.append(MoveTo(pts[0]))
    dash_els.append(CubicTo(pts[1], pts[2], pts[3]))


def dash(path: BezPath, dash_offset: float, dash_pattern) -> BezPath:
    """Return the dashed version of `path` as a new path of open
    subpaths (except fully-on closed subpaths, which stay closed)."""
    from . import ClosePath

    pattern = [float(d) for d in dash_pattern if d >= 0.0]
    if not pattern or all(d == 0.0 for d in pattern):
        return BezPath(list(path))
    # Odd-length patterns repeat doubled (SVG semantics).
    if len(pattern) % 2 == 1:
        pattern = pattern + pattern

    total = sum(pattern)
    out = BezPath()

    for segs, closed in _subpaths(path):
        # Initialize pattern state from dash_offset.
        off = math.fmod(dash_offset, total)
        if off < 0:
            off += total
        idx = 0
        while off >= pattern[idx]:
            off -= pattern[idx]
            idx = (idx + 1) % len(pattern)
        remaining = pattern[idx] - off
        is_on = idx % 2 == 0
        pen_down = False
        started_on = is_on

        # Dashes are buffered per subpath so the closed-seam merge can
        # run before emission (kurbo Dash semantics).
        dashes: list[list] = []
        cur: list = []
        lifted = False

        def flush():
            nonlocal cur
            if cur:
                dashes.append(cur)
                cur = []

        for seg in segs:
            t = 0.0
            seg_len = seg.arclen()
            used = 0.0
            while used + remaining < seg_len - 1e-12:
                t_next = seg.t_at_arclen(remaining, t)
                if is_on:
                    _emit_cubic(cur, seg.subsegment(t, t_next), not pen_down)
                    pen_down = True
                used += remaining
                t = t_next
                idx = (idx + 1) % len(pattern)
                remaining = pattern[idx]
                is_on = not is_on
                if is_on:
                    flush()
                    pen_down = False
                else:
                    lifted = True
            # Tail of the segment stays in the current dash/gap.
            if is_on and t < 1.0:
                _emit_cubic(cur, seg.subsegment(t, 1.0), not pen_down)
                pen_down = True
            remaining -= seg_len - used
        ended_on = is_on and pen_down
        flush()

        if closed and started_on and ended_on and dashes:
            if not lifted and len(dashes) == 1:
                # The whole loop is one dash: keep it closed (joins
                # everywhere, no caps).
                dashes[0].append(ClosePath())
            elif len(dashes) >= 2:
                # Merge the seam-crossing final dash into the initial
                # one: last dash continues into the first (skip its
                # MoveTo).
                first_dash = dashes.pop(0)
                dashes[-1].extend(first_dash[1:])

        for d in dashes:
            for el in d:
                out.push(el)

    return out
