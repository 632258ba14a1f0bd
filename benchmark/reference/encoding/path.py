"""Path tag/data stream encoding (reference: encoding/path.go).

The path encoder is a small state machine that converts path elements
into two parallel streams:
  - tags: one u8 `PathTag` per segment (plus transform/style/path marker
    tags emitted by the Encoding), carrying segment kind, f32/i16 flag
    and subpath-end bit,
  - data: little-endian f32 coordinate pairs.

Semantics replicated exactly from the reference:
  - zero-length segment culling (path.go:234-254, 300-302),
  - kurbo behavior of treating an initial line/quad/cubic as a move
    (path.go:280-287),
  - implicit closing of fills,
  - stroke cap-marker segments that encode the subpath's start tangent
    (path.go:459-482),
  - `EmptyPath` encoding of a degenerate line (path.go:484-489).
"""

from __future__ import annotations

import struct

import numpy as np

from ..curve import BezPath, ElKind, Stroke, Cap, Join
from ..gfx import Fill

EPSILON = 1e-12  # jmath.Epsilon

# PathTag constants (reference: encoding/path.go:130-175)
PATH_TAG_LINE_TO_F32 = 0x9
PATH_TAG_QUAD_TO_F32 = 0xA
PATH_TAG_CUBIC_TO_F32 = 0xB
PATH_TAG_LINE_TO_I16 = 0x1
PATH_TAG_QUAD_TO_I16 = 0x2
PATH_TAG_CUBIC_TO_I16 = 0x3
PATH_TAG_TRANSFORM = 0x20
PATH_TAG_PATH = 0x10
PATH_TAG_STYLE = 0x40
PATH_TAG_SUBPATH_END_BIT = 0x4
PATH_TAG_F32_BIT = 0x8
PATH_TAG_SEG_TYPE_MASK = 0x3

# Style flag bits (reference: encoding/path.go:39-73)
FLAGS_STYLE_BIT = 0x8000_0000
FLAGS_FILL_BIT = 0x4000_0000
FLAGS_JOIN_BITS_BEVEL = 0
FLAGS_JOIN_BITS_MITER = 0x1000_0000
FLAGS_JOIN_BITS_ROUND = 0x2000_0000
FLAGS_JOIN_MASK = 0x3000_0000
FLAGS_CAP_BITS_BUTT = 0
FLAGS_CAP_BITS_SQUARE = 0x0100_0000
FLAGS_CAP_BITS_ROUND = 0x0200_0000
FLAGS_START_CAP_MASK = 0x0C00_0000
FLAGS_END_CAP_MASK = 0x0300_0000
MITER_LIMIT_MASK = 0xFFFF

# Number of u32 words in an encoded Style (flags word + linewidth word).
STYLE_SIZE_WORDS = 2

_JOIN_BITS = {
    Join.BEVEL: FLAGS_JOIN_BITS_BEVEL,
    Join.MITER: FLAGS_JOIN_BITS_MITER,
    Join.ROUND: FLAGS_JOIN_BITS_ROUND,
}
_CAP_BITS = {
    Cap.BUTT: FLAGS_CAP_BITS_BUTT,
    Cap.SQUARE: FLAGS_CAP_BITS_SQUARE,
    Cap.ROUND: FLAGS_CAP_BITS_ROUND,
}


def style_from_fill(fill: Fill) -> tuple[int, float]:
    """(flags_and_miter_limit, line_width) for a fill style."""
    flags = FLAGS_FILL_BIT if fill == Fill.EVEN_ODD else 0
    return (flags, 0.0)


def style_from_stroke(stroke: Stroke) -> tuple[int, float]:
    """(flags_and_miter_limit, line_width) for a stroke style.

    The miter limit is stored as an f16 in the low 16 bits
    (reference: encoding/path.go:115-119)."""
    flags = FLAGS_STYLE_BIT
    flags |= _JOIN_BITS[stroke.join]
    flags |= _CAP_BITS[stroke.start_cap] << 2
    flags |= _CAP_BITS[stroke.end_cap]
    miter = int(np.float16(stroke.miter_limit).view(np.uint16))
    return (flags | miter, float(stroke.width))


_STATE_START = 0
_STATE_MOVE_TO = 1
_STATE_NONEMPTY = 2


class PathEncoder:
    """Stateful tag/data emitter targeting an Encoding's streams."""

    def __init__(self, enc, is_fill: bool):
        self._enc = enc
        self._is_fill = is_fill
        self._first_point = (0.0, 0.0)
        self._first_start_tangent_end = (0.0, 0.0)
        self._state = _STATE_START
        self._n_encoded_segments = 0

    # -- low-level helpers ----------------------------------------------

    def _f32(self, v: float) -> float:
        return float(np.float32(v))

    def _push_pt(self, x: float, y: float):
        self._enc.path_data += struct.pack("<ff", np.float32(x), np.float32(y))

    def _pop_pt(self):
        del self._enc.path_data[-8:]

    def _last_point(self):
        data = self._enc.path_data
        if len(data) < 8:
            return None
        x, y = struct.unpack("<ff", bytes(data[-8:]))
        return (x, y)

    def _is_zero_length_segment(self, p1, p2=None, p3=None) -> bool:
        p0 = self._last_point()
        assert p0 is not None
        p2 = p2 if p2 is not None else p1
        p3 = p3 if p3 is not None else p1
        xs = (p0[0], p1[0], p2[0], p3[0])
        ys = (p0[1], p1[1], p2[1], p3[1])
        return not (
            max(xs) - min(xs) > EPSILON or max(ys) - min(ys) > EPSILON
        )

    def _start_tangent_for_curve(self, p1, p2=None, p3=None):
        p0 = self._first_point
        p2 = p2 if p2 is not None else p0
        p3 = p3 if p3 is not None else p0
        if abs(p1[0] - p0[0]) > EPSILON or abs(p1[1] - p0[1]) > EPSILON:
            return p1
        if abs(p2[0] - p0[0]) > EPSILON or abs(p2[1] - p0[1]) > EPSILON:
            return p2
        if abs(p3[0] - p0[0]) > EPSILON or abs(p3[1] - p0[1]) > EPSILON:
            return p3
        return None

    # -- path element API ------------------------------------------------

    def move_to(self, x: float, y: float):
        x, y = self._f32(x), self._f32(y)
        if self._is_fill:
            self.close()
        if self._state == _STATE_MOVE_TO:
            self._pop_pt()
        elif self._state == _STATE_NONEMPTY:
            if not self._is_fill:
                self._insert_stroke_cap_marker_segment(is_closed=False)
            if self._enc.path_tags:
                self._enc.path_tags[-1] |= PATH_TAG_SUBPATH_END_BIT
        self._first_point = (x, y)
        self._push_pt(x, y)
        self._state = _STATE_MOVE_TO

    def line_to(self, x: float, y: float):
        x, y = self._f32(x), self._f32(y)
        if self._state == _STATE_START:
            if self._n_encoded_segments == 0:
                # Kurbo treats an initial line as a move.
                self.move_to(x, y)
                return
            self.move_to(*self._first_point)
        if self._state == _STATE_MOVE_TO:
            pt = self._start_tangent_for_curve((x, y))
            if pt is None:
                return
            self._first_start_tangent_end = pt
        if self._is_zero_length_segment((x, y)):
            return
        self._push_pt(x, y)
        self._enc.path_tags.append(PATH_TAG_LINE_TO_F32)
        self._state = _STATE_NONEMPTY
        self._n_encoded_segments += 1

    def quad_to(self, x1, y1, x2, y2):
        x1, y1, x2, y2 = map(self._f32, (x1, y1, x2, y2))
        if self._state == _STATE_START:
            if self._n_encoded_segments == 0:
                self.move_to(x2, y2)
                return
            self.move_to(*self._first_point)
        if self._state == _STATE_MOVE_TO:
            pt = self._start_tangent_for_curve((x1, y1), (x2, y2), (0.0, 0.0))
            if pt is None:
                return
            self._first_start_tangent_end = pt
        if self._is_zero_length_segment((x1, y1), (x2, y2)):
            return
        self._push_pt(x1, y1)
        self._push_pt(x2, y2)
        self._enc.path_tags.append(PATH_TAG_QUAD_TO_F32)
        self._state = _STATE_NONEMPTY
        self._n_encoded_segments += 1

    def cubic_to(self, x1, y1, x2, y2, x3, y3):
        x1, y1, x2, y2, x3, y3 = map(self._f32, (x1, y1, x2, y2, x3, y3))
        if self._state == _STATE_START:
            if self._n_encoded_segments == 0:
                self.move_to(x3, y3)
                return
            self.move_to(*self._first_point)
        if self._state == _STATE_MOVE_TO:
            pt = self._start_tangent_for_curve((x1, y1), (x2, y2), (x3, y3))
            if pt is None:
                return
            self._first_start_tangent_end = pt
        if self._is_zero_length_segment((x1, y1), (x2, y2), (x3, y3)):
            return
        self._push_pt(x1, y1)
        self._push_pt(x2, y2)
        self._push_pt(x3, y3)
        self._enc.path_tags.append(PATH_TAG_CUBIC_TO_F32)
        self._state = _STATE_NONEMPTY
        self._n_encoded_segments += 1

    def close(self):
        if self._state == _STATE_START:
            return
        if self._state == _STATE_MOVE_TO:
            self._pop_pt()
            self._state = _STATE_START
            return
        if len(self._enc.path_data) < 8:
            return
        first = struct.pack(
            "<ff", np.float32(self._first_point[0]), np.float32(self._first_point[1])
        )
        if bytes(self._enc.path_data[-8:]) != first:
            self._enc.path_data += first
            self._enc.path_tags.append(PATH_TAG_LINE_TO_F32)
            self._n_encoded_segments += 1
        if not self._is_fill:
            self._insert_stroke_cap_marker_segment(is_closed=True)
        if self._enc.path_tags:
            self._enc.path_tags[-1] |= PATH_TAG_SUBPATH_END_BIT
        self._state = _STATE_START

    def path(self, path: BezPath):
        for el in path:
            k = el.kind
            if k == ElKind.MOVE_TO:
                self.move_to(el.points[0].x, el.points[0].y)
            elif k == ElKind.LINE_TO:
                self.line_to(el.points[0].x, el.points[0].y)
            elif k == ElKind.QUAD_TO:
                p0, p1 = el.points
                self.quad_to(p0.x, p0.y, p1.x, p1.y)
            elif k == ElKind.CUBIC_TO:
                p0, p1, p2 = el.points
                self.cubic_to(p0.x, p0.y, p1.x, p1.y, p2.x, p2.y)
            elif k == ElKind.CLOSE_PATH:
                self.close()

    def finish(self, insert_path_marker: bool) -> int:
        if self._is_fill:
            self.close()
        if self._state == _STATE_MOVE_TO:
            self._pop_pt()
        if self._n_encoded_segments != 0:
            if not self._is_fill and self._state == _STATE_NONEMPTY:
                self._insert_stroke_cap_marker_segment(is_closed=False)
            if self._enc.path_tags:
                self._enc.path_tags[-1] |= PATH_TAG_SUBPATH_END_BIT
            self._enc.n_path_segments += self._n_encoded_segments
            if insert_path_marker:
                self._enc.path_tags.append(PATH_TAG_PATH)
                self._enc.n_paths += 1
        return self._n_encoded_segments

    def empty_path(self):
        """Encode a degenerate 4-float line segment (path.go:484-489)."""
        self._enc.path_data += bytes(16)
        self._enc.path_tags.append(PATH_TAG_LINE_TO_F32)
        self._n_encoded_segments += 1

    def _insert_stroke_cap_marker_segment(self, is_closed: bool):
        assert not self._is_fill
        assert self._state == _STATE_NONEMPTY
        if is_closed:
            # The data stream already ends with the subpath's start point;
            # a line-to embeds the start tangent end.
            self.line_to(*self._first_start_tangent_end)
        else:
            self.quad_to(
                self._first_point[0],
                self._first_point[1],
                self._first_start_tangent_end[0],
                self._first_start_tangent_end[1],
            )
