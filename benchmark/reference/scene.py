"""Retained scene builder (reference: scene.go).

`Scene` records fills, strokes, clip/blend layers and nested scenes into
an `encoding.Encoding`. Unlike the reference, bump estimation is not
tallied during scene construction; the TPU renderer derives its capacity
classes at resolve time directly from the encoded streams (see
renderer/estimate.py), which is both simpler and accounts for host-side
dashing — the reference itself notes estimation should move to resolve
time (scene.go:163-168).
"""

from __future__ import annotations

from . import gfx
from .curve import Affine, BezPath, LineTo, MoveTo, Pt, Rect, Stroke, dash
from .encoding import Encoding, transform_from_affine
from .gfx import BlendMode, Brush, Fill


class Scene:
    """Scene builder.

    `debug_trace=True` records a reconstructible Python statement for
    every draw call (the reference's `debugTrace` const, scene.go:18,51-59)
    — retrieve with `trace_log()` to capture a repro.
    """

    def __init__(self, debug_trace: bool = False):
        self._encoding = Encoding()
        self._debug_trace = debug_trace
        self._trace: list[str] = []
        # Mutation counter: lets renderers cache the resolved scene
        # (the reference engine's resident-resource analog) and
        # invalidate on any Scene-level mutation.
        self._rev = 0

    def reset(self):
        self._encoding.reset()
        self._trace.clear()
        self._rev += 1

    def trace_log(self) -> str:
        return "\n".join(self._trace)

    def _log(self, call: str, *args):
        if self._debug_trace:
            self._trace.append(f"scene.{call}({', '.join(repr(a) for a in args)})")

    @property
    def encoding(self) -> Encoding:
        return self._encoding

    def push_layer(
        self,
        blend: BlendMode,
        alpha: float,
        clip_transform: Affine,
        clip: BezPath,
    ):
        self._log("push_layer", blend, alpha, clip_transform, clip.elements)
        self._rev += 1
        t = transform_from_affine(clip_transform)
        self._encoding.encode_transform(t)
        self._encoding.encode_fill_style(Fill.NON_ZERO)
        if not self._encoding.encode_path(clip, True):
            # Invalid clip shape: encode a valid empty path so drawing is
            # suppressed until the layer is popped (scene.go:64-76).
            self._encoding.encode_path(Rect().path_elements(0.1), True)
            self._encoding.encode_empty_shape()
        self._encoding.encode_begin_clip(blend, min(max(alpha, 0.0), 1.0))

    def pop_layer(self):
        self._log("pop_layer")
        self._rev += 1
        self._encoding.encode_end_clip()

    def fill(
        self,
        style: Fill,
        transform: Affine,
        brush: Brush,
        brush_transform: Affine | None,
        path: BezPath,
    ):
        self._log("fill", style, transform, brush, brush_transform, path.elements)
        self._rev += 1
        t = transform_from_affine(transform)
        self._encoding.encode_transform(t)
        self._encoding.encode_fill_style(style)
        if self._encoding.encode_path(path, True):
            if brush_transform is not None and brush_transform != Affine.identity():
                if self._encoding.encode_transform(
                    transform_from_affine(transform @ brush_transform)
                ):
                    self._encoding.swap_last_path_tags()
            self._encoding.encode_brush(brush, 1.0)

    def stroke(
        self,
        style: Stroke,
        transform: Affine,
        brush: Brush,
        brush_transform: Affine | None,
        shape: BezPath,
    ):
        # GPU-side stroke expansion (scene.go:150-186); dashing is always
        # expanded on the host.
        self._log("stroke", style, transform, brush, brush_transform, shape.elements)
        self._rev += 1
        t = transform_from_affine(transform)
        self._encoding.encode_transform(t)
        self._encoding.encode_stroke_style(style)
        if style.dash_pattern:
            shape = dash(shape, style.dash_offset, style.dash_pattern)
        if self._encoding.encode_path(shape, False):
            if brush_transform is not None and brush_transform != Affine.identity():
                if self._encoding.encode_transform(
                    transform_from_affine(transform @ brush_transform)
                ):
                    self._encoding.swap_last_path_tags()
            self._encoding.encode_brush(brush, 1.0)

    def append(self, other: "Scene", transform: Affine):
        self._rev += 1
        self._encoding.append(other._encoding, transform_from_affine(transform))

    def apply_transform(self, transform: Affine):
        """Transform everything already drawn (e.g. HiDPI scaling)."""
        self._rev += 1
        self._encoding.apply_transform(transform_from_affine(transform))
