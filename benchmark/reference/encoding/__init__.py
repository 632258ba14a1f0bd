"""Scene encoding streams (reference: encoding/encoding.go).

An `Encoding` is six parallel append-only streams plus late-bound
resources (gradient color stops and images). The byte layout of every
stream matches the reference so that the packed scene buffer produced by
the resolver is identical:

  - path_tags:   u8 per tag
  - path_data:   f32 LE coordinate pairs
  - draw_tags:   u32 LE per draw object
  - draw_data:   variable u32-word payloads
  - transforms:  6 x f32 per transform (xx, yx, xy, yy, x0, y0)
  - styles:      2 x u32 per style (flags_and_miter_limit, linewidth f32)
"""

from __future__ import annotations

import math
import struct
from dataclasses import dataclass

import numpy as np

from .. import gfx
from ..curve import Affine, BezPath, Stroke
from ..gfx import (
    Brush,
    Color,
    ColorStop,
    Extend,
    Fill,
    GradientBrush,
    Image,
    ImageBrush,
    LinearGradient,
    RadialGradient,
    SolidBrush,
    SweepGradient,
    BlendMode,
)
from . import draw as drawtags
from .path import (
    PATH_TAG_PATH,
    PATH_TAG_STYLE,
    PATH_TAG_TRANSFORM,
    PathEncoder,
    style_from_fill,
    style_from_stroke,
)

_FORCE_NEXT_TRANSFORM = 1
_FORCE_NEXT_STYLE = 2


@dataclass(frozen=True)
class RampPatch:
    draw_data_offset: int
    stops: tuple  # (start, end) indices into color_stops
    extend: Extend


@dataclass(frozen=True)
class ImagePatch:
    draw_data_offset: int
    image: Image


class Resources:
    def __init__(self):
        self.patches: list = []
        self.color_stops: list[ColorStop] = []

    def reset(self):
        self.patches.clear()
        self.color_stops.clear()


@dataclass(frozen=True)
class StreamOffsets:
    path_tags: int = 0
    path_data: int = 0
    draw_tags: int = 0
    draw_data: int = 0
    transforms: int = 0
    styles: int = 0


def transform_from_affine(affine: Affine) -> tuple:
    """f32 6-tuple in stream order (reference: jmath.TransformFromKurbo)."""
    return tuple(float(np.float32(c)) for c in affine.coeffs)


IDENTITY_TRANSFORM = transform_from_affine(Affine.identity())


class Encoding:
    def __init__(self):
        self.path_tags: list[int] = []
        self.path_data = bytearray()
        self.draw_tags: list[int] = []
        self.draw_data = bytearray()
        self.transforms: list[tuple] = []
        self.styles: list[tuple] = []  # (flags_u32, linewidth_f32)
        self.resources = Resources()
        self.n_paths = 0
        self.n_path_segments = 0
        self.n_clips = 0
        self.n_open_clips = 0
        self.flags = 0

    # -- basic stream ops ------------------------------------------------

    def is_empty(self) -> bool:
        return not self.path_tags

    def reset(self):
        self.path_tags.clear()
        self.path_data = bytearray()
        self.draw_tags.clear()
        self.draw_data = bytearray()
        self.transforms.clear()
        self.styles.clear()
        self.resources.reset()
        self.n_paths = 0
        self.n_path_segments = 0
        self.n_clips = 0
        self.n_open_clips = 0
        self.flags = 0

    def stream_offsets(self) -> StreamOffsets:
        return StreamOffsets(
            path_tags=len(self.path_tags),
            path_data=len(self.path_data),
            draw_tags=len(self.draw_tags),
            draw_data=len(self.draw_data),
            transforms=len(self.transforms),
            styles=len(self.styles),
        )

    def append(self, other: "Encoding", transform: tuple):
        """Concatenate another encoding, rebasing patches and applying
        `transform` to its transform stream (encoding.go:58-105)."""
        offsets = self.stream_offsets()
        stops_base = len(self.resources.color_stops)
        for patch in other.resources.patches:
            if isinstance(patch, RampPatch):
                self.resources.patches.append(
                    RampPatch(
                        draw_data_offset=patch.draw_data_offset + offsets.draw_data,
                        stops=(patch.stops[0] + stops_base, patch.stops[1] + stops_base),
                        extend=patch.extend,
                    )
                )
            elif isinstance(patch, ImagePatch):
                self.resources.patches.append(
                    ImagePatch(
                        draw_data_offset=patch.draw_data_offset + offsets.draw_data,
                        image=patch.image,
                    )
                )
            else:
                raise TypeError(patch)
        self.resources.color_stops.extend(other.resources.color_stops)

        self.path_tags.extend(other.path_tags)
        self.path_data += other.path_data
        self.draw_tags.extend(other.draw_tags)
        self.draw_data += other.draw_data
        self.n_paths += other.n_paths
        self.n_path_segments += other.n_path_segments
        self.n_clips += other.n_clips
        self.n_open_clips += other.n_open_clips
        self.flags = other.flags
        if transform != IDENTITY_TRANSFORM:
            self.transforms.extend(_transform_mul(transform, t) for t in other.transforms)
        else:
            self.transforms.extend(other.transforms)
        self.styles.extend(other.styles)

    def apply_transform(self, transform: tuple):
        self.transforms = [_transform_mul(transform, t) for t in self.transforms]

    # -- styles / transforms ---------------------------------------------

    def encode_fill_style(self, fill: Fill):
        self.encode_style(style_from_fill(fill))

    def encode_stroke_style(self, stroke: Stroke):
        self.encode_style(style_from_stroke(stroke))

    def encode_style(self, style: tuple):
        if (
            self.flags & _FORCE_NEXT_STYLE
            or not self.styles
            or self.styles[-1] != style
        ):
            self.path_tags.append(PATH_TAG_STYLE)
            self.styles.append(style)
            self.flags &= ~_FORCE_NEXT_STYLE

    def encode_transform(self, transform: tuple) -> bool:
        if (
            self.flags & _FORCE_NEXT_TRANSFORM
            or not self.transforms
            or self.transforms[-1] != transform
        ):
            self.path_tags.append(PATH_TAG_TRANSFORM)
            self.transforms.append(transform)
            self.flags &= ~_FORCE_NEXT_TRANSFORM
            return True
        return False

    # -- paths -----------------------------------------------------------

    def encode_path(self, path: BezPath, is_fill: bool) -> bool:
        pe = PathEncoder(self, is_fill)
        pe.path(path)
        return pe.finish(True) != 0

    def encode_empty_shape(self):
        pe = PathEncoder(self, True)
        pe.empty_path()
        pe.finish(True)

    # -- draw objects ----------------------------------------------------

    def encode_brush(self, brush: Brush, alpha: float):
        if isinstance(brush, SolidBrush):
            color = brush.color.with_alpha_factor(alpha)
            self.encode_color(gfx.premul32(color))
        elif isinstance(brush, GradientBrush):
            g = brush.gradient
            if isinstance(g, LinearGradient):
                self.encode_linear_gradient(g, alpha)
            elif isinstance(g, RadialGradient):
                self.encode_radial_gradient(g, alpha)
            elif isinstance(g, SweepGradient):
                self.encode_sweep_gradient(g, alpha)
            else:
                raise TypeError(g)
        elif isinstance(brush, ImageBrush):
            self.encode_image(brush.image, 1.0)
        else:
            raise TypeError(brush)

    def encode_color(self, rgba: np.ndarray):
        """rgba: premultiplied linear f32[4]."""
        self.draw_tags.append(drawtags.DRAW_TAG_COLOR)
        self.draw_data += struct.pack(
            "<ffff", np.float32(rgba[0]), np.float32(rgba[1]), np.float32(rgba[2]), np.float32(rgba[3])
        )

    def _add_ramp(self, stops, alpha: float, extend: Extend):
        assert len(stops) >= 2
        offset = len(self.draw_data)
        start = len(self.resources.color_stops)
        if alpha != 1.0:
            stops = [s.with_alpha_factor(alpha) for s in stops]
        self.resources.color_stops.extend(stops)
        end = len(self.resources.color_stops)
        self.resources.patches.append(
            RampPatch(draw_data_offset=offset, stops=(start, end), extend=extend)
        )

    def _encode_degenerate(self, stops, alpha: float) -> bool:
        if len(stops) == 0:
            self.encode_color(np.zeros(4, dtype=np.float32))
            return True
        if len(stops) == 1:
            c = stops[0].color.with_alpha_factor(alpha)
            self.encode_color(gfx.premul32(c))
            return True
        return False

    def encode_linear_gradient(self, g: LinearGradient, alpha: float):
        if self._encode_degenerate(g.stops, alpha):
            return
        self._add_ramp(list(g.stops), alpha, g.extend)
        self.draw_tags.append(drawtags.DRAW_TAG_LINEAR_GRADIENT)
        self.draw_data += struct.pack(
            "<Iffff",
            0,
            np.float32(g.start[0]),
            np.float32(g.start[1]),
            np.float32(g.end[0]),
            np.float32(g.end[1]),
        )

    def encode_radial_gradient(self, g: RadialGradient, alpha: float):
        # Match Skia's epsilon for radii comparison (encoding.go:291).
        skia_epsilon = 1.0 / (1 << 12)
        p0 = (float(np.float32(g.start_center[0])), float(np.float32(g.start_center[1])))
        p1 = (float(np.float32(g.end_center[0])), float(np.float32(g.end_center[1])))
        if p0 == p1 and abs(g.start_radius - g.end_radius) < skia_epsilon:
            self.encode_color(np.zeros(4, dtype=np.float32))
            return
        if self._encode_degenerate(g.stops, alpha):
            return
        self._add_ramp(list(g.stops), alpha, g.extend)
        self.draw_tags.append(drawtags.DRAW_TAG_RADIAL_GRADIENT)
        self.draw_data += struct.pack(
            "<Iffffff",
            0,
            np.float32(p0[0]),
            np.float32(p0[1]),
            np.float32(p1[0]),
            np.float32(p1[1]),
            np.float32(g.start_radius),
            np.float32(g.end_radius),
        )

    def encode_sweep_gradient(self, g: SweepGradient, alpha: float):
        skia_degenerate_threshold = 1.0 / (1 << 15)
        t0 = float(np.float32(g.start_angle / (2 * math.pi)))
        t1 = float(np.float32(g.end_angle / (2 * math.pi)))
        if abs(t0 - t1) < skia_degenerate_threshold:
            self.encode_color(np.zeros(4, dtype=np.float32))
            return
        if self._encode_degenerate(g.stops, alpha):
            return
        self._add_ramp(list(g.stops), alpha, g.extend)
        self.draw_tags.append(drawtags.DRAW_TAG_SWEEP_GRADIENT)
        self.draw_data += struct.pack(
            "<Iffff",
            0,
            np.float32(g.center[0]),
            np.float32(g.center[1]),
            np.float32(t0),
            np.float32(t1),
        )

    def encode_image(self, img: Image, _alpha: float):
        self.resources.patches.append(
            ImagePatch(draw_data_offset=len(self.draw_data), image=img)
        )
        self.draw_tags.append(drawtags.DRAW_TAG_IMAGE)
        # Width/height packed (encoding.go:343-346); the atlas index word
        # is patched in by the resolver.
        wh = ((img.width & 0xFFFF) << 16) | (img.height & 0xFFFF)
        self.draw_data += struct.pack("<II", 0, wh)

    def encode_begin_clip(self, blend_mode: BlendMode, alpha: float):
        self.draw_tags.append(drawtags.DRAW_TAG_BEGIN_CLIP)
        self.draw_data += struct.pack(
            "<If", blend_mode.packed(), np.float32(alpha)
        )
        self.n_clips += 1
        self.n_open_clips += 1

    def encode_end_clip(self):
        if self.n_open_clips == 0:
            return
        self.draw_tags.append(drawtags.DRAW_TAG_END_CLIP)
        # Dummy path for the end-clip draw object (encoding.go:365-368).
        self.path_tags.append(PATH_TAG_PATH)
        self.n_paths += 1
        self.n_clips += 1
        self.n_open_clips -= 1

    def force_next_transform_and_style(self):
        self.flags |= _FORCE_NEXT_TRANSFORM | _FORCE_NEXT_STYLE

    def swap_last_path_tags(self):
        self.path_tags[-2], self.path_tags[-1] = self.path_tags[-1], self.path_tags[-2]


def _transform_mul(a: tuple, b: tuple) -> tuple:
    """Compose transforms in f32 (reference: jmath.Transform.Mul)."""
    a = np.array(a, dtype=np.float32)
    b = np.array(b, dtype=np.float32)
    out = np.array(
        [
            a[0] * b[0] + a[2] * b[1],
            a[1] * b[0] + a[3] * b[1],
            a[0] * b[2] + a[2] * b[3],
            a[1] * b[2] + a[3] * b[3],
            a[0] * b[4] + a[2] * b[5] + a[4],
            a[1] * b[4] + a[3] * b[5] + a[5],
        ],
        dtype=np.float32,
    )
    return tuple(float(v) for v in out)
