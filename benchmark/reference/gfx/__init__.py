"""Paint and style types (reference: gfx/).

Pure data types shared by the scene API, the encoder and the renderer.
Enum values follow the reference exactly (gfx/blend.go:12-16 swaps the
peniko zero values so that defaults are sane: Mix.NORMAL == 0 and
Compose.SRC_OVER == 0).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

import numpy as np


class Fill(enum.IntEnum):
    """Fill rule (reference: gfx/style.go:7-12)."""

    NON_ZERO = 0
    EVEN_ODD = 1


class Extend(enum.IntEnum):
    """Gradient/image extend mode (reference: gfx/brush.go:28-34)."""

    PAD = 0
    REPEAT = 1
    REFLECT = 2


class Mix(enum.IntEnum):
    """Color mixing function (reference: gfx/blend.go:19-76)."""

    NORMAL = 0
    MULTIPLY = 1
    SCREEN = 2
    OVERLAY = 3
    DARKEN = 4
    LIGHTEN = 5
    COLOR_DODGE = 6
    COLOR_BURN = 7
    HARD_LIGHT = 8
    SOFT_LIGHT = 9
    DIFFERENCE = 10
    EXCLUSION = 11
    HUE = 12
    SATURATION = 13
    COLOR = 14
    LUMINOSITY = 15
    # Same as NORMAL, but signals that the layer need not be isolated.
    CLIP = 128


class Compose(enum.IntEnum):
    """Porter-Duff composition function (reference: gfx/blend.go:79-124)."""

    SRC_OVER = 0
    COPY = 1
    DEST = 2
    CLEAR = 3
    DEST_OVER = 4
    SRC_IN = 5
    DEST_IN = 6
    SRC_OUT = 7
    DEST_OUT = 8
    SRC_ATOP = 9
    DEST_ATOP = 10
    XOR = 11
    PLUS = 12
    PLUS_LIGHTER = 13


@dataclass(frozen=True)
class BlendMode:
    """A (mix, compose) pair (reference: gfx/blend.go BlendMode)."""

    mix: Mix = Mix.NORMAL
    compose: Compose = Compose.SRC_OVER

    def packed(self) -> int:
        """Packed scene encoding: (mix << 8) | compose
        (reference: encoding/encoding.go:351)."""
        return (int(self.mix) << 8) | int(self.compose)


# The packed blend-mode word that represents a pure (non-isolated) clip.
BLEND_CLIP_PACKED = (int(Mix.CLIP) << 8) | int(Compose.SRC_OVER)


# ---------------------------------------------------------------------------
# Color
#
# The reference depends on honnef.co/go/color, an external color-management
# library; only two spaces actually flow through the renderer: sRGB (user
# colors, gradient interpolation space) and linear sRGB (everything on the
# device; see gfx/color.go Premul32 and renderer/ramp_cache.go:147).
# We implement exactly that slice.
# ---------------------------------------------------------------------------


def _srgb_eotf(c: np.ndarray) -> np.ndarray:
    """sRGB -> linear transfer function, elementwise."""
    c = np.asarray(c, dtype=np.float64)
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def _srgb_oetf(c: np.ndarray) -> np.ndarray:
    """linear -> sRGB transfer function, elementwise."""
    c = np.asarray(c, dtype=np.float64)
    return np.where(c <= 0.0031308, c * 12.92, 1.055 * np.clip(c, 0, None) ** (1 / 2.4) - 0.055)


class ColorSpace(enum.Enum):
    SRGB = "srgb"
    LINEAR_SRGB = "linear-srgb"


@dataclass(frozen=True)
class Color:
    """An RGBA color with an associated color space.

    `values` are (r, g, b, a), alpha always linear. The default space is
    sRGB, matching what users of the reference supply.
    """

    values: tuple = (0.0, 0.0, 0.0, 0.0)
    space: ColorSpace = ColorSpace.SRGB

    @staticmethod
    def rgba(r: float, g: float, b: float, a: float = 1.0) -> "Color":
        return Color((float(r), float(g), float(b), float(a)), ColorSpace.SRGB)

    @staticmethod
    def rgba8(r: int, g: int, b: int, a: int = 255) -> "Color":
        return Color((r / 255.0, g / 255.0, b / 255.0, a / 255.0), ColorSpace.SRGB)

    def convert(self, space: ColorSpace) -> "Color":
        if space == self.space:
            return self
        r, g, b, a = self.values
        if space == ColorSpace.LINEAR_SRGB:
            rgb = _srgb_eotf(np.array([r, g, b]))
        else:
            rgb = _srgb_oetf(np.array([r, g, b]))
        return Color((float(rgb[0]), float(rgb[1]), float(rgb[2]), float(a)), space)

    def with_alpha_factor(self, alpha: float) -> "Color":
        r, g, b, a = self.values
        return Color((r, g, b, a * alpha), self.space)

    def with_alpha(self, alpha: float) -> "Color":
        r, g, b, _ = self.values
        return Color((r, g, b, alpha), self.space)


def premul32(color: Color | None) -> np.ndarray:
    """Premultiplied linear-sRGB f32 RGBA (reference: gfx/color.go Premul32)."""
    if color is None:
        return np.zeros(4, dtype=np.float32)
    cc = color.convert(ColorSpace.LINEAR_SRGB)
    r, g, b, a = cc.values
    return np.array([r * a, g * a, b * a, a], dtype=np.float32)


def premul16(color: Color) -> np.ndarray:
    """Premultiplied linear-sRGB f16 RGBA (reference: gfx/color.go Premul16)."""
    return premul32(color).astype(np.float16)


# ---------------------------------------------------------------------------
# Brushes (reference: gfx/brush.go, gfx/gradient.go, gfx/image.go)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ColorStop:
    offset: float
    color: Color

    def with_alpha_factor(self, alpha: float) -> "ColorStop":
        # Matches the reference's WithAlphaFactor, which *sets* (not
        # multiplies) the alpha (gfx/gradient.go:17-24).
        return ColorStop(self.offset, self.color.with_alpha(alpha))


@dataclass(frozen=True)
class LinearGradient:
    start: tuple  # (x, y)
    end: tuple
    stops: tuple = ()
    extend: Extend = Extend.PAD


@dataclass(frozen=True)
class RadialGradient:
    start_center: tuple
    start_radius: float
    end_center: tuple
    end_radius: float
    stops: tuple = ()
    extend: Extend = Extend.PAD


@dataclass(frozen=True)
class SweepGradient:
    center: tuple
    start_angle: float
    end_angle: float
    stops: tuple = ()
    extend: Extend = Extend.PAD


@dataclass(frozen=True)
class Image:
    """An RGBA8 image brush (reference: gfx/image.go).

    `pixels` is a (height, width, 4) uint8 array (non-premultiplied sRGB,
    as with Go's image.Image decoded pixels).
    """

    pixels: np.ndarray = field(compare=False)
    extend: Extend = Extend.PAD

    @property
    def width(self) -> int:
        return int(self.pixels.shape[1])

    @property
    def height(self) -> int:
        return int(self.pixels.shape[0])


@dataclass(frozen=True)
class SolidBrush:
    color: Color


@dataclass(frozen=True)
class GradientBrush:
    gradient: LinearGradient | RadialGradient | SweepGradient


@dataclass(frozen=True)
class ImageBrush:
    image: Image


Brush = SolidBrush | GradientBrush | ImageBrush
