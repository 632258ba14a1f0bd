"""Render parameters (reference: renderer/render.go:50-63)."""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

from ..gfx import Color


class AaConfig(enum.Enum):
    AREA = "area"
    MSAA8 = "msaa8"
    MSAA16 = "msaa16"


@dataclass
class RenderParams:
    base_color: Color = field(default_factory=lambda: Color.rgba(0, 0, 0, 0))
    width: int = 0
    height: int = 0
    antialiasing_method: AaConfig = AaConfig.AREA
