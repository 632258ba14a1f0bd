"""The check of a run's pixels against the plain reference
(`reference/`): the u8 surfaces the timed path returned, each against the
reference's frame of the same scene under the same view transform, built
by the reference itself from the same draw commands.

Numbers compared, each against the limit of the cell's configuration
(`limits` in `configs/<name>.json`):
  frames_failed  frames of the window that raised or came back with an
                 overflow flag still raised (limit 0);
  max_u8_diff    the largest difference of a channel value, in u8 steps;
  px_off_ppm     channel values that differ by 2 steps or more, in parts
                 per million of all values compared;
  programs_built frame programs captured inside the measured window
                 (limit 0: set-up has to settle every class the window
                 renders, so that nothing compiles in the window).
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

import numpy as np

from . import commands

REF_NAME = "portbench_reference"


def reference(bench_dir: Path):
    """The reference package (`reference/`), loaded under its own name."""
    if REF_NAME in sys.modules:
        return sys.modules[REF_NAME]
    path = Path(bench_dir) / "reference"
    spec = importlib.util.spec_from_file_location(REF_NAME, path / "__init__.py",
                                                  submodule_search_locations=[str(path)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[REF_NAME] = module
    spec.loader.exec_module(module)
    importlib.import_module(REF_NAME + ".frame")
    return module


def diff_readings(got: np.ndarray, want: np.ndarray):
    """(largest difference in u8 steps, values off by 2 or more, values)."""
    if got.shape != want.shape or got.dtype != np.uint8:
        return 255, want.size, want.size
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    return int(d.max()), int((d >= 2).sum()), int(d.size)


class Reference:
    """Reference frames of one configuration's commands, by view transform."""

    def __init__(self, bench_dir, cmds, device):
        self.ref = reference(bench_dir)
        self.device = device
        self.fragment = commands.build(self.ref, cmds)
        self.params = commands.params(self.ref, cmds)
        self._frames = {}

    def frame(self, transform, low_precision=False):
        """The u8 frame under `transform` (None: the scene itself); with
        `low_precision`, the control's (`frame.lower`)."""
        key = (transform, low_precision)
        if key not in self._frames:
            ref = self.ref
            scene = self.fragment
            if transform is not None:
                scene = ref.Scene()
                scene.append(self.fragment, ref.Affine(tuple(transform)))
            self._frames[key] = ref.frame.render_u8(scene, self.params, self.device,
                                                    low_precision=low_precision)
        return self._frames[key]


def readings(samples, ref: Reference):
    """samples: [(frame index, transform, u8 pixels)] -> (max_u8_diff,
    px_off_ppm)."""
    worst, off, total = 0, 0, 0
    for _, transform, pixels in samples:
        m, o, t = diff_readings(pixels, ref.frame(transform))
        worst, off, total = max(worst, m), off + o, total + t
    return worst, 1e6 * off / max(total, 1)


def checks(frames_failed, max_diff, off_ppm, limits, programs_built=0) -> dict:
    """Each number compared beside its limit."""
    return {
        "frames_failed": {"value": frames_failed, "limit": 0},
        "max_u8_diff": {"value": max_diff, "limit": limits["max_u8_diff"]},
        "px_off_ppm": {"value": off_ppm, "limit": limits["px_off_ppm"]},
        "programs_built": {"value": programs_built, "limit": 0},
    }


def passed(result: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in result.values())
