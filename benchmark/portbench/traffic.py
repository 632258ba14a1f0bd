"""The one traffic generator: a traffic mix's parameters
(`traffic/<name>.json`) turned into frames through a renderer.

Parameters:
  scene          "retained": one Scene object, drawn every frame;
                 "append": every frame a new Scene holding the
                 configuration's scene appended under the frame's view
                 transform (Scene.append, inside the frame's time);
  in_flight      1: `render_surface`, one frame at a time; n > 1:
                 `render_surface_async`, submitting frame i + n - 1 before
                 waiting for frame i (`Frame.result()`);
  motion         the view transform of frame i, for "append": a
                 translation around a circle of `radius_px`, one turn every
                 `period_frames`;
  warmup_frames  frames rendered in set-up before the window;
  trace_frames   frames in the traced sub-window of a `--trace 1` run;
  sample_frames  frames of the window whose pixels the reference checks.
"""

from __future__ import annotations

import collections
import contextlib
import math
import time


def view_transform(motion, i):
    """The affine coefficients of frame i's view transform, or None."""
    if not motion:
        return None
    th = 2.0 * math.pi * (i % motion["period_frames"]) / motion["period_frames"]
    r = motion["radius_px"]
    return (1.0, 0.0, 0.0, 1.0, r * math.cos(th), r * math.sin(th))


class Traffic:
    """Frames of one traffic mix. `scene` is the configuration's scene in
    the renderer's API `api`; `span(label)` opens a span around each step
    (a context manager; nothing by default)."""

    def __init__(self, spec, api, scene, params, renderer, span=None):
        self.spec = spec
        self.api = api
        self.scene = scene
        self.params = params
        self.renderer = renderer
        self.span = span or (lambda label: contextlib.nullcontext())
        self.next_index = 0

    def transform(self, i):
        if self.spec["scene"] != "append":
            return None
        return view_transform(self.spec["motion"], i)

    def _scene(self, i):
        if self.spec["scene"] == "retained":
            return self.scene
        if self.spec["scene"] != "append":
            raise ValueError(f"unknown scene mode {self.spec['scene']!r}")
        with self.span("scene.append"):
            s = self.api.Scene()
            s.append(self.scene, self.api.Affine(self.transform(i)))
        return s

    def run(self, frames=None, seconds=None, done=None):
        """Render frames until `frames` are submitted or `seconds` have
        passed since the first submission (no frame is submitted after
        that; those in flight complete). done(i, t_submit, t_done, pixels,
        error) is called as each frame completes, in order (pixels None
        for a frame that raised). Returns (t_first_submit, t_last_done)."""
        depth = max(1, int(self.spec["in_flight"]))
        r = self.renderer
        inflight = collections.deque()
        t_start = time.perf_counter()
        t_end = t_start
        n = 0

        def complete():
            nonlocal t_end
            i, ts, handle, err = inflight.popleft()
            pixels = None
            if err is None:
                try:
                    with self.span("frame.result"):
                        pixels = handle.result()
                except Exception as e:  # a frame that fails counts, it does not stop the run
                    err = e
            t_end = time.perf_counter()
            if done is not None:
                done(i, ts, t_end, pixels, err)

        while True:
            if frames is not None and n >= frames:
                break
            if seconds is not None and time.perf_counter() - t_start >= seconds:
                break
            i = self.next_index
            self.next_index += 1
            n += 1
            ts = time.perf_counter()
            try:
                scene = self._scene(i)
                if depth == 1:
                    with self.span("renderer.render_surface"):
                        pixels = r.render_surface(scene, self.params)
                    t_end = time.perf_counter()
                    if done is not None:
                        done(i, ts, t_end, pixels, None)
                    continue
                with self.span("renderer.render_surface_async"):
                    inflight.append((i, ts, r.render_surface_async(scene, self.params), None))
            except Exception as e:
                if depth == 1:
                    t_end = time.perf_counter()
                    if done is not None:
                        done(i, ts, t_end, None, e)
                    continue
                inflight.append((i, ts, None, e))
            if len(inflight) >= depth:
                complete()
        while inflight:
            complete()
        return t_start, t_end
