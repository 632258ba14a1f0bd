"""Scene resolution: late-bound resources + packed scene buffer.

(reference: renderer/resolve.go, renderer/ramp_cache.go)

`Resolver.resolve` turns an `Encoding` plus its resources into:
  - a `Layout` of word-indexed stream base offsets,
  - the gradient ramp texture (N x 512 premultiplied linear f16 RGBA),
  - the list of images referenced this frame,
  - the single packed little-endian scene buffer consumed by the device
    pipeline (viewed as u32 words).

Draw data is patched in place: gradient payload word 0 becomes
(ramp_id << 2) | extend, image payload word 0 becomes the image index.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

from ..encoding import Encoding, ImagePatch, RampPatch
from ..encoding.path import PATH_TAG_PATH
from ..encoding.draw import DRAW_TAG_END_CLIP, info_size
from ..gfx import ColorStop, ColorSpace, premul32

PATH_REDUCE_WG = 256
NUM_RAMP_SAMPLES = 512
# The reference retains 64 ramps (a wgpu-texture-era choice,
# ramp_cache.go:41). Ramps live in HBM here, so the default retention is
# much larger; gradient-heavy scenes then resolve to cache hits after
# the first frame.
RETAINED_RAMP_COUNT = 4096


@dataclass
class Layout:
    """Word-indexed offsets into the packed scene buffer
    (reference: renderer/config.go:57-80)."""

    n_draw_objects: int = 0
    n_paths: int = 0
    n_clips: int = 0
    bin_data_start: int = 0
    path_tag_base: int = 0
    path_data_base: int = 0
    draw_tag_base: int = 0
    draw_data_base: int = 0
    transform_base: int = 0
    style_base: int = 0

    # Extra bookkeeping (not part of the reference layout struct, but
    # host-known): number of real path tag bytes before padding.
    n_path_tags: int = 0


@dataclass
class Ramps:
    data: np.ndarray = field(default_factory=lambda: np.zeros((0, NUM_RAMP_SAMPLES, 4), np.float16))
    width: int = NUM_RAMP_SAMPLES
    height: int = 0
    # Analytic form consumed by the fine stages: per-ramp stop-table rows
    # (pipeline/gradient.py layout). `data` (the baked 512-texel texture
    # of renderer/ramp_cache.go) is kept for API parity/inspection only.
    stops: np.ndarray = field(default_factory=lambda: np.zeros((0, 11), np.float32))
    max_stops: int = 2


def make_ramp(stops: list[ColorStop]) -> np.ndarray:
    """Bake color stops into a 512-texel premultiplied linear f16 ramp.

    Interpolation happens in sRGB (what users expect) and samples are
    converted to premultiplied linear sRGB, mirroring
    renderer/ramp_cache.go:139-150.
    """
    assert len(stops) >= 2
    if stops[0].offset != 0.0:
        stops = [ColorStop(0.0, stops[0].color)] + list(stops)
    out = np.zeros((NUM_RAMP_SAMPLES, 4), dtype=np.float32)
    pos = 0
    remaining = NUM_RAMP_SAMPLES
    for i in range(1, len(stops)):
        prev, stop = stops[i - 1], stops[i]
        if i == len(stops) - 1:
            n = remaining
        else:
            frac = stop.offset - prev.offset
            n = int(np.round(np.float32(NUM_RAMP_SAMPLES) * np.float32(frac)))
            n = min(remaining, n)
        remaining -= n
        if n == 0:
            continue
        if n == 1:
            out[pos] = premul32(stop.color)
            pos += 1
            continue
        # n evenly spaced samples from prev to stop inclusive, blended in
        # sRGB component space.
        c0 = np.array(prev.color.convert(ColorSpace.SRGB).values, dtype=np.float64)
        c1 = np.array(stop.color.convert(ColorSpace.SRGB).values, dtype=np.float64)
        ts = np.linspace(0.0, 1.0, n)[:, None]
        cs = c0[None, :] * (1 - ts) + c1[None, :] * ts
        # convert srgb->linear, premultiply
        from ..gfx import _srgb_eotf

        rgb = _srgb_eotf(cs[:, :3])
        a = cs[:, 3:4]
        out[pos : pos + n, :3] = rgb * a
        out[pos : pos + n, 3:4] = a
        pos += n
    assert pos == NUM_RAMP_SAMPLES
    return out.astype(np.float16)


class _RampCache:
    """Keyed ramp cache with epoch-based retention
    (reference: renderer/ramp_cache.go:30-104)."""

    def __init__(self):
        self.epoch = 0
        self.mapping: dict = {}  # key -> [id, epoch]
        self.data: list[np.ndarray] = []  # one (512,4) f16 row per ramp
        self.stop_lists: list = []  # the ColorStop sequence per ramp id
        self._version = 0  # bumped on any content change
        self._ramps_cache: tuple | None = None  # (version, Ramps)

    def maintain(self):
        self.epoch += 1
        if len(self.mapping) > RETAINED_RAMP_COUNT:
            self.mapping = {
                k: v for k, v in self.mapping.items() if v[0] < RETAINED_RAMP_COUNT
            }
            del self.data[RETAINED_RAMP_COUNT:]
            del self.stop_lists[RETAINED_RAMP_COUNT:]
            self._version += 1

    @staticmethod
    def _key(stops):
        # ColorStop is a frozen dataclass; the stop sequence itself is a
        # hashable, collision-free key (the reference serializes to bytes
        # because Go map keys must be strings; ramp_cache.go:56-68).
        return tuple(stops)

    def add(self, stops: list[ColorStop]) -> int:
        key = self._key(stops)
        entry = self.mapping.get(key)
        if entry is not None:
            entry[1] = self.epoch
            return entry[0]
        if len(self.mapping) < RETAINED_RAMP_COUNT:
            ramp_id = len(self.data)
            self.data.append(make_ramp(stops))
            self.stop_lists.append(list(stops))
            self._version += 1
            self.mapping[key] = [ramp_id, self.epoch]
            return ramp_id
        # Reuse a stale slot if possible, else append unretained.
        for k, v in self.mapping.items():
            if v[1] + 2 < self.epoch:
                reuse_id = v[0]
                del self.mapping[k]
                self.data[reuse_id] = make_ramp(stops)
                self.stop_lists[reuse_id] = list(stops)
                self._version += 1
                self.mapping[key] = [reuse_id, self.epoch]
                return reuse_id
        ramp_id = len(self.data)
        self.data.append(make_ramp(stops))
        self.stop_lists.append(list(stops))
        self._version += 1
        return ramp_id

    def ramps(self) -> Ramps:
        if not self.data:
            return Ramps()
        # Rebuild only when a ramp was added/replaced (static scenes hit
        # this every frame).
        if self._ramps_cache is not None and self._ramps_cache[0] == self._version:
            return self._ramps_cache[1]
        from ..pipeline.gradient import bake_stops_row, stops_row_width

        arr = np.stack(self.data)
        # Table-wide max stop count (a 0-offset stop may be prepended).
        max_stops = 2
        for sl in self.stop_lists:
            n = len(sl) + (1 if sl[0].offset != 0.0 else 0)
            max_stops = max(max_stops, n)
        stops_tab = np.stack(
            [bake_stops_row(sl, max_stops) for sl in self.stop_lists]
        ).astype(np.float32)
        out = Ramps(
            data=arr,
            width=NUM_RAMP_SAMPLES,
            height=len(self.data),
            stops=stops_tab,
            max_stops=max_stops,
        )
        self._ramps_cache = (self._version, out)
        return out


class ImageAtlas:
    """Shelf-packed image atlas (the reference's atlas scheme,
    resolve.go:128-149): one [height, width] plane; each image draw's
    data is patched with its (x, y) placement packed as (y << 16) | x.
    """

    def __init__(self):
        self.images = []       # Image objects, dedup'd by pixel identity
        self.placements = []   # (ax, ay) per image
        self.width = 0
        self.height = 0

    def __len__(self):
        return len(self.images)

    def pack(self):
        """Shelf-pack by decreasing height. Width quantized to 128 and
        height to 8 so the packed plane is kernel-tileable as-is."""
        if not self.images:
            return
        order = sorted(range(len(self.images)),
                       key=lambda i: -self.images[i].height)
        W = 128
        for img in self.images:
            while img.width > W:
                W *= 2
        x = y = shelf_h = 0
        place = [None] * len(self.images)
        for i in order:
            img = self.images[i]
            if x + img.width > W:
                y += shelf_h
                x = 0
                shelf_h = 0
            place[i] = (x, y)
            x += img.width
            shelf_h = max(shelf_h, img.height)
        self.placements = place
        self.width = W
        self.height = -(-(y + shelf_h) // 8) * 8


class Resolver:
    def __init__(self):
        self._ramp_cache = _RampCache()

    def resolve_solid_paths_only(self, enc: Encoding):
        """Fast path for encodings with no late-bound resources
        (reference: renderer/resolve.go:231-283 resolveSolidPathsOnly):
        skips the patch walk, the ramp cache epoch bump and the ramp
        table rebuild entirely — the common case for solid-fill/stroke
        scenes. Same returns as resolve() (empty Ramps, no atlas)."""
        if enc.resources.patches:
            raise ValueError(
                "resolve_solid_paths_only does not support late-bound "
                "resources (gradients/images); use resolve()"
            )
        layout, scene = self._pack_scene(
            enc, np.frombuffer(bytes(enc.draw_data), dtype=np.uint32)
        )
        return layout, Ramps(), None, scene

    def resolve(self, enc: Encoding):
        """Returns (layout, ramps, atlas: ImageAtlas | None,
        packed_scene_u32)."""
        if not enc.resources.patches:
            return self.resolve_solid_paths_only(enc)
        self._ramp_cache.maintain()

        # Resolve patches: assign ramp ids and image atlas placements.
        ramp_patches = []  # (draw_data_offset, packed_word)
        image_patches = []  # (draw_data_offset, image_idx)
        atlas = ImageAtlas()
        image_ids: dict[int, int] = {}
        for patch in enc.resources.patches:
            if isinstance(patch, RampPatch):
                stops = enc.resources.color_stops[patch.stops[0] : patch.stops[1]]
                ramp_id = self._ramp_cache.add(stops)
                word = (ramp_id << 2) | int(patch.extend)
                ramp_patches.append((patch.draw_data_offset, word))
            elif isinstance(patch, ImagePatch):
                pid = id(patch.image.pixels)
                if pid in image_ids:
                    idx = image_ids[pid]
                else:
                    idx = len(atlas.images)
                    image_ids[pid] = idx
                    atlas.images.append(patch.image)
                image_patches.append((patch.draw_data_offset, idx))
            else:
                raise TypeError(patch)
        atlas.pack()
        image_patches = [
            (off, (atlas.placements[idx][1] << 16) | atlas.placements[idx][0])
            for off, idx in image_patches
        ]
        images = atlas if atlas.images else None

        # Patch the draw data stream (vectorized word scatter).
        draw_data = np.frombuffer(bytes(enc.draw_data), dtype=np.uint32).copy()
        if ramp_patches or image_patches:
            offs = np.array(
                [p[0] for p in ramp_patches + image_patches], dtype=np.int64
            )
            words = np.array(
                [p[1] for p in ramp_patches + image_patches], dtype=np.uint32
            )
            assert (offs % 4 == 0).all()
            draw_data[offs // 4] = words

        layout, scene = self._pack_scene(enc, draw_data)
        return layout, self._ramp_cache.ramps(), images, scene

    def _pack_scene(self, enc: Encoding, draw_data: np.ndarray):
        """Pack the six streams into the scene buffer + Layout
        (resolve.go:82-179 stream packing; shared by both resolve
        entry points)."""
        layout = Layout(n_paths=enc.n_paths, n_clips=enc.n_clips)

        parts = []
        pos = 0

        def put(b: bytes):
            nonlocal pos
            parts.append(b)
            pos += len(b)

        # Path tag stream, padded to 4*256 bytes (resolve.go:290-306).
        layout.path_tag_base = pos // 4
        put(bytes(enc.path_tags))
        put(bytes([PATH_TAG_PATH]) * enc.n_open_clips)
        layout.n_path_tags = len(enc.path_tags) + enc.n_open_clips
        pad = -pos % (4 * PATH_REDUCE_WG)
        if pos + pad == 0:
            pad = 4 * PATH_REDUCE_WG  # keep the buffer non-empty for empty scenes
        put(bytes(pad))
        # Path data stream.
        layout.path_data_base = pos // 4
        put(bytes(enc.path_data))
        # Draw tag stream; bin data (info) offset precedes it.
        layout.draw_tag_base = pos // 4
        tags_arr = np.array(enc.draw_tags, dtype=np.uint32)
        layout.bin_data_start = int(((tags_arr >> 6) & 0xF).sum())
        put(tags_arr.tobytes())
        put(
            np.full(enc.n_open_clips, DRAW_TAG_END_CLIP, dtype=np.uint32).tobytes()
        )
        # Draw data stream.
        layout.draw_data_base = pos // 4
        put(draw_data.tobytes())
        # Transform stream.
        layout.transform_base = pos // 4
        put(np.array(enc.transforms, dtype=np.float32).tobytes())
        # Style stream.
        layout.style_base = pos // 4
        if enc.styles:
            styles = np.zeros((len(enc.styles), 2), dtype=np.uint32)
            styles[:, 0] = np.array([s[0] for s in enc.styles], dtype=np.uint64).astype(
                np.uint32
            )
            styles[:, 1] = (
                np.array([s[1] for s in enc.styles], dtype=np.float32)
                .view(np.uint32)
            )
            put(styles.tobytes())

        layout.n_draw_objects = layout.n_paths

        scene = np.frombuffer(b"".join(parts), dtype=np.uint32).copy()
        return layout, scene
