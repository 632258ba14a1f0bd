"""Flatten's per-slot table kernel wrapper (kernel L, `csrc/slot_tables.cu`).

Replaces no Pallas kernel: jello_tpu leaves flatten's per-slot chain to
XLA. `slot_tables` launches kernel L for CUDA tensors and takes its plain
version, `pipeline.flatten.slot_tables_plain` (the torch chain of
`_read_points`, `_normalize_segment` and `slot_geometry`, which stays the
specification), only for CPU tensors; there is no fallback from one to
the other.

On the card a call is one ctypes call and one kernel: the scene, the
stage's decoded tags, the layout's 0-dim fields and the monoid's columns
go to the entry as they are, and it writes every table, allocated here
with `torch.empty` (inside a captured frame, from its pool).
"""

from __future__ import annotations

import torch

from ..pipeline import flatten
from ..pipeline.ops import F32, I32
from .build import check, check_tensor, kernels, stream_of

LAYOUT_KEYS = ("path_data_base", "style_base", "transform_base", "n_path_tags")
MONO_KEYS = ("path_idx", "path_seg_offset", "style_idx", "trans_idx")
EULER_COLS = 21  # tab2's columns
SA_COLS = 15  # the simple/arc table's


def slot_tables(scene, layout, tags_e, mono, N, tag_lo, n_paths_cap):
    """Flatten's per-slot tables (`flatten.slot_tables_plain`'s contract):
    scene int32 [S], S >= 1; layout's LAYOUT_KEYS 0-dim int32; tags_e the
    decoded tags, a contiguous int32 [Ne]; mono's MONO_KEYS int32 [Ne] of
    one stride (the rows of kernel I's [5, Ne] output), Ne >= N (Ne == N:
    the whole tag stream, slot N - 1's successor is slot 0; Ne > N: a
    tag-range shard from slot tag_lo, a multiple of 4); scene and layout
    contiguous; all on one device.
    Returns the dict of tables of `slot_tables_plain`."""
    if not isinstance(scene, torch.Tensor) or scene.dim() != 1 or scene.shape[0] < 1:
        raise ValueError("scene: expected a non-empty vector, got "
                         + (f"shape {tuple(scene.shape)}" if isinstance(scene, torch.Tensor)
                            else type(scene).__name__))
    dev = scene.device
    check_tensor("scene", scene, I32, dev, scene.shape)
    for k in LAYOUT_KEYS:
        check_tensor(k, layout[k], I32, dev, ())
    first = mono[MONO_KEYS[0]]
    Ne = first.shape[0] if isinstance(first, torch.Tensor) and first.dim() == 1 else -1
    if N < 1 or Ne < N:
        raise ValueError(f"mono: expected vectors of at least N = {N} >= 1 slots, got "
                         + (f"{Ne}" if Ne >= 0 else "no vector"))
    stride = first.stride(0) if Ne > 1 else 1
    for k in MONO_KEYS:
        c = mono[k]
        if (not isinstance(c, torch.Tensor) or c.dtype != I32 or c.device != dev
                or tuple(c.shape) != (Ne,) or (Ne > 1 and c.stride(0) != stride) or stride < 1):
            raise ValueError(
                f"{k}: expected an int32 vector of {Ne} on {dev} with stride {stride}, got "
                + (f"{c.dtype} {tuple(c.shape)} on {c.device} with stride {c.stride()}"
                   if isinstance(c, torch.Tensor) else type(c).__name__))
    check_tensor("tags_e", tags_e, I32, dev, (Ne,))
    if tag_lo < 0 or tag_lo % 4:
        raise ValueError(f"tag_lo: expected a multiple of 4 at least 0, got {tag_lo}")
    if not scene.is_cuda:
        return flatten.slot_tables_plain(scene, layout, tags_e, mono, N, tag_lo, n_paths_cap)
    out = {
        "tab2": torch.empty((2 * N, EULER_COLS), dtype=F32, device=dev),
        "counts2": torch.empty(2 * N, dtype=I32, device=dev),
        "sa": torch.empty((4 * N, SA_COLS), dtype=F32, device=dev),
        "orow": torch.empty((N, 3), dtype=I32, device=dev),
        "tot4": torch.empty(N, dtype=I32, device=dev),
        "tgt": torch.empty(N, dtype=I32, device=dev),
        "pmeta": torch.empty((N, 2), dtype=I32, device=dev),
        "arc_n": torch.empty(N, dtype=F32, device=dev),
    }
    check("jello_slot_tables", kernels().jello_slot_tables(
        scene.data_ptr(), tags_e.data_ptr(), *[layout[k].data_ptr() for k in LAYOUT_KEYS],
        *[mono[k].data_ptr() for k in MONO_KEYS], *[t.data_ptr() for t in out.values()],
        stride, scene.shape[0], N, Ne, tag_lo, n_paths_cap, stream_of(scene)))
    slot_tables.launches += 1
    return out


slot_tables.launches = 0
