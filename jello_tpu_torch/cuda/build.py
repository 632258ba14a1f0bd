"""Kernel loader: builds `jello_tpu_torch/csrc/*.cu` with nvcc into one
shared library with a plain C interface and binds it with ctypes (one
nvcc per source, all at once, then one link).

The build runs at first use, never at import: it compiles for `sm_90a`
with `-fmad=false` (no contraction of a*b+c into FMA, so the float
rounding follows the reference op by op) and without fast math (the
fine kernel relies on `x != x` NaN scrubs and on accurate expf/logf).
The library lands in `jello_tpu_torch/_build/` and is rebuilt when a
source is newer; a failed build raises with nvcc's stderr.

Each exported C function launches its kernel on the stream it is given
(kernel C's entry also zeroes its output there, kernel D's its
iteration count and kernel F's its region flag, with one memset each;
kernel E's entries launch the prefix scan before the expansion, kernel
I's a reduce kernel before its scan when the columns span more than one
tile, kernel K's copies the target into its output with one memcpy) and
returns `cudaGetLastError()`;
`check` raises if that is not 0.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
LIB_NAME = "libjello_kernels.so"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-fmad=false", "-Xcompiler", "-fPIC",
]

P = ctypes.c_void_p
I = ctypes.c_int
L = ctypes.c_longlong
# C signatures of the exported launchers (all return cudaError_t as int).
SIGNATURES = {
    # seg stream [SC, 8] f32, row_start [R] i32, row_end [R] i32,
    # row_bd [R] f32, out [R, 256] f32, R, stream
    "jello_coverage_area": [P, P, P, P, P, I, P],
    # seg stream, row_start, row_end, row_bd as above, row_eo [R] i32,
    # out [R, 256] f32, R, samples (8 or 16), stream
    "jello_coverage_msaa": [P, P, P, P, P, P, I, I, P],
    # samples (0 area, 8 or 16): kernel A's persistent CTAs on the current
    # device (a query, no launch; -1 on a CUDA error)
    "jello_coverage_grid": [I],
    # rec [PC, 16] i32, cov [>=PC, 256] f32, stops [NR, W] f32,
    # tile_start [GRID] i32, tile_end [GRID] i32, base [4] f32,
    # fg_tab [IRC, 1024] f32 or null, out [PC, 4, 256] f32, wit [] i32 (the
    # width in tiles, read on the device), GRID, NR, W, IRC, resolved (1: cov
    # holds resolved MSAA rows), stream
    "jello_fine_v2": [P, P, P, P, P, P, P, P, P, I, I, I, I, I, P],
    # pos [R] i32, keep [R] bool, three value vectors [R] (null past K),
    # their type codes (0 int32, 1 float32), out [K, out_len] f32 (zeroed
    # by the entry), R, K, out_len, stream
    "jello_monotone_land": [P, P, P, P, P, I, I, I, P, I, I, I, P],
    # table [NW, 21] f32, valid [NW] bool, rec [3, IT, NW] f32, count [NW]
    # f32, not_done [NW] bool, iters [] i32 (all written by the entry: one
    # memset of iters, one kernel), NW, IT, stream
    "jello_lockstep_walk": [P, P, P, P, P, P, I, I, P],
    # The expand entries take counts [R] i32, scratch [R + ceil(R /
    # cuda.expand.SCAN_TILE)] i32 and total [] i32 (the prefix, computed
    # by the entry) and write each output slot. Euler: table [NW, 21] f32, rec [3, IT, NW] f32,
    # counts, scratch, total, x0, y0, x1, y1 [EC] f32, path [EC] i32,
    # valid [EC] bool, NW, IT, EC, sentinel path, stream
    "jello_expand_euler": [P, P, P, P, P, P, P, P, P, P, P, I, I, I, I, P],
    # P [L, 21] f64, counts, scratch, total, x0, y0, x1, y1, y_edge [SC]
    # f64, tile_slot, bump_slot, bump_delta [SC] i32, L, SC, T, stream
    "jello_expand_crossings": [P, P, P, P, P, P, P, P, P, P, P, P, I, I, I, P],
    # PRT [L, 5] f64, counts, scratch, total, r_slot, r_delta [RC] i32, L,
    # RC, T, stream
    "jello_expand_rows": [P, P, P, P, P, P, I, I, I, P],
    # tap_rec [IRC, 16] i32, atlas [4, AHp, AWp] f32, out [IRC, 1024] f32,
    # region flag, one byte (the entry clears it with a memset), wit [] i32
    # (the width in tiles, read on the device), IRC, GRID, AHp, AWp, stream
    "jello_image_tap": [P, P, P, P, P, I, I, I, I, P],
    # F's CTAs resident on a multiprocessor (a query, no launch)
    "jello_image_tap_ctas": [],
    # counts [n + 1] i32 (then the width in tiles, read on the device),
    # tile_ids [n] i32, base [4] f32, slab [n, MC, 16] i32,
    # rows [R, 256] f32 (both 16-byte aligned), stops [NR, W] f32, atlas
    # [4, AHp, AWp] f32 or null, stack scratch (jello_fine_interp_scratch's
    # floats) or null, out [n, 4, 256] f32, ovf [n] i32, n, MC, R, NR, W,
    # BD, AHp, AWp, batch (0 kernel G, 1 kernel H), resolved (1: rows
    # hold resolved MSAA coverage), stream
    "jello_fine_interp": [P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, I, P],
    # n, BD, batch: floats of stack scratch the entry needs (a query)
    "jello_fine_interp_scratch": [I, I, I],
    # batch, BD: G's or H's CTAs resident on a multiprocessor (a query)
    "jello_fine_interp_ctas": [I, I],
    # kernel H at any point of its design space: jello_fine_interp's
    # arguments without batch, then the build (warps a slot, CTAs a
    # multiprocessor it is built for) and shared stack levels (0 to 4)
    "jello_fine_interp_h": [P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, I, I, I, P],
    # which (0 scratch floats, 1 resident CTAs, 2, 3, 4 the shipped warps,
    # CTAs and levels), n, BD, warps, min CTAs, levels (a query)
    "jello_fine_interp_h_query": [I, I, I, I, I, I],
    # slots [n] i64, slot, stream: the card's %globaltimer (ns) into
    # slots[slot] (the stage clock's stamp, `profiler.named_scope`)
    "jello_stamp": [P, I, P],
    # a host array of k column pointers (int32, N each, one stride),
    # stride, k, N, op (0 sum, 1 max), exclusive, out [k, N] i32, totals
    # [k] i32 or null, partial [k * ceil(N / cuda.scan.TILE)] i32 or null
    # (one tile), stream
    "jello_column_scan": [P, I, I, I, I, I, P, P, P, P],
    # line x0, y0, x1, y1 [L] f32, valid [L] bool, path [L] i32, the paths'
    # rect x0, y0, x1, y1 and tile offset [D] i32, P [L, 21] f64, the row
    # table [L, 5] f64, n_cross, n_rows [L] i32, L, D, stream
    "jello_line_dda": [P, P, P, P, P, P, P, P, P, P, P, P, P, P, P, I, I, P],
    # target [n, w] words, out [n, w] (the entry copies target into it,
    # then scatters), idx [m], idx64 (0 int32, 1 int64), vals [m, w], m,
    # n, w, op (0 set, 1 int32 add, 2 int32 max, 3 int32 min, 4 float32
    # max), vec (1: vals and out aligned for w-word vectors), stream
    "jello_drop_scatter": [P, P, P, I, P, L, L, I, I, I, P],
    # scene [S] i32; the layout's path_tag_base, path_data_base,
    # style_base, transform_base, n_path_tags (0-dim i32 on the device);
    # the monoid's path_idx, path_seg_offset, style_idx, trans_idx [Ne]
    # i32 (one stride); tab2 [2N, 21] f32, counts2 [2N] i32, sa [4N, 15]
    # f32, orow [N, 3] i32, tot4, tgt [N] i32, pmeta [N, 2] i32, arc_n [N]
    # f32; the monoid's stride, S, N, Ne, tag_lo, n_paths_cap, stream
    "jello_slot_tables": [P] * 18 + [L, L, I, I, I, I, P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _run(procs):
    """Wait for every (name, Popen) and raise with the stderr of the
    first that failed. Returns the stderr texts."""
    errs = []
    for name, proc in procs:
        _, err = proc.communicate()
        errs.append(err)
        if proc.returncode != 0:
            for _, other in procs:
                other.kill()
            raise RuntimeError(f"nvcc failed on {name} ({proc.returncode}):\n{err}")
    return errs


# nvcc's stderr of the last build, by source name (with `verbose`,
# ptxas's registers, shared memory and spills of every kernel).
LOG: dict[str, str] = {}


def build(verbose: bool = False, force: bool = False) -> Path:
    """Compile the kernels if the library is missing or older than a
    source (or always, with `force`): one nvcc per source, all started
    together, then one link. Returns the library path."""
    srcs = sorted(CSRC.glob("*.cu"))
    heads = sorted(CSRC.glob("*.cuh"))
    lib = BUILD / LIB_NAME
    newest = max(p.stat().st_mtime for p in srcs + heads)
    if not force and lib.exists() and lib.stat().st_mtime >= newest:
        return lib
    BUILD.mkdir(parents=True, exist_ok=True)
    tag = os.getpid()
    nvcc = _nvcc()
    flags = NVCC_FLAGS + (["-Xptxas=-v"] if verbose else [])
    objs = [BUILD / f"{s.stem}.{tag}.o" for s in srcs]
    errs = _run([(s.name, subprocess.Popen(
        [nvcc, *flags, "-c", "-I", str(CSRC), "-o", str(o), str(s)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for s, o in zip(srcs, objs)])
    tmp = BUILD / f"{LIB_NAME}.{tag}.tmp"
    _run([("link", subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp)] + [str(o) for o in objs],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))])
    for o in objs:
        o.unlink()
    LOG.clear()
    LOG.update({s.name: e for s, e in zip(srcs, errs)})
    if verbose:
        print("".join(errs))
    os.replace(tmp, lib)
    return lib


@functools.cache
def kernels() -> ctypes.CDLL:
    """The built and bound kernel library (built on first call)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def check_tensor(name, t, dtype, device, shape) -> None:
    """Raise unless t is a contiguous `dtype` tensor of `shape` on `device`."""
    import torch

    if not isinstance(t, torch.Tensor):
        raise ValueError(f"{name}: expected a {dtype} tensor {tuple(shape)} on {device}, got "
                         f"{type(t).__name__}")
    if (t.dtype != dtype or t.device != device or tuple(t.shape) != tuple(shape)
            or not t.is_contiguous()):
        raise ValueError(
            f"{name}: expected contiguous {dtype} {tuple(shape)} on {device}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device}"
            f"{'' if t.is_contiguous() else ' (not contiguous)'}")


def stream_of(t) -> int:
    """The raw handle of the current CUDA stream of t's device."""
    import torch

    return torch._C._cuda_getCurrentRawStream(t.get_device())


def pinned(t, device):
    """A host tensor made ready to copy to `device`: a copy in pinned
    memory for a CUDA device, else t itself."""
    import torch

    return t.pin_memory() if torch.device(device).type == "cuda" else t


def copy_to(t, device):
    """A `pinned` host tensor on `device`; a CUDA copy does not make the
    host wait for the queue (a pageable copy would)."""
    import torch

    device = torch.device(device)
    return t.to(device, non_blocking=device.type == "cuda")


def pinned_read(t):
    """Enqueue the read of a tensor's values to the host: (host tensor,
    CUDA event or None). From a CUDA device, one copy on the device's
    current stream into page-locked memory from torch's host cache,
    behind an event that must complete before the host tensor is read;
    the host tensor keeps that memory until it is dropped. A pageable
    read (`.cpu()`) stages through CUDA's own bounce buffer into memory
    the host allocates afresh, and how long that takes varies by process
    (on an H100's host, 5.3 ms for an 8.3 MB 1080p surface in some
    processes, about 1 ms in others). From any other device the values,
    and no event."""
    import torch

    if not t.is_cuda:
        return t.cpu(), None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(t.device))
    return host, event


def device_to_host(t):
    """A tensor's values as a host numpy array: `pinned_read`, waited for."""
    host, event = pinned_read(t)
    if event is not None:
        event.synchronize()
    return host.numpy()


def host_to_device(t, device):
    """A host tensor on `device` (`pinned`, then `copy_to`)."""
    return copy_to(pinned(t, device), device)
