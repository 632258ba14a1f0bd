"""Native (C++) host runtime components.

The reference's host side is compiled Go; the performance-relevant
pieces here are C++ driven through ctypes. Currently: the path encoder
(the hot loop of scene construction; reference encoding/path.go).

The shared library is built from source on first import if missing
(g++ required); the pure-Python implementations remain as fallbacks and
as the semantic oracle (tests/test_torch_host.py checks byte equality).

The port's own copy of `jello_tpu/native/__init__.py` (same text; only the imports
stay inside `jello_tpu_torch`, and the library is built into
`jello_tpu_torch/_build/`), so that the port imports nothing of
`jello_tpu`.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(__file__)
# Built beside the CUDA kernels, never beside the source.
_BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
_LIB_PATH = os.path.join(_BUILD_DIR, "_encoder.so")
_lib = None


def _build() -> bool:
    src = os.path.join(_DIR, "encoder.cpp")
    try:
        os.makedirs(_BUILD_DIR, exist_ok=True)
        # Several processes may build at once (test workers): each writes
        # its own file and renames it into place, so no one loads a
        # half-written library.
        tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
        subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-o", tmp, src],
            check=True,
            capture_output=True,
        )
        os.replace(tmp, _LIB_PATH)
        return True
    except Exception:
        return False


def _stale() -> bool:
    """True when the .so is missing or older than encoder.cpp."""
    if not os.path.exists(_LIB_PATH):
        return True
    src = os.path.join(_DIR, "encoder.cpp")
    try:
        return os.path.getmtime(src) > os.path.getmtime(_LIB_PATH)
    except OSError:
        return True


def get_lib():
    """Load (building if needed or stale) the native library, or None."""
    global _lib
    if _lib is not None:
        return _lib
    if _stale() and not _build():
        if not os.path.exists(_LIB_PATH):
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        if not _build():
            return None
        lib = ctypes.CDLL(_LIB_PATH)
    lib.jello_encode_path.restype = ctypes.c_int32
    lib.jello_encode_path.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
    ]
    _lib = lib
    return lib


def encode_path_native(path, is_fill: bool):
    """Encode a BezPath via the native encoder.

    Returns (tags uint8 array, data float32 array, n_segments) or None
    if the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    els = path.elements
    n = len(els)
    kinds = np.zeros(n, dtype=np.uint8)
    pts = np.zeros((n, 6), dtype=np.float32)
    for i, el in enumerate(els):
        kinds[i] = int(el.kind)
        for j, p in enumerate(el.points):
            pts[i, 2 * j] = p.x
            pts[i, 2 * j + 1] = p.y
    tags = np.zeros(4 * n + 8, dtype=np.uint8)
    data = np.zeros(6 * n + 16, dtype=np.float32)
    ntags = ctypes.c_int32(0)
    ndata = ctypes.c_int32(0)
    nsegs = lib.jello_encode_path(
        kinds.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n,
        1 if is_fill else 0,
        tags.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.byref(ntags),
        ctypes.byref(ndata),
    )
    return tags[: ntags.value], data[: ndata.value], int(nsegs)
