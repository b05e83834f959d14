"""ctypes bridge to the port's JPEG batch decoder, `csrc/dataio.cpp`
(counterpart of ocl_tpu/data/native_io.py).

The library is built at first use with g++ and libjpeg by `ops/_build.py`,
as the CUDA kernels are: into `build/ocl_tpu_torch/` at the root of the
checkout, under a name keyed by a hash of its source and flags, so an edit
rebuilds it and a second process reuses it. It is host code: CORE50's
loader decodes its JPEGs with it, and falls back to PIL where it returns None
(`data/datasets.py::CORE50._load_imgs`, ocl_tpu's order).
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np

from ocl_tpu_torch.ops import _build

SOURCE = _build.PKG_DIR / "csrc" / "dataio.cpp"
GXX_FLAGS = ("-O2", "-shared", "-fPIC")
LINK = ("-ljpeg", "-lpthread")


def library_path():
    """Where the decoder's library lives, keyed by its source and flags."""
    return _build.library_path(SOURCE, GXX_FLAGS + LINK)


def build_library():
    """Compile the decoder unless its library exists; returns the library's
    path. Raises RuntimeError when g++ cannot run or the build fails (no
    libjpeg headers, for one)."""
    return _build.build(SOURCE, "g++", GXX_FLAGS, LINK)


@functools.cache
def load_library():
    """(the loaded library, None), or (None, why it could not be built or
    loaded). Built and loaded once a process."""
    try:
        lib = ctypes.CDLL(str(build_library()))
    except (RuntimeError, OSError) as e:   # no toolchain, or no libjpeg to load
        return None, str(e)
    lib.decode_jpeg_batch.restype = ctypes.c_int
    lib.decode_jpeg_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int]
    return lib, None


def decode_jpeg_batch(paths, h: int, w: int, n_threads: int | None = None):
    """uint8 [n, h, w, 3] decoded by the native thread pool, or None if the
    library cannot be built or any file is missing, corrupt or not h x w x 3
    (ocl_tpu's contract: the caller then decodes with PIL)."""
    lib, _ = load_library()
    if lib is None or not paths:
        return None
    n = len(paths)
    out = np.zeros((n, h, w, 3), np.uint8)
    c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    threads = n_threads or min(8, os.cpu_count() or 1)
    failures = lib.decode_jpeg_batch(
        c_paths, n, h, w, out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), threads)
    if failures:
        return None
    return out
