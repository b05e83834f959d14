"""Build and load the port's native libraries: the CUDA kernels (nvcc into a
plain-C shared library, bound with ctypes) and the host JPEG decoder (g++,
data/native_io.py).

A library is built at first use into `build/ocl_tpu_torch/` at the root of
the checkout, under a name keyed by a hash of its source and flags, so an edit
rebuilds it and a second process reuses it. A missing compiler or a failed
build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[1]
BUILD_DIR = PKG_DIR.parent / "build" / "ocl_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# source file -> {C entry: (argtypes, restype)}
LIBRARIES = {
    # (a, b, out, launch plan: ops/distance.py::CPlan, stream)
    "pairwise_sqdist.cu": {
        "ocl_pairwise_sqdist_f32": (
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p],
            ctypes.c_int),
        # (launch plan) -> blocks of its kernel one SM holds, -1 if not built
        "ocl_pairwise_sqdist_blocks_per_sm": ([ctypes.c_void_p], ctypes.c_int),
    },
}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
        if cand.is_file():
            nvcc = str(cand)
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
            "port's CUDA kernels are built with it at first use")
    return nvcc


def library_path(source, flags=NVCC_FLAGS) -> Path:
    """Where the library of `source` (a file of csrc/, or a path) lives,
    keyed by its content and `flags`."""
    text = (PKG_DIR / "csrc" / source).read_bytes()
    digest = hashlib.sha256(text + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / "lib{}_{}.so".format(Path(source).stem, digest)


def build(source, compiler=None, flags=NVCC_FLAGS, link=()) -> Path:
    """Compile `source` with `compiler` (nvcc when None) unless its library
    exists; returns the library path. The compiler's report (for nvcc:
    registers, shared memory, spills) is kept beside the library as `.log`.
    Raises RuntimeError when the compiler cannot run or the build fails."""
    so = library_path(source, tuple(flags) + tuple(link))
    if so.exists():
        return so
    compiler = compiler or find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [compiler, *flags, "-o", tmp, str(PKG_DIR / "csrc" / source), *link]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    except (OSError, subprocess.TimeoutExpired) as e:
        os.unlink(tmp)
        raise RuntimeError("{} could not run: {}".format(" ".join(cmd), e)) from e
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError("{} failed:\n{}\n{}".format(
            " ".join(cmd), proc.stdout, proc.stderr[-4000:]))
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, so)
    return so


@functools.cache
def load_library(source: str) -> ctypes.CDLL:
    """Build (if needed) and load the library of `source`, with argtypes and
    restype set on each C entry."""
    lib = ctypes.CDLL(str(build(source)))
    for name, (argtypes, restype) in LIBRARIES[source].items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib
