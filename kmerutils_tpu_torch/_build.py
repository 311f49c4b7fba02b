"""Build and load the CUDA kernels of ``csrc/`` (nvcc -> shared library ->
ctypes).

The library is compiled at first use for Hopper (``sm_90a``) into
``build/kernels/`` at the repository root, under a name keyed by a hash of
the sources and flags, so an edited source rebuilds and an unchanged one
loads at once.  The kernels expose plain C entry points (no PyTorch headers),
which keeps the build to seconds.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(CSRC_DIR), "..", "build", "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None
build_info: dict = {}   # seconds, path and compiler output of the last build


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu"))
                  + glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.abspath(os.path.join(
        BUILD_DIR, f"libkmerutils_kernels_{h.hexdigest()[:16]}.so"))


def _declare(lib) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.launch_tournament_u32.restype = ci
    lib.launch_tournament_u32.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, vp]
    lib.launch_tournament_u64.restype = ci
    lib.launch_tournament_u64.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci,
                                          ci, vp]


def load():
    """The kernels' ctypes library, compiled first if needed.  Raises when
    nvcc is missing or the build fails: there is no fallback."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not os.path.exists(path):
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *[
                s for s in _sources() if s.endswith(".cu")]]
            t0 = time.perf_counter()
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                                   f"{' '.join(cmd)}\n{res.stderr}")
            os.replace(tmp, path)
            build_info.update(seconds=time.perf_counter() - t0, path=path,
                              output=res.stdout + res.stderr)
        lib = ctypes.CDLL(path)
        _declare(lib)
        _lib = lib
        return _lib
