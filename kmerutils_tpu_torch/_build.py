"""Build and load the CUDA kernels of ``csrc/`` (nvcc -> shared library ->
ctypes).

The library is compiled at first use for Hopper (``sm_90a``) into
``build/kernels/`` at the repository root, under a name keyed by a hash of
the sources and flags, so an edited source rebuilds and an unchanged one
loads at once.  Each ``.cu`` file compiles in its own nvcc process, all
started together, and one more nvcc call links the objects into the shared
library.  The kernels expose plain C entry points (no PyTorch headers),
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
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

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
    vp, ci, ll, cu = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_uint
    lib.launch_tournament_u32.restype = ci
    lib.launch_tournament_u32.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, vp]
    lib.launch_tournament_u64.restype = ci
    lib.launch_tournament_u64.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci,
                                          ci, vp]
    lib.aggregate_scratch_words.restype = ll
    lib.aggregate_scratch_words.argtypes = [ll]
    lib.launch_merge.restype = ci
    lib.launch_merge.argtypes = [ci, ci, ci, vp, vp, vp, ll, vp, vp, ll,
                                 vp, vp, vp, ll, vp]
    lib.launch_aggregate.restype = ci
    lib.launch_aggregate.argtypes = [ci, ci, ci, vp, vp, vp, ll, cu, cu,
                                     vp, vp, vp, vp, vp]
    vpp = ctypes.POINTER(vp)
    lib.compact_scratch_words.restype = ll
    lib.compact_scratch_words.argtypes = [ll]
    lib.launch_compact.restype = ci
    lib.launch_compact.argtypes = [ci, vpp, vpp, ll, vp, vp]


def launch(fn, *args, device) -> None:
    """Call a C launcher with the current stream of ``device`` appended;
    raise when it returns a CUDA error."""
    import torch
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} failed: CUDA error {rc}")


def _compile(path: str) -> None:
    """nvcc -c of every source in parallel, then one nvcc link."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    srcs = [s for s in _sources() if s.endswith(".cu")]
    jobs = []
    for src in srcs:
        obj = f"{tmp}.{os.path.basename(src)}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    output, failed = [], []
    for cmd, _obj, proc in jobs:
        out, _ = proc.communicate()
        output.append(out)
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{out}")
    try:
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        cmd = [nvcc, "-shared", *ARCH_FLAGS, "-o", f"{tmp}.so",
               *[obj for _, obj, _ in jobs]]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{res.stderr}")
        os.replace(f"{tmp}.so", path)
    finally:
        for _, obj, _ in jobs:
            if os.path.exists(obj):
                os.remove(obj)
    build_info.update(seconds=time.perf_counter() - t0, path=path,
                      output="".join(output))


def load():
    """The kernels' ctypes library, compiled first if needed.  Raises when
    nvcc is missing or the build fails: there is no fallback."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not os.path.exists(path):
            _compile(path)
        lib = ctypes.CDLL(path)
        _declare(lib)
        _lib = lib
        return _lib
