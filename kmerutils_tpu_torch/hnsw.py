"""HNSW graph index over sketch signatures: a ctypes binding to the native
C++ index (native/hnsw.cpp, in native/libktpnative.so).

Port of kmerutils_tpu/hnsw.py through this package's own library loader
(io/native.py), so it imports no JAX.  Same entry points, parameters and
graph file.  'hamming' is the fraction of unequal u32 slots, 'l2' the
squared Euclidean distance of float32 vectors.  Insertion with more than
one thread builds a graph that differs from run to run; with
``n_threads=1`` the graph, and its file, are a function of the input.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from .io.native import _load

_DIST = {"hamming": 0, "l2": 1}
_declared = False


def _lib():
    global _declared
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable (run `make -C native`)")
    if not _declared:
        c = ctypes
        u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
        lib.hnsw_create.restype = c.c_void_p
        lib.hnsw_create.argtypes = [c.c_int32, c.c_int32, c.c_int64,
                                    c.c_int32, c.c_int32, c.c_uint64]
        lib.hnsw_free.restype = None
        lib.hnsw_free.argtypes = [c.c_void_p]
        lib.hnsw_size.restype = c.c_int64
        lib.hnsw_size.argtypes = [c.c_void_p]
        lib.hnsw_insert_batch.restype = c.c_int64
        lib.hnsw_insert_batch.argtypes = [c.c_void_p, u32p, c.c_int64,
                                          c.c_int32]
        lib.hnsw_search.restype = None
        lib.hnsw_search.argtypes = [
            c.c_void_p, u32p, c.c_int64, c.c_int32, c.c_int32,
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            c.c_int32]
        lib.hnsw_save.restype = c.c_int32
        lib.hnsw_save.argtypes = [c.c_void_p, c.c_char_p]
        lib.hnsw_load.restype = c.c_void_p
        lib.hnsw_load.argtypes = [c.c_char_p]
        _declared = True
    return lib


def available() -> bool:
    try:
        _lib()
    except RuntimeError:
        return False
    return True


def _as_rows(x, dist: str) -> np.ndarray:
    """Rows of 4-byte cells as the C side takes them (f32 viewed as u32)."""
    dt = np.float32 if dist == "l2" else np.uint32
    a = np.ascontiguousarray(np.asarray(x), dtype=dt)
    if a.ndim == 1:
        a = a[None, :]
    return a.view(np.uint32)


def _threads(n_threads: int | None) -> int:
    return min(8, os.cpu_count() or 1) if n_threads is None else n_threads


class Hnsw:
    """HNSW index of ``dim``-slot vectors, at most ``capacity`` of them."""

    def __init__(self, dim: int, capacity: int, dist: str = "hamming",
                 max_nb_connection: int = 24, ef_construction: int = 400,
                 seed: int = 0):
        if dist not in _DIST:
            raise ValueError(f"unknown distance {dist!r}")
        self.dim = int(dim)
        self.capacity = int(capacity)
        self.dist = dist
        self._h = _lib().hnsw_create(_DIST[dist], self.dim, self.capacity,
                                     int(max_nb_connection),
                                     int(ef_construction), int(seed))
        if not self._h:
            raise ValueError("bad HNSW parameters")

    def __len__(self) -> int:
        return int(_lib().hnsw_size(self._h))

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            _lib().hnsw_free(h)
            self._h = None

    def parallel_insert(self, vecs, n_threads: int | None = None) -> int:
        """Insert the rows of ``vecs``; returns the element count."""
        a = _as_rows(vecs, self.dist)
        if a.shape[1] != self.dim:
            raise ValueError(f"dim mismatch: {a.shape[1]} != {self.dim}")
        out = _lib().hnsw_insert_batch(self._h, a, a.shape[0],
                                       _threads(n_threads))
        if out < 0:
            raise RuntimeError("HNSW capacity exceeded")
        return int(out)

    def insert(self, vec) -> int:
        return self.parallel_insert(vec, n_threads=1)

    def search(self, queries, k: int, ef_search: int = 64,
               n_threads: int | None = None):
        """k nearest neighbours: (ids int64[nq, k], -1 padded; distances
        float32[nq, k])."""
        q = _as_rows(queries, self.dist)
        if q.shape[1] != self.dim:
            raise ValueError(f"dim mismatch: {q.shape[1]} != {self.dim}")
        nq = q.shape[0]
        ids = np.empty(nq * k, dtype=np.int64)
        d = np.empty(nq * k, dtype=np.float32)
        _lib().hnsw_search(self._h, q, nq, int(k), int(ef_search), ids, d,
                           _threads(n_threads))
        return ids.reshape(nq, k), d.reshape(nq, k)

    def file_dump(self, path: str) -> None:
        """Write the graph and its vectors to ``path``."""
        if _lib().hnsw_save(self._h, path.encode()) != 0:
            raise OSError(f"cannot write {path}")

    @classmethod
    def load(cls, path: str) -> "Hnsw":
        h = _lib().hnsw_load(path.encode())
        if not h:
            raise OSError(f"cannot load HNSW from {path}")
        with open(path, "rb") as f:
            head = np.frombuffer(f.read(44), dtype=np.uint8)
        obj = cls.__new__(cls)
        obj._h = h
        obj.dist = {v: k for k, v in _DIST.items()}[
            int(head[8:12].view(np.uint32)[0])]
        obj.dim = int(head[12:16].view(np.uint32)[0])
        obj.capacity = int(head[36:44].view(np.int64)[0])
        return obj
