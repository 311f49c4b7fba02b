"""ctypes binding to the native C++ FASTA/FASTQ parser (native/fastx.cpp)
and wavelet-matrix builder (native/wavelet.cpp).

The port builds its own copy of the library from ``native/*.cpp`` into
``build/native/`` at the repository root (git-ignored), under a name keyed
by a hash of the sources and the compiler command, at first use.  The
build runs under a file lock, writes a temporary name and moves it into
place with ``os.replace``, so concurrent processes neither race on the
file nor load half of it; the JAX package's ``native/libktpnative.so`` is
never written or read.  When the compiler is missing or the build or the
load fails, ``available()`` is False and io/fastx.py parses in Python
instead.  This is host parsing: nothing here touches the device.
"""

from __future__ import annotations

import ctypes
import fcntl
import glob
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np

_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..")
_NATIVE_DIR = os.path.normpath(os.path.join(_ROOT, "native"))
_BUILD_DIR = os.path.normpath(os.path.join(_ROOT, "build", "native"))
# native/Makefile's flags
_FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-shared"]
_LIBS = ["-lz", "-lpthread"]

_lib = None
_tried = False
_lock = threading.Lock()


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(_NATIVE_DIR, "*.cpp")))


def library_path() -> str:
    """Where the library for the current sources and compiler lives."""
    h = hashlib.sha256()
    cmd = [os.environ.get("CXX", "g++")] + _FLAGS + _LIBS
    h.update(" ".join(cmd).encode())
    for src in _sources():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + f.read())
    return os.path.join(_BUILD_DIR, f"libktpnative_{h.hexdigest()[:16]}.so")


def _build(path: str) -> bool:
    """Compile the sources into ``path`` unless another process already
    has; True when the library is there."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    with open(os.path.join(_BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(path):
            return True
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run([os.environ.get("CXX", "g++")] + _FLAGS
                           + _sources() + ["-o", tmp] + _LIBS,
                           check=True, capture_output=True)
            os.replace(tmp, path)
            return True
        except (OSError, subprocess.CalledProcessError):
            return False
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        path = library_path()
        try:
            if not _build(path):
                return None
            lib = ctypes.CDLL(path)
            _declare(lib)
        except (OSError, AttributeError):  # no library, or a stale one
            return None
        _lib = lib
        return _lib


def _declare(lib) -> None:
    """argtypes/restype of every entry point this binding calls."""
    lib.ktp_open.restype = ctypes.c_void_p
    lib.ktp_open.argtypes = [ctypes.c_char_p]
    lib.ktp_close.restype = None
    lib.ktp_close.argtypes = [ctypes.c_void_p]
    lib.ktp_next_block.restype = ctypes.c_long
    lib.ktp_next_block.argtypes = [
        ctypes.c_void_p,
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        ctypes.c_long,
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        ctypes.c_long,
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
    ]
    lib.ktp_next_block_packed.restype = ctypes.c_long
    lib.ktp_next_block_packed.argtypes = [
        ctypes.c_void_p,
        np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"),
        ctypes.c_long,
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ctypes.c_long,
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        ctypes.c_int32,
    ]
    lib.ktp_next_block_qual.restype = ctypes.c_long
    lib.ktp_next_block_qual.argtypes = [
        ctypes.c_void_p,
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        ctypes.c_long,
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        ctypes.c_long,
    ]
    lib.ktp_wavelet_build.restype = ctypes.c_long
    lib.ktp_wavelet_build.argtypes = [
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        ctypes.c_long,
        ctypes.c_int,
        np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
    ]


def available() -> bool:
    return _load() is not None


class NativeFastxReader:
    """Streaming reader over one file; ``stats`` accumulates
    {bases, bad_bases, bad_reads, records}."""

    def __init__(self, path: str, block_reads: int = 10000,
                 block_bases: int = 1 << 26):
        lib = _load()
        if lib is None:
            raise RuntimeError("native parser unavailable")
        self._lib = lib
        self._h = lib.ktp_open(path.encode())
        if not self._h:
            raise FileNotFoundError(path)
        self.block_reads = block_reads
        self.block_bases = block_bases
        self.stats = np.zeros(4, dtype=np.int64)

    def __iter__(self):
        """Yield (codes uint8 concatenated, offsets int64[n+1]) blocks."""
        codes = np.empty(self.block_bases, dtype=np.uint8)
        offsets = np.empty(self.block_reads + 1, dtype=np.int64)
        try:
            while True:
                n = self._lib.ktp_next_block(
                    self._h, codes, codes.size, offsets, self.block_reads,
                    self.stats)
                if n < 0:
                    raise RuntimeError("native parser error (bad format or "
                                       "single read larger than block_bases)")
                if n == 0:
                    return
                yield codes[: offsets[n]].copy(), offsets[: n + 1].copy()
        finally:
            self.close()

    def packed_blocks(self, n_threads: int | None = None):
        """Yield (words uint32 flat, word_offsets int64[n+1], lengths
        int32[n]): reads already in the ReadBatch word layout (each read
        starts at a fresh word), encoded by ``n_threads`` C++ threads.
        Reads with a non-ACGT base never appear."""
        if n_threads is None:
            n_threads = min(8, os.cpu_count() or 1)
        cap_words = self.block_bases // 16 + self.block_reads
        words = np.empty(cap_words, dtype=np.uint32)
        woff = np.empty(self.block_reads + 1, dtype=np.int64)
        lens = np.empty(self.block_reads, dtype=np.int32)
        try:
            while True:
                n = self._lib.ktp_next_block_packed(
                    self._h, words, cap_words, woff, lens, self.block_reads,
                    self.stats, int(n_threads))
                if n < 0:
                    raise RuntimeError("native parser error (bad format or "
                                       "single read larger than block_bases)")
                if n == 0:
                    return
                yield (words[: woff[n]].copy(), woff[: n + 1].copy(),
                       lens[:n].copy())
        finally:
            self.close()

    def close(self):
        if self._h:
            self._lib.ktp_close(self._h)
            self._h = None


def iter_clean_read_codes(path: str, block_reads: int = 10000):
    """Yield the 2-bit code array (uint8) of every pure-ACGT read."""
    for codes, offsets in NativeFastxReader(path, block_reads):
        for i in range(len(offsets) - 1):
            yield codes[offsets[i] : offsets[i + 1]]


def wavelet_build(vals: np.ndarray, bit_len: int):
    """Build the levels of a wavelet matrix natively (native/wavelet.cpp).

    vals: uint8[n] symbols < 2**bit_len.  Returns (words u64[bit_len, nw],
    sub u16[bit_len, nw], sup u32[bit_len, nsup + 1], zeros i64[bit_len]) in
    the layout of ``quality._BitVecRank``, or None when the library is not
    available or the build fails.
    """
    lib = _load()
    if lib is None:
        return None
    vals = np.ascontiguousarray(vals, dtype=np.uint8)
    n = vals.size
    nw = (n + 63) // 64
    nsup = (nw + 7) // 8
    words = np.empty((bit_len, nw), dtype=np.uint64)
    sub = np.empty((bit_len, nw), dtype=np.uint16)
    sup = np.empty((bit_len, nsup + 1), dtype=np.uint32)
    zeros = np.empty(bit_len, dtype=np.int64)
    rc = lib.ktp_wavelet_build(vals, n, int(bit_len), words.reshape(-1),
                               sub.reshape(-1), sup.reshape(-1), zeros)
    if rc != 0:
        return None
    return words, sub, sup, zeros


def iter_quality_blocks(path: str, block_reads: int = 10000,
                        cap_bytes: int = 64 << 20):
    """Yield (quality bytes uint8[...], offsets int64[n + 1]) blocks of the
    raw quality lines of EVERY read of a 4-line FASTQ: no read is dropped
    for a non-ACGT base, so read numbers match a scan of the whole file.
    Raises ValueError on a record the native parser cannot take (wrapped
    FASTQ, FASTA, a block overflow)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native parser unavailable")
    h = lib.ktp_open(path.encode())
    if not h:
        raise OSError(f"cannot open {path}")
    try:
        quals = np.empty(cap_bytes, dtype=np.uint8)
        offsets = np.empty(block_reads + 1, dtype=np.int64)
        while True:
            n = lib.ktp_next_block_qual(h, quals, cap_bytes, offsets,
                                        block_reads)
            if n == 0:
                return
            if n < 0:
                raise ValueError(f"{path}: native quality parse failed "
                                 "(overflow or non-FASTQ)")
            yield quals[: offsets[n]].copy(), offsets[: n + 1].copy()
    finally:
        lib.ktp_close(h)
