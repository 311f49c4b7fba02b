"""Signature dump, byte-compatible with the JAX package and the reference.

Port of the signature-dump half of kmerutils_tpu/io/formats.py (all
little-endian):

    u32 0xceabeadd | u32 sig_size (bytes) | u32 sketch_size | u32 kmer_size
    then the raw signature words of each read, in read order.
"""

from __future__ import annotations

import struct

import numpy as np

MAGIC_SIG_DUMP = 0xCEABEADD


def write_signature_dump(fname: str, kmer_size: int, signatures) -> None:
    """signatures: numpy [n_reads, sketch_size] of uint32 or uint64."""
    sigs = np.asarray(signatures)
    sig_size = sigs.dtype.itemsize
    n, m = sigs.shape
    with open(fname, "wb") as f:
        f.write(struct.pack("<IIII", MAGIC_SIG_DUMP, sig_size, m, kmer_size))
        dt = "<u4" if sig_size == 4 else "<u8"
        f.write(np.ascontiguousarray(sigs.astype(dt)).tobytes())


def read_signature_dump(fname: str):
    """-> (kmer_size, sketch_size, signatures [n, m] uint32/uint64)."""
    with open(fname, "rb") as f:
        magic, sig_size, m, kmer_size = struct.unpack("<IIII", f.read(16))
        if magic != MAGIC_SIG_DUMP:
            raise ValueError("bad magic for signature dump")
        dt = "<u4" if sig_size == 4 else "<u8"
        flat = np.frombuffer(f.read(), dtype=dt)
    if m and flat.size % m:
        raise ValueError("truncated signature dump")
    return kmer_size, m, flat.reshape(-1, m).copy()
