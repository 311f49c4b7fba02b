"""Classic bottom-k MinHash with counts, and its invertible-hash variant.

Port of kmerutils_tpu/sketch/minhash.py.  Per read: sort the item hashes,
take run lengths, and keep the ``size`` smallest distinct hashes with their
occurrence counts.  The invertible variant stores Wang hashes of the k-mers,
so the k-mers come back through :func:`invert_sketch`.

Hashes are u64 bit patterns in int64 tensors, ordered unsigned (a sign
flip); the all-ones SENTINEL (-1) pads a row, and a real hash equal to it
drops, as in the JAX package.  Runs on the device of the tensors given.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.bitops import M32, as_u64, flip64, s64
from ..ops.rng import splitmix64, wang_hash32, wang_hash32_inv, \
    wang_hash64, wang_hash64_inv
from ..ops.weights import _run_multiplicities
from .jaccard import _host_unsigned

SENTINEL = np.uint64(0xFFFFFFFFFFFFFFFF)
_SENTINEL64 = -1     # its int64 bit pattern


def bottomk_sketch(hashes: torch.Tensor, valid: torch.Tensor, size: int):
    """The ``size`` smallest distinct hashes of each row, with counts.

    hashes int64 [n, P] (u64 bit patterns), valid bool [n, P] ->
    (sketch int64 [n, min(size, P)] padded with SENTINEL, ascending
    unsigned; counts int32 [n, min(size, P)], 0 in padding)."""
    h = torch.where(valid, as_u64(hashes), _SENTINEL64)
    s = flip64(torch.sort(flip64(h), dim=1).values)
    is_real = s != _SENTINEL64
    n, P = s.shape
    new_run = torch.ones_like(is_real)
    new_run[:, 1:] = s[:, 1:] != s[:, :-1]
    new_run &= is_real
    run_count = _run_multiplicities(s, is_real)
    # compaction: the run heads are distinct and ascending and every other
    # entry is (SENTINEL, 0), so an unsigned sort of the masked keys moves
    # the heads to the front in order; ties are only among the padding
    dv = torch.where(new_run, s, _SENTINEL64)
    dc = torch.where(new_run, run_count, 0).to(torch.int32)
    keys, order = torch.sort(flip64(dv), dim=1)
    w = min(size, P)
    return flip64(keys[:, :w]), torch.gather(dc, 1, order[:, :w])


def sketch_items(items: torch.Tensor, valid: torch.Tensor, size: int,
                 seed: int = 0):
    """Bottom-k sketch of splitmix64-hashed items (u64 bit patterns, or
    u32 values as int32)."""
    return bottomk_sketch(splitmix64(as_u64(items) ^ s64(seed)), valid,
                          size)


def sketch_items_invhash(items: torch.Tensor, valid: torch.Tensor, size: int,
                         wide: bool = False):
    """Bottom-k of Wang-hashed k-mers (64-bit hash when ``wide``, else the
    32-bit hash of the low 32 bits); only hashes are stored, the k-mers are
    recovered by :func:`invert_sketch`."""
    if wide:
        h = wang_hash64(as_u64(items))
    else:
        h = wang_hash32(as_u64(items) & M32)
    return bottomk_sketch(h, valid, size)


def invert_sketch(sketch: torch.Tensor, wide: bool = False) -> torch.Tensor:
    """The k-mers of an invertible-hash sketch: u64 bit patterns when
    ``wide``, else u32 values (of the low 32 bits) in int64."""
    if wide:
        return wang_hash64_inv(as_u64(sketch))
    return wang_hash32_inv(as_u64(sketch) & M32)


def minhash_distance(sk_a, sk_b):
    """(containment, jaccard, common, total) of two bottom-k sketches: walk
    both sorted lists and count matches among the ``size`` smallest of the
    union (host code)."""
    a = _host_unsigned(sk_a).astype(np.uint64)
    b = _host_unsigned(sk_b).astype(np.uint64)
    a = a[a != SENTINEL]
    b = b[b != SENTINEL]
    size = max(len(a), len(b))
    i = j = 0
    common = 0
    total = 0
    while i < len(a) and j < len(b) and total < size:
        if a[i] < b[j]:
            i += 1
        elif b[j] < a[i]:
            j += 1
        else:
            i += 1
            j += 1
            common += 1
        total += 1
    if total < size:
        total = min(size, total + (len(a) - i) + (len(b) - j))
    containment = common / max(i, 1)
    jaccard = common / max(total, 1)
    return containment, jaccard, common, total
