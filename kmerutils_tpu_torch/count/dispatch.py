"""Shard dispatch of k-mers across counters or devices.

Port of kmerutils_tpu/count/dispatch.py: a k-mer goes to shard
``wang_hash(value) % n_shards``; the invertible hash spreads AT/CG-skewed
canonical k-mers evenly.  u32 values (k <= 16) take the 32-bit hash, u64
values the 64-bit one, whose unsigned modulo goes through
``ops/bitops.urem64`` (a signed ``%`` is wrong for hashes >= 2^63).  Runs on
the device of the tensor given.
"""

from __future__ import annotations

import torch

from ..ops.bitops import M32, as_u64, urem64
from ..ops.rng import wang_hash32, wang_hash64


def dispatch_u32(values: torch.Tensor, n_shards: int) -> torch.Tensor:
    """Shard id (int32) of 32-bit k-mer values (int64 carriers or int32
    bit patterns; only the low 32 bits count)."""
    h = wang_hash32(values.to(torch.int64) & M32)
    return (h % n_shards).to(torch.int32)


def dispatch_u64(values: torch.Tensor, n_shards: int) -> torch.Tensor:
    """Shard id (int32) of 64-bit k-mer values (u64 bit patterns in int64;
    int32 tensors are u32 values)."""
    return urem64(wang_hash64(as_u64(values)), n_shards).to(torch.int32)


def dispatch(values: torch.Tensor, n_shards: int, k: int) -> torch.Tensor:
    """Shard by the width the k-mers of this k use."""
    if k <= 16:
        return dispatch_u32(values, n_shards)
    return dispatch_u64(values, n_shards)
