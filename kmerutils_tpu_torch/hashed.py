"""Hashed-item wrappers (the reference's hashed.rs).

Port of kmerutils_tpu/hashed.py.  The reference threads (hash, item)
pairs through its minhash heaps: ``HashedItem{hash, Option<item>}`` ordered
by hash; ``HashCount{hashed, count}``; and invertible-hash flavours that
drop the item, since it is recoverable (``InvHashedItem`` /
``InvHashCount``).  On the device these never exist per object: sketches
are (hash, count) tensors (sketch/minhash.py).  These dataclasses are the
host boundary types, with the same ordering and recovery.
"""

from __future__ import annotations

import dataclasses
from typing import Generic, Optional, TypeVar

import torch

from .ops.bitops import M32, s64
from .ops.rng import wang_hash32_inv, wang_hash64_inv

T = TypeVar("T")


@dataclasses.dataclass(frozen=True, order=True)
class HashedItem(Generic[T]):
    """(hash, item), ordered by hash."""
    hash: int
    item: Optional[T] = dataclasses.field(default=None, compare=False)


@dataclasses.dataclass(frozen=True, order=True)
class HashCount(Generic[T]):
    """Hashed item and its multiplicity."""
    hashed: HashedItem
    count: int = dataclasses.field(default=1, compare=False)


@dataclasses.dataclass(frozen=True, order=True)
class InvHashedItem:
    """Invertibly hashed k-mer: only the hash is stored, the k-mer value is
    recovered from it (``wide``: a u64 hash, else a u32 one)."""
    hash: int
    wide: bool = dataclasses.field(default=False, compare=False)

    def recover(self) -> int:
        """The k-mer value whose Wang hash is ``hash``."""
        if self.wide:
            # the u64 value travels as its int64 bit pattern
            x = torch.tensor([s64(self.hash)], dtype=torch.int64)
            return int(wang_hash64_inv(x)[0]) & ((1 << 64) - 1)
        x = torch.tensor([self.hash & M32], dtype=torch.int64)
        return int(wang_hash32_inv(x)[0])


@dataclasses.dataclass(frozen=True, order=True)
class InvHashCount:
    """InvHashedItem and its count."""
    hashed: InvHashedItem
    count: int = dataclasses.field(default=1, compare=False)
