"""Probabilistic membership and counting filters as device tensors.

Port of kmerutils_tpu/count/filters.py.  A filter is one flat tensor of
slots on a device; a key probes ``nb_hash`` slots derived from splitmix64 of
the key XOR a per-probe salt.

* :class:`BloomFilter`: uint8 slots; insert sets the probed slots to 1,
  ``contains`` is the AND over the probes, ``union`` an elementwise max;
* :class:`CountingBloom`: int32 slots; insert adds each key's increment to
  its probed slots, then clamps at 2^nb_bits - 1; ``estimate_count`` is
  the minimum over the probes and ``merge`` a clamped sum.

Both are immutable: insert, union and merge return a new filter.  A key
masked out touches no slot (JAX adds 0 to slot 0 for it).  Sums stay in
int32, as in JAX, so the clamp sees the same values.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops.bitops import as_u64, s64
from ..ops.rng import splitmix64

_SALT = 0x9E3779B97F4A7C15


def probe_indices(keys_u64: torch.Tensor, nb_hash: int,
                  log2_slots: int) -> torch.Tensor:
    """``nb_hash`` slot indices per key, int32 [..., nb_hash]: the low
    ``log2_slots`` bits of splitmix64(key ^ (i + 1) * 0x9E3779B97F4A7C15).
    Keys are u64 bit patterns (int32 tensors: u32 values)."""
    keys = as_u64(keys_u64)
    salts = torch.tensor([s64((i + 1) * _SALT) for i in range(nb_hash)],
                         dtype=torch.int64, device=keys.device)
    h = splitmix64(keys[..., None] ^ salts)
    return (h & ((1 << log2_slots) - 1)).to(torch.int32)


def _probes(keys, nb_hash: int, log2_slots: int, mask):
    """Flat int64 slot indices of the keys kept by ``mask``, and the
    mask's broadcast over the probes (None without a mask)."""
    idx = probe_indices(keys, nb_hash, log2_slots).to(torch.int64)
    if mask is None:
        return idx.reshape(-1), None
    keep = mask[..., None].expand(idx.shape)
    return idx[keep], keep


@dataclasses.dataclass(frozen=True)
class BloomFilter:
    slots: torch.Tensor  # uint8 [2^log2_slots]
    nb_hash: int
    log2_slots: int

    @staticmethod
    def create(log2_slots: int, nb_hash: int = 4,
               device="cuda") -> "BloomFilter":
        return BloomFilter(torch.zeros(1 << log2_slots, dtype=torch.uint8,
                                       device=device), nb_hash, log2_slots)

    def insert(self, keys_u64: torch.Tensor, mask=None) -> "BloomFilter":
        idx, _ = _probes(keys_u64, self.nb_hash, self.log2_slots, mask)
        return dataclasses.replace(self,
                                   slots=self.slots.index_fill(0, idx, 1))

    def contains(self, keys_u64: torch.Tensor) -> torch.Tensor:
        idx = probe_indices(keys_u64, self.nb_hash, self.log2_slots)
        return (self.slots[idx.to(torch.int64)] > 0).all(dim=-1)

    def union(self, other: "BloomFilter") -> "BloomFilter":
        return dataclasses.replace(self, slots=torch.maximum(self.slots,
                                                             other.slots))

    def fill_fraction(self) -> torch.Tensor:
        """Share of set slots, float64."""
        return torch.count_nonzero(self.slots).to(torch.float64) \
            / self.slots.numel()


@dataclasses.dataclass(frozen=True)
class CountingBloom:
    slots: torch.Tensor  # int32 [2^log2_slots]
    nb_hash: int
    log2_slots: int
    nb_bits: int

    @staticmethod
    def create(log2_slots: int, nb_hash: int = 4, nb_bits: int = 8,
               device="cuda") -> "CountingBloom":
        return CountingBloom(torch.zeros(1 << log2_slots, dtype=torch.int32,
                                         device=device),
                             nb_hash, log2_slots, nb_bits)

    @property
    def max_count(self) -> int:
        return (1 << self.nb_bits) - 1

    def insert(self, keys_u64: torch.Tensor, increments=None,
               mask=None) -> "CountingBloom":
        """Add each key (with its increment, 1 by default) to its probed
        slots, then clamp every slot at ``max_count``."""
        idx, keep = _probes(keys_u64, self.nb_hash, self.log2_slots, mask)
        shape = keys_u64.shape + (self.nb_hash,)
        if increments is None:
            inc = torch.ones(shape, dtype=torch.int32, device=idx.device)
        else:
            inc = torch.as_tensor(increments, device=idx.device) \
                .to(torch.int32)[..., None].expand(shape)
        inc = inc.reshape(-1) if keep is None else inc[keep]
        slots = self.slots.index_add(0, idx, inc)
        return dataclasses.replace(self, slots=slots.clamp_(
            max=self.max_count))

    def estimate_count(self, keys_u64: torch.Tensor) -> torch.Tensor:
        idx = probe_indices(keys_u64, self.nb_hash, self.log2_slots)
        return self.slots[idx.to(torch.int64)].min(dim=-1).values

    def merge(self, other: "CountingBloom") -> "CountingBloom":
        return dataclasses.replace(self, slots=(self.slots + other.slots)
                                   .clamp_(max=self.max_count))
