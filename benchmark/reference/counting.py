"""Plain k-mer counting over weighted batches, in plain PyTorch: count(key)
= the sum over batches b of m_b x (the occurrences of key among b's
canonical k-mers), saturating at 2^32 - 1.

Keys are int64 (``reference/kmers.py``: the canonical value, at k = 32 the
u64 bit pattern).  So that it fits the card beside what a run leaves, the
work is split into ``n_slices`` slices by a mix of the key (canonical keys
crowd low values, so their top bits would split them unevenly): each
batch's keys are cut into the slices as they come, and a slice is counted
on its own, by one sort and a weighted sum over each run of equal keys.
Imports nothing of the program.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF


def key_slice(keys: torch.Tensor, n_slices: int) -> torch.Tensor:
    """The slice of each int64 key: its two 32-bit halves xored and mixed
    (lowbias32, multiplied on 16-bit limbs so that no product passes
    2^63), modulo ``n_slices``."""
    h = (keys & M32) ^ ((keys >> 32) & M32)
    for c in (0x7FEB352D, 0x846CA68B):
        h = h ^ (h >> 16)
        h = ((h * (c & 0xFFFF)) + (((h * (c >> 16)) & 0xFFFF) << 16)) & M32
    h = h ^ (h >> 16)
    return h % n_slices


def split(n_slices: int, keys: torch.Tensor, *values) -> list:
    """[(keys, *values)] of each slice of ``keys``, in slice order; each of
    ``values`` is cut beside the keys."""
    s = key_slice(keys, n_slices)
    order = torch.argsort(s)
    sizes = torch.bincount(s, minlength=n_slices).tolist()
    return list(zip(*[torch.split(t[order], sizes) for t in (keys, *values)]))


class Counter:
    """Weighted canonical k-mers, sliced by :func:`key_slice`."""

    def __init__(self, n_slices: int = 16):
        self.n_slices = n_slices
        self.parts: list = [[] for _ in range(n_slices)]

    def add(self, keys: torch.Tensor, weight: int) -> None:
        """Count each of ``keys`` (int64) ``weight`` times."""
        if weight <= 0 or keys.numel() == 0:
            return
        for part, (chunk,) in zip(self.parts, split(self.n_slices, keys)):
            if chunk.numel():
                part.append((chunk, int(weight)))

    def counts(self, i: int):
        """(keys ascending as int64, counts int64) of slice ``i``."""
        part = self.parts[i]
        if not part:
            z = torch.zeros(0, dtype=torch.int64)
            return z, z
        keys = torch.cat([k for k, _ in part])
        w = torch.cat([torch.full((k.numel(),), m, dtype=torch.int64,
                                  device=k.device) for k, m in part])
        keys, order = torch.sort(keys)
        w = w[order]
        head = torch.ones(keys.numel(), dtype=torch.bool, device=keys.device)
        head[1:] = keys[1:] != keys[:-1]
        rid = torch.cumsum(head.to(torch.int64), 0) - 1
        sums = torch.zeros(int(rid[-1]) + 1, dtype=torch.int64,
                           device=keys.device).index_add_(0, rid, w)
        return keys[head], sums.clamp(max=M32)


def keys_differ(got_keys, got_counts, want_keys, want_counts) -> int:
    """Keys whose count differs between two countings (int64 tensors on one
    device, keys distinct within each): keys in one and not the other, and
    keys in both with different counts."""
    if want_keys.numel() == 0:
        return int(got_keys.numel())
    gk, go = torch.sort(got_keys)
    gc = got_counts[go]
    wk, wo = torch.sort(want_keys)
    wc = want_counts[wo]
    at = torch.searchsorted(wk, gk).clamp(max=wk.numel() - 1)
    found = wk[at] == gk
    same = found & (wc[at] == gc)
    return int(gk.numel() - same.sum()) + int(wk.numel() - found.sum())
