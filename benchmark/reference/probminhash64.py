"""Plain ProbMinHash (the PROB3A family of the reference crate) per read
over 64-bit k-mers (17 <= k <= 32), in plain PyTorch: the yardstick the
k=21 sketch cell holds the program to.

For read r, its items are Thomas Wang's hash64shift of its canonical
k-mers, u64 values, each weighted by its multiplicity in the read.  Slot s
of the read's signature is the item x that maximises

    e(x, s) = ln(u) * (1 / w_x),   u = ((h >> 8) + 1) * 2^-24,
    h = mix(f ^ c_s),  f = lo(x) ^ hi(x),
    mix: h * 0x9E3779B1, h ^ (h >> 15), h * 0x85EBCA77

(all u32 after the fold), i.e. minimises the exponential draw -ln(u) /
w_x; ties go to the smallest item in unsigned order.  c_s is the top half
of splitmix64(s) (seed 0).  The draw is computed in float32, the
configuration's precision: ``u`` exactly, then ln and the product each
rounded to float32.  A read without an item gets signature 0.

Departures from the published description (Ertl's ProbMinHash3a and the
reference crate's ``Kmer64bit`` path), each as the port and the JAX package
define the u64 family:

* the draw is not a stream of exponentials from a generator seeded by the
  item: it is one 32-bit mix of the item's 32-bit fold and the slot's
  constant, so two items with the same fold and weight draw alike;
* a tie between such items goes to the first position of the read's
  sorted row, which is the smallest item in unsigned order;
* an item equal to the all-ones u64 word counts as padding and never wins.

``precision="bfloat16"`` computes ln and the product in bfloat16: the
control, the next precision below, which has to fail the comparison.
Imports nothing of the program.
"""

from __future__ import annotations

import torch

from . import kmers
from .probminhash import M32, slot_constants

SIGN = -(1 << 63)
NONE = (1 << 63) - 1            # the all-ones item in signed order: padding
# (item, slot) draws computed at once: ~4 GB of int64 and float32 temporaries
STEP_ELEMENTS = 1 << 27


def lsr(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical shift right of u64 bit patterns held in int64."""
    return (x >> n) & ((1 << (64 - n)) - 1)


def wang64(x: torch.Tensor) -> torch.Tensor:
    """Thomas Wang's hash64shift of u64 values held in int64 (wrapping)."""
    x = (~x) + (x << 21)
    x = x ^ lsr(x, 24)
    x = x + (x << 3) + (x << 8)
    x = x ^ lsr(x, 14)
    x = x + (x << 2) + (x << 4)
    x = x ^ lsr(x, 28)
    return x + (x << 31)


def weighted_items(codes, lengths, k: int, device):
    """(read number, item, 1 / multiplicity float32) of each distinct item
    of each read, sorted by read and then by item in unsigned order."""
    if not 16 < k <= 32:
        raise ValueError("this reference states the u64 (16 < k <= 32) "
                         "family")
    can, rid, _ = kmers.canonical(codes, lengths, k, device)
    items = wang64(can)
    del can
    keep = items != -1           # the all-ones item counts as padding
    rid, key = rid[keep], items[keep] ^ SIGN
    del items, keep
    order = torch.sort(key, stable=True).indices
    order = order[torch.sort(rid[order], stable=True).indices]
    rid, key = rid[order], key[order]
    del order
    head = torch.ones_like(key, dtype=torch.bool)
    head[1:] = (rid[1:] != rid[:-1]) | (key[1:] != key[:-1])
    group = torch.cumsum(head, 0) - 1
    mult = torch.bincount(group)
    winv = 1.0 / mult.to(torch.float32)
    return rid[head], key[head] ^ SIGN, winv


def signatures(codes, lengths, k: int, m: int, device,
               precision: str = "float32") -> torch.Tensor:
    """Signatures int64[n_reads, m] (u64 bit patterns) of the reads."""
    n = len(lengths)
    rid, item, winv = weighted_items(codes, lengths, k, device)
    sc = slot_constants(m, device)
    out = torch.zeros((n, m), dtype=torch.int64, device=device)
    if item.numel() == 0:
        return out
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[precision]
    w = winv.to(dt)[:, None]
    fold = (item ^ (item >> 32)) & M32
    key = item ^ SIGN
    step = max(1, min(m, STEP_ELEMENTS // item.numel()))
    for s0 in range(0, m, step):
        c = sc[s0:s0 + step]
        h = fold[:, None] ^ c[None, :]
        h = (h * 0x9E3779B1) & M32
        h = h ^ (h >> 15)
        h = (h * 0x85EBCA77) & M32
        u = (h >> 8).to(torch.float32) * 2.0**-24 + 2.0**-24
        del h
        e = torch.log(u.to(dt)) * w
        del u
        idx = rid[:, None].expand_as(e)
        best = torch.full((n, c.numel()), float("-inf"), dtype=dt,
                          device=device)
        best.scatter_reduce_(0, idx, e, "amax")
        cand = torch.where(e == best[rid], key[:, None], NONE)
        del e
        win = torch.full((n, c.numel()), NONE, dtype=torch.int64,
                         device=device)
        win.scatter_reduce_(0, idx, cand, "amin")
        out[:, s0:s0 + step] = torch.where(win == NONE, 0, win ^ SIGN)
    return out
