"""Plain ProbMinHash (the PROB3A family of the reference crate) per read,
in plain PyTorch: the yardstick the sketch cells hold the program to.

For read r, its items are the Wang hashes (hash32shiftmult) of its
canonical k-mers (k <= 16), each weighted by its multiplicity in the read.
Slot s of the read's signature is the item x that maximises

    e(x, s) = ln(u) * (1 / w_x),   u = ((h >> 8) + 1) * 2^-24,
    h = mix(x ^ c_s),  mix: h * 0x9E3779B1, h ^ (h >> 15), h * 0x85EBCA77

(all u32), i.e. minimises the exponential draw -ln(u) / w_x; ties go to
the smallest item.  c_s is the top half of splitmix64(s) (seed 0).  The
draw is computed in float32, the configuration's precision: ``u`` exactly,
then ln and the product each rounded to float32.  A read without an item
gets signature 0.  As in the reference crate's port, an item equal to the
all-ones word counts as padding and never wins.

``precision="bfloat16"`` computes ln and the product in bfloat16: the
control, the next precision below, which has to fail the comparison.
Imports nothing of the program.
"""

from __future__ import annotations

import torch

from . import kmers

M32 = 0xFFFFFFFF
M64 = (1 << 64) - 1
# (item, slot) draws computed at once: ~4 GB of int64 and float32 temporaries
STEP_ELEMENTS = 1 << 27


def wang32(x: torch.Tensor) -> torch.Tensor:
    """Thomas Wang's hash32shiftmult of u32 values held in int64."""
    x = (x ^ 61) ^ (x >> 16)
    x = (x + (x << 3)) & M32
    x = x ^ (x >> 4)
    x = (x * 0x27D4EB2D) & M32
    return x ^ (x >> 15)


def splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & M64
    return x ^ (x >> 31)


def slot_constants(m: int, device) -> torch.Tensor:
    """c_s for s < m, u32 values in int64."""
    return torch.tensor([splitmix64(s) >> 32 for s in range(m)],
                        dtype=torch.int64, device=device)


def weighted_items(codes, lengths, k: int, device):
    """(read number, item, 1 / multiplicity float32) of each distinct item
    of each read, sorted by (read, item)."""
    if k > 16:
        raise ValueError("this reference states the u32 (k <= 16) family")
    can, rid, _ = kmers.canonical(codes, lengths, k, device)
    items = wang32(can)
    del can
    keep = items != M32          # the all-ones item counts as padding
    pair = (rid[keep] << 32) | items[keep]
    del items, rid, keep
    pair, mult = torch.unique(pair, sorted=True, return_counts=True)
    winv = 1.0 / mult.to(torch.float32)
    return pair >> 32, pair & M32, winv


def signatures(codes, lengths, k: int, m: int, device,
               precision: str = "float32") -> torch.Tensor:
    """Signatures int64[n_reads, m] (u32 values) of the reads."""
    n = len(lengths)
    rid, item, winv = weighted_items(codes, lengths, k, device)
    sc = slot_constants(m, device)
    out = torch.zeros((n, m), dtype=torch.int64, device=device)
    if item.numel() == 0:
        return out
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[precision]
    w = winv.to(dt)[:, None]
    step = max(1, min(m, STEP_ELEMENTS // item.numel()))
    for s0 in range(0, m, step):
        c = sc[s0:s0 + step]
        h = item[:, None] ^ c[None, :]
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
        cand = torch.where(e == best[rid], item[:, None], 1 << 32)
        del e
        win = torch.full((n, c.numel()), 1 << 32, dtype=torch.int64,
                         device=device)
        win.scatter_reduce_(0, idx, cand, "amin")
        out[:, s0:s0 + step] = torch.where(win == 1 << 32, 0, win)
    return out
