"""Plain SuperMinHash with integer signatures (SUPER2, the reference
crate's ``SuperHash2Sketch``) per read over 64-bit k-mers, in plain
PyTorch: the yardstick the SUPER2 cell holds the program to.

For read r, its items are Thomas Wang's hash64shift of its canonical
k-mers (17 <= k <= 32), u64 values, one per valid position (a k-mer that
recurs in the read gives the same key again, which cannot change a
minimum).  Slot j of the read's signature is the smallest, over the read's
positions, of the u32 key

    key = pi << u_bits | u,   nbits = bit length of m - 1 (at least 1),
                              u_bits = 32 - nbits,

    pi: slot j under the item's keyed permutation of [0, m): with
        kd = splitmix64(x ^ 0x51), a = (kd >> 32) | 1, b = kd & 0xFFFFFFFF,
        E(v) = y ^ (y >> max(nbits / 2, 1)) with y = (v * a ^ b) mod 2^nbits,
        pi = E(j), then E again while pi >= m, at most 4 more rounds, then
        min(pi, m - 1);
    u:  the top u_bits of mix(f ^ c_j), f = lo(x) ^ hi(x), c_j the top half
        of splitmix64(j), mix: h * 0x85EBCA77, h ^ (h >> 13),
        h * 0xC2B2AE3D, h ^ (h >> 16) (all u32)

(seed 0).  A read without a valid k-mer gets 0xFFFFFFFF in every slot.

Departures from Ertl's description (arXiv:1706.05698, Algorithm 1), each
as the port and the JAX package define SUPER2:

* pi is not drawn by a Fisher-Yates shuffle from a generator seeded by the
  item: it is a keyed bijection of [0, 2^nbits) (an odd multiply and an
  xor, then an xorshift), cycle-walked back into [0, m);
* the walk stops after 4 rounds and clamps what is still out of range to
  m - 1, so for a few (item, slot) pairs (52 of the 5.2e8 pairs of
  every key modulo 2^10 and every slot at m = 1000) pi is not a
  permutation of [0, m);
* u is not a uniform float from the item's generator but the top u_bits
  of one 32-bit mix of the item's 32-bit fold and the slot's constant, so
  two items with the same fold draw the same u;
* the signature is the packed integer key itself, not pi + u as a float,
  and it is the minimum over every position, where Ertl stops early.

``cut16=True`` gives the control: the minimum taken on keys whose u is
cut to its top 16 bits, a tie going to the read's first such position,
whose full key is reported.  It differs from the exact signature only in
slots where two positions tie on the cut key and the later one has the
smaller full key.  Imports nothing of the program.
"""

from __future__ import annotations

import torch

from . import kmers
from .probminhash import M32, slot_constants
from .probminhash64 import lsr, wang64

WALKS = 4
# (row, position, slot) keys computed at once: ~1 GB for each int64
# temporary
STEP_ELEMENTS = 1 << 27
POS_BITS = 24                   # positions of a read, for the control


def splitmix64(x: torch.Tensor) -> torch.Tensor:
    """SplitMix64's finalizer of u64 values held in int64 (wrapping)."""
    x = x + (0x9E3779B97F4A7C15 - (1 << 64))
    x = (x ^ lsr(x, 30)) * (0xBF58476D1CE4E5B9 - (1 << 64))
    x = (x ^ lsr(x, 27)) * (0x94D049BB133111EB - (1 << 64))
    return x ^ lsr(x, 31)


def perm_bits(m: int) -> int:
    return max((m - 1).bit_length(), 1)


def encrypt(v, a, b, nbits: int):
    """E(v) of the module docstring: v, a, b integer tensors that
    broadcast, of which E reads a and b modulo 2^nbits only."""
    mask = (1 << nbits) - 1
    y = ((v * a) ^ b) & mask
    return y ^ (y >> max(nbits // 2, 1))


def padded_items(codes, lengths, k: int, device):
    """(items int64[n, P] as u64 bit patterns, valid bool[n, P]): each
    read's items in position order, P the most k-mers of a read (>= 1)."""
    if not 16 < k <= 32:
        raise ValueError("this reference states the u64 (16 < k <= 32) "
                         "family")
    can, rid, pos = kmers.canonical(codes, lengths, k, device)
    n = len(lengths)
    P = int(pos.max()) + 1 if pos.numel() else 1
    items = torch.zeros((n, P), dtype=torch.int64, device=device)
    valid = torch.zeros((n, P), dtype=torch.bool, device=device)
    items[rid, pos] = wang64(can)
    valid[rid, pos] = True
    return items, valid


def _keys(f, a, b, sc, j, m: int):
    """(pi, u) of positions (f, a, b: int64[r, p] u32 values) and slots
    (sc, j: int64[s]), each int64[r, p, s]."""
    nbits = perm_bits(m)
    mask = (1 << nbits) - 1
    # pi depends on a and b mod 2^nbits only: int32 holds its products
    a3 = (a & mask).to(torch.int32)[:, :, None]
    b3 = (b & mask).to(torch.int32)[:, :, None]
    pi = encrypt(j.to(torch.int32), a3, b3, nbits)
    out = pi >= m
    if out.any():   # walk only the few pairs out of range
        at = out.nonzero(as_tuple=True)
        v = pi[at]
        aw, bw = a3.expand_as(pi)[at], b3.expand_as(pi)[at]
        for _ in range(WALKS):
            v = torch.where(v >= m, encrypt(v, aw, bw, nbits), v)
        pi[at] = v.clamp(max=m - 1)
    h = (f[:, :, None] ^ sc) * 0x85EBCA77 & M32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE3D) & M32
    h = h ^ (h >> 16)
    return pi.to(torch.int64), h >> nbits


def signatures_of_items(items, valid, m: int,
                        cut16: bool = False) -> torch.Tensor:
    """Signatures int64[n, m] (u32 values) of items [n, P] (int64 u64 bit
    patterns) where valid; see the module docstring."""
    n, P = items.shape
    dev = items.device
    nbits = perm_bits(m)
    u_bits = 32 - nbits
    kd = splitmix64(items ^ 0x51)
    a = lsr(kd, 32) | 1
    b = kd & M32
    f = (items ^ lsr(items, 32)) & M32
    sc = slot_constants(m, dev)
    j = torch.arange(m, dtype=torch.int64, device=dev)
    cut = max(u_bits - 16, 0)
    if cut16 and P >= 1 << POS_BITS:
        raise ValueError(f"reads of {P} positions: the control packs a "
                         f"position in {POS_BITS} bits")
    pos = torch.arange(P, dtype=torch.int64, device=dev)
    none = (1 << 63) - 1
    out = torch.full((n, m), M32, dtype=torch.int64, device=dev)
    ns = min(m, max(1, STEP_ELEMENTS // P))
    nr = max(1, STEP_ELEMENTS // (P * ns))
    for r0 in range(0, n, nr):
        rs = slice(r0, min(n, r0 + nr))
        ok = valid[rs, :, None]
        if not ok.any():
            continue
        for s0 in range(0, m, ns):
            ss = slice(s0, min(m, s0 + ns))
            pi, u = _keys(f[rs], a[rs], b[rs], sc[ss], j[ss], m)
            if not cut16:
                key = torch.where(ok, (pi << u_bits) | u, M32)
                out[rs, ss] = key.amin(dim=1)
                continue
            # (cut key, position, the u bits cut off): the first position
            # wins a tie of cut keys, and its full key is read back
            low = u & ((1 << cut) - 1)
            key = (((pi << (u_bits - cut)) | (u >> cut)) << POS_BITS
                   | pos[None, :, None]) << cut | low
            best = torch.where(ok, key, none).amin(dim=1)
            full = (best >> (POS_BITS + cut)) << cut | (best & ((1 << cut)
                                                                - 1))
            out[rs, ss] = torch.where(best == none, M32, full)
    return out


def signatures(codes, lengths, k: int, m: int, device,
               cut16: bool = False) -> torch.Tensor:
    """Signatures int64[n_reads, m] (u32 values) of the reads (``codes``
    uint8 numpy concatenation of 2-bit codes, ``lengths`` per read)."""
    items, valid = padded_items(codes, lengths, k, device)
    return signatures_of_items(items, valid, m, cut16)
