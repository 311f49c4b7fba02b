"""The work count of the SUPER2 cell's kernel G1, frozen here so that no
change to the program can move it; the peaks are ``roofline.py``'s (one
NVIDIA H100 SXM at 700 W).

G1 (per row and slot the least SUPER2 key over the row's valid positions)
bytes: the items' folds x, the permutation keys a and b (int32) and valid
(1 byte) of [n, P] read once, 13 bytes a position; the [n, m] u32
signatures written once, 4 bytes a slot.

G1 operations: the valid (position, slot) pairs times
:data:`G1_OPS_PER_PAIR` plus :data:`G1_OPS_PER_ROUND` for the first round
of the permutation and for each walk round, over the issue rate.  One
pair, counted by hand from the function (see the module docstring of
``reference/superminhash2.py``), each step as the fewest Hopper
instructions that state it:

    the slot's draw and the reduction, once a pair
    f ^ c_j                      1  LOP3
    * 0x85EBCA77                 1  IMAD
    h ^ (h >> 13)                2  SHF, LOP3
    * 0xC2B2AE3D                 1  IMAD
    h ^ (h >> 16)                2  SHF, LOP3
    u = h >> nbits               1  SHF
    pi << u_bits | u             1  LEA (the two fields do not overlap)
    keep the least key           1  IMNMX.U32
                                --
                                10

    a round of the permutation, the first and each walk round
    v * a                        1  IMAD
    (^ b) & mask                 1  LOP3
    y >> max(nbits / 2, 1)       1  SHF
    (y ^ ...) & mask             1  LOP3
    the test v >= m              1  ISETP
                                --
                                 5

The clamp to m - 1 is needed only by a pair still out of range after the
last walk round (52 of 5.2e8 pairs at m = 1000) and is not counted, as
K1's tie test is not.

Walk rounds (:data:`WALK_ROUNDS`): a round is taken while v >= m, at most
4 times.  The permutation reads a and b modulo 2^nbits only, so the mean
over every such key and every slot is the mean of uniform keys; the
program's keys are splitmix64 outputs.  At m = 1000 (nbits = 10): 512 odd
a x 1024 b x 1000 slots = 524,288,000 pairs take 12,567,296 walk rounds,
0.02397 a pair (a uniform bijection of [0, 1024) would take 24/1024 +
24/1024 x 23/1023 + ... = 0.02398).  A window has no per-call count: the mean is counted
once, by :func:`walk_rounds` over every key, and frozen.

The count charges the hash to every pair, as G1 computes it.  A G1 that
skips the hash of a pair whose ``pi`` alone exceeds its slot's running
minimum needs it on 0.15-0.46 % of the cell's pairs, ~5.15 operations a
pair: such a kernel reads this share ~2.9x too high, so the count is
restated for it first (the permutation on every pair, the hash on the
share of pairs the skip keeps, that share frozen).
"""

from __future__ import annotations

from . import roofline

FAMILY = "G1 grid_min"          # families.family's name for G1's kernel
G1_OPS_PER_PAIR = 10
G1_OPS_PER_ROUND = 5
G1_BYTES_PER_POSITION = 13
G1_BYTES_PER_SLOT = 4
WALKS = 4
# m -> mean walk rounds a (position, slot) pair takes
WALK_ROUNDS = {1000: 12_567_296 / 524_288_000}


def g1_bytes(n: int, P: int, m: int) -> int:
    return n * P * G1_BYTES_PER_POSITION + n * m * G1_BYTES_PER_SLOT


def ops_per_pair(m: int) -> float:
    return G1_OPS_PER_PAIR + G1_OPS_PER_ROUND * (1 + WALK_ROUNDS[m])


def g1_least_s(pairs: int, m: int, nbytes: int) -> float:
    return max(roofline.bytes_s(nbytes), roofline.ops_s(pairs
                                                        * ops_per_pair(m)))


def g1_pairs(valid, m: int):
    """Valid (position, slot) pairs, as a device scalar (no
    synchronisation)."""
    return valid.sum() * m


def walk_rounds(a, b, m: int):
    """(walk rounds taken, pairs) over keys a, b (int64 tensors, u32
    values) and the m slots: the count that :data:`WALK_ROUNDS` froze."""
    import torch

    from ..reference.superminhash2 import encrypt, perm_bits
    nbits = perm_bits(m)
    a2, b2 = a.reshape(-1, 1), b.reshape(-1, 1)
    v = encrypt(torch.arange(m, dtype=torch.int64, device=a.device), a2, b2,
                nbits)
    rounds = 0
    for _ in range(WALKS):
        need = v >= m
        rounds += int(need.sum())
        v = torch.where(need, encrypt(v, a2, b2, nbits), v)
    return rounds, a2.numel() * m
