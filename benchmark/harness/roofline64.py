"""The work counts of the k=21 sketch cell's kernels K2 and KW, frozen here
so that no change to the program can move them; the peaks are
``roofline.py``'s (one NVIDIA H100 SXM at 700 W).

K2 (the weighted tournament over u64 items, given as int32 lo and hi
planes) bytes: lo, hi and 1/w of [n, P] read once (12 bytes a position),
the [n, m] winners' lo and hi written once (8 bytes a slot).

K2 operations: the draws the inputs need times :data:`K2_OPS_PER_DRAW`,
plus :data:`K2_OPS_PER_POSITION` for each needed position, over the issue
rate.  A draw is needed for each (valid position, slot) whose position does
not repeat the item and weight of the position before it (a repeated
position draws alike and loses the tie to the first).  One draw, counted
by hand from the function (see the module docstring of
``reference/probminhash64.py``), each step as the fewest Hopper
instructions that state it:

    f ^ c_s                      1  LOP3
    * 0x9E3779B1                 1  IMAD
    h ^ (h >> 15)                2  SHF, LOP3
    * 0x85EBCA77                 1  IMAD
    h >> 8                       1  SHF
    to float32                   1  I2F
    * 2^-24 + 2^-24              1  FFMA
    ln(u)                        2  MUFU.LG2, FMUL by ln 2
    * (1 / w)                    1  FMUL
    keep the best (e, position)  3  FSETP, FSEL, SEL
                                --
                                14

and once a position its 32-bit fold f = lo ^ hi (1 LOP3), which no slot
repeats.  K1's count (``roofline.K1_OPS_PER_DRAW``) is the same draw: the
payload kept is the position here and the item there, one register
either way.  The tie test on equal draws is not counted, as for K1.

KW (each row sorted and its run lengths) at int64 items: items (8) and
valid (1) read once, the sorted items (8), 1/w (4) and is_real (1) written
once, 22 bytes a position.  Its operations are a sort's, which depend on
the algorithm: only the bytes bound is counted, so the share says how far
the stage is from moving its bytes once.
"""

from __future__ import annotations

from . import roofline

K2_OPS_PER_DRAW = 14
K2_OPS_PER_POSITION = 1
KW64_BYTES_PER_POSITION = 22


def k2_bytes(n: int, P: int, m: int) -> int:
    return n * P * 12 + n * m * 8


def k2_positions(lo, hi, winv):
    """Positions the inputs need, as a device scalar (no synchronisation):
    valid positions (winv > 0) that do not repeat the item (lo and hi) and
    weight of the position before them."""
    need = winv > 0
    need[:, 1:] &= ~((lo[:, 1:] == lo[:, :-1]) & (hi[:, 1:] == hi[:, :-1])
                     & (winv[:, 1:] == winv[:, :-1]))
    return need.sum()


def k2_least_s(positions: int, m: int, nbytes: int) -> float:
    ops = positions * (m * K2_OPS_PER_DRAW + K2_OPS_PER_POSITION)
    return max(roofline.bytes_s(nbytes), roofline.ops_s(ops))


def kw64_least_s(positions: int) -> float:
    return roofline.bytes_s(positions * KW64_BYTES_PER_POSITION)
