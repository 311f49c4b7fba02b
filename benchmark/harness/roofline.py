"""The yardstick's peaks and work counts, frozen here so that no change to
the program can move them.

Peaks of one NVIDIA H100 SXM (data sheet, 700 W): HBM at 3.35 TB/s; 132
SMs, each issuing 128 thread instructions a clock (4 schedulers x 32
lanes), at 1.98 GHz.  A roofline share is the least time the work needs
on these peaks over the time the device took; the least time is the larger
of the bytes bound and the operations bound.

Bytes: each input byte read once and each output byte written once.

K1 (the weighted tournament, u32 items) operations: the draws the inputs
need times :data:`K1_OPS_PER_DRAW`, over the issue rate.  A draw is needed
for each (valid position, slot) whose position does not repeat the item and
weight of the position before it (a repeated position cannot change the
winner).  One draw, counted by hand from the function (see the module
docstring of ``reference/probminhash.py``), each step as the fewest Hopper
instructions that state it:

    x ^ c_s                      1  LOP3
    * 0x9E3779B1                 1  IMAD
    h ^ (h >> 15)                2  SHF, LOP3
    * 0x85EBCA77                 1  IMAD
    h >> 8                       1  SHF
    to float32                   1  I2F
    * 2^-24 + 2^-24              1  FFMA
    ln(u)                        2  MUFU.LG2, FMUL by ln 2
    * (1 / w)                    1  FMUL
    keep the best (e, item)      3  FSETP, FSEL, SEL
                                --
                                14

The tie test on equal draws is not counted: equal draws of different items
are rare, so the inputs need it almost never.  ln is counted as the
hardware's base-2 logarithm and one multiply, the fewest that state it; a
correctly rounded logf takes more, which the share then shows as lost.
MUFU issues at 16 lanes an SM, so one MUFU a draw (1/16 of a lane-clock)
stays below the 14/128 of the issue bound.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
SMS = 132
LANES_PER_SM = 128
SM_CLOCK_HZ = 1.98e9
ISSUE_PER_S = SMS * LANES_PER_SM * SM_CLOCK_HZ

K1_OPS_PER_DRAW = 14


def bytes_s(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S


def ops_s(instructions: float) -> float:
    return instructions / ISSUE_PER_S


def k1_bytes(n: int, P: int, m: int) -> int:
    """Items (int32) and 1/w (float32) of [n, P] read once, the [n, m]
    winners written once."""
    return n * P * 8 + n * m * 4


def k1_least_s(draws: int, nbytes: int) -> float:
    return max(bytes_s(nbytes), ops_s(draws * K1_OPS_PER_DRAW))


def k1_draws(items, winv, m: int):
    """Draws the inputs need, as a device scalar (no synchronisation):
    valid positions (winv > 0) that do not repeat the position before
    them, times m."""
    need = winv > 0
    need[:, 1:] &= ~((items[:, 1:] == items[:, :-1])
                     & (winv[:, 1:] == winv[:, :-1]))
    return need.sum() * m
