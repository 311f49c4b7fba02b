"""SuperMinHash (Ertl 2017): per-read Jaccard signatures.

Port of kmerutils_tpu/sketch/superminhash.py.  For item d and slot j,
h_j(d) = pi_d(j) + u_{d,j}, with pi_d a keyed permutation of [0, m) (an odd
multiply and an xorshift on the next power of two, cycle-walked back into
[0, m)) and u_{d,j} uniform in [0, 1); the signature is min_d h_j(d).  Both
pack into one u32 key per (d, j), ``pi << u_bits | u``, so the sketch is
one min-reduction over positions: the grid kernel G1
(ops/sketch_grid.py::grid_min) on the card, its plain version on the CPU.

* :func:`superminhash2`: the packed u32 keys (SUPER2), int32 bit patterns;
* :func:`superminhash`: float64 ``pi + u / 2^u_bits`` (SUPER), +inf for a
  read without a valid k-mer.

Items: int32 tensors are u32 items, int64 tensors u64 items (bit
patterns).  The permutation key hashes the whole item, zero-extended from
u32; the slot draw hashes its 32-bit fold (lo ^ hi for u64 items).
"""

from __future__ import annotations

import torch

from .. import obs
from ..ops import sketch_grid
from ..ops.bitops import M32, as_u64, s64, shr64
from ..ops.rng import splitmix64
from ..ops.sketch_grid import WALKS as _WALKS
from ..ops.sketch_grid import encrypt_pow2 as _encrypt_pow2
from ..ops.sketch_grid import perm_bits as _perm_bits
from .probminhash import _fold32

SENTINEL32 = -1          # int32 pattern of 0xFFFFFFFF
_GOLDEN64 = 0x9E3779B97F4A7C15


def _small_perm(j: torch.Tensor, keys_u64: torch.Tensor, m: int):
    """Keyed pseudorandom permutation of [0, m), int32: slots j (int64)
    under keys (u64 bit patterns) that broadcast against them."""
    nbits = _perm_bits(m)
    k1 = splitmix64(keys_u64 ^ 0xA5A5A5A5)
    a = shr64(k1, 32) | 1
    b = k1 & M32
    x = _encrypt_pow2(j & M32, a, b, nbits)
    for _ in range(_WALKS):
        x = torch.where(x >= m, _encrypt_pow2(x, a, b, nbits), x)
    return x.clamp(max=m - 1).to(torch.int32)


def slot_consts(m: int, seed: int, device) -> torch.Tensor:
    """SUPER2's per-slot draw constants, int32[m] (u32 bit patterns): the
    top half of splitmix64(j + seed * 0x632BE59B)."""
    j = torch.arange(m, dtype=torch.int64, device=device)
    return shr64(splitmix64(j + s64(seed * 0x632BE59B)), 32).to(torch.int32)


def grid_min_args(items: torch.Tensor, valid: torch.Tensor, m: int,
                  seed: int = 0):
    """The inputs of G1 (ops/sketch_grid.grid_min) for SUPER2: the items'
    32-bit folds, their permutation keys (a odd, b) from splitmix64 of the
    whole item, valid and the slot constants."""
    kd = splitmix64(as_u64(items) ^ s64(seed * _GOLDEN64 + 0x51))
    return (_fold32(items).contiguous(),
            (shr64(kd, 32) | 1).to(torch.int32), kd.to(torch.int32),
            valid.contiguous(), slot_consts(m, seed, items.device))


def superminhash2(items: torch.Tensor, valid: torch.Tensor, m: int,
                  seed: int = 0):
    """Integer-signature SuperMinHash (SUPER2): (sig int32[n, m], the
    packed key of the winning item per slot as u32 bit patterns; empty
    bool[n]).  Rows without a valid item hold 0xFFFFFFFF.  Span
    ``sketch.grid`` (G1's inputs, G1 and the empty rows), over n x P
    positions."""
    with obs.span("sketch.grid", items.numel(), items.device):
        sig = sketch_grid.grid_min(*grid_min_args(items, valid, m, seed))
        return sig, ~valid.any(dim=1)


def superminhash(items: torch.Tensor, valid: torch.Tensor, m: int,
                 seed: int = 0):
    """Float-signature SuperMinHash (SUPER): (sig float64[n, m] =
    pi + u / 2^u_bits, +inf for an empty read; empty bool[n])."""
    sig2, empty = superminhash2(items, valid, m, seed)
    u_bits = 32 - _perm_bits(m)
    sig = (sig2.to(torch.int64) & M32).to(torch.float64) * 2.0**-u_bits
    return torch.where(empty[:, None], float("inf"), sig), empty


def superminhash_jaccard(sig_a: torch.Tensor, sig_b: torch.Tensor):
    """Fraction of equal slots, SuperMinHash's Jaccard estimate."""
    return (sig_a == sig_b).to(torch.float32).mean(dim=-1)
