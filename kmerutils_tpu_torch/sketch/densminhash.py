"""One-permutation MinHash with densification (OPTDENS / REVOPTDENS).

Port of kmerutils_tpu/sketch/densminhash.py.  One hash per item: bucket =
h mod m (an unsigned 64-bit modulo), value = a float32 uniform from the
hash's top bits; the base sketch is the per-bucket minimum of a read's
values (+inf for an empty bucket), one ``scatter_reduce(amin)``.  Empty
buckets are then filled in rounds t = 1, 2, ... below ``max_rounds``:

* OPTDENS: each empty bucket copies the value of the originally filled
  bucket its round-t probe hits;
* REVOPTDENS: each originally filled bucket pushes its value into the
  bucket its round-t target hits, the minimum winning on collision, and a
  still-empty target takes it.

The JAX package runs the rounds in a ``while_loop`` that tests before each
round whether any bucket of a non-empty read is still empty.  Here the test
runs every :data:`CHECK_EVERY` rounds (one host synchronisation each); a
round after the test has turned false changes nothing, so the result is the
same.  Signatures are float32[n, m]; slot equality estimates Jaccard.
"""

from __future__ import annotations

import torch

from ..ops.bitops import M32, s64, shr64, urem64
from ..ops.rng import splitmix64, uniform01_f32_from_bits

CHECK_EVERY = 8
_GOLDEN64 = 0x9E3779B97F4A7C15
INF = float("inf")


def _oph_buckets(items: torch.Tensor, valid: torch.Tensor, m: int,
                 seed: int) -> torch.Tensor:
    """Per-read bucket minima float32[n, m] (+inf for an empty bucket)."""
    u = items.to(torch.int64) & M32 if items.dtype == torch.int32 else items
    h = splitmix64(u ^ s64(seed * _GOLDEN64 + 1))
    bucket = urem64(h, m)
    val = torch.where(valid, uniform01_f32_from_bits(shr64(h, 32)), INF)
    out = torch.full((items.shape[0], m), INF, dtype=torch.float32,
                     device=items.device)
    return out.scatter_reduce_(1, bucket, val, "amin", include_self=True)


def _probe(m: int, t: int, mult: int, salt: int, device) -> torch.Tensor:
    """Round t's probe of every bucket: splitmix64(j ^ t * mult ^ salt)
    mod m, int64[m]."""
    j = torch.arange(m, dtype=torch.int64, device=device)
    return urem64(splitmix64(j ^ s64(t * mult) ^ s64(salt)), m)


def _densify(mins: torch.Tensor, max_rounds: int, step):
    """Rounds t = 1 .. max_rounds - 1 of ``step(sig, t)`` while a bucket of
    a non-empty read is empty; (sig, empty bool[n])."""
    any_filled = torch.isfinite(mins).any(dim=1)
    sig = mins
    for t in range(1, max_rounds):
        if (t - 1) % CHECK_EVERY == 0 and not bool(
                (~torch.isfinite(sig) & any_filled[:, None]).any()):
            break
        sig = step(sig, t)
    return sig, ~any_filled


def optdens_signatures(items: torch.Tensor, valid: torch.Tensor, m: int,
                       seed: int = 0, max_rounds: int = 256):
    """OPTDENS signatures (float32[n, m], empty bool[n])."""
    mins = _oph_buckets(items, valid, m, seed)

    def step(sig, t):
        # the probed bucket's value if it was filled at the start: mins
        # holds exactly that (+inf elsewhere)
        src = mins[:, _probe(m, t, _GOLDEN64, seed * 77 + 13, mins.device)]
        return torch.where(torch.isfinite(sig), sig, src)

    return _densify(mins, max_rounds, step)


def revoptdens_signatures(items: torch.Tensor, valid: torch.Tensor, m: int,
                          seed: int = 0, max_rounds: int = 256):
    """REVOPTDENS signatures (float32[n, m], empty bool[n])."""
    mins = _oph_buckets(items, valid, m, seed)

    def step(sig, t):
        tgt = _probe(m, t, 0xD1B54A32D192ED03, seed * 31 + 7, mins.device)
        received = torch.full_like(mins, INF).scatter_reduce_(
            1, tgt.expand_as(mins), mins, "amin", include_self=True)
        return torch.where(torch.isfinite(sig), sig, received)

    return _densify(mins, max_rounds, step)


def dens_jaccard(sig_a: torch.Tensor, sig_b: torch.Tensor):
    """Fraction of equal slots."""
    return (sig_a == sig_b).to(torch.float32).mean(dim=-1)
