"""Invertible integer hashes and the splitmix64 counter RNG on int64 carriers.

Port of kmerutils_tpu/ops/rng.py: Thomas Wang's hash32shiftmult and
hash64shift with exact inverses, the splitmix64 finalizer, the two-value
mix built on it, and the maps from random bits to uniform floats.  u32 inputs
are int64 tensors in [0, 2^32), u64 inputs are int64 bit patterns (see
ops/bitops.py); results are bit-identical to the JAX functions.
"""

from __future__ import annotations

import torch

from .bitops import M32, s64, shr64

_GOLDEN64 = 0x9E3779B97F4A7C15


def wang_hash32(x: torch.Tensor) -> torch.Tensor:
    """Thomas Wang's invertible 32-bit mix (hash32shiftmult)."""
    x = (x ^ 61) ^ (x >> 16)
    x = (x + (x << 3)) & M32
    x = x ^ (x >> 4)
    x = (x * 0x27D4EB2D) & M32
    return x ^ (x >> 15)


def wang_hash32_inv(x: torch.Tensor) -> torch.Tensor:
    """Exact inverse of :func:`wang_hash32`."""
    x = x ^ (x >> 15) ^ (x >> 30)
    x = (x * pow(0x27D4EB2D, -1, 1 << 32)) & M32
    x = x ^ (x >> 4) ^ (x >> 8) ^ (x >> 12) ^ (x >> 16) \
        ^ (x >> 20) ^ (x >> 24) ^ (x >> 28)
    x = (x * pow(9, -1, 1 << 32)) & M32
    x = x ^ (x >> 16)
    return x ^ 61


def wang_hash64(x: torch.Tensor) -> torch.Tensor:
    """Thomas Wang's invertible 64-bit hash (hash64shift)."""
    x = (~x) + (x << 21)
    x = x ^ shr64(x, 24)
    x = (x + (x << 3)) + (x << 8)   # x * 265
    x = x ^ shr64(x, 14)
    x = (x + (x << 2)) + (x << 4)   # x * 21
    x = x ^ shr64(x, 28)
    return x + (x << 31)


def wang_hash64_inv(x: torch.Tensor) -> torch.Tensor:
    """Exact inverse of :func:`wang_hash64`."""
    x = x * s64(pow((1 << 31) + 1, -1, 1 << 64))
    x = x ^ shr64(x, 28) ^ shr64(x, 56)
    x = x * s64(pow(21, -1, 1 << 64))
    y = x
    for _ in range(5):
        y = x ^ shr64(y, 14)
    x = y * s64(pow(265, -1, 1 << 64))
    x = x ^ shr64(x, 24) ^ shr64(x, 48)
    # forward: y = (~x) + (x << 21) = x * (2^21 - 1) - 1  (mod 2^64)
    return (x + 1) * s64(pow((1 << 21) - 1, -1, 1 << 64))


def splitmix64(x: torch.Tensor) -> torch.Tensor:
    """SplitMix64 finalizer: counter-based 64-bit mix."""
    x = x + s64(_GOLDEN64)
    x = (x ^ shr64(x, 30)) * s64(0xBF58476D1CE4E5B9)
    x = (x ^ shr64(x, 27)) * s64(0x94D049BB133111EB)
    return x ^ shr64(x, 31)


def mix2_64(a: torch.Tensor, b) -> torch.Tensor:
    """Mix two u64 values (bit patterns; ``b`` may be a Python int) into
    one."""
    if not isinstance(b, torch.Tensor):
        b = torch.tensor(s64(b), dtype=torch.int64, device=a.device)
    return splitmix64(a ^ (splitmix64(b) + s64(_GOLDEN64)))


def uniform01_from_bits(u64bits: torch.Tensor) -> torch.Tensor:
    """u64 bit patterns -> float64 uniform in (0, 1] from the top 53 bits:
    (x + 1) * 2^-53."""
    return (shr64(u64bits, 11).to(torch.float64) + 1.0) * 2.0**-53


def uniform01_f32_from_bits(u32bits: torch.Tensor) -> torch.Tensor:
    """u32 values (int64 carrier or int32 bit patterns) -> float32 uniform
    in (0, 1] from the top 24 bits: (x + 1) * 2^-24, exact in float32."""
    x = (u32bits.to(torch.int64) & M32) >> 8
    return (x.to(torch.float32) + 1.0) * 2.0**-24
