"""Unsigned bit manipulation on int64 carriers.

Port of kmerutils_tpu/ops/bitops.py.  torch's uint32/uint64 dtypes lack
shifts, comparisons and addition on the CPU (and may compute with signed
semantics on CUDA), so:

* a u32 value lives in an ``int64`` tensor in [0, 2^32); every result is
  masked back to 32 bits;
* a u64 value lives in an ``int64`` tensor as its bit pattern; left shifts
  and multiplies wrap, arithmetic right shifts are masked (:func:`shr64`),
  and unsigned order comes from flipping the sign bit (:func:`flip64`);
* at a kernel boundary u32 data travels as ``int32`` bit patterns
  (:func:`u32_to_i32` / :func:`i32_to_u32`).
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
SIGN64 = -(1 << 63)   # int64 pattern of 0x8000000000000000


def s64(c: int) -> int:
    """A u64 constant as the Python int of its int64 bit pattern."""
    c &= (1 << 64) - 1
    return c - (1 << 64) if c >= 1 << 63 else c


def as_u64(x: torch.Tensor) -> torch.Tensor:
    """u64 bit patterns in int64: int32 tensors are u32 values (bit
    patterns), zero-extended; other integer tensors are taken as they
    are."""
    if x.dtype == torch.int32:
        return x.to(torch.int64) & M32
    return x.to(torch.int64)


def shr64(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of u64 bit patterns held in int64 (0 <= s < 64)."""
    if s == 0:
        return x
    return (x >> s) & ((1 << (64 - s)) - 1)


def urem64(x: torch.Tensor, m: int) -> torch.Tensor:
    """x mod m for u64 bit patterns held in int64 and 0 < m < 2^62
    (``torch.remainder`` is signed: it is wrong for every x >= 2^63)."""
    if not 0 < m < 1 << 62:
        raise ValueError(f"modulus {m} out of range")
    r = (x & ((1 << 63) - 1)) % m        # the low 63 bits
    return torch.where(x < 0, (r + (1 << 63) % m) % m, r)


def flip64(x: torch.Tensor) -> torch.Tensor:
    """Order-preserving map of u64 bit patterns onto signed int64 order."""
    return x ^ SIGN64


def lt_u64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a < b as unsigned 64-bit values."""
    return flip64(a) < flip64(b)


def rotl64(x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Rotate u64 bit patterns left by ``r`` (an int64 tensor that
    broadcasts against ``x``), modulo 64."""
    r = r % 64
    # the arithmetic shift's sign fill is masked off; r == 0 masks it all
    right = (x >> (64 - r).clamp(max=63)) & ((1 << r) - 1)
    return (x << r) | right


def rotr64(x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Rotate u64 bit patterns right by ``r`` modulo 64."""
    return rotl64(x, -r % 64)


def u32_to_i32(x: torch.Tensor) -> torch.Tensor:
    """u32 values held in int64 -> int32 bit patterns (4 bytes each)."""
    return x.to(torch.int32)


def i32_to_u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> u32 values held in int64."""
    return x.to(torch.int64) & M32


def reverse_base_pairs_u32(x: torch.Tensor) -> torch.Tensor:
    """Reverse the order of the 16 2-bit groups of a u32 (int64 carrier)."""
    x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
    x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
    x = ((x & 0x00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF)
    return ((x << 16) | (x >> 16)) & M32


def reverse_base_pairs_u64(x: torch.Tensor) -> torch.Tensor:
    """Reverse the order of the 32 2-bit groups of a u64 (int64 pattern)."""
    for sh, c in ((2, 0x3333333333333333), (4, 0x0F0F0F0F0F0F0F0F),
                  (8, 0x00FF00FF00FF00FF), (16, 0x0000FFFF0000FFFF)):
        # the mask clears the sign-extended top bits of the arithmetic shift
        x = ((x & c) << sh) | ((x >> sh) & c)
    return (x << 32) | shr64(x, 32)


def revcomp_u32(kmer: torch.Tensor, k: int) -> torch.Tensor:
    """Reverse complement of a k-mer (k <= 16) in the low 2k bits of a u32
    (A=00 C=01 G=10 T=11, so the complement is bitwise NOT)."""
    x = reverse_base_pairs_u32(~kmer & M32)
    if k < 16:
        x = x >> (32 - 2 * k)
    return x


def revcomp_u64(kmer: torch.Tensor, k: int) -> torch.Tensor:
    """Reverse complement of a k-mer (k <= 32) in the low 2k bits of a u64."""
    x = reverse_base_pairs_u64(~kmer)
    if k < 32:
        x = shr64(x, 64 - 2 * k)
    return x
