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
SIGN32 = -(1 << 31)   # int32 pattern of 0x80000000


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


def flip32(x: torch.Tensor) -> torch.Tensor:
    """Order-preserving map of u32 bit patterns in int32 onto signed int32
    order (its own inverse, as :func:`flip64`)."""
    return x ^ SIGN32


def lt_u64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a < b as unsigned 64-bit values."""
    return flip64(a) < flip64(b)


def _amount(r, x: torch.Tensor) -> torch.Tensor:
    """A shift or rotate amount (a Python int or an integer tensor) as int64
    on the device of ``x``."""
    return torch.as_tensor(r, dtype=torch.int64, device=x.device)


def _shr64_var(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """:func:`shr64` by an int64 tensor of amounts in [0, 64)."""
    # the arithmetic shift's sign fill is masked off; s == 0 keeps x whole
    low = (1 << (64 - s).clamp(max=63)) - 1
    return torch.where(s == 0, x, (x >> s) & low)


def _check_nbits(nbits: int) -> None:
    if nbits not in (32, 64):
        raise ValueError(f"nbits must be 32 or 64, got {nbits}")


def rotl(x: torch.Tensor, r, nbits: int) -> torch.Tensor:
    """Rotate left by ``r`` (any value, taken mod nbits; a Python int or an
    integer tensor that broadcasts against ``x``).  nbits 32: u32 values
    in int64; nbits 64: u64 bit patterns in int64."""
    _check_nbits(nbits)
    r = _amount(r, x) % nbits
    if nbits == 32:
        return ((x << r) | (x >> (32 - r))) & M32
    # the arithmetic shift's sign fill is masked off; r == 0 masks it all
    right = (x >> (64 - r).clamp(max=63)) & ((1 << r) - 1)
    return (x << r) | right


def rotr(x: torch.Tensor, r, nbits: int) -> torch.Tensor:
    """Rotate right by ``r`` (any value, taken mod nbits)."""
    return rotl(x, -_amount(r, x), nbits)


def rotl64(x: torch.Tensor, r) -> torch.Tensor:
    return rotl(x, r, 64)


def rotr64(x: torch.Tensor, r) -> torch.Tensor:
    return rotr(x, r, 64)


def rotl32(x: torch.Tensor, r) -> torch.Tensor:
    return rotl(x, r, 32)


def _shift_safe(x: torch.Tensor, s, nbits: int, left: bool) -> torch.Tensor:
    _check_nbits(nbits)
    s = _amount(s, x)
    sm = s % nbits
    if left:
        y = (x << sm) & M32 if nbits == 32 else x << sm
    else:
        y = x >> sm if nbits == 32 else _shr64_var(x, sm)
    return torch.where(s >= nbits, 0, y)


def shl_safe(x: torch.Tensor, s, nbits: int) -> torch.Tensor:
    """x << s in nbits (32: u32 values in int64, 64: u64 bit patterns),
    0 for any s >= nbits."""
    return _shift_safe(x, s, nbits, left=True)


def shr_safe(x: torch.Tensor, s, nbits: int) -> torch.Tensor:
    """Logical x >> s in nbits, 0 for any s >= nbits."""
    return _shift_safe(x, s, nbits, left=False)


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
