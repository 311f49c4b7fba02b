"""Parity of the port's unsigned-integer layer (kmerutils_tpu_torch.ops) with
the JAX package.

Tolerance: bit-exact.  Inputs come from a seeded numpy generator and always
include values >= 2^31 (u32) and >= 2^63 (u64), where int64 carriers and
signed shifts would go wrong first.
"""

import numpy as np
import pytest
import torch

from kmerutils_tpu.ops import bitops as jbit
from kmerutils_tpu.ops import rng as jrng
from kmerutils_tpu.sketch import probminhash as jpmh
from kmerutils_tpu_torch.ops import bitops as tbit
from kmerutils_tpu_torch.ops import rng as trng
from kmerutils_tpu_torch.sketch import probminhash as tpmh

N = 4096


def u32_values(seed: int) -> np.ndarray:
    x = np.random.default_rng(seed).integers(0, 1 << 32, size=N,
                                             dtype=np.uint64)
    x[:4] = [0, 1 << 31, (1 << 32) - 1, (1 << 31) - 1]
    assert (x >= 1 << 31).sum() > N // 4
    return x.astype(np.uint32)


def u64_values(seed: int) -> np.ndarray:
    x = np.random.default_rng(seed).integers(0, 1 << 64, size=N,
                                             dtype=np.uint64)
    x[:4] = [0, 1 << 63, (1 << 64) - 1, (1 << 63) - 1]
    assert (x >= np.uint64(1 << 63)).sum() > N // 4
    return x


def t32(x: np.ndarray) -> torch.Tensor:
    """u32 numpy -> the port's int64 carrier."""
    return torch.from_numpy(x.astype(np.int64))


def t64(x: np.ndarray) -> torch.Tensor:
    """u64 numpy -> the port's int64 bit patterns."""
    return torch.from_numpy(x.view(np.int64).copy())


def back32(t: torch.Tensor) -> np.ndarray:
    v = t.numpy()
    assert ((v >= 0) & (v < 1 << 32)).all()   # carriers stay masked
    return v.astype(np.uint32)


def back64(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


@pytest.mark.parametrize("name", ["wang_hash32", "wang_hash32_inv"])
def test_hash32_matches_jax(name):
    x = u32_values(1)
    got = back32(getattr(trng, name)(t32(x)))
    assert (got == np.asarray(getattr(jrng, name)(x))).all()


@pytest.mark.parametrize("name", ["wang_hash64", "wang_hash64_inv",
                                  "splitmix64"])
def test_hash64_matches_jax(name):
    x = u64_values(2)
    got = back64(getattr(trng, name)(t64(x)))
    assert (got == np.asarray(getattr(jrng, name)(x))).all()


def test_wang_inverses_round_trip():
    x32, x64 = u32_values(3), u64_values(3)
    assert (back32(trng.wang_hash32_inv(trng.wang_hash32(t32(x32))))
            == x32).all()
    assert (back64(trng.wang_hash64_inv(trng.wang_hash64(t64(x64))))
            == x64).all()


@pytest.mark.parametrize("k", [1, 8, 15, 16])
def test_revcomp_u32_matches_jax(k):
    x = u32_values(4) & np.uint32((1 << 2 * k) - 1 if k < 16 else 0xFFFFFFFF)
    got = back32(tbit.revcomp_u32(t32(x), k))
    assert (got == np.asarray(jbit.revcomp_u32(x, k))).all()


@pytest.mark.parametrize("k", [1, 17, 21, 31, 32])
def test_revcomp_u64_matches_jax(k):
    mask = np.uint64((1 << 2 * k) - 1) if k < 32 else np.uint64(2**64 - 1)
    x = u64_values(5) & mask
    got = back64(tbit.revcomp_u64(t64(x), k))
    assert (got == np.asarray(jbit.revcomp_u64(x, k))).all()


def test_reverse_base_pairs_match_jax():
    x32, x64 = u32_values(6), u64_values(6)
    assert (back32(tbit.reverse_base_pairs_u32(t32(x32)))
            == np.asarray(jbit.reverse_base_pairs_u32(x32))).all()
    assert (back64(tbit.reverse_base_pairs_u64(t64(x64)))
            == np.asarray(jbit.reverse_base_pairs_u64(x64))).all()


def test_unsigned_order_and_i32_boundary():
    x = u64_values(7)
    a, b = t64(x), t64(x[::-1].copy())
    assert (tbit.lt_u64(a, b).numpy() == (x < x[::-1])).all()
    y = u32_values(7)
    i32 = tbit.u32_to_i32(t32(y))
    assert i32.dtype == torch.int32
    assert (i32.numpy().view(np.uint32) == y).all()
    assert (back32(tbit.i32_to_u32(i32)) == y).all()


@pytest.mark.parametrize("seed", [0, 1, 42, 2**40 + 3, 2**62 + 11])
def test_slot_consts_match_jax(seed):
    got = tpmh._slot_consts(200, seed, device="cpu").numpy().astype(np.uint32)
    assert (got == np.asarray(jpmh._slot_consts(200, seed))).all()
