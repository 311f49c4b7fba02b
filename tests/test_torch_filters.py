"""The port's shard dispatch (count/dispatch.py) and Bloom / counting Bloom
filters (count/filters.py) against the JAX package, on the CPU.

Tolerance: none.  Shard ids, probe indices, filter slots, memberships and
count estimates are equal integer for integer; the fill fraction is the
same float64.  Keys and hashes cross 2^31 and 2^63.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from kmerutils_tpu.count import dispatch as jd
from kmerutils_tpu.count import filters as jf
from kmerutils_tpu_torch.count import dispatch as td
from kmerutils_tpu_torch.count import filters as tf
from kmerutils_tpu_torch.ops.bitops import M32
from kmerutils_tpu_torch.ops.rng import wang_hash64


def keys_u64(seed: int, n: int, distinct: int | None = None) -> np.ndarray:
    """u64 keys, about half >= 2^63; with ``distinct``, n draws from that
    many keys (so keys repeat and counting slots saturate)."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 1 << 64, size=distinct or n, dtype=np.uint64)
    return pool if distinct is None else pool[rng.integers(0, distinct, n)]


def t64(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.uint64).view(np.int64))


@pytest.mark.parametrize("n_shards", [1, 2, 3, 7, 8, 1000, (1 << 31) - 1])
def test_dispatch_matches_jax(n_shards):
    v64 = keys_u64(n_shards, 4000)
    v32 = (v64 & np.uint64(M32)).astype(np.uint32)
    hi = wang_hash64(t64(v64)) < 0          # hashes >= 2^63
    assert 0 < int(hi.sum()) < v64.size
    want64 = np.asarray(jd.dispatch_u64(v64, n_shards))
    want32 = np.asarray(jd.dispatch_u32(v32, n_shards))
    got64 = td.dispatch_u64(t64(v64), n_shards)
    assert got64.dtype == torch.int32
    assert np.array_equal(got64.numpy(), want64)
    got32 = td.dispatch_u32(torch.from_numpy(v32.astype(np.int64)), n_shards)
    assert np.array_equal(got32.numpy(), want32)
    assert np.array_equal(td.dispatch_u32(torch.from_numpy(
        v32.view(np.int32)), n_shards).numpy(), want32)
    for k, vals, want in ((16, v32, want32), (21, v64, want64)):
        j = np.asarray(jd.dispatch(vals, n_shards, k))
        t = td.dispatch(t64(vals.astype(np.uint64)), n_shards, k)
        assert np.array_equal(j, want) and np.array_equal(t.numpy(), want)
    if n_shards > 1:
        assert want64.min() >= 0 and want64.max() < n_shards


@pytest.mark.parametrize("nb_hash,log2_slots", [(1, 8), (4, 20), (7, 31)])
def test_probe_indices_match_jax(nb_hash, log2_slots):
    k = keys_u64(nb_hash, 3000).reshape(30, 100)
    got = tf.probe_indices(t64(k), nb_hash, log2_slots)
    want = np.asarray(jf.probe_indices(k, nb_hash, log2_slots))
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert np.array_equal(got.numpy(), want)
    k32 = (k & np.uint64(M32)).astype(np.uint32)
    assert np.array_equal(
        tf.probe_indices(torch.from_numpy(k32.view(np.int32)), nb_hash,
                         log2_slots).numpy(),
        np.asarray(jf.probe_indices(k32.astype(np.uint64), nb_hash,
                                    log2_slots)))


def masks(seed: int, shape):
    rng = np.random.default_rng(seed)
    return [None, rng.random(shape) < 0.6, np.zeros(shape, bool)]


@pytest.mark.parametrize("log2_slots", [6, 12])
def test_bloom_filter_matches_jax(log2_slots):
    k1, k2 = keys_u64(1, 400).reshape(20, 20), keys_u64(2, 300)
    probe = np.concatenate([k1.ravel()[:100], keys_u64(3, 200)])
    for mask in masks(log2_slots, k1.shape):
        tb = tf.BloomFilter.create(log2_slots, 3, device="cpu")
        jb = jf.BloomFilter.create(log2_slots, 3)
        tm = None if mask is None else torch.from_numpy(mask)
        jm = None if mask is None else jnp.asarray(mask)
        tb1, jb1 = tb.insert(t64(k1), mask=tm), jb.insert(k1, mask=jm)
        assert tb.slots.sum() == 0          # insert returns a new filter
        assert tb1.slots.dtype == torch.uint8
        assert np.array_equal(tb1.slots.numpy(), np.asarray(jb1.slots))
        if mask is not None and not mask.any():
            assert tb1.slots[0] == 0        # masked keys touch no slot
        tb2 = tf.BloomFilter.create(log2_slots, 3, device="cpu").insert(
            t64(k2))
        jb2 = jf.BloomFilter.create(log2_slots, 3).insert(k2)
        tu, ju = tb1.union(tb2), jb1.union(jb2)
        assert np.array_equal(tu.slots.numpy(), np.asarray(ju.slots))
        for t, j in ((tb1, jb1), (tu, ju)):
            assert np.array_equal(t.contains(t64(probe)).numpy(),
                                  np.asarray(j.contains(probe)))
            ff = t.fill_fraction()
            assert ff.dtype == torch.float64
            assert float(ff) == float(j.fill_fraction())
        if mask is not None and mask.any():
            assert tb1.contains(t64(k1[mask])).all()


@pytest.mark.parametrize("nb_bits", [4, 8])
def test_counting_bloom_matches_jax(nb_bits):
    k = keys_u64(nb_bits, 6000, distinct=50).reshape(60, 100)
    probe = np.concatenate([k.ravel()[:200], keys_u64(7, 50)])
    rng = np.random.default_rng(nb_bits)
    incs = [None, rng.integers(0, 40, size=k.shape).astype(np.int32)]
    for inc in incs:
        for mask in masks(nb_bits + 10, k.shape):
            t = tf.CountingBloom.create(10, 4, nb_bits, device="cpu")
            j = jf.CountingBloom.create(10, 4, nb_bits)
            ti = None if inc is None else torch.from_numpy(inc)
            tm = None if mask is None else torch.from_numpy(mask)
            jm = None if mask is None else jnp.asarray(mask)
            t1 = t.insert(t64(k), increments=ti, mask=tm)
            j1 = j.insert(k, increments=inc, mask=jm)
            assert t1.slots.dtype == torch.int32
            assert np.array_equal(t1.slots.numpy(), np.asarray(j1.slots))
            assert int(t1.slots.max()) <= t1.max_count
            if mask is None:                # 120 copies a key: saturated
                assert int(t1.slots.max()) == t1.max_count
            t2 = t1.insert(t64(k[:5]), increments=None if inc is None
                           else torch.from_numpy(inc[:5]))
            j2 = j1.insert(k[:5], increments=None if inc is None
                           else inc[:5])
            assert np.array_equal(t2.slots.numpy(), np.asarray(j2.slots))
            tmg, jmg = t1.merge(t2), j1.merge(j2)
            assert np.array_equal(tmg.slots.numpy(), np.asarray(jmg.slots))
            for a, b in ((t1, j1), (tmg, jmg)):
                est = a.estimate_count(t64(probe))
                assert est.dtype == torch.int32
                assert np.array_equal(est.numpy(),
                                      np.asarray(b.estimate_count(probe)))


def test_counting_bloom_against_bincount():
    """Without saturation the slots are the bincount of the probes, and
    each estimate is at least the key's true count."""
    k = keys_u64(11, 5000, distinct=700)
    cb = tf.CountingBloom.create(14, 4, 16, device="cpu").insert(t64(k))
    idx = tf.probe_indices(t64(k), 4, 14).numpy().ravel()
    assert np.array_equal(cb.slots.numpy(),
                          np.bincount(idx, minlength=1 << 14))
    vals, counts = np.unique(k, return_counts=True)
    assert (cb.estimate_count(t64(vals)).numpy() >= counts).all()
