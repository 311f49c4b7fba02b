"""The port's bottom-k MinHash (sketch/minhash.py) and range sketches
(sketch/seqminhash.py) against the JAX package, on the CPU.

Tolerance: none.  Sketch hashes, counts and inverted k-mers are equal
integer for integer (u64 hashes compared as unsigned, across 2^63), the
distance tuples are equal, and the SuperMinHash range signatures (float64
pi + u / 2^u_bits, exact) are equal bit for bit.
"""

import numpy as np
import pytest
import torch

from kmerutils_tpu.base import sequence as jseq
from kmerutils_tpu.sketch import minhash as jm
from kmerutils_tpu.sketch import seqminhash as jsq
from kmerutils_tpu_torch.base import sequence as tseq
from kmerutils_tpu_torch.sketch import minhash as tm
from kmerutils_tpu_torch.sketch import seqminhash as tsq

ALL_ONES = np.uint64(0xFFFFFFFFFFFFFFFF)


def u64(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


def t64(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.uint64).view(np.int64))


def hash_rows(seed: int, n: int = 8, P: int = 40):
    """u64 hashes, half >= 2^63; row 0 repeats a run of values, row 1 holds
    the all-ones value (which drops, as the sentinel), row 2 is all
    invalid, row 3 has one valid entry, row 4 repeats one value."""
    rng = np.random.default_rng(seed)
    h = rng.integers(0, 1 << 64, size=(n, P), dtype=np.uint64)
    h[0, 10:20] = h[0, :10]
    h[1, 5] = h[1, 9] = ALL_ONES
    h[4] = h[4, 0]
    valid = rng.random((n, P)) < 0.85
    valid[1, 5] = valid[1, 9] = True
    valid[2] = False
    valid[3] = False
    valid[3, 7] = True
    assert (h[valid] >= np.uint64(1 << 63)).any()
    return h, valid


def assert_sketch_equal(got, want):
    (gs, gc), (ws, wc) = got, want
    ws, wc = np.asarray(ws), np.asarray(wc)
    assert gs.dtype == torch.int64 and gc.dtype == torch.int32
    assert gs.shape == ws.shape and gc.shape == wc.shape
    assert np.array_equal(u64(gs), ws)
    assert np.array_equal(gc.numpy(), wc)


# size 64 > P = 40: both return P columns
@pytest.mark.parametrize("size", [1, 5, 16, 64])
@pytest.mark.parametrize("seed", [0, 1])
def test_bottomk_sketch_matches_jax(size, seed):
    h, valid = hash_rows(seed)
    got = tm.bottomk_sketch(t64(h), torch.from_numpy(valid), size)
    assert_sketch_equal(got, jm.bottomk_sketch(h, valid, size))
    s, c = got
    assert s.shape[1] == min(size, h.shape[1])
    assert (u64(s)[2] == ALL_ONES).all() and (c[2] == 0).all()
    assert (u64(s)[1] != ALL_ONES).sum() == min(
        size, len(set(h[1][valid[1]].tolist()) - {int(ALL_ONES)}))


def test_bottomk_counts_are_run_lengths():
    h, valid = hash_rows(5)
    s, c = tm.bottomk_sketch(t64(h), torch.from_numpy(valid), 40)
    for r in range(h.shape[0]):
        vals, counts = np.unique(h[r][valid[r] & (h[r] != ALL_ONES)],
                                 return_counts=True)
        n = vals.size
        assert np.array_equal(u64(s)[r, :n], vals)
        assert np.array_equal(c.numpy()[r, :n], counts)


@pytest.mark.parametrize("seed", [0, 9])
def test_sketch_items_matches_jax(seed):
    h, valid = hash_rows(seed + 2)
    assert_sketch_equal(tm.sketch_items(t64(h), torch.from_numpy(valid), 12,
                                        seed=seed),
                        jm.sketch_items(h, valid, 12, seed=seed))


@pytest.mark.parametrize("wide", [False, True])
def test_invhash_sketch_and_inversion_match_jax(wide):
    h, valid = hash_rows(3)
    items = h if wide else h & np.uint64(0xFFFFFFFF)
    tv = torch.from_numpy(valid)
    got = tm.sketch_items_invhash(t64(items), tv, 16, wide=wide)
    want = jm.sketch_items_invhash(items, valid, 16, wide=wide)
    assert_sketch_equal(got, want)
    inv = tm.invert_sketch(got[0], wide=wide)
    jinv = np.asarray(jm.invert_sketch(want[0], wide=wide))
    assert np.array_equal(inv.numpy().view(np.uint64) if wide
                          else inv.numpy(), jinv)
    # the round trip: every live slot inverts to an item of its row
    live = got[1].numpy() > 0
    for r in range(items.shape[0]):
        got_items = set(inv.numpy()[r][live[r]].view(np.uint64).tolist()
                        if wide else inv.numpy()[r][live[r]].tolist())
        assert got_items <= set(items[r][valid[r]].tolist())
    # u32 items given as int32 bit patterns hash as their u32 values
    if not wide:
        i32 = torch.from_numpy(items.astype(np.uint32).view(np.int32))
        assert_sketch_equal(tm.sketch_items_invhash(i32, tv, 16), want)


def test_minhash_distance_matches_jax():
    rng = np.random.default_rng(4)
    base = np.sort(rng.integers(0, 1 << 64, size=60, dtype=np.uint64))
    cases = [(base[:30], base[10:40]), (base[:30], base[:30]),
             (base[:5], base[30:60]), (base[:0], base[:8]),
             (np.concatenate([base[:20], [ALL_ONES] * 4]), base[5:29])]
    for a, b in cases:
        want = jm.minhash_distance(a, b)
        assert tm.minhash_distance(t64(a), t64(b)) == want
        assert tm.minhash_distance(a, b) == want
    h, valid = hash_rows(6)
    s, _ = tm.bottomk_sketch(t64(h), torch.from_numpy(valid), 16)
    js, _ = jm.bottomk_sketch(h, valid, 16)
    assert tm.minhash_distance(s[0], s[4]) \
        == jm.minhash_distance(np.asarray(js)[0], np.asarray(js)[4])


def reads(seed: int, n: int = 6):
    rng = np.random.default_rng(seed)
    lens = rng.integers(40, 160, size=n)
    lens[1] = 12
    rs = ["".join(rng.choice(list("ACGT"), size=int(L))) for L in lens]
    rs[3] = rs[2]
    return rs


@pytest.mark.parametrize("k", [9, 10, 11, 12, 13, 14, 16])
def test_seqrange_sketches_match_jax(k):
    rs = reads(k)
    tb = tseq.pack_ascii_reads(rs, device="cpu")
    jb = jseq.pack_ascii_reads(rs)
    for start, end in ((0, 10_000), (7, 90), (30, 30 + k)):
        got = tsq.sketch_seqrange_minhash(tb, start, end, k, 24)
        assert_sketch_equal(got, jsq.sketch_seqrange_minhash(jb, start, end,
                                                             k, 24))
        sig = tsq.sketch_seqrange_superminhash(tb, start, end, k, 32,
                                               seed=k)
        want = np.asarray(jsq.sketch_seqrange_superminhash(jb, start, end, k,
                                                           32, seed=k))
        assert sig.dtype == torch.float64 and sig.shape == want.shape
        assert np.array_equal(sig.numpy(), want)
    # a range of exactly one k-mer keeps one distinct hash per long read
    s, c = tsq.sketch_seqrange_minhash(tb, 30, 30 + k, k, 24)
    assert (c.numpy()[[0, 2, 3], 0] == 1).all()
    assert (u64(s)[[0, 2, 3], 1] == ALL_ONES).all()


@pytest.mark.parametrize("k", [8, 15, 17])
def test_seqrange_k_dispatch_raises_like_jax(k):
    tb = tseq.pack_ascii_reads(reads(1), device="cpu")
    jb = jseq.pack_ascii_reads(reads(1))
    for tf, jf in ((tsq.sketch_seqrange_minhash,
                    jsq.sketch_seqrange_minhash),
                   (tsq.sketch_seqrange_superminhash,
                    jsq.sketch_seqrange_superminhash)):
        with pytest.raises(ValueError) as te:
            tf(tb, 0, 100, k, 16)
        with pytest.raises(ValueError) as je:
            jf(jb, 0, 100, k, 16)
        assert str(te.value) == str(je.value)
