"""Parity of the plain merge / aggregation versions (kmerutils_tpu_torch.ops.
merge, the CPU side of kernels K3-K6) with the JAX package's Pallas kernels
in interpret mode.

The same numpy-seeded entries go to both, in each package's own layout: the
JAX kernels take u32 words (keys split into (hi, lo) for u64, sign-flipped
and persistent for K3/K4), the port takes unsigned keys in int32 / int64
and the coordinate as one int64 ``read << 32 | pos``.  Keys include values
>= 2^31 and >= 2^63.

Tolerance: exact.  K5 (stable, A first) and K4/K6 (one entry per key) are
compared entry by entry; K3 after sorting entries by (key, payload), since
the order within a run of equal keys is free.  The CUDA kernels themselves
are compared with these plain versions, exactly, on the card by
chip_smoke.py, which also holds K4/K6 to them at the run layouts around the
kernels' tile (chip_smoke.agg_layouts); here the plain versions meet a
numpy oracle at the same layouts.
"""

import os
import re

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import chip_smoke
from kmerutils_tpu.ops import merge_pallas as mp
from kmerutils_tpu_torch.ops import merge as M

FLIP = np.uint32(0x80000000)
M32 = np.uint64(0xFFFFFFFF)


def rand_keys(rng, n, wide, n_distinct=None, top=None):
    """n ascending unsigned keys, a third of them with the top bit set;
    ``n_distinct`` draws them from a small pool (ties)."""
    bits = 64 if wide else 32
    hi = np.uint64((1 << bits) - 17) if top is None else np.uint64(top)
    pool_n = n if n_distinct is None else n_distinct
    pool = rng.integers(1, hi, size=pool_n, dtype=np.uint64)
    pool[: pool_n // 3] |= np.uint64(1 << (bits - 1))
    pool = np.minimum(pool, hi)
    keys = np.sort(rng.choice(pool, size=n) if n_distinct else pool)
    return keys if wide else keys.astype(np.uint32)


def rand_words(rng, n):
    return rng.integers(0, 1 << 32, size=n, dtype=np.uint64).astype(np.uint32)


def key_words(keys, wide):
    """u32 keys -> [key]; u64 keys -> [hi, lo] (the JAX compare words)."""
    if not wide:
        return [keys.astype(np.uint32)]
    return [(keys >> np.uint64(32)).astype(np.uint32),
            (keys & M32).astype(np.uint32)]


def port_key(keys, wide):
    return torch.from_numpy(keys.view(np.int64) if wide
                            else keys.astype(np.uint32).view(np.int32))


def port_crd(chi, clo):
    return torch.from_numpy(((chi.astype(np.uint64) << np.uint64(32))
                             | clo).view(np.int64))


def from_port(key, cnt, crd, n, wide):
    """The port's entries [0, n) as JAX u32 word arrays."""
    k = key[:n].numpy()
    words = key_words(k.view(np.uint64) if wide else k.view(np.uint32), wide)
    if cnt is not None:
        words.append(cnt[:n].numpy().view(np.uint32))
    if crd is not None:
        c = crd[:n].numpy().view(np.uint64)
        words += [(c >> np.uint64(32)).astype(np.uint32),
                  (c & M32).astype(np.uint32)]
    return words


def sort_rows(words):
    """Entries (columns of words) sorted lexicographically."""
    order = np.lexsort(words[::-1])
    return [w[order] for w in words]


def to_persistent(words, ncmp, capacity, window, rng):
    """Raw u32 entry words -> the JAX table's kernel-native form: compare
    words flipped, physical length (n_tiles + 2) * T, random garbage past
    the live prefix."""
    T = window - 2048
    lp = (-(-capacity // T) + 2) * T
    out = []
    for j, x in enumerate(words):
        full = rand_words(rng, lp)
        full[: len(x)] = x
        if j < ncmp:
            full ^= FLIP
        out.append(jnp.asarray(full.view(np.int32)))
    return tuple(out)


def to_batch_kernel(words, ncmp, window):
    """Raw u32 batch words -> the JAX fold kernel's reversed b-side form."""
    nb_p = -(-len(words[0]) // 1024) * 1024
    out = []
    for j, x in enumerate(words):
        full = np.full(nb_p + window, 0xFFFFFFFF, np.uint32)
        full[: len(x)] = x
        if j < ncmp:
            full ^= FLIP
        out.append(jnp.asarray(full[::-1].copy().view(np.int32)))
    return tuple(out)


@pytest.mark.parametrize("na,nb,wide,with_crd,n_distinct", [
    (1000, 777, False, False, 300),     # many ties across A and B
    (3000, 2500, True, True, None),
    (2048, 0, False, True, None),       # empty B
])
def test_merge_sorted_matches_jax(na, nb, wide, with_crd, n_distinct):
    rng = np.random.default_rng(na + nb)
    ka = rand_keys(rng, na, wide, n_distinct and n_distinct // 2)
    kb = rand_keys(rng, nb, wide, n_distinct and n_distinct // 2) \
        if nb else ka[:0]
    ca = [rand_words(rng, na), rand_words(rng, na)]
    cb = [rand_words(rng, nb), rand_words(rng, nb)]
    ncmp = 2 if wide else 1
    a_words = key_words(ka, wide) + (ca if with_crd else [])
    b_words = key_words(kb, wide) + (cb if with_crd else [])
    want = mp.merge_sorted_u32(tuple(a_words), tuple(b_words), ncmp=ncmp,
                               window=4096)
    key, crd = M.merge_sorted(port_key(ka, wide),
                              port_crd(*ca) if with_crd else None,
                              port_key(kb, wide),
                              port_crd(*cb) if with_crd else None)
    n = na + nb
    got = from_port(key, None, crd, n, wide)
    assert key.numel() == n
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w)[:n])


@pytest.mark.parametrize("used,nb,wide,with_crd,capacity", [
    (5000, 3000, True, True, 9000),
    (900, 800, False, False, 1024),     # past capacity: largest keys drop
    (0, 500, True, False, 4000),        # empty table
    (1200, 0, False, True, 4000),       # empty batch
])
def test_merge_fold_matches_jax(used, nb, wide, with_crd, capacity):
    rng = np.random.default_rng(used * 7 + nb)
    ncmp = 2 if wide else 1
    ka = rand_keys(rng, used, wide)
    kb = rand_keys(rng, nb, wide)
    cnt = rng.integers(1, 1 << 32, size=used, dtype=np.uint64).astype(
        np.uint32)
    ca = [rand_words(rng, used), rand_words(rng, used)]
    cb = [rand_words(rng, nb), rand_words(rng, nb)]
    a_words = key_words(ka, wide) + [cnt] + (ca if with_crd else [])
    b_words = key_words(kb, wide) + [np.ones(nb, np.uint32)] \
        + (cb if with_crd else [])
    window = 4096
    outs = mp.merge_fold_i32(to_persistent(a_words, ncmp, capacity, window,
                                           rng),
                             to_batch_kernel(b_words, ncmp, window), used, nb,
                             ncmp=ncmp, capacity=capacity, window=window)
    n = min(used + nb, capacity)
    want = []
    for j, o in enumerate(outs):
        w = np.asarray(o)[:n].view(np.uint32)
        want.append(w ^ FLIP if j < ncmp else w.copy())

    # the port's table: live prefix, garbage behind it
    t_key = torch.cat([port_key(ka, wide), port_key(
        rand_keys(rng, 50, wide), wide)])
    t_cnt = torch.from_numpy(np.concatenate(
        [cnt, rand_words(rng, 50)]).view(np.int32))
    t_crd = torch.cat([port_crd(*ca), port_crd(rand_words(rng, 50),
                                               rand_words(rng, 50))]) \
        if with_crd else None
    key, c, crd, n_out = M.merge_fold(
        t_key, t_cnt, t_crd, used, port_key(kb, wide),
        port_crd(*cb) if with_crd else None, capacity)
    assert n_out == n and key.numel() == capacity
    got = from_port(key, c, crd, n, wide)
    for g, w in zip(sort_rows(got), sort_rows(want)):
        np.testing.assert_array_equal(g, w)
    # ascending keys over the merged prefix
    k = key[:n].numpy()
    k = k.view(np.uint64) if wide else k.view(np.uint32)
    assert np.all(k[:-1] <= k[1:])


def agg_inputs(rng, n, wide, with_crd):
    """Sorted entries with heavy duplication, 1 % of counts near 2^32 (so
    sums saturate), random coordinates."""
    keys = rand_keys(rng, n, wide, n_distinct=max(n // 4, 2))
    cnt = rng.integers(1, 10, size=n).astype(np.uint32)
    cnt[rng.random(n) < 0.01] = 0xFFFFFFF0
    crd = [rand_words(rng, n), rand_words(rng, n)] if with_crd else []
    return keys, cnt, crd


def with_long_run(keys, cnt, a: int, b: int):
    """Entries [a, b) made one run whose first and last counts are 2^31:
    its sum saturates, though no tile of 1024 entries within it does."""
    keys[a:b] = keys[a]
    cnt[a + 1: b - 1] = 3
    cnt[a] = cnt[b - 1] = 0x80000000


@pytest.mark.parametrize("n,wide,with_crd,lo,hi,long_run", [
    (5000, True, True, 2, 5, None),
    (3000, False, False, 1, None, None),
    (4096, False, True, 1, None, None),
    (0, False, False, 1, None, None),
    (5000, False, True, 1, None, (900, 3400)),   # > 2 JAX tiles of 1024
], ids=["5000-True-True-2-5", "3000-False-False-1-None",
        "4096-False-True-1-None", "0-False-False-1-None",
        "5000-False-True-1-None-long_run"])
def test_aggregate_fold_matches_jax(n, wide, with_crd, lo, hi, long_run):
    rng = np.random.default_rng(n + 11)
    ncmp = 2 if wide else 1
    keys, cnt, crd = agg_inputs(rng, n, wide, with_crd)
    if long_run:
        with_long_run(keys, cnt, *long_run)
    words = key_words(keys, wide) + [cnt] + crd
    capacity, window = 6000, 4096
    outs, n_live = mp.aggregate_fold_i32(
        to_persistent(words, ncmp, capacity, window, rng), n, kw=ncmp,
        coords=with_crd, capacity=capacity, window=window, lo=lo, hi=hi,
        tile=1024)
    n_live = int(n_live)
    want = []
    for j, o in enumerate(outs):
        w = np.asarray(o)[:n_live].view(np.uint32)
        want.append(w ^ FLIP if j < ncmp else w.copy())

    pad = 100
    t_key = torch.cat([port_key(keys, wide),
                       port_key(rand_keys(rng, pad, wide), wide)])
    t_cnt = torch.from_numpy(np.concatenate([cnt, rand_words(rng, pad)])
                             .view(np.int32))
    t_crd = torch.cat([port_crd(*crd), port_crd(rand_words(rng, pad),
                                                rand_words(rng, pad))]) \
        if with_crd else None
    key, c, r, got_n = M.aggregate_fold(t_key, t_cnt, t_crd, n, lo, hi)
    assert got_n == n_live and key.numel() == n + pad
    for g, w in zip(from_port(key, c, r, n_live, wide), want):
        np.testing.assert_array_equal(g, w)
    if n and hi is None:
        assert (c[:got_n].numpy().view(np.uint32) == 0xFFFFFFFF).any()
    if long_run:    # the long run is one entry, its sum saturated
        at = np.flatnonzero(from_port(key, None, None, got_n, wide)[-1]
                            == keys[long_run[0]].astype(np.uint32))
        assert len(at) == 1 and c[at[0]].item() == -1


@pytest.mark.parametrize("m,n_dead,wide,with_crd,lo,hi", [
    (5000, 1000, True, True, 1, None),
    (4000, 700, False, True, 2, 6),
    (3000, 3000, False, False, 1, None),   # all dead
])
def test_aggregate_compact_matches_jax(m, n_dead, wide, with_crd, lo, hi):
    rng = np.random.default_rng(m + n_dead)
    keys, cnt, crd = agg_inputs(rng, m - n_dead, wide, with_crd)
    ones32 = np.full(n_dead, 0xFFFFFFFF, np.uint32)
    words = [np.concatenate([w, ones32])
             for w in key_words(keys, wide) + [cnt] + crd]
    outs, n_live = mp.aggregate_compact_u32(
        tuple(words), kw=2 if wide else 1, coords=with_crd, lo=lo, hi=hi,
        tile=1024)
    want = [np.asarray(o) for o in outs]

    all_ones = np.concatenate([keys, np.full(
        n_dead, (1 << 64) - 1 if wide else 0xFFFFFFFF, keys.dtype)])
    key, c, r, got_n = M.aggregate_compact(
        port_key(all_ones, wide), torch.from_numpy(words[len(words) - 1 - (
            2 if with_crd else 0)].view(np.int32)),
        port_crd(words[-2], words[-1]) if with_crd else None, lo, hi)
    assert got_n == int(n_live)
    for g, w in zip(from_port(key, c, r, m, wide), want):
        np.testing.assert_array_equal(g, w)        # tail all ones included


def agg_oracle(keys, cnt, crd, lo: int, hi):
    """numpy K4 over live entries: per run of equal keys the key, the count
    sum saturated at 2^32 - 1, the coordinate minimum (unsigned); runs with
    lo <= count <= hi (lo <= 1 keeps all)."""
    if len(keys) == 0:
        return keys, cnt.view(np.int32), crd
    head = np.ones(len(keys), bool)
    head[1:] = keys[1:] != keys[:-1]
    at = np.flatnonzero(head)
    sums = np.add.reduceat(cnt.astype(np.uint64), at)
    sums = np.minimum(sums, np.uint64(0xFFFFFFFF))
    hi = 0xFFFFFFFF if hi is None else hi
    keep = (sums >= (lo if lo > 1 else 0)) & (sums <= hi)
    r_crd = None
    if crd is not None:
        r_crd = np.minimum.reduceat(crd.view(np.uint64), at)[keep].view(
            np.int64)
    return keys[at][keep], sums[keep].astype(np.uint32).view(np.int32), r_crd


AGG_LAYOUTS = [case[0] for case in chip_smoke.agg_layouts(
    np.random.default_rng(0), M.AGG_TILE)]


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("layout", AGG_LAYOUTS)
def test_aggregate_refs_match_numpy_oracle(layout, wide):
    """aggregate_fold_ref (over a table with garbage behind its live
    prefix) and aggregate_compact_ref (dead tail, all-ones fill) against
    agg_oracle, with and without coordinates, at the layouts on which
    chip_smoke.py holds the kernels to them: runs spanning
    tiles, ending on and one past tile boundaries, all distinct, sums
    saturating only across a tile boundary, lo/hi dropping runs that span
    tiles, and n = 0, 1, tile - 1, tile, tile + 1."""
    rng = np.random.default_rng(AGG_LAYOUTS.index(layout) * 2 + wide)
    _, lens, cnt, lo, hi = next(
        c for c in chip_smoke.agg_layouts(rng, M.AGG_TILE) if c[0] == layout)
    n = int(lens.sum())
    keys = chip_smoke.layout_keys(rng, lens, wide)
    crd = chip_smoke.coords(rng, n)
    for with_crd in (False, True):
        r = crd if with_crd else None
        want = agg_oracle(keys, cnt, r, lo, hi)
        m = len(want[0])
        pad = 37
        t_key = np.concatenate([keys, chip_smoke.layout_keys(
            rng, np.ones(pad, np.int64), wide)])
        t_cnt = np.concatenate([cnt.view(np.int32),
                                rng.integers(0, 9, pad).astype(np.int32)])
        t_crd = np.concatenate([crd, chip_smoke.coords(rng, pad)])
        got = M.aggregate_fold_ref(
            torch.from_numpy(t_key), torch.from_numpy(t_cnt),
            torch.from_numpy(t_crd) if with_crd else None, n, lo, hi)
        assert got[3] == m
        for g, w in zip(got[:3], want):
            if w is not None:
                np.testing.assert_array_equal(g[:m].numpy(), w)
        dead = n // 3 + 7
        d_key = np.concatenate([keys, np.full(dead, -1, keys.dtype)])
        d_cnt = np.concatenate([cnt.view(np.int32), np.full(dead, -1,
                                                            np.int32)])
        d_crd = np.concatenate([crd, np.full(dead, -1, np.int64)])
        got = M.aggregate_compact_ref(
            torch.from_numpy(d_key), torch.from_numpy(d_cnt),
            torch.from_numpy(d_crd) if with_crd else None, lo, hi)
        assert got[3] == m
        for g, w in zip(got[:3], want):
            if w is not None:
                np.testing.assert_array_equal(g[:m].numpy(), w)
                assert (g[m:] == -1).all()


def straddling_runs(rng, tile: int, at: int):
    """u32 keys (a third >= 2^31) of two sorted runs whose stable merge
    has one key repeated 50 times in A then 40 times in B across output
    diagonal ``tile``, ``at`` entries after the repeat's start, distinct
    keys before and after it."""
    low = np.sort(rng.choice(np.arange(1, 1 << 31, 7, dtype=np.uint64),
                             tile - at + 100, replace=False))
    low[::3] += np.uint64(1 << 31) - np.uint64(1 << 28)
    low = np.sort(low).astype(np.uint32)
    k = low[tile - at]
    before, after = low[: tile - at], low[tile - at + 1:]
    a_of = rng.random(low.size) < 0.5
    a = np.sort(np.concatenate([before[a_of[: before.size]], [k] * 50,
                                after[a_of[-after.size:]]])).astype(np.uint32)
    b = np.sort(np.concatenate([before[~a_of[: before.size]], [k] * 40,
                                after[~a_of[-after.size:]]])).astype(np.uint32)
    return a, b


def test_merge_sorted_straddling_a_tile_matches_jax():
    """Equal keys from both runs across the port's tile diagonal, with
    coordinates: the JAX kernel (interpret mode) gives the same keys entry
    by entry and the same (key, coordinate) entries.  Its bitonic merge
    orders the payloads of equal keys freely, so the entries are compared
    sorted; the port's order (A's copies first, each side's in order) is
    pinned against numpy."""
    rng = np.random.default_rng(8)
    ka, kb = straddling_runs(rng, M.MERGE_TILE, 30)
    ca = [rand_words(rng, ka.size), rand_words(rng, ka.size)]
    cb = [rand_words(rng, kb.size), rand_words(rng, kb.size)]
    want = mp.merge_sorted_u32((ka, *ca), (kb, *cb), ncmp=1, window=4096)
    key, crd = M.merge_sorted(port_key(ka, False), port_crd(*ca),
                              port_key(kb, False), port_crd(*cb))
    n = ka.size + kb.size
    got = from_port(key, None, crd, n, False)
    want = [np.asarray(w)[:n] for w in want]
    np.testing.assert_array_equal(got[0], want[0])
    for g, w in zip(sort_rows(got), sort_rows(want)):
        np.testing.assert_array_equal(g, w)
    order = np.argsort(np.concatenate([ka, kb]), kind="stable")
    for g, c in zip(got[1:], (np.concatenate([ca[0], cb[0]]),
                              np.concatenate([ca[1], cb[1]]))):
        np.testing.assert_array_equal(g, c[order])


MERGE_LAYOUTS = [case[0] for case in chip_smoke.merge_layouts(
    np.random.default_rng(0), M.MERGE_TILE)]


@pytest.mark.parametrize("with_crd", [False, True])
@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("layout", MERGE_LAYOUTS)
def test_merge_refs_match_numpy_oracle(layout, wide, with_crd):
    """merge_sorted_ref and merge_fold_ref (through the wrappers, over a
    table with garbage behind its live prefix and random counts) against
    a stable numpy argsort of the concatenated keys, at the layouts on
    which chip_smoke.py holds the kernels to them: na or nb 0 or 1, n =
    tile - 1, tile, tile + 1, all of A below or above all of B, one key
    across tiles, equal-key runs straddling tile diagonals from both
    sides, keys >= 2^31 and >= 2^63, and K3 capacities that cut the merge
    mid-tile and at a tile edge."""
    rng = np.random.default_rng(MERGE_LAYOUTS.index(layout))
    _, av, bv, cap = next(c for c in chip_smoke.merge_layouts(
        rng, M.MERGE_TILE) if c[0] == layout)
    a, b = chip_smoke.merge_keys(av, wide), chip_smoke.merge_keys(bv, wide)
    na, nb = a.size, b.size
    u = np.uint64 if wide else np.uint32
    cat = np.concatenate([a, b])
    order = np.argsort(cat.view(u), kind="stable")
    crd = chip_smoke.coords(rng, na + nb) if with_crd else None
    t = lambda x: None if x is None else torch.from_numpy(x)   # noqa: E731

    key, r = M.merge_sorted(t(a), t(None if crd is None else crd[:na]),
                            t(b), t(None if crd is None else crd[na:]))
    np.testing.assert_array_equal(key.numpy(), cat[order])
    if with_crd:
        np.testing.assert_array_equal(r.numpy(), crd[order])
    assert np.all(np.diff(key.numpy().view(u).astype(np.float64)) >= 0)

    pad = 37
    cnt = rng.integers(-(1 << 31), 1 << 31, na + pad).astype(np.int32)
    t_key = np.concatenate([a, chip_smoke.merge_keys(rng.integers(
        0, 1 << 32, pad, dtype=np.uint64), wide)])
    t_crd = None if crd is None else np.concatenate(
        [crd[:na], chip_smoke.coords(rng, pad)])
    capacity = cap or na + nb
    n_out = min(na + nb, capacity)
    key, c, r, n = M.merge_fold(t(t_key), t(cnt), t(t_crd), na, t(b),
                                t(None if crd is None else crd[na:]),
                                capacity)
    assert n == n_out and key.numel() == c.numel() == capacity
    cnts = np.concatenate([cnt[:na], np.ones(nb, np.int32)])
    np.testing.assert_array_equal(key[:n].numpy(), cat[order][:n])
    np.testing.assert_array_equal(c[:n].numpy(), cnts[order][:n])
    if with_crd:
        np.testing.assert_array_equal(r[:n].numpy(), crd[order][:n])
        assert r.numel() == capacity
    else:
        assert r is None


def test_merge_tile_matches_the_kernel_source():
    # kMergeTile = kThreads (256) x kMergeIpt (constants of csrc/merge.cu);
    # the library reports it on the card
    src = open(os.path.join(os.path.dirname(M.__file__), "..", "csrc",
                            "merge.cu")).read()
    ipt = re.search(r"constexpr int kMergeIpt = (\d+);", src)
    assert "constexpr int kThreads = 256;" in src
    assert 256 * int(ipt.group(1)) == M.MERGE_TILE


def test_wrappers_validate_inputs():
    k = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="cnt"):
        M.aggregate_fold(k, torch.zeros(8, dtype=torch.int64), None, 8)
    with pytest.raises(ValueError, match="used"):
        M.aggregate_fold(k, torch.zeros(8, dtype=torch.int32), None, 9)
    with pytest.raises(ValueError, match="key type"):
        M.merge_sorted(k, None, torch.zeros(3, dtype=torch.int64), None)
    with pytest.raises(ValueError, match="coordinates"):
        M.merge_fold(k, torch.zeros(8, dtype=torch.int32), None, 0, k,
                     torch.zeros(8, dtype=torch.int64), 16)
