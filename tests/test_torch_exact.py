"""Parity of the port's exact counting (count/exact.py), kernel K7
(ops/merge.compact_live), kmer_coordinates, ntHash and the
whole-collection sketch with the JAX package, on the CPU.

The same numpy-seeded reads go through both packages.  JAX's K7
(``compact_live_u32``) runs in interpret mode; the port's K7 takes its
plain version on CPU tensors.  JAX's K7 returns arrays padded to a whole
number of tiles: only the first m entries are compared.  K7's plain
version is also held to a numpy statement of its contract at the layouts
around the CUDA kernel's tile that chip_smoke.py checks the kernel at on
the card (``chip_smoke.live_layouts``).

Tolerance: exact equality of every key, count, coordinate, hash, signature
and estimate.
"""

import functools
import os
import re

import numpy as np
import pytest
import torch

import chip_smoke
from kmerutils_tpu.base import kmer as j_kmer
from kmerutils_tpu.base import nthash as j_nthash
from kmerutils_tpu.base.sequence import pack_ascii_reads as j_pack
from kmerutils_tpu.count import exact as j_exact
from kmerutils_tpu.ops import merge_pallas as j_mp
from kmerutils_tpu.sketch import jaccard as j_jac
from kmerutils_tpu.sketch.params import SeqSketcherParams as JParams
from kmerutils_tpu_torch.base import kmer as t_kmer
from kmerutils_tpu_torch.base import nthash as t_nthash
from kmerutils_tpu_torch.base.sequence import pack_ascii_reads
from kmerutils_tpu_torch.count import exact as t_exact
from kmerutils_tpu_torch.ops import merge as t_merge
from kmerutils_tpu_torch.sketch import jaccard as t_jac
from kmerutils_tpu_torch.sketch.params import SeqSketcherParams as TParams

t_pack = functools.partial(pack_ascii_reads, device="cpu")

# k = 32 keys with an all-ones half: T^16A^16 (0xFFFFFFFF00000000) and
# A^16T^16 (0x00000000FFFFFFFF) are their own reverse complements
PALINDROMES = ["GGG" + "T" * 16 + "A" * 16 + "CCCCC",
               "C" + "A" * 16 + "T" * 16 + "GG"]


def make_reads(seed: int, n: int = 7):
    """n reads of 40-160 bases, one repeated, one short (no 32-mer), and
    the two k = 32 palindrome reads."""
    rng = np.random.default_rng(seed)
    rs = ["".join(rng.choice(list("ACGT"), size=int(L)))
          for L in rng.integers(40, 160, size=n)]
    rs[2] = rs[0]
    rs[3] = rs[3][:20]
    return rs + PALINDROMES


def u(t: torch.Tensor) -> np.ndarray:
    """A port tensor of bit patterns as numpy unsigned words."""
    a = t.numpy()
    return a.view({np.int32: np.uint32, np.int64: np.uint64}[a.dtype.type])


def same(got, want) -> None:
    want = np.asarray(want)
    got = u(got) if isinstance(got, torch.Tensor) \
        and got.dtype in (torch.int32, torch.int64) \
        and want.dtype.kind == "u" else np.asarray(got)
    assert got.shape == want.shape
    assert np.array_equal(got.astype(want.dtype), want)


def dense_same(got, want) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("m,narr,tile,frac", [
    (1000, 1, 1024, 0.5),
    (5000, 3, 1024, 0.1),
])
def test_compact_live_ref_matches_jax(m, narr, tile, frac):
    rng = np.random.default_rng(m + narr)
    keys = rng.integers(0, 2**32 - 1, m, dtype=np.uint64).astype(np.uint32)
    keys[rng.random(m) >= frac] = 0xFFFFFFFF
    arrs = [keys] + [rng.integers(0, 2**32, m, dtype=np.uint64)
                     .astype(np.uint32) for _ in range(narr - 1)]
    want, want_n = j_mp.compact_live_u32(tuple(arrs), tile=tile)
    got, n_live = t_merge.compact_live(
        tuple(torch.from_numpy(a.view(np.int32)) for a in arrs))
    assert n_live == int(want_n) == int((keys != 0xFFFFFFFF).sum())
    for g, w in zip(got, want):
        assert np.array_equal(u(g), np.asarray(w)[:m])   # JAX pads to tiles
    assert t_merge.launches_live == 0     # CPU tensors: the plain version


def test_compact_live_ref_matches_jax_across_a_dead_stretch():
    # five arrays; a dead stretch longer than one JAX tile between live
    # entries on both sides
    m, tile = 3000, 1024
    rng = np.random.default_rng(11)
    live = rng.random(m) < 0.5
    live[700:2100] = False
    arrs = chip_smoke.live_words(rng, live, 5)
    want, want_n = j_mp.compact_live_u32(tuple(a.view(np.uint32)
                                               for a in arrs), tile=tile)
    got, n_live = t_merge.compact_live(tuple(torch.from_numpy(a)
                                             for a in arrs))
    assert n_live == int(want_n) == int(live.sum())
    for g, w in zip(got, want):
        assert np.array_equal(u(g), np.asarray(w)[:m])


# K7's layouts around its tile (chip_smoke.live_layouts, which phase 9 of
# chip_smoke.py runs on the card): the plain version against a numpy
# oracle of the contract
LIVE_LAYOUTS = [case[0] for case in chip_smoke.live_layouts(
    np.random.default_rng(0), t_merge.LIVE_TILE)]


def live_layout_case(layout: str, narr: int):
    rng = np.random.default_rng(0)
    live = dict(chip_smoke.live_layouts(rng, t_merge.LIVE_TILE))[layout]
    return live, chip_smoke.live_words(rng, live, narr)


def assert_compacted(live, words):
    got, n_live = t_merge.compact_live(tuple(torch.from_numpy(w)
                                             for w in words))
    assert n_live == int(live.sum())
    for g, w in zip(got, words):
        want = np.full(w.size, -1, np.int32)
        want[:n_live] = w[live]
        assert g.dtype == torch.int32 and np.array_equal(g.numpy(), want)


@pytest.mark.parametrize("narr", [1, 5])
@pytest.mark.parametrize("layout", LIVE_LAYOUTS)
def test_compact_live_ref_at_tile_layouts(layout, narr):
    assert_compacted(*live_layout_case(layout, narr))


@pytest.mark.parametrize("narr", [2, 3, 4])
def test_compact_live_ref_through_a_dead_chain(narr):
    assert_compacted(*live_layout_case(
        "40 all-dead tiles, then one live entry", narr))


def test_live_tile_matches_the_kernel_source():
    # kLiveTile = kLiveThreads x kLiveIpt (constants of csrc/merge.cu);
    # the library reports it on the card
    src = open(os.path.join(os.path.dirname(t_merge.__file__), "..", "csrc",
                            "merge.cu")).read()
    consts = dict(re.findall(r"constexpr int (kLive\w+) = (\d+);", src))
    assert int(consts["kLiveThreads"]) \
        * int(consts["kLiveIpt"]) == t_merge.LIVE_TILE


def test_compact_live_checks_inputs():
    a = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError):
        t_merge.compact_live((a,) * 6)
    with pytest.raises(ValueError):
        t_merge.compact_live((a, torch.zeros(7, dtype=torch.int32)))
    with pytest.raises(ValueError):
        t_merge.compact_live((a.to(torch.int64),))
    outs, n = t_merge.compact_live((torch.zeros(0, dtype=torch.int32),))
    assert n == 0 and outs[0].numel() == 0


@pytest.mark.parametrize("k", [8, 16, 21, 32])
def test_counts_match_jax(k):
    reads = make_reads(40 + k)
    jb, tb = j_pack(reads), t_pack(reads)
    jkc, tkc = j_exact.count_batch(jb, k), t_exact.count_batch(tb, k)
    for f in ("keys", "counts", "n_distinct", "n_unique"):
        same(getattr(tkc, f), getattr(jkc, f))
    dense_same(t_exact.compact(tkc), j_exact.compact(jkc))
    jm, jv = j_exact.multiplicity_per_slot(jb, k)
    tm, tv = t_exact.multiplicity_per_slot(tb, k)
    same(tm, jm)
    same(tv, jv)


@pytest.mark.parametrize("k", [8, 16, 21, 32])
def test_detailed_and_unique_match_jax(k):
    reads = make_reads(50 + k)
    jb, tb = j_pack(reads), t_pack(reads)
    jd = j_exact.count_batch_detailed(jb, k, read_num_offset=7)
    td = t_exact.count_batch_detailed(tb, k, read_num_offset=7)
    for g, w in zip(td, jd):
        same(g, w)
    dense_same(t_exact.compact_detailed(*td[:4]),
               j_exact.compact_detailed(*jd[:4]))
    ju = j_exact.unique_kmer_coords(jb, k, read_num_offset=7)
    tu = t_exact.unique_kmer_coords(tb, k, read_num_offset=7)
    for g, w in zip(tu, ju):
        same(g, w)
    dense_same(t_exact.compact_unique(*tu[:3]),
               j_exact.compact_unique(*ju[:3]))


def test_k32_keys_with_an_all_ones_half_survive_compaction():
    # K7 takes an entry as dead when its first word is all ones: fed a
    # u64 key's high word it would lose T^16A^16, fed the low word
    # A^16T^16; the port derives the liveness word from the counts
    jb, tb = j_pack(PALINDROMES[:1]), t_pack(PALINDROMES[:1])
    jd = j_exact.count_batch_detailed(jb, 32)
    td = t_exact.count_batch_detailed(tb, 32)
    assert int(td[4]) == int(jd[4]) == 6
    keys, counts, _, _ = t_exact.compact_detailed(*td[:4])
    assert keys.size == 6 and 0xFFFFFFFF00000000 in keys.tolist()
    dense_same((keys, counts), j_exact.compact_detailed(*jd[:4])[:2])
    hi = (td[0] >> 32).to(torch.int32)
    _, kept = t_merge.compact_live((hi,))
    assert kept == 5           # the hazard the liveness word avoids
    both = t_pack(PALINDROMES)
    keys, _ = t_exact.compact(t_exact.count_batch(both, 32))
    assert {0xFFFFFFFF00000000, 0xFFFFFFFF} <= set(keys.tolist())
    ukeys, _, _ = t_exact.compact_unique(
        *t_exact.unique_kmer_coords(both, 32)[:3])
    assert 0xFFFFFFFF in ukeys.tolist()


def test_count_from_values_matches_jax():
    rng = np.random.default_rng(5)
    for dt, top in ((np.uint32, 2**32), (np.uint64, 2**64)):
        v = rng.integers(0, 40, 300, dtype=np.uint64).astype(dt)
        v[::7] = np.iinfo(dt).max                         # the sentinel
        v[1::9] = dt(top - 2)                             # top bit set
        jkc = j_exact.count_from_values(v)
        tkc = t_exact.count_from_values(torch.from_numpy(
            v.view(np.int32 if dt == np.uint32 else np.int64)))
        for f in ("keys", "counts", "n_distinct", "n_unique"):
            same(getattr(tkc, f), getattr(jkc, f))


def test_multiplicity_from_values_matches_jax():
    rng = np.random.default_rng(6)
    v = rng.integers(0, 9, (5, 40), dtype=np.uint64) | np.uint64(1 << 63)
    valid = rng.random((5, 40)) < 0.8
    got = t_exact.multiplicity_from_values(
        torch.from_numpy(v.view(np.int64)), torch.from_numpy(valid))
    same(got, j_exact.multiplicity_from_values(v, valid))


def test_host_merges_match_jax():
    rng = np.random.default_rng(8)
    parts = []
    for n in (50, 0, 80):
        keys = np.unique(rng.integers(0, 60, n).astype(np.uint64))
        parts.append((keys, rng.integers(1, 9, keys.size),
                      rng.integers(0, 5, keys.size).astype(np.uint32),
                      rng.integers(0, 99, keys.size).astype(np.uint32)))
    dense_same(t_exact.merge_counts_host([p[:2] for p in parts]),
               j_exact.merge_counts_host([p[:2] for p in parts]))
    dense_same(t_exact.merge_detailed_host(parts),
               j_exact.merge_detailed_host(parts))


@pytest.mark.parametrize("k", [8, 21])
def test_kmer_coordinates_match_jax(k):
    reads = make_reads(60)
    for g, w in zip(t_kmer.kmer_coordinates(t_pack(reads), k, 2**32 - 3),
                    j_kmer.kmer_coordinates(j_pack(reads), k, 2**32 - 3)):
        same(g, w)


@pytest.mark.parametrize("k", [5, 21, 32])
def test_nthash_matches_jax(k):
    reads = make_reads(70 + k)
    got = t_nthash.nthash_kmers(t_pack(reads), k)
    want = j_nthash.nthash_kmers(j_pack(reads), k)
    for g, w in zip(got, want):
        same(g, w)
    same(t_nthash.multi_hash(got[2], k, 4), j_nthash.multi_hash(want[2], k, 4))
    if k == 21:
        jkc = j_exact.count_batch_nthash(j_pack(reads), k)
        tkc = t_exact.count_batch_nthash(t_pack(reads), k)
        same(tkc.keys, jkc.keys)
        same(tkc.counts, jkc.counts)


@pytest.mark.parametrize("k", [8, 21])
def test_sketch_collection_matches_jax(k):
    reads = make_reads(80 + k)
    want = j_jac.Sketcher(JParams(kmer_size=k, sketch_size=48)) \
        .sketch_collection(j_pack(reads))
    got = t_jac.Sketcher(TParams(kmer_size=k, sketch_size=48)) \
        .sketch_collection(t_pack(reads))
    same(got, want)
    items, weights, valid = t_jac.hashed_weighted_kmers(t_pack(reads), k)
    ji, jw, jv = j_jac.hashed_weighted_kmers(j_pack(reads), k)
    for g, w in ((items, ji), (weights, jw), (valid, jv)):
        same(g, w)


def test_jaccard_functions_match_jax():
    reads = make_reads(90)
    jp, tp = JParams(kmer_size=8, sketch_size=64), \
        TParams(kmer_size=8, sketch_size=64)
    want = np.asarray(j_jac.jaccard_one_vs_many(
        j_pack(reads[:1]), j_pack(reads), jp)).astype(np.float32)
    got = t_jac.jaccard_one_vs_many(t_pack(reads[:1]), t_pack(reads), tp)
    assert np.array_equal(got.numpy(), want) and want[0] == want[2] == 1.0
    a = {int(x): int(w) for x, w in zip(range(5, 90, 3), range(1, 40))}
    b = {int(x) + (1 << 63): 2 for x in range(20, 70, 2)}
    b.update({x: 1 for x in list(a)[:10]})
    for ret in (False, True):
        assert t_jac.compute_probminhash3a_jaccard(a, b, 64, ret, seed=3) \
            == j_jac.compute_probminhash3a_jaccard(a, b, 64, ret, seed=3)
    sa = torch.tensor([1, -2, 3, 4], dtype=torch.int64)
    sb = torch.tensor([1, -2, 5, 6], dtype=torch.int64)
    assert t_jac.probminhash_get_jaccard_objects(sa, sb) \
        == j_jac.probminhash_get_jaccard_objects(u(sa), u(sb))
