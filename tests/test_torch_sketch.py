"""Parity of the port's ProbMinHash path (multiplicities, signatures,
hashed k-mers, Sketcher.sketch_batch) with the JAX package, on the CPU.

Tolerance: integers are exact (hashed k-mers, multiplicities, empty flags).
Signatures must be equal slot for slot; a mismatching slot is accepted only
as a proven near-tie between items of different weight (see
test_torch_tournament.py), which one-ulp differences between ``torch.log``
and ``jnp.log`` could cause.  Jaccard estimates (fractions of equal slots)
use ``np.allclose``: the port averages in float32, JAX in float64.
"""

import numpy as np
import pytest
import torch

from kmerutils_tpu.base import sequence as jseq
from kmerutils_tpu.sketch import jaccard as jjac
from kmerutils_tpu.sketch import probminhash as jpmh
from kmerutils_tpu.sketch.params import SeqSketcherParams as JParams
from kmerutils_tpu_torch.base import sequence as tseq
from kmerutils_tpu_torch.ops.weights import sort_weights
from kmerutils_tpu_torch.sketch import jaccard as tjac
from kmerutils_tpu_torch.sketch import probminhash as tpmh
from kmerutils_tpu_torch.sketch.params import SeqSketcherParams
from test_torch_tournament import assert_exact_or_near_ties, first_position

M = 200


def to_torch(items: np.ndarray) -> torch.Tensor:
    """u32 items -> int32 bit patterns, u64 items -> int64 bit patterns."""
    if items.dtype == np.uint32:
        return torch.from_numpy(items.view(np.int32).copy())
    return torch.from_numpy(items.view(np.int64).copy())


def to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32 if t.dtype == torch.int32 else np.uint64)


def row_weights(items: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """Within-row multiplicity of each valid position's item (0 elsewhere)."""
    w = np.zeros(items.shape, np.int64)
    for r in range(items.shape[0]):
        _, inv, cnt = np.unique(items[r][valid[r]], return_inverse=True,
                                   return_counts=True)
        w[r][valid[r]] = cnt[inv]
    return w


def assert_sigs_match(got: np.ndarray, want: np.ndarray, items, valid,
                      seed: int = 0):
    if (got == want).all():
        return
    w = row_weights(items, valid)
    x32 = items if items.dtype == np.uint32 else (
        (items ^ (items >> np.uint64(32))) & np.uint64(0xFFFFFFFF)
    ).astype(np.uint32)
    assert_exact_or_near_ties(first_position(items, w, got),
                              first_position(items, w, want), x32, w,
                              got.shape[1], seed)


def items_case(seed: int, wide: bool):
    """Ragged rows with many duplicates and values >= 2^31 / 2^63, one row
    of length 1 and one sentinel-valued item inside a valid prefix."""
    rng = np.random.default_rng(seed)
    P = 37
    if wide:
        pool = rng.integers(1 << 62, 1 << 64, size=8, dtype=np.uint64)
        items = rng.choice(pool, size=(4, P))
        items[0, 3] = np.uint64(2**64 - 1)             # the sentinel
    else:
        items = rng.integers(0, 8, size=(4, P)).astype(np.uint32) \
            + np.uint32(0xFFFFFFF0)
        items[0, 3] = np.uint32(0xFFFFFFFF)            # the sentinel
    lengths = np.array([P, P - 13, 5, 1])
    valid = np.arange(P)[None, :] < lengths[:, None]
    return items, valid


@pytest.mark.parametrize("wide", [False, True])
def test_run_multiplicities_match_jax(wide):
    items, valid = items_case(1, wide)
    s, winv, is_real = sort_weights(to_torch(items), torch.from_numpy(valid))
    sent = np.uint64(2**64 - 1) if wide else np.uint32(0xFFFFFFFF)
    js = np.sort(np.where(valid, items, sent), axis=1)
    assert (to_numpy(s) == js).all()
    assert (is_real.numpy() == (js != sent)).all()
    w = np.asarray(jpmh._run_multiplicities(js, js != sent))
    assert (winv.numpy() == (1.0 / np.maximum(w, 1)).astype(np.float32)).all()


@pytest.mark.parametrize("wide", [False, True])
def test_fold32_matches_jax(wide):
    items, _ = items_case(4, wide)
    got = tpmh._fold32(to_torch(items))
    assert got.dtype == torch.int32
    assert (to_numpy(got) == np.asarray(jpmh._fold32(items))).all()


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("seed", [0, 9])
def test_probminhash_from_items_matches_jax(wide, seed):
    items, valid = items_case(2, wide)
    got, empty = tpmh.probminhash_from_items(
        to_torch(items), torch.from_numpy(valid), 128, seed=seed)
    want, jempty, _ = jpmh.probminhash_from_items(items, valid, 128,
                                                  seed=seed)
    assert (empty.numpy() == np.asarray(jempty)).all()
    # the sentinel-valued item counts as padding in both packages
    assert not (to_numpy(got) == items[0, 3]).any()
    real = valid & (items != items[0, 3])
    assert_sigs_match(to_numpy(got), np.asarray(want), items, real, seed)


@pytest.mark.parametrize("wide", [False, True])
def test_probminhash_signatures_match_jax(wide):
    rng = np.random.default_rng(3)
    items, _ = items_case(3, wide)
    w = rng.integers(0, 6, size=items.shape).astype(np.int32)
    w[2] = 0                                           # an empty row
    got, empty = tpmh.probminhash_signatures(to_torch(items),
                                             torch.from_numpy(w), M)
    want, jempty, _ = jpmh.probminhash_signatures(items, w, M)
    assert (empty.numpy() == np.asarray(jempty)).all() and empty[2]
    assert (to_numpy(got)[2] == 0).all()
    assert_sigs_match(to_numpy(got), np.asarray(want), items, w > 0)


def reads(seed: int, n: int = 12):
    rng = np.random.default_rng(seed)
    lens = rng.integers(30, 2500, size=n)
    lens[0] = 5                                        # no k-mer at all
    rs = ["".join(rng.choice(list("ACGT"), size=int(L))) for L in lens]
    rs[2] = rs[1]                                      # a duplicate read
    return rs


@pytest.mark.parametrize("k", [8, 21])
def test_hashed_kmers_match_jax(k):
    rs = reads(4, 5)
    ji, jv = jjac.hashed_kmers(jseq.pack_ascii_reads(rs), k)
    ti, tv = tjac.hashed_kmers(tseq.pack_ascii_reads(rs, device="cpu"), k)
    assert ti.dtype == (torch.int32 if k <= 16 else torch.int64)
    assert (tv.numpy() == np.asarray(jv)).all()
    assert (to_numpy(ti) == np.asarray(ji)).all()


@pytest.mark.parametrize("k", [8, 21])
def test_sketch_batch_matches_jax(k):
    rs = reads(5)
    jsk = jjac.Sketcher(params=JParams(kmer_size=k, sketch_size=M))
    tsk = tjac.Sketcher(params=SeqSketcherParams(kmer_size=k, sketch_size=M))
    want = np.asarray(jsk.sketch_batch(jseq.pack_ascii_reads(rs)))
    got = to_numpy(tsk.sketch_batch(tseq.pack_ascii_reads(rs, device="cpu")))
    assert got.dtype == want.dtype and got.shape == want.shape
    assert (got[0] == 0).all() and (got[1] == got[2]).all()
    ji, jv = jjac.hashed_kmers(jseq.pack_ascii_reads(rs), k)
    assert_sigs_match(got, want, np.asarray(ji), np.asarray(jv))


def test_probjaccard_estimators_match_jax():
    rng = np.random.default_rng(6)
    sigs = rng.integers(0, 3, size=(5, 64)).astype(np.uint32)
    t = to_torch(sigs)
    assert np.allclose(tpmh.probjaccard_pair(t[0], t[1]).numpy(),
                       np.asarray(jpmh.probjaccard_pair(sigs[0], sigs[1])))
    assert np.allclose(tpmh.probjaccard_one_vs_many(t[0], t).numpy(),
                       np.asarray(jpmh.probjaccard_one_vs_many(sigs[0], sigs)))
    assert np.allclose(tpmh.probjaccard_matrix(t).numpy(),
                       np.asarray(jpmh.probjaccard_matrix(sigs)))


def test_jaccard_of_half_read_is_near_theory():
    # a read against its first half: J ~ 0.5, and against itself exactly 1
    rng = np.random.default_rng(7)
    full = "".join(rng.choice(list("ACGT"), size=2000))
    tsk = tjac.Sketcher(params=SeqSketcherParams(kmer_size=11,
                                                 sketch_size=256))
    sig = tsk.sketch_batch(tseq.pack_ascii_reads([full, full[:1000], full],
                                                device="cpu"))
    assert abs(float(tsk.jaccard(sig[0], sig[1])) - 0.5) < 0.12
    assert float(tsk.jaccard(sig[0], sig[2])) == 1.0
