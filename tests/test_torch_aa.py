"""Parity of the port's amino-acid k-mers and AA sketcher (kmerutils_tpu_torch.
aa) with the JAX package, on the CPU.

Tolerance: k-mers, hashed items and validity are exact.  SUPER2, SUPER,
OPTDENS and REVOPTDENS signatures are equal bit for bit; PROB3A signatures
too, except a slot proven to be a near-tie between items of different
weight (test_torch_sketch.py's rule); HLL registers too, except registers
proven to sit on a float32 floor boundary (test_torch_families.py's rule).
"""

import numpy as np
import pytest
import torch

from kmerutils_tpu.aa import kmeraa as jaa
from kmerutils_tpu.sketch.params import SeqSketcherParams as JParams
from kmerutils_tpu.sketch.params import SketchAlgo as JAlgo
from kmerutils_tpu_torch.aa import alphabet as talpha
from kmerutils_tpu_torch.aa import kmeraa as taa
from kmerutils_tpu_torch.sketch import setsketch as tss
from kmerutils_tpu_torch.sketch.params import SeqSketcherParams, SketchAlgo
from test_torch_families import assert_registers_match, hll_h_best
from test_torch_sketch import assert_sigs_match

AA = "ACDEFGHIKLMNPQRSTVWY"


def proteins(seed: int, n: int = 9):
    """Sequences of 20-250 residues, one of 3 residues (shorter than any
    k here), one duplicate."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(20, 250, size=n)
    lens[1] = 3
    ss = ["".join(rng.choice(list(AA), size=int(L))) for L in lens]
    ss[4] = ss[3]
    return ss


def batches(ss):
    return jaa.pack_aa_reads(ss), taa.pack_aa_reads(ss, device="cpu")


def test_alphabet_and_sequence_match_jax():
    raw = np.frombuffer(b"ACDQYXW*", dtype=np.uint8)
    assert np.array_equal(talpha.encode_aa(raw),
                          jaa.alphabet.encode_aa(raw))
    assert talpha.ENCODE_AA[ord("Q")] == 15
    assert str(taa.SequenceAA("AXQ", filtered=True)) == "AQ"
    with pytest.raises(ValueError):
        taa.SequenceAA("AXQ")
    with pytest.raises(ValueError):
        taa.pack_aa_reads(["ACDZ"], device="cpu")
    jb = jaa.pack_aa_reads([jaa.SequenceAA("ACDK"), "WYV"])
    tb = taa.pack_aa_reads([taa.SequenceAA("ACDK"), "WYV"], device="cpu")
    assert np.array_equal(tb.codes.numpy(), np.asarray(jb.codes))
    assert np.array_equal(tb.lengths.numpy(), np.asarray(jb.lengths))
    assert taa.kmer_value_from_str("ACDEFGHIKLMN") == \
        jaa.kmer_value_from_str("ACDEFGHIKLMN")


@pytest.mark.parametrize("k", [1, 5, 9, 12])
def test_kmers_and_hashed_items_match_jax(k):
    jb, tb = batches(proteins(k))
    km, valid = taa.kmers_aa(tb, k)
    jkm, jvalid = jaa.kmers_aa(jb, k)
    assert np.array_equal(km.numpy().view(np.uint64), np.asarray(jkm))
    assert np.array_equal(valid.numpy(), np.asarray(jvalid))
    for hash_name in ("wang", "identity"):
        items, v = taa.hashed_kmers_aa(tb, k, hash_name)
        jitems, _ = jaa.hashed_kmers_aa(jb, k, hash_name)
        jitems = np.asarray(jitems)
        got = items.numpy()
        assert got.dtype == (np.int32 if jitems.dtype == np.uint32
                             else np.int64)
        assert np.array_equal(got.view(jitems.dtype), jitems)
    first = proteins(k)[0][:k]
    assert taa.kmer_value_from_str(first) == int(km[0, 0])


def test_short_batch_has_no_kmers():
    km, valid = taa.kmers_aa(taa.pack_aa_reads(["ACD", "W"], device="cpu"),
                             5)
    assert km.shape == (2, 1) and not valid.any()
    with pytest.raises(ValueError):
        taa.kmers_aa(taa.pack_aa_reads(["ACD"], device="cpu"), 13)


def assert_family(algo: str, got: torch.Tensor, want, items, valid,
                  m: int, what: str, h_best=None):
    want = np.asarray(want)
    if algo == "HLL":
        assert_registers_match(got.numpy(), want.astype(np.int32), h_best,
                               tss.SetSketchParams(m=m), what)
        return
    g = got.numpy()
    g = g.view(want.dtype) if g.dtype in (np.int32, np.int64) else g
    if algo == "PROB3A":
        assert_sigs_match(g, want, items, valid)
    else:
        assert np.array_equal(g, want)


@pytest.mark.parametrize("k", [5, 9])
@pytest.mark.parametrize("algo", [a.value for a in SketchAlgo])
def test_sketcher_aa_matches_jax(algo, k):
    ss = proteins(100 + k)
    jb, tb = batches(ss)
    m = 64
    jsk = jaa.SketcherAA(params=JParams(kmer_size=k, sketch_size=m,
                                        algo=JAlgo(algo)), seed=3)
    tsk = taa.SketcherAA(params=SeqSketcherParams(
        kmer_size=k, sketch_size=m, algo=SketchAlgo(algo)), seed=3)
    items, valid = (np.asarray(a) for a in jaa.hashed_kmers_aa(jb, k))
    h_best = hll_h_best(items, valid, m, 3) if algo == "HLL" else None
    got = tsk.sketch_batch(tb)
    assert_family(algo, got, jsk.sketch_batch(jb), items, valid, m,
                  f"AA k={k}", h_best)
    assert torch.equal(got[3], got[4])
    coll = tsk.sketch_collection(tb)
    want = np.asarray(jsk.sketch_collection(jb))
    if algo == "PROB3A":
        # one row of all the batch's items, weighted by their counts
        flat = items[valid].astype(np.uint64)[None]
        assert_sigs_match(coll.numpy().view(np.uint64)[None], want[None],
                          flat, np.ones(flat.shape, bool))
    else:
        assert_family(algo, coll[None], want[None], items, valid, m,
                      f"AA collection k={k}",
                      None if h_best is None else h_best.max(axis=0)[None])
    est = tsk.jaccard(got[3], got[4])
    assert float(est) == pytest.approx(1.0)
