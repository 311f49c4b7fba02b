"""Parity of the port's packing and k-mer extraction with the JAX package.

Tolerance: bit-exact (words, k-mer values, canonical values, strands and
validity masks).  Reads are seeded random ACGT of ragged lengths, so rows
end inside a word and in the padding.
"""

import numpy as np
import pytest
import torch

from kmerutils_tpu.base import kmer as jkmer
from kmerutils_tpu.base import sequence as jseq
from kmerutils_tpu_torch.base import kmer as tkmer
from kmerutils_tpu_torch.base import sequence as tseq

KS = [1, 8, 16, 17, 21, 32]


def reads(seed: int, n: int = 9):
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, 300, size=n)
    lens[:3] = [16, 33, 64][:n]
    return ["".join(rng.choice(list("ACGT"), size=int(L))) for L in lens]


@pytest.fixture(scope="module")
def batches():
    rs = reads(11)
    return jseq.pack_ascii_reads(rs), tseq.pack_ascii_reads(rs, device="cpu")


def words_u32(batch: tseq.ReadBatch) -> np.ndarray:
    assert batch.words.dtype == torch.int32
    return batch.words.numpy().view(np.uint32)


def as_u(t: torch.Tensor, k: int) -> np.ndarray:
    """The port's k-mers (int64 carriers / patterns) as the JAX dtype."""
    v = t.numpy()
    return v.astype(np.uint32) if k <= 16 else v.view(np.uint64)


def test_pack_ascii_reads_matches_jax(batches):
    jb, tb = batches
    assert (words_u32(tb) == np.asarray(jb.words)).all()
    assert (tb.lengths.numpy() == np.asarray(jb.lengths)).all()
    # the +1 slack word: ceil(longest / 16) + 1 words per row
    longest = int(tb.lengths.max())
    assert tb.words.shape[1] == -(-longest // 16) + 1
    assert tb.max_len == jb.max_len and tb.n_reads == jb.n_reads


@pytest.mark.parametrize("width", [77, 64])
def test_pack_codes_matches_jax(width):
    # 77 ends inside a word, 64 on a word boundary; the slack word either way
    rng = np.random.default_rng(12)
    codes = rng.integers(0, 4, size=(5, width), dtype=np.uint8)
    lengths = np.array([width, 1, 16, 17, 0], np.int32)
    jb = jseq.pack_codes(codes, lengths)
    tb = tseq.pack_codes(codes, lengths, device="cpu")
    assert tb.words.shape == tuple(jb.words.shape)
    assert tb.words.shape[1] == -(-width // 16) + 1
    assert (words_u32(tb) == np.asarray(jb.words)).all()
    assert (tb.lengths.numpy() == np.asarray(jb.lengths)).all()


def test_pack_ascii_reads_rejects_non_acgt():
    with pytest.raises(ValueError):
        tseq.pack_ascii_reads(["ACGN"], device="cpu")


@pytest.mark.parametrize("k", KS)
def test_kmers_u64_match_jax(batches, k):
    jb, tb = batches
    jk, jv = jkmer.kmers_u64(jb, k)
    tk, tv = tkmer.kmers_u64(tb, k)
    assert (tv.numpy() == np.asarray(jv)).all()
    assert (tk.numpy().view(np.uint64) == np.asarray(jk)).all()


@pytest.mark.parametrize("k", [k for k in KS if k <= 16])
def test_kmers_u32_match_jax(batches, k):
    jb, tb = batches
    jk, jv = jkmer.kmers_u32(jb, k)
    tk, tv = tkmer.kmers_u32(tb, k)
    assert (tv.numpy() == np.asarray(jv)).all()
    assert (tk.numpy().astype(np.uint32) == np.asarray(jk)).all()


@pytest.mark.parametrize("k", KS)
def test_canonical_kmers_match_jax(batches, k):
    jb, tb = batches
    jc, jv, js = jkmer.canonical_kmers(jb, k)
    tc, tv, ts = tkmer.canonical_kmers(tb, k)
    assert (tv.numpy() == np.asarray(jv)).all()
    assert (as_u(tc, k) == np.asarray(jc)).all()
    assert (ts.numpy() == np.asarray(js)).all()


@pytest.mark.parametrize("k", [8, 16, 21, 32])
def test_canonical_of_high_values_matches_jax(k):
    # raw values >= 2^31 / 2^63 straight into canonical_u32/u64
    rng = np.random.default_rng(13)
    top = (1 << 2 * k) - 1
    x = rng.integers(0, top, size=2048, dtype=np.uint64, endpoint=True)
    x[:2] = [top, top >> 1]
    if k <= 16:
        jc, js = jkmer.canonical_u32(x.astype(np.uint32), k)
        tc, ts = tkmer.canonical_u32(torch.from_numpy(x.astype(np.int64)), k)
    else:
        jc, js = jkmer.canonical_u64(x, k)
        tc, ts = tkmer.canonical_u64(torch.from_numpy(x.view(np.int64)), k)
    assert (as_u(tc, k) == np.asarray(jc)).all()
    assert (ts.numpy() == np.asarray(js)).all()


def test_kmer_values_match_read_text():
    rng = np.random.default_rng(14)
    r = "".join(rng.choice(list("ACGT"), size=150))
    tb = tseq.pack_ascii_reads([r], device="cpu")
    km, valid = tkmer.kmers_u64(tb, 21)
    for p in (0, 5, len(r) - 21):
        assert int(km[0, p]) == jkmer.kmer_value_from_str(r[p : p + 21])
    assert int(valid[0].sum()) == len(r) - 20
