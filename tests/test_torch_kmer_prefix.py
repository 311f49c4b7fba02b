"""The k-mer prefix of the sketches (ops/kmer_prefix.py, kernel KP on the
card): its plain version against the JAX package's ``hashed_kmers``, its
argument checks, and the kernel's launch geometry.

Tolerance: bit-exact (items and validity masks at every position, the
invalid ones included).  Reads are seeded random ACGT of ragged lengths:
rows of length 0, rows shorter than k, rows ending inside a word and a row
of the batch's full width.
"""

import numpy as np
import pytest
import torch

from kmerutils_tpu.base import sequence as jseq
from kmerutils_tpu.sketch import jaccard as jjaccard
from kmerutils_tpu_torch.base import sequence as tseq
from kmerutils_tpu_torch.ops import kmer_prefix as KP
from kmerutils_tpu_torch.sketch.jaccard import hashed_kmers

KS = [1, 8, 15, 16, 17, 21, 31, 32]
HASHES = ["wang", "identity"]


def ragged_codes(seed: int, n: int, width: int):
    """codes uint8[n, width] and ragged lengths: 0, below 8, 15, 31, the
    full width, the rest random."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(n, width), dtype=np.uint8)
    lens = rng.integers(0, width + 1, size=n).astype(np.int32)
    lens[:5] = [0, 5, 15, width, 31]
    return codes, lens


@pytest.fixture(scope="module", params=[(11, 12, 160), (12, 6, 16)],
            ids=["ragged", "one_word"])
def batches(request):
    """(JAX batch, port batch) of the same reads; "one_word" rows hold at
    most 16 bases, so k > 16 leaves one position a row."""
    seed, n, width = request.param
    codes, lens = ragged_codes(seed, n, width)
    if width < 31:
        lens = np.minimum(lens, width)
    return jseq.pack_codes(codes, lens), tseq.pack_codes(codes, lens,
                                                         device="cpu")


@pytest.mark.parametrize("hash_name", HASHES)
@pytest.mark.parametrize("k", KS)
def test_kmer_prefix_matches_jax(batches, k, hash_name):
    jb, tb = batches
    items, valid = KP.kmer_prefix(tb.words, tb.lengths, k, hash_name)
    P = max(tb.max_len - k + 1, 1)
    assert items.shape == valid.shape == (tb.n_reads, P)
    assert items.dtype == (torch.int32 if k <= 16 else torch.int64)
    assert valid.dtype == torch.bool
    ji, jv = jjaccard.hashed_kmers(jb, k, hash_name)
    view = np.uint32 if k <= 16 else np.uint64
    assert (items.numpy().view(view) == np.asarray(ji)).all()
    assert (valid.numpy() == np.asarray(jv)).all()
    # rows of length 0 and below k have no valid position; the full-width
    # row is valid everywhere when P is the natural width
    lens = tb.lengths.numpy()
    assert not valid[torch.from_numpy(lens < k)].any()
    full = lens == tb.max_len
    if full.any() and tb.max_len >= k:
        assert valid[torch.from_numpy(full)].all()


def small_batch():
    return tseq.pack_codes(*ragged_codes(3, 6, 40), device="cpu")


@pytest.mark.parametrize("case", ["words_int64", "lengths_int64",
                                  "words_not_contiguous", "devices_differ",
                                  "k_0", "k_33", "one_column", "hash"])
def test_kmer_prefix_rejects_what_the_kernel_does_not_take(case):
    b = small_batch()
    words, lengths, k, h = b.words, b.lengths, 8, "wang"
    if case == "words_int64":
        words = words.to(torch.int64)
    elif case == "lengths_int64":
        lengths = lengths.to(torch.int64)
    elif case == "words_not_contiguous":
        words = torch.cat([words, words], dim=1)[:, ::2]
        assert not words.is_contiguous()
    elif case == "devices_differ":
        lengths = lengths.to("meta")
    elif case == "one_column":
        words = words[:, :1].contiguous()
    elif case == "hash":
        h = "murmur"
    else:
        k = int(case[2:])
    for fn in (KP.kmer_prefix, KP.kmer_prefix_ref):
        with pytest.raises(ValueError):
            fn(words, lengths, k, h)


def test_kmer_prefix_on_the_cpu_launches_nothing():
    b = small_batch()
    before = KP.launches_prefix
    for k in (8, 21):
        KP.kmer_prefix(b.words, b.lengths, k)
        hashed_kmers(b, k, "identity")
    assert KP.launches_prefix == before


def kernel_visits(n: int, P: int, blocks: int) -> np.ndarray:
    """visits[n, P] of the kernel's walk, in numpy: ceil(n * P / 4) groups
    of 4 flat positions; thread t of block b takes groups b * threads + t
    + i * blocks * threads; a group's first position comes from one
    division, and each next one steps to the next row where the position
    reaches P."""
    visits = np.zeros((n, P), np.int64)
    total = n * P
    groups = -(-total // KP._VEC)
    stride = blocks * KP._THREADS
    for tid in range(stride):
        for g in range(tid, groups, stride):
            f0 = g * KP._VEC
            row, pos = f0 // P, f0 % P
            for e in range(min(KP._VEC, total - f0)):
                assert divmod(f0 + e, P) == (row, pos)
                visits[row, pos] += 1
                pos += 1
                if pos == P:
                    row, pos = row + 1, 0
    return visits


@pytest.mark.parametrize("n,P,max_blocks", [
    (7, 1, KP._MAX_BLOCKS), (5, 3, KP._MAX_BLOCKS), (9, 5, 1),
    (3, 6001, KP._MAX_BLOCKS), (4, 505, 2), (1, 1027, 1), (0, 9, 1)])
def test_kmer_prefix_grid_visits_every_position_once(n, P, max_blocks):
    """Every flat position of [n, P] is written by exactly one thread, with
    groups that cross one row boundary (P = 5, 505, 6001), several (P = 1,
    3), the last group short (n * P not a multiple of 4) and a grid-stride
    loop over fewer blocks than groups."""
    blocks = KP.blocks(n, P, max_blocks)
    assert 1 <= blocks <= max_blocks
    if max_blocks == KP._MAX_BLOCKS:      # one group a thread
        assert blocks * KP._THREADS * KP._VEC >= n * P
    assert (kernel_visits(n, P, blocks) == 1).all()
