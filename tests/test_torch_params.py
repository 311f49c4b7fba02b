"""Parity of the port's optional parameters with the JAX package's, on the
CPU: ``iter_clean_reads(with_quality=True)``, ``read_batches(bucket=False)``,
``read_batches_overlapped(queue_depth=)``, ``block_sketch(hash_name=)``,
``write_signature_dump(sig_size=)`` and the ignored ``heavy_cap`` of the
ProbMinHash entry points.  (``finalize(phases=)`` is held in
test_torch_count.py, beside the JAX stream it needs.)

Tolerance: exact — the same codes, qualities and ingest counters; the same
batches, words, lengths and read indices once JAX's all-zero padding rows
are removed; the same signature words and liveness flags; byte-identical
dumps.
"""

import functools
import time

import numpy as np
import pytest
import torch

from kmerutils_tpu.base.sequence import pack_ascii_reads as j_pack
from kmerutils_tpu.io import fastx as jfastx
from kmerutils_tpu.io import formats as jformats
from kmerutils_tpu.sketch import block as j_block
from kmerutils_tpu.sketch import probminhash as jpmh
from kmerutils_tpu_torch.base.sequence import pack_ascii_reads
from kmerutils_tpu_torch.io import fastx as tfastx
from kmerutils_tpu_torch.io import formats as tformats
from kmerutils_tpu_torch.io import native as tnative
from kmerutils_tpu_torch.sketch import block as t_block
from kmerutils_tpu_torch.sketch import probminhash as tpmh

t_pack = functools.partial(pack_ascii_reads, device="cpu")


def random_reads(seed: int, n: int, lo: int, hi: int, n_bad: int = 3,
                 log_lengths: bool = False):
    """n reads of lo..hi bases (uniform, or log-uniform) with an N in
    ``n_bad`` of them."""
    rng = np.random.default_rng(seed)
    lens = (np.exp(rng.uniform(np.log(lo), np.log(hi), size=n))
            if log_lengths else rng.integers(lo, hi, size=n))
    rs = ["".join(rng.choice(list("ACGT"), size=int(L))) for L in lens]
    for i in rng.choice(n, size=n_bad, replace=False):
        rs[i] = rs[i][:1] + "N" + rs[i][2:]
    return rs


@pytest.fixture(scope="module")
def rung_fastq(tmp_path_factory):
    """320 reads of 10-3,300 bases, log-uniform, so that file-order groups
    reach every width rung from 256 to 4096; four of them with an N."""
    p = str(tmp_path_factory.mktemp("params") / "rungs.fastq")
    tfastx.write_fastq(p, random_reads(41, 320, 10, 3300, n_bad=4,
                                       log_lengths=True))
    return p


def quality_strings(rng, reads):
    return ["".join(chr(33 + int(q)) for q in rng.integers(0, 41, len(r)))
            for r in reads]


@pytest.mark.parametrize("fmt", ["fastq", "fasta"])
def test_iter_clean_reads_with_quality_matches_jax(tmp_path, fmt):
    rng = np.random.default_rng(42)
    reads = random_reads(43, 40, 0, 120, n_bad=5)
    p = str(tmp_path / f"reads.{fmt}")
    if fmt == "fastq":
        tfastx.write_fastq(p, reads, quality_strings(rng, reads))
    else:
        tfastx.write_fasta(p, reads)
    jst, tst = jfastx.IngestStats(), tfastx.IngestStats()
    want = list(jfastx.iter_clean_reads(p, jst, with_quality=True))
    got = list(tfastx.iter_clean_reads(p, tst, with_quality=True))
    assert len(got) == len(want) == 35
    for (gc, gq), (wc, wq) in zip(got, want):
        assert gc.dtype == np.uint8 and np.array_equal(gc, wc)
        if wq is None:   # FASTA, or a zero-length FASTQ read
            assert gq is None
        else:
            assert gq.dtype == np.uint8 and np.array_equal(gq, wq)
    assert (fmt == "fasta") == all(q is None for _, q in got)
    assert vars(tst) == vars(jst)
    assert (tst.n_reads, tst.nb_bad_read) == (35, 5)
    # without the flag: the codes alone, through the native parser as in
    # JAX (which keeps no zero-length FASTA record)
    jst, tst = jfastx.IngestStats(), tfastx.IngestStats()
    plain = list(tfastx.iter_clean_reads(p, tst))
    jplain = list(jfastx.iter_clean_reads(p, jst))
    assert len(plain) == len(jplain) and vars(tst) == vars(jst)
    assert all(np.array_equal(a, c) for a, c in zip(plain, jplain))


def assert_batches_match(tb, jb):
    """The port's batches against JAX's with its padding rows removed."""
    assert len(tb) == len(jb)
    for (tbatch, tidx), (jbatch, jidx) in zip(tb, jb):
        n = len(jidx)
        jwords, jlens = np.asarray(jbatch.words), np.asarray(jbatch.lengths)
        assert tbatch.n_reads == len(tidx) == n
        assert (tbatch.words.numpy().view(np.uint32) == jwords[:n]).all()
        assert (tbatch.lengths.numpy() == jlens[:n]).all()
        assert (jwords[n:] == 0).all() and (jlens[n:] == 0).all()
        assert tidx.dtype == np.int64 and (tidx == jidx).all()


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("batch_reads", [16, 5])
def test_read_batches_file_order_matches_jax(rung_fastq, monkeypatch, native,
                                             batch_reads):
    jst, tst = jfastx.IngestStats(), tfastx.IngestStats()
    jb = list(jfastx.read_batches(rung_fastq, batch_reads=batch_reads,
                                  stats=jst, bucket=False, packed=native,
                                  to_host=True))
    if not native:
        monkeypatch.setattr(tnative, "available", lambda: False)
    tb = list(tfastx.read_batches(rung_fastq, batch_reads=batch_reads,
                                  stats=tst, bucket=False))
    assert len(tb) > 316 // batch_reads
    assert_batches_match(tb, jb)
    assert vars(tst) == vars(jst)
    # rows and batches in file order, every clean read once
    idx = np.concatenate([i for _, i in tb])
    assert (idx == np.arange(316)).all()
    # groups span width rungs, unlike the length-sorted batches
    widths = {b.words.shape[1] for b, _ in tb}
    assert len(widths) > 2
    assert max(int(b.lengths.max()) - int(b.lengths.min())
               for b, _ in tb) > 1000
    sorted_b = list(tfastx.read_batches(rung_fastq, batch_reads=batch_reads))
    assert [i.tolist() for _, i in sorted_b] != [i.tolist() for _, i in tb]


@pytest.mark.parametrize("depth", [1, 3])
@pytest.mark.parametrize("bucket", [True, False])
def test_overlapped_queue_depth_gives_the_same_batches(rung_fastq, depth,
                                                       bucket):
    plain = list(tfastx.read_batches(rung_fastq, batch_reads=16,
                                     bucket=bucket))
    st = tfastx.IngestStats()
    over = list(tfastx.read_batches_overlapped(
        rung_fastq, device="cpu", queue_depth=depth, batch_reads=16,
        stats=st, bucket=bucket))
    assert len(over) == len(plain) > 1
    for (a, ia), (b, ib) in zip(plain, over):
        assert torch.equal(a.words, b.words)
        assert torch.equal(a.lengths, b.lengths) and (ia == ib).all()
    assert st.n_reads == 316


def test_overlapped_queue_depth_bounds_the_producer(rung_fastq, monkeypatch):
    """With queue_depth=1 the producer is at most two batches ahead of the
    consumer: one waiting in the queue, one blocked on its put."""
    produced = []
    real = tfastx.read_batches

    def counting(*a, **kw):
        for item in real(*a, **kw):
            produced.append(item)
            yield item

    monkeypatch.setattr(tfastx, "read_batches", counting)
    it = tfastx.read_batches_overlapped(rung_fastq, device="cpu",
                                        queue_depth=1, batch_reads=8)
    next(it)
    time.sleep(0.5)
    assert len(produced) <= 3
    rest = list(it)
    assert len(produced) == len(rest) + 1 > 3


@pytest.mark.parametrize("k", [8, 21])
def test_block_sketch_identity_hash_matches_jax(k):
    rng = np.random.default_rng(44 + k)
    reads = ["".join(rng.choice(list("ACGT"), size=int(L)))
             for L in rng.integers(30, 300, size=10)]
    reads[3] = reads[7]
    reads[5] = reads[5][:14]        # no k-mer at k = 21: no live block
    m, bs = 24, 48
    want = j_block.block_sketch(j_pack(reads), k, m, bs, "identity")
    got = t_block.block_sketch(t_pack(reads), k, m, bs, "identity")
    wang = t_block.block_sketch(t_pack(reads), k, m, bs)
    assert got.sigs.dtype == want.sigs.dtype == (np.uint32 if k <= 16
                                                 else np.uint64)
    assert got.sigs.shape == want.sigs.shape
    assert np.array_equal(got.live, want.live)
    live = got.live
    assert np.array_equal(got.sigs[live], want.sigs[live])
    assert not np.array_equal(got.sigs[live], wang.sigs[live])
    # identity items are canonical k-mer values: below 4^k
    assert (got.sigs[live] < 4 ** k).all()
    with pytest.raises(ValueError):
        t_block.block_sketch(t_pack(reads), k, m, bs, "fnv")


@pytest.mark.parametrize("dtype,sig_size", [(np.uint32, None),
                                            (np.uint32, 8),
                                            (np.uint64, 8),
                                            (np.uint64, 4)])
def test_signature_dump_word_size_matches_jax(tmp_path, dtype, sig_size):
    rng = np.random.default_rng(45)
    sigs = rng.integers(0, np.iinfo(dtype).max, size=(9, 13), dtype=dtype,
                        endpoint=True)
    a, b = str(tmp_path / "j.bin"), str(tmp_path / "t.bin")
    jformats.write_signature_dump(a, 17, sigs, sig_size=sig_size)
    tformats.write_signature_dump(b, 17, sigs, sig_size=sig_size)
    assert open(a, "rb").read() == open(b, "rb").read()
    k, m, back = tformats.read_signature_dump(b)
    width = sig_size or np.dtype(dtype).itemsize
    assert (k, m) == (17, 13) and back.dtype.itemsize == width
    assert (back == sigs.astype(back.dtype)).all()


@pytest.mark.parametrize("wide", [False, True])
def test_heavy_cap_is_accepted_and_ignored(wide):
    rng = np.random.default_rng(46)
    dt = np.uint64 if wide else np.uint32
    items = rng.integers(0, 1 << 30, size=(4, 60)).astype(dt)
    items[:, 30:] = items[:, :30]                     # multiplicities 2
    valid = rng.random((4, 60)) < 0.9
    ti = torch.from_numpy(items.view(np.int64 if wide else np.int32))
    tv = torch.from_numpy(valid)
    base = tpmh.probminhash_from_items(ti, tv, 32, seed=3)
    capped = tpmh.probminhash_from_items(ti, tv, 32, 7, 3)     # positional
    assert torch.equal(base[0], capped[0]) and torch.equal(base[1],
                                                           capped[1])
    want, _, _ = jpmh.probminhash_from_items(items, valid, 32, heavy_cap=7,
                                             seed=3)
    assert np.array_equal(capped[0].numpy().view(dt), np.asarray(want))
    w = np.where(valid, 2, 0).astype(np.int32)
    tw = torch.from_numpy(w)
    s0 = tpmh.probminhash_signatures(ti, tw, 32, seed=5)
    s1 = tpmh.probminhash_signatures(ti, tw, 32, heavy_cap=1, seed=5)
    assert torch.equal(s0[0], s1[0])
    want, _, _ = jpmh.probminhash_signatures(items, w, 32, 1, 5)
    assert np.array_equal(s1[0].numpy().view(dt), np.asarray(want))
