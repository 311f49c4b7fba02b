"""Parity of the port's host ingest and formats (kmerutils_tpu_torch.io,
sketch.params) with the JAX package.

Tolerance: exact — the same reads in the same batch rows with the same
words, lengths and read indices, the same ingest counters, and files that
are byte-identical.  The JAX batches also carry all-zero padding rows up to
a power-of-two row count; the port's have only the real rows.
"""

import json

import numpy as np
import pytest
import torch

from kmerutils_tpu.io import fastx as jfastx
from kmerutils_tpu.io import formats as jformats
from kmerutils_tpu.sketch.params import SeqSketcherParams as JParams
from kmerutils_tpu_torch.io import fastx as tfastx
from kmerutils_tpu_torch.io import formats as tformats
from kmerutils_tpu_torch.io import native as tnative
from kmerutils_tpu_torch.sketch.params import (PARAMS_DUMP_FILENAME,
                                               SeqSketcherParams, SketchAlgo)


@pytest.fixture(scope="module")
def fastq(tmp_path_factory):
    rng = np.random.default_rng(21)
    lens = rng.integers(20, 900, size=150)
    rs = ["".join(rng.choice(list("ACGT"), size=int(L))) for L in lens]
    for i in (4, 77):
        rs[i] = rs[i][:7] + "N" + rs[i][8:]
    p = str(tmp_path_factory.mktemp("io") / "reads.fastq")
    tfastx.write_fastq(p, rs)
    return p, rs


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("batch_reads", [64, 16])
def test_read_batches_match_jax(fastq, monkeypatch, native, batch_reads):
    p, _ = fastq
    jst, tst = jfastx.IngestStats(), tfastx.IngestStats()
    jb = list(jfastx.read_batches(p, batch_reads=batch_reads, stats=jst,
                                  packed=native, to_host=True))
    if not native:   # the Python parser and packer, as without the library
        monkeypatch.setattr(tnative, "available", lambda: False)
    tb = list(tfastx.read_batches(p, batch_reads=batch_reads, stats=tst))
    assert len(tb) == len(jb) > 1
    for (jbatch, jidx), (tbatch, tidx) in zip(jb, tb):
        n = len(jidx)
        assert tbatch.words.dtype == torch.int32
        assert tbatch.n_reads == len(tidx) == n
        jwords, jlens = np.asarray(jbatch.words), np.asarray(jbatch.lengths)
        assert (tbatch.words.numpy().view(np.uint32) == jwords[:n]).all()
        assert (tbatch.lengths.numpy() == jlens[:n]).all()
        assert (jwords[n:] == 0).all() and (jlens[n:] == 0).all()
        assert (tidx == jidx).all()
    assert vars(tst) == vars(jst)
    assert (tst.n_reads, tst.nb_bad_read) == (148, 2)


def test_overlapped_batches_equal_plain_batches(fastq):
    p, _ = fastq
    plain = list(tfastx.read_batches(p, batch_reads=64))
    st = tfastx.IngestStats()
    over = list(tfastx.read_batches_overlapped(p, device="cpu",
                                               batch_reads=64, stats=st))
    assert len(over) == len(plain)
    for (a, ia), (b, ib) in zip(plain, over):
        assert torch.equal(a.words, b.words) and (ia == ib).all()
        assert b.device == torch.device("cpu")
    assert st.n_reads == 148


def test_overlapped_surfaces_parse_errors(tmp_path):
    p = tmp_path / "bad.txt"
    p.write_bytes(b"not a fastx file\n")
    # the native parser raises RuntimeError, the Python one ValueError
    with pytest.raises((RuntimeError, ValueError)):
        list(tfastx.read_batches_overlapped(str(p), device="cpu"))


def test_crlf_records_parse_alike(tmp_path, monkeypatch):
    p = str(tmp_path / "crlf.fastq")
    with open(p, "wb") as f:
        f.write(b"@r0\r\nACGTACGT\r\n+\r\nIIIIIIII\r\n"
                b"@r1\r\nTTNTCCCC\r\n+\r\nIIIIIIII\r\n"
                b"@r2\r\nTTTTCCCC\r\n+\r\nIIIIIIII\r\n")
    want = [[0, 1, 2, 3, 0, 1, 2, 3], [3, 3, 3, 3, 1, 1, 1, 1]]
    assert [r[1] for r in tfastx.iter_fastx(p)] == [
        b"ACGTACGT", b"TTNTCCCC", b"TTTTCCCC"]
    assert [c.tolist() for c in jfastx.iter_clean_reads(p)] == want
    st = tfastx.IngestStats()
    assert [c.tolist() for c in tfastx.iter_clean_reads(p, st)] == want
    monkeypatch.setattr(tnative, "available", lambda: False)
    st_py = tfastx.IngestStats()
    assert [c.tolist() for c in tfastx.iter_clean_reads(p, st_py)] == want
    assert st == st_py == tfastx.IngestStats(2, 24, 1, 1)


def test_wrapped_fastq_records(tmp_path):
    p = str(tmp_path / "wrapped.fastq")
    with open(p, "w") as f:
        f.write("@r0\nACGTAC\nGT\n+\n@III\nIIII\n@r1\nTTTT\n+\nIIII\n")
    recs = list(tfastx.iter_fastx(p))
    assert recs == list(jfastx.iter_fastx(p))
    assert [r[1] for r in recs] == [b"ACGTACGT", b"TTTT"]


def test_write_fasta_round_trip(tmp_path):
    p = str(tmp_path / "x.fa")
    tfastx.write_fasta(p, ["ACGT", b"GGCC"])
    assert [r[1] for r in tfastx.iter_fastx(p)] == [b"ACGT", b"GGCC"]
    assert open(p).read() == ">read0\nACGT\n>read1\nGGCC\n"


@pytest.mark.parametrize("dtype", [np.uint32, np.uint64])
def test_signature_dump_bytes_and_cross_reading(tmp_path, dtype):
    rng = np.random.default_rng(22)
    sigs = rng.integers(0, np.iinfo(dtype).max, size=(7, 24), dtype=dtype,
                        endpoint=True)
    a, b = str(tmp_path / "j.bin"), str(tmp_path / "t.bin")
    jformats.write_signature_dump(a, 21, sigs)
    tformats.write_signature_dump(b, 21, sigs)
    assert open(a, "rb").read() == open(b, "rb").read()
    k, m, back = tformats.read_signature_dump(a)       # a JAX-written dump
    assert (k, m) == (21, 24) and back.dtype == dtype and (back == sigs).all()
    with open(a, "r+b") as f:
        f.write(b"\0\0\0\0")
    with pytest.raises(ValueError):
        tformats.read_signature_dump(a)


def test_params_json_identical_and_reloads(tmp_path):
    ja, tb = tmp_path / "j", tmp_path / "t"
    ja.mkdir(), tb.mkdir()
    JParams(kmer_size=21, sketch_size=200).dump_json(
        str(ja / PARAMS_DUMP_FILENAME))
    SeqSketcherParams(kmer_size=21, sketch_size=200).dump_json(
        str(tb / PARAMS_DUMP_FILENAME))
    assert (ja / PARAMS_DUMP_FILENAME).read_bytes() \
        == (tb / PARAMS_DUMP_FILENAME).read_bytes()
    back = SeqSketcherParams.reload_json(str(ja))
    assert back == SeqSketcherParams(21, 200, SketchAlgo.PROB3A)
    assert json.loads((tb / PARAMS_DUMP_FILENAME).read_text())["algo"] \
        == "PROB3A"
