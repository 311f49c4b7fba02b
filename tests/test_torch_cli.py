"""The port's datasketcher CLI against the JAX CLI, on the CPU, and the
port's independence from JAX.

Tolerance: byte-identical ``sigs.bin`` and ``sketchparams_dump.json`` for
k=8 (u32 items, kernel K1's path) and k=21 (u64 items, K2's path; the dump
keeps the low 32 bits as the JAX CLI does); byte-identical block dumps
(``-b``) and exact-search neighbour tables (``ann --engine brute``).  The
native HNSW index inserts with several threads and builds another graph
on every run, so its tables are held to the JAX CLI tests' invariants.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from kmerutils_tpu.cli import datasketcher as jcli
from kmerutils_tpu_torch import ann as tann
from kmerutils_tpu_torch import hnsw as thnsw
from kmerutils_tpu_torch.cli import datasketcher as tcli
from kmerutils_tpu_torch.io import formats as tformats

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def write_reads(path: str, seed: int, n: int, crlf: bool = False):
    """n reads of 200-350 bases (two width rungs, so several batches), four
    of them with an N, one exact duplicate."""
    rng = np.random.default_rng(seed)
    rs = ["".join(rng.choice(list("ACGT"), size=int(L)))
          for L in rng.integers(200, 350, size=n)]
    for i in (1, n // 3, n // 2, n - 2):
        rs[i] = rs[i][:50] + "N" + rs[i][51:]
    rs[5] = rs[4]
    nl = "\r\n" if crlf else "\n"
    with open(path, "w", newline="") as f:
        for i, r in enumerate(rs):
            f.write(f"@read{i}{nl}{r}{nl}+{nl}{'I' * len(r)}{nl}")
    return rs


def run_both(tmp_path, fq: str, k: int, tail=(), m: int = 200,
             files=("sigs.bin", "sketchparams_dump.json")):
    """Both CLIs on ``fq`` with ``tail`` after the common flags; returns
    {package: tuple of the bytes of ``files``}."""
    out = {}
    for name, main, extra in (("jax", jcli.main, []),
                              ("torch", tcli.main, ["--device", "cpu"])):
        d = tmp_path / f"{name}_k{k}"
        d.mkdir()
        rc = main(["-f", fq, "-s", str(m), "-k", str(k), "-d",
                   str(d / "sigs.bin"), *extra, *tail])
        assert rc == 0
        out[name] = tuple((d / f).read_bytes() for f in files)
    return out


@pytest.mark.parametrize("k", [8, 21])
def test_dump_bytes_match_jax_cli(tmp_path, k):
    fq = str(tmp_path / "reads.fastq")
    rs = write_reads(fq, 31, 240)
    out = run_both(tmp_path, fq, k)
    assert out["torch"][1] == out["jax"][1]
    assert out["torch"][0] == out["jax"][0]
    kk, m, sigs = tformats.read_signature_dump(str(tmp_path / f"torch_k{k}"
                                                   / "sigs.bin"))
    assert (kk, m) == (k, 200) and sigs.dtype == np.uint32
    assert sigs.shape[0] == len(rs) - 4                # N reads dropped
    assert (sigs[3] == sigs[4]).all()     # reads 4 and 5 after dropped read 1


def test_crlf_file_matches_jax_cli(tmp_path):
    fq = str(tmp_path / "crlf.fastq")
    write_reads(fq, 32, 60, crlf=True)
    out = run_both(tmp_path, fq, 8)
    assert out["torch"] == out["jax"]


def write_reads_and_a_short_one(path: str, seed: int, n: int):
    """:func:`write_reads`, then a 5-base read (no 8-mer: an empty
    signature, +inf for SUPER / OPTDENS / REVOPTDENS)."""
    write_reads(path, seed, n)
    with open(path, "a") as f:
        f.write("@short\nACGTA\n+\nIIIII\n")


@pytest.mark.parametrize("algo", ["SUPER", "SUPER2", "OPTDENS", "REVOPTDENS",
                                  "HLL"])
def test_algo_dump_bytes_match_jax_cli(tmp_path, algo):
    # the JAX CLI's casts, quirks included: SUPER2 as u32, the others
    # through numpy's cast to u64 (SUPER keeps its integer part, the
    # densified families' [0, 1) values and +inf go as numpy casts them)
    fq = str(tmp_path / "reads.fastq")
    write_reads_and_a_short_one(fq, 33, 60)
    out = run_both(tmp_path, fq, 8, ["-a", algo], m=16)
    assert out["torch"] == out["jax"]
    kk, m, sigs = tformats.read_signature_dump(str(tmp_path / "torch_k8"
                                                   / "sigs.bin"))
    assert (kk, m, sigs.shape[0]) == (8, 16, 57)
    assert sigs.dtype == (np.uint32 if algo == "SUPER2" else np.uint64)


def test_block_mode_ignores_algo_like_jax_cli(tmp_path):
    fq = str(tmp_path / "reads.fastq")
    write_reads(fq, 35, 40)
    out = run_both(tmp_path, fq, 8, ["-a", "SUPER", "-b", "64"], m=16)
    assert out["torch"] == out["jax"]


@pytest.mark.parametrize("algo", ["SUPER2", "HLL"])
def test_algo_ann_brute_bytes_match_jax_cli(tmp_path, algo):
    fq = str(tmp_path / "reads.fastq")
    write_reads_and_a_short_one(fq, 39, 50)
    out = run_both(tmp_path, fq, 8, ["-a", algo, "ann", "-n", "4",
                                     "--engine", "brute"], m=16,
                   files=("sigs.bin", "sigs.bin-ann"))
    assert out["torch"] == out["jax"]


@pytest.mark.parametrize("k", [8, 21])
def test_block_dump_bytes_match_jax_cli(tmp_path, k):
    # the JAX CLI batches blocks in file order, the port by length
    fq = str(tmp_path / "reads.fastq")
    rs = write_reads(fq, 34 + k, 90)
    out = run_both(tmp_path, fq, k, ["-b", "64"], m=48)
    assert out["torch"] == out["jax"]
    kk, m, bs, per_seq = tformats.read_block_signature_dump(
        str(tmp_path / f"torch_k{k}" / "sigs.bin"))
    assert (kk, m, bs) == (k, 48, 64) and len(per_seq) == len(rs) - 4
    assert [len(b) for _, b in per_seq] == [
        -(-(len(r) - k + 1) // 64) for r in rs if "N" not in r]


@pytest.mark.parametrize("k", [8, 21])
def test_ann_brute_bytes_match_jax_cli(tmp_path, k):
    fq = str(tmp_path / "reads.fastq")
    write_reads(fq, 36 + k, 120)
    out = run_both(tmp_path, fq, k, ["ann", "-n", "6", "--engine", "brute"],
                   m=24, files=("sigs.bin", "sigs.bin-ann"))
    assert out["torch"] == out["jax"]
    nn, sim = tann.read_neighbor_dump(str(tmp_path / f"torch_k{k}"
                                          / "sigs.bin-ann"))
    assert nn.shape == (116, 6) and (nn[3, 0], sim[3, 0]) == (4, 1.0)


def test_block_ann_brute_bytes_match_jax_cli(tmp_path, monkeypatch):
    # the JAX CLI takes the native index for block ann whenever it loads;
    # without it both take the exact search
    from kmerutils_tpu import hnsw as jhnsw
    monkeypatch.setattr(jhnsw, "available", lambda: False)
    fq = str(tmp_path / "reads.fastq")
    write_reads(fq, 38, 60)
    out = run_both(tmp_path, fq, 8, ["-b", "64", "ann", "-n", "3",
                                     "--engine", "brute"], m=16,
                   files=("sigs.bin", "sigs.bin-ann", "sigs.bin-ann.blocks"))
    assert out["torch"] == out["jax"]


def ann_invariants(path: str, n_rows: int, nbng: int, read_of=None):
    """The JAX CLI tests' invariants of a neighbour table: its shape, no
    self hit, no -1 padding written as a neighbour, and no hit from the
    query's own read (block mode)."""
    nn, sim = tann.read_neighbor_dump(path)
    assert nn.shape == (n_rows, nbng)
    live = sim >= 0
    assert live.any() and (nn[live] < n_rows).all()
    q = np.broadcast_to(np.arange(n_rows)[:, None], nn.shape)
    assert not (nn[live] == q[live]).any()
    if read_of is not None:
        assert not (read_of[nn[live]] == read_of[q[live]]).any()
    return nn, sim


@pytest.mark.parametrize("engine", ["hnsw", "brute"])
def test_ann_invariants(tmp_path, engine):
    fq = str(tmp_path / "reads.fastq")
    write_reads(fq, 40, 80)
    out = str(tmp_path / "s.bin")
    assert tcli.main(["-f", fq, "-s", "64", "-k", "11", "-d", out,
                      "--device", "cpu", "ann", "-n", "3", "--engine",
                      engine]) == 0
    nn, sim = ann_invariants(out + "-ann", 76, 3)
    assert (sim > -1).all()              # 75 other reads: every slot filled
    assert nn[3, 0] == 4 and nn[4, 0] == 3    # the duplicate reads
    assert os.path.exists(out + "-ann.hnsw") == (
        engine == "hnsw" and thnsw.available())


@pytest.mark.parametrize("engine", ["hnsw", "brute"])
def test_block_ann_invariants(tmp_path, engine):
    fq = str(tmp_path / "reads.fastq")
    write_reads(fq, 41, 40)
    out = str(tmp_path / "b.bin")
    assert tcli.main(["-f", fq, "-s", "64", "-k", "11", "-d", out, "-b",
                      "64", "--device", "cpu", "ann", "-n", "2", "--engine",
                      engine]) == 0
    who = np.fromfile(out + "-ann.blocks", dtype=np.uint32).reshape(-1, 2)
    per_seq = tformats.read_block_signature_dump(out)[3]
    assert who.tolist() == [[s, j] for s, b in per_seq
                            for j in range(len(b))]
    ann_invariants(out + "-ann", who.shape[0], 2, who[:, 0])


def test_port_imports_without_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import kmerutils_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'kmerutils_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "assert len(mods) >= 18, mods\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "assert not any(m.startswith('kmerutils_tpu.') for m in sys.modules)\n"
        "print(len(mods))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 18
