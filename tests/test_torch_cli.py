"""The port's datasketcher CLI against the JAX CLI, on the CPU, and the
port's independence from JAX.

Tolerance: byte-identical ``sigs.bin`` and ``sketchparams_dump.json`` for
k=8 (u32 items, kernel K1's path) and k=21 (u64 items, K2's path; the dump
keeps the low 32 bits as the JAX CLI does).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from kmerutils_tpu.cli import datasketcher as jcli
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


def run_both(tmp_path, fq: str, k: int):
    out = {}
    for name, main, extra in (("jax", jcli.main, []),
                              ("torch", tcli.main, ["--device", "cpu"])):
        d = tmp_path / f"{name}_k{k}"
        d.mkdir()
        rc = main(["-f", fq, "-s", "200", "-k", str(k), "-d",
                   str(d / "sigs.bin"), *extra])
        assert rc == 0
        out[name] = ((d / "sigs.bin").read_bytes(),
                     (d / "sketchparams_dump.json").read_bytes())
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


@pytest.mark.parametrize("argv,why", [
    (["-b", "500"], "block mode"),
    (["-a", "SUPER"], "SUPER"),
    (["ann", "-n", "5"], "ann"),
])
def test_unported_options_raise(tmp_path, argv, why):
    fq = str(tmp_path / "r.fastq")
    write_reads(fq, 33, 8)
    base = ["-f", fq, "-s", "16", "-k", "8", "-d", str(tmp_path / "s.bin"),
            "--device", "cpu"]
    with pytest.raises(NotImplementedError, match=why):
        tcli.main(base + argv)
    assert not os.path.exists(tmp_path / "s.bin")


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
