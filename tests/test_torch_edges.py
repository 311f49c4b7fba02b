"""The port's CLIs against the JAX CLIs at the edge configurations of the
k-mer width, on the CPU.

``datasketcher``: k = 4 (the shortest k-mer), 16 / 17 (the last u32 item
and the first u64 item) and 32 (a full u64 key, its top bit set in the
port's int64 carriers), each at m = 7 and 64; ``-a SUPER2`` and ``-a HLL``
and block mode ``-b 64`` at k = 32.  ``parsefastq``: ``--count`` and
``--unique`` at k = 32, ``--count -s 17 -c 16`` (the first u64 table, u16
counts) and ``-b 4 kmer --count -s 16``.

Tolerance: byte-identical dumps and statistics files.
"""

import contextlib
import io
import os

import numpy as np
import pytest

from kmerutils_tpu.cli import datasketcher as j_sketch
from kmerutils_tpu.cli import parsefastq as j_parse
from kmerutils_tpu_torch.cli import datasketcher as t_sketch
from kmerutils_tpu_torch.cli import parsefastq as t_parse


def write_reads(path: str, seed: int, n: int, lo: int, hi: int, dups: int):
    """n reads of lo..hi bases, the first ``dups`` of them repeated (counts
    >= 2), one of them with an N; the last read is 6 bases long (no
    k-mer above k = 6: an empty signature)."""
    rng = np.random.default_rng(seed)
    rs = ["".join(rng.choice(list("ACGT"), size=int(L)))
          for L in rng.integers(lo, hi, size=n)]
    rs += rs[:dups]
    rs[2] = rs[2][:30] + "N" + rs[2][31:]
    rs.append("ACGTTG")
    with open(path, "w") as f:
        for i, r in enumerate(rs):
            f.write(f"@read{i}\n{r}\n+\n{'I' * len(r)}\n")


def run(main, argv, workdir):
    """A CLI main in ``workdir``; returns (rc, stdout + stderr, {file:
    bytes}) of the files it wrote there."""
    here = os.getcwd()
    buf = io.StringIO()
    os.chdir(workdir)
    try:
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(buf):
            rc = main(argv)
    finally:
        os.chdir(here)
    return rc, buf.getvalue(), {
        n: open(os.path.join(workdir, n), "rb").read()
        for n in sorted(os.listdir(workdir)) if n != "in.fastq"}


SKETCH_CASES = {f"k{k}_m{m}": ["-k", str(k), "-s", str(m)]
                for k in (4, 16, 17, 32) for m in (7, 64)}
SKETCH_CASES.update({
    "k32_SUPER2": ["-k", "32", "-s", "24", "-a", "SUPER2"],
    "k32_HLL": ["-k", "32", "-s", "24", "-a", "HLL"],
    "k32_block64": ["-k", "32", "-s", "24", "-b", "64"],
})


@pytest.mark.parametrize("case", sorted(SKETCH_CASES))
def test_datasketcher_edges_match_jax_cli(tmp_path, case):
    files = {}
    for name, main, extra in (("jax", j_sketch.main, []),
                              ("torch", t_sketch.main, ["--device", "cpu"])):
        d = tmp_path / name
        d.mkdir()
        fq = str(d / "in.fastq")
        write_reads(fq, 51, 40, 60, 400, 3)
        rc, _, files[name] = run(main, ["-f", fq, "-d", str(d / "sigs.bin"),
                                        *SKETCH_CASES[case], *extra], str(d))
        assert rc == 0
    assert sorted(files["torch"]) == sorted(files["jax"]) == [
        "sigs.bin", "sketchparams_dump.json"]
    for n in files["jax"]:
        assert files["torch"][n] == files["jax"][n], n


PARSE_CASES = {
    "count_k32": ["kmer", "--count", "-s", "32"],
    "unique_k32": ["kmer", "--unique", "-s", "32"],
    "count_k17_c16": ["kmer", "--count", "-s", "17", "-c", "16"],
    "bits4_count_k16": ["-b", "4", "kmer", "--count", "-s", "16"],
}


@pytest.mark.parametrize("case", sorted(PARSE_CASES))
def test_parsefastq_edges_match_jax_cli(tmp_path, case):
    files = {}
    for name, main, extra in (("jax", j_parse.main, []),
                              ("torch", t_parse.main, ["--device", "cpu"])):
        d = tmp_path / name
        d.mkdir()
        fq = str(d / "in.fastq")
        write_reads(fq, 52, 20, 100, 200, 4)     # one width rung
        # --device is a global flag: before the subcommand
        rc, log, files[name] = run(main, ["-f", fq, *extra,
                                          *PARSE_CASES[case],
                                          "--capacity", "4096"], str(d))
        assert rc == 0 and "WARNING" not in log     # nothing dropped
    assert sorted(files["torch"]) == sorted(files["jax"])
    assert len(files["jax"]) == 3
    for n in files["jax"]:
        assert files["torch"][n] == files["jax"][n], n
    dump = [n for n in files["jax"] if n.endswith("_kmer.bin")]
    assert len(dump) == 1 and len(files["jax"][dump[0]]) > 1000
