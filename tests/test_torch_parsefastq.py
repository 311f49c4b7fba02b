"""The port's parsefastq CLI against the JAX CLI, on the CPU.

Tolerance: byte-identical ``.multi_kmer.bin``, ``.once_kmer.bin``,
``bases.histo`` and ``readlen.histo`` for --count with k = 11 (u32 tagged
keys), 16 (u32) and 20 (u64 table), --count -c 16, --unique with k = 16 and
21 (coordinates; reads of several lengths, so the port's length-sorted
batch rows differ from file order), a spill run that writes at least
two segments, and the statistics-only call; k=15 returns 1 in both.
Either package's ``KmerCountReload`` reloads either CLI's --count and
--unique dumps with equal counts, keys, coordinates and accessors.  The
--no-spill run past capacity is held to the drop contract instead (the
port's batches have no padding rows, so its compaction timing may differ
from JAX's where entries drop): the largest keys go, a warning is printed,
and the keys that are missing or short number at most n_dropped.
"""

import collections
import contextlib
import io
import os
import re

import numpy as np
import pytest

from kmerutils_tpu.cli import parsefastq as jcli
from kmerutils_tpu.io import formats as jformats
from kmerutils_tpu_torch.cli import parsefastq as tcli
from kmerutils_tpu_torch.io import fastx, formats

COMP = str.maketrans("ACGT", "TGCA")
CAP = ["--capacity", "16384"]


def make_reads(seed: int, n: int, lo: int, hi: int, dups: int):
    rng = np.random.default_rng(seed)
    reads = ["".join(rng.choice(list("ACGT"), size=int(L)))
             for L in rng.integers(lo, hi, size=n)]
    reads += reads[:dups]             # repeated reads: counts >= 2
    reads[3] = reads[3][:20] + "N" + reads[3][21:]   # dropped at ingest
    return reads


FIXTURES = {
    # one length rung (one batch shape in the JAX CLI)
    "small": lambda: make_reads(5, 36, 150, 250, 6),
    # two rungs: the port's rows are length-sorted, not in file order
    "mixed": lambda: make_reads(6, 30, 100, 400, 4),
    # 8 reads per batch under --batch-reads 8: spills at capacity 16384
    "spill": lambda: make_reads(7, 110, 150, 250, 12),
}

CASES = {
    "count_k11": ("small", ["kmer", "--count", "-s", "11", *CAP]),
    "count_k16": ("small", ["kmer", "--count", "-s", "16", *CAP]),
    "count_k16_c16": ("small", ["kmer", "--count", "-s", "16", "-c", "16",
                                *CAP]),
    "count_k20": ("small", ["kmer", "--count", "-s", "20", *CAP]),
    "unique_k16": ("mixed", ["kmer", "--unique", "-s", "16", *CAP]),
    "unique_k21": ("mixed", ["kmer", "--unique", "-s", "21", *CAP]),
    "spill_k16": ("spill", ["--batch-reads", "8", "kmer", "--count", "-s",
                            "16", *CAP]),
    "stats_only": ("mixed", []),
    "k15": ("small", ["kmer", "--count", "-s", "15"]),
}


def run_cli(main, fixture: str, argv, workdir):
    """Run a CLI main in its own directory on a copy of the fixture;
    returns (rc, stdout + stderr, {output file: bytes})."""
    os.makedirs(workdir)
    fq = os.path.join(workdir, "in.fastq")
    fastx.write_fastq(fq, FIXTURES[fixture]())
    buf = io.StringIO()
    here = os.getcwd()
    os.chdir(workdir)
    try:
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(buf):
            rc = main(["-f", fq] + argv)
    finally:
        os.chdir(here)
    files = {n: open(os.path.join(workdir, n), "rb").read()
             for n in sorted(os.listdir(workdir)) if n != "in.fastq"}
    return rc, buf.getvalue(), files


@pytest.fixture(scope="module")
def jax_outputs(tmp_path_factory):
    base = tmp_path_factory.mktemp("jax_cli")
    return {name: run_cli(jcli.main, fx, argv, str(base / name))
            for name, (fx, argv) in CASES.items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_outputs_match_jax_cli(case, jax_outputs, tmp_path):
    fx, argv = CASES[case]
    rc, log, files = run_cli(tcli.main, fx, ["--device", "cpu"] + argv,
                             str(tmp_path / case))
    j_rc, j_log, j_files = jax_outputs[case]
    assert rc == j_rc == (1 if case == "k15" else 0)
    assert "WARNING" not in log + j_log
    assert sorted(files) == sorted(j_files)
    for name in files:
        assert files[name] == j_files[name], name
    if case == "k15":
        assert not files
    elif case == "stats_only":
        assert sorted(files) == ["bases.histo", "readlen.histo"]
    else:
        assert len(files) == 3
    if case == "spill_k16":
        segs = int(re.search(r"\((\d+) spill segments merged\)", log)[1])
        assert segs >= 2 and "spill segments" in j_log


def oracle_counts(reads, k):
    c = collections.Counter()
    for s in reads:
        if "N" in s:
            continue
        for p in range(len(s) - k + 1):
            sub = s[p : p + k]
            c[min(sub, sub.translate(COMP)[::-1])] += 1
    return {int(sum(4 ** (k - 1 - i) * "ACGT".index(ch)
                    for i, ch in enumerate(s))): n for s, n in c.items()}


def test_no_spill_drop_contract(tmp_path):
    """One batch of ~7,000 entries into a 4096-entry table with --no-spill:
    the largest keys drop, the warning names the drop count, and every
    key below the first wrong one is exact."""
    rc, log, _ = run_cli(tcli.main, "small",
                         ["--device", "cpu", "kmer", "--count", "-s", "16",
                          "--capacity", "4096", "--no-spill"],
                         str(tmp_path / "drop"))
    assert rc == 0
    n_dropped = int(re.search(r"WARNING: (\d+) entries dropped", log)[1])
    assert n_dropped > 0
    _, got = formats.read_multiple_kmer_dump(
        str(tmp_path / "drop" / "in.fastq.multi_kmer.bin"))
    truth = {key: min(n, 255) for key, n in
             oracle_counts(FIXTURES["small"](), 16).items() if n >= 2}
    wrong = [key for key in sorted(truth) if got.get(key) != truth[key]]
    assert wrong and len(wrong) <= n_dropped
    assert set(got) <= set(truth)
    assert all(got[key] <= truth[key] for key in got)
    # a suffix of the key order is affected: past the first wrong key
    # nothing survives but that key itself
    assert all(key <= wrong[0] for key in got)



RELOAD_CASES = ["count_k11", "count_k16", "count_k20", "unique_k16",
                "unique_k21"]


def reload_both(path: str):
    """The dump reloaded by the JAX package and by the port."""
    multi = path.endswith("multi_kmer.bin")
    load = ("load_multiple_kmers_from_file" if multi
            else "load_unique_kmers_from_file")
    return (getattr(jformats.KmerCountReload, load)(path),
            getattr(formats.KmerCountReload, load)(path))


@pytest.mark.parametrize("case", RELOAD_CASES)
def test_kmer_count_reload_matches_jax_on_both_clis_dumps(case, jax_outputs,
                                                          tmp_path):
    """Each package's reload of the JAX CLI's dump and of the port's: equal
    counts, keys, coordinates and accessors (an absent key, ranks -1 and n
    give None)."""
    fx, argv = CASES[case]
    rc, _, files = run_cli(tcli.main, fx, ["--device", "cpu"] + argv,
                           str(tmp_path / "port"))
    assert rc == 0
    name = "in.fastq." + ("multi" if "count" in case else "once") + \
        "_kmer.bin"
    paths = {"port": str(tmp_path / "port" / name),
             "jax": str(tmp_path / ("jax." + name))}
    with open(paths["jax"], "wb") as f:
        f.write(jax_outputs[case][2][name])
    rng = np.random.default_rng(len(case))
    for who, path in paths.items():
        j, t = reload_both(path)
        assert (t.kmer_size, t.counts, t.unique_keys, t.coords) == \
            (j.kmer_size, j.counts, j.unique_keys, j.coords), who
        assert t.get_multi_kmer_counts() == j.get_multi_kmer_counts()
        keys = list(t.counts or t.unique_keys)
        assert keys, who
        probe = [keys[int(i)] for i in rng.integers(0, len(keys), 50)]
        absent = max(keys) + 1
        for key in probe + [absent]:
            assert t.get_kmer_count(key) == j.get_kmer_count(key)
            assert t.get_unique_kmer_coord(key) == \
                j.get_unique_kmer_coord(key)
        n = len(t.coords or [])
        for rank in [-1, 0, n // 2, n - 1, n]:
            assert t.get_coord_from_rank(rank) == j.get_coord_from_rank(rank)
        assert t.get_kmer_count(absent) is None
        assert t.get_unique_kmer_coord(absent) is None
        assert t.get_coord_from_rank(-1) is None
        assert t.get_coord_from_rank(n) is None
