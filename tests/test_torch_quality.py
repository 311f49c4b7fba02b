"""The port's quality store, quality server and ``qualityloader`` CLI against
the JAX package's, on the CPU.

Tolerance: none.  Every symbol, rank, directory word, offset and
``memory_bits`` is equal, and every reply of the quality server is
byte-identical to the JAX server's for the same request bytes.  All of it
is host code in both packages.  Every socket has a timeout and every server
thread is a daemon, so a hung exchange fails in seconds.
"""

import os
import select
import socket
import struct
import subprocess
import sys
import time

import numpy as np
import pytest

from kmerutils_tpu.cli import qualityloader as jcli
from kmerutils_tpu.io import native as jnative
from kmerutils_tpu.quality import qserver as jqs
from kmerutils_tpu.quality import quality as jq
from kmerutils_tpu_torch.cli import qualityloader as tcli
from kmerutils_tpu_torch.io import native as tnative
from kmerutils_tpu_torch.quality import qserver as tqs
from kmerutils_tpu_torch.quality import quality as tq

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REQ = struct.Struct(">QIQQQ")
TIMEOUT = 10.0


def write_quality_fastq(path: str, seed: int, n: int, wrapped: bool = False):
    """n reads of 1-300 bases, some with an N, qualities drawn over bytes
    0x21-0x5A: below 0x25 (symbol 0), 0x25-0x37 (1-6) and above 0x37 (7).
    Returns the quality lines as bytes."""
    rng = np.random.default_rng(seed)
    quals = []
    with open(path, "wb") as f:
        for i in range(n):
            L = int(rng.integers(1, 300))
            seq = bytearray(rng.choice(np.frombuffer(b"ACGT", np.uint8),
                                       size=L).tobytes())
            if i % 7 == 3:
                seq[L // 2] = ord("N")
            q = rng.integers(0x21, 0x5B, size=L).astype(np.uint8).tobytes()
            quals.append(q)
            if wrapped and L > 60:   # 60-column wrapping: the Python parser
                s = b"\n".join(bytes(seq[j:j + 60]) for j in range(0, L, 60))
                qq = b"\n".join(q[j:j + 60] for j in range(0, L, 60))
            else:
                s, qq = bytes(seq), q
            f.write(b"@read%d\n%s\n+\n%s\n" % (i, s, qq))
    return quals


def test_remap_table_and_proba_equal_jax():
    q = np.arange(256, dtype=np.uint8)
    got = tq.remap_quality8(q)
    assert got.dtype == np.uint8
    assert np.array_equal(got, jq.remap_quality8(q))
    assert np.array_equal(tq.quality_to_proba(q), jq.quality_to_proba(q))


def test_native_bindings_present():
    # the committed library exports both entry points the quality path
    # needs; without it the store would silently take the numpy build
    assert tnative.available() and jnative.available()
    assert tnative.wavelet_build(np.zeros(1, np.uint8), 3) is not None


def test_native_blocks_match_jax(tmp_path):
    """iter_quality_blocks keeps every read (N reads too), in small blocks
    as in one; iter_clean_read_codes drops the N reads; both as JAX's."""
    p = str(tmp_path / "q.fastq")
    quals = write_quality_fastq(p, 31, 50)
    for block_reads in (7, 10000):
        t = list(tnative.iter_quality_blocks(p, block_reads=block_reads))
        j = list(jnative.iter_quality_blocks(p, block_reads=block_reads))
        assert len(t) == len(j) == -(-50 // block_reads)
        for (tq_, to), (jq_, jo) in zip(t, j):
            assert np.array_equal(tq_, jq_) and np.array_equal(to, jo)
    assert np.concatenate([q for q, _ in t]).tobytes() == b"".join(quals)
    t = list(tnative.iter_clean_read_codes(p, block_reads=7))
    j = list(jnative.iter_clean_read_codes(p, block_reads=7))
    assert len(t) == len(j) == sum(1 for i in range(50) if i % 7 != 3)
    assert all(np.array_equal(a, b) for a, b in zip(t, j))


def assert_same_matrix(t, j):
    assert t.n == j.n and t.zeros == j.zeros
    assert t.memory_bits() == j.memory_bits()
    for bt, bj in zip(t.levels, j.levels, strict=True):
        assert bt.n == bj.n
        for name in ("words", "sup", "sub"):
            a, b = getattr(bt, name), getattr(bj, name)
            assert a.dtype == b.dtype and np.array_equal(a, b), name


# 500 symbols: the numpy build; 100,001 and the dense one: the native build
@pytest.mark.parametrize("n,dense", [(500, False), (100_001, False),
                                     (100_000, True)])
def test_wavelet_matrix_matches_jax(n, dense):
    rng = np.random.default_rng(n)
    vals = rng.integers(0, 8, size=n).astype(np.uint8)
    if dense:
        vals[:] = 7
        vals[::7] = 2
    t, j = tq.WaveletMatrix(vals), jq.WaveletMatrix(vals)
    assert (n >= tq.WaveletMatrix._NATIVE_MIN) == (n > 500)
    assert_same_matrix(t, j)
    assert np.array_equal(t.access_all(), vals.astype(np.uint64))
    idx = rng.integers(0, n, size=200)
    assert np.array_equal(t.lookup(idx), j.lookup(idx))
    for sym in range(8):
        for pos in (0, 1, 63, 64, 65, 511, 512, n // 2, n):
            if pos > n:           # rank is defined on [0, n]
                continue
            assert t.rank(sym, pos) == j.rank(sym, pos) \
                == int((vals[:pos] == sym).sum()), (sym, pos)


def test_native_build_equals_numpy_build():
    rng = np.random.default_rng(3)
    for n in (64, 65, 511, 513, 4095, 20_001):
        vals = rng.integers(0, 8, size=n).astype(np.uint8)
        words, sub, sup, zeros = tnative.wavelet_build(vals, 3)
        cur = vals.astype(np.uint64)
        for d, lvl in enumerate((2, 1, 0)):
            bits = ((cur >> np.uint64(lvl)) & np.uint64(1)).astype(bool)
            bv = tq._BitVecRank(bits)
            assert np.array_equal(words[d], bv.words), (n, d)
            assert np.array_equal(sub[d], bv.sub), (n, d)
            assert np.array_equal(sup[d], bv.sup), (n, d)
            assert zeros[d] == int((~bits).sum()), (n, d)
            cur = np.concatenate([cur[~bits], cur[bits]])


@pytest.mark.parametrize("wrapped", [False, True])
def test_quality_store_matches_jax(tmp_path, wrapped):
    p = str(tmp_path / "q.fastq")
    quals = write_quality_fastq(p, 11 + wrapped, 240, wrapped=wrapped)
    t, j = tq.load_quality_store(p), jq.load_quality_store(p)
    assert len(t) == len(j) == len(quals)
    assert np.array_equal(t.offsets, j.offsets)
    assert_same_matrix(t.wm, j.wm)
    assert t.memory_bits() == j.memory_bits()
    flat = tq.remap_quality8(np.frombuffer(b"".join(quals), np.uint8))
    assert np.array_equal(t.wm.access_all(), flat.astype(np.uint64))
    assert set(np.unique(flat)) == set(range(8))
    for r in (0, 5, 100, len(quals) - 1):
        want = tq.remap_quality8(np.frombuffer(quals[r], np.uint8))
        assert np.array_equal(t[r].decompress().qseq, want)
    tm, jm = tq.load_quality_store(p, max_reads=17), \
        jq.load_quality_store(p, max_reads=17)
    assert len(tm) == 17 and np.array_equal(tm.offsets, jm.offsets)
    assert np.array_equal(tm.wm.access_all(), jm.wm.access_all())


@pytest.mark.parametrize("wrapped", [False, True])
def test_load_quality_wm_matches_jax(tmp_path, wrapped):
    p = str(tmp_path / "q.fastq")
    quals = write_quality_fastq(p, 21 + wrapped, 60, wrapped=wrapped)
    t, j = tq.load_quality_wm(p), jq.load_quality_wm(p)
    assert len(t) == len(j) == len(quals)
    for a, b in zip(t, j):
        assert a.read_num == b.read_num and len(a) == len(b)
        assert_same_matrix(a.qseq, b.qseq)
        assert np.array_equal(a.decompress().qseq, b.decompress().qseq)
    assert len(tq.load_quality_wm(p, max_reads=9)) == 9
    raw = t[4].decompress()
    assert np.array_equal(raw.to_wm().decompress().qseq, raw.qseq)


def test_fasta_has_no_qualities(tmp_path):
    p = tmp_path / "r.fasta"
    p.write_text(">a\nACGT\n")
    for load in (tq.load_quality_store, tq.load_quality_wm):
        with pytest.raises(ValueError, match="FASTA file has no qualities"):
            load(str(p))


def exchange(port: int, reqs) -> list[bytes]:
    """Send each request frame on one connection and read its reply
    (header, then payload) as raw bytes."""
    out = []
    with socket.create_connection(("127.0.0.1", port),
                                  timeout=TIMEOUT) as s:
        for req in reqs:
            s.sendall(req)
            hdr = tqs._recv_exact(s, 16)
            n = struct.unpack(">QII", hdr)[2]
            out.append(hdr + (tqs._recv_exact(s, n) if n else b""))
    return out


def requests(n_reads: int, lens) -> list[bytes]:
    """Every code (1, 2, 3, an unknown 5), in and out of range: blocks
    inside, empty, to the end, past the end and reversed; bases at 0, the
    last and one past; a read number past the last."""
    reqs = []
    h = 0x8000_0000_0000_0001
    for r in (0, 3, n_reads - 1):
        L = int(lens[r])
        reqs += [REQ.pack(h + r, tqs.GET_Q_READ, r, 0, 0),
                 REQ.pack(h, tqs.GET_Q_BLOCK, r, 1, L // 2),
                 REQ.pack(h, tqs.GET_Q_BLOCK, r, 2, 2),
                 REQ.pack(h, tqs.GET_Q_BLOCK, r, 0, L),
                 REQ.pack(h, tqs.GET_Q_BLOCK, r, 0, L + 1),
                 REQ.pack(h, tqs.GET_Q_BLOCK, r, 5, 4),
                 REQ.pack(h, tqs.GET_Q_BASE, r, 0, 0),
                 REQ.pack(h, tqs.GET_Q_BASE, r, L - 1, 0),
                 REQ.pack(h, tqs.GET_Q_BASE, r, L, 0),
                 REQ.pack(h, 5, r, 0, 1)]
    reqs += [REQ.pack(7, tqs.GET_Q_READ, n_reads, 0, 0),
             REQ.pack(7, tqs.GET_Q_BASE, (1 << 64) - 1, 0, 0)]
    return reqs


@pytest.mark.parametrize("per_read", [False, True])
def test_server_replies_byte_identical_to_jax(tmp_path, per_read):
    p = str(tmp_path / "q.fastq")
    quals = write_quality_fastq(p, 5, 40)
    load_t = tq.load_quality_wm if per_read else tq.load_quality_store
    load_j = jq.load_quality_wm if per_read else jq.load_quality_store
    servers = {"torch": tqs.QualityServer(load_t(p), port=0),
               "jax": jqs.QualityServer(load_j(p), port=0)}
    threads = {k: s.serve_in_thread() for k, s in servers.items()}
    reqs = requests(len(quals), [len(q) for q in quals])
    replies = {k: exchange(s.port, reqs + [REQ.pack(9, tqs.EXIT, 0, 0, 0)])
               for k, s in servers.items()}
    for t in threads.values():
        t.join(timeout=TIMEOUT)
        assert not t.is_alive()
    assert replies["torch"] == replies["jax"]
    ok = [struct.unpack(">QII", r[:16])[1] == 0 for r in replies["torch"]]
    assert 0 < sum(ok) < len(ok)          # both outcomes were exercised
    want = tq.remap_quality8(np.frombuffer(quals[3], np.uint8)).tobytes()
    assert replies["torch"][10][16:] == want


def test_client_against_both_servers(tmp_path):
    p = str(tmp_path / "q.fastq")
    quals = write_quality_fastq(p, 8, 12)
    want = tq.remap_quality8(np.frombuffer(quals[2], np.uint8))
    for server in (tqs.QualityServer(tq.load_quality_store(p), port=0),
                   jqs.QualityServer(jq.load_quality_store(p), port=0)):
        t = server.serve_in_thread()
        cli = tqs.QualityClient(port=server.port)
        cli.sock.settimeout(TIMEOUT)
        assert np.array_equal(cli.get_quality_sequence(2), want)
        assert np.array_equal(cli.get_quality_block(2, 3, 9), want[3:9])
        assert cli.get_quality_base(2, 4) == int(want[4])
        with pytest.raises(RuntimeError, match="error status 1"):
            cli.get_quality_base(2, len(want))
        cli.exit_server()
        cli.close()
        t.join(timeout=TIMEOUT)
        assert not t.is_alive()


@pytest.mark.parametrize("argv", [
    ["-f", "a.fq"],
    ["-f", "a.fq", "-p", "0", "-w"],
    ["--file", "b.fq", "--port", "9999", "--per-read", "--host", "0.0.0.0"],
])
def test_cli_parser_matches_jax(argv):
    assert vars(tcli.build_parser().parse_args(argv)) \
        == vars(jcli.build_parser().parse_args(argv))


def test_cli_parser_requires_file():
    with pytest.raises(SystemExit):
        tcli.build_parser().parse_args(["-p", "1"])


def read_lines(proc, n: int, timeout: float = 60.0) -> list[str]:
    """The first n lines of a child's stdout, failing after ``timeout``."""
    buf = b""
    end = time.monotonic() + timeout
    fd = proc.stdout.fileno()
    while buf.count(b"\n") < n:
        left = end - time.monotonic()
        ready, _, _ = select.select([fd], [], [], max(left, 0))
        if not ready:
            raise TimeoutError(f"no line from {proc.args} after {timeout} s")
        chunk = os.read(fd, 4096)
        if not chunk:
            raise RuntimeError(f"{proc.args} ended: {buf!r}")
        buf += chunk
    return buf.decode().splitlines()[:n]


def test_cli_serves_the_same_bytes_as_the_jax_cli(tmp_path):
    p = str(tmp_path / "reads.fastq")
    quals = write_quality_fastq(p, 9, 30)
    procs = {}
    try:
        for name, mod in (("torch", "kmerutils_tpu_torch"),
                          ("jax", "kmerutils_tpu")):
            procs[name] = subprocess.Popen(
                [sys.executable, "-m", f"{mod}.cli.qualityloader", "-f", p,
                 "-p", "0"], cwd=REPO, stdout=subprocess.PIPE,
                stderr=subprocess.DEVNULL,
                # the JAX CLI prints without a flush
                env={**os.environ, "PYTHONUNBUFFERED": "1"})
        lines = {k: read_lines(pr, 2) for k, pr in procs.items()}
        assert lines["torch"][0] == lines["jax"][0] \
            == f"loaded {len(quals)} quality sequences from {p}"
        ports = {}
        for k, (_, second) in lines.items():
            assert second.startswith("serving qualities on 127.0.0.1:")
            ports[k] = int(second.rsplit(":", 1)[1])
        reqs = requests(len(quals), [len(q) for q in quals])
        replies = {k: exchange(port, reqs + [REQ.pack(9, tqs.EXIT, 0, 0, 0)])
                   for k, port in ports.items()}
        assert replies["torch"] == replies["jax"]
        for pr in procs.values():
            assert pr.wait(timeout=TIMEOUT) == 0
    finally:
        for pr in procs.values():
            if pr.poll() is None:
                pr.kill()
                pr.wait(timeout=TIMEOUT)
            pr.stdout.close()
