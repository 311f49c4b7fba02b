"""The port's anchors (anchor.py) and RESP store (kvstore.py) against the
JAX package, on the CPU.

Tolerance: none.  Anchor key and value strings, the anchors' order and the
stores' contents are byte-equal to JAX's, and the RESP servers' replies are
byte-identical for the same request bytes.  Two deliberate differences are
pinned here: an empty value string parses to an anchor with an empty
minhash (JAX raises), and a malformed RESP frame gets ``-ERR protocol
error`` (the JAX handler raises without a reply).  Every socket has a
timeout and every server thread is a daemon.
"""

import socket

import numpy as np
import pytest

from kmerutils_tpu import anchor as ja
from kmerutils_tpu import kvstore as jk
from kmerutils_tpu.base import sequence as jseq
from kmerutils_tpu_torch import anchor as ta
from kmerutils_tpu_torch import kvstore as tk
from kmerutils_tpu_torch.base import sequence as tseq
from kmerutils_tpu_torch.io import fastx

TIMEOUT = 10.0


def random_reads(rng, lens):
    return ["".join(rng.choice(list("ACGT"), size=int(L))) for L in lens]


def params(k: int, window: int = 100, overlap: int = 20, nbkmer: int = 8):
    kw = dict(fasta_name="reads.fa", window=window, nbkmer=nbkmer,
              kmer_size=k, overlap=overlap)
    return ta.AnchorsGeneratorParameters(**kw), \
        ja.AnchorsGeneratorParameters(**kw)


def strings(anchors, p):
    return [(a.key_string(p), a.value_string()) for a in anchors]


@pytest.mark.parametrize("k", [11, 21])
def test_compute_anchors_matches_jax(k):
    rng = np.random.default_rng(k)
    # 85 bases: the window at 80 holds no k-mer (empty minhash); 100 and
    # 180: windows ending exactly at the read's end; one read of k bases
    rs = random_reads(rng, [300, 85, 100, 180, k, 257, 411])
    rs[5] = rs[0][:257]
    tp, jp = params(k)
    got = ta.compute_anchors(tseq.pack_ascii_reads(rs, device="cpu"), tp,
                             read_num_offset=40)
    want = ja.compute_anchors(jseq.pack_ascii_reads(rs), jp,
                              read_num_offset=40)
    assert strings(got, tp) == strings(want, jp)
    assert [(a.readnum, a.slicepos, a.minhash) for a in got] \
        == [(a.readnum, a.slicepos, a.minhash) for a in want]
    assert any(not a.minhash for a in got)
    assert all(len(a.minhash) <= 8 for a in got)


def test_compute_anchors_window_shorter_than_nbkmer():
    """window 10 < nbkmer 16: the bottom-k sketch has P = 10 columns, so
    each anchor holds every distinct hash of its window, as JAX's anchors
    with nbkmer = window do.  JAX's compute_anchors raises here (it
    reshapes the P columns to nbkmer)."""
    rs = random_reads(np.random.default_rng(2), [60, 33, 12])
    tp, _ = params(7, window=10, overlap=3, nbkmer=16)
    _, jp_window = params(7, window=10, overlap=3, nbkmer=10)
    got = ta.compute_anchors(tseq.pack_ascii_reads(rs, device="cpu"), tp)
    want = ja.compute_anchors(jseq.pack_ascii_reads(rs), jp_window)
    assert strings(got, tp) == strings(want, jp_window)
    with pytest.raises(ValueError, match="cannot reshape"):
        ja.compute_anchors(jseq.pack_ascii_reads(rs), params(
            7, window=10, overlap=3, nbkmer=16)[1])


def test_compute_anchors_takes_read_numbers_from_the_batch():
    rs = random_reads(np.random.default_rng(3), [120, 90, 200])
    tp, _ = params(11)
    batch = tseq.pack_ascii_reads(rs, device="cpu")
    plain = ta.compute_anchors(batch, tp)
    mapped = ta.compute_anchors(batch, tp, read_nums=np.array([7, 2, 5]))
    assert [a.readnum for a in mapped] == sorted(a.readnum for a in mapped)
    by_read = {a.readnum: [] for a in plain}
    for a in plain:
        by_read[a.readnum].append((a.slicepos, a.minhash))
    remap = {7: 0, 2: 1, 5: 2}
    for a in mapped:
        assert (a.slicepos, a.minhash) in by_read[remap[a.readnum]]


def write_unsorted_fasta(path: str, seed: int, n: int = 160):
    """Reads whose length order is not their file order: lengths across
    several width rungs (so the port's length-sorted windows reorder them
    into several batches), some with an N (dropped, so read numbers skip
    nothing), one of 85 bases (an empty last window at k = 21)."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(30, 1400, size=n)
    lens[[0, 1, 2]] = (1300, 85, 40)
    rs = random_reads(rng, lens)
    for i in range(5, n, 17):
        rs[i] = rs[i][:10] + "N" + rs[i][11:]
    with open(path, "w") as f:
        for i, r in enumerate(rs):
            f.write(f">r{i}\n{r}\n")
    return rs


@pytest.mark.parametrize("k", [11, 21])
def test_anchor_computation_matches_jax_on_unsorted_file(tmp_path, k):
    path = str(tmp_path / "reads.fa")
    rs = write_unsorted_fasta(path, k)
    rows = [idx for _, idx in fastx.read_batches(path)]
    order = np.concatenate(rows)
    assert len(rows) > 1 and not np.array_equal(order, np.sort(order))
    tp, jp = params(k)
    tstore, jstore = ta.AnchorStore(), ja.AnchorStore()
    got = ta.anchor_computation(path, tp, tstore, device="cpu")
    want = ja.anchor_computation(path, jp, jstore)
    assert strings(got, tp) == strings(want, jp)
    assert tstore.hashes == jstore.hashes
    n_clean = sum("N" not in r for r in rs)
    assert len({a.readnum for a in got}) == n_clean
    empty = [a for a in got if not a.minhash]     # the 85-base read's
    assert empty
    for a in empty:
        assert tstore.load_anchor(tp, a.readnum, a.slicepos).minhash == []


def test_empty_value_string_gives_an_empty_anchor():
    a = ta.SliceAnchor.from_value_string(3, 800, "")
    assert (a.readnum, a.slicepos, a.minhash) == (3, 800, [])
    assert a.value_string() == ""
    with pytest.raises(ValueError):          # the reference's fault
        ja.SliceAnchor.from_value_string(3, 800, "")
    s = "12,1:4294967297,3"
    assert ta.SliceAnchor.from_value_string(0, 0, s).minhash \
        == ja.SliceAnchor.from_value_string(0, 0, s).minhash \
        == [(12, 1), (4294967297, 3)]


def raw_exchange(port: int, frames) -> list[bytes]:
    """Send each frame and read one reply line (and a bulk's body)."""
    out = []
    with socket.create_connection(("127.0.0.1", port),
                                  timeout=TIMEOUT) as s:
        reader = tk._Reader(s)
        for f in frames:
            s.sendall(f)
            line = reader._line()
            body = b""
            if line[:1] == b"$" and int(line[1:]) >= 0:
                body = reader._exact(int(line[1:]))
            elif line[:1] == b"*":
                body = b"|".join(reader._exact(int(reader._line()[1:]))
                                 for _ in range(int(line[1:])))
            out.append(line + b"/" + body)
    return out


def test_resp_servers_reply_byte_identical():
    frames = [tk._encode_command(*c) for c in (
        ("PING",), ("SELECT", 0), ("HSET", "h", "a", "1"),
        ("HSET", "h", "a", "2", "b", "3"), ("HGET", "h", "a"),
        ("HGET", "h", "zz"), ("HGET", "nokey", "a"), ("HLEN", "h"),
        ("HGETALL", "h"), ("hset", "h", "c", "4"), ("HSET", "h", "x"),
        ("NOSUCH", "x"), ("BGREWRITEAOF",), ("FLUSHDB",), ("HLEN", "h"))]
    servers = [tk.RespServer(), jk.RespServer()]
    try:
        got, want = (raw_exchange(s.port, frames) for s in servers)
    finally:
        for s in servers:
            s.close()
    assert got == want
    assert got[4] == b"$1/2" and got[11].startswith(b"-ERR unknown command")
    assert tk._encode_command("HSET", 1, b"x") \
        == jk._encode_command("HSET", 1, b"x")


@pytest.mark.parametrize("frame", [b"?oops\r\n", b"*1\r\n$abc\r\n",
                                   b"*1\r\n$-1\r\n", b"*1\r\n:5\r\n",
                                   b"*0\r\n", b"+PING\r\n",
                                   b"*2\r\n*1\r\n$1\r\na\r\n$1\r\nb\r\n"])
def test_resp_server_answers_a_malformed_frame(frame):
    srv = tk.RespServer()
    try:
        with socket.create_connection(("127.0.0.1", srv.port),
                                      timeout=TIMEOUT) as s:
            s.sendall(tk._encode_command("PING") + frame)
            got = b""
            while True:                      # until the server closes
                chunk = s.recv(4096)
                if not chunk:
                    break
                got += chunk
        assert got == b"+PONG\r\n-ERR protocol error\r\n"
        cli = tk.RespClient(port=srv.port, timeout=TIMEOUT)
        assert cli.ping() and cli.hset("k", "f", "v") == 1
        assert cli.hget("k", "f") == "v"
        cli.close()
    finally:
        srv.close()


def test_redis_anchor_store_round_trip(tmp_path):
    path = str(tmp_path / "reads.fa")
    write_unsorted_fasta(path, 4, n=60)
    tp, jp = params(21)
    srv = tk.RespServer()
    try:
        store = ta.RedisAnchorStore(port=srv.port)
        got = ta.anchor_computation(path, tp, store, device="cpu")
        jstore = ja.AnchorStore()
        ja.anchor_computation(path, jp, jstore)
        # the server holds exactly what the JAX store holds
        assert {k.decode(): {f.decode(): v.decode() for f, v in h.items()}
                for k, h in srv.store.items()} == jstore.hashes
        assert store._r.hgetall(ta.SLICE_ANCHOR_KEY) \
            == jstore.hashes[ta.SLICE_ANCHOR_KEY]
        for a in got[::5] + [a for a in got if not a.minhash]:
            back = store.load_anchor(tp, a.readnum, a.slicepos)
            assert (back.readnum, back.slicepos, back.minhash) \
                == (a.readnum, a.slicepos, a.minhash)
        assert store.load_anchor(tp, 10**6, 0) is None
        # the JAX client reads the port's server the same way
        jcli = jk.RespClient(port=srv.port, timeout=TIMEOUT)
        a = got[3]
        assert jcli.hget(ja.SLICE_ANCHOR_KEY, a.key_string(tp)) \
            == a.value_string()
        jcli.close()
        store.close()
    finally:
        srv.close()
