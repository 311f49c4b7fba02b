"""The port's host value types and the rest of base/, ops/bitops.py and
io/fastx.py against the JAX package, on the CPU.

Tolerance: exact.  The same seeded inputs go through both packages: every
table and codec of ``base/alphabet.py`` over all 256 byte values and
``base_counts``; ``Sequence`` (2, 4 and 8 bits) and ``IterSequence``;
``ReadBatch.codes`` / ``valid_mask``, ``min_words`` and ``revcomp_batch``;
the k-mer value types of ``base/kmertypes.py``; the host k-mer helpers of
``base/kmer.py``; ntHash's scalar oracles (also against the first window
of the port's ``nthash_kmers``); the rotates and safe shifts of
``ops/bitops.py`` at 32 and 64 bits; ``hashed.py``; ``utils.py``; and
``io/fastx.load_all``; and the port's own build of the native library.
(``io/formats.KmerCountReload`` is held to the JAX package on both CLIs'
dumps in tests/test_torch_parsefastq.py.)
"""

import logging
import os
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmerutils_tpu import hashed as jhashed
from kmerutils_tpu import utils as jutils
from kmerutils_tpu.base import alphabet as jalpha
from kmerutils_tpu.base import kmer as jkmer
from kmerutils_tpu.base import kmertypes as jkt
from kmerutils_tpu.base import nthash as jnth
from kmerutils_tpu.base import sequence as jseq
from kmerutils_tpu.io import fastx as jfastx
from kmerutils_tpu.ops import bitops as jbit
from kmerutils_tpu.ops import rng as jrng
from kmerutils_tpu_torch import hashed as thashed
from kmerutils_tpu_torch import utils as tutils
from kmerutils_tpu_torch.base import alphabet as talpha
from kmerutils_tpu_torch.base import kmer as tkmer
from kmerutils_tpu_torch.base import kmertypes as tkt
from kmerutils_tpu_torch.base import nthash as tnth
from kmerutils_tpu_torch.base import sequence as tseq
from kmerutils_tpu_torch.io import fastx as tfastx
from kmerutils_tpu_torch.ops import bitops as tbit

M64 = (1 << 64) - 1
ALL = np.arange(256, dtype=np.uint8)


def u32(t: torch.Tensor) -> np.ndarray:
    """int32 bit patterns -> uint32 values."""
    return t.numpy().view(np.uint32)


# ---------------------------------------------------------------------------
# base/alphabet.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["ENCODE_2B", "DECODE_2B", "ENCODE_4B",
                                  "DECODE_4B", "COMPLEMENT_4B", "IS_ACGT"])
def test_alphabet_tables_match_jax(name):
    want, got = getattr(jalpha, name), getattr(talpha, name)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("name", ["is_acgt", "encode_2b", "decode_2b",
                                  "complement_2b", "encode_4b", "decode_4b"])
def test_alphabet_codecs_match_jax_on_every_byte(name):
    want = np.asarray(getattr(jalpha, name)(ALL))
    got = getattr(talpha, name)(ALL)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_alphabet_scalars_match_jax_on_every_byte():
    assert talpha.count_non_acgt(ALL) == jalpha.count_non_acgt(ALL) == 248
    for c in range(256):
        assert talpha.get_ac_from_tg(c) == jalpha.get_ac_from_tg(c)


def test_complement_2b_t_matches_jax():
    want = np.asarray(jalpha.complement_2b_jnp(jnp.asarray(ALL)))
    got = talpha.complement_2b_t(torch.from_numpy(ALL.copy()))
    assert got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("masked", [False, True])
def test_base_counts_matches_jax(masked):
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 4, size=(6, 5, 37), dtype=np.uint8)
    mask = rng.random((6, 5, 37)) < 0.7 if masked else None
    want = np.asarray(jalpha.base_counts(
        jnp.asarray(codes), None if mask is None else jnp.asarray(mask)))
    got = talpha.base_counts(torch.from_numpy(codes),
                             None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.int32 and want.dtype == np.int32
    assert np.array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# base/sequence.py: Sequence and IterSequence
# ---------------------------------------------------------------------------

def raw_bases(nb_bits: int, n: int, seed: int, with_n: bool = False) -> bytes:
    rng = np.random.default_rng(seed)
    letters = list("ACGTN" if with_n else "ACGT")
    s = "".join(rng.choice(letters, size=n))
    if with_n and n:
        s = s[: n // 2] + "N" + s[n // 2 + 1:]
    return s.encode()


def assert_same_sequence(got, want) -> None:
    assert np.array_equal(got.seq, want.seq)
    assert (got.nb_bits, got.nb_bases) == (want.nb_bits, want.nb_bases)
    assert got.description == want.description
    assert got.size() == want.size()
    assert [got.get_base(p) for p in range(got.size())] == \
        [want.get_base(p) for p in range(want.size())]
    assert np.array_equal(got.codes(), want.codes())
    assert got.decompress() == want.decompress()


@pytest.mark.parametrize("n", list(range(10)) + [1000])
@pytest.mark.parametrize("nb_bits", [2, 4, 8])
def test_sequence_matches_jax(nb_bits, n):
    raw = raw_bases(nb_bits, n, seed=n)
    got, want = tseq.Sequence(raw, nb_bits), jseq.Sequence(raw, nb_bits)
    assert_same_sequence(got, want)
    assert_same_sequence(got.reverse_complement(), want.reverse_complement())
    assert got.reverse_complement().reverse_complement().decompress() == \
        got.decompress()


@pytest.mark.parametrize("nb_bits", [4, 8])
def test_sequence_with_n_matches_jax(nb_bits):
    raw = raw_bases(nb_bits, 33, seed=9, with_n=True)
    got, want = tseq.Sequence(raw, nb_bits), jseq.Sequence(raw, nb_bits)
    assert_same_sequence(got, want)
    assert_same_sequence(got.reverse_complement(), want.reverse_complement())


def test_sequence_bad_input_raises_as_in_jax():
    for mod in (tseq, jseq):
        with pytest.raises(ValueError):
            mod.Sequence(b"ACGNT", 2)
        with pytest.raises(ValueError):
            mod.Sequence(b"ACGXT", 4)
        with pytest.raises(ValueError):
            mod.Sequence(b"ACGT", 3)


def walk(it, pattern: str):
    """Steps of an IterSequence: 'f' = next, 'b' = next_back."""
    return [it.next() if c == "f" else it.next_back() for c in pattern]


@pytest.mark.parametrize("decode", [False, True])
@pytest.mark.parametrize("nb_bits", [2, 4, 8])
def test_iter_sequence_matches_jax(nb_bits, decode):
    raw = raw_bases(nb_bits, 23, seed=4, with_n=nb_bits != 2)
    tq, jq = tseq.Sequence(raw, nb_bits), jseq.Sequence(raw, nb_bits)
    assert list(tseq.IterSequence(tq, decode)) == \
        list(jseq.IterSequence(jq, decode))
    pattern = "bbfbffbfffbbbfbfbfbbffbfbfbfff"          # runs past the ends
    assert walk(tseq.IterSequence(tq, decode), pattern) == \
        walk(jseq.IterSequence(jq, decode), pattern)
    for begin, end in ((0, 23), (5, 6), (3, 17)):
        ti, ji = tseq.IterSequence(tq, decode), jseq.IterSequence(jq, decode)
        ti.set_range(begin, end)
        ji.set_range(begin, end)
        assert walk(ti, "fbfbbf" * 5) == walk(ji, "fbfbbf" * 5)
    for begin, end in ((5, 5), (-1, 3), (0, 24), (7, 2)):
        for it in (tseq.IterSequence(tq), jseq.IterSequence(jq)):
            with pytest.raises(ValueError):
                it.set_range(begin, end)


# ---------------------------------------------------------------------------
# base/sequence.py: ReadBatch, min_words, revcomp_batch
# ---------------------------------------------------------------------------

def ragged(seed: int):
    """Codes of a ragged batch: an empty row, a row of exactly 16 * 3
    bases, a row of one base and random lengths."""
    rng = np.random.default_rng(seed)
    lengths = np.array([37, 0, 48, 1, 63, 16, 5], np.int32)
    codes = rng.integers(0, 4, size=(lengths.size, 64), dtype=np.uint8)
    return codes, lengths


@pytest.mark.parametrize("min_words", [None, 2, 9])
def test_readbatch_and_revcomp_match_jax(min_words):
    codes, lengths = ragged(11)
    jb = jseq.pack_codes(codes, lengths, min_words=min_words)
    tb = tseq.pack_codes(codes, lengths, min_words=min_words, device="cpu")
    assert np.array_equal(u32(tb.words), np.asarray(jb.words))
    assert np.array_equal(tb.lengths.numpy(), np.asarray(jb.lengths))
    assert tb.codes().dtype == torch.uint8
    assert np.array_equal(tb.codes().numpy(), np.asarray(jb.codes()))
    assert np.array_equal(tb.valid_mask().numpy(),
                          np.asarray(jb.valid_mask()))
    trc, jrc = tseq.revcomp_batch(tb), jseq.revcomp_batch(jb)
    assert np.array_equal(u32(trc.words), np.asarray(jrc.words))
    assert np.array_equal(trc.lengths.numpy(), np.asarray(jrc.lengths))
    back = tseq.revcomp_batch(trc)
    assert torch.equal(back.words, tb.words)
    assert torch.equal(back.lengths, tb.lengths)


def test_revcomp_batch_is_the_reverse_complement_of_each_read():
    codes, lengths = ragged(12)
    rc = tseq.revcomp_batch(tseq.pack_codes(codes, lengths, device="cpu"))
    got = rc.codes().numpy()
    for r, n in enumerate(lengths):
        assert np.array_equal(got[r, :n], 3 - codes[r, :n][::-1])
        assert not got[r, n:].any()


@pytest.mark.parametrize("min_words", [None, 12])
def test_pack_ascii_reads_min_words_matches_jax(min_words):
    reads = ["ACGT" * 10, "", "GATTACA", "T" * 32]
    jb = jseq.pack_ascii_reads(reads, min_words=min_words)
    tb = tseq.pack_ascii_reads(reads, min_words=min_words, device="cpu")
    assert np.array_equal(u32(tb.words), np.asarray(jb.words))
    assert np.array_equal(tb.lengths.numpy(), np.asarray(jb.lengths))


# ---------------------------------------------------------------------------
# base/kmertypes.py
# ---------------------------------------------------------------------------

KMER_CASES = ([("Kmer32bit", k) for k in (1, 14)] + [("Kmer16b32bit", 16)]
              + [("Kmer64bit", k) for k in (1, 14, 16, 21, 32)]
              + [("KmerAA32bit", k) for k in (1, 6)]
              + [("KmerAA64bit", k) for k in (1, 6, 12)])


def state(km):
    """Every slot of a k-mer object."""
    return tuple(getattr(km, s) for s in type(km).__slots__)


def pushed(cls, k: int, codes):
    """The k-mers after each push of ``codes`` into an empty k-mer."""
    km = cls(0) if cls.__name__ == "Kmer16b32bit" else cls(k)
    out = []
    for c in codes:
        km = km.push(int(c))
        out.append(km)
    return out


def kmer_codes(name: str, k: int) -> np.ndarray:
    """3k + 10 random codes: bases, or amino acids' 5-bit codes."""
    rng = np.random.default_rng(k * 7 + len(name))
    if "AA" not in name:
        return rng.integers(0, 4, size=3 * k + 10)
    from kmerutils_tpu_torch.aa import alphabet as aa
    letters = np.frombuffer(aa.BASES, np.uint8)
    return aa.encode_aa(rng.choice(letters, size=3 * k + 10))


@pytest.mark.parametrize("name,k", KMER_CASES,
                         ids=[f"{n}-k{k}" for n, k in KMER_CASES])
def test_kmertypes_match_jax(name, k):
    tcls, jcls = getattr(tkt, name), getattr(jkt, name)
    aa = "AA" in name
    codes = kmer_codes(name, k)
    tk, jk = pushed(tcls, k, codes), pushed(jcls, k, codes)
    assert [state(a) for a in tk] == [state(b) for b in jk]
    # the k-mers after k pushes: every method and the value semantics
    tk, jk = tk[k - 1:], jk[k - 1:]
    for a, b in zip(tk, jk):
        assert a.get_nb_base() == b.get_nb_base() == k
        assert a.get_compressed_value() == b.get_compressed_value()
        assert a.get_uncompressed_kmer() == b.get_uncompressed_kmer()
        assert str(a) == str(b)
        assert hash(a) == hash(b)
        assert a.get_bitsize() == b.get_bitsize()
        assert tcls.get_nb_base_max() == jcls.get_nb_base_max()
        s = str(b)
        assert state(tcls.from_str(s)) == state(jcls.from_str(s))
        v = b.get_compressed_value()
        assert state(tcls.build(v, k)) == state(jcls.build(v, k))
        if aa:
            with pytest.raises(NotImplementedError):
                a.reverse_complement()
            with pytest.raises(NotImplementedError):
                b.reverse_complement()
        else:
            assert a.dump_bytes() == b.dump_bytes()
            assert state(a.reverse_complement()) == \
                state(b.reverse_complement())
            assert a.reverse_complement().reverse_complement() == a
    order_t = sorted(range(len(tk)), key=lambda i: tk[i])
    order_j = sorted(range(len(jk)), key=lambda i: jk[i])
    assert [state(tk[i]) for i in order_t] == [state(jk[i]) for i in order_j]
    for i in range(len(tk) - 1):
        a, b = tk[i], tk[i + 1]
        assert (a == b) == (jk[i] == jk[i + 1])
        assert (a < b) == (jk[i] < jk[i + 1])
        if not aa:
            assert (a <= b) == (jk[i] <= jk[i + 1])
    assert len({*tk}) == len({*jk})


def test_kmertypes_errors_match_jax():
    for mod in (tkt, jkt):
        with pytest.raises(ValueError):
            mod.Kmer32bit(15)
        with pytest.raises(ValueError):
            mod.Kmer32bit.from_str("A" * 15)
        with pytest.raises(ValueError):
            mod.Kmer16b32bit.from_str("ACGT")
        with pytest.raises(ValueError):
            mod.Kmer16b32bit.build(5, 15)
        with pytest.raises(ValueError):
            mod.Kmer64bit.from_str("ACGTN")
        with pytest.raises(ValueError):
            mod.KmerAA32bit(7)
        with pytest.raises(ValueError):
            mod.KmerAA64bit.from_str("ACDB")


def test_kmer_type_for_matches_jax():
    for k in range(0, 36):
        try:
            want = jkt.kmer_type_for(k).__name__
        except ValueError:
            with pytest.raises(ValueError):
                tkt.kmer_type_for(k)
            continue
        assert tkt.kmer_type_for(k).__name__ == want


def test_kmer_dump_records_are_the_reference_layouts():
    km = tkt.Kmer64bit.from_str("ACGTACGTACGTACGTACGTA")
    assert km.dump_bytes() == struct.pack("<BQ", 21, km.value)
    km = tkt.Kmer32bit.from_str("GATTACA")
    assert km.dump_bytes() == struct.pack("<I", (7 << 28) | km.word & 0x0FFFFFFF)


# ---------------------------------------------------------------------------
# base/kmer.py, base/nthash.py: host helpers and oracles
# ---------------------------------------------------------------------------

def test_kmer_value_str_round_trip_matches_jax():
    rng = np.random.default_rng(13)
    for k in range(1, 33):
        s = "".join(rng.choice(list("ACGTacgt"), size=k))
        v = tkmer.kmer_value_from_str(s)
        assert v == jkmer.kmer_value_from_str(s)
        assert tkmer.kmer_str_from_value(v, k) == \
            jkmer.kmer_str_from_value(v, k) == s.upper()
    for mod in (tkmer, jkmer):
        with pytest.raises(ValueError):
            mod.kmer_value_from_str("ACGNT")


def test_nthash_seeds_match_jax():
    for b in "ACGT":
        assert getattr(tnth, "SEED_" + b) == int(getattr(jnth, "SEED_" + b))


@pytest.mark.parametrize("k", [1, 5, 21, 32, 63, 64, 65, 70])
def test_nthash_oracles_match_jax_and_the_first_window(k):
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, size=k, dtype=np.uint8)
    f, r = tnth.nthash_init_ref(codes), tnth.nthash_rcomp_init_ref(codes)
    assert f == jnth.nthash_init_ref(codes)
    assert r == jnth.nthash_rcomp_init_ref(codes)
    batch = tseq.pack_codes(codes, device="cpu")
    fh, rh, _, _, valid = tnth.nthash_kmers(batch, k)
    assert bool(valid[0, 0])
    assert int(fh[0, 0]) & M64 == f
    assert int(rh[0, 0]) & M64 == r


# ---------------------------------------------------------------------------
# ops/bitops.py
# ---------------------------------------------------------------------------

AMOUNTS = [0, 1, 31, 32, 33, 63, 64, 65, 127]


def bit_values(nbits: int) -> np.ndarray:
    rng = np.random.default_rng(nbits)
    top = 1 << (nbits - 1)
    fixed = [0, 1, top - 1, top, top + 1, (1 << nbits) - 1]
    if nbits == 32:
        rand = rng.integers(0, 1 << 32, size=12, dtype=np.uint64)
        return np.array(fixed + rand.tolist(), np.uint32)
    rand = rng.integers(0, 1 << 63, size=12, dtype=np.uint64) * np.uint64(2) \
        + np.uint64(1)
    return np.array(fixed + rand.tolist(), np.uint64)


def port_tensor(x: np.ndarray) -> torch.Tensor:
    """The port's carrier of u32 / u64 values: int64."""
    if x.dtype == np.uint32:
        return torch.from_numpy(x.astype(np.int64))
    return torch.from_numpy(x.view(np.int64).copy())


def from_port(t: torch.Tensor, nbits: int) -> np.ndarray:
    a = t.numpy()
    return a.astype(np.uint32) if nbits == 32 else a.view(np.uint64)


BITOPS = [("rotl", 32), ("rotl", 64), ("rotr", 32), ("rotr", 64),
          ("rotl32", 32), ("shl_safe", 32), ("shl_safe", 64),
          ("shr_safe", 32), ("shr_safe", 64)]


def call(mod, name: str, x, r, nbits: int):
    if name == "rotl32":
        return mod.rotl32(x, r)
    return getattr(mod, name)(x, r, nbits)


@pytest.mark.parametrize("name,nbits", BITOPS,
                         ids=[f"{n}-{b}" for n, b in BITOPS])
def test_bitops_match_jax(name, nbits):
    x = bit_values(nbits)
    jx, tx = jnp.asarray(x), port_tensor(x)
    for r in AMOUNTS:                                   # scalar amounts
        want = np.asarray(call(jbit, name, jx, r, nbits))
        got = from_port(call(tbit, name, tx, r, nbits), nbits)
        assert np.array_equal(got, want), (name, nbits, r)
    # a tensor of amounts, one per value
    rs = np.resize(np.array(AMOUNTS, np.int64), x.size)
    want = np.asarray(call(jbit, name, jx, jnp.asarray(rs.astype(x.dtype)),
                           nbits))
    got = from_port(call(tbit, name, tx, torch.from_numpy(rs), nbits), nbits)
    assert np.array_equal(got, want), (name, nbits)


def test_rotl64_rotr64_are_cases_of_rotl_rotr():
    x = port_tensor(bit_values(64))
    r = torch.arange(x.numel(), dtype=torch.int64) * 7
    assert torch.equal(tbit.rotl64(x, r), tbit.rotl(x, r, 64))
    assert torch.equal(tbit.rotr64(x, r), tbit.rotr(x, r, 64))
    assert torch.equal(tbit.rotr64(tbit.rotl64(x, r), r), x)


# ---------------------------------------------------------------------------
# hashed.py
# ---------------------------------------------------------------------------

def test_hashed_ordering_matches_jax():
    rng = np.random.default_rng(17)
    hs = rng.integers(0, 1 << 63, size=40, dtype=np.uint64).tolist()
    hs += hs[:5]                                         # ties
    items = [f"item{i}" for i in range(len(hs))]

    def order(mod):
        hi = sorted(mod.HashedItem(h, it) for h, it in zip(hs, items))
        hc = sorted(mod.HashCount(mod.HashedItem(h, it), c)
                    for c, (h, it) in enumerate(zip(hs, items)))
        ih = sorted(mod.InvHashedItem(h, bool(h & 1)) for h in hs)
        ic = sorted(mod.InvHashCount(mod.InvHashedItem(h), c)
                    for c, h in enumerate(hs))
        return ([(x.hash, x.item) for x in hi],
                [(x.hashed.hash, x.count) for x in hc],
                [(x.hash, x.wide) for x in ih],
                [(x.hashed.hash, x.count) for x in ic])

    assert order(thashed) == order(jhashed)
    assert thashed.HashedItem(3, "a") == thashed.HashedItem(3, "b")


@pytest.mark.parametrize("wide", [False, True])
def test_inv_hashed_recover_matches_jax(wide):
    rng = np.random.default_rng(19)
    if wide:
        vals = rng.integers(0, 1 << 63, size=64, dtype=np.uint64) * \
            np.uint64(2) + np.uint64(1)
        hs = np.asarray(jrng.wang_hash64(jnp.asarray(vals)))
        assert (hs >= np.uint64(1 << 63)).sum() >= 16    # the int64 sign
    else:
        vals = rng.integers(0, 1 << 32, size=64, dtype=np.uint64) \
            .astype(np.uint32)
        hs = np.asarray(jrng.wang_hash32(jnp.asarray(vals)))
    for v, h in zip(vals.tolist(), hs.tolist()):
        got = thashed.InvHashedItem(int(h), wide).recover()
        assert got == jhashed.InvHashedItem(int(h), wide).recover() == v


# ---------------------------------------------------------------------------
# utils.py
# ---------------------------------------------------------------------------

def test_make_equal_groups_matches_jax():
    rng = np.random.default_rng(23)
    for trial in range(50):
        n = int(rng.integers(1, 40))
        blocks = rng.integers(1, 1000, size=n).tolist()
        if trial % 5 == 0:
            blocks[int(rng.integers(n))] = 50_000          # one huge block
        for groups in (1, 2, 3, max(1, n // 2), n, n + 3, 2 * n + 7):
            assert tutils.make_equal_groups(blocks, groups) == \
                jutils.make_equal_groups(blocks, groups)


def test_nbkmer_guesses_match_jax():
    sizes = [0, 1, 10**9, -5]
    for k in range(1, 40):
        sizes += [(1 << k) - 1, 1 << k, (1 << k) + 1]
    for s in sizes:
        assert tutils.get_nbkmer_guess(s) == jutils.get_nbkmer_guess(s)
    rng = np.random.default_rng(29)
    for _ in range(30):
        lens = rng.integers(0, 1 << int(rng.integers(1, 40)),
                            size=int(rng.integers(0, 6))).tolist()
        assert tutils.get_nbkmer_guess_seqs(lens) == \
            jutils.get_nbkmer_guess_seqs(lens)


def test_phase_timer_accumulates(caplog):
    t = tutils.PhaseTimer()
    for _ in range(2):
        with t.phase("ingest"):
            sum(range(20000))
    first = t.elapsed["ingest"]
    with t.phase("ingest"):
        sum(range(20000))
    with t.phase("sketch"):
        pass
    assert t.elapsed["ingest"] > first > 0
    with caplog.at_level(logging.INFO, logger="kmerutils_tpu_torch"):
        rep = t.report()
    assert rep == t.elapsed and set(rep) == {"ingest", "sketch"}
    assert [r.name for r in caplog.records] == ["kmerutils_tpu_torch"] * 2


# ---------------------------------------------------------------------------
# io/fastx.py::load_all
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("native", [True, False])
def test_load_all_matches_jax_in_file_order(tmp_path, monkeypatch, native):
    from kmerutils_tpu_torch.io import native as tnative
    if native and not tnative.available():
        pytest.skip("the native parser did not build here")
    if not native:
        monkeypatch.setattr(tnative, "available", lambda: False)
    rng = np.random.default_rng(31)
    lens = [300, 20, 170, 5, 64, 900, 33]                # not length order
    reads = ["".join(rng.choice(list("ACGT"), size=n)) for n in lens]
    reads[2] = reads[2][:50] + "N" + reads[2][51:]       # dropped
    p = str(tmp_path / "r.fastq")
    tfastx.write_fastq(p, reads)
    jstats, tstats = jfastx.IngestStats(), tfastx.IngestStats()
    jb = jfastx.load_all(p, jstats)
    tb = tfastx.load_all(p, tstats, device="cpu")
    assert np.array_equal(u32(tb.words), np.asarray(jb.words))
    assert tb.lengths.tolist() == [n for i, n in enumerate(lens) if i != 2]
    assert np.array_equal(tb.lengths.numpy(), np.asarray(jb.lengths))
    assert vars(tstats) == vars(jstats)


# ---------------------------------------------------------------------------
# io/native.py: the port's private, locked build of the native library
# ---------------------------------------------------------------------------

def test_native_library_is_the_ports_own_build():
    from kmerutils_tpu_torch.io import native as tnative
    path = tnative.library_path()
    assert os.path.dirname(path) == tnative._BUILD_DIR
    assert os.path.basename(path).startswith("libktpnative_")
    assert not path.endswith(os.path.join("native", "libktpnative.so"))


def test_native_build_failure_leaves_nothing_and_gives_none(tmp_path,
                                                            monkeypatch):
    from kmerutils_tpu_torch.io import native as tnative
    monkeypatch.setattr(tnative, "_BUILD_DIR", str(tmp_path / "b"))
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    path = tnative.library_path()
    assert not tnative._build(path)
    assert os.listdir(tmp_path / "b") == [".lock"]    # no temporary left
    monkeypatch.setattr(tnative, "_tried", False)
    monkeypatch.setattr(tnative, "_lib", None)
    assert not tnative.available()
