"""Quality handling: Phred remap to 3 bits and wavelet-matrix storage.

Port of kmerutils_tpu/quality/quality.py.  This is host code (numpy and the
native wavelet builder); nothing here touches the device.

* ``remap_quality8``: q > 0x37 -> 7, q < 0x25 -> 0, else
  1 + floor((q - 0x25) * 6 / 18), as a 256-entry table;
* ``quality_to_proba``: the error probability of a quality byte;
* :class:`WaveletMatrix`: rank and access over the 3-bit symbols, about 3
  bits a symbol plus the rank directories;
* :class:`QSequenceWM` / :class:`QSequenceRaw` (one read) and
  :class:`QualityStore` (every read in one matrix, with offsets), and the
  FASTQ loaders ``load_quality_wm`` / ``load_quality_store``.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def quality_to_proba(q, qmin: int = 0x25):
    """Probability of error of quality byte(s) q."""
    q = np.asarray(q, dtype=np.float64)
    return np.power(10.0, (qmin - q) / 10.0)


def _remap_lut() -> np.ndarray:
    q = np.arange(256, dtype=np.int32)
    mid = 1 + ((np.minimum(q, 0x37) - 0x25) * 6 // 18)
    return np.where(q > 0x37, 7, np.where(q < 0x25, 0, mid)).astype(np.uint8)


_REMAP_LUT = _remap_lut()


def remap_quality8(q) -> np.ndarray:
    """Quality bytes -> 3-bit symbols (uint8), through the table."""
    return _REMAP_LUT[np.asarray(q, dtype=np.uint8)]


def _popcounts(words: np.ndarray) -> np.ndarray:
    x = words.copy()
    x = x - ((x >> np.uint64(1)) & np.uint64(0x5555555555555555))
    x = (x & np.uint64(0x3333333333333333)) \
        + ((x >> np.uint64(2)) & np.uint64(0x3333333333333333))
    x = (x + (x >> np.uint64(4))) & np.uint64(0x0F0F0F0F0F0F0F0F)
    return ((x * np.uint64(0x0101010101010101)) >> np.uint64(56)) \
        .astype(np.int64)


class _BitVecRank:
    """Bit vector with O(1) rank1 through a two-level directory: a u32
    count before each 8-word (512-bit) superblock and a u16 count before
    each word within its superblock (up to 448, so u8 would wrap)."""

    __slots__ = ("n", "words", "sup", "sub")

    def __init__(self, bits: np.ndarray):
        self.n = bits.size
        pad = (-bits.size) % 64
        b = np.concatenate([bits, np.zeros(pad, dtype=bool)])
        w = np.packbits(b.reshape(-1, 8)[:, ::-1], axis=1)  # LSB first
        self.words = w.reshape(-1, 8).view(np.uint64).ravel()
        pops = _popcounts(self.words)
        nw = self.words.size
        nsup = -(-nw // 8)
        padded = np.zeros(nsup * 8, dtype=np.int64)
        padded[:nw] = pops
        per_sup = padded.reshape(nsup, 8)
        within = np.cumsum(per_sup, axis=1) - per_sup
        self.sub = within.astype(np.uint16).ravel()[:nw]
        self.sup = np.concatenate(
            [[0], np.cumsum(per_sup.sum(axis=1))]).astype(np.uint32)

    @classmethod
    def _from_parts(cls, n: int, words: np.ndarray, sup: np.ndarray,
                    sub: np.ndarray) -> "_BitVecRank":
        """Adopt directories built by native/wavelet.cpp."""
        bv = cls.__new__(cls)
        bv.n, bv.words, bv.sup, bv.sub = n, words, sup, sub
        return bv

    def rank1(self, pos) -> np.ndarray:
        """Number of ones in [0, pos), vectorized over pos."""
        pos = np.asarray(pos, dtype=np.int64)
        wi = pos >> 6
        off = pos & 63
        in_range = wi < len(self.words)
        wic = np.minimum(wi, len(self.words) - 1)
        head = self.sup[np.minimum(wi >> 3, len(self.sup) - 1)] \
            .astype(np.int64) + self.sub[wic]
        # both np.where branches evaluate: keep the shift in [0, 63] (a
        # shift by 64 is undefined in C and numpy's result then varies)
        shift = (np.uint64(64) - off.astype(np.uint64)) & np.uint64(63)
        mask = np.where(off == 0, np.uint64(0), (~np.uint64(0)) >> shift)
        partial = _popcounts(np.atleast_1d(self.words[wic] & mask))
        total = int(self.sup[-1]) if len(self.words) else 0
        return np.where(in_range, head + partial, total)

    def get(self, pos) -> np.ndarray:
        pos = np.asarray(pos, dtype=np.int64)
        return ((self.words[pos >> 6] >> (pos & 63).astype(np.uint64))
                & np.uint64(1)).astype(bool)


class WaveletMatrix:
    """Wavelet matrix over small-alphabet symbols (3 bits by default):
    access (``lookup``), ``rank`` and ``len``."""

    # below this, the numpy build's fixed cost beats the ctypes round trip
    _NATIVE_MIN = 1 << 14

    def __init__(self, values, bit_len: int = 3):
        v = np.asarray(values)
        self.n = v.size
        self._bit_len = bit_len
        self.levels: list[_BitVecRank] = []
        self.zeros: list[int] = []
        if v.size >= self._NATIVE_MIN and bit_len <= 8:
            from ..io import native
            parts = native.wavelet_build(
                v if v.dtype == np.uint8 else v.astype(np.uint8), bit_len)
            if parts is not None:
                words, sub, sup, zeros = parts
                for d in range(bit_len):
                    self.levels.append(_BitVecRank._from_parts(
                        v.size, words[d], sup[d], sub[d]))
                    self.zeros.append(int(zeros[d]))
                return
        cur = v.astype(np.uint64)
        for lvl in range(bit_len - 1, -1, -1):
            bits = ((cur >> np.uint64(lvl)) & np.uint64(1)).astype(bool)
            self.levels.append(_BitVecRank(bits))
            self.zeros.append(int((~bits).sum()))
            cur = np.concatenate([cur[~bits], cur[bits]])  # stable partition

    def __len__(self):
        return self.n

    def bit_len(self) -> int:
        return self._bit_len

    def lookup(self, idx) -> np.ndarray:
        """The symbols at position(s) idx (uint64)."""
        idx = np.atleast_1d(np.asarray(idx, dtype=np.int64)).copy()
        out = np.zeros(idx.shape, dtype=np.uint64)
        for d, bv in enumerate(self.levels):
            bit = bv.get(idx)
            out |= bit.astype(np.uint64) << np.uint64(self._bit_len - 1 - d)
            r1 = bv.rank1(idx)
            idx = np.where(bit, self.zeros[d] + r1, idx - r1)
        return out

    def access_all(self) -> np.ndarray:
        return self.lookup(np.arange(self.n))

    def rank(self, symbol: int, pos: int) -> int:
        """Occurrences of ``symbol`` in [0, pos)."""
        lo, hi = 0, int(pos)
        for d, bv in enumerate(self.levels):
            bit = (symbol >> (self._bit_len - 1 - d)) & 1
            rlo = int(np.ravel(bv.rank1(lo))[0])
            rhi = int(np.ravel(bv.rank1(hi))[0])
            if bit:
                lo, hi = self.zeros[d] + rlo, self.zeros[d] + rhi
            else:
                lo, hi = lo - rlo, hi - rhi
        return hi - lo

    def memory_bits(self) -> int:
        return sum(bv.words.size * 64 + bv.sup.size * 32 + bv.sub.size * 16
                   for bv in self.levels)


@dataclasses.dataclass
class QSequenceRaw:
    """The remapped quality of one read, uncompressed."""
    read_num: int
    qseq: np.ndarray  # remapped uint8 symbols

    def to_wm(self) -> "QSequenceWM":
        return QSequenceWM(self.read_num, raw_remapped=self.qseq)


class QSequenceWM:
    """The remapped quality of one read in its own wavelet matrix."""

    def __init__(self, read_num: int, qv=None, raw_remapped=None):
        self.read_num = read_num
        if raw_remapped is None:
            raw_remapped = remap_quality8(np.asarray(qv, dtype=np.uint8))
        self.qseq = WaveletMatrix(raw_remapped, bit_len=3)

    def __len__(self):
        return len(self.qseq)

    def decompress(self) -> QSequenceRaw:
        return QSequenceRaw(self.read_num,
                            self.qseq.access_all().astype(np.uint8))

    def bit_len(self) -> int:
        return self.qseq.bit_len()


class _StoreReadQseq:
    """One read of a :class:`QualityStore` with the lookup surface of a
    per-read WaveletMatrix (what QualityServer uses)."""

    __slots__ = ("_store", "_base", "_n")

    def __init__(self, store: "QualityStore", base: int, n: int):
        self._store = store
        self._base = base
        self._n = n

    def __len__(self):
        return self._n

    def lookup(self, idx):
        idx = np.asarray(idx, dtype=np.int64)
        return self._store.wm.lookup(idx + self._base)

    def bit_len(self):
        return self._store.wm.bit_len()


class _StoreReadView:
    """A :class:`QSequenceWM` look-alike backed by a QualityStore slice."""

    __slots__ = ("read_num", "qseq", "_n")

    def __init__(self, store: "QualityStore", read_num: int):
        base = int(store.offsets[read_num])
        self._n = int(store.offsets[read_num + 1]) - base
        self.read_num = read_num
        self.qseq = _StoreReadQseq(store, base, self._n)

    def __len__(self):
        return self._n

    def decompress(self) -> QSequenceRaw:
        return QSequenceRaw(
            self.read_num,
            self.qseq.lookup(np.arange(self._n)).astype(np.uint8))

    def bit_len(self):
        return self.qseq.bit_len()


class QualityStore:
    """Every read's remapped quality in ONE wavelet matrix, plus offsets.

    Indexed like a list of per-read :class:`QSequenceWM`; each item has
    the same decompress() / qseq.lookup surface, so QualityServer serves
    either.  One vectorized build over the whole file instead of one small
    build per read, and the rank directories are shared."""

    def __init__(self, remapped: np.ndarray, offsets: np.ndarray):
        self.wm = WaveletMatrix(remapped, bit_len=3)
        self.offsets = np.asarray(offsets, np.int64)

    def __len__(self):
        return len(self.offsets) - 1

    def __getitem__(self, read_num: int) -> _StoreReadView:
        if not 0 <= read_num < len(self):
            raise IndexError(read_num)
        return _StoreReadView(self, read_num)

    def memory_bits(self) -> int:
        return self.wm.memory_bits() + self.offsets.size * 64


def _native_quals():
    """The native parser's binding, or None (the Python parser then)."""
    from ..io import native
    return native if native.available() else None


def _iter_fastq_quals(fname: str):
    """Quality lines of every record through the Python parser (it takes
    wrapped FASTQ); importing it brings in torch, so only here."""
    from ..io import fastx
    for _rid, _seq, qual in fastx.iter_fastx(fname):
        if qual is None:
            raise ValueError("FASTA file has no qualities")
        yield np.frombuffer(qual, dtype=np.uint8)


def load_quality_store(fname: str, max_reads: int | None = None
                       ) -> QualityStore:
    """FASTQ -> :class:`QualityStore`: one wavelet build over the
    concatenated remapped qualities of every read (the first ``max_reads``
    when given).  4-line FASTQ goes through the native parser; wrapped
    records fall back to the Python parser."""
    chunks: list = []
    lens = [0]
    native = _native_quals()
    if native is not None:
        try:
            done = False
            for quals, offsets in native.iter_quality_blocks(fname):
                take = len(offsets) - 1
                if max_reads is not None:
                    take = min(take, max_reads - (len(lens) - 1))
                    done = take < len(offsets) - 1
                chunks.append(remap_quality8(quals[:offsets[take]]))
                lens.extend(np.diff(offsets[:take + 1]).tolist())
                if done:
                    break
            return QualityStore(
                np.concatenate(chunks) if chunks else np.zeros(0, np.uint8),
                np.cumsum(np.asarray(lens, np.int64)))
        except ValueError:
            chunks, lens = [], [0]      # wrapped or odd FASTQ
    for i, q in enumerate(_iter_fastq_quals(fname)):
        chunks.append(remap_quality8(q))
        lens.append(q.size)
        if max_reads is not None and i + 1 >= max_reads:
            break
    return QualityStore(
        np.concatenate(chunks) if chunks else np.zeros(0, np.uint8),
        np.cumsum(np.asarray(lens, np.int64)))


def load_quality_wm(fname: str, max_reads: int | None = None
                    ) -> list[QSequenceWM]:
    """FASTQ -> one :class:`QSequenceWM` per read (the first ``max_reads``
    when given), through the native parser for 4-line FASTQ and the Python
    parser for wrapped records."""
    out: list[QSequenceWM] = []
    native = _native_quals()
    if native is not None:
        try:
            for quals, offsets in native.iter_quality_blocks(fname):
                for r in range(len(offsets) - 1):
                    out.append(QSequenceWM(
                        len(out), qv=quals[offsets[r]: offsets[r + 1]]))
                    if max_reads is not None and len(out) >= max_reads:
                        return out
            return out
        except ValueError:
            out = []                    # wrapped or odd FASTQ
    for i, q in enumerate(_iter_fastq_quals(fname)):
        out.append(QSequenceWM(i, qv=q))
        if max_reads is not None and len(out) >= max_reads:
            break
    return out
