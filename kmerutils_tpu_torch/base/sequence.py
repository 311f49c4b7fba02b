"""Sequence storage: the host ``Sequence`` / ``IterSequence`` and the
batched read representation every device function takes.

Port of kmerutils_tpu/base/sequence.py.

* :class:`Sequence` — host numpy, byte-compatible with the reference's
  ``Sequence`` (sequence.rs:14-106): packed bases plus a 2-byte descriptor
  [nb_bits_by_base, nb_bases_in_last_byte].  Used for format parity; never
  on the hot path.  :class:`IterSequence` walks it from both ends.
* :class:`ReadBatch` — a [n_reads, W] tensor of 32-bit words, each holding
  16 consecutive 2-bit bases with the first base in the top bits, plus an
  int32 length vector.  Words are u32 values stored as ``int32`` bit
  patterns.  One zero word of slack is always present at the end of a row
  (W >= ceil(max_len / 16) + 1), so k-mer extraction reads words i+1 and
  i+2 unconditionally.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import alphabet

BASES_PER_WORD = 16


# ---------------------------------------------------------------------------
# host-side reference-compatible Sequence
# ---------------------------------------------------------------------------

class Sequence:
    """Byte-packed sequence with the reference's exact layout.

    2-bit mode packs 4 bases a byte with the first base in bits 7..6
    (sequence.rs:48-72), the partial last byte padded with 'A'.  4-bit
    mode packs 2 bases a byte, padded with 'Z' = 0 (sequence.rs:75-92).
    8-bit is raw.
    """

    __slots__ = ("seq", "nb_bits", "nb_bases")

    def __init__(self, raw: bytes | np.ndarray, nb_bits: int = 2):
        raw = np.frombuffer(bytes(raw), dtype=np.uint8) if isinstance(
            raw, (bytes, bytearray)) else np.asarray(raw, dtype=np.uint8)
        self.nb_bits = nb_bits
        self.nb_bases = int(raw.size)
        if nb_bits == 8:
            self.seq = raw.copy()
        elif nb_bits == 2:
            codes = alphabet.encode_2b(raw)
            if (codes == 0xFF).any():
                raise ValueError("non-ACGT base in 2-bit sequence")
            pad = (-self.nb_bases) % 4
            codes = np.concatenate([codes, np.zeros(pad, dtype=np.uint8)])
            c = codes.reshape(-1, 4).astype(np.uint8)
            self.seq = ((c[:, 0] << 6) | (c[:, 1] << 4) | (c[:, 2] << 2)
                        | c[:, 3])
        elif nb_bits == 4:
            codes = alphabet.encode_4b(raw)
            if (codes == 0xFF).any():
                raise ValueError("invalid base in 4-bit sequence")
            pad = (-self.nb_bases) % 2
            codes = np.concatenate([codes, np.zeros(pad, dtype=np.uint8)])
            c = codes.reshape(-1, 2)
            self.seq = (c[:, 0] << 4) | c[:, 1]
        else:
            raise ValueError("nb_bits must be 2, 4 or 8")

    @property
    def description(self):
        """The descriptor bytes (nb_bits, bases in the last byte)."""
        per = 8 // self.nb_bits
        return (self.nb_bits, self.nb_bases % per)

    def size(self) -> int:
        """Logical number of bases."""
        return self.nb_bases

    def get_base(self, pos: int) -> int:
        """Encoded base at ``pos``."""
        nb = self.nb_bits
        if nb == 8:
            return int(self.seq[pos])
        per = 8 // nb
        byte = self.seq[pos // per]
        off = nb * (pos % per)
        return (byte >> (8 - off - nb)) & ((1 << nb) - 1)

    def codes(self) -> np.ndarray:
        """All encoded bases as a dense uint8 vector."""
        nb = self.nb_bits
        if nb == 8:
            return self.seq.copy()
        b = self.seq
        if nb == 2:
            out = np.empty(b.size * 4, dtype=np.uint8)
            out[0::4] = b >> 6
            out[1::4] = (b >> 4) & 3
            out[2::4] = (b >> 2) & 3
            out[3::4] = b & 3
            return out[: self.nb_bases]
        out = np.empty(b.size * 2, dtype=np.uint8)
        out[0::2] = b >> 4
        out[1::2] = b & 0x0F
        return out[: self.nb_bases]

    def decompress(self) -> bytes:
        """ASCII bases."""
        if self.nb_bits == 8:
            return self.seq.tobytes()
        dec = alphabet.decode_2b if self.nb_bits == 2 else alphabet.decode_4b
        return dec(self.codes()).tobytes()

    def reverse_complement(self) -> "Sequence":
        """Reverse complement in the same packing (sequence.rs:252-315)."""
        if self.nb_bits == 2:
            rc = alphabet.complement_2b(self.codes())[::-1]
            return Sequence(alphabet.decode_2b(rc), 2)
        if self.nb_bits == 8:
            comp = {65: 84, 67: 71, 71: 67, 84: 65, 78: 78}
            return Sequence(bytes(comp.get(b, b) for b in self.seq[::-1]), 8)
        rc = alphabet.COMPLEMENT_4B[self.codes()][::-1]
        return Sequence(alphabet.decode_4b(rc), 4)


class IterSequence:
    """Forward and backward base iterator over a :class:`Sequence`, with
    range restriction (the reference's IterSequence, sequence.rs:499-722).
    ``decode=True`` yields ASCII bases instead of codes."""

    __slots__ = ("_codes", "_decode", "_front", "_back", "_table")

    def __init__(self, seq: Sequence, decode: bool = False):
        self._codes = seq.codes()
        self._decode = decode
        self._table = {2: alphabet.DECODE_2B, 4: alphabet.DECODE_4B,
                       8: None}[seq.nb_bits]
        self._front = 0
        self._back = seq.size()

    def set_range(self, begin: int, end: int) -> None:
        if not 0 <= begin < end <= self._codes.size:
            raise ValueError("bad range for IterSequence")
        self._front = begin
        self._back = end

    def _emit(self, code: int):
        if self._decode and self._table is not None:
            return int(self._table[code])
        return int(code)

    def __iter__(self):
        return self

    def __next__(self):
        v = self.next()
        if v is None:
            raise StopIteration
        return v

    def next(self):
        """Forward step; None when exhausted."""
        if self._front >= self._back:
            return None
        c = self._codes[self._front]
        self._front += 1
        return self._emit(c)

    def next_back(self):
        """Backward step from the end of the range; None when exhausted."""
        if self._back <= self._front:
            return None
        self._back -= 1
        return self._emit(self._codes[self._back])


# ---------------------------------------------------------------------------
# device-side batched representation
# ---------------------------------------------------------------------------

def _shifts(dtype, device) -> torch.Tensor:
    """The bit offset of each base of a word, made on ``device`` (a copy
    from host memory would wait for the device's queue)."""
    return 30 - 2 * torch.arange(BASES_PER_WORD, dtype=dtype, device=device)


@dataclasses.dataclass(frozen=True)
class ReadBatch:
    """words int32[n, W] (u32 bit patterns), lengths int32[n]; both on one
    device.  Padding bases are 0 ('A') and masked through ``lengths``.

    ``host_lengths``, the same lengths in host memory, is kept by
    :meth:`to` when the batch was moved from the host, so that a caller
    can size what depends on the lengths without reading the device
    (count/stream.batch_entries); None otherwise."""

    words: torch.Tensor
    lengths: torch.Tensor
    host_lengths: torch.Tensor | None = None

    @property
    def device(self) -> torch.device:
        return self.words.device

    @property
    def n_reads(self) -> int:
        return self.words.shape[0]

    @property
    def max_len(self) -> int:
        """Usable base capacity of a row, excluding the slack word."""
        return (self.words.shape[1] - 1) * BASES_PER_WORD

    def to(self, device, non_blocking: bool = False) -> "ReadBatch":
        host = (self.lengths if self.lengths.device.type == "cpu"
                else self.host_lengths)
        return ReadBatch(self.words.to(device, non_blocking=non_blocking),
                         self.lengths.to(device, non_blocking=non_blocking),
                         host)

    def codes(self) -> torch.Tensor:
        """Per-base 2-bit codes, uint8[n_reads, W * 16]."""
        # the arithmetic shift's sign fill is masked off by the & 3
        c = (self.words[:, :, None] >> _shifts(torch.int32, self.device)) & 3
        return c.reshape(self.n_reads, -1).to(torch.uint8)

    def valid_mask(self) -> torch.Tensor:
        """bool[n_reads, W * 16]: True where a real base exists."""
        pos = torch.arange(self.words.shape[1] * BASES_PER_WORD,
                           dtype=torch.int32, device=self.device)
        return pos[None, :] < self.lengths[:, None]


def pack_words(codes: np.ndarray, lengths: np.ndarray | None = None,
               min_words: int | None = None):
    """Host packing: codes uint8[n, L] -> (words uint32[n, W], lengths
    int32[n]), with W = ceil(L / 16) + 1 (the slack word), or
    ``min_words`` if that is more."""
    codes = np.asarray(codes, dtype=np.uint8)
    if codes.ndim == 1:
        codes = codes[None, :]
    n, L = codes.shape
    if lengths is None:
        lengths = np.full(n, L, dtype=np.int32)
    else:
        lengths = np.asarray(lengths, dtype=np.int32)
        codes = np.where(np.arange(L)[None, :] < lengths[:, None], codes, 0)
    n_words = -(-L // BASES_PER_WORD) + 1  # +1 slack word
    if min_words is not None:
        n_words = max(n_words, min_words)
    padded = np.zeros((n, n_words * BASES_PER_WORD), dtype=np.uint8)
    padded[:, :L] = codes
    c = padded.reshape(n, n_words, BASES_PER_WORD).astype(np.uint32)
    shifts = 30 - 2 * np.arange(BASES_PER_WORD, dtype=np.uint32)
    words = np.bitwise_or.reduce(c << shifts[None, None, :], axis=2)
    return words.astype(np.uint32), lengths


def batch_from_numpy(words: np.ndarray, lengths: np.ndarray,
                     device="cuda") -> ReadBatch:
    """ReadBatch from host words uint32[n, W] and lengths int32[n]."""
    w = torch.from_numpy(np.ascontiguousarray(words, np.uint32).view(np.int32))
    ln = torch.from_numpy(np.ascontiguousarray(lengths, np.int32))
    return ReadBatch(w, ln).to(device)


def pack_codes(codes: np.ndarray, lengths: np.ndarray | None = None,
               min_words: int | None = None, device="cuda") -> ReadBatch:
    """Pack per-base 2-bit codes [n_reads, max_len] (numpy) into a ReadBatch
    on ``device``; positions at or past a read's length are zeroed, and a
    row holds at least ``min_words`` words."""
    words, lengths = pack_words(codes, lengths, min_words)
    return batch_from_numpy(words, lengths, device)


def pack_ascii_reads(reads, min_words: int | None = None,
                     device="cuda") -> ReadBatch:
    """Pack ASCII reads (bytes/str); a non-ACGT base raises — ingest
    (io/fastx.py) drops such reads before packing."""
    arrs = []
    for r in reads:
        if isinstance(r, str):
            r = r.encode()
        a = alphabet.encode_2b(np.frombuffer(bytes(r), dtype=np.uint8))
        if (a == 0xFF).any():
            raise ValueError("non-ACGT base in read; filter before packing")
        arrs.append(a)
    L = max((a.size for a in arrs), default=0)
    codes = np.zeros((len(arrs), L), dtype=np.uint8)
    lengths = np.zeros(len(arrs), dtype=np.int32)
    for i, a in enumerate(arrs):
        codes[i, : a.size] = a
        lengths[i] = a.size
    return pack_codes(codes, lengths, min_words, device=device)


def revcomp_batch(batch: ReadBatch) -> ReadBatch:
    """Reverse complement of every read, on the batch's device: base j of
    read r becomes the complement of base lengths[r] - 1 - j; the padding
    stays 0 and the lengths are the batch's."""
    comp = 3 - batch.codes()
    L = comp.shape[1]
    pos = torch.arange(L, dtype=torch.int64, device=batch.device)[None, :]
    lengths = batch.lengths.to(torch.int64)[:, None]
    src = (lengths - 1 - pos).clamp(0, L - 1)
    rc = torch.where(pos < lengths, torch.gather(comp, 1, src), 0)
    c = rc.reshape(batch.n_reads, -1, BASES_PER_WORD).to(torch.int64)
    # the codes hold disjoint bits, so the sum is their OR
    words = (c << _shifts(torch.int64, batch.device)).sum(dim=2)
    words = words.to(torch.int32)
    return ReadBatch(words, batch.lengths)
