"""The batched read representation every device function takes.

Port of ``ReadBatch`` / ``pack_codes`` / ``pack_ascii_reads`` of
kmerutils_tpu/base/sequence.py: a [n_reads, W] tensor of 32-bit words, each
holding 16 consecutive 2-bit bases with the first base in the top bits, plus
an int32 length vector.  Words are u32 values stored as ``int32`` bit
patterns.  One zero word of slack is always present at the end of a row
(W >= ceil(max_len / 16) + 1), so k-mer extraction reads words i+1 and i+2
unconditionally.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import alphabet

BASES_PER_WORD = 16


@dataclasses.dataclass(frozen=True)
class ReadBatch:
    """words int32[n, W] (u32 bit patterns), lengths int32[n]; both on one
    device.  Padding bases are 0 ('A') and masked through ``lengths``."""

    words: torch.Tensor
    lengths: torch.Tensor

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
        return ReadBatch(self.words.to(device, non_blocking=non_blocking),
                         self.lengths.to(device, non_blocking=non_blocking))


def pack_words(codes: np.ndarray, lengths: np.ndarray | None = None):
    """Host packing: codes uint8[n, L] -> (words uint32[n, W], lengths
    int32[n]), with W = ceil(L / 16) + 1 (the slack word)."""
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
               device="cuda") -> ReadBatch:
    """Pack per-base 2-bit codes [n_reads, max_len] (numpy) into a ReadBatch
    on ``device``; positions at or past a read's length are zeroed."""
    words, lengths = pack_words(codes, lengths)
    return batch_from_numpy(words, lengths, device)


def pack_ascii_reads(reads, device="cuda") -> ReadBatch:
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
    return pack_codes(codes, lengths, device=device)
