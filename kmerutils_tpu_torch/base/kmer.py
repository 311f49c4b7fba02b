"""Batched k-mer extraction and canonicalization (shift-window closed form).

Port of kmerutils_tpu/base/kmer.py.  With reads packed 16 bases per word
(first base in the top bits), the 32-bit window starting at base p = 16i + j
is ``(w[i] << 2j) | (w[i+1] >> (32 - 2j))`` and the k-mer is that window
shifted right by 32 - 2k; k > 16 uses a 64-bit window built from three words.
Every k-mer of every read comes out of one broadcast over [n, W-1, 16] —
no gathers.  Values are bit-identical to the JAX package's.

u32 k-mers come back as int64 values in [0, 2^32), u64 k-mers as int64 bit
patterns (ops/bitops.py).
"""

from __future__ import annotations

import torch

from ..ops.bitops import M32, lt_u64, revcomp_u32, revcomp_u64, shr64, \
    flip64
from .sequence import BASES_PER_WORD, ReadBatch


def _valid(batch: ReadBatch, k: int, P: int) -> torch.Tensor:
    pos = torch.arange(P, dtype=torch.int32, device=batch.device)[None, :]
    return pos + k <= batch.lengths[:, None]


def kmers_u32(batch: ReadBatch, k: int):
    """All k-mers (1 <= k <= 16) of every read.

    Returns (kmers int64[n, P] holding u32 values, valid bool[n, P]) with
    P = max(max_len - k + 1, 1); position p is valid iff p + k <= length.
    """
    if not 1 <= k <= 16:
        raise ValueError("kmers_u32 requires 1 <= k <= 16")
    w = batch.words.to(torch.int64) & M32
    P = max(batch.max_len - k + 1, 1)
    j2 = 2 * torch.arange(BASES_PER_WORD, dtype=torch.int64,
                          device=w.device)[None, None, :]
    # j2 == 0 shifts the next word right by 32: an int64 carrier gives 0
    win = ((w[:, :-1, None] << j2) | (w[:, 1:, None] >> (32 - j2))) & M32
    kmers = win.reshape(w.shape[0], -1)[:, :P] >> (32 - 2 * k)
    return kmers, _valid(batch, k, P)


def kmers_u64(batch: ReadBatch, k: int):
    """All k-mers (1 <= k <= 32) as u64 bit patterns in int64, from a 64-bit
    window over three consecutive words."""
    if not 1 <= k <= 32:
        raise ValueError("kmers_u64 requires 1 <= k <= 32")
    w = batch.words.to(torch.int64) & M32
    n = w.shape[0]
    P = max(batch.max_len - k + 1, 1)
    # third word: the slack-padded rows shifted left by two words, zero fill
    w2 = torch.nn.functional.pad(w[:, 2:], (0, 2))[:, :-1, None]
    d = (w[:, :-1, None] << 32) | w[:, 1:, None]
    j2 = 2 * torch.arange(BASES_PER_WORD, dtype=torch.int64,
                          device=w.device)[None, None, :]
    win = ((d << j2) | (w2 >> (32 - j2))).reshape(n, -1)
    kmers = shr64(win[:, :P], 64 - 2 * k)
    return kmers, _valid(batch, k, P)


def canonical_u32(kmers: torch.Tensor, k: int):
    """(min(kmer, revcomp), strand uint8) — strand 1 when the reverse
    complement is strictly smaller."""
    rc = revcomp_u32(kmers, k)
    return torch.minimum(kmers, rc), (rc < kmers).to(torch.uint8)


def canonical_u64(kmers: torch.Tensor, k: int):
    """:func:`canonical_u32` for u64 bit patterns (unsigned order)."""
    rc = revcomp_u64(kmers, k)
    strand = lt_u64(rc, kmers)
    can = flip64(torch.minimum(flip64(kmers), flip64(rc)))
    return can, strand.to(torch.uint8)


def canonical_kmers(batch: ReadBatch, k: int):
    """Extract + canonicalize: (can, valid, strand); the u32 path when
    k <= 16."""
    if k <= 16:
        km, valid = kmers_u32(batch, k)
        can, strand = canonical_u32(km, k)
    else:
        km, valid = kmers_u64(batch, k)
        can, strand = canonical_u64(km, k)
    return can, valid, strand


def kmer_coordinates(batch: ReadBatch, k: int, read_num_offset: int = 0):
    """(read_num, pos) of every k-mer slot, u32 values in int64[n, P]
    (broadcast views): read_num = row + read_num_offset, pos = slot."""
    P = max(batch.max_len - k + 1, 1)
    n = batch.n_reads
    rows = torch.arange(n, dtype=torch.int64, device=batch.device)
    read_num = ((rows + read_num_offset) & M32)[:, None]
    pos = torch.arange(P, dtype=torch.int64, device=batch.device)[None, :]
    return read_num.expand(n, P), pos.expand(n, P)
