"""Range-restricted sketches of single sequences.

Port of kmerutils_tpu/sketch/seqminhash.py: ``sketch_seqrange_superminhash``
and ``sketch_seqrange_minhash`` sketch the canonical k-mers of each read
that lie in the base range [start, end), through the 32-bit Wang hash; k is
16 or 9..14.  The range is a mask over k-mer starts: k-mer p takes part iff
start <= p and p + k <= end.  SuperMinHash goes through the grid kernel G1
on the card (sketch/superminhash.py); runs on the batch's device.
"""

from __future__ import annotations

import torch

from ..base import kmer as kmer_mod
from ..base.sequence import ReadBatch
from ..ops.rng import wang_hash32
from . import minhash, superminhash


def _range_items(batch: ReadBatch, start: int, end: int, kmer_size: int):
    if not 9 <= kmer_size <= 16 or kmer_size == 15:
        raise ValueError(
            "kmer_size must be 16 or 9..=14 (seqminhash.rs:33-62 dispatch; "
            "15 has no reference kmer type)")
    km, valid = kmer_mod.kmers_u32(batch, kmer_size)
    can, _ = kmer_mod.canonical_u32(km, kmer_size)
    pos = torch.arange(km.shape[1], dtype=torch.int32,
                       device=km.device)[None, :]
    valid = valid & (pos >= start) & (pos + kmer_size <= end)
    return wang_hash32(can), valid


def sketch_seqrange_superminhash(batch: ReadBatch, start: int, end: int,
                                 kmer_size: int, sketch_size: int,
                                 seed: int = 0) -> torch.Tensor:
    """SuperMinHash (float64 signature, [n, sketch_size]) of the k-mers in
    [start, end) of every read of ``batch``."""
    items, valid = _range_items(batch, start, end, kmer_size)
    sig, _ = superminhash.superminhash(items, valid, sketch_size, seed)
    return sig


def sketch_seqrange_minhash(batch: ReadBatch, start: int, end: int,
                            kmer_size: int, sketch_size: int):
    """Bottom-``sketch_size`` invertible MinHash with counts of the k-mers
    in [start, end): (hashes int64 [n, size] SENTINEL-padded, counts int32
    [n, size])."""
    items, valid = _range_items(batch, start, end, kmer_size)
    return minhash.bottomk_sketch(items, valid, sketch_size)
