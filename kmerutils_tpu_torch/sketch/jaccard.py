"""k-mer hashing for the sketchers and the algorithm-dispatched Sketcher.

Port of the PROB3A path of kmerutils_tpu/sketch/jaccard.py.  The item of a
k-mer is the invertible Wang hash of its canonical value: u32 items (int32
bit patterns) for k <= 16, u64 items (int64 bit patterns) for
17 <= k <= 32.
"""

from __future__ import annotations

import dataclasses

import torch

from ..base import kmer as kmer_mod
from ..base.sequence import ReadBatch
from ..ops.bitops import u32_to_i32
from ..ops.rng import wang_hash32, wang_hash64
from . import probminhash
from .params import SeqSketcherParams, SketchAlgo


def hashed_kmers(batch: ReadBatch, k: int):
    """(items [n, P], valid bool[n, P]): Wang hashes of the canonical
    k-mers; int32 (u32) items for k <= 16, int64 (u64) items above."""
    can, valid, _ = kmer_mod.canonical_kmers(batch, k)
    if k <= 16:
        return u32_to_i32(wang_hash32(can)), valid
    return wang_hash64(can), valid


@dataclasses.dataclass(frozen=True)
class Sketcher:
    """Per-read sequence sketcher.  ``sketch_batch`` runs on the batch's
    device; only ProbMinHash (PROB3A) is ported so far."""

    params: SeqSketcherParams

    def sketch_batch(self, batch: ReadBatch) -> torch.Tensor:
        """Signatures [n_reads, sketch_size]: int32 (u32) for k <= 16,
        int64 (u64) above."""
        algo = self.params.algo
        if algo != SketchAlgo.PROB3A:
            raise NotImplementedError(
                f"{algo.value} sketches are not ported yet "
                "(ROADMAP.md Queue 1 item 11: the other sketchers)")
        items, valid = hashed_kmers(batch, self.params.kmer_size)
        return probminhash.probminhash_from_items(
            items, valid, self.params.sketch_size)[0]

    def jaccard(self, sig_a: torch.Tensor, sig_b: torch.Tensor):
        return probminhash.probjaccard_pair(sig_a, sig_b)
