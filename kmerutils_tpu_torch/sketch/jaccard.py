"""k-mer hashing for the sketchers and the algorithm-dispatched Sketcher.

Port of the PROB3A path of kmerutils_tpu/sketch/jaccard.py.  The item of a
k-mer is the invertible Wang hash of its canonical value: u32 items (int32
bit patterns) for k <= 16, u64 items (int64 bit patterns) for
17 <= k <= 32.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..base import kmer as kmer_mod
from ..base.sequence import ReadBatch
from ..count import exact
from ..ops.bitops import M32, u32_to_i32
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


def hashed_weighted_kmers(batch: ReadBatch, k: int):
    """(items, weights int32, valid): the items of :func:`hashed_kmers` with
    the within-read multiplicity of each position's canonical k-mer."""
    items, valid = hashed_kmers(batch, k)
    weights, _ = exact.multiplicity_per_slot(batch, k)
    return items, weights, valid


def _require_prob3a(algo: SketchAlgo) -> None:
    if algo != SketchAlgo.PROB3A:
        raise NotImplementedError(
            f"{algo.value} sketches are not ported yet "
            "(ROADMAP.md Queue 1 item 11: the other sketchers)")


@dataclasses.dataclass(frozen=True)
class Sketcher:
    """Sequence sketcher; runs on the batch's device.  Only ProbMinHash
    (PROB3A) is ported so far."""

    params: SeqSketcherParams

    def sketch_batch(self, batch: ReadBatch) -> torch.Tensor:
        """Signatures [n_reads, sketch_size]: int32 (u32) for k <= 16,
        int64 (u64) above."""
        _require_prob3a(self.params.algo)
        items, valid = hashed_kmers(batch, self.params.kmer_size)
        return probminhash.probminhash_from_items(
            items, valid, self.params.sketch_size)[0]

    def sketch_collection(self, batch: ReadBatch) -> torch.Tensor:
        """One signature int64[sketch_size] (u64 bit patterns) for all reads
        of the batch together: the batch's items are counted exactly
        (count/exact.count_from_values) and the distinct items, weighted by
        their counts, go through the u64 tournament as one row."""
        _require_prob3a(self.params.algo)
        items, valid = hashed_kmers(batch, self.params.kmer_size)
        if items.dtype == torch.int32:
            items = items.to(torch.int64) & M32
        kc = exact.count_from_values(
            torch.where(valid.reshape(-1), items.reshape(-1), -1))
        weights = torch.where(kc.keys != -1, kc.counts, 0)
        return probminhash.probminhash_signatures(
            kc.keys[None, :], weights[None, :], self.params.sketch_size)[0][0]

    def jaccard(self, sig_a: torch.Tensor, sig_b: torch.Tensor):
        return probminhash.probjaccard_pair(sig_a, sig_b)


def _host_unsigned(sig) -> np.ndarray:
    """A signature as numpy unsigned words (tensors hold bit patterns)."""
    if isinstance(sig, torch.Tensor):
        a = sig.cpu().numpy()
        return a.view(np.uint32 if a.dtype == np.int32 else np.uint64) \
            if a.dtype in (np.int32, np.int64) else a
    return np.asarray(sig)


def probminhash_get_jaccard_objects(sig_a, sig_b):
    """(Jaccard estimate, the items of the equal slots or None when there
    are none) of two ProbMinHash signatures."""
    a, b = _host_unsigned(sig_a), _host_unsigned(sig_b)
    eq = a == b
    jp = float(eq.mean())
    if jp > 0:
        return jp, a[eq].tolist()
    return 0.0, None


def compute_probminhash3a_jaccard(weighted_a: dict, weighted_b: dict,
                                  sketch_size: int,
                                  return_object: bool = False,
                                  seed: int = 0):
    """Probability-Jaccard of two {u64 item: weight} mappings through their
    ProbMinHash signatures: (estimate, common items or None)."""
    def sig_of(d):
        items = np.fromiter(d.keys(), dtype=np.uint64, count=len(d))
        w = np.fromiter(d.values(), dtype=np.int64, count=len(d))
        s, _ = probminhash.probminhash_signatures(
            torch.from_numpy(items.view(np.int64))[None, :],
            torch.from_numpy(w.astype(np.int32))[None, :], sketch_size,
            seed=seed)
        return _host_unsigned(s[0])

    sa, sb = sig_of(weighted_a), sig_of(weighted_b)
    if not return_object:
        return float((sa == sb).mean()), None
    return probminhash_get_jaccard_objects(sa, sb)


def jaccard_one_vs_many(seq_a: ReadBatch, seqs_b: ReadBatch,
                        params: SeqSketcherParams) -> torch.Tensor:
    """Estimated Jaccard index of the first read of ``seq_a`` against every
    read of ``seqs_b``: float32[n_b]."""
    sk = Sketcher(params=params)
    sig_a = sk.sketch_batch(seq_a)[0]
    return probminhash.probjaccard_one_vs_many(sig_a, sk.sketch_batch(seqs_b))
