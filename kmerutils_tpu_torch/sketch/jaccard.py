"""k-mer hashing for the sketchers and the algorithm-dispatched Sketcher.

Port of kmerutils_tpu/sketch/jaccard.py.  The item of a k-mer is the
invertible Wang hash of its canonical value (``hash_name="wang"``), or the
canonical value itself (``"identity"``): u32 items (int32 bit patterns) for
k <= 16, u64 items (int64 bit patterns) for 17 <= k <= 32.  The Sketcher
dispatches to the six families: PROB3A (probminhash.py, kernels K1/K2),
SUPER and SUPER2 (superminhash.py, kernel G1), OPTDENS and REVOPTDENS
(densminhash.py), HLL (setsketch.py, kernel G2).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import obs
from ..base.sequence import ReadBatch
from ..count import exact
from ..ops import kmer_prefix
from ..ops.bitops import M32
from . import densminhash, probminhash, setsketch, superminhash
from .params import SeqSketcherParams, SketchAlgo
from .setsketch import SetSketchParams


def hashed_kmers(batch: ReadBatch, k: int, hash_name: str = "wang"):
    """(items [n, P], valid bool[n, P]): the canonical k-mers through the
    k-mer hash; int32 (u32) items for k <= 16, int64 (u64) items above
    (ops/kmer_prefix.py, kernel KP on the card).  Span ``sketch.kmers``, over
    n x P positions."""
    work = batch.n_reads * max(batch.max_len - k + 1, 1)
    with obs.span("sketch.kmers", work, batch.device):
        return kmer_prefix.kmer_prefix(batch.words, batch.lengths, k,
                                       hash_name)


def hashed_weighted_kmers(batch: ReadBatch, k: int, hash_name: str = "wang"):
    """(items, weights int32, valid): the items of :func:`hashed_kmers` with
    the within-read multiplicity of each position's canonical k-mer."""
    items, valid = hashed_kmers(batch, k, hash_name)
    weights, _ = exact.multiplicity_per_slot(batch, k)
    return items, weights, valid


def sketch_items(items: torch.Tensor, valid: torch.Tensor, algo: SketchAlgo,
                 m: int, seed: int = 0,
                 setsketch_params: SetSketchParams | None = None):
    """Per-row signatures of items [n, P] by ``algo``: PROB3A in the items'
    dtype, SUPER2 int32 (u32), SUPER float64, OPTDENS / REVOPTDENS
    float32, HLL int32 registers."""
    if algo == SketchAlgo.PROB3A:
        return probminhash.probminhash_from_items(items, valid, m,
                                                  seed=seed)[0]
    if algo == SketchAlgo.SUPER:
        return superminhash.superminhash(items, valid, m, seed)[0]
    if algo == SketchAlgo.SUPER2:
        return superminhash.superminhash2(items, valid, m, seed)[0]
    if algo == SketchAlgo.OPTDENS:
        return densminhash.optdens_signatures(items, valid, m, seed)[0]
    if algo == SketchAlgo.REVOPTDENS:
        return densminhash.revoptdens_signatures(items, valid, m, seed)[0]
    if algo == SketchAlgo.HLL:
        return setsketch.setsketch_signatures(
            items, valid, setsketch_params or SetSketchParams(m=m), seed)
    raise ValueError(f"unhandled algo {algo}")


def sketch_items_collection(items: torch.Tensor, valid: torch.Tensor,
                            algo: SketchAlgo, m: int, seed: int = 0,
                            setsketch_params: SetSketchParams | None = None):
    """One signature [m] for all rows of items [n, P] together.  PROB3A
    counts the items exactly (count/exact.count_from_values) and sketches
    the distinct ones, weighted by their counts, as one u64 row; HLL
    merges the per-row registers (their max); the others sketch the
    flattened items as one row."""
    if algo == SketchAlgo.HLL:
        return sketch_items(items, valid, algo, m, seed,
                            setsketch_params).amax(dim=0)
    flat, fvalid = items.reshape(1, -1), valid.reshape(1, -1)
    if algo != SketchAlgo.PROB3A:
        return sketch_items(flat, fvalid, algo, m, seed)[0]
    if flat.dtype == torch.int32:
        flat = flat.to(torch.int64) & M32
    kc = exact.count_from_values(torch.where(fvalid[0], flat[0], -1))
    weights = torch.where(kc.keys != -1, kc.counts, 0)
    return probminhash.probminhash_signatures(
        kc.keys[None, :], weights[None, :], m, seed=seed)[0][0]


def estimate_jaccard(sig_a: torch.Tensor, sig_b: torch.Tensor,
                     algo: SketchAlgo, m: int,
                     setsketch_params: SetSketchParams | None = None):
    """Jaccard estimate of broadcasting signatures: the fraction of equal
    slots (float32), or for HLL the inclusion-exclusion of the registers
    (float64)."""
    if algo == SketchAlgo.HLL:
        return setsketch.jaccard(sig_a, sig_b,
                                 setsketch_params or SetSketchParams(m=m))
    return probminhash.probjaccard_pair(sig_a, sig_b)


@dataclasses.dataclass(frozen=True)
class Sketcher:
    """Sequence sketcher for the six families; runs on the batch's device.
    ``heavy_cap`` is a legacy knob of the JAX package, ignored."""

    params: SeqSketcherParams
    hash_name: str = "wang"
    seed: int = 0
    setsketch_params: SetSketchParams | None = None
    heavy_cap: int = 2048

    def get_kmer_size(self) -> int:
        return self.params.kmer_size

    def get_sketch_size(self) -> int:
        return self.params.sketch_size

    def get_algo(self) -> SketchAlgo:
        return self.params.algo

    def sketch_batch(self, batch: ReadBatch) -> torch.Tensor:
        """Signatures [n_reads, sketch_size] (see :func:`sketch_items`)."""
        items, valid = hashed_kmers(batch, self.params.kmer_size,
                                    self.hash_name)
        return sketch_items(items, valid, self.params.algo,
                            self.params.sketch_size, self.seed,
                            self.setsketch_params)

    def sketch_collection(self, batch: ReadBatch) -> torch.Tensor:
        """One signature [sketch_size] for all reads of the batch together
        (see :func:`sketch_items_collection`)."""
        items, valid = hashed_kmers(batch, self.params.kmer_size,
                                    self.hash_name)
        return sketch_items_collection(items, valid, self.params.algo,
                                       self.params.sketch_size, self.seed,
                                       self.setsketch_params)

    def jaccard(self, sig_a: torch.Tensor, sig_b: torch.Tensor):
        return estimate_jaccard(sig_a, sig_b, self.params.algo,
                                self.params.sketch_size,
                                self.setsketch_params)


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
                        params: SeqSketcherParams, hash_name: str = "wang",
                        seed: int = 0) -> torch.Tensor:
    """Estimated Jaccard index of the first read of ``seq_a`` against every
    read of ``seqs_b``: [n_b]."""
    sk = Sketcher(params=params, hash_name=hash_name, seed=seed)
    sig_a = sk.sketch_batch(seq_a)[0]
    return sk.jaccard(sk.sketch_batch(seqs_b), sig_a[None, :])
