"""ProbMinHash: per-read Probability-Jaccard signatures.

Port of kmerutils_tpu/sketch/probminhash.py.  Slot s of a read receives
argmin over its items x of E_s(x) = -ln(U(x, s)) / weight(x), a pure
function of (item, slot), so P(sig_A[s] == sig_B[s]) is the Probability
Jaccard of the two weighted sets.  Weights are within-read multiplicities:
one sort per row groups duplicates and two scans (cummax, flipped cummin)
give each position its run length (ops/weights.py: CUDA kernel KW on the
card, plain PyTorch on the CPU).  The argmin itself is the tournament
(ops/tournament.py: CUDA kernels K1/K2 on the card, plain PyTorch on the
CPU).

Item dtypes: ``int32`` tensors are u32 items (bit patterns), ``int64``
tensors are u64 items (bit patterns).  Signatures come back in the items'
dtype; rows without a valid item get signature 0.  An item equal to the
all-ones sentinel counts as padding, as in the JAX package.
"""

from __future__ import annotations

import torch

from .. import obs
from ..ops import tournament
from ..ops.bitops import M32
from ..ops.tournament import slot_consts as _slot_consts  # noqa: F401
from ..ops.weights import SIGN, sort_weights


def _is_wide(items: torch.Tensor) -> bool:
    if items.dtype not in SIGN:
        raise ValueError(f"items must be int32 (u32) or int64 (u64), "
                         f"got {items.dtype}")
    return items.dtype == torch.int64


def _fold32(items: torch.Tensor) -> torch.Tensor:
    """32-bit fold lo ^ hi of u64 items as int32 bit patterns (u32 items
    pass through)."""
    if _is_wide(items):
        return (items ^ (items >> 32)).to(torch.int32)
    return items


def _tournament(items: torch.Tensor, winv: torch.Tensor, valid: torch.Tensor,
                m: int, seed: int = 0):
    """(sig [n, m] in the items' dtype, empty bool[n]).  items [n, P],
    winv float32 [n, P] (1 / multiplicity), valid bool [n, P]."""
    empty = ~valid.any(dim=1)
    winv_m = torch.where(valid, winv.to(torch.float32), 0.0).contiguous()
    if not _is_wide(items):
        sig = tournament.weighted_tournament(items.contiguous(), winv_m, m,
                                             seed=seed)
        return sig, empty
    lo = items.to(torch.int32).contiguous()
    hi = (items >> 32).to(torch.int32).contiguous()
    lo_w, hi_w = tournament.weighted_tournament_u64(lo, hi, winv_m, m,
                                                    seed=seed)
    sig = (hi_w.to(torch.int64) << 32) | (lo_w.to(torch.int64) & M32)
    return sig, empty


def probminhash_signatures(items: torch.Tensor, weights: torch.Tensor,
                           m: int, heavy_cap: int = 0, seed: int = 0):
    """Signatures from slot-aligned (item, weight) pairs.

    items int32/int64 [n, P]; weights integer [n, P] (0 marks padding;
    duplicate occurrences may all carry the item's weight).  ``heavy_cap``
    is accepted and ignored, as in the JAX version: the tournament is exact
    for any multiplicity.  Returns (sig [n, m], empty bool[n])."""
    valid = weights > 0
    winv = 1.0 / weights.clamp(min=1).to(torch.float32)
    return _tournament(items, winv, valid, m, seed)


def probminhash_from_items(items: torch.Tensor, valid: torch.Tensor, m: int,
                           heavy_cap: int = 0, seed: int = 0):
    """Signatures with the weights derived from the items themselves: the
    within-row multiplicity of each item (the per-read weighted histogram).
    The tournament runs on the sorted rows: same multiset, same signature.
    ``heavy_cap`` is accepted and ignored, as in the JAX version.
    Returns (sig [n, m] in the items' dtype, empty bool[n]).  Spans
    ``sketch.weights`` and ``sketch.draw``, each over n x P positions."""
    work, dev = items.numel(), items.device
    with obs.span("sketch.weights", work, dev) as weights:
        s, winv, is_real = sort_weights(items, valid)
    with obs.span("sketch.draw", work, dev, after=weights):
        return _tournament(s, winv, is_real, m, seed)


def probjaccard_pair(sig_a: torch.Tensor, sig_b: torch.Tensor):
    """Fraction of equal slots: the Probability-Jaccard estimate."""
    return (sig_a == sig_b).to(torch.float32).mean(dim=-1)


def probjaccard_one_vs_many(sig_a: torch.Tensor, sigs_b: torch.Tensor):
    """sig_a [m] vs sigs_b [n, m] -> [n]."""
    return probjaccard_pair(sigs_b, sig_a[None, :])


def probjaccard_matrix(sigs: torch.Tensor):
    """All-pairs estimate from signatures [n, m] -> [n, n]."""
    return (sigs[:, None, :] == sigs[None, :, :]).to(torch.float32) \
        .mean(dim=-1)
