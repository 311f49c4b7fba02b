"""Amino-acid sequences, their k-mers and the AA sketcher.

Port of kmerutils_tpu/aa/kmeraa.py: 5 bits a residue, the first residue in
the high bits, k <= 12 (60 bits, so an int64 holds a k-mer with no sign
trouble), no reverse complement.  The items fed to the sketchers are the
Wang hash of the k-mer, u32 (int32 bit patterns) for k <= 6 and u64 for
7 <= k <= 12, or with ``hash_name="identity"`` the k-mer itself as a u64
item.  :class:`SketcherAA` dispatches to the same six families as the DNA
Sketcher (sketch/jaccard.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import alphabet
from ..ops.bitops import M32, u32_to_i32
from ..ops.rng import wang_hash32, wang_hash64
from ..sketch.jaccard import (estimate_jaccard, sketch_items,
                              sketch_items_collection)
from ..sketch.params import SeqSketcherParams
from ..sketch.setsketch import SetSketchParams

NB_BITS = 5


class SequenceAA:
    """Host-side AA sequence (raw ASCII bytes), optionally filtered of
    invalid residues; an invalid residue raises otherwise."""

    __slots__ = ("raw",)

    def __init__(self, s: bytes | str, filtered: bool = False):
        if isinstance(s, str):
            s = s.encode()
        raw = np.frombuffer(bytes(s), dtype=np.uint8)
        valid = alphabet.is_valid_aa(raw)
        if filtered:
            raw = raw[valid]
        elif not valid.all():
            raise ValueError("invalid amino acid in sequence")
        self.raw = raw

    def __len__(self):
        return self.raw.size

    def __str__(self):
        return self.raw.tobytes().decode()


@dataclasses.dataclass(frozen=True)
class AABatch:
    """Batched AA reads: codes uint8[n, L] (5-bit codes, padding 0) and
    lengths int32[n], on one device."""

    codes: torch.Tensor
    lengths: torch.Tensor

    @property
    def n_reads(self) -> int:
        return self.codes.shape[0]

    @property
    def device(self) -> torch.device:
        return self.codes.device


def pack_aa_reads(seqs, device="cuda") -> AABatch:
    """Pack sequences (SequenceAA, str or bytes) into an AABatch on
    ``device``; an invalid residue in a str / bytes raises."""
    arrs = []
    for s in seqs:
        if isinstance(s, SequenceAA):
            a = alphabet.encode_aa(s.raw)
        else:
            if isinstance(s, str):
                s = s.encode()
            a = alphabet.encode_aa(np.frombuffer(bytes(s), dtype=np.uint8))
            if (a == 0xFF).any():
                raise ValueError("invalid amino acid; filter first")
        arrs.append(a)
    n = len(arrs)
    L = max((a.size for a in arrs), default=1)
    codes = np.zeros((n, L), dtype=np.uint8)
    lengths = np.zeros(n, dtype=np.int32)
    for i, a in enumerate(arrs):
        codes[i, : a.size] = a
        lengths[i] = a.size
    return AABatch(codes=torch.from_numpy(codes).to(device),
                   lengths=torch.from_numpy(lengths).to(device))


def kmers_aa(batch: AABatch, k: int):
    """All AA k-mers as u64 values in int64 (5 bits a residue, first
    residue highest): (kmers int64[n, P], valid bool[n, P]), P =
    max(L - k + 1, 1)."""
    if not 1 <= k <= 12:
        raise ValueError("AA kmers support k <= 12 (u64, 5 bits/residue)")
    codes = batch.codes
    n, L = codes.shape
    P = max(L - k + 1, 1)
    if L < P + k - 1:       # reads shorter than k: no valid k-mer anyway
        codes = torch.nn.functional.pad(codes, (0, P + k - 1 - L))
    acc = torch.zeros((n, P), dtype=torch.int64, device=codes.device)
    for i in range(k):
        acc = (acc << NB_BITS) | codes[:, i : i + P].to(torch.int64)
    pos = torch.arange(P, dtype=torch.int32, device=codes.device)[None, :]
    return acc, pos + k <= batch.lengths[:, None]


def kmer_value_from_str(s: str) -> int:
    v = 0
    for c in alphabet.encode_aa(np.frombuffer(s.encode(), dtype=np.uint8)):
        if c == 0xFF:
            raise ValueError("invalid AA")
        v = (v << NB_BITS) | int(c)
    return v


def hashed_kmers_aa(batch: AABatch, k: int, hash_name: str = "wang"):
    """(items, valid): the AA k-mers through the k-mer hash, with no
    canonical form; int32 (u32) items for k <= 6 with the Wang hash, int64
    (u64) items otherwise."""
    km, valid = kmers_aa(batch, k)
    if hash_name == "wang":
        if k <= 6:
            return u32_to_i32(wang_hash32(km & M32)), valid
        return wang_hash64(km), valid
    if hash_name == "identity":
        return km, valid
    raise ValueError(f"unknown hash {hash_name}")


@dataclasses.dataclass(frozen=True)
class SketcherAA:
    """AA twin of sketch.jaccard.Sketcher: the six families over AA
    k-mers; runs on the batch's device."""

    params: SeqSketcherParams
    hash_name: str = "wang"
    seed: int = 0
    setsketch_params: SetSketchParams | None = None

    def sketch_batch(self, batch: AABatch) -> torch.Tensor:
        """Signatures [n_reads, sketch_size] (sketch/jaccard.py::
        sketch_items)."""
        items, valid = hashed_kmers_aa(batch, self.params.kmer_size,
                                       self.hash_name)
        return sketch_items(items, valid, self.params.algo,
                            self.params.sketch_size, self.seed,
                            self.setsketch_params)

    def sketch_collection(self, batch: AABatch) -> torch.Tensor:
        """One signature [sketch_size] for all sequences together
        (sketch/jaccard.py::sketch_items_collection)."""
        items, valid = hashed_kmers_aa(batch, self.params.kmer_size,
                                       self.hash_name)
        return sketch_items_collection(items, valid, self.params.algo,
                                       self.params.sketch_size, self.seed,
                                       self.setsketch_params)

    def jaccard(self, sig_a: torch.Tensor, sig_b: torch.Tensor):
        return estimate_jaccard(sig_a, sig_b, self.params.algo,
                                self.params.sketch_size,
                                self.setsketch_params)
