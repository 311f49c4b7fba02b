"""Block sketching of long reads and the block distance.

Port of kmerutils_tpu/sketch/block.py.  Block i of a read covers its k-mer
start positions [i * block_size, (i + 1) * block_size); each block gets its
own ProbMinHash signature.  The [n_reads, P] item grid is padded to a
multiple of block_size and reshaped to [n_reads * n_blocks, block_size], so
blocks are just more rows of the same sketch (and of kernel K1/K2).  A
block's signature depends only on its own positions, not on the batch's
width, so a read gets the same blocks in a length-sorted batch as in the
JAX CLI's file-order batches.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..base.sequence import ReadBatch
from . import probminhash
from .jaccard import hashed_kmers


@dataclasses.dataclass(frozen=True)
class BlockSketchResult:
    """sigs uint32/uint64[n_reads, n_blocks, m] (numpy); live bool[n_reads,
    n_blocks]: a block is live when it holds at least one valid k-mer."""
    sigs: np.ndarray
    live: np.ndarray
    block_size: int
    kmer_size: int


def block_sketch(batch: ReadBatch, k: int, m: int, block_size: int,
                 hash_name: str = "wang", seed: int = 0) -> BlockSketchResult:
    """Sketch every ``block_size`` window of k-mer start positions of every
    read, on the batch's device.  ``hash_name`` is the k-mer hash of
    :func:`sketch.jaccard.hashed_kmers`: ``"wang"`` or ``"identity"`` (the
    canonical k-mer values themselves)."""
    items, valid = hashed_kmers(batch, k, hash_name)
    n, P = items.shape
    nb = -(-P // block_size)
    pad = nb * block_size - P
    items = torch.nn.functional.pad(items, (0, pad))
    valid = torch.nn.functional.pad(valid, (0, pad))
    sig, empty = probminhash.probminhash_from_items(
        items.reshape(n * nb, block_size), valid.reshape(n * nb, block_size),
        m, seed=seed)
    sig = sig.cpu().numpy()
    sig = sig.view(np.uint32 if sig.dtype == np.int32 else np.uint64)
    return BlockSketchResult(sigs=sig.reshape(n, nb, m),
                             live=~empty.cpu().numpy().reshape(n, nb),
                             block_size=block_size, kmer_size=k)


def dist_block_sketched(numseq_a: int, sig_a, numseq_b: int, sig_b) -> float:
    """1.0 for two blocks of the same read, else the fraction of unequal
    slots."""
    if numseq_a == numseq_b:
        return 1.0
    return float((np.asarray(sig_a) != np.asarray(sig_b)).mean())


def flatten_for_dump(res: BlockSketchResult, read_indices=None):
    """-> list of (numseq, [block signature u32[m], ...]) over the reads
    with a live block, in row order, for io.formats.write_block_signature_dump;
    signatures are cut to u32 (their low half for u64 items).  Rows past
    ``len(read_indices)`` are ignored."""
    n = res.sigs.shape[0]
    if read_indices is not None:
        n = min(n, len(read_indices))
    live = res.live[:n]
    per_read = live.sum(axis=1)
    rows = np.flatnonzero(per_read)
    blocks = res.sigs[:n][live].astype(np.uint32)      # row-major: in order
    numseq = (np.asarray(read_indices)[rows] if read_indices is not None
              else rows)
    parts = np.split(blocks, np.cumsum(per_read[rows])[:-1])
    return [(int(s), list(p)) for s, p in zip(numseq, parts)]
