"""Canonical k-mers of reads given as 2-bit codes, in plain PyTorch.

A k-mer's value packs its bases 2 bits each, the first base in the top
bits (A=0, C=1, G=2, T=3); its canonical value is the smaller of it and
its reverse complement.  Positions are in scan order: read by read, and
within a read from its first base, one per start p with p + k <= length.
Values are int64 (k <= 32 fits below 2^63 up to k = 31; at k = 32 the
int64 carries the u64 bit pattern).  Imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch


def positions(lengths, k: int, device):
    """(flat start index into the codes, read number, position) of every
    k-mer, in scan order, as int64 tensors."""
    ln = torch.as_tensor(np.asarray(lengths, np.int64), device=device)
    n_k = (ln - k + 1).clamp(min=0)
    rid = torch.repeat_interleave(torch.arange(ln.numel(), device=device),
                                  n_k)
    first = torch.cumsum(n_k, 0) - n_k
    pos = torch.arange(rid.numel(), device=device) - first[rid]
    offs = torch.cumsum(ln, 0) - ln
    return offs[rid] + pos, rid, pos


def canonical(codes, lengths, k: int, device, chunk: int = 1 << 26):
    """(canonical value, read number, position) of every k-mer of the reads
    (``codes`` uint8 numpy concatenation, ``lengths`` per read)."""
    at, rid, pos = positions(lengths, k, device)
    c = torch.as_tensor(codes, device=device).to(torch.int64)
    can = torch.empty_like(at)
    mask = (1 << (2 * k)) - 1 if k < 32 else -1
    for s in range(0, at.numel(), chunk):
        a = at[s:s + chunk]
        fwd = torch.zeros_like(a)
        rev = torch.zeros_like(a)
        for j in range(k):
            b = c[a + j]
            fwd = (fwd << 2) | b
            rev = rev | ((3 - b) << (2 * j))
        fwd = fwd & mask
        if k < 32:
            can[s:s + chunk] = torch.minimum(fwd, rev)
        else:   # unsigned order of u64 bit patterns
            flip = -(1 << 63)
            can[s:s + chunk] = torch.minimum(fwd ^ flip, rev ^ flip) ^ flip
    return can, rid, pos
