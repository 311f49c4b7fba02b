"""Reads with sequencing errors on both strands, for the count cells: a
pool drawn from a seeded random genome, cut into batches as ingest cuts a
file (``generate.py``'s lengths and cutting, so the same traffic gives the
same batch shapes as the sketch cell's).

The genome is never held: base g of the genome is the top two bits of a
32-bit mix of g and the run's seed, so a human-sized genome costs nothing
to draw, and any read's bases are made where they are needed, on the
device or on the host, by the same integer arithmetic.  Read i starts at
a uniform ``starts[i]``, is reverse-complemented when ``strands[i]`` is 1
(probability 1/2), and each of its bases, at offset j along the read, is
replaced by one of the three other bases with probability ``err_rate``
(decided by a mix of (i, j) and the seed).  Bases are 2-bit codes A=0,
C=1, G=2, T=3.  Nothing here reads or imports the program.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import generate

M32 = 0xFFFFFFFF
OFFSET_BITS = 14            # offsets along a read: below 2^14 = 16,384


def _mul32(x, c: int):
    """(x * c) mod 2^32 for u32 values in int64, without passing 2^63."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def mix32(x, salt: int):
    """A 32-bit mix (lowbias32) of u32 values in int64 and a u32 salt."""
    x = (x ^ salt) & M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


@dataclasses.dataclass
class CountPool:
    """A pool of reads with errors, on both strands, cut into batches."""
    genome_len: int
    starts: np.ndarray       # int64 genome position of each read's first
    lengths: np.ndarray      # int64
    strands: np.ndarray      # uint8: 1 = reverse complement
    salts: tuple             # u32 salts: genome (2), errors (2)
    err_threshold: int       # a base is substituted when its mix is below
    batches: list            # int64 read indices of each batch

    def n_bases(self, b: int) -> int:
        return int(self.lengths[self.batches[b]].sum())

    def codes(self, idx, device):
        """The bases of reads ``idx``, concatenated in that order, as int64
        codes on ``device``."""
        dev = torch.device(device)
        idx = np.asarray(idx, np.int64)
        ln = torch.as_tensor(self.lengths[idx], device=dev)
        rid = torch.repeat_interleave(torch.arange(idx.size, device=dev), ln)
        first = torch.cumsum(ln, 0) - ln
        j = torch.arange(rid.numel(), device=dev) - first[rid]
        rc = torch.as_tensor(self.strands[idx], device=dev)[rid] \
            .to(torch.bool)
        g = torch.as_tensor(self.starts[idx], device=dev)[rid] \
            + torch.where(rc, ln[rid] - 1 - j, j)
        s0, s1, s2, s3 = self.salts
        base = mix32(mix32(g, s0), s1) >> 30
        base = torch.where(rc, 3 - base, base)
        site = (torch.as_tensor(idx, device=dev)[rid] << OFFSET_BITS) + j
        h = mix32(site, s2)
        sub = (mix32(h, s3) % 3) + 1
        return torch.where(h < self.err_threshold, (base + sub) & 3, base)


def make_pool(config: dict, traffic: dict, seed: int) -> CountPool:
    """The traffic's pool of ``pool_reads`` reads (``generate.make_pool``'s
    lengths and batches) with the configuration's strands and errors."""
    n = traffic["pool_reads"]
    lengths = generate.read_lengths(config, n, traffic["lengths_seed"])
    if lengths.max() >= 1 << OFFSET_BITS or n >= 1 << (31 - OFFSET_BITS):
        raise ValueError("reads too long or too many for the error sites")
    if config["genome_len"] > M32:
        raise ValueError("a genome position must fit 32 bits")
    rng = generate.seed_rng(seed, 3)
    starts = rng.integers(0, config["genome_len"] - lengths.max(), size=n)
    strands = (rng.random(n) < 0.5).astype(np.uint8)
    if not config["both_strands"]:
        strands[:] = 0
    salts = tuple(int(v) for v in rng.integers(0, 1 << 32, size=4))
    batches = generate.cut_batches(lengths, traffic["batch_reads"],
                                   traffic["max_batch_bases"],
                                   traffic["window_batches"]
                                   * traffic["max_batch_bases"])
    return CountPool(int(config["genome_len"]), starts, lengths, strands,
                     salts, int(round(config["err_rate"] * (1 << 32))),
                     batches)
