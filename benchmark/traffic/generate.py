"""The one generator of the benchmark's inputs: a pool of reads drawn from
a seeded random genome and cut into batches as ingest cuts a file.

A cell's configuration (``configs/<name>.json``) fixes the data's shape:
genome length, read-length distribution, strands, substitution rate.  Its
traffic (``traffic/<name>.json``) fixes how the data arrives: a pool of
how many reads, cut into batches of at most how many bases.  Nothing here
reads or imports the program.

Every seed gets the same read lengths in the same order, drawn once from
the traffic's ``lengths_seed``, so every seed's batches have the same
shapes; the run's seed draws the genome and the starts.  So two seeds do
the same amount of work on different data.  Bases are 2-bit codes A=0,
C=1, G=2, T=3.
"""

from __future__ import annotations

import dataclasses

import numpy as np

def seed_rng(seed: int, *stream: int) -> np.random.Generator:
    """A numpy generator for one stream of one run's seed (any integer)."""
    return np.random.default_rng([int(seed) % (1 << 64), *stream])


def read_lengths(config: dict, n: int, lengths_seed: int) -> np.ndarray:
    """The fixed sequence of ``n`` read lengths (lognormal, clipped)."""
    rl = config["read_len"]
    rng = np.random.default_rng(lengths_seed)
    return np.clip(rng.lognormal(np.log(rl["median"]), rl["sigma"], size=n),
                   rl["min"], rl["max"]).astype(np.int64)


@dataclasses.dataclass
class Reads:
    """Clean reads as one concatenation of 2-bit codes: read i is
    ``codes[offsets[i]:offsets[i + 1]]``."""
    codes: np.ndarray        # uint8[total]
    lengths: np.ndarray      # int64[n]

    @property
    def offsets(self) -> np.ndarray:
        return np.concatenate([[0], np.cumsum(self.lengths)])

    @property
    def n_bases(self) -> int:
        return int(self.lengths.sum())


def rung(length: int) -> int:
    """The next {2^i, 1.5 * 2^i} width >= max(length, 256), as ingest
    pads a batch's rows."""
    L = max(int(length), 256)
    p = 1 << (L - 1).bit_length()
    return 3 * p // 4 if L <= 3 * p // 4 else p


def cut_batches(lengths: np.ndarray, batch_reads: int, max_batch_bases: int,
                window_bases: int):
    """Read indices of each batch, cut by the rule ingest cuts a file with
    (``io/fastx.read_batches`` with its length bucketing): reads gather in
    a window until it holds ``window_bases`` new bases or 4 x
    ``batch_reads`` new reads; the window is sorted by length and split
    into groups of one width rung; a group is full at a power-of-two row
    quota (<= min(batch_reads, max_batch_bases / width)) or at
    ``max_batch_bases`` padded bases; groups that are not full wait for the
    next window, and the last window emits everything."""
    def quota(width):
        q = max(1, min(batch_reads, max_batch_bases // width))
        return 1 << (q.bit_length() - 1)

    batches = []
    window: list = []

    def flush(final: bool):
        nonlocal window
        order = sorted(window, key=lambda i: lengths[i])
        keep = []
        start = 0
        while start < len(order):
            L0 = int(lengths[order[start]])
            take, full = 1, False
            while start + take < len(order):
                Lc = max(L0, int(lengths[order[start + take]]))
                if rung(Lc) != rung(L0):
                    break
                if take + 1 > quota(rung(Lc)) \
                        or (take + 1) * rung(Lc) > max_batch_bases:
                    full = True
                    break
                take += 1
                L0 = Lc
            w = rung(L0)
            full = full or take >= quota(w) or (take + 1) * w > max_batch_bases
            group = order[start:start + take]
            start += take
            if final or full:
                batches.append(np.array(group, np.int64))
            else:
                keep.extend(group)
        window = keep

    new_bases = new_reads = 0
    for i in range(lengths.size):
        window.append(i)
        new_bases += int(lengths[i])
        new_reads += 1
        if new_bases >= window_bases or new_reads >= 4 * batch_reads:
            flush(final=False)
            new_bases = new_reads = 0
    flush(final=True)
    return batches


@dataclasses.dataclass
class Pool:
    """Reads sampled from ``genome`` (forward strand), cut into batches."""
    genome: np.ndarray
    starts: np.ndarray
    lengths: np.ndarray
    batches: list            # int64 read indices of each batch

    def reads(self, idx) -> Reads:
        ln = self.lengths[idx]
        return Reads(np.concatenate([
            self.genome[s:s + n] for s, n in zip(self.starts[idx].tolist(),
                                                 ln.tolist())]), ln)

    def n_bases(self, b: int) -> int:
        return int(self.lengths[self.batches[b]].sum())


def make_pool(config: dict, traffic: dict, seed: int) -> Pool:
    """The traffic's pool of ``pool_reads`` clean reads (forward strand,
    no errors, as the configuration states for the resident cell's
    in-process caller) and its batches."""
    if config["both_strands"] or config["err_rate"]:
        raise ValueError("a resident pool draws forward reads without "
                         "errors")
    n = traffic["pool_reads"]
    lengths = read_lengths(config, n, traffic["lengths_seed"])
    rng = seed_rng(seed, 2)
    genome = rng.integers(0, 4, size=config["genome_len"], dtype=np.uint8)
    starts = rng.integers(0, genome.size - lengths.max(), size=n)
    batches = cut_batches(lengths, traffic["batch_reads"],
                          traffic["max_batch_bases"],
                          traffic["window_batches"]
                          * traffic["max_batch_bases"])
    return Pool(genome, starts, lengths, batches)
