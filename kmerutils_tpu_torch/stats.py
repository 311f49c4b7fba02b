"""Read statistics: length distribution + per-percent base composition.

Port of kmerutils_tpu/stats.py (ReadBaseDistribution):

* a read-length histogram (exact int64 counts),
* the 101 x 4 matrix: row = percentage 0..100, column = A/C/G/T, cell = the
  number (normalized to fraction) of reads whose base b occupies round(100 *
  count_b / len) percent of the read,
* ascii dumps "bases.histo" (101 lines of 4 values) and "readlen.histo"
  (quantile points), byte-identical to the JAX package's.

Batches are accumulated on their own device with torch ops (no host
traffic per batch); :meth:`ReadBaseDistribution.finish` copies the sums to
the host once.  The percentage is computed in float64 and rounded half to
even, as the JAX package's ``jnp.rint`` does with x64 enabled.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .base.alphabet import base_counts
from .base.sequence import ReadBatch

# device accumulator bins: reads at or beyond _HISTO_DEV bases clamp into
# the top length bin; reads above upper_histo additionally count into
# histo_out
_HISTO_DEV = 1 << 20


def _new_state(device):
    z = torch.zeros((), dtype=torch.int64, device=device)
    # one spare cell each: rows that must not count land there
    return (torch.zeros(102 * 4, dtype=torch.int64, device=device),
            torch.zeros(_HISTO_DEV + 1, dtype=torch.int64, device=device),
            z.clone(), z.clone())


def _accum_batch(state, batch: ReadBatch, upper_histo: int) -> None:
    """Fold one batch into the device accumulator, in place.  state =
    (acgt [102*4] i64, len_histo [_HISTO_DEV + 1] i64, histo_out i64,
    n_reads i64)."""
    acgt, histo, histo_out, n_reads = state
    dev = batch.device
    counts = base_counts(batch.codes(), batch.valid_mask())
    lengths = batch.lengths.to(torch.int64)
    real = lengths > 0            # zero-length rows carry no read
    pct = torch.round(100.0 * counts.to(torch.float64)
                      / lengths.clamp(min=1).to(torch.float64)[:, None])
    pct = pct.clamp(0, 100).to(torch.int64)
    cell = pct * 4 + torch.arange(4, device=dev)[None, :]
    cell = torch.where(real[:, None], cell, 101 * 4 + torch.arange(
        4, device=dev)[None, :])
    acgt.index_add_(0, cell.reshape(-1),
                    torch.ones(cell.numel(), dtype=torch.int64, device=dev))
    over = lengths > upper_histo
    keep = real & ~over
    bins = torch.where(keep, lengths.clamp(0, _HISTO_DEV - 1), _HISTO_DEV)
    histo.index_add_(0, bins, torch.ones_like(bins))
    histo_out += over.sum()
    n_reads += real.sum()


@dataclasses.dataclass
class ReadBaseDistribution:
    acgt_distribution: np.ndarray  # [101, 4] float64 (counts until normalize)
    read_lengths: np.ndarray       # growing int64 histogram over lengths
    upper_histo: int
    histo_out: int = 0
    non_acgt: int = 0
    n_reads: int = 0
    # device accumulator (see _accum_batch), on the first batch's device
    _dev: tuple | None = dataclasses.field(default=None, repr=False)

    @staticmethod
    def new(readmaxsize: int = 10_000_000) -> "ReadBaseDistribution":
        return ReadBaseDistribution(
            acgt_distribution=np.zeros((101, 4), dtype=np.float64),
            read_lengths=np.zeros(0, dtype=np.int64),
            upper_histo=readmaxsize)

    # ------------------------------------------------------------------
    def record_batch(self, batch: ReadBatch) -> None:
        if self._dev is None:
            self._dev = _new_state(batch.device)
        _accum_batch(self._dev, batch, self.upper_histo)

    def finish(self) -> "ReadBaseDistribution":
        """Fold the device accumulator into the host fields; call after
        the last record_batch (the dumps and normalized_distribution do
        so themselves)."""
        if self._dev is None:
            return self
        acgt, histo, hout, nr = (x.cpu().numpy() for x in self._dev)
        self._dev = None
        self.acgt_distribution += acgt[: 101 * 4].reshape(101, 4) \
            .astype(np.float64)
        histo = histo[:_HISTO_DEV]
        nz = np.flatnonzero(histo)
        if nz.size:
            L = int(nz[-1]) + 1
            grown = np.zeros(max(L, self.read_lengths.size), np.int64)
            grown[: self.read_lengths.size] += self.read_lengths
            grown[:L] += histo[:L]
            self.read_lengths = grown
        self.histo_out += int(hout)
        self.n_reads += int(nr)
        return self

    def merge(self, other: "ReadBaseDistribution") -> None:
        self.finish()
        other.finish()
        self.acgt_distribution += other.acgt_distribution
        self.histo_out += other.histo_out
        self.non_acgt += other.non_acgt
        self.n_reads += other.n_reads
        L = max(self.read_lengths.size, other.read_lengths.size)
        grown = np.zeros(L, dtype=np.int64)
        grown[: self.read_lengths.size] += self.read_lengths
        grown[: other.read_lengths.size] += other.read_lengths
        self.read_lengths = grown

    # ------------------------------------------------------------------
    def normalized_distribution(self) -> np.ndarray:
        """Fractions-of-reads matrix (normalized by the number of reads)."""
        self.finish()
        if self.n_reads == 0:
            return self.acgt_distribution.copy()
        return self.acgt_distribution / self.n_reads

    def ascii_dump_acgt_distribution(self, name: str) -> None:
        m = self.normalized_distribution()
        with open(name, "w") as f:
            for i in range(m.shape[0]):
                f.write(f"{m[i, 0]} {m[i, 1]}  {m[i, 2]}  {m[i, 3]} \n")

    def ascii_dump_readlen_distribution(self, name: str,
                                        nb_points: int = 1000) -> None:
        """Quantile-sampled (length, nb_reads) points."""
        self.finish()
        total = int(self.read_lengths.sum())
        if total == 0:
            raise ValueError("empty read-length histogram")
        nbslot = max(total // 100, 1)
        cum = np.cumsum(self.read_lengths)
        # value_at_quantile(q): smallest length whose cumulative count >= q*total
        qs = np.arange(nbslot + 1) / nbslot
        readsize = np.searchsorted(cum, qs * total, side="left")
        readsize = np.clip(readsize, 0, self.read_lengths.size - 1)
        lines = []
        first_i = 0
        current_i = 0
        for j in range(nb_points):
            threshold = (total * j) // nb_points
            while current_i < nbslot and readsize[current_i] < threshold:
                current_i += 1
            if current_i < nbslot and current_i > first_i:
                nb_in_slot = ((current_i - first_i) * total) // nbslot
                lines.append((int(readsize[current_i]), nb_in_slot))
            first_i = current_i
        with open(name, "w") as f:
            for absc, nb in lines:
                f.write(f"{absc}  {nb} \n")


def get_base_count(batches, readmaxsize: int = 10_000_000) -> ReadBaseDistribution:
    """Driver over an iterable of ReadBatch."""
    dist = ReadBaseDistribution.new(readmaxsize)
    for b in batches:
        dist.record_batch(b)
    return dist.finish()
