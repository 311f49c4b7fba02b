"""Balanced grouping of variable-length work, size guesses, phase timers.

Port of kmerutils_tpu/utils.py (pure Python):

* ``make_equal_groups`` — the reference's groups.rs: a greedy contiguous
  partition of blocks into groups of about equal size;
* ``get_nbkmer_guess`` / ``get_nbkmer_guess_seqs`` — the reference's
  nbkmerguess.rs: pre-size heuristics for per-sequence k-mer stores;
* ``PhaseTimer`` — accumulated wall time per named phase.
"""

from __future__ import annotations

import logging
import time

_MAX_NB_KMER = 100_000_000
_FACTOR_LIST = 10_000_000


def get_nbkmer_guess(seq_len: int) -> int:
    """min(len, 1e8 * (1 + ilog2(len))) — nbkmerguess.rs:7-13."""
    if seq_len <= 0:
        return 0
    return min(seq_len, _MAX_NB_KMER * (1 + (seq_len.bit_length() - 1)))


def get_nbkmer_guess_seqs(seq_lens) -> int:
    """Guess for a list of sequences — nbkmerguess.rs:15-20."""
    total = sum(seq_lens)
    if total <= 0:
        return 0
    return min(total, _FACTOR_LIST * (1 + (total.bit_length() - 1)))


def make_equal_groups(blocks_size, nbgroup: int) -> list[int]:
    """Return frontiers f so group i spans blocks [f[i], f[i+1]);
    f[-1] == len(blocks_size).  Same greedy rule as groups.rs:20-62."""
    total = sum(blocks_size)
    equal_group = round(total / nbgroup)
    frontiers = [0]
    nb_blocks = len(blocks_size)
    nb_group = 1
    b = 0
    cumul = 0
    while b < nb_blocks:
        if cumul + blocks_size[b] <= equal_group * nb_group:
            cumul += blocks_size[b]
            b += 1
        else:
            excess = cumul + blocks_size[b] - equal_group * nb_group
            default = equal_group * nb_group - cumul
            if excess <= default:
                frontiers.append(b + 1)
            else:
                frontiers.append(b)
            cumul += blocks_size[b]
            b += 1
            nb_group += 1
    if frontiers[-1] < nb_blocks:
        frontiers.append(nb_blocks)
    return frontiers


class PhaseTimer:
    """Per-phase wall timers as a reusable context manager; a phase
    entered twice accumulates.

    >>> t = PhaseTimer()
    >>> with t.phase("ingest"):
    ...     ...
    >>> t.report()   # logs one line per phase
    """

    def __init__(self, logger: str = "kmerutils_tpu_torch"):
        self._log = logging.getLogger(logger)
        self.elapsed: dict[str, float] = {}

    def phase(self, name: str):
        timer = self

        class _Ctx:
            def __enter__(self):
                self._t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                timer.elapsed[name] = timer.elapsed.get(name, 0.0) + (
                    time.perf_counter() - self._t0)
                return False

        return _Ctx()

    def report(self) -> dict[str, float]:
        for name, dt in self.elapsed.items():
            self._log.info("phase %-20s %.3f s", name, dt)
        return dict(self.elapsed)
