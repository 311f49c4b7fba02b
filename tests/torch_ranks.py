"""Helpers of the port's multi-rank CPU tests (tests/test_torch_collective.py,
tests/test_torch_pstream.py): spawn a gloo group in worker processes, read
back what each rank wrote, and numpy oracles of canonical k-mers.

A rank is a ``torch.multiprocessing`` spawn of a function defined at the top
level of a test module; it joins the group through a ``file://``
rendezvous in the test's temporary directory with a group timeout, writes
its arrays there with ``np.savez`` and exits.  The test joins the ranks
with a timeout of its own, so a collective that some rank skips fails the
test instead of hanging the suite.  Nothing here imports jax.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch.multiprocessing as mp

GROUP_TIMEOUT_S = 60     # a collective some rank never enters fails after it
JOIN_TIMEOUT_S = 240     # the ranks of one test, start-up included


def make_mesh(rank: int, world: int, root: str):
    """This rank's gloo mesh over the rendezvous file in ``root``."""
    from kmerutils_tpu_torch.parallel import mesh as pmesh
    return pmesh.make_mesh("cpu", init_method=f"file://{root}/rendezvous",
                           rank=rank, world_size=world,
                           timeout=GROUP_TIMEOUT_S)


def leave_group() -> None:
    import torch.distributed as dist
    dist.destroy_process_group()


class Ranks:
    """``world`` spawned ranks running ``fn(rank, world, root, *args)``;
    started at once, joined by :meth:`results` (so the caller can compute
    the JAX side meanwhile)."""

    def __init__(self, fn, world: int, root: str, *args):
        os.makedirs(root, exist_ok=True)
        self.world, self.root = world, str(root)
        self._ctx = mp.start_processes(fn, args=(world, self.root) + args,
                                       nprocs=world, join=False,
                                       start_method="spawn")
        self._done = False

    def join(self) -> None:
        if self._done:
            return
        deadline = time.monotonic() + JOIN_TIMEOUT_S
        while not self._ctx.join(timeout=5):
            if time.monotonic() > deadline:
                for p in self._ctx.processes:
                    p.kill()
                raise TimeoutError(f"{self.world} ranks still running after "
                                   f"{JOIN_TIMEOUT_S} s")
        self._done = True

    def results(self, name: str) -> list[dict]:
        """What every rank saved under ``name``, in rank order."""
        self.join()
        out = []
        for r in range(self.world):
            with np.load(os.path.join(self.root, f"{name}.{r}.npz")) as z:
                out.append({k: z[k] for k in z.files})
        return out


def save(root: str, name: str, rank: int, **arrays) -> None:
    np.savez(os.path.join(root, f"{name}.{rank}.npz"), **arrays)


def random_codes(rng, n: int, length: int, dup_rows: int = 0):
    """2-bit codes [n, length] of random reads; the last ``dup_rows`` rows
    repeat the first ones (k-mers shared across ranks)."""
    codes = rng.integers(0, 4, size=(n, length), dtype=np.uint8)
    if dup_rows:
        codes[n - dup_rows:] = codes[:dup_rows]
    return codes


def canonical_np(codes: np.ndarray, lengths: np.ndarray, k: int):
    """Canonical k-mers of every valid position, in scan order (rows, then
    positions), with their row and position: numpy only."""
    vals, rows, pos = [], [], []
    for r, (c, ln) in enumerate(zip(codes, lengths)):
        c = c[:ln].astype(np.uint64)
        n = ln - k + 1
        if n <= 0:
            continue
        fwd = np.zeros(n, np.uint64)
        rev = np.zeros(n, np.uint64)
        for j in range(k):
            fwd = (fwd << np.uint64(2)) | c[j:j + n]
            rev |= (np.uint64(3) - c[j:j + n]) << np.uint64(2 * j)
        vals.append(np.minimum(fwd, rev))
        rows.append(np.full(n, r, np.int64))
        pos.append(np.arange(n, dtype=np.int64))
    return np.concatenate(vals), np.concatenate(rows), np.concatenate(pos)


def count_oracle(batches, k: int):
    """(keys, counts, first read number, first position) over batches of
    (codes, lengths, read-number offset), keys ascending; read numbers are
    offset + row."""
    vals, coord = [], []
    for codes, lengths, offset in batches:
        v, r, p = canonical_np(codes, lengths, k)
        vals.append(v)
        coord.append(((r + offset).astype(np.uint64) << np.uint64(32))
                     | p.astype(np.uint64))
    vals, coord = np.concatenate(vals), np.concatenate(coord)
    keys, inv, counts = np.unique(vals, return_inverse=True,
                                  return_counts=True)
    first = np.full(keys.size, np.iinfo(np.uint64).max, np.uint64)
    np.minimum.at(first, inv, coord)
    return (keys, counts.astype(np.uint32),
            (first >> np.uint64(32)).astype(np.uint32),
            (first & np.uint64(0xFFFFFFFF)).astype(np.uint32))
