"""Sharded streaming counting: the production multi-device counting engine.

Port of kmerutils_tpu/parallel/stream.py.  count/stream.py owns the
counting loop (StreamCounter: kernel K3 folds, K4 compactions and
finalize, K5 staging merges, growth, disk spill); this module runs that
loop on every rank of the group, with k-mer space hash-partitioned over
the ranks.  What only sharding needs stays here:

  exchange  ->  each rank extracts and canonicalizes its own reads'
                k-mers, routes them by shard id (count/dispatch.py) through
                ONE bucketed ``all_to_all_single``, and sorts what it
                received into a run in count/stream.py's entry layout
                (count 1 each, optional coordinates; no +1 key bias and no
                sign flip: those were the TPU kernels' layout)
  hints     ->  each fold's grow hint stays on its rank; the ranks'
                hints are max-reduced at the host's lag-1 sample points
                (every ``hint_every`` folds), so every rank grows and
                spills at the same fold
  drops     ->  the in-transit drop counts are sum-reduced on every call
  finalize  ->  each rank finishes its shard; the union of the shards
                needs a group of one rank.

JAX builds a jitted program per shape for each step (the exchange, the
fold, the staging merge, the drop and hint reductions) and caches them in
``_PROG_CACHE``; eager PyTorch compiles nothing per shape, so each is a
plain function called per batch: :func:`exchange`, count/stream.fold,
ops/merge.merge_sorted, :func:`drop_reduce` and :func:`hint_reduce`.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..base.sequence import ReadBatch
from ..count import exact, stream
from ..ops.bitops import M32
from . import collective
from .mesh import Mesh


def sharded_stream_create(capacity_per_device: int, mesh: Mesh,
                          wide: bool = False, coords: bool = False
                          ) -> stream.StreamCountTable:
    """This rank's streaming count table (count/stream.py) on its device:
    it only ever holds k-mers of shard ``rank`` (disjoint from every other
    rank's, like the reference's counter pool)."""
    return stream.StreamCountTable.create(capacity_per_device, wide, coords,
                                          mesh.device)


def exchange(batch: ReadBatch, k: int, mesh: Mesh, wide: bool, coords: bool,
             read_num_offset: int = 0, shard_cap_factor: float = 1.5):
    """Route this rank's k-mers to their shards and return the run it
    received: ((key, crd), dropped).

    key holds the received live entries ascending by unsigned key (int64 u64
    bit patterns when ``wide``, else int32 u32 bit patterns; k > 16 needs
    ``wide``), count 1 each; crd is None or ``read_num << 32 | pos`` with
    read_num = read_num_offset + rank * n_local + row (JAX's rule for a
    reads-sharded batch).  ``dropped`` (0-d int64 tensor) counts the entries
    this rank could not send: bucket overflow, zero in any correctly sized
    run.  A collective: every rank calls it with its own batch of the same
    row count and width.
    """
    if k > 16 and not wide:
        raise ValueError(f"k={k} needs a wide (u64) table")
    keys, sid, live, (n_local, p) = collective._keys_and_shards(
        batch, k, mesh.world)
    if wide and keys.dtype == torch.int32:
        keys = torch.where(live, keys.to(torch.int64) & M32, -1)
    cap = collective.shard_capacity(n_local, p, mesh.world, shard_cap_factor)
    payloads = [keys]
    if coords:
        idx = torch.arange(n_local * p, dtype=torch.int64, device=keys.device)
        rn = idx // p + (read_num_offset + mesh.rank * n_local)
        payloads.append(torch.where(live, (rn << 32) | (idx % p), -1))
    buckets, dropped = collective._bucketize_by_shard(payloads, sid,
                                                      mesh.world, cap)
    recv = [collective._all_to_all(b) for b in buckets]
    keep = recv[0] != -1
    key = recv[0][keep]
    s, perm = torch.sort(exact._carrier(key), stable=True)
    crd = recv[1][keep][perm] if coords else None
    return (exact._uncarry(s, key.dtype), crd), dropped


def drop_reduce(mesh: Mesh, dropped) -> int:
    """The group's sum of the ranks' in-transit drop counts (a collective:
    every rank must call it at the same point)."""
    t = torch.as_tensor(dropped, dtype=torch.int64).reshape(1).to(mesh.device)
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return int(t.item())


def hint_reduce(mesh: Mesh, hint: int) -> int:
    """The group's maximum of the ranks' grow hints: the one agreement the
    growth ladder needs (a collective, launched at the host's sample
    points)."""
    t = torch.tensor([int(hint)], dtype=torch.int64, device=mesh.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return int(t.item())


def sharded_grow(table: stream.StreamCountTable, new_capacity: int,
                 mesh: Mesh) -> stream.StreamCountTable:
    """Grow this rank's table (count/stream.grow); every rank calls it at
    the same fold, so all shards keep one capacity."""
    del mesh
    return stream.grow(table, new_capacity)


def local_shard_tables(table: stream.StreamCountTable, mesh: Mesh):
    """Yield (shard, table) for every shard this process holds: one, its
    own rank's."""
    yield mesh.rank, table


def finalize_local(table: stream.StreamCountTable, mesh: Mesh,
                   min_count: int = 1, max_count: int | None = None,
                   count_clamp: int | None = None) -> dict:
    """This rank's finalized shard: {rank: (keys, counts, read_nums,
    positions, dropped)} with keys ascending (count/stream.finalize)."""
    return {r: stream.finalize(t, min_count, max_count, count_clamp)
            for r, t in local_shard_tables(table, mesh)}


def _needs_one_rank(mesh: Mesh, what: str) -> None:
    if mesh.world > 1:
        raise RuntimeError(f"{what} needs every shard in this process; each "
                           "rank of a larger group calls finalize_local")


def finalize_union(table: stream.StreamCountTable, mesh: Mesh,
                   min_count: int = 1, max_count: int | None = None,
                   count_clamp: int | None = None):
    """The union of every shard, keys ascending (the KmerCounterPool
    union): only a group of one rank holds every shard, and its one shard
    is the union, so no concatenation or sort is left to do."""
    _needs_one_rank(mesh, "finalize_union")
    return finalize_local(table, mesh, min_count, max_count,
                          count_clamp)[mesh.rank]


class ShardedStreamCounter(stream.StreamCounter):
    """The multi-device ``parsefastq --count`` engine: one hash-sharded
    merge-fold table per rank, each run by count/stream.StreamCounter's
    loop (staging, the growth ladder, disk spill, the ``count.*`` spans
    and counters).

    :meth:`update` routes this rank's batch (ONE all_to_all) and hands the
    received run to the loop, which stages it and folds every 2**depth
    batches.  A fold's grow hint stays on its rank; the ranks max-reduce
    the hints of fold i - 1 after fold i (lag 1, as the one-device counter
    reads them; ``hint_every`` samples sparser on a stream whose capacity
    is sized in advance), so they all take the same decision: grow every
    table x8 toward ``cap_max_per_device``, then, past the ladder, spill
    every table to its rank's disk segments and restart it empty.  Every
    rank must call :meth:`update` for every batch, and
    :meth:`finalize_local` at the end, as with any collective.
    """

    def __init__(self, mesh: Mesh, capacity_per_device: int, *,
                 wide: bool = False, coords: bool = False,
                 cap_max_per_device: int | None = None,
                 depth: int | None = None, spill: bool = True,
                 spill_dir: str | None = None,
                 shard_cap_factor: float = 1.5,
                 hint_every: int = 1):
        self.mesh = mesh
        self.wide, self.coords = wide, coords
        self._start(sharded_stream_create(capacity_per_device, mesh, wide,
                                          coords),
                    cap_max_per_device or capacity_per_device, spill, depth,
                    spill_dir)
        self._shard_cap_factor = shard_cap_factor
        self.hint_every = max(1, hint_every)
        self._fold_i = 0
        # this rank's in-transit drops (device, never reset) and the group's
        # total at the last reduction
        self._local_dropped = torch.zeros((), dtype=torch.int64,
                                          device=mesh.device)
        self.dropped_in_transit = 0

    @property
    def depth(self) -> int:
        """Staging depth: as given, else by the table's CURRENT capacity
        (count/stream.StagedFolder's rule)."""
        return self.folder.depth

    # -- streaming --------------------------------------------------------
    def update(self, batch: ReadBatch, k: int,
               read_num_offset: int = 0) -> None:
        """Route and stage this rank's batch; folds, growth and spill run
        as the staging and the reduced hints dictate."""
        run, dropped = exchange(batch, k, self.mesh, self.wide, self.coords,
                                read_num_offset, self._shard_cap_factor)
        self._local_dropped += dropped
        self._add_run(run)

    def _hint(self) -> int:
        """The group's maximum of the ranks' lagged hints on every
        ``hint_every``-th fold, else 0."""
        self._pending.append(self.table.grow_hint)
        self._fold_i += 1
        if len(self._pending) < 2 or self._fold_i % self.hint_every:
            return 0
        # _fold_i moves in lockstep on every rank, so every rank enters the
        # reduction at the same folds
        h = hint_reduce(self.mesh, self._pending.pop(0))
        self._pending = self._pending[-1:]
        return h

    def spill_shards(self) -> None:
        """Ship this rank's aggregated table to its disk segment store and
        restart the table empty."""
        self._spill()

    def flush(self) -> stream.StreamCountTable:
        """Fold any staged remainder (end of stream) as the one-device
        counter does, with no collective; returns the table."""
        return super().flush()

    # -- collection -------------------------------------------------------
    def reduce_in_transit_drops(self) -> int:
        """The group's total of in-transit drops (all_to_all bucket
        overflow, counted by the sender), stored in ``dropped_in_transit``
        and returned.  It reduces on EVERY call on every rank, so the group
        never splits between ranks that enter the reduction and ranks that
        do not (the JAX version enters it only while its accumulator is not
        yet a host int).  A collective: :meth:`finalize_local` calls it."""
        self.dropped_in_transit = drop_reduce(self.mesh,
                                              self._local_dropped.clone())
        return self.dropped_in_transit

    def finalize_local(self, min_count: int = 1,
                       max_count: int | None = None,
                       count_clamp: int | None = None) -> dict:
        """This rank's results after :meth:`flush`: {rank: (keys, counts,
        read_nums, positions, dropped)}, keys ascending
        (count/stream.StreamCounter.finish: after spill epochs the rank's
        final table joins its segments, which are merged k-way with the
        count range applied after the merge, and removed).  Also reduces
        the in-transit drops into ``dropped_in_transit`` (the per-shard
        ``dropped`` counts the table's drops only)."""
        self.flush()
        self.reduce_in_transit_drops()
        blocks, dropped = self.finish(min_count, max_count, count_clamp)
        cols = [c[0] if len(c) == 1 else np.concatenate(c)
                for c in zip(*blocks)]
        return {self.mesh.rank: (*cols, dropped)}

    def finalize(self, min_count: int = 1, max_count: int | None = None,
                 count_clamp: int | None = None):
        """The union of every shard, keys ascending, for a group of one
        rank, whose one shard it is (raises on a larger group before any
        work, as JAX raises on several processes)."""
        _needs_one_rank(self.mesh, "finalize")
        return self.finalize_local(min_count, max_count,
                                   count_clamp)[self.mesh.rank]

    def close(self) -> None:
        if self.spill_store is not None:
            self.spill_store.close()
            self.spill_store = None
