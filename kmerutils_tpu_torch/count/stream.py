"""Streaming whole-file counting: the sorted count table and its fold.

Port of kmerutils_tpu/count/stream.py.  The table is a sorted run of
entries with pending duplicates; each batch goes through

  batch      ->  the batch's valid canonical k-mers by kernel KC
                 (ops/count_prefix.py), then one ``torch.sort`` of them
                 (one entry per valid position, count 1 each)
  fold       ->  ONE merge of (table, batch) by kernel K3
                 (ops/merge.merge_fold); duplicate keys coexist as separate
                 entries
  compact    ->  when entries approach capacity, or pending duplicates
                 outgrow the amortized bound: ONE aggregation by kernel K4
                 (ops/merge.aggregate_fold)
  finalize   ->  the same aggregation with the count-range filter, then ONE
                 copy to the host

Entries (ops/merge.py): ``key`` int32 (u32 bit patterns, k <= 16) or int64
(u64 bit patterns, k 17..32), ``cnt`` int32 (u32), ``crd`` int64
(``read_num << 32 | pos``) or None; ascending by unsigned key over the live
prefix [0, used), anything past it unspecified.  Unlike the JAX table, keys
carry no +1 bias and no sign flip, and a fold merges into a second buffer
(the kernels never work in place), so two tables' worth of device memory
are in use while a fold or compaction runs.

Counts are exact, saturating at 2^32 - 1.  Overflow beyond capacity drops
the LARGEST keys deterministically, counted in ``n_dropped`` (entry
granularity: a dropped entry may be a duplicate of a surviving key, so the
distinct-key drop count is <= n_dropped).  Within a run of equal keys entry
order is arbitrary after merges, so a run's coordinate is its minimum.

``used``, ``last_distinct`` and ``grow_hint`` live on the host: the fold's
compaction policy reads them without a device round trip, and a compaction
costs one ``.item()`` for its live count.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .. import obs
from ..base.sequence import ReadBatch
from ..ops import count_prefix, merge
from ..ops.bitops import M32, flip32, flip64

# one batch is capped at 8M padded bases (io/fastx.read_batches); the
# auto-compact threshold keeps this much headroom so a fold can never
# overflow between compactions
BATCH_CAP = 9 << 20


@dataclasses.dataclass(frozen=True)
class StreamCountTable:
    """Sorted entry table with pending duplicates (see module docstring).

    key, cnt, crd: entry arrays of ``capacity`` entries; only [0, used) is
    meaningful.
    used:          occupied entries (live rows incl. duplicates).
    n_dropped:     entries dropped past capacity (largest keys first).
    grow_hint:     1 when the last fold ran a compaction AND the fresh
                   distinct count is within the fold headroom of capacity
                   (the growth / spill signal of cli/parsefastq).
    last_distinct: distinct count at the last compaction (drives the
                   amortized compaction trigger).
    """

    key: torch.Tensor
    cnt: torch.Tensor
    crd: torch.Tensor | None
    used: int = 0
    n_dropped: int = 0
    grow_hint: int = 0
    last_distinct: int = 0

    @property
    def capacity(self) -> int:
        return self.key.numel()

    @property
    def wide(self) -> bool:
        return self.key.dtype == torch.int64

    @property
    def coords(self) -> bool:
        return self.crd is not None

    @property
    def device(self) -> torch.device:
        return self.key.device

    @staticmethod
    def create(capacity: int, wide: bool, coords: bool,
               device="cuda") -> "StreamCountTable":
        dev = torch.device(device)
        key_dt = torch.int64 if wide else torch.int32
        return StreamCountTable(
            key=torch.empty(capacity, dtype=key_dt, device=dev),
            cnt=torch.empty(capacity, dtype=torch.int32, device=dev),
            crd=(torch.empty(capacity, dtype=torch.int64, device=dev)
                 if coords else None))


def batch_entries(batch: ReadBatch, k: int, read_indices,
                  coords: bool = False):
    """One batch's sorted run for :func:`fold`: (key, crd) with one entry
    per valid k-mer position, ascending by unsigned key (count 1 each,
    implicit).  ``crd`` is None without coordinates, else read_num << 32 |
    pos with read_num = ``read_indices[row]`` (the batch's map from rows to
    read numbers in file order, io/fastx.read_batches).

    The valid positions' keys come compacted at the rows' offsets and in
    the sort's form from kernel KC (ops/count_prefix.py), then one sort (4
    bytes a key for k <= 16, 8 above; stable with coordinates) and one xor
    back to the table's bit patterns.  The offsets come from
    ``batch.host_lengths`` (a batch moved from the host, as ingest moves
    it), and they and the read numbers go up through pinned memory, so
    nothing waits for the device; a batch made on the device without them
    costs one read of its lengths.  Span ``count.entries``, over rows x
    positions.
    """
    host = (batch.host_lengths if batch.host_lengths is not None
            else batch.lengths.cpu())
    offs = count_prefix.offsets(host, k)
    p = max(batch.max_len - k + 1, 1)
    with obs.span("count.entries", batch.n_reads * p, batch.device):
        skeys, flat = count_prefix.count_prefix(batch.words, batch.lengths,
                                                k, offs, coords)
        crd = None
        if coords:
            skeys, perm = torch.sort(skeys, stable=True)
            flat = flat[perm]
            rows = count_prefix.upload(torch.as_tensor(
                np.asarray(read_indices, np.int64)), skeys.device)
            crd = (rows[flat // p] << 32) | (flat % p)
        else:
            skeys = torch.sort(skeys).values
        key = flip64(skeys) if k > 16 else flip32(skeys)
    return key, crd


def compact(table: StreamCountTable) -> StreamCountTable:
    """Aggregate the table's runs (kernel K4): ``used`` becomes the
    distinct count.  Never filters by count range: mid-stream compaction
    must keep every run (finalize applies lo/hi on its own aggregation).
    Span ``count.compact`` (entries in plus out), counter
    ``count.compactions`` (the distinct count)."""
    with obs.span("count.compact", table.used, table.device) as sp:
        key, cnt, crd, n_live = merge.aggregate_fold(table.key, table.cnt,
                                                     table.crd, table.used)
        if sp is not None:
            sp.work += n_live
    obs.count("count.compactions", n_live)
    return dataclasses.replace(table, key=key, cnt=cnt, crd=crd, used=n_live,
                               last_distinct=n_live)


def fold(table: StreamCountTable, run) -> StreamCountTable:
    """Merge one sorted run (from :func:`batch_entries` or a StagedFolder
    merge) into the table; compacts first when occupancy approaches
    capacity or pending duplicates pass the amortized bound.  The policy
    is the JAX fold's, over the run's length.  Span ``count.fold`` around
    K3 (entries in plus out); counters ``count.folds`` (the run's entries)
    and ``count.used`` (the table's entries after it)."""
    b_key, b_crd = run
    nb = b_key.numel()
    S = table.capacity
    # F bounds this fold's entries (a plain batch is < BATCH_CAP; a
    # StagedFolder run spans up to 2^depth batches).  The headroom keeps
    # the no-drop induction of the JAX fold: the hint is raised only at a
    # compaction, and the last hint-free fold, the raising fold and one
    # fold of host lag (cli/parsefastq reads the hint one fold late) add
    # <= 3F, so H = 3F + one batch of margin.
    F = max(nb, BATCH_CAP)
    headroom = min(3 * F + BATCH_CAP, S // 2)
    # amortized trigger: pending duplicates P cost every fold O(D + P);
    # compacting at P* = 2 * sqrt(D * F) balances the two (stream.py of the
    # JAX package), computed in float32 as there
    d_f32 = np.float32(max(table.last_distinct, 1))
    pend_cap = int(np.float32(2.0) * np.sqrt(d_f32 * np.float32(F)))
    hint = 0
    if (table.used + nb > S - headroom
            or table.used > table.last_distinct + pend_cap):
        table = compact(table)
        # table.used is now the true DISTINCT count
        hint = int(table.used + nb > S - headroom)
    n_in = table.used + nb
    with obs.span("count.fold", n_in + min(n_in, S), table.device):
        key, cnt, crd, n_out = merge.merge_fold(table.key, table.cnt,
                                                table.crd, table.used, b_key,
                                                b_crd, S)
    obs.count("count.folds", nb)
    obs.count("count.used", n_out)
    dropped = max(n_in - S, 0)
    return dataclasses.replace(table, key=key, cnt=cnt, crd=crd, used=n_out,
                               n_dropped=table.n_dropped + dropped,
                               grow_hint=hint)


class StagedFolder:
    """LSM-style staging in front of :func:`fold`.

    A fold re-reads the table's whole live prefix, O(used).  Staging merges
    ``2**depth`` consecutive batch runs into ONE sorted run first (kernel
    K5, binary-counter style: each entry passes through ``depth`` O(batch)
    merges), so the table pays its O(used) re-read once per ``2**depth``
    batches.  Fold order does not change results: counts are sums and run
    coordinates are minima.

    ``depth`` defaults by CURRENT table capacity (re-evaluated each push,
    so a grown table deepens its staging) such that the fold's drop-safety
    margins hold (6 * 2**depth * BATCH_CAP <= capacity): 0 below 2^27-entry
    tables, 1 at 2^27, 2 at 2^28 and above.  Assign ``.table`` directly for
    host-driven transitions (grow, spill); staged runs carry over.
    """

    MAX_DEPTH = 2

    def __init__(self, table: StreamCountTable, depth: int | None = None):
        self.table = table
        self._depth = depth
        self._runs: list = []     # [level, run]; levels strictly
        #                           decreasing bottom-to-top of the stack

    @property
    def depth(self) -> int:
        if self._depth is not None:
            return self._depth
        d = 0
        while (d < self.MAX_DEPTH
               and 6 * (2 << d) * BATCH_CAP <= self.table.capacity):
            d += 1
        return d

    def push(self, run) -> bool:
        """Stage one batch's sorted run (from :func:`batch_entries`);
        returns True when a table fold was issued (the caller's cue to
        read ``table.grow_hint``).  Span ``count.stage`` around each K5
        merge (entries in plus out)."""
        self._runs.append([0, run])
        while (len(self._runs) >= 2
               and self._runs[-1][0] == self._runs[-2][0]):
            lvl, b = self._runs.pop()
            _, a = self._runs.pop()
            n = a[0].numel() + b[0].numel()
            with obs.span("count.stage", 2 * n, b[0].device):
                ab = merge.merge_sorted(*a, *b)
            self._runs.append([lvl + 1, ab])
        if self._runs[0][0] >= self.depth:
            _, a = self._runs.pop()
            self.table = fold(self.table, a)
            return True
        return False

    def flush(self) -> StreamCountTable:
        """Fold any staged remainder (end of stream) and return the table."""
        while self._runs:
            _, a = self._runs.pop()
            self.table = fold(self.table, a)
        return self.table


def grow(table: StreamCountTable, new_capacity: int) -> StreamCountTable:
    """Grow the table's capacity: live entries are a contiguous prefix, so
    growth is one allocation and one copy of [0, used) — no re-sort, no
    merge.  Callers start small and grow x8 only when occupancy stays high
    after compaction (see cli/parsefastq)."""
    if new_capacity <= table.capacity:
        return table
    big = StreamCountTable.create(new_capacity, table.wide, table.coords,
                                  table.device)
    u = table.used
    for dst, src in ((big.key, table.key), (big.cnt, table.cnt),
                     (big.crd, table.crd)):
        if src is not None:
            dst[:u] = src[:u]
    # occupancy is far from the NEW capacity by construction; a stale
    # raised hint would re-trigger growth/spill immediately
    return dataclasses.replace(table, key=big.key, cnt=big.cnt, crd=big.crd,
                               grow_hint=0)


def finalize(table: StreamCountTable, min_count: int = 1,
             max_count: int | None = None, count_clamp: int | None = None,
             phases: dict | None = None):
    """Aggregate + filter + compact on the device (kernel K4), then one copy
    to the host.

    Returns numpy (keys u32/u64, counts, read_nums u32, positions u32,
    n_dropped) ascending by key (read_nums/positions all zero when the
    table tracks no coordinates).  ``count_clamp`` saturates counts to
    0xFF/0xFFFF and returns them as uint8/uint16, as the dump formats
    store them.  Keys come back whole: the JAX version's delta-encoded key
    transfer was built for a slow host link and is not ported.

    ``phases``, a dict, gets added to it, as in the JAX version:
    ``agg_s``, wall seconds from entry until the live count is on the host
    (K4 and its read of ``n``); ``records``, that count; ``xfer_s``, wall
    seconds of the copies to the host and their unpacking (not added when
    nothing is live, as the JAX version copies nothing then).  It adds no
    synchronisation: K4 already reads ``n`` and the copies already wait.
    """
    t0 = time.perf_counter() if phases is not None else 0.0
    key, cnt, crd, n = merge.aggregate_fold(table.key, table.cnt, table.crd,
                                            table.used, lo=min_count,
                                            hi=max_count)
    if phases is not None:
        t1 = time.perf_counter()
        phases["agg_s"] = phases.get("agg_s", 0.0) + (t1 - t0)
        phases["records"] = phases.get("records", 0) + n
    keys = key[:n].cpu().numpy()
    keys = keys.view(np.uint64) if table.wide else keys.view(np.uint32)
    counts = cnt[:n].cpu().numpy().view(np.uint32)
    if table.coords:
        c = crd[:n].cpu().numpy().view(np.uint64)
        rn = (c >> np.uint64(32)).astype(np.uint32)
        ps = (c & np.uint64(M32)).astype(np.uint32)
    else:
        rn = np.zeros(n, np.uint32)
        ps = np.zeros(n, np.uint32)
    # K4 applied the count range; the clamp is the host's
    keys, counts, rn, ps = _in_range(keys, counts, rn, ps, clamp=count_clamp)
    if phases is not None and n:
        phases["xfer_s"] = phases.get("xfer_s", 0.0) \
            + (time.perf_counter() - t1)
    return keys, counts, rn, ps, int(table.n_dropped)


class StreamCounter:
    """The port's counting loop over a stream of batches already on the
    device: :func:`batch_entries`, a :class:`StagedFolder`, the growth
    ladder and the spill switch (what ``parsefastq kmer`` runs, and what
    parallel/stream.ShardedStreamCounter runs on each rank over the runs
    its exchange receives).

    The table starts at ``min(capacity_max, 2^26)`` entries in ``folder``
    (staged by capacity).  Each fold's ``grow_hint`` is acted on one fold
    late (the headroom of :func:`fold` is sized for that lag): a raised
    hint grows the table x8, up to ``capacity_max``; at ``capacity_max`` it
    ships the table's aggregated runs to a disk segment (``count/spill.py``)
    and restarts the table empty, or, with ``spill=False``, lets the
    largest keys drop (counted in ``n_dropped``).

    It reads the device at one ``.item()`` a compaction (the distinct
    count); a spill and :meth:`finish` copy the table to the host.  A batch
    made on the device, without ``host_lengths`` (``ReadBatch``), costs
    one more read, of its lengths (:func:`batch_entries`); batches from
    ingest carry them.  Nothing else waits for the device.

    Spans (``obs.py``, off unless ``obs.sink`` is set): ``count.entries``
    (kernel KC's valid canonical k-mers and the batch sort; work: rows x
    positions), ``count.stage`` (K5), ``count.fold`` (K3) and
    ``count.compact`` (K4), each of the last three over entries in plus
    entries out.  Counters (``obs.count``): ``count.folds`` (a fold's run
    entries), ``count.used`` (the table's entries after each fold),
    ``count.compactions`` (the distinct count after each), ``count.grows``
    (the new capacity) and ``count.spills`` (the entries spilled).
    """

    def __init__(self, k: int, coords: bool = False,
                 capacity_max: int = 1 << 26, device="cuda",
                 spill: bool = True):
        self.k = k
        self.coords = coords
        self._start(StreamCountTable.create(
            min(capacity_max, 1 << 26), wide=k > 16, coords=coords,
            device=device), capacity_max, spill)

    def _start(self, table: StreamCountTable, capacity_max: int,
               spill: bool, depth: int | None = None,
               spill_dir: str | None = None) -> None:
        """The loop's state from its first ``table``: staged at ``depth``
        (None: by capacity), spill segments under ``spill_dir`` (None: the
        system's temporary directory)."""
        self.capacity_max = capacity_max
        self.spill = spill
        self.folder = StagedFolder(table, depth)
        self.spill_store = None
        self._spill_dir = spill_dir
        self.n_segments = 0        # spill segments merged by finish
        self.pushes = 0
        self.grown_at: list = []   # (pushes, new capacity) of each growth
        self._pending: list = []   # hints of the folds not acted on yet

    @property
    def table(self) -> StreamCountTable:
        return self.folder.table

    @property
    def capacity(self) -> int:
        return self.folder.table.capacity

    def add(self, batch: ReadBatch, read_indices) -> None:
        """Count one batch; ``read_indices`` maps its rows to read numbers
        (used only with coordinates)."""
        self._add_run(batch_entries(batch, self.k, read_indices,
                                    coords=self.coords))

    def _add_run(self, run) -> None:
        """Stage one sorted run; after each table fold, act on the hint
        that :meth:`_hint` reads."""
        self.pushes += 1
        if self.folder.push(run) and self._hint():
            self._ladder()

    def _hint(self) -> int:
        """The grow hint to act on after a fold: the previous fold's (lag
        1)."""
        self._pending.append(self.folder.table.grow_hint)
        return self._pending.pop(0) if len(self._pending) > 1 else 0

    def _ladder(self) -> None:
        """Grow the table x8 toward ``capacity_max``; past it, spill (or,
        without ``spill``, let the largest keys drop)."""
        table = self.folder.table
        if table.capacity < self.capacity_max:
            capacity = min(table.capacity * 8, self.capacity_max)
            self.folder.table = grow(table, capacity)
            self.grown_at.append((self.pushes, capacity))
            obs.count("count.grows", capacity)
        elif self.spill:
            self._spill()
        else:
            return
        # hints still queued were computed against the old table
        self._pending.clear()

    def _spill(self) -> None:
        """Ship the table's aggregated runs to a disk segment and restart
        it empty."""
        from .spill import SpillStore
        table = self.folder.table
        if self.spill_store is None:
            self.spill_store = SpillStore(wide=table.wide,
                                          coords=table.coords,
                                          tmpdir=self._spill_dir)
        obs.count("count.spills", table.used)
        self.folder.table = self.spill_store.spill_table(table)

    def flush(self) -> StreamCountTable:
        """Fold the staged remainder; returns the table."""
        return self.folder.flush()

    def finish(self, min_count: int = 1, max_count: int | None = None,
               count_clamp: int | None = None):
        """End of stream: :meth:`flush`, then the counts with ``min_count
        <= count <= max_count``, clamped as :func:`finalize` clamps them.
        Returns (blocks, n_dropped): blocks yields (keys, counts,
        read_nums, positions) in ascending key order, one block from
        :func:`finalize` when nothing was spilled; else the final table
        joins the spill segments and blocks is their k-way merge (set
        :attr:`n_segments`), which removes the segments once read."""
        table = self.flush()
        store = self.spill_store
        if store is None or not store.n_segments:
            keys, counts, rn, ps, dropped = finalize(table, min_count,
                                                     max_count, count_clamp)
            return iter([(keys, counts, rn, ps)]), dropped
        store.spill_table(table)
        self.n_segments = store.n_segments
        return _merged(store, min_count, max_count, count_clamp), \
            store.n_dropped


def _in_range(keys, counts, rn, ps, lo: int = 1, hi: int | None = None,
             clamp: int | None = None):
    """The host block's entries with ``lo <= count <= hi`` (every entry
    counts at least 1), counts clamped to ``clamp`` and returned as uint8
    (``clamp`` <= 0xFF) or uint16, as the dump formats store them."""
    if lo > 1 or hi is not None:
        sel = counts >= lo
        if hi is not None:
            sel &= counts <= hi
        keys, counts, rn, ps = keys[sel], counts[sel], rn[sel], ps[sel]
    if clamp is not None:
        dt = np.uint8 if clamp <= 0xFF else np.uint16
        counts = np.minimum(counts, np.uint32(clamp)).astype(dt)
    return keys, counts, rn, ps


def _merged(store, lo: int, hi: int | None, clamp: int | None):
    """The spill store's merged blocks, filtered and clamped by
    :func:`_in_range`; closes the store at the end."""
    try:
        for block in store.merge_stream():
            yield _in_range(*block, lo, hi, clamp)
    finally:
        store.close()


def table_from_jax(arrs, used: int, n_dropped: int, last_distinct: int,
                   wide: bool, coords: bool, cap: int, grow_hint: int = 0,
                   device="cuda") -> StreamCountTable:
    """The port's table from a JAX ``StreamCountTable``'s state.

    ``arrs`` are the JAX table's kernel-native int32 words as numpy arrays
    (compare words XOR 0x80000000, keys biased +1, see
    kmerutils_tpu/count/stream.py): (key[, key_lo], cnt[, read, pos]);
    the other arguments are its scalar leaves and static fields.  Only the
    live prefix [0, used) is carried over, so a stream the JAX package
    began can be continued here.
    """
    kw = 2 if wide else 1
    w = [np.asarray(a).view(np.uint32)[:used] for a in arrs]
    if len(w) != kw + 1 + (2 if coords else 0):
        raise ValueError(f"{len(w)} word arrays for wide={wide}, "
                         f"coords={coords}")
    flip = np.uint32(0x80000000)
    if wide:
        key = ((((w[0] ^ flip).astype(np.uint64) << np.uint64(32))
                | (w[1] ^ flip)) - np.uint64(1)).view(np.int64)
    else:
        key = ((w[0] ^ flip) - np.uint32(1)).view(np.int32)
    table = StreamCountTable.create(cap, wide, coords, device)
    table.key[:used] = torch.from_numpy(key.copy())
    table.cnt[:used] = torch.from_numpy(w[kw].view(np.int32).copy())
    if coords:
        crd = (w[kw + 1].astype(np.uint64) << np.uint64(32)) | w[kw + 2]
        table.crd[:used] = torch.from_numpy(crd.view(np.int64).copy())
    return dataclasses.replace(table, used=int(used),
                               n_dropped=int(n_dropped),
                               grow_hint=int(grow_hint),
                               last_distinct=int(last_distinct))
