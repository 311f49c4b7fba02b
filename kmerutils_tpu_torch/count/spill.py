"""Host spill segments: exact counting beyond device-table capacity.

Port of kmerutils_tpu/count/spill.py (host numpy, over the port's
:func:`stream.finalize`):

  spill     ->  when the growth ladder tops out, ONE aggregation on the
                device (stream.finalize, min_count=1) ships the table's
                distinct runs to the host; the sorted segment goes to disk
                (np.memmap-readable raw arrays) and the device table
                restarts empty at full capacity.
  merge     ->  at end of stream the segments (each sorted by key, keys
                distinct within a segment) are k-way merged in bounded
                memory: per step, a pivot key caps every segment's take at
                ``chunk`` entries, the takes are concatenated + sorted, and
                runs are aggregated (counts: saturating u32 sum; coords:
                min packed (read, pos) = first occurrence in scan order).

The merged stream is exact: every (key, total count, first coordinate) is
what an unbounded table would produce.
"""

from __future__ import annotations

import os
import shutil
import tempfile

import numpy as np

from . import stream

U32MAX = np.uint64(0xFFFFFFFF)


class SpillStore:
    """Disk-backed sorted segments of aggregated (key, count[, coord]) runs.

    ``wide`` selects u64 keys, ``coords`` carries first-occurrence
    (read_num, pos) per key, as in the table.
    """

    def __init__(self, wide: bool, coords: bool, tmpdir: str | None = None):
        self.wide = wide
        self.coords = coords
        self.dir = tempfile.mkdtemp(prefix="ktp_spill_", dir=tmpdir)
        self._segments: list[dict] = []
        self.total_records = 0
        self.n_dropped = 0

    @property
    def n_segments(self) -> int:
        return len(self._segments)

    def add_segment(self, keys, counts, read_nums=None, positions=None):
        """Persist one sorted-distinct-key segment to disk."""
        n = len(keys)
        if n == 0:
            return
        kdt = np.uint64 if self.wide else np.uint32
        seg = {"n": n}
        base = os.path.join(self.dir, f"seg{len(self._segments):04d}")
        np.ascontiguousarray(keys, dtype=kdt).tofile(base + ".k")
        np.ascontiguousarray(counts, dtype=np.uint32).tofile(base + ".c")
        seg["k"] = np.memmap(base + ".k", dtype=kdt, mode="r")
        seg["c"] = np.memmap(base + ".c", dtype=np.uint32, mode="r")
        if self.coords:
            np.ascontiguousarray(read_nums, np.uint32).tofile(base + ".r")
            np.ascontiguousarray(positions, np.uint32).tofile(base + ".p")
            seg["r"] = np.memmap(base + ".r", dtype=np.uint32, mode="r")
            seg["p"] = np.memmap(base + ".p", dtype=np.uint32, mode="r")
        self._segments.append(seg)
        self.total_records += n

    def spill_table(self, table: stream.StreamCountTable
                    ) -> stream.StreamCountTable:
        """Ship the table's aggregated contents here; return a fresh empty
        table of the same capacity on the same device."""
        keys, counts, rn, ps, dropped = stream.finalize(table, min_count=1)
        self.n_dropped += dropped
        self.add_segment(keys, counts, rn if self.coords else None,
                         ps if self.coords else None)
        return stream.StreamCountTable.create(
            table.capacity, wide=table.wide, coords=table.coords,
            device=table.device)

    def merge_stream(self, chunk: int = 1 << 24):
        """Yield globally aggregated (keys, counts, read_nums, positions)
        blocks in ascending key order, bounded by ~chunk*n_segments entries
        of working memory per step.  Counts saturate at 2^32-1 (the device
        table's own saturation); coordinates are per-key minima (first
        occurrence in scan order)."""
        segs = self._segments
        cursors = [0] * len(segs)
        lens = [s["n"] for s in segs]
        while True:
            active = [i for i in range(len(segs)) if cursors[i] < lens[i]]
            if not active:
                return
            # pivot: smallest "chunk-th key ahead" across active segments.
            # Every segment's take of keys <= pivot is then <= chunk entries
            # (keys are distinct and ascending within a segment), and no key
            # can straddle a step boundary.
            pivot = min(segs[i]["k"][min(cursors[i] + chunk, lens[i]) - 1]
                        for i in active)
            pk, pc, pr, pp = [], [], [], []
            for i in active:
                lo = cursors[i]
                hi = int(np.searchsorted(segs[i]["k"], pivot, side="right"))
                if hi > lo:
                    pk.append(np.asarray(segs[i]["k"][lo:hi]))
                    pc.append(np.asarray(segs[i]["c"][lo:hi]))
                    if self.coords:
                        pr.append(np.asarray(segs[i]["r"][lo:hi]))
                        pp.append(np.asarray(segs[i]["p"][lo:hi]))
                    cursors[i] = hi
            keys = np.concatenate(pk)
            counts = np.concatenate(pc)
            order = np.argsort(keys, kind="stable")
            keys, counts = keys[order], counts[order]
            starts = np.flatnonzero(
                np.concatenate([[True], keys[1:] != keys[:-1]]))
            csum = np.add.reduceat(counts.astype(np.uint64), starts)
            out_c = np.minimum(csum, U32MAX).astype(np.uint32)
            if self.coords:
                packed = ((np.concatenate(pr)[order].astype(np.uint64) << 32)
                          | np.concatenate(pp)[order])
                cmin = np.minimum.reduceat(packed, starts)
                out_r = (cmin >> np.uint64(32)).astype(np.uint32)
                out_p = (cmin & U32MAX).astype(np.uint32)
            else:
                out_r = np.zeros(len(starts), np.uint32)
                out_p = np.zeros(len(starts), np.uint32)
            yield keys[starts], out_c, out_r, out_p

    def close(self):
        self._segments.clear()   # drops the memmap references
        shutil.rmtree(self.dir, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
