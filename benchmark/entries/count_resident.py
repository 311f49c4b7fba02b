"""Entry: the port's counting loop, ``count/stream.StreamCounter``, over
batches already on the device.

Inputs: the traffic's pool of reads with errors on both strands
(``traffic/count_reads.py``), cut into batches as ingest cuts a file.
Set-up makes each batch's bases on the device, packs them into the
program's ``ReadBatch`` (``harness/jobs.pack``), with the reads' lengths
also on the host as ingest's batches carry them, keeps them there, and
creates the counter (k from the configuration, no coordinates, a table of
2^26 entries growing up to ``capacity_max``, spill on, as ``parsefastq
kmer --count`` runs it).  Warm pushes every batch ``warm_passes`` times,
so the growth ladder has run before the window.  Job i pushes batch i mod
n and returns its bases; ``drain`` folds the staged remainder and waits
for the device, so every base of the window is in the table.

The check, after ``release`` of the batches: the program's own end of
stream (``StreamCounter.finish``: finalize, min count 1, no clamp) against
the plain counting of ``reference/counting.py``, count(key) = the sum over
batches of (the batch's pushes in warm and window) x (its occurrences in
the batch's canonical k-mers, ``reference/kmers.py``), every key, slice by
slice.  The number compared is the keys whose count differs, or that one
side lacks (limit 0: an exact comparison).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from benchmark.harness.jobs import Entry as Base
from benchmark.harness.jobs import pack
from benchmark.reference import counting, kmers
from benchmark.traffic import count_reads

CHECK = "count_keys_differ"
CONTROL_CLAMP = 15              # 4-bit counters
UPLOAD = 1 << 26                # keys a copy to the device in the check


class Entry(Base):
    def inputs(self):
        c = self.ctx
        self.pool = count_reads.make_pool(c.config, c.traffic, c.seed)
        self.k = c.config["kmer_size"]
        self.bases = [self.pool.n_bases(b)
                      for b in range(len(self.pool.batches))]
        self.pushes = np.zeros(len(self.pool.batches), np.int64)

    def setup(self):
        from kmerutils_tpu_torch.base.sequence import ReadBatch
        from kmerutils_tpu_torch.count.stream import StreamCounter
        dev = torch.device(self.ctx.device)
        self.cuda = dev.type == "cuda"
        p = self.pool
        self.batches = []
        for idx in p.batches:
            host = torch.as_tensor(p.lengths[idx], dtype=torch.int32)
            ln = host.to(dev, torch.int64)
            self.batches.append(ReadBatch(
                pack(p.codes(idx, dev), torch.cumsum(ln, 0) - ln, ln, dev),
                host.to(dev), host))
        self.counter = StreamCounter(
            self.k, coords=False, capacity_max=self.ctx.config[
                "capacity_max"], device=dev, spill=True)

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def _push(self, b):
        idx = self.pool.batches[b]
        self.counter.add(self.batches[b], idx)
        self.pushes[b] += 1

    def warm(self):
        for _ in range(int(self.ctx.traffic["warm_passes"])):
            for b in range(len(self.batches)):
                self._push(b)
        self._sync()
        t = self.counter.table
        print(f"count warm: grew at (pushes, capacity) "
              f"{self.counter.grown_at}; capacity {t.capacity}, used "
              f"{t.used}, distinct at the last compaction "
              f"{t.last_distinct}", file=sys.stderr)

    def job(self, i):
        b = i % len(self.batches)
        self._push(b)
        return self.bases[b]

    def drain(self):
        self.counter.flush()
        self._sync()

    def release(self):
        self.batches = []

    def _reference(self, weights):
        """The plain counting of every batch at its weight, sliced."""
        ref = counting.Counter(int(self.ctx.traffic["check_slices"]))
        dev = torch.device(self.ctx.device)
        for b, idx in enumerate(self.pool.batches):
            if weights[b]:
                can, _, _ = kmers.canonical(self.pool.codes(idx, dev),
                                            self.pool.lengths[idx], self.k,
                                            dev)
                ref.add(can, int(weights[b]))
        return ref

    def _program(self):
        """The program's counts, as int64 (keys, counts) on the device, cut
        into the reference's slices; frees the counter."""
        blocks, dropped = self.counter.finish()
        segments, cap = self.counter.n_segments, self.counter.capacity
        self.counter = None
        if self.cuda:
            torch.cuda.empty_cache()
        n = int(self.ctx.traffic["check_slices"])
        parts: list = [[] for _ in range(n)]
        total = distinct = 0
        dev = torch.device(self.ctx.device)
        for keys, counts, _, _ in blocks:
            for s in range(0, keys.size, UPLOAD):
                k = torch.from_numpy(keys[s:s + UPLOAD].view(
                    np.int64 if keys.dtype == np.uint64 else np.int32))
                k = k.to(dev).to(torch.int64)
                if keys.dtype != np.uint64:
                    k &= counting.M32
                c = torch.from_numpy(counts[s:s + UPLOAD].view(np.int32)) \
                    .to(dev).to(torch.int64) & counting.M32
                total += int(c.sum())
                distinct += k.numel()
                for part, sl in zip(parts, counting.split(n, k, c)):
                    part.append(sl)
        print(f"count check: capacity {cap}, distinct {distinct}, sum of "
              f"counts {total}, dropped {dropped}, spill segments "
              f"{segments}; pushes {int(self.pushes.sum())}",
              file=sys.stderr)
        return parts

    def check(self):
        parts = self._program()
        ref = self._reference(self.pushes)
        bad = 0
        for i, part in enumerate(parts):
            want = ref.counts(i)
            ref.parts[i] = []
            got = ([torch.cat(t) for t in zip(*part)] if part
                   else [t[:0] for t in want])
            bad += counting.keys_differ(*got, *want)
        return [(CHECK, bad, 0)]

    def control(self):
        """The reference's counts in 4-bit counters (saturating at 15) in
        the program's place, every batch pushed as a run of the cell pushes
        it at the least: ``warm_passes`` and ``control_passes``."""
        t = self.ctx.traffic
        ref = self._reference(np.full(len(self.pool.batches),
                                      t["warm_passes"] + t["control_passes"]))
        bad = 0
        for i in range(ref.n_slices):
            keys, counts = ref.counts(i)
            bad += counting.keys_differ(keys, counts.clamp(max=CONTROL_CLAMP),
                                        keys, counts)
        return [(CHECK, bad, 0)]
