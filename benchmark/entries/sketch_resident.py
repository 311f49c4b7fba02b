"""Entry: ``Sketcher.sketch_batch`` over batches already on the device.

Set-up draws the traffic's pool of reads (``generate.make_pool``), cuts it
into batches as ingest cuts a file (length-sorted windows, width rungs,
<= ``max_batch_bases`` padded bases a batch), packs each batch on the
device into the program's ``ReadBatch`` (16 bases a 32-bit word, the
first base in the top bits, one slack word a row) and keeps them there.
Job i sketches batch i mod n with
``Sketcher(SeqSketcherParams(k, m, PROB3A, DNA)).sketch_batch`` and copies
the signatures to pinned host memory one batch late, as ``datasketcher``
does: the job waits for the copy of the batch before it, so the host runs
at most one batch ahead.  The window ends when every copy is done.

The check compares, for a sample of the batches drawn from the seed, the
signatures of the batch's last call in the window with the plain
ProbMinHash of its reads (``reference/probminhash.py``), worked out again
from the genome, the starts and the lengths.  The number compared is the
reads whose signature differs (limit 0: an exact comparison).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.harness.jobs import Entry as Base
from benchmark.harness.jobs import pack
from benchmark.reference import probminhash as ref
from benchmark.traffic import generate

CHECK = "sig_reads_differ"


class Entry(Base):
    def inputs(self):
        c = self.ctx
        self.pool = generate.make_pool(c.config, c.traffic, c.seed)
        self.k = c.config["kmer_size"]
        self.m = c.config["sketch_size"]
        self.bases = [self.pool.n_bases(b)
                      for b in range(len(self.pool.batches))]

    def setup(self):
        from kmerutils_tpu_torch.base.sequence import ReadBatch
        from kmerutils_tpu_torch.sketch.jaccard import Sketcher
        from kmerutils_tpu_torch.sketch.params import (DataType,
                                                       SeqSketcherParams,
                                                       SketchAlgo)
        dev = torch.device(self.ctx.device)
        self.cuda = dev.type == "cuda"
        p = self.pool
        genome = torch.as_tensor(p.genome, device=dev).to(torch.int64)
        starts = torch.as_tensor(p.starts, device=dev)
        lengths = torch.as_tensor(p.lengths, device=dev)
        self.batches = []
        for idx in p.batches:
            i = torch.as_tensor(idx, device=dev)
            self.batches.append(ReadBatch(
                pack(genome, starts[i], lengths[i], dev),
                lengths[i].to(torch.int32)))
        del genome, starts, lengths
        self.host = [torch.empty((len(idx), self.m), dtype=torch.int32,
                                 pin_memory=self.cuda) for idx in p.batches]
        self.sk = Sketcher(params=SeqSketcherParams(
            kmer_size=self.k, sketch_size=self.m, algo=SketchAlgo.PROB3A,
            data_t=DataType.DNA))
        self.pending: list = []
        self.ran = np.zeros(len(p.batches), bool)

    def _call(self, b):
        sig = self.sk.sketch_batch(self.batches[b])
        self.host[b].copy_(sig, non_blocking=self.cuda)
        if self.cuda:
            ev = torch.cuda.Event()
            ev.record()
            self.pending.append(ev)
            if len(self.pending) > 1:
                self.pending.pop(0).synchronize()

    def warm(self):
        for b in range(len(self.batches)):
            self._call(b)
        self.drain()

    def job(self, i):
        b = i % len(self.batches)
        self._call(b)
        self.ran[b] = True
        return self.bases[b]

    def drain(self):
        for ev in self.pending:
            ev.synchronize()
        self.pending = []

    def release(self):
        self.batches = []
        self.sk = None

    def _sample(self):
        ran = np.flatnonzero(self.ran)
        n = min(int(self.ctx.traffic["check_batches"]), ran.size)
        rng = generate.seed_rng(self.ctx.seed, 9)
        return sorted(rng.choice(ran, size=n, replace=False).tolist())

    def _reference(self, b, precision="float32"):
        r = self.pool.reads(self.pool.batches[b])
        return ref.signatures(r.codes, r.lengths, self.k, self.m,
                              self.ctx.device, precision).cpu().numpy()

    def check(self):
        bad = 0
        for b in self._sample():
            got = self.host[b].numpy().view(np.uint32).astype(np.int64)
            bad += int((got != self._reference(b)).any(axis=1).sum())
        return [(CHECK, bad, 0)]

    def control(self):
        """The reference's draws in bfloat16 as the program's signatures,
        over the same sample of batches (every batch counts as run)."""
        self.ran = np.ones(len(self.pool.batches), bool)
        bad = 0
        for b in self._sample():
            got = self._reference(b, "bfloat16")
            bad += int((got != self._reference(b)).any(axis=1).sum())
        return [(CHECK, bad, 0)]
