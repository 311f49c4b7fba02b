"""Entry: ``Sketcher.sketch_batch`` at k > 16 over batches already on the
device: ``sketch_resident``'s pool, batches, jobs and pinned copies, with
64-bit k-mers.

At 17 <= k <= 32 the program's items are u64 (hash64shift of the canonical
k-mers), so its signatures are int64 u64 bit patterns; the pinned host
copies are int64 too.  The check compares, for the same sample of batches,
the signatures of each batch's last call in the window with the plain
ProbMinHash over 64-bit k-mers (``reference/probminhash64.py``), as u64
values; the number compared is the reads whose signature differs (limit 0:
an exact comparison).  The control puts that reference with its draws in
bfloat16 in the program's place.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.entries import sketch_resident
from benchmark.reference import probminhash64 as ref

CHECK = sketch_resident.CHECK


class Entry(sketch_resident.Entry):
    def setup(self):
        super().setup()
        self.host = [torch.empty((len(idx), self.m), dtype=torch.int64,
                                 pin_memory=self.cuda)
                     for idx in self.pool.batches]

    def _reference(self, b, precision="float32"):
        r = self.pool.reads(self.pool.batches[b])
        return ref.signatures(r.codes, r.lengths, self.k, self.m,
                              self.ctx.device, precision).cpu().numpy()

    def check(self):
        bad = 0
        for b in self._sample():
            got = self.host[b].numpy()
            bad += int((got != self._reference(b)).any(axis=1).sum())
        return [(CHECK, bad, 0)]
