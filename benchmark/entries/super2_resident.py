"""Entry: ``Sketcher.sketch_batch`` with SuperMinHash's integer signatures
(SUPER2) at k > 16 over batches already on the device:
``sketch_resident``'s pool, batches, jobs and pinned copies.

At 17 <= k <= 32 the program's items are u64 (hash64shift of the
canonical k-mers); SUPER2's signatures are u32 keys as int32 bit patterns,
[n, m] a batch, copied to int32 pinned memory one batch late.  The check
compares, for the same sample of batches, the signatures of each batch's
last call in the window with the plain SUPER2 over 64-bit k-mers
(``reference/superminhash2.py``), as u32 values; the number compared is
the reads whose signature differs (limit 0: an exact comparison).  The
control puts that reference, with the minimum taken on keys whose u is cut
to its top 16 bits, in the program's place.
"""

from __future__ import annotations

import numpy as np

from benchmark.entries import sketch_resident
from benchmark.reference import superminhash2 as ref

CHECK = sketch_resident.CHECK


class Entry(sketch_resident.Entry):
    def setup(self):
        from kmerutils_tpu_torch.sketch.jaccard import Sketcher
        from kmerutils_tpu_torch.sketch.params import (DataType,
                                                       SeqSketcherParams,
                                                       SketchAlgo)
        super().setup()
        self.sk = Sketcher(params=SeqSketcherParams(
            kmer_size=self.k, sketch_size=self.m, algo=SketchAlgo.SUPER2,
            data_t=DataType.DNA))

    def _reference(self, b, cut16=False):
        r = self.pool.reads(self.pool.batches[b])
        return ref.signatures(r.codes, r.lengths, self.k, self.m,
                              self.ctx.device, cut16).cpu().numpy()

    def control(self):
        """The reference's minimum on 16-bit u as the program's
        signatures, over the same sample of batches (every batch counts as
        run)."""
        self.ran = np.ones(len(self.pool.batches), bool)
        bad = 0
        for b in self._sample():
            got = self._reference(b, cut16=True)
            bad += int((got != self._reference(b)).any(axis=1).sum())
        return [(CHECK, bad, 0)]
