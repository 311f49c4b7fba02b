"""compact_roofline_pct (layer: kernel K4, count/stream.py ->
ops/merge.py -> csrc/merge.cu): K4's least time over its device time in
the window.  Each call of ``ops.merge.aggregate_fold`` is recorded by a
wrapper in the traced run, with its bytes from the live prefix it was
given and the live count it returned (``harness/count_roofline.py``: the
entries read and written, once each at 3.35 TB/s); the device time is the
profiler's, of K4's four kernels (``families.K4``).  The window's calls
are the table's compactions; finalize runs after the window.  None where
the window has no K4 call or no device time (on the CPU)."""

from benchmark.harness import count_roofline, families


def probes(tracer):
    from kmerutils_tpu_torch.ops import merge

    def make(orig):
        def wrapped(key, cnt, crd, used, *a, **kw):
            out = orig(key, cnt, crd, used, *a, **kw)
            tracer.record("k4", count_roofline.aggregate_bytes(
                key, crd, used, out[3]))
            return out
        return wrapped

    tracer.patch(merge, "aggregate_fold", make)


def read(trace):
    return count_roofline.share_pct(trace.records.get("k4"),
                                    trace.family_s((families.K4,)))
