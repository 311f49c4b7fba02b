"""fold_roofline_pct (layer: kernel K3, count/stream.py -> ops/merge.py ->
csrc/merge.cu): K3's least time over its device time in the window.  Each
call of ``ops.merge.merge_fold`` is recorded by a wrapper in the traced
run, with its bytes from the sizes it was given and returned
(``harness/count_roofline.py``: the table's entries read and written and
the run's entries read, once each at 3.35 TB/s); the device time is the
profiler's, of the merge kernel in its fold form (``families.K3``).  None
where the window has no K3 call or no device time (on the CPU)."""

from benchmark.harness import count_roofline, families


def probes(tracer):
    from kmerutils_tpu_torch.ops import merge

    def make(orig):
        def wrapped(key, cnt, crd, used, b_key, b_crd, capacity, *a, **kw):
            out = orig(key, cnt, crd, used, b_key, b_crd, capacity, *a, **kw)
            tracer.record("k3", count_roofline.fold_bytes(
                key, crd, used, b_key.numel(), out[3]))
            return out
        return wrapped

    tracer.patch(merge, "merge_fold", make)


def read(trace):
    return count_roofline.share_pct(trace.records.get("k3"),
                                    trace.family_s((families.K3,)))
