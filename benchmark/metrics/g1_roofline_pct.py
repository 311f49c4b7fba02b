"""g1_roofline_pct (layer: kernel G1, sketch/superminhash.py ->
ops/sketch_grid.py -> csrc/sketch.cu): G1's least time over its device
time in the window.  Each call of ``ops.sketch_grid.grid_min`` is recorded
by a wrapper in the traced run: its bytes from the shapes and its valid
(position, slot) pairs, counted on the device without a synchronisation
(``harness/roofline_grid.py``: G1_OPS_PER_PAIR, G1_OPS_PER_ROUND and the
walk rounds a pair takes at m, frozen with their derivation).  A call's
least time is the larger of its bytes bound and its operations bound; the
device time is the profiler's, of the "G1 grid_min" family.  None where
the window has no G1 call at a frozen m or no device time (on the CPU)."""

from benchmark.harness import roofline_grid


def probes(tracer):
    from kmerutils_tpu_torch.ops import sketch_grid

    def make(orig):
        def wrapped(x, a, b, valid, slotc, *args, **kw):
            out = orig(x, a, b, valid, slotc, *args, **kw)
            n, P = valid.shape
            m = slotc.shape[0]
            tracer.record("g1", (roofline_grid.g1_pairs(valid, m), m,
                                 roofline_grid.g1_bytes(n, P, m)))
            return out
        return wrapped

    tracer.patch(sketch_grid, "grid_min", make)


def read(trace):
    calls = trace.records.get("g1")
    device_s = trace.family_s((roofline_grid.FAMILY,))
    if not calls or device_s <= 0 \
            or any(m not in roofline_grid.WALK_ROUNDS for _, m, _ in calls):
        return None
    least = sum(roofline_grid.g1_least_s(int(p), m, b) for p, m, b in calls)
    return 100.0 * least / device_s
