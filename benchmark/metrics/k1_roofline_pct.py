"""k1_roofline_pct (layer: kernel K1, sketch/probminhash.py ->
ops/tournament.py -> csrc/tournament.cu): K1's least time over its device
time in the window.  Each call of ``ops.tournament.weighted_tournament``
is recorded by a wrapper in the traced run: its bytes from the shapes and
the draws its inputs need, counted on the device without a
synchronisation (``harness/roofline.py``: K1_OPS_PER_DRAW, frozen with its
derivation).  A call's least time is the larger of its bytes bound and its
operations bound; the device time is the profiler's, of the tournament
kernels of the u32 family (the main and the finish kernel)."""

from benchmark.harness import families, roofline


def probes(tracer):
    from kmerutils_tpu_torch.ops import tournament

    def make(orig):
        def wrapped(items, winv, m, *a, **kw):
            out = orig(items, winv, m, *a, **kw)
            n, P = winv.shape
            tracer.record("k1", (roofline.k1_draws(items, winv, m),
                                 roofline.k1_bytes(n, P, m)))
            return out
        return wrapped

    tracer.patch(tournament, "weighted_tournament", make)


def read(trace):
    calls = trace.records.get("k1")
    device_s = trace.family_s((families.K1,))
    if not calls or device_s <= 0:
        return None
    least = sum(roofline.k1_least_s(int(d), b) for d, b in calls)
    return 100.0 * least / device_s
