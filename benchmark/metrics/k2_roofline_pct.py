"""k2_roofline_pct (layer: kernel K2, sketch/probminhash.py ->
ops/tournament.py -> csrc/tournament.cu): K2's least time over its device
time in the window.  Each call of ``ops.tournament.weighted_tournament_u64``
is recorded by a wrapper in the traced run: its bytes from the shapes and
the positions its inputs need, counted on the device without a
synchronisation (``harness/roofline64.py``: K2_OPS_PER_DRAW and
K2_OPS_PER_POSITION, frozen with their derivation).  A call's least time
is the larger of its bytes bound and its operations bound; the device time
is the profiler's, of the tournament kernels of the u64 family (the main
and the finish kernel).  None where the window has no K2 call or no
device time (on the CPU)."""

from benchmark.harness import families, roofline64


def probes(tracer):
    from kmerutils_tpu_torch.ops import tournament

    def make(orig):
        def wrapped(lo, hi, winv, m, *a, **kw):
            out = orig(lo, hi, winv, m, *a, **kw)
            n, P = winv.shape
            tracer.record("k2", (roofline64.k2_positions(lo, hi, winv), m,
                                 roofline64.k2_bytes(n, P, m)))
            return out
        return wrapped

    tracer.patch(tournament, "weighted_tournament_u64", make)


def read(trace):
    calls = trace.records.get("k2")
    device_s = trace.family_s((families.K2,))
    if not calls or device_s <= 0:
        return None
    least = sum(roofline64.k2_least_s(int(p), m, b) for p, m, b in calls)
    return 100.0 * least / device_s
