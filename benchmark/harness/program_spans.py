"""The program's own spans (``kmerutils_tpu_torch/obs.py``) in a traced
run, and the arithmetic of the metrics that read them.

:func:`attach`, called from a reader's ``probes``, points ``obs.sink`` at
the run's :class:`~benchmark.harness.trace.Tracer` until the window ends
(``Tracer.restore``); calling it again changes nothing.  A tree whose
program has no ``obs`` module records no span, and the readers return
None.  The sketch layer's spans: ``sketch.kmers`` (k-mers, canonical form,
hash), ``sketch.weights`` (the row sort and its run scans) and
``sketch.draw`` (the mask, K1's plan and K1); each records the positions
it was handed (rows x P) and, on the card, a pair of timing events on the
stream.
"""

from __future__ import annotations

def attach(tracer) -> None:
    try:
        from kmerutils_tpu_torch import obs
    except ImportError:
        return
    if obs.sink is not tracer:
        tracer.patch(obs, "sink", lambda _: tracer)


def gpos_per_s(trace, name: str):
    """Positions a second, in 10^9, of span ``name`` on the device stream:
    the sum of its work over the sum of its event intervals; None without
    event records (as on the CPU).  Read after the run's final
    synchronisation, so every event has completed."""
    recs = trace.records.get(name)
    if not recs:
        return None
    ms = sum(a.elapsed_time(b) for _, a, b in recs)
    if ms <= 0:
        return None
    return sum(w for w, _, _ in recs) / (ms * 1e-3) / 1e9
