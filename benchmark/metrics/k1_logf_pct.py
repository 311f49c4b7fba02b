"""k1_logf_pct (layer: kernel K1, ops/tournament.py -> csrc/tournament.cu):
the share of the draws K1's inputs need whose ln(u) K1 took, in %.  K1
rejects a weight-1 draw on its hash alone when it cannot reach the best
draw of its tile; the other draws, and those that pass, take ln(u).

The numerator is the program's counter ``sketch.k1_logf`` (``obs.count``
in ``ops/tournament.py``: one device scalar a K1 launch, summed over the
kernel's lanes; nothing while ``obs.sink`` is None).  The denominator is
the needed draws that ``k1_roofline_pct``'s probe records as ``"k1"`` for
each call (``harness/roofline.py::k1_draws``); this reader patches nothing
itself.  Both are device scalars, turned into numbers once, after the
window.  None without both records (a program without the counter, or on
the CPU, where no kernel runs).  Lower is better."""

from benchmark.harness import program_spans


def probes(tracer):
    program_spans.attach(tracer)


def read(trace):
    logf = trace.records.get("sketch.k1_logf")
    calls = trace.records.get("k1")
    if not logf or not calls:
        return None
    need = int(sum(d for d, _ in calls))
    if need <= 0:
        return None
    return 100.0 * int(sum(logf)) / need
