"""weights_wide_pct (layer: sketch): the share of the positions handed to
span ``sketch.weights`` (rows x P) that KW handed to its wide route
(``csrc/weights_wide.cu``), from the program's counter
``sketch.weights_wide`` (``ops/weights.py``: n x P a launch on the wide
route, 0 on the tile route), in %.  Lower is better: the wide route sorts
in global memory.  None where the program has no such counter, or without
event records of the span (on the CPU, where no kernel runs)."""

from benchmark.harness import program_spans


def probes(tracer):
    program_spans.attach(tracer)


def read(trace):
    wide = trace.records.get("sketch.weights_wide")
    recs = trace.records.get("sketch.weights")
    if not wide or not recs:
        return None
    handed = sum(w for w, _, _ in recs)
    if handed <= 0:
        return None
    return 100.0 * sum(wide) / handed
