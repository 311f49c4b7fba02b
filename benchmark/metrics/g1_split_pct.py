"""g1_split_pct (layer: sketch): the share of the positions handed to span
``sketch.grid`` (rows x P) that G1 took in rows split over several spans
of its plan, from the program's counter ``sketch.g1_split``
(``ops/sketch_grid.py::count_split``: n x P a launch whose plan splits
rows, else 0), in %.  Lower is better: each span of a split row loads the
slot constants again and ends in m global atomicMin.  None where the
program has no such counter, or without event records of the span (on the
CPU, where no kernel runs)."""

from benchmark.harness import program_spans


def probes(tracer):
    program_spans.attach(tracer)


def read(trace):
    split = trace.records.get("sketch.g1_split")
    recs = trace.records.get("sketch.grid")
    if not split or not recs:
        return None
    handed = sum(w for w, _, _ in recs)
    if handed <= 0:
        return None
    return 100.0 * sum(split) / handed
