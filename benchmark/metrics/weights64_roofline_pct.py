"""weights64_roofline_pct (layer: kernel KW, sketch/probminhash.py ->
ops/weights.py -> csrc/weights.cu): KW's bytes bound at int64 items (22
bytes a position, ``harness/roofline64.py``) over the time of span
``sketch.weights`` on the device stream, for the positions that span was
handed (rows x P).  The span holds one KW call and nothing else; its time
is the sum of the intervals between its timing events, read after the
run's final synchronisation (``harness/program_spans.py``), so a wait of
the device for the stage's first launch counts in it.  None without event
records (on the CPU, or a program without spans)."""

from benchmark.harness import program_spans, roofline64


def probes(tracer):
    program_spans.attach(tracer)


def read(trace):
    rate = program_spans.gpos_per_s(trace, "sketch.weights")
    if rate is None:
        return None
    # the least time of one second's positions, over that second
    return 100.0 * roofline64.kw64_least_s(rate * 1e9)
