"""grid_gpos_per_s (layer: sketch): the positions that span
``sketch.grid`` was handed (rows x P) over its time on the device stream,
in 10^9 a second.  The stage: G1's inputs (the items' folds, their
permutation keys, the slot constants), G1 and the empty rows
(``sketch/superminhash.py::superminhash2``).

The program records a timing event on the stream at the span's open and
close (``kmerutils_tpu_torch/obs.py``, pointed at the tracer by
``harness/program_spans.py``); the time is the sum of the intervals
between them, read after the run's final synchronisation.  A stage's
interval on the stream starts when the work queued before it ends, so any
wait of the device for the stage's first launch counts in the stage.
None without event records (on the CPU, or a program without the span)."""

from benchmark.harness import program_spans


def probes(tracer):
    program_spans.attach(tracer)


def read(trace):
    return program_spans.gpos_per_s(trace, "sketch.grid")
