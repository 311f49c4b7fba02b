"""count_entries_gpos_per_s (layer: count): the positions that span
``count.entries`` was handed (rows x P) over its time on the device
stream, in 10^9 a second.  The stage: the k-mers of each batch, their
canonical form, the valid positions' selection and the batch's sort
(``count/stream.py::batch_entries``).

The program records a timing event on the stream at the span's open and
close (``kmerutils_tpu_torch/obs.py``, pointed at the tracer by
``harness/program_spans.py``); the time is the sum of the intervals
between them, read after the run's final synchronisation.  A stage's
interval on the stream starts when the work queued before it ends, so any
wait of the device for the stage's first launch counts in the stage (here
the fold queued by the batch before).  None without event records (on the
CPU, or a program without spans)."""

from benchmark.harness import program_spans


def probes(tracer):
    program_spans.attach(tracer)


def read(trace):
    return program_spans.gpos_per_s(trace, "count.entries")
