"""The readers of the program's own spans (``harness/program_spans.py`` and
the sketch layer's three metrics) on the CPU: their arithmetic on a trace
built by hand, None where there is nothing to read, the sink pointed at the
tracer once and only for the window, and a traced run of the cell."""

import json
import sys

import pytest

from benchmark.harness import spec
from benchmark.harness import trace as tracing

from .sizes import TINY

CELL = "ont_sketch_k8_resident"
STAGES = ("kmers", "weights", "draw")
METRICS = [f"{s}_gpos_per_s" for s in STAGES]


class Event:
    """A completed timing event at ``ms`` on the stream."""

    def __init__(self, ms):
        self.ms = ms

    def elapsed_time(self, end):
        return end.ms - self.ms


def readers(names=METRICS):
    c = spec.cell(CELL)
    return {m["name"]: c.reader(m) for m in c.per_layer
            if m["name"] in names}


def hand_trace(**kw):
    """Window [0, 100) ns with host spans, stream-event records (two
    ``sketch.kmers`` calls, one ``sketch.draw``, none of the weights) and
    device operations."""
    args = dict(
        t0=0, t1=100, jobs=2,
        spans=[("sketch.kmers", 5, 15), ("sketch.draw", 45, 50),
               ("load", 50, 60), ("sketch.weights", 95, 120),
               ("sketch.draw", 62, 88)],
        records={"sketch.kmers": [(2 * 10**9, Event(0.0), Event(400.0)),
                                  (10**9, Event(500.0), Event(1100.0))],
                 "sketch.draw": [(3 * 10**9, Event(0.0), Event(1500.0))],
                 "k1": [(1, 2)]},
        device=[("elementwise", "a", 10, 30), ("sort", "b", 25, 40),
                ("K1 tournament", "c", 60, 90)])
    args.update(kw)
    return tracing.Trace(**args)


def test_the_cell_reports_the_three_metrics_of_the_sketch_layer():
    r = readers()
    assert sorted(r) == sorted(METRICS)
    c = spec.cell(CELL)
    for m in c.per_layer:
        if m["name"] in METRICS:
            assert (m["layer"], m["moves"], m["source"]) == (
                "sketch", "mbases_per_s", "device_trace")


def test_stage_rates_are_the_work_over_the_stream_time():
    r = readers()
    tr = hand_trace()
    # 3e9 positions over 1.0 s; 3e9 over 1.5 s
    assert r["kmers_gpos_per_s"].read(tr) == pytest.approx(3.0)
    assert r["draw_gpos_per_s"].read(tr) == pytest.approx(2.0)
    assert r["weights_gpos_per_s"].read(tr) is None       # no records


@pytest.mark.parametrize("records", [{}, {"sketch.draw": []},
                                     {"sketch.draw": [(5, Event(1.0),
                                                       Event(1.0))]}])
def test_stage_rates_are_none_without_event_time(records):
    assert readers()["draw_gpos_per_s"].read(hand_trace(records=records)) \
        is None


def test_the_sink_is_the_tracer_once_and_only_until_restore():
    from kmerutils_tpu_torch import obs
    assert obs.sink is None
    t = tracing.Tracer()
    for reader in readers().values():
        reader.probes(t)
    assert obs.sink is t and len(t._patches) == 1
    t.restore()
    assert obs.sink is None


def test_a_program_without_spans_is_left_as_it_is(monkeypatch):
    import kmerutils_tpu_torch
    monkeypatch.delattr(kmerutils_tpu_torch, "obs")
    monkeypatch.setitem(sys.modules, "kmerutils_tpu_torch.obs", None)
    t = tracing.Tracer()
    for reader in readers().values():
        reader.probes(t)
    assert t._patches == []
    tr = hand_trace(spans=[], records={})
    assert all(r.read(tr) is None for r in readers().values())


def run_traced(tmp_path):
    from benchmark.harness import runner
    return runner.run_cell(CELL, 2**33 + 29, 0.3, True, device="cpu",
                           overrides=TINY[CELL], out_dir=str(tmp_path))


def test_a_traced_cpu_run_records_the_spans_and_reports_what_it_can(
        tmp_path):
    from kmerutils_tpu_torch import obs
    res = run_traced(tmp_path)
    assert res["correct"]
    want = {m["name"] for m in spec.cell(CELL).per_layer}
    got = set(res["metrics"])
    assert got <= want
    # the CPU has no stream events and no device operations
    assert not got & set(METRICS)
    doc = json.load(open(tmp_path / f"{CELL}.{2**33 + 29}.trace.json"))
    counts = {n: doc["spans"][f"sketch.{n}"]["count"] for n in STAGES}
    assert counts["kmers"] == counts["weights"] == counts["draw"] \
        == res["attempted"]
    assert obs.sink is None
