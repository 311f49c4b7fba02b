"""The k=21 sketch cell on the CPU at a small size: the cell's run (traced
and not) against the plain ProbMinHash over 64-bit k-mers, its control,
planted faults, and the readers of its three metrics.  The reference
against the program outside the cell: ``tests/test_torch_sketch_k21.py``.

The cell's small size joins ``sizes.TINY`` here, at import, so that the
harness's tests over every cell (``test_bench_harness.py``) run it too.
"""

import pytest

from benchmark import control
from benchmark.harness import roofline, roofline64, runner, spec
from benchmark.harness import trace as tracing

from . import sizes
from .test_bench_obs import Event

CELL = "ont_sketch_k21_resident"
sizes.TINY.setdefault(CELL, {"config": sizes.SMALL, "traffic": {
    "pool_reads": 200, "max_batch_bases": 16384, "check_batches": 3}})
TINY = sizes.TINY[CELL]
METRICS = ("k2_roofline_pct", "weights64_roofline_pct", "weights_wide_pct")


def run_tiny(seed=2**36 + 21, trace=False, tmp_path=None, overrides=TINY):
    return runner.run_cell(CELL, seed, 0.3, trace, device="cpu",
                           overrides=overrides, out_dir=str(tmp_path))


def test_the_cell_is_k21_over_the_k8_cells_pool():
    k8, k21 = spec.cell("ont_sketch_k8_resident"), spec.cell(CELL)
    assert k21.config["kmer_size"] == 21
    assert {k: v for k, v in k21.config.items()
            if k not in ("name", "source", "kmer_size", "assumed")} == {
        k: v for k, v in k8.config.items()
        if k not in ("name", "source", "kmer_size", "assumed")}
    assert {k: v for k, v in k21.traffic.items() if k not in ("entry",
                                                              "why")} == {
        k: v for k, v in k8.traffic.items() if k not in ("entry", "why")}
    assert k21.chips == 1


@pytest.mark.parametrize("trace", [False, True])
def test_the_cell_runs_correct(trace, tmp_path):
    res = run_tiny(trace=trace, tmp_path=tmp_path)
    assert res["correct"] is True and res["attempted"] >= 1
    assert res["checks"] == {"sig_reads_differ": {"value": 0, "limit": 0}}
    if not trace:
        assert set(res["metrics"]) == {"mbases_per_s", "setup_s"}


def test_the_control_fails():
    [(name, value, limit)] = control.readings(CELL, 2**33 + 21, "cpu",
                                              overrides=TINY)
    assert name == "sig_reads_differ" and value > limit


def altered_word(monkeypatch):
    from kmerutils_tpu_torch.ops import tournament
    orig = tournament.weighted_tournament_u64

    def bad(*a, **kw):
        lo, hi = orig(*a, **kw)
        hi = hi.clone()
        hi[0, 0] ^= 1
        return lo, hi
    monkeypatch.setattr(tournament, "weighted_tournament_u64", bad)


def batch_left_out(monkeypatch):
    """Every call of the first batch's shape returns zeros: that batch is
    never sketched."""
    from kmerutils_tpu_torch.ops import tournament
    orig = tournament.weighted_tournament_u64
    first = []

    def bad(lo, hi, winv, m, *a, **kw):
        out = orig(lo, hi, winv, m, *a, **kw)
        if not first:
            first.append(tuple(lo.shape))
        if tuple(lo.shape) == first[0]:
            return tuple(x.zero_() for x in out)
        return out
    monkeypatch.setattr(tournament, "weighted_tournament_u64", bad)


@pytest.mark.parametrize("fault", [altered_word, batch_left_out])
def test_a_planted_fault_is_not_correct(fault, monkeypatch, tmp_path):
    fault(monkeypatch)
    # every batch checked, so the one left out is among them
    every = {"config": TINY["config"],
             "traffic": dict(TINY["traffic"], check_batches=10**6)}
    res = run_tiny(2**35 + 21, tmp_path=tmp_path, overrides=every)
    assert res["correct"] is False
    assert res["checks"]["sig_reads_differ"]["value"] > 0


def readers():
    c = spec.cell(CELL)
    return {m["name"]: c.reader(m) for m in c.per_layer
            if m["name"] in METRICS}


def test_the_cell_reports_its_metrics_with_their_layers():
    c = spec.cell(CELL)
    got = {m["name"]: (m["layer"], m["source"], m["better"])
           for m in c.per_layer}
    assert got == {
        "device_idle_pct": ("device", "device_trace", "lower"),
        "kmers_gpos_per_s": ("sketch", "device_trace", "higher"),
        "weights_gpos_per_s": ("sketch", "device_trace", "higher"),
        "draw_gpos_per_s": ("sketch", "device_trace", "higher"),
        "k2_roofline_pct": ("kernel K2", "device_trace", "higher"),
        "weights64_roofline_pct": ("kernel KW", "device_trace", "higher"),
        "weights_wide_pct": ("sketch", "program_counter", "lower")}
    assert "k1_roofline_pct" not in got
    assert [m["name"] for m in spec.cell("ont_sketch_k8_resident").per_layer
            if m["name"] in METRICS] == []


def hand_trace(**kw):
    """Window [0, 10^9) ns: two KW spans of 2 and 3 x 10^9 positions over
    1 s of stream time, one on the wide route; two K2 calls over 0.5 s of
    device time."""
    args = dict(
        t0=0, t1=10**9, jobs=2, spans=[],
        records={"sketch.weights": [(2 * 10**9, Event(0.0), Event(400.0)),
                                    (3 * 10**9, Event(500.0),
                                     Event(1100.0))],
                 "sketch.weights_wide": [0, 3 * 10**9],
                 "k2": [(1000, 200, 12 * 1000 + 8 * 200),
                        (10**6, 200, 10**9)]},
        device=[("K2 tournament_u64", "a", 0, 2 * 10**8),
                ("K2 tournament_u64", "b", 3 * 10**8, 6 * 10**8),
                ("sort", "c", 6 * 10**8, 7 * 10**8)])
    args.update(kw)
    return tracing.Trace(**args)


def test_the_readers_arithmetic_on_a_trace_built_by_hand():
    r = readers()
    tr = hand_trace()
    assert r["weights_wide_pct"].read(tr) == pytest.approx(60.0)
    assert r["weights64_roofline_pct"].read(tr) == pytest.approx(
        100 * 5e9 * 22 / 3.35e12)
    least = (roofline.ops_s(1000 * (200 * 14 + 1))
             + max(roofline.bytes_s(10**9),
                   roofline.ops_s(10**6 * (200 * 14 + 1))))
    assert r["k2_roofline_pct"].read(tr) == pytest.approx(100 * least / 0.5)


@pytest.mark.parametrize("records,reads", [
    ({}, set()),
    ({"sketch.weights_wide": [0]}, set()),
    ({"sketch.weights": [(5, Event(1.0), Event(2.0))]},
     {"weights64_roofline_pct"}),
    ({"sketch.weights": [(5, Event(1.0), Event(1.0))],
      "sketch.weights_wide": [0]}, {"weights_wide_pct"}),
    ({"k2": [(10, 4, 100)]}, set())])
def test_the_readers_are_none_without_their_records(records, reads):
    """A program without the counter, a trace without stream time or
    without K2's device time: the metric is left out, not 0."""
    tr = hand_trace(records=records, device=[])
    got = {n for n, r in readers().items() if r.read(tr) is not None}
    assert got == reads


def test_k2_positions_skip_padding_and_repeats():
    import torch
    lo = torch.tensor([[1, 1, 2, 2, 0], [7, 7, 7, 7, 7]], dtype=torch.int32)
    hi = torch.tensor([[0, 0, 0, 5, 0], [1, 1, 1, 1, 1]], dtype=torch.int32)
    winv = torch.tensor([[.5, .5, 1., 1., 0.], [.2, .2, .2, .2, .2]])
    # row 0: 1, (repeat), 2, (2 with another hi), padding; row 1: one run
    assert int(roofline64.k2_positions(lo, hi, winv)) == 3 + 1
    assert roofline64.k2_bytes(2, 5, 3) == 2 * 5 * 12 + 2 * 3 * 8


def test_a_traced_cpu_run_counts_no_wide_route(tmp_path):
    """On the CPU no kernel runs: the spans are recorded, the counter and
    the device metrics have nothing to read."""
    res = run_tiny(2**33 + 41, True, tmp_path)
    assert res["correct"]
    assert not set(res["metrics"]) & set(METRICS)
