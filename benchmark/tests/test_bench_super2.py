"""The SUPER2 cell (k=21, s=1000) on the CPU at a small size: the cell's
run (traced and not) against the plain SUPER2 over 64-bit k-mers, its
control, planted faults, G1's frozen work count, and the readers of its
three metrics.  The reference against the program outside the cell:
``tests/test_torch_sketch_super2.py``.

The cell's small size joins ``sizes.TINY`` here, at import, so that the
harness's tests over every cell (``test_bench_harness.py``) and on the card
(``test_bench_card.py``) run it too.  It is the size at which the control
fails: 7 slots over ~2 M positions of long reads, every batch checked.
Cut keys tie too seldom at 1000 slots over reads of a few hundred bases
for the control to read above 0 at a size the CPU computes in a second;
this file's own runs keep m = 1000 on short reads (``M1000``).
"""

import pytest
import torch

from benchmark import control
from benchmark.harness import roofline, roofline_grid, runner, spec
from benchmark.harness import trace as tracing
from benchmark.reference import superminhash2 as ref
from benchmark.reference.probminhash64 import lsr

from . import sizes
from .test_bench_obs import Event

CELL = "ont_super2_k21_resident"
sizes.TINY.setdefault(CELL, {
    "config": dict(sizes.SMALL, genome_len=400000, sketch_size=7,
                   read_len={"median": 10000, "sigma": 0.3, "min": 5000,
                             "max": 16000}),
    "traffic": {"pool_reads": 200, "max_batch_bases": 1 << 17,
                "check_batches": 10**6}})
TINY = sizes.TINY[CELL]
# the cell's own slots over short reads, three batches checked
M1000 = {"config": sizes.SMALL, "traffic": {
    "pool_reads": 120, "max_batch_bases": 16384, "check_batches": 3}}
METRICS = ("g1_roofline_pct", "grid_gpos_per_s", "g1_split_pct")


def run_tiny(seed=2**36 + 27, trace=False, tmp_path=None, overrides=M1000):
    return runner.run_cell(CELL, seed, 0.3, trace, device="cpu",
                           overrides=overrides, out_dir=str(tmp_path))


def test_the_cell_is_super2_at_mashs_defaults_over_the_k21_pool():
    k21, c = spec.cell("ont_sketch_k21_resident"), spec.cell(CELL)
    assert (c.config["kmer_size"], c.config["sketch_size"],
            c.config["algo"]) == (21, 1000, "SUPER2")
    same = ("kmer_size", "data", "bases", "genome_len", "read_len",
            "both_strands", "err_rate", "reduced", "published")
    assert {k: c.config[k] for k in same} == {k: k21.config[k] for k in same}
    assert set(k21.config["assumed"]) < set(c.config["assumed"])
    assert {k: v for k, v in c.traffic.items() if k not in ("entry",
                                                            "why")} == {
        k: v for k, v in k21.traffic.items() if k not in ("entry", "why")}
    assert c.traffic["entry"] == "super2_resident" and c.chips == 1


@pytest.mark.parametrize("trace", [False, True])
def test_the_cell_runs_correct(trace, tmp_path):
    res = run_tiny(trace=trace, tmp_path=tmp_path)
    assert res["correct"] is True and res["attempted"] >= 1
    assert res["checks"] == {"sig_reads_differ": {"value": 0, "limit": 0}}
    if not trace:
        assert set(res["metrics"]) == {"mbases_per_s", "setup_s"}
    else:
        # on the CPU no kernel runs: the span is recorded, the counter
        # and the device metrics have nothing to read
        assert not set(res["metrics"]) & set(METRICS)


@pytest.mark.parametrize("seed", [2**33 + 27, 2**34 + 11, 2**35 + 3])
def test_the_control_fails(seed):
    """At the tiny size, 7 slots and long reads (~2 M positions), so that
    cut keys tie often enough at a size the CPU computes in a second; on
    several seeds, the card test's (2**34 + 11) among them."""
    [(name, value, limit)] = control.readings(CELL, seed, "cpu",
                                              overrides=TINY)
    assert name == "sig_reads_differ" and value > limit


def altered_word(monkeypatch):
    from kmerutils_tpu_torch.ops import sketch_grid
    orig = sketch_grid.grid_min

    def bad(*a, **kw):
        out = orig(*a, **kw).clone()
        out[0, 0] ^= 1
        return out
    monkeypatch.setattr(sketch_grid, "grid_min", bad)


def batch_left_out(monkeypatch):
    """Every call of the first batch's shape returns zeros: that batch is
    never sketched."""
    from kmerutils_tpu_torch.ops import sketch_grid
    orig = sketch_grid.grid_min
    first = []

    def bad(x, *a, **kw):
        out = orig(x, *a, **kw)
        if not first:
            first.append(tuple(x.shape))
        return out.zero_() if tuple(x.shape) == first[0] else out
    monkeypatch.setattr(sketch_grid, "grid_min", bad)


@pytest.mark.parametrize("fault", [altered_word, batch_left_out])
def test_a_planted_fault_is_not_correct(fault, monkeypatch, tmp_path):
    fault(monkeypatch)
    # every batch checked, so the one left out is among them
    every = {"config": M1000["config"],
             "traffic": dict(M1000["traffic"], check_batches=10**6)}
    res = run_tiny(2**35 + 27, tmp_path=tmp_path, overrides=every)
    assert res["correct"] is False
    assert res["checks"]["sig_reads_differ"]["value"] > 0


def test_the_frozen_walk_rounds_against_a_fresh_count():
    """The walk rounds of 2^14 keys drawn as the program draws them
    (splitmix64 of seeded u64 items) against the frozen mean at m = 1000;
    and the frozen count's own arithmetic."""
    g = torch.Generator().manual_seed(2**31 + 27)
    items = torch.randint(-2**63, 2**63 - 1, (1 << 14,), generator=g,
                          dtype=torch.int64)
    kd = ref.splitmix64(items ^ 0x51)
    rounds, pairs = roofline_grid.walk_rounds(lsr(kd, 32) | 1,
                                              kd & 0xFFFFFFFF, 1000)
    assert pairs == 1000 << 14
    assert rounds / pairs == pytest.approx(roofline_grid.WALK_ROUNDS[1000],
                                           rel=2e-3)
    assert roofline_grid.WALK_ROUNDS[1000] == pytest.approx(0.023970,
                                                            abs=1e-6)
    assert roofline_grid.ops_per_pair(1000) == pytest.approx(
        15 + 5 * 0.0239702, abs=1e-6)


def test_the_walk_rounds_of_keys_worked_by_hand():
    """m = 5 (nbits 3, shift 1), a = 1, b = 0: v -> v ^ (v >> 1), so
    slots 0-4 go to 0, 1, 3, 2, 6, and 6 walks to 5, then 7, then 4: three
    rounds for slot 4, none for the others."""
    one = torch.tensor([1], dtype=torch.int64)
    zero = torch.tensor([0], dtype=torch.int64)
    assert roofline_grid.walk_rounds(one, zero, 5) == (3, 5)


def test_g1_pairs_and_bytes():
    valid = torch.tensor([[True, True, False], [False, False, False],
                          [True, False, True]])
    assert int(roofline_grid.g1_pairs(valid, 1000)) == 4 * 1000
    assert roofline_grid.g1_bytes(3, 3, 1000) == 3 * 3 * 13 + 3 * 1000 * 4


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
        "g1_roofline_pct": ("kernel G1", "device_trace", "higher"),
        "grid_gpos_per_s": ("sketch", "device_trace", "higher"),
        "g1_split_pct": ("sketch", "program_counter", "lower")}
    assert [m["name"] for m in c.end_to_end] == ["mbases_per_s", "setup_s"]
    for other in ("ont_sketch_k8_resident", "ont_sketch_k21_resident",
                  "ont_count_k16_resident"):
        assert not {m["name"] for m in spec.cell(other).per_layer} \
            & set(METRICS)


def hand_trace(**kw):
    """Window [0, 10^9) ns: two G1 spans of 2 and 3 x 10^9 positions over
    1 s of stream time, the second split; two G1 calls over 0.5 s of
    device time."""
    args = dict(
        t0=0, t1=10**9, jobs=2, spans=[],
        records={"sketch.grid": [(2 * 10**9, Event(0.0), Event(400.0)),
                                 (3 * 10**9, Event(500.0), Event(1100.0))],
                 "sketch.g1_split": [0, 3 * 10**9],
                 "g1": [(10**6, 1000, 10**6), (10**9, 1000, 10**12)]},
        device=[("G1 grid_min", "a", 0, 2 * 10**8),
                ("G1 grid_min", "b", 3 * 10**8, 6 * 10**8),
                ("elementwise", "c", 6 * 10**8, 7 * 10**8)])
    args.update(kw)
    return tracing.Trace(**args)


def test_the_readers_arithmetic_on_a_trace_built_by_hand():
    r = readers()
    tr = hand_trace()
    assert r["g1_split_pct"].read(tr) == pytest.approx(60.0)
    assert r["grid_gpos_per_s"].read(tr) == pytest.approx(5.0)
    per = 10 + 5 * (1 + roofline_grid.WALK_ROUNDS[1000])
    # the first call is bound by its operations, the second by its bytes
    least = roofline.ops_s(10**6 * per) + roofline.bytes_s(10**12)
    assert roofline.bytes_s(10**6) < roofline.ops_s(10**6 * per)
    assert roofline.bytes_s(10**12) > roofline.ops_s(10**9 * per)
    assert r["g1_roofline_pct"].read(tr) == pytest.approx(100 * least / 0.5)


@pytest.mark.parametrize("records,device,reads", [
    ({}, True, set()),
    ({"sketch.g1_split": [0]}, True, set()),
    ({"sketch.grid": [(5, Event(1.0), Event(2.0))]}, True,
     {"grid_gpos_per_s"}),
    ({"sketch.grid": [(5, Event(1.0), Event(1.0))],
      "sketch.g1_split": [0]}, True, {"g1_split_pct"}),
    ({"g1": [(10, 1000, 100)]}, False, set()),
    ({"g1": [(10, 200, 100)]}, True, set())],
    ids=["nothing", "counter-alone", "span-alone", "no-stream-time",
         "no-device-time", "m-not-frozen"])
def test_the_readers_are_none_without_their_records(records, device, reads):
    """A program without the span or the counter, a trace without stream
    time, without G1's device time or at an m whose walk is not frozen:
    the metric is left out, not 0."""
    tr = hand_trace(records=records) if device else hand_trace(
        records=records, device=[])
    got = {n for n, r in readers().items() if r.read(tr) is not None}
    assert got == reads
