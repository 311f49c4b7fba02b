"""The reader of ``k1_logf_pct`` (K1's draws through ln(u) over the draws
its inputs need) on the CPU: its entry in the sketch cell, its arithmetic
on a trace built by hand, and None where a record is missing."""

import pytest
import torch

from benchmark.harness import spec

from .test_bench_obs import CELL, hand_trace


def k1_logf_reader():
    c = spec.cell(CELL)
    (m,) = [m for m in c.per_layer if m["name"] == "k1_logf_pct"]
    assert (m["layer"], m["source"], m["better"], m["moves"]) == (
        "kernel K1", "program_counter", "lower", "mbases_per_s")
    return c.reader(m)


@pytest.mark.parametrize("records,want", [
    ({"sketch.k1_logf": [30, 20], "k1": [(400, 8), (600, 8)]}, 5.0),
    ({"sketch.k1_logf": [1], "k1": [(4, 8)]}, 25.0),
    ({}, None),
    ({"k1": [(400, 8)]}, None),                   # a program without it
    ({"sketch.k1_logf": [3]}, None),              # no needed draws recorded
    ({"sketch.k1_logf": [0], "k1": [(0, 8)]}, None)])
def test_k1_logf_pct_is_the_counter_over_the_needed_draws(records, want):
    got = k1_logf_reader().read(hand_trace(records=records))
    assert got == (None if want is None else pytest.approx(want))
    # the program hands device scalars; the reader sums them once
    dev = {k: ([torch.tensor(v) for v in vs] if k == "sketch.k1_logf"
               else [(torch.tensor(d), b) for d, b in vs])
           for k, vs in records.items()}
    got = k1_logf_reader().read(hand_trace(records=dev))
    assert got == (None if want is None else pytest.approx(want))
