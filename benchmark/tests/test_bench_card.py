"""The cells and their controls on the card, at small sizes (the benchmark's
runs measure them at full size): ``python -m pytest benchmark/tests -m
card`` on a machine with a CUDA card; skipped without one."""

import json
import os

import pytest

from benchmark import control
from benchmark.harness import runner, spec

from .sizes import TINY

CELLS = [w["name"] for w in json.load(open(os.path.join(
    spec.ROOT, "BENCHMARK.json")))["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_a_cell_is_correct_on_the_card(card, cell, trace, tmp_path):
    res = runner.run_cell(cell, 2**34 + 9, 1.0, trace, device=card,
                          overrides=TINY[cell], out_dir=str(tmp_path))
    assert res["correct"] and res["device"]["platform"] == "gpu"
    if trace:
        assert res["device"]["busy_s"] > 0


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_on_the_card(card, cell):
    got = control.readings(cell, 2**34 + 11, card, overrides=TINY[cell])
    assert all(v > lim for _, v, lim in got)
