"""The check against planted faults: each cell's run, on the CPU at a
small size, with the timed path broken underneath, comes out not correct.

The faults a cell can have: an answer altered where it is produced (a
signature word); half of a batch left out.  The sketch keeps no state from
one step to the next, so no step can return it unchanged, and no cell
exchanges anything between chips.
"""

import pytest

from benchmark.harness import runner

from .sizes import TINY

SKETCH = ["ont_sketch_k8_resident"]


def altered_signature(monkeypatch):
    from kmerutils_tpu_torch.ops import tournament
    orig = tournament.weighted_tournament

    def bad(*a, **kw):
        out = orig(*a, **kw).clone()
        out[0, 0] ^= 1
        return out
    monkeypatch.setattr(tournament, "weighted_tournament", bad)


def half_sketch_batch(monkeypatch):
    from kmerutils_tpu_torch.ops import tournament
    orig = tournament.weighted_tournament

    def bad(items, winv, m, *a, **kw):
        out = orig(items, winv, m, *a, **kw).clone()
        out[out.shape[0] // 2:] = 0
        return out
    monkeypatch.setattr(tournament, "weighted_tournament", bad)


CASES = [(c, f) for c in SKETCH for f in (altered_signature,
                                          half_sketch_batch)]


@pytest.mark.parametrize("cell,fault", CASES,
                         ids=[f"{c}-{f.__name__}" for c, f in CASES])
def test_a_planted_fault_is_not_correct(cell, fault, monkeypatch, tmp_path):
    fault(monkeypatch)
    res = runner.run_cell(cell, 2**35 + 1, 0.3, False, device="cpu",
                          overrides=TINY[cell], out_dir=str(tmp_path))
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values())
