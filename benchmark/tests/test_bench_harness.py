"""The harness on the CPU: every cell runs and reports by the contract,
cells and metrics are found by name, and a run without a card or with JAX
loaded gives no result."""

import contextlib
import io
import json
import os
import re
import shutil
import statistics

import pytest

from benchmark import run
from benchmark.harness import imports, runner, spec

from .sizes import TINY

ROOT = spec.ROOT
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def run_tiny(name, trace, tmp_path, root=ROOT, overrides=None):
    return runner.run_cell(name, 2**33 + 17, 0.3, trace, device="cpu",
                           root=root, overrides=overrides or TINY[name],
                           out_dir=str(tmp_path))


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_runs_correct_with_the_contract_keys(cell, trace,
                                                        tmp_path):
    res = run_tiny(cell, trace, tmp_path)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    c = spec.cell(cell)
    want = {m["name"] for m in (c.per_layer if trace else c.end_to_end)}
    # on the CPU the device metrics have nothing to read
    got = set(res["metrics"])
    assert got <= want
    if not trace:
        assert got == want
        assert all(v["value"] > 0 for v in res["metrics"].values())
    else:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert os.path.exists(tmp_path / f"{cell}.{2**33 + 17}.trace.json")
    for v in res["checks"].values():
        assert set(v) == {"value", "limit"}


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = 24
    need = (2 + 14 * cells) * (BENCH["run_seconds"] + 60) + cells * 180 \
        + 1200
    assert need <= 43200
    configs = {c["name"] for c in BENCH["configs"]}
    used = {w["config"] for w in BENCH["workloads"]}
    assert configs == used
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        cfg = json.load(open(os.path.join(ROOT, c["file"])))
        assert cfg["reduced"] == c["reduced"] and cfg["source"]
        assert len(c["source"]) <= 200 and len(c["why"]) <= 200
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert os.path.exists(os.path.join(
            ROOT, "benchmark", "traffic", w["traffic"] + ".json"))
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m
        for w in m["workloads"]:
            assert w in CELLS
            assert "workloads" not in e2e[m["moves"]] \
                or w in e2e[m["moves"]]["workloads"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and m["better"] in ("lower", "higher")
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
    for cell in CELLS:
        c = spec.cell(cell)
        assert {"setup_s"} < {m["name"] for m in c.end_to_end}
        assert c.per_layer
    assert len(json.dumps(BENCH)) < 64 << 10


def copy_tree(tmp_path):
    root = tmp_path / "tree"
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    return root


def test_a_cell_a_traffic_and_a_metric_added_as_files_run(tmp_path):
    """A later cell brings its traffic, a metric reader and entries of its
    own in BENCHMARK.json, and edits no entry that is there: its end-to-end
    metric and a split per-layer metric (``<quantity>.<part>``) are read by
    the quantity's reader."""
    root = copy_tree(tmp_path)
    bench = json.load(open(root / "BENCHMARK.json"))
    with open(root / "benchmark" / "traffic" / "tiny_pool.json", "w") as f:
        json.dump({"entry": "sketch_resident", "pool_reads": 120,
                   "batch_reads": 64, "max_batch_bases": 8192,
                   "window_batches": 2, "lengths_seed": 1,
                   "check_batches": 2}, f)
    with open(root / "benchmark" / "metrics" / "jobs_per_s.py", "w") as f:
        f.write("def read(trace):\n    return trace.jobs / trace.window_s\n")
    bench["workloads"].append({"name": "tiny_sketch", "config":
                               "ont_sketch_k8_m200", "traffic": "tiny_pool",
                               "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "mbases_per_s.tiny", "unit":
                                "Mbases/s", "better": "higher", "bound": 0.25,
                                "source": "host_clock",
                                "workloads": ["tiny_sketch"]})
    for name in ("jobs_per_s", "device_idle_pct.tiny"):
        bench["per_layer"].append({"name": name, "unit": "1/s",
                                   "better": "higher", "source": "host_clock",
                                   "layer": "device",
                                   "moves": "mbases_per_s.tiny",
                                   "workloads": ["tiny_sketch"]})
    with open(root / "BENCHMARK.json", "w") as f:
        json.dump(bench, f)
    small = {"config": TINY["ont_sketch_k8_resident"]["config"]}
    res = run_tiny("tiny_sketch", False, tmp_path, str(root), small)
    assert res["correct"] and res["attempted"] >= 1
    assert set(res["metrics"]) == {"mbases_per_s.tiny", "setup_s"}
    assert res["metrics"]["mbases_per_s.tiny"]["value"] > 0
    c = spec.cell("tiny_sketch", str(root))
    assert [m["name"] for m in c.per_layer] == ["jobs_per_s",
                                                "device_idle_pct.tiny"]
    assert c.reader(c.per_layer[1]).__doc__.startswith("device_idle_pct")
    res = run_tiny("tiny_sketch", True, tmp_path, str(root), small)
    assert res["metrics"]["jobs_per_s"]["value"] > 0


def test_a_run_without_a_card_gives_no_result(monkeypatch, capsys):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", CELLS[0], "--seed", str(2**32 + 3),
                   "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "no CUDA device" in out.err


def test_an_unknown_cell_gives_no_result(capsys):
    rc = run.main(["--workload", "no_such_cell", "--seed", "1",
                   "--seconds", "1"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_forbidden_modules_are_named_by_their_top_level_name():
    assert imports.forbidden(["kmerutils_tpu_torch", "kmerutils_tpu_torch.io",
                              "numpy", "jaxtyping"]) == []
    assert imports.forbidden(["jax.numpy", "kmerutils_tpu.ops", "flax",
                              "jaxlib"]) == ["flax", "jax", "jaxlib",
                                             "kmerutils_tpu"]


def test_a_run_that_loads_jax_gives_no_result(monkeypatch, tmp_path):
    import sys
    import types
    monkeypatch.setitem(sys.modules, "kmerutils_tpu", types.ModuleType("x"))
    with pytest.raises(runner.ForbiddenImport):
        run_tiny(CELLS[0], False, tmp_path)


def test_nothing_loaded_by_a_run_is_jax():
    assert imports.forbidden() == []


def test_spread_is_the_quartile_distance_over_the_median():
    from benchmark.spread import spread
    vals = [10.0, 11.0, 12.0, 13.0, 14.0, 15.0]
    q = statistics.quantiles(vals, n=4)
    assert spread(vals) == pytest.approx((q[2] - q[0]) / 12.5)


def test_a_run_prints_its_checks_last(monkeypatch, capsys):
    """The card path of run.main, with the cell's run on the CPU in its
    place: the checks are the last lines of stderr, the result the last
    line of stdout."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    cell = CELLS[0]
    run_cell = runner.run_cell

    def cpu_run(name, seed, seconds, trace, device, started_ns, boot):
        assert set(boot) == {"python", "torch", "cuda", "program"}
        return run_cell(name, seed, 0.3, trace, device="cpu",
                        overrides=TINY[name], started_ns=started_ns,
                        boot=boot)
    monkeypatch.setattr(runner, "run_cell", cpu_run)
    with contextlib.redirect_stdout(io.StringIO()) as out:
        rc = run.main(["--workload", cell, "--seed", "3000000123",
                       "--seconds", "0.3", "--trace", "0"])
    err = capsys.readouterr().err.strip().splitlines()
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    assert rc == 0 and res["correct"]
    assert err[-len(res["checks"]):] == [
        f"check {n}: {c['value']} (limit {c['limit']})"
        for n, c in res["checks"].items()]
