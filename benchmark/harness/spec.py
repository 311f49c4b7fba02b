"""Finding a cell's parts by name, from ``BENCHMARK.json`` and the files
beside it.

For a cell of ``BENCHMARK.json``'s ``workloads``:

* its configuration: the ``file`` its ``configs`` entry names;
* its traffic: ``benchmark/traffic/<traffic>.json``, which names the entry
  that drives a job (``benchmark/entries/<entry>.py``) and the entry's and
  the generator's parameters;
* its metrics: the ``end_to_end`` and ``per_layer`` entries that apply to
  it (a metric with ``workloads`` applies to the cells listed; one without
  to every cell that reports the end-to-end metric it ``moves``), each read
  by ``benchmark/metrics/<name>.py`` (a quantity split by the cells'
  end-to-end metrics, ``<quantity>.<part>``, by ``<quantity>.py``).

So a cell, a traffic mix or a metric is added by adding its files and its
entry in ``BENCHMARK.json``; nothing here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def load_module(path: str, name: str):
    """The Python file at ``path`` as a module named ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list        # metric entries of BENCHMARK.json
    per_layer: list
    root: str

    def module(self, kind: str, name: str):
        """``benchmark/<kind>/<name>.py`` of this cell's tree."""
        path = os.path.join(self.root, "benchmark", kind, f"{name}.py")
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        return load_module(path, f"_bench_{kind}_{name.replace('.', '_')}"
                                 f"_{id(self)}")

    def entry(self):
        return self.module("entries", self.traffic["entry"])

    def reader(self, metric: dict):
        """The reader of a metric: ``metrics/<name>.py``, or for a quantity
        split by cells (``<quantity>.<part>``, as ``device_idle_pct.count``)
        ``metrics/<quantity>.py`` where the split has no file of its own."""
        name = metric["name"]
        path = os.path.join(self.root, "benchmark", "metrics", f"{name}.py")
        return self.module("metrics", name if os.path.exists(path)
                           else name.split(".", 1)[0])


def _applies(metric: dict, cell: str, e2e_names) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" in metric:
        return metric["moves"] in e2e_names
    return True


def _merge(base: dict, over: dict | None) -> dict:
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) \
            and isinstance(out.get(k), dict) else v
    return out


def cell(name: str, root: str = ROOT, overrides: dict | None = None) -> Cell:
    """The cell ``name``; ``overrides`` ({"config": {...}, "traffic":
    {...}}) replace parameters, for runs at a small size in the tests."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    found = [w for w in bench["workloads"] if w["name"] == name]
    if len(found) != 1:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    cfg_entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    with open(os.path.join(root, cfg_entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, "benchmark", "traffic",
                           f"{w['traffic']}.json")) as f:
        traffic = json.load(f)
    overrides = overrides or {}
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _applies(m, name, names)]
    return Cell(name, w["chips"], _merge(config, overrides.get("config")),
                _merge(traffic, overrides.get("traffic")), e2e, per_layer,
                root)
