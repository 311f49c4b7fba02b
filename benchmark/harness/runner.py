"""One run of one cell: inputs, set-up, the closed-loop window, the check
and the result line.

The order of a run:

1. the entry makes the cell's inputs from the seed (under ``TMPDIR``);
2. it sets up and warms the program on the cell's own paths (the first run
   in a checkout builds the kernels into its ``build/``);
3. the window: one client in a closed loop, each job starting when the
   last one ended; the window closes at the end of the first job that
   ends ``seconds`` or more after it opened, so every job in it is whole;
4. the peak device memory is read, the program's state freed, and the
   outputs of the window's jobs (or a sample drawn from the seed) are
   compared with the plain reference;
5. the result: end-to-end metrics (``--trace 0``) or per-layer metrics
   with the device's busy time and a breakdown (``--trace 1``), and each
   number compared beside its limit.

``setup_s`` runs from the process's start to the window's start.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import shutil
import sys
import tempfile
import time
import traceback

from . import imports, spec
from . import trace as tracing


@dataclasses.dataclass
class Context:
    """What an entry gets: the cell, the run's seed, the device and a
    scratch directory that is removed when the run ends."""
    cell: spec.Cell
    seed: int
    device: str
    tmp: str

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def traffic(self) -> dict:
        return self.cell.traffic


@dataclasses.dataclass
class Window:
    """The window's record, which the end-to-end readers read."""
    setup_s: float
    window_s: float
    walls: list             # seconds of each job
    bases: int              # clean bases of all jobs


def process_start_ns() -> int:
    """The process's start on the perf_counter clock (from /proc; now, where
    that cannot be read)."""
    now = time.perf_counter_ns()
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        age = up - int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return now - int(max(age, 0.0) * 1e9)
    except (OSError, ValueError, IndexError):
        return now


class ForbiddenImport(RuntimeError):
    pass


def _device_info(torch, device: str, chips: int) -> dict:
    if device == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": chips,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}
    return {"platform": device, "kind": device, "count": chips,
            "memory_peak_bytes": 0}


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", root: str = spec.ROOT,
             overrides: dict | None = None, out_dir: str | None = None,
             started_ns: int | None = None, boot: dict | None = None) -> dict:
    """Run cell ``name`` once and return its result (see the module
    docstring); raises :class:`ForbiddenImport` when JAX or the JAX
    package is loaded once the window has closed.  ``boot``: the parts of
    the process's start that the caller timed, printed with the phases."""
    started_ns = process_start_ns() if started_ns is None else started_ns
    cell = spec.cell(name, root, overrides)
    here = os.getcwd()
    tmp = tempfile.mkdtemp(prefix="kmerbench_")
    ctx = Context(cell, int(seed), device, tmp)
    try:
        return _run(ctx, seconds, trace, out_dir, started_ns, boot or {})
    finally:
        os.chdir(here)
        shutil.rmtree(tmp, ignore_errors=True)


def _run(ctx: Context, seconds: float, trace: bool, out_dir, started_ns,
         boot: dict):
    cell = ctx.cell
    entry = cell.entry().Entry(ctx)
    e2e = [(m, cell.reader(m)) for m in cell.end_to_end]
    layers = [(m, cell.reader(m)) for m in cell.per_layer] if trace else []
    phases = {"start": (time.perf_counter_ns() - started_ns) / 1e9}
    for step in ("inputs", "setup", "warm"):
        t = time.perf_counter()
        getattr(entry, step)()
        phases[step] = time.perf_counter() - t
    import torch
    cuda = ctx.device == "cuda"
    tracer = tracing.Tracer() if trace else None
    prof = tracing.DeviceProfile() if trace and cuda else None
    if prof is not None:
        prof.start()
    for _, reader in layers:
        if hasattr(reader, "probes"):
            reader.probes(tracer)
    launches0 = _launches()
    # what set-up wrote (inputs, a first run's builds) reaches the disk now,
    # not by the kernel's writeback inside the window
    t = time.perf_counter()
    os.sync()
    phases["sync"] = time.perf_counter() - t
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    if prof is not None:
        prof.mark()
    t0 = time.perf_counter_ns()
    walls, bases, failed, i = [], 0, 0, 0
    while True:
        js = time.perf_counter_ns()
        try:
            bases += entry.job(i)
        except Exception:
            failed += 1
            traceback.print_exc(file=sys.stderr)
        je = time.perf_counter_ns()
        walls.append((je - js) / 1e9)
        i += 1
        if je - t0 >= seconds * 1e9:
            break
    entry.drain()
    if cuda:
        torch.cuda.synchronize()
    t1 = time.perf_counter_ns()
    if prof is not None:
        prof.stop()
    if tracer is not None:
        tracer.restore()
    launches = {k: v - launches0.get(k, 0) for k, v in _launches().items()}
    device = _device_info(torch, ctx.device, cell.chips)
    bad = imports.forbidden()
    if bad:
        raise ForbiddenImport(bad)
    win = Window((t0 - started_ns) / 1e9, (t1 - t0) / 1e9, walls, bases)
    metrics: dict = {}
    extra: dict = {}
    if not trace:
        for m, reader in e2e:
            metrics[m["name"]] = {"value": reader.read(win),
                                  "unit": m["unit"]}
    else:
        dev_ops, host_ops = prof.events() if prof is not None else ([], {})
        tr = tracing.Trace(t0, t1, len(walls), tracer.spans, tracer.records,
                           tracing.clip_device(dev_ops, t0, t1))
        extra_doc = {"device_s_outside_window": sum(
            max(0, min(b, t0) - a) + max(0, b - max(a, t1))
            for _, a, b in dev_ops) / 1e9}
        for m, reader in layers:
            v = reader.read(tr)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device["busy_s"] = tr.busy_s()
        device["window_s"] = tr.window_s
        ops, gaps, idle_by = tracing.breakdown(tr)
        extra["breakdown"] = {"device_ops": ops, "idle_gaps": gaps}
        _write_trace(out_dir or os.path.join(cell.root, "build",
                                             "bench_traces"),
                     ctx, tr, win, metrics, launches, host_ops, ops, idle_by,
                     extra_doc)
        del dev_ops, host_ops, tr
    entry.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    checks = entry.check()
    phases["check"] = time.perf_counter() - t
    w = sorted(walls)
    print(f"run {cell.name} seed {ctx.seed}: phases "
          + " ".join(f"{k} {v:.3f} s" for k, v in phases.items())
          + "".join(f"; start: {k} {v:.3f} s" for k, v in boot.items())
          + f"; {len(w)} jobs, wall min {w[0]:.4f} median "
          f"{w[len(w) // 2]:.4f} max {w[-1]:.4f} s; window "
          f"{win.window_s:.3f} s", file=sys.stderr)
    bad = imports.forbidden()
    if bad:
        raise ForbiddenImport(bad)
    correct = failed == 0 and bool(walls) and all(v <= lim for _, v, lim
                                                  in checks)
    result = {"correct": correct, "attempted": len(walls), "failed": failed,
              "metrics": metrics, "device": device}
    result.update(extra)
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return result


def _launches() -> dict:
    """The program's kernel launch counters, where it has been loaded."""
    out = {}
    for mod, names in (("kmerutils_tpu_torch.ops.tournament",
                        ("launches_u32", "launches_u64")),
                       ("kmerutils_tpu_torch.ops.merge",
                        ("launches_merge", "launches_fold",
                         "launches_aggregate", "launches_live"))):
        m = sys.modules.get(mod)
        for n in names:
            if m is not None:
                out[n] = getattr(m, n)
    return out


def _write_trace(out_dir, ctx, tr, win, metrics, launches, host_ops, ops,
                 idle_by, extra) -> None:
    """The traced run's file: what does not go on the result line."""
    os.makedirs(out_dir, exist_ok=True)
    host = sorted(host_ops.items(), key=lambda kv: -kv[1][1])[:25]
    spans: dict = {}
    for n, a, b in tr.spans:
        s = spans.setdefault(n, [0, 0.0])
        s[0] += 1
        s[1] += (b - a) / 1e9
    jobs = max(len(win.walls), 1)
    doc = {"workload": ctx.cell.name, "seed": ctx.seed,
           "window_s": win.window_s, "jobs": len(win.walls),
           "bases": win.bases, "metrics": metrics,
           "busy_s": tr.busy_s(), "device_families_s": ops,
           "idle_s_by_host_span": idle_by,
           "spans": {n: {"count": c, "s": s} for n, (c, s) in spans.items()},
           "launches_per_job": {k: v / jobs for k, v in launches.items()},
           "h2d_bytes": sum(tr.records.get("h2d_bytes", [])),
           "host_top_ops": [{"op": n, "calls": c, "ms": ns / 1e6}
                            for n, (c, ns) in host],
           "job_walls_s": win.walls, **extra}
    path = os.path.join(out_dir, f"{ctx.cell.name}.{ctx.seed}.trace.json")
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
