"""Run one cell of the benchmark once, on the card.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s>
                             --trace <0|1>

from the root of a checkout (the program, ``kmerutils_tpu_torch``, is
imported from there; its kernels are built into the checkout's ``build/``
on the first run).  Cells, metrics and limits: ``BENCHMARK.json``; the
order of a run: ``harness/runner.py``.  The last line of standard output
is the result, one JSON object; the numbers compared with the reference
are the last lines of standard error and the result's last key.  A
``--trace 1`` run also writes what does not fit on that line (spans,
launches a job, the host's top calls, every job's wall) to
``build/bench_traces/<cell>.<seed>.trace.json`` in the checkout.

Exits non-zero without a result when no CUDA card is found or fewer than
the cell asks for, when the program is not in this checkout, and when
JAX or the JAX package has been loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from .harness import runner, spec

CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR":
          "torch_extensions"}


def parse(argv):
    p = argparse.ArgumentParser(prog="benchmark.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fail(msg: str) -> int:
    print(f"benchmark.run: {msg}", file=sys.stderr, flush=True)
    return 1


def main(argv=None) -> int:
    started = runner.process_start_ns()
    # the start of set-up, split: what swings it between runs
    boot = {"python": (time.perf_counter_ns() - started) / 1e9}
    args = parse(argv)
    for var, sub in CACHES.items():
        os.environ[var] = os.path.join(spec.ROOT, "build", "bench_cache", sub)
    try:
        cell = spec.cell(args.workload)
    except (OSError, KeyError, StopIteration, ValueError) as e:
        return fail(f"cannot read the cell {args.workload!r}: {e!r}")
    t = time.perf_counter()
    import torch
    boot["torch"] = time.perf_counter() - t
    t = time.perf_counter()
    if not torch.cuda.is_available():
        return fail("no CUDA device: this benchmark measures the card")
    if torch.cuda.device_count() < cell.chips:
        return fail(f"{torch.cuda.device_count()} CUDA devices, the cell "
                    f"needs {cell.chips}")
    boot["cuda"] = time.perf_counter() - t
    t = time.perf_counter()
    try:
        import kmerutils_tpu_torch
    except ImportError as e:
        return fail(f"the program is not in this checkout: {e}")
    boot["program"] = time.perf_counter() - t
    where = os.path.dirname(os.path.abspath(kmerutils_tpu_torch.__file__))
    if os.path.dirname(where) != spec.ROOT:
        return fail(f"kmerutils_tpu_torch comes from {where}, not from "
                    f"this checkout ({spec.ROOT})")
    try:
        result = runner.run_cell(args.workload, args.seed, args.seconds,
                                 bool(args.trace), device="cuda",
                                 started_ns=started, boot=boot)
    except runner.ForbiddenImport as e:
        return fail(f"forbidden modules loaded: {e}")
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
