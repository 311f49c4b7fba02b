"""Run one cell several times, each run its own process, and report the
spread of each metric: what a bound is set from.

    python3 -m benchmark.spread --workload <name> --seeds 11 12 13 ...
        [--sets 2] [--seconds S] [--trace 0|1] [--out FILE]

Each set runs every seed once, in order, through ``python3 -m
benchmark.run``; with ``--sets 2`` the same seeds run again.  Each run's
result line is appended to ``--out`` (a JSON line with the set, the seed,
the exit code and the seconds the process took).  Per set and metric it
prints the median and the spread: the distance between the first and
third quartiles of ``statistics.quantiles(values, n=4)``, as a share of
the median.  Needs the card, as the runs do.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

from .harness import spec


def spread(values) -> float:
    q = statistics.quantiles(values, n=4)
    return (q[2] - q[0]) / statistics.median(values)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark.spread")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--sets", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.seconds is None:
        with open(os.path.join(spec.ROOT, "BENCHMARK.json")) as f:
            args.seconds = json.load(f)["run_seconds"]
    out = args.out or os.path.join(spec.ROOT, "build", "bench_traces",
                                   f"{args.workload}.runs.jsonl")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    by_set: dict = {}
    for s in range(args.sets):
        for seed in args.seeds:
            t = time.perf_counter()
            p = subprocess.run(
                [sys.executable, "-m", "benchmark.run", "--workload",
                 args.workload, "--seed", str(seed), "--seconds",
                 str(args.seconds), "--trace", str(args.trace)],
                cwd=spec.ROOT, capture_output=True, text=True)
            took = time.perf_counter() - t
            lines = p.stdout.strip().splitlines()
            try:
                res = json.loads(lines[-1]) if p.returncode == 0 else None
            except (IndexError, json.JSONDecodeError):
                res = None
            rec = {"set": s, "seed": seed, "rc": p.returncode,
                   "process_s": took, "result": res,
                   "stderr_tail": p.stderr[-1500:]}
            with open(out, "a") as f:
                f.write(json.dumps(rec) + "\n")
            short = {k: v["value"] for k, v in (res or {}).get(
                "metrics", {}).items()}
            for line in p.stderr.splitlines():
                if line.startswith("run "):
                    print("  " + line, flush=True)
            print(f"set {s} seed {seed}: rc {p.returncode} "
                  f"{took:.1f} s correct={(res or {}).get('correct')} "
                  f"{short} checks={(res or {}).get('checks')}", flush=True)
            if res is not None:
                for k, v in short.items():
                    by_set.setdefault(k, {}).setdefault(s, []).append(v)
            else:
                print(p.stderr[-3000:], flush=True)
    for k, sets in by_set.items():
        for s, vals in sorted(sets.items()):
            line = f"{k} set {s}: n={len(vals)} median " \
                   f"{statistics.median(vals)!r}"
            if len(vals) >= 2:
                line += f" spread {spread(vals):.4%}"
            print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
