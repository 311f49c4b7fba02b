"""The controls of the cells' correctness checks, at the cells' own sizes.

    python3 -m benchmark.control --workload <name> --seeds 1 2 3 [--out F]

For each seed, the cell's entry makes its inputs and puts the plain
reference, computed at the next precision below the configuration's, in
the program's place (``Entry.control``: the sketch's draws in bfloat16
for float32): every number compared has to come out above its limit, or
the check could not tell such a program from a sound one.  Prints one
JSON line per seed (appended to ``--out``) and exits non-zero when a
control passes.  The benchmark's own runs do not run
it.  Needs the card, as the cells do.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

from .harness import runner, spec


def readings(name: str, seed: int, device: str = "cuda",
             root: str = spec.ROOT, overrides: dict | None = None) -> list:
    """[(name, number, limit)] of the control of cell ``name``."""
    cell = spec.cell(name, root, overrides)
    tmp = tempfile.mkdtemp(prefix="kmerbench_control_")
    try:
        entry = cell.entry().Entry(runner.Context(cell, seed, device, tmp))
        entry.inputs()
        return entry.control()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("benchmark.control: no CUDA device", file=sys.stderr)
        return 1
    passed = 0
    for seed in args.seeds:
        t = time.perf_counter()
        got = readings(args.workload, seed)
        rec = {"workload": args.workload, "seed": seed,
               "seconds": time.perf_counter() - t,
               "checks": {n: {"value": v, "limit": lim} for n, v, lim in got},
               "control_fails": any(v > lim for _, v, lim in got)}
        passed += not rec["control_fails"]
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 1 if passed else 0


if __name__ == "__main__":
    sys.exit(main())
