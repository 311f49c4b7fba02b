"""Device-time breakdown of ``Sketcher.sketch_batch`` on one CUDA card.

    python -m kmerutils_tpu_torch.profile_sketch [--iters 10] [--algo HLL]
        [--out FILE]

At the bench shape (1024 random reads x 6000 bases, m=200), for k=8 and
k=21 of the family ``--algo`` names (PROB3A by default: K1 at k=8, K2 at
k=21; HLL runs G2), in one process on one card:

1. times a loop of ``iters`` calls with CUDA events (no profiler);
2. runs the same loop again under ``torch.profiler`` with CUDA events
   around it, sums the device time of every kernel by family (tournament,
   grid, sort, scan, elementwise, other) and takes the loop's idle share as
   1 - kernel time / event time of that same loop.

Kernels of one stream do not overlap, so the kernel sum is the busy time.
Prints one JSON line per k (the card's name and power limit included) and
appends the lines to ``--out`` when given.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

FAMILIES = (("tournament", ("tournament",)),
            ("grid", ("grid_min", "grid_max")),
            ("sort", ("sort", "radix")),
            ("scan", ("scan", "cum")),
            ("elementwise", ("elementwise", "vectorized", "unrolled")))


def family(kernel_name: str) -> str:
    name = kernel_name.lower()
    for fam, keys in FAMILIES:
        if any(key in name for key in keys):
            return fam
    return "other"


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout
        return out.splitlines()[0].strip()
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "unknown"


def loop_ms(fn, iters: int) -> float:
    """Event time of ``iters`` back-to-back calls."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def profile(fn, iters: int) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn()
    torch.cuda.synchronize()
    plain_ms = loop_ms(fn, iters)
    # a session now and then records no device events at all (seen on the
    # H100 machines late in a long process): such a session is run again
    for _ in range(3):
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            profiled_ms = loop_ms(fn, iters)
        device = [ev for ev in prof.events()
                  if ev.device_type == DeviceType.CUDA]
        if device:
            break
    else:
        raise RuntimeError("the profiler recorded no device events")
    fams: dict[str, float] = {}
    per_kernel: dict[str, float] = {}
    n_kernels = 0
    for ev in device:
        us = ev.time_range.elapsed_us()
        n_kernels += 1
        fams[family(ev.name)] = fams.get(family(ev.name), 0.0) + us
        per_kernel[ev.name] = per_kernel.get(ev.name, 0.0) + us
    busy_ms = sum(fams.values()) / 1e3
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:10]
    return {
        "event_ms_per_call": plain_ms / iters,
        "profiled_event_ms_per_call": profiled_ms / iters,
        "device_ms_per_call": busy_ms / iters,
        "idle_share_profiled_loop": 1.0 - busy_ms / profiled_ms,
        "idle_share_vs_unprofiled_loop": 1.0 - busy_ms / plain_ms,
        "kernels_per_call": n_kernels / iters,
        "family_ms_per_call": {f: us / 1e3 / iters for f, us in fams.items()},
        "top_kernels_ms_per_call": [[name[:120], us / 1e3 / iters]
                                    for name, us in top],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="profile_sketch")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--algo", default="PROB3A")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from .base.sequence import pack_codes
    from .sketch.jaccard import Sketcher
    from .sketch.params import SeqSketcherParams, SketchAlgo

    n, L, m = 1024, 6000, 200
    card = card_line()
    rng = np.random.default_rng(args.seed)
    codes = rng.integers(0, 4, size=(n, L), dtype=np.uint8)
    batch = pack_codes(codes, np.full(n, L, np.int32), device="cuda")
    lines = []
    for k in (8, 21):
        sk = Sketcher(SeqSketcherParams(kmer_size=k, sketch_size=m,
                                        algo=SketchAlgo(args.algo)))
        r = {"profile": f"sketch_batch_k{k}", "algo": args.algo,
             "reads": n, "length": L,
             "m": m, "iters": args.iters,
             **profile(lambda: sk.sketch_batch(batch), args.iters),
             "card": card}
        lines.append(json.dumps(r))
        print(lines[-1], flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
