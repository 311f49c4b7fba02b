"""Sweep of the SuperMinHash grid kernel G1 (``grid_min_kernel`` of
csrc/sketch.cu) on one CUDA card: slots a thread (``KMER_GRID_R``: 4, 8,
16), positions staged per step (``KMER_GRID_CHUNK``: 512, 1024) and walk
rounds in the main loop (``KMER_GRID_INLINE``: 0, 1); and, for timing only,
the default configuration without its drain (``KMER_GRID_DRAIN=0``: a
wrong result, the time of the main loop alone).

    python3 -m kmerutils_tpu_torch.sweep_grid [--out FILE]

Run from the repository's root.  Builds csrc/sketch.cu once per
configuration (one nvcc each, all started together) into build/sweep/ and
prints each build's registers and spills of ``grid_min_kernel`` and its
SASS inner loop per (position, slot) pair, by pipe.  At phase 11's timed
shapes of ``chip_smoke.py`` (the 1024 x 6000 bench batch at k=8 and k=21,
m = 200; ``sketch_collection``'s one row of its ~6.1 M distinct 21-mers)
every exact configuration is checked against ``grid_min_ref``, then all
are timed with CUDA events over back-to-back calls (the output's fill and
the launch), configurations in turns, forwards then backwards.  Prints one
JSON line per (configuration, shape) and one ranking line of the exact
ones (geometric mean over the shapes of the time over the bound of
``roofline.grid_work``), each with the card's name and power limit, and
appends them to ``--out``.  Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import itertools
import json
import math
import sys
import time

import numpy as np
import torch

from . import _build, roofline
from .ops import sketch_grid as G
from .profile_sketch import card_line, loop_ms

# (slots a thread, positions staged per step, inline walk rounds, drain)
CONFIGS = tuple(itertools.product((4, 8, 16), (512, 1024), (0, 1), (1,))) \
    + ((8, 1024, 1, 0),)
NAMES = ("R", "CHUNK", "INLINE", "DRAIN")


def build_all(configs) -> dict:
    """{config: (ctypes library, (registers, spill bytes), SASS loop)}, one
    nvcc per configuration."""
    libs = _build.build_variants(
        configs, lambda c: [f"-DKMER_GRID_{k}={v}" for k, v in zip(NAMES, c)],
        "sketch.cu", _build.declare_sketch)
    out = {}
    for cfg, (lib, text) in libs.items():
        regs = _build.ptxas_registers(text, r"(grid_min_kernel)")
        sass = roofline.grid_instructions_per_pair(lib._name)["grid_min"]
        out[cfg] = (lib, regs.get("grid_min_kernel"), sass)
    return out


def shapes(seed: int):
    """(name, G1's inputs) at phase 11's timed shapes."""
    from chip_smoke import grid_args, random_batch
    from .sketch.jaccard import hashed_kmers
    bench = random_batch(np.random.default_rng(seed), 1024, 6000)
    for k in (8, 21):
        items, valid = hashed_kmers(bench, k)
        yield f"bench_k{k}", grid_args(torch, items, valid, 200)[0]
    items, valid = hashed_kmers(bench, 21)
    yield "collection_k21", grid_args(torch, items.reshape(1, -1),
                                      valid.reshape(1, -1), 200)[0]


def launcher(lib, args, sms: int):
    """(one call of ``lib``'s G1 on args into an output allocated once,
    the output)."""
    x, a, b, valid, slotc = args
    n, P = x.shape
    m = slotc.shape[0]
    out = torch.empty((n, m), dtype=torch.int32, device=x.device)
    cfg = G.library_config(lib)
    pl = G.plan(n, P, m, sms, cfg[2])
    ptrs = [t.data_ptr() for t in (x, a, b, valid, slotc, out)]

    def once():
        out.fill_(-1)
        _build.launch(lib.launch_grid_min, *ptrs, n, P, m,
                      pl.threads_per_set, pl.subsets, pl.span,
                      device=out.device)
    return once, out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="sweep_grid")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = roofline.sm_clock_hz()
    t0 = time.perf_counter()
    libs = build_all(CONFIGS)
    lines = [{"sweep": "build", "configs": len(libs),
              "seconds": time.perf_counter() - t0, "card": card}]
    for cfg, (_, regs, sass) in libs.items():
        lines.append({"config": dict(zip(NAMES, cfg)),
                      "registers_spill": regs,
                      "sass_per_pair": sass["instructions_per_draw"],
                      "pipes_per_pair": sass["pipes_per_draw"]})
    for line in lines:
        print(json.dumps(line), flush=True)
    share = {cfg: [] for cfg in libs}
    for what, wargs in shapes(args.seed):
        want = G.grid_min_ref(*wargs)
        runs = {}
        for cfg, (lib, _, _) in libs.items():
            once, out = launcher(lib, wargs, sms)
            once()
            torch.cuda.synchronize()
            if cfg[3] and not torch.equal(out, want):
                raise SystemExit(f"{dict(zip(NAMES, cfg))} != plain at "
                                 f"{what}")
            runs[cfg] = once
        del want
        ops, nbytes = roofline.grid_work("grid_min", wargs)
        bound = roofline.bound(nbytes, ops, sms, clock)[0]
        ms = {cfg: [] for cfg in libs}
        for order in (list(libs), list(libs)[::-1]):
            for cfg in order:
                runs[cfg]()
                torch.cuda.synchronize()
                ms[cfg].append(loop_ms(runs[cfg], args.iters) / args.iters)
        for cfg in libs:
            share[cfg].append(min(ms[cfg]) / bound)
            line = {"config": dict(zip(NAMES, cfg)), "shape": what,
                    "ms": ms[cfg], "bound_ms": bound,
                    "bound_share": bound / min(ms[cfg]),
                    "exact": bool(cfg[3]), "card": card}
            lines.append(line)
            print(json.dumps(line), flush=True)
        del runs, wargs
        torch.cuda.empty_cache()
    rank = sorted(((math.exp(sum(map(math.log, s)) / len(s)),
                    dict(zip(NAMES, cfg))) for cfg, s in share.items()
                   if cfg[3]), key=lambda r: r[0])
    lines.append({"sweep": "ranking", "time_over_bound_geomean": rank[:12],
                  "card": card})
    print(json.dumps(lines[-1]), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.writelines(json.dumps(line) + "\n" for line in lines)
    return 0


if __name__ == "__main__":
    sys.exit(main())
