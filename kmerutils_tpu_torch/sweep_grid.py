"""Sweep of the grid kernels of csrc/sketch.cu on one CUDA card.

G1, SuperMinHash's ``grid_min_kernel`` (the default ``--kernel
grid_min``): slots a thread (``KMER_GRID_R``: 4, 8, 16), positions staged
per step (``KMER_GRID_CHUNK``: 512, 1024) and walk rounds in the main loop
(``KMER_GRID_INLINE``: 0, 1); and, for timing only, the default
configuration without its drain (``KMER_GRID_DRAIN=0``: a wrong result, the
time of the main loop alone).

G2, SetSketch's ``grid_max_kernel`` (``--kernel grid_max``): slots a thread
(``KMER_GRID_MAX_R``: 4, 8, 16) x staged positions a shared load
(``KMER_GRID_MAX_VEC``: 1, 2, 4) x positions staged per step
(``KMER_GRID_MAX_CHUNK``: 1024, 2048).

    python3 -m kmerutils_tpu_torch.sweep_grid [--kernel grid_max] [--out FILE]

Run from the repository's root.  Builds csrc/sketch.cu once per
configuration (one nvcc each, all started together) into build/sweep/ and
prints each build's registers and spills of the kernel and its SASS inner
loop per (position, slot) pair, by pipe.  At phase 11's timed shapes of
``chip_smoke.py`` (the 1024 x 6000 bench batch at k=8 and k=21, m = 200;
``sketch_collection``'s one row of its ~6.1 M distinct 21-mers) every
exact configuration is checked against the plain version, then all are
timed with CUDA events over back-to-back calls (the output's fill and the
launch), configurations in turns, forwards then backwards.  Prints one
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

# per kernel: the -D prefix and names of its build constants, the
# configurations (tuples in that order), whether a configuration gives the
# exact result, and its plan's slots a thread in library_config's tuple
KINDS = {
    "grid_min": {
        "prefix": "KMER_GRID_", "names": ("R", "CHUNK", "INLINE", "DRAIN"),
        "configs": tuple(itertools.product((4, 8, 16), (512, 1024), (0, 1),
                                           (1,))) + ((8, 1024, 1, 0),),
        "exact": lambda cfg: bool(cfg[3]), "per_thread": 2},
    "grid_max": {
        "prefix": "KMER_GRID_MAX_", "names": ("R", "VEC", "CHUNK"),
        "configs": tuple(itertools.product((4, 8, 16), (1, 2, 4),
                                           (1024, 2048))),
        "exact": lambda cfg: True, "per_thread": 5},
}


def build_all(kind: str) -> dict:
    """{config: (ctypes library, (registers, spill bytes), SASS loop)} of
    ``kind``'s kernel, one nvcc per configuration."""
    k = KINDS[kind]
    libs = _build.build_variants(
        k["configs"], lambda c: [f"-D{k['prefix']}{n}={v}"
                                 for n, v in zip(k["names"], c)],
        "sketch.cu", _build.declare_sketch)
    kernel = roofline.GRID_KERNELS[kind]
    out = {}
    for cfg, (lib, text) in libs.items():
        regs = _build.ptxas_registers(text, f"({kernel})")
        sass = roofline.grid_instructions_per_pair(lib._name)[kind]
        out[cfg] = (lib, regs.get(kernel), sass)
    return out


def shapes(seed: int, kind: str):
    """(name, ``kind``'s inputs) at phase 11's timed shapes."""
    from chip_smoke import grid_args, random_batch
    from .sketch.jaccard import hashed_kmers
    which = 0 if kind == "grid_min" else 1
    bench = random_batch(np.random.default_rng(seed), 1024, 6000)
    for k in (8, 21):
        items, valid = hashed_kmers(bench, k)
        yield f"bench_k{k}", grid_args(torch, items, valid, 200)[which]
    items, valid = hashed_kmers(bench, 21)
    yield "collection_k21", grid_args(torch, items.reshape(1, -1),
                                      valid.reshape(1, -1), 200)[which]


def launcher(lib, kind: str, args, sms: int):
    """(one call of ``lib``'s G1 or G2 on args into an output allocated
    once, the output)."""
    x, valid, slotc = args[0], args[-2], args[-1]
    n, P = x.shape
    m = slotc.shape[0]
    out = torch.empty((n, m), dtype=torch.int32, device=x.device)
    cfg = G.library_config(lib)
    pl = G.plan(n, P, m, sms, per_thread=cfg[KINDS[kind]["per_thread"]])
    ptrs = [t.data_ptr() for t in (*args, out)]
    fn = lib.launch_grid_min if kind == "grid_min" else lib.launch_grid_max
    ident = -1 if kind == "grid_min" else 0

    def once():
        out.fill_(ident)
        _build.launch(fn, *ptrs, n, P, m, pl.threads_per_set, pl.subsets,
                      pl.span, device=out.device)
    return once, out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="sweep_grid")
    ap.add_argument("--kernel", choices=tuple(KINDS), default="grid_min")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    kind = KINDS[args.kernel]
    names, exact = kind["names"], kind["exact"]
    card = card_line()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = roofline.sm_clock_hz()
    t0 = time.perf_counter()
    libs = build_all(args.kernel)
    lines = [{"sweep": "build", "kernel": args.kernel, "configs": len(libs),
              "seconds": time.perf_counter() - t0, "card": card}]
    for cfg, (_, regs, sass) in libs.items():
        lines.append({"config": dict(zip(names, cfg)),
                      "registers_spill": regs,
                      "sass_per_pair": sass["instructions_per_draw"],
                      "pipes_per_pair": sass["pipes_per_draw"]})
    for line in lines:
        print(json.dumps(line), flush=True)
    ref = getattr(G, args.kernel + "_ref")
    share = {cfg: [] for cfg in libs}
    for what, wargs in shapes(args.seed, args.kernel):
        want = ref(*wargs)
        runs = {}
        for cfg, (lib, _, _) in libs.items():
            once, out = launcher(lib, args.kernel, wargs, sms)
            once()
            torch.cuda.synchronize()
            if exact(cfg) and not torch.equal(out, want):
                raise SystemExit(f"{dict(zip(names, cfg))} != plain at "
                                 f"{what}")
            runs[cfg] = once
        del want
        ops, nbytes = roofline.grid_work(args.kernel, wargs)
        bound = roofline.bound(nbytes, ops, sms, clock)[0]
        ms = {cfg: [] for cfg in libs}
        for order in (list(libs), list(libs)[::-1]):
            for cfg in order:
                runs[cfg]()
                torch.cuda.synchronize()
                ms[cfg].append(loop_ms(runs[cfg], args.iters) / args.iters)
        for cfg in libs:
            share[cfg].append(min(ms[cfg]) / bound)
            line = {"config": dict(zip(names, cfg)), "shape": what,
                    "ms": ms[cfg], "bound_ms": bound,
                    "bound_share": bound / min(ms[cfg]),
                    "exact": exact(cfg), "card": card}
            lines.append(line)
            print(json.dumps(line), flush=True)
        del runs, wargs
        torch.cuda.empty_cache()
    rank = sorted(((math.exp(sum(map(math.log, s)) / len(s)),
                    dict(zip(names, cfg))) for cfg, s in share.items()
                   if exact(cfg)), key=lambda r: r[0])
    lines.append({"sweep": "ranking", "kernel": args.kernel,
                  "time_over_bound_geomean": rank[:12], "card": card})
    print(json.dumps(lines[-1]), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.writelines(json.dumps(line) + "\n" for line in lines)
    return 0


if __name__ == "__main__":
    sys.exit(main())
