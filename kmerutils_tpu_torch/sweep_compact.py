"""Sweep of kernel K7's tile on one CUDA card: threads per block and
entries per thread (``KMER_LIVE_THREADS`` and ``KMER_LIVE_IPT`` of
csrc/merge.cu), every pair with a tile of at most 8,192 entries.

    python3 -m kmerutils_tpu_torch.sweep_compact [--out FILE]

Builds csrc/merge.cu once per configuration (one nvcc each, all started
together) into build/sweep/ and prints each build's registers and spills
of ``compact_kernel`` (``-Xptxas -v``).  At K7's timed shapes (the
exact-counting path's ``compact_detailed`` arrays of the 1024 x 6000 bench
batch at k=21, 6,123,520 entries x 5; 64 Mi entries x 1 and x 5 arrays at
10 % and 90 % live) every configuration is checked against
``compact_live_ref`` and timed with CUDA events over back-to-back launches
(the memset and the kernel, outputs allocated once), configurations in
turns, forwards then backwards.  Prints one JSON line per (configuration,
shape) and one ranking line (geometric mean of time over bound), each with
the card's name and power limit, and appends them to ``--out``.  Needs a
CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import math
import sys
import time

import numpy as np
import torch

from . import _build, roofline
from .ops import merge as M
from .profile_sketch import card_line

CONFIGS = tuple((t, i) for t, i in itertools.product((128, 256, 512),
                                                   (4, 8, 16, 32))
                if t * i <= 8192)


def live_arrays(gen, n: int, narr: int, frac: float, dev="cuda"):
    """narr int32 arrays of n entries made on ``dev`` from the generator
    ``gen``: a share ``frac`` of live entries (first word not all ones,
    values over the whole u32 range), the rest dead (first word -1)."""
    first = torch.randint(-(1 << 31), (1 << 31) - 1, (n,), dtype=torch.int32,
                          device=dev, generator=gen)
    first = torch.where(first == -1, 0, first)
    dead = torch.rand(n, device=dev, generator=gen) >= frac
    first = torch.where(dead, -1, first)
    rest = [torch.randint(-(1 << 31), (1 << 31) - 1, (n,), dtype=torch.int32,
                          device=dev, generator=gen)
            for _ in range(narr - 1)]
    return (first, *rest)


def exact_path_arrays(batch, k: int = 21):
    """K7's five arrays in ``count/exact.compact_detailed`` of
    ``count_batch_detailed(batch, k)``: the liveness word (count - 1), the
    key's halves, read numbers and positions."""
    from .count import exact
    kd = exact.count_batch_detailed(batch, k)
    return ((kd[1] - 1).contiguous(), kd[0].to(torch.int32),
            (kd[0] >> 32).to(torch.int32), kd[2].contiguous(),
            kd[3].contiguous())


def bench_batch(seed: int, n: int = 1024, length: int = 6000, dev="cuda"):
    from .base.sequence import pack_codes
    codes = np.random.default_rng(seed).integers(0, 4, size=(n, length),
                                                 dtype=np.uint8)
    return pack_codes(codes, np.full(n, length, np.int32), device=dev)


def build_all(configs) -> dict:
    """{config: (ctypes library, {narr: (registers, spill bytes)} of
    compact_kernel<narr>)}, one nvcc per configuration."""
    libs = _build.build_variants(configs, lambda c: [
        f"-DKMER_LIVE_THREADS={c[0]}", f"-DKMER_LIVE_IPT={c[1]}"])
    return {cfg: (lib, _build.ptxas_registers(out, r"compact_kernelILi(\d)E"))
            for cfg, (lib, out) in libs.items()}


def launch_loop_ms(lib, arrs, iters: int) -> float:
    """CUDA-event ms of one launch (memset + kernel) over ``iters``
    back-to-back launches into outputs and scratch allocated once."""
    n = arrs[0].numel()
    outs = [torch.empty_like(a) for a in arrs]
    scratch = torch.empty(lib.compact_scratch_words(n), dtype=torch.int64,
                          device=arrs[0].device)
    ptrs = ctypes.c_void_p * len(arrs)
    ins_p = ptrs(*[a.data_ptr() for a in arrs])
    outs_p = ptrs(*[o.data_ptr() for o in outs])

    def once():
        _build.launch(lib.launch_compact, len(arrs), ins_p, outs_p, n,
                      scratch.data_ptr(), device=arrs[0].device)
    once()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        once()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def shapes(seed: int, n_syn: int = 64 << 20):
    """(name, arrays) at K7's timed shapes, made on the card."""
    yield "path 6,123,520 x 5", exact_path_arrays(bench_batch(seed))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    for narr, frac in ((1, 0.1), (1, 0.9), (5, 0.1), (5, 0.9)):
        yield (f"{n_syn} x {narr}, {frac:.0%} live",
               live_arrays(gen, n_syn, narr, frac))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="sweep_compact")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    t0 = time.perf_counter()
    libs = build_all(CONFIGS)
    lines = [{"sweep": "build", "configs": len(libs),
              "seconds": time.perf_counter() - t0, "card": card}]
    for cfg, (_, regs) in libs.items():
        lines.append({"config": list(cfg), "registers_spill_by_narr": regs})
    share = {cfg: [] for cfg in libs}
    for name, arrs in shapes(args.seed):
        want, n_live = M.compact_live_ref(arrs)
        for cfg, (lib, _) in libs.items():
            got, n = M.compact_live_with(lib, arrs)
            torch.cuda.synchronize()
            if n != n_live or not all(torch.equal(g, w)
                                      for g, w in zip(got, want)):
                raise SystemExit(f"K7 {cfg} != plain at {name}")
            del got
        bound = roofline.bound(8 * arrs[0].numel() * len(arrs))[0]
        ms = {cfg: [] for cfg in libs}
        for order in (list(libs), list(libs)[::-1]):
            for cfg in order:
                ms[cfg].append(launch_loop_ms(libs[cfg][0], arrs, args.iters))
        for cfg in libs:
            share[cfg].append(min(ms[cfg]) / bound)
            lines.append({"config": list(cfg), "shape": name,
                          "n_live": n_live, "ms": ms[cfg], "bound_ms": bound,
                          "card": card})
        del arrs, want
        torch.cuda.empty_cache()
    rank = sorted((math.exp(sum(map(math.log, s)) / len(s)), list(cfg))
                  for cfg, s in share.items())
    lines.append({"sweep": "ranking", "time_over_bound_geomean": rank,
                  "card": card})
    for line in lines:
        print(json.dumps(line), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.writelines(json.dumps(line) + "\n" for line in lines)
    return 0


if __name__ == "__main__":
    sys.exit(main())
