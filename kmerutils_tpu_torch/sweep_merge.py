"""Sweep of the merge kernel K3/K5's tile on one CUDA card: outputs per
thread (``KMER_MERGE_IPT`` of csrc/merge.cu: 8, 16, 32, tiles of
2,048-8,192 outputs).

    python3 -m kmerutils_tpu_torch.sweep_merge [--out FILE]

Run from the repository's root: the shapes come from ``chip_smoke.py``.
Builds csrc/merge.cu once per tile (one nvcc each, all started together)
into build/sweep/ and prints each build's registers and spills of
``merge_kernel``.  At K3/K5's timed shapes (``chip_smoke.merge_shapes``:
two 8 Mi-entry runs, u32 keys and u64 keys with coordinates; an 8
Mi-entry run folded into 40 M live entries of a 2^26-entry table, the same
two key types) every tile is checked against the plain version, then
timed with CUDA events over back-to-back launches into outputs allocated
once, tiles in turns, forwards then backwards, and by the profiler's
device time per call.  Prints one JSON line per (tile, shape) and one
ranking line (geometric mean of event time over the bytes bound), each
with the card's name and power limit, and appends them to ``--out``.
Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import numpy as np
import torch

from . import _build, roofline
from .ops import merge as M
from .profile_sketch import card_line, loop_ms, profile

CONFIGS = (8, 16, 32)   # outputs per thread


def build_all(configs) -> dict:
    """{outputs per thread: (ctypes library, {template arguments:
    (registers, spill bytes)} of merge_kernel)}, one nvcc per tile."""
    libs = _build.build_variants(configs,
                                 lambda c: [f"-DKMER_MERGE_IPT={c}"])
    return {cfg: (lib, _build.ptxas_registers(out, r"merge_kernelI(\w+?)EEv"))
            for cfg, (lib, out) in libs.items()}


def launcher(lib, name: str, args):
    """(one launch of ``lib``'s merge on the wrapper args into outputs
    allocated once, the outputs): the key, count and coordinate arrays."""
    ptr = M._ptr
    if name == "merge_sorted":
        a, ac, b, bc = args
        n = a.numel() + b.numel()
        outs = (torch.empty(n, dtype=a.dtype, device=a.device), None,
                None if ac is None else torch.empty(n, dtype=torch.int64,
                                                    device=a.device))
        call = (a.element_size(), 0, int(ac is not None), ptr(a), None,
                ptr(ac), a.numel(), ptr(b), ptr(bc), b.numel(),
                ptr(outs[0]), None, ptr(outs[2]), n)
    else:
        key, cnt, crd, used, b, bc, cap = args
        n = min(used + b.numel(), cap)
        outs = (torch.empty(cap, dtype=key.dtype, device=key.device),
                torch.empty(cap, dtype=torch.int32, device=key.device),
                None if crd is None else torch.empty(cap, dtype=torch.int64,
                                                     device=key.device))
        call = (key.element_size(), 1, int(crd is not None), ptr(key),
                ptr(cnt), ptr(crd), used, ptr(b), ptr(bc), b.numel(),
                ptr(outs[0]), ptr(outs[1]), ptr(outs[2]), n)

    def once():
        _build.launch(lib.launch_merge, *call, device=outs[0].device)
    return once, outs, n


def launch_ms(fn, iters: int) -> float:
    """CUDA-event ms of one of ``iters`` back-to-back calls, after one."""
    fn()
    torch.cuda.synchronize()
    return loop_ms(fn, iters) / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="sweep_merge")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import merge_shapes
    card = card_line()
    t0 = time.perf_counter()
    libs = build_all(CONFIGS)
    lines = [{"sweep": "build", "configs": len(libs),
              "seconds": time.perf_counter() - t0, "card": card}]
    for cfg, (_, regs) in libs.items():
        lines.append({"ipt": cfg, "registers_spill": regs})
    for line in lines:
        print(json.dumps(line), flush=True)
    share = {cfg: [] for cfg in libs}
    for name, what, wargs, nbytes in merge_shapes(
            torch, np.random.default_rng(args.seed)):
        if name == "merge_sorted":
            key, crd = M.merge_sorted_ref(*wargs)
            want = (key, None, crd)
        else:
            want = M.merge_fold_ref(*wargs)[:3]
        runs = {}
        for cfg, (lib, _) in libs.items():
            once, outs, n = launcher(lib, name, wargs)
            once()
            torch.cuda.synchronize()
            for g, w in zip(outs, want):
                if g is not None and not torch.equal(g[:n], w[:n]):
                    raise SystemExit(f"ipt {cfg} != plain at {what}")
            runs[cfg] = once
        del want
        bound = roofline.bound(nbytes)[0]
        ms = {cfg: [] for cfg in libs}
        for order in (list(libs), list(libs)[::-1]):
            for cfg in order:
                ms[cfg].append(launch_ms(runs[cfg], args.iters))
        for cfg in libs:
            prof = profile(runs[cfg], 10)
            share[cfg].append(min(ms[cfg]) / bound)
            line = {"ipt": cfg, "shape": what, "ms": ms[cfg],
                    "device_ms": prof["device_ms_per_call"],
                    "bound_ms": bound, "card": card}
            lines.append(line)
            print(json.dumps(line), flush=True)
        del runs, wargs
        torch.cuda.empty_cache()
    rank = sorted((math.exp(sum(map(math.log, s)) / len(s)), cfg)
                  for cfg, s in share.items())
    lines.append({"sweep": "ranking", "time_over_bound_geomean": rank,
                  "card": card})
    print(json.dumps(lines[-1]), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.writelines(json.dumps(line) + "\n" for line in lines)
    return 0


if __name__ == "__main__":
    sys.exit(main())
