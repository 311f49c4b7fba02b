"""Device-time breakdown of one ``parsefastq kmer --count`` run on one card.

    python -m kmerutils_tpu_torch.profile_count -f reads.fastq [-s 16]
                                                [--out FILE]

In one process on one card: one warm-up run (kernel build, allocator
growth), one timed run (host clock, ended by a device synchronize), then
one run under ``torch.profiler``.  The profiled run's device time is summed
by family: the batch sort, K3 (merge_fold), K5 (merge_sorted), K4
(aggregate_fold: its summary, resolve, scan and emit kernels), elementwise,
copies and the rest; its idle share is 1 - device time / the run's wall
time.  Kernels and copies of one stream do not overlap, so their sum is
the busy time.  The run writes its dump and histograms into a temporary
directory.  Prints one JSON line (the card's name and power limit
included) and appends it to ``--out`` when given.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import sys
import tempfile
import time

import torch

from .profile_sketch import card_line


def family(kernel_name: str) -> str:
    name = kernel_name.lower()
    if "merge_kernel<" in name:
        targs = name.split("merge_kernel<", 1)[1].split(">", 1)[0].split(",")
        return "K3 merge_fold" if targs[1].strip() == "true" \
            else "K5 merge_sorted"
    if any(s in name for s in ("agg_summary", "agg_resolve", "agg_emit",
                               "scan_kernel")):
        return "K4 aggregate_fold"
    if "sort" in name or "radix" in name:
        return "sort"
    if "memcpy" in name or "memset" in name:
        return "copy"
    if any(s in name for s in ("elementwise", "vectorized", "unrolled")):
        return "elementwise"
    return "other"


def run_once(argv, workdir: str) -> float:
    """parsefastq.main in ``workdir``; wall seconds up to a synchronize."""
    from .cli import parsefastq
    here = os.getcwd()
    os.chdir(workdir)
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = parsefastq.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        os.chdir(here)
    if rc != 0:
        raise RuntimeError(f"parsefastq returned {rc}")
    return wall


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="profile_count")
    ap.add_argument("-f", "--file", required=True, dest="filename")
    ap.add_argument("-s", "--size", type=int, default=16, dest="kmer_size")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    tmp = tempfile.mkdtemp(prefix="profile_count_")
    try:
        fq = os.path.join(tmp, os.path.basename(args.filename))
        shutil.copy(args.filename, fq)
        cli = ["-f", fq, "--device", "cuda", "kmer", "--count", "-s",
               str(args.kmer_size)]
        run_once(cli, tmp)
        wall = run_once(cli, tmp)
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            wall_prof = run_once(cli, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    fams: dict[str, float] = {}
    counts: dict[str, int] = {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        f = family(ev.name)
        fams[f] = fams.get(f, 0.0) + ev.time_range.elapsed_us() / 1e3
        counts[f] = counts.get(f, 0) + 1
    if not counts:
        raise RuntimeError("the profiler recorded no device events")
    busy_ms = sum(fams.values())
    line = json.dumps({
        "profile": f"parsefastq_count_k{args.kmer_size}",
        "file": os.path.basename(args.filename),
        "wall_s": wall, "wall_s_profiled": wall_prof,
        "device_ms": busy_ms,
        "idle_share_profiled_run": 1.0 - busy_ms / (wall_prof * 1e3),
        "idle_share_vs_unprofiled_run": 1.0 - busy_ms / (wall * 1e3),
        "family_ms": fams, "family_launches": counts, "card": card_line()})
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
