"""Device-time breakdown of one ``parsefastq kmer --count`` run on one card.

    python -m kmerutils_tpu_torch.profile_count -f reads.fastq [-s 16]
                                                [--sharded] [--out FILE]

``--sharded`` profiles parallel/stream.ShardedStreamCounter over the same
file instead (no dump), on a process group of one rank over NCCL on
cuda:0, with the capacities phase 13 of chip_smoke.py uses (2^26 entries,
growing toward 2^28); its all_to_all and reductions show as the "nccl"
family.

In one process on one card: one warm-up run (kernel build, allocator
growth), one timed run (host clock, ended by a device synchronize), then
one run under ``torch.profiler``.  The profiled run's device time is summed
by family: the batch sort, K3 (merge_fold), K5 (merge_sorted), K4
(aggregate_fold: its summary, resolve, scan and emit kernels), elementwise,
copies and the rest; its idle share is 1 - device time / the run's wall
time.  Kernels and copies of one stream do not overlap, so their sum is
the busy time.  The run writes its dump and histograms into a temporary
directory.  Prints one JSON line (the card's name and power limit
included) and appends it to ``--out`` when given, with the host
operations of the profiled run that took the most CPU time themselves
(``host_top``).  Needs a CUDA device.
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
    if "nccl" in name:
        return "nccl"
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


def sharded_once(mesh, path: str, k: int) -> float:
    """ShardedStreamCounter over ``path`` to its finalized union; wall
    seconds up to a synchronize."""
    from .io import fastx
    from .parallel import mesh as pm
    from .parallel import stream as ps
    t0 = time.perf_counter()
    ctr = ps.ShardedStreamCounter(mesh, 1 << 26, wide=k > 16,
                                  cap_max_per_device=1 << 28)
    for batch, _idx in fastx.read_batches_overlapped(path,
                                                     device=mesh.device):
        ctr.update(pm.reads_sharding(mesh, batch), k)
    ctr.finalize()
    ctr.close()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="profile_count")
    ap.add_argument("-f", "--file", required=True, dest="filename")
    ap.add_argument("-s", "--size", type=int, default=16, dest="kmer_size")
    ap.add_argument("--sharded", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    tmp = tempfile.mkdtemp(prefix="profile_count_")
    mesh = None
    try:
        fq = os.path.join(tmp, os.path.basename(args.filename))
        shutil.copy(args.filename, fq)
        if args.sharded:
            import socket
            from .parallel import mesh as pm
            with socket.socket() as s:
                s.bind(("127.0.0.1", 0))
                port = s.getsockname()[1]
            mesh = pm.make_mesh("cuda", init_method=f"tcp://127.0.0.1:{port}",
                                rank=0, world_size=1, timeout=120)

            def once():
                return sharded_once(mesh, fq, args.kmer_size)
        else:
            cli = ["-f", fq, "--device", "cuda", "kmer", "--count", "-s",
                   str(args.kmer_size)]

            def once():
                return run_once(cli, tmp)
        once()
        wall = once()
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            wall_prof = once()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        if mesh is not None:
            torch.distributed.destroy_process_group()
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
    host = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)
    line = json.dumps({
        "profile": ("sharded_counter" if args.sharded else
                    "parsefastq_count") + f"_k{args.kmer_size}",
        "file": os.path.basename(args.filename),
        "wall_s": wall, "wall_s_profiled": wall_prof,
        "device_ms": busy_ms,
        "idle_share_profiled_run": 1.0 - busy_ms / (wall_prof * 1e3),
        "idle_share_vs_unprofiled_run": 1.0 - busy_ms / (wall * 1e3),
        "family_ms": fams, "family_launches": counts,
        "host_top": [{"op": a.key, "self_cpu_ms": a.self_cpu_time_total / 1e3,
                      "calls": a.count} for a in host[:15]],
        "card": card_line()})
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
