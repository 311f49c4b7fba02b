"""Kernel families of the program's device operations, by name, as the
profiler reports them (the rules of kmerutils_tpu_torch/profile_count.py
and profile_sketch.py, merged and frozen here)."""

from __future__ import annotations

K1 = "K1 tournament"
K2 = "K2 tournament_u64"
K3 = "K3 merge_fold"
K4 = "K4 aggregate_fold"
K5 = "K5 merge_sorted"


def family(kernel_name: str) -> str:
    name = kernel_name.lower()
    if "tournament" in name:
        wide = ("tournament_kernel<true" in name
                or "tournament_finish_kernel<true" in name)
        return K2 if wide else K1
    if "merge_kernel<" in name:
        targs = name.split("merge_kernel<", 1)[1].split(">", 1)[0].split(",")
        return K3 if len(targs) > 1 and targs[1].strip() == "true" else K5
    if any(s in name for s in ("agg_summary", "agg_resolve", "agg_emit",
                               "scan_kernel")):
        return K4
    if "compact_kernel" in name:
        return "K7 compact_live"
    if "grid_min" in name:
        return "G1 grid_min"
    if "grid_max" in name:
        return "G2 grid_max"
    if "nccl" in name:
        return "nccl"
    if "memcpy" in name:
        return "copy"
    if "memset" in name:
        return "memset"
    if "sort" in name or "radix" in name:
        return "sort"
    if "scan" in name:
        return "scan"
    if any(s in name for s in ("elementwise", "vectorized", "unrolled")):
        return "elementwise"
    if "reduce" in name:
        return "reduce"
    return "other"
