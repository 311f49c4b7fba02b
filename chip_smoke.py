#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (kmerutils_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA Hopper card (the
kernels are built for sm_90a with nvcc).  Every phase is fatal on failure:

1. environment: torch, CUDA, nvcc, triton, the card's name and power limit;
2. build: every kernel of kmerutils_tpu_torch/csrc/ (one nvcc per source,
   started together, then one link);
3. K1 (weighted_tournament) vs its plain PyTorch version on the card, both
   payload modes: exact equality;
4. K2 (weighted_tournament_u64) vs its plain version: exact equality;
5. the slice: ``datasketcher`` on a seeded ONT-like FASTQ (10,000 reads,
   ~60 Mbases, k=8, m=200) and on a 1,000-read file with k=21, through the
   CLI entry point on ``cuda``; the dumps are read back and 64 sampled
   reads of each are recomputed through the plain path on the card; the
   kernel launch counters must show the kernels ran; the k=8 run is then
   repeated three times for its wall-time spread;
6. timing with CUDA events at the bench shape (1024 reads x 6000 bases,
   k=8, m=200): K1 alone, its plain version, the whole
   ``Sketcher.sketch_batch``; K2 likewise at k=21;
7. K5 (merge_sorted), K3 (merge_fold), K4 (aggregate_fold) and K6
   (aggregate_compact) vs their plain versions on the card, exact, at the
   counting path's shapes (two 8 Mi-entry runs; an 8 Mi-entry batch into
   ~40 M live entries at capacity 2^26; ~50 M entries, half duplicates,
   counts near 2^32, coordinates, with and without a count filter), each
   timed against its plain version;
8. the counting slice: ``parsefastq kmer --count -s 16``, ``--unique -s 21``
   and a spill run (``--capacity 4194304``, small batches, first 2,000
   reads) through the CLI entry point on ``cuda`` over a seeded
   bacterial-scale FASTQ (4.6 Mbase genome, 10,000 reads from both strands,
   6 % substitutions); every dump is compared in full with a numpy oracle
   computed from the generated reads; the launch counters must show K3, K4
   and K5 ran; the --count run is repeated three times for its wall time;
9. K7 (compact_live) vs its plain version on the card, exact, at 64 Mi
   entries with 1 and 5 arrays and 10 / 50 / 90 % live, each timed; then
   the exact-counting path (count/exact.py: ``count_batch``,
   ``count_batch_detailed``, ``unique_kmer_coords``, densified on the card
   through K7) on the bench batch at k=21 and on reads holding the k=32
   keys T^16A^16 and A^16T^16, against a numpy oracle; K7's launch counter
   must show it ran; K7 is timed again at that path's shape;
10. the rest of ``datasketcher`` through the CLI on ``cuda`` over phase 5's
   ONT-like file: ``-b 512`` (the block dump read back, live blocks exactly
   those with a valid k-mer, 64 sampled reads recomputed through the plain
   path, K1's counter > 0), ``ann -n 10 --engine brute`` (64 sampled rows
   equal to a numpy top-10 with the tie rule) and ``ann -n 10`` through
   the native HNSW index (graph file written, no self hit, no padding,
   recall@10 against the exact search), block ``ann`` (exact and HNSW)
   over the file's first 1,000 records, and ``Sketcher.sketch_collection``
   at the bench shape (k=21, one row of ~6.1 M distinct keys) equal to the
   plain path, timed with K2 alone against its plain version.

The temporary files of phases 5-10 live in one directory, removed at the
end.  The last three lines are the card's name and power limit, the
kernels' JSON record and
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
package beside it, the script exits non-zero before printing either.
"""

from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 20261016
K1_TPU = "kmerutils_tpu/ops/tournament.py:107"
K2_TPU = "kmerutils_tpu/ops/tournament.py:220"
K3_TPU = "kmerutils_tpu/ops/merge_pallas.py:458"
K4_TPU = "kmerutils_tpu/ops/merge_pallas.py:967"
K5_TPU = "kmerutils_tpu/ops/merge_pallas.py:238"
K6_TPU = "kmerutils_tpu/ops/merge_pallas.py:839"
K7_TPU = "kmerutils_tpu/ops/merge_pallas.py:1101"
SOURCE = "kmerutils_tpu_torch/csrc/tournament.cu"
MERGE_SOURCE = "kmerutils_tpu_torch/csrc/merge.cu"
ACGT = np.frombuffer(b"ACGT", np.uint8)


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def run(cmd) -> str:
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e})"
    return (res.stdout + res.stderr).strip()


# ---------------------------------------------------------------------------
# phase 1-2
# ---------------------------------------------------------------------------

def environment(torch) -> str:
    phase("1 environment")
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"torch.version.cuda {torch.version.cuda}")
    nvcc = run(["nvcc", "--version"])
    if nvcc.startswith("unavailable"):
        nvcc = run(["/usr/local/cuda/bin/nvcc", "--version"])
    print("nvcc:", nvcc.splitlines()[-1] if nvcc else "?")
    try:
        import triton
        print(f"triton {triton.__version__} importable")
    except ImportError as e:
        print(f"triton not importable ({e})")
    from kmerutils_tpu_torch.io import native
    print("native FASTQ parser (native/libktpnative.so):",
          "available" if native.available() else "unavailable, Python parser")
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    card = run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).splitlines()[0]
    print(f"card: {card}  (torch: {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} visible)", flush=True)
    return card


def build() -> None:
    phase("2 build")
    from kmerutils_tpu_torch import _build
    t0 = time.perf_counter()
    _build.load()
    info = _build.build_info
    print(f"built {info.get('path', _build.library_path())} in "
          f"{info.get('seconds', 0.0):.2f} s (load {time.perf_counter() - t0:.2f} s)")
    for line in info.get("output", "").splitlines():
        if "ptxas" in line or "spill" in line:
            print("  " + line.strip())


# ---------------------------------------------------------------------------
# phase 3-4: kernels vs plain versions on the card
# ---------------------------------------------------------------------------

def tournament_inputs(rng, n: int, P: int, wide: bool):
    """Items with values >= 2^31 (>= 2^63 when wide), many duplicates,
    invalid positions (winv 0 or negative) and one all-invalid row."""
    hi_bit = 63 if wide else 31
    pool = rng.integers(0, 1 << hi_bit, size=max(4, P // 3), dtype=np.uint64)
    pool[: len(pool) // 2] |= np.uint64(1 << hi_bit)
    items = rng.choice(pool, size=(n, P))
    w = rng.integers(1, 6, size=(n, P)).astype(np.float32)
    winv = (1.0 / w).astype(np.float32)
    bad = rng.random((n, P)) < 0.1
    winv[bad] = rng.choice(np.array([0.0, -1.0], np.float32), size=bad.sum())
    winv[n // 2, :] = 0.0
    return items, winv


def as_i32(x_u32: np.ndarray, dev):
    import torch
    return torch.from_numpy(np.ascontiguousarray(
        x_u32.astype(np.uint32)).view(np.int32)).to(dev)


def sync(torch, dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def max_abs_err(a, b) -> int:
    import torch
    d = (a.to(torch.int64) & 0xFFFFFFFF) - (b.to(torch.int64) & 0xFFFFFFFF)
    return int(d.abs().max()) if d.numel() else 0


def k1_vs_plain(torch, rng, dev) -> int:
    phase("3 K1 vs plain (exact)")
    from kmerutils_tpu_torch.ops import tournament as T
    worst = 0
    for P in (5993, 37):
        for m in (200, 13):
            items, winv = tournament_inputs(rng, 64, P, wide=False)
            it, wv = as_i32(items, dev), torch.from_numpy(winv).to(dev)
            for pos in (False, True):
                got = T.weighted_tournament(it, wv, m, seed=7,
                                            return_positions=pos)
                want = T.weighted_tournament_ref(it, wv, m, seed=7,
                                                 return_positions=pos)
                sync(torch, dev)
                err = max_abs_err(got, want)
                worst = max(worst, err)
                print(f"K1 P={P} m={m} positions={pos}: "
                      f"{int((got != want).sum())} mismatches", flush=True)
                check(torch.equal(got, want), f"K1 != plain (P={P}, m={m}, "
                      f"positions={pos})")
                check(bool((got[32] == 0).all()), "K1 all-invalid row != 0")
    return worst


def k2_vs_plain(torch, rng, dev) -> int:
    phase("4 K2 vs plain (exact)")
    from kmerutils_tpu_torch.ops import tournament as T
    worst = 0
    for P in (5993, 37):
        for m in (200, 13):
            items, winv = tournament_inputs(rng, 64, P, wide=True)
            lo = as_i32(items & np.uint64(0xFFFFFFFF), dev)
            hi = as_i32(items >> np.uint64(32), dev)
            wv = torch.from_numpy(winv).to(dev)
            got = T.weighted_tournament_u64(lo, hi, wv, m, seed=7)
            want = T.weighted_tournament_u64_ref(lo, hi, wv, m, seed=7)
            sync(torch, dev)
            err = max(max_abs_err(got[0], want[0]),
                      max_abs_err(got[1], want[1]))
            worst = max(worst, err)
            print(f"K2 P={P} m={m}: {int((got[0] != want[0]).sum())} lo / "
                  f"{int((got[1] != want[1]).sum())} hi mismatches",
                  flush=True)
            check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                  f"K2 != plain (P={P}, m={m})")
            check(bool((got[0][32] == 0).all() and (got[1][32] == 0).all()),
                  "K2 all-invalid row != 0")
    return worst


# ---------------------------------------------------------------------------
# phase 5: the slice through the CLI
# ---------------------------------------------------------------------------

def write_ont_fastq(path: str, rng, n_reads: int, n_with_n: int):
    """ONT-like reads sampled from a 2 Mbase genome: lognormal lengths
    (median 5 kb, sigma 0.85, clipped to [500, 16000]).  ``n_with_n`` extra
    reads carrying an 'N' are interleaved; ingest must drop them.  Returns
    the clean reads as 2-bit code arrays, in file order."""
    genome = rng.integers(0, 4, size=2 << 20, dtype=np.uint8)
    lens = np.clip(rng.lognormal(np.log(5000), 0.85, size=n_reads),
                   500, 16000).astype(np.int64)
    starts = rng.integers(0, genome.size - 16000, size=n_reads)
    bad_at = set(rng.choice(n_reads, size=n_with_n, replace=False).tolist())
    clean = []
    with open(path, "wb") as f:
        for i, (s, ln) in enumerate(zip(starts, lens)):
            codes = genome[s : s + ln]
            if i in bad_at:
                seq = bytearray(ACGT[codes].tobytes())
                seq[len(seq) // 2] = ord("N")
                f.write(b"@bad%d\n%s\n+\n%s\n" % (i, bytes(seq), b"I" * ln))
            f.write(b"@read%d\n%s\n+\n%s\n" % (i, ACGT[codes].tobytes(),
                                               b"I" * ln))
            clean.append(codes)
    return clean


def plain_signatures(torch, codes_list, k: int, m: int, dev):
    """Signatures of the given reads through the plain path on the card
    (same hashing and multiplicities, plain tournament), cut to u32 as the
    PROB3A dump stores them."""
    from kmerutils_tpu_torch.base.sequence import pack_codes
    from kmerutils_tpu_torch.ops import tournament as T
    from kmerutils_tpu_torch.sketch import probminhash
    from kmerutils_tpu_torch.sketch.jaccard import hashed_kmers
    L = max(c.size for c in codes_list)
    codes = np.zeros((len(codes_list), L), np.uint8)
    lengths = np.array([c.size for c in codes_list], np.int32)
    for i, c in enumerate(codes_list):
        codes[i, : c.size] = c
    batch = pack_codes(codes, lengths, device=dev)
    items, valid = hashed_kmers(batch, k)
    s, winv, is_real = probminhash.sort_with_multiplicities(items, valid)
    winv = torch.where(is_real, winv, 0.0).contiguous()
    if k <= 16:
        sig = T.weighted_tournament_ref(s.contiguous(), winv, m)
        return sig.cpu().numpy().view(np.uint32)
    lo, hi = T.weighted_tournament_u64_ref(
        s.to(torch.int32).contiguous(), (s >> 32).to(torch.int32).contiguous(),
        winv, m)
    return lo.cpu().numpy().view(np.uint32)   # the dump keeps the low half


def slice_runs(torch, rng, tmp: str, card: str, dev,
               n_reads=(10_000, 1_000)):
    phase("5 the slice: datasketcher on cuda")
    from kmerutils_tpu_torch.cli import datasketcher
    from kmerutils_tpu_torch.io import fastx, formats
    from kmerutils_tpu_torch.ops import tournament as T
    fq8 = os.path.join(tmp, "ont10k.fastq")
    fq21 = os.path.join(tmp, "ont1k.fastq")
    clean8 = write_ont_fastq(fq8, rng, n_reads[0], 7)
    clean21 = write_ont_fastq(fq21, rng, n_reads[1], 3)
    mbases = sum(c.size for c in clean8) / 1e6
    n_batches8 = sum(1 for _ in fastx.read_batches(fq8, batch_reads=10000))
    n_batches21 = sum(1 for _ in fastx.read_batches(fq21, batch_reads=10000))
    print(f"fixtures: {len(clean8)} clean reads / {mbases:.1f} Mbases "
          f"({n_batches8} batches); {len(clean21)} reads ({n_batches21} "
          f"batches)", flush=True)
    os.makedirs(os.path.join(tmp, "k8"))
    os.makedirs(os.path.join(tmp, "k21"))
    dump8 = os.path.join(tmp, "k8", "sigs.bin")
    dump21 = os.path.join(tmp, "k21", "sigs.bin")

    # --- the main path: counts from 0 to what the two CLI runs launched ---
    T.launches_u32 = T.launches_u64 = 0
    t0 = time.perf_counter()
    rc8 = datasketcher.main(["-f", fq8, "-s", "200", "-k", "8", "-d", dump8,
                             "--device", str(dev)])
    wall8 = time.perf_counter() - t0
    rc21 = datasketcher.main(["-f", fq21, "-s", "200", "-k", "21", "-d",
                              dump21, "--device", str(dev)])
    launches = {"u32": T.launches_u32, "u64": T.launches_u64}
    # -----------------------------------------------------------------------
    print(f"launches: K1 {launches['u32']}, K2 {launches['u64']}", flush=True)
    check(rc8 == 0 and rc21 == 0, "datasketcher returned non-zero")
    check(launches["u32"] >= n_batches8,
          f"K1 launched {launches['u32']} < {n_batches8} batches")
    check(launches["u64"] >= n_batches21,
          f"K2 launched {launches['u64']} < {n_batches21} batches")

    for dump, clean, k in ((dump8, clean8, 8), (dump21, clean21, 21)):
        with open(dump, "rb") as f:
            head = np.frombuffer(f.read(16), "<u4")
        check(head.tolist() == [0xCEABEADD, 4, 200, k],
              f"k={k} dump header {head.tolist()}")
        kk, m, sigs = formats.read_signature_dump(dump)
        check((kk, m) == (k, 200) and sigs.shape == (len(clean), 200),
              f"k={k} dump holds {sigs.shape}, want ({len(clean)}, 200)")
        check(sigs.dtype == np.uint32 and bool((sigs != 0).any(axis=1).all()),
              f"k={k}: an all-zero signature for a non-empty read")
        pick = np.sort(rng.choice(len(clean), size=64, replace=False))
        want = plain_signatures(torch, [clean[i] for i in pick], k, 200, dev)
        bad = int((sigs[pick] != want).sum())
        print(f"k={k}: {sigs.shape[0]} reads in the dump, 64 sampled reads "
              f"vs the plain path on the card: {bad} mismatching slots",
              flush=True)
        check(bad == 0, f"k={k}: dump != plain path on sampled reads")
    # repeats of the k=8 run (after the counted one), to show the spread
    walls = [wall8]
    for _ in range(3):
        t0 = time.perf_counter()
        check(datasketcher.main(["-f", fq8, "-s", "200", "-k", "8", "-d",
                                 dump8, "--device", str(dev)]) == 0,
              "datasketcher repeat returned non-zero")
        walls.append(time.perf_counter() - t0)
    print(json.dumps({"timing": "datasketcher_k8_wall", "s": walls,
                      "mbases": mbases,
                      "mbases_per_s": [mbases / w for w in walls],
                      "card": card}), flush=True)
    return launches, fq8, clean8


# ---------------------------------------------------------------------------
# phase 6: timing at the bench shape
# ---------------------------------------------------------------------------

def cuda_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def timings(torch, rng, card: str):
    phase("6 timing at the bench shape (1024 x 6000, m=200)")
    from kmerutils_tpu_torch.base.sequence import pack_codes
    from kmerutils_tpu_torch.ops import tournament as T
    from kmerutils_tpu_torch.sketch import probminhash
    from kmerutils_tpu_torch.sketch.jaccard import Sketcher, hashed_kmers
    from kmerutils_tpu_torch.sketch.params import SeqSketcherParams
    n, L, m = 1024, 6000, 200
    codes = rng.integers(0, 4, size=(n, L), dtype=np.uint8)
    batch = pack_codes(codes, np.full(n, L, np.int32), device="cuda")
    out = {}
    for k in (8, 21):
        items, valid = hashed_kmers(batch, k)
        s, winv, is_real = probminhash.sort_with_multiplicities(items, valid)
        winv = torch.where(is_real, winv, 0.0).contiguous()
        if k <= 16:
            it = s.contiguous()
            kern = lambda: T.weighted_tournament(it, winv, m)     # noqa: E731
            plain = lambda: T.weighted_tournament_ref(it, winv, m)  # noqa: E731
        else:
            lo = s.to(torch.int32).contiguous()
            hi = (s >> 32).to(torch.int32).contiguous()
            kern = lambda: T.weighted_tournament_u64(lo, hi, winv, m)  # noqa: E731
            plain = lambda: T.weighted_tournament_u64_ref(lo, hi, winv, m)  # noqa: E731
        got, want = kern(), plain()
        got = got if k <= 16 else torch.stack(got)
        want = want if k <= 16 else torch.stack(want)
        check(torch.equal(got, want), f"k={k} bench batch: kernel != plain")
        sk = Sketcher(SeqSketcherParams(kmer_size=k, sketch_size=m))
        # turns: plain, kernel, kernel, plain
        p1 = cuda_ms(torch, plain, 3, warmup=1)
        k1 = cuda_ms(torch, kern, 20)
        k2 = cuda_ms(torch, kern, 20)
        p2 = cuda_ms(torch, plain, 3, warmup=0)
        step = cuda_ms(torch, lambda: sk.sketch_batch(batch), 10)
        r = {"k": k, "kernel_ms": [k1, k2], "plain_ms": [p1, p2],
             "sketch_batch_ms": step,
             "sketch_mbases_per_s": n * L / step / 1e3, "card": card}
        print(json.dumps({"timing": f"bench_shape_k{k}", **r}), flush=True)
        out[k] = {"ms": min(k1, k2), "plain_ms": min(p1, p2)}
    return out


# ---------------------------------------------------------------------------
# phase 7: the merge and aggregation kernels vs their plain versions
# ---------------------------------------------------------------------------

def sorted_keys(rng, n: int, wide: bool, dup: float = 0.0):
    """n ascending unsigned keys (int32 / int64 bit patterns as numpy), all
    >= 2^31 (u32) or >= 2^63 (u64), a share ``dup`` of them repeating the
    previous key."""
    gaps = rng.integers(1, 1 << (30 if wide else 6), size=n, dtype=np.uint64)
    if wide:
        gaps <<= np.uint64(4)
    gaps[rng.random(n) < dup] = 0
    base = np.uint64(1 << 63) if wide else np.uint64(1 << 31)
    keys = base + np.cumsum(gaps, dtype=np.uint64)
    return keys.view(np.int64) if wide else keys.astype(np.uint32).view(
        np.int32)


def coords(rng, n: int):
    return rng.integers(0, 1 << 63, size=n, dtype=np.int64)


def to_dev(torch, a):
    return None if a is None else torch.from_numpy(a).to("cuda")


def compare(torch, got, want, n: int):
    """(mismatching entries over the first n, max |difference| of the
    unsigned words at up to 1000 of them) of two tuples of arrays; None
    entries must match."""
    bad, err = 0, 0
    for g, w in zip(got, want):
        check((g is None) == (w is None), "coordinate arrays differ")
        if g is None:
            continue
        g, w = g[:n], w[:n]
        at = (g != w).nonzero()[:, 0]
        bad += at.numel()
        mask = (1 << (8 * g.element_size())) - 1
        for x, y in zip(g[at[:1000]].tolist(), w[at[:1000]].tolist()):
            err = max(err, abs((x & mask) - (y & mask)))
    return bad, err


def turns(torch, kern, plain, iters: int = 10, plain_iters: int = 3):
    """CUDA-event ms of kernel and plain version, in turns plain, kernel,
    kernel, plain; returns (best kernel ms, best plain ms, all four)."""
    p1 = cuda_ms(torch, plain, plain_iters, warmup=1)
    k1 = cuda_ms(torch, kern, iters)
    k2 = cuda_ms(torch, kern, iters)
    p2 = cuda_ms(torch, plain, plain_iters, warmup=0)
    return min(k1, k2), min(p1, p2), [p1, k1, k2, p2]


def merge_kernels_vs_plain(torch, rng, card: str, n_run: int = 8 << 20,
                           cap: int = 1 << 26, used: int = 40_000_000,
                           n_agg: int = 50_000_000, dead: int = 1 << 20):
    phase("7 K5, K3, K4, K6 vs plain (exact) and timing")
    from kmerutils_tpu_torch.ops import merge as M
    res = {}

    def record(name, bad, err, ms, plain_ms, runs, shape):
        r = res.setdefault(name, {"mismatches": 0, "max_abs_err": 0,
                                  "ms": [], "plain_ms": []})
        r["mismatches"] += bad
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["ms"].append(ms)
        r["plain_ms"].append(plain_ms)
        print(json.dumps({"timing": name, "shape": shape, "mismatches": bad,
                          "ms_plain_kern_kern_plain": runs, "card": card}),
              flush=True)
        check(bad == 0 and err == 0, f"{name} != plain at {shape}")

    for wide, with_crd in ((False, False), (True, True)):
        a_key = to_dev(torch, sorted_keys(rng, n_run, wide, 0.3))
        b_key = to_dev(torch, sorted_keys(rng, n_run, wide, 0.3))
        a_crd = to_dev(torch, coords(rng, n_run) if with_crd else None)
        b_crd = to_dev(torch, coords(rng, n_run) if with_crd else None)
        got = M.merge_sorted(a_key, a_crd, b_key, b_crd)
        want = M.merge_sorted_ref(a_key, a_crd, b_key, b_crd)
        torch.cuda.synchronize()
        bad, err = compare(torch, got, want, 2 * n_run)
        ms, pms, runs = turns(
            torch, lambda: M.merge_sorted(a_key, a_crd, b_key, b_crd),
            lambda: M.merge_sorted_ref(a_key, a_crd, b_key, b_crd))
        record("merge_sorted", bad, err, ms, pms, runs,
               f"2 x {n_run} {'u64' if wide else 'u32'} keys"
               f"{' + coords' if with_crd else ''}")
        del a_key, b_key, a_crd, b_crd, got, want

    for wide, with_crd in ((False, False), (True, True)):
        t_key = to_dev(torch, np.concatenate([
            sorted_keys(rng, used, wide, 0.2),
            np.zeros(cap - used, np.int64 if wide else np.int32)]))
        t_cnt = to_dev(torch, rng.integers(1, 100, size=cap).astype(
            np.int32))
        t_crd = to_dev(torch, coords(rng, cap) if with_crd else None)
        b_key = to_dev(torch, sorted_keys(rng, n_run, wide, 0.5))
        b_crd = to_dev(torch, coords(rng, n_run) if with_crd else None)
        args = (t_key, t_cnt, t_crd, used, b_key, b_crd, cap)
        got = M.merge_fold(*args)
        want = M.merge_fold_ref(*args)
        torch.cuda.synchronize()
        check(got[3] == want[3] == used + n_run, "merge_fold length")
        bad, err = compare(torch, got[:3], want[:3], got[3])
        ms, pms, runs = turns(torch, lambda: M.merge_fold(*args),
                              lambda: M.merge_fold_ref(*args))
        record("merge_fold", bad, err, ms, pms, runs,
               f"{n_run} into {used} of {cap}, {'u64' if wide else 'u32'} "
               f"keys{' + coords' if with_crd else ''}")
        del t_key, t_cnt, t_crd, b_key, b_crd, args, got, want

    for wide, lo, hi in ((False, 2, (1 << 31)), (True, 1, None)):
        key = sorted_keys(rng, n_agg, wide, 0.5)
        cnt = rng.integers(1, 10, size=n_agg).astype(np.uint32)
        cnt[rng.random(n_agg) < 0.1] = 0xFFFFFF00    # saturating sums
        cnt = cnt.view(np.int32)
        crd = coords(rng, n_agg)
        for sentinel in (False, True):
            if sentinel:   # K6: raw arrays, dead (all ones) tail
                k = np.concatenate([key, np.full(dead, -1, key.dtype)])
                c = np.concatenate([cnt, np.full(dead, -1, np.int32)])
                r = np.concatenate([crd, np.full(dead, -1, np.int64)])
            else:          # K4: a table of capacity 2^26, live prefix
                pad = cap - n_agg
                k = np.concatenate([key, np.zeros(pad, key.dtype)])
                c = np.concatenate([cnt, np.zeros(pad, np.int32)])
                r = np.concatenate([crd, np.zeros(pad, np.int64)])
            k, c, r = to_dev(torch, k), to_dev(torch, c), to_dev(torch, r)
            fn, ref, args = (
                (M.aggregate_compact, M.aggregate_compact_ref,
                 (k, c, r, lo, hi)) if sentinel else
                (M.aggregate_fold, M.aggregate_fold_ref,
                 (k, c, r, n_agg, lo, hi)))
            name = fn.__name__
            kern = functools.partial(fn, *args)
            plain = functools.partial(ref, *args)
            got, want = kern(), plain()
            torch.cuda.synchronize()
            check(got[3] == want[3], f"{name} n_live {got[3]} != {want[3]}")
            bad, err = compare(torch, got[:3], want[:3],
                               k.numel() if sentinel else got[3])
            ms, pms, runs = turns(torch, kern, plain)
            record(name, bad, err, ms, pms, runs,
                   f"{n_agg} entries{f' + {dead} dead' if sentinel else ''},"
                   f" {'u64' if wide else 'u32'} keys + coords, lo={lo} "
                   f"hi={hi}, n_live={got[3]}")
            del k, c, r, got, want
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 8: the counting slice through the CLI
# ---------------------------------------------------------------------------

def write_genome_fastq(path: str, rng, n_reads: int, genome_len: int,
                       err_rate: float):
    """Reads from a random genome, both strands, phase 5's lognormal
    lengths, substitution errors at ``err_rate``; returns the reads' 2-bit
    codes in file order."""
    genome = rng.integers(0, 4, size=genome_len, dtype=np.uint8)
    lens = np.clip(rng.lognormal(np.log(5000), 0.85, size=n_reads),
                   500, 16000).astype(np.int64)
    starts = rng.integers(0, genome_len - 16000, size=n_reads)
    reads = []
    with open(path, "wb") as f:
        for i, (s, ln) in enumerate(zip(starts, lens)):
            codes = genome[s : s + ln].copy()
            if rng.random() < 0.5:
                codes = (3 - codes)[::-1].copy()
            hit = np.flatnonzero(rng.random(ln) < err_rate)
            codes[hit] = (codes[hit] + rng.integers(1, 4, size=hit.size,
                                                    dtype=np.uint8)) % 4
            f.write(b"@read%d\n%s\n+\n%s\n" % (i, ACGT[codes].tobytes(),
                                               b"I" * ln))
            reads.append(codes)
    return reads


def oracle_kmers(reads, k: int):
    """Canonical k-mers of every valid position in scan order, with their
    read numbers and positions, straight from the codes (numpy only)."""
    cat = np.concatenate(reads).astype(np.uint64)
    lens = np.array([r.size for r in reads], np.int64)
    rid = np.repeat(np.arange(len(reads), dtype=np.int64), lens)
    pos = np.arange(cat.size, dtype=np.int64) - np.repeat(
        np.cumsum(lens) - lens, lens)
    valid = pos <= (lens[rid] - k)
    n = cat.size - k + 1
    fwd = np.zeros(n, np.uint64)
    rev = np.zeros(n, np.uint64)
    for j in range(k):
        fwd = (fwd << np.uint64(2)) | cat[j : j + n]
        rev |= (np.uint64(3) - cat[j : j + n]) << np.uint64(2 * j)
    sel = np.flatnonzero(valid[:n])
    return np.minimum(fwd, rev)[sel], rid[sel], pos[sel]


def read_count_dump(path: str, k: int):
    with open(path, "rb") as f:
        head = f.read(14)
        payload = f.read()
    check(int.from_bytes(head[:4], "little") == 0xCEA2BBFF and head[4] == k,
          f"{path}: bad header")
    if k == 16:
        rec = np.frombuffer(payload, dtype=[("k", "<u4"), ("c", "u1")])
        return rec["k"].astype(np.uint64), rec["c"]
    rec = np.frombuffer(payload, dtype=[("n", "u1"), ("k", "<u8"),
                                        ("c", "u1")])
    return rec["k"], rec["c"]


def check_count_dump(path: str, reads, k: int, what: str) -> int:
    can, _, _ = oracle_kmers(reads, k)
    keys, counts = np.unique(can, return_counts=True)
    sel = counts >= 2
    want_k, want_c = keys[sel], np.minimum(counts[sel], 255)
    got_k, got_c = read_count_dump(path, k)
    ok = (got_k.size == want_k.size and np.array_equal(got_k, want_k)
          and np.array_equal(got_c.astype(np.int64), want_c))
    print(f"{what}: {got_k.size} records in the dump, oracle {want_k.size} "
          f"(of {keys.size} distinct {k}-mers): "
          f"{'equal' if ok else 'DIFFERENT'}", flush=True)
    check(ok, f"{what}: dump != numpy oracle")
    return int(keys.size)


def check_unique_dump(path: str, reads, k: int, what: str) -> int:
    can, rid, pos = oracle_kmers(reads, k)
    keys, first, counts = np.unique(can, return_index=True,
                                    return_counts=True)
    at = np.sort(first[counts == 1])          # scan order
    with open(path, "rb") as f:
        head = f.read(13)
        rec = np.frombuffer(f.read(), dtype=[("k", "<u4"), ("r", "<u4"),
                                             ("p", "<u4")])
    check(int.from_bytes(head[:4], "little") == 0xCEA2BBDD
          and head[4] == k, f"{path}: bad header")
    ok = (rec.size == at.size
          and np.array_equal(rec["k"], (can[at] & np.uint64(0xFFFFFFFF))
                             .astype(np.uint32))
          and np.array_equal(rec["r"], rid[at].astype(np.uint32))
          and np.array_equal(rec["p"], pos[at].astype(np.uint32)))
    print(f"{what}: {rec.size} unique records in the dump, oracle "
          f"{at.size} (of {keys.size} distinct {k}-mers): "
          f"{'equal' if ok else 'DIFFERENT'}", flush=True)
    check(ok, f"{what}: dump != numpy oracle")
    return int(keys.size)


def run_parsefastq(argv, cwd: str):
    """parsefastq.main in ``cwd`` (where it writes its histograms); returns
    (rc, stdout, stderr, wall s)."""
    import contextlib
    import io
    from kmerutils_tpu_torch.cli import parsefastq
    out, err = io.StringIO(), io.StringIO()
    here = os.getcwd()
    os.chdir(cwd)
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = parsefastq.main(argv)
        wall = time.perf_counter() - t0
    finally:
        os.chdir(here)
    print(f"parsefastq {' '.join(argv[2:])}: rc {rc} in {wall:.3f} s | "
          + out.getvalue().strip().replace("\n", " | ")
          + (" | stderr: " + err.getvalue().strip() if err.getvalue()
             else ""), flush=True)
    return rc, out.getvalue(), err.getvalue(), wall


def counting_runs(torch, rng, tmp: str, card: str, dev,
                  n_reads: int = 10_000, genome_len: int = 4_600_000,
                  spill_reads: int = 2_000, spill_capacity: int = 4194304,
                  spill_batch_reads: int = 64):
    phase("8 the counting slice: parsefastq on cuda")
    from kmerutils_tpu_torch.ops import merge as M
    fq = os.path.join(tmp, "bact.fastq")
    t0 = time.perf_counter()
    reads = write_genome_fastq(fq, rng, n_reads, genome_len, 0.06)
    mbases = sum(r.size for r in reads) / 1e6
    print(f"fixture: {len(reads)} reads / {mbases:.1f} Mbases from a "
          f"{genome_len / 1e6:.1f} Mbase genome, both strands, 6 % "
          f"substitutions "
          f"({time.perf_counter() - t0:.1f} s to write)", flush=True)
    base = ["-f", fq, "--device", str(dev), "kmer"]

    # --- the main path: counts from 0 to what the --count run launched ---
    M.reset_launches()
    rc, _, err, wall = run_parsefastq(base + ["--count", "-s", "16"], tmp)
    launches = {"K3": M.launches_fold, "K4": M.launches_aggregate,
                "K5": M.launches_merge, "K6": M.launches_compact}
    # -----------------------------------------------------------------------
    print(f"launches on the --count -s 16 path: {launches}", flush=True)
    check(rc == 0 and "WARNING" not in err, "--count -s 16 failed or dropped")
    for name in ("K3", "K4", "K5"):
        check(launches[name] > 0, f"{name} was not launched on the CLI path")
    distinct16 = check_count_dump(fq + ".multi_kmer.bin", reads, 16,
                                  "--count -s 16")

    rc, _, err, _ = run_parsefastq(base + ["--unique", "-s", "21"], tmp)
    check(rc == 0 and "WARNING" not in err, "--unique -s 21 failed or dropped")
    check_unique_dump(fq + ".once_kmer.bin", reads, 21, "--unique -s 21")

    spill_fq = os.path.join(tmp, "bact2k.fastq")
    with open(fq, "rb") as src, open(spill_fq, "wb") as dst:
        for _ in range(4 * spill_reads):
            dst.write(src.readline())
    rc, out, err, _ = run_parsefastq(
        ["-f", spill_fq, "--device", str(dev), "--batch-reads",
         str(spill_batch_reads), "kmer", "--count", "-s", "16", "--capacity",
         str(spill_capacity)], tmp)
    check(rc == 0 and "WARNING" not in err, "spill run failed or dropped")
    segs = int(out.split(" spill segments merged")[0].rsplit("(", 1)[1]) \
        if "spill segments merged" in out else 0
    check(segs >= 2, f"spill run wrote {segs} segments, want >= 2")
    check_count_dump(spill_fq + ".multi_kmer.bin", reads[:spill_reads], 16,
                     f"spill run ({segs} segments)")

    walls = [wall]
    for _ in range(3):
        rc, _, _, w = run_parsefastq(base + ["--count", "-s", "16"], tmp)
        check(rc == 0, "--count repeat failed")
        walls.append(w)
    print(json.dumps({"timing": "parsefastq_count_k16_wall", "s": walls,
                      "mbases": mbases, "distinct_16mers": distinct16,
                      "mbases_per_s": [mbases / w for w in walls],
                      "card": card}), flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 9: K7 and the exact-counting path
# ---------------------------------------------------------------------------

PALINDROMES = ["GGG" + "T" * 16 + "A" * 16 + "CCCCC",
               "C" + "A" * 16 + "T" * 16 + "GG"]


def live_arrays(torch, gen, n: int, narr: int, frac: float, dev):
    """narr int32 arrays of n entries made on the card from ``gen``: a
    share ``frac`` of live entries (first word not all ones, values over
    the whole u32 range), the rest dead (first word -1)."""
    first = torch.randint(-(1 << 31), (1 << 31) - 1, (n,), dtype=torch.int32,
                          device=dev, generator=gen)
    first = torch.where(first == -1, 0, first)
    dead = torch.rand(n, device=dev, generator=gen) >= frac
    first = torch.where(dead, -1, first)
    rest = [torch.randint(-(1 << 31), (1 << 31) - 1, (n,), dtype=torch.int32,
                          device=dev, generator=gen)
            for _ in range(narr - 1)]
    return (first, *rest)


def k7_check(torch, arrs, what: str):
    """K7 vs its plain version on ``arrs``: (mismatching entries, max |diff|
    of the u32 words); fails on any difference."""
    from kmerutils_tpu_torch.ops import merge as M
    got, n = M.compact_live(arrs)
    want, n_ref = M.compact_live_ref(arrs)
    sync(torch, arrs[0].device)
    check(n == n_ref, f"K7 n_live {n} != {n_ref} ({what})")
    bad, err = compare(torch, got, want, arrs[0].numel())
    check(bad == 0, f"K7 != plain ({what}): {bad} mismatches")
    return bad, err


def dense_oracle(reads, k: int, offset: int = 0):
    """numpy oracle of the dense exact counts: (keys, counts, first read,
    first position) of the distinct canonical k-mers, ascending."""
    can, rid, pos = oracle_kmers(reads, k)
    keys, first, counts = np.unique(can, return_index=True,
                                    return_counts=True)
    return keys, counts, rid[first] + offset, pos[first]


def exact_path_checks(torch, batch, reads, k: int, what: str) -> int:
    """count/exact.py on the card, densified through K7, against the numpy
    oracle: compact(count_batch), compact_detailed, compact_unique."""
    from kmerutils_tpu_torch.count import exact
    keys, counts, rn, ps = dense_oracle(reads, k, offset=3)
    got = exact.compact_detailed(*exact.count_batch_detailed(batch, k, 3)[:4])
    ok = all(np.array_equal(g.astype(np.uint64), w.astype(np.uint64))
             for g, w in zip(got, (keys, counts, rn, ps)))
    ck, cc = exact.compact(exact.count_batch(batch, k))
    ok = ok and np.array_equal(ck.astype(np.uint64), keys) \
        and np.array_equal(cc, counts)
    one = counts == 1
    uk, ur, up = exact.compact_unique(*exact.unique_kmer_coords(batch, k,
                                                                3)[:3])
    ok = ok and np.array_equal(uk.astype(np.uint64), keys[one]) \
        and np.array_equal(ur, rn[one]) and np.array_equal(up, ps[one])
    print(f"{what}: {keys.size} distinct {k}-mers ({int(one.sum())} unique) "
          f"densified through K7: {'equal' if ok else 'DIFFERENT'} to the "
          f"numpy oracle", flush=True)
    check(ok, f"{what}: exact counts != numpy oracle")
    return int(keys.size)


def k7_and_exact(torch, rng, card: str, dev="cuda", n_syn: int = 64 << 20,
                 bench=(1024, 6000)):
    phase("9 K7 vs plain (exact) and the exact-counting path")
    from kmerutils_tpu_torch.base.sequence import pack_ascii_reads, pack_codes
    from kmerutils_tpu_torch.count import exact
    from kmerutils_tpu_torch.ops import merge as M
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    res = {"mismatches": 0, "max_abs_err": 0, "shapes": []}

    def record(arrs, what):
        bad, err = k7_check(torch, arrs, what)
        ms, pms, runs = turns(torch, lambda: M.compact_live(arrs),
                              lambda: M.compact_live_ref(arrs))
        res["mismatches"] += bad
        res["max_abs_err"] = max(res["max_abs_err"], err)
        res["shapes"].append({"shape": what, "ms": ms, "plain_ms": pms})
        print(json.dumps({"timing": "compact_live", "shape": what,
                          "mismatches": bad, "ms_plain_kern_kern_plain": runs,
                          "card": card}), flush=True)
        return ms, pms

    for narr in (1, 5):
        for frac in (0.1, 0.5, 0.9):
            arrs = live_arrays(torch, gen, n_syn, narr, frac, dev)
            record(arrs, f"{n_syn} entries x {narr} arrays, {frac:.0%} live")
            del arrs
    n, L = bench
    codes = rng.integers(0, 4, size=(n, L), dtype=np.uint8)
    bench = pack_codes(codes, np.full(n, L, np.int32), device=dev)
    pal_codes = [rng.integers(0, 4, size=int(ln), dtype=np.uint8)
                 for ln in rng.integers(40, 400, size=62)]
    enc = {c: i for i, c in enumerate("ACGT")}
    pal_codes += [np.array([enc[c] for c in r], np.uint8) for r in PALINDROMES]
    pal = pack_ascii_reads(["".join("ACGT"[c] for c in r) for r in pal_codes],
                           device=dev)

    # --- the main path: counts from 0 to what count/exact.py launched ---
    M.reset_launches()
    distinct = exact_path_checks(torch, bench, list(codes), 21,
                                 f"bench batch {n} x {L}, k=21")
    exact_path_checks(torch, pal, pal_codes, 32,
                      "64 reads with T^16A^16 and A^16T^16, k=32")
    launches = M.launches_live
    # -----------------------------------------------------------------------
    print(f"K7 launches on the count/exact.py path: {launches}", flush=True)
    check(launches >= 6, f"K7 launched {launches} < 6 times on that path")
    keys, _ = exact.compact(exact.count_batch(pal, 32))
    check({0xFFFFFFFF00000000, 0xFFFFFFFF} <= set(keys.tolist()),
          "a k=32 key with an all-ones half was lost")

    # K7 at the path's own shape: compact_detailed of the bench batch
    kd = exact.count_batch_detailed(bench, 21)
    arrs = ((kd[1] - 1).contiguous(), kd[0].to(torch.int32),
            (kd[0] >> 32).to(torch.int32), kd[2].contiguous(),
            kd[3].contiguous())
    ms, pms = record(arrs, f"count_batch_detailed k=21 bench batch "
                           f"({arrs[0].numel()} entries, {distinct} live) "
                           f"x 5 arrays")
    res.update(ms=ms, plain_ms=pms, launches=launches)
    return res


# ---------------------------------------------------------------------------
# phase 10: block mode, ann and the whole-collection sketch
# ---------------------------------------------------------------------------

def plain_blocks(torch, codes_list, k: int, m: int, bs: int, dev):
    """Per read, its live blocks' signatures (u32[n_live, m]) through the
    plain path on the card: same hashing, per-block multiplicities, plain
    tournament (k <= 16)."""
    from kmerutils_tpu_torch.base.sequence import pack_codes
    from kmerutils_tpu_torch.ops import tournament as T
    from kmerutils_tpu_torch.sketch import probminhash
    from kmerutils_tpu_torch.sketch.jaccard import hashed_kmers
    L = max(c.size for c in codes_list)
    codes = np.zeros((len(codes_list), L), np.uint8)
    for i, c in enumerate(codes_list):
        codes[i, : c.size] = c
    batch = pack_codes(codes, np.array([c.size for c in codes_list],
                                       np.int32), device=dev)
    items, valid = hashed_kmers(batch, k)
    n, P = items.shape
    nb = -(-P // bs)
    pad = torch.nn.functional.pad
    items = pad(items, (0, nb * bs - P)).reshape(n * nb, bs)
    valid = pad(valid, (0, nb * bs - P)).reshape(n * nb, bs)
    s, winv, is_real = probminhash.sort_with_multiplicities(items, valid)
    sig = T.weighted_tournament_ref(
        s.contiguous(), torch.where(is_real, winv, 0.0).contiguous(), m)
    sig = sig.cpu().numpy().view(np.uint32).reshape(n, nb, m)
    live = is_real.any(dim=1).cpu().numpy().reshape(n, nb)
    return [sig[i][live[i]] for i in range(n)]


def topk_oracle(sigs: np.ndarray, queries, k: int):
    """numpy top-k of the given query rows over all rows: equal-slot count
    descending, then index ascending, self excluded; (ids, counts)."""
    cnt = (sigs[queries][:, None, :] == sigs[None, :, :]).sum(axis=2)
    cnt[np.arange(len(queries)), queries] = -1
    idx = np.arange(sigs.shape[0])
    order = np.array([np.lexsort((idx, -c))[:k] for c in cnt])
    return order, np.take_along_axis(cnt, order, axis=1)


def check_ann_dump(path: str, n: int, k: int, read_of=None):
    """Invariants of a neighbour table: shape, no self hit, no neighbour
    outside the rows, no hit from the query's own read (block mode)."""
    from kmerutils_tpu_torch.ann import read_neighbor_dump
    nn, sim = read_neighbor_dump(path)
    check(nn.shape == (n, k), f"{path}: shape {nn.shape} != {(n, k)}")
    live = sim >= 0
    q = np.broadcast_to(np.arange(n)[:, None], nn.shape)
    check(bool((nn[live] < n).all()) and not (nn[live] == q[live]).any(),
          f"{path}: a self hit or a neighbour outside the table")
    if read_of is not None:
        check(not (read_of[nn[live]] == read_of[q[live]]).any(),
              f"{path}: a hit from the query's own read")
    return nn, sim


def datasketcher_run(argv, what: str):
    from kmerutils_tpu_torch.cli import datasketcher
    t0 = time.perf_counter()
    rc = datasketcher.main(argv)
    wall = time.perf_counter() - t0
    print(f"{what}: rc {rc} in {wall:.3f} s", flush=True)
    check(rc == 0, f"{what} returned non-zero")
    return wall


def rest_of_datasketcher(torch, rng, tmp: str, card: str, dev, fq8: str,
                         clean8, n_block_ann: int = 1000, m: int = 200,
                         bench=(1024, 6000)):
    phase("10 the rest of datasketcher on cuda: -b, ann, block ann, "
          "sketch_collection")
    from kmerutils_tpu_torch.base.sequence import pack_codes
    from kmerutils_tpu_torch.count import exact
    from kmerutils_tpu_torch.io import formats
    from kmerutils_tpu_torch.ops import tournament as T
    from kmerutils_tpu_torch.sketch.jaccard import Sketcher, hashed_kmers
    from kmerutils_tpu_torch.sketch.params import SeqSketcherParams
    out = {"card": card}
    for d in ("blk", "brute", "hnsw", "bann", "bann_hnsw"):
        os.makedirs(os.path.join(tmp, d))
    base = ["-f", fq8, "-s", str(m), "-k", "8", "--device", str(dev)]

    # --- the main path: counts from 0 to what the block run launched ---
    T.launches_u32 = T.launches_u64 = 0
    bdump = os.path.join(tmp, "blk", "sigs.bin")
    out["block_wall_s"] = datasketcher_run(
        base + ["-b", "512", "-d", bdump], "datasketcher -b 512 -k 8")
    launches = T.launches_u32
    # -----------------------------------------------------------------------
    print(f"K1 launches on the -b 512 path: {launches}", flush=True)
    check(launches > 0, "K1 was not launched on the block path")
    kk, mm, bs, per_seq = formats.read_block_signature_dump(bdump)
    check((kk, mm, bs) == (8, m, 512) and len(per_seq) == len(clean8),
          f"block dump header {(kk, mm, bs)}, {len(per_seq)} reads")
    n_blocks = [len(b) for _, b in per_seq]
    want_blocks = [-(-(c.size - 8 + 1) // 512) for c in clean8]
    check([s for s, _ in per_seq] == list(range(len(clean8)))
          and n_blocks == want_blocks,
          "live blocks != the blocks with a valid k-mer")
    pick = np.sort(rng.choice(len(clean8), size=64, replace=False))
    want = plain_blocks(torch, [clean8[i] for i in pick], 8, m, 512, dev)
    bad = sum(int((np.asarray(per_seq[i][1]) != w).sum())
              for i, w in zip(pick, want))
    print(f"block dump: {sum(n_blocks)} blocks of {len(per_seq)} reads; 64 "
          f"sampled reads vs the plain path on the card: {bad} mismatching "
          f"slots", flush=True)
    check(bad == 0, "block dump != plain path on sampled reads")

    # ann over the per-read signatures: exact search, then the native index
    brute = os.path.join(tmp, "brute", "sigs.bin")
    out["ann_brute_wall_s"] = datasketcher_run(
        base + ["-d", brute, "ann", "-n", "10", "--engine", "brute"],
        "datasketcher ann -n 10 --engine brute")
    sigs = formats.read_signature_dump(brute)[2]
    n = sigs.shape[0]
    nn_b, sim_b = check_ann_dump(brute + "-ann", n, 10)
    q = np.sort(rng.choice(n, size=64, replace=False))
    ids, cnt = topk_oracle(sigs, q, 10)
    inv = np.float32(1.0 / m)
    ok = np.array_equal(nn_b[q], ids) and np.array_equal(
        sim_b[q], cnt.astype(np.float32) * inv)
    print(f"brute ann: 64 sampled reads vs numpy top-10 (count desc, index "
          f"asc): {'equal' if ok else 'DIFFERENT'}", flush=True)
    check(ok, "brute neighbours != numpy top-k")
    hn = os.path.join(tmp, "hnsw", "sigs.bin")
    out["ann_hnsw_wall_s"] = datasketcher_run(
        base + ["-d", hn, "ann", "-n", "10"], "datasketcher ann -n 10 (hnsw)")
    check(os.path.exists(hn + "-ann.hnsw"), "no -ann.hnsw graph file")
    nn_h, sim_h = check_ann_dump(hn + "-ann", n, 10)
    check(bool((sim_h > -1).all()), "hnsw table holds -1 padding")
    got_cnt = (sigs[np.arange(n)[:, None]] == sigs[nn_h]).sum(axis=2)
    kth = np.rint(sim_b[:, -1] * m).astype(np.int64)
    out["hnsw_recall_at_10_ids"] = float(np.mean(
        [len(set(a) & set(b)) / 10 for a, b in zip(nn_h.tolist(),
                                                   nn_b.tolist())]))
    out["hnsw_recall_at_10_ties"] = float((got_cnt >= kth[:, None]).mean())
    print(f"hnsw recall@10 against the exact search: "
          f"{out['hnsw_recall_at_10_ids']:.4f} by id, "
          f"{out['hnsw_recall_at_10_ties']:.4f} counting ties at the 10th",
          flush=True)

    # block ann over the file's first reads
    fq_b = os.path.join(tmp, "first.fastq")
    n_clean = 0
    with open(fq8, "rb") as src, open(fq_b, "wb") as dst:
        for _ in range(n_block_ann):
            rec = [src.readline() for _ in range(4)]
            n_clean += rec[0].startswith(b"@read")
            dst.write(b"".join(rec))
    bb = os.path.join(tmp, "bann", "sigs.bin")
    out["block_ann_brute_wall_s"] = datasketcher_run(
        ["-f", fq_b, "-s", str(m), "-k", "8", "-b", "512", "-d", bb,
         "--device", str(dev), "ann", "-n", "10", "--engine", "brute"],
        f"datasketcher -b 512 ann --engine brute ({n_block_ann} records)")
    per_seq_b = formats.read_block_signature_dump(bb)[3]
    check(len(per_seq_b) == n_clean, "block ann dump lost reads")
    who = np.fromfile(bb + "-ann.blocks", dtype=np.uint32).reshape(-1, 2)
    check(who.tolist() == [[s, j] for s, b in per_seq_b
                           for j in range(len(b))], "-ann.blocks mismatch")
    bsigs = np.concatenate([np.asarray(b) for _, b in per_seq_b])
    read_of = who[:, 0].astype(np.int64)
    nn_bb, sim_bb = check_ann_dump(bb + "-ann", who.shape[0], 10, read_of)
    qb = np.sort(rng.choice(who.shape[0], size=32, replace=False))
    ids, cnt = topk_oracle(bsigs, qb, 18)
    bad = 0
    for row, (i, c) in enumerate(zip(ids, cnt)):
        keep = read_of[i] != read_of[qb[row]]
        wi, wc = i[keep][:10], c[keep][:10]
        ws = wc.astype(np.float32) * inv
        bad += int(not (np.array_equal(nn_bb[qb[row], : wi.size], wi)
                        and np.array_equal(sim_bb[qb[row], : wi.size], ws)
                        and (sim_bb[qb[row], wi.size:] == -1).all()))
    print(f"block ann: {who.shape[0]} blocks of {n_clean} reads; 32 sampled "
          f"blocks vs numpy: {bad} differ", flush=True)
    check(bad == 0, "block ann neighbours != numpy oracle")
    bh = os.path.join(tmp, "bann_hnsw", "sigs.bin")
    out["block_ann_hnsw_wall_s"] = datasketcher_run(
        ["-f", fq_b, "-s", str(m), "-k", "8", "-b", "512", "-d", bh,
         "--device", str(dev), "ann", "-n", "10"],
        f"datasketcher -b 512 ann (hnsw, {n_block_ann} records)")
    check(os.path.exists(bh + "-ann.hnsw"), "no block -ann.hnsw graph file")
    check_ann_dump(bh + "-ann", who.shape[0], 10, read_of)

    # the whole-collection sketch at the bench shape (one row, k = 21)
    nr, L = bench
    codes = rng.integers(0, 4, size=(nr, L), dtype=np.uint8)
    batch = pack_codes(codes, np.full(nr, L, np.int32), device=dev)
    sk = Sketcher(SeqSketcherParams(kmer_size=21, sketch_size=m))
    T.launches_u64 = 0
    got = sk.sketch_collection(batch)
    k2 = T.launches_u64
    items, valid = hashed_kmers(batch, 21)
    kc = exact.count_from_values(
        torch.where(valid.reshape(-1), items.reshape(-1), -1))
    w = torch.where(kc.keys != -1, kc.counts, 0)[None, :]
    winv = torch.where(w > 0, 1.0 / w.clamp(min=1).to(torch.float32),
                       0.0).contiguous()
    lo = kc.keys.to(torch.int32)[None, :].contiguous()
    hi = (kc.keys >> 32).to(torch.int32)[None, :].contiguous()
    plo, phi = T.weighted_tournament_u64_ref(lo, hi, winv, m)
    want = (phi[0].to(torch.int64) << 32) | (plo[0].to(torch.int64)
                                             & 0xFFFFFFFF)
    sync(torch, dev)
    distinct = int(kc.n_distinct)
    check(k2 == 1, f"K2 launched {k2} times by sketch_collection, want 1")
    check(torch.equal(got, want), "sketch_collection != plain path")
    ms, pms, runs = turns(
        torch, lambda: T.weighted_tournament_u64(lo, hi, winv, m),
        lambda: T.weighted_tournament_u64_ref(lo, hi, winv, m), iters=3,
        plain_iters=1)
    out.update(collection_distinct=distinct,
               collection_ms=cuda_ms(torch,
                                     lambda: sk.sketch_collection(batch), 3),
               collection_k2_ms=ms, collection_k2_plain_ms=pms,
               collection_k2_runs=runs)
    print(json.dumps({"timing": "phase10", **out}), flush=True)
    return out


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"FAIL: torch is not importable ({e})", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    try:
        import kmerutils_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"FAIL: the port is not importable here ({e}); run from the "
              "repository root", file=sys.stderr)
        return 1
    rng = np.random.default_rng(SEED)
    try:
        card = environment(torch)
        build()
        err1 = k1_vs_plain(torch, rng, "cuda")
        err2 = k2_vs_plain(torch, rng, "cuda")
        with tempfile.TemporaryDirectory() as tmp:
            launches, fq8, clean8 = slice_runs(torch, rng, tmp, card, "cuda")
            t = timings(torch, rng, card)
            m = merge_kernels_vs_plain(torch, rng, card)
            launches.update(counting_runs(torch, rng, tmp, card, "cuda"))
            k7 = k7_and_exact(torch, rng, card)
            torch.cuda.empty_cache()
            rest_of_datasketcher(torch, rng, tmp, card, "cuda", fq8, clean8)
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    kernels = [
        {"name": "weighted_tournament", "route": "cuda", "source": SOURCE,
         "replaces": K1_TPU, "launches": launches["u32"], "mismatches": 0,
         "max_abs_err": err1, "ms": t[8]["ms"], "plain_ms": t[8]["plain_ms"]},
        {"name": "weighted_tournament_u64", "route": "cuda", "source": SOURCE,
         "replaces": K2_TPU, "launches": launches["u64"], "mismatches": 0,
         "max_abs_err": err2, "ms": t[21]["ms"],
         "plain_ms": t[21]["plain_ms"]},
    ]
    for name, k, tpu in (("merge_fold", "K3", K3_TPU),
                         ("aggregate_fold", "K4", K4_TPU),
                         ("merge_sorted", "K5", K5_TPU),
                         ("aggregate_compact", "K6", K6_TPU)):
        r = m[name]
        kernels.append({
            "name": name, "route": "cuda", "source": MERGE_SOURCE,
            "replaces": tpu, "launches": launches[k],
            "mismatches": r["mismatches"], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"][0], "plain_ms": r["plain_ms"][0],
            "ms_each_shape": r["ms"], "plain_ms_each_shape": r["plain_ms"]})
    kernels.append({
        "name": "compact_live", "route": "cuda", "source": MERGE_SOURCE,
        "replaces": K7_TPU, "launches": k7["launches"],
        "mismatches": k7["mismatches"], "max_abs_err": k7["max_abs_err"],
        "ms": k7["ms"], "plain_ms": k7["plain_ms"],
        "ms_each_shape": [r["ms"] for r in k7["shapes"]],
        "plain_ms_each_shape": [r["plain_ms"] for r in k7["shapes"]]})
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
