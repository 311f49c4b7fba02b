#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (kmerutils_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA Hopper card (the
kernels are built for sm_90a with nvcc).  Every phase is fatal on failure:

1. environment: torch, CUDA, nvcc, triton, the card's name and power limit;
2. build: the tournament kernels from kmerutils_tpu_torch/csrc/;
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
   ``Sketcher.sketch_batch``; K2 likewise at k=21.

The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
package beside it, the script exits non-zero before printing either.
"""

from __future__ import annotations

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
SOURCE = "kmerutils_tpu_torch/csrc/tournament.cu"
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
    return launches


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
            launches = slice_runs(torch, rng, tmp, card, "cuda")
        t = timings(torch, rng, card)
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    kernels = [
        {"name": "weighted_tournament", "route": "cuda", "source": SOURCE,
         "replaces": K1_TPU, "launches": launches["u32"],
         "max_abs_err": err1, "ms": t[8]["ms"], "plain_ms": t[8]["plain_ms"]},
        {"name": "weighted_tournament_u64", "route": "cuda", "source": SOURCE,
         "replaces": K2_TPU, "launches": launches["u64"],
         "max_abs_err": err2, "ms": t[21]["ms"],
         "plain_ms": t[21]["plain_ms"]},
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
