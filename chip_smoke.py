#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (kmerutils_tpu_torch) on one GPU.

    python3 chip_smoke.py [--baseline ROOT]

Run from the repository root on a machine with an NVIDIA Hopper card (the
kernels are built for sm_90a with nvcc).  Every phase is fatal on failure:

1. environment: torch, CUDA, nvcc, triton, the card's name and power limit;
2. build: every kernel of kmerutils_tpu_torch/csrc/ (one nvcc per source,
   started together, then one link);
3. K1 (weighted_tournament) vs its plain PyTorch version on the card, both
   payload modes: exact equality at every shape of KERNEL_SHAPES (short
   and long rows, one row of ~6.1 M positions, the block rows of an 8
   Mi-base batch, a tail of three 16,384-position rows; m = 1, 13, 200;
   all-invalid rows and an all-invalid range inside a split row; two
   items built through the inverse of mix32 that draw u = 1 in one slot,
   and runs of repeated items);
   then K1 at the k=8 sketch cell's row rungs (``K1_RUNGS``: 1024 x 5993,
   1600 x 5232, 520 x 16,000, 3 x 16,377), rows of random reads through
   the plain prefix and weights stage (~80-92 % of the needed draws at
   weight 1) with the ties of row 0 planted, both payload modes, the
   first rung also at m = 13 and 1 with an all-invalid row and an
   all-invalid range wider than a tile;
   K1's weight-1 test (``k1_threshold_check``): f(t) = logf((t + 1) *
   2^-24) of the kernels' own logf is monotone non-decreasing over all
   2^24 values of t, and K1's threshold of every f(t), of f(t) at weights
   1/2, 1/3 and 1/5 and of f(t) one ulp lower is the smallest t' with
   f(t') at or above it;
4. K2 (weighted_tournament_u64) vs its plain version: the same shapes;
5. the slice: ``datasketcher`` on a seeded ONT-like FASTQ (10,000 reads,
   ~60 Mbases, k=8, m=200) and on a 1,000-read file with k=21, through the
   CLI entry point on ``cuda``; the dumps are read back and 64 sampled
   reads of each are recomputed through the plain path on the card (the
   plain prefix ``kmer_prefix_ref``, not KP, the plain weights stage
   ``sort_weights_ref``, not KW, and the plain tournament);
   the launch counters of K1, K2 and KP, set to 0 before the two runs,
   must show a launch a batch at least, and KW's one a batch of the k=8
   run with no row on the plain route; the k=8 run is then
   repeated three times for its wall-time spread;
6. K1/K2 timed with CUDA events against their plain versions at the row
   shapes of the paths (m=200): the bench shape (1024 reads x 6000 bases)
   with K1 at k=8 and K2 at k=21, beside the whole
   ``Sketcher.sketch_batch``; the block rows of an 8 Mi-base batch (16,384
   x 512, k=8); a tail batch of three 16,384-base reads (k=8); K1 at the
   k=8 cell's other two rungs (1600 x 5232, 520 x 16,000); each with
   the host time to enqueue one call and its bound
   (kmerutils_tpu_torch/roofline.py: K2's needed draws x the SASS
   instructions a draw of K2's own loop; K1's draws through logf, counted
   by its counter, x its exact loop's and the rest x its rejecting loop's,
   both counted in phase 2; over the card's issue rate);
7. K5 (merge_sorted), K3 (merge_fold), K4 (aggregate_fold) and K6
   (aggregate_compact) vs their plain versions on the card, exact, at the
   counting path's shapes (two 8 Mi-entry runs; an 8 Mi-entry batch into
   ~40 M live entries at capacity 2^26, each with u32 keys and with u64
   keys and coordinates, ``merge_shapes``; ~50 M entries, half
   duplicates, counts near 2^32: u32 keys with and without coordinates and
   a count filter, u64 keys with coordinates), each timed against its
   plain version, its bytes bound and, for K3/K5, a stable ``torch.sort``
   of the concatenated keys (``library_ms``), all by profiler device time
   too (K3/K5: one merge kernel per call and nothing else; K4/K6 in all
   and for each of their kernels); 100 K5 calls at its u32 shape, each
   equal to the plain version; K3/K5 exact at the layouts of
   ``merge_layouts`` around their tile (na or nb 0 or 1, n = tile - 1,
   tile, tile + 1, all of A below or above all of B, one key over three
   tiles, equal-key runs straddling tile diagonals from both sides, keys
   across 2^31 and 2^63, K3 capacities cutting the merge mid-tile and at a
   tile edge), u32 and u64 keys, with and without coordinates;
   then K4/K6 exact at the layouts of ``agg_layouts`` around their tile
   (a run of 3.5 tiles, runs ending on and one past tile boundaries, all
   keys distinct, sums saturating only across a tile boundary, lo/hi
   dropping runs that span tiles, n = 0, 1, tile - 1, tile, tile + 1),
   u32 and u64 keys, with and without coordinates;
8. the counting slice: ``parsefastq kmer --count -s 16``, ``--unique -s 21``
   and a spill run (``--capacity 4194304``, small batches, first 2,000
   reads) through the CLI entry point on ``cuda`` over a seeded
   bacterial-scale FASTQ (4.6 Mbase genome, 10,000 reads from both strands,
   6 % substitutions); every dump is compared in full with a numpy oracle
   computed from the generated reads; the launch counters must show K3, K4
   and K5 ran, and KC once for each ``batch_entries`` call of the --count
   and --unique runs; the --count run is repeated three times for its wall
   time;
9. K7 (compact_live) vs its plain version on the card, exact, with n_live
   equal: at every layout of ``live_layouts`` around its tile (n = 1 live
   and dead, tile - 1, tile, tile + 1, all live, all dead, 40 all-dead
   tiles then one live entry, live only at each tile's first or last slot
   or only in the last tile, alternating, 10 / 50 / 90 % over 3.5 tiles)
   with 1 and 5 arrays, 2-4 arrays at one layout; at 64 Mi entries with 1
   and 5 arrays and 10 / 50 / 90 % live, each timed (CUDA events over
   wrapper calls, and the profiler's device time and kernels per call:
   one K7 kernel and one memset); then the exact-counting path
   (count/exact.py: ``count_batch``, ``count_batch_detailed``,
   ``unique_kmer_coords``, densified on the card through K7) on the bench
   batch at k=21 and on reads holding the k=32 keys T^16A^16 and
   A^16T^16, against a numpy oracle; K7's launch counter must show it ran;
   K7 is timed again at that path's shape; then 100 calls at that shape
   and 100 at the all-dead chain, each output equal to the plain
   version's;
10. the rest of ``datasketcher`` through the CLI on ``cuda`` over phase 5's
   ONT-like file: ``-b 512`` (the block dump read back, live blocks exactly
   those with a valid k-mer, 64 sampled reads recomputed through the plain
   path, K1's counter > 0), ``ann -n 10 --engine brute`` (64 sampled rows
   equal to a numpy top-10 with the tie rule) and ``ann -n 10`` through
   the native HNSW index (graph file written, no self hit, no padding,
   recall@10 against the exact search), block ``ann`` (exact and HNSW)
   over the file's first 1,000 records, and ``Sketcher.sketch_collection``
   at the bench shape (k=21, one row of ~6.1 M distinct keys) equal to the
   plain path, timed with K2 alone against its plain version; then
   ``-b 512`` again under torch.profiler for its tournament kernels'
   device time;
11. the other five families: G1 (``grid_min``, SUPER2's packed-key
   minimum) and G2 (``grid_max``, SetSketch's hash maximum) of
   csrc/sketch.cu vs their plain versions on the card, exact, at the bench
   shape (1024 x 6000, k=8 and k=21, some all-invalid rows), on
   sketch_collection's one row of ~6.1 M positions (the split grid) and at
   the shapes of ``GRID_CHECKS`` with random u32 / u64 items (half >= 2^31
   / 2^63): m = 1, 13, 129, 199, 200, 201, 257, 1000 and 4096 over 64 x
   2000 positions (not a multiple of the staging chunk; all-invalid rows, a
   row of one valid position), rows of one position, one split row at
   m = 129, where the data must hold pairs that the clamp after four walk
   rounds ends (``roofline.walk_stats``), whole rows of 2047 and 2049
   positions around G2's 2048-position chunk, and rows of 1-3 valid
   positions at m = 200 and 4096 (the copies that fill G2's last shared
   load); G1 alone at the rows of the SUPER2 cell (``GRID_CELL_CHECKS``:
   k=21 u64 items of length-sorted reads through KP and
   ``grid_min_args``, m = 1000, rows split over 2-9 spans); timed at the
   bench shape and the collection row (G1 also at the cell's median
   batch, 1600 x 5232 at m = 1000) with CUDA
   events against its plain version and its bound
   (kmerutils_tpu_torch/roofline.py: the integer operations the function
   needs per (position, slot) pair, G1's cycle walk counted from the
   data, over the card's issue rate; G2's ALU-pipe floor and the kernel's
   own SASS count beside it, by pipe); HLL's whole ``sketch_batch`` on the
   card against the CPU at the bench shape and on a ragged batch
   (``sketch_collection`` too), k=8 and k=21, registers equal but where
   the float32 value before the floor lies within 2 ulp of an integer;
   ``sketch_batch`` of the five families at the bench shape;
   ``datasketcher -a SUPER / SUPER2 / OPTDENS / REVOPTDENS / HLL -k 8``
   through the CLI on ``cuda`` over phase 5's file
   (G1 / G2 launch counters > 0), each dump read back and 64 sampled reads
   sketched again on the card, through the plain path on the card (every
   kernel replaced by its plain version) and read by read on the CPU: the
   uncast signatures equal (HLL under the floor rule) and the dump equals
   them cast as the JAX CLI casts them; ``SketcherAA`` of all six families
   at 1024 x 2000 residues, k=5 and k=9, equal to the plain path, and 64
   sampled sequences equal to the same sequences sketched on the CPU
   before any cast (HLL under the floor rule);
12. the modules without a kernel of their own, and seqminhash through G1:
   ``sketch_items_invhash`` (bottom-k MinHash) at the bench shape, k=21
   (u64) and k=11 (u32), and ``bottomk_sketch`` of raw u64 hashes (half
   >= 2^63, duplicates, all-ones values, empty rows, size > P), card equal
   to CPU and timed; ``anchor_computation`` over phase 5's ONT-like file
   (k=21, window 1000, overlap 200, nbkmer 16) on the card, persisted
   through the port's RespServer on loopback (anchor count, order, and 64
   sampled anchors read back through the wire equal to the same reads
   anchored on the CPU; wall, Mbases/s, peak device memory), then both
   seqminhash functions over a batch of that file at k=16 and k=12
   (SuperMinHash through G1 equal to the plain path on the card, bottom-k
   on 64 sampled rows equal to the CPU's); G1's counter is set to 0
   before the anchors and must be > 0 after seqminhash; ``qualityloader
   -f ... -p 0`` run as a subprocess over the same reads with seeded
   qualities over bytes 0x21-0x5A (its port read from its second line; GetQRead,
   GetQBlock and GetQBase for 64 sampled reads equal to the remap of the
   file's quality lines written out in numpy; then Exit), with the store's
   load time and ``memory_bits``; ``BloomFilter`` and ``CountingBloom``
   (2^28 slots, 4 probes) over every 16-mer occurrence of phase 8's
   bacterial file, their slots equal to a numpy oracle (``np.bincount``
   over probe indices computed in numpy; clamped at 255), ``contains`` /
   ``estimate_count`` on a million keys equal to the oracle's, and
   ``dispatch`` to 4 and 8 shards (the 16-mers and 16 M random u64 keys)
   card equal to CPU; insert and dispatch rates timed;
13. the sharded path (``parallel/``) on a process group of one rank over
   NCCL on cuda:0 (a multi-card group needs several cards):
   ``ShardedStreamCounter`` over phase 8's file at k=16 (capacity 2^26 a
   rank, growing toward 2^28 as the CLI does) equal in every count to the
   numpy oracle, its wall and device busy time (torch.profiler) printed
   beside phase 8's ``parsefastq --count -s 16`` walls; at k=21 with
   coordinates over the first 2,000 reads in file order (staging depth 1)
   equal to a first-occurrence oracle; a growth epoch and spill epochs at
   2^20 entries over the first 400 reads; ``sharded_count`` and
   ``sharded_count_redundant`` at the bench batch (1024 x 6000, k=21)
   equal to ``count/exact.count_batch``; ``sharded_setsketch_collection``
   (m=200) equal to the row maximum of ``setsketch_signatures``;
   ``gather_signatures`` of those signatures equal to them;
   ``sharded_bloom_insert`` (2^28 slots, 4 probes) equal to
   ``BloomFilter.insert``; the launch counters of K3, K4, K5 and G2 (each
   set to 0 just before every path of the phase) must be > 0;
14. the host leftovers on the card and the six families against the
   published algorithms: ``revcomp_batch`` at the bench batch and a ragged
   one (empty, one-base and whole-word rows) equal to the CPU's and to
   numpy's reverse complement, the identity applied twice, timed;
   ``ReadBatch.codes`` / ``valid_mask`` and ``base_counts`` over phase 5's
   batches, per-read counts equal to numpy's, their totals to numpy's over
   the file and their per-percent histogram to ``stats.py``'s; the k-mer
   value types (``Kmer32bit`` k=14, ``Kmer16b32bit``, ``Kmer64bit`` k=21
   and 32) pushed base by base over 64 sampled reads equal to
   ``base/kmer.py``'s k-mers on the card, and their canonical k-mers at
   4,096 sampled positions; ``KmerCountReload`` of phase 8's ``--count -s
   16`` and ``--unique -s 21`` dumps (10,000 sampled keys and ranks, absent
   keys, ranks -1 and n) equal to phase 8's oracles; ``load_all`` of phase
   5's file onto the card equal to its clean reads in file order; then each
   of the six families (PROB3A, SUPER, SUPER2, OPTDENS, REVOPTDENS, HLL) at
   m = 200 in one batched card call over 2,048 pairs of seeded sets with a
   known exact Jaccard (0.5 and 0.2; weighted sets and
   ``probjaccard_exact`` for PROB3A; the cardinality of 2,048 sets of 400
   items for HLL) and the published sequential algorithm
   (``sketch/golden.py``) on the host over the first 48 pairs (12 sets),
   both held to tests/test_sketch.py's mean and spread rules; the launch
   counters of K1, G1 and G2, each set to 0 before its family, must be > 0.
15. the last interface gaps on the card: ``block_sketch(hash_name=
   "identity")`` at k=8 (K1) and k=21 (K2) on a bench-shape batch equal to
   the same call with the plain kernels, and the k=8 live blocks' u32
   signatures dumped as u64 words (``write_signature_dump(sig_size=8)``)
   and read back; ``read_batches(bucket=False)`` on the host and
   ``read_batches_overlapped(queue_depth=1, bucket=False)`` onto the card
   over phase 5's file, each equal to its clean reads packed in file order
   by numpy; the k=16 table of phase 8's file (the ``--count`` path through
   the library) finalized as ``--count`` does with and without
   ``phases=``: the same arrays, equal to phase 8's oracle, with
   ``agg_s``, ``records`` and ``xfer_s`` filled; the counters of K1 and K2
   (the block calls) and K4 (the ``finalize(phases=)`` call) must be > 0.
16. KP (``ops/kmer_prefix.kmer_prefix``, csrc/kmers.cu: packed words to
   valid, canonical, hashed items) vs its plain version on the card,
   ``torch.equal`` on items and valid at k = 1, 8, 15, 16, 17, 21, 31, 32
   with the Wang and the identity hash, at the bench shape (1024 x 6000),
   the block shape (16,384 x 512), the tail batch (3 x 16,377) and a batch
   with rows of length 0 and below k (``KP_SHAPES``; ragged lengths);
   timed with CUDA events in turns (plain, kernel, kernel, plain) at the
   bench shape (k=8 and k=21), the block and the tail shapes, with the
   host time to enqueue one call, the profiler's device time (one KP
   kernel a call and nothing else) and the bytes bound; the launch counter
   must grow by one for each ``hashed_kmers`` call and each
   ``sketch_batch`` on the card.
17. KC (``ops/count_prefix.count_prefix``, csrc/kmers.cu: packed words to
   the valid canonical keys compacted at the rows' offsets, in the sort's
   form) vs its plain version on the card, ``torch.equal`` on keys and
   indices at k = 1, 8, 15, 16, 17, 21, 31, 32 with and without
   coordinates over ``KC_SHAPES`` (the count cell's shortest, median and
   longest batch rows, a --unique -s 21 batch, the tail batch, rows of
   length 0 to 40 and a batch of mostly empty rows), and
   ``count/stream.batch_entries`` through it equal to the path before KC
   (``plain_entries``); ``batch_entries`` of a batch with host lengths
   under ``torch.cuda.set_sync_debug_mode("error")`` (no wait for the
   device); the launch counter must grow by one a call; timed at
   ``KC_TIMED`` with CUDA events in turns, the enqueue time, the
   profiler's device time and the bytes bound, with ``batch_entries``'
   device time by kernel beside it.
18. KW (``ops/weights.sort_weights``, csrc/weights.cu: each row sorted
   and each position's run length) vs its plain version on the card, bit
   for bit on s, winv and is_real at ``KW_SHAPES`` (KP's items of the
   bench batch at k=8 and k=21, the block rows, the k=8 cell's median and
   longest rows, the k=21 cell's rows of 12,268 and 16,364 positions, a
   3 x 16,370 tail, short rows, heavy duplicates; every
   case with a real item equal to the sentinel, an empty row and a valid
   mask that is not a prefix), long reads past the widest tile class (the
   wide route), and at ``KW_WIDTHS`` (every tile class full and one
   position past it); the route the profiler sees at the widest class
   and one past it; timed at ``KW_TIMED`` with CUDA events against the
   plain version and ``torch.sort(dim=1)`` alone, in turns, with the
   enqueue time, the profiler's device time and the bytes bound; one
   launch a ``sketch_batch`` call.  The oracles of the
   phases before it (``plain_signatures``, ``sorted_rows``,
   ``plain_blocks``) take the plain weights stage, not KW.

With ``--baseline ROOT`` (the tree of another commit, e.g. unpacked from
``git archive`` into a git-ignored directory) the script runs phases 1-2,
builds that tree's kernels into ROOT/build/ and compares its K1/K2 with
this tree's through both packages' public wrappers, in turns (baseline,
this, this, baseline): at phase 6's shapes and sketch_collection's row,
CUDA-event ms, host ms to enqueue one call and device ms (torch.profiler),
every result equal to the plain version; K3/K5 and K4/K6 at phase 7's
timed shapes and K7 at phase 9's seven timed shapes the same way (event ms
and device ms); G1/G2 at phase 11's three timed shapes (each tree's SASS
count per pair; event ms, host enqueue ms and device ms) and HLL's whole
``sketch_batch`` of the bench batch at k=8 and k=21 (the same three, both
trees' registers equal); then ``datasketcher -b 512 -k 8`` of each
package over phase 5's ONT-like file (wall ms, device ms, the
tournament kernels' device ms), and phase 8's ``parsefastq kmer --count -s
16`` and ``--unique -s 21`` of each over a bacterial file like phase 8's
(wall s and Mbases/s).  It prints one JSON line per result and the card
line, and no ``ok`` line.

The temporary files of phases 5-15 live in one directory, removed at the
end.  The last three lines are the card's name and power limit, the
kernels' JSON record (each kernel's launches on its path, exactness, ms,
plain_ms, bound_ms with bound_by, and library_ms or null) and
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
package beside it, the script exits non-zero before printing either.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import importlib
import importlib.util
import json
import os
import re
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
    print("native FASTQ parser (build/native/):",
          "available" if native.available() else "unavailable, Python parser")
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    card = run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).splitlines()[0]
    print(f"card: {card}  (torch: {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} visible)", flush=True)
    return card


def build() -> dict:
    """Builds the kernels; returns the SASS counts of the tournament
    kernels ("u32": K1, "u32_pos": K1 positions mode, "u64": K2; each
    roofline.tournament_instructions_per_draw's record, K1's with its
    rejecting and exact loops)."""
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
    from kmerutils_tpu_torch import roofline
    ipd = {}
    for name, r in roofline.tournament_instructions_per_draw(
            _build.library_path()).items():
        # K2; K1 with item payloads (the sketch's); K1 positions mode
        kind = ("u64" if "ILb1E" in name else
                "u32" if "ILb0ELb1E" in name else "u32_pos")
        ipd[kind] = r
        print(f"SASS {name[:60]}: inner loop {r['instructions']} "
              f"instructions for {r['draws']} draws")
        if "reject" in r:
            rj = r["reject"]
            print(f"  rejecting loop {rj['range']}: {rj['straight']} "
                  f"instructions for {rj['straight_draws']} draws when "
                  f"none passes ({r['reject_per_draw']:.3f} a draw; "
                  f"{rj['instructions']} with the pass region); exact loop "
                  f"{r['exact']['range']}: {r['exact_per_draw']:.3f} a draw")
    check(set(ipd) == {"u32", "u32_pos", "u64"},
          f"tournament SASS not found: {list(ipd)}")
    check("reject" in ipd["u32"] and "reject" in ipd["u32_pos"],
          "K1's rejecting and exact loops not found in the SASS")
    return ipd


# ---------------------------------------------------------------------------
# phase 3-4: kernels vs plain versions on the card
# ---------------------------------------------------------------------------

def tournament_inputs(rng, n: int, P: int, wide: bool, empty_rows=(),
                      empty_span=None):
    """Items with values >= 2^31 (>= 2^63 when wide), many duplicates,
    invalid positions (winv 0 or negative), the given all-invalid rows and
    an all-invalid position range [a, b) of row 0."""
    hi_bit = 63 if wide else 31
    pool = rng.integers(0, 1 << hi_bit, size=max(4, P // 3), dtype=np.uint64)
    pool[: len(pool) // 2] |= np.uint64(1 << hi_bit)
    items = rng.choice(pool, size=(n, P))
    w = rng.integers(1, 6, size=(n, P)).astype(np.float32)
    winv = (1.0 / w).astype(np.float32)
    bad = rng.random((n, P)) < 0.1
    winv[bad] = rng.choice(np.array([0.0, -1.0], np.float32), size=bad.sum())
    for r in empty_rows:
        winv[r, :] = 0.0
    if empty_span is not None:
        winv[0, empty_span[0] : empty_span[1]] = 0.0
    return items, winv


def mix32(x: int) -> int:
    h = (x * 0x9E3779B1) & 0xFFFFFFFF
    h ^= h >> 15
    return (h * 0x85EBCA77) & 0xFFFFFFFF


def unit_draw_item(slot_const: int, h: int) -> int:
    """The u32 x with mix32(x ^ slot_const) = h: mix32 inverted step by
    step.  h >= 0xFFFFFF00 gives the draw u = 1 (e = 0, the largest draw,
    whatever the weight)."""
    def inv(a):
        return pow(a, -1, 1 << 32)
    y = (h * inv(0x85EBCA77)) & 0xFFFFFFFF
    z = y ^ (y >> 15) ^ (y >> 30)                 # undo h ^= h >> 15
    return ((z * inv(0x9E3779B1)) & 0xFFFFFFFF) ^ slot_const


def plant_ties(items, winv, m: int, seed: int, wide: bool):
    """Row 0 gets two positions that draw u = 1 in slot 3 % m, with other
    items and weights (a tie at e = 0, decided by the payload), and a run
    of repeats of the second with equal and other weights.  Returns the
    slot constant."""
    from kmerutils_tpu_torch.ops import tournament as T
    sc = int(T.slot_consts(m, seed)[3 % m])
    if items.shape[1] < 16:
        return sc
    x5, x9 = (np.uint64(unit_draw_item(sc, h))
              for h in (0xFFFFFFFF, 0xFFFFFF00))
    check(mix32(int(x5) ^ sc) == 0xFFFFFFFF, "mix32 inverse")
    if wide:   # the fold lo ^ hi is what draws
        top = np.uint64(0x9ABCDEF0)
        x5, x9 = x5 ^ top | top << np.uint64(32), x9
    items[0, 5], items[0, 9] = x5, x9
    winv[0, 5], winv[0, 9] = 0.5, 1.0
    items[0, 10:15] = items[0, 9]
    winv[0, 10:15] = [1.0, 0.25, 0.25, 1.0, 0.0]
    return sc


def draws_one(x: int, sc: int) -> bool:
    return mix32((x ^ sc) & 0xFFFFFFFF) >> 8 == 0xFFFFFF


# (n, P, m, all-invalid rows, all-invalid range of row 0): the earlier
# shapes, one long row (sketch_collection), short rows, the block rows of
# an 8 Mi-base batch, a tail batch of 16 k-base reads whose rows are split
KERNEL_SHAPES = ((64, 5993, 200, (32,), None), (64, 5993, 13, (32,), None),
                 (64, 37, 200, (32,), None), (64, 37, 13, (32,), None),
                 (1, 6_123_500, 200, (), (1_000_000, 1_020_000)),
                 (1, 37, 13, (), None), (16384, 512, 200, (7, 9000), None),
                 (3, 16384, 200, (1,), (4000, 9000)),
                 (3, 16384, 1, (1,), None))


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
    for n, P, m, empty, span in KERNEL_SHAPES:
        items, winv = tournament_inputs(rng, n, P, False, empty, span)
        sc = plant_ties(items, winv, m, 7, wide=False)
        it, wv = as_i32(items, dev), torch.from_numpy(winv).to(dev)
        for pos in (False, True):
            got = T.weighted_tournament(it, wv, m, seed=7,
                                        return_positions=pos)
            want = T.weighted_tournament_ref(it, wv, m, seed=7,
                                             return_positions=pos)
            sync(torch, dev)
            worst = max(worst, max_abs_err(got, want))
            print(f"K1 {n} x {P} m={m} positions={pos} ("
                  f"{T.launch_plan(it.device, n, P, m, False, pos)}): "
                  f"{int((got != want).sum())} mismatches", flush=True)
            check(torch.equal(got, want), f"K1 != plain ({n} x {P}, m={m}, "
                  f"positions={pos})")
            check(all(bool((got[r] == 0).all()) for r in empty),
                  "K1 all-invalid row != 0")
            if P >= 16:
                win = int(got[0, 3 % m]) & 0xFFFFFFFF
                x = int(items[0, win]) if pos else win
                check(draws_one(x, sc), "K1: no u = 1 draw won its slot")
        del it, wv, got, want
    return worst


# the k=8 sketch cell's row rungs (rows x positions): its median, widest-
# row and tail batches, and the 1024-read bench batch
K1_RUNGS = ((1024, 5993), (1600, 5232), (520, 16_000), (3, 16_377))


def rung_rows(torch, rng, n: int, P: int):
    """K1's inputs as the sketch gives them for n random reads of P + 7
    bases at k=8: sorted rows and 1 / multiplicity weights (the plain
    prefix and weights stage), as numpy arrays."""
    s, w = rung(torch, rng, n, P)
    return (s.cpu().numpy().view(np.uint32).astype(np.uint64),
            w.cpu().numpy())


def rung(torch, rng, n: int, P: int):
    """Sorted k=8 rows and weights of n random reads of P + 7 bases, cut
    to the P positions (the packing pads a read to whole words)."""
    s, w = sorted_rows(torch, *plain_hashed(random_batch(rng, n, P + 7), 8))
    return s[:, :P].contiguous(), w[:, :P].contiguous()


def k1_rungs_vs_plain(torch, rng, dev) -> int:
    """K1 against its plain version at K1_RUNGS (m = 200; the first rung
    also at m = 13 and 1, with an all-invalid row and an all-invalid range
    wider than a tile's span), row 0's ties planted, both payload
    modes."""
    from kmerutils_tpu_torch.ops import tournament as T
    worst = 0
    for (n, P), ms in zip(K1_RUNGS, ((200, 13, 1), (200,), (200,), (200,))):
        items, winv = rung_rows(torch, rng, n, P)
        if n > 2:
            winv[1, :] = 0.0
            winv[2, P // 6: P // 6 + 2100] = 0.0
        need = winv > 0
        ones = float((winv == 1.0).sum() / max(1, need.sum()))
        for m in ms:
            sc = plant_ties(items, winv, m, 7, wide=False)
            it, wv = as_i32(items, dev), torch.from_numpy(winv).to(dev)
            for pos in (False, True):
                got = T.weighted_tournament(it, wv, m, seed=7,
                                            return_positions=pos)
                want = T.weighted_tournament_ref(it, wv, m, seed=7,
                                                 return_positions=pos)
                sync(torch, dev)
                worst = max(worst, max_abs_err(got, want))
                print(f"K1 rung {n} x {P} m={m} positions={pos} (weight 1: "
                      f"{100 * ones:.1f} % of the valid positions): "
                      f"{int((got != want).sum())} mismatches", flush=True)
                check(torch.equal(got, want), f"K1 != plain (rung {n} x "
                      f"{P}, m={m}, positions={pos})")
                if n > 2:
                    check(bool((got[1] == 0).all()),
                          "K1 all-invalid row != 0")
                win = int(got[0, 3 % m]) & 0xFFFFFFFF
                check(draws_one(int(items[0, win]) if pos else win, sc),
                      "K1: no u = 1 draw won its slot")
            del it, wv, got, want
    return worst


def k1_threshold_check(torch, dev="cuda") -> dict:
    """K1's weight-1 test over every t = h >> 8: f(t) of the kernels'
    logf is monotone non-decreasing, and the kernel's threshold of a best
    draw e is the smallest t with f(t) >= e (torch.searchsorted over f),
    for e = f(t), f(t) at weights 1/2, 1/3 and 1/5, f(t) one ulp lower and
    the ends.  Also counts where f differs from torch.log on the card (the
    plain version's log)."""
    phase("3a K1's weight-1 threshold (exhaustive over 2^24)")
    from kmerutils_tpu_torch.ops import tournament as T
    t0 = time.perf_counter()
    f = T.unit_logs(dev)
    t = torch.arange(1 << 24, device=dev)
    plain = torch.log(t.to(torch.float32) * 2.0**-24 + 2.0**-24)
    d = f[1:] - f[:-1]
    res = {"decreasing": int((d < 0).sum()), "plateaus": int((d == 0).sum()),
           "f_ne_torch_log": int((f != plain).sum()),
           "f0": float(f[0]), "f_last": float(f[-1])}
    check(res["decreasing"] == 0, f"logf is not monotone: {res}")
    check(res["f_last"] == 0.0, f"logf(1) != 0: {res}")
    cases = {"weight1": f, "w/2": f * 0.5, "w/3": f * np.float32(1 / 3),
             "w/5": f * np.float32(0.2),
             "ulp_below": torch.nextafter(f, torch.full_like(f, -np.inf)),
             "ends": torch.tensor([-np.inf, 0.0, -0.0, -1e-30, -3.4e38,
                                   float(f[0]), float(f[1])],
                                  dtype=torch.float32, device=dev)}
    for name, e in cases.items():
        got = T.unit_thresholds(e)
        want = torch.searchsorted(f, e, side="left").clamp(max=(1 << 24) - 1)
        bad = int((got != want).sum())
        res[name] = bad
        check(bad == 0, f"K1 threshold != smallest t with f(t) >= e "
              f"({name}: {bad} of {e.numel()})")
        if name == "weight1":
            check(bool((got <= t).all()), "an equal draw would be rejected")
    res["s"] = time.perf_counter() - t0
    print(json.dumps({"k1_threshold": res}), flush=True)
    return res


def k2_vs_plain(torch, rng, dev) -> int:
    phase("4 K2 vs plain (exact)")
    from kmerutils_tpu_torch.ops import tournament as T
    worst = 0
    for n, P, m, empty, span in KERNEL_SHAPES:
        items, winv = tournament_inputs(rng, n, P, True, empty, span)
        sc = plant_ties(items, winv, m, 7, wide=True)
        lo = as_i32(items & np.uint64(0xFFFFFFFF), dev)
        hi = as_i32(items >> np.uint64(32), dev)
        wv = torch.from_numpy(winv).to(dev)
        got = T.weighted_tournament_u64(lo, hi, wv, m, seed=7)
        want = T.weighted_tournament_u64_ref(lo, hi, wv, m, seed=7)
        sync(torch, dev)
        worst = max(worst, max_abs_err(got[0], want[0]),
                    max_abs_err(got[1], want[1]))
        pl = T.launch_plan(lo.device, n, P, m, True)
        print(f"K2 {n} x {P} m={m} ({pl}): "
              f"{int((got[0] != want[0]).sum())} lo / "
              f"{int((got[1] != want[1]).sum())} hi mismatches", flush=True)
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"K2 != plain ({n} x {P}, m={m})")
        check(all(bool((got[0][r] == 0).all() and (got[1][r] == 0).all())
                  for r in empty), "K2 all-invalid row != 0")
        if P >= 16:
            x = int(got[0][0, 3 % m]) ^ int(got[1][0, 3 % m])
            check(draws_one(x, sc), "K2: no u = 1 draw won its slot")
        del lo, hi, wv, got, want
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


def plain_hashed(batch, k: int, hash_name: str = "wang"):
    """``hashed_kmers`` through the plain prefix (``kmer_prefix_ref``, not
    KP) on the batch's device: what the oracles on the card start from."""
    from kmerutils_tpu_torch.ops import kmer_prefix as KP
    return KP.kmer_prefix_ref(batch.words, batch.lengths, k, hash_name)


def plain_signatures(torch, codes_list, k: int, m: int, dev):
    """Signatures of the given reads through the plain path on the card
    (the plain prefix, weights stage and tournament), cut to u32 as the
    PROB3A dump stores them."""
    from kmerutils_tpu_torch.base.sequence import pack_codes
    from kmerutils_tpu_torch.ops import tournament as T
    from kmerutils_tpu_torch.ops import weights as KW
    L = max(c.size for c in codes_list)
    codes = np.zeros((len(codes_list), L), np.uint8)
    lengths = np.array([c.size for c in codes_list], np.int32)
    for i, c in enumerate(codes_list):
        codes[i, : c.size] = c
    batch = pack_codes(codes, lengths, device=dev)
    items, valid = plain_hashed(batch, k)
    s, winv, is_real = KW.sort_weights_ref(items, valid)
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
    from kmerutils_tpu_torch.ops import kmer_prefix as KP
    from kmerutils_tpu_torch.ops import tournament as T
    from kmerutils_tpu_torch.ops import weights as KW
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
    KP.launches_prefix = 0
    KW.launches_weights = 0
    t0 = time.perf_counter()
    rc8 = datasketcher.main(["-f", fq8, "-s", "200", "-k", "8", "-d", dump8,
                             "--device", str(dev)])
    wall8 = time.perf_counter() - t0
    kw8 = KW.launches_weights
    rc21 = datasketcher.main(["-f", fq21, "-s", "200", "-k", "21", "-d",
                              dump21, "--device", str(dev)])
    launches = {"u32": T.launches_u32, "u64": T.launches_u64,
                "kp": KP.launches_prefix, "kw": KW.launches_weights,
                "kw_k8": kw8}
    # -----------------------------------------------------------------------
    print(f"launches: K1 {launches['u32']}, K2 {launches['u64']}, KP "
          f"{launches['kp']}, KW {launches['kw']} ({kw8} at k=8)",
          flush=True)
    check(rc8 == 0 and rc21 == 0, "datasketcher returned non-zero")
    check(launches["u32"] >= n_batches8,
          f"K1 launched {launches['u32']} < {n_batches8} batches")
    check(launches["u64"] >= n_batches21,
          f"K2 launched {launches['u64']} < {n_batches21} batches")
    check(launches["kp"] >= n_batches8 + n_batches21,
          f"KP launched {launches['kp']} < {n_batches8 + n_batches21} "
          f"batches")
    check(kw8 == n_batches8 and launches["kw"] - kw8 == n_batches21,
          f"KW: {kw8} launches at k=8 for {n_batches8} batches, "
          f"{launches['kw'] - kw8} at k=21 for {n_batches21}")

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
# phase 6: K1/K2 timing at the row shapes of the paths
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


def enqueue_ms(torch, fn, iters: int = 50) -> float:
    """Host ms to enqueue one call: a loop of calls with no synchronisation
    inside it."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t * 1e3 / iters


class CounterSink:
    """An ``obs.sink`` that keeps the program's counters of a call."""

    def __init__(self):
        self.records: dict = {}

    def add(self, name, t0, t1) -> None:
        pass

    def record(self, name, value) -> None:
        self.records.setdefault(name, []).append(value)


def k1_counters(torch, fn) -> dict:
    """K1's counters (``sketch.k1_logf``, ``sketch.k1_exact_steps``) over
    one call of ``fn``, as ints."""
    from kmerutils_tpu_torch import obs
    sink = obs.sink = CounterSink()
    try:
        fn()
    finally:
        obs.sink = None
    return {k: int(sum(v)) for k, v in sink.records.items()}


class Bounds:
    """roofline bounds on this card: the SM count and maximum SM clock, and
    the SASS counts of phase 2: K2's draws at its own loop's instructions
    a draw; K1's draws through logf (its counter) at its exact loop's and
    the rest at its rejecting loop's (roofline.k1_instructions)."""

    def __init__(self, torch, ipd: dict):
        from kmerutils_tpu_torch import roofline
        self.rl = roofline
        self.torch = torch
        self.k1 = ipd["u32"]
        self.k2_per_draw = ipd["u64"]["instructions_per_draw"]
        self.sms = torch.cuda.get_device_properties(0).multi_processor_count
        self.clock = roofline.sm_clock_hz()
        print(f"K2 bound: {self.k2_per_draw} instructions a draw; K1: "
              f"{self.k1['exact_per_draw']} a draw through logf, "
              f"{self.k1['reject_per_draw']} a rejected one; {self.sms} SMs "
              f"at {self.clock / 1e9:.3f} GHz", flush=True)

    def bytes(self, nbytes: float):
        return self.rl.bound(nbytes)

    def tournament(self, args, m: int):
        """(bound ms, bound_by) of K1 (args items, winv) or K2 (lo, hi,
        winv)."""
        wide = len(args) == 3
        x = args[0] ^ args[1] if wide else args[0]
        draws, nbytes = self.rl.tournament_work(x, args[-1], m, wide)
        if wide:
            instructions = draws * self.k2_per_draw
        else:
            from kmerutils_tpu_torch.ops import tournament as T
            logf = k1_counters(self.torch, lambda: T.weighted_tournament(
                *args, m))["sketch.k1_logf"]
            instructions = self.rl.k1_instructions(draws, logf, self.k1)
        return self.rl.bound(nbytes, instructions, self.sms, self.clock)


def random_batch(rng, n: int, L: int):
    from kmerutils_tpu_torch.base.sequence import pack_codes
    codes = rng.integers(0, 4, size=(n, L), dtype=np.uint8)
    return pack_codes(codes, np.full(n, L, np.int32), device="cuda")


def sorted_rows(torch, items, valid):
    """The per-row sorted items and weights the sketch gives K1/K2, through
    the plain weights stage (not KW)."""
    from kmerutils_tpu_torch.ops import weights as KW
    s, winv, is_real = KW.sort_weights_ref(items, valid)
    return s.contiguous(), torch.where(is_real, winv, 0.0).contiguous()


def halves(torch, s):
    return (s.to(torch.int32).contiguous(),
            (s >> 32).to(torch.int32).contiguous())


def block_rows(torch, batch, k: int, bs: int = 512):
    """The sorted block rows and weights the -b path gives K1."""
    items, valid = plain_hashed(batch, k)
    pad = -items.shape[1] % bs
    items = torch.nn.functional.pad(items, (0, pad)).reshape(-1, bs)
    valid = torch.nn.functional.pad(valid, (0, pad)).reshape(-1, bs)
    return sorted_rows(torch, items, valid)


def collection_row(torch, batch, k: int = 21):
    """sketch_collection's one row for K2: the batch's distinct k-mers as
    lo / hi halves [1, n], weighted by 1 / their counts."""
    from kmerutils_tpu_torch.count import exact
    items, valid = plain_hashed(batch, k)
    kc = exact.count_from_values(
        torch.where(valid.reshape(-1), items.reshape(-1), -1))
    w = torch.where(kc.keys != -1, kc.counts, 0)[None, :]
    winv = torch.where(w > 0, 1.0 / w.clamp(min=1).to(torch.float32),
                       0.0).contiguous()
    return (*halves(torch, kc.keys[None, :]), winv), int(kc.n_distinct)


def tournament_shapes(torch, rng, bench, collection: bool = False):
    """(name, K1 inputs (items, winv) or K2 inputs (lo, hi, winv)) at the
    row shapes of the paths: the bench batch ``bench`` at k=8 (K1) and
    k=21 (K2); the block rows of an 8 Mi-base batch (512 random reads x
    16,384 -> 16,384 x 512, k=8); a tail batch of three 16,384-base reads
    (k=8); K1 at the k=8 cell's rungs 1600 x 5232 and 520 x 16,000; with
    ``collection``, sketch_collection's row of the bench batch (items from
    the plain prefix)."""
    yield "bench_k8", sorted_rows(torch, *plain_hashed(bench, 8))
    s, w = sorted_rows(torch, *plain_hashed(bench, 21))
    yield "bench_k21", (*halves(torch, s), w)
    yield "block_k8", block_rows(torch, random_batch(rng, 512, 16384), 8)
    yield "tail_k8", sorted_rows(torch, *plain_hashed(
        random_batch(rng, 3, 16384), 8))
    for n, P in K1_RUNGS[1:3]:
        yield f"rung_{n}x{P}_k8", rung(torch, rng, n, P)
    if collection:
        yield "collection_k21", collection_row(torch, bench)[0]


def tournament_fn(T, args, m: int, plain: bool = False):
    """A call of K1 or K2 of tournament module T on args (or of its plain
    version), returning one tensor."""
    if len(args) == 2:
        fn = T.weighted_tournament_ref if plain else T.weighted_tournament
        return lambda: fn(*args, m)
    fn = T.weighted_tournament_u64_ref if plain else T.weighted_tournament_u64
    return lambda: fn(*args, m)


def same(torch, a, b) -> bool:
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    return all(torch.equal(x, y) for x, y in zip(a, b))


def timings(torch, rng, card: str, bounds: Bounds, m: int = 200):
    phase("6 K1/K2 timing at the paths' row shapes (m=200) and sketch_batch")
    from kmerutils_tpu_torch.ops import tournament as T
    from kmerutils_tpu_torch.sketch.jaccard import Sketcher
    from kmerutils_tpu_torch.sketch.params import SeqSketcherParams
    n, L = 1024, 6000
    batch = random_batch(rng, n, L)
    out = {}
    for name, args in tournament_shapes(torch, rng, batch):
        kern = tournament_fn(T, args, m)
        plain = tournament_fn(T, args, m, plain=True)
        check(same(torch, kern(), plain()), f"{name}: kernel != plain")
        ms, pms, runs = turns(torch, kern, plain, iters=20)
        bound = bounds.tournament(args, m)
        r = {"timing": name, "rows": args[-1].shape[0],
             "P": args[-1].shape[1], "ms_plain_kern_kern_plain": runs,
             "enqueue_ms": enqueue_ms(torch, kern), "bound_ms": bound[0],
             "bound_by": bound[1], "bound_share": bound[0] / ms}
        if name.startswith("bench"):
            sk = Sketcher(SeqSketcherParams(kmer_size=int(name[7:]),
                                            sketch_size=m))
            step = cuda_ms(torch, lambda: sk.sketch_batch(batch), 10)
            r.update(sketch_batch_ms=step,
                     sketch_mbases_per_s=n * L / step / 1e3)
        print(json.dumps({**r, "card": card}), flush=True)
        out[name] = {"ms": ms, "plain_ms": pms, "bound_ms": bound[0],
                     "bound_by": bound[1]}
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


def merge_shapes(torch, rng, n_run: int = 8 << 20, cap: int = 1 << 26,
                 used: int = 40_000_000):
    """K3/K5's timed shapes, one at a time, on the card: (wrapper name,
    description, wrapper args, bytes the merge must move: each input entry
    read once, each output entry written once).  Two n_run-entry runs, and
    an n_run-entry run folded into ``used`` live entries of a table of
    ``cap``, each with u32 keys and with u64 keys and coordinates."""
    for wide, with_crd in ((False, False), (True, True)):
        a, b = (to_dev(torch, sorted_keys(rng, n_run, wide, 0.3))
                for _ in range(2))
        ac, bc = (to_dev(torch, coords(rng, n_run) if with_crd else None)
                  for _ in range(2))
        ent = a.element_size() + (8 if with_crd else 0)
        yield ("merge_sorted", f"2 x {n_run} {'u64' if wide else 'u32'} "
               f"keys{' + coords' if with_crd else ''}", (a, ac, b, bc),
               4 * n_run * ent)
        del a, b, ac, bc
    for wide, with_crd in ((False, False), (True, True)):
        t_key = to_dev(torch, np.concatenate([
            sorted_keys(rng, used, wide, 0.2),
            np.zeros(cap - used, np.int64 if wide else np.int32)]))
        t_cnt = to_dev(torch, rng.integers(1, 100, size=cap).astype(
            np.int32))
        t_crd = to_dev(torch, coords(rng, cap) if with_crd else None)
        b = to_dev(torch, sorted_keys(rng, n_run, wide, 0.5))
        bc = to_dev(torch, coords(rng, n_run) if with_crd else None)
        ent = t_key.element_size() + (8 if with_crd else 0)
        yield ("merge_fold", f"{n_run} into {used} of {cap}, "
               f"{'u64' if wide else 'u32'} keys"
               f"{' + coords' if with_crd else ''}",
               (t_key, t_cnt, t_crd, used, b, bc, cap),
               used * (ent + 4) + n_run * ent + (used + n_run) * (ent + 4))
        del t_key, t_cnt, t_crd, b, bc


def short_runs(rng, n: int, longest: int = 40):
    """Run lengths 1..longest summing to n."""
    lens = rng.integers(1, longest + 1, size=n // 2 + 1)
    lens = lens[: np.searchsorted(np.cumsum(lens), n) + 1]
    lens[-1] -= lens.sum() - n
    return lens[lens > 0]


def runs_at(rng, n: int, cuts, quiet=()):
    """Run lengths over n entries ending at the given cut points (exclusive
    run ends) and at random ones, none of those inside the ``quiet``
    ranges [a, b)."""
    cand = np.cumsum(short_runs(rng, n))
    for a, b in quiet:
        cand = cand[(cand <= a) | (cand >= b)]
    ends = np.union1d(cand, [c for c in cuts if 0 < c < n])
    ends = np.union1d(ends[ends < n], [n])
    return np.diff(ends, prepend=0)


def agg_layouts(rng, tile: int):
    """Adversarial inputs of K4/K6 around their tile of ``tile`` entries:
    (name, run lengths, u32 counts per entry, lo, hi).  Counts are small
    except where a case needs them large; ``hi`` None keeps every count."""
    T = tile
    M = 0xFFFFFFFF

    def small(n):
        return rng.integers(0, 10, size=n).astype(np.uint32)

    cases = []
    # one run of 3.5 tiles between short runs
    lens = np.concatenate([short_runs(rng, T + 77), [3 * T + T // 2],
                           short_runs(rng, T)])
    cases.append(("long_run", lens, small(int(lens.sum())), 2, None))
    # runs ending exactly on a tile boundary and one entry after one; a
    # run starting on a boundary; runs ending at a piece's last lane
    n = 6 * T + 5
    lens = runs_at(rng, n, [T, T + 1, 2 * T + 1, 3 * T - 1, 3 * T, 3 * T + 1,
                            4 * T + 32, 4 * T + 64, 5 * T],
                   quiet=[(2 * T - 60, 2 * T + 1), (5 * T - 300, 5 * T)])
    cases.append(("tile_edges", lens, small(n), 1, None))
    cases.append(("tile_edges_lo2", lens, small(n), 2, 7))
    # all entries distinct
    n = 2 * T + T // 2
    cases.append(("distinct", np.ones(n, np.int64), small(n), 1, None))
    cases.append(("distinct_lo1_hi4", np.ones(n, np.int64), small(n), 1, 4))
    # sums that saturate only across a tile boundary: each tile's part of
    # a run stays below 2^32 - 1
    n = 4 * T
    cnt = small(n)
    cnt[T - 3: T + 3] = [0x7FFFFFFF, 1, 1, 1, 1, 0x7FFFFFFF]
    cnt[2 * T - 1], cnt[2 * T] = 0x80000000, 0x7FFFFFFF   # exactly 2^32 - 1
    cnt[3 * T - 1], cnt[3 * T] = 0x80000000, 0x80000000   # exactly 2^32
    # and, for contrast, runs saturating inside one piece of 32 entries
    # and across two pieces of one tile
    h = T // 2
    cnt[100:103] = 0xFFFFFFF0
    cnt[h - 20], cnt[h + 20] = 0x90000000, 0x90000000
    lens = runs_at(rng, n, [100, 103, h - 20, h + 21, T - 3, T + 3, 2 * T - 1,
                            2 * T + 1, 3 * T - 1, 3 * T + 1],
                   quiet=[(100, 103), (h - 20, h + 21), (T - 3, T + 3)])
    cases.append(("saturate_across", lens, cnt, 1, None))
    cases.append(("saturate_across_hi", lens, cnt, 1, M - 1))
    # lo / hi that drop runs spanning several tiles: a run of 2.5 tiles of
    # count 1 (above hi), a run of 1.5 tiles of count 0 (below lo), and a
    # run of 2 tiles summing to 500 (kept)
    a, b, c = 2 * T + T // 2, T + T // 2, 2 * T
    lens = np.concatenate([short_runs(rng, T - 9), [a], short_runs(rng, 50),
                           [b], short_runs(rng, 70), [c],
                           short_runs(rng, T)])
    cnt = small(int(lens.sum()))
    o = T - 9
    cnt[o: o + a] = 1
    o += a + 50
    cnt[o: o + b] = 0
    o += b + 70
    cnt[o: o + c] = 0
    cnt[o + rng.choice(c, 500, replace=False)] = 1
    cases.append(("filter_spanning", lens, cnt, 2, 1000))
    # tiny and edge lengths
    for n in (0, 1, T - 1, T, T + 1):
        lens = short_runs(rng, n, 5) if n else np.zeros(0, np.int64)
        cases.append((f"n={n}", lens, small(n), 1 if n % 2 else 2, None))
    return cases


def merge_layouts(rng, tile: int):
    """Adversarial inputs of K3/K5 around their tile of ``tile`` outputs:
    (name, A, B, K3 capacity or None for na + nb), A and B ascending
    uint64 values below 2^32 spread over the whole range (a third with the
    top bit set), made into keys by ``merge_keys``."""
    T = tile

    def vals(n, pool=None):
        v = rng.integers(0, 1 << 32, size=pool or n, dtype=np.uint64)
        v[: len(v) // 3] |= np.uint64(1 << 31)
        return np.sort(rng.choice(v, size=n) if pool else v)

    def split(v):
        """v cut at random into two ascending runs."""
        to_a = rng.random(v.size) < 0.5
        return v[to_a], v[~to_a]

    def straddling(cuts):
        """Runs of one key in A and in B placed so that output diagonal D
        falls o entries after the run's start, for each (D, o, ra, rb) of
        cuts: inside A's part, at its end, inside B's part, at its
        start; distinct filler keys between runs, each to A or B."""
        a, b, pos, key = [], [], 0, 0
        for d, o, ra, rb in cuts:
            while pos < d - o:
                key += int(rng.integers(1, 1 << 16))
                (a if rng.random() < 0.5 else b).append(key)
                pos += 1
            key += int(rng.integers(1, 1 << 16))
            a += [key] * ra
            b += [key] * rb
            pos += ra + rb
        for _ in range(T // 2):
            key += int(rng.integers(1, 1 << 16))
            (a if rng.random() < 0.5 else b).append(key)
        base = np.uint64((1 << 31) - key // 2)   # across 2^31
        return (base + np.array(a, np.uint64), base + np.array(b, np.uint64))

    e = np.zeros(0, np.uint64)
    one = vals(1)
    cases = [("na=0, nb=1", e, one, None), ("na=1, nb=0", one, e, None),
             ("na=1, nb=1, equal keys", one, one.copy(), None),
             ("na=0, nb=2.5 tiles", e, vals(2 * T + T // 2), None),
             ("na=2.5 tiles, nb=0", vals(2 * T + T // 2), e, None),
             ("na=1, nb=3 tiles", vals(1), vals(3 * T), None),
             ("na=3 tiles, nb=1", vals(3 * T), vals(1), None)]
    for n in (T - 1, T, T + 1):
        cases.append((f"n={n}, ties", *split(vals(n, pool=n // 4)), None))
    v = vals(5 * T + 3)
    lo, hi = v[: v.size // 2], v[v.size // 2:]
    cases.append(("all of A below all of B", lo, hi, None))
    cases.append(("all of B below all of A", hi, lo, None))
    # the splits at the top of their search ranges, ranges of every tile
    # multiple up to 130 (a multiple of 33, 65 or 129 among them)
    v = vals(260 * T)
    cases.append(("all of A below all of B, 130 tiles each",
                  v[: 130 * T], v[130 * T:], None))
    k = vals(1)
    cases.append(("one key over 3 tiles", np.repeat(k, T + T // 2 + 5),
                  np.repeat(k, T + T // 2 + 7), None))
    cases.append(("equal-key runs straddling tile diagonals", *straddling(
        [(T, 5, 47, 35), (2 * T, 54, 54, 40), (3 * T, 64, 61, 45),
         (4 * T, 0, 68, 50), (5 * T, 1, 1, 300)]), None))
    cases.append(("random with ties over 2.5 tiles",
                  *split(vals(2 * T + T // 2, pool=T)), None))
    cases.append(("K3 capacity cuts mid-tile", vals(T + 100), vals(2 * T),
                  T + T // 2 + 3))
    cases.append(("K3 capacity at a tile edge", vals(T + 10), vals(2 * T),
                  2 * T))
    return cases


def merge_keys(v, wide: bool):
    """merge_layouts values as u32 keys (int32 bit patterns) or as u64 keys
    (int64 bit patterns, v << 32 | v >> 16: the same order and ties, the
    top bit set where v's is)."""
    if not wide:
        return v.astype(np.uint32).view(np.int32)
    return ((v << np.uint64(32)) | (v >> np.uint64(16))).view(np.int64)


def layout_keys(rng, lens, wide: bool):
    """Ascending keys with runs of the given lengths (int32 / int64 bit
    patterns), from 2^31 (u32) or 2^63 (u64) up, never all ones."""
    n_runs = len(lens)
    top = (1 << 31) - 2 if not wide else (1 << 62)
    gaps = rng.integers(1, max(2, top // max(n_runs, 1)), size=n_runs,
                        dtype=np.uint64)
    base = np.uint64(1 << 63) if wide else np.uint64(1 << 31)
    keys = np.repeat(base + np.cumsum(gaps, dtype=np.uint64), lens)
    return keys.view(np.int64) if wide else keys.astype(np.uint32).view(
        np.int32)


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


def merge_out(got):
    """(arrays, entries to compare) of a merge_sorted or merge_fold
    result."""
    if len(got) == 2:
        return got, got[0].numel()
    return got[:3], got[3]


def merge_check(torch, fn, ref, args, what: str):
    """K3 or K5 of the wrapper ``fn`` against its plain version ``ref`` on
    args: (mismatches, max abs err, the plain result); fails on any
    difference or another length."""
    got, want = fn(*args), ref(*args)
    sync(torch, args[0].device)
    (g, n), (w, n_ref) = merge_out(got), merge_out(want)
    check(n == n_ref, f"{fn.__name__} at {what}: {n} entries != {n_ref}")
    bad, err = compare(torch, g, w, n)
    check(bad == 0 and err == 0, f"{fn.__name__} != plain at {what}: {bad} "
          f"mismatches")
    return bad, err, want


def merge_profile(torch, fn, iters: int = 10,
                  kernel: str = "merge_kernel") -> dict:
    """``iters`` calls of ``fn`` (a merge_sorted or merge_fold call, or
    another wrapper of one ``kernel``) under torch.profiler: device ms per
    call and the calls' device events.  A call launches one such kernel
    and nothing else (no copy, no memset), so every device event must be
    that kernel and each is one call;
    the profiler can lose the first events of a session late in a long
    process (see k7_profile), so the time is the mean of the last half.
    A session that recorded fewer than half of the calls is run again, at
    most twice."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        evs = sorted((ev for ev in prof.events()
                      if ev.device_type == DeviceType.CUDA),
                     key=lambda ev: ev.time_range.start)
        if len(evs) >= iters // 2:
            break
        print(f"the profiler kept {len(evs)} {kernel} events of {iters} "
              f"calls; profiling again", flush=True)
    names = {short_name(ev.name) for ev in evs}
    check(all(n.startswith(kernel) for n in names)
          and iters // 2 <= len(evs) <= iters,
          f"{kernel} profile: {len(evs)} device events of {names} for "
          f"{iters} calls, want one {kernel} per call")
    last = evs[-(iters // 2):]
    return {"device_ms": sum(ev.time_range.elapsed_us()
                             for ev in last) / 1e3 / len(last),
            "kernels": sorted(names), "calls_recorded": len(evs),
            "calls": iters}


def merge_stress(torch, fn, want, what: str, calls: int = 100) -> None:
    """``calls`` calls of ``fn`` (K3 or K5), each output held to the plain
    version's ``want``."""
    w, n = merge_out(want)
    bad = 0
    for _ in range(calls):
        g, m = merge_out(fn())
        bad += int(m != n or not all(
            x is None or torch.equal(x[:n], y[:n]) for x, y in zip(g, w)))
    print(f"merge stress, {what}: {calls} calls, {bad} differ from the "
          f"plain version", flush=True)
    check(bad == 0, f"merge stress at {what}: {bad} of {calls} calls differ")


def merge_layout_checks(torch, rng, M, dev="cuda"):
    """K5 and K3 against their plain versions at every layout of
    merge_layouts (around the tile of ops/merge.MERGE_TILE), with u32 and
    u64 keys, with and without coordinates; K3 over a table with 37
    entries of garbage behind its live prefix (A) and random counts, at
    the layout's capacity.  Yields (wrapper name, mismatches, max abs
    err) for each call and prints one JSON line per layout."""
    for case, av, bv, cap in merge_layouts(rng, M.MERGE_TILE):
        for wide in (False, True):
            a = torch.from_numpy(merge_keys(av, wide)).to(dev)
            b = torch.from_numpy(merge_keys(bv, wide)).to(dev)
            pad = torch.from_numpy(merge_keys(rng.integers(
                0, 1 << 32, 37, dtype=np.uint64), wide)).to(dev)
            t_key = torch.cat([a, pad])
            t_cnt = torch.from_numpy(rng.integers(
                -(1 << 31), 1 << 31, t_key.numel()).astype(np.int32)).to(dev)
            for with_crd in (False, True):
                ac, bc, tc = (torch.from_numpy(coords(rng, n)).to(dev)
                              if with_crd else None
                              for n in (a.numel(), b.numel(), 37))
                t_crd = None if ac is None else torch.cat([ac, tc])
                k3 = (t_key, t_cnt, t_crd, a.numel(), b, bc,
                      cap or a.numel() + b.numel())
                for fn, args in ((M.merge_sorted, (a, ac, b, bc)),
                                 (M.merge_fold, k3)):
                    ref = getattr(M, fn.__name__ + "_ref")
                    bad, err, _ = merge_check(torch, fn, ref, args, case)
                    yield fn.__name__, bad, err
        print(json.dumps({"merge_layout": case, "na": int(av.size),
                          "nb": int(bv.size), "capacity": cap,
                          "mismatches": 0}), flush=True)


def merge_kernels_vs_plain(torch, rng, card: str, bounds: Bounds,
                           cap: int = 1 << 26, n_agg: int = 50_000_000,
                           dead: int = 1 << 20):
    phase("7 K5, K3, K4, K6 vs plain (exact) and timing")
    from kmerutils_tpu_torch.ops import merge as M
    res = {}

    def record(name, bad, err, ms, plain_ms, runs, shape, nbytes,
               library_ms=None, device_ms=None):
        r = res.setdefault(name, {"mismatches": 0, "max_abs_err": 0,
                                  "ms": [], "plain_ms": [], "bound_ms": [],
                                  "library_ms": [], "device_ms": []})
        r["mismatches"] += bad
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["ms"].append(ms)
        r["plain_ms"].append(plain_ms)
        r["bound_ms"].append(bounds.bytes(nbytes)[0])
        r["library_ms"].append(library_ms)
        r["device_ms"].append(device_ms)
        print(json.dumps({"timing": name, "shape": shape, "mismatches": bad,
                          "ms_plain_kern_kern_plain": runs, "bytes": nbytes,
                          "bound_ms": r["bound_ms"][-1],
                          "device_ms": device_ms,
                          "library_ms": library_ms, "card": card}),
              flush=True)
        check(bad == 0 and err == 0, f"{name} != plain at {shape}")

    def sort_ms(*keys):
        """A stable torch.sort of the concatenated keys as int64 carriers
        of the unsigned values: the one library call that orders a merge."""
        cat = torch.cat([M._ukey(k) for k in keys])
        ms = cuda_ms(torch, lambda: torch.sort(cat, stable=True), 10)
        del cat
        return ms

    for name, what, args, nbytes in merge_shapes(torch, rng):
        fn, ref = getattr(M, name), getattr(M, name + "_ref")
        bad, err, want = merge_check(torch, fn, ref, args, what)
        kern = functools.partial(fn, *args)
        ms, pms, runs = turns(torch, kern, functools.partial(ref, *args))
        prof = merge_profile(torch, kern)
        print(json.dumps({"timing": name, "shape": what, "profile": prof,
                          "card": card}), flush=True)
        if name == "merge_sorted" and not res.get(name):
            merge_stress(torch, kern, want, what)   # the --count variant
        keys = (args[0], args[2]) if name == "merge_sorted" else \
            (args[0][:args[3]], args[4])
        record(name, bad, err, ms, pms, runs, what, nbytes, sort_ms(*keys),
               prof["device_ms"])
        del args, kern, want, keys
    torch.cuda.empty_cache()
    for name, bad, err in merge_layout_checks(torch, rng, M):
        r = res[name]
        r["mismatches"] += bad
        r["max_abs_err"] = max(r["max_abs_err"], err)

    from kmerutils_tpu_torch import _build
    from kmerutils_tpu_torch.profile_sketch import profile
    check(_build.load().aggregate_tile_entries() == M.AGG_TILE,
          "K4/K6 tile of csrc/merge.cu != ops/merge.AGG_TILE")
    for sentinel, args, what in aggregate_shapes(torch, rng, n_agg, cap,
                                                 dead):
        fn, ref = agg_fns(M, sentinel)
        name = fn.__name__
        kern = functools.partial(fn, *args)
        plain = functools.partial(ref, *args)
        got, want = kern(), plain()
        torch.cuda.synchronize()
        check(got[3] == want[3], f"{name} n_live {got[3]} != {want[3]}")
        k = args[0]
        bad, err = compare(torch, got[:3], want[:3],
                           k.numel() if sentinel else got[3])
        ms, pms, runs = turns(torch, kern, plain)
        prof = profile(kern, 5)
        print(json.dumps({"timing": name, "shape": what,
                          "device_ms": prof["device_ms_per_call"],
                          "kernel_ms": kernel_split(prof), "card": card}),
              flush=True)
        record(name, bad, err, ms, pms, runs,
               f"{what}, n_live={got[3]}", aggregate_bytes(args, got[3]))
        del k, args, kern, plain, got, want
    torch.cuda.empty_cache()
    for name, bad, err in aggregate_layout_checks(torch, rng, M):
        r = res[name]
        r["mismatches"] += bad
        r["max_abs_err"] = max(r["max_abs_err"], err)
        check(bad == 0 and err == 0, f"{name} != plain at the tile layouts")
    return res


def kernel_split(prof: dict) -> dict:
    """Device ms per call of each kernel in a profile_sketch.profile result,
    keyed by the kernel's name without its namespace and arguments."""
    out = {}
    for name, ms in prof["top_kernels_ms_per_call"]:
        out[short_name(name)] = out.get(short_name(name), 0.0) + ms
    return out


def short_name(kernel: str) -> str:
    """A kernel's name without its namespace and arguments."""
    return re.sub(r"^void |\(anonymous namespace\)::|\(.*$", "",
                  kernel).strip()


def agg_fns(M, sentinel: bool):
    """K6 (aggregate_compact) or K4 (aggregate_fold) of merge module M and
    its plain version."""
    if sentinel:
        return M.aggregate_compact, M.aggregate_compact_ref
    return M.aggregate_fold, M.aggregate_fold_ref


def aggregate_bytes(args, n_live: int) -> int:
    """Bytes K4/K6 must move: every input entry read once, each kept run
    written once (K6: the whole output, its all-ones tail included)."""
    k, c, r = args[:3]
    ent = k.element_size() + 4 + (0 if r is None else 8)
    n_in = args[3] if len(args) == 6 else k.numel()
    return ent * (n_in + (n_in if len(args) == 5 else n_live))


def aggregate_shapes(torch, rng, n_agg: int = 50_000_000, cap: int = 1 << 26,
                     dead: int = 1 << 20):
    """The timed K4/K6 shapes: (sentinel, wrapper args, description).
    ~50 M sorted entries, half of them repeating the previous key, counts
    1-9 with a tenth near 2^32 (saturating sums): u32 keys with lo=2 and
    hi=2^31, with coordinates and without (the --count path's variant),
    and u64 keys with coordinates, lo=1.  K4 gets a table of capacity 2^26
    with a live prefix, K6 the raw arrays with a dead (all ones) tail."""
    for wide, lo, hi, crds in ((False, 2, 1 << 31, (True, False)),
                               (True, 1, None, (True,))):
        key = sorted_keys(rng, n_agg, wide, 0.5)
        cnt = rng.integers(1, 10, size=n_agg).astype(np.uint32)
        cnt[rng.random(n_agg) < 0.1] = 0xFFFFFF00    # saturating sums
        cnt = cnt.view(np.int32)
        crd_all = coords(rng, n_agg)
        for with_crd in crds:
            crd = crd_all if with_crd else None
            for sentinel in (False, True):
                fill, n_pad = (-1, dead) if sentinel else (0, cap - n_agg)
                k = to_dev(torch, np.concatenate(
                    [key, np.full(n_pad, fill, key.dtype)]))
                c = to_dev(torch, np.concatenate(
                    [cnt, np.full(n_pad, fill, np.int32)]))
                r = None if crd is None else to_dev(torch, np.concatenate(
                    [crd, np.full(n_pad, fill, np.int64)]))
                args = (k, c, r, lo, hi) if sentinel else \
                    (k, c, r, n_agg, lo, hi)
                yield sentinel, args, (
                    f"{n_agg} entries{f' + {dead} dead' if sentinel else ''}"
                    f", {'u64' if wide else 'u32'} keys"
                    f"{' + coords' if with_crd else ''}, lo={lo} hi={hi}")
                del k, c, r, args


def aggregate_layout_checks(torch, rng, M):
    """K4 and K6 against their plain versions at every layout of
    agg_layouts (runs around the tile of ops/merge.AGG_TILE), with u32 and
    u64 keys, with and without coordinates; K4 over a table with 37
    entries of garbage behind its live prefix, K6 with a dead tail of a
    third of the entries.  Yields (wrapper name, mismatches, max abs err)
    for each call and prints one JSON line per layout."""
    for case, lens, cnt, lo, hi in agg_layouts(rng, M.AGG_TILE):
        n = int(lens.sum())
        bad_case = 0
        for wide in (False, True):
            keys = layout_keys(rng, lens, wide)
            crd = coords(rng, n)
            for with_crd in (False, True):
                for sentinel in (False, True):
                    pad = n // 3 + 7 if sentinel else 37
                    pk = np.full(pad, -1, keys.dtype) if sentinel else \
                        layout_keys(rng, np.ones(pad, np.int64), wide)
                    pc = np.full(pad, -1, np.int32) if sentinel else \
                        rng.integers(0, 100, pad).astype(np.int32)
                    pr = np.full(pad, -1, np.int64) if sentinel else \
                        coords(rng, pad)
                    k = to_dev(torch, np.concatenate([keys, pk]))
                    c = to_dev(torch, np.concatenate([cnt.view(np.int32),
                                                      pc]))
                    r = to_dev(torch, np.concatenate([crd, pr])) \
                        if with_crd else None
                    args = (k, c, r, lo, hi) if sentinel else \
                        (k, c, r, n, lo, hi)
                    fn, ref = agg_fns(M, sentinel)
                    got, want = fn(*args), ref(*args)
                    torch.cuda.synchronize()
                    check(got[3] == want[3], f"{fn.__name__} n_live at "
                          f"{case}: {got[3]} != {want[3]}")
                    bad, err = compare(torch, got[:3], want[:3],
                                       k.numel() if sentinel else got[3])
                    bad_case += bad
                    yield fn.__name__, bad, err
        print(json.dumps({"agg_layout": case, "n": n, "runs": len(lens),
                          "lo": lo, "hi": hi, "mismatches": bad_case}),
              flush=True)


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


def check_count_dump(path: str, reads, k: int, what: str):
    """Compare a --count dump with the numpy oracle; returns the oracle's
    (keys, counts) of every distinct k-mer."""
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
    return keys, counts


def check_unique_dump(path: str, reads, k: int, what: str):
    """Compare a --unique dump with the numpy oracle; returns the oracle's
    records (u32 keys, read numbers, positions) in scan order."""
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
    return ((can[at] & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            rid[at].astype(np.uint32), pos[at].astype(np.uint32))


def run_parsefastq(argv, cwd: str, main=None):
    """parsefastq's ``main`` (this tree's by default) in ``cwd`` (where it
    writes its histograms); returns (rc, stdout, stderr, wall s)."""
    import contextlib
    import io
    if main is None:
        from kmerutils_tpu_torch.cli import parsefastq
        main = parsefastq.main
    out, err = io.StringIO(), io.StringIO()
    here = os.getcwd()
    os.chdir(cwd)
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = main(argv)
        wall = time.perf_counter() - t0
    finally:
        os.chdir(here)
    print(f"parsefastq {' '.join(argv[2:])}: rc {rc} in {wall:.3f} s | "
          + out.getvalue().strip().replace("\n", " | ")
          + (" | stderr: " + err.getvalue().strip() if err.getvalue()
             else ""), flush=True)
    return rc, out.getvalue(), err.getvalue(), wall


@contextlib.contextmanager
def counted_calls(module, name: str):
    """``module.name`` replaced, inside the block, by a wrapper that counts
    its calls in the list yielded (callers look the name up at each
    call)."""
    calls, real = [0], getattr(module, name)

    def counted(*args, **kw):
        calls[0] += 1
        return real(*args, **kw)
    setattr(module, name, counted)
    try:
        yield calls
    finally:
        setattr(module, name, real)


def counting_runs(torch, rng, tmp: str, card: str, dev,
                  n_reads: int = 10_000, genome_len: int = 4_600_000,
                  spill_reads: int = 2_000, spill_capacity: int = 4194304,
                  spill_batch_reads: int = 64):
    phase("8 the counting slice: parsefastq on cuda")
    from kmerutils_tpu_torch.count import stream
    from kmerutils_tpu_torch.ops import count_prefix as KC
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
    KC.launches_count_prefix = 0
    with counted_calls(stream, "batch_entries") as calls:
        rc, _, err, wall = run_parsefastq(base + ["--count", "-s", "16"],
                                          tmp)
    launches = {"K3": M.launches_fold, "K4": M.launches_aggregate,
                "K5": M.launches_merge, "K6": M.launches_compact,
                "KC": KC.launches_count_prefix}
    # -----------------------------------------------------------------------
    print(f"launches on the --count -s 16 path: {launches}, batch_entries "
          f"calls {calls[0]}", flush=True)
    check(rc == 0 and "WARNING" not in err, "--count -s 16 failed or dropped")
    for name in ("K3", "K4", "K5"):
        check(launches[name] > 0, f"{name} was not launched on the CLI path")
    check(launches["KC"] == calls[0] > 0,
          f"KC launched {launches['KC']} times for {calls[0]} batches")
    oracle16 = check_count_dump(fq + ".multi_kmer.bin", reads, 16,
                                "--count -s 16")

    KC.launches_count_prefix = 0
    with counted_calls(stream, "batch_entries") as calls:
        rc, _, err, _ = run_parsefastq(base + ["--unique", "-s", "21"], tmp)
    launches["KC_unique21"] = KC.launches_count_prefix
    print(f"KC launches on the --unique -s 21 path: "
          f"{KC.launches_count_prefix} for {calls[0]} batches", flush=True)
    check(rc == 0 and "WARNING" not in err, "--unique -s 21 failed or dropped")
    check(KC.launches_count_prefix == calls[0] > 0,
          f"KC launched {KC.launches_count_prefix} times for {calls[0]} "
          "batches on --unique -s 21")
    unique21 = check_unique_dump(fq + ".once_kmer.bin", reads, 21,
                                 "--unique -s 21")

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
                      "mbases": mbases, "distinct_16mers": oracle16[0].size,
                      "mbases_per_s": [mbases / w for w in walls],
                      "card": card}), flush=True)
    return launches, reads, walls, oracle16, unique21


# ---------------------------------------------------------------------------
# phase 9: K7 and the exact-counting path
# ---------------------------------------------------------------------------

PALINDROMES = ["GGG" + "T" * 16 + "A" * 16 + "CCCCC",
               "C" + "A" * 16 + "T" * 16 + "GG"]


def live_layouts(rng, tile: int):
    """Adversarial liveness of K7 around its tile of ``tile`` entries:
    (name, bool mask, True where the entry is live)."""
    T = tile

    def at(n, live_at):
        m = np.zeros(n, bool)
        m[live_at] = True
        return m

    cases = [("n=1 live", np.ones(1, bool)), ("n=1 dead", np.zeros(1, bool))]
    for n in (T - 1, T, T + 1):
        cases.append((f"n={n}, half live", rng.random(n) < 0.5))
    n = 3 * T + T // 2
    cases.append(("all live", np.ones(n, bool)))
    cases.append(("all dead", np.zeros(n, bool)))
    # a look-back through 40 tiles whose aggregates are all 0
    cases.append(("40 all-dead tiles, then one live entry",
                  at(40 * T + 1, [40 * T])))
    n = 5 * T + T // 3
    cases.append(("live only at each tile's first slot",
                  at(n, np.arange(0, n, T))))
    cases.append(("live only at each tile's last slot",
                  at(n, np.append(np.arange(T - 1, n, T), n - 1))))
    n = 4 * T + 100
    cases.append(("live only in the last tile",
                  at(n, 4 * T + np.flatnonzero(rng.random(100) < 0.5))))
    cases.append(("alternating", np.arange(3 * T + 17) % 2 == 0))
    for frac in (0.1, 0.5, 0.9):
        cases.append((f"{frac:.0%} live over 3.5 tiles",
                      rng.random(3 * T + T // 2) < frac))
    return cases


def live_words(rng, live, narr: int):
    """narr int32 numpy arrays for the liveness mask ``live``: the first
    word random but never all ones where live, all ones where dead; the
    others random over the whole u32 range."""
    n = live.size
    first = rng.integers(0, 0xFFFFFFFF, size=n, dtype=np.uint64)
    first[~live] = 0xFFFFFFFF
    rest = [rng.integers(0, 1 << 32, size=n, dtype=np.uint64)
            for _ in range(narr - 1)]
    return [w.astype(np.uint32).view(np.int32) for w in (first, *rest)]


def k7_check(torch, arrs, what: str):
    """K7 vs its plain version on ``arrs``: (mismatching entries, max |diff|
    of the u32 words); fails on any difference or another n_live."""
    from kmerutils_tpu_torch.ops import merge as M
    got, n = M.compact_live(arrs)
    want, n_ref = M.compact_live_ref(arrs)
    sync(torch, arrs[0].device)
    check(n == n_ref, f"K7 n_live {n} != {n_ref} ({what})")
    bad, err = compare(torch, got, want, arrs[0].numel())
    check(bad == 0, f"K7 != plain ({what}): {bad} mismatches")
    return bad, err


def k7_layout_checks(torch, rng, dev="cuda"):
    """K7 against its plain version at every layout of live_layouts, with 1
    and 5 arrays, and with 2-4 arrays at the all-dead chain; one JSON line
    per layout."""
    from kmerutils_tpu_torch.ops import merge as M
    for name, live in live_layouts(rng, M.LIVE_TILE):
        counts = (1, 2, 3, 4, 5) if name.startswith("40 all-dead") else (1, 5)
        for narr in counts:
            arrs = tuple(torch.from_numpy(w).to(dev)
                         for w in live_words(rng, live, narr))
            k7_check(torch, arrs, f"{name}, {narr} arrays")
        print(json.dumps({"live_layout": name, "n": int(live.size),
                          "n_live": int(live.sum()), "arrays": counts,
                          "mismatches": 0}), flush=True)


def k7_profile(torch, fn, iters: int = 10) -> dict:
    """``iters`` calls of ``fn`` (a compact_live wrapper) under
    torch.profiler, cut into calls at the device-to-host copy that ends
    each one (its n_live): device ms per call, in all and in kernels, and
    kernels per call by name, memsets and copies per call, over the last
    half of the calls.  The profiler on the H100 machines can lose the
    first device events of a session late in a long process (one to a
    few, seen in every session of a ``--baseline`` run), so the first
    calls are not counted.  A session can also lose all its device events
    (seen in phase 9 of whole runs): such a session is run again,
    at most twice, as profile_sketch.profile does."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        calls, cur = [], []
        for ev in sorted((ev for ev in prof.events()
                          if ev.device_type == DeviceType.CUDA),
                         key=lambda ev: ev.time_range.start):
            cur.append(ev)
            if ev.name.startswith("Memcpy"):
                calls.append(cur)
                cur = []
        calls = calls[-(iters // 2):]
        if len(calls) == iters // 2:
            break
        print(f"the profiler kept {len(calls)} K7 calls of {iters} "
              f"(session {attempt + 1}); profiling again", flush=True)
    check(len(calls) == iters // 2, f"the profiler kept {len(calls)} K7 "
          f"calls of {iters}")
    us = {"kernel": 0.0, "memset": 0.0, "copy": 0.0}
    count = {"kernel": 0, "memset": 0, "copy": 0}
    names = {}
    for ev in (ev for call in calls for ev in call):
        kind = ("memset" if ev.name.startswith("Memset") else
                "copy" if ev.name.startswith("Memcpy") else "kernel")
        us[kind] += ev.time_range.elapsed_us()
        count[kind] += 1
        if kind == "kernel":
            names[short_name(ev.name)] = names.get(short_name(ev.name), 0) + 1
    n = len(calls)
    return {"device_ms": sum(us.values()) / 1e3 / n,
            "kernel_ms": us["kernel"] / 1e3 / n,
            "kernels_per_call": count["kernel"] / n,
            "memsets_per_call": count["memset"] / n,
            "copies_per_call": count["copy"] / n,
            "kernels": {k: v / n for k, v in names.items()}}


def live_arrays(gen, n: int, narr: int, frac: float, dev="cuda"):
    """narr int32 arrays of n entries made on ``dev`` from the generator
    ``gen``: a share ``frac`` of live entries (first word not all ones,
    values over the whole u32 range), the rest dead (first word -1)."""
    import torch
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
    import torch
    from kmerutils_tpu_torch.count import exact
    kd = exact.count_batch_detailed(batch, k)
    return ((kd[1] - 1).contiguous(), kd[0].to(torch.int32),
            (kd[0] >> 32).to(torch.int32), kd[2].contiguous(),
            kd[3].contiguous())


def k7_synthetic(torch, gen, n_syn: int = 64 << 20):
    """Phase 9's six 64 Mi-entry shapes: (description, arrays on the card
    made from ``gen``), one at a time."""
    for narr in (1, 5):
        for frac in (0.1, 0.5, 0.9):
            yield (f"{n_syn} entries x {narr} arrays, {frac:.0%} live",
                   live_arrays(gen, n_syn, narr, frac))


def k7_stress(torch, arrs, what: str, calls: int = 100) -> None:
    """``calls`` K7 calls on the same arrays, each output held to the plain
    version's."""
    from kmerutils_tpu_torch.ops import merge as M
    want, n_ref = M.compact_live_ref(arrs)
    bad = 0
    for _ in range(calls):
        got, n = M.compact_live(arrs)
        bad += int(n != n_ref or not all(torch.equal(g, w)
                                         for g, w in zip(got, want)))
    print(f"K7 stress, {what}: {calls} calls, {bad} differ from the plain "
          f"version", flush=True)
    check(bad == 0, f"K7 stress at {what}: {bad} of {calls} calls differ")


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


def k7_and_exact(torch, rng, card: str, bounds: Bounds, dev="cuda",
                 bench=(1024, 6000)):
    phase("9 K7 vs plain (exact) and the exact-counting path")
    from kmerutils_tpu_torch.base.sequence import pack_ascii_reads, pack_codes
    from kmerutils_tpu_torch.count import exact
    from kmerutils_tpu_torch.ops import merge as M
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    res = {"mismatches": 0, "max_abs_err": 0, "shapes": []}
    k7_layout_checks(torch, rng, dev)

    def record(arrs, what):
        bad, err = k7_check(torch, arrs, what)
        ms, pms, runs = turns(torch, lambda: M.compact_live(arrs),
                              lambda: M.compact_live_ref(arrs))
        prof = k7_profile(torch, lambda: M.compact_live(arrs))
        check(prof["kernels_per_call"] == 1 and prof["memsets_per_call"] == 1,
              f"K7 at {what}: {prof['kernels']} kernels and "
              f"{prof['memsets_per_call']} memsets per call, want 1 and 1")
        res["mismatches"] += bad
        res["max_abs_err"] = max(res["max_abs_err"], err)
        # bytes: every array read once and written once (live entries,
        # then the all-ones tail); the library call is the plain version's
        # boolean-mask indexing
        bound = bounds.bytes(8 * arrs[0].numel() * len(arrs))[0]
        res["shapes"].append({"shape": what, "ms": ms, "plain_ms": pms,
                              "bound_ms": bound,
                              "device_ms": prof["device_ms"]})
        print(json.dumps({"timing": "compact_live", "shape": what,
                          "mismatches": bad, "ms_plain_kern_kern_plain": runs,
                          "profile": prof, "bound_ms": bound, "card": card}),
              flush=True)
        return ms, pms

    for what, arrs in k7_synthetic(torch, gen):
        record(arrs, what)
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
    arrs = exact_path_arrays(bench)
    what = (f"count_batch_detailed k=21 bench batch ({arrs[0].numel()} "
            f"entries, {distinct} live) x 5 arrays")
    ms, pms = record(arrs, what)
    res.update(ms=ms, plain_ms=pms, launches=launches,
               bound_ms=res["shapes"][-1]["bound_ms"],
               device_ms=res["shapes"][-1]["device_ms"])
    k7_stress(torch, arrs, what)
    chain = dict(live_layouts(rng, M.LIVE_TILE))[
        "40 all-dead tiles, then one live entry"]
    k7_stress(torch, tuple(torch.from_numpy(w).to(dev)
                           for w in live_words(rng, chain, 5)),
              "40 all-dead tiles, then one live entry, 5 arrays")
    return res


def k7_against_baseline(torch, rng, card: str, bounds: Bounds,
                        order) -> None:
    """K7 of the baseline tree (imported as baseline_port) and of this tree
    through their public wrappers at phase 9's seven timed shapes: both
    equal to the plain version, then CUDA-event ms and profiler device ms
    in turns."""
    from kmerutils_tpu_torch.ops import merge as M
    mods = {"baseline": importlib.import_module("baseline_port.ops.merge"),
            "this": M}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)

    def shapes():
        yield from k7_synthetic(torch, gen)
        arrs = exact_path_arrays(random_batch(rng, 1024, 6000))
        yield "count_batch_detailed k=21 bench batch x 5 arrays", arrs

    for what, arrs in shapes():
        want, n_ref = M.compact_live_ref(arrs)
        fns = {k: functools.partial(mod.compact_live, arrs)
               for k, mod in mods.items()}
        for k, fn in fns.items():
            got, n = fn()
            torch.cuda.synchronize()
            check(n == n_ref and all(torch.equal(g, w)
                                     for g, w in zip(got, want)),
                  f"compact_live at {what}: {k} kernel != plain")
            del got
        res = {k: {"ms": [], "device_ms": []} for k in fns}
        for k in order:
            res[k]["ms"].append(cuda_ms(torch, fns[k], 10))
        for k in order:
            res[k]["device_ms"].append(
                k7_profile(torch, fns[k])["device_ms"])
        print(json.dumps({"timing": "compact_live", "shape": what,
                          "n_live": n_ref, **res,
                          "bound_ms": bounds.bytes(
                              8 * arrs[0].numel() * len(arrs))[0],
                          "card": card}), flush=True)
        del want, fns, arrs
        torch.cuda.empty_cache()
    # the exact-counting path's densify of the bench batch through each
    # tree's count/exact.py (K7, then the live prefix to the host)
    batch = random_batch(rng, 1024, 6000)
    mods = {"baseline": importlib.import_module(
        "baseline_port.count.exact"), "this": importlib.import_module(
        "kmerutils_tpu_torch.count.exact")}
    kd = mods["this"].count_batch_detailed(batch, 21)
    res = {k: [] for k in mods}
    for k in order:
        res[k].append(cuda_ms(torch, lambda: mods[k].compact_detailed(
            *kd[:4]), 10))
    print(json.dumps({"timing": "compact_detailed_k21_bench", **res,
                      "card": card}), flush=True)


# ---------------------------------------------------------------------------
# phase 10: block mode, ann and the whole-collection sketch
# ---------------------------------------------------------------------------

def plain_blocks(torch, codes_list, k: int, m: int, bs: int, dev):
    """Per read, its live blocks' signatures (u32[n_live, m]) through the
    plain path on the card: the plain prefix, per-block plain weights
    stage, plain tournament (k <= 16)."""
    from kmerutils_tpu_torch.base.sequence import pack_codes
    from kmerutils_tpu_torch.ops import tournament as T
    from kmerutils_tpu_torch.ops import weights as KW
    L = max(c.size for c in codes_list)
    codes = np.zeros((len(codes_list), L), np.uint8)
    for i, c in enumerate(codes_list):
        codes[i, : c.size] = c
    batch = pack_codes(codes, np.array([c.size for c in codes_list],
                                       np.int32), device=dev)
    items, valid = plain_hashed(batch, k)
    n, P = items.shape
    nb = -(-P // bs)
    pad = torch.nn.functional.pad
    items = pad(items, (0, nb * bs - P)).reshape(n * nb, bs)
    valid = pad(valid, (0, nb * bs - P)).reshape(n * nb, bs)
    s, winv, is_real = KW.sort_weights_ref(items, valid)
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


def datasketcher_main():
    from kmerutils_tpu_torch.cli import datasketcher
    return datasketcher.main


def cli_profile(main, argv) -> dict:
    """``main(argv)`` (a datasketcher entry point) run under
    torch.profiler (profile_sketch.profile: one warm run, one timed with
    CUDA events, one profiled): its event ms, the device ms of all its
    kernels and of the tournament kernels."""
    from kmerutils_tpu_torch.profile_sketch import profile

    def run():
        check(main(argv) == 0, f"datasketcher {' '.join(argv)} failed")
    p = profile(run, 1)
    return {"event_ms": p["event_ms_per_call"],
            "device_ms": p["device_ms_per_call"],
            "tournament_device_ms": p["family_ms_per_call"].get(
                "tournament", 0.0)}


def datasketcher_run(argv, what: str):
    t0 = time.perf_counter()
    rc = datasketcher_main()(argv)
    wall = time.perf_counter() - t0
    print(f"{what}: rc {rc} in {wall:.3f} s", flush=True)
    check(rc == 0, f"{what} returned non-zero")
    return wall


def rest_of_datasketcher(torch, rng, tmp: str, card: str, dev, fq8: str,
                         clean8, bounds: Bounds, n_block_ann: int = 1000,
                         m: int = 200,
                         bench=(1024, 6000)):
    phase("10 the rest of datasketcher on cuda: -b, ann, block ann, "
          "sketch_collection")
    from kmerutils_tpu_torch.io import formats
    from kmerutils_tpu_torch.ops import tournament as T
    from kmerutils_tpu_torch.sketch.jaccard import Sketcher
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
    batch = random_batch(rng, *bench)
    sk = Sketcher(SeqSketcherParams(kmer_size=21, sketch_size=m))
    T.launches_u64 = 0
    got = sk.sketch_collection(batch)
    k2 = T.launches_u64
    args, distinct = collection_row(torch, batch)
    plo, phi = T.weighted_tournament_u64_ref(*args, m)
    want = (phi[0].to(torch.int64) << 32) | (plo[0].to(torch.int64)
                                             & 0xFFFFFFFF)
    sync(torch, dev)
    check(k2 == 1, f"K2 launched {k2} times by sketch_collection, want 1")
    check(torch.equal(got, want), "sketch_collection != plain path")
    kern = tournament_fn(T, args, m)
    ms, pms, runs = turns(torch, kern, tournament_fn(T, args, m, plain=True),
                          iters=3, plain_iters=1)
    bound = bounds.tournament(args, m)
    out.update(collection_distinct=distinct,
               collection_k2_bound_ms=bound[0],
               collection_k2_bound_by=bound[1],
               collection_ms=cuda_ms(torch,
                                     lambda: sk.sketch_collection(batch), 3),
               collection_k2_ms=ms, collection_k2_plain_ms=pms,
               collection_k2_runs=runs,
               collection_k2_enqueue_ms=enqueue_ms(torch, kern))
    # -b 512 again, profiled: the tournament kernels' share of its device
    # time (the counted run above stays unprofiled)
    out["block_profile"] = cli_profile(
        datasketcher_main(), base + ["-b", "512", "-d", bdump])
    print(json.dumps({"timing": "phase10", **out}), flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 11: the other five sketch families and their grid kernels G1 / G2
# ---------------------------------------------------------------------------

G1_SOURCE = "kmerutils_tpu_torch/csrc/sketch.cu"
# the JAX package's fused grid reductions that G1 / G2 stand for (no
# Pallas kernel: XLA fuses them)
G1_JAX = "kmerutils_tpu/sketch/superminhash.py:95"
G2_JAX = "kmerutils_tpu/sketch/setsketch.py:58"
FAMILIES = ("SUPER", "SUPER2", "OPTDENS", "REVOPTDENS", "HLL")


class plain_kernels:
    """Within the block, every kernel wrapper of the sketch path (K1, K2,
    G1, G2, KP) runs its plain version on the card: the plain path."""

    def __enter__(self):
        from kmerutils_tpu_torch.ops import kmer_prefix as KP
        from kmerutils_tpu_torch.ops import sketch_grid as G
        from kmerutils_tpu_torch.ops import tournament as T
        self.saved = [(mod, name, getattr(mod, name)) for mod, name in (
            (T, "weighted_tournament"), (T, "weighted_tournament_u64"),
            (G, "grid_min"), (G, "grid_max"), (KP, "kmer_prefix"))]
        for mod, name, _ in self.saved:
            setattr(mod, name, getattr(mod, name + "_ref"))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def grid_args(torch, items, valid, m: int, seed: int = 0):
    """The inputs superminhash2 gives G1 and setsketch_signatures gives
    G2."""
    from kmerutils_tpu_torch.sketch import setsketch, superminhash
    return (superminhash.grid_min_args(items, valid, m, seed),
            setsketch.grid_max_args(items, valid, m, seed))


def grid_case(torch, G, name: str, args, what: str) -> int:
    """G1 ("grid_min") or G2 on args against its plain version: fails on
    any difference; returns the max |difference| (0)."""
    got = getattr(G, name)(*args)
    want = getattr(G, name + "_ref")(*args)
    torch.cuda.synchronize()
    bad = int((got != want).sum())
    err = max_abs_err(got, want)
    print(f"{name} at {what}: {tuple(args[0].shape)} x m={args[-1].numel()}"
          f", {bad} mismatches", flush=True)
    check(bad == 0, f"{name} != plain at {what}")
    return err


def random_items(torch, rng, n: int, P: int, wide: bool,
                 few: bool = False):
    """Random items with half of them >= 2^31 (u32) or >= 2^63 (u64), a
    valid mask with (when n > 1) all-invalid rows and a row of one valid
    position; with ``few``, row r holds 1 + r % 3 valid positions at random
    places instead."""
    if wide:
        a = rng.integers(0, 1 << 64, size=(n, P), dtype=np.uint64)
        items = torch.from_numpy(a.view(np.int64)).cuda()
    else:
        a = rng.integers(0, 1 << 32, size=(n, P), dtype=np.uint64)
        items = torch.from_numpy(a.astype(np.uint32).view(np.int32)).cuda()
    if few:
        v = np.zeros((n, P), bool)
        for r in range(n):
            v[r, rng.choice(P, size=1 + r % 3, replace=False)] = True
    else:
        v = rng.random((n, P)) < 0.9
    if n > 1 and not few:
        v[::7] = False
        v[1] = False
        v[1, P // 2] = True
    return items, torch.from_numpy(v).cuda()


def on_floor_boundary(torch, h, p):
    """For u32 hashes h (int64 on the CPU): whether HLL's float32 value
    before the floor (setsketch.prefloor) lies within 2 ulp of an integer
    on the CPU or on the card, and those values on each."""
    from kmerutils_tpu_torch.sketch import setsketch
    edge = torch.zeros(h.shape, dtype=torch.bool)
    vals = {}
    for dev in ("cpu", "cuda"):
        v = vals[dev] = setsketch.prefloor(h.to(dev), p).cpu()
        ulp = torch.nextafter(v.abs(), torch.tensor(float("inf"))) - v.abs()
        edge |= (v - v.round()).abs() <= 2 * ulp
    return edge, vals


def hll_agree(torch, card, cpu, h_best, m: int, what: str) -> int:
    """HLL registers from the card against the same from the CPU (which
    the tests hold to the JAX package): a register may differ only by one
    and where the float32 value before the floor lies within 2 ulp of an
    integer on either device; ``h_best()`` gives the exact largest hashes
    [n, m] behind them.  Returns the number of differing registers."""
    from kmerutils_tpu_torch.sketch import setsketch
    bad = card != cpu
    n_bad = int(bad.sum())
    if n_bad:
        h = (h_best().cpu().to(torch.int64) & 0xFFFFFFFF)[bad]
        edge, vals = on_floor_boundary(torch, h,
                                       setsketch.SetSketchParams(m=m))
        for i in range(min(n_bad, 8)):
            print(f"HLL at {what}: register card {int(card[bad][i])} CPU "
                  f"{int(cpu[bad][i])}, hash {int(h[i]):#010x}, value "
                  f"before the floor CPU {float(vals['cpu'][i]):.9g} card "
                  f"{float(vals['cuda'][i]):.9g}, on a boundary "
                  f"{bool(edge[i])}", flush=True)
        check(bool(edge.all()) and int((card[bad] - cpu[bad]).abs().max())
              <= 1, f"HLL at {what}: the card's registers differ from the "
              f"CPU's away from a float32 floor boundary")
    print(f"HLL at {what}, card vs CPU: {n_bad} of {card.numel()} registers "
          f"differ, each on a float32 floor boundary", flush=True)
    return n_bad


def hll_card_vs_cpu(torch, batch, k: int, m: int, what: str,
                    collection: bool = False) -> int:
    """The whole HLL ``Sketcher.sketch_batch`` (and ``sketch_collection``)
    of a batch on the card against the same on the CPU, under
    :func:`hll_agree`'s rule.  Returns the number of differing
    registers."""
    from kmerutils_tpu_torch.ops import sketch_grid as G
    from kmerutils_tpu_torch.sketch import setsketch
    from kmerutils_tpu_torch.sketch.jaccard import Sketcher, hashed_kmers
    from kmerutils_tpu_torch.sketch.params import SeqSketcherParams, SketchAlgo
    sk = Sketcher(SeqSketcherParams(kmer_size=k, sketch_size=m,
                                    algo=SketchAlgo.HLL))
    host = batch.to("cpu")

    @functools.lru_cache(maxsize=1)
    def h_best():
        items, valid = hashed_kmers(host, k)
        return G.grid_max(*setsketch.grid_max_args(items, valid, m))

    n_bad = hll_agree(torch, sk.sketch_batch(batch).cpu(),
                      sk.sketch_batch(host), h_best, m,
                      f"{what}, k={k}, sketch_batch")
    if collection:
        n_bad += hll_agree(
            torch, sk.sketch_collection(batch).cpu()[None],
            sk.sketch_collection(host)[None],
            lambda: (h_best().to(torch.int64) & 0xFFFFFFFF).amax(
                dim=0, keepdim=True), m, f"{what}, k={k}, sketch_collection")
    return n_bad


def hll_whole_checks(torch, rng, bench, m: int = 200) -> int:
    """:func:`hll_card_vs_cpu` at the bench shape and on a ragged batch
    (200 reads of 5-1000 bases, sketch_collection too), k=8 and k=21.
    Short reads give registers whose value before the floor lies where
    the CPU's and the card's float32 log differ by an ulp now and then, so
    the rule is exercised.  Returns the number of differing registers."""
    from kmerutils_tpu_torch.base.sequence import pack_codes
    codes = rng.integers(0, 4, size=(200, 1000), dtype=np.uint8)
    lens = rng.integers(5, 1000, size=200).astype(np.int32)
    ragged = pack_codes(codes, lens, device="cuda")
    n_bad = 0
    for k in (8, 21):
        n_bad += hll_card_vs_cpu(torch, bench, k, m, "the bench shape")
        n_bad += hll_card_vs_cpu(torch, ragged, k, m, "a ragged batch",
                                 collection=True)
    return n_bad


def grid_timed_shapes(torch, bench, m: int = 200):
    """(name, G1's inputs, G2's inputs) at phase 11's timed shapes: the
    bench batch at k=8 and k=21 (every 97th row from the 6th all-invalid)
    and sketch_collection's one row (k=21)."""
    for k in (8, 21):
        items, valid = plain_hashed(bench, k)
        valid = valid.clone()
        valid[5::97] = False
        yield (f"bench_k{k}", *grid_args(torch, items, valid, m))
    items, valid = plain_hashed(bench, 21)
    yield ("collection_k21", *grid_args(torch, items.reshape(1, -1),
                                        valid.reshape(1, -1), m))


GRID_TIMED = ("bench_k8", "bench_k21", "collection_k21")
# (m, rows, positions) of phase 11's exact-only G1 / G2 checks: a slot set
# of one slot, of 13, of 129 (nbits 8: about half of the pairs walk, some
# to the clamp), around 200 and 256 (slot sets that are not a multiple of
# G1's slots a thread or of a warp), 1000 and 4096 (two slot groups of G1);
# 2000 positions (not a multiple of the staging chunk), one position a row,
# and one split row; then (m, rows, positions, few) of G2's chunk and last
# shared load: whole rows (rows enough that the plan splits none on a card
# of 132 SMs, _WANT_TILES x 132) of 2047 and 2049 positions around its
# 2048-position chunk, and rows of 1-3 valid positions (random_items' few)
GRID_CHECKS = tuple((mm, 64, 2000) for mm in (1, 13, 129, 199, 200, 201, 257,
                                              1000, 4096)) + (
    (200, 5, 1), (129, 1, 300_000))
GRID_TAIL_CHECKS = ((200, 4224, 2047, False), (200, 4224, 2049, False),
                    (200, 64, 2000, True), (4096, 64, 2000, True))
# (rows, positions) of G1's exact checks at the rows of the SUPER2 cell
# (k=21, m=1000, u64 items of length-sorted reads, ont_super2_k21_resident):
# its median batch, its widest row of a full batch, its longest rows and
# its shortest, whose rows the plan splits over 3, 5, 9 and 2 spans on a
# card of 132 SMs; G1 is timed at the first of them (GRID_CELL_TIMED)
GRID_CELL_M = 1000
GRID_CELL_CHECKS = ((1600, 5232), (1024, 8172), (512, 16364), (4096, 2028))
GRID_CELL_TIMED = "cell_k21_m1000"


def grid_cell_args(torch, rng, n: int, P: int, k: int = 21,
                   m: int = GRID_CELL_M, dev="cuda"):
    """G1's inputs at one of the SUPER2 cell's rows: n random reads of
    P + k - 1 bases at most, the first full and each at least three
    quarters of that (a length-sorted batch), through KP's u64 k-mer hash
    (its first P positions) and ``superminhash.grid_min_args``."""
    from kmerutils_tpu_torch.sketch import superminhash
    from kmerutils_tpu_torch.sketch.jaccard import hashed_kmers
    L = P + k - 1
    lens = rng.integers(L * 3 // 4, L + 1, size=n).astype(np.int32)
    lens[0] = L
    items, valid = hashed_kmers(kp_batch(rng, n, L, lens.tolist(), dev), k)
    # KP's rows end on a whole word: the positions past P hold no k-mer
    check(items.shape[1] >= P and items.dtype == torch.int64
          and not bool(valid[:, P:].any()),
          f"the cell's row {n} x {P}: items {tuple(items.shape)} "
          f"{items.dtype}, a valid k-mer past position {P}")
    return superminhash.grid_min_args(items[:, :P].contiguous(),
                                      valid[:, :P].contiguous(), m)


def grid_kernels_vs_plain(torch, rng, card: str, bench, m: int = 200):
    """G1 / G2 exact at every checked shape, G1 at the SUPER2 cell's rows;
    timed at the bench shape (k=8 and k=21) and sketch_collection's row,
    G1 at the cell's median batch.  Returns the kernels' numbers."""
    from kmerutils_tpu_torch import _build, roofline as rl
    from kmerutils_tpu_torch.ops import sketch_grid as G
    ipp = rl.grid_instructions_per_pair(_build.library_path())
    for k, r in ipp.items():
        print(f"SASS {k}: inner loop {r['instructions']} instructions for "
              f"{r['draws']} pairs; per pair by pipe "
              f"{json.dumps(r['pipes_per_draw'])}", flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = rl.sm_clock_hz()
    err = {"grid_min": 0, "grid_max": 0}

    def both(g1, g2, what):
        err["grid_min"] = max(err["grid_min"],
                              grid_case(torch, G, "grid_min", g1, what))
        err["grid_max"] = max(err["grid_max"],
                              grid_case(torch, G, "grid_max", g2, what))

    timed = {}
    for shape, g1, g2 in grid_timed_shapes(torch, bench, m):
        both(g1, g2, shape)
        timed[shape] = {"grid_min": g1, "grid_max": g2}
    for i, (n, P) in enumerate(GRID_CELL_CHECKS):
        g1 = grid_cell_args(torch, rng, n, P)
        spans = G.launch_plan(g1[0].device, n, P, GRID_CELL_M,
                              G.G1_SLOTS_PER_THREAD).spans
        print(f"the SUPER2 cell's row {n} x {P}: G1's plan splits it over "
              f"{spans} spans", flush=True)
        err["grid_min"] = max(err["grid_min"], grid_case(
            torch, G, "grid_min", g1, f"the SUPER2 cell's row {n} x {P}, "
            f"k=21 u64 items"))
        if i == 0:
            timed[GRID_CELL_TIMED] = {"grid_min": g1}
        del g1
    for mm, n, P, few in tuple((*c, False) for c in GRID_CHECKS) \
            + GRID_TAIL_CHECKS:
        for wide in (False, True):
            items, valid = random_items(torch, rng, n, P, wide, few)
            g1, g2 = grid_args(torch, items, valid, mm, seed=7)
            what = f"m={mm} {'u64' if wide else 'u32'} items" + (
                ", 1-3 valid positions a row" if few else "")
            if (mm, n, P, few) in GRID_TAIL_CHECKS and not few:
                check(G.launch_plan(valid.device, n, P, mm,
                                    G.G2_SLOTS_PER_THREAD).spans == 1,
                      f"the plan splits the rows of {n} x {P}")
            if mm == 129:           # the four-walk clamp must fire here
                walks = rl.walk_stats(g1[1], g1[2], g1[3], mm)
                print(f"{what}, {n} x {P}: {walks['rounds']} walk rounds, "
                      f"{walks['clamped']} pairs clamped", flush=True)
                check(walks["clamped"] > 0, f"no clamped pair at {what}")
            both(g1, g2, what)
            del g1, g2, items, valid
    out = {}
    for shape, calls in timed.items():
        for name, args in calls.items():
            kern = functools.partial(getattr(G, name), *args)
            plain = functools.partial(getattr(G, name + "_ref"), *args)
            ms, pms, runs = turns(torch, kern, plain, iters=10, plain_iters=1)
            ops, nbytes = rl.grid_work(name, args)
            bound = rl.bound(nbytes, ops, sms, clock)
            mm = args[-1].numel()
            pairs = int(args[-2].sum()) * mm
            r = {"ms": ms, "plain_ms": pms, "bound_ms": bound[0],
                 "bound_by": bound[1], "alu_floor_ms": rl.alu_floor_ms(
                     pairs, sms, clock) if name == "grid_max" else None,
                 "runs": runs,
                 "enqueue_ms": enqueue_ms(torch, kern),
                 "ops_per_pair": ops / pairs,
                 "sass_bound_ms": rl.issue_ms(
                     pairs * ipp[name]["instructions_per_draw"], sms,
                     clock)}
            out.setdefault(name, {})[shape] = r
            print(json.dumps({"timing": f"{name}_{shape}",
                              "rows": args[0].shape[0],
                              "P": args[0].shape[1], "m": mm, **r,
                              "bound_share": bound[0] / ms,
                              "card": card}), flush=True)
        del calls
    timed.clear()
    torch.cuda.empty_cache()
    for name in out:
        out[name]["max_abs_err"] = err[name]
        out[name]["sass_per_pair"] = ipp[name]["instructions_per_draw"]
        out[name]["sass_pipes_per_pair"] = ipp[name]["pipes_per_draw"]
    return out


def family_dump_check(torch, rng, dump: str, clean, algo: str, m: int,
                      k: int, dev) -> None:
    """A ``-a algo`` dump read back: header and shape; then 64 sampled
    reads sketched on the card through the kernels and through the plain
    path (every kernel replaced by its plain version), and read by read on
    the CPU (which the tests hold to the JAX package).  The card's
    signatures, before any cast, equal the plain path's and the CPU's (HLL
    registers the CPU's under hll_agree's float32 floor-boundary rule), and
    the dump equals them cast as the JAX CLI casts them."""
    from kmerutils_tpu_torch.base.sequence import pack_codes
    from kmerutils_tpu_torch.cli.datasketcher import jax_words
    from kmerutils_tpu_torch.io import formats
    from kmerutils_tpu_torch.ops import sketch_grid as G
    from kmerutils_tpu_torch.sketch import setsketch
    from kmerutils_tpu_torch.sketch.jaccard import Sketcher, hashed_kmers
    from kmerutils_tpu_torch.sketch.params import SeqSketcherParams, SketchAlgo
    kk, mm, sigs = formats.read_signature_dump(dump)
    want_dt = np.uint32 if algo == "SUPER2" else np.uint64
    check((kk, mm) == (k, m) and sigs.shape == (len(clean), m)
          and sigs.dtype == want_dt,
          f"-a {algo} dump holds {sigs.dtype}{sigs.shape}")
    pick = np.sort(rng.choice(len(clean), size=64, replace=False))
    L = max(clean[i].size for i in pick)
    codes = np.zeros((64, L), np.uint8)
    for r, i in enumerate(pick):
        codes[r, : clean[i].size] = clean[i]
    batch = pack_codes(codes, np.array([clean[i].size for i in pick],
                                       np.int32), device=dev)
    algo_e = SketchAlgo(algo)
    sk = Sketcher(SeqSketcherParams(kmer_size=k, sketch_size=m, algo=algo_e))
    card = sk.sketch_batch(batch)
    with plain_kernels():
        plain = sk.sketch_batch(batch)
    torch.cuda.synchronize()
    check(torch.equal(card, plain), f"-a {algo}: the kernels' path != the "
          f"plain path on the card on sampled reads")
    card = card.cpu()
    singles = [pack_codes(clean[i][None], np.array([clean[i].size],
                                                   np.int32), device="cpu")
               for i in pick]
    cpu = torch.cat([sk.sketch_batch(b) for b in singles])
    if algo_e == SketchAlgo.HLL:
        hll_agree(torch, card, cpu, lambda: torch.cat([
            G.grid_max(*setsketch.grid_max_args(*hashed_kmers(b, k), m))
            for b in singles]), m, f"-a {algo}'s 64 sampled reads")
    else:
        check(card.dtype == cpu.dtype and torch.equal(card, cpu),
              f"-a {algo}: the card's signatures != the CPU's on sampled "
              f"reads")
    bad = int((sigs[pick] != jax_words(card.numpy(), algo_e)).sum())
    print(f"-a {algo}: {sigs.shape[0]} reads in the dump, 64 sampled reads: "
          f"the card's {card.dtype} signatures checked against the plain "
          f"path and the CPU, {bad} mismatching dump words", flush=True)
    check(bad == 0, f"-a {algo}: dump != the card's signatures cast as the "
          f"JAX CLI casts them on sampled reads")


def aa_checks(torch, rng, card: str, n: int = 1024, L: int = 2000,
              m: int = 200) -> dict:
    """SketcherAA (all six families) at n x L residues, k = 5 and 9, equal
    to the plain path on the card, and on 64 sampled sequences equal to
    the same sequences sketched on the CPU (which the tests hold to the JAX
    package), before any cast; HLL registers under hll_agree's float32
    floor-boundary rule.  Returns its sketch_batch times."""
    from kmerutils_tpu_torch.aa import kmeraa
    from kmerutils_tpu_torch.ops import sketch_grid as G
    from kmerutils_tpu_torch.sketch import setsketch
    from kmerutils_tpu_torch.sketch.params import SeqSketcherParams, SketchAlgo
    letters = np.frombuffer(kmeraa.alphabet.BASES, np.uint8)
    seqs = [letters[c].tobytes()
            for c in rng.integers(0, 20, size=(n, L))]
    batch = kmeraa.pack_aa_reads(seqs, device="cuda")
    pick = np.sort(rng.choice(n, size=64, replace=False))
    host = kmeraa.pack_aa_reads([seqs[i] for i in pick], device="cpu")
    out = {"hll_registers_differ": 0}
    for k in (5, 9):
        for algo in SketchAlgo:
            sk = kmeraa.SketcherAA(SeqSketcherParams(
                kmer_size=k, sketch_size=m, algo=algo))
            got = sk.sketch_batch(batch)
            with plain_kernels():
                want = sk.sketch_batch(batch)
            torch.cuda.synchronize()
            check(torch.equal(got, want),
                  f"SketcherAA {algo.value} k={k} != plain path")
            card_rows = got[torch.from_numpy(pick).cuda()].cpu()
            cpu = sk.sketch_batch(host)
            what = f"SketcherAA {algo.value} k={k}, 64 sampled sequences"
            if algo == SketchAlgo.HLL:
                out["hll_registers_differ"] += hll_agree(
                    torch, card_rows, cpu, lambda: G.grid_max(
                        *setsketch.grid_max_args(
                            *kmeraa.hashed_kmers_aa(host, k), m)), m, what)
            else:
                check(card_rows.dtype == cpu.dtype
                      and torch.equal(card_rows, cpu),
                      f"{what}: the card's signatures != the CPU's")
            out[f"{algo.value}_k{k}_ms"] = cuda_ms(
                torch, lambda: sk.sketch_batch(batch), 3, warmup=1)
    print(json.dumps({"timing": "sketcher_aa", "sequences": n,
                      "residues": L, "m": m, **out, "card": card}),
          flush=True)
    return out


def sketch_families(torch, rng, tmp: str, card: str, dev, fq8: str, clean8,
                    m: int = 200, bench=(1024, 6000)) -> dict:
    phase("11 the other five families: G1/G2 vs plain, datasketcher -a, "
          "SketcherAA")
    t_phase = time.perf_counter()
    from kmerutils_tpu_torch.ops import sketch_grid as G
    from kmerutils_tpu_torch.sketch.jaccard import Sketcher
    from kmerutils_tpu_torch.sketch.params import SeqSketcherParams, SketchAlgo
    batch = random_batch(rng, *bench)
    out = grid_kernels_vs_plain(torch, rng, card, batch, m)
    out["hll_registers_differ"] = hll_whole_checks(torch, rng, batch, m)
    for k in (8, 21):               # the whole sketch_batch of each family
        for algo in FAMILIES:
            sk = Sketcher(SeqSketcherParams(kmer_size=k, sketch_size=m,
                                            algo=SketchAlgo(algo)))
            out.setdefault("sketch_batch_ms", {})[f"{algo}_k{k}"] = cuda_ms(
                torch, lambda: sk.sketch_batch(batch), 3, warmup=1)
    print(json.dumps({"timing": "sketch_batch_families", "rows": bench[0],
                      "bases": bench[1], "m": m, **out["sketch_batch_ms"],
                      "card": card}), flush=True)
    del batch
    torch.cuda.empty_cache()

    # --- the main path: counts from 0 to what the five CLI runs launched ---
    G.launches_min = G.launches_max = 0
    walls = {}
    for algo in FAMILIES:
        os.makedirs(os.path.join(tmp, "a_" + algo))
        walls[algo] = datasketcher_run(
            ["-f", fq8, "-s", str(m), "-k", "8", "-a", algo, "-d",
             os.path.join(tmp, "a_" + algo, "sigs.bin"), "--device",
             str(dev)], f"datasketcher -a {algo} -k 8")
    launches = {"G1": G.launches_min, "G2": G.launches_max}
    # -----------------------------------------------------------------------
    print(f"launches: G1 {launches['G1']}, G2 {launches['G2']}", flush=True)
    check(launches["G1"] >= 2 and launches["G2"] >= 1,
          "G1 / G2 were not launched by the -a SUPER / SUPER2 / HLL runs")
    for algo in FAMILIES:
        family_dump_check(torch, rng, os.path.join(tmp, "a_" + algo,
                                                   "sigs.bin"),
                          clean8, algo, m, 8, dev)
    mbases = sum(c.size for c in clean8) / 1e6
    print(json.dumps({"timing": "datasketcher_a_k8_wall_s", **walls,
                      "mbases": mbases, "card": card}), flush=True)
    out["aa"] = aa_checks(torch, rng, card)
    out.update(launches=launches, cli_wall_s=walls,
               seconds=time.perf_counter() - t_phase)
    print(f"phase 11: {out['seconds']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 12: bottom-k MinHash, seqminhash, anchors over RESP, the quality
# CLI, shard dispatch and the filters
# ---------------------------------------------------------------------------

ANCHOR_PARAMS = dict(window=1000, overlap=200, nbkmer=16, kmer_size=21)
FILTER_LOG2_SLOTS = 28
FILTER_NB_HASH = 4


def bottomk_checks(torch, rng, card: str, dev, bench=(1024, 6000),
                   m: int = 200) -> dict:
    """sketch_items_invhash (bottomk_sketch of Wang-hashed forward k-mers)
    at the bench shape, k = 21 (u64 hashes) and k = 11 (u32 hashes), and
    bottomk_sketch of raw u64 hashes (half >= 2^63, runs of duplicates,
    all-ones values, all-invalid rows): card equal to CPU; timed with CUDA
    events."""
    from kmerutils_tpu_torch.base import kmer
    from kmerutils_tpu_torch.sketch import minhash
    from kmerutils_tpu_torch.base.sequence import pack_codes
    batch = pack_codes(rng.integers(0, 4, size=bench, dtype=np.uint8),
                       device=dev)
    out = {}
    for k in (21, 11):
        wide = k > 16
        km, valid = (kmer.kmers_u64 if wide else kmer.kmers_u32)(batch, k)

        def fn():
            return minhash.sketch_items_invhash(km, valid, m, wide=wide)
        s, c = fn()
        hs, hc = minhash.sketch_items_invhash(km.cpu(), valid.cpu(), m,
                                              wide=wide)
        check(torch.equal(s.cpu(), hs) and torch.equal(c.cpu(), hc)
              and int(c.sum()) > 0, f"sketch_items_invhash k={k}: card != "
              f"CPU at the bench shape")
        out[f"invhash_k{k}_ms"] = cuda_ms(torch, fn, 5)
    h = torch.from_numpy(rng.integers(0, 1 << 64, size=(512, 4096),
                                      dtype=np.uint64).view(np.int64))
    h[:, 2048:3072] = h[:, :1024]
    h[::5, 17] = -1
    v = torch.from_numpy(rng.random((512, 4096)) < 0.9)
    v[3] = False
    for size in (16, 200, 5000):
        s, c = minhash.bottomk_sketch(h.to(dev), v.to(dev), size)
        hs, hc = minhash.bottomk_sketch(h, v, size)
        check(s.shape == (512, min(size, 4096)) and torch.equal(s.cpu(), hs)
              and torch.equal(c.cpu(), hc),
              f"bottomk_sketch size {size}: card != CPU")
    h, v = h.to(dev), v.to(dev)
    out["bottomk_u64_512x4096_ms"] = cuda_ms(
        torch, lambda: minhash.bottomk_sketch(h, v, 200), 5)
    print(json.dumps({"timing": "bottomk", "rows": bench[0],
                      "bases": bench[1], "m": m, **out, "card": card}),
          flush=True)
    return out


def seqminhash_run(torch, batch, host, k: int, m: int = 200) -> None:
    """Both seqminhash functions over a batch on the card: SuperMinHash
    (through G1) equal to the plain path on the card, bottom-k on 64
    sampled rows equal to the same rows on the CPU (``host``: those rows
    and their indices)."""
    from kmerutils_tpu_torch.sketch import seqminhash as sq
    rows = torch.from_numpy(host[1]).to(batch.device)
    start, end = 100, 4000
    sig = sq.sketch_seqrange_superminhash(batch, start, end, k, m)
    with plain_kernels():
        want = sq.sketch_seqrange_superminhash(batch, start, end, k, m)
    check(torch.equal(sig, want) and bool(torch.isfinite(sig).all()),
          f"seqminhash superminhash k={k}: kernels != plain path")
    hs, hc = sq.sketch_seqrange_minhash(batch, start, end, k, m)
    ws, wc = sq.sketch_seqrange_minhash(host[0], start, end, k, m)
    check(torch.equal(hs[rows].cpu(), ws) and torch.equal(hc[rows].cpu(), wc)
          and int(wc.sum()) > 0, f"seqminhash minhash k={k}: card != CPU on "
          f"64 sampled rows")


def anchors_run(torch, rng, card: str, fq: str, clean, dev) -> dict:
    """anchor_computation over ``fq`` on the card, persisted through the
    port's RespServer on loopback: the anchor count, and 64 sampled anchors
    read back through the wire equal to the same reads anchored on the
    CPU; then both seqminhash functions over a batch of the file.  G1's
    counter is set to 0 just before and read just after.  Returns the
    numbers."""
    from kmerutils_tpu_torch import anchor, kvstore
    from kmerutils_tpu_torch.base.sequence import ReadBatch, pack_codes
    from kmerutils_tpu_torch.io import fastx
    from kmerutils_tpu_torch.ops import sketch_grid as G
    p = anchor.AnchorsGeneratorParameters(fasta_name=os.path.basename(fq),
                                          **ANCHOR_PARAMS)
    step = p.window - p.overlap
    mbases = sum(c.size for c in clean) / 1e6
    batch, _ = next(iter(fastx.read_batches(fq)))
    pick = np.sort(rng.choice(batch.n_reads, size=min(64, batch.n_reads),
                              replace=False))
    host = (ReadBatch(batch.words[pick], batch.lengths[pick]), pick)
    srv = kvstore.RespServer()
    try:
        store = anchor.RedisAnchorStore(port=srv.port)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

        # --- the phase's path: G1's count from 0 to what it launched ---
        G.launches_min = 0
        t0 = time.perf_counter()
        anchors = anchor.anchor_computation(fq, p, store, device=dev)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        batch = batch.to(dev)
        for k in (16, 12):
            seqminhash_run(torch, batch, host, k)
        launches_g1 = G.launches_min
        # ------------------------------------------------------------------
        print(f"launches on the anchor / seqminhash path: G1 {launches_g1}",
              flush=True)
        check(launches_g1 >= 2, "G1 was not launched by seqminhash")
        want_n = sum(-(-c.size // step) for c in clean)
        n_stored = len(srv.store.get(anchor.SLICE_ANCHOR_KEY.encode(), {}))
        check(len(anchors) == want_n == n_stored,
              f"{len(anchors)} anchors, {n_stored} stored, want {want_n}")
        check([(a.readnum, a.slicepos) for a in anchors]
              == sorted((a.readnum, a.slicepos) for a in anchors),
              "anchors not in (read number, slice position) order")
        t0 = time.perf_counter()
        anchor.anchor_computation(fq, p, None, device=dev)
        wall_compute = time.perf_counter() - t0
        sample = [anchors[i] for i in np.sort(rng.choice(
            len(anchors), size=min(64, len(anchors)), replace=False))]
        reads = sorted({a.readnum for a in sample})
        L = max(clean[r].size for r in reads)
        codes = np.zeros((len(reads), L), np.uint8)
        for i, r in enumerate(reads):
            codes[i, : clean[r].size] = clean[r]
        cpu = {(a.readnum, a.slicepos): a for a in anchor.compute_anchors(
            pack_codes(codes, np.array([clean[r].size for r in reads],
                                       np.int32), device="cpu"),
            p, read_nums=reads)}
        for a in sample:
            back = store.load_anchor(p, a.readnum, a.slicepos)
            want = cpu[(a.readnum, a.slicepos)]
            check(back is not None and back.minhash == a.minhash
                  == want.minhash and back.value_string()
                  == want.value_string(), f"anchor ({a.readnum}, "
                  f"{a.slicepos}) over the wire != the CPU's")
        store.close()
    finally:
        srv.close()
    out = {"anchors": len(anchors), "wall_s": wall,
           "wall_compute_s": wall_compute, "mbases": mbases,
           "mbases_per_s": mbases / wall,
           "mbases_per_s_compute": mbases / wall_compute,
           "max_memory_allocated_bytes": peak, "launches_G1": launches_g1,
           "empty_anchors": sum(not a.minhash for a in anchors)}
    print(json.dumps({"timing": "anchor_computation", **ANCHOR_PARAMS, **out,
                      "card": card}), flush=True)
    return out


def remap_oracle(q: np.ndarray) -> np.ndarray:
    """The 3-bit remap written out: q > 0x37 -> 7, q < 0x25 -> 0, else
    1 + (q - 0x25) * 6 // 18."""
    q = q.astype(np.int64)
    return np.where(q > 0x37, 7, np.where(q < 0x25, 0,
                                          1 + (q - 0x25) * 6 // 18))


def write_quality_fastq(src: str, dst: str, rng):
    """``src`` (4-line FASTQ) again with seeded qualities over bytes
    0x21-0x5A; returns (all quality bytes, offsets[n + 1])."""
    with open(src, "rb") as f:
        lines = f.read().split(b"\n")
    quals = lines[3::4]
    lens = np.array([len(q) for q in quals], np.int64)
    flat = rng.integers(0x21, 0x5B, size=int(lens.sum()), dtype=np.uint8)
    offsets = np.concatenate([[0], np.cumsum(lens)])
    raw = flat.tobytes()
    lines[3::4] = [raw[offsets[i]: offsets[i + 1]] for i in range(lens.size)]
    with open(dst, "wb") as f:
        f.write(b"\n".join(lines))
    return flat, offsets


def first_lines(proc, n: int, timeout: float) -> list[str]:
    """The first n lines of a child's stdout, failing after ``timeout``."""
    import select
    buf = b""
    end = time.monotonic() + timeout
    fd = proc.stdout.fileno()
    while buf.count(b"\n") < n:
        ready, _, _ = select.select([fd], [], [],
                                    max(end - time.monotonic(), 0))
        check(bool(ready), f"no output from {proc.args} in {timeout} s")
        chunk = os.read(fd, 4096)
        check(bool(chunk), f"{proc.args} ended early: {buf!r}")
        buf += chunk
    return buf.decode().splitlines()[:n]


def quality_run(rng, tmp: str, card: str, fq: str) -> dict:
    """qualityloader through the CLI as a subprocess over a seeded FASTQ
    with qualities across all eight symbols: its port from its second line,
    GetQRead / GetQBlock / GetQBase for 64 sampled reads equal to the
    remap of the file's quality lines, then Exit; the in-process store's
    build time and memory_bits."""
    from kmerutils_tpu_torch.quality import qserver, quality
    qfq = os.path.join(tmp, "ont10k_qual.fastq")
    flat, offsets = write_quality_fastq(fq, qfq, rng)
    n = offsets.size - 1
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "kmerutils_tpu_torch.cli.qualityloader",
         "-f", qfq, "-p", "0"], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE)
    try:
        lines = first_lines(proc, 2, 120.0)
        cli_wall = time.perf_counter() - t0
        check(lines[0] == f"loaded {n} quality sequences from {qfq}",
              f"qualityloader said {lines[0]!r}")
        port = int(lines[1].rsplit(":", 1)[1])
        cli = qserver.QualityClient(port=port)
        cli.sock.settimeout(30.0)
        for r in rng.choice(n, size=min(64, n), replace=False).tolist():
            want = remap_oracle(flat[offsets[r]: offsets[r + 1]])
            L = want.size
            b, e = sorted(rng.integers(0, L + 1, size=2).tolist())
            pos = int(rng.integers(0, L))
            check(np.array_equal(cli.get_quality_sequence(r), want)
                  and np.array_equal(cli.get_quality_block(r, b, e),
                                     want[b:e])
                  and cli.get_quality_base(r, pos) == want[pos],
                  f"qualityloader: read {r} served != the file's remap")
        cli.exit_server()
        cli.close()
        check(proc.wait(timeout=30) == 0, "qualityloader exited non-zero")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()
        proc.stderr.close()
    t0 = time.perf_counter()
    store = quality.load_quality_store(qfq)
    load_s = time.perf_counter() - t0
    check(np.array_equal(store.offsets, offsets)
          and np.array_equal(store.wm.lookup(offsets[:-1][:1000]),
                             remap_oracle(flat[offsets[:-1][:1000]])),
          "load_quality_store != the file's remap")
    out = {"reads": int(n), "symbols": int(flat.size),
           "cli_wall_to_serving_s": cli_wall, "store_load_s": load_s,
           "memory_bits": store.memory_bits(),
           "bits_per_symbol": store.memory_bits() / flat.size}
    print(json.dumps({"timing": "qualityloader", **out, "card": card}),
          flush=True)
    return out


def splitmix64_np(x: np.ndarray) -> np.ndarray:
    """The splitmix64 finalizer in numpy (u64 arithmetic wraps)."""
    x = x + np.uint64(0x9E3779B97F4A7C15)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def filter_keys(torch, fq: str, dev):
    """Every valid canonical 16-mer occurrence of the file, as u32 values
    in int64 on the card."""
    from kmerutils_tpu_torch.base import kmer
    from kmerutils_tpu_torch.io import fastx
    parts = []
    for b, _ in fastx.read_batches(fq):
        can, valid, _ = kmer.canonical_kmers(b.to(dev), 16)
        parts.append(can[valid])
    return torch.cat(parts)


def filters_run(torch, rng, card: str, fq: str, dev,
                log2: int = FILTER_LOG2_SLOTS, nh: int = FILTER_NB_HASH,
                n_wide: int = 1 << 24) -> dict:
    """BloomFilter and CountingBloom at 2^28 slots, 4 probes, over every
    16-mer occurrence of the bacterial fixture: the card's slots equal a
    numpy oracle (np.bincount over splitmix64 probe indices computed in
    numpy; > 0, and clamped at 255), contains / estimate_count on a sample
    equal the oracle's; dispatch to 4 and 8 shards (u32 16-mers and u64
    keys, half hashing >= 2^63) card equal to CPU; insert rates timed."""
    from kmerutils_tpu_torch.count import dispatch as D
    from kmerutils_tpu_torch.count import filters as F
    keys = filter_keys(torch, fq, dev)
    n = keys.numel()
    host = keys.cpu().numpy().view(np.uint64)
    t0 = time.perf_counter()
    mask = np.uint64((1 << log2) - 1)
    idx = np.empty((nh, n), np.int64)
    for i in range(nh):
        idx[i] = splitmix64_np(host ^ np.uint64((i + 1) * 0x9E3779B97F4A7C15
                                                % (1 << 64))) & mask
    check(np.array_equal(F.probe_indices(keys, nh, log2).T.cpu().numpy(),
                         idx), "probe_indices: card != numpy")
    counts = np.bincount(idx.ravel(), minlength=1 << log2)
    del idx
    oracle_s = time.perf_counter() - t0
    bf = F.BloomFilter.create(log2, nh, device=dev).insert(keys)
    cb = F.CountingBloom.create(log2, nh, 8, device=dev).insert(keys)
    check(np.array_equal(bf.slots.cpu().numpy(), (counts > 0)
                         .astype(np.uint8)), "BloomFilter slots != oracle")
    clamped = np.minimum(counts, cb.max_count)
    check(np.array_equal(cb.slots.cpu().numpy(), clamped),
          "CountingBloom slots != oracle")
    probe = np.concatenate([host[rng.integers(0, n, size=1 << 19)],
                            rng.integers(0, 1 << 64, size=1 << 19,
                                         dtype=np.uint64)])
    pt = torch.from_numpy(probe.view(np.int64)).to(dev)
    pidx = F.probe_indices(pt, nh, log2).cpu().numpy()
    check(np.array_equal(bf.contains(pt).cpu().numpy(),
                         (counts[pidx] > 0).all(axis=1))
          and np.array_equal(cb.estimate_count(pt).cpu().numpy(),
                             clamped[pidx].min(axis=1)),
          "contains / estimate_count != oracle")
    check(float(bf.fill_fraction()) == float((counts > 0).mean()),
          "fill_fraction != oracle")
    wide = torch.from_numpy(rng.integers(0, 1 << 64, size=n_wide,
                                         dtype=np.uint64).view(np.int64))
    shards = {}
    for s in (4, 8):
        d16 = D.dispatch(keys, s, 16)
        check(torch.equal(d16.cpu(), D.dispatch(keys.cpu(), s, 16)),
              f"dispatch of 16-mers to {s} shards: card != CPU")
        d64 = D.dispatch(wide.to(dev), s, 21)
        check(torch.equal(d64.cpu(), D.dispatch(wide, s, 21)),
              f"dispatch of u64 keys to {s} shards: card != CPU")
        shards[s] = torch.bincount(d16.long(), minlength=s).tolist()
    out = {"keys": n, "log2_slots": log2, "nb_hash": nh, "oracle_s": oracle_s,
           "bloom_fill": float(bf.fill_fraction()),
           "counting_saturated_slots": int((counts >= 255).sum()),
           "shard_sizes_16mers": shards}
    del bf, cb
    torch.cuda.empty_cache()
    for name, f in (("bloom", F.BloomFilter.create(log2, nh, device=dev)),
                    ("counting", F.CountingBloom.create(log2, nh, 8,
                                                        device=dev))):
        ms = cuda_ms(torch, lambda: f.insert(keys), 3, warmup=1)
        out[f"{name}_insert_ms"] = ms
        out[f"{name}_insert_mkeys_per_s"] = n / ms / 1e3
    ms = cuda_ms(torch, lambda: D.dispatch(keys, 8, 16), 5)
    out.update(dispatch_ms=ms, dispatch_mkeys_per_s=n / ms / 1e3)
    print(json.dumps({"timing": "filters", **out, "card": card}),
          flush=True)
    return out


def anchors_quality_filters(torch, rng, tmp: str, card: str, dev, fq8: str,
                            clean8, bact: str) -> dict:
    phase("12 bottom-k MinHash, anchors over RESP, seqminhash, the quality "
          "CLI, dispatch and the filters")
    t_phase = time.perf_counter()
    out, seconds = {}, {}
    for name, run in (
            ("bottomk", lambda: bottomk_checks(torch, rng, card, dev)),
            ("anchors", lambda: anchors_run(torch, rng, card, fq8, clean8,
                                            dev)),
            ("quality", lambda: quality_run(rng, tmp, card, fq8)),
            ("filters", lambda: filters_run(torch, rng, card, bact, dev))):
        t0 = time.perf_counter()
        out[name] = run()
        seconds[name] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    print(json.dumps({"timing": "phase12_s", **seconds,
                      "total": out["seconds"]}), flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 13: the sharded path (parallel/) over NCCL, one rank
# ---------------------------------------------------------------------------

def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def file_order_batches(reads, n_rows: int, dev):
    """(ReadBatch on ``dev``, read-number offset) over ``reads`` in file
    order, ``n_rows`` reads a batch."""
    from kmerutils_tpu_torch.base.sequence import pack_codes
    for s in range(0, len(reads), n_rows):
        chunk = reads[s:s + n_rows]
        lens = np.array([r.size for r in chunk], np.int32)
        codes = np.zeros((len(chunk), int(lens.max())), np.uint8)
        for i, r in enumerate(chunk):
            codes[i, :r.size] = r
        yield pack_codes(codes, lens, device=dev), s


def count_oracle_np(reads, k: int):
    """(keys, counts, first read, first position) of every canonical k-mer
    of ``reads``, keys ascending (numpy)."""
    can, rid, pos = oracle_kmers(reads, k)
    keys, first, counts = np.unique(can, return_index=True,
                                    return_counts=True)
    return keys, counts, rid[first], pos[first]


def check_counter(got, reads, k: int, coords: bool, what: str,
                  oracle=None) -> int:
    """Compare a counter's union with the numpy oracle (``oracle``: its
    (keys, counts) when computed already, for a run without
    coordinates)."""
    keys, counts, rn, ps, dropped = got
    if oracle is None:
        wk, wc, wr, wp = count_oracle_np(reads, k)
    else:
        wk, wc = oracle
    ok = (dropped == 0 and keys.size == wk.size
          and np.array_equal(keys.astype(np.uint64), wk)
          and np.array_equal(counts.astype(np.int64), wc))
    if coords:
        ok = ok and np.array_equal(rn, wr) and np.array_equal(ps, wp)
    print(f"{what}: {keys.size} distinct {k}-mers, oracle {wk.size}, "
          f"{int(wc.sum())} occurrences: {'equal' if ok else 'DIFFERENT'}",
          flush=True)
    check(ok, f"{what}: counter != numpy oracle")
    return int(wk.size)


def sharded_path(torch, rng, card: str, fq: str, reads, walls8, oracle16,
                 dev, n_coords: int = 2_000, n_small: int = 400,
                 bench_shape=(1024, 6000), log2_slots: int = 28) -> dict:
    """Phase 13: parallel/ on a one-rank group on ``dev`` (NCCL on
    cuda:0)."""
    phase("13 the sharded path over NCCL (one rank on cuda:0)")
    import torch.distributed as dist
    from kmerutils_tpu_torch.base import kmer as kmer_mod
    from kmerutils_tpu_torch.base.sequence import pack_codes
    from kmerutils_tpu_torch.count import exact
    from kmerutils_tpu_torch.count.filters import BloomFilter
    from kmerutils_tpu_torch.io import fastx
    from kmerutils_tpu_torch.ops import merge as M
    from kmerutils_tpu_torch.ops import sketch_grid as G
    from kmerutils_tpu_torch.parallel import collective as pc
    from kmerutils_tpu_torch.parallel import mesh as pm
    from kmerutils_tpu_torch.parallel import stream as ps
    from kmerutils_tpu_torch.profile_sketch import profile
    from kmerutils_tpu_torch.sketch import setsketch
    from kmerutils_tpu_torch.sketch.jaccard import hashed_kmers

    t_phase = time.perf_counter()
    mesh = pm.make_mesh(dev, init_method=f"tcp://127.0.0.1:{free_port()}",
                        rank=0, world_size=1, timeout=120)
    print(f"process group: {mesh}", flush=True)
    check(mesh.world == 1 and (mesh.backend == "nccl"
                               and mesh.device == torch.device("cuda", 0)
                               or torch.device(dev).type == "cpu"),
          "not NCCL on cuda:0")
    launches = {"K3": 0, "K4": 0, "K5": 0, "G2": 0}

    def driven(fn):
        # --- a path of this phase: counts from 0 to what it launched ---
        M.reset_launches()
        G.launches_max = 0
        out = fn()
        if mesh.device.type == "cuda":
            torch.cuda.synchronize()
        for name, n in (("K3", M.launches_fold), ("K4", M.launches_aggregate),
                        ("K5", M.launches_merge), ("G2", G.launches_max)):
            launches[name] += n
        # -------------------------------------------------------------------
        return out

    def counter_run(batches, k, cap, **kw):
        ctr = ps.ShardedStreamCounter(mesh, cap, wide=k > 16, **kw)
        for batch, offset in batches:
            ctr.update(pm.reads_sharding(mesh, batch), k,
                       read_num_offset=offset)
        got = ctr.finalize()
        check(ctr.dropped_in_transit == 0, "in-transit drops")
        return ctr, got

    def file_batches():
        for batch, _idx in fastx.read_batches_overlapped(fq, device=dev):
            yield batch, 0

    out, seconds = {}, {}
    t0 = time.perf_counter()
    try:
        # the k=16 counter over the whole file (the CLI's capacities)
        def k16():
            return counter_run(file_batches(), 16, 1 << 26,
                               cap_max_per_device=1 << 28)
        t1 = time.perf_counter()
        ctr, got = driven(k16)
        walls = [time.perf_counter() - t1]
        out["capacity16"] = ctr.table.capacity
        ctr.close()
        check_counter(got, reads, 16, False, "ShardedStreamCounter k=16",
                      oracle=oracle16)
        del got
        # a warm run, one timed by events, one under torch.profiler
        prof = profile(lambda: k16()[0].close(), 1)
        walls.append(prof["event_ms_per_call"] / 1e3)
        mbases = sum(r.size for r in reads) / 1e6
        out["k16"] = {"wall_s": walls,
                      "device_busy_ms": prof["device_ms_per_call"],
                      "idle_share": prof["idle_share_vs_unprofiled_loop"],
                      "family_ms": prof["family_ms_per_call"],
                      "mbases_per_s": [mbases / w for w in walls],
                      "parsefastq_count_k16_wall_s": walls8}
        print(json.dumps({"timing": "sharded_counter_k16", **out["k16"],
                          "capacity_end": out["capacity16"],
                          "card": card}), flush=True)
        seconds["k16"] = time.perf_counter() - t0

        # k=21 with coordinates, file-order batches, staged at depth 1
        part = reads[:n_coords]
        ctr, got = driven(lambda: counter_run(
            file_order_batches(part, 250, dev), 21, 1 << 26, coords=True,
            depth=1))
        ctr.close()
        check_counter(got, part, 21, True,
                      f"ShardedStreamCounter k=21 coords ({n_coords} reads)")
        seconds["k21_coords"] = time.perf_counter() - t0 - sum(
            seconds.values())

        # one growth epoch, then spill epochs, at small capacities
        small = reads[:n_small]
        ctr, got = driven(lambda: counter_run(
            file_order_batches(small, 24, dev), 16, 1 << 20,
            cap_max_per_device=1 << 23))
        check(ctr.table.capacity > 1 << 20 and ctr.spill_store is None,
              "the growth run never grew")
        check_counter(got, small, 16, False,
                      f"growth run ({ctr.table.capacity} entries at the end)")
        ctr.close()
        ctr, got = driven(lambda: counter_run(
            file_order_batches(small, 24, dev), 16, 1 << 20,
            coords=True))
        segs = ctr.n_segments
        check(segs >= 2, f"spill run wrote {segs} segments, want >= 2")
        check_counter(got, small, 16, True, f"spill run ({segs} segments)")
        ctr.close()
        seconds["grow_spill"] = time.perf_counter() - t0 - sum(
            seconds.values())
        torch.cuda.empty_cache()

        # the one-batch collectives at the bench batch
        n_b, l_b = bench_shape
        bench = pack_codes(rng.integers(0, 4, size=(n_b, l_b), dtype=np.uint8),
                           np.full(n_b, l_b, np.int32), device=dev)
        want = exact.count_batch(bench, 21)
        n = want.keys.numel()
        keys, counts, dropped, nd, nu = driven(
            lambda: pc.sharded_count(bench, 21, mesh))
        check(int(dropped) == 0 and torch.equal(keys[:n], want.keys)
              and bool((keys[n:] == -1).all())
              and torch.equal(counts[:n], want.counts)
              and bool((counts[n:] == 0).all())
              and int(nd) == int(want.n_distinct)
              and int(nu) == int(want.n_unique),
              "sharded_count != count_batch")
        red = driven(lambda: pc.sharded_count_redundant(bench, 21, mesh))
        check(torch.equal(red[0], want.keys) and torch.equal(red[1],
                                                             want.counts)
              and int(red[2]) == int(want.n_distinct)
              and int(red[3]) == int(want.n_unique),
              "sharded_count_redundant != count_batch")
        print(f"sharded_count / _redundant ({n_b} x {l_b}, k=21): "
              f"{int(nd)} distinct, {int(nu)} unique, equal to count_batch",
              flush=True)
        del keys, counts, red, want

        items, valid = hashed_kmers(bench, 21)
        p = setsketch.SetSketchParams(m=200)
        merged = driven(lambda: pc.sharded_setsketch_collection(
            items, valid, p, mesh))
        regs = setsketch.setsketch_signatures(items, valid, p)
        check(torch.equal(merged, regs.max(dim=0).values),
              "sharded_setsketch_collection != row max")
        gathered = driven(lambda: pc.gather_signatures(regs, mesh))
        mask = pc.gather_signatures(regs % 2 == 0, mesh)
        check(torch.equal(gathered, regs) and torch.equal(mask,
                                                          regs % 2 == 0),
              "gather_signatures != the signatures")

        can, kvalid, _ = kmer_mod.canonical_kmers(bench, 21)
        bkeys = torch.where(kvalid, can, -1).reshape(-1)
        slots = torch.zeros(1 << log2_slots, dtype=torch.uint8, device=dev)
        got_slots = driven(lambda: pc.sharded_bloom_insert(
            slots, bkeys, 4, log2_slots, mesh))
        want_slots = BloomFilter.create(log2_slots, 4, dev).insert(
            bkeys, mask=bkeys != -1).slots
        check(torch.equal(got_slots, want_slots),
              "sharded_bloom_insert != BloomFilter.insert")
        print(f"setsketch collection, gather and Bloom (2^{log2_slots} slots,"
              f" 4 probes, fill {float(got_slots.float().mean()):.4f}): "
              "equal", flush=True)
        seconds["one_batch"] = time.perf_counter() - t0 - sum(
            seconds.values())
    finally:
        dist.destroy_process_group()
    print(f"launches on phase 13's paths: {launches}", flush=True)
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the sharded path")
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t_phase
    print(json.dumps({"timing": "phase13_s", **seconds,
                      "total": out["seconds"]}), flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 14: the host leftovers on the card, and the six families against
# the published algorithms (sketch/golden.py)
# ---------------------------------------------------------------------------

def revcomp_checks(torch, rng, card: str, dev) -> dict:
    """revcomp_batch on the card at the bench batch and a ragged batch:
    equal to the CPU's and to numpy's reverse complement of the codes,
    and the identity when applied twice; timed by CUDA events."""
    from kmerutils_tpu_torch.base.sequence import (pack_codes, pack_words,
                                                   revcomp_batch)
    out = {}
    for what, (n, L) in (("bench", (1024, 6000)), ("ragged", (512, 3000))):
        codes = rng.integers(0, 4, size=(n, L), dtype=np.uint8)
        lengths = np.full(n, L, np.int32)
        if what == "ragged":        # empty, one base, whole words, full
            lengths = rng.integers(0, L + 1, size=n).astype(np.int32)
            lengths[:4] = (0, 1, 16 * 64, L)
        codes[np.arange(L)[None, :] >= lengths[:, None]] = 0
        batch = pack_codes(codes, lengths, device=dev)
        rc = revcomp_batch(batch)
        want = np.zeros_like(codes)
        for r, ln in enumerate(lengths.tolist()):
            want[r, :ln] = 3 - codes[r, :ln][::-1]
        want_words, _ = pack_words(want, lengths)
        cpu = revcomp_batch(batch.to("cpu"))
        back = revcomp_batch(rc)
        ok = (np.array_equal(rc.words.cpu().numpy().view(np.uint32),
                             want_words)
              and torch.equal(rc.words.cpu(), cpu.words)
              and torch.equal(rc.lengths, batch.lengths)
              and torch.equal(back.words, batch.words))
        ms = (cuda_ms(torch, lambda: revcomp_batch(batch), 10)
              if torch.device(dev).type == "cuda" else None)
        print(f"revcomp_batch {what} {n} x {L}: card = CPU = numpy, twice = "
              f"input: {ok}; {ms} ms", flush=True)
        check(ok, f"revcomp_batch at the {what} batch")
        out[what] = {"rows": n, "bases": L, "ms": ms}
    print(json.dumps({"timing": "revcomp_batch_ms", **{
        k: v["ms"] for k, v in out.items()}, "card": card}), flush=True)
    return out


def base_count_checks(torch, fq: str, clean, dev) -> dict:
    """ReadBatch.codes / valid_mask and base_counts on the card over phase
    5's batches: per-read counts equal numpy's, their totals numpy's over
    the file, and their per-percent histogram stats.py's
    (ReadBaseDistribution over the same batches on the card)."""
    from kmerutils_tpu_torch import stats
    from kmerutils_tpu_torch.base.alphabet import base_counts
    from kmerutils_tpu_torch.io import fastx
    counts, rows = [], []
    dist = stats.ReadBaseDistribution.new()
    for host, idx in fastx.read_batches(fq, batch_reads=10000):
        b = host.to(dev)
        counts.append(base_counts(b.codes(), b.valid_mask()).cpu().numpy())
        rows.append(np.asarray(idx))
        dist.record_batch(b)
    dist.finish()
    counts = np.concatenate(counts).astype(np.int64)
    rows = np.concatenate(rows)
    want = np.stack([np.bincount(clean[r], minlength=4) for r in rows])
    totals = counts.sum(axis=0)
    lengths = np.array([clean[r].size for r in rows], np.int64)
    pct = np.clip(np.rint(100.0 * counts / lengths[:, None]), 0, 100)
    mat = np.zeros((101, 4))
    np.add.at(mat, (pct.astype(np.int64), np.arange(4)[None, :]), 1.0)
    ok = (np.array_equal(counts, want)
          and np.array_equal(totals,
                             np.bincount(np.concatenate(clean), minlength=4))
          and np.array_equal(mat, dist.acgt_distribution)
          and dist.n_reads == len(clean))
    print(f"base_counts over {rows.size} reads: A/C/G/T totals "
          f"{totals.tolist()}; = numpy per read and over the file, "
          f"= stats.py's histogram: {ok}", flush=True)
    check(ok, "base_counts on the card != numpy / stats.py")
    return {"totals": totals.tolist(), "reads": int(rows.size)}


def kmertype_checks(torch, rng, clean, dev, n_reads: int = 64,
                    n_canonical: int = 4096) -> dict:
    """Kmer32bit (k=14), Kmer16b32bit and Kmer64bit (k=21, 32) pushed base
    by base over 64 sampled reads: every k-mer equal to base/kmer.py's on
    the card, and the canonical k-mer (min of the value and its reverse
    complement's) at ``n_canonical`` sampled positions equal to the
    card's."""
    from kmerutils_tpu_torch.base import kmer
    from kmerutils_tpu_torch.base.kmertypes import (Kmer16b32bit, Kmer32bit,
                                                    Kmer64bit)
    from kmerutils_tpu_torch.base.sequence import pack_codes
    pick = np.sort(rng.choice(len(clean), size=n_reads, replace=False))
    reads = [clean[i] for i in pick]
    L = max(r.size for r in reads)
    codes = np.zeros((n_reads, L), np.uint8)
    for i, r in enumerate(reads):
        codes[i, : r.size] = r
    batch = pack_codes(codes, np.array([r.size for r in reads], np.int32),
                       device=dev)
    out = {}
    for cls, k in ((Kmer32bit, 14), (Kmer16b32bit, 16), (Kmer64bit, 21),
                   (Kmer64bit, 32)):
        t0 = time.perf_counter()
        if k <= 16:
            km, _ = kmer.kmers_u32(batch, k)
            can, _ = kmer.canonical_u32(km, k)
        else:
            km, _ = kmer.kmers_u64(batch, k)
            can, _ = kmer.canonical_u64(km, k)
        km = km.cpu().numpy().view(np.uint64)
        can = can.cpu().numpy().view(np.uint64)
        n_pos = sum(r.size - k + 1 for r in reads)
        sample = set(rng.choice(n_pos, size=n_canonical,
                                replace=False).tolist())
        bad = bad_can = seen = 0
        for i, r in enumerate(reads):
            x = cls(0) if cls is Kmer16b32bit else cls(k)
            vals = []
            for p, c in enumerate(r.tolist()):
                x = x.push(c)
                if p < k - 1:
                    continue
                vals.append(x.get_compressed_value())
                if seen in sample:
                    rc = x.reverse_complement().get_compressed_value()
                    bad_can += min(vals[-1], rc) != int(can[i, p - k + 1])
                seen += 1
            bad += int((np.array(vals, np.uint64)
                        != km[i, : len(vals)]).sum())
        s = time.perf_counter() - t0
        print(f"{cls.__name__} k={k}: {n_pos} k-mers pushed base by base vs "
              f"base/kmer.py on the card: {bad} differ; {n_canonical} "
              f"canonical: {bad_can} differ ({s:.1f} s)", flush=True)
        check(bad == 0 and bad_can == 0,
              f"{cls.__name__} k={k} != the card's k-mers")
        out[f"{cls.__name__}_k{k}"] = {"kmers": n_pos, "seconds": s}
    return out


def present(sorted_keys: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Whether each value of ``v`` is in the sorted array."""
    i = np.minimum(np.searchsorted(sorted_keys, v), sorted_keys.size - 1)
    return sorted_keys[i] == v


def reload_checks(rng, fq: str, oracle16, unique21,
                  n_sample: int = 10_000) -> dict:
    """KmerCountReload of phase 8's --count -s 16 and --unique -s 21 dumps:
    the counts of sampled 16-mers (count-1 ones absent) and the
    coordinates of sampled ranks and keys equal phase 8's oracles."""
    from kmerutils_tpu_torch.io.formats import KmerCountReload
    t0 = time.perf_counter()
    multi = KmerCountReload.load_multiple_kmers_from_file(
        fq + ".multi_kmer.bin")
    t_multi = time.perf_counter() - t0
    keys, counts = oracle16            # sorted, every distinct 16-mer
    pick = rng.choice(keys.size, size=n_sample, replace=False)
    want = [None if c < 2 else min(int(c), 255) for c in counts[pick]]
    got = [multi.get_kmer_count(int(v)) for v in keys[pick]]
    cand = rng.integers(0, 1 << 32, size=4 * n_sample, dtype=np.uint64)
    absent16 = cand[~present(keys, cand)][:100]
    ok_multi = (multi.kmer_size == 16 and got == want
                and len(multi.counts) == int((counts >= 2).sum())
                and all(multi.get_kmer_count(int(v)) is None
                        for v in absent16))
    t_multi_checks = time.perf_counter() - t0 - t_multi

    t0 = time.perf_counter()
    uniq = KmerCountReload.load_unique_kmers_from_file(fq + ".once_kmer.bin")
    t_uniq = time.perf_counter() - t0
    ukeys, rid, pos = unique21
    n = ukeys.size
    ranks = rng.choice(n, size=n_sample, replace=False)
    ok_rank = all(uniq.get_coord_from_rank(int(r)) == (int(rid[r]),
                                                       int(pos[r]))
                  for r in ranks)
    ok_rank &= (uniq.get_coord_from_rank(-1) is None
                and uniq.get_coord_from_rank(n) is None)
    # the dump keeps a key's low 32 bits, and the reload's key map keeps
    # the last rank of a repeated low half: in a stable sort, the last of
    # the equal keys
    order = np.argsort(ukeys, kind="stable")
    srt = ukeys[order]
    sk = ukeys[ranks]
    hi = np.searchsorted(srt, sk, "right")
    repeated = hi - np.searchsorted(srt, sk, "left") > 1
    last = order[hi - 1]
    ok_key = all(uniq.get_unique_kmer_coord(int(v))
                 == (int(rid[i]), int(pos[i])) for v, i in zip(sk, last))
    cand = rng.integers(0, 1 << 32, size=4 * n_sample,
                        dtype=np.uint64).astype(np.uint32)
    absent21 = cand[~present(srt, cand)][:100]
    ok_key &= all(uniq.get_unique_kmer_coord(int(v)) is None
                  for v in absent21)
    ok_uniq = (uniq.kmer_size == 21 and len(uniq.coords) == n
               and uniq.get_kmer_count(int(sk[0])) is None
               and ok_rank and ok_key)
    t_uniq_checks = time.perf_counter() - t0 - t_uniq
    t0 = time.perf_counter()
    del multi, uniq
    t_free = time.perf_counter() - t0
    print(f"KmerCountReload: --count -s 16 ({len(want)} sampled of "
          f"{int((counts >= 2).sum())} records, {t_multi:.1f} s to load, "
          f"{t_multi_checks:.1f} s to check) sampled 16-mers + 100 absent = "
          f"oracle: {ok_multi}; --unique -s 21 ({n} records, {t_uniq:.1f} s "
          f"to load, {t_uniq_checks:.1f} s to check) {n_sample} sampled ranks"
          f" and keys ({int(repeated.sum())} with a repeated low half), ranks"
          f" -1 and n, 100 absent keys = oracle: {ok_uniq}; {t_free:.1f} s "
          f"to free both", flush=True)
    check(ok_multi, "KmerCountReload of the --count dump != oracle")
    check(ok_uniq, "KmerCountReload of the --unique dump != oracle")
    return {"count_records": int((counts >= 2).sum()),
            "count_load_s": t_multi, "unique_records": n,
            "unique_load_s": t_uniq, "check_s": t_multi_checks
            + t_uniq_checks, "free_s": t_free}


def load_all_check(torch, fq: str, clean, dev) -> dict:
    """io/fastx.load_all of phase 5's file onto the card: the clean reads
    in file order."""
    from kmerutils_tpu_torch.base.sequence import pack_words
    from kmerutils_tpu_torch.io import fastx
    t0 = time.perf_counter()
    b = fastx.load_all(fq, device=dev)
    s = time.perf_counter() - t0
    L = max(c.size for c in clean)
    codes = np.zeros((len(clean), L), np.uint8)
    for i, c in enumerate(clean):
        codes[i, : c.size] = c
    words, lengths = pack_words(codes, [c.size for c in clean])
    ok = (b.device.type == torch.device(dev).type
          and np.array_equal(b.words.cpu().numpy().view(np.uint32), words)
          and np.array_equal(b.lengths.cpu().numpy(), lengths))
    print(f"load_all: {b.n_reads} x {b.words.shape[1]} words on {b.device} "
          f"= the clean reads in file order: {ok} ({s:.1f} s)", flush=True)
    check(ok, "load_all != the clean reads in file order")
    return {"reads": b.n_reads, "seconds": s}


GOLDEN_M = 200           # the bench width
GOLDEN_SET = 300         # items a set: more than m, few buckets stay empty
GOLDEN_SHARED = (200, 100)   # shared items: exact J = 0.5 and 0.2
GOLDEN_HLL_SET = 400


def distinct_rows(rng, rows: int, n: int, wide: bool) -> np.ndarray:
    """``rows`` rows of ``n`` distinct random items (u64 below 2^62, or u32
    below 2^31 so K1 runs)."""
    hi = 1 << (62 if wide else 31)
    return np.stack([rng.choice(hi, size=n, replace=False) + 1
                     for _ in range(rows)]).astype(np.uint64)


def estimate_rule(est, exact: float, m: int, slack: float, sd_lo=None,
                  sd_hi: float = 1.7) -> dict:
    """tests/test_sketch.py's rule: the mean within 3.5 sd / sqrt(trials)
    + slack of the exact J, the spread below sd_hi (and above sd_lo) times
    the binomial sd."""
    est = np.asarray(est, np.float64)
    ref_sd = np.sqrt(exact * (1 - exact) / m)
    tol = 3.5 * np.sqrt(exact * (1 - exact) / m / est.size) + slack
    mean, sd = float(est.mean()), float(est.std())
    ok = abs(mean - exact) < tol and sd < sd_hi * ref_sd
    if sd_lo is not None:
        ok &= sd > sd_lo * ref_sd
    return {"mean": mean, "sd": sd, "tol": tol, "ref_sd": ref_sd,
            "n": int(est.size), "ok": bool(ok)}


def pair_estimates(torch, sig) -> np.ndarray:
    """Fraction of equal slots of rows 2i and 2i + 1."""
    return (sig[0::2] == sig[1::2]).to(torch.float64).mean(dim=1) \
        .cpu().numpy()


def golden_families(torch, rng, card: str, dev, n_pairs: int = 2048,
                    n_golden: int = 48, n_hll: int = 2048,
                    n_hll_golden: int = 12, seed: int = 3) -> dict:
    """Each of the six families in one batched call on the card over many
    pairs of seeded sets with a known exact value, and the published
    sequential algorithm (sketch/golden.py) on the host over the first
    pairs: both held to tests/test_sketch.py's mean and spread rules."""
    from kmerutils_tpu_torch.ops import sketch_grid as G
    from kmerutils_tpu_torch.ops import tournament as T
    from kmerutils_tpu_torch.sketch import (densminhash, golden,
                                            probminhash, setsketch,
                                            superminhash)
    m, n = GOLDEN_M, GOLDEN_SET
    out, launches = {}, {}

    def record(family, exact, card_est, gold_est, gold_s, **rule):
        r = {"exact": exact, "card": estimate_rule(card_est, exact, m,
                                                   **rule),
             "golden": estimate_rule(gold_est, exact, m, **rule),
             "golden_host_s": gold_s}
        print(f"{family} J={exact:.4f}: card mean {r['card']['mean']:.4f} "
              f"sd {r['card']['sd']:.4f} ({r['card']['n']} pairs, tol "
              f"{r['card']['tol']:.4f}); golden mean "
              f"{r['golden']['mean']:.4f} sd {r['golden']['sd']:.4f} "
              f"({r['golden']['n']} pairs, tol {r['golden']['tol']:.4f}, "
              f"{gold_s:.2f} s on the host); binomial sd "
              f"{r['card']['ref_sd']:.4f}", flush=True)
        check(r["card"]["ok"], f"{family} on the card fails the rule")
        check(r["golden"]["ok"], f"{family}'s golden fails the rule")
        out.setdefault(family, []).append(r)

    # PROB3A: weighted sets, b a subset of a with weights of its own
    for shared in GOLDEN_SHARED:
        wa = rng.integers(1, 6, size=n)
        wb = rng.integers(1, 6, size=shared)
        exact = golden.probjaccard_exact(
            {i: float(w) for i, w in enumerate(wa)},
            {i: float(w) for i, w in enumerate(wb)})
        pool = distinct_rows(rng, n_pairs, n, wide=False)
        items = np.zeros((2 * n_pairs, n), np.uint32)
        weights = np.zeros((2 * n_pairs, n), np.int32)
        items[0::2], weights[0::2] = pool, wa
        items[1::2, :shared], weights[1::2, :shared] = pool[:, :shared], wb
        ti = torch.from_numpy(items.view(np.int32)).to(dev)
        tw = torch.from_numpy(weights).to(dev)
        T.launches_u32 = 0
        sig, _ = probminhash.probminhash_signatures(ti, tw, m,
                                                      seed=seed)
        launches.setdefault("K1", []).append(T.launches_u32)
        t0 = time.perf_counter()
        gold = [float((golden.probminhash3_golden(p, wa, m, seed)
                       == golden.probminhash3_golden(p[:shared], wb, m,
                                                     seed)).mean())
                for p in pool[:n_golden]]
        record("PROB3A", exact, pair_estimates(torch, sig), gold,
               time.perf_counter() - t0, slack=0.01, sd_lo=0.5, sd_hi=1.6)

    # the unweighted families: a = pool[:n], b = pool[n - shared:2n - shared]
    fams = (("SUPER", superminhash.superminhash, golden.superminhash_golden,
             "G1"),
            ("SUPER2", superminhash.superminhash2,
             golden.superminhash_golden, "G1"),
            ("OPTDENS", densminhash.optdens_signatures,
             golden.optdens_golden, None),
            ("REVOPTDENS", densminhash.revoptdens_signatures,
             golden.revoptdens_golden, None))
    for shared in GOLDEN_SHARED:
        exact = shared / (2 * n - shared)
        pool = distinct_rows(rng, n_pairs, 2 * n - shared, wide=True)
        items = np.zeros((2 * n_pairs, n), np.uint64)
        items[0::2], items[1::2] = pool[:, :n], pool[:, n - shared:]
        ti = torch.from_numpy(items.view(np.int64)).to(dev)
        valid = torch.ones(ti.shape, dtype=torch.bool, device=dev)
        cache = {}
        for family, fn, gfn, kern in fams:
            G.launches_min = 0
            sig, _ = fn(ti, valid, m, seed)
            if kern:
                launches.setdefault(kern, []).append(G.launches_min)
            t0 = time.perf_counter()
            if gfn not in cache:      # SUPER and SUPER2: one algorithm
                ga = [gfn(p[:n], m, seed) for p in pool[:n_golden]]
                gb = [gfn(p[n - shared:], m, seed) for p in pool[:n_golden]]
                # SuperMinHash is judged on winners, densification on values
                j = 1 if family.startswith("SUPER") else 0
                cache[gfn] = [float((x[j] == y[j]).mean())
                              for x, y in zip(ga, gb)]
            record(family, exact, pair_estimates(torch, sig), cache[gfn],
                   time.perf_counter() - t0, slack=0.02)

    # HLL: the cardinality of sets of 400 items
    p = setsketch.SetSketchParams(m=m)
    pool = distinct_rows(rng, n_hll, GOLDEN_HLL_SET, wide=True)
    ti = torch.from_numpy(pool.view(np.int64)).to(dev)
    valid = torch.ones(ti.shape, dtype=torch.bool, device=dev)
    G.launches_max = 0
    regs = setsketch.setsketch_signatures(ti, valid, p, seed)
    launches["G2"] = [G.launches_max]
    est = setsketch.cardinality(regs, p).cpu().numpy()
    t0 = time.perf_counter()
    gregs = [golden.setsketch_golden(x, m, p.b, p.a, p.q, seed)
             for x in pool[:n_hll_golden]]
    gest = [golden.setsketch_cardinality_golden(r, m, p.b, p.a)
            for r in gregs]
    gold_s = time.perf_counter() - t0
    nn = GOLDEN_HLL_SET
    sd_theory = nn / np.sqrt(m)
    sd_mean_reg = (1.0 / np.log(p.b)) / np.sqrt(m)
    mean_reg = (regs[:n_hll_golden].to(torch.float64).mean().item(),
                float(np.mean(gregs)))
    hll = {"exact": nn, "golden_host_s": gold_s,
           "mean_register": mean_reg, "mean_register_tol": 4 * sd_mean_reg}
    for side, e in (("card", est), ("golden", np.asarray(gest))):
        tol = 3.5 * sd_theory / np.sqrt(e.size) + 0.05 * nn
        hll[side] = {"mean": float(e.mean()), "sd": float(e.std()),
                     "tol": tol, "sd_max": 2.5 * sd_theory, "n": int(e.size),
                     "ok": bool(abs(e.mean() - nn) < tol
                                and e.std() < 2.5 * sd_theory)}
    print(f"HLL n={nn}: card mean {hll['card']['mean']:.1f} sd "
          f"{hll['card']['sd']:.1f} ({n_hll} sets, tol "
          f"{hll['card']['tol']:.1f}); golden mean "
          f"{hll['golden']['mean']:.1f} sd {hll['golden']['sd']:.1f} "
          f"({n_hll_golden} sets, tol {hll['golden']['tol']:.1f}, "
          f"{gold_s:.2f} s on the host); sd max {2.5 * sd_theory:.1f}; "
          f"mean register card {mean_reg[0]:.1f} golden {mean_reg[1]:.1f} "
          f"(tol {4 * sd_mean_reg:.1f})", flush=True)
    check(hll["card"]["ok"], "HLL on the card fails the rule")
    check(hll["golden"]["ok"], "HLL's golden fails the rule")
    check(abs(mean_reg[0] - mean_reg[1]) < 4 * sd_mean_reg,
          "HLL's mean register differs from the golden's")
    out["HLL"] = [hll]
    if torch.device(dev).type == "cuda":
        print(f"launches in the families' card calls: {launches}",
              flush=True)
        for name, ns in launches.items():
            check(all(x > 0 for x in ns), f"{name} was not launched")
    out["launches"] = launches
    print(json.dumps({"golden_families": {
        f: rs for f, rs in out.items() if f != "launches"}, "card": card}),
        flush=True)
    return out


def host_leftovers(torch, rng, card: str, dev, ont_fq: str, ont_clean,
                   bact_fq: str, oracle16, unique21) -> dict:
    """Phase 14, over phase 5's ONT-like file and phase 8's bacterial
    file and dumps."""
    phase("14 the host leftovers on the card and the six families against "
          "the published algorithms")
    t_phase = time.perf_counter()
    seconds, out = {}, {}
    for name, fn in (
            ("revcomp", lambda: revcomp_checks(torch, rng, card, dev)),
            ("base_counts", lambda: base_count_checks(torch, ont_fq,
                                                      ont_clean, dev)),
            ("kmertypes", lambda: kmertype_checks(torch, rng, ont_clean,
                                                  dev)),
            ("reload", lambda: reload_checks(rng, bact_fq, oracle16,
                                             unique21)),
            ("load_all", lambda: load_all_check(torch, ont_fq, ont_clean,
                                                dev)),
            ("golden", lambda: golden_families(torch, rng, card, dev))):
        t0 = time.perf_counter()
        out[name] = fn()
        seconds[name] = time.perf_counter() - t0
    out["seconds"] = time.perf_counter() - t_phase
    print(json.dumps({"timing": "phase14_s", **seconds,
                      "total": out["seconds"]}), flush=True)
    print(f"phase 14: {out['seconds']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 15: the last interface gaps on the card
# ---------------------------------------------------------------------------

def identity_blocks(tmp: str, bench, m: int = 200,
                    bs: int = 512) -> dict:
    """block_sketch(hash_name="identity") at k=8 (K1) and k=21 (K2) on the
    bench batch, equal to the same call with the plain kernels; then the
    k=8 live blocks' u32 signatures dumped as u64 words (sig_size=8) and
    read back.  The launch counts must be > 0 on a CUDA device."""
    from kmerutils_tpu_torch.io import formats
    from kmerutils_tpu_torch.ops import tournament as T
    from kmerutils_tpu_torch.sketch import block

    # --- the main path: K1 / K2 counts from 0 to what the two calls made ---
    T.launches_u32 = T.launches_u64 = 0
    t0 = time.perf_counter()
    card_res = {k: block.block_sketch(bench, k, m, bs, "identity")
                for k in (8, 21)}
    s = time.perf_counter() - t0
    launches = {"K1": T.launches_u32, "K2": T.launches_u64}
    # -----------------------------------------------------------------------
    print(f"launches on block_sketch(hash_name='identity'): {launches}",
          flush=True)
    check(bench.device.type != "cuda"
          or (launches["K1"] > 0 and launches["K2"] > 0),
          "K1/K2 not launched by the identity block sketch")
    for k, res in card_res.items():
        with plain_kernels():
            want = block.block_sketch(bench, k, m, bs, "identity")
        live = res.live
        bad = int((res.sigs[live] != want.sigs[live]).sum())
        ok = (np.array_equal(live, want.live) and bad == 0
              and res.sigs.dtype == (np.uint32 if k <= 16 else np.uint64)
              and bool((res.sigs[live] < np.uint64(4) ** k).all()))
        print(f"identity blocks k={k}: {int(live.sum())} live blocks of "
              f"{live.size}, {bad} slots differ from the plain path: "
              f"{'equal' if ok else 'DIFFERENT'}", flush=True)
        check(ok, f"identity blocks k={k} != plain path")
    sigs = card_res[8].sigs[card_res[8].live]
    dump = os.path.join(tmp, "sigs_u64words.bin")
    formats.write_signature_dump(dump, 8, sigs, sig_size=8)
    kk, mm, back = formats.read_signature_dump(dump)
    with open(dump, "rb") as f:
        head = np.frombuffer(f.read(16), "<u4").tolist()
    ok = (head == [0xCEABEADD, 8, m, 8] and (kk, mm) == (8, m)
          and back.dtype == np.uint64
          and np.array_equal(back, sigs.astype(np.uint64))
          and os.path.getsize(dump) == 16 + 8 * sigs.size)
    print(f"sig_size=8 dump of {sigs.shape[0]} x {m} u32 signatures: header "
          f"{head}, read back equal: {ok}", flush=True)
    check(ok, "sig_size=8 dump does not read back")
    return {"launches": launches, "card_s": s}


def file_order_checks(torch, fq: str, clean, dev) -> dict:
    """read_batches(bucket=False) on the host and read_batches_overlapped(
    queue_depth=1, bucket=False) onto the card, each equal to the clean
    reads packed in file order (numpy), rows and batches in file order."""
    from kmerutils_tpu_torch.base.sequence import pack_words
    from kmerutils_tpu_torch.io import fastx

    def oracle_ok(batches) -> bool:
        idx = np.concatenate([i for _, i in batches])
        if not np.array_equal(idx, np.arange(len(clean))):
            return False
        for b, i in batches:
            W = b.words.shape[1]
            codes = np.zeros((len(i), 16 * (W - 1)), np.uint8)
            for r, j in enumerate(i):
                codes[r, : clean[j].size] = clean[j]
            words, lengths = pack_words(codes, [clean[j].size for j in i])
            if not (np.array_equal(b.words.cpu().numpy().view(np.uint32),
                                   words)
                    and np.array_equal(b.lengths.cpu().numpy(), lengths)):
                return False
        return True

    t0 = time.perf_counter()
    host = list(fastx.read_batches(fq, bucket=False))
    s_host = time.perf_counter() - t0
    t0 = time.perf_counter()
    st = fastx.IngestStats()
    over = list(fastx.read_batches_overlapped(fq, device=dev, queue_depth=1,
                                              bucket=False, stats=st))
    sync(torch, dev)
    s_over = time.perf_counter() - t0
    on_card = all(b.words.device.type == torch.device(dev).type
                  for b, _ in over)
    ok_host, ok_over = oracle_ok(host), oracle_ok(over)
    same = len(host) == len(over) and all(
        torch.equal(a.words, b.words.cpu()) and np.array_equal(i, j)
        for (a, i), (b, j) in zip(host, over))
    widths = sorted({b.words.shape[1] for b, _ in host})
    print(f"file-order batches: {len(host)} batches of widths {widths} "
          f"words; read_batches(bucket=False) = oracle: {ok_host} "
          f"({s_host:.2f} s); read_batches_overlapped(queue_depth=1) on "
          f"{over[0][0].words.device} = oracle: {ok_over}, = host batches: "
          f"{same} ({s_over:.2f} s); {st.n_reads} reads", flush=True)
    check(ok_host and ok_over and same and on_card
          and st.n_reads == len(clean), "file-order batches != oracle")
    return {"batches": len(host), "host_s": s_host, "overlapped_s": s_over}


def finalize_phases_check(torch, fq: str, oracle16, dev) -> dict:
    """The k=16 table of phase 8's file (the --count path, through the
    library), finalized as --count does with and without phases=: the
    same arrays, equal to phase 8's oracle; the three keys present."""
    from kmerutils_tpu_torch.count import stream
    from kmerutils_tpu_torch.io import fastx
    from kmerutils_tpu_torch.ops import merge as M
    folder = stream.StagedFolder(stream.StreamCountTable.create(
        1 << 27, wide=False, coords=False, device=dev))
    for batch, idx in fastx.read_batches_overlapped(fq, device=dev):
        folder.push(stream.batch_entries(batch, 16, idx))
    table = folder.flush()
    plain = stream.finalize(table, min_count=2, count_clamp=255)

    # --- the main path: K4's count from 0 to what finalize(phases) made ---
    M.reset_launches()
    ph: dict = {}
    t0 = time.perf_counter()
    got = stream.finalize(table, min_count=2, count_clamp=255, phases=ph)
    s = time.perf_counter() - t0
    k4 = M.launches_aggregate
    # -----------------------------------------------------------------------
    print(f"launches on finalize(phases=...): K4 {k4}", flush=True)
    keys, counts = oracle16
    sel = counts >= 2
    same = all(np.array_equal(a, b) and a.dtype == b.dtype
               for a, b in zip(got[:4], plain[:4])) and got[4] == plain[4]
    ok = (same and got[4] == 0
          and np.array_equal(got[0].astype(np.uint64), keys[sel])
          and np.array_equal(got[1].astype(np.int64),
                             np.minimum(counts[sel], 255)))
    print(f"finalize(phases=...): {json.dumps(ph)}; {len(got[0])} records, "
          f"= phases=None: {same}, = phase 8's oracle: {ok} ({s:.3f} s)",
          flush=True)
    check(ok, "finalize(phases=...) != phases=None or the oracle")
    check(set(ph) == {"agg_s", "records", "xfer_s"}
          and ph["records"] == len(got[0]) and ph["agg_s"] > 0
          and ph["xfer_s"] > 0, f"finalize phases {ph}")
    check(torch.device(dev).type != "cuda" or k4 > 0,
          "K4 was not launched by finalize(phases=...)")
    return {"launches": {"K4": k4}, "phases": ph, "seconds": s}


def interface_gaps(torch, rng, card: str, tmp: str, dev, ont_fq: str,
                   ont_clean, bact_fq: str, oracle16,
                   bench_shape=(1024, 6000)) -> dict:
    """Phase 15, over the bench batch, phase 5's ONT-like file and phase
    8's bacterial file and oracle.  Every part also runs with
    ``dev="cpu"`` (a smaller ``bench_shape`` there)."""
    from kmerutils_tpu_torch.base.sequence import pack_codes
    phase("15 the last interface gaps on the card: identity blocks, "
          "file-order batches, queue depth, finalize phases, u64 dump words")
    t_phase = time.perf_counter()
    n, L = bench_shape
    bench = pack_codes(rng.integers(0, 4, size=(n, L), dtype=np.uint8),
                       np.full(n, L, np.int32), device=dev)
    out = {"blocks": identity_blocks(tmp, bench),
           "file_order": file_order_checks(torch, ont_fq, ont_clean, dev),
           "finalize": finalize_phases_check(torch, bact_fq, oracle16, dev)}
    out["seconds"] = time.perf_counter() - t_phase
    print(json.dumps({"timing": "phase15_s", "card": card,
                      "launches": {**out["blocks"]["launches"],
                                   **out["finalize"]["launches"]},
                      "total": out["seconds"]}), flush=True)
    print(f"phase 15: {out['seconds']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 16: KP, the k-mer prefix of the sketches
# ---------------------------------------------------------------------------

KP_SOURCE = "kmerutils_tpu_torch/csrc/kmers.cu"
KP_JAX = "kmerutils_tpu/sketch/jaccard.py:37"
KP_KS = (1, 8, 15, 16, 17, 21, 31, 32)
# (name, rows, width, lengths: "full", "ragged" or explicit)
KP_SHAPES = (("bench", 1024, 6000, "ragged"), ("block", 16384, 512, "full"),
             ("tail", 3, 16377, "ragged"),
             ("short_rows", 8, 40, (0, 1, 7, 15, 16, 20, 31, 40)))
KP_TIMED = (("bench", 8), ("bench", 21), ("block", 8), ("tail", 8))


def kp_batch(rng, n: int, L: int, lengths, dev="cuda"):
    """A packed batch of n random reads of width L: every read full, ragged
    (uniform in [0, L] with a full read, an empty one and one of 7 bases),
    or of the lengths given."""
    from kmerutils_tpu_torch.base.sequence import pack_codes
    codes = rng.integers(0, 4, size=(n, L), dtype=np.uint8)
    if lengths == "full":
        lens = np.full(n, L, np.int32)
    elif lengths == "ragged":
        lens = rng.integers(0, L + 1, size=n).astype(np.int32)
        lens[:3] = (L, 0, 7)[:n]
    else:
        lens = np.asarray(lengths, np.int32)
    return pack_codes(codes, lens, device=dev)


def kmer_prefix_phase(torch, rng, card: str, dev="cuda") -> dict:
    """Phase 16: KP exact against its plain version at ``KP_SHAPES`` for
    every k of ``KP_KS`` and both hashes, timed at ``KP_TIMED``, and its
    launch counter against the calls."""
    from kmerutils_tpu_torch import roofline
    from kmerutils_tpu_torch.ops import kmer_prefix as KP
    from kmerutils_tpu_torch.sketch.jaccard import Sketcher, hashed_kmers
    from kmerutils_tpu_torch.sketch.params import SeqSketcherParams
    phase("16 KP (the k-mer prefix) vs plain (exact) and timing")
    t_phase = time.perf_counter()
    batches = {name: kp_batch(rng, n, L, lens, dev)
               for name, n, L, lens in KP_SHAPES}
    n_checks = 0
    for name, b in batches.items():
        for k in KP_KS:
            for h in ("wang", "identity"):
                got = KP.kmer_prefix(b.words, b.lengths, k, h)
                want = KP.kmer_prefix_ref(b.words, b.lengths, k, h)
                sync(torch, dev)
                check(same(torch, got, want),
                      f"KP != plain at {name} {tuple(b.words.shape)}, k={k}, "
                      f"{h}: {int((got[0] != want[0]).sum())} items, "
                      f"{int((got[1] != want[1]).sum())} valid differ")
                n_checks += 1
        del got, want
    print(f"KP: {n_checks} cases equal to the plain version", flush=True)
    out = {"checks": n_checks, "shapes": {}}
    for name, k in KP_TIMED:
        b = batches[name]
        kern = functools.partial(KP.kmer_prefix, b.words, b.lengths, k)
        plain = functools.partial(KP.kmer_prefix_ref, b.words, b.lengths, k)
        ms, pms, runs = turns(torch, kern, plain, iters=100)
        n, W = b.words.shape
        P = KP.positions(b.words, k)
        nbytes = n * W * 4 + n * 4 + n * P * ((4 if k <= 16 else 8) + 1)
        bound = roofline.bound(nbytes)
        r = {"timing": f"kp_{name}_k{k}", "rows": n, "P": P,
             "ms_plain_kern_kern_plain": runs,
             "enqueue_ms": enqueue_ms(torch, kern, iters=200),
             "device_ms": merge_profile(torch, kern, 50,
                                        "kmer_prefix_kernel")["device_ms"],
             "bytes": nbytes,
             "bound_ms": bound[0], "bound_by": bound[1],
             "bound_share": bound[0] / ms,
             "gpos_per_s": n * P / ms / 1e6}
        print(json.dumps({**r, "card": card}), flush=True)
        out["shapes"][f"{name}_k{k}"] = {
            "ms": ms, "plain_ms": pms, "bound_ms": bound[0],
            "device_ms": r["device_ms"], "enqueue_ms": r["enqueue_ms"]}
    bench = batches["bench"]
    before = KP.launches_prefix
    for k in KP_KS:
        hashed_kmers(bench, k)
    sk = Sketcher(SeqSketcherParams(kmer_size=8, sketch_size=200))
    sk.sketch_batch(bench)
    sync(torch, dev)
    calls = len(KP_KS) + 1
    check(KP.launches_prefix - before == calls,
          f"KP launches {KP.launches_prefix - before} for {calls} calls")
    out["launches"] = KP.launches_prefix - before
    out["seconds"] = time.perf_counter() - t_phase
    print(json.dumps({"timing": "phase16_s", "card": card,
                      "launches": out["launches"],
                      "total": out["seconds"]}), flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 17: KC, the k-mer prefix of counting
# ---------------------------------------------------------------------------

KC_JAX = "kmerutils_tpu/count/stream.py:147"


def uniform_lengths(lo: int, hi: int):
    return lambda rng, n, L: rng.integers(lo, hi + 1, size=n)


def sparse_lengths(rng, n: int, L: int):
    """Most rows below 16 bases (no k-mer at k >= 16), one in 7 of any
    length: runs of empty rows longer than KC's 1,024-output tile."""
    lens = rng.integers(0, 16, size=n)
    lens[::7] = rng.integers(0, L + 1, size=lens[::7].size)
    lens[100:2200] = 0
    return lens


# (name, rows, width, lengths: "ragged", explicit, or a function of (rng,
# n, width)): the count cell's batches (length-sorted reads of 500-16,000
# bases, <= 8 Mi padded bases: its shortest, median and longest rows), a
# --unique -s 21 batch (phase 8's reads are ~6.4 kb) and edges
KC_SHAPES = (("cell_short", 16384, 512, uniform_lengths(480, 512)),
             ("cell_median", 1600, 5232, uniform_lengths(4900, 5232)),
             ("cell_long", 520, 16000, uniform_lengths(15000, 16000)),
             ("unique", 1024, 6000, "ragged"),
             ("tail", 3, 16377, "ragged"),
             ("short_rows", 8, 40, (0, 1, 7, 15, 16, 20, 31, 40)),
             ("mostly_empty", 4096, 64, sparse_lengths))
# (shape, k, coordinates)
KC_TIMED = (("cell_short", 16, False), ("cell_median", 16, False),
            ("cell_long", 16, False), ("unique", 21, True))


def kc_batch(rng, n: int, L: int, lengths, dev="cuda"):
    if callable(lengths):
        lengths = tuple(int(x) for x in lengths(rng, n, L))
    return kp_batch(rng, n, L, lengths, dev)


def plain_entries(torch, batch, k: int, idx, coords: bool):
    """``batch_entries`` as the port computed it before KC: the canonical
    k-mers of base/kmer.py, the valid ones in row order, one stable sort
    of int64 carriers (u64 bit patterns flipped)."""
    from kmerutils_tpu_torch.base import kmer
    from kmerutils_tpu_torch.ops.bitops import flip64
    can, valid, _ = kmer.canonical_kmers(batch, k)
    p = can.shape[1]
    flat = torch.nonzero(valid.reshape(-1)).squeeze(1)
    keys = can.reshape(-1)[flat]
    wide = k > 16
    skeys, perm = torch.sort(flip64(keys) if wide else keys, stable=True)
    key = flip64(skeys) if wide else skeys.to(torch.int32)
    if not coords:
        return key, None
    flat = flat[perm]
    rows = torch.as_tensor(np.asarray(idx, np.int64), device=can.device)
    return key, (rows[flat // p] << 32) | (flat % p)


def same_run(torch, got, want) -> bool:
    return all((g is None and w is None) or (
        g is not None and w is not None and torch.equal(g, w))
        for g, w in zip(got, want))


def device_split(torch, fn, calls: int, kernel: str) -> dict:
    """``calls`` calls of ``fn`` under torch.profiler: device ms a call by
    kernel name (short) and the number of ``kernel`` events, which must be
    one a call (the profiler may lose early events late in a long
    process: then at least half)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ms: dict = {}
    n_kernel = 0
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        name = short_name(ev.name)
        ms[name] = ms.get(name, 0.0) + ev.time_range.elapsed_us() / 1e3
        n_kernel += name.startswith(kernel)
    check(calls // 2 <= n_kernel <= calls,
          f"{kernel}: {n_kernel} device events for {calls} calls")
    return {"calls_recorded": n_kernel,
            "ms": {name: t / n_kernel for name, t in sorted(
                ms.items(), key=lambda x: -x[1])}}


def kc_exact(torch, rng, batches: dict, dev) -> int:
    """KC against its plain version and ``batch_entries`` against the path
    before KC on each batch, at every k of ``KP_KS``, with and without
    coordinates; returns the number of cases (each calls KC twice)."""
    from kmerutils_tpu_torch.count import stream
    from kmerutils_tpu_torch.ops import count_prefix as KC
    n_checks = 0
    for name, b in batches.items():
        idx = rng.permutation(b.n_reads) + 7
        for k in KP_KS:
            offs = KC.offsets(b.host_lengths, k)
            for coords in (False, True):
                got = KC.count_prefix(b.words, b.lengths, k, offs, coords)
                want = KC.count_prefix_ref(b.words, b.lengths, k, offs,
                                           coords)
                run = stream.batch_entries(b, k, idx, coords)
                run_want = plain_entries(torch, b, k, idx, coords)
                sync(torch, dev)
                check(same_run(torch, got, want),
                      f"KC != plain at {name} {tuple(b.words.shape)}, k={k},"
                      f" coords={coords}: {int(offs[-1])} outputs")
                check(same_run(torch, run, run_want),
                      f"batch_entries != the plain path at {name}, k={k}, "
                      f"coords={coords}")
                n_checks += 1
    return n_checks


def count_prefix_phase(torch, rng, card: str, dev="cuda") -> dict:
    """Phase 17: KC exact against its plain version at ``KC_SHAPES`` for
    every k of ``KP_KS`` with and without coordinates, ``batch_entries``
    through it exact against the path before it, no wait for the device
    in ``batch_entries`` of a batch with host lengths, its launch counter
    against the calls, and KC and ``batch_entries`` timed at
    ``KC_TIMED``."""
    from kmerutils_tpu_torch import roofline
    from kmerutils_tpu_torch.count import stream
    from kmerutils_tpu_torch.ops import count_prefix as KC
    phase("17 KC (the k-mer prefix of counting) vs plain (exact) and "
          "timing")
    t_phase = time.perf_counter()
    batches = {name: kc_batch(rng, n, L, lens, dev)
               for name, n, L, lens in KC_SHAPES}
    before = KC.launches_count_prefix
    n_checks = kc_exact(torch, rng, batches, dev)
    launches = KC.launches_count_prefix - before
    check(launches == 2 * n_checks,
          f"KC launches {launches} for {n_checks} calls and as many "
          "batch_entries")
    print(f"KC: {n_checks} cases equal to the plain version, "
          f"batch_entries equal to the plain path; {launches} launches",
          flush=True)
    # no wait for the device: a batch with host lengths, with and without
    # coordinates
    for name, k, coords in (("cell_median", 16, False), ("unique", 21, True)):
        b = batches[name]
        check(b.host_lengths is not None, f"{name} has no host lengths")
        stream.batch_entries(b, k, np.arange(b.n_reads), coords)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            stream.batch_entries(b, k, np.arange(b.n_reads), coords)
        except RuntimeError as e:
            check(False, f"batch_entries waited for the device at {name}: "
                  f"{e}")
        finally:
            torch.cuda.set_sync_debug_mode("default")
    out = {"checks": n_checks, "shapes": {}}
    for name, k, coords in KC_TIMED:
        b = batches[name]
        offs = KC.offsets(b.host_lengths, k)
        kern = functools.partial(KC.count_prefix, b.words, b.lengths, k,
                                 offs, coords)
        plain = functools.partial(KC.count_prefix_ref, b.words, b.lengths,
                                  k, offs, coords)
        ms, pms, runs = turns(torch, kern, plain, iters=100)
        n, W = b.words.shape
        total = int(offs[-1])
        nbytes = n * W * 4 + (n + 1) * 8 + total * (
            (4 if k <= 16 else 8) + (8 if coords else 0))
        bound = roofline.bound(nbytes)
        kc = device_split(torch, kern, 50, "count_prefix_kernel")
        kc_ms = sum(t for nm, t in kc["ms"].items()
                    if nm.startswith("count_prefix_kernel"))
        idx = np.arange(b.n_reads)
        entries = functools.partial(stream.batch_entries, b, k, idx, coords)
        ems = cuda_ms(torch, entries, 50)
        split = device_split(torch, entries, 50, "count_prefix_kernel")
        r = {"timing": f"kc_{name}_k{k}" + ("_coords" if coords else ""),
             "rows": n, "W": W, "outputs": total,
             "ms_plain_kern_kern_plain": runs,
             "enqueue_ms": enqueue_ms(torch, kern, iters=200),
             "device_ms": kc_ms, "device_ms_by_kernel": kc["ms"],
             "bytes": nbytes, "bound_ms": bound[0], "bound_by": bound[1],
             "bound_share_device": bound[0] / kc_ms,
             "goutputs_per_s": total / kc_ms / 1e6,
             "batch_entries_ms": ems,
             "batch_entries_enqueue_ms": enqueue_ms(torch, entries, 50),
             "batch_entries_device_ms": sum(split["ms"].values()),
             "batch_entries_device_ms_by_kernel": split["ms"]}
        print(json.dumps({**r, "card": card}), flush=True)
        out["shapes"][r["timing"][3:]] = {
            "ms": ms, "plain_ms": pms, "bound_ms": bound[0],
            "device_ms": kc_ms, "enqueue_ms": r["enqueue_ms"],
            "batch_entries_device_ms": r["batch_entries_device_ms"]}
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t_phase
    print(json.dumps({"timing": "phase17_s", "card": card,
                      "launches": launches, "total": out["seconds"]}),
          flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 18: KW, the weights stage of ProbMinHash
# ---------------------------------------------------------------------------

KW_SOURCE = "kmerutils_tpu_torch/csrc/weights.cu"
KW_JAX = "kmerutils_tpu/sketch/probminhash.py:178"
# (name, items): ("kp", rows, width, lengths, k) hashes a packed batch
# through KP; ("drawn", rows, P, wide, alphabet) draws items of any value
# (alphabet 0) or of a few values near the top of the range; every case
# then gets a real item equal to the sentinel, an empty row and a valid
# mask that is not a prefix (kw_plant)
KW_SHAPES = (("bench_k8", ("kp", 1024, 6000, "ragged", 8)),
             ("bench_k21", ("kp", 1024, 6000, "ragged", 21)),
             ("block", ("kp", 16384, 512, "full", 8)),
             ("cell_median", ("kp", 1024, 6144, "full", 8)),
             ("cell_long", ("kp", 512, 16384, "full", 8)),
             ("tail", ("drawn", 3, 16370, False, 0)),
             ("short_rows", ("kp", 9, 40, (40, 40, 40, 0, 1, 7, 15, 16, 20),
                             8)),
             ("duplicates_k8", ("drawn", 1024, 5993, False, 5)),
             ("duplicates_k21", ("drawn", 1024, 5980, True, 5)),
             ("duplicates_long", ("drawn", 64, 16377, False, 40)),
             ("cell_k21_12k", ("kp", 512, 12288, "ragged", 21)),
             ("cell_k21_16k", ("kp", 512, 16384, "ragged", 21)),
             ("long_reads", ("kp", 256, 40000, "ragged", 8)),
             ("long_reads_k21", ("kp", 128, 40000, "ragged", 21)),
             ("wide_duplicates", ("drawn", 16, 70000, False, 5)),
             ("wide_tail", ("drawn", 3, 100000, True, 0)))
KW_TIMED = ("bench_k8", "bench_k21", "block", "cell_median", "cell_long",
            "tail", "cell_k21_12k", "cell_k21_16k", "long_reads",
            "long_reads_k21")
# the widest row of a tile class (csrc/weights.cu), by wide (int64): rows
# past it take the wide route (csrc/weights_wide.cu)
KW_WIDEST = {False: 16384, True: 16384}
# widths at and one past each tile class's, and well past the widest
KW_WIDTHS = {False: (512, 513, 1024, 1025, 2048, 2049, 3072, 3073, 4096,
                     4097, 6144, 6145, 8192, 8193, 12288, 12289, 16384,
                     16385, 40000),
             True: (512, 513, 2048, 2049, 4096, 4097, 8192, 8193, 12288,
                    12289, 16384, 16385, 20000)}


def kw_plant(torch, rng, items, valid):
    """Row 0 gets a valid item equal to the all-ones sentinel, row 1 no
    valid position, row 2 a random valid mask (not a prefix)."""
    n, P = items.shape
    items[0, min(3, P - 1)] = -1
    valid[0, min(3, P - 1)] = True
    if n > 1:
        valid[1] = False
    if n > 2:
        valid[2] = torch.as_tensor(rng.random(P) < 0.5, device=valid.device)
    return items, valid


def kw_items(torch, rng, spec, dev="cuda"):
    """(items, valid) of a KW_SHAPES spec on ``dev``."""
    from kmerutils_tpu_torch.sketch.jaccard import hashed_kmers
    if spec[0] == "kp":
        _, n, L, lengths, k = spec
        items, valid = hashed_kmers(kp_batch(rng, n, L, lengths, dev), k)
    else:
        _, n, P, wide, alphabet = spec
        ut = np.uint64 if wide else np.uint32
        top = np.iinfo(ut).max
        if alphabet:
            pool = top - rng.integers(0, 4 * alphabet, size=alphabet,
                                      dtype=np.int64).astype(ut)
            x = rng.choice(pool, size=(n, P))
        else:
            x = rng.integers(0, top, size=(n, P), dtype=ut, endpoint=True)
        items = torch.as_tensor(x.view(np.int64 if wide else np.int32),
                                device=dev)
        lens = rng.integers(0, P + 1, size=n)
        valid = torch.as_tensor(np.arange(P)[None, :] < lens[:, None],
                                device=dev)
    return kw_plant(torch, rng, items.clone(), valid.clone())


def kw_same(torch, got, want) -> bool:
    """Bit for bit: s, winv (as int32 words) and is_real."""
    return (torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
            and torch.equal(got[1].view(torch.int32),
                            want[1].view(torch.int32)))


def kw_check(torch, items, valid, what: str) -> None:
    from kmerutils_tpu_torch.ops import weights as KW
    got = KW.sort_weights(items, valid)
    want = KW.sort_weights_ref(items, valid)
    sync(torch, items.device)
    check(kw_same(torch, got, want),
          f"KW != plain at {what} {tuple(items.shape)} {items.dtype}: "
          f"{[int((g != w).sum()) for g, w in zip(got, want)]} positions "
          "of s, winv, is_real differ")


def kw_kernels(torch, fn, calls: int = 20) -> dict:
    """Device ms a call of each kernel that ``calls`` calls of ``fn`` (a
    KW call) ran, by short name, under torch.profiler.  The profiler can
    lose the first events of a session late in a long process: a session
    that kept fewer than half of the calls' last KW kernel
    (sort_weights_kernel, or sort_weights_runs_kernel on the wide route)
    is run again, at most twice."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        ms: dict = {}
        kept = 0
        for ev in prof.events():
            if ev.device_type != DeviceType.CUDA:
                continue
            name = short_name(ev.name)
            ms[name] = ms.get(name, 0.0) + ev.time_range.elapsed_us() / 1e3
            kept += name.startswith(("sort_weights_kernel",
                                     "sort_weights_runs_kernel"))
        if kept >= calls // 2:
            break
        print(f"the profiler kept {kept} KW events of {calls} calls; "
              f"profiling again", flush=True)
    check(calls // 2 <= kept <= calls,
          f"KW profile: {kept} events of {sorted(ms)} for {calls} calls")
    return {name: t / kept for name, t in sorted(ms.items(),
                                                 key=lambda x: -x[1])}


def kw_route(kernels: dict) -> str:
    """The route of a KW call from its kernels (kw_kernels): "tile"
    (sort_weights_kernel alone) or "wide" (sort_weights_keys_kernel,
    CUB's segmented sort and sort_weights_runs_kernel)."""
    names = {n.split("<")[0] for n in kernels}
    ours = {n for n in names if n.startswith("sort_weights")}
    if ours == names == {"sort_weights_kernel"}:
        return "tile"
    if ours == {"sort_weights_keys_kernel", "sort_weights_runs_kernel"}:
        return "wide"
    return f"unknown {sorted(names)}"


def weights_phase(torch, rng, card: str, dev="cuda") -> dict:
    """Phase 18: KW exact against its plain version at ``KW_SHAPES`` and at
    ``KW_WIDTHS`` (every tile class full and one position past it, and the
    wide route), the route at the widest class and one past it; timed at
    ``KW_TIMED`` against the plain version and ``torch.sort(dim=1)``; its
    launch counter against ``sketch_batch`` calls."""
    from kmerutils_tpu_torch import roofline
    from kmerutils_tpu_torch.ops import weights as KW
    from kmerutils_tpu_torch.sketch.jaccard import Sketcher
    from kmerutils_tpu_torch.sketch.params import SeqSketcherParams
    phase("18 KW (the weights stage) vs plain (exact) and timing")
    t_phase = time.perf_counter()
    launches0 = KW.launches_weights
    cases = {name: kw_items(torch, rng, spec, dev)
             for name, spec in KW_SHAPES}
    n_checks = 0
    for name, (items, valid) in cases.items():
        kw_check(torch, items, valid, name)
        n_checks += 1
    for wide in (False, True):
        for i, P in enumerate(KW_WIDTHS[wide]):
            items, valid = kw_items(
                torch, rng, ("drawn", 48, P, wide, 3 if i % 2 else 0), dev)
            kw_check(torch, items, valid, f"width {P}")
            n_checks += 1
    routes = {}
    for wide in (False, True):
        for P in (KW_WIDEST[wide], KW_WIDEST[wide] + 1):
            items, valid = kw_items(torch, rng, ("drawn", 8, P, wide, 7),
                                    dev)
            routes[f"{'u64' if wide else 'u32'} P={P}"] = route = \
                kw_route(kw_kernels(torch, functools.partial(
                    KW.sort_weights, items, valid)))
            check(route == ("tile" if P <= KW_WIDEST[wide] else "wide"),
                  f"KW at P={P} wide={wide} took the {route} route")
    launches = KW.launches_weights - launches0
    check(launches >= n_checks,
          f"KW: {launches} launches for {n_checks} checked calls")
    print(f"KW: {n_checks} cases equal to the plain version, {launches} "
          f"launches, routes {routes}", flush=True)
    out = {"checks": n_checks, "shapes": {}, "routes": routes}
    for name in KW_TIMED:
        items, valid = cases[name]
        n, P = items.shape
        kern = functools.partial(KW.sort_weights, items, valid)
        plain = functools.partial(KW.sort_weights_ref, items, valid)
        lib = functools.partial(torch.sort, items, dim=1)
        l1 = cuda_ms(torch, lib, 20)
        ms, pms, runs = turns(torch, kern, plain, iters=100, plain_iters=10)
        l2 = cuda_ms(torch, lib, 20)
        isz = items.element_size()
        nbytes = n * P * (2 * isz + 1 + 4 + 1)
        bound = roofline.bound(nbytes)
        if P <= KW_WIDEST[items.dtype == torch.int64]:
            route = "tile"
            dms = merge_profile(torch, kern, 50,
                                "sort_weights_kernel")["device_ms"]
            split = None
        else:
            route = "wide"
            split = kw_kernels(torch, kern)
            dms = sum(split.values())
        r = {"timing": f"kw_{name}", "rows": n, "P": P,
             "dtype": str(items.dtype), "route": route,
             "ms_plain_kern_kern_plain": runs, "library_ms": [l1, l2],
             "enqueue_ms": enqueue_ms(torch, kern, iters=200),
             "device_ms": dms, "device_ms_by_kernel": split,
             "bytes": nbytes, "bound_ms": bound[0], "bound_by": bound[1],
             "bound_share_device": bound[0] / dms,
             "gpos_per_s": n * P / dms / 1e6}
        print(json.dumps({**r, "card": card}), flush=True)
        out["shapes"][name] = {
            "ms": ms, "plain_ms": pms, "bound_ms": bound[0],
            "device_ms": dms, "enqueue_ms": r["enqueue_ms"],
            "library_ms": min(l1, l2)}
    # the main path: one launch a sketch_batch call
    bench = kp_batch(rng, 1024, 6000, "ragged", dev)
    before = KW.launches_weights
    for k in (8, 21):
        Sketcher(SeqSketcherParams(kmer_size=k, sketch_size=200)
                 ).sketch_batch(bench)
    sync(torch, dev)
    check(KW.launches_weights - before == 2,
          f"sketch_batch: {KW.launches_weights - before} KW launches for 2 "
          f"calls")
    out["launches"] = KW.launches_weights - launches0
    out["seconds"] = time.perf_counter() - t_phase
    print(json.dumps({"timing": "phase18_s", "card": card,
                      "launches": out["launches"],
                      "total": out["seconds"]}), flush=True)
    return out


# ---------------------------------------------------------------------------
# --baseline: K1-K7 and G1/G2 of this tree against another tree's, in
# turns
# ---------------------------------------------------------------------------

def load_port(root: str, name: str = "baseline_port"):
    """The port's package in the tree ``root``, imported as ``name`` beside
    this tree's (its modules import each other relatively; its kernels
    build into root/build/)."""
    pkg = os.path.join(os.path.abspath(root), "kmerutils_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    check(spec is not None, f"no kmerutils_tpu_torch package in {root}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def against_baseline(torch, rng, root: str, card: str, ipd: dict,
                     m: int = 200) -> None:
    phase(f"A/B: K1/K2, K3-K6, K7 and G1/G2 of this tree against the port "
          f"in {root}")
    from kmerutils_tpu_torch import roofline
    from kmerutils_tpu_torch.ops import tournament as T
    from kmerutils_tpu_torch.profile_sketch import profile
    load_port(root)
    base_build = importlib.import_module("baseline_port._build")
    base_build.load()
    print(f"baseline kernels built in "
          f"{base_build.build_info.get('seconds', 0.0):.2f} s", flush=True)
    for name, r in roofline.tournament_instructions_per_draw(
            base_build.library_path()).items():
        print(f"baseline SASS {name[:60]}: inner loop {r['instructions']} "
              f"instructions for {r['draws']} draws")
    bounds = Bounds(torch, ipd)
    impls = {"baseline": importlib.import_module(
        "baseline_port.ops.tournament"), "this": T}
    order = ("baseline", "this", "this", "baseline")
    for name, args in tournament_shapes(torch, rng, random_batch(rng, 1024,
                                                                 6000),
                                        collection=True):
        want = tournament_fn(T, args, m, plain=True)()
        fns = {k: tournament_fn(mod, args, m) for k, mod in impls.items()}
        for k, fn in fns.items():
            check(same(torch, fn(), want), f"{name}: {k} kernel != plain")
        iters = max(3, min(50, int(200 / max(0.05, cuda_ms(torch,
                                                          fns["this"], 1)))))
        res = {k: {"ms": [], "enqueue_ms": []} for k in fns}
        for k in order:
            res[k]["ms"].append(cuda_ms(torch, fns[k], iters))
        for k in order:
            res[k]["enqueue_ms"].append(enqueue_ms(torch, fns[k]))
        for k in fns:
            res[k]["device_ms"] = profile(fns[k], 5)["device_ms_per_call"]
        bound = bounds.tournament(args, m)
        print(json.dumps({"timing": name, "rows": args[-1].shape[0],
                          "P": args[-1].shape[1], "iters": iters, **res,
                          "bound_ms": bound[0], "bound_by": bound[1],
                          "card": card}), flush=True)
        del args, want, fns
        torch.cuda.empty_cache()
    merge_against_baseline(torch, rng, card, bounds, order)
    aggregate_against_baseline(torch, rng, card, bounds, order)
    k7_against_baseline(torch, rng, card, bounds, order)
    grid_against_baseline(torch, rng, card, order)
    mains = {"baseline": importlib.import_module(
        "baseline_port.cli.datasketcher").main, "this": datasketcher_main()}
    with tempfile.TemporaryDirectory() as tmp:
        fq = os.path.join(tmp, "ont10k.fastq")
        write_ont_fastq(fq, rng, 10_000, 7)
        argv = ["-f", fq, "-s", str(m), "-k", "8", "-b", "512", "-d",
                os.path.join(tmp, "sigs.bin"), "--device", "cuda"]
        res = {k: [] for k in mains}
        for k in order:
            res[k].append(cli_profile(mains[k], argv))
    print(json.dumps({"timing": "datasketcher_b512_k8", **res,
                      "card": card}), flush=True)
    parsefastq_against_baseline(torch, rng, card, order)


def parsefastq_against_baseline(torch, rng, card: str, order, pkgs=None,
                                count_repeats: int = 3) -> None:
    """Phase 8's ``parsefastq kmer --count -s 16`` and ``--unique -s 21``
    walls of several trees on one seeded bacterial file, in turns.
    ``pkgs`` maps a name of ``order`` to a port package (default: the
    baseline imported by :func:`load_port` and this tree's); each tree's
    ``--count`` runs once untimed first, to build its kernels and parser."""
    pkgs = pkgs or {"baseline": "baseline_port",
                    "this": "kmerutils_tpu_torch"}
    mains = {k: importlib.import_module(p + ".cli.parsefastq").main
             for k, p in pkgs.items()}
    with tempfile.TemporaryDirectory() as tmp:
        fq = os.path.join(tmp, "bact.fastq")
        reads = write_genome_fastq(fq, rng, 10_000, 4_600_000, 0.06)
        mbases = sum(r.size for r in reads) / 1e6
        del reads
        for flags, reps in ((["--count", "-s", "16"], count_repeats),
                            (["--unique", "-s", "21"], 1)):
            argv = ["-f", fq, "--device", "cuda", "kmer", *flags]
            if flags[0] == "--count":
                for k in pkgs:
                    check(run_parsefastq(argv, tmp, mains[k])[0] == 0,
                          f"{k}: parsefastq {' '.join(flags)} failed")
            walls = {k: [] for k in pkgs}
            for k in order:
                for _ in range(reps):
                    rc, _, err, w = run_parsefastq(argv, tmp, mains[k])
                    check(rc == 0 and "WARNING" not in err,
                          f"{k}: parsefastq {' '.join(flags)} failed")
                    walls[k].append(w)
            print(json.dumps({
                "timing": f"parsefastq_{flags[0][2:]}_k{flags[2]}",
                "s": walls, "mbases": mbases,
                "mbases_per_s": {k: [mbases / w for w in v]
                                 for k, v in walls.items()},
                "card": card}), flush=True)


def merge_against_baseline(torch, rng, card: str, bounds: Bounds,
                           order) -> None:
    """K3/K5 of the baseline tree (imported as baseline_port) and of this
    tree through their public wrappers at phase 7's four timed shapes: both
    equal to the plain version, then CUDA-event ms and profiler device ms
    in turns."""
    from kmerutils_tpu_torch.ops import merge as M
    mods = {"baseline": importlib.import_module("baseline_port.ops.merge"),
            "this": M}
    for name, what, args, nbytes in merge_shapes(torch, rng):
        fns = {k: getattr(mod, name) for k, mod in mods.items()}
        for k, fn in fns.items():
            merge_check(torch, fn, getattr(M, name + "_ref"), args,
                        f"{what} ({k})")
        calls = {k: functools.partial(fn, *args) for k, fn in fns.items()}
        res = {k: {"ms": [], "device_ms": []} for k in fns}
        for k in order:
            res[k]["ms"].append(cuda_ms(torch, calls[k], 10))
        for k in order:
            res[k]["device_ms"].append(
                merge_profile(torch, calls[k])["device_ms"])
        print(json.dumps({"timing": name, "shape": what, **res,
                          "bound_ms": bounds.bytes(nbytes)[0],
                          "card": card}), flush=True)
        del args, fns, calls
        torch.cuda.empty_cache()


def aggregate_against_baseline(torch, rng, card: str, bounds: Bounds,
                               order) -> None:
    """K4/K6 of the baseline tree (imported as baseline_port) and of this
    tree through their public wrappers at phase 7's timed shapes: both
    equal to the plain version, then CUDA-event ms and profiler device ms
    in turns."""
    from kmerutils_tpu_torch.ops import merge as M
    from kmerutils_tpu_torch.profile_sketch import profile
    mods = {"baseline": importlib.import_module("baseline_port.ops.merge"),
            "this": M}
    for sentinel, args, what in aggregate_shapes(torch, rng):
        name = agg_fns(M, sentinel)[0].__name__
        want = agg_fns(M, sentinel)[1](*args)
        fns = {k: functools.partial(agg_fns(mod, sentinel)[0], *args)
               for k, mod in mods.items()}
        for k, fn in fns.items():
            got = fn()
            torch.cuda.synchronize()
            check(got[3] == want[3] and compare(
                torch, got[:3], want[:3],
                args[0].numel() if sentinel else got[3]) == (0, 0),
                f"{name} at {what}: {k} kernel != plain")
            del got
        res = {k: {"ms": [], "device_ms": []} for k in fns}
        for k in order:
            res[k]["ms"].append(cuda_ms(torch, fns[k], 10))
        for k in order:
            res[k]["device_ms"].append(
                profile(fns[k], 5)["device_ms_per_call"])
        print(json.dumps({"timing": name, "shape": what, **res,
                          "bound_ms": bounds.bytes(aggregate_bytes(
                              args, want[3]))[0], "card": card}), flush=True)
        del want, fns, args
        torch.cuda.empty_cache()


def grid_against_baseline(torch, rng, card: str, order) -> None:
    """G1 / G2 of the baseline tree (imported as baseline_port) and of this
    tree through their public wrappers at phase 11's three timed shapes:
    each tree's SASS count per pair, every result equal to the plain
    version, then CUDA-event ms, host ms to enqueue one call and profiler
    device ms (the output's fill and the kernel) in turns; then the same
    three for HLL's whole ``sketch_batch`` of the bench batch (k=8 and
    k=21), both trees' registers equal."""
    from kmerutils_tpu_torch import _build, roofline as rl
    from kmerutils_tpu_torch.ops import sketch_grid as G
    from kmerutils_tpu_torch.profile_sketch import profile
    base = {m: importlib.import_module("baseline_port." + m)
            for m in ("_build", "roofline", "ops.sketch_grid")}
    for k, r in (("baseline", base["roofline"].grid_instructions_per_pair(
            base["_build"].library_path())),
                 ("this", rl.grid_instructions_per_pair(
                     _build.library_path()))):
        print(json.dumps({"sass": k, **{name: {
            "per_pair": v["instructions_per_draw"],
            "pipes_per_pair": v.get("pipes_per_draw")}
            for name, v in r.items()}}), flush=True)
    mods = {"baseline": base["ops.sketch_grid"], "this": G}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = rl.sm_clock_hz()
    bench = random_batch(rng, 1024, 6000)
    for shape, g1, g2 in grid_timed_shapes(torch, bench):
        for name, args in (("grid_min", g1), ("grid_max", g2)):
            want = getattr(G, name + "_ref")(*args)
            fns = {k: functools.partial(getattr(mod, name), *args)
                   for k, mod in mods.items()}
            for k, fn in fns.items():
                check(torch.equal(fn(), want), f"{name} at {shape}: {k} "
                      f"kernel != plain")
            res = {k: {"ms": [], "enqueue_ms": []} for k in fns}
            for k in order:
                res[k]["ms"].append(cuda_ms(torch, fns[k], 20))
            for k in order:
                res[k]["enqueue_ms"].append(enqueue_ms(torch, fns[k]))
            for k in fns:
                res[k]["device_ms"] = profile(fns[k], 5)["device_ms_per_call"]
            ops, nbytes = rl.grid_work(name, args)
            pairs = int(args[-2].sum()) * args[-1].numel()
            print(json.dumps({"timing": f"{name}_{shape}",
                              "rows": args[0].shape[0],
                              "P": args[0].shape[1], **res,
                              "bound_ms": rl.bound(nbytes, ops, sms,
                                                   clock)[0],
                              "alu_floor_ms": rl.alu_floor_ms(
                                  pairs, sms, clock)
                              if name == "grid_max" else None,
                              "card": card}), flush=True)
            del want, fns
        del g1, g2
    for k in (8, 21):               # HLL's whole sketch_batch, which runs G2
        fns = {key: functools.partial(hll_sketcher(pkg, k).sketch_batch,
                                      bench)
               for key, pkg in (("baseline", "baseline_port"),
                                ("this", "kmerutils_tpu_torch"))}
        check(torch.equal(fns["baseline"](), fns["this"]()),
              f"HLL sketch_batch k={k}: this tree != the baseline")
        res = {key: {"ms": [], "enqueue_ms": []} for key in fns}
        for key in order:
            res[key]["ms"].append(cuda_ms(torch, fns[key], 20))
        for key in order:
            res[key]["enqueue_ms"].append(enqueue_ms(torch, fns[key]))
        for key in fns:
            res[key]["device_ms"] = profile(fns[key],
                                            5)["device_ms_per_call"]
        print(json.dumps({"timing": f"hll_sketch_batch_k{k}",
                          "rows": bench.n_reads, **res,
                          "card": card}), flush=True)
    del bench
    torch.cuda.empty_cache()


def hll_sketcher(pkg: str, k: int, m: int = 200):
    """An HLL ``Sketcher`` of the port package ``pkg`` (this tree's, or a
    baseline's imported by :func:`load_port`)."""
    params = importlib.import_module(pkg + ".sketch.params")
    return importlib.import_module(pkg + ".sketch.jaccard").Sketcher(
        params.SeqSketcherParams(kmer_size=k, sketch_size=m,
                                 algo=params.SketchAlgo.HLL))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Smoke test of the PyTorch + CUDA port on one GPU.")
    ap.add_argument("--baseline", metavar="ROOT", default=None,
                    help="compare K1/K2, K3-K6, K7 and G1/G2 with the port "
                         "in this tree instead of running the smoke test")
    args = ap.parse_args(argv)
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
    if args.baseline:
        try:
            card = environment(torch)
            against_baseline(torch, rng, args.baseline, card, build())
        except SmokeFailure as e:
            print(f"FAIL: {e}", file=sys.stderr)
            return 1
        print(card)
        return 0
    try:
        card = environment(torch)
        bounds = Bounds(torch, build())
        err1 = max(k1_vs_plain(torch, rng, "cuda"),
                   k1_rungs_vs_plain(torch, rng, "cuda"))
        k1_threshold_check(torch)
        err2 = k2_vs_plain(torch, rng, "cuda")
        with tempfile.TemporaryDirectory() as tmp:
            launches, fq8, clean8 = slice_runs(torch, rng, tmp, card, "cuda")
            t = timings(torch, rng, card, bounds)
            m = merge_kernels_vs_plain(torch, rng, card, bounds)
            launches8, bact_reads, walls8, oracle16, unique21 = \
                counting_runs(torch, rng, tmp, card, "cuda")
            launches.update(launches8)
            k7 = k7_and_exact(torch, rng, card, bounds)
            torch.cuda.empty_cache()
            rest_of_datasketcher(torch, rng, tmp, card, "cuda", fq8, clean8,
                                 bounds)
            torch.cuda.empty_cache()
            g = sketch_families(torch, rng, tmp, card, "cuda", fq8, clean8)
            torch.cuda.empty_cache()
            p12 = anchors_quality_filters(torch, rng, tmp, card, "cuda", fq8,
                                          clean8, os.path.join(tmp,
                                                               "bact.fastq"))
            torch.cuda.empty_cache()
            p13 = sharded_path(torch, rng, card, os.path.join(tmp,
                                                              "bact.fastq"),
                               bact_reads, walls8, oracle16, "cuda")
            torch.cuda.empty_cache()
            host_leftovers(torch, rng, card, "cuda", fq8, clean8,
                           os.path.join(tmp, "bact.fastq"), oracle16,
                           unique21)
            torch.cuda.empty_cache()
            interface_gaps(torch, rng, card, tmp, "cuda", fq8, clean8,
                           os.path.join(tmp, "bact.fastq"), oracle16)
            torch.cuda.empty_cache()
            kp = kmer_prefix_phase(torch, rng, card)
            torch.cuda.empty_cache()
            kc = count_prefix_phase(torch, rng, card)
            torch.cuda.empty_cache()
            kw = weights_phase(torch, rng, card)
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    # bound_ms / library_ms of the shape "ms" was taken at; library_ms is
    # null where no one PyTorch call computes the kernel's function
    k1, k2 = t["bench_k8"], t["bench_k21"]
    kernels = [
        {"name": "weighted_tournament", "route": "cuda", "source": SOURCE,
         "replaces": K1_TPU, "launches": launches["u32"], "mismatches": 0,
         "max_abs_err": err1, "ms": k1["ms"], "plain_ms": k1["plain_ms"],
         "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
         "library_ms": None,
         "block_shape_ms": t["block_k8"]["ms"],
         "block_shape_bound_ms": t["block_k8"]["bound_ms"],
         "tail_shape_ms": t["tail_k8"]["ms"],
         "tail_shape_bound_ms": t["tail_k8"]["bound_ms"]},
        {"name": "weighted_tournament_u64", "route": "cuda", "source": SOURCE,
         "replaces": K2_TPU, "launches": launches["u64"], "mismatches": 0,
         "max_abs_err": err2, "ms": k2["ms"], "plain_ms": k2["plain_ms"],
         "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
         "library_ms": None},
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
            "bound_ms": r["bound_ms"][0], "bound_by": "bytes",
            "library_ms": r["library_ms"][0],
            "ms_each_shape": r["ms"], "plain_ms_each_shape": r["plain_ms"],
            "bound_ms_each_shape": r["bound_ms"],
            "library_ms_each_shape": r["library_ms"]})
        if k in ("K3", "K5"):   # profiler device time of one wrapper call
            kernels[-1].update(device_ms=r["device_ms"][0],
                               device_ms_each_shape=r["device_ms"])
    kernels.append({
        "name": "compact_live", "route": "cuda", "source": MERGE_SOURCE,
        "replaces": K7_TPU, "launches": k7["launches"],
        "mismatches": k7["mismatches"], "max_abs_err": k7["max_abs_err"],
        "ms": k7["ms"], "plain_ms": k7["plain_ms"],
        "bound_ms": k7["bound_ms"], "bound_by": "bytes",
        "library_ms": k7["plain_ms"], "device_ms": k7["device_ms"],
        "ms_each_shape": [r["ms"] for r in k7["shapes"]],
        "device_ms_each_shape": [r["device_ms"] for r in k7["shapes"]],
        "plain_ms_each_shape": [r["plain_ms"] for r in k7["shapes"]],
        "bound_ms_each_shape": [r["bound_ms"] for r in k7["shapes"]]})
    for name, key, tpu in (("grid_min", "G1", G1_JAX),
                           ("grid_max", "G2", G2_JAX)):
        r = g[name]
        kernels.append({
            "name": name, "route": "cuda", "source": G1_SOURCE,
            "replaces": tpu, "launches": g["launches"][key],
            "mismatches": 0, "max_abs_err": r["max_abs_err"],
            "ms": r["bench_k8"]["ms"], "plain_ms": r["bench_k8"]["plain_ms"],
            "bound_ms": r["bench_k8"]["bound_ms"],
            "bound_by": r["bench_k8"]["bound_by"], "library_ms": None,
            "alu_floor_ms": r["bench_k8"]["alu_floor_ms"],
            "ops_per_pair": r["bench_k8"]["ops_per_pair"],
            "sass_per_pair": r["sass_per_pair"],
            "sass_pipes_per_pair": r["sass_pipes_per_pair"],
            **{f"{k}_each_shape": {s: r[s][k] for s in GRID_TIMED
                                   + (GRID_CELL_TIMED,) if s in r}
               for k in ("ms", "plain_ms", "bound_ms")}})
    # G1 also runs on phase 12's path (seqminhash's SuperMinHash); K3, K4,
    # K5 and G2 on phase 13's sharded path
    kernels[-2]["launches_phase12"] = p12["anchors"]["launches_G1"]
    for kern in kernels:
        key = {"merge_fold": "K3", "aggregate_fold": "K4",
               "merge_sorted": "K5", "grid_max": "G2"}.get(kern["name"])
        if key:
            kern["launches_phase13"] = p13["launches"][key]
    kp_bench = kp["shapes"]["bench_k8"]
    kernels.append({
        "name": "kmer_prefix", "route": "cuda", "source": KP_SOURCE,
        "replaces": None, "jax_function": KP_JAX,
        "launches": launches["kp"], "launches_phase16": kp["launches"],
        "mismatches": 0, "max_abs_err": 0,
        "ms": kp_bench["ms"], "plain_ms": kp_bench["plain_ms"],
        "bound_ms": kp_bench["bound_ms"], "bound_by": "bytes",
        "library_ms": None, "device_ms": kp_bench["device_ms"],
        **{f"{k}_each_shape": {s: r[k] for s, r in kp["shapes"].items()}
           for k in ("ms", "plain_ms", "bound_ms", "device_ms")}})
    kc_cell = kc["shapes"]["cell_median_k16"]
    kernels.append({
        "name": "count_prefix", "route": "cuda", "source": KP_SOURCE,
        "replaces": None, "jax_function": KC_JAX,
        "launches": launches["KC"],
        "launches_unique21": launches["KC_unique21"],
        "launches_phase17": kc["launches"],
        "mismatches": 0, "max_abs_err": 0,
        "ms": kc_cell["ms"], "plain_ms": kc_cell["plain_ms"],
        "bound_ms": kc_cell["bound_ms"], "bound_by": "bytes",
        "library_ms": None, "device_ms": kc_cell["device_ms"],
        **{f"{k}_each_shape": {s: r[k] for s, r in kc["shapes"].items()}
           for k in ("ms", "plain_ms", "bound_ms", "device_ms",
                     "batch_entries_device_ms")}})
    kw_cell = kw["shapes"]["cell_median"]
    kernels.append({
        "name": "sort_weights", "route": "cuda", "source": KW_SOURCE,
        "replaces": None, "jax_function": KW_JAX,
        "launches": launches["kw"], "launches_phase18": kw["launches"],
        "mismatches": 0, "max_abs_err": 0,
        "ms": kw_cell["ms"], "plain_ms": kw_cell["plain_ms"],
        "bound_ms": kw_cell["bound_ms"], "bound_by": "bytes",
        "library_ms": kw_cell["library_ms"],
        "device_ms": kw_cell["device_ms"],
        **{f"{k}_each_shape": {s: r[k] for s, r in kw["shapes"].items()}
           for k in ("ms", "plain_ms", "bound_ms", "device_ms",
                     "library_ms")}})
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
