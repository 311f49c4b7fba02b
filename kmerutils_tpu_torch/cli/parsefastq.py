"""parsefastq CLI: base statistics + k-mer counting / unicity.

Port of kmerutils_tpu/cli/parsefastq.py, same flags plus ``--device``:

    parsefastq -f <file> [-b nb_bits] [--batch-reads N] [--device cuda|cpu]
               kmer (--count | --unique) [-s kmer_size] [-t n_threads]
               [-c counter_size] [--capacity N] [--no-spill]
    parsefastq -f <file> ret -b <base>

Always computes the base / read-length statistics ("bases.histo",
"readlen.histo" in the working directory).  Counting writes
<file>.multi_kmer.bin (counts >= 2, clamped to the counter size, ascending
key order); unicity writes <file>.once_kmer.bin with each unique k-mer's
(read, position) in scan order.  Both files and the histograms are
byte-identical to the JAX CLI's.  Each batch's k-mers are sorted on the
device and folded into the streaming count table by
``count/stream.StreamCounter`` (kernels K3-K5); growth, staging and disk
spill follow the JAX CLI.  ``-t`` is
accepted for interface parity.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch


def build_parser():
    p = argparse.ArgumentParser(prog="parsefastq")
    p.add_argument("-f", "--file", required=True, dest="filename")
    p.add_argument("-b", "--bits", type=int, default=2, dest="nb_bits",
                   help="bits per base for in-memory packing (2|4|8)")
    p.add_argument("--batch-reads", type=int, default=10000)
    p.add_argument("--device", default="cuda",
                   help="torch device that counts (default cuda)")
    sub = p.add_subparsers(dest="cmd")
    km = sub.add_parser("kmer", help="kmer counting")
    g = km.add_mutually_exclusive_group(required=True)
    g.add_argument("--count", action="store_true")
    g.add_argument("--unique", action="store_true")
    km.add_argument("-s", "--size", type=int, default=16, dest="kmer_size")
    km.add_argument("-t", "--threads", type=int, default=1,
                    help="accepted for parity; batching replaces threads")
    km.add_argument("-c", "--counter", type=int, default=8, dest="counter_size",
                    help="bits per count in the dump (8 or 16)")
    km.add_argument("--capacity", type=int, default=0,
                    help="device count-table capacity in entries; 0 = size "
                         "from the file")
    km.add_argument("--no-spill", action="store_true",
                    help="disable host spill segments; past-capacity "
                         "entries drop (largest keys) with a warning.  "
                         "Default is exact counting at any cardinality via "
                         "disk spill (count/spill.py)")
    ret = sub.add_parser("ret", help="return times (reserved)")
    ret.add_argument("-b", "--base", type=str, default="A")
    return p


def _auto_capacity(filename: str, coords: bool) -> int:
    """Size the count table from the file: distinct kmers <= total kmers
    ~ bases ~ half the FASTQ byte size (gz estimated at 2.5x expansion).
    Clamp to [2^20, cap_max] entries and add 50% headroom for pending
    duplicate entries."""
    import os
    size = os.path.getsize(filename)
    if filename.endswith(".gz"):
        size = int(size * 2.5)
    est_kmers = max(size // 2, 1)
    cap_max = 27 if coords else 28
    return 1 << max(20, min(cap_max, (int(est_kmers * 1.5) - 1).bit_length()))


def _write_unique(out: str, k: int, keys, frn, fps) -> None:
    order = np.argsort((frn.astype(np.uint64) << np.uint64(32)) | fps,
                       kind="stable")  # scan order
    from ..io import formats
    formats.write_unique_kmer_dump(out, k, keys[order], frn[order],
                                   fps[order])


def main(argv=None):
    from ..io import fastx
    from ..io import formats
    from .. import stats

    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    t0 = time.time()
    st = fastx.IngestStats()
    dist = stats.ReadBaseDistribution.new()

    if args.cmd == "kmer":
        k = args.kmer_size
        if k == 15 or k > 32:
            print(f"kmer size {k} unsupported (14-max u32 / 16 / 17..32)",
                  file=sys.stderr)
            return 1
        from ..count import stream
        # --unique needs first-occurrence coordinates; --count does not
        coords = not args.count
        counter = stream.StreamCounter(
            k, coords=coords,
            capacity_max=args.capacity or _auto_capacity(args.filename,
                                                         coords),
            device=device, spill=not args.no_spill)
        for batch, idx in fastx.read_batches_overlapped(
                args.filename, device=device, batch_reads=args.batch_reads,
                stats=st):
            dist.record_batch(batch)
            # read numbers come from idx: the port's batches are always
            # length-sorted, so rows are not in file order
            counter.add(batch, idx)
        bpc = 1 if args.counter_size <= 8 else 2
        if args.count:
            blocks, dropped = counter.finish(
                min_count=2, count_clamp=(1 << (8 * bpc)) - 1)
            out = args.filename + ".multi_kmer.bin"
            if counter.n_segments:
                with formats.MultipleKmerDumpWriter(out, k, bpc) as w:
                    for mk, mc, _mr, _mp in blocks:
                        w.write(mk, mc)
                print(f"dumped {w.n} multiple kmers to {out} "
                      f"({counter.n_segments} spill segments merged)")
            else:
                [(keys, counts, _, _)] = blocks
                n = formats.write_multiple_kmer_dump(out, k, keys, counts,
                                                     bytes_per_count=bpc)
                print(f"dumped {n} multiple kmers to {out}")
        else:
            blocks, dropped = counter.finish(1, 1)
            keys, frn, fps = (np.concatenate(a) for a in
                              zip(*[(b[0], b[2], b[3]) for b in blocks]))
            out = args.filename + ".once_kmer.bin"
            _write_unique(out, k, keys, frn, fps)
            merged = (f" ({counter.n_segments} spill segments merged)"
                      if counter.n_segments else "")
            print(f"dumped {len(keys)} unique kmers to {out}{merged}")
        if dropped:
            print(f"WARNING: {dropped} entries dropped past capacity "
                  f"{counter.capacity} (raise --capacity or drop --no-spill)",
                  file=sys.stderr)
    else:
        for batch, _idx in fastx.read_batches_overlapped(
                args.filename, device=device, batch_reads=args.batch_reads,
                stats=st):
            dist.record_batch(batch)

    dist.non_acgt = st.nb_bad_bases
    dist.ascii_dump_acgt_distribution("bases.histo")
    try:
        dist.ascii_dump_readlen_distribution("readlen.histo")
    except ValueError:
        pass
    print(f"reads: {st.n_reads}  bases: {st.n_bases}  "
          f"bad reads dropped: {st.nb_bad_read}  elapsed: {time.time()-t0:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
