"""datasketcher CLI: per-read ProbMinHash signatures of a FASTA/FASTQ file.

Port of the whole-read PROB3A path of kmerutils_tpu/cli/datasketcher.py,
same flags plus ``--device``:

    datasketcher -f <file> -s <sketch_size> -k <kmer_size> -d <dump>
                 [--device cuda|cpu]

Streams the file in packs of 10000 reads, sketches each batch on the device
(canonical k-mers -> Wang hash -> per-read multiplicities -> tournament
kernel), and writes the signature dump (magic 0xceabeadd, u32 words, reads
in file order) and ``sketchparams_dump.json`` beside it.  Both files are
byte-identical to the JAX CLI's.  Block mode (``-b``), the other sketch
algorithms and the ``ann`` export are not ported yet.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch


def build_parser():
    p = argparse.ArgumentParser(prog="datasketcher")
    p.add_argument("-f", "--file", required=True, dest="filename")
    p.add_argument("-s", "--sketch", type=int, required=True, dest="sketch_size")
    p.add_argument("-k", "--kmer", type=int, required=True, dest="kmer_size")
    p.add_argument("-d", "--dump", required=True, dest="dumpfname")
    p.add_argument("-b", "--block", type=int, default=0, dest="block_size")
    p.add_argument("-a", "--algo", default="PROB3A",
                   choices=["PROB3A", "SUPER", "SUPER2", "OPTDENS",
                            "REVOPTDENS", "HLL"])
    p.add_argument("--device", default="cuda",
                   help="torch device that sketches (default cuda)")
    sub = p.add_subparsers(dest="cmd")
    ann = sub.add_parser("ann")
    ann.add_argument("-n", "--nbng", type=int, default=10)
    ann.add_argument("--engine", default="hnsw", choices=["hnsw", "brute"])
    ann.add_argument("--max-nb-connection", type=int, default=24)
    ann.add_argument("--ef", type=int, default=400)
    return p


def _not_ported(args) -> str | None:
    if args.block_size:
        return ("block mode (-b) is not ported yet "
                "(ROADMAP.md Queue 1 item 11: sketch/block.py)")
    if args.algo != "PROB3A":
        return (f"-a {args.algo} is not ported yet "
                "(ROADMAP.md Queue 1 item 11: the other sketchers)")
    if args.cmd == "ann":
        return ("the ann export is not ported yet "
                "(ROADMAP.md Queue 1 item 13: ann.py / hnsw.py)")
    return None


def _to_u32(sigs: np.ndarray) -> np.ndarray:
    """PROB3A dumps hold u32 words: u32 bit patterns as they are, u64
    signatures cut to their low 32 bits (as the JAX CLI's astype does)."""
    if sigs.dtype == np.int32:
        return sigs.view(np.uint32)
    return (sigs & 0xFFFFFFFF).astype(np.uint32)


def main(argv=None):
    from ..io import fastx, formats
    from ..sketch.jaccard import Sketcher
    from ..sketch.params import (PARAMS_DUMP_FILENAME, DataType,
                                 SeqSketcherParams, SketchAlgo)

    args = build_parser().parse_args(argv)
    why = _not_ported(args)
    if why:
        raise NotImplementedError(why)
    device = torch.device(args.device)
    t0 = time.time()
    params = SeqSketcherParams(kmer_size=args.kmer_size,
                               sketch_size=args.sketch_size,
                               algo=SketchAlgo(args.algo),
                               data_t=DataType.DNA)
    params.dump_json(os.path.join(os.path.dirname(args.dumpfname) or ".",
                                  PARAMS_DUMP_FILENAME))
    st = fastx.IngestStats()
    sk = Sketcher(params=params)
    cuda = device.type == "cuda"
    rows: list = []
    block_idx: list = []

    def collect(host, done, idx):
        if done is not None:
            done.synchronize()
        rows.append(host.numpy()[: len(idx)])
        block_idx.append(idx)

    # signatures come back to the host one batch late: the copy of batch i
    # is queued behind its sketch and waited for once batch i+1 is queued,
    # which also bounds how far the host runs ahead of the device
    pending: list = []
    for batch, idx in fastx.read_batches_overlapped(
            args.filename, device=device, batch_reads=10000, stats=st):
        sig = sk.sketch_batch(batch)
        if cuda:
            host = torch.empty(sig.shape, dtype=sig.dtype, pin_memory=True)
            host.copy_(sig, non_blocking=True)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(device))
            pending.append((host, done, idx))
        else:
            pending.append((sig, None, idx))
        if len(pending) > 1:
            collect(*pending.pop(0))
    for p in pending:
        collect(*p)
    all_idx = np.concatenate(block_idx)
    ordered = np.concatenate(rows)[np.argsort(all_idx, kind="stable")]
    formats.write_signature_dump(args.dumpfname, args.kmer_size,
                                 _to_u32(ordered))
    print(f"sketched {len(all_idx)} reads in {time.time() - t0:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
