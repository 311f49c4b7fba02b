"""datasketcher CLI: signatures of the reads (or of blocks of the reads)
of a FASTA/FASTQ file, and their nearest neighbours.

Port of kmerutils_tpu/cli/datasketcher.py, same flags plus ``--device``:

    datasketcher -f <file> -s <sketch_size> -k <kmer_size> -d <dump>
                 [-b block_size] [-a algo] [--device cuda|cpu]
                 [ann -n nbng [--engine hnsw|brute]]

Streams the file in packs of 10000 reads (5000 in block mode), sketches
each batch on the device with the family ``-a`` names (PROB3A by default;
SUPER, SUPER2, OPTDENS, REVOPTDENS, HLL: sketch/jaccard.py) and writes,
byte-identical to the JAX CLI, ``sketchparams_dump.json`` and either the
signature dump (magic 0xceabeadd, reads in file order) or the block dump
(0xceabbadd).  The JAX CLI's casts are kept, quirks included: PROB3A and
SUPER2 dump u32 words (a u64 signature keeps its low half); the other
families go through numpy's cast to u64, so SUPER keeps only its integer
part, OPTDENS / REVOPTDENS values in [0, 1) dump as 0 and +inf as numpy
casts it; HLL registers are u16.  Block mode always sketches ProbMinHash
blocks, whatever ``-a`` says.  ``ann`` writes the neighbour table
``<dump>-ann``: from the native HNSW index when the native library loads
(over the signatures cast to u32; its graph goes to ``<dump>-ann.hnsw``),
else, or with ``--engine brute``, from the exact search on the device over
the signatures as they are (ann.py).  In block mode every live block is
one vector, same-read hits are dropped, and ``<dump>-ann.blocks`` maps
table rows to (numseq, block).
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


def jax_words(sigs: np.ndarray, algo, hnsw: bool = False) -> np.ndarray:
    """The port's signatures (numpy, in its dtypes) cast as the JAX CLI
    casts them: the signature dump's words (u32 for PROB3A and SUPER2, the
    others numpy's cast to u64, so floats truncate), or with ``hnsw`` the
    u32 words its HNSW index takes (numpy's cast to u32).  The casts start
    from the JAX package's dtypes: HLL registers in the default
    parameters' register dtype (u16), int32 / int64 bit patterns as u32 /
    u64, floats as they are."""
    from ..sketch.params import SketchAlgo
    from ..sketch.setsketch import SetSketchParams
    if algo == SketchAlgo.HLL:
        host = sigs.astype(SetSketchParams().register_dtype)
    elif sigs.dtype in (np.int32, np.int64):
        host = sigs.view(np.uint32 if sigs.dtype == np.int32 else np.uint64)
    else:
        host = sigs
    if hnsw or algo in (SketchAlgo.PROB3A, SketchAlgo.SUPER2):
        return host.astype(np.uint32)
    return host if host.dtype == np.uint32 else host.astype(np.uint64)


def _hnsw_hits(args, sigs_u32: np.ndarray, k: int, ef_search: int):
    """(ids int64, similarity) of the k + 1 nearest rows of every row from
    the native index, whose graph is dumped to <dump>-ann.hnsw."""
    from .. import hnsw
    index = hnsw.Hnsw(dim=sigs_u32.shape[1], capacity=sigs_u32.shape[0],
                      max_nb_connection=args.max_nb_connection,
                      ef_construction=args.ef)
    index.parallel_insert(sigs_u32)
    index.file_dump(args.dumpfname + "-ann.hnsw")
    ids, dist = index.search(sigs_u32, k=k + 1, ef_search=ef_search)
    return ids, 1.0 - dist


def _first_kept(ids, sim, keep, k: int):
    """The first k kept hits of every row, in order; slots without one get
    neighbour 0 and similarity -1."""
    order = np.argsort(~keep, axis=1, kind="stable")
    ids = np.take_along_axis(ids, order, axis=1)
    sim = np.take_along_axis(sim, order, axis=1)
    col = np.arange(ids.shape[1])[None, :]
    valid = col < np.minimum(keep.sum(axis=1), k)[:, None]
    return (np.where(valid, ids, 0)[:, :k].astype(np.int32),
            np.where(valid, sim, -1.0)[:, :k].astype(np.float32))


def _use_hnsw(args) -> bool:
    from .. import hnsw
    return args.engine == "hnsw" and hnsw.available()


def _read_ann(args, ordered: np.ndarray, algo, device) -> None:
    """Neighbour table of the per-read signatures ``ordered`` (file order,
    the port's dtypes) of family ``algo``."""
    from ..ann import brute_force_neighbors, write_neighbor_dump
    n = ordered.shape[0]
    if _use_hnsw(args):
        # drop the self match by id (a duplicate read can rank above it)
        # and the -1 padding of a search that found fewer hits
        k = min(args.nbng, n - 1)
        ids, sim = _hnsw_hits(args, jax_words(ordered, algo, hnsw=True), k,
                              max(64, 2 * args.nbng))
        keep = (ids >= 0) & (ids != np.arange(n, dtype=np.int64)[:, None])
        nn, sim = _first_kept(ids, sim, keep, k)
    else:
        nn, sim = brute_force_neighbors(torch.from_numpy(ordered).to(device),
                                        args.nbng)
    write_neighbor_dump(args.dumpfname + "-ann", nn, sim)
    print(f"wrote {nn.shape[1]} neighbors/read to {args.dumpfname}-ann")


def _block_ann(args, per_seq, device) -> None:
    """Neighbour table of the live blocks: a block's hits in its own read
    (distance 1.0 by the block distance) are dropped."""
    from ..ann import brute_force_neighbors, write_neighbor_dump
    who = np.array([(numseq, j) for numseq, blocks in per_seq
                    for j in range(len(blocks))], dtype=np.uint32)
    if who.size == 0:
        print("no live blocks; skipping ann")
        return
    sigs = np.concatenate([np.asarray(b, np.uint32) for _, b in per_seq])
    read_of = who[:, 0].astype(np.int64)
    k = args.nbng
    extra = 8   # headroom so the same-read filter still leaves k hits
    if _use_hnsw(args):
        ids, sim = _hnsw_hits(args, sigs, k + extra,
                              max(64, 2 * (k + extra)))
    else:
        nn, sim = brute_force_neighbors(
            torch.from_numpy(sigs.view(np.int32)).to(device), k + extra)
        ids = nn.astype(np.int64)
    keep = (ids >= 0) & (read_of[np.clip(ids, 0, None)] != read_of[:, None])
    nn, sim = _first_kept(ids, sim, keep, k)
    write_neighbor_dump(args.dumpfname + "-ann", nn, sim)
    who.tofile(args.dumpfname + "-ann.blocks")
    print(f"block ann: {who.shape[0]} blocks, {k} cross-read "
          f"neighbors/block -> {args.dumpfname}-ann")


def _block_mode(args, device) -> int:
    from ..io import fastx, formats
    from ..sketch import block
    per_seq: list = []
    for batch, idx in fastx.read_batches_overlapped(
            args.filename, device=device, batch_reads=5000,
            stats=fastx.IngestStats()):
        res = block.block_sketch(batch, args.kmer_size, args.sketch_size,
                                 args.block_size)
        per_seq.extend(block.flatten_for_dump(res, idx))
    per_seq.sort(key=lambda t: t[0])
    formats.write_block_signature_dump(args.dumpfname, args.kmer_size,
                                       args.block_size, per_seq)
    print(f"dumped block signatures for {len(per_seq)} reads")
    if args.cmd == "ann":
        _block_ann(args, per_seq, device)
    return 0


def main(argv=None):
    from ..io import fastx, formats
    from ..sketch.jaccard import Sketcher
    from ..sketch.params import (PARAMS_DUMP_FILENAME, DataType,
                                 SeqSketcherParams, SketchAlgo)

    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    t0 = time.time()
    params = SeqSketcherParams(kmer_size=args.kmer_size,
                               sketch_size=args.sketch_size,
                               algo=SketchAlgo(args.algo),
                               data_t=DataType.DNA)
    params.dump_json(os.path.join(os.path.dirname(args.dumpfname) or ".",
                                  PARAMS_DUMP_FILENAME))
    if args.block_size:
        return _block_mode(args, device)
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
                                 jax_words(ordered, params.algo))
    print(f"sketched {len(all_idx)} reads in {time.time() - t0:.1f}s")
    if args.cmd == "ann":
        _read_ann(args, ordered, params.algo, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
