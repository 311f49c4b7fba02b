"""Counting and sketching over several devices with torch.distributed.

Port of kmerutils_tpu/parallel/collective.py.  Each rank runs the body of
the JAX ``shard_map`` step on its own rows (parallel/mesh.py) and the mesh
collectives become the group's:

* hash-sharded exact counting: each rank extracts and canonicalizes its
  reads' k-mers, computes their shard id (count/dispatch.py), arranges them
  in fixed-capacity send buckets and exchanges them with ONE
  ``all_to_all_single``, so that rank d receives exactly the k-mers of
  shard d; its count table is disjoint from every other rank's;
* Bloom slots and SetSketch registers merge with ``all_reduce(MAX)``;
* signatures are collected with ``all_gather_into_tensor``;
* data-parallel sketching needs no communication at all.

Keys are int32 (u32 bit patterns, k <= 16) or int64 (u64 bit patterns),
-1 the sentinel in both (count/exact.py).  Every function returns this
rank's part of what the JAX function returns for the whole mesh: its row d
of a [n_dev, ...] result, or the replicated value.  Every rank must call a
function that communicates at the same point, as with any collective.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..base import kmer as kmer_mod
from ..base.sequence import ReadBatch
from ..count import dispatch, exact
from ..sketch import setsketch
from .mesh import Mesh

# all_gather_single is the newer name of all_gather_into_tensor (same
# arguments); older torch has only the latter
_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


def _bucketize_by_shard(payloads, shard_ids: torch.Tensor, n_shards: int,
                        cap: int):
    """Arrange a rank's entries into [n_shards, cap] send buckets, -1
    padded; overflow past ``cap`` is dropped and counted.

    ``payloads`` are 1-D tensors riding along with ``shard_ids`` (int32;
    an entry to skip carries shard id ``n_shards``).  ONE stable sort by
    shard id (JAX's variadic ``lax.sort``), the shard boundaries by
    ``searchsorted``, and each bucket GATHERS its slots.  Returns (buckets,
    dropped): a tuple of [n_shards, cap] tensors and a 0-d int64 tensor.
    Port of both ``_bucketize_by_shard`` and stream.py's
    ``_multi_bucketize``.
    """
    ss, order = torch.sort(shard_ids, stable=True)
    starts = torch.searchsorted(
        ss, torch.arange(n_shards + 1, dtype=ss.dtype, device=ss.device))
    counts = starts[1:] - starts[:-1]
    dropped = (counts - cap).clamp(min=0).sum()
    r = torch.arange(cap, dtype=starts.dtype, device=ss.device)[None, :]
    idx = torch.minimum(starts[:-1, None] + r,
                        torch.full_like(r, max(ss.numel() - 1, 0)))
    live = r < counts[:, None]
    src = order[idx]
    return tuple(torch.where(live, p[src], -1) for p in payloads), dropped


def _all_to_all(buckets: torch.Tensor) -> torch.Tensor:
    """Send bucket row j to rank j; returns what every rank sent this one,
    flat, in source-rank order (JAX's ``concat_axis=1``)."""
    buckets = buckets.contiguous()
    out = torch.empty_like(buckets)
    dist.all_to_all_single(out, buckets)
    return out.reshape(-1)


def _keys_and_shards(batch: ReadBatch, k: int, world: int):
    """The batch's canonical k-mer keys, flat (-1 where invalid), and their
    shard ids (``world`` for the invalid ones)."""
    can, valid, _ = kmer_mod.canonical_kmers(batch, k)
    keys = exact._flatten_valid(exact._key_tensor(can, k), valid)
    live = keys != -1
    sid = dispatch.dispatch(torch.where(live, keys, 0), world, k)
    return keys, torch.where(live, sid, world), live, can.shape


def shard_capacity(n_local: int, p: int, world: int,
                   shard_cap_factor: float) -> int:
    """Slots of one send bucket: JAX's rule over the rank's n_local rows of
    p positions (``collective.py:74``, ``stream.py:151-152``)."""
    return int(n_local * p / world * shard_cap_factor) + 64


def sharded_count(batch: ReadBatch, k: int, mesh: Mesh,
                  shard_cap_factor: float = 1.5):
    """Exact canonical k-mer counting with reads data-parallel and k-mer
    space hash-partitioned over the group.

    ``batch`` is this rank's rows.  Returns this rank's (keys, counts,
    dropped, n_distinct, n_unique): the distinct k-mers of shard ``rank``
    in count/exact.py's run-start-aligned layout over the world x cap
    received slots, the entries this rank could not send (bucket overflow),
    and the shard's distinct and count-1 totals (0-d tensors).
    """
    keys, sid, _, (n_local, p) = _keys_and_shards(batch, k, mesh.world)
    cap = shard_capacity(n_local, p, mesh.world, shard_cap_factor)
    (buckets,), dropped = _bucketize_by_shard((keys,), sid, mesh.world, cap)
    kc = exact.count_from_values(_all_to_all(buckets))
    return kc.keys, kc.counts, dropped, kc.n_distinct, kc.n_unique


def sharded_count_redundant(batch: ReadBatch, k: int, mesh: Mesh):
    """Redundant-compute sharding: every rank scans the FULL batch (the
    same on every rank) and keeps only the k-mers of its own shard, with
    no communication.  Returns this rank's (keys, counts, n_distinct,
    n_unique) like :func:`sharded_count`, over the batch's slots."""
    keys, sid, live, _ = _keys_and_shards(batch, k, mesh.world)
    keys = torch.where((sid == mesh.rank) & live, keys, -1)
    kc = exact.count_from_values(keys)
    return kc.keys, kc.counts, kc.n_distinct, kc.n_unique


def sharded_setsketch_collection(items: torch.Tensor, valid: torch.Tensor,
                                 params, mesh: Mesh,
                                 seed: int = 0) -> torch.Tensor:
    """One SetSketch of the whole collection: each rank's registers of its
    rows (kernel G2), their maximum over rows, then ``all_reduce(MAX)``
    over the group.  Returns the int32 registers [m], the same on every
    rank."""
    regs = setsketch.setsketch_signatures(items, valid, params, seed)
    merged = regs.max(dim=0).values.contiguous()
    dist.all_reduce(merged, op=dist.ReduceOp.MAX)
    return merged


def sharded_bloom_insert(slots: torch.Tensor, keys: torch.Tensor,
                         nb_hash: int, log2_slots: int,
                         mesh: Mesh) -> torch.Tensor:
    """Insert every rank's keys into a Bloom slot tensor held whole by each
    rank: a local scatter max of 1 at the probed slots, then
    ``all_reduce(MAX)`` (the union).  ``keys`` are int64 u64 bit patterns
    (the sentinel -1 inserts nothing) or int32 u32 values; ``slots`` uint8
    [2^log2_slots], not changed.  Returns the union's slots."""
    from ..count import filters
    flat = keys.reshape(-1)
    idx = filters.probe_indices(flat, nb_hash, log2_slots)
    if flat.dtype == torch.int64:
        idx = idx[flat != -1]
    filled = slots.index_fill(0, idx.reshape(-1).to(torch.int64), 1)
    out = torch.maximum(filled, slots).contiguous()
    dist.all_reduce(out, op=dist.ReduceOp.MAX)
    return out


def gather_signatures(sigs: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's block of signature rows, concatenated in rank order on
    every rank (axis 0) — the collection step before an ANN export.  Each
    rank must pass the same shape."""
    as_u8 = sigs.dtype == torch.bool          # NCCL carries no bool
    src = (sigs.to(torch.uint8) if as_u8 else sigs).contiguous()
    out = torch.empty((mesh.world * src.shape[0],) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    _all_gather(out, src)
    return out.to(torch.bool) if as_u8 else out


def data_parallel_sketch(sketch_fn, mesh: Mesh):
    """A per-batch sketch function (items, valid) -> sigs run on each rank's
    own rows, with no communication: ``sketch_fn`` itself, since each rank
    already holds only its rows; :func:`gather_signatures` collects the
    blocks."""
    del mesh
    return sketch_fn


def sharded_stream_create(capacity_per_device: int, mesh: Mesh,
                          wide: bool = False, coords: bool = False):
    """This rank's streaming count table of its shard (parallel/stream.py,
    the production engine)."""
    from . import stream as pstream
    return pstream.sharded_stream_create(capacity_per_device, mesh, wide,
                                         coords)


def sharded_stream_update(table, batch: ReadBatch, k: int, mesh: Mesh,
                          read_num_offset: int = 0,
                          shard_cap_factor: float = 1.5):
    """One exchange + fold step of sharded counting through the merge-fold
    table: this rank's k-mer entries (count 1 each, optional
    first-occurrence coordinates) routed to their shard by ONE all_to_all,
    sorted, and folded by kernel K3.

    The unstaged single-step API; a stream should use
    parallel/stream.ShardedStreamCounter (staging, growth, spill).  Returns
    (the updated table, this rank's in-transit drop count)."""
    from ..count import stream
    from . import stream as pstream
    run, dropped = pstream.exchange(batch, k, mesh, table.wide, table.coords,
                                    read_num_offset, shard_cap_factor)
    return stream.fold(table, run), int(dropped)


def sharded_stream_finalize(table, mesh: Mesh, min_count: int = 1,
                            max_count: int | None = None):
    """The union of the shards' finalized tables, for a group of one rank
    (parallel/stream.finalize_union); each rank of a larger group calls
    parallel/stream.finalize_local instead."""
    from . import stream as pstream
    return pstream.finalize_union(table, mesh, min_count, max_count)
