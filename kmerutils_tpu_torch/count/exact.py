"""Exact k-mer counting of one batch: sort + run lengths.

Port of kmerutils_tpu/count/exact.py.  Canonical k-mers (or ntHash values)
are sorted; each run of equal keys is one distinct k-mer whose count is the
run length.  Device outputs keep the JAX layout: the input's length, run-
start-aligned (a distinct key sits at the sorted position where its run
starts, ascending), the all-ones sentinel in every other key slot and 0 in
the other fields.

Key dtypes follow ops/merge.py: int32 tensors hold u32 keys (k <= 16),
int64 tensors u64 keys (k > 16, and ntHash values), as bit patterns; the
sentinel is -1 in both.  Counts are int32; read numbers and positions are
u32 values as int32 bit patterns.

``compact``, ``compact_detailed`` and ``compact_unique`` densify on the
tensors' device through kernel K7 (ops/merge.compact_live; its plain
version on the CPU) and copy only the live prefix to the host.  K7 takes an
entry as dead when its first word is all ones, and no half of a u64 key is
a safe first word: at k = 32 the canonical k-mer T^16A^16 has the high word
0xFFFFFFFF and A^16T^16 the low word 0xFFFFFFFF.  So the first word is
``counts - 1`` (-1 exactly where the count is 0), or, where there are no
counts, -1 exactly where the whole 64-bit key is the sentinel.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..base import kmer as kmer_mod
from ..base.sequence import ReadBatch
from ..ops import merge
from ..ops.bitops import M32, flip64, u32_to_i32
from ..ops.weights import _run_multiplicities


def sentinel_of(dtype: torch.dtype) -> int:
    """The all-ones padding key of an int32 (u32) or int64 (u64) key tensor:
    -1.  No canonical k-mer is all ones (its reverse complement, all A, is
    smaller)."""
    if dtype not in (torch.int32, torch.int64):
        raise ValueError(f"keys are int32 or int64 bit patterns, got {dtype}")
    return -1


@dataclasses.dataclass(frozen=True)
class KmerCounts:
    """Sorted distinct k-mers with exact counts, run-start-aligned.

    keys:       int32/int64[N]; each distinct key once, at its run start in
                sorted order; the sentinel -1 in every other slot.
    counts:     int32[N]; the multiplicity at run starts, 0 elsewhere.
    n_distinct: int32 scalar tensor, the number of distinct keys.
    n_unique:   int32 scalar tensor, the number of keys with count 1.
    """

    keys: torch.Tensor
    counts: torch.Tensor
    n_distinct: torch.Tensor
    n_unique: torch.Tensor


# int64 values whose signed order is the unsigned order of the keys
_carrier = merge._ukey


def _uncarry(s: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :data:`_carrier`."""
    return s.to(torch.int32) if dtype == torch.int32 else flip64(s)


def _key_tensor(can: torch.Tensor, k: int) -> torch.Tensor:
    """canonical_kmers values -> the key dtype (int32 for k <= 16)."""
    return u32_to_i32(can) if k <= 16 else can


def _flatten_valid(keys: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    return torch.where(valid.reshape(-1), keys.reshape(-1), -1)


def _runs(s: torch.Tensor, is_real: torch.Tensor):
    """(run starts, run length at every position) of a sorted 1-D array."""
    new_run = torch.ones_like(is_real)
    new_run[1:] = s[1:] != s[:-1]
    new_run &= is_real
    return new_run, _run_multiplicities(s[None], is_real[None])[0]


def count_from_values(values: torch.Tensor) -> KmerCounts:
    """Exact counts of a 1-D int32/int64 key tensor (-1 = ignore)."""
    sent = sentinel_of(values.dtype)
    s = _uncarry(torch.sort(_carrier(values)).values, values.dtype)
    is_real = s != sent
    new_run, run_len = _runs(s, is_real)
    return KmerCounts(
        keys=torch.where(new_run, s, sent),
        counts=torch.where(new_run, run_len, 0).to(torch.int32),
        n_distinct=new_run.sum().to(torch.int32),
        n_unique=(new_run & (run_len == 1)).sum().to(torch.int32))


def count_batch(batch: ReadBatch, k: int) -> KmerCounts:
    """Exact counts of the batch's canonical k-mers."""
    can, valid, _ = kmer_mod.canonical_kmers(batch, k)
    return count_from_values(_flatten_valid(_key_tensor(can, k), valid))


def count_batch_nthash(batch: ReadBatch, k: int) -> KmerCounts:
    """Exact counts keyed by canonical ntHash values (int64 keys; exact up
    to u64 hash collisions)."""
    from ..base import nthash
    _, _, canonical, _, valid = nthash.nthash_kmers(batch, k)
    return count_from_values(_flatten_valid(canonical, valid))


def count_batch_detailed(batch: ReadBatch, k: int, read_num_offset: int = 0):
    """Exact counts plus the first occurrence (read-major, position-minor)
    of every distinct canonical k-mer.

    Returns (keys int32/int64[N], counts int32[N], first_read int32[N],
    first_pos int32[N], n_distinct), run-start-aligned: the stable sort
    keeps scan order within a run, so its start is the first occurrence."""
    can, valid, _ = kmer_mod.canonical_kmers(batch, k)
    keys = _flatten_valid(_key_tensor(can, k), valid)
    P = can.shape[1]
    sorted_, perm = torch.sort(_carrier(keys), stable=True)
    s = _uncarry(sorted_, keys.dtype)
    is_real = s != -1
    new_run, run_len = _runs(s, is_real)
    rn = u32_to_i32((perm // P + read_num_offset) & M32)
    ps = (perm % P).to(torch.int32)
    return (torch.where(new_run, s, -1),
            torch.where(new_run, run_len, 0).to(torch.int32),
            torch.where(new_run, rn, 0), torch.where(new_run, ps, 0),
            new_run.sum().to(torch.int32))


def unique_kmer_coords(batch: ReadBatch, k: int, read_num_offset: int = 0):
    """Unique (count 1) canonical k-mers with their coordinates: (keys,
    read_num int32, pos int32, n_unique), run-start-aligned like
    :func:`count_batch_detailed`."""
    keys, counts, rn, ps, _ = count_batch_detailed(batch, k, read_num_offset)
    is_unique = counts == 1
    return (torch.where(is_unique, keys, -1), torch.where(is_unique, rn, 0),
            torch.where(is_unique, ps, 0), is_unique.sum().to(torch.int32))


def multiplicity_from_values(values: torch.Tensor, valid: torch.Tensor):
    """Within-row multiplicity of every value: values int32/int64[n, P],
    valid bool[n, P] -> int32[n, P] (0 where invalid)."""
    keys = torch.where(valid, values, -1)
    s, order = torch.sort(_carrier(keys), dim=1)
    is_real = _uncarry(s, values.dtype) != -1
    run = _run_multiplicities(s, is_real)
    per_slot = torch.empty_like(run).scatter_(1, order, run)
    return torch.where(valid, per_slot, 0).to(torch.int32)


def multiplicity_per_slot(batch: ReadBatch, k: int):
    """(per-read multiplicity of the canonical k-mer at every position,
    valid)."""
    can, valid, _ = kmer_mod.canonical_kmers(batch, k)
    return multiplicity_from_values(_key_tensor(can, k), valid), valid


# ---------------------------------------------------------------------------
# host-side merge across batches
# ---------------------------------------------------------------------------

def merge_counts_host(parts):
    """Merge dense (keys, counts) numpy pairs of several batches: returns
    (keys, counts int64) sorted ascending, counts summed per key."""
    all_keys = np.concatenate([np.asarray(p[0]) for p in parts])
    all_counts = np.concatenate([np.asarray(p[1]) for p in parts])
    order = np.argsort(all_keys, kind="stable")
    ks, cs = all_keys[order], all_counts[order]
    if ks.size == 0:
        return ks, cs
    starts = np.flatnonzero(np.concatenate([[True], ks[1:] != ks[:-1]]))
    return ks[starts], np.add.reduceat(cs.astype(np.int64), starts)


def merge_detailed_host(parts):
    """Merge dense (keys, counts, read_nums, positions) numpy tuples of
    several batches: counts sum per key, the coordinate kept is the
    smallest (read, pos).  Returns (keys u64, counts i64, read_nums u32,
    positions u32, first_coord u64), ascending by key."""
    keys = np.concatenate([np.asarray(p[0], dtype=np.uint64) for p in parts])
    counts = np.concatenate([np.asarray(p[1], dtype=np.int64) for p in parts])
    coord = np.concatenate(
        [(np.asarray(p[2], dtype=np.uint64) << np.uint64(32))
         | np.asarray(p[3], dtype=np.uint64) for p in parts])
    if keys.size == 0:
        e = np.zeros(0, np.uint64)
        return e, counts[:0], e.astype(np.uint32), e.astype(np.uint32), e
    order = np.argsort(keys, kind="stable")
    ks, cs, co = keys[order], counts[order], coord[order]
    starts = np.flatnonzero(np.concatenate([[True], ks[1:] != ks[:-1]]))
    out_coord = np.minimum.reduceat(co, starts)
    return (ks[starts], np.add.reduceat(cs, starts),
            (out_coord >> np.uint64(32)).astype(np.uint32),
            (out_coord & np.uint64(0xFFFFFFFF)).astype(np.uint32), out_coord)


# ---------------------------------------------------------------------------
# densification (kernel K7 on the tensors' device)
# ---------------------------------------------------------------------------

def _halves(keys: torch.Tensor):
    """A key tensor as int32 words: (key,) or (lo, hi)."""
    if keys.dtype == torch.int32:
        return (keys.contiguous(),)
    return keys.to(torch.int32), (keys >> 32).to(torch.int32)


def _dense(live_word: torch.Tensor, words):
    """K7 over (live_word, *words); the live prefix of each word array as
    numpy u32 (live_word's first)."""
    outs, n_live = merge.compact_live((live_word.contiguous(), *words))
    return [o[:n_live].cpu().numpy().view(np.uint32) for o in outs]


def _host_keys(words) -> np.ndarray:
    if len(words) == 1:
        return words[0]
    return (words[1].astype(np.uint64) << np.uint64(32)) \
        | words[0].astype(np.uint64)


def compact(kc: KmerCounts):
    """Dense ascending numpy (keys u32/u64, counts int32) of the live
    slots."""
    kw = _halves(kc.keys)
    cm1, *out = _dense(kc.counts - 1, kw)
    return _host_keys(out), (cm1.view(np.int32) + 1)


def compact_detailed(keys, counts, rn, ps):
    """Dense ascending numpy (keys, counts int32, read_nums u32, positions
    u32) of :func:`count_batch_detailed`'s outputs."""
    kw = _halves(keys)
    cm1, *out = _dense(counts - 1, (*kw, rn, ps))
    return (_host_keys(out[: len(kw)]), cm1.view(np.int32) + 1,
            out[len(kw)], out[len(kw) + 1])


def compact_unique(keys, rn, ps):
    """Dense ascending numpy (keys, read_nums u32, positions u32) of
    :func:`unique_kmer_coords`' outputs."""
    if keys.dtype == torch.int32:   # the key itself is the whole key
        out = _dense(keys, (rn, ps))
        return out[0], out[1], out[2]
    live = torch.where(keys == -1, -1, 0).to(torch.int32)
    _, *out = _dense(live, (*_halves(keys), rn, ps))
    return _host_keys(out[:2]), out[2], out[3]
