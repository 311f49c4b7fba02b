"""Merge and run aggregation of sorted k-mer entries: CUDA kernels and their
plain versions.

Port of the Pallas kernels K3-K7 of kmerutils_tpu/ops/merge_pallas.py,
with the contract kept and the TPU's layout left behind (no sign-flipped
compare words, no +1 key bias, no reversed B side, no aligned windows):

* K5 :func:`merge_sorted` (``merge_sorted_u32``): stable merge of two sorted
  runs, A first on ties;
* K3 :func:`merge_fold` (``merge_fold_i32``): the same merge of a sorted
  batch run into a count table's live prefix, batch entries counting 1,
  keeping the first ``capacity`` entries (the largest keys drop);
* K4 :func:`aggregate_fold` (``aggregate_fold_i32``): one entry per run of
  equal keys over a table's live prefix, count = the saturating sum,
  coordinate = the minimum, filtered by ``lo <= count <= hi``, compacted;
* K6 :func:`aggregate_compact` (``aggregate_compact_u32``): K4 on a raw
  array whose dead entries (key all ones) trail, the tail filled with all
  ones;
* K7 :func:`compact_live` (``compact_live_u32``): stable compaction of 1-5
  int32 arrays whose dead entries (first array all ones) lie anywhere.

Entries are parallel 1-D tensors: ``key`` int32 (u32 bit patterns, k <= 16)
or int64 (u64 bit patterns), ``cnt`` int32 (u32 bit patterns), ``crd`` int64
(``read_num << 32 | pos``) or None.  Keys order as unsigned words.  A batch
run is (key, crd) with an implicit count of 1 per entry.

The device of the inputs picks the implementation: a CUDA tensor launches
the hand-written kernel of csrc/merge.cu (built on first use by _build.py)
or raises; a CPU tensor runs the plain PyTorch version (``*_ref``), which is
also what the kernels are checked against on the card.  Outputs are new
tensors: the kernels never work in place.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .bitops import M32, flip64

# kernel launches by the wrappers (not by the plain versions)
launches_merge = 0       # K5
launches_fold = 0        # K3
launches_aggregate = 0   # K4
launches_compact = 0     # K6
launches_live = 0        # K7


def reset_launches() -> None:
    global launches_merge, launches_fold, launches_aggregate, \
        launches_compact, launches_live
    launches_merge = launches_fold = launches_aggregate = \
        launches_compact = launches_live = 0


def _ukey(key: torch.Tensor) -> torch.Tensor:
    """int64 keys whose signed order is the unsigned order of ``key``."""
    if key.dtype == torch.int32:
        return key.to(torch.int64) & M32
    return flip64(key)


def _check_entries(key, cnt, crd, what: str) -> torch.device:
    if key.dim() != 1 or key.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"{what}: key must be 1-D int32 or int64, got "
                         f"{key.dtype}{list(key.shape)}")
    dev = key.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {dev}")
    for name, t, dt in (("key", key, key.dtype), ("cnt", cnt, torch.int32),
                        ("crd", crd, torch.int64)):
        if t is None:
            continue
        if t.dtype != dt or t.shape != key.shape or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous {dt}"
                             f"{list(key.shape)} on {dev}, got {t.dtype}"
                             f"{list(t.shape)} on {t.device}")
    return dev


def _ptr(t):
    return None if t is None else t.data_ptr()


def _empty_like(t):
    return None if t is None else torch.empty_like(t)


def _bounds(lo: int, hi: int | None):
    """The count filter as the kernels take it (u32 lo, hi); lo <= 1 keeps
    every count, as in the JAX kernels."""
    return (lo if lo > 1 else 0), (M32 if hi is None else hi)


# ---------------------------------------------------------------------------
# K5 / K3: merge
# ---------------------------------------------------------------------------

def merge_sorted(a_key, a_crd, b_key, b_crd):
    """K5.  Stable merge (A first on ties) of two runs sorted by unsigned
    key; returns (key, crd) of length len(a) + len(b)."""
    global launches_merge
    dev = _check_entries(a_key, None, a_crd, "merge_sorted a")
    if _check_entries(b_key, None, b_crd, "merge_sorted b") != dev \
            or b_key.dtype != a_key.dtype \
            or (a_crd is None) != (b_crd is None):
        raise ValueError("merge_sorted: runs differ in device, key type or "
                         "coordinates")
    if dev.type == "cpu":
        return merge_sorted_ref(a_key, a_crd, b_key, b_crd)
    lib = _build.load()
    n = a_key.numel() + b_key.numel()
    o_key = torch.empty(n, dtype=a_key.dtype, device=dev)
    o_crd = None if a_crd is None else torch.empty(n, dtype=torch.int64,
                                                   device=dev)
    if n:
        _build.launch(lib.launch_merge, a_key.element_size(), 0,
                      int(a_crd is not None), _ptr(a_key), None, _ptr(a_crd),
                      a_key.numel(), _ptr(b_key), _ptr(b_crd), b_key.numel(),
                      _ptr(o_key), None, _ptr(o_crd), n, device=dev)
        launches_merge += 1
    return o_key, o_crd


def merge_fold(key, cnt, crd, used: int, b_key, b_crd, capacity: int):
    """K3.  Merge the sorted batch run (b_key, b_crd), counting 1 per entry,
    into the table's live prefix [0, used).  Returns (key, cnt, crd, n) with
    arrays of ``capacity`` entries whose first n = min(used + len(b),
    capacity) are the merged entries; the merged entries past capacity (the
    largest keys) are dropped."""
    global launches_fold
    dev = _check_entries(key, cnt, crd, "merge_fold table")
    if _check_entries(b_key, None, b_crd, "merge_fold batch") != dev \
            or b_key.dtype != key.dtype or (crd is None) != (b_crd is None):
        raise ValueError("merge_fold: batch differs from the table in "
                         "device, key type or coordinates")
    if not 0 <= used <= key.numel():
        raise ValueError(f"merge_fold: used={used} outside the table")
    if dev.type == "cpu":
        return merge_fold_ref(key, cnt, crd, used, b_key, b_crd, capacity)
    lib = _build.load()
    o_key = torch.empty(capacity, dtype=key.dtype, device=dev)
    o_cnt = torch.empty(capacity, dtype=torch.int32, device=dev)
    o_crd = None if crd is None else torch.empty(capacity, dtype=torch.int64,
                                                 device=dev)
    n_out = min(used + b_key.numel(), capacity)
    if n_out:
        _build.launch(lib.launch_merge, key.element_size(), 1,
                      int(crd is not None), _ptr(key), _ptr(cnt), _ptr(crd),
                      used, _ptr(b_key), _ptr(b_crd), b_key.numel(),
                      _ptr(o_key), _ptr(o_cnt), _ptr(o_crd), n_out,
                      device=dev)
        launches_fold += 1
    return o_key, o_cnt, o_crd, n_out


# ---------------------------------------------------------------------------
# K4 / K6: run aggregation
# ---------------------------------------------------------------------------

def _aggregate_cuda(key, cnt, crd, n: int, lo: int, hi, sentinel: bool):
    lib = _build.load()
    dev = key.device
    o_key, o_cnt, o_crd = _empty_like(key), _empty_like(cnt), _empty_like(crd)
    if n == 0:
        return o_key, o_cnt, o_crd, 0
    lo_k, hi_k = _bounds(lo, hi)
    scratch = torch.empty(lib.aggregate_scratch_words(n), dtype=torch.int64,
                          device=dev)
    _build.launch(lib.launch_aggregate, key.element_size(),
                  int(crd is not None), int(sentinel), _ptr(key), _ptr(cnt),
                  _ptr(crd), n, lo_k, hi_k, _ptr(o_key), _ptr(o_cnt),
                  _ptr(o_crd), scratch.data_ptr(), device=dev)
    return o_key, o_cnt, o_crd, int(scratch[-1].item())


def aggregate_fold(key, cnt, crd, used: int, lo: int = 1,
                   hi: int | None = None):
    """K4.  Aggregate the runs of equal keys of the live prefix [0, used)
    (count: sum saturating at 2^32 - 1; coordinate: minimum), keep those
    with lo <= count <= hi, compact them in key order.  Returns (key, cnt,
    crd, n_live) with arrays of the input's length; entries past n_live are
    unspecified."""
    global launches_aggregate
    dev = _check_entries(key, cnt, crd, "aggregate_fold")
    if not 0 <= used <= key.numel():
        raise ValueError(f"aggregate_fold: used={used} outside the table")
    if dev.type == "cpu":
        return aggregate_fold_ref(key, cnt, crd, used, lo, hi)
    out = _aggregate_cuda(key, cnt, crd, used, lo, hi, sentinel=False)
    if used:
        launches_aggregate += 1
    return out


def aggregate_compact(key, cnt, crd, lo: int = 1, hi: int | None = None):
    """K6.  :func:`aggregate_fold` on a raw array whose dead entries (key all
    ones) trail; the output past n_live is all ones in every array.
    Returns (key, cnt, crd, n_live)."""
    global launches_compact
    dev = _check_entries(key, cnt, crd, "aggregate_compact")
    if dev.type == "cpu":
        return aggregate_compact_ref(key, cnt, crd, lo, hi)
    out = _aggregate_cuda(key, cnt, crd, key.numel(), lo, hi, sentinel=True)
    if key.numel():
        launches_compact += 1
    return out


# ---------------------------------------------------------------------------
# K7: stable compaction
# ---------------------------------------------------------------------------

def _check_arrays(arrs, what: str) -> torch.device:
    if not 1 <= len(arrs) <= 5:
        raise ValueError(f"{what}: takes 1-5 arrays, got {len(arrs)}")
    a0 = arrs[0]
    dev = a0.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {dev}")
    for i, t in enumerate(arrs):
        if t.dtype != torch.int32 or t.dim() != 1 or t.shape != a0.shape \
                or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{what}: arrs[{i}] must be contiguous int32"
                             f"{list(a0.shape)} on {dev}, got {t.dtype}"
                             f"{list(t.shape)} on {t.device}")
    return dev


def compact_live(arrs):
    """K7.  Stable compaction of 1-5 int32 arrays (u32 bit patterns) of one
    length m; an entry is dead when ``arrs[0]`` is all ones (-1).  Returns
    (new arrays of length m with the live entries first, in order, and all
    ones after them; n_live as a host int)."""
    global launches_live
    dev = _check_arrays(arrs, "compact_live")
    if dev.type == "cpu":
        return compact_live_ref(arrs)
    lib = _build.load()
    n = arrs[0].numel()
    outs = tuple(torch.empty_like(a) for a in arrs)
    if n == 0:
        return outs, 0
    scratch = torch.empty(lib.compact_scratch_words(n), dtype=torch.int64,
                          device=dev)
    ptrs = ctypes.c_void_p * len(arrs)
    _build.launch(lib.launch_compact, len(arrs),
                  ptrs(*[a.data_ptr() for a in arrs]),
                  ptrs(*[o.data_ptr() for o in outs]), n, scratch.data_ptr(),
                  device=dev)
    launches_live += 1
    return outs, int(scratch[-1].item())


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def compact_live_ref(arrs):
    """Plain version of :func:`compact_live` (same I/O)."""
    _check_arrays(arrs, "compact_live_ref")
    live = arrs[0] != -1
    n_live = int(live.sum())
    outs = []
    for a in arrs:
        o = torch.full_like(a, -1)
        o[:n_live] = a[live]
        outs.append(o)
    return tuple(outs), n_live


def _merge_order(a_key, b_key):
    """Indices into cat([a, b]) of the stable merge, A first on ties."""
    return torch.sort(torch.cat([_ukey(a_key), _ukey(b_key)]),
                      stable=True).indices


def merge_sorted_ref(a_key, a_crd, b_key, b_crd):
    """Plain version of :func:`merge_sorted` (same I/O)."""
    order = _merge_order(a_key, b_key)
    key = torch.cat([a_key, b_key])[order]
    crd = None if a_crd is None else torch.cat([a_crd, b_crd])[order]
    return key, crd


def merge_fold_ref(key, cnt, crd, used: int, b_key, b_crd, capacity: int):
    """Plain version of :func:`merge_fold` (same I/O)."""
    order = _merge_order(key[:used], b_key)
    n_out = min(used + b_key.numel(), capacity)
    order = order[:n_out]
    ones = torch.ones(b_key.numel(), dtype=torch.int32, device=key.device)
    outs = []
    for a, b in ((key, b_key), (cnt, ones), (crd, b_crd)):
        if a is None:
            outs.append(None)
            continue
        o = torch.empty(capacity, dtype=a.dtype, device=a.device)
        o[:n_out] = torch.cat([a[:used], b])[order]
        outs.append(o)
    return outs[0], outs[1], outs[2], n_out


def _aggregate_runs(key, cnt, crd, lo: int, hi):
    """Runs of equal keys of sorted entries -> (key, cnt, crd) of the runs
    with lo <= count <= hi."""
    if key.numel() == 0:
        return key, cnt, crd
    head = torch.ones(key.numel(), dtype=torch.bool, device=key.device)
    head[1:] = key[1:] != key[:-1]
    rid = torch.cumsum(head.to(torch.int64), 0) - 1
    n_runs = int(rid[-1]) + 1
    sums = torch.zeros(n_runs, dtype=torch.int64, device=key.device)
    sums.index_add_(0, rid, cnt.to(torch.int64) & M32)
    counts = sums.clamp(max=M32)
    lo_k, hi_k = _bounds(lo, hi)
    keep = (counts >= lo_k) & (counts <= hi_k)
    r_crd = None
    if crd is not None:
        big = torch.full((n_runs,), torch.iinfo(torch.int64).max,
                         dtype=torch.int64, device=key.device)
        r_crd = flip64(big.scatter_reduce(0, rid, flip64(crd), "amin"))[keep]
    return key[head][keep], counts[keep].to(torch.int32), r_crd


def _place(runs, like, fill):
    """Write the runs at the front of new arrays shaped like the inputs."""
    outs = []
    for r, t in zip(runs, like):
        if t is None:
            outs.append(None)
            continue
        o = torch.full_like(t, -1) if fill else torch.empty_like(t)
        o[: r.numel()] = r
        outs.append(o)
    return outs[0], outs[1], outs[2], runs[0].numel()


def aggregate_fold_ref(key, cnt, crd, used: int, lo: int = 1,
                       hi: int | None = None):
    """Plain version of :func:`aggregate_fold` (same I/O)."""
    runs = _aggregate_runs(key[:used], cnt[:used],
                           None if crd is None else crd[:used], lo, hi)
    return _place(runs, (key, cnt, crd), fill=False)


def aggregate_compact_ref(key, cnt, crd, lo: int = 1, hi: int | None = None):
    """Plain version of :func:`aggregate_compact` (same I/O)."""
    live = key != -1
    runs = _aggregate_runs(key[live], cnt[live],
                           None if crd is None else crd[live], lo, hi)
    return _place(runs, (key, cnt, crd), fill=True)
