"""The bytes of the count table's kernels K3 (``ops/merge.merge_fold``) and
K4 (``ops/merge.aggregate_fold``), for their roofline shares, frozen here
so that no change to the program can move them.

An entry of the table is a key (4 bytes for k <= 16, 8 above), a u32
count and, with coordinates, a u64 coordinate; an entry of a batch run is
a key and, with coordinates, a coordinate (its count, 1, is implicit).
Each byte the function needs is counted once, read or written, at the HBM
peak of ``harness/roofline.py`` (3.35 TB/s):

* K3, the merge of a sorted run of ``nb`` entries into a table's live
  prefix of ``used`` entries: reads ``used`` table entries and ``nb`` run
  entries, writes the first ``n_out = min(used + nb, capacity)`` merged
  table entries;
* K4, the aggregation of the live prefix: reads ``used`` table entries,
  writes ``n_live`` table entries (one a run of equal keys that passes
  the count filter).

The per-tile scratch of K3's merge path and of K4's joins across tiles
(under 50 bytes a 4,096-entry tile) is not counted: the function does not
need it.
"""

from __future__ import annotations

from . import roofline


def entry_bytes(key, crd, counted: bool) -> int:
    """Bytes of one entry: the key, the count when ``counted``, the
    coordinate when there is one."""
    return key.element_size() + 4 * counted + (0 if crd is None else 8)


def fold_bytes(key, crd, used: int, nb: int, n_out: int) -> int:
    """K3's bytes (the table's ``key`` and ``crd`` give the entry's
    layout)."""
    table = entry_bytes(key, crd, True)
    return (used + n_out) * table + nb * entry_bytes(key, crd, False)


def aggregate_bytes(key, crd, used: int, n_live: int) -> int:
    """K4's bytes."""
    return (used + n_live) * entry_bytes(key, crd, True)


def share_pct(nbytes, device_s: float):
    """100 x the least time of ``nbytes`` over ``device_s``; None without
    bytes or device time."""
    if not nbytes or device_s <= 0:
        return None
    return 100.0 * roofline.bytes_s(sum(nbytes)) / device_s
