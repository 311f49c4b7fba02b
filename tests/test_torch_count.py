"""Parity of the port's counting modules (count/stream.py, count/spill.py,
stats.py) with the JAX package on the CPU.

The same numpy-seeded reads go through both packages: batch entries, the
streaming table (fold with its compaction policy, StagedFolder at depth 0
and 1, grow, finalize with its filters and clamp), host spill with its
k-way merge, a JAX stream continued in the port through
``table_from_jax``, and the read statistics.  JAX's Pallas kernels run in
interpret mode; the port's kernels take their plain versions on CPU
tensors.

Tolerance: exact equality of every key, count, coordinate, drop count and
histogram byte.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from kmerutils_tpu.base.sequence import pack_ascii_reads as j_pack
from kmerutils_tpu.count import spill as j_spill
from kmerutils_tpu.count import stream as j_stream
from kmerutils_tpu import stats as j_stats
from kmerutils_tpu_torch.base.sequence import pack_ascii_reads
from kmerutils_tpu_torch.count import spill as t_spill
from kmerutils_tpu_torch.count import stream as t_stream
from kmerutils_tpu_torch import stats as t_stats

t_pack = functools.partial(pack_ascii_reads, device="cpu")

N_BATCHES, READS_PER_BATCH = 5, 6


def batches_of_reads(seed: int):
    """5 batches of 6 reads, 60-300 bases, one 300-base read in each (one
    batch shape for JAX) and one read repeated (counts >= 2)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(N_BATCHES):
        lens = list(rng.integers(60, 300, size=READS_PER_BATCH - 1)) + [300]
        out.append(["".join(rng.choice(list("ACGT"), size=int(n)))
                    for n in lens])
    out[3][0] = out[1][2]
    return out


def finalize_variants(finalize, table):
    """Unfiltered finalize, then --unique style (count == 1) for a table
    with coordinates, --count style (count >= 2, clamped) without: each
    filter is one more interpret-mode compile on the JAX side."""
    if table.coords:
        return [finalize(table), finalize(table, 1, 1)]
    return [finalize(table), finalize(table, min_count=2, count_clamp=255)]


def assert_same_final(got, want):
    for g, w in zip(got, want):
        assert len(g) == len(w) == 5
        for a, b in zip(g[:4], w[:4]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert g[4] == w[4]


# (k, coords, staging depth, grow after batch i or None)
STREAM_CONFIGS = {
    "k16_coords_depth0_grow": (16, True, 0, 2),
    "k21_depth1": (21, False, 1, None),
}


def jax_stream(reads, k, coords, depth, grow_at, capacity=1 << 13,
               snapshot_at=None):
    folder = j_stream.StagedFolder(
        j_stream.StreamCountTable.create(capacity, wide=k > 16,
                                         coords=coords), depth=depth,
        window=4096)
    offset, snap = 0, None
    for i, rs in enumerate(reads):
        arrs, live = j_stream.batch_entries(j_pack(rs), k, offset,
                                            coords=coords)
        folder.push(arrs, live)
        offset += len(rs)
        if i == grow_at:
            folder.table = j_stream.grow(folder.table, 2 * capacity)
        if i == snapshot_at:
            t = folder.table
            snap = dict(arrs=[np.asarray(a) for a in t.arrs],
                        used=int(np.asarray(t.used)),
                        n_dropped=int(np.asarray(t.n_dropped)),
                        last_distinct=int(np.asarray(t.last_distinct)),
                        grow_hint=int(np.asarray(t.grow_hint)),
                        wide=t.wide, coords=t.coords, cap=t.cap)
    return folder.flush(), snap


def torch_stream(reads, k, coords, depth, grow_at, capacity=1 << 13,
                 table=None, start=0):
    folder = t_stream.StagedFolder(
        table if table is not None else t_stream.StreamCountTable.create(
            capacity, wide=k > 16, coords=coords, device="cpu"), depth=depth)
    offset = sum(len(rs) for rs in reads[:start])
    for i, rs in enumerate(reads[start:], start):
        run = t_stream.batch_entries(t_pack(rs), k,
                                     np.arange(offset, offset + len(rs)),
                                     coords=coords)
        folder.push(run)
        offset += len(rs)
        if i == grow_at:
            folder.table = t_stream.grow(folder.table, 2 * capacity)
    return folder.flush()


@pytest.fixture(scope="module", params=sorted(STREAM_CONFIGS))
def jax_run(request):
    k, coords, depth, grow_at = STREAM_CONFIGS[request.param]
    reads = batches_of_reads(k)
    table, snap = jax_stream(reads, k, coords, depth, grow_at, snapshot_at=1)
    return dict(cfg=STREAM_CONFIGS[request.param], reads=reads, snap=snap,
                final=finalize_variants(j_stream.finalize, table),
                table=table)


def test_stream_finalize_matches_jax(jax_run):
    k, coords, depth, grow_at = jax_run["cfg"]
    table = torch_stream(jax_run["reads"], k, coords, depth, grow_at)
    assert table.capacity == (1 << 14 if grow_at is not None else 1 << 13)
    assert_same_final(finalize_variants(t_stream.finalize, table),
                      jax_run["final"])
    assert jax_run["final"][0][4] == 0 and len(jax_run["final"][0][0]) > 0


def test_jax_stream_continued_in_port(jax_run):
    """table_from_jax: the JAX table after two batches (nothing staged at
    depth 0 or 1), carried over and folded on in the port, finalizes as the
    all-JAX stream does."""
    k, coords, depth, grow_at = jax_run["cfg"]
    table = t_stream.table_from_jax(**jax_run["snap"], device="cpu")
    assert table.used == jax_run["snap"]["used"] > 0
    table = torch_stream(jax_run["reads"], k, coords, depth, grow_at,
                         table=table, start=2)
    assert_same_final(finalize_variants(t_stream.finalize, table),
                      jax_run["final"])


def test_finalize_phases_match_jax(jax_run):
    """finalize(phases=dict): the JAX keys, added to what the dict holds;
    the same records count; the same results as without the dict."""
    k, coords, depth, grow_at = jax_run["cfg"]
    jph = {"agg_s": 1.0, "other": 7}
    j_stream.finalize(jax_run["table"], phases=jph)
    table = torch_stream(jax_run["reads"], k, coords, depth, grow_at)
    tph = {"agg_s": 1.0, "other": 7}
    got = t_stream.finalize(table, phases=tph)
    assert_same_final([got], jax_run["final"][:1])
    assert_same_final([t_stream.finalize(table)], [got])
    assert set(tph) == set(jph) == {"agg_s", "records", "xfer_s", "other"}
    assert tph["records"] == jph["records"] == len(got[0]) > 0
    assert tph["agg_s"] > 1.0 and tph["xfer_s"] >= 0.0 and tph["other"] == 7
    # a second call adds to the same keys; a filter that keeps nothing
    # copies nothing, so it adds no xfer_s (the JAX version returns early)
    t_stream.finalize(table, min_count=1 << 30, phases=tph)
    assert tph["records"] == len(got[0])
    xfer = tph["xfer_s"]
    t_stream.finalize(table, phases=tph)
    assert tph["records"] == 2 * len(got[0]) and tph["xfer_s"] > xfer
    empty = {}
    t_stream.finalize(t_stream.StreamCountTable.create(
        64, wide=k > 16, coords=coords, device="cpu"), phases=empty)
    assert set(empty) == {"agg_s", "records"} and empty["records"] == 0


def test_batch_entries_match_jax():
    reads = batches_of_reads(3)[0]
    for k, coords in ((16, True), (21, True), (11, False), (32, False)):
        arrs, live = j_stream.batch_entries(j_pack(reads), k, 40,
                                            coords=coords)
        live = int(live)
        a = [np.asarray(x)[:live] for x in arrs]
        if k > 16:
            want = ((a[0].astype(np.uint64) << np.uint64(32)) | a[1]) \
                - np.uint64(1)
        else:
            want = a[0] - np.uint32(1)
        key, crd = t_stream.batch_entries(t_pack(reads), k,
                                          np.arange(40, 40 + len(reads)),
                                          coords=coords)
        got = key.numpy().view(np.uint64 if k > 16 else np.uint32)
        np.testing.assert_array_equal(got, want)
        assert (crd is None) == (not coords)
        if coords:
            c = crd.numpy().view(np.uint64)
            np.testing.assert_array_equal(c >> np.uint64(32), a[-2])
            np.testing.assert_array_equal(c & np.uint64(0xFFFFFFFF), a[-1])


def test_batch_entries_read_numbers_from_indices():
    """Read numbers come from the batch's read_indices, not from the row:
    the port's batches hold length-sorted rows."""
    reads = ["ACGTACGTTGCA" * 3, "TTGACCA" * 3]
    idx = np.array([17, 5])
    key, crd = t_stream.batch_entries(t_pack(reads), 8, idx, coords=True)
    rn = (crd.numpy().view(np.uint64) >> np.uint64(32)).astype(np.int64)
    assert sorted(set(rn.tolist())) == [5, 17]
    assert (rn == 17).sum() == len(reads[0]) - 8 + 1


def test_spill_merge_stream_matches_jax():
    """Two mid-stream spills plus the final table, k-way merged with a
    small chunk (several pivot steps), in both packages."""
    reads = batches_of_reads(99)
    k, cap = 16, 1 << 13
    outs = {}
    for name, stream_mod, spill_mod in (("jax", j_stream, j_spill),
                                        ("torch", t_stream, t_spill)):
        store = spill_mod.SpillStore(wide=False, coords=True)
        table = stream_mod.StreamCountTable.create(
            cap, wide=False, coords=True,
            **({"device": "cpu"} if name == "torch" else {}))
        offset = 0
        for i, rs in enumerate(reads):
            if name == "jax":
                arrs, live = stream_mod.batch_entries(j_pack(rs), k, offset,
                                                      coords=True)
                table = stream_mod.fold(table, arrs, live)
            else:
                run = stream_mod.batch_entries(
                    t_pack(rs), k, np.arange(offset, offset + len(rs)),
                    coords=True)
                table = stream_mod.fold(table, run)
            offset += len(rs)
            if i in (1, 3):
                table = store.spill_table(table)
        store.spill_table(table)
        assert store.n_segments == 3 and store.n_dropped == 0
        blocks = list(store.merge_stream(chunk=700))
        assert len(blocks) > 2
        outs[name] = [np.concatenate(c) for c in zip(*blocks)]
        store.close()
    for g, w in zip(outs["torch"], outs["jax"]):
        np.testing.assert_array_equal(g, w)


def test_fold_empty_run_and_empty_finalize():
    table = t_stream.StreamCountTable.create(1 << 10, wide=True,
                                             coords=True, device="cpu")
    keys, counts, rn, ps, dropped = t_stream.finalize(table, 2,
                                                      count_clamp=0xFFFF)
    assert (keys.dtype, counts.dtype, rn.dtype, len(keys), dropped) == \
        (np.uint64, np.uint16, np.uint32, 0, 0)
    empty = (torch.zeros(0, dtype=torch.int64),
             torch.zeros(0, dtype=torch.int64))
    table = t_stream.fold(table, empty)
    assert table.used == 0
    run = t_stream.batch_entries(t_pack([batches_of_reads(1)[0][0][:40]]),
                                 21, [0], coords=True)
    table = t_stream.fold(table, run)
    keys, counts, rn, ps, _ = t_stream.finalize(table)
    assert len(keys) == 20 and counts.sum() == 20


def test_fold_drops_largest_keys_past_capacity():
    reads = batches_of_reads(5)[0]
    run = t_stream.batch_entries(t_pack(reads), 11, np.arange(len(reads)))
    big = t_stream.fold(t_stream.StreamCountTable.create(
        1 << 13, wide=False, coords=False, device="cpu"), run)
    k_all, c_all, _, _, d0 = t_stream.finalize(big)
    small = t_stream.fold(t_stream.StreamCountTable.create(
        512, wide=False, coords=False, device="cpu"), run)
    k_s, c_s, _, _, dropped = t_stream.finalize(small)
    assert d0 == 0 and dropped == run[0].numel() - 512
    n = len(k_s)
    np.testing.assert_array_equal(k_s, k_all[:n])
    np.testing.assert_array_equal(c_s[:-1], c_all[: n - 1])


def test_staged_folder_auto_depth():
    t = t_stream.StreamCountTable.create(1 << 13, wide=False, coords=False,
                                         device="cpu")
    assert t_stream.StagedFolder(t).depth == 0
    for cap, depth in ((1 << 27, 1), (1 << 28, 2)):
        # a stride-0 view: the capacity without the memory
        big = dataclasses.replace(
            t, key=torch.zeros(1, dtype=torch.int32).expand(cap))
        assert t_stream.StagedFolder(big).depth == depth


@pytest.mark.parametrize("upper", [10_000_000, 150])
def test_read_statistics_match_jax(tmp_path, upper):
    """Base composition and length histograms, with reads whose base
    percentage lands on .5 (3/8 -> 37.5 and 5/8 -> 62.5: half to even)."""
    rng = np.random.default_rng(8)
    batches = [["AAACCCCC", "AAACCCCCGGGTTTTT", "ACGT" * 50],
               ["".join(rng.choice(list("ACGT"), size=int(n)))
                for n in rng.integers(1, 400, size=30)]]
    dists = {}
    for name, mod, pack in (("jax", j_stats, j_pack),
                            ("torch", t_stats, t_pack)):
        d = mod.ReadBaseDistribution.new(upper)
        for rs in batches:
            d.record_batch(pack(rs))
        d.ascii_dump_acgt_distribution(str(tmp_path / f"{name}.bases"))
        d.ascii_dump_readlen_distribution(str(tmp_path / f"{name}.len"))
        dists[name] = d
    j, t = dists["jax"], dists["torch"]
    np.testing.assert_array_equal(t.acgt_distribution, j.acgt_distribution)
    np.testing.assert_array_equal(t.read_lengths, j.read_lengths)
    assert (t.n_reads, t.histo_out) == (j.n_reads, j.histo_out)
    assert t.acgt_distribution[38, 0] >= 1 and t.acgt_distribution[62, 1] >= 1
    for ext in ("bases", "len"):
        assert (tmp_path / f"torch.{ext}").read_bytes() == \
            (tmp_path / f"jax.{ext}").read_bytes()
