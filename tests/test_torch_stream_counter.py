"""The port's counting loop, ``count/stream.StreamCounter``, on the CPU at
small sizes: its counts against a plain counting of the reads' canonical
k-mers (``collections.Counter`` over the read text) on reads with
substitutions on both strands, batches pushed more than once; its batch
entries against the JAX package's ``batch_entries``, from host lengths or
from the batch's own; the growth ladder through two growths at staging
depths 0-2; the spill switch; the spans and counters it hands a sink, and
nothing without one; and ``parsefastq kmer`` counting through it, with
ingest's host lengths.

Tolerance: exact equality of every key, count and coordinate, and no
entry dropped where the table suffices.
"""

from __future__ import annotations

import collections

import numpy as np
import pytest
import torch

from kmerutils_tpu.base.sequence import pack_ascii_reads as j_pack
from kmerutils_tpu.count import stream as j_stream
from kmerutils_tpu_torch import obs
from kmerutils_tpu_torch.base.sequence import ReadBatch, pack_ascii_reads
from kmerutils_tpu_torch.count import stream

ACGT = np.frombuffer(b"ACGT", np.uint8)
COMPLEMENT = str.maketrans("ACGT", "TGCA")
DIGITS = str.maketrans("ACGT", "0123")


def make_reads(n_reads: int, seed: int, genome_len: int = 10**6):
    """``n_reads`` reads of a seeded random genome: lognormal lengths
    (median 70, [40, 120]), each reverse-complemented with probability 1/2
    and given 6 % uniform substitutions."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, genome_len, dtype=np.uint8)
    lengths = np.clip(np.round(rng.lognormal(np.log(70), 0.3, n_reads)),
                      40, 120).astype(np.int64)
    reads = []
    for ln in lengths:
        s = int(rng.integers(0, genome_len - ln))
        c = genome[s:s + ln].copy()
        if rng.random() < 0.5:
            c = 3 - c[::-1]
        sub = rng.random(ln) < 0.06
        c[sub] = (c[sub] + rng.integers(1, 4, int(sub.sum()))) & 3
        reads.append(ACGT[c].tobytes().decode())
    return reads


def batches_of(reads, batch_reads: int):
    return [reads[i:i + batch_reads]
            for i in range(0, len(reads), batch_reads)]


def plain_counts(batches, k: int, pushes) -> dict:
    """count(key) = the sum over batches of its pushes x the key's
    occurrences among the batch's canonical k-mers; a k-mer string's order
    is its value's, so the canonical one is the smaller string."""
    c: collections.Counter = collections.Counter()
    for reads, m in zip(batches, pushes):
        for r in reads if m else ():
            rc = r.translate(COMPLEMENT)[::-1]
            n = len(r)
            for p in range(n - k + 1):
                c[min(r[p:p + k], rc[n - k - p:n - p])] += int(m)
    return {int(s.translate(DIGITS), 4): v for s, v in c.items()}


def program_counts(blocks) -> dict:
    out: dict = {}
    for keys, counts, _, _ in blocks:
        out.update(zip(keys.tolist(), counts.tolist()))
    return out


def run(batches, k: int, order, host_lengths: bool = True, capacity=None,
        depth=None, **kw):
    """Push ``batches`` (lists of reads) in ``order`` through a counter,
    each packed with its host lengths or as a batch made where it lives,
    without them; its first table of ``capacity`` entries staged at
    ``depth`` where given, as the card's ladder runs from 2^26.  Returns
    (counter, {key: count}, n_dropped, pushes of each batch)."""
    packed = [pack_ascii_reads(reads, device="cpu") for reads in batches]
    if not host_lengths:
        packed = [ReadBatch(b.words, b.lengths) for b in packed]
    first = np.cumsum([0] + [len(r) for r in batches])
    ctr = stream.StreamCounter(k, device="cpu", **kw)
    if capacity is not None:
        ctr.folder = stream.StagedFolder(stream.StreamCountTable.create(
            capacity, wide=k > 16, coords=ctr.coords, device="cpu"), depth)
    pushes = np.zeros(len(batches), np.int64)
    for b in order:
        ctr.add(packed[b], np.arange(first[b], first[b + 1]))
        pushes[b] += 1
    blocks, dropped = ctr.finish()
    return ctr, program_counts(blocks), dropped, pushes


@pytest.mark.parametrize("host_lengths", [False, True])
@pytest.mark.parametrize("coords", [False, True])
@pytest.mark.parametrize("k", [16, 21])
def test_counts_match_the_plain_counting(k, coords, host_lengths):
    batches = batches_of(make_reads(60, 2**40 + k), 8)
    n = len(batches)
    # every batch once, the first half again, batch 1 a third time
    order = list(range(n)) + list(range(n // 2)) + [1]
    ctr, got, dropped, pushes = run(batches, k, order, host_lengths,
                                    coords=coords, capacity_max=1 << 16)
    assert dropped == 0 and ctr.n_segments == 0 and not ctr.grown_at
    assert pushes.max() == 3
    assert got == plain_counts(batches, k, pushes)


@pytest.mark.parametrize("coords", [False, True])
@pytest.mark.parametrize("k", [11, 16, 21, 32])
def test_entries_from_host_lengths_equal_the_selected_ones(k, coords):
    """The port's entries, with the valid positions counted from the host
    lengths (``ReadBatch.to``) or read from the batch, equal the JAX
    package's ``batch_entries`` on the same reads, a read with no k-mer
    among them."""
    reads = make_reads(12, 2**41 + k)
    reads[3] = reads[3][:k - 1]
    arrs, live = j_stream.batch_entries(j_pack(reads), k, 40, coords=coords)
    a = [np.asarray(x)[:int(live)] for x in arrs]
    if k > 16:
        want = ((a[0].astype(np.uint64) << np.uint64(32)) | a[1]) \
            - np.uint64(1)
    else:
        want = a[0] - np.uint32(1)
    moved = pack_ascii_reads(reads, device="cpu")
    assert torch.equal(moved.host_lengths, moved.lengths)
    for batch in (moved, ReadBatch(moved.words, moved.lengths)):
        key, crd = stream.batch_entries(batch, k, np.arange(40, 52),
                                        coords=coords)
        got = key.numpy().view(np.uint64 if k > 16 else np.uint32)
        np.testing.assert_array_equal(got, want)
        assert (crd is None) == (not coords)
        if coords:
            c = crd.numpy().view(np.uint64)
            np.testing.assert_array_equal(c >> np.uint64(32), a[-2])
            np.testing.assert_array_equal(c & np.uint64(0xFFFFFFFF), a[-1])


def test_host_lengths_that_disagree_with_the_batch_raise():
    batch = pack_ascii_reads(make_reads(4, 5), device="cpu")
    wrong = ReadBatch(batch.words, batch.lengths, batch.lengths - 1)
    with pytest.raises(ValueError, match="valid positions"):
        stream.batch_entries(wrong, 16, np.arange(4))


@pytest.mark.parametrize("depth", [0, 1, 2])
def test_the_ladder_grows_twice_at_each_staging_depth(depth):
    batches = batches_of(make_reads(400, 7), 2)
    ctr, got, dropped, pushes = run(batches, 16, range(len(batches)),
                                    capacity=1 << 12, capacity_max=1 << 18,
                                    depth=depth)
    assert ctr.folder.depth == depth
    assert [c for _, c in ctr.grown_at] == [1 << 15, 1 << 18]
    assert ctr.capacity == 1 << 18
    assert dropped == 0 and ctr.n_segments == 0
    assert got == plain_counts(batches, 16, pushes)


@pytest.mark.parametrize("spill", [True, False])
def test_the_spill_switch_at_the_top_of_the_ladder(spill):
    batches = batches_of(make_reads(400, 11), 2)
    ctr, got, dropped, pushes = run(batches, 16, range(len(batches)),
                                    capacity=1 << 12, capacity_max=1 << 12,
                                    depth=0, spill=spill)
    assert not ctr.grown_at
    want = plain_counts(batches, 16, pushes)
    if spill:
        assert ctr.n_segments >= 2 and dropped == 0
        assert got == want
    else:
        # the largest keys drop past capacity: fewer keys, none extra
        assert ctr.n_segments == 0 and dropped > 0
        assert len(got) < len(want)
        assert set(got) <= set(want)


class ListSink:
    def __init__(self):
        self.spans: list = []
        self.records: list = []

    def add(self, name, t0, t1):
        self.spans.append((name, t0, t1))

    def record(self, name, value):
        self.records.append((name, value))


def test_spans_and_counters_reach_the_sink(monkeypatch):
    sink = ListSink()
    monkeypatch.setattr(obs, "sink", sink)
    handed = []
    span = obs.span

    def spy(name, work=0, device=None, after=None):
        handed.append((name, work))
        return span(name, work, device, after)
    monkeypatch.setattr(obs, "span", spy)
    batches = batches_of(make_reads(400, 13), 2)
    ctr, got, dropped, pushes = run(batches, 16, range(len(batches)),
                                    capacity=1 << 12, capacity_max=1 << 18,
                                    depth=1)
    names = {nm for nm, _, _ in sink.spans}
    assert names == {"count.entries", "count.stage", "count.fold",
                     "count.compact"}
    assert all(t0 <= t1 for _, t0, t1 in sink.spans)
    entries = [w for nm, w in handed if nm == "count.entries"]
    packed = [pack_ascii_reads(reads, device="cpu") for reads in batches]
    assert entries == [b.n_reads * (b.max_len - 15) for b in packed]
    rec: dict = {}
    for nm, v in sink.records:
        rec.setdefault(nm, []).append(v)
    # on the CPU spans record no events: the records are the counters
    assert set(rec) == {"count.folds", "count.used", "count.compactions",
                        "count.grows"}
    assert rec["count.grows"] == [1 << 15, 1 << 18] == [
        c for _, c in ctr.grown_at]
    folds = [w for nm, w in handed if nm == "count.fold"]
    assert len(folds) == len(rec["count.folds"]) == len(rec["count.used"])
    # a fold's work: the table's entries and the run's in, the table's out
    # (as many, with nothing dropped)
    assert folds == [2 * u for u in rec["count.used"]]
    assert sum(rec["count.folds"]) == sum(
        int(m) * sum(max(len(r) - 15, 0) for r in reads)
        for reads, m in zip(batches, pushes))
    compact = [w for nm, w in handed if nm == "count.compact"]
    assert len(compact) == len(rec["count.compactions"]) > 0
    assert dropped == 0
    assert got == plain_counts(batches, 16, pushes)


def test_spill_counter_reaches_the_sink(monkeypatch):
    sink = ListSink()
    monkeypatch.setattr(obs, "sink", sink)
    batches = batches_of(make_reads(400, 17), 2)
    ctr, _, _, _ = run(batches, 16, range(len(batches)), capacity=1 << 12,
                       capacity_max=1 << 12, depth=0)
    spills = [v for nm, v in sink.records if nm == "count.spills"]
    assert len(spills) == ctr.n_segments - 1 >= 1
    assert all(v > 0 for v in spills)


def test_nothing_is_recorded_without_a_sink(monkeypatch):
    assert obs.sink is None

    def forbidden(*a, **kw):
        raise AssertionError("touched while the sink is off")
    monkeypatch.setattr(obs.time, "perf_counter_ns", forbidden)
    monkeypatch.setattr(obs.torch.cuda, "Event", forbidden)
    monkeypatch.setattr(obs.torch.cuda, "current_stream", forbidden)
    batches = batches_of(make_reads(400, 19), 2)
    ctr, got, dropped, pushes = run(batches, 16, range(len(batches)),
                                    capacity=1 << 12, capacity_max=1 << 18,
                                    depth=2)
    assert ctr.grown_at and dropped == 0
    assert got == plain_counts(batches, 16, pushes)


def test_parsefastq_counts_through_the_stream_counter(tmp_path, monkeypatch):
    """The CLI counts through one StreamCounter, and every batch it hands
    over carries ingest's host lengths, so no batch reads the device."""
    from kmerutils_tpu_torch.cli import parsefastq
    reads = make_reads(30, 23)
    fq = tmp_path / "r.fastq"
    with open(fq, "w") as f:
        for i, s in enumerate(reads):
            f.write(f"@r{i}\n{s}\n+\n{'I' * len(s)}\n")
    made, seen = [], []
    real, entries = stream.StreamCounter, stream.batch_entries

    class Spy(real):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    def spy(batch, *a, **kw):
        seen.append(batch.host_lengths)
        return entries(batch, *a, **kw)
    monkeypatch.setattr(stream, "StreamCounter", Spy)
    monkeypatch.setattr(stream, "batch_entries", spy)
    monkeypatch.chdir(tmp_path)
    assert parsefastq.main(["-f", str(fq), "--device", "cpu", "kmer",
                            "--count", "-s", "16"]) == 0
    [ctr] = made
    assert ctr.pushes == len(seen) >= 1 and ctr.k == 16 and not ctr.coords
    assert all(h is not None for h in seen)
    assert sum(int(h.numel()) for h in seen) == len(reads)
