"""The count cell on the CPU at a small size: the plain counting against
the program, the cell's run and its control, planted faults, and a
program without the counting function.

The count cell's small size joins ``sizes.TINY`` here, at import, so that
the harness's tests over every cell (``test_bench_harness.py``) run it
too.
"""

import numpy as np
import pytest
import torch

from benchmark import control
from benchmark.harness import runner
from benchmark.reference import counting, kmers
from benchmark.traffic import count_reads

from . import sizes

CELL = "ont_count_k16_resident"
SMALL = {"capacity_max": 1 << 18,
         "read_len": {"median": 300, "sigma": 0.5, "min": 30, "max": 900}}
sizes.TINY.setdefault(CELL, {"config": SMALL, "traffic": {
    "pool_reads": 200, "max_batch_bases": 16384, "check_slices": 4}})
TINY = sizes.TINY[CELL]


def run_tiny(seed=2**36 + 5, trace=False, tmp_path=None):
    return runner.run_cell(CELL, seed, 0.3, trace, device="cpu",
                           overrides=TINY, out_dir=str(tmp_path))


def test_keys_differ_counts_each_kind_of_difference():
    k = torch.tensor([5, 1, 9, 3])
    c = torch.tensor([2, 1, 4, 7])
    assert counting.keys_differ(k, c, k.flip(0), c.flip(0)) == 0
    assert counting.keys_differ(k, c + (k == 9), k, c) == 1
    assert counting.keys_differ(k[:3], c[:3], k, c) == 1
    assert counting.keys_differ(k, c, k[1:], c[1:]) == 1
    assert counting.keys_differ(k, c, k[:0], c[:0]) == 4


@pytest.mark.parametrize("k", [16, 21])
def test_the_plain_counting_matches_the_program(k):
    from kmerutils_tpu_torch.base.sequence import ReadBatch
    from kmerutils_tpu_torch.count.stream import StreamCounter
    from benchmark.harness.jobs import pack
    config = dict(SMALL, genome_len=3 * 10**9, both_strands=True,
                  err_rate=0.06)
    pool = count_reads.make_pool(config, {
        "pool_reads": 120, "lengths_seed": 0, "batch_reads": 32,
        "max_batch_bases": 16384, "window_batches": 4}, 2**34 + k)
    ctr = StreamCounter(k, capacity_max=1 << 18, device="cpu")
    ref = counting.Counter(3)
    for b, idx in enumerate(pool.batches):
        ln = torch.as_tensor(pool.lengths[idx])
        codes = pool.codes(idx, "cpu")
        batch = ReadBatch(pack(codes, torch.cumsum(ln, 0) - ln, ln, "cpu"),
                          ln.to(torch.int32))
        for _ in range(1 + b % 3):
            ctr.add(batch, idx)
        ref.add(kmers.canonical(codes, pool.lengths[idx], k, "cpu")[0],
                1 + b % 3)
    [(keys, counts, _, _)], dropped = ctr.finish()
    got = (torch.from_numpy(keys.astype(np.int64)),
           torch.from_numpy(counts.astype(np.int64)))
    want = [torch.cat(t) for t in zip(*[ref.counts(i) for i in range(3)])]
    assert dropped == 0 and int(want[1].max()) == 3
    assert counting.keys_differ(*got, *want) == 0


def test_the_reads_carry_both_strands_and_errors():
    config = dict(SMALL, genome_len=10**6, both_strands=True, err_rate=0.06)
    pool = count_reads.make_pool(config, {
        "pool_reads": 400, "lengths_seed": 0, "batch_reads": 64,
        "max_batch_bases": 16384, "window_batches": 4}, 99)
    assert 0.4 < pool.strands.mean() < 0.6
    clean = dict(config, err_rate=0.0)
    pool0 = count_reads.make_pool(clean, {
        "pool_reads": 400, "lengths_seed": 0, "batch_reads": 64,
        "max_batch_bases": 16384, "window_batches": 4}, 99)
    idx = np.arange(400)
    a, b = pool.codes(idx, "cpu"), pool0.codes(idx, "cpu")
    assert 0.05 < float((a != b).double().mean()) < 0.07
    # a reverse read is the reverse complement of the genome's bases
    r = int(np.flatnonzero(pool0.strands)[0])
    fwd = dict(clean, both_strands=False)
    pf = count_reads.make_pool(fwd, {
        "pool_reads": 400, "lengths_seed": 0, "batch_reads": 64,
        "max_batch_bases": 16384, "window_batches": 4}, 99)
    assert pf.starts[r] == pool0.starts[r]
    assert torch.equal(pool0.codes([r], "cpu"),
                       3 - pf.codes([r], "cpu").flip(0))


@pytest.mark.parametrize("trace", [False, True])
def test_the_cell_runs_correct(trace, tmp_path):
    res = run_tiny(trace=trace, tmp_path=tmp_path)
    assert res["correct"] is True and res["attempted"] >= 1
    assert res["checks"] == {"count_keys_differ": {"value": 0, "limit": 0}}


def test_the_control_fails():
    [(name, value, limit)] = control.readings(CELL, 2**33 + 9, "cpu",
                                              overrides=TINY)
    assert name == "count_keys_differ" and value > limit


def altered_count(monkeypatch):
    from kmerutils_tpu_torch.ops import merge
    orig = merge.merge_fold

    def bad(*a, **kw):
        key, cnt, crd, n = orig(*a, **kw)
        cnt = cnt.clone()
        cnt[n // 2] += 1
        return key, cnt, crd, n
    monkeypatch.setattr(merge, "merge_fold", bad)


def batch_left_out(monkeypatch):
    from kmerutils_tpu_torch.count import stream
    orig = stream.batch_entries
    calls = []

    def bad(batch, k, *a, **kw):
        key, crd = orig(batch, k, *a, **kw)
        calls.append(1)
        return (key[:0], crd) if len(calls) == 5 else (key, crd)
    monkeypatch.setattr(stream, "batch_entries", bad)


def key_dropped(monkeypatch):
    from kmerutils_tpu_torch.count import stream
    orig = stream.finalize

    def bad(*a, **kw):
        keys, counts, rn, ps, dropped = orig(*a, **kw)
        keep = np.arange(keys.size) != keys.size // 2
        return keys[keep], counts[keep], rn[keep], ps[keep], dropped
    monkeypatch.setattr(stream, "finalize", bad)


@pytest.mark.parametrize("fault", [altered_count, batch_left_out,
                                   key_dropped])
def test_a_planted_fault_is_not_correct(fault, monkeypatch, tmp_path):
    fault(monkeypatch)
    res = run_tiny(2**35 + 3, tmp_path=tmp_path)
    assert res["correct"] is False
    assert res["checks"]["count_keys_differ"]["value"] > 0


def test_a_program_without_the_counting_function_fails(monkeypatch,
                                                       tmp_path):
    from kmerutils_tpu_torch.count import stream
    monkeypatch.delattr(stream, "StreamCounter")
    with pytest.raises(ImportError):
        run_tiny(tmp_path=tmp_path)
