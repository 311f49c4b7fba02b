"""The port's in-program spans (kmerutils_tpu_torch/obs.py) on the CPU: the
sketch layer's three stages tile a PROB3A call, in order, with their work;
a sink that is off costs no clock, no event and no allocation; the
signatures do not depend on the sink; a span closes when its body raises."""

from __future__ import annotations

import gc
import sys

import numpy as np
import pytest
import torch

from kmerutils_tpu_torch import obs
from kmerutils_tpu_torch.base.sequence import pack_ascii_reads
from kmerutils_tpu_torch.sketch import block
from kmerutils_tpu_torch.sketch.jaccard import Sketcher
from kmerutils_tpu_torch.sketch.params import SeqSketcherParams, SketchAlgo

M = 24
STAGES = ["sketch.kmers", "sketch.weights", "sketch.draw"]


class ListSink:
    def __init__(self):
        self.spans: list = []
        self.records: list = []

    def add(self, name, t0, t1):
        self.spans.append((name, t0, t1))

    def record(self, name, value):
        self.records.append((name, value))


@pytest.fixture
def sink(monkeypatch):
    s = ListSink()
    monkeypatch.setattr(obs, "sink", s)
    return s


def batch(seed: int = 3, n: int = 7):
    rng = np.random.default_rng(seed)
    lens = rng.integers(20, 400, size=n)
    lens[0] = 4                                     # no k-mer at all
    return pack_ascii_reads(["".join(rng.choice(list("ACGT"), size=int(L)))
                             for L in lens], device="cpu")


def sketcher(k: int, algo=SketchAlgo.PROB3A) -> Sketcher:
    return Sketcher(params=SeqSketcherParams(kmer_size=k, sketch_size=M,
                                             algo=algo))


@pytest.mark.parametrize("k", [8, 21])
def test_sketch_batch_emits_the_three_stages_in_order(k, sink, monkeypatch):
    handed = []
    span = obs.span

    def spy(name, work=0, device=None, after=None):
        opened = span(name, work, device, after)
        handed.append((name, work, device, after, opened))
        return opened
    monkeypatch.setattr(obs, "span", spy)
    b = batch()
    sketcher(k).sketch_batch(b)
    assert [n for n, _, _ in sink.spans] == STAGES
    for (_, a0, a1), (_, b0, b1) in zip(sink.spans, sink.spans[1:]):
        assert a0 <= a1 <= b0 <= b1
    P = b.max_len - k + 1
    assert [(n, w) for n, w, _, _, _ in handed] == [(s, b.n_reads * P)
                                                    for s in STAGES]
    assert all(d.type == "cpu" for _, _, d, _, _ in handed)
    # the draw opens where the weights closed; the others open on their own
    assert [a for _, _, _, a, _ in handed] == [None, None, handed[1][4]]
    assert sink.records == []                       # no events on the CPU


@pytest.mark.parametrize("k", [8, 21])
def test_signatures_are_the_same_with_the_sink_on_and_off(k, monkeypatch):
    b = batch(5)
    off = sketcher(k).sketch_batch(b)
    s = ListSink()
    monkeypatch.setattr(obs, "sink", s)
    on = sketcher(k).sketch_batch(b)
    assert on.dtype == off.dtype and torch.equal(on, off)
    assert len(s.spans) == 3


def held(make) -> int:
    """Memory blocks alive inside a ``with make():`` body, beyond before
    it (the most over 200 entries after 50 to warm up)."""
    most = 0
    for i in range(250):
        before = sys.getallocatedblocks()
        with make():
            if i >= 50:
                most = max(most, sys.getallocatedblocks() - before)
    return most


@pytest.mark.parametrize("k", [8, 21])
def test_off_reads_no_clock_records_no_event_and_allocates_nothing(
        k, monkeypatch):
    assert obs.sink is None

    def forbidden(*a, **kw):
        raise AssertionError("touched while the sink is off")
    monkeypatch.setattr(obs.time, "perf_counter_ns", forbidden)
    monkeypatch.setattr(obs.torch.cuda, "Event", forbidden)
    monkeypatch.setattr(obs.torch.cuda, "current_stream", forbidden)
    sketcher(k).sketch_batch(batch())
    assert obs.span("sketch.draw", 10**9) is obs.span("x") is obs._NULL

    dev = torch.device("cpu")
    gc.disable()
    try:
        # blocks held inside the body: the same as the bare null context
        bare = held(lambda: obs._NULL)
        assert held(lambda: obs.span("sketch.kmers", 123456789, dev)) == bare
        before = sys.getallocatedblocks()
        for _ in range(100000):
            with obs.span("sketch.kmers", 123456789, dev):
                pass
        assert sys.getallocatedblocks() - before < 10
        monkeypatch.undo()                      # the clock and CUDA again
        monkeypatch.setattr(obs, "sink", ListSink())
        assert held(lambda: obs.span("sketch.kmers", 1, dev)) > bare
    finally:
        gc.enable()


class FakeEvent:
    def __init__(self, enable_timing=False):
        assert enable_timing
        self.on = None

    def record(self, stream):
        self.on = stream


@pytest.fixture
def fake_cuda(monkeypatch):
    """CUDA's stream and events replaced, to follow the card path here."""
    stream = object()
    monkeypatch.setattr(obs.torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(obs.torch.cuda, "current_stream",
                        lambda device=None: stream)
    return stream


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_a_span_closes_when_its_body_raises(device, sink, fake_cuda):
    with pytest.raises(ValueError):
        with obs.span("sketch.draw", 42, torch.device(device)):
            raise ValueError("inside")
    [(name, t0, t1)] = sink.spans
    assert name == "sketch.draw" and t0 <= t1
    if device == "cpu":
        assert sink.records == []
    else:
        [(name, (work, a, b))] = sink.records
        assert (name, work) == ("sketch.draw", 42)
        assert a is not b and a.on is b.on is fake_cuda


def test_a_cuda_span_records_its_work_and_two_events_on_the_stream(
        sink, fake_cuda):
    with obs.span("sketch.weights", 7 * 300, torch.device("cuda", 0)):
        pass
    with obs.span("sketch.weights", 5, torch.device("cuda", 0)):
        pass
    assert [n for n, _, _ in sink.spans] == ["sketch.weights"] * 2
    assert [(n, w) for n, (w, _, _) in sink.records] == [
        ("sketch.weights", 2100), ("sketch.weights", 5)]
    assert all(a.on is b.on is fake_cuda for _, (_, a, b) in sink.records)


def test_a_span_after_another_opens_on_its_closing_event(sink, fake_cuda):
    dev = torch.device("cuda", 0)
    with obs.span("sketch.weights", 3, dev) as first:
        pass
    with obs.span("sketch.draw", 3, torch.device("cpu"), after=first):
        pass
    with obs.span("sketch.draw", 4, dev, after=None):
        pass
    [(_, (_, a, b)), (_, (_, c, d)), (_, (_, e, f))] = sink.records
    assert c is b and b is first.end and d is not b
    assert len({id(x) for x in (a, b, d, e, f)}) == 5
    assert all(x.on is fake_cuda for x in (a, b, d, e, f))


def test_a_span_after_a_cpu_span_records_its_own_events(sink, fake_cuda):
    with obs.span("sketch.weights", 3, torch.device("cpu")) as first:
        pass
    with obs.span("sketch.draw", 3, torch.device("cuda", 0), after=first):
        pass
    [(name, (_, a, b))] = sink.records
    assert name == "sketch.draw" and a is not b and a.on is b.on is fake_cuda


@pytest.mark.parametrize("k", [8, 21])
def test_block_sketches_tile_the_same_three_stages(k, sink):
    b = batch(7)
    block.block_sketch(b, k, M, 64)
    assert [n for n, _, _ in sink.spans] == STAGES


@pytest.mark.parametrize("algo", [SketchAlgo.SUPER2, SketchAlgo.HLL])
def test_the_other_families_open_only_the_kmer_span(algo, sink):
    """None of the PROB3A stages: HLL opens the k-mer span alone, SUPER2
    the k-mer span and then its grid stage (``sketch.grid``)."""
    sketcher(8, algo).sketch_batch(batch())
    want = {SketchAlgo.SUPER2: ["sketch.kmers", "sketch.grid"],
            SketchAlgo.HLL: ["sketch.kmers"]}[algo]
    assert [n for n, _, _ in sink.spans] == want
