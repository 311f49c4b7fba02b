"""ProbMinHash at k=21 (u64 items) on the CPU: the port's
``Sketcher.sketch_batch`` against the plain reference over 64-bit k-mers
that the k=21 sketch cell holds the card to
(``benchmark/reference/probminhash64.py``), on seeded random reads; the
reference against values worked by hand; its bfloat16 control; and the
counter of KW's wide route (``sketch.weights_wide``)."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from benchmark.reference import probminhash64 as ref
from kmerutils_tpu_torch import obs
from kmerutils_tpu_torch.base.sequence import pack_codes
from kmerutils_tpu_torch.ops import weights as KW
from kmerutils_tpu_torch.sketch import probminhash
from kmerutils_tpu_torch.sketch.jaccard import Sketcher, hashed_kmers
from kmerutils_tpu_torch.sketch.params import (DataType, SeqSketcherParams,
                                               SketchAlgo)

K = 21
U64 = (1 << 64) - 1


def sketcher(m: int) -> Sketcher:
    return Sketcher(params=SeqSketcherParams(kmer_size=K, sketch_size=m,
                                             algo=SketchAlgo.PROB3A,
                                             data_t=DataType.DNA))


def reads(kind: str, seed: int):
    """(codes uint8[n, L], lengths int64[n]) of one case: ``short`` rows
    well under 8,192 positions, ``long`` rows past it, ``repeats`` tandem
    repeats (k-mers that recur in a read, weights above 1), ``empty`` an
    empty read, a read shorter than k and one of exactly k bases."""
    rng = np.random.default_rng(seed)
    n, L = {"short": (9, 700), "long": (3, 9000), "repeats": (6, 900),
            "empty": (5, 300)}[kind]
    codes = rng.integers(0, 4, size=(n, L), dtype=np.uint8)
    lengths = rng.integers(K, L + 1, size=n)
    lengths[0] = L
    if kind == "repeats":
        for i in range(n):
            unit = rng.integers(0, 4, size=int(rng.integers(1, 30)))
            codes[i] = np.resize(unit, L)
        codes[1, 400:] = rng.integers(0, 4, size=L - 400)
    if kind == "empty":
        lengths[1:4] = (0, K - 1, K)
    return codes, lengths.astype(np.int64)


def flat(codes, lengths):
    return np.concatenate([codes[i, :lengths[i]] for i in range(len(lengths))])


def sketch(codes, lengths, m: int) -> torch.Tensor:
    batch = pack_codes(codes, lengths.astype(np.int32), device="cpu")
    return sketcher(m).sketch_batch(batch)


CASES = [(m, kind) for m in (1, 13, 200)
         for kind in ("short", "long", "repeats", "empty")]


@pytest.mark.parametrize("m,kind", CASES,
                         ids=[f"m{m}-{kind}" for m, kind in CASES])
def test_sketch_batch_at_k21_equals_the_plain_reference(m, kind):
    codes, lengths = reads(kind, 1000 * m + len(kind))
    got = sketch(codes, lengths, m)
    want = ref.signatures(flat(codes, lengths), lengths, K, m, "cpu")
    assert got.dtype == torch.int64 and got.shape == (len(lengths), m)
    assert torch.equal(got, want)
    if kind == "long":
        assert codes.shape[1] - K + 1 > 8192
    if kind == "repeats":
        _, _, winv = ref.weighted_items(flat(codes, lengths), lengths, K,
                                        "cpu")
        assert (winv < 1).any()
    if kind == "empty":
        assert not got[1:3].any() and got[3].all()


def test_an_all_ones_item_is_padding_in_the_port_and_the_reference(
        monkeypatch):
    """The item of one k-mer replaced by the all-ones word on both sides:
    it never wins, and a read holding only it gets signature 0."""
    codes, lengths = reads("short", 77)
    codes[1, :] = 0                  # read 1: one k-mer value only
    m = 13
    batch = pack_codes(codes, lengths.astype(np.int32), device="cpu")
    items, valid = hashed_kmers(batch, K)
    hit = int(items[1, 0])
    assert (items[0][valid[0]] != hit).all()
    items = torch.where(items == hit, -1, items)
    got = probminhash.probminhash_from_items(items, valid, m)[0]
    wang64 = ref.wang64
    monkeypatch.setattr(ref, "wang64", lambda x: torch.where(
        wang64(x) == hit, -1, wang64(x)))
    want = ref.signatures(flat(codes, lengths), lengths, K, m, "cpu")
    assert torch.equal(got, want)
    assert not got[1].any() and got[0].all()


def py_wang64(x: int) -> int:
    x = (~x + (x << 21)) & U64
    x ^= x >> 24
    x = (x + (x << 3) + (x << 8)) & U64
    x ^= x >> 14
    x = (x + (x << 2) + (x << 4)) & U64
    x ^= x >> 28
    return (x + (x << 31)) & U64


def py_draw(item: int, slot: int, w: int) -> float:
    """e(item, slot) in float64: ln(u) / w on the folded item."""
    c = ref.slot_constants(slot + 1, "cpu")[slot].item()
    h = ((item & 0xFFFFFFFF) ^ (item >> 32)) ^ c
    h = (h * 0x9E3779B1) & 0xFFFFFFFF
    h ^= h >> 15
    h = (h * 0x85EBCA77) & 0xFFFFFFFF
    return math.log(((h >> 8) + 1) * 2.0**-24) / w


def signed(x: int) -> int:
    return x - (1 << 64) if x >> 63 else x


def test_the_reference_by_hand():
    # a read of 22 A's: one 21-mer twice, whose canonical value is 0
    want = signed(py_wang64(0))
    assert ref.wang64(torch.tensor([0])).item() == want
    sig = ref.signatures(np.zeros(22, np.uint8), np.array([22]), K, 5, "cpu")
    assert sig.tolist() == [[want] * 5]
    # 22 A's then 21 C's: the 21-mers A^(21-j) C^j, j = 0..21, each the
    # smaller of it and its complement G^j T^(21-j); j = 0 twice
    codes = np.array([0] * 22 + [1] * 21, np.uint8)
    sig = ref.signatures(codes, np.array([43]), K, 40, "cpu")
    items = {py_wang64(int("01" * j, 2) if j else 0): 1 + (j == 0)
             for j in range(K + 1)}
    seen = set()
    for s in range(40):
        e = sorted((py_draw(x, s, w), x) for x, w in items.items())
        if e[-1][0] - e[-2][0] > 1e-4:        # no near-tie in float32
            assert sig[0, s].item() == signed(e[-1][1])
            seen.add(e[-1][1])
    assert len(seen) > 5


@pytest.mark.parametrize("items,winner", [
    ((0x0000000100000001, 0x0000000200000002), 0x0000000100000001),
    ((0x8000000080000000, 0x0000000200000002), 0x0000000200000002)],
    ids=["smaller-first", "unsigned-order"])
def test_a_tie_of_folds_goes_to_the_smaller_item(items, winner,
                                                 monkeypatch):
    """Two items with the same 32-bit fold (0) and weight draw alike in
    every slot: the smaller in unsigned order wins each."""
    # A..AA and A..AC: two k-mers, canonical values 0 and 1, in one read
    table = {0: signed(items[0]), 1: signed(items[1])}
    monkeypatch.setattr(ref, "wang64", lambda x: torch.tensor(
        [table[int(v)] for v in x], dtype=torch.int64))
    codes = np.array([0] * 21 + [1], np.uint8)
    _, item, winv = ref.weighted_items(codes, np.array([22]), K, "cpu")
    assert sorted(item.tolist()) == sorted(table.values())
    assert winv.tolist() == [1.0, 1.0]
    sig = ref.signatures(codes, np.array([22]), K, 7, "cpu")
    assert sig.tolist() == [[signed(winner)] * 7]


def test_the_bfloat16_control_differs():
    codes, lengths = reads("short", 5)
    f = flat(codes, lengths)
    want = ref.signatures(f, lengths, K, 200, "cpu")
    low = ref.signatures(f, lengths, K, 200, "cpu", "bfloat16")
    assert (low != want).any(dim=1).float().mean() > 0.5


class ListSink:
    def __init__(self):
        self.records: list = []

    def add(self, name, t0, t1):
        pass

    def record(self, name, value):
        self.records.append((name, value))


def test_the_wide_route_counter_records_only_while_a_sink_is_set(
        monkeypatch):
    assert obs.sink is None
    KW.count_wide(4, 20000, 1 << 20)                # nothing to record to
    sink = ListSink()
    monkeypatch.setattr(obs, "sink", sink)
    KW.count_wide(4, 20000, 1 << 20)
    KW.count_wide(512, 16364, 0)
    assert sink.records == [("sketch.weights_wide", 80000),
                            ("sketch.weights_wide", 0)]
    # the plain version on the CPU has no route and counts nothing
    items = torch.arange(12, dtype=torch.int64).view(3, 4)
    KW.sort_weights(items, torch.ones_like(items, dtype=torch.bool))
    assert len(sink.records) == 2
