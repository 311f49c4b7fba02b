"""SuperMinHash with integer signatures (SUPER2) at k=21 on the CPU: the
port's ``Sketcher.sketch_batch`` against the plain reference that the
SUPER2 cell holds the card to (``benchmark/reference/superminhash2.py``),
on seeded random reads; the reference against values worked by hand; its
16-bit control; and the span ``sketch.grid`` and the counter
``sketch.g1_split`` of G1's split rows."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.reference import superminhash2 as ref
from kmerutils_tpu_torch import obs
from kmerutils_tpu_torch.base.sequence import pack_codes
from kmerutils_tpu_torch.ops import sketch_grid
from kmerutils_tpu_torch.sketch import superminhash
from kmerutils_tpu_torch.sketch.jaccard import Sketcher
from kmerutils_tpu_torch.sketch.params import (DataType, SeqSketcherParams,
                                               SketchAlgo)

K = 21
M32 = 0xFFFFFFFF
M64 = (1 << 64) - 1


def sketcher(m: int) -> Sketcher:
    return Sketcher(params=SeqSketcherParams(kmer_size=K, sketch_size=m,
                                             algo=SketchAlgo.SUPER2,
                                             data_t=DataType.DNA))


def reads(seed: int, n: int = 7, L: int = 400):
    """(codes uint8[n, L], lengths int64[n]): seeded random reads, among
    them an empty read, one shorter than k and one of exactly k bases."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(n, L), dtype=np.uint8)
    lengths = rng.integers(K, L + 1, size=n)
    lengths[0] = L
    lengths[1:4] = (0, K - 1, K)
    return codes, lengths.astype(np.int64)


def flat(codes, lengths):
    return np.concatenate([codes[i, :lengths[i]] for i in range(len(lengths))])


def sketch(codes, lengths, m: int) -> torch.Tensor:
    batch = pack_codes(codes, lengths.astype(np.int32), device="cpu")
    return sketcher(m).sketch_batch(batch)


@pytest.mark.parametrize("m", [1000, 7])
def test_sketch_batch_at_k21_equals_the_plain_reference(m):
    codes, lengths = reads(2**33 + m)
    got = sketch(codes, lengths, m)
    want = ref.signatures(flat(codes, lengths), lengths, K, m, "cpu")
    assert got.dtype == torch.int32 and got.shape == (len(lengths), m)
    assert torch.equal(got.to(torch.int64) & M32, want)
    # the empty read and the one shorter than k hold the sentinel; the
    # read of k bases one key per slot, with pi running over [0, m)
    assert (want[1:3] == M32).all()
    pi = want[3] >> (32 - ref.perm_bits(m))
    assert (want[3] != M32).all()
    assert sorted(pi.tolist()) == list(range(m))


def py_splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & M64
    return x ^ (x >> 31)


def py_key(x: int, j: int, m: int) -> int:
    """SUPER2's key of u64 item x in slot j, one integer at a time."""
    nbits = max((m - 1).bit_length(), 1)
    mask = (1 << nbits) - 1
    kd = py_splitmix64(x ^ 0x51)
    a, b = (kd >> 32) | 1, kd & M32

    def enc(v):
        y = ((v * a) ^ b) & mask
        return y ^ (y >> max(nbits // 2, 1))
    pi = enc(j)
    for _ in range(4):
        if pi >= m:
            pi = enc(pi)
    pi = min(pi, m - 1)
    h = ((x & M32) ^ (x >> 32) ^ (py_splitmix64(j) >> 32)) * 0x85EBCA77 & M32
    h ^= h >> 13
    h = h * 0xC2B2AE3D & M32
    h ^= h >> 16
    return pi << (32 - nbits) | h >> nbits


def signed(x: int) -> int:
    return x - (1 << 64) if x >> 63 else x


def test_the_reference_by_hand():
    """Three items in one read and m = 5: each slot the least of the three
    keys worked one integer at a time; pi of each item a permutation."""
    xs = [0x0123456789ABCDEF, 0xFEDCBA9876543210, 0x00000000FFFFFFFF]
    items = torch.tensor([[signed(x) for x in xs]], dtype=torch.int64)
    valid = torch.ones_like(items, dtype=torch.bool)
    got = ref.signatures_of_items(items, valid, 5)
    keys = [[py_key(x, j, 5) for j in range(5)] for x in xs]
    assert got.tolist() == [[min(k[j] for k in keys) for j in range(5)]]
    for k in keys:
        assert sorted(v >> 29 for v in k) == list(range(5))
    # the port's grid on the same items agrees
    port, _ = superminhash.superminhash2(items, valid, 5)
    assert (port.to(torch.int64) & M32).tolist() == got.tolist()
    # one item invalid: it drops out of every slot
    valid[0, 1] = False
    got = ref.signatures_of_items(items, valid, 5)
    assert got.tolist() == [[min(keys[0][j], keys[2][j]) for j in range(5)]]


def test_the_16_bit_control_differs():
    """About one (read, slot) in 2^17 positions flips where two positions
    tie on the cut key: ~1.2 M positions at m = 7 flip some slots, and
    the control's keys are the exact ones' or those of a tie."""
    rng = np.random.default_rng(2**34 + 27)
    n, L = 120, 10000
    codes = rng.integers(0, 4, size=n * L, dtype=np.uint8)
    lengths = np.full(n, L, np.int64)
    want = ref.signatures(codes, lengths, K, 7, "cpu")
    low = ref.signatures(codes, lengths, K, 7, "cpu", cut16=True)
    differ = (low != want).any(dim=1)
    assert 0 < int(differ.sum()) < n // 2
    assert ((low >> 13) == (want >> 13)).all()
    assert (low >= want).all()


class ListSink:
    def __init__(self):
        self.spans: list = []
        self.records: list = []

    def add(self, name, t0, t1):
        self.spans.append(name)

    def record(self, name, value):
        self.records.append((name, value))


def test_the_grid_span_and_the_split_counter_record_only_with_a_sink(
        monkeypatch):
    codes, lengths = reads(5)
    batch = pack_codes(codes, lengths.astype(np.int32), device="cpu")
    split = sketch_grid.plan(1600, 5212, 1000, per_thread=8)
    whole = sketch_grid.plan(8192, 492, 1000, per_thread=8)
    assert split.spans == 3 and whole.spans == 1
    assert obs.sink is None
    sketcher(13).sketch_batch(batch)
    sketch_grid.count_split(1600, 5212, split)      # nothing to record to
    sink = ListSink()
    monkeypatch.setattr(obs, "sink", sink)
    sketch_grid.count_split(1600, 5212, split)
    sketch_grid.count_split(8192, 492, whole)
    assert sink.records == [("sketch.g1_split", 1600 * 5212),
                            ("sketch.g1_split", 0)]
    # on the CPU a sketch records the span and no G1 launch
    sink.records.clear()
    sketcher(13).sketch_batch(batch)
    assert sink.spans == ["sketch.kmers", "sketch.grid"]
    assert sink.records == []


def test_the_smoke_checks_g1_at_the_super2_cells_split_rows():
    """chip_smoke.py holds G1 to its plain version at the SUPER2 cell's
    rows (``GRID_CELL_CHECKS``, m = 1000), which G1's plan splits over
    3, 5, 9 and 2 spans on a card of 132 SMs; their inputs are the u64
    k-mers of reads of at most P + k - 1 bases, the first row full."""
    import chip_smoke
    assert [sketch_grid.plan(n, P, chip_smoke.GRID_CELL_M,
                             per_thread=sketch_grid.G1_SLOTS_PER_THREAD).spans
            for n, P in chip_smoke.GRID_CELL_CHECKS] == [3, 5, 9, 2]
    x, a, b, valid, slotc = chip_smoke.grid_cell_args(
        torch, np.random.default_rng(2**33 + 5), 6, 40, m=7, dev="cpu")
    assert x.shape == a.shape == b.shape == valid.shape == (6, 40)
    assert slotc.shape == (7,) and bool(valid[0].all())
    assert int(valid.sum(dim=1).min()) >= 40 - 15
