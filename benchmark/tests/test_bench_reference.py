"""The plain references against the program on the CPU, at small sizes,
on inputs from the benchmark's own generator; and their independence."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import control
from benchmark.harness import jobs
from benchmark.reference import kmers
from benchmark.reference import probminhash as ref
from benchmark.traffic import generate

from .sizes import SMALL, TINY

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
ACGT = np.frombuffer(b"ACGT", np.uint8)


def pool_of(n, seed, genome_len=20000):
    config = dict(SMALL, genome_len=genome_len, both_strands=False,
                  err_rate=0.0)
    return generate.make_pool(config, {
        "pool_reads": n, "lengths_seed": 0, "batch_reads": 100,
        "max_batch_bases": 8192, "window_batches": 4}, seed)


def reads_of(n, seed):
    return pool_of(n, seed).reads(np.arange(n))


def text(codes):
    return ACGT[codes].tobytes().decode()


@pytest.mark.parametrize("k", [8, 16, 21, 32])
def test_canonical_kmers_match_the_strings(k):
    r = reads_of(5, 3)
    can, rid, pos = kmers.canonical(r.codes, r.lengths, k, "cpu")
    comp = str.maketrans("ACGT", "TGCA")
    code = {"A": 0, "C": 1, "G": 2, "T": 3}
    i = 0
    for read in range(5):
        s = text(r.codes[r.offsets[read]:r.offsets[read + 1]])
        for p in range(len(s) - k + 1):
            w = s[p:p + k]
            v = min(sum(code[c] << 2 * (k - 1 - j) for j, c in enumerate(x))
                    for x in (w, w.translate(comp)[::-1]))
            assert (int(can[i]) & ((1 << 64) - 1), int(rid[i]),
                    int(pos[i])) == (v, read, p)
            i += 1
    assert i == can.numel()


@pytest.mark.parametrize("seed", [1, 2**31 + 5, 2**40])
def test_probminhash_equals_the_program(seed):
    from kmerutils_tpu_torch.base.sequence import pack_codes
    from kmerutils_tpu_torch.sketch.jaccard import Sketcher
    from kmerutils_tpu_torch.sketch.params import (DataType,
                                                   SeqSketcherParams,
                                                   SketchAlgo)
    r = reads_of(40, seed)
    L = int(r.lengths.max())
    codes = np.zeros((40, L), np.uint8)
    for i in range(40):
        codes[i, :r.lengths[i]] = r.codes[r.offsets[i]:r.offsets[i + 1]]
    batch = pack_codes(codes, r.lengths, device="cpu")
    sk = Sketcher(params=SeqSketcherParams(kmer_size=8, sketch_size=200,
                                           algo=SketchAlgo.PROB3A,
                                           data_t=DataType.DNA))
    got = sk.sketch_batch(batch).numpy().view(np.uint32)
    want = ref.signatures(r.codes, r.lengths, 8, 200, "cpu").numpy()
    assert np.array_equal(got.astype(np.int64), want)
    low = ref.signatures(r.codes, r.lengths, 8, 200, "cpu", "bfloat16")
    assert (low.numpy() != want).any(axis=1).mean() > 0.5


def test_the_all_ones_item_is_padding():
    items = torch.tensor([0xFFFFFFFF, 5], dtype=torch.int64)
    assert ref.wang32(items).dtype == torch.int64
    # a read whose only k-mers hash to all ones gets signature 0: the
    # rule is stated in weighted_items, held here on its output
    r = reads_of(3, 9)
    rid, item, _ = ref.weighted_items(r.codes, r.lengths, 8, "cpu")
    assert not (item == 0xFFFFFFFF).any()


@pytest.mark.parametrize("seed", [3, 2**33])
def test_every_seed_gets_the_same_shapes(seed):
    a, b = pool_of(300, seed), pool_of(300, seed + 1)
    assert np.array_equal(a.lengths, b.lengths)
    assert all(np.array_equal(x, y) for x, y in zip(a.batches, b.batches))
    assert not np.array_equal(a.genome, b.genome)
    assert sorted(np.concatenate(a.batches).tolist()) == list(range(300))


def test_batches_follow_the_ingest_rule():
    lengths = generate.read_lengths(dict(SMALL, read_len={
        "median": 5000, "sigma": 0.85, "min": 500, "max": 16000}), 3000, 0)
    for idx in generate.cut_batches(lengths, 10000, 8 << 20, 32 << 20):
        width = generate.rung(int(lengths[idx].max()))
        assert {generate.rung(int(x)) for x in lengths[idx]} == {width}
        assert len(idx) * width <= 8 << 20


def test_pack_matches_the_program_packing():
    from kmerutils_tpu_torch.base.sequence import pack_codes
    r = reads_of(7, 5)
    bases = torch.as_tensor(r.codes).to(torch.int64)
    offs = torch.as_tensor(r.offsets[:-1])
    ln = torch.as_tensor(r.lengths)
    words = jobs.pack(bases, offs, ln, "cpu")
    L = int(r.lengths.max())
    codes = np.zeros((7, L), np.uint8)
    for i in range(7):
        codes[i, :r.lengths[i]] = r.codes[r.offsets[i]:r.offsets[i + 1]]
    want = pack_codes(codes, r.lengths, device="cpu").words
    assert torch.equal(words[:, :want.shape[1]], want)
    assert not words[:, want.shape[1]:].any()


def test_the_control_fails_the_check():
    cell = "ont_sketch_k8_resident"
    got = control.readings(cell, 7, "cpu", overrides=TINY[cell])
    assert got and all(v > lim for _, v, lim in got)


def test_the_reference_imports_nothing_of_the_program():
    folder = os.path.join(ROOT, "benchmark", "reference")
    for name in os.listdir(folder):
        if not name.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(folder, name)).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                assert m.split(".")[0] not in ("kmerutils_tpu_torch",
                                               "kmerutils_tpu", "jax")
    code = ("import sys; import benchmark.reference.probminhash, "
            "benchmark.reference.kmers; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'kmerutils_tpu_torch', 'kmerutils_tpu', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True).stdout
    assert out.strip() == "[]"
