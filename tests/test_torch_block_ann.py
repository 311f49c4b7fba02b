"""Parity of the port's block sketch (sketch/block.py), block dump
(io/formats.py), neighbour search (ann.py) and HNSW binding (hnsw.py) with
the JAX package, on the CPU.

Tolerance: exact equality of every signature word, liveness flag,
neighbour index and similarity bit, and byte-identical dump and graph
files.
"""

import numpy as np
import pytest
import torch

from kmerutils_tpu import ann as j_ann
from kmerutils_tpu import hnsw as j_hnsw
from kmerutils_tpu.base.sequence import pack_ascii_reads as j_pack
from kmerutils_tpu.io import formats as j_formats
from kmerutils_tpu.sketch import block as j_block
from kmerutils_tpu_torch import ann as t_ann
from kmerutils_tpu_torch import hnsw as t_hnsw
from kmerutils_tpu_torch.base.sequence import pack_ascii_reads as t_pack
from kmerutils_tpu_torch.io import formats as t_formats
from kmerutils_tpu_torch.sketch import block as t_block


def reads_of(seed: int, n: int = 12):
    rng = np.random.default_rng(seed)
    rs = ["".join(rng.choice(list("ACGT"), size=int(L)))
          for L in rng.integers(30, 400, size=n)]
    rs[4] = rs[1]
    rs[6] = rs[6][:12]          # no k-mer at k = 21: no live block
    return rs


def flat_equal(got, want) -> None:
    assert [s for s, _ in got] == [s for s, _ in want]
    for (_, gb), (_, wb) in zip(got, want):
        assert len(gb) == len(wb)
        for g, w in zip(gb, wb):
            assert g.dtype == w.dtype == np.uint32 and np.array_equal(g, w)


@pytest.mark.parametrize("k", [8, 21])
def test_block_sketch_length_sorted_batches_match_jax(k):
    # the JAX CLI sketches blocks in file-order batches; the port's batches
    # are sorted by length and narrower: block i of a read still covers
    # its k-mer start positions [i * bs, (i + 1) * bs)
    reads = reads_of(k)
    m, bs = 40, 64
    want = j_block.block_sketch(j_pack(reads), k, m, bs)
    order = np.argsort([len(r) for r in reads], kind="stable")
    got = []
    for part in (order[:5], order[5:]):
        res = t_block.block_sketch(t_pack([reads[i] for i in part]), k, m, bs)
        assert res.sigs.dtype == want.sigs.dtype
        for row, i in enumerate(part):
            nb = res.sigs.shape[1]
            assert np.array_equal(res.live[row], want.live[i, :nb])
            assert not want.live[i, nb:].any()
            live = res.live[row]
            assert np.array_equal(res.sigs[row][live], want.sigs[i, :nb][live])
        got.extend(t_block.flatten_for_dump(res, part))
    got.sort(key=lambda t: t[0])
    flat_equal(got, j_block.flatten_for_dump(want, np.arange(len(reads))))
    assert not any(s == 6 for s, _ in got) or k == 8


def test_flatten_for_dump_matches_jax():
    res = j_block.block_sketch(j_pack(reads_of(3)), 8, 16, 50)
    t_res = t_block.BlockSketchResult(res.sigs, res.live, 50, 8)
    idx = np.arange(100, 112)
    flat_equal(t_block.flatten_for_dump(t_res, idx[:10]),
               j_block.flatten_for_dump(res, idx[:10]))
    flat_equal(t_block.flatten_for_dump(t_res), j_block.flatten_for_dump(res))
    a, b = res.sigs[0, 0], res.sigs[1, 0]
    assert t_block.dist_block_sketched(0, a, 1, b) \
        == j_block.dist_block_sketched(0, a, 1, b)
    assert t_block.dist_block_sketched(2, a, 2, b) == 1.0


def test_block_dump_bytes_match_jax(tmp_path):
    res = j_block.block_sketch(j_pack(reads_of(4)), 21, 24, 32)
    per_seq = j_block.flatten_for_dump(res, np.arange(12) * 3)
    j_formats.write_block_signature_dump(str(tmp_path / "j.bin"), 21, 32,
                                         per_seq)
    t_formats.write_block_signature_dump(str(tmp_path / "t.bin"), 21, 32,
                                         per_seq)
    assert (tmp_path / "j.bin").read_bytes() == (tmp_path / "t.bin").read_bytes()
    back = t_formats.read_block_signature_dump(str(tmp_path / "j.bin"))
    want = j_formats.read_block_signature_dump(str(tmp_path / "j.bin"))
    assert back[:3] == want[:3] == (21, 24, 32)
    flat_equal(back[3], want[3])
    t_formats.write_block_signature_dump(str(tmp_path / "e.bin"), 8, 5, [])
    assert t_formats.read_block_signature_dump(str(tmp_path / "e.bin")) \
        == (8, 0, 5, [])


def tied_sigs(seed: int, n: int, m: int, wide: bool = False):
    """Signatures over a 3-letter alphabet with repeated rows: many equal
    similarities and exact duplicates."""
    rng = np.random.default_rng(seed)
    sigs = rng.integers(0, 3, size=(n, m), dtype=np.uint64)
    sigs[n // 2] = sigs[1]
    sigs[n - 1] = sigs[1]
    if wide:
        return sigs | np.uint64(1 << 63)
    return sigs.astype(np.uint32) | np.uint32(1 << 31)


@pytest.mark.parametrize("n,m,nbng,block,tile,wide,self_", [
    (37, 8, 5, 1024, 1 << 28, False, True),     # one tile each way
    (50, 6, 7, 8, 8 * 6 * 9, True, True),       # tiled queries and columns
    (20, 4, 20, 16, 16 * 4 * 4, False, False),  # self included, nbng = n
])
def test_brute_force_neighbors_ties_match_jax(monkeypatch, n, m, nbng, block,
                                              tile, wide, self_):
    monkeypatch.setattr(t_ann, "_TILE_ELEMS", tile)
    sigs = tied_sigs(n + m, n, m, wide)
    want = j_ann.brute_force_neighbors(sigs, nbng, block=block,
                                       exclude_self=self_)
    view = sigs.view(np.int64 if wide else np.int32)
    got = t_ann.brute_force_neighbors(torch.from_numpy(view), nbng,
                                      block=block, exclude_self=self_)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    sim = t_ann.hamming_similarity_block(torch.from_numpy(view[:9]),
                                         torch.from_numpy(view))
    assert np.array_equal(sim.numpy(), np.asarray(
        j_ann.hamming_similarity_block(sigs[:9], sigs)))


def test_neighbor_dump_bytes_match_jax(tmp_path):
    nn, sim = j_ann.brute_force_neighbors(tied_sigs(1, 30, 8), 4)
    j_ann.write_neighbor_dump(str(tmp_path / "j"), nn, sim)
    t_ann.write_neighbor_dump(str(tmp_path / "t"), nn, sim)
    assert (tmp_path / "j").read_bytes() == (tmp_path / "t").read_bytes()
    for g, w in zip(t_ann.read_neighbor_dump(str(tmp_path / "j")), (nn, sim)):
        assert np.array_equal(g, w.astype(g.dtype))


def test_hnsw_binding_matches_jax_single_thread(tmp_path):
    if not (t_hnsw.available() and j_hnsw.available()):
        pytest.skip("native library unavailable")
    sigs = tied_sigs(2, 300, 16)
    indexes = []
    for mod, name in ((j_hnsw, "j"), (t_hnsw, "t")):
        index = mod.Hnsw(dim=16, capacity=300, max_nb_connection=12,
                         ef_construction=64, seed=5)
        assert index.parallel_insert(sigs, n_threads=1) == 300
        index.file_dump(str(tmp_path / f"{name}.hnsw"))
        indexes.append(index)
    assert (tmp_path / "j.hnsw").read_bytes() == \
        (tmp_path / "t.hnsw").read_bytes()
    want = indexes[0].search(sigs[:40], k=5, ef_search=32, n_threads=1)
    got = indexes[1].search(sigs[:40], k=5, ef_search=32, n_threads=1)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    loaded = t_hnsw.Hnsw.load(str(tmp_path / "j.hnsw"))
    assert (len(loaded), loaded.dim, loaded.capacity, loaded.dist) \
        == (300, 16, 300, "hamming")
    again = loaded.search(sigs[:40], k=5, ef_search=32, n_threads=1)
    assert all(np.array_equal(g, w) for g, w in zip(again, want))
    with pytest.raises(RuntimeError):
        indexes[1].insert(sigs[0])          # capacity exceeded
