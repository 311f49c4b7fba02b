"""Parity of the port's other five sketch families (SUPER2, SUPER, OPTDENS,
REVOPTDENS, HLL) and of their grid reductions with the JAX package, on the
CPU.

Tolerance: SUPER2, SUPER, OPTDENS and REVOPTDENS signatures are equal bit
for bit (integer hashing, exact float64 / float32 scaling, minima).  HLL
registers come from an exact integer maximum followed by float32 -log, log
and floor, which may differ by an ulp between XLA and torch: a register may
differ from JAX's only where the float32 value before the floor lies within
2 ulp of an integer in one of the two packages, and every mismatch is
proven so (the count is printed; 0 is expected here).  Cardinality and
Jaccard of the same registers agree to rtol 1e-12 (float64 sums in another
order).  The plain grid reductions equal a direct numpy statement of them.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from kmerutils_tpu.base import sequence as jseq
from kmerutils_tpu.sketch import jaccard as jjac
from kmerutils_tpu.sketch import setsketch as jss
from kmerutils_tpu.sketch import superminhash as jsm
from kmerutils_tpu.sketch.params import SeqSketcherParams as JParams
from kmerutils_tpu.sketch.params import SketchAlgo as JAlgo
from kmerutils_tpu_torch.base import sequence as tseq
from kmerutils_tpu_torch.ops import sketch_grid
from kmerutils_tpu_torch.sketch import jaccard as tjac
from kmerutils_tpu_torch.sketch import setsketch as tss
from kmerutils_tpu_torch.sketch import superminhash as tsm
from kmerutils_tpu_torch.sketch.params import SeqSketcherParams, SketchAlgo

EXACT = ["SUPER2", "SUPER", "OPTDENS", "REVOPTDENS"]


def reads(seed: int, n: int = 10):
    """Reads of 12-300 bases: the first shorter than k = 21 (no valid
    k-mer at k = 21, one at k = 8), the second of 4 bases (none at all),
    a duplicate, and all with fewer k-mers than m = 200, so densification
    runs many rounds."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(30, 300, size=n)
    lens[0], lens[1] = 8, 4
    rs = ["".join(rng.choice(list("ACGT"), size=int(L))) for L in lens]
    rs[3] = rs[2]
    return rs


def to_numpy(t: torch.Tensor) -> np.ndarray:
    a = t.numpy()
    return a.view(np.uint32) if a.dtype == np.int32 else a


def sketchers(algo: str, k: int, m: int, seed: int, hash_name="wang"):
    return (jjac.Sketcher(params=JParams(kmer_size=k, sketch_size=m,
                                         algo=JAlgo(algo)),
                          hash_name=hash_name, seed=seed),
            tjac.Sketcher(params=SeqSketcherParams(
                kmer_size=k, sketch_size=m, algo=SketchAlgo(algo)),
                hash_name=hash_name, seed=seed))


def assert_equal_sigs(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    got = to_numpy(got)
    assert got.shape == want.shape
    if want.dtype == np.uint32:
        assert got.dtype == np.uint32
    assert np.array_equal(got, want.astype(got.dtype))


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("k", [8, 21])
@pytest.mark.parametrize("algo", EXACT)
def test_sketch_batch_matches_jax(algo, k, seed):
    rs = reads(10 + k + seed)
    jsk, tsk = sketchers(algo, k, 200, seed)
    tb = tseq.pack_ascii_reads(rs, device="cpu")
    items, valid = tjac.hashed_kmers(tb, k)
    if k <= 16:                                  # items >= 2^31
        assert bool(((items.to(torch.int64) & 0xFFFFFFFF) >= 1 << 31).any())
    else:                                        # items >= 2^63
        assert bool((items < 0).any())
    assert not valid[1].any() and (k > 8 or valid[0].any())
    got = tsk.sketch_batch(tb)
    assert_equal_sigs(got, jsk.sketch_batch(jseq.pack_ascii_reads(rs)))
    assert torch.equal(got[2], got[3])
    if algo in ("OPTDENS", "REVOPTDENS"):
        assert bool(torch.isfinite(got[4:]).all())   # densified rows


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("k", [8, 21])
@pytest.mark.parametrize("algo", EXACT)
def test_sketch_collection_matches_jax(algo, k, seed):
    rs = reads(20 + k + seed)
    jsk, tsk = sketchers(algo, k, 200, seed)
    got = tsk.sketch_collection(tseq.pack_ascii_reads(rs, device="cpu"))
    want = jsk.sketch_collection(jseq.pack_ascii_reads(rs))
    assert_equal_sigs(got, want)


@pytest.mark.parametrize("m", [1, 13])
@pytest.mark.parametrize("algo", EXACT)
def test_small_sketch_sizes_match_jax(algo, m):
    rs = reads(31)
    jsk, tsk = sketchers(algo, 8, m, 3)
    assert_equal_sigs(tsk.sketch_batch(tseq.pack_ascii_reads(rs, device="cpu")),
                      jsk.sketch_batch(jseq.pack_ascii_reads(rs)))


def item_grid(seed: int, wide: bool, n: int = 6, P: int = 90):
    """Items >= 2^31 / 2^63 among others, a valid mask with an all-invalid
    row and a row with one valid position."""
    rng = np.random.default_rng(seed)
    if wide:
        items = rng.integers(0, 1 << 64, size=(n, P), dtype=np.uint64)
        t = torch.from_numpy(items.view(np.int64).copy())
    else:
        items = rng.integers(0, 1 << 32, size=(n, P),
                             dtype=np.uint64).astype(np.uint32)
        t = torch.from_numpy(items.view(np.int32).copy())
    valid = rng.random((n, P)) < 0.8
    valid[1] = False
    valid[2] = False
    valid[2, 17] = True
    return items, t, valid


@pytest.mark.parametrize("m", [1, 13, 129, 200, 257])
@pytest.mark.parametrize("wide", [False, True])
def test_superminhash_items_match_jax(wide, m):
    items, t, valid = item_grid(40 + m, wide)
    tv = torch.from_numpy(valid)
    sig2, empty = tsm.superminhash2(t, tv, m, 7)
    want2, jempty = jsm.superminhash2(items, valid, m, 7)
    assert np.array_equal(to_numpy(sig2), np.asarray(want2))
    assert np.array_equal(empty.numpy(), np.asarray(jempty))
    sig, _ = tsm.superminhash(t, tv, m, 7)
    want = np.asarray(jsm.superminhash(items, valid, m, 7)[0])
    assert np.array_equal(sig.numpy(), want) and np.isinf(want[1]).all()
    keys = items[:, :1].astype(np.uint64)
    perm = tsm._small_perm(torch.arange(m)[None, :],
                           torch.from_numpy(keys.view(np.int64).copy()), m)
    jperm = jsm._small_perm(np.arange(m, dtype=np.uint64)[None, :], keys, m)
    assert np.array_equal(perm.numpy(), np.asarray(jperm))
    assert np.array_equal(
        tsm.superminhash_jaccard(sig2[0], sig2).numpy(),
        np.asarray(jsm.superminhash_jaccard(np.asarray(want2)[0],
                                            np.asarray(want2)))
        .astype(np.float32))


def numpy_walk(a, b, m: int):
    """SUPER2's cycle walk of every slot under keys (a odd, b: u32[k]) in
    numpy: (pi before the clamp u32[k, m], walk rounds taken, pairs still
    >= m after the four walks, which the clamp ends)."""
    nbits = max((m - 1).bit_length(), 1)
    mask = np.uint32((1 << nbits) - 1)
    sh = np.uint32(max(nbits // 2, 1))
    a2, b2 = a[:, None], b[:, None]

    def enc(v):
        v = ((v * a2) ^ b2) & mask
        return (v ^ (v >> sh)) & mask

    with np.errstate(over="ignore"):
        v = enc(np.arange(m, dtype=np.uint32)[None, :])
        walks = 0
        for _ in range(4):
            need = v >= m
            walks += int(need.sum())
            v = np.where(need, enc(v), v)
    return v, walks, int((v >= m).sum())


@pytest.mark.parametrize("wide", [False, True])
def test_superminhash_four_walk_clamp_matches_jax(wide):
    """m = 129 (nbits 8: about half of the pairs walk): the data holds
    pairs still >= m after the four walk rounds, and both the permutation
    (clamped to m - 1) and the signatures equal JAX's."""
    m = 129
    items, t, valid = item_grid(61, wide, n=8, P=120)
    tv = torch.from_numpy(valid)
    args = tsm.grid_min_args(t, tv, m, 3)
    a, b = (args[i][tv].numpy().view(np.uint32) for i in (1, 2))
    pi, _, clamped = numpy_walk(a, b, m)
    assert clamped > 0
    sig2, _ = tsm.superminhash2(t, tv, m, 3)
    assert np.array_equal(to_numpy(sig2),
                          np.asarray(jsm.superminhash2(items, valid, m, 3)[0]))
    keys = items.reshape(-1)[:, None].astype(np.uint64)
    perm = tsm._small_perm(torch.arange(m)[None, :],
                           torch.from_numpy(keys.view(np.int64).copy()), m)
    jperm = np.asarray(jsm._small_perm(np.arange(m, dtype=np.uint64)[None, :],
                                       keys, m))
    assert np.array_equal(perm.numpy(), jperm)
    # each key maps one slot to m - 1; the clamped pairs add more
    assert (jperm == m - 1).sum() > jperm.shape[0]


# ---------------------------------------------------------------------------
# HLL: registers under the float32 floor-boundary rule
# ---------------------------------------------------------------------------

def _prefloor_torch(h: np.ndarray, p) -> np.ndarray:
    return tss.prefloor(torch.from_numpy(h.astype(np.int64)), p).numpy()


def _prefloor_jax(h: np.ndarray, p) -> np.ndarray:
    u = (jnp.asarray(h >> 8, jnp.uint32).astype(jnp.float32)
         * np.float32(2.0**-24) + np.float32(2.0**-24))
    e = -jnp.log(u)
    return np.asarray((np.float32(np.log(p.a)) - jnp.log(e))
                      * np.float32(1.0 / np.log(p.b)))


def _near_integer(v: np.ndarray) -> np.ndarray:
    v = v.astype(np.float32)
    return np.abs(v - np.round(v)) <= 2 * np.spacing(np.abs(v))


def assert_registers_match(got: np.ndarray, want: np.ndarray,
                           h_best: np.ndarray, p, what: str) -> int:
    """got / want registers [n, m]; h_best the exact u32 maximum hashes.
    Returns the number of mismatching registers, each proven to sit on a
    float32 floor boundary in one of the two packages."""
    bad = got != want
    if bad.any():
        h = h_best[bad]
        edge = _near_integer(_prefloor_torch(h, p)) \
            | _near_integer(_prefloor_jax(h, p))
        assert edge.all(), (what, h[~edge][:8])
        assert (np.abs(got[bad].astype(np.int64)
                       - want[bad].astype(np.int64)) <= 1).all()
    print(f"HLL {what}: {int(bad.sum())} registers on a float32 floor "
          f"boundary differ from JAX")
    return int(bad.sum())


def hll_h_best(items: np.ndarray, valid: np.ndarray, m: int, seed: int):
    """The JAX package's per-register maximum hash, stated in numpy."""
    it32 = items if items.dtype == np.uint32 else \
        (items ^ (items >> np.uint64(32))).astype(np.uint32)
    salts = tss.register_salts(m, seed, "cpu").numpy().view(np.uint32)
    h = numpy_hll_hashes(it32, salts)
    return np.where(valid[:, :, None], h, np.uint32(0)).max(axis=1)


@pytest.mark.parametrize("m", [13, 200, 4096])
@pytest.mark.parametrize("wide", [False, True])
def test_setsketch_registers_match_jax(wide, m):
    items, t, valid = item_grid(50 + m, wide, n=4, P=60)
    p, jp = tss.SetSketchParams(m=m), jss.SetSketchParams(m=m)
    got = tss.setsketch_signatures(t, torch.from_numpy(valid), p, 5).numpy()
    want = np.asarray(jss.setsketch_signatures(items, valid, jp, 5))
    assert got.dtype == np.int32 and want.dtype == np.uint16
    assert (got[1] == 0).all() and (want[1] == 0).all()
    assert_registers_match(got, want.astype(np.int32),
                           hll_h_best(items, valid, m, 5), p,
                           f"wide={wide} m={m}")


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("k", [8, 21])
def test_hll_sketcher_matches_jax(k, seed):
    rs = reads(60 + k + seed)
    jsk, tsk = sketchers("HLL", k, 200, seed)
    tb = tseq.pack_ascii_reads(rs, device="cpu")
    got = tsk.sketch_batch(tb).numpy()
    want = np.asarray(jsk.sketch_batch(jseq.pack_ascii_reads(rs)))
    items, valid = (np.asarray(a) for a in jjac.hashed_kmers(
        jseq.pack_ascii_reads(rs), k))
    h_best = hll_h_best(items, valid, 200, seed)
    assert_registers_match(got, want.astype(np.int32), h_best,
                           tss.SetSketchParams(m=200), f"k={k} seed={seed}")
    coll = tsk.sketch_collection(tb).numpy()
    jcoll = np.asarray(jsk.sketch_collection(jseq.pack_ascii_reads(rs)))
    assert_registers_match(coll[None], jcoll[None].astype(np.int32),
                           h_best.max(axis=0)[None], tss.SetSketchParams(
                               m=200), f"collection k={k} seed={seed}")


def test_setsketch_estimators_match_jax():
    rng = np.random.default_rng(9)
    p, jp = tss.SetSketchParams(m=256), jss.SetSketchParams(m=256)
    regs = np.asarray(jss.setsketch_signatures(
        rng.integers(0, 1 << 64, size=(3, 500), dtype=np.uint64),
        np.ones((3, 500), bool), jp, 2))
    t = torch.from_numpy(regs.astype(np.int32))
    np.testing.assert_allclose(tss.cardinality(t, p).numpy(),
                               np.asarray(jss.cardinality(regs, jp)),
                               rtol=1e-12)
    np.testing.assert_allclose(
        tss.jaccard(t[0], t[1:], p).numpy(),
        np.asarray(jss.jaccard(regs[0], regs[1:], jp)), rtol=1e-12)
    assert torch.equal(tss.merge(t[0], t[1]),
                       torch.from_numpy(np.asarray(
                           jss.merge(regs[0], regs[1])).astype(np.int32)))


# ---------------------------------------------------------------------------
# one against many, and the identity hash
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("algo,hash_name", [("PROB3A", "wang"),
                                            ("SUPER2", "wang"),
                                            ("HLL", "wang"),
                                            ("SUPER2", "identity")])
def test_jaccard_one_vs_many_matches_jax(algo, hash_name):
    rs = reads(70)
    jp = JParams(kmer_size=8, sketch_size=64, algo=JAlgo(algo))
    tp = SeqSketcherParams(kmer_size=8, sketch_size=64,
                           algo=SketchAlgo(algo))
    want = np.asarray(jjac.jaccard_one_vs_many(
        jseq.pack_ascii_reads(rs[2:3]), jseq.pack_ascii_reads(rs), jp,
        hash_name=hash_name, seed=4))
    got = tjac.jaccard_one_vs_many(
        tseq.pack_ascii_reads(rs[2:3], device="cpu"),
        tseq.pack_ascii_reads(rs, device="cpu"), tp, hash_name=hash_name,
        seed=4).numpy()
    if algo == "HLL":
        np.testing.assert_allclose(got, want, rtol=1e-12)
    else:
        assert np.array_equal(got, want.astype(np.float32))
    assert got[2] == got[3] == 1.0


def test_identity_hash_sketch_matches_jax():
    rs = reads(71)
    for k in (8, 21):
        jsk, tsk = sketchers("SUPER", k, 32, 1, hash_name="identity")
        assert_equal_sigs(
            tsk.sketch_batch(tseq.pack_ascii_reads(rs, device="cpu")),
            jsk.sketch_batch(jseq.pack_ascii_reads(rs)))
    with pytest.raises(ValueError, match="unknown kmer hash"):
        tjac.hashed_kmers(tseq.pack_ascii_reads(rs, device="cpu"), 8,
                          "md5")


# ---------------------------------------------------------------------------
# the grid reductions' plain versions against numpy
# ---------------------------------------------------------------------------

def numpy_hll_hashes(x: np.ndarray, salts: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):
        h = (x[:, :, None] ^ salts[None, None, :]) * np.uint32(0x9E3779B1)
        h ^= h >> np.uint32(15)
        return h * np.uint32(0x85EBCA77)


def numpy_super_keys(x, a, b, m: int) -> np.ndarray:
    nbits = max((m - 1).bit_length(), 1)
    mask = np.uint32((1 << nbits) - 1)
    sh = np.uint32(max(nbits // 2, 1))
    sc = tsm.slot_consts(m, 0, "cpu").numpy().view(np.uint32)
    a3, b3 = a[:, :, None], b[:, :, None]

    def enc(v):
        v = ((v * a3) ^ b3) & mask
        return (v ^ (v >> sh)) & mask

    with np.errstate(over="ignore"):
        pi = enc(np.arange(m, dtype=np.uint32)[None, None, :])
        for _ in range(4):
            pi = np.where(pi >= m, enc(pi), pi)
        pi = np.minimum(pi, np.uint32(m - 1))
        h = (x[:, :, None] ^ sc) * np.uint32(0x85EBCA77)
        h ^= h >> np.uint32(13)
        h *= np.uint32(0xC2B2AE3D)
        h ^= h >> np.uint32(16)
    return (pi << np.uint32(32 - nbits)) | (h >> np.uint32(nbits))


@pytest.mark.parametrize("m", [1, 13, 129, 200, 257])
def test_plain_grid_reductions_match_numpy(m):
    rng = np.random.default_rng(80 + m)
    n, P = 5, 40
    x, a, b = (rng.integers(0, 1 << 32, size=(n, P), dtype=np.uint64)
               .astype(np.uint32) for _ in range(3))
    a |= np.uint32(1)
    valid = rng.random((n, P)) < 0.7
    valid[3] = False
    t = [torch.from_numpy(v.view(np.int32).copy()) for v in (x, a, b)]
    tv = torch.from_numpy(valid)
    sc = tsm.slot_consts(m, 0, "cpu")
    want_min = np.where(valid[:, :, None], numpy_super_keys(x, a, b, m),
                        np.uint32(0xFFFFFFFF)).min(axis=1)
    got_min = sketch_grid.grid_min(*t, tv, sc)
    assert np.array_equal(to_numpy(got_min), want_min)
    salts = sc.numpy().view(np.uint32)
    want_max = np.where(valid[:, :, None], numpy_hll_hashes(x, salts),
                        np.uint32(0)).max(axis=1)
    got_max = sketch_grid.grid_max(t[0], tv, sc)
    assert np.array_equal(to_numpy(got_max), want_max)
    assert (want_min[3] == 0xFFFFFFFF).all() and (want_max[3] == 0).all()
    with pytest.raises(ValueError, match="valid"):
        sketch_grid.grid_max(t[0], tv[:, :-1], sc)


def test_grid_plan_covers_rows():
    R2 = sketch_grid.G2_SLOTS_PER_THREAD
    pl = sketch_grid.plan(1, 6_100_000, 200, per_thread=R2)
    assert pl.spans * pl.span >= 6_100_000 > (pl.spans - 1) * pl.span
    assert pl.spans > 132 and pl.threads_per_set * pl.subsets <= 256
    # G2: 4 slots a thread, so 4 groups of 1024 slots at m = 4096 (not 16
    # of 256), whose 4096 tiles split each row in 2 spans; at m = 200, 250
    # of 256 threads work (not 200 of 224)
    assert R2 == 4
    pl = sketch_grid.plan(1024, 5993, 4096, per_thread=R2)
    assert (pl.slots, pl.groups, pl.spans) == (1024, 4, 2)
    pl = sketch_grid.plan(3, 100, 13, per_thread=R2)
    assert (pl.slots, pl.subsets, pl.spans) == (16, 64, 1)
    pl = sketch_grid.plan(1024, 5993, 200, per_thread=R2)
    assert (pl.threads_per_set, pl.subsets, pl.groups) == (50, 5, 1)
    # G1: 8 slots a thread
    pl = sketch_grid.plan(1024, 5993, 200, per_thread=8)
    assert (pl.threads_per_set, pl.subsets, pl.groups) == (25, 10, 1)
    pl = sketch_grid.plan(1024, 5993, 4096, per_thread=8)
    assert (pl.slots, pl.threads_per_set, pl.subsets, pl.groups) == (
        2048, 256, 1, 2)


def staged_chunks(p0: int, p1: int, chunk: int, vec: int):
    """The kernels' staging of positions [p0, p1) when all are valid:
    (first position, staged positions) of each chunk, where the chunk's
    last group of ``vec`` staged positions is filled with copies of its
    first position (G2; G1 reads one position a load, vec = 1)."""
    for c0 in range(p0, p1, chunk):
        cn = min(chunk, p1 - c0)
        staged = np.arange(cn + (-cn) % vec)
        yield c0, np.where(staged < cn, staged, 0)


def plan_coverage(pl, n: int, P: int, m: int, chunk: int,
                  vec: int = 1) -> np.ndarray:
    """How often the kernels' index map visits each (row, position, slot)
    under plan pl: tile (row, span, group); thread t of the block holds
    slots g * slots + t % T + r * T (r < per_thread, T threads a slot set)
    and, within each staged chunk of the span, the groups of ``vec``
    staged positions whose index is t // T modulo the subsets (all
    positions valid here)."""
    T, Q, R = pl.threads_per_set, pl.subsets, pl.per_thread
    threads = -(-T * Q // 32) * 32
    t = np.arange(threads)
    ts, sub = t % T, t // T
    counts = np.zeros((n, P, m), np.int16)
    for row in range(n):
        for sp in range(pl.spans):
            p0, p1 = sp * pl.span, min(P, (sp + 1) * pl.span)
            for g in range(pl.groups):
                cover = np.zeros((Q, m), np.int16)
                for r in range(R):
                    j = g * pl.slots + ts + r * T
                    ok = (sub < Q) & (j < m)
                    np.add.at(cover, (sub[ok], j[ok]), 1)
                for c0, src in staged_chunks(p0, p1, chunk, vec):
                    p_sub = (np.arange(src.size) // vec) % Q
                    np.add.at(counts[row], c0 + src, cover[p_sub])
    return counts


KERNELS = {"G2": (sketch_grid.G2_SLOTS_PER_THREAD, sketch_grid._G2_CHUNK,
                  sketch_grid._G2_VEC),
           "G1": (sketch_grid.G1_SLOTS_PER_THREAD, sketch_grid._G1_CHUNK, 1)}


@pytest.mark.parametrize("split", [False, True], ids=["whole", "split"])
@pytest.mark.parametrize("kernel", ["G2", "G1"])
@pytest.mark.parametrize("m", [1, 13, 129, 199, 200, 201, 256, 257, 4096])
def test_grid_plan_visits_every_pair_once(m, kernel, split):
    """Every (row, position, slot) is visited exactly once by the plan's
    index map at the kernel's slots a thread, chunk and positions a shared
    load, whole rows (positions over more than one staging chunk) and a
    row split over spans, with at most 256 threads a block and at most
    2048 slots a group; G2's copies that fill a chunk's last shared load
    visit the chunk's first position again, and nothing else."""
    per_thread, chunk, vec = KERNELS[kernel]
    n, P, sms = (1, 2600, 132) if split else (2, 2600, 0)
    pl = sketch_grid.plan(n, P, m, sms, per_thread=per_thread)
    assert (pl.spans > 1) == split
    assert pl.threads_per_set * pl.subsets <= 256
    assert pl.slots <= 2048 and pl.slots == pl.threads_per_set * per_thread
    # at m = 200 and 4 or 8 slots a thread nearly every thread works
    if m == 200 and per_thread in (4, 8):
        assert pl.threads_per_set * pl.subsets == 250
    want = np.ones((n, P, m), np.int16)
    for sp in range(pl.spans):
        p0, p1 = sp * pl.span, min(P, (sp + 1) * pl.span)
        for c0, src in staged_chunks(p0, p1, chunk, vec):
            want[:, c0] += src.size - min(chunk, p1 - c0)
    assert (plan_coverage(pl, n, P, m, chunk, vec) == want).all()
    assert split or P > chunk


def numpy_grid_max(x, valid, salts, pl, chunk: int, vec: int, rng):
    """G2 as the kernel computes it, in numpy: per tile and chunk the valid
    positions staged in any order (the warps' compaction has none), the
    last group of ``vec`` staged positions filled with copies of staged
    position 0, subset q reading the groups q, q + Q, ...; each thread's
    per_thread register maxima, then the subsets' maxima met, then the
    tiles' (all u32)."""
    n, P = x.shape
    m = salts.size
    T, Q, R = pl.threads_per_set, pl.subsets, pl.per_thread
    out = np.zeros((n, m), np.uint32)
    for row in range(n):
        for sp in range(pl.spans):
            p0, p1 = sp * pl.span, min(P, (sp + 1) * pl.span)
            for c0 in range(p0, p1, chunk):
                pos = c0 + np.flatnonzero(valid[row, c0:min(p1, c0 + chunk)])
                if pos.size == 0:
                    continue
                sx = x[row, rng.permutation(pos)]
                sx = np.concatenate([sx, np.repeat(sx[:1], -sx.size % vec)])
                assert sx.size % vec == 0
                for g in range(pl.groups):
                    for q in range(Q):
                        mine = sx.reshape(-1, vec)[q::Q].ravel()
                        for ts in range(T):
                            j = g * pl.slots + ts + np.arange(R) * T
                            j = j[j < m]
                            if mine.size and j.size:
                                best = numpy_hll_hashes(
                                    mine[None], salts[j])[0].max(axis=0)
                                out[row, j] = np.maximum(out[row, j], best)
    return out


@pytest.mark.parametrize("vec", [1, 2, 4])
@pytest.mark.parametrize("m,chunk", [(200, 64), (13, 32), (200, 2048),
                                     (4096, 64)])
def test_grid_max_tail_copies_are_exact(m, chunk, vec):
    """The tail rule of G2: chunks whose count of valid positions is no
    multiple of vec x subsets (1, 3, 41 or 77 valid positions a row, and
    90 % of 300), their last shared load filled with copies of a staged
    position, give grid_max_ref's maxima, at G2's slots a thread."""
    rng = np.random.default_rng(m + chunk + vec)
    n, P = 6, 300
    x = rng.integers(0, 1 << 32, size=(n, P), dtype=np.uint64).astype(
        np.uint32)
    valid = np.zeros((n, P), bool)
    for row, k in enumerate((1, 3, 41, 77, 0)):
        valid[row, rng.choice(P, size=k, replace=False)] = True
    valid[5] = rng.random(P) < 0.9
    pl = sketch_grid.plan(n, P, m,
                          per_thread=sketch_grid.G2_SLOTS_PER_THREAD)
    assert vec * pl.subsets == 1 or any(
        int(valid[r].sum()) % (vec * pl.subsets) for r in range(n))
    salts = tsm.slot_consts(m, 0, "cpu")
    want = to_numpy(sketch_grid.grid_max_ref(
        torch.from_numpy(x.view(np.int32).copy()), torch.from_numpy(valid),
        salts))
    got = numpy_grid_max(x, valid, salts.numpy().view(np.uint32), pl, chunk,
                         vec, rng)
    assert np.array_equal(got, want)
    assert (got[4] == 0).all() and (got[:4] != 0).any(axis=1).all()


@pytest.mark.parametrize("m", [1, 13, 129, 200])
def test_grid_work_counts_the_walk_rounds_the_data_needs(m):
    """roofline.grid_work: G2 6 operations a valid pair; G1 10 a pair and
    5 a permutation round, the walk's rounds counted from the data, as a
    numpy cycle walk counts them; roofline.walk_stats also counts the
    pairs that the clamp after the four walks ends."""
    from kmerutils_tpu_torch import roofline
    rng = np.random.default_rng(90 + m)
    n, P = 4, 50
    x, a, b = (rng.integers(0, 1 << 32, size=(n, P), dtype=np.uint64)
               .astype(np.uint32) for _ in range(3))
    a |= np.uint32(1)
    valid = rng.random((n, P)) < 0.7
    valid[2] = False
    _, walks, clamped = numpy_walk(a[valid], b[valid], m)
    pairs = int(valid.sum()) * m
    t = [torch.from_numpy(z.view(np.int32).copy()) for z in (x, a, b)]
    tv = torch.from_numpy(valid)
    sc = tsm.slot_consts(m, 0, "cpu")
    ops, nbytes = roofline.grid_work("grid_min", (*t, tv, sc))
    assert ops == 10 * pairs + 5 * (pairs + walks)
    assert nbytes == n * P * 13 + n * m * 4
    assert roofline.grid_work("grid_max", (t[0], tv, sc)) == (
        6 * pairs, n * P * 5 + n * m * 4)
    assert roofline.walk_stats(t[1], t[2], tv, m, chunk=999) == {
        "rounds": walks, "clamped": clamped}
    assert walks > 0          # no m here is a power of two
    assert clamped > 0 or m != 129


def test_g2_alu_floor():
    """roofline.alu_floor_ms: G2's 4 ALU instructions a pair over 64 lanes
    an SM at the clock; at the bench shape's ~1.215e9 pairs on 132 SMs at
    1.98 GHz, 0.2905 ms, above the 0.218 ms bound of all 6 operations over
    128 lanes, which stays as it was."""
    from kmerutils_tpu_torch import roofline
    assert roofline.G2_ALU_OPS_PER_PAIR == 4 and roofline.G2_OPS_PER_PAIR == 6
    assert roofline.alu_floor_ms(1_000_000, sms=1, clock_hz=1e6) == 62.5
    pairs = 1_215_000_000
    floor = roofline.alu_floor_ms(pairs, 132, 1.98e9)
    assert abs(floor - 0.29055) < 1e-4
    bound = roofline.bound(0, pairs * roofline.G2_OPS_PER_PAIR, 132, 1.98e9)
    assert bound[1] == "operations" and abs(bound[0] - 0.21791) < 1e-4
    assert abs(floor / bound[0] - 4 / 6 * 2) < 1e-12


# a loop of SASS as cuobjdump prints it: one G1-like pass of two pairs
_SASS = """
        /*0100*/                   LDS.128 R4, [R2] ;
        /*0110*/                   IMAD R8, R4, R10, RZ ;
        /*0120*/                   LOP3.LUT R8, R8, R5, RZ, 0x3c, !PT ;
        /*0130*/                   IMAD.HI.U32 R9, R8, R11, RZ ;
        /*0140*/                   IMAD R9, R9, -0x3d4d51c3, RZ ;
        /*0150*/                   SHF.R.U32.HI R12, RZ, 0xd, R9 ;
        /*0160*/                   IMAD R13, R12, -0x3d4d51c3, RZ ;
        /*0170*/                   ISETP.GE.U32.AND P0, PT, R13, R14, PT ;
        /*0180*/                   IMNMX.U32 R15, R15, R13, PT ;
        /*0190*/              @!P0 BRA 0x100 ;
"""


def test_sass_pipes_per_pair():
    """roofline.draw_loop finds the loop by its pair markers (0xC2B2AE3D,
    printed as -0x3d4d51c3) and splits its instructions by pipe."""
    from kmerutils_tpu_torch import roofline
    insns = [(int(mt.group(1), 16), mt.group(2), mt.group(3))
             for mt in roofline._INSN.finditer(_SASS)]
    r = roofline.draw_loop(insns, roofline._spellings(0xC2B2AE3D),
                           fallback=False)
    assert (r["instructions"], r["draws"]) == (10, 2)
    assert r["pipes_per_draw"] == {"mem": 0.5, "fma": 1.5, "alu": 2.0,
                                   "fma_wide": 0.5, "other": 0.5}
    assert [roofline.pipe_of(op) for op in (
        "IMAD.WIDE.U32", "IMAD.MOV.U32", "SHF.L.U32", "ATOMS.MIN", "VOTE.ANY",
        "POPC", "VIMNMX3.U32")] == ["fma_wide", "fma", "alu", "mem", "other",
                                    "alu", "alu"]


@pytest.mark.parametrize("names,ok", [
    (["_ZN12_GLOBAL__N_115grid_min_kernelEPKj", "_ZN12_GLOBAL__N_115grid_max"
      "_kernelEPKj"], True),
    (["_ZN12_GLOBAL__N_115grid_max_kernelEPKj"], False),
    (["_ZN12_GLOBAL__N_111grid_kernelILb1EEvPKj"], False)])
def test_grid_sass_lookup_fails_loudly(monkeypatch, names, ok):
    """roofline.grid_instructions_per_pair finds G1 and G2 by their kernel
    names, and raises when either is missing."""
    from kmerutils_tpu_torch import roofline
    funcs = {name: [(int(mt.group(1), 16), mt.group(2), mt.group(3).replace(
        "-0x3d4d51c3", "-0x61c8864f" if "max" in name else "-0x3d4d51c3"))
        for mt in roofline._INSN.finditer(_SASS)] for name in names}
    monkeypatch.setattr(roofline, "sass_functions", lambda path: funcs)
    if ok:
        r = roofline.grid_instructions_per_pair("lib.so")
        assert set(r) == {"grid_min", "grid_max"}
        assert r["grid_min"]["instructions_per_draw"] == 5.0
    else:
        with pytest.raises(RuntimeError, match="kernels named"):
            roofline.grid_instructions_per_pair("lib.so")


# ---------------------------------------------------------------------------
# every entry point that places data defaults to the card
# ---------------------------------------------------------------------------

def _device_entry_points():
    from kmerutils_tpu_torch.aa import kmeraa
    from kmerutils_tpu_torch.base import nthash, sequence
    from kmerutils_tpu_torch.count import stream
    from kmerutils_tpu_torch.io import fastx
    from kmerutils_tpu_torch.ops import tournament
    return [sequence.batch_from_numpy, sequence.pack_codes,
            sequence.pack_ascii_reads, fastx.read_batches_overlapped,
            stream.StreamCountTable.create, stream.table_from_jax,
            nthash.nthash_kmers_ascii, tournament.slot_consts,
            kmeraa.pack_aa_reads, fastx.load_all]


@pytest.mark.parametrize("fn", _device_entry_points(),
                         ids=lambda f: f.__qualname__)
def test_device_defaults_to_cuda(fn):
    import inspect
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_default_device_fails_loudly_without_a_card():
    # with no CUDA device the default must raise, not fall back to the CPU
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to fail")
    with pytest.raises((RuntimeError, AssertionError)):
        tseq.pack_ascii_reads(["ACGTACGT"])
