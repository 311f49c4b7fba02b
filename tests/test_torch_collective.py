"""Parity of the port's parallel/collective.py and parallel/mesh.py with the
JAX package on the CPU.

The port runs in 2 and 4 ranks: ``torch.multiprocessing`` spawns joined in
a gloo group (tests/torch_ranks.py), each rank on its block of rows of the
same numpy inputs, made from a seed.  The JAX functions run on
``make_mesh(n)`` of the 8 virtual CPU devices, and shard d must equal what
rank d wrote: the run-start-aligned keys, counts, n_distinct, n_unique and
drop counts of the hash-sharded counts, the Bloom slots and the gathered
signatures, exactly; the merged SetSketch registers under the float32
floor rule of tests/test_torch_families.py.  Each world size is held to
JAX at one key width (JAX compiles a program per mesh and width) and to a
numpy oracle at the other.

The module imports jax only inside the test functions, so that the ranks,
which import it, start without it.
"""

import functools

import numpy as np
import pytest
import torch

import torch_ranks

SEED = 20261017
N_READS, READ_LEN, DUP_ROWS = 8, 180, 2
M_SKETCH, LOG2_SLOTS, NB_HASH = 64, 16, 4
# (k held against JAX, k held against the oracle) for each world size
K_OF = {2: (9, 21), 4: (21, 9)}


def inputs(world: int) -> dict:
    """The seeded inputs of one world size (numpy)."""
    rng = np.random.default_rng(SEED + world)
    from kmerutils_tpu_torch.base.sequence import pack_words
    codes = torch_ranks.random_codes(rng, N_READS, READ_LEN, DUP_ROWS)
    lengths = rng.integers(READ_LEN - 60, READ_LEN + 1, size=N_READS)
    words, lengths = pack_words(codes, lengths)
    bloom = rng.integers(0, 2**63, size=1024, dtype=np.uint64)
    bloom[rng.integers(0, bloom.size, size=8)] = np.uint64(2**64 - 1)
    return dict(
        codes=codes, words=words, lengths=lengths,
        items=rng.integers(1, 2**63, size=(N_READS, 48), dtype=np.uint64),
        valid=rng.random((N_READS, 48)) < 0.8,
        bloom=bloom,
        sigs=rng.integers(0, 2**63, size=(N_READS, 16), dtype=np.uint64))


def _rank_main(rank: int, world: int, root: str) -> None:
    from kmerutils_tpu_torch.base.sequence import batch_from_numpy
    from kmerutils_tpu_torch.parallel import collective as pc
    from kmerutils_tpu_torch.parallel import mesh as pm
    from kmerutils_tpu_torch.sketch.setsketch import SetSketchParams
    from kmerutils_tpu_torch.sketch import setsketch

    mesh = torch_ranks.make_mesh(rank, world, root)
    x = inputs(world)
    batch = batch_from_numpy(x["words"], x["lengths"], device="cpu")
    local = pm.reads_sharding(mesh, batch)
    save = functools.partial(torch_ranks.save, root, rank=rank)
    for k in K_OF[world]:
        keys, counts, dropped, nd, nu = pc.sharded_count(local, k, mesh)
        save(f"count_k{k}", keys=keys.numpy(), counts=counts.numpy(),
             dropped=int(dropped), nd=int(nd), nu=int(nu))
        keys, counts, nd, nu = pc.sharded_count_redundant(
            pm.replicated(mesh, batch), k, mesh)
        save(f"redundant_k{k}", keys=keys.numpy(), counts=counts.numpy(),
             nd=int(nd), nu=int(nu))
    keys, counts, dropped, _, _ = pc.sharded_count(local, 13, mesh,
                                                   shard_cap_factor=0.1)
    save("overflow_k13", counts=counts.numpy(), dropped=int(dropped))

    items = pm.reads_sharding(mesh, x["items"].view(np.int64))
    valid = pm.reads_sharding(mesh, x["valid"])
    p = SetSketchParams(m=M_SKETCH)
    save("setsketch",
         regs=pc.sharded_setsketch_collection(items, valid, p, mesh).numpy())
    sketch = pc.data_parallel_sketch(
        lambda it, va: setsketch.setsketch_signatures(it, va, p, 3), mesh)
    save("data_parallel",
         sigs=pc.gather_signatures(sketch(items, valid), mesh).numpy())
    slots = torch.zeros(1 << LOG2_SLOTS, dtype=torch.uint8)
    save("bloom", slots=pc.sharded_bloom_insert(
        slots, pm.reads_sharding(mesh, x["bloom"].view(np.int64)), NB_HASH,
        LOG2_SLOTS, mesh).numpy())
    sigs = pm.reads_sharding(mesh, x["sigs"].view(np.int64))
    save("gather", sigs=pc.gather_signatures(sigs, mesh).numpy(),
         mask=pc.gather_signatures(sigs % 3 == 0, mesh).numpy())
    torch_ranks.leave_group()


@pytest.fixture(scope="module", params=[2, 4], ids=lambda n: f"ranks{n}")
def ranks(request, tmp_path_factory):
    world = request.param
    return torch_ranks.Ranks(_rank_main, world,
                             str(tmp_path_factory.mktemp(f"ranks{world}")))


@functools.cache
def jax_mesh(world: int):
    from kmerutils_tpu.parallel import mesh as kmesh
    return kmesh.make_mesh(world)


def jax_batch(x):
    import jax.numpy as jnp
    from kmerutils_tpu.base.sequence import ReadBatch
    return ReadBatch(words=jnp.asarray(x["words"]),
                     lengths=jnp.asarray(x["lengths"]))


def as_u64(keys: np.ndarray) -> np.ndarray:
    """The port's int32 / int64 key bit patterns as JAX's u64 keys (the
    sentinel -1 as all ones)."""
    if keys.dtype == np.int32:
        k = keys.view(np.uint32).astype(np.uint64)
        return np.where(keys == -1, np.uint64(2**64 - 1), k)
    return keys.view(np.uint64)


def assert_counts_match(got: list[dict], want, redundant: bool):
    keys, counts = np.asarray(want[0]), np.asarray(want[1])
    nd, nu = np.asarray(want[-2]), np.asarray(want[-1])
    assert keys.shape[0] == len(got)
    for d, g in enumerate(got):
        np.testing.assert_array_equal(as_u64(g["keys"]), keys[d])
        np.testing.assert_array_equal(g["counts"], counts[d])
        assert (int(g["nd"]), int(g["nu"])) == (int(nd[d]), int(nu[d]))
        if not redundant:
            assert int(g["dropped"]) == int(np.asarray(want[2])[d])


def test_sharded_count_matches_jax(ranks):
    from kmerutils_tpu.parallel import collective as jc
    k = K_OF[ranks.world][0]
    want = jc.sharded_count(jax_batch(inputs(ranks.world)), k,
                            jax_mesh(ranks.world))
    assert_counts_match(ranks.results(f"count_k{k}"), want, redundant=False)


def test_sharded_count_redundant_matches_jax(ranks):
    from kmerutils_tpu.parallel import collective as jc
    k = K_OF[ranks.world][0]
    want = jc.sharded_count_redundant(jax_batch(inputs(ranks.world)), k,
                                      jax_mesh(ranks.world))
    assert_counts_match(ranks.results(f"redundant_k{k}"), want,
                        redundant=True)


@pytest.mark.parametrize("kind", ["count", "redundant"])
def test_sharded_count_matches_oracle(ranks, kind):
    """The other key width: shards disjoint, each k-mer on the shard that
    dispatch names, their union equal to numpy's counts."""
    from kmerutils_tpu_torch.count import dispatch
    x = inputs(ranks.world)
    k = K_OF[ranks.world][1]
    want_k, want_c, _, _ = torch_ranks.count_oracle(
        [(x["codes"], x["lengths"], 0)], k)
    got_k, got_c = [], []
    for d, g in enumerate(ranks.results(f"{kind}_k{k}")):
        live = g["counts"] > 0
        assert live.sum() == g["nd"]
        assert (g["counts"][live] == 1).sum() == g["nu"]
        assert int(g.get("dropped", 0)) == 0
        keys = torch.from_numpy(g["keys"][live])
        assert (dispatch.dispatch(keys, ranks.world, k) == d).all()
        got_k.append(as_u64(g["keys"][live]))
        got_c.append(g["counts"][live])
    got_k, got_c = np.concatenate(got_k), np.concatenate(got_c)
    order = np.argsort(got_k)
    np.testing.assert_array_equal(got_k[order], want_k)
    np.testing.assert_array_equal(got_c[order], want_c)


def test_sharded_count_counts_overflow_on_the_sender(ranks):
    """A tiny bucket capacity: what the senders dropped plus what the
    shards counted is every valid k-mer."""
    x = inputs(ranks.world)
    got = ranks.results("overflow_k13")
    dropped = sum(int(g["dropped"]) for g in got)
    received = sum(int(g["counts"].sum()) for g in got)
    generated = torch_ranks.canonical_np(x["codes"], x["lengths"], 13)[0].size
    assert dropped > 0
    assert dropped + received == generated


def test_setsketch_collection_matches_jax(ranks):
    import jax.numpy as jnp
    from kmerutils_tpu.parallel import collective as jc
    from kmerutils_tpu.sketch.setsketch import SetSketchParams as JParams
    from kmerutils_tpu_torch.sketch.setsketch import SetSketchParams
    from test_torch_families import assert_registers_match, hll_h_best
    x = inputs(ranks.world)
    want = np.asarray(jc.sharded_setsketch_collection(
        jnp.asarray(x["items"]), jnp.asarray(x["valid"]),
        JParams(m=M_SKETCH), jax_mesh(ranks.world)))
    h_best = hll_h_best(x["items"], x["valid"], M_SKETCH, 0).max(axis=0)
    got = ranks.results("setsketch")
    for g in got:
        np.testing.assert_array_equal(g["regs"], got[0]["regs"])
        assert g["regs"].dtype == np.int32
    assert_registers_match(got[0]["regs"][None],
                           want.astype(np.int32)[None], h_best[None],
                           SetSketchParams(m=M_SKETCH),
                           f"collection of {ranks.world} ranks")


def test_data_parallel_sketch_gathers_every_row(ranks):
    from kmerutils_tpu_torch.sketch import setsketch
    x = inputs(ranks.world)
    want = setsketch.setsketch_signatures(
        torch.from_numpy(x["items"].view(np.int64)),
        torch.from_numpy(x["valid"]),
        setsketch.SetSketchParams(m=M_SKETCH), 3).numpy()
    for g in ranks.results("data_parallel"):
        np.testing.assert_array_equal(g["sigs"], want)


def test_bloom_insert_matches_jax(ranks):
    import jax.numpy as jnp
    from kmerutils_tpu.parallel import collective as jc
    x = inputs(ranks.world)
    want = np.asarray(jc.sharded_bloom_insert(
        jnp.zeros(1 << LOG2_SLOTS, jnp.uint8), jnp.asarray(x["bloom"]),
        NB_HASH, LOG2_SLOTS, jax_mesh(ranks.world)))
    assert 0 < want.sum() < want.size
    for g in ranks.results("bloom"):
        np.testing.assert_array_equal(g["slots"], want)


def test_gather_signatures_matches_jax(ranks):
    import jax.numpy as jnp
    from kmerutils_tpu.parallel import collective as jc
    x = inputs(ranks.world)
    want = np.asarray(jc.gather_signatures(jnp.asarray(x["sigs"]),
                                           jax_mesh(ranks.world)))
    np.testing.assert_array_equal(want, x["sigs"])
    for g in ranks.results("gather"):
        np.testing.assert_array_equal(g["sigs"].view(np.uint64), want)
        assert g["mask"].dtype == np.bool_
        np.testing.assert_array_equal(g["mask"], x["sigs"] % 3 == 0)


@pytest.mark.parametrize("cap", [3, 40])
def test_bucketize_by_shard_matches_jax(cap):
    """The send buckets and the sender's drop count, with skipped entries
    (shard id = n_shards) and shards over and under the capacity."""
    import jax.numpy as jnp
    from kmerutils_tpu.parallel import collective as jc
    from kmerutils_tpu_torch.parallel import collective as pc
    rng = np.random.default_rng(SEED + cap)
    n_shards = 4
    sid = rng.integers(0, n_shards + 1, size=96).astype(np.int32)
    keys = rng.integers(0, 2**62, size=96, dtype=np.uint64)
    keys[sid == n_shards] = np.uint64(2**64 - 1)
    want, want_dropped = jc._bucketize_by_shard(
        jnp.asarray(keys), jnp.asarray(sid), n_shards, cap)
    (got,), dropped = pc._bucketize_by_shard(
        (torch.from_numpy(keys.view(np.int64)),), torch.from_numpy(sid),
        n_shards, cap)
    np.testing.assert_array_equal(got.numpy().view(np.uint64),
                                  np.asarray(want))
    assert int(dropped) == int(want_dropped)
    assert (int(dropped) > 0) == (cap == 3)


@pytest.mark.parametrize("world", [1, 2, 4])
def test_reads_sharding_takes_the_ranks_row_block(world):
    from kmerutils_tpu_torch.base.sequence import batch_from_numpy
    from kmerutils_tpu_torch.parallel import mesh as pm
    x = inputs(2)
    batch = batch_from_numpy(x["words"], x["lengths"], device="cpu")
    b = N_READS // world
    for rank in range(world):
        m = pm.Mesh(rank, world, torch.device("cpu"), "gloo")
        local = pm.reads_sharding(m, batch)
        np.testing.assert_array_equal(
            local.words.numpy().view(np.uint32),
            x["words"][rank * b:(rank + 1) * b])
        np.testing.assert_array_equal(local.lengths.numpy(),
                                      x["lengths"][rank * b:(rank + 1) * b])
        np.testing.assert_array_equal(
            pm.reads_sharding(m, x["sigs"].view(np.int64)).numpy(),
            x["sigs"][rank * b:(rank + 1) * b].view(np.int64))
        assert pm.replicated(m, batch).words.shape == batch.words.shape
    with pytest.raises(ValueError, match="equal"):
        pm.reads_sharding(pm.Mesh(0, 3, torch.device("cpu"), "gloo"), batch)
