"""Parity of the port's parallel/stream.py (ShardedStreamCounter, the
exchange, the reductions, the one-step stream wrappers of
parallel/collective.py) with the JAX package and a numpy oracle, on the CPU.

The port runs in 2 and 4 ranks: ``torch.multiprocessing`` spawns joined in
a gloo group (tests/torch_ranks.py), each rank on its block of rows of
every batch (4 rows a rank); batches of seeded numpy reads, read numbers
offset + row.
Each world size is held to JAX's ShardedStreamCounter on ``make_mesh(n)``
of the 8 virtual CPU devices at capacity 1 << 12, one key width each (u32
at 2 ranks, u64 with a forced in-transit overflow at 4; JAX's Pallas
merges run in interpret mode): shard d equals rank d in keys, counts,
read numbers, positions and table drops, and the reduced in-transit drops
agree.  Every other configuration (growth, spill, ``hint_every`` > 1,
depth 0 and 1, growth then spill at depth 1, both widths with and
without coordinates, the unstaged wrappers) is held to a numpy oracle:
shards disjoint, each k-mer on the shard that dispatch names, and the
union equal to the oracle's counts and first occurrences.  On one rank, a stream that stages, grows and spills
hands a sink the spans and counters of count/stream.StreamCounter's loop.
Tolerance: exact equality throughout.

The module imports jax only inside the test functions, so that the ranks,
which import it, start without it.
"""

import functools

import numpy as np
import pytest
import torch

import torch_ranks

SEED = 20261018
ROWS_PER_RANK = 4
# name: (k, coords, depth, capacity, cap_max, hint_every, shard_cap_factor,
#        batches, read length).  The read lengths keep every rank's run of
# a batch under a quarter of the table, which the fold's lag-1 hint needs
# at these small capacities (count/stream.fold's headroom is then half the
# table).
SCENARIOS = {
    "jax_u32": (13, True, 1, 1 << 12, None, 1, 1.5, 3, 120),
    "jax_u64": (21, True, 0, 1 << 12, None, 1, 0.35, 3, 400),
    "grow": (13, False, 0, 1 << 11, 1 << 14, 1, 1.5, 10, 120),
    "spill": (13, True, 0, 1 << 11, 1 << 11, 1, 1.5, 10, 120),
    "hint_every": (21, False, 1, 1 << 13, None, 3, 1.5, 7, 120),
    "wide_coords_grow": (21, True, 1, 1 << 11, 1 << 14, 1, 1.5, 12, 90),
    "overflow": (13, False, 0, 1 << 12, None, 1, 0.1, 2, 400),
    "grow_spill": (13, False, 1, 1 << 10, 1 << 13, 1, 1.5, 90, 60),
}
JAX_SCENARIO = {2: "jax_u32", 4: "jax_u64"}


def scenario_batches(name: str, world: int):
    """[(codes, lengths, read-number offset)] of a scenario: each batch
    repeats two reads of the first (k-mers shared across batches and
    ranks)."""
    n_batches, length = SCENARIOS[name][7:]
    n = ROWS_PER_RANK * world
    rng = np.random.default_rng([SEED, world, len(name)] + list(name.encode()))
    out = []
    for b in range(n_batches):
        codes = torch_ranks.random_codes(rng, n, length)
        if b:
            codes[:2] = out[0][0][-2:]
        lengths = rng.integers(length - 40, length + 1, size=n)
        out.append((codes, lengths, b * n))
    return out


def _shard_arrays(res) -> dict:
    keys, counts, rn, ps, dropped = res
    return dict(keys=keys, counts=counts, rn=rn, ps=ps, dropped=dropped)


def _run_counter(mesh, name: str):
    from kmerutils_tpu_torch.base.sequence import pack_codes
    from kmerutils_tpu_torch.parallel import mesh as pm
    from kmerutils_tpu_torch.parallel import stream as ps
    k, coords, depth, cap, cap_max, hint_every, factor = SCENARIOS[name][:7]
    ctr = ps.ShardedStreamCounter(
        mesh, cap, wide=k > 16, coords=coords, cap_max_per_device=cap_max,
        depth=depth, spill_dir=None, shard_cap_factor=factor,
        hint_every=hint_every)
    for codes, lengths, offset in scenario_batches(name, mesh.world):
        batch = pack_codes(codes, lengths, device="cpu")
        ctr.update(pm.reads_sharding(mesh, batch), k, read_num_offset=offset)
    (r, res), = ctr.finalize_local().items()
    assert r == mesh.rank
    try:
        ctr.finalize()
        raised = False
    except RuntimeError:
        raised = True
    out = dict(_shard_arrays(res), in_transit=ctr.dropped_in_transit,
               local_in_transit=int(ctr._local_dropped),
               capacity=ctr.table.capacity, finalize_raised=raised,
               spilled=ctr.spill_store is not None)
    ctr.close()
    return out


def _drop_reductions(mesh) -> dict:
    """Reductions with no update, after an overflowing update (twice), and
    after one more update: every call reduces on every rank."""
    from kmerutils_tpu_torch.base.sequence import pack_codes
    from kmerutils_tpu_torch.parallel import mesh as pm
    from kmerutils_tpu_torch.parallel import stream as ps
    ctr = ps.ShardedStreamCounter(mesh, 1 << 12, depth=0,
                                  shard_cap_factor=0.1)
    got = [ctr.reduce_in_transit_drops()]
    rng = np.random.default_rng(SEED)
    for _ in range(2):
        codes = torch_ranks.random_codes(rng, ROWS_PER_RANK * mesh.world,
                                         400)
        ctr.update(pm.reads_sharding(mesh, pack_codes(codes, device="cpu")),
                   13)
        got += [ctr.reduce_in_transit_drops(), ctr.reduce_in_transit_drops()]
    ctr.finalize_local()
    return dict(reductions=np.array(got + [ctr.dropped_in_transit]),
                local=int(ctr._local_dropped))


def _wrappers(mesh) -> dict:
    """The unstaged one-step API of parallel/collective.py."""
    from kmerutils_tpu_torch.base.sequence import pack_codes
    from kmerutils_tpu_torch.parallel import collective as pc
    from kmerutils_tpu_torch.parallel import mesh as pm
    from kmerutils_tpu_torch.parallel import stream as ps
    table = pc.sharded_stream_create(1 << 12, mesh, wide=False, coords=True)
    dropped = 0
    for codes, lengths, offset in scenario_batches("jax_u32", mesh.world):
        batch = pm.reads_sharding(mesh, pack_codes(codes, lengths,
                                                   device="cpu"))
        table, d = pc.sharded_stream_update(table, batch, 13, mesh,
                                            read_num_offset=offset)
        dropped += d
    try:
        pc.sharded_stream_finalize(table, mesh)
        raised = False
    except RuntimeError:
        raised = True
    (_, res), = ps.finalize_local(table, mesh).items()
    return dict(_shard_arrays(res), in_transit=dropped,
                finalize_raised=raised)


def _rank_main(rank: int, world: int, root: str) -> None:
    mesh = torch_ranks.make_mesh(rank, world, root)
    save = functools.partial(torch_ranks.save, root, rank=rank)
    for name in SCENARIOS:
        save(name, **_run_counter(mesh, name))
    save("drops", **_drop_reductions(mesh))
    save("wrappers", **_wrappers(mesh))
    torch_ranks.leave_group()


def _one_rank_main(rank: int, world: int, root: str) -> None:
    """A group of one rank: finalize() and sharded_stream_finalize return
    the union of every shard."""
    from kmerutils_tpu_torch.base.sequence import pack_codes
    from kmerutils_tpu_torch.parallel import collective as pc
    from kmerutils_tpu_torch.parallel import stream as ps
    mesh = torch_ranks.make_mesh(rank, world, root)
    for name in ("spill", "hint_every"):
        k, coords, depth, cap, cap_max, hint_every, factor = \
            SCENARIOS[name][:7]
        ctr = ps.ShardedStreamCounter(
            mesh, cap, wide=k > 16, coords=coords,
            cap_max_per_device=cap_max, depth=depth,
            shard_cap_factor=factor, hint_every=hint_every)
        table = pc.sharded_stream_create(1 << 14, mesh, wide=k > 16,
                                         coords=coords)
        for codes, lengths, offset in scenario_batches(name, world):
            batch = pack_codes(codes, lengths, device="cpu")
            ctr.update(batch, k, read_num_offset=offset)
            table, _ = pc.sharded_stream_update(table, batch, k, mesh,
                                                read_num_offset=offset)
        torch_ranks.save(root, name, rank, **_shard_arrays(ctr.finalize()),
                         spilled=ctr.spill_store is not None)
        ctr.close()
        torch_ranks.save(root, f"{name}_wrappers", rank, **_shard_arrays(
            pc.sharded_stream_finalize(table, mesh)))
    torch_ranks.save(root, "sink", rank, **_sink_run(mesh))
    torch_ranks.leave_group()


class ListSink:
    """An ``obs.sink`` that keeps what it is handed."""

    def __init__(self):
        self.spans: list = []
        self.records: list = []

    def add(self, name, t0, t1):
        self.spans.append(name)

    def record(self, name, value):
        self.records.append((name, value))


def _sink_run(mesh) -> dict:
    """The grow_spill scenario with a sink set: the spans' names, the
    count.grows and count.spills readings, and the shard."""
    from kmerutils_tpu_torch import obs
    from kmerutils_tpu_torch.base.sequence import pack_codes
    from kmerutils_tpu_torch.parallel import stream as ps
    k, coords, depth, cap, cap_max, hint_every, factor = \
        SCENARIOS["grow_spill"][:7]
    sink = ListSink()
    obs.sink = sink
    try:
        ctr = ps.ShardedStreamCounter(
            mesh, cap, cap_max_per_device=cap_max, depth=depth,
            shard_cap_factor=factor, hint_every=hint_every)
        for codes, lengths, offset in scenario_batches("grow_spill", 1):
            ctr.update(pack_codes(codes, lengths, device="cpu"), k,
                       read_num_offset=offset)
        got = _shard_arrays(ctr.finalize())
    finally:
        obs.sink = None
    ctr.close()

    def readings(name):
        return np.array([v for n, v in sink.records if n == name], np.int64)
    return dict(got, spans=np.array(sorted(set(sink.spans))),
                grows=readings("count.grows"),
                spills=readings("count.spills"),
                n_segments=ctr.n_segments)


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    return torch_ranks.Ranks(_one_rank_main, 1,
                             str(tmp_path_factory.mktemp("ranks1")))


@pytest.mark.parametrize("name", ["spill", "hint_every"])
def test_one_rank_finalize_is_the_union(one_rank, name):
    one = one_rank
    for what in (name, f"{name}_wrappers"):
        assert_owned_union(one.results(what), name, 1)
    assert bool(one.results(name)[0]["spilled"]) == (name == "spill")


def test_spans_and_counters_reach_the_sink(one_rank):
    """The sharded counter runs count/stream.StreamCounter's loop: a
    stream that stages, grows and spills hands a sink the loop's spans and
    its growth and spill counters, and still counts exactly."""
    [got] = one_rank.results("sink")
    assert set(got["spans"]) == {"count.stage", "count.fold",
                                 "count.compact"}
    assert got["grows"].tolist() == [SCENARIOS["grow_spill"][4]]
    assert got["spills"].size >= 1 and (got["spills"] > 0).all()
    assert int(got["n_segments"]) == got["spills"].size + 1
    assert_owned_union([got], "grow_spill", 1)


@pytest.fixture(scope="module", params=[2, 4], ids=lambda n: f"ranks{n}")
def ranks(request, tmp_path_factory):
    world = request.param
    return torch_ranks.Ranks(_rank_main, world,
                             str(tmp_path_factory.mktemp(f"ranks{world}")))


def assert_owned_union(got: list[dict], name: str, world: int):
    """Shards disjoint and owned by dispatch; their union equals the
    oracle (first occurrences too where the scenario tracks them)."""
    from kmerutils_tpu_torch.count import dispatch
    k, coords = SCENARIOS[name][:2]
    for d, g in enumerate(got):
        assert int(g["dropped"]) == 0
        keys = g["keys"].view(np.int64 if k > 16 else np.int32)
        assert (dispatch.dispatch(torch.from_numpy(keys), world, k) == d).all()
        assert (g["keys"][1:] > g["keys"][:-1]).all()
    union = {f: np.concatenate([g[f] for g in got])
             for f in ("keys", "counts", "rn", "ps")}
    order = np.argsort(union["keys"], kind="stable")
    want = torch_ranks.count_oracle(scenario_batches(name, world), k)
    np.testing.assert_array_equal(union["keys"][order], want[0])
    np.testing.assert_array_equal(union["counts"][order], want[1])
    if coords:
        np.testing.assert_array_equal(union["rn"][order], want[2])
        np.testing.assert_array_equal(union["ps"][order], want[3])
    else:
        assert not union["rn"].any() and not union["ps"].any()


def _jax_counter(name: str, world: int):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from kmerutils_tpu.base.sequence import ReadBatch
    from kmerutils_tpu.parallel import mesh as kmesh
    from kmerutils_tpu.parallel import stream as jps
    from kmerutils_tpu_torch.base.sequence import pack_words
    k, coords, depth, cap, cap_max, hint_every, factor = SCENARIOS[name][:7]
    mesh = kmesh.make_mesh(world)
    sh = NamedSharding(mesh, P(kmesh.READS_AXIS))
    ctr = jps.ShardedStreamCounter(
        mesh, cap, wide=k > 16, coords=coords, cap_max_per_device=cap_max,
        depth=depth, shard_cap_factor=factor, hint_every=hint_every)
    for codes, lengths, offset in scenario_batches(name, world):
        words, lengths = pack_words(codes, lengths)
        ctr.update(ReadBatch(words=jax.device_put(words, sh),
                             lengths=jax.device_put(lengths, sh)),
                   k, read_num_offset=offset)
    return ctr.finalize_local(), ctr.dropped_in_transit


def test_counter_matches_jax(ranks):
    name = JAX_SCENARIO[ranks.world]
    want, want_transit = _jax_counter(name, ranks.world)
    got = ranks.results(name)
    assert sorted(want) == list(range(ranks.world))
    for d, g in enumerate(got):
        for i, f in enumerate(("keys", "counts", "rn", "ps")):
            assert g[f].dtype == want[d][i].dtype, f
            np.testing.assert_array_equal(g[f], want[d][i], err_msg=f)
        assert int(g["dropped"]) == int(want[d][4]) == 0
        assert int(g["in_transit"]) == want_transit
    if name == "jax_u64":
        assert want_transit > 0


@pytest.mark.parametrize("name", ["grow", "spill", "hint_every",
                                  "wide_coords_grow", "jax_u32",
                                  "grow_spill"])
def test_counter_matches_oracle(ranks, name):
    got = ranks.results(name)
    assert_owned_union(got, name, ranks.world)
    for g in got:
        assert int(g["in_transit"]) == 0
        assert bool(g["finalize_raised"])
    cap, cap_max = SCENARIOS[name][3:5]
    if name in ("grow", "wide_coords_grow"):
        assert all(int(g["capacity"]) > cap for g in got), "never grew"
        assert all(not g["spilled"] for g in got)
        assert len({int(g["capacity"]) for g in got}) == 1
    if name == "spill":
        assert all(bool(g["spilled"]) for g in got), "never spilled"
    if name == "grow_spill":
        assert all(int(g["capacity"]) == cap_max and bool(g["spilled"])
                   for g in got), "never grew to the top and spilled"


@pytest.mark.parametrize("name", ["overflow", "jax_u64"])
def test_in_transit_drops_are_the_senders_overflow(ranks, name):
    """What the senders dropped, reduced over the group, plus what the
    shards counted is every valid k-mer."""
    k = SCENARIOS[name][0]
    got = ranks.results(name)
    generated = sum(torch_ranks.canonical_np(c, ln, k)[0].size
                    for c, ln, _ in scenario_batches(name, ranks.world))
    received = sum(int(g["counts"].sum()) for g in got)
    total = sum(int(g["local_in_transit"]) for g in got)
    assert total > 0
    for g in got:
        assert int(g["in_transit"]) == total
    assert total + received == generated


def _jax_drop_reductions(world: int) -> list[int]:
    """JAX's counter through the same updates as :func:`_drop_reductions`,
    reducing after each."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from kmerutils_tpu.base.sequence import ReadBatch
    from kmerutils_tpu.parallel import mesh as kmesh
    from kmerutils_tpu.parallel import stream as jps
    from kmerutils_tpu_torch.base.sequence import pack_words
    mesh = kmesh.make_mesh(world)
    sh = NamedSharding(mesh, P(kmesh.READS_AXIS))
    ctr = jps.ShardedStreamCounter(mesh, 1 << 12, depth=0,
                                   shard_cap_factor=0.1)
    got = [ctr.reduce_in_transit_drops()]
    rng = np.random.default_rng(SEED)
    for _ in range(2):
        words, lengths = pack_words(torch_ranks.random_codes(
            rng, ROWS_PER_RANK * world, 400))
        ctr.update(ReadBatch(words=jax.device_put(words, sh),
                             lengths=jax.device_put(lengths, sh)), 13)
        got.append(ctr.reduce_in_transit_drops())
    return got


def test_drop_reduction_runs_on_every_call(ranks):
    """Every rank reduces on every call: with nothing sent (0), twice in a
    row after an overflowing update (the same total), after one more
    update (a larger one), and in finalize_local.  The JAX version enters
    its reduction only while its accumulator is not yet a host int, and an
    update after a reduction replaces the reduced total: at 2 ranks its
    second total counts the second update's drops alone."""
    got = ranks.results("drops")
    red = got[0]["reductions"]
    for g in got:
        np.testing.assert_array_equal(g["reductions"], red)
    assert red[0] == 0
    assert 0 < red[1] == red[2] < red[3] == red[4] == red[5]
    assert red[5] == sum(int(g["local"]) for g in got)
    if ranks.world == 2:
        assert _jax_drop_reductions(2) == [0, red[1], red[3] - red[1]]


def test_stream_wrappers_match_the_counter(ranks):
    """sharded_stream_create / _update (one fold per batch, no staging)
    equal the staged counter's shards; the union finalize raises on more
    than one rank."""
    got = ranks.results("wrappers")
    staged = ranks.results("jax_u32")
    for g, s in zip(got, staged):
        assert bool(g["finalize_raised"])
        assert int(g["in_transit"]) == 0
        for f in ("keys", "counts", "rn", "ps", "dropped"):
            np.testing.assert_array_equal(g[f], s[f])
