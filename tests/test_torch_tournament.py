"""Parity of the plain tournament (kmerutils_tpu_torch.ops.tournament, the
CPU side of kernels K1/K2) with the JAX package's Pallas kernels (interpret
mode) and with its fused-XLA ``probminhash._tournament``.

Tolerance: exact equality of every signature slot.  The draws go through
``torch.log`` here and ``jnp.log`` there, which may differ by one ulp; such
a difference can flip a slot only on a near-tie between items of different
weight.  A mismatching slot is therefore accepted only if
:func:`assert_exact_or_near_ties` shows it is such a near-tie (the two
candidates' ln(u) * winv within 1 ulp, their weights different); anything
else fails.  The CUDA kernels themselves are compared with these plain
versions, bit for bit, on the card by chip_smoke.py.
"""

import functools

import numpy as np
import pytest
import torch

from kmerutils_tpu.ops.tournament import (weighted_tournament as j_wt,
                                          weighted_tournament_u64 as j_wt64)
from kmerutils_tpu.sketch import probminhash as jpmh
from kmerutils_tpu_torch.ops import tournament as T

M = 200


def draw_f32(x32: np.ndarray, slot_const: int, winv: np.ndarray):
    """ln(u) * winv in float32 for u32 draw inputs x32 (numpy)."""
    h = (x32.astype(np.uint64) ^ np.uint64(slot_const)) & np.uint64(0xFFFFFFFF)
    h = (h * np.uint64(0x9E3779B1)) & np.uint64(0xFFFFFFFF)
    h ^= h >> np.uint64(15)
    h = (h * np.uint64(0x85EBCA77)) & np.uint64(0xFFFFFFFF)
    u = (h >> np.uint64(8)).astype(np.float32) * np.float32(2.0**-24) \
        + np.float32(2.0**-24)
    return np.log(u) * np.asarray(winv, np.float32)


def near_tie(x_a, w_a, x_b, w_b, slot_const) -> bool:
    """Candidates a and b (draw inputs x, weights w) tie within 1 ulp with
    different weights."""
    e = draw_f32(np.array([x_a, x_b], np.uint32), slot_const,
                 np.array([1.0 / w_a, 1.0 / w_b], np.float32))
    return w_a != w_b and abs(float(e[0]) - float(e[1])) <= float(
        np.spacing(np.float32(max(abs(e[0]), abs(e[1])))))


def assert_exact_or_near_ties(got, want, x32, weights, m, seed=0,
                              max_rate=1e-3):
    """got/want: winner payloads [n, m] that are positions into the rows of
    x32 / weights [n, P] (int weights, 0 = invalid).  Every mismatching
    slot must be a near-tie, and mismatches must stay rare."""
    got, want = np.asarray(got), np.asarray(want)
    bad = np.argwhere(got != want)
    sc = T.slot_consts(m, seed, device="cpu").numpy()
    for r, s in bad:
        pa, pb = int(got[r, s]), int(want[r, s])
        assert near_tie(x32[r, pa], weights[r, pa], x32[r, pb],
                        weights[r, pb], int(sc[s])), (r, s, pa, pb)
    assert len(bad) <= max_rate * got.size, len(bad)


def first_position(items: np.ndarray, weights: np.ndarray, sig: np.ndarray):
    """Position of each signature item in its row (first valid hit)."""
    out = np.zeros(sig.shape, np.int64)
    for r in range(sig.shape[0]):
        for s in range(sig.shape[1]):
            hit = np.flatnonzero((items[r] == sig[r, s]) & (weights[r] > 0))
            out[r, s] = hit[0] if hit.size else 0
    return out


def case(seed: int, wide: bool, n: int = 4, P: int = 700):
    """The tie/invalid cases of the JAX suite: few distinct items (u32) or
    duplicated u64 items, weights 1..4, ~10% invalid, the last row empty;
    values >= 2^31 / 2^63."""
    rng = np.random.default_rng(seed)
    if wide:
        items = rng.integers(1, 1 << 64, size=(n, P), dtype=np.uint64)
        items[:, 0::3][:, :233] = items[:, 1::3][:, :233]
        assert (items >= np.uint64(1 << 63)).any()
    else:
        items = (rng.integers(0, 50, size=(n, P)).astype(np.uint32)
                 + np.uint32(0xFFFFFF00))
    w = rng.integers(1, 5, size=(n, P)).astype(np.int32)
    valid = rng.random((n, P)) < 0.9
    valid[-1, :] = False
    w = np.where(valid, w, 0)
    winv = np.where(valid, 1.0 / np.maximum(w, 1), 0.0).astype(np.float32)
    return items, w, valid, winv


def ti32(x_u32: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        x_u32.astype(np.uint32)).view(np.int32))


def check_u32(items, w, winv, sig_port, sig_ref):
    pa = first_position(items, w, sig_port)
    pb = first_position(items, w, sig_ref)
    assert_exact_or_near_ties(pa, pb, items, w, M)


@pytest.mark.parametrize("seed", [0, 1])
def test_k1_plain_matches_pallas_and_xla(seed):
    items, w, valid, winv = case(seed, wide=False)
    got = T.weighted_tournament(ti32(items), torch.from_numpy(winv), M)
    got = got.numpy().view(np.uint32)
    sig_xla, empty = jpmh._tournament(items, winv, valid, M, 0)
    sig_pl = np.asarray(j_wt(items, winv, M, seed=0, interpret=True))
    sig_pl = np.where(np.asarray(empty)[:, None], 0, sig_pl)
    assert (got[-1] == 0).all()                        # empty row -> 0
    check_u32(items, w, winv, got, np.asarray(sig_xla))
    check_u32(items, w, winv, got, sig_pl)


def test_k1_positions_mode_matches_pallas():
    items, w, valid, winv = case(2, wide=False)
    got = T.weighted_tournament(ti32(items), torch.from_numpy(winv), M,
                                return_positions=True).numpy()
    want = np.asarray(j_wt(items, winv, M, seed=0, interpret=True,
                           return_positions=True)).astype(np.int64)
    live = valid.any(axis=1)
    assert (got[~live] == 0).all()
    assert_exact_or_near_ties(got[live], want[live], items[live], w[live], M)


@pytest.mark.parametrize("seed", [0, 3])
def test_k2_plain_matches_pallas_and_xla(seed):
    items, w, valid, winv = case(seed, wide=True)
    lo = (items & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (items >> np.uint64(32)).astype(np.uint32)
    glo, ghi = T.weighted_tournament_u64(ti32(lo), ti32(hi),
                                         torch.from_numpy(winv), M)
    got = ((ghi.numpy().view(np.uint32).astype(np.uint64) << np.uint64(32))
           | glo.numpy().view(np.uint32).astype(np.uint64))
    sig_xla, empty = jpmh._tournament(items, winv, valid, M, 0)
    plo, phi = j_wt64(lo, hi, winv, M, seed=0, interpret=True)
    sig_pl = ((np.asarray(phi).astype(np.uint64) << np.uint64(32))
              | np.asarray(plo).astype(np.uint64))
    sig_pl = np.where(np.asarray(empty)[:, None], 0, sig_pl)
    assert (got[-1] == 0).all()
    fold = (lo ^ hi).astype(np.uint32)
    for ref in (np.asarray(sig_xla), sig_pl):
        pa, pb = first_position(items, w, got), first_position(items, w, ref)
        assert_exact_or_near_ties(pa, pb, fold, w, M)


def test_seed_changes_signature_deterministically():
    items, _, _, winv = case(4, wide=False)
    a = T.weighted_tournament(ti32(items), torch.from_numpy(winv), M, seed=1)
    b = T.weighted_tournament(ti32(items), torch.from_numpy(winv), M, seed=1)
    c = T.weighted_tournament(ti32(items), torch.from_numpy(winv), M, seed=2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    sig_xla, _ = jpmh._tournament(items, winv, winv > 0, M, 2)
    assert (c.numpy().view(np.uint32) == np.asarray(sig_xla)).all()


def test_cpu_wrapper_runs_plain_version_without_counting():
    items, _, _, winv = case(5, wide=False, n=2, P=40)
    before = (T.launches_u32, T.launches_u64)
    a = T.weighted_tournament(ti32(items), torch.from_numpy(winv), 13)
    b = T.weighted_tournament_ref(ti32(items), torch.from_numpy(winv), 13)
    assert torch.equal(a, b) and a.dtype == torch.int32 and a.shape == (2, 13)
    assert (T.launches_u32, T.launches_u64) == before


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguity"])
def test_wrapper_rejects_bad_inputs(bad):
    items = torch.zeros((3, 8), dtype=torch.int32)
    winv = torch.ones((3, 8), dtype=torch.float32)
    if bad == "dtype":
        items = items.to(torch.int64)
    elif bad == "shape":
        winv = winv[:, :7].contiguous()
    else:
        items = torch.zeros((8, 3), dtype=torch.int32).t()
    with pytest.raises(ValueError):
        T.weighted_tournament(items, winv, 4)
    with pytest.raises(ValueError):
        T.weighted_tournament_u64(items, items, winv, 4)


def test_near_tie_check_accepts_ties_and_rejects_others():
    # search a pair of draws with weights 1 and 2 that meet within 1 ulp
    sc = int(T.slot_consts(1, device="cpu").numpy()[0])
    x = np.arange(1 << 16, dtype=np.uint32)
    e1 = draw_f32(x, sc, np.ones(x.size, np.float32))
    e2 = draw_f32(x, sc, np.full(x.size, 0.5, np.float32))
    order = np.argsort(e1)
    pos = np.clip(np.searchsorted(e1[order], e2), 0, x.size - 1)
    gap = np.abs(e1[order][pos] - e2)
    b = int(np.argmin(gap))
    a = int(order[pos[b]])
    assert near_tie(x[a], 1, x[b], 2, sc)
    assert not near_tie(x[a], 1, x[b], 1, sc)          # same weight
    far = int(np.argmax(np.abs(e1 - e2[b])))
    assert not near_tie(x[far], 1, x[b], 2, sc)


# ---------------------------------------------------------------------------
# the kernels' work plan and their packed-key order
# ---------------------------------------------------------------------------

def tile_bounds(pl, n: int, P: int, m: int, t):
    """(r0, r1, c0, c1, s0, s1) of tiles t (int64 array): the rows,
    positions and slots each covers, with csrc/tournament.cu's tile
    arithmetic."""
    sg = t % pl.slot_groups
    rest = t // pl.slot_groups
    c0 = (rest % pl.spans) * pl.span
    r0 = (rest // pl.spans) * pl.rows
    s0 = sg * pl.slots
    mn = np.minimum
    return (r0, mn(r0 + pl.rows, n), c0, mn(c0 + pl.span, P), s0,
            mn(s0 + pl.slots, m))


def _partition(lo, hi, length):
    """The distinct [lo, hi) ranges tile [0, length) without gaps or
    overlaps; returns how many there are."""
    iv = sorted(set(zip(lo.tolist(), hi.tolist())))
    assert iv[0][0] == 0 and iv[-1][1] == length
    assert all(a[1] == b[0] for a, b in zip(iv, iv[1:]))
    assert all(a < b for a, b in iv) or length == 0
    return len(iv)


@pytest.mark.parametrize("n,P", [(1, 6_123_500), (1024, 5993),
                                 (129_195, 512), (3, 16_384), (0, 700),
                                 (5, 0)])
@pytest.mark.parametrize("m", [200, 13])
def test_plan_covers_every_row_position_and_slot_once(n, P, m):
    pl = T.plan(n, P, m, sms=132)
    assert pl.rows * pl.slots <= T._MAX_PAIRS
    assert pl.rows * pl.chunk <= T._STAGE and pl.sub in (1 << np.arange(9))
    if n == 0:
        assert pl.tiles == 0
        return
    t = np.arange(pl.tiles, dtype=np.int64)
    r0, r1, c0, c1, s0, s1 = tile_bounds(pl, n, P, m, t)
    counts = (_partition(r0, r1, n), _partition(c0, c1, P),
              _partition(s0, s1, m))
    # every (row range, position range, slot range) once: each (row,
    # position, slot) lies in exactly one tile
    assert len(set(zip(r0.tolist(), c0.tolist(), s0.tolist()))) == pl.tiles
    assert pl.tiles == counts[0] * counts[1] * counts[2]
    assert int(((r1 - r0) * (c1 - c0) * (s1 - s0)).sum()) == n * P * m


@pytest.mark.parametrize("per_sm", [4, 5, 8])
def test_plan_fills_the_card_for_every_row_shape(per_sm):
    sms = 132
    waves = T._WAVES * sms * per_sm
    one = T.plan(1, 6_123_500, 200, sms, per_sm)    # sketch_collection
    assert one.split and one.tiles >= 0.99 * waves   # spans round down
    tail = T.plan(3, 16_384, 200, sms, per_sm)      # a tail batch
    assert tail.split and tail.span == T._MIN_SPAN
    bench = T.plan(1024, 5993, 200, sms, per_sm)    # the bench shape
    assert bench.split and bench.tiles >= 0.99 * waves and bench.rows == 1
    block = T.plan(16_384, 512, 200, sms, per_sm)   # block mode
    assert not block.split and block.rows > 1
    many = T.plan(10_000, 16_000, 200, sms, per_sm)  # long reads, many
    assert not many.split
    for pl in (one, tail, bench, block, many):
        units = pl.sub * pl.rows * -(-pl.slots // T._GROUP)
        assert T._MIN_UNITS <= units < 2 * T._MIN_UNITS


def test_plan_struct_has_the_kernels_layout():
    """struct Plan {long long tiles; int rows, slots, span, chunk, sub,
    spans, slot_groups;} of csrc/tournament.cu, filled from a Plan."""
    import ctypes
    from kmerutils_tpu_torch import _build
    S = _build.TournamentPlan
    assert ctypes.sizeof(S) == 40
    assert [getattr(S, f).offset for f, _ in S._fields_] == \
        [0, 8, 12, 16, 20, 24, 28, 32]
    pl = T.plan(3, 16_384, 200, 132, 4)
    c = T._c_plan(pl)
    assert (c.tiles, c.rows, c.slots, c.span, c.chunk, c.sub, c.spans,
            c.slot_groups) == (pl.tiles, pl.rows, pl.slots, pl.span,
                               pl.chunk, pl.sub, pl.spans, pl.slot_groups)


def better(a, b):
    """The JAX kernel's comparator: larger e, then smaller payload."""
    return a[0] > b[0] or (a[0] == b[0] and a[1] < b[1])


def pack(e: np.float32, pay: int) -> int:
    """csrc/tournament.cu's pack(): order32(e) << 32 | ~payload for a
    finite e <= 0 (+0 and -0 alike) and a u32 payload."""
    bits = int(np.float32(e).view(np.uint32))
    hi = (~bits & 0xFFFFFFFF) if e < 0 else 0x7FFFFFFF
    return hi << 32 | (~int(pay) & 0xFFFFFFFF)


def test_packed_key_max_is_the_comparator_on_adversarial_ties():
    rng = np.random.default_rng(11)
    es = np.array([0.0, -0.0, -1e-30, -np.float32(2.0**-24),
                   np.log(np.float32(1 - 2.0**-24)), -0.5, -0.5, -16.6355,
                   -3.4e37], np.float32)
    pays = np.array([0, 1, 7, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE,
                     0xFFFFFFFF], np.int64)
    for _ in range(200):
        k = int(rng.integers(2, 9))
        e = rng.choice(es, size=k)
        pay = rng.choice(pays, size=k)
        keys = [pack(ei, pi) for ei, pi in zip(e, pay)]
        win = int(np.argmax(keys))
        best = 0
        for i in range(1, k):
            if better((e[i], pay[i]), (e[best], pay[best])):
                best = i
        assert (e[win], pay[win]) == (e[best], pay[best])
        assert 0 < min(keys) and max(keys) < 1 << 63
        # 0 stays "no valid position"; the keys are positive as int64


# ---------------------------------------------------------------------------
# K1's weight-1 rejection (csrc/tournament.cu: unit_log, threshold24,
# walk_down, k1_tiles), modelled on the CPU
# ---------------------------------------------------------------------------

H24 = 1 << 24
REFRESH = 8                      # csrc/tournament.cu kRefresh


@functools.lru_cache(maxsize=1)
def unit_logs_cpu() -> torch.Tensor:
    """The model's f(t) = ln((t + 1) * 2^-24) for every t < 2^24: the CPU's
    log in float64, rounded to float32, in this thread (monotone by
    construction; the card's logf is checked exhaustively by
    chip_smoke.py)."""
    u = np.arange(1, H24 + 1, dtype=np.float64) * 2.0**-24
    return torch.from_numpy(np.log(u).astype(np.float32))


def threshold_model(e: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """threshold24 over float32 draws e: the guess from exp, moved up while
    f(t) < e, then walk_down's steps while f(t - 1) >= e."""
    g = torch.exp(e) * np.float32(H24)
    t = torch.where(g >= H24, H24 - 1,
                    torch.where(g >= 1, g.to(torch.int64) - 1, 0))
    while True:
        up = (t < H24 - 1) & (f[t] < e)
        if not bool(up.any()):
            break
        t = t + up.to(torch.int64)
    while True:
        down = (t > 0) & (f[(t - 1).clamp(min=0)] >= e)
        if not bool(down.any()):
            return t
        t = t - down.to(torch.int64)


def threshold_draws(kind: str, f: torch.Tensor) -> torch.Tensor:
    """Best draws a tile may hold: every weight-1 draw, draws at weights
    1/2, 1/3 and 1/5 (between and on weight-1 draws), every weight-1 draw
    one ulp lower, and the ends."""
    if kind == "weight1":
        return f.clone()
    if kind.startswith("w/"):
        return f[::97] * np.float32(1.0 / int(kind[2:]))
    if kind == "ulp_below":
        return torch.nextafter(f, torch.tensor(-np.inf))
    return torch.tensor([-np.inf, 0.0, -0.0, float(f[0]), float(f[1]),
                         float(f[0]) * 2, -1e-30, float(f[-2]),
                         np.nextafter(np.float32(f[0]), np.float32(-1)),
                         -3.4e38], dtype=torch.float32)


@pytest.mark.parametrize("kind", ["weight1", "w/2", "w/3", "w/5",
                                  "ulp_below", "ends"])
def test_weight1_threshold_rejects_exactly_the_draws_below_the_best(kind):
    """T(be) is the smallest t with f(t) >= be, so "h >> 8 < T(be)" is
    "the weight-1 draw is below be": no draw that reaches be, a tie
    included, is rejected."""
    f = unit_logs_cpu()
    assert bool((f[1:] >= f[:-1]).all()) and float(f[-1]) == 0.0
    be = threshold_draws(kind, f)
    got = threshold_model(be, f)
    want = torch.searchsorted(f, be, side="left")
    assert torch.equal(got, want.clamp(max=H24 - 1))
    if kind == "weight1":      # an equal draw always passes
        assert bool((got <= torch.arange(H24)).all())
    step = max(1, be.numel() // 7)
    for b, t in zip(be[::step].tolist(), got[::step].tolist()):
        rejected = torch.arange(H24) < t
        assert torch.equal(rejected, f < b), (b, t)


def k1_tile_model(x, winv, sc, pos_mode: bool, J: int, rng):
    """The keys one tile of K1 leaves for one row [P] and slots sc: staging
    to weight 1 and the rest in an arbitrary order (the kernel's shared
    atomics), phase B's units every draw through the log, thr = T(keys),
    then phase A's units in an arbitrary interleaving, each keeping only T
    from thr (again every REFRESH positions and after its passing draws
    meet the tile's key), a passing draw's key meeting the tile's and,
    when it raises it, its T going to thr.  (The kernel queues passing
    draws and meets them 32 at a time; the interleaving stands for that.)"""
    f = unit_logs_cpu()
    P = x.size
    ok = winv > 0
    rep = np.zeros(P, bool)
    rep[1:] = (x[1:] == x[:-1]) & (winv[1:] == winv[:-1])
    cols = np.flatnonzero(ok & ~rep)
    one = cols[winv[cols] == np.float32(1.0)]
    rest = cols[winv[cols] != np.float32(1.0)]
    one, rest = rng.permutation(one), rng.permutation(rest)
    keys = np.zeros(sc.size, object)

    def h_of(c, s):
        h = ((int(x[c]) ^ int(sc[s])) * 0x9E3779B1) & 0xFFFFFFFF
        h ^= h >> 15
        return (h * 0x85EBCA77) & 0xFFFFFFFF

    def pay_of(c):
        return int(c) if pos_mode else int(x[c])

    for s in range(sc.size):
        for j in range(J):                       # phase B
            be, bp = -np.inf, 0xFFFFFFFF
            for c in rest[j::J]:
                e = np.float32(f[h_of(c, s) >> 8]) * winv[c]
                if e >= be and (e > be or pay_of(c) < bp):
                    be, bp = e, pay_of(c)
            if be != -np.inf:
                keys[s] = max(keys[s], pack(be, bp))
    kd = np.array([-np.inf if k == 0 else np.float32(0.0)
                   if k >> 32 == 0x7FFFFFFF else
                   np.uint32(~(k >> 32) & 0xFFFFFFFF).view(np.float32)
                   for k in keys], np.float32)
    thr = threshold_model(torch.from_numpy(kd), f).numpy() << 8
    units = [(s, j) for s in range(sc.size) for j in range(J)]
    state = {u: dict(k=u[1], since=0, T=int(thr[u[0]])) for u in units}
    live = [u for u in units if state[u]["k"] < one.size]
    while live:                                   # phase A
        u = live[rng.integers(len(live))]
        st, s = state[u], u[0]
        st["since"] += 1
        if st["since"] == REFRESH:
            st["since"], st["T"] = 0, max(st["T"], int(thr[s]))
        c = one[st["k"]]
        h = h_of(c, s)
        if h >= st["T"]:
            e = np.float32(f[h >> 8])
            key = pack(e, pay_of(c))
            if key > keys[s]:                     # the tile's atomicMax
                keys[s] = key
                t = h >> 8
                while t > 0 and float(f[t - 1]) >= e:
                    t -= 1
                thr[s] = max(int(thr[s]), t << 8)
                st["T"] = max(st["T"], t << 8)
            else:
                st["T"] = max(st["T"], int(thr[s]))
        st["k"] += J
        if st["k"] >= one.size:
            live.remove(u)
    return keys


def same_h24_items(slot_const: int, h24: int, k: int):
    """k distinct items whose hashes in one slot share h >> 8: equal draws
    at equal weight."""
    return [unit_draw_item(slot_const, (h24 << 8) | i) for i in range(k)]


@pytest.mark.parametrize("pos_mode", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_k1_tile_from_the_tiles_threshold_gives_the_plain_maximum(
        seed, pos_mode):
    """A tile whose units test each weight-1 draw against T of the tile's
    best (thr), seeded after the other weights and raised by every draw
    that raises the tile's key, leaves the keys of the plain comparator:
    the largest draw, then the smallest payload, whatever order the units
    run in.  Rows hold u = 1 draws at weights 1, 1/2 and 1/4, runs of
    repeats with equal and other weights, and equal weight-1 draws of
    distinct items."""
    rng = np.random.default_rng(seed)
    m, P, J = 5, 420, 4
    sc = T.slot_consts(m, seed, device="cpu").numpy()
    x = rng.integers(0, 1 << 32, size=P, dtype=np.uint64).astype(np.uint32)
    mult = rng.choice([1, 1, 1, 1, 1, 1, 2, 3, 4], size=P)
    winv = (1.0 / mult).astype(np.float32)
    winv[rng.random(P) < 0.08] = 0.0
    for s, (h, w) in enumerate([(0xFFFFFFFF, 1.0), (0xFFFFFF00, 0.5),
                                (0xFFFFFF7F, 0.25)]):
        at = rng.integers(0, P, size=2)
        x[at] = unit_draw_item(int(sc[s]), h)
        winv[at] = w
    for i, item in enumerate(same_h24_items(int(sc[3]), 0xFFFFFF, 4)):
        x[30 + 40 * i], winv[30 + 40 * i] = item, 1.0
    x[200:206], winv[200:206] = x[199], [1.0, 0.5, 0.5, 1.0, 0.25, 1.0]
    keys = k1_tile_model(x, winv, sc, pos_mode, J, rng)
    f = unit_logs_cpu().numpy()
    ok = winv > 0
    for s in range(m):             # the plain comparator on the same draws
        h = ((x.astype(np.uint64) ^ np.uint64(sc[s])) * np.uint64(
            0x9E3779B1)) & np.uint64(0xFFFFFFFF)
        h ^= h >> np.uint64(15)
        h = (h * np.uint64(0x85EBCA77)) & np.uint64(0xFFFFFFFF)
        e = np.where(ok, f[(h >> np.uint64(8)).astype(np.int64)] * winv,
                     -np.inf).astype(np.float32)
        pay = np.arange(P) if pos_mode else x.astype(np.int64)
        want = pay[e == e.max()].min()
        assert keys[s] == pack(e.max(), int(want)), s


@pytest.mark.parametrize("n,P", [(1024, 5993), (1600, 5232), (520, 16_000),
                                 (3, 16_377), (512, 12_268), (512, 16_364)])
def test_plans_at_the_cells_row_shapes_are_unchanged(n, P):
    """K1's rejection needs no other cut of the tiles: at 4 blocks an SM
    the plan of the sketch cells' row shapes (the k=8 and k=21 rungs) is
    the one K1 and K2 had before it."""
    want = {(1024, 5993): (1, 1199, 2048, 32, 5), (1600, 5232):
            (1, 1744, 2048, 32, 3), (520, 16_000): (1, 1778, 2048, 32, 9),
            (3, 16_377): (1, 512, 2048, 32, 32), (512, 12_268):
            (1, 1364, 2048, 32, 9), (512, 16_364): (1, 1819, 2048, 32, 9)}
    pl = T.plan(n, P, 200, 132, 4)
    assert (pl.rows, pl.span, pl.chunk, pl.sub, pl.spans) == want[(n, P)]


def unit_draw_item(slot_const: int, h: int) -> int:
    """The u32 x with mix32(x ^ slot_const) = h (h >= 0xFFFFFF00: u = 1)."""
    def inv(a):
        return pow(a, -1, 1 << 32)
    y = (h * inv(0x85EBCA77)) & 0xFFFFFFFF
    z = y ^ (y >> 15) ^ (y >> 30)
    return ((z * inv(0x9E3779B1)) & 0xFFFFFFFF) ^ slot_const


def tie_case(wide: bool, slot: int = 3, n: int = 3, P: int = 600):
    """Unsorted rows with repeats of equal and other weights, and in row 0
    two items that draw u = 1 in ``slot`` with other weights."""
    items, w, valid, winv = case(21, wide, n=n, P=P)
    rng = np.random.default_rng(22)
    rep = rng.random((n, P)) < 0.3
    rep[:, 0] = False
    for r in range(n):                       # runs of repeats
        for p in np.flatnonzero(rep[r]):
            items[r, p] = items[r, p - 1]
            if rng.random() < 0.5:
                w[r, p] = w[r, p - 1]
    sc = int(T.slot_consts(M, device="cpu")[slot])
    x5, x9 = (unit_draw_item(sc, h) for h in (0xFFFFFFFF, 0xFFFFFF00))
    top = 0x9ABCDEF0
    items[0, 5] = (x5 ^ top) | (top << 32) if wide else x5
    items[0, 9] = x9
    w[0, 5], w[0, 9] = 2, 1
    valid[0, [5, 9]] = True
    w = np.where(valid, w, 0)
    winv = np.where(valid, 1.0 / np.maximum(w, 1), 0.0).astype(np.float32)
    return items, w, valid, winv


def test_unit_draw_and_repeats_match_jax():
    sc = int(T.slot_consts(M, device="cpu")[3])
    for wide in (False, True):
        items, w, valid, winv = tie_case(wide)
        live = valid.any(axis=1)
        if wide:
            lo = (items & np.uint64(0xFFFFFFFF)).astype(np.uint32)
            hi = (items >> np.uint64(32)).astype(np.uint32)
            glo, ghi = T.weighted_tournament_u64(ti32(lo), ti32(hi),
                                                 torch.from_numpy(winv), M)
            got = ((ghi.numpy().view(np.uint32).astype(np.uint64)
                    << np.uint64(32)) | glo.numpy().view(np.uint32))
            plo, phi = j_wt64(lo, hi, winv, M, seed=0, interpret=True)
            want = ((np.asarray(phi).astype(np.uint64) << np.uint64(32))
                    | np.asarray(plo).astype(np.uint64))
            fold = (lo ^ hi).astype(np.uint32)
            pa = first_position(items, w, got)[live]
            pb = first_position(items, w, want)[live]
            assert_exact_or_near_ties(pa, pb, fold[live], w[live], M)
            x = int(fold[0, pa[0, 3]])
        else:
            for pos in (False, True):
                got = T.weighted_tournament(ti32(items),
                                            torch.from_numpy(winv), M,
                                            return_positions=pos).numpy()
                want = np.asarray(j_wt(items, winv, M, seed=0, interpret=True,
                                       return_positions=pos))
                if not pos:
                    got = first_position(items, w, got.view(np.uint32))
                    want = first_position(items, w, want)
                assert_exact_or_near_ties(got[live], want[live].astype(
                    np.int64), items[live], w[live], M)
            x = int(items[0, got[0, 3]])
        h = ((((x ^ sc) & 0xFFFFFFFF) * 0x9E3779B1) & 0xFFFFFFFF)
        h = ((h ^ (h >> 15)) * 0x85EBCA77) & 0xFFFFFFFF
        assert h >> 8 == 0xFFFFFF              # a u = 1 draw won slot 3


def test_skipping_a_repeat_of_the_position_before_is_exact():
    """What the kernels' staging does: a position whose draw input and
    winv equal the position before it is dropped.  The plain versions give
    the same winners with and without those positions."""
    for wide in (False, True):
        items, w, valid, winv = tie_case(wide)
        x = ((items ^ (items >> np.uint64(32))) if wide else items) \
            .astype(np.uint64) & np.uint64(0xFFFFFFFF)
        rep = np.zeros_like(valid)
        rep[:, 1:] = (x[:, 1:] == x[:, :-1]) & (winv[:, 1:] == winv[:, :-1])
        assert (rep & (winv > 0)).sum() > 100
        skipped = np.where(rep, 0.0, winv).astype(np.float32)
        if wide:
            lo, hi = ti32(items & np.uint64(0xFFFFFFFF)), ti32(
                items >> np.uint64(32))
            a = T.weighted_tournament_u64(lo, hi, torch.from_numpy(winv), M)
            b = T.weighted_tournament_u64(lo, hi, torch.from_numpy(skipped), M)
            assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        else:
            for pos in (False, True):
                a = T.weighted_tournament(ti32(items), torch.from_numpy(winv),
                                          M, return_positions=pos)
                b = T.weighted_tournament(ti32(items),
                                          torch.from_numpy(skipped), M,
                                          return_positions=pos)
                assert torch.equal(a, b)


SASS = """
        Function : _ZN12_GLOBAL__N_117tournament_kernelILb0EEEvPKj
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   LDS.64 R2, [R0] ;
        /*0020*/                   IMAD R4, R3, 0x9e3779b1, RZ ;
        /*0030*/              @!P0 BRA 0x60 ;
        /*0040*/                   I2FP.F32.U32 R4, R4 ;
        /*0050*/                   IMAD R5, R2, 0x9e3779b1, RZ ;
        /*0060*/                   FMUL R5, R4, R4 ;
        /*0070*/               @P1 BRA 0x10 ;
        /*0080*/                   IADD3 R0, R0, 0x1, RZ ;
        /*0090*/               @P2 BRA 0x10 ;
        /*00a0*/                   EXIT ;
"""


def test_sass_draw_loop_is_the_innermost_loop_with_draws(monkeypatch):
    from kmerutils_tpu_torch import roofline

    class Done:
        stdout = SASS
    monkeypatch.setattr(roofline.subprocess, "run", lambda *a, **k: Done())
    monkeypatch.setattr(roofline, "_cuobjdump", lambda: "cuobjdump")
    (name, r), = roofline.tournament_instructions_per_draw("lib.so").items()
    assert "ILb0E" in name
    assert r["instructions"] == 7 and r["draws"] == 2
    assert r["instructions_per_draw"] == 3.5 and r["range"] == ["0x10", "0x70"]


def test_tournament_work_counts_needed_draws_and_bytes():
    from kmerutils_tpu_torch import roofline
    x = torch.tensor([[5, 5, 5, 7, 7], [1, 2, 3, 4, 5]], dtype=torch.int32)
    w = torch.tensor([[1.0, 1.0, 0.5, 0.5, 0.0], [0.0, 1, 1, 1, -1]])
    draws, nbytes = roofline.tournament_work(x, w, 3, wide=False)
    assert draws == (3 + 3) * 3                # row 0: 5@1, 5@.5, 7@.5
    assert nbytes == 2 * 5 * 8 + 2 * 3 * 4
    b, by = roofline.bound(1e9, 3.35e8, sms=1, clock_hz=1e9)
    assert by == "operations" and b > roofline.bytes_ms(1e9)
