"""The port's sketch/golden.py (the published sequential algorithms) against
the JAX package's, and the port's six sketch families against it, on the
CPU.

Tolerance: the golden functions are equal to JAX's bit for bit on seeded
small inputs (m = 16-64, at most 80 items, 3 seeds): the Xoshiro256**
streams, ``below``, winners, values and registers.  The families are then
judged by tests/test_sketch.py's statistical rules for the JAX package,
with the same tolerances: both the port's batched sampler and the golden
algorithm must estimate the exact (Probability) Jaccard, or HLL's
cardinality, without bias and with binomial-order spread.
"""

import numpy as np
import pytest
import torch

from kmerutils_tpu.sketch import golden as jgold
from kmerutils_tpu_torch.sketch import densminhash, probminhash, setsketch
from kmerutils_tpu_torch.sketch import golden as tgold
from kmerutils_tpu_torch.sketch import superminhash

SEEDS = [0, 1, 7]


def same(a, b) -> bool:
    """Equal values of the same dtype and shape."""
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 1, 12345, (1 << 64) - 1])
def test_xoshiro_streams_match_jax(seed):
    t, j = tgold.Xoshiro256ss(seed), jgold.Xoshiro256ss(seed)
    assert t.s == j.s
    assert [t.next_u64() for _ in range(200)] == \
        [j.next_u64() for _ in range(200)]
    assert [t.uniform() for _ in range(100)] == \
        [j.uniform() for _ in range(100)]
    for n in (1, 2, 3, 7, 64, 200, 1 << 33, (1 << 63) + 5):
        assert [t.below(n) for _ in range(20)] == \
            [j.below(n) for _ in range(20)]


def items_for(seed: int, n: int = 60):
    rng = np.random.default_rng(100 + seed)
    items = rng.integers(1, 2**62, n, dtype=np.uint64)
    weights = rng.integers(1, 6, n)
    return items, weights


@pytest.mark.parametrize("seed", SEEDS)
def test_golden_samplers_match_jax(seed):
    items, weights = items_for(seed)
    for m in (16, 40, 64):
        assert same(tgold.probminhash3_golden(items, weights, m, seed),
                    jgold.probminhash3_golden(items, weights, m, seed))
        for name in ("superminhash_golden", "optdens_golden",
                     "revoptdens_golden"):
            tv, tw = getattr(tgold, name)(items, m, seed)
            jv, jw = getattr(jgold, name)(items, m, seed)
            assert same(tv, jv) and same(tw, jw), (name, m)
    # fewer items than slots: densification walks many rounds
    few = items[:5]
    for name in ("optdens_golden", "revoptdens_golden"):
        tv, tw = getattr(tgold, name)(few, 64, seed)
        jv, jw = getattr(jgold, name)(few, 64, seed)
        assert same(tv, jv) and same(tw, jw), name
    p = setsketch.SetSketchParams(m=32)
    tr = tgold.setsketch_golden(items[:40], 32, p.b, p.a, p.q, seed)
    jr = jgold.setsketch_golden(items[:40], 32, p.b, p.a, p.q, seed)
    assert same(tr, jr)
    assert tgold.setsketch_cardinality_golden(tr, 32, p.b, p.a) == \
        jgold.setsketch_cardinality_golden(jr, 32, p.b, p.a)


@pytest.mark.parametrize("seed", SEEDS)
def test_probjaccard_exact_matches_jax(seed):
    items, weights = items_for(seed, 80)
    wa = {int(d): float(w) for d, w in zip(items[:60], weights[:60])}
    wb = {int(d): float(w) for d, w in zip(items[20:], weights[20:] + 1)}
    assert tgold.probjaccard_exact(wa, wb) == jgold.probjaccard_exact(wa, wb)
    assert tgold.probjaccard_exact(wa, wa) == pytest.approx(1.0)
    assert tgold.probjaccard_exact(wa, {}) == 0.0


def test_golden_edge_cases_match_jax():
    none = np.zeros(0, np.uint64)
    for name in ("superminhash_golden", "optdens_golden",
                 "revoptdens_golden"):
        tv, tw = getattr(tgold, name)(none, 16)
        jv, jw = getattr(jgold, name)(none, 16)
        assert same(tv, jv) and same(tw, jw)
    assert same(tgold.probminhash3_golden(none, [], 16),
                jgold.probminhash3_golden(none, [], 16))
    assert same(tgold.setsketch_golden(none, 16, 1.001, 20.0, 65534),
                jgold.setsketch_golden(none, 16, 1.001, 20.0, 65534))


# ---------------------------------------------------------------------------
# the port's six families against the port's golden, tests/test_sketch.py's
# rules
# ---------------------------------------------------------------------------

def row(a: np.ndarray) -> torch.Tensor:
    """One row of u64 items as int64 bit patterns."""
    return torch.from_numpy(a.view(np.int64).copy())[None]


def overlap_sets():
    """tests/test_sketch.py's sets: exact J = 40 / 80."""
    rng = np.random.default_rng(17)
    pool = rng.integers(1, 2**62, 120, dtype=np.uint64)
    return pool[:60], pool[20:80], 0.5


def unweighted(family: str, a, b, m: int, trials: int):
    """Per-seed Jaccard estimates of the port's sampler and the golden."""
    fn = {"SUPER": superminhash.superminhash,
          "SUPER2": superminhash.superminhash2,
          "OPTDENS": densminhash.optdens_signatures,
          "REVOPTDENS": densminhash.revoptdens_signatures}[family]
    gold = {"SUPER": tgold.superminhash_golden,
            "SUPER2": tgold.superminhash_golden,
            "OPTDENS": tgold.optdens_golden,
            "REVOPTDENS": tgold.revoptdens_golden}[family]
    ta, tb = row(a), row(b)
    va = torch.ones(ta.shape, dtype=torch.bool)
    vb = torch.ones(tb.shape, dtype=torch.bool)
    est_t, est_g = [], []
    for s in range(trials):
        sa, _ = fn(ta, va, m, s)
        sb, _ = fn(tb, vb, m, s)
        est_t.append(float((sa[0] == sb[0]).to(torch.float64).mean()))
        ga, wa = gold(a, m, s)
        gb, wb = gold(b, m, s)
        # SuperMinHash's golden compares winners, the densified ones values
        est_g.append(float(((wa == wb) if family.startswith("SUPER")
                            else (ga == gb)).mean()))
    return est_t, est_g


def check_unweighted(family: str):
    a, b, jex = overlap_sets()
    m, trials = 64, 24
    est_t, est_g = unweighted(family, a, b, m, trials)
    tol = 3.5 * np.sqrt(jex * (1 - jex) / m / trials) + 0.02
    ref_sd = np.sqrt(jex * (1 - jex) / m)
    for label, est in (("port", est_t), ("golden", est_g)):
        assert abs(np.mean(est) - jex) < tol, (label, np.mean(est), tol)
        # SuperMinHash's spread is below binomial for small sets, so only
        # the upper bound is common to the families
        assert np.std(est) < 1.7 * ref_sd, (label, np.std(est), ref_sd)


def check_prob3a():
    rng = np.random.default_rng(5)
    items = rng.integers(1, 2**31, 60, dtype=np.uint64)
    wa = {int(d): int(w) for d, w in zip(items, rng.integers(1, 6, 60))}
    wb = {int(d): int(w) for d, w in zip(items[:40], rng.integers(1, 6, 40))}
    jp = tgold.probjaccard_exact({k: float(v) for k, v in wa.items()},
                                 {k: float(v) for k, v in wb.items()})
    m, trials = 64, 40
    ka = np.array(sorted(wa), dtype=np.uint64)
    va = np.array([wa[int(k)] for k in ka], dtype=np.int32)
    kb = np.array(sorted(wb), dtype=np.uint64)
    vb = np.array([wb[int(k)] for k in kb], dtype=np.int32)
    est_t, est_g = [], []
    for s in range(trials):
        sa, _ = probminhash.probminhash_signatures(
            row(ka), torch.from_numpy(va)[None], m, seed=s)
        sb, _ = probminhash.probminhash_signatures(
            row(kb), torch.from_numpy(vb)[None], m, seed=s)
        est_t.append(float((sa[0] == sb[0]).to(torch.float64).mean()))
        ga = tgold.probminhash3_golden(ka, va, m, seed=s)
        gb = tgold.probminhash3_golden(kb, vb, m, seed=s)
        est_g.append(float((ga == gb).mean()))
    tol = 3.5 * np.sqrt(jp * (1 - jp) / m / trials) + 0.01
    ref_sd = np.sqrt(jp * (1 - jp) / m)
    for label, est in (("port", est_t), ("golden", est_g)):
        assert abs(np.mean(est) - jp) < tol, (label, np.mean(est), jp, tol)
        assert 0.5 * ref_sd < np.std(est) < 1.6 * ref_sd, \
            (label, np.std(est), ref_sd)


def check_hll():
    rng = np.random.default_rng(23)
    n, m, trials = 400, 64, 8
    items = rng.integers(1, 2**62, n, dtype=np.uint64)
    p = setsketch.SetSketchParams(m=m)
    valid = torch.ones((1, n), dtype=torch.bool)
    est_t, est_g = [], []
    for s in range(trials):
        regs = setsketch.setsketch_signatures(row(items), valid, p, s)
        est_t.append(float(setsketch.cardinality(regs, p)[0]))
        regs_g = tgold.setsketch_golden(items, m, p.b, p.a, p.q, s)
        est_g.append(tgold.setsketch_cardinality_golden(regs_g, m, p.b, p.a))
    sd_theory = n / np.sqrt(m)            # HLL-order relative error
    for label, est in (("port", est_t), ("golden", est_g)):
        assert abs(np.mean(est) - n) < \
            3.5 * sd_theory / np.sqrt(trials) + 0.05 * n, \
            (label, np.mean(est))
        assert np.std(est) < 2.5 * sd_theory, (label, np.std(est))
    # the register law: mean registers within each other's sampling noise
    regs_t = setsketch.setsketch_signatures(row(items), valid, p, 0)[0]
    regs_g = tgold.setsketch_golden(items, m, p.b, p.a, p.q, 0)
    sd_mean_reg = (1.0 / np.log(p.b)) / np.sqrt(m)
    assert abs(regs_t.to(torch.float64).mean().item()
               - regs_g.astype(np.float64).mean()) < 4 * sd_mean_reg


@pytest.mark.parametrize("family", ["PROB3A", "SUPER", "SUPER2", "OPTDENS",
                                    "REVOPTDENS", "HLL"])
def test_family_estimates_like_golden(family):
    """The port's sampler and the published algorithm both estimate the
    exact value without bias and with at most binomial-order spread."""
    if family == "PROB3A":
        check_prob3a()
    elif family == "HLL":
        check_hll()
    else:
        check_unweighted(family)
