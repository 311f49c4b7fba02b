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
    sc = T.slot_consts(m, seed).numpy()
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
    sc = int(T.slot_consts(1).numpy()[0])
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
