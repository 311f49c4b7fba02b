"""The published sequential algorithms of the six sketch families, on the
host (pure Python and numpy, no torch).

Port of kmerutils_tpu/sketch/golden.py.  The batched samplers on the card
are estimator-equivalent to these, not bit-identical: the reference
consumes the ``probminhash`` crate, whose order of random draws is
inherently sequential.  These functions let a check measure the card's
estimates against faithful implementations of the published algorithms:

* ProbMinHash3 (O. Ertl, IEEE TKDE 2020, Algorithm 3): per item d of
  weight w, a dedicated RNG seeded from d; the j-th smallest of m iid
  Exp(w) arrival times generated incrementally (t_j = t_{j-1} +
  Exp((m - j) w)), each assigned to a random not yet visited slot by an
  inline Fisher-Yates step; a slot keeps the item with the smallest
  arrival time; an item stops once t exceeds the current worst slot;
* SuperMinHash (Ertl, arXiv:1706.05698, Algorithm 1);
* OptDens (Shrivastava, PMLR 2017) and RevOptDens (Mai et al., PMLR 2020)
  over one-permutation hashing;
* SetSketch1's register law (Ertl, VLDB 2021, eq. 6) and its estimator;
* the exact Probability Jaccard of two weighted sets.

RNG: xoshiro256** (Blackman-Vigna), seeded through splitmix64 as the crate
family seeds its per-item streams.  Exponential draws are -ln(u) / rate
with u the standard 53-bit double in (0, 1].  Not a performance path.
"""

from __future__ import annotations

import math

import numpy as np

_MASK64 = (1 << 64) - 1


def _splitmix64(x: int):
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    z = x
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x, z ^ (z >> 31)


class Xoshiro256ss:
    """xoshiro256** — the crate family's stream generator."""

    def __init__(self, seed: int):
        s = seed & _MASK64
        st = []
        for _ in range(4):
            s, v = _splitmix64(s)
            st.append(v)
        self.s = st

    @staticmethod
    def _rotl(x, k):
        return ((x << k) | (x >> (64 - k))) & _MASK64

    def next_u64(self) -> int:
        s = self.s
        result = (self._rotl((s[1] * 5) & _MASK64, 7) * 9) & _MASK64
        t = (s[1] << 17) & _MASK64
        s[2] ^= s[0]
        s[3] ^= s[1]
        s[1] ^= s[2]
        s[0] ^= s[3]
        s[2] ^= t
        s[3] = self._rotl(s[3], 45)
        return result

    def uniform(self) -> float:
        """Standard 53-bit double in (0, 1]."""
        return ((self.next_u64() >> 11) + 1) * (2.0 ** -53)

    def below(self, n: int) -> int:
        """Unbiased uniform integer in [0, n) (rejection on the top range)."""
        lim = _MASK64 - (_MASK64 + 1) % n
        while True:
            v = self.next_u64()
            if v <= lim:
                return v % n


def probminhash3_golden(items, weights, m: int, seed: int = 0):
    """Signature of a weighted set by the published sequential algorithm.

    items: iterable of int hash values; weights: positive floats/ints.
    Returns uint64[m] (slot -> winning item value).
    """
    sig_t = np.full(m, np.inf)
    sig_v = np.zeros(m, dtype=np.uint64)
    for d, w in zip(items, weights):
        d = int(d)
        w = float(w)
        rng = Xoshiro256ss(d ^ (seed * 0x9E3779B97F4A7C15 & _MASK64))
        perm = list(range(m))
        t = 0.0
        worst = sig_t.max()
        for j in range(m):
            rate = w * (m - j)
            t += -math.log(rng.uniform()) / rate
            if t >= worst:
                break
            r = j + rng.below(m - j) if m - j > 1 else j
            perm[j], perm[r] = perm[r], perm[j]
            s = perm[j]
            if t < sig_t[s]:
                sig_t[s] = t
                sig_v[s] = d
                worst = sig_t.max()
    return sig_v


def superminhash_golden(items, m: int, seed: int = 0):
    """GOLDEN SuperMinHash — Ertl's published sequential Algorithm 1
    (arXiv:1706.05698; the algorithm SuperHashSketch/SuperHash2Sketch
    consume through the probminhash crate,
    the reference's setsketchert.rs:211-336, 904-1046).

    Per item d: a dedicated RNG; for j = 0..m-1, draw u ~ U[0,1) and an
    inline Fisher-Yates step selecting slot p[j] among the unvisited; the
    candidate value j + u goes to slot p[j] if smaller.  Early termination
    once j exceeds the current global maximum (Ertl's a_max bookkeeping is
    equivalent to stopping when j >= ceil(current max); we use the simple
    bound).  Returns (values float64[m], winners uint64[m]).
    """
    sig_t = np.full(m, np.inf)
    sig_v = np.zeros(m, dtype=np.uint64)
    for d in items:
        d = int(d)
        rng = Xoshiro256ss(d ^ (seed * 0x9E3779B97F4A7C15 & _MASK64))
        perm = list(range(m))
        worst = sig_t.max()
        for j in range(m):
            if j >= worst:           # j + u >= worst for every later slot
                break
            u = rng.uniform()
            r = j + rng.below(m - j) if m - j > 1 else j
            perm[j], perm[r] = perm[r], perm[j]
            s = perm[j]
            t = j + u
            if t < sig_t[s]:
                sig_t[s] = t
                sig_v[s] = d
                worst = sig_t.max()
    return sig_t, sig_v


def _oph_golden(items, m: int, seed: int):
    """One-permutation hashing base: per-slot minima + winning items.
    One uniform draw decides (bucket, value) per item — the structure
    OptDens/RevOptDens densify (setsketchert.rs:343-596)."""
    sig = np.full(m, np.inf)
    win = np.zeros(m, dtype=np.uint64)
    for d in items:
        d = int(d)
        rng = Xoshiro256ss(d ^ (seed * 0x9E3779B97F4A7C15 & _MASK64))
        b = rng.below(m)
        u = rng.uniform()
        if u < sig[b]:
            sig[b] = u
            win[b] = d
    return sig, win


def optdens_golden(items, m: int, seed: int = 0):
    """GOLDEN OptDens (Shrivastava, PMLR 2017 "Optimal densification for
    fast and accurate minwise hashing"): each EMPTY bucket walks a random
    probe sequence (its own RNG keyed by (bucket, seed)) and copies the
    first originally-filled bucket it hits.  Returns (values, winners)."""
    sig, win = _oph_golden(items, m, seed)
    filled = np.isfinite(sig)
    if not filled.any():
        return sig, win
    out_s, out_w = sig.copy(), win.copy()
    for jb in np.flatnonzero(~filled):
        rng = Xoshiro256ss((int(jb) * 0xD1B54A32D192ED03
                            ^ seed * 0x9E3779B97F4A7C15) & _MASK64)
        while True:
            p = rng.below(m)
            if filled[p]:
                out_s[jb] = sig[p]
                out_w[jb] = win[p]
                break
    return out_s, out_w


def revoptdens_golden(items, m: int, seed: int = 0):
    """GOLDEN RevOptDens (Mai et al., PMLR 2020 "On densification for
    minwise hashing"): rounds of the REVERSE walk — every originally
    filled bucket probes one random target per round and fills it if still
    empty (min-combining on collision within a round), until no bucket is
    empty.  Robust when m > #items (setsketchert.rs:490-495).  Returns
    (values, winners)."""
    sig, win = _oph_golden(items, m, seed)
    filled0 = np.flatnonzero(np.isfinite(sig))
    if filled0.size == 0:
        return sig, win
    out_s, out_w = sig.copy(), win.copy()
    rngs = {int(jb): Xoshiro256ss((int(jb) * 0xD1B54A32D192ED03
                                   ^ seed * 0x9E3779B97F4A7C15) & _MASK64)
            for jb in filled0}
    while not np.isfinite(out_s).all():
        empty_at_round = ~np.isfinite(out_s)
        for jb in filled0:
            p = rngs[int(jb)].below(m)
            # only rounds' empty slots may fill; min-combine on collision
            if empty_at_round[p] and sig[jb] < out_s[p]:
                out_s[p] = sig[jb]
                out_w[p] = win[jb]
    return out_s, out_w


def setsketch_golden(items, m: int, b: float, a: float, q: int,
                     seed: int = 0):
    """GOLDEN SetSketch1 register law (Ertl, VLDB 2021, eq. 6 — the
    probminhash SetSketcher behind HyperLogLogSketch,
    setsketchert.rs:600-896): register i of the sketch of a set D is

        K_i = max_{d in D} clamp(1 + floor(log_b(a / E(d, i))), 0, q)

    with E(d, i) iid Exp(1) per (item, register), drawn here from a
    dedicated xoshiro stream per item.  Returns uint64[m] registers."""
    regs = np.zeros(m, dtype=np.int64)
    log_b = math.log(b)
    for d in items:
        d = int(d)
        rng = Xoshiro256ss(d ^ (seed * 0x9E3779B97F4A7C15 & _MASK64))
        for i in range(m):
            e = -math.log(rng.uniform())
            v = 1 + math.floor((math.log(a) - math.log(e)) / log_b)
            v = min(max(v, 0), q)
            if v > regs[i]:
                regs[i] = v
    return regs.astype(np.uint64)


def setsketch_cardinality_golden(regs, m: int, b: float, a: float) -> float:
    """Ertl's GHLL estimator (the closed form sketch/setsketch.py uses)."""
    s = float(np.power(b, -regs.astype(np.float64)).sum())
    return m * (1.0 - 1.0 / b) / (a * math.log(b)) / s


def probjaccard_exact(wa: dict, wb: dict) -> float:
    """Exact Probability Jaccard J_P of two weighted sets:
    J_P = sum_d 1 / sum_e max(w_e^A / w_d^A, w_e^B / w_d^B) over the union
    (Moulton-Jiang; the quantity every ProbMinHash estimates)."""
    union = set(wa) | set(wb)
    total = 0.0
    for d in union:
        da, db = wa.get(d, 0.0), wb.get(d, 0.0)
        if da == 0.0 or db == 0.0:
            continue
        denom = 0.0
        for e in union:
            denom += max(wa.get(e, 0.0) / da, wb.get(e, 0.0) / db)
        total += 1.0 / denom
    return total
