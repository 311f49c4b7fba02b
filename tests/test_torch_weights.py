"""The weights stage of ProbMinHash (ops/weights.py, kernel KW on the card):
its plain version against the JAX package's sort and
``_run_multiplicities``, the argument checks, and the kernel's two routes
modelled in numpy: the walk over a tile, and the wide route's galloping
run search.

Tolerance: bit-exact (sorted items, float32 ``winv`` and ``is_real`` at
every position, padding included).  Rows are seeded: ragged and empty rows,
valid masks that are not a prefix, heavy duplicates, items >= 2^31 / 2^63
and items equal to the all-ones sentinel.
"""

import numpy as np
import pytest
import torch

from kmerutils_tpu.sketch import probminhash as jpmh
from kmerutils_tpu_torch.ops import weights as KW

DTYPES = [torch.int32, torch.int64]
NP = {torch.int32: (np.uint32, np.int32), torch.int64: (np.uint64, np.int64)}


def sentinel(dtype):
    return NP[dtype][0](np.iinfo(NP[dtype][0]).max)


def rows(seed: int, n: int, P: int, dtype, alphabet: int = 0):
    """(items unsigned [n, P], valid bool [n, P]): row 0 full with a
    sentinel-valued item, row 1 empty, row 2 one position, row 3 a random
    mask that is not a prefix, the rest ragged prefixes; items from an
    ``alphabet`` of values (0: any value) near the top of the range."""
    rng = np.random.default_rng(seed)
    ut, _ = NP[dtype]
    top = np.iinfo(ut).max
    if alphabet:
        pool = (top - rng.integers(0, 4 * alphabet, size=alphabet,
                                   dtype=np.int64).astype(ut))
        items = rng.choice(pool, size=(n, P))
    else:
        items = rng.integers(0, top, size=(n, P), dtype=ut, endpoint=True)
    lengths = rng.integers(0, P + 1, size=n)
    lengths[:3] = [P, 0, 1][:n]
    valid = np.arange(P)[None, :] < lengths[:, None]
    if n > 3:
        valid[3] = rng.random(P) < 0.5
    if P > 3:
        items[0, 3] = sentinel(dtype)
    return items.astype(ut), valid


def to_torch(items: np.ndarray, dtype) -> torch.Tensor:
    return torch.from_numpy(items.view(NP[dtype][1]).copy())


def to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32 if t.dtype == torch.int32 else np.uint64)


def jax_weights(items: np.ndarray, valid: np.ndarray, dtype):
    """The JAX package's sort and _run_multiplicities of the same rows."""
    sent = sentinel(dtype)
    js = np.sort(np.where(valid, items, sent), axis=1)
    w = np.asarray(jpmh._run_multiplicities(js, js != sent))
    return js, (np.float32(1.0) / np.maximum(w, 1).astype(np.float32)), \
        js != sent


def kernel_model(items: np.ndarray, valid: np.ndarray, threads: int,
                 ipt: int, dtype):
    """csrc/weights.cu's arithmetic, one tile of threads x ipt a row: the
    row padded with the sentinel to the tile and sorted; positions blocked
    (thread t holds t * ipt .. t * ipt + ipt - 1); heads and stops from the
    key before; each thread's last head and first stop; inclusive scans
    across the lanes of a warp, then the warps before and after; then the
    thread's own ascending and descending walks."""
    n, P = items.shape
    tile = threads * ipt
    sent = sentinel(dtype)
    keys = np.full((n, tile), sent, items.dtype)
    keys[:, :P] = np.where(valid, items, sent)
    keys = np.sort(keys, axis=1)
    real = keys != sent
    prev = np.concatenate([np.full((n, 1), sent), keys[:, :-1]], axis=1)
    head = real & (keys != prev)
    stop = head | ~real
    pos = np.arange(tile).reshape(threads, ipt)
    heads = head.reshape(n, threads, ipt)
    stops = stop.reshape(n, threads, ipt)
    h_last = np.where(heads, pos, -1).max(axis=2)            # [n, threads]
    s_first = np.where(stops, pos, tile).min(axis=2)
    warps = threads // 32
    hw = np.maximum.accumulate(h_last.reshape(n, warps, 32), axis=2)
    sw = np.minimum.accumulate(
        s_first.reshape(n, warps, 32)[:, :, ::-1], axis=2)[:, :, ::-1]
    start = np.concatenate([np.full((n, warps, 1), -1), hw[:, :, :-1]], 2)
    end = np.concatenate([sw[:, :, 1:], np.full((n, warps, 1), tile)], 2)
    for w in range(warps):
        for v in range(w):
            start[:, w] = np.maximum(start[:, w], hw[:, v, 31][:, None])
        for v in range(w + 1, warps):
            end[:, w] = np.minimum(end[:, w], sw[:, v, 0][:, None])
    start, end = start.reshape(n, threads), end.reshape(n, threads)
    first = np.empty((n, threads, ipt), np.int64)
    for i in range(ipt):
        start = np.where(heads[:, :, i], pos[:, i], start)
        first[:, :, i] = start
    wv = np.empty((n, threads, ipt), np.float32)
    for i in reversed(range(ipt)):
        wv[:, :, i] = np.float32(1.0) / (end - first[:, :, i]).astype(
            np.float32)
        end = np.where(stops[:, :, i], pos[:, i], end)
    return (keys[:, :P], wv.reshape(n, tile)[:, :P], real[:, :P])


def run_first(s: np.ndarray, p: int) -> int:
    """csrc/weights_wide.cu's run_first: the first q <= p with s[q] ==
    s[p], by galloping back (1, 2, 4, ... positions) then bisecting."""
    k, inside, out, d = s[p], p, -1, 1
    while p - d >= 0:
        if s[p - d] != k:
            out = p - d
            break
        inside, d = p - d, 2 * d
    while inside - out > 1:
        m = out + (inside - out) // 2
        inside, out = (m, out) if s[m] == k else (inside, m)
    return inside


def run_end(s: np.ndarray, p: int) -> int:
    """csrc/weights_wide.cu's run_end: the first q > p with s[q] != s[p],
    or P."""
    P = len(s)
    k, inside, out, d = s[p], p, P, 1
    while p + d < P:
        if s[p + d] != k:
            out = p + d
            break
        inside, d = p + d, 2 * d
    while out - inside > 1:
        m = inside + (out - inside) // 2
        inside, out = (m, out) if s[m] == k else (inside, m)
    return out


def wide_model(items: np.ndarray, valid: np.ndarray, dtype):
    """csrc/weights_wide.cu's arithmetic: the keys sorted a row, then at a
    real position its run's end less its first position, and at padding p,
    p + 1 less the first position of the last real run (-1 if none)."""
    sent = sentinel(dtype)
    keys = np.sort(np.where(valid, items, sent), axis=1)
    w = np.empty(keys.shape, np.int64)
    for r, row in enumerate(keys):
        for p in range(len(row)):
            if row[p] != sent:
                w[r, p] = run_end(row, p) - run_first(row, p)
            else:
                f = run_first(row, p)
                w[r, p] = p + 1 - (run_first(row, f - 1) if f > 0 else -1)
    return keys, np.float32(1.0) / w.astype(np.float32), keys != sent


@pytest.mark.parametrize("dtype", DTYPES)
def test_cpu_tensors_run_the_plain_version(dtype):
    items, valid = rows(5, 6, 40, dtype, alphabet=5)
    before = KW.launches_weights
    got = KW.sort_weights(to_torch(items, dtype), torch.from_numpy(valid))
    want = KW.sort_weights_ref(to_torch(items, dtype),
                               torch.from_numpy(valid))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert (got[0].dtype, got[1].dtype, got[2].dtype) == \
        (dtype, torch.float32, torch.bool)
    assert KW.launches_weights == before


@pytest.mark.parametrize("case", ["int16", "float", "valid_int", "shape",
                                  "one_dim", "three_dim"])
def test_bad_arguments_raise(case):
    items = torch.zeros((3, 8), dtype=torch.int32)
    valid = torch.ones((3, 8), dtype=torch.bool)
    if case == "int16":
        items = items.to(torch.int16)
    elif case == "float":
        items = items.to(torch.float32)
    elif case == "valid_int":
        valid = valid.to(torch.int32)
    elif case == "shape":
        valid = valid[:, :7]
    elif case == "one_dim":
        items, valid = items[0], valid[0]
    else:
        items, valid = items[None], valid[None]
    with pytest.raises(ValueError):
        KW.sort_weights(items, valid)
    with pytest.raises(ValueError):
        KW.sort_weights_ref(items, valid)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n, P, alphabet", [(8, 37, 6), (7, 300, 0),
                                            (5, 129, 2), (4, 1, 0)],
                         ids=["duplicates", "distinct", "two_values",
                              "one_position"])
def test_plain_version_matches_jax(dtype, n, P, alphabet):
    items, valid = rows(11 + P, n, P, dtype, alphabet)
    s, winv, is_real = KW.sort_weights_ref(to_torch(items, dtype),
                                           torch.from_numpy(valid))
    js, jwinv, jreal = jax_weights(items, valid, dtype)
    assert (to_numpy(s) == js).all()
    assert (winv.numpy() == jwinv).all()         # padding included
    assert (is_real.numpy() == jreal).all()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("threads, ipt", [(32, 1), (64, 8), (128, 8),
                                          (128, 16), (256, 12), (256, 16),
                                          (512, 12), (512, 16), (512, 32),
                                          (768, 16)])
def test_kernel_walk_matches_the_plain_version(dtype, threads, ipt):
    # tiles of the kind csrc/weights.cu's classes take (whole warps, at
    # most 32 keys a thread): a full tile, a tile short of one position
    # (the sentinel padding past P), and a row well inside the tile; heavy
    # duplicates make runs that cross threads and warps
    tile = threads * ipt
    for P, alphabet in ((tile, 3), (tile - 1, 0), (tile // 3 + 1, 40)):
        items, valid = rows(P, 5, P, dtype, alphabet)
        want = KW.sort_weights_ref(to_torch(items, dtype),
                                   torch.from_numpy(valid))
        s, winv, real = kernel_model(items, valid, threads, ipt, dtype)
        assert (s == to_numpy(want[0])).all(), P
        assert (winv == want[1].numpy()).all(), P
        assert (real == want[2].numpy()).all(), P


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n, P, alphabet", [(8, 37, 6), (6, 300, 0),
                                            (5, 129, 2), (4, 1, 0),
                                            (5, 200, 1), (3, 1500, 3),
                                            (40, 60, 9)],
                         ids=["duplicates", "distinct", "two_values",
                              "one_position", "one_value", "long_runs",
                              "many_rows"])
def test_wide_route_matches_the_plain_version(dtype, n, P, alphabet):
    items, valid = rows(23 + P, n, P, dtype, alphabet)
    want = KW.sort_weights_ref(to_torch(items, dtype),
                               torch.from_numpy(valid))
    s, winv, real = wide_model(items, valid, dtype)
    assert (s == to_numpy(want[0])).all()
    assert (winv == want[1].numpy()).all()       # padding included
    assert (real == want[2].numpy()).all()
