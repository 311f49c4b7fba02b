"""Exact neighbour search over signatures, and the neighbour table dump.

Port of kmerutils_tpu/ann.py.  Similarity is the fraction of equal slots
(1 - the Hamming distance on sketch slots).  ``brute_force_neighbors`` tiles
queries AND columns, so no [queries, n, m] tensor is ever whole, and keeps a
running top-k per query.  Order is (similarity descending, index ascending),
the order ``jax.lax.top_k`` gives: similarities are multiples of 1/m, so
ties are common, and ``torch.topk`` alone does not promise an order among
equal values.  Each candidate therefore ranks by one distinct int64 key
built from its equal-slot count and its column.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

NEIGHBOR_MAGIC = 0xCEA7A77D
# elements of one [queries, columns, m] equality tile
_TILE_ELEMS = 1 << 28


def _fraction(count: torch.Tensor, m: int) -> torch.Tensor:
    """count / m as JAX's float32 mean computes it: count times the float32
    reciprocal of m (not a division: 5 / 6 differs in the last bit)."""
    inv = torch.tensor(1.0 / m, dtype=torch.float32, device=count.device)
    return count.to(torch.float32) * inv


def hamming_similarity_block(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Fraction of equal slots for every pair: a [na, m], b [nb, m] ->
    float32[na, nb]."""
    eq = (a[:, None, :] == b[None, :, :]).sum(dim=-1, dtype=torch.int32)
    return _fraction(eq, a.shape[1])


def brute_force_neighbors(sigs, nbng: int, block: int = 1024,
                          exclude_self: bool = True):
    """Top-``nbng`` neighbours of every row of ``sigs`` (a tensor, computed
    on its device, or a numpy array, computed on the CPU) by similarity.

    Returns numpy (neighbors int32[n, nbng], similarity float32[n, nbng]);
    with ``exclude_self`` a row's own column scores -1 and nbng is at most
    n - 1."""
    if not isinstance(sigs, torch.Tensor):
        sigs = torch.from_numpy(np.ascontiguousarray(sigs))
    n, m = sigs.shape
    nbng = min(nbng, n - 1 if exclude_self else n)
    all_nn = np.zeros((n, nbng), dtype=np.int32)
    all_sim = np.zeros((n, nbng), dtype=np.float32)
    if nbng <= 0:
        return all_nn, all_sim
    cols_per_tile = max(nbng, _TILE_ELEMS // max(1, block * m))
    for q0 in range(0, n, block):
        q = sigs[q0 : q0 + block]
        rows = torch.arange(q0, q0 + q.shape[0], device=sigs.device)
        best = None
        for c0 in range(0, n, cols_per_tile):
            c = sigs[c0 : c0 + cols_per_tile]
            cnt = (q[:, None, :] == c[None, :, :]).sum(dim=-1,
                                                         dtype=torch.int64)
            col = torch.arange(c0, c0 + c.shape[0], device=sigs.device)
            if exclude_self:
                cnt = torch.where(rows[:, None] == col[None, :], -1, cnt)
            # distinct keys: higher count first, then the lower column
            key = ((cnt + 1) << 32) | ((1 << 32) - 1 - col)[None, :]
            if best is not None:
                key = torch.cat([best, key], dim=1)
            best = torch.topk(key, min(nbng, key.shape[1]), dim=1).values
        col = ((1 << 32) - 1) - (best & 0xFFFFFFFF)
        cnt = (best >> 32) - 1
        sim = torch.where(cnt < 0, -1.0, _fraction(cnt, m))
        all_nn[q0 : q0 + q.shape[0]] = col.to(torch.int32).cpu().numpy()
        all_sim[q0 : q0 + q.shape[0]] = sim.cpu().numpy()
    return all_nn, all_sim


def write_neighbor_dump(fname: str, neighbors, similarities) -> None:
    """Binary neighbour table: u32 magic | u32 n | u32 nbng | per read:
    (u32 neighbour, f32 similarity) * nbng."""
    nn = np.asarray(neighbors, dtype=np.uint32)
    sim = np.asarray(similarities, dtype=np.float32)
    n, k = nn.shape
    rec = np.zeros((n, k), dtype=[("i", "<u4"), ("s", "<f4")])
    rec["i"] = nn
    rec["s"] = sim
    with open(fname, "wb") as f:
        f.write(struct.pack("<III", NEIGHBOR_MAGIC, n, k))
        f.write(rec.tobytes())


def read_neighbor_dump(fname: str):
    """-> (neighbors u32[n, nbng], similarity f32[n, nbng])."""
    with open(fname, "rb") as f:
        magic, n, k = struct.unpack("<III", f.read(12))
        if magic != NEIGHBOR_MAGIC:
            raise ValueError("bad magic for neighbor dump")
        rec = np.frombuffer(f.read(), dtype=[("i", "<u4"), ("s", "<f4")])
    rec = rec.reshape(n, k)
    return rec["i"].copy(), rec["s"].copy()
