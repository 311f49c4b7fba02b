"""The ProbMinHash weighted tournament: CUDA kernels and their plain versions.

Port of kmerutils_tpu/ops/tournament.py (Pallas kernels K1 and K2).  For
read r and slot s the winner is the position p maximising

    e(p, s) = ln(u) * winv[r, p],  u = ((h >> 8) + 1) * 2^-24,
    h = mix32(x_p ^ slotc[s])

i.e. minimising the exponential draw E = -ln(u) / w_p.  K1 takes u32 items
(x_p = item, ties -> smallest item, or with ``return_positions`` the
position, ties -> first position); K2 takes u64 items as lo/hi halves
(x_p = lo ^ hi, ties -> first position, returns the winner's halves).
Positions with winv <= 0 never win; a row without a valid position gives 0.

The device of the inputs picks the implementation: a CUDA tensor launches
the hand-written kernel of csrc/tournament.cu (built on first use by
_build.py) or raises; a CPU tensor runs the plain PyTorch version
(``*_ref``), which is also what the kernels are checked against on the card.
u32 data crosses this boundary as int32 bit patterns.
"""

from __future__ import annotations

import torch

from .bitops import M32, i32_to_u32, s64, shr64
from .rng import splitmix64

_GOLDEN64 = 0x9E3779B97F4A7C15
# [rows, positions, slots] elements per step of the plain versions: the
# int64 hash, f32 draw and int64 candidate temporaries stay near 256 MB
_PLAIN_CHUNK = 1 << 23

# kernel launches by the wrappers (not by the plain versions)
launches_u32 = 0
launches_u64 = 0


def slot_consts(m: int, seed: int = 0, device="cpu") -> torch.Tensor:
    """Per-slot hash constants, u32 values in int64[m]: the top half of
    splitmix64(arange(m) + seed * golden64), as in the JAX package."""
    off = s64(int(seed) * _GOLDEN64)
    s = splitmix64(torch.arange(m, dtype=torch.int64, device=device) + off)
    return shr64(s, 32)


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or t.device != device or not t.is_contiguous():
        raise ValueError(f"{name}: want contiguous {dtype}{list(shape)} on "
                         f"{device}, got {t.dtype}{list(t.shape)} on "
                         f"{t.device} (contiguous={t.is_contiguous()})")


def _check_inputs(halves, winv, m: int) -> torch.device:
    if halves[0].dim() != 2:
        raise ValueError("items must be [n, P]")
    dev = halves[0].device
    for i, t in enumerate(halves):
        _check(f"items[{i}]", t, torch.int32, halves[0].shape, dev)
    _check("winv", winv, torch.float32, halves[0].shape, dev)
    if m < 0:
        raise ValueError("m must be >= 0")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def weighted_tournament(items: torch.Tensor, winv: torch.Tensor, m: int,
                        seed: int = 0,
                        return_positions: bool = False) -> torch.Tensor:
    """K1.  items int32[n, P] (u32 bit patterns), winv float32[n, P]
    (<= 0 marks invalid) -> int32[n, m]: the winning item per slot (u32 bit
    pattern), or its position with ``return_positions``."""
    global launches_u32
    dev = _check_inputs((items,), winv, m)
    if dev.type == "cpu":
        return weighted_tournament_ref(items, winv, m, seed, return_positions)
    from .. import _build
    lib = _build.load()
    n, P = items.shape
    slotc = slot_consts(m, seed, dev).to(torch.int32)
    out = torch.empty((n, m), dtype=torch.int32, device=dev)
    _build.launch(lib.launch_tournament_u32, items.data_ptr(),
                  winv.data_ptr(), slotc.data_ptr(), out.data_ptr(), n, P, m,
                  int(bool(return_positions)), device=dev)
    launches_u32 += 1
    return out


def weighted_tournament_u64(lo: torch.Tensor, hi: torch.Tensor,
                            winv: torch.Tensor, m: int, seed: int = 0):
    """K2.  lo, hi int32[n, P] (u32 halves of u64 items), winv float32[n, P]
    -> (lo_win, hi_win) int32[n, m], the winning item's halves."""
    global launches_u64
    dev = _check_inputs((lo, hi), winv, m)
    if dev.type == "cpu":
        return weighted_tournament_u64_ref(lo, hi, winv, m, seed)
    from .. import _build
    lib = _build.load()
    n, P = lo.shape
    slotc = slot_consts(m, seed, dev).to(torch.int32)
    out_lo = torch.empty((n, m), dtype=torch.int32, device=dev)
    out_hi = torch.empty((n, m), dtype=torch.int32, device=dev)
    _build.launch(lib.launch_tournament_u64, lo.data_ptr(), hi.data_ptr(),
                  winv.data_ptr(), slotc.data_ptr(), out_lo.data_ptr(),
                  out_hi.data_ptr(), n, P, m, device=dev)
    launches_u64 += 1
    return out_lo, out_hi


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def _chunks(n: int, P: int, m: int):
    """(row slice, slot slice) steps of at most ~_PLAIN_CHUNK elements (one
    row and one slot at least)."""
    ns = max(1, min(m, 64, _PLAIN_CHUNK // max(1, P)))
    nr = max(1, _PLAIN_CHUNK // max(1, P * ns))
    for r0 in range(0, n, nr):
        for s0 in range(0, m, ns):
            yield slice(r0, min(n, r0 + nr)), slice(s0, min(m, s0 + ns))


def _best(x: torch.Tensor, winv: torch.Tensor, sc: torch.Tensor,
          pay: torch.Tensor):
    """Per (row, slot) the smallest payload among the positions with the
    best draw.  x, pay int64[r, P] (u32 values); winv f32[r, P] with a
    valid position in every row; sc int64[s].  Returns int64[r, s]."""
    h = x[:, :, None] ^ sc[None, None, :]
    h = (h * 0x9E3779B1) & M32
    h = h ^ (h >> 15)
    h = (h * 0x85EBCA77) & M32
    # u = (h24 + 1) * 2^-24, both steps exact in f32
    u = (h >> 8).to(torch.float32) * 2.0**-24 + 2.0**-24
    e = torch.log(u) * winv[:, :, None]
    e.masked_fill_(~(winv > 0)[:, :, None], float("-inf"))
    best = e.max(dim=1).values
    cand = torch.where(e == best[:, None, :], pay[:, :, None], 1 << 32)
    return cand.min(dim=1).values


def _live(winv: torch.Tensor):
    """(indices of rows with a valid position, end of the last valid column):
    padding rows and trailing padding columns cannot win, so the plain
    versions skip them (this reads the mask on the host)."""
    ok = winv > 0
    rows = ok.any(dim=1).nonzero()[:, 0]
    cols = ok.any(dim=0).nonzero()
    return rows, (int(cols[-1, 0]) + 1 if cols.numel() else 0)


def weighted_tournament_ref(items: torch.Tensor, winv: torch.Tensor, m: int,
                            seed: int = 0,
                            return_positions: bool = False) -> torch.Tensor:
    """Plain version of :func:`weighted_tournament` (same I/O), computed in
    row x slot chunks so the [rows, P, slots] draws stay small."""
    dev = _check_inputs((items,), winv, m)
    rows, P = _live(winv)
    x = i32_to_u32(items[rows, :P])
    wv = winv[rows, :P]
    sc = slot_consts(m, seed, dev)
    pos = torch.arange(P, dtype=torch.int64, device=dev)
    res = torch.empty((rows.numel(), m), dtype=torch.int64, device=dev)
    for rs, ss in _chunks(rows.numel(), P, m):
        pay = pos.expand(x[rs].shape) if return_positions else x[rs]
        res[rs, ss] = _best(x[rs], wv[rs], sc[ss], pay)
    out = torch.zeros((items.shape[0], m), dtype=torch.int32, device=dev)
    out[rows] = res.to(torch.int32)
    return out


def weighted_tournament_u64_ref(lo: torch.Tensor, hi: torch.Tensor,
                                winv: torch.Tensor, m: int, seed: int = 0):
    """Plain version of :func:`weighted_tournament_u64` (same I/O)."""
    dev = _check_inputs((lo, hi), winv, m)
    rows, P = _live(winv)
    lo_r, hi_r, wv = lo[rows, :P], hi[rows, :P], winv[rows, :P]
    x = i32_to_u32(lo_r ^ hi_r)
    sc = slot_consts(m, seed, dev)
    pos = torch.arange(P, dtype=torch.int64, device=dev)
    res = torch.empty((rows.numel(), m), dtype=torch.int64, device=dev)
    for rs, ss in _chunks(rows.numel(), P, m):
        res[rs, ss] = _best(x[rs], wv[rs], sc[ss], pos.expand(x[rs].shape))
    out_lo = torch.zeros((lo.shape[0], m), dtype=torch.int32, device=dev)
    out_hi = torch.zeros_like(out_lo)
    out_lo[rows] = torch.gather(lo_r, 1, res)
    out_hi[rows] = torch.gather(hi_r, 1, res)
    return out_lo, out_hi
