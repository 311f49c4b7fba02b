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
The plain versions state this order directly (the largest e, then the
smallest payload among equal e); the kernels pack it into one u64 key.

The device of the inputs picks the implementation: a CUDA tensor launches
the hand-written kernel of csrc/tournament.cu (built on first use by
_build.py), cut into tiles by :func:`plan`, or raises; a CPU tensor runs
the plain PyTorch version (``*_ref``), which is also what the kernels are
checked against on the card.  u32 data crosses this boundary as int32 bit
patterns.

K1 takes ``ln(u)`` of a weight-1 draw only when its hash reaches an exact
threshold (csrc/tournament.cu).  While ``obs.sink`` is set, each K1 launch
reports two counters as device scalars: ``sketch.k1_logf``, the draws
whose ``ln(u)`` it took, and ``sketch.k1_exact_steps``, the warp steps (two
positions of each lane) of its weight-1 sweep where some lane's draw
passed its threshold.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from .. import obs
from .bitops import M32, i32_to_u32, s64, shr64
from .rng import splitmix64

_GOLDEN64 = 0x9E3779B97F4A7C15
# [rows, positions, slots] elements per step of the plain versions: the
# int64 hash, f32 draw and int64 candidate temporaries stay near 256 MB
_PLAIN_CHUNK = 1 << 23

# kernel launches by the wrappers (not by the plain versions)
launches_u32 = 0
launches_u64 = 0


def slot_consts(m: int, seed: int = 0, device="cuda") -> torch.Tensor:
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


# ---------------------------------------------------------------------------
# the work plan of the kernels
# ---------------------------------------------------------------------------

# the kernels' constants (csrc/tournament.cu): threads per block, staged
# (row, position) entries per chunk, (row, slot) keys per tile, slots a
# thread sweeps together
_THREADS, _STAGE, _MAX_PAIRS, _GROUP = 256, 2048, 1024, 8
_WAVES = 8               # tiles per resident block wanted before splitting
_MIN_SPAN = 512          # fewest positions of a split row per tile
_MIN_UNITS = 3 * _THREADS  # units per tile wanted
_MIN_SWEEP = 8           # fewest positions per (row, slot group, subset) unit


@dataclasses.dataclass(frozen=True)
class Plan:
    """How the kernels cut an [n, P] x m tournament into tiles.  A tile is
    ``rows`` rows x ``span`` positions x ``slots`` slots; tile t is
    ((row group * spans) + span index) * slot_groups + slot group.  Its
    positions are staged ``chunk`` at a time, and each (row, group of
    _GROUP slots) is swept as ``sub`` interleaved position subsets.  Rows
    are split (their keys meet in a scratch) when ``spans`` > 1."""
    rows: int
    slots: int
    span: int
    chunk: int
    sub: int
    row_groups: int
    spans: int
    slot_groups: int

    @property
    def tiles(self) -> int:
        return self.row_groups * self.spans * self.slot_groups

    @property
    def split(self) -> bool:
        return self.spans > 1


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=256)
def plan(n: int, P: int, m: int, sms: int = 132, per_sm: int = 4) -> Plan:
    """The tile plan for ``sms`` streaming multiprocessors holding
    ``per_sm`` blocks each: as many short rows per tile as the staging and
    key buffers hold; the positions of a row split over spans of at least
    _MIN_SPAN until the tiles make _WAVES waves (a tile's time is then a
    small share of the whole, so the last wave leaves the card little idle
    time); and the fewest position subsets that give a block _MIN_UNITS
    units, each still sweeping _MIN_SWEEP positions."""
    slots = max(1, min(m, _MAX_PAIRS))
    slot_groups = _cdiv(m, slots)
    rows = max(1, min(n, _STAGE // max(P, 1), _MAX_PAIRS // slots))
    chunk = _STAGE // rows
    row_groups = _cdiv(n, rows)
    whole = row_groups * slot_groups
    want = _WAVES * sms * per_sm
    spans = 1
    if 0 < whole < want and P > _MIN_SPAN:
        spans = min(_cdiv(P, _MIN_SPAN), _cdiv(want, whole))
    span = _cdiv(P, spans)
    spans = _cdiv(P, span) if P else 1
    groups = rows * _cdiv(slots, _GROUP)
    sweep = max(1, min(chunk, span))
    sub = 1
    while sub * groups < _MIN_UNITS and sub < 256 \
            and sweep // (2 * sub) >= _MIN_SWEEP:
        sub *= 2
    return Plan(rows=rows, slots=slots, span=span, chunk=chunk, sub=sub,
                row_groups=row_groups, spans=spans, slot_groups=slot_groups)


_devices: dict = {}      # (device index, wide, positions) -> (SMs, blocks)
_slotc: dict = {}        # (m, seed, device) -> int32 slot constants


def launch_plan(dev: torch.device, n: int, P: int, m: int, wide: bool,
                pos: bool = False) -> Plan:
    """The plan a launch on CUDA device ``dev`` uses: :func:`plan` with the
    card's SM count and the kernel's resident blocks per SM.  The library
    reports those blocks with its tile constants, which must be this
    module's: the plan and the kernel cut tiles with the same numbers."""
    from .. import _build
    key = (dev.index, wide, pos and not wide)
    if key not in _devices:
        cfg = (ctypes.c_int * 5)()
        with torch.cuda.device(dev):
            err = _build.load().tournament_config(int(wide), int(pos), cfg)
        if err:
            raise RuntimeError(f"tournament occupancy query failed: CUDA "
                               f"error {err}")
        if tuple(cfg[1:]) != (_THREADS, _STAGE, _MAX_PAIRS, _GROUP):
            raise RuntimeError(f"csrc/tournament.cu's tile constants "
                               f"{tuple(cfg[1:])} != (_THREADS, _STAGE, "
                               f"_MAX_PAIRS, _GROUP) here")
        _devices[key] = (torch.cuda.get_device_properties(dev)
                         .multi_processor_count, cfg[0])
    return plan(n, P, m, *_devices[key])


@functools.lru_cache(maxsize=256)
def _c_plan(pl: Plan):
    """``pl`` as the C struct launch_tournament takes."""
    from .. import _build
    return _build.TournamentPlan(
        tiles=pl.tiles, rows=pl.rows, slots=pl.slots, span=pl.span,
        chunk=pl.chunk, sub=pl.sub, spans=pl.spans,
        slot_groups=pl.slot_groups)


def _launch(wide: bool, a, b, winv, m: int, seed: int, pos: bool, outs):
    from .. import _build
    lib = _build.load()
    n, P = a.shape
    dev = a.device
    pl = launch_plan(dev, n, P, m, wide, pos)
    if (m, seed, dev) not in _slotc:
        _slotc[(m, seed, dev)] = slot_consts(m, seed, dev).to(torch.int32)
    slotc = _slotc[(m, seed, dev)]
    scratch = torch.empty((n, m), dtype=torch.int64, device=dev) \
        if pl.split else None
    counts = torch.zeros(2, dtype=torch.int64, device=dev) \
        if obs.sink is not None and not wide else None
    ptr = (lambda t: None if t is None else t.data_ptr())
    _build.launch(lib.launch_tournament, int(wide), a.data_ptr(), ptr(b),
                  winv.data_ptr(), slotc.data_ptr(), outs[0].data_ptr(),
                  ptr(outs[1]), ptr(scratch), n, P, m, int(pos),
                  ctypes.byref(_c_plan(pl)), ptr(counts), device=dev)
    if counts is not None:
        obs.count("sketch.k1_logf", counts[0])
        obs.count("sketch.k1_exact_steps", counts[1])


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
    out = torch.empty((items.shape[0], m), dtype=torch.int32, device=dev)
    _launch(False, items, None, winv, m, seed, return_positions, (out, None))
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
    out_lo = torch.empty((lo.shape[0], m), dtype=torch.int32, device=dev)
    out_hi = torch.empty_like(out_lo)
    _launch(True, lo, hi, winv, m, seed, True, (out_lo, out_hi))
    launches_u64 += 1
    return out_lo, out_hi


def unit_logs(device) -> torch.Tensor:
    """float32[2^24]: K1's weight-1 draw ln((t + 1) * 2^-24) for every
    t = h >> 8, computed by the kernels' own logf on CUDA ``device``."""
    from .. import _build
    dev = torch.device(device)
    out = torch.empty(1 << 24, dtype=torch.float32, device=dev)
    _build.launch(_build.load().tournament_threshold_probe, None, None,
                  out.data_ptr(), out.numel(), device=dev)
    return out


def unit_thresholds(e: torch.Tensor) -> torch.Tensor:
    """int64[k]: for each draw e (float32[k] on CUDA, each <= 0) K1's
    threshold, the smallest t in [0, 2^24) with unit_logs()[t] >= e."""
    from .. import _build
    e = e.contiguous()
    out = torch.empty(e.shape, dtype=torch.int32, device=e.device)
    _build.launch(_build.load().tournament_threshold_probe, e.data_ptr(),
                  out.data_ptr(), None, e.numel(), device=e.device)
    return out.to(torch.int64) & M32


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
