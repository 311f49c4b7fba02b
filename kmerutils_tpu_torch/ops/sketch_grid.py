"""The grid reductions of SuperMinHash (SUPER2) and SetSketch (HLL): CUDA
kernels and their plain versions.

The JAX package writes both sketches as one reduction over the [n, P, m]
grid of (read, position, slot), which XLA fuses so that the grid never
reaches device memory (kmerutils_tpu/sketch/superminhash.py::superminhash2,
kmerutils_tpu/sketch/setsketch.py::setsketch_signatures).  These are the
port's own kernels for that reduction; they replace no Pallas kernel.

* G1 :func:`grid_min`: per (row, slot j) the unsigned minimum, over the
  row's valid positions p, of SUPER2's packed key ``pi << u_bits | u``:
  pi is slot j under the position's keyed permutation of [0, m) (key
  ``(a_p, b_p)``, :func:`encrypt_pow2` cycle-walked :data:`WALKS` more
  times, then clamped to m - 1) and u is the top u_bits of a 32-bit mix of
  ``x_p ^ slotc[j]``; ``u_bits = 32 - perm_bits(m)``.  Rows without a
  valid position give 0xFFFFFFFF.
* G2 :func:`grid_max`: per (row, register j) the unsigned maximum over the
  valid positions of ``h = mix(x_p ^ salts[j])`` (x * 0x9E3779B1,
  ^ >> 15, * 0x85EBCA77).  Rows without a valid position give 0.

Both kernels take the same tile plan (:func:`plan`), each at its own slots
a thread: a thread holds several slots in registers and reads each staged
position once for all of them.  G2 reads :data:`_G2_VEC` consecutive staged
positions a shared load; the position subsets own whole such groups, and
copies of a staged position fill a chunk's last group (exact, as a maximum
is idempotent).

u32 data crosses this boundary as int32 bit patterns: x, a, b int32[n, P],
valid bool[n, P], slotc / salts int32[m], results int32[n, m].  The device
of the inputs picks the implementation: a CUDA tensor launches the
hand-written kernel of csrc/sketch.cu (built on first use by _build.py), or
raises; a CPU tensor runs the plain PyTorch version (``*_ref``), which is
also what the kernels are checked against on the card.

While ``obs.sink`` is set, each G1 launch reads the counter
``sketch.g1_split`` (:func:`count_split`): its n x P where the plan splits
rows over several spans, whose tiles each load the slot constants again
and end in m global atomicMin, else 0.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from .. import obs
from .bitops import M32

WALKS = 4                # cycle-walk rounds after the first encryption
# [rows, positions, slots] elements per step of the plain versions: the
# int64 temporaries of one step stay near 64 MB each
_PLAIN_CHUNK = 1 << 23

# the kernels' constants (csrc/sketch.cu): threads per block at most and
# slots a group at most (both kernels); G1's slots a thread and positions
# staged per step; G2's slots a thread, staged positions a shared load and
# positions staged per step
_THREADS, _MAX_GROUP = 256, 2048
G1_SLOTS_PER_THREAD, _G1_CHUNK = 8, 1024
G2_SLOTS_PER_THREAD, _G2_VEC, _G2_CHUNK = 4, 4, 2048
_WANT_TILES = 32         # tiles per SM wanted before a row is split
_MIN_SPAN = 512          # fewest positions of a split row per tile

# kernel launches by the wrappers (not by the plain versions)
launches_min = 0         # G1
launches_max = 0         # G2


def perm_bits(m: int) -> int:
    """Bits of the power-of-two domain that holds [0, m)."""
    return max((m - 1).bit_length(), 1)


def encrypt_pow2(x: torch.Tensor, a_odd: torch.Tensor, b: torch.Tensor,
                 nbits: int) -> torch.Tensor:
    """Keyed bijection of [0, 2^nbits) on u32 values in int64: an odd
    multiply and an xor, then an xorshift, each step bijective mod
    2^nbits (the multiply may wrap int64; its low bits are right)."""
    mask = (1 << nbits) - 1
    x = ((x * a_odd) ^ b) & mask
    return (x ^ (x >> max(nbits // 2, 1))) & mask


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or t.device != device or not t.is_contiguous():
        raise ValueError(f"{name}: want contiguous {dtype}{list(shape)} on "
                         f"{device}, got {t.dtype}{list(t.shape)} on "
                         f"{t.device} (contiguous={t.is_contiguous()})")


def _check_inputs(xs, valid, slotc) -> torch.device:
    if xs[0].dim() != 2:
        raise ValueError("x must be [n, P]")
    dev = xs[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    for i, t in enumerate(xs):
        _check(f"input {i}", t, torch.int32, xs[0].shape, dev)
    _check("valid", valid, torch.bool, xs[0].shape, dev)
    if slotc.dim() != 1 or not 1 <= slotc.shape[0] < 1 << 31:
        raise ValueError("slot constants must be [m] with m >= 1")
    _check("slot constants", slotc, torch.int32, slotc.shape, dev)
    return dev


# ---------------------------------------------------------------------------
# the work plan of the kernel
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Plan:
    """A tile is one row x ``span`` positions x a group of ``slots``
    slots.  A slot set of ``slots / per_thread`` threads holds the group,
    ``per_thread`` slots a thread: thread t of a block (``subsets`` slot
    sets, rounded up to a warp) holds slots ``t % T + r * T``, r <
    per_thread (T = :attr:`threads_per_set`), and position subset t // T.
    G1 holds :data:`G1_SLOTS_PER_THREAD` slots a thread, G2
    :data:`G2_SLOTS_PER_THREAD`."""
    slots: int
    per_thread: int
    subsets: int
    span: int
    spans: int
    groups: int

    @property
    def threads_per_set(self) -> int:
        return self.slots // self.per_thread


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=256)
def plan(n: int, P: int, m: int, sms: int = 132, *,
         per_thread: int) -> Plan:
    """The tile plan: groups of up to min(256 x per_thread, 2048) slots
    held by ceil(group / per_thread) threads, as many position subsets as
    fill 256 threads, and a row's positions split over spans of at least
    _MIN_SPAN when whole rows give fewer than _WANT_TILES tiles per SM."""
    per_set = _cdiv(min(m, _THREADS * per_thread, _MAX_GROUP), per_thread)
    slots = per_set * per_thread
    subsets = _THREADS // per_set
    groups = _cdiv(m, slots)
    whole = n * groups
    want = _WANT_TILES * sms
    spans = 1
    if 0 < whole < want and P > _MIN_SPAN:
        spans = min(_cdiv(P, _MIN_SPAN), _cdiv(want, whole))
    span = max(1, _cdiv(P, spans))
    return Plan(slots=slots, per_thread=per_thread, subsets=subsets,
                span=span, spans=_cdiv(P, span) if P else 1, groups=groups)


_config: dict = {}       # device index -> SM count (constants checked)


def library_config(lib) -> tuple:
    """csrc/sketch.cu's constants in a built library (sketch_grid_config):
    threads, G2's chunk, G1's slots a thread, G1's chunk, the largest
    group, G2's slots a thread, G2's positions a shared load."""
    cfg = (ctypes.c_int * 7)()
    lib.sketch_grid_config(cfg)
    return tuple(cfg)


def launch_plan(dev: torch.device, n: int, P: int, m: int,
                per_thread: int = 1) -> Plan:
    """:func:`plan` with the card's SM count; the library's constants must
    be this module's."""
    from .. import _build
    if dev.index not in _config:
        want = (_THREADS, _G2_CHUNK, G1_SLOTS_PER_THREAD, _G1_CHUNK,
                _MAX_GROUP, G2_SLOTS_PER_THREAD, _G2_VEC)
        got = library_config(_build.load())
        if got != want:
            raise RuntimeError(f"csrc/sketch.cu's constants {got} != {want} "
                               f"here")
        _config[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return plan(n, P, m, _config[dev.index], per_thread=per_thread)


def grid_min(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
             valid: torch.Tensor, slotc: torch.Tensor) -> torch.Tensor:
    """G1.  x int32[n, P] (u32 folds of the items), a, b int32[n, P] (the
    positions' permutation keys, a odd), valid bool[n, P], slotc int32[m]
    -> int32[n, m]: per slot the smallest packed key (u32 bit patterns)."""
    global launches_min
    dev = _check_inputs((x, a, b), valid, slotc)
    if dev.type == "cpu":
        return grid_min_ref(x, a, b, valid, slotc)
    from .. import _build
    n, P = x.shape
    m = slotc.shape[0]
    out = torch.full((n, m), -1, dtype=torch.int32, device=dev)
    pl = launch_plan(dev, n, P, m, G1_SLOTS_PER_THREAD)
    count_split(n, P, pl)
    _build.launch(_build.load().launch_grid_min, *(t.data_ptr() for t in (
        x, a, b, valid, slotc, out)), n, P, m, pl.threads_per_set,
        pl.subsets, pl.span, device=dev)
    launches_min += 1
    return out


def count_split(n: int, P: int, pl: Plan) -> None:
    """Counter ``sketch.g1_split`` of one G1 launch of n rows of P
    positions under plan ``pl``: n x P where it splits rows over spans,
    else 0; nothing while ``obs.sink`` is None."""
    obs.count("sketch.g1_split", n * P if pl.spans > 1 else 0)


def grid_max(x: torch.Tensor, valid: torch.Tensor,
             salts: torch.Tensor) -> torch.Tensor:
    """G2.  x int32[n, P] (u32 folds of the items), valid bool[n, P],
    salts int32[m] -> int32[n, m]: per register the largest hash (u32 bit
    patterns)."""
    global launches_max
    dev = _check_inputs((x,), valid, salts)
    if dev.type == "cpu":
        return grid_max_ref(x, valid, salts)
    from .. import _build
    n, P = x.shape
    m = salts.shape[0]
    out = torch.zeros((n, m), dtype=torch.int32, device=dev)
    pl = launch_plan(dev, n, P, m, G2_SLOTS_PER_THREAD)
    _build.launch(_build.load().launch_grid_max, *(t.data_ptr() for t in (
        x, valid, salts, out)), n, P, m, pl.threads_per_set, pl.subsets,
        pl.span, device=dev)
    launches_max += 1
    return out


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def _chunks(n: int, P: int, m: int):
    """(row slice, position slice, slot slice) steps of at most
    ~_PLAIN_CHUNK grid elements (one of each at least)."""
    ns = min(m, 256)
    np_ = max(1, min(P, _PLAIN_CHUNK // ns))
    nr = max(1, _PLAIN_CHUNK // (np_ * ns))
    for r0 in range(0, n, nr):
        for p0 in range(0, P, np_):
            for s0 in range(0, m, ns):
                yield (slice(r0, min(n, r0 + nr)), slice(p0, min(P, p0 + np_)),
                       slice(s0, min(m, s0 + ns)))


def super_keys(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
               j: torch.Tensor, sc: torch.Tensor, m: int) -> torch.Tensor:
    """SUPER2's packed keys [r, p, s] of positions (x, a, b: u32 values in
    int64[r, p]) and slots (j, sc: int64[s])."""
    nbits = perm_bits(m)
    a3, b3 = a[:, :, None], b[:, :, None]
    pi = encrypt_pow2(j, a3, b3, nbits)
    for _ in range(WALKS):
        pi = torch.where(pi >= m, encrypt_pow2(pi, a3, b3, nbits), pi)
    pi = pi.clamp(max=m - 1)
    h = ((x[:, :, None] ^ sc) * 0x85EBCA77) & M32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE3D) & M32
    h = h ^ (h >> 16)
    return ((pi << (32 - nbits)) | (h >> nbits)) & M32


def hll_hashes(x: torch.Tensor, salts: torch.Tensor) -> torch.Tensor:
    """SetSketch's u32 hashes [r, p, s] of x (u32 values in int64[r, p])
    against salts (int64[s])."""
    h = ((x[:, :, None] ^ salts) * 0x9E3779B1) & M32
    h = h ^ (h >> 15)
    return (h * 0x85EBCA77) & M32


def _reduce(x, valid, slotc, is_min: bool, value) -> torch.Tensor:
    n, P = x.shape
    m = slotc.shape[0]
    ident = M32 if is_min else 0
    out = torch.full((n, m), ident, dtype=torch.int64, device=x.device)
    for rs, ps, ss in _chunks(n, P, m):
        v = value(rs, ps, ss)
        v = torch.where(valid[rs, ps, None], v, ident)
        red = v.amin(dim=1) if is_min else v.amax(dim=1)
        out[rs, ss] = torch.minimum(out[rs, ss], red) if is_min \
            else torch.maximum(out[rs, ss], red)
    return out.to(torch.int32)


def grid_min_ref(x, a, b, valid, slotc) -> torch.Tensor:
    """Plain version of :func:`grid_min` (same I/O), computed in (row,
    position, slot) chunks with a running minimum."""
    _check_inputs((x, a, b), valid, slotc)
    m = slotc.shape[0]
    xs, as_, bs = (t.to(torch.int64) & M32 for t in (x, a, b))
    sc = slotc.to(torch.int64) & M32
    j = torch.arange(m, dtype=torch.int64, device=x.device)
    return _reduce(x, valid, slotc, True, lambda rs, ps, ss: super_keys(
        xs[rs, ps], as_[rs, ps], bs[rs, ps], j[ss], sc[ss], m))


def grid_max_ref(x, valid, salts) -> torch.Tensor:
    """Plain version of :func:`grid_max` (same I/O)."""
    _check_inputs((x,), valid, salts)
    xs = x.to(torch.int64) & M32
    sl = salts.to(torch.int64) & M32
    return _reduce(x, valid, salts, False,
                   lambda rs, ps, ss: hll_hashes(xs[rs, ps], sl[ss]))
