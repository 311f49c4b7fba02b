"""The k-mer prefix of counting (KC): packed words to the batch's valid
canonical k-mers, compacted at the rows' offsets and ready for the batch
sort.

The JAX package writes this prefix as plain array code
(kmerutils_tpu/count/stream.py::batch_entries over base/kmer.py's
``canonical_kmers``) and XLA fuses it; eager PyTorch would run it as some
thirty int64 passes over [n, P] and a selection of the valid positions.
This is the port's own kernel for it (csrc/kmers.cu, beside KP); it
replaces no Pallas kernel.

:func:`count_prefix` takes a batch's words int32[n, W] (u32 bit patterns,
16 bases a word, the slack word last), its lengths int32[n], k and the
rows' output offsets int64[n + 1] on the host (:func:`offsets`: the
exclusive prefix of max(length - k + 1, 0), the total last) and gives one
entry per valid position (p + k <= length), row by row:

* keys: the canonical k-mer, unhashed, in the sort's form: int32 u32 bit
  patterns with the top bit flipped for k <= 16 (``bitops.flip32``),
  int64 u64 bit patterns with the top bit flipped above
  (``bitops.flip64``), so that a signed sort gives the unsigned order;
* flat: with coordinates, the entry's index row * P + p in [n, P] (int64,
  P = max(16 (W - 1) - k + 1, 1)), else None.

The device of the words picks the implementation: a CUDA tensor launches
the hand-written kernel (built on first use by _build.py), after one copy
of the offsets from pinned memory and no read of the device, or raises; a
CPU tensor runs the plain PyTorch version :func:`count_prefix_ref`, which
is also what the kernel is checked against on the card.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..base import kmer as kmer_mod
from ..base.sequence import ReadBatch
from .bitops import flip32, flip64, u32_to_i32
from .kmer_prefix import positions

# the kernel's constants (csrc/kmers.cu): threads per block, outputs a
# thread writes together
_THREADS, _VEC = 256, 4
_TILE = _THREADS * _VEC   # outputs a block takes at a time
_MAX_BLOCKS = 1 << 20     # blocks at most; a grid-stride loop does the rest

# kernel launches by the wrapper (not by the plain version)
launches_count_prefix = 0

_checked = False          # csrc/kmers.cu's constants checked against ours


def offsets(lengths, k: int) -> torch.Tensor:
    """The rows' output offsets, int64[n + 1] on the host, from lengths in
    host memory (a tensor or an array): offsets[r] = the sum over the rows
    before r of max(length - k + 1, 0), offsets[n] = all of them."""
    cnt = np.asarray(lengths, np.int64) - (k - 1)
    out = np.zeros(cnt.size + 1, np.int64)
    np.cumsum(np.maximum(cnt, 0, out=cnt), out=out[1:])
    return torch.from_numpy(out)


def upload(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """A host tensor on ``dev`` with no wait for the device: through pinned
    memory, which the caching host allocator keeps until the copy has
    run."""
    if dev.type == "cpu":
        return t
    return t.pin_memory().to(dev, non_blocking=True)


def blocks(total: int, max_blocks: int = _MAX_BLOCKS) -> int:
    """The kernel's grid for ``total`` outputs: tiles of :data:`_TILE`
    consecutive outputs (the last one shorter), one a block; block b takes
    tiles b, b + blocks, ..."""
    return max(1, min(-(-total // _TILE), max_blocks))


def _check(words: torch.Tensor, lengths: torch.Tensor, k: int,
           offs: torch.Tensor) -> None:
    if not 1 <= k <= 32:
        raise ValueError(f"k must be in [1, 32], got {k}")
    if words.dim() != 2 or words.shape[1] < 2:
        raise ValueError("words must be [n, W] with W >= 2 (the slack word "
                         f"last), got {list(words.shape)}")
    dev = words.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    n = words.shape[0]
    for name, t, dt, shape, on in (
            ("words", words, torch.int32, words.shape, dev),
            ("lengths", lengths, torch.int32, (n,), dev),
            ("offsets", offs, torch.int64, (n + 1,), torch.device("cpu"))):
        if t.dtype != dt or tuple(t.shape) != tuple(shape) \
                or t.device != on or not t.is_contiguous():
            raise ValueError(
                f"{name}: want contiguous {dt}{list(shape)} on {on}, got "
                f"{t.dtype}{list(t.shape)} on {t.device} "
                f"(contiguous={t.is_contiguous()})")
    # what keeps the kernel's reads inside the rows: a row has 0 to P
    # outputs
    d = np.diff(offs.numpy())
    if int(offs[0]) != 0 or (d.size and not 0 <= d.min() <= d.max()
                             <= positions(words, k)):
        raise ValueError("offsets must start at 0 and give each row 0 to "
                         f"{positions(words, k)} valid positions")


def count_prefix(words: torch.Tensor, lengths: torch.Tensor, k: int,
                 offs: torch.Tensor, coords: bool = False):
    """KC.  (keys, flat) of words int32[n, W], lengths int32[n] and the
    rows' offsets int64[n + 1] on the host (:func:`offsets` of the same
    lengths): int32 keys for k <= 16, int64 above, in the sort's form;
    flat int64 with ``coords``, else None."""
    global launches_count_prefix, _checked
    _check(words, lengths, k, offs)
    dev = words.device
    if dev.type == "cpu":
        return count_prefix_ref(words, lengths, k, offs, coords)
    from .. import _build
    lib = _build.load()
    if not _checked:
        cfg = (ctypes.c_int * 2)()
        lib.count_prefix_config(cfg)
        if tuple(cfg) != (_THREADS, _VEC):
            raise RuntimeError(f"csrc/kmers.cu's constants {tuple(cfg)} != "
                               f"{(_THREADS, _VEC)} here")
        _checked = True
    n, W = words.shape
    total = int(offs[-1])
    keys = torch.empty(total, dtype=torch.int32 if k <= 16
                       else torch.int64, device=dev)
    flat = torch.empty(total, dtype=torch.int64, device=dev) \
        if coords else None
    on_dev = upload(offs, dev)
    _build.launch(lib.launch_count_prefix, words.data_ptr(),
                  on_dev.data_ptr(), keys.data_ptr(),
                  flat.data_ptr() if coords else None, n, W,
                  positions(words, k), k, total, blocks(total), device=dev)
    launches_count_prefix += 1
    return keys, flat


def count_prefix_ref(words: torch.Tensor, lengths: torch.Tensor, k: int,
                     offs: torch.Tensor, coords: bool = False):
    """Plain version of :func:`count_prefix` (same I/O): the canonical
    k-mers of base/kmer.py where they are valid, in row order.  Raises
    when the offsets do not count the batch's valid positions."""
    _check(words, lengths, k, offs)
    want = offsets(lengths.cpu(), k)
    if not torch.equal(offs, want):
        raise ValueError(f"{int(offs[-1])} valid positions from the "
                         f"offsets, not the batch's lengths' "
                         f"{int(want[-1])}, or not row by row")
    can, valid, _ = kmer_mod.canonical_kmers(ReadBatch(words, lengths), k)
    flat = torch.nonzero(valid.reshape(-1)).squeeze(1)
    keys = can.reshape(-1)[flat]
    keys = flip32(u32_to_i32(keys)) if k <= 16 else flip64(keys)
    return keys, (flat if coords else None)
