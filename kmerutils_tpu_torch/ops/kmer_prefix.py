"""The k-mer prefix of the sketches (KP): packed words to valid, canonical,
hashed items in one pass.

The JAX package writes this prefix as plain array code
(kmerutils_tpu/sketch/jaccard.py::hashed_kmers) and XLA fuses it; eager
PyTorch would run it as some thirty int64 passes over [n, P].  This is the
port's own kernel for it (csrc/kmers.cu); it replaces no Pallas kernel.

:func:`kmer_prefix` takes a batch's words int32[n, W] (u32 bit patterns, 16
bases a word, the slack word last) and lengths int32[n] and gives, for the
P = max(16 (W - 1) - k + 1, 1) positions of each row, the canonical k-mer
through the k-mer hash (``"wang"``: Thomas Wang's hash32shiftmult for
k <= 16, hash64shift above; ``"identity"``: the canonical value) and
whether the k-mer lies inside the read: (items int32[n, P] for k <= 16 or
int64[n, P] above, bit patterns; valid bool[n, P]).  The device of the
inputs picks the implementation: a CUDA tensor launches the hand-written
kernel (built on first use by _build.py), or raises; a CPU tensor runs the
plain PyTorch version :func:`kmer_prefix_ref`, which is also what the
kernel is checked against on the card.
"""

from __future__ import annotations

import ctypes

import torch

from ..base import kmer as kmer_mod
from ..base.sequence import BASES_PER_WORD, ReadBatch
from .bitops import u32_to_i32
from .rng import wang_hash32, wang_hash64

HASHES = ("wang", "identity")

# the kernel's constants (csrc/kmers.cu): threads per block, positions a
# thread writes together
_THREADS, _VEC = 256, 4
_MAX_BLOCKS = 1 << 20     # blocks at most; a grid-stride loop does the rest

# kernel launches by the wrapper (not by the plain version)
launches_prefix = 0

_checked = False          # csrc/kmers.cu's constants checked against ours


def positions(words: torch.Tensor, k: int) -> int:
    """P: the positions of a row of ``words`` [n, W] at k."""
    return max((words.shape[1] - 1) * BASES_PER_WORD - k + 1, 1)


def blocks(n: int, P: int, max_blocks: int = _MAX_BLOCKS) -> int:
    """The kernel's grid for n rows of P positions: the flat output [n * P]
    in groups of :data:`_VEC` positions (the last one shorter when n * P is
    not a multiple), one group a thread; thread t of block b takes groups
    b * _THREADS + t, then every ``blocks * _THREADS`` after."""
    groups = -(-(n * P) // _VEC)
    return max(1, min(-(-groups // _THREADS), max_blocks))


def _check(words: torch.Tensor, lengths: torch.Tensor, k: int,
           hash_name: str) -> None:
    if hash_name not in HASHES:
        raise ValueError(f"unknown kmer hash {hash_name}")
    if not 1 <= k <= 32:
        raise ValueError(f"k must be in [1, 32], got {k}")
    if words.dim() != 2 or words.shape[1] < 2:
        raise ValueError("words must be [n, W] with W >= 2 (the slack word "
                         f"last), got {list(words.shape)}")
    dev = words.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    for name, t, shape in (("words", words, words.shape),
                           ("lengths", lengths, words.shape[:1])):
        if t.dtype != torch.int32 or tuple(t.shape) != tuple(shape) \
                or t.device != dev or not t.is_contiguous():
            raise ValueError(
                f"{name}: want contiguous torch.int32{list(shape)} on {dev}, "
                f"got {t.dtype}{list(t.shape)} on {t.device} "
                f"(contiguous={t.is_contiguous()})")


def kmer_prefix(words: torch.Tensor, lengths: torch.Tensor, k: int,
                hash_name: str = "wang"):
    """KP.  (items [n, P], valid bool[n, P]) of words int32[n, W] and
    lengths int32[n]: int32 (u32) items for k <= 16, int64 (u64) above."""
    global launches_prefix, _checked
    _check(words, lengths, k, hash_name)
    dev = words.device
    if dev.type == "cpu":
        return kmer_prefix_ref(words, lengths, k, hash_name)
    from .. import _build
    lib = _build.load()
    if not _checked:
        cfg = (ctypes.c_int * 2)()
        lib.kmer_prefix_config(cfg)
        if tuple(cfg) != (_THREADS, _VEC):
            raise RuntimeError(f"csrc/kmers.cu's constants {tuple(cfg)} != "
                               f"{(_THREADS, _VEC)} here")
        _checked = True
    n, W = words.shape
    P = positions(words, k)
    items = torch.empty((n, P), dtype=torch.int32 if k <= 16
                        else torch.int64, device=dev)
    valid = torch.empty((n, P), dtype=torch.bool, device=dev)
    _build.launch(lib.launch_kmer_prefix, words.data_ptr(),
                  lengths.data_ptr(), items.data_ptr(), valid.data_ptr(), n,
                  W, P, k, int(hash_name == "wang"), blocks(n, P),
                  device=dev)
    launches_prefix += 1
    return items, valid


def kmer_prefix_ref(words: torch.Tensor, lengths: torch.Tensor, k: int,
                    hash_name: str = "wang"):
    """Plain version of :func:`kmer_prefix` (same I/O): the canonical k-mers
    of base/kmer.py, then the hash."""
    _check(words, lengths, k, hash_name)
    can, valid, _ = kmer_mod.canonical_kmers(ReadBatch(words, lengths), k)
    if hash_name == "wang":
        items = wang_hash32(can) if k <= 16 else wang_hash64(can)
    else:
        items = can
    return (u32_to_i32(items) if k <= 16 else items), valid
