"""Anchors: per-window invertible-MinHash signatures of reads, and their
key-value export.

Port of kmerutils_tpu/anchor.py.  Each read is cut into sliding windows
(step = window - overlap); every window gets the bottom-``nbkmer``
invertible MinHash of its forward (not canonical) k-mers; anchors persist to
a key-value store with the same key and value strings.  All windows of a
batch are rows of one [n_windows, window] k-mer matrix sketched in one call
on the batch's device (sketch/minhash.py).

Deliberate differences from the JAX package:

* ``anchor_computation`` reads length-sorted batches (``read_batches``'
  default; the JAX version reads ``bucket=False``), so a row's read number
  comes from the batch's ``read_indices`` and
  ``anchor_computation`` returns (and dumps) the anchors ordered by read
  number, then slice position: the JAX order, which its file-order batches
  give;
* ``SliceAnchor.from_value_string`` of an empty string (an anchor whose
  window holds no k-mer) gives an anchor with an empty minhash; the JAX
  version raises on it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .base import kmer as kmer_mod
from .base.sequence import ReadBatch
from .sketch import minhash

# the key schema
FN_KEY = "prop:fn"
PROCESS_KEY = "prop:fn:process"
NB_BASES_KEY = "prop:fn:process:bases"
SLICE_SIZE_KEY = "prop:fn:process:ssize"
POS_KEY = "prop:fn:process:readnum:slicepos"
MINHASH_1 = "prop:fn:process:minhash_1"
MINHASH_2 = "prop:fn:process:minhash_2"
SLICE_ANCHOR_KEY = "prop:fn:process:ssize:bases:readnum:slicepos"


@dataclasses.dataclass(frozen=True)
class AnchorsGeneratorParameters:
    fasta_name: str
    window: int
    nbkmer: int
    kmer_size: int
    overlap: int

    def __post_init__(self):
        if self.window <= self.overlap or self.window <= 0:
            raise ValueError("window must exceed overlap (anchor.rs:295-296)")


@dataclasses.dataclass
class SliceAnchor:
    """(readnum, slicepos) and the window's bottom-k (hash, count) pairs."""
    readnum: int
    slicepos: int
    minhash: list[tuple[int, int]]  # (invertible hash, count)

    def value_string(self) -> str:
        """'h,c:h,c:...'"""
        return ":".join(f"{h},{c}" for h, c in self.minhash)

    @staticmethod
    def from_value_string(readnum: int, slicepos: int, s: str
                          ) -> "SliceAnchor":
        pairs = []
        for couple in s.split(":") if s else ():
            h, c = couple.split(",")
            pairs.append((int(h), int(c)))
        return SliceAnchor(readnum, slicepos, pairs)

    def key_string(self, params: AnchorsGeneratorParameters,
                   process: str = "anchor") -> str:
        return (f"{params.fasta_name}:{process}:{params.window}:"
                f"{params.kmer_size}:{self.readnum}:{self.slicepos}")


def compute_anchors(batch: ReadBatch, params: AnchorsGeneratorParameters,
                    read_num_offset: int = 0, read_nums=None
                    ) -> list[SliceAnchor]:
    """Every sliding-window anchor of a batch, in one sketch call on the
    batch's device.  Row r is read ``read_nums[r]`` when given (a batch's
    ``read_indices``), else ``read_num_offset + r``; anchors come ordered
    by read number, then slice position."""
    k = params.kmer_size
    wide = k > 16
    if wide:
        km, valid = kmer_mod.kmers_u64(batch, k)
    else:
        km, valid = kmer_mod.kmers_u32(batch, k)
    n, P = km.shape
    step = params.window - params.overlap
    lengths = batch.lengths.cpu().numpy().astype(np.int64)
    max_w = max(1, -(-int(lengths.max(initial=1)) // step))
    # window w covers k-mer positions [w * step, w * step + window)
    idx = (torch.arange(max_w, device=km.device)[:, None] * step
           + torch.arange(params.window, device=km.device)[None, :])
    idx_c = idx.clamp(max=P - 1)
    km_f = km[:, idx_c].reshape(n * max_w, params.window)
    va_f = (valid[:, idx_c] & (idx < P)[None]).reshape(n * max_w,
                                                       params.window)
    sk, counts = minhash.sketch_items_invhash(km_f, va_f, params.nbkmer,
                                              wide=wide)
    sk = sk.cpu().numpy().view(np.uint64).reshape(n, max_w, -1)
    counts = counts.cpu().numpy().reshape(n, max_w, -1)
    if read_nums is None:
        read_nums = read_num_offset + np.arange(n)
    read_nums = np.asarray(read_nums, dtype=np.int64)
    order = np.argsort(read_nums, kind="stable")
    # windows start at 0, step, ... while the start is inside the read
    live_w = (np.arange(max_w)[None, :] * step) < lengths[order, None]
    slot_ok = sk != minhash.SENTINEL
    out = []
    for r, w in zip(*np.nonzero(live_w)):
        i = order[r]
        m = slot_ok[i, w]
        pairs = list(zip(sk[i, w][m].tolist(), counts[i, w][m].tolist()))
        out.append(SliceAnchor(int(read_nums[i]), int(w) * step, pairs))
    return out


class AnchorStore:
    """Key-value persistence of anchors with the key schema above, in a
    dict of hashes."""

    def __init__(self):
        self.hashes: dict[str, dict[str, str]] = {}

    def hset(self, key: str, field: str, value: str):
        self.hashes.setdefault(key, {})[field] = value

    def dump_anchors(self, params: AnchorsGeneratorParameters,
                     anchors: list[SliceAnchor], process: str = "anchor"):
        """Each anchor under SLICE_ANCHOR_KEY, and the inverse index
        smallest hash -> 'readnum:slicepos' under MINHASH_1."""
        for a in anchors:
            self.hset(SLICE_ANCHOR_KEY, a.key_string(params, process),
                      a.value_string())
            if a.minhash:
                self.hset(MINHASH_1, str(a.minhash[0][0]),
                          f"{a.readnum}:{a.slicepos}")

    def load_anchor(self, params: AnchorsGeneratorParameters, readnum: int,
                    slicepos: int, process: str = "anchor"
                    ) -> SliceAnchor | None:
        key = SliceAnchor(readnum, slicepos, []).key_string(params, process)
        v = self.hashes.get(SLICE_ANCHOR_KEY, {}).get(key)
        if v is None:
            return None
        return SliceAnchor.from_value_string(readnum, slicepos, v)


class RedisAnchorStore(AnchorStore):
    """AnchorStore mirrored to a redis-protocol server (stock redis or
    :class:`kvstore.RespServer`) over RESP.  A bulk dump sends every HSET
    in one pipelined round trip, then BGREWRITEAOF."""

    def __init__(self, host: str = "127.0.0.1", port: int = 6379,
                 db: int = 0):
        from .kvstore import RespClient
        super().__init__()
        self._r = RespClient(host=host, port=port, db=db)

    def hset(self, key: str, field: str, value: str):
        super().hset(key, field, value)
        self._r.hset(key, field, value)

    def load_anchor(self, params: AnchorsGeneratorParameters, readnum: int,
                    slicepos: int, process: str = "anchor"
                    ) -> SliceAnchor | None:
        """Read back through the wire, not the local mirror, so anchors
        persisted by other processes are seen."""
        key = SliceAnchor(readnum, slicepos, []).key_string(params, process)
        v = self._r.hget(SLICE_ANCHOR_KEY, key)
        if v is None:
            return None
        return SliceAnchor.from_value_string(readnum, slicepos, v)

    def dump_anchors(self, params, anchors, process: str = "anchor"):
        from .kvstore import RespError
        cmds = []
        for a in anchors:
            key, val = a.key_string(params, process), a.value_string()
            AnchorStore.hset(self, SLICE_ANCHOR_KEY, key, val)
            cmds.append(("HSET", SLICE_ANCHOR_KEY, key, val))
            if a.minhash:
                inv_f, inv_v = str(a.minhash[0][0]), \
                    f"{a.readnum}:{a.slicepos}"
                AnchorStore.hset(self, MINHASH_1, inv_f, inv_v)
                cmds.append(("HSET", MINHASH_1, inv_f, inv_v))
        if cmds:
            self._r.pipeline(cmds)
        try:
            self._r.bgrewriteaof()
        except RespError:
            pass  # a server without an append-only file is fine

    def close(self):
        self._r.close()


def anchor_computation(fasta_path: str, params: AnchorsGeneratorParameters,
                       store: AnchorStore | None = None, device="cuda"
                       ) -> list[SliceAnchor]:
    """Anchor every pure-ACGT read of a file (reads with another base are
    dropped; read numbers count the kept reads in file order) on
    ``device``, and persist the anchors to ``store`` when given."""
    from .io import fastx
    anchors: list[SliceAnchor] = []
    for batch, read_idx in fastx.read_batches(fasta_path):
        anchors.extend(compute_anchors(batch.to(device), params,
                                       read_nums=read_idx))
    anchors.sort(key=lambda a: (a.readnum, a.slicepos))
    if store is not None:
        store.dump_anchors(params, anchors)
    return anchors
