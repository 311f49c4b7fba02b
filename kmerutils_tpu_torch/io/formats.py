"""Binary dumps, byte-compatible with the JAX package and the reference.

Port of kmerutils_tpu/io/formats.py (all little-endian):

* multiple-kmer dump:
    u32 0xcea2bbff | u8 kmer_size | u8 bytes_per_count | u64 nb_kmers(approx)
    records: kmer-dump, count u8/u16.  Kmer-dump per type:
      k <= 14  -> u32 (value | k<<28)
      k == 16  -> u32 raw
      17..=32  -> u8 k, u64 value
    count >= 2 only.
* unique-kmer dump:
    u32 0xcea2bbdd | u8 kmer_size | u64 nb_kmers
    records: u32 kmer, u32 numseq, u32 numkmer, in scan order.
* signature dump:
    u32 0xceabeadd | u32 sig_size (bytes) | u32 sketch_size | u32 kmer_size
    then the raw signature words of each read, in read order.
* block signature dump:
    u32 0xceabbadd | u32 sig_size (4) | u32 sketch_size | u32 kmer_size
    | u32 block_size, then per read: u32 numseq | u32 n_blocks and per
    block: u32 numseq | u32 block index | u32 signature words.

Readers return numpy arrays and read records to EOF (the header count is
approximate by design); ``KmerCountReload`` wraps the two counting dumps
with the reference's accessors.
"""

from __future__ import annotations

import struct

import numpy as np

COUNTER_MULTIPLE = 0xCEA2BBFF
COUNTER_UNIQUE = 0xCEA2BBDD
MAGIC_SIG_DUMP = 0xCEABEADD
MAGIC_BLOCKSIG_DUMP = 0xCEABBADD


def write_signature_dump(fname: str, kmer_size: int, signatures,
                         sig_size: int | None = None) -> None:
    """signatures: numpy [n_reads, sketch_size] of uint32 or uint64, written
    as words of ``sig_size`` bytes (4 or 8; the array's own width when
    None), cast as numpy's ``astype`` casts."""
    sigs = np.asarray(signatures)
    if sig_size is None:
        sig_size = sigs.dtype.itemsize
    n, m = sigs.shape
    with open(fname, "wb") as f:
        f.write(struct.pack("<IIII", MAGIC_SIG_DUMP, sig_size, m, kmer_size))
        dt = "<u4" if sig_size == 4 else "<u8"
        f.write(np.ascontiguousarray(sigs.astype(dt)).tobytes())


def read_signature_dump(fname: str):
    """-> (kmer_size, sketch_size, signatures [n, m] uint32/uint64)."""
    with open(fname, "rb") as f:
        magic, sig_size, m, kmer_size = struct.unpack("<IIII", f.read(16))
        if magic != MAGIC_SIG_DUMP:
            raise ValueError("bad magic for signature dump")
        dt = "<u4" if sig_size == 4 else "<u8"
        flat = np.frombuffer(f.read(), dtype=dt)
    if m and flat.size % m:
        raise ValueError("truncated signature dump")
    return kmer_size, m, flat.reshape(-1, m).copy()


def write_block_signature_dump(fname: str, kmer_size: int, block_size: int,
                               per_seq_blocks) -> None:
    """per_seq_blocks: list of (numseq, [block signature u32[m], ...])."""
    m = len(per_seq_blocks[0][1][0]) if per_seq_blocks else 0
    with open(fname, "wb") as f:
        f.write(struct.pack("<IIIII", MAGIC_BLOCKSIG_DUMP, 4, m, kmer_size,
                            block_size))
        for numseq, blocks in per_seq_blocks:
            # per read: (numseq, n_blocks), then per block (numseq, j, sig)
            rec = np.empty((len(blocks), 2 + m), dtype="<u4")
            rec[:, 0] = numseq
            rec[:, 1] = np.arange(len(blocks))
            if len(blocks):
                rec[:, 2:] = np.asarray(blocks, dtype="<u4")
            f.write(struct.pack("<II", numseq, len(blocks)))
            f.write(rec.tobytes())


def read_block_signature_dump(fname: str):
    """-> (kmer_size, sketch_size, block_size, list of (numseq,
    [signature u32[m], ...]))."""
    with open(fname, "rb") as f:
        magic, sig_size, m, kmer_size, block_size = struct.unpack(
            "<IIIII", f.read(20))
        if magic != MAGIC_BLOCKSIG_DUMP:
            raise ValueError("bad magic for block signature dump")
        if sig_size != 4:
            raise ValueError("only u32 block signatures supported")
        words = np.frombuffer(f.read(), dtype="<u4")
    out = []
    p = 0
    while p + 2 <= words.size:
        numseq, nb = int(words[p]), int(words[p + 1])
        end = p + 2 + nb * (2 + m)
        if end > words.size:
            raise ValueError("truncated block signature dump")
        rec = words[p + 2 : end].reshape(nb, 2 + m)
        out.append((numseq, [r.copy() for r in rec[:, 2:]]))
        p = end
    return kmer_size, m, block_size, out


def _kmer_record_dtype(k: int):
    if k <= 14:
        return "u32_tagged"
    if k == 16:
        return "u32"
    if 17 <= k <= 32:
        return "u64_len"
    raise ValueError(f"kmer size {k} unsupported by the reference dump format "
                     "(14-max Kmer32bit / 16 / 17..32 Kmer64bit)")


# ---------------------------------------------------------------------------
# multiple-kmer dump
# ---------------------------------------------------------------------------

def write_multiple_kmer_dump(fname: str, k: int, keys, counts,
                             bytes_per_count: int = 1,
                             nb_kmers_header: int | None = None) -> int:
    """Write counted kmers (count >= 2 only) in the reference format.

    keys/counts must already be in the desired record order (use
    count_batch_detailed + argsort by first-occurrence for scan order).
    Returns the number of records written.
    """
    keys = np.asarray(keys)
    counts = np.asarray(counts)
    # fast paths matter at scale: boolean fancy-indexing of a 51M-record
    # all-true mask measured 3-5 s host-side, the min/max checks ~0.03 s
    # (finalize already filtered and clamped in the common CLI flow)
    if counts.size and int(counts.min()) < 2:
        sel = counts >= 2
        keys, counts = keys[sel], counts[sel]
    kind = _kmer_record_dtype(k)
    cap = (1 << (8 * bytes_per_count)) - 1
    if counts.size and int(counts.max()) > cap:
        ccl = np.minimum(counts, cap)
    else:
        ccl = counts
    with open(fname, "wb") as f:
        f.write(struct.pack("<IBBQ", COUNTER_MULTIPLE, k, bytes_per_count,
                            nb_kmers_header if nb_kmers_header is not None
                            else len(keys)))
        if kind == "u32_tagged":
            kd = (keys.astype(np.uint32) | np.uint32(k << 28))
        elif kind == "u32":
            kd = keys.astype(np.uint32)
        else:
            kd = keys  # u64 path handled below
        cdt = np.uint8 if bytes_per_count == 1 else np.uint16
        if kind in ("u32_tagged", "u32"):
            rec = np.zeros(len(keys), dtype=[("k", "<u4"), ("c", cdt)])
            rec["k"] = kd
            rec["c"] = ccl.astype(cdt)
        else:
            rec = np.zeros(len(keys), dtype=[("n", "u1"), ("k", "<u8"), ("c", cdt)])
            rec["n"] = k
            rec["k"] = kd
            rec["c"] = ccl.astype(cdt)
        f.write(rec.tobytes())
    return len(keys)


class MultipleKmerDumpWriter:
    """Streaming variant of :func:`write_multiple_kmer_dump` for record
    streams too large to materialize (the spill-merge path).  The header's
    record count is patched on close — the reference's own header count is
    approximate by design (kmercount.rs:680-693) and readers loop to EOF.
    """

    def __init__(self, fname: str, k: int, bytes_per_count: int = 1):
        self.k = k
        self.kind = _kmer_record_dtype(k)
        self.bpc = bytes_per_count
        self.cap = (1 << (8 * bytes_per_count)) - 1
        self.n = 0
        self._f = open(fname, "wb")
        self._f.write(struct.pack("<IBBQ", COUNTER_MULTIPLE, k,
                                  bytes_per_count, 0))

    def write(self, keys, counts):
        """Append records (count >= 2 filter + clamp applied here)."""
        keys = np.asarray(keys, dtype=np.uint64)
        counts = np.asarray(counts, dtype=np.uint64)
        sel = counts >= 2
        keys, counts = keys[sel], counts[sel]
        if len(keys) == 0:
            return
        ccl = np.minimum(counts, self.cap)
        cdt = np.uint8 if self.bpc == 1 else np.uint16
        if self.kind == "u64_len":
            rec = np.zeros(len(keys), dtype=[("n", "u1"), ("k", "<u8"),
                                             ("c", cdt)])
            rec["n"] = self.k
            rec["k"] = keys
        else:
            rec = np.zeros(len(keys), dtype=[("k", "<u4"), ("c", cdt)])
            rec["k"] = (keys.astype(np.uint32) | np.uint32(self.k << 28)
                        if self.kind == "u32_tagged"
                        else keys.astype(np.uint32))
        rec["c"] = ccl.astype(cdt)
        self._f.write(rec.tobytes())
        self.n += len(keys)

    def close(self) -> int:
        self._f.seek(6)
        self._f.write(struct.pack("<Q", self.n))
        self._f.close()
        return self.n

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_multiple_kmer_dump(fname: str):
    """Reload a multiple-kmer dump -> (k, dict kmer_value -> count).

    Twin of KmerCountReload::load_multiple_kmers_from_file
    (kmercount.rs:1209-1351): reads records to EOF, ignoring the approximate
    header count.
    """
    with open(fname, "rb") as f:
        magic, k, bpc, _nb = struct.unpack("<IBBQ", f.read(14))
        if magic != COUNTER_MULTIPLE:
            raise ValueError("bad magic for multiple-kmer dump")
        payload = f.read()
    cdt = "u1" if bpc == 1 else "<u2"
    if k <= 14:
        rec = np.frombuffer(payload, dtype=[("k", "<u4"), ("c", cdt)])
        keys = (rec["k"] & np.uint32(0x0FFFFFFF)).astype(np.uint64)
    elif k == 16:
        rec = np.frombuffer(payload, dtype=[("k", "<u4"), ("c", cdt)])
        keys = rec["k"].astype(np.uint64)
    else:
        rec = np.frombuffer(payload, dtype=[("n", "u1"), ("k", "<u8"), ("c", cdt)])
        if rec.size and not (rec["n"] == k).all():
            raise ValueError("inconsistent per-record kmer size")
        keys = rec["k"]
    return k, dict(zip(keys.tolist(), rec["c"].astype(int).tolist()))


# ---------------------------------------------------------------------------
# unique-kmer dump (16-mers, with coordinates)
# ---------------------------------------------------------------------------

def write_unique_kmer_dump(fname: str, k: int, keys, read_nums, positions) -> int:
    """Records must be in scan order (sort by (read, pos) beforehand)."""
    keys = np.asarray(keys, dtype=np.uint64)
    with open(fname, "wb") as f:
        f.write(struct.pack("<IBQ", COUNTER_UNIQUE, k, len(keys)))
        rec = np.zeros(len(keys), dtype=[("k", "<u4"), ("r", "<u4"), ("p", "<u4")])
        rec["k"] = keys.astype(np.uint32)
        rec["r"] = np.asarray(read_nums, dtype=np.uint32)
        rec["p"] = np.asarray(positions, dtype=np.uint32)
        f.write(rec.tobytes())
    return len(keys)


def read_unique_kmer_dump(fname: str):
    """-> (k, keys u32, read_nums u32, positions u32) — twin of
    KmerCountReload::load_unique (kmercount.rs:1356-1470)."""
    with open(fname, "rb") as f:
        magic, k, _nb = struct.unpack("<IBQ", f.read(13))
        if magic != COUNTER_UNIQUE:
            raise ValueError("bad magic for unique-kmer dump")
        rec = np.frombuffer(f.read(), dtype=[("k", "<u4"), ("r", "<u4"), ("p", "<u4")])
    return k, rec["k"].copy(), rec["r"].copy(), rec["p"].copy()


class KmerCountReload:
    """A reloaded counting dump with the reference's accessors
    (kmercount.rs:1132-1503): the counts of a multiple-kmer dump; the keys,
    coordinates and rank accessor of a unique-kmer dump."""

    def __init__(self, kmer_size: int, counts: dict | None = None,
                 unique_keys=None, coords=None):
        self.kmer_size = kmer_size
        self.counts = counts
        self.unique_keys = unique_keys   # key -> rank
        self.coords = coords             # [(read_num, pos)] by rank

    @staticmethod
    def load_multiple_kmers_from_file(fname: str) -> "KmerCountReload":
        k, counts = read_multiple_kmer_dump(fname)
        return KmerCountReload(k, counts=counts)

    @staticmethod
    def load_unique_kmers_from_file(fname: str) -> "KmerCountReload":
        k, keys, rn, ps = read_unique_kmer_dump(fname)
        return KmerCountReload(
            k, unique_keys=dict(zip(keys.tolist(), range(keys.size))),
            coords=list(zip(rn.tolist(), ps.tolist())))

    def get_kmer_count(self, value: int):
        """Count of a k-mer value, None if absent."""
        if self.counts is None:
            return None
        return self.counts.get(int(value))

    def get_coord_from_rank(self, rank: int):
        """(read_num, pos) of the rank-th unique k-mer, None out of range."""
        if self.coords is None or not 0 <= rank < len(self.coords):
            return None
        return self.coords[rank]

    def get_unique_kmer_coord(self, value: int):
        """Coordinate of a unique k-mer value, None if absent (the
        reference left this accessor unimplemented)."""
        if self.unique_keys is None:
            return None
        rank = self.unique_keys.get(int(value))
        return None if rank is None else self.coords[rank]

    def get_multi_kmer_counts(self):
        """All counts as a list, in dump order."""
        if self.counts is None:
            return None
        return list(self.counts.values())
