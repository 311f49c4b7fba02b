"""FASTA / FASTQ ingest: host parsing into packed batches, then upload.

Port of kmerutils_tpu/io/fastx.py.  Reads FASTA or FASTQ (plain or gzip),
drops whole reads that contain any non-ACGT base, 2-bit packs the survivors
and counts the same ingest statistics.  ``read_batches`` yields the same
reads in the same rows as the JAX version (length bucketing or file
order, the {2^i, 1.5 * 2^i} width ladder, power-of-two row quotas, an 8
Mi-base cap on a batch's padded size) but without its all-zero padding
rows; its batches stay on the host.
``read_batches_overlapped`` parses in a thread and uploads each batch from
pinned memory with ``non_blocking=True``.
"""

from __future__ import annotations

import dataclasses
import gzip
import queue as _queue
import threading

import numpy as np
import torch

from ..base import alphabet
from ..base.sequence import ReadBatch, batch_from_numpy, pack_words


@dataclasses.dataclass
class IngestStats:
    """Ingest counters: reads kept, bases seen, bad bases, reads dropped."""
    n_reads: int = 0
    n_bases: int = 0
    nb_bad_bases: int = 0
    nb_bad_read: int = 0


def _open(path: str):
    f = open(path, "rb")
    magic = f.read(2)
    f.seek(0)
    if magic == b"\x1f\x8b":
        return gzip.open(f)
    return f


def iter_fastx(path: str):
    """Yield (id bytes, seq bytes, qual bytes|None) records.

    FASTQ records may be wrapped (sequence ends at the '+' line; quality
    ends once it is as long as the sequence); FASTA sequences may span
    lines.  Line ends, CRLF included, are stripped.
    """
    with _open(path) as f:
        line = f.readline()
        if not line:
            return
        if line.startswith(b"@"):  # FASTQ
            while line:
                rid = line.rstrip()[1:]
                seq_parts = []
                line = f.readline()
                while line and not line.startswith(b"+"):
                    seq_parts.append(line.rstrip())
                    line = f.readline()
                seq = b"".join(seq_parts)
                qual_parts: list[bytes] = []
                qlen = 0
                # a zero-length read still carries ONE (empty) quality line
                first_q = True
                while qlen < len(seq) or first_q:
                    line = f.readline()
                    if not line:
                        break
                    first_q = False
                    part = line.rstrip()
                    qual_parts.append(part)
                    qlen += len(part)
                yield rid, seq, b"".join(qual_parts)
                line = f.readline()
        elif line.startswith(b">"):  # FASTA
            rid = line.rstrip()[1:]
            chunks = []
            for line in f:
                if line.startswith(b">"):
                    yield rid, b"".join(chunks), None
                    rid = line.rstrip()[1:]
                    chunks = []
                else:
                    chunks.append(line.rstrip())
            yield rid, b"".join(chunks), None
        else:
            raise ValueError(f"{path}: not FASTA/FASTQ (first byte {line[:1]!r})")


def _add_native_stats(stats: IngestStats | None, reader) -> None:
    if stats is not None:
        stats.n_bases += int(reader.stats[0])
        stats.nb_bad_bases += int(reader.stats[1])
        stats.nb_bad_read += int(reader.stats[2])
        stats.n_reads += int(reader.stats[3] - reader.stats[2])


def iter_clean_reads(path: str, stats: IngestStats | None = None,
                     with_quality: bool = False):
    """Yield 2-bit code arrays (uint8) of the pure-ACGT reads, dropping the
    rest; the native parser when it is built, Python otherwise.

    ``with_quality=True`` yields ``(codes, quality uint8 | None)`` instead,
    through the Python parser (the native one drops the quality lines);
    FASTA records have no quality and give None."""
    if not with_quality:
        from . import native
        if native.available():
            reader = native.NativeFastxReader(path)
            for codes, offsets in reader:
                for i in range(len(offsets) - 1):
                    yield codes[offsets[i] : offsets[i + 1]]
            _add_native_stats(stats, reader)
            return
    for _rid, seq, qual in iter_fastx(path):
        raw = np.frombuffer(seq, dtype=np.uint8)
        codes = alphabet.ENCODE_2B[raw]
        bad = int((codes == 0xFF).sum())
        if stats is not None:
            stats.n_bases += raw.size
            stats.nb_bad_bases += bad
        if bad:
            if stats is not None:
                stats.nb_bad_read += 1
            continue
        if stats is not None:
            stats.n_reads += 1
        if with_quality:
            yield codes, (np.frombuffer(qual, dtype=np.uint8) if qual
                          else None)
        else:
            yield codes


def _qwidth(L: int) -> int:
    """Next {2^i, 1.5 * 2^i} rung >= max(L, 256)."""
    L = max(L, 256)
    p = 1 << (L - 1).bit_length()
    return 3 * p // 4 if L <= 3 * p // 4 else p


def read_batches(path: str, batch_reads: int = 10000,
                 stats: IngestStats | None = None, bucket: bool = True):
    """Yield (ReadBatch on the host, read_indices int64[rows]) with at most
    ``batch_reads`` reads each; ``read_indices`` maps batch rows to read
    numbers in file order.

    The batching rules are the JAX version's (with its ``quantize=True``),
    so both yield the same reads in the same rows: with ``bucket=True``
    the reads of a parse window are sorted by length and a group stops at
    a width rung; with ``bucket=False`` rows and batches keep file order
    and a group may span rungs.  A batch's width goes up to the next rung
    of the {2^i, 1.5 * 2^i} ladder (>= 256 bases); a group closes at a
    power-of-two row quota (at its widest read's rung) or at 8 Mi padded
    bases; the window flushes every ~4 batches of new bases and carries
    groups below their quota into the next window.  Unlike the JAX
    version, a batch has only its
    real rows: eager PyTorch has no compiled shapes to keep stable, so
    padding rows would only add device work.  With the native library the
    reads arrive already packed; otherwise they are parsed and packed in
    Python.
    """
    max_batch_bases = 8 << 20
    window: list = []          # (codes or packed words, length) per read
    indices: list[int] = []
    next_index = 0
    from . import native
    use_packed = native.available()

    def quota_rows(Lq):
        q = max(1, min(batch_reads, max_batch_bases // Lq))
        n = 1 << (q - 1).bit_length()
        return n if n <= q else n >> 1

    def flush(final: bool):
        nonlocal window, indices, window_bases, window_new
        if not window:
            return
        lens = np.array([ln for _, ln in window], dtype=np.int64)
        order = (np.argsort(lens, kind="stable") if bucket
                 else np.arange(len(window)))
        keep: list = []
        keep_idx: list[int] = []
        start = 0
        while start < len(window):
            L0 = int(lens[order[start]])
            take = 1
            full = False
            while start + take < len(window):
                Lc = max(L0, int(lens[order[start + take]]))
                if bucket and _qwidth(Lc) != _qwidth(L0):
                    break                      # rung boundary: not full
                Lq = _qwidth(Lc)
                if take + 1 > quota_rows(Lq) \
                        or (take + 1) * Lq > max_batch_bases:
                    full = True
                    break
                take += 1
                L0 = Lc
            Lq0 = _qwidth(L0)
            full = full or take >= quota_rows(Lq0) \
                or (take + 1) * Lq0 > max_batch_bases
            sel = order[start : start + take]
            start += take
            if not final and not full:
                for i in sel:
                    keep.append(window[i])
                    keep_idx.append(indices[i])
                continue
            group = [window[i] for i in sel]
            L = _qwidth(max(ln for _, ln in group))
            n = len(group)
            lengths = np.zeros(n, dtype=np.int32)
            if use_packed:
                words = np.zeros((n, -(-L // 16) + 1), dtype=np.uint32)
                for i, (w, ln) in enumerate(group):
                    words[i, : w.size] = w
                    lengths[i] = ln
            else:
                codes = np.zeros((n, L), dtype=np.uint8)
                for i, (c, ln) in enumerate(group):
                    codes[i, :ln] = c
                    lengths[i] = ln
                words, lengths = pack_words(codes, lengths)
            yield (batch_from_numpy(words, lengths, device="cpu"),
                   np.array([indices[i] for i in sel], dtype=np.int64))
        window, indices = keep, keep_idx
        # carried entries do not count toward the next flush's triggers
        window_bases = 0
        window_new = 0

    window_budget = 4 * max_batch_bases
    window_bases = 0
    window_new = 0
    window_cap = batch_reads * 4

    def append(payload, ln):
        nonlocal next_index, window_bases, window_new
        window.append((payload, ln))
        indices.append(next_index)
        next_index += 1
        window_bases += ln
        window_new += 1
        return window_bases >= window_budget or window_new >= window_cap

    if use_packed:
        reader = native.NativeFastxReader(path)
        for words, woff, lens_blk in reader.packed_blocks():
            for i in range(lens_blk.size):
                if append(words[woff[i] : woff[i + 1]], int(lens_blk[i])):
                    yield from flush(final=False)
        yield from flush(final=True)
        _add_native_stats(stats, reader)
        return
    for codes in iter_clean_reads(path, stats):
        if append(codes, codes.size):
            yield from flush(final=False)
    yield from flush(final=True)


def _put(q: _queue.Queue, item, stop: threading.Event) -> bool:
    """Blocking put that gives up once ``stop`` is set."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return True
        except _queue.Full:
            continue
    return False


def read_batches_overlapped(path: str, device="cuda", queue_depth: int = 3,
                            **kw):
    """:func:`read_batches` with parsing in a producer thread and each batch
    moved to ``device``; every other keyword goes to :func:`read_batches`.

    For a CUDA device the producer pins each host batch and the consumer
    issues ``non_blocking`` copies on the current stream, so the upload of a
    batch overlaps the compute already queued.  The pinned host tensors are
    kept until an event recorded after their copy has completed.  A
    ``stats=`` keyword is filled before the stream ends.

    ``queue_depth`` bounds the parsed batches waiting for the consumer, and
    so the pinned host memory.  The JAX version bounds each of its two
    stages (parse, then a device-put thread) by this number; here the copy
    is issued by the consumer, so the one parse stage is the whole
    pipeline and its queue takes the bound.
    """
    device = torch.device(device)
    cuda = device.type == "cuda"
    q: _queue.Queue = _queue.Queue(maxsize=queue_depth)
    stop = threading.Event()
    end = object()

    def parse_worker():
        try:
            for batch, idx in read_batches(path, **kw):
                if cuda:
                    batch = ReadBatch(batch.words.pin_memory(),
                                      batch.lengths.pin_memory())
                if not _put(q, (batch, idx), stop):
                    return
            _put(q, end, stop)
        except Exception as e:  # surfaced in the consumer
            _put(q, e, stop)

    worker = threading.Thread(target=parse_worker, daemon=True)
    worker.start()
    in_flight: list = []   # (pinned host batch, event after its copy)
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, Exception):
                raise item
            batch, idx = item
            if not cuda:
                yield batch.to(device), idx
                continue
            dev = batch.to(device, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(device))
            in_flight.append((batch, ev))
            while in_flight and in_flight[0][1].query():
                in_flight.pop(0)
            yield dev, idx
    finally:
        stop.set()
        for _, ev in in_flight:
            ev.synchronize()
        worker.join(timeout=10)


def load_all(path: str, stats: IngestStats | None = None,
             device="cuda") -> ReadBatch:
    """The whole (small) file's clean reads as one ReadBatch on ``device``,
    in file order (not the length-sorted batches of :func:`read_batches`)."""
    reads = list(iter_clean_reads(path, stats))
    if not reads:
        raise ValueError(f"no clean reads in {path}")
    L = max(c.size for c in reads)
    codes = np.zeros((len(reads), L), dtype=np.uint8)
    lengths = np.zeros(len(reads), dtype=np.int32)
    for i, c in enumerate(reads):
        codes[i, : c.size] = c
        lengths[i] = c.size
    words, lengths = pack_words(codes, lengths)
    return batch_from_numpy(words, lengths, device)


def write_fastq(path: str, reads, quals=None) -> None:
    """Write ASCII reads to a FASTQ file."""
    with open(path, "w") as f:
        for i, r in enumerate(reads):
            if isinstance(r, bytes):
                r = r.decode()
            q = quals[i] if quals is not None else "I" * len(r)
            f.write(f"@read{i}\n{r}\n+\n{q}\n")


def write_fasta(path: str, reads) -> None:
    with open(path, "w") as f:
        for i, r in enumerate(reads):
            if isinstance(r, bytes):
                r = r.decode()
            f.write(f">read{i}\n{r}\n")
