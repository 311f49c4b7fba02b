"""Counting's k-mer prefix (ops/count_prefix.py, kernel KC on the card): its
plain version against base/kmer.py's canonical k-mers where they are valid,
``count/stream.batch_entries`` through it against the JAX package's
``batch_entries``, its argument checks, and the kernel's walk over its
outputs.

Tolerance: exact (every key and index, in order).  Reads are seeded random
ACGT with an empty read, reads of k - 1 and k bases, reads ending on word
boundaries (16, 32 and 48 bases), a read of the batch's full width and a
planted read whose canonical k-mers are >= 2^31 (k = 16) or >= 2^63
(k = 32).
"""

import numpy as np
import pytest
import torch

from kmerutils_tpu.base.sequence import pack_ascii_reads as j_pack
from kmerutils_tpu.count import stream as j_stream
from kmerutils_tpu_torch.base import kmer as tkmer
from kmerutils_tpu_torch.base.sequence import ReadBatch, pack_ascii_reads
from kmerutils_tpu_torch.count import stream as t_stream
from kmerutils_tpu_torch.ops import count_prefix as KC

KS = [1, 8, 15, 16, 17, 21, 31, 32]
WIDTH = 70


def reads_for(k: int):
    """Ragged reads for k: empty, k - 1 and k bases, word boundaries, the
    full width, random lengths, and a read of T then A's, whose canonical
    k-mers (the forward ones) start with T, the top bit set."""
    rng = np.random.default_rng(1000 + k)
    lens = [0, max(k - 1, 0), k, 16, 32, 48, WIDTH]
    lens += list(rng.integers(0, WIDTH + 1, size=9))
    reads = ["".join(rng.choice(list("ACGT"), size=int(n))) for n in lens]
    reads.append("T" + "A" * 40)
    return reads


CASES = [(k, coords, True) for k in KS for coords in (False, True)] + [
    (16, False, False), (21, True, False)]


@pytest.mark.parametrize("k,coords,host_lengths", CASES, ids=[
    f"k{k}-{'coords' if c else 'keys'}-{'host' if h else 'device'}_lengths"
    for k, c, h in CASES])
def test_count_prefix_and_batch_entries_match_their_references(
        k, coords, host_lengths):
    """The plain KC against ``canonical_kmers`` masked by its validity and
    flattened in row order, entry for entry; ``batch_entries`` through it
    against the JAX package's, decoded as tests/test_torch_count.py
    decodes it; a batch without host lengths gives the same run."""
    reads = reads_for(k)
    batch = pack_ascii_reads(reads, device="cpu")
    assert torch.equal(batch.host_lengths, batch.lengths)
    if not host_lengths:
        batch = ReadBatch(batch.words, batch.lengths)
    lens = batch.lengths.numpy()
    assert (lens % 16 == 0).sum() >= 4 and (lens < k).any()

    # the plain KC against the canonical k-mers where valid, in row order
    offs = KC.offsets(lens, k)
    assert offs[-1] == np.maximum(lens.astype(np.int64) - k + 1, 0).sum()
    keys, flat = KC.count_prefix(batch.words, batch.lengths, k, offs, coords)
    can, valid, _ = tkmer.canonical_kmers(batch, k)
    want_flat = np.flatnonzero(valid.numpy())
    want = can.numpy().reshape(-1)[want_flat]
    view = np.uint64 if k > 16 else np.uint32
    top = np.uint64(1 << 63) if k > 16 else np.uint32(1 << 31)
    assert keys.dtype == (torch.int64 if k > 16 else torch.int32)
    got = keys.numpy().view(view) ^ top
    np.testing.assert_array_equal(got, want.astype(view))
    assert (flat is None) == (not coords)
    if coords:
        assert flat.dtype == torch.int64
        np.testing.assert_array_equal(flat.numpy(), want_flat)
    if k in (16, 32):
        assert (got >> view(2 * k - 1)).any()

    # batch_entries against the JAX package's
    arrs, live = j_stream.batch_entries(j_pack(reads), k, 40, coords=coords)
    a = [np.asarray(x)[:int(live)] for x in arrs]
    if k > 16:
        want = ((a[0].astype(np.uint64) << np.uint64(32)) | a[1]) \
            - np.uint64(1)
    else:
        want = a[0] - np.uint32(1)
    key, crd = t_stream.batch_entries(
        batch, k, np.arange(40, 40 + len(reads)), coords=coords)
    got = key.numpy().view(view)
    np.testing.assert_array_equal(got, want)
    assert (crd is None) == (not coords)
    if coords:
        c = crd.numpy().view(np.uint64)
        np.testing.assert_array_equal(c >> np.uint64(32), a[-2])
        np.testing.assert_array_equal(c & np.uint64(0xFFFFFFFF), a[-1])


def small_batch():
    return pack_ascii_reads(reads_for(8)[:6], device="cpu")


@pytest.mark.parametrize("case", [
    "words_int64", "lengths_int64", "words_not_contiguous", "devices_differ",
    "offsets_int32", "offsets_on_meta", "offsets_short", "offsets_from_1",
    "offsets_decreasing", "row_beyond_P", "k_0", "k_33", "one_column",
    "offsets_of_other_lengths"])
def test_count_prefix_rejects_what_the_kernel_does_not_take(case):
    b = small_batch()
    words, lengths, k = b.words, b.lengths, 8
    offs = KC.offsets(b.lengths, k)
    if case == "words_int64":
        words = words.to(torch.int64)
    elif case == "lengths_int64":
        lengths = lengths.to(torch.int64)
    elif case == "words_not_contiguous":
        words = torch.cat([words, words], dim=1)[:, ::2]
        assert not words.is_contiguous()
    elif case == "devices_differ":
        lengths = lengths.to("meta")
    elif case == "offsets_int32":
        offs = offs.to(torch.int32)
    elif case == "offsets_on_meta":
        offs = offs.to("meta")
    elif case == "offsets_short":
        offs = offs[:-1]
    elif case == "offsets_from_1":
        offs = offs + 1
    elif case == "offsets_decreasing":
        offs = offs.clone()
        offs[2] = offs[1] - 1
    elif case == "row_beyond_P":
        offs = torch.arange(offs.numel(), dtype=torch.int64) * (
            KC.positions(words, k) + 1)
    elif case == "one_column":
        words = words[:, :1].contiguous()
    elif case == "offsets_of_other_lengths":
        offs = KC.offsets(b.lengths - 1, k)
    else:
        k = int(case[2:])
    for fn in (KC.count_prefix, KC.count_prefix_ref):
        with pytest.raises(ValueError):
            fn(words, lengths, k, offs)


def test_count_prefix_on_the_cpu_launches_nothing():
    b = small_batch()
    before = KC.launches_count_prefix
    for k, coords in ((8, False), (21, True)):
        KC.count_prefix(b.words, b.lengths, k, KC.offsets(b.lengths, k),
                        coords)
        t_stream.batch_entries(b, k, np.arange(b.n_reads), coords=coords)
    assert KC.launches_count_prefix == before


def warp_row_of(off, lo: int, hi: int, o: int) -> int:
    """The kernel's 32-ary search of warp 0, lane by lane."""
    while hi - lo > 1:
        step = -(-(hi - lo) // 32)
        hold = [lo + i * step < hi and off[lo + i * step] <= o
                for i in range(32)]
        assert hold[0] and hold == sorted(hold, reverse=True)
        lo += (32 - 1 - hold[::-1].index(True)) * step
        hi = min(lo + step, hi)
    return lo


def row_of(off, lo: int, hi: int, o: int) -> int:
    while hi - lo > 1:
        mid = lo + (hi - lo) // 2
        if off[mid] <= o:
            lo = mid
        else:
            hi = mid
    return lo


def kernel_writes(counts, P: int, blocks: int) -> np.ndarray:
    """writes[total, 3] of the kernel's walk, in numpy: (row, position,
    times written) of each output.  Block b takes tiles b, b + blocks, ...
    of KC._TILE outputs; warp 0 finds the rows of a tile's first and last
    outputs, thread t its four outputs' rows between them, searching
    again where an output passes its row's end."""
    n = len(counts)
    off = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=off[1:])
    total = int(off[-1])
    out = np.zeros((total, 3), np.int64)
    tiles = -(-total // KC._TILE)
    for b in range(blocks):
        for tile in range(b, tiles, blocks):
            t0 = tile * KC._TILE
            last = min(t0 + KC._TILE, total) - 1
            r0 = warp_row_of(off, 0, n, t0)
            r1 = warp_row_of(off, r0, n, last)
            for t in range(KC._THREADS):
                o0 = t0 + t * KC._VEC
                if o0 > last:
                    continue
                row = row_of(off, r0, r1 + 1, o0)
                start, end = off[row], off[row + 1]
                for o in range(o0, min(o0 + KC._VEC, last + 1)):
                    if o >= end:
                        row = row_of(off, row + 1, r1 + 1, o)
                        start, end = off[row], off[row + 1]
                    assert 0 <= o - start < min(counts[row], P)
                    out[o, 0], out[o, 1] = row, o - start
                    out[o, 2] += 1
    return out


LAYOUTS = {
    "one_long_row": ([5000], 6000, KC._MAX_BLOCKS),
    "ragged_with_empty_rows": ([0, 3, 0, 0, 1, 17, 0, 250, 1, 0] * 30, 300,
                               KC._MAX_BLOCKS),
    "a_long_run_of_empty_rows": ([7] + [0] * 5000 + [9, 1030, 0], 2000,
                                 KC._MAX_BLOCKS),
    "rows_of_one_output": ([1] * 3001, 1, KC._MAX_BLOCKS),
    "grid_stride_over_two_blocks": ([513, 0, 2049, 6, 1], 4000, 2),
    "nothing_valid": ([0, 0, 0], 10, KC._MAX_BLOCKS),
}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_count_prefix_walk_writes_every_output_once(layout):
    """Every output is written once, at its own row and position: tiles
    inside one row, tiles across hundreds of rows with empty ones between,
    a run of empty rows longer than a tile, totals that are not a multiple
    of 4 or of a tile, and a grid-stride loop over fewer blocks than
    tiles."""
    counts, P, max_blocks = LAYOUTS[layout]
    counts = np.asarray(counts, np.int64)
    total = int(counts.sum())
    blocks = KC.blocks(total, max_blocks)
    assert 1 <= blocks <= max_blocks
    out = kernel_writes(counts, P, blocks)
    rows = np.repeat(np.arange(counts.size), counts)
    pos = np.arange(total) - np.repeat(np.cumsum(counts) - counts, counts)
    np.testing.assert_array_equal(out[:, 0], rows)
    np.testing.assert_array_equal(out[:, 1], pos)
    assert (out[:, 2] == 1).all()
