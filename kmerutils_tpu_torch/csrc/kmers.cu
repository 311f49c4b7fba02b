// The k-mer prefix of every sketch for Hopper (sm_90a): packed words to
// valid, canonical, hashed items in one pass (KP).
//
// Not a replacement of a TPU kernel: the JAX package writes this prefix as
// plain array code (kmerutils_tpu/sketch/jaccard.py::hashed_kmers over
// kmerutils_tpu/base/kmer.py::canonical_kmers) and XLA fuses it.  Eager
// PyTorch runs it as some thirty int64 passes over [n, P], each reading and
// writing 8 bytes a position.  This kernel computes, per position p of row
// r (P = max(16 (W - 1) - k + 1, 1) positions a row), in registers:
//   window  (w[i] << 2j) | (w[i+1] >> (32 - 2j)) with i = p / 16,
//           j = p % 16 (j = 0 gives w[i]): one funnel shift; k > 16 builds
//           a 64-bit window from w[i], w[i+1] and w[i+2] (0 past the row);
//   k-mer   the window >> (32 - 2k), or >> (64 - 2k);
//   revcomp the complement (bitwise NOT, as A=00 C=01 G=10 T=11) with its
//           2-bit groups reversed: a bit reversal, then the two bits of
//           each group swapped back, >> the same amount;
//   item    the unsigned minimum of the two, through Thomas Wang's
//           hash32shiftmult (k <= 16) or hash64shift (k > 16), or as it is
//           (the identity hash);
//   valid   p + k <= lengths[r].
// Every position is written, the invalid ones too, bit for bit as the
// plain version (ops/kmer_prefix.py::kmer_prefix_ref) gives them.  The
// strand is not computed: the sketches do not use it.
//
// What bounds it: bytes.  It reads the packed words (an eighth of a byte a
// base) and the lengths, and writes 4 (k <= 16) or 8 (k > 16) bytes of item
// and one byte of valid a position: ~95 % of the traffic is the output.
// The arithmetic is some 30 integer instructions a position (twice that on
// the 64-bit path), under the store time at 3.35 TB/s.
//
// Design: the output is indexed flat, [n * P], in groups of kVec = 4
// consecutive positions, one group a thread in a grid-stride loop.  A group
// goes out as one 16-byte store of items (two on the 64-bit path) and one
// 4-byte store of its valid bytes: the output is 256-byte aligned and a
// group starts at a multiple of 4 positions, so both are aligned, and a
// warp writes 512 (or 1,024) contiguous bytes of items and 128 of valid.
// Row starts are not aligned (P is any width), so a group may cross one or
// more row boundaries: the thread finds its first position's row with one
// (64-bit) division and steps to the next row where the position reaches
// P.  The words (1.7 MB for an 8 Mi-base batch) are read through the
// read-only path; neighbouring threads read the same or neighbouring
// words, which stay in L1 and L2.  The last group of an output whose size
// is not a multiple of 4 is stored a position at a time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;   // positions a thread writes together

typedef unsigned long long u64;

__device__ __forceinline__ uint32_t swap_pair_bits32(uint32_t x) {
  return ((x >> 1) & 0x55555555u) | ((x & 0x55555555u) << 1);
}

__device__ __forceinline__ u64 swap_pair_bits64(u64 x) {
  return ((x >> 1) & 0x5555555555555555ull) |
         ((x & 0x5555555555555555ull) << 1);
}

__device__ __forceinline__ uint32_t wang32(uint32_t x) {
  x = (x ^ 61u) ^ (x >> 16);
  x *= 9u;
  x ^= x >> 4;
  x *= 0x27D4EB2Du;
  return x ^ (x >> 15);
}

__device__ __forceinline__ u64 wang64(u64 x) {
  x = ~x + (x << 21);
  x ^= x >> 24;
  x = x + (x << 3) + (x << 8);
  x ^= x >> 14;
  x = x + (x << 2) + (x << 4);
  x ^= x >> 28;
  return x + (x << 31);
}

// The item of the k-mer at bit 2j of word i of a row (wr), shifted down by
// `shift` = 32 - 2k (u32) or 64 - 2k (u64).
template <bool kWide, bool kWang>
__device__ __forceinline__ u64 item_at(const uint32_t* __restrict__ wr,
                                       long long i, int j2, long long W,
                                       int shift) {
  const uint32_t a = __ldg(wr + i), b = __ldg(wr + i + 1);
  if (kWide) {
    const uint32_t c = i + 2 < W ? __ldg(wr + i + 2) : 0u;
    const u64 km = (((u64)__funnelshift_l(b, a, j2) << 32) |
                    __funnelshift_l(c, b, j2)) >> shift;
    const u64 rc = swap_pair_bits64(__brevll(~km)) >> shift;
    const u64 can = km < rc ? km : rc;
    return kWang ? wang64(can) : can;
  }
  const uint32_t km = __funnelshift_l(b, a, j2) >> shift;
  const uint32_t rc = swap_pair_bits32(__brev(~km)) >> shift;
  const uint32_t can = km < rc ? km : rc;
  return kWang ? wang32(can) : can;
}

// words [n, W] u32, lengths [n] int32, items [n, P] u32 or u64, valid
// [n, P] bytes; total = n * P.
template <bool kWide, bool kWang>
__global__ void __launch_bounds__(kThreads)
kmer_prefix_kernel(const uint32_t* __restrict__ words,
                   const int* __restrict__ lengths, void* __restrict__ items,
                   uint8_t* __restrict__ valid, long long W, long long P,
                   int k, long long total) {
  const int shift = (kWide ? 64 : 32) - 2 * k;
  const long long groups = (total + kVec - 1) / kVec;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
       g < groups; g += stride) {
    const long long f0 = g * kVec;
    long long row = f0 / P, pos = f0 - row * P;
    const long long left = total - f0;
    const int cnt = left < kVec ? (int)left : kVec;
    u64 it[kVec];
    uint32_t vbits = 0;
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      it[e] = 0;
      if (e < cnt) {
        it[e] = item_at<kWide, kWang>(words + row * W, pos >> 4,
                                      (int)(pos & 15) * 2, W, shift);
        if (pos + k <= (long long)__ldg(lengths + row))
          vbits |= 1u << (8 * e);
        if (++pos == P) {
          pos = 0;
          ++row;
        }
      }
    }
    if (cnt == kVec) {
      if (kWide) {
        ulonglong2* o = reinterpret_cast<ulonglong2*>(items) + 2 * g;
        o[0] = make_ulonglong2(it[0], it[1]);
        o[1] = make_ulonglong2(it[2], it[3]);
      } else {
        reinterpret_cast<uint4*>(items)[g] =
            make_uint4((uint32_t)it[0], (uint32_t)it[1], (uint32_t)it[2],
                       (uint32_t)it[3]);
      }
      reinterpret_cast<uint32_t*>(valid)[g] = vbits;
    } else {
      for (int e = 0; e < cnt; ++e) {
        if (kWide)
          reinterpret_cast<u64*>(items)[f0 + e] = it[e];
        else
          reinterpret_cast<uint32_t*>(items)[f0 + e] = (uint32_t)it[e];
        valid[f0 + e] = (uint8_t)(vbits >> (8 * e));
      }
    }
  }
}

template <bool kWide, bool kWang>
void launch(const void* words, const void* lengths, void* items, void* valid,
            long long W, long long P, int k, long long total, unsigned blocks,
            cudaStream_t stream) {
  kmer_prefix_kernel<kWide, kWang><<<blocks, kThreads, 0, stream>>>(
      (const uint32_t*)words, (const int*)lengths, items, (uint8_t*)valid, W,
      P, k, total);
}

}  // namespace

// out[0] = threads per block, out[1] = positions a thread writes together:
// ops/kmer_prefix.py checks them against its own constants.
extern "C" int kmer_prefix_config(int* out) {
  out[0] = kThreads;
  out[1] = kVec;
  return 0;
}

// KP: words [n, W] u32 (16 bases a word, a slack word at the end of each
// row), lengths [n] int32 -> items [n, P] (u32 for k <= 16, u64 above) and
// valid [n, P] bytes, P = max(16 (W - 1) - k + 1, 1); `wang` 1 for Wang's
// hash, 0 for the identity.  `blocks` of kThreads threads walk the groups
// in a grid-stride loop (ops/kmer_prefix.py::blocks).  items must be 16-byte
// and valid 4-byte aligned; anything else is refused with
// cudaErrorInvalidValue.
extern "C" int launch_kmer_prefix(const void* words, const void* lengths,
                                  void* items, void* valid, long long n,
                                  long long W, long long P, int k, int wang,
                                  long long blocks, void* stream) {
  if (k < 1 || k > 32 || n < 0 || W < 2 || P < 1 || P > 16 * (W - 1) ||
      blocks < 1 || blocks > 0x7FFFFFFFLL || ((uintptr_t)items & 15) != 0 ||
      ((uintptr_t)valid & 3) != 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const long long total = n * P;
  const unsigned b = (unsigned)blocks;
  cudaStream_t s = (cudaStream_t)stream;
  if (k > 16) {
    if (wang)
      launch<true, true>(words, lengths, items, valid, W, P, k, total, b, s);
    else
      launch<true, false>(words, lengths, items, valid, W, P, k, total, b, s);
  } else {
    if (wang)
      launch<false, true>(words, lengths, items, valid, W, P, k, total, b, s);
    else
      launch<false, false>(words, lengths, items, valid, W, P, k, total, b,
                           s);
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// KC: the k-mer prefix of counting.  Packed words to the batch's valid
// canonical k-mers, compacted at the rows' offsets, in the sort's form.
//
// Not a replacement of a TPU kernel either: the JAX package's counting
// prefix (kmerutils_tpu/count/stream.py::batch_entries over
// kmerutils_tpu/base/kmer.py::canonical_kmers) is plain array code that
// XLA fuses.  Eager PyTorch ran it as some thirty int64 passes over [n, P]
// and a where / cumsum / scatter selection of the valid positions.  This
// kernel writes, for output o in [0, total) of row r (offsets[r] <= o <
// offsets[r + 1], offsets[r + 1] - offsets[r] = max(lengths[r] - k + 1, 0))
// at position p = o - offsets[r]:
//   keys[o]  the canonical k-mer of (r, p), as item_at gives it to KP with
//            the identity hash, its top bit flipped: int32 for k <= 16,
//            int64 above, so that a signed sort gives the unsigned order;
//   flat[o]  r * P + p as int64, with coordinates only.
// Only valid positions (p + k <= lengths[r]) have an output, and every
// output is written once.  The strand is not computed.
//
// What bounds it: bytes.  The words are read once (an eighth of a byte a
// base), the offsets once, and each output writes 4 (k <= 16) or 8 bytes
// of key, plus 8 of index with coordinates: at k = 16 without coordinates
// a batch of ~6.0 M outputs moves ~1.6 MB in and ~24 MB out, ~7.7 us at
// 3.35 TB/s.  The arithmetic (KP's without the hash) is under that.
//
// Design: the OUTPUT is walked, so that every store is a whole aligned
// vector.  A block takes a tile of kCountTile = kCountThreads * kCountVec
// consecutive outputs (a grid-stride loop over tiles); thread t takes
// outputs 4t .. 4t + 3 of it and writes them with one 16-byte store of
// keys (two on the 64-bit path, and two of indices with coordinates): a
// warp writes 512 contiguous bytes of keys.  Rows are found without a
// search per output: warp 0 finds the rows of the tile's first and last
// outputs in offsets[] by a 32-ary search (a load a lane a round, three
// rounds up to 32 K rows); a thread then searches between those two rows
// only (no step when the tile lies in one row, as it does for reads of
// thousands of bases), and an output past its row's end searches again
// from the next row.  Invalid positions cost nothing: they have no output.
// The words are read through the read-only path; neighbouring threads read
// the same or neighbouring words.

namespace {

constexpr int kCountThreads = 256;
constexpr int kCountVec = 4;   // outputs a thread writes together
constexpr long long kCountTile = kCountThreads * kCountVec;

// The largest r in [lo, hi) with offsets[r] <= o, given offsets[lo] <= o
// (offsets are non-decreasing).
__device__ __forceinline__ long long row_of(const long long* __restrict__ off,
                                            long long lo, long long hi,
                                            long long o) {
  while (hi - lo > 1) {
    const long long mid = lo + ((hi - lo) >> 1);
    if (__ldg(off + mid) <= o)
      lo = mid;
    else
      hi = mid;
  }
  return lo;
}

// row_of by the 32 lanes of a warp together: each round lane i tests lo +
// i * step, and the range narrows to the step after the last lane whose
// test holds (the tests that hold are a prefix, lane 0's always).
__device__ __forceinline__ long long warp_row_of(
    const long long* __restrict__ off, long long lo, long long hi,
    long long o, int lane) {
  while (hi - lo > 1) {
    const long long step = (hi - lo + 31) >> 5;
    const long long c = lo + lane * step;
    const unsigned hold =
        __ballot_sync(0xFFFFFFFFu, c < hi && __ldg(off + c) <= o);
    lo += (31 - __clz((int)hold)) * step;
    hi = min(lo + step, hi);
  }
  return lo;
}

// words [n, W] u32, offsets [n + 1] int64 (offsets[n] = total), keys
// [total] int32 or int64, flat [total] int64 (kCoords only).
template <bool kWide, bool kCoords>
__global__ void __launch_bounds__(kCountThreads)
count_prefix_kernel(const uint32_t* __restrict__ words,
                    const long long* __restrict__ offsets,
                    void* __restrict__ keys, long long* __restrict__ flat,
                    long long n, long long W, long long P, int k,
                    long long total) {
  __shared__ long long rows[2];
  const int shift = (kWide ? 64 : 32) - 2 * k;
  const long long tiles = (total + kCountTile - 1) / kCountTile;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long t0 = tile * kCountTile;
    const long long last = min(t0 + kCountTile, total) - 1;
    if (threadIdx.x < 32) {
      const long long r0 = warp_row_of(offsets, 0, n, t0, threadIdx.x);
      const long long r1 = warp_row_of(offsets, r0, n, last, threadIdx.x);
      if (threadIdx.x == 0) {
        rows[0] = r0;
        rows[1] = r1;
      }
    }
    __syncthreads();
    const long long r0 = rows[0], r1 = rows[1];
    __syncthreads();   // rows is written again for the next tile
    const long long o0 = t0 + (long long)threadIdx.x * kCountVec;
    if (o0 > last) continue;
    const int cnt = (int)min((long long)kCountVec, last - o0 + 1);
    long long row = row_of(offsets, r0, r1 + 1, o0);
    long long start = __ldg(offsets + row), end = __ldg(offsets + row + 1);
    u64 key[kCountVec];
    long long at[kCountVec];
#pragma unroll
    for (int e = 0; e < kCountVec; ++e) {
      key[e] = 0;
      at[e] = 0;
      if (e < cnt) {
        const long long o = o0 + e;
        if (o >= end) {
          row = row_of(offsets, row + 1, r1 + 1, o);
          start = __ldg(offsets + row);
          end = __ldg(offsets + row + 1);
        }
        const long long p = o - start;
        const u64 can = item_at<kWide, false>(words + row * W, p >> 4,
                                              (int)(p & 15) * 2, W, shift);
        key[e] = can ^ (kWide ? 0x8000000000000000ull : 0x80000000ull);
        at[e] = row * P + p;
      }
    }
    if (cnt == kCountVec) {
      if (kWide) {
        ulonglong2* d = reinterpret_cast<ulonglong2*>(keys) + o0 / 2;
        d[0] = make_ulonglong2(key[0], key[1]);
        d[1] = make_ulonglong2(key[2], key[3]);
      } else {
        reinterpret_cast<uint4*>(keys)[o0 / kCountVec] =
            make_uint4((uint32_t)key[0], (uint32_t)key[1], (uint32_t)key[2],
                       (uint32_t)key[3]);
      }
      if (kCoords) {
        longlong2* d = reinterpret_cast<longlong2*>(flat) + o0 / 2;
        d[0] = make_longlong2(at[0], at[1]);
        d[1] = make_longlong2(at[2], at[3]);
      }
    } else {
      for (int e = 0; e < cnt; ++e) {
        if (kWide)
          reinterpret_cast<u64*>(keys)[o0 + e] = key[e];
        else
          reinterpret_cast<uint32_t*>(keys)[o0 + e] = (uint32_t)key[e];
        if (kCoords) flat[o0 + e] = at[e];
      }
    }
  }
}

template <bool kWide, bool kCoords>
void launch_count(const void* words, const void* offsets, void* keys,
                  void* flat, long long n, long long W, long long P, int k,
                  long long total, unsigned blocks, cudaStream_t stream) {
  count_prefix_kernel<kWide, kCoords><<<blocks, kCountThreads, 0, stream>>>(
      (const uint32_t*)words, (const long long*)offsets, keys,
      (long long*)flat, n, W, P, k, total);
}

}  // namespace

// out[0] = threads per block, out[1] = outputs a thread writes together:
// ops/count_prefix.py checks them against its own constants.
extern "C" int count_prefix_config(int* out) {
  out[0] = kCountThreads;
  out[1] = kCountVec;
  return 0;
}

// KC: words [n, W] u32 (16 bases a word, a slack word at the end of each
// row) and offsets [n + 1] int64 (offsets[r] the first output of row r,
// offsets[n] = total; row r has max(length - k + 1, 0) outputs, at most P
// = max(16 (W - 1) - k + 1, 1)) -> keys [total] (int32 u32 ^ 2^31 for
// k <= 16, int64 u64 ^ 2^63 above) and, when flat is not null, flat
// [total] int64 (row * P + position).  `blocks` of kCountThreads threads
// walk the tiles in a grid-stride loop (ops/count_prefix.py::blocks).
// keys and flat must be 16-byte aligned; anything else is refused with
// cudaErrorInvalidValue.
extern "C" int launch_count_prefix(const void* words, const void* offsets,
                                   void* keys, void* flat, long long n,
                                   long long W, long long P, int k,
                                   long long total, long long blocks,
                                   void* stream) {
  if (k < 1 || k > 32 || n < 0 || W < 2 || P < 1 || P > 16 * (W - 1) ||
      total < 0 || total > n * P || blocks < 1 || blocks > 0x7FFFFFFFLL ||
      ((uintptr_t)keys & 15) != 0 || ((uintptr_t)flat & 15) != 0)
    return (int)cudaErrorInvalidValue;
  if (total == 0) return 0;
  const unsigned b = (unsigned)blocks;
  cudaStream_t s = (cudaStream_t)stream;
  if (k > 16) {
    if (flat)
      launch_count<true, true>(words, offsets, keys, flat, n, W, P, k, total,
                               b, s);
    else
      launch_count<true, false>(words, offsets, keys, flat, n, W, P, k,
                                total, b, s);
  } else {
    if (flat)
      launch_count<false, true>(words, offsets, keys, flat, n, W, P, k,
                                total, b, s);
    else
      launch_count<false, false>(words, offsets, keys, flat, n, W, P, k,
                                 total, b, s);
  }
  return (int)cudaGetLastError();
}
