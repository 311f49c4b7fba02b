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
