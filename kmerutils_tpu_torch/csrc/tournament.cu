// ProbMinHash weighted tournament kernels for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of kmerutils_tpu/ops/tournament.py:
//   K1  weighted_tournament     (_tournament_kernel, u32 items)
//   K2  weighted_tournament_u64 (_tournament_kernel_u64, u64 items as lo/hi)
//
// For read r and slot s the winner is the position p that maximises
//     e(p, s) = logf(u) * winv[r, p],   u = ((h >> 8) + 1) * 2^-24,
//     h = mix32(x_p ^ slotc[s])  (x * 0x9E3779B1, ^ x >> 15, * 0x85EBCA77)
// with x_p the item (K1) or the fold lo ^ hi (K2).  Ties: K1 keeps the
// smallest payload, which is the item itself or, in positions mode, the
// position; K2 keeps the first position and returns that position's lo/hi
// halves.  Positions with winv <= 0 (or NaN) never win; a row without a
// valid position yields 0.
//
// What bounds it: per (position, slot) two integer multiplies, one logf and
// one fmul - about 1.2e9 evaluations for a 1024 x 6000 batch at m = 200.
// Items and winv are 8 bytes per position, re-read once per slot group and
// mostly served from L1/L2, so the kernel is bound by the logf (SFU + FMA
// pipe) and IMAD rates, not by HBM bandwidth.
//
// Design: one block per (read, group of kSlots slots), kThreads threads.
// Each thread strides over the read's positions and keeps, per slot, the
// best (e, payload) pair in registers; a warp-shuffle then shared-memory
// reduction with the comparator "larger e, or equal e and smaller payload"
// picks the winner.  The comparator is a total order, so the result does
// not depend on the reduction order and equals the plain PyTorch version
// (ops/tournament.py) bit for bit: logf (not __logf, no fast math) and the
// exact draw u = h24 * 2^-24 + 2^-24 (both steps exact, so FMA contraction
// cannot change it).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = 8;

__device__ __forceinline__ float draw(uint32_t x, uint32_t slot_const,
                                      float winv) {
  uint32_t h = x ^ slot_const;
  h *= 0x9E3779B1u;
  h ^= h >> 15;
  h *= 0x85EBCA77u;
  const float u = (float)(h >> 8) * 0x1p-24f + 0x1p-24f;
  return logf(u) * winv;
}

__device__ __forceinline__ bool better(float e, uint32_t p, float best_e,
                                       uint32_t best_p) {
  return e > best_e || (e == best_e && p < best_p);
}

// Per-slot best (e, payload) over the block, left in slot s's entry of
// red_e/red_p[0][s] for s < kSlots.
__device__ __forceinline__ void block_reduce(float (&be)[kSlots],
                                             uint32_t (&bp)[kSlots],
                                             float (*red_e)[kSlots],
                                             uint32_t (*red_p)[kSlots]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float oe = __shfl_xor_sync(0xFFFFFFFFu, be[s], off);
      const uint32_t op = __shfl_xor_sync(0xFFFFFFFFu, bp[s], off);
      if (better(oe, op, be[s], bp[s])) {
        be[s] = oe;
        bp[s] = op;
      }
    }
    if (lane == 0) {
      red_e[warp][s] = be[s];
      red_p[warp][s] = bp[s];
    }
  }
  __syncthreads();
  if (threadIdx.x < kSlots) {
    const int s = threadIdx.x;
    float e = red_e[0][s];
    uint32_t p = red_p[0][s];
    for (int w = 1; w < kWarps; ++w) {
      if (better(red_e[w][s], red_p[w][s], e, p)) {
        e = red_e[w][s];
        p = red_p[w][s];
      }
    }
    red_e[0][s] = e;
    red_p[0][s] = p;
  }
}

// Shared body of K1 and K2: the per-slot winners of one (row, slot group).
// kWide folds lo ^ hi and takes the position as payload; otherwise the
// payload is the item, or the position when pos_payload is set.
template <bool kWide>
__device__ __forceinline__ void row_tournament(
    const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
    const float* __restrict__ winv, const uint32_t* __restrict__ slotc,
    int P, int m, int s0, bool pos_payload, float (*red_e)[kSlots],
    uint32_t (*red_p)[kSlots]) {
  uint32_t sc[kSlots];
  float be[kSlots];
  uint32_t bp[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    sc[s] = (s0 + s < m) ? slotc[s0 + s] : 0u;  // extra slots: never stored
    be[s] = -INFINITY;
    bp[s] = 0xFFFFFFFFu;
  }
  for (int p = threadIdx.x; p < P; p += kThreads) {
    const float w = winv[p];
    if (!(w > 0.0f)) continue;  // invalid position (also NaN)
    const uint32_t x = kWide ? (a[p] ^ b[p]) : a[p];
    const uint32_t pay = (kWide || pos_payload) ? (uint32_t)p : x;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const float e = draw(x, sc[s], w);
      if (better(e, pay, be[s], bp[s])) {
        be[s] = e;
        bp[s] = pay;
      }
    }
  }
  block_reduce(be, bp, red_e, red_p);
}

__global__ void __launch_bounds__(kThreads)
tournament_u32_kernel(const uint32_t* __restrict__ items,
                      const float* __restrict__ winv,
                      const uint32_t* __restrict__ slotc,
                      uint32_t* __restrict__ out, int P, int m, int n_groups,
                      int pos_payload) {
  __shared__ float red_e[kWarps][kSlots];
  __shared__ uint32_t red_p[kWarps][kSlots];
  const int row = blockIdx.x / n_groups;
  const int s0 = (blockIdx.x % n_groups) * kSlots;
  const size_t base = (size_t)row * P;
  row_tournament<false>(items + base, nullptr, winv + base, slotc, P, m, s0,
                        pos_payload != 0, red_e, red_p);
  const int s = threadIdx.x;
  if (s < kSlots && s0 + s < m) {
    const bool none = red_e[0][s] == -INFINITY;
    out[(size_t)row * m + s0 + s] = none ? 0u : red_p[0][s];
  }
}

__global__ void __launch_bounds__(kThreads)
tournament_u64_kernel(const uint32_t* __restrict__ lo,
                      const uint32_t* __restrict__ hi,
                      const float* __restrict__ winv,
                      const uint32_t* __restrict__ slotc,
                      uint32_t* __restrict__ out_lo,
                      uint32_t* __restrict__ out_hi, int P, int m,
                      int n_groups) {
  __shared__ float red_e[kWarps][kSlots];
  __shared__ uint32_t red_p[kWarps][kSlots];
  const int row = blockIdx.x / n_groups;
  const int s0 = (blockIdx.x % n_groups) * kSlots;
  const size_t base = (size_t)row * P;
  row_tournament<true>(lo + base, hi + base, winv + base, slotc, P, m, s0,
                       true, red_e, red_p);
  const int s = threadIdx.x;
  if (s < kSlots && s0 + s < m) {
    const size_t o = (size_t)row * m + s0 + s;
    if (red_e[0][s] == -INFINITY) {
      out_lo[o] = 0u;
      out_hi[o] = 0u;
    } else {
      out_lo[o] = lo[base + red_p[0][s]];
      out_hi[o] = hi[base + red_p[0][s]];
    }
  }
}

int grid_blocks(int n, int m, int* n_groups) {
  *n_groups = (m + kSlots - 1) / kSlots;
  const long long blocks = (long long)n * (*n_groups);
  return blocks > 0x7FFFFFFFLL ? -1 : (int)blocks;
}

}  // namespace

// items, winv: [n, P] row-major (u32 bit patterns, f32); slotc: [m] u32;
// out: [n, m] u32.  pos_payload != 0 returns winning positions.
extern "C" int launch_tournament_u32(const void* items, const void* winv,
                                     const void* slotc, void* out, int n,
                                     int P, int m, int pos_payload,
                                     void* stream) {
  int n_groups = 0;
  const int blocks = grid_blocks(n, m, &n_groups);
  if (blocks < 0) return (int)cudaErrorInvalidConfiguration;
  if (blocks == 0) return (int)cudaSuccess;
  tournament_u32_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)items, (const float*)winv, (const uint32_t*)slotc,
      (uint32_t*)out, P, m, n_groups, pos_payload);
  return (int)cudaGetLastError();
}

// lo, hi: [n, P] u32 halves of u64 items; winv: [n, P] f32; slotc: [m] u32;
// out_lo, out_hi: [n, m] u32 halves of the winning items.
extern "C" int launch_tournament_u64(const void* lo, const void* hi,
                                     const void* winv, const void* slotc,
                                     void* out_lo, void* out_hi, int n, int P,
                                     int m, void* stream) {
  int n_groups = 0;
  const int blocks = grid_blocks(n, m, &n_groups);
  if (blocks < 0) return (int)cudaErrorInvalidConfiguration;
  if (blocks == 0) return (int)cudaSuccess;
  tournament_u64_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)lo, (const uint32_t*)hi, (const float*)winv,
      (const uint32_t*)slotc, (uint32_t*)out_lo, (uint32_t*)out_hi, P, m,
      n_groups);
  return (int)cudaGetLastError();
}
