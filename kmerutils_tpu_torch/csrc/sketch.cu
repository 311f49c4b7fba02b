// Grid reductions of the SuperMinHash and SetSketch sketches for Hopper
// (sm_90a).
//
// Not a replacement of a TPU kernel: the JAX package writes both sketches as
// one reduction over an [n, P, m] grid of (read, position, slot) and leaves
// the fusion to XLA, so the grid never reaches memory there
// (kmerutils_tpu/sketch/superminhash.py::superminhash2 and
// kmerutils_tpu/sketch/setsketch.py::setsketch_signatures).  Eager PyTorch
// would write every elementwise step of that grid to device memory.  These
// kernels keep each (position, slot) value in registers:
//   G1  grid_min (SUPER2): per (row, slot j) the unsigned minimum over the
//       row's valid positions of the packed key  pi << u_bits | u  with
//         pi = the cycle-walked keyed permutation of j under the
//              position's key (a, b): x -> ((x * a) ^ b) & mask,
//              x ^= x >> max(nbits / 2, 1), four more rounds while x >= m,
//              then min(x, m - 1);
//         u  = mix(x_p ^ slotc[j]) >> pi_bits with mix = (* 0x85EBCA77,
//              ^ >> 13, * 0xC2B2AE3D, ^ >> 16);
//       a row without a valid position keeps 0xFFFFFFFF;
//   G2  grid_max (HLL): per (row, register j) the unsigned maximum over the
//       valid positions of h = (x_p ^ salts[j]) * 0x9E3779B1,
//       h ^= h >> 15, h *= 0x85EBCA77; a row without a valid position keeps
//       0.  The register values follow from h on [n, m] in PyTorch.
// x_p is the 32-bit fold of the item; (a, b) come from the full item (the
// host computes them, one [n, P] pass).  All arithmetic is uint32_t, which
// wraps as the JAX package's u32 lanes do.
//
// What bounds it: the function needs per (position, slot) pair 6 integer
// operations (G2), or 10 plus 5 for each round of the permutation (G1: ~16
// at m = 200 with the walk rounds the data needs), against 13 (G1) or 5
// (G2) input bytes per position: 1.2e9 pairs for a 1024 x 6000 batch at
// m = 200.  So the bound is the instruction issue rate
// (kmerutils_tpu_torch/roofline.py::grid_work counts the operations).
//
// Design (a simple kernel, right first).
// - A tile is (one row, a span of positions, a group of S = min(m, 256)
//   slots).  The host plan (ops/sketch_grid.py::plan) splits a row's
//   positions over spans when the tiles of whole rows are too few to fill
//   the card (one row of 6.1 M positions in sketch_collection).  Blocks walk
//   the tiles with a 64-bit grid-stride loop.
// - A block has ceil32(S * Q) threads, Q = 256 / S position subsets: thread
//   t owns slot t % S of the group and subset t / S.  Chunks of kChunk
//   positions are staged in shared memory, the valid ones only (compacted
//   with one ballot and one shared atomicAdd per warp; the order does not
//   matter to a min or a max).  A thread keeps its running min / max in a
//   register; all threads of one subset read the same staged position (a
//   broadcast).
// - The Q subsets meet in shared memory, and each slot's result goes to the
//   output with one unsigned atomicMin / atomicMax (skipped when it is the
//   identity).  The wrapper fills the output with the identity first.  Min
//   and max do not depend on the order, so the result is exact and
//   deterministic however the tiles run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // S * Q <= kThreads
constexpr int kChunk = 1024;    // positions staged per step
constexpr int kWalks = 4;       // cycle-walk rounds after the first

__device__ __forceinline__ uint32_t encrypt(uint32_t x, uint32_t a,
                                            uint32_t b, uint32_t mask,
                                            int sh) {
  x = ((x * a) ^ b) & mask;
  return (x ^ (x >> sh)) & mask;
}

template <bool kMin>
__global__ void __launch_bounds__(kThreads)
    grid_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ a,
                const uint32_t* __restrict__ b,
                const uint8_t* __restrict__ valid,
                const uint32_t* __restrict__ slotc, uint32_t* __restrict__ out,
                long long P, int m, int S, int Q, long long span, int spans,
                int groups, long long tiles) {
  __shared__ uint32_t sx[kChunk];
  __shared__ uint32_t sa[kMin ? kChunk : 1];
  __shared__ uint32_t sb[kMin ? kChunk : 1];
  __shared__ uint32_t sbest[kThreads];
  __shared__ int scount;
  constexpr uint32_t kIdentity = kMin ? 0xFFFFFFFFu : 0u;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int jl = t % S;
  const int sub = t / S;
  // G1's permutation constants (unused by G2)
  const int nbits = m > 1 ? 32 - __clz((unsigned)(m - 1)) : 1;
  const uint32_t mask = nbits >= 32 ? 0xFFFFFFFFu : (1u << nbits) - 1u;
  const int sh = nbits / 2 > 1 ? nbits / 2 : 1;
  const int u_bits = 32 - nbits;
  const uint32_t top = (uint32_t)m;

  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int g = (int)(tile % groups);
    const long long rs = tile / groups;
    const int sp = (int)(rs % spans);
    const long long row = rs / spans;
    const int j = g * S + jl;
    const bool has_slot = sub < Q && j < m;
    const uint32_t sc = has_slot ? slotc[j] : 0u;
    const long long p0 = (long long)sp * span;
    const long long p1 = p0 + span < P ? p0 + span : P;
    const long long base_off = row * P;
    uint32_t best = kIdentity;

    for (long long c0 = p0; c0 < p1; c0 += kChunk) {
      if (t == 0) scount = 0;
      __syncthreads();
      const int cn = (int)(p1 - c0 < kChunk ? p1 - c0 : kChunk);
      for (int i0 = 0; i0 < cn; i0 += blockDim.x) {
        const int i = i0 + t;
        const long long p = base_off + c0 + i;
        const bool v = i < cn && valid[p] != 0;
        const unsigned bal = __ballot_sync(0xFFFFFFFFu, v);
        int off = 0;
        if (lane == 0 && bal) off = atomicAdd(&scount, __popc(bal));
        off = __shfl_sync(0xFFFFFFFFu, off, 0);
        if (v) {
          const int k = off + __popc(bal & ((1u << lane) - 1u));
          sx[k] = x[p];
          if (kMin) {
            sa[k] = a[p];
            sb[k] = b[p];
          }
        }
      }
      __syncthreads();
      const int cnt = scount;
      if (has_slot) {
        if (kMin) {
          for (int i = sub; i < cnt; i += Q) {
            const uint32_t ka = sa[i], kb = sb[i];
            uint32_t pi = encrypt((uint32_t)j, ka, kb, mask, sh);
#pragma unroll
            for (int w = 0; w < kWalks; ++w)
              pi = pi >= top ? encrypt(pi, ka, kb, mask, sh) : pi;
            pi = pi < top - 1u ? pi : top - 1u;
            uint32_t h = (sx[i] ^ sc) * 0x85EBCA77u;
            h ^= h >> 13;
            h *= 0xC2B2AE3Du;
            h ^= h >> 16;
            const uint32_t key = (pi << u_bits) | (h >> nbits);
            best = key < best ? key : best;
          }
        } else {
          for (int i = sub; i < cnt; i += Q) {
            uint32_t h = (sx[i] ^ sc) * 0x9E3779B1u;
            h ^= h >> 15;
            h *= 0x85EBCA77u;
            best = h > best ? h : best;
          }
        }
      }
      __syncthreads();
    }

    if (Q > 1) {
      sbest[t] = best;
      __syncthreads();
      if (sub == 0)
        for (int q = 1; q < Q; ++q) {
          const uint32_t o = sbest[q * S + jl];
          best = kMin ? (o < best ? o : best) : (o > best ? o : best);
        }
      __syncthreads();
    }
    if (sub == 0 && has_slot && best != kIdentity) {
      if (kMin)
        atomicMin(out + row * m + j, best);
      else
        atomicMax(out + row * m + j, best);
    }
  }
}

}  // namespace

// out[0] = threads per block at most, out[1] = positions staged per step:
// ops/sketch_grid.py checks them against its own constants.
extern "C" int sketch_grid_config(int* out) {
  out[0] = kThreads;
  out[1] = kChunk;
  return 0;
}

// G1 (is_min = 1): x, a, b [n, P] u32 (fold, permutation key halves).
// G2 (is_min = 0): x [n, P]; a, b unused (null).
// valid [n, P] bytes; slotc [m] u32; out [n, m] u32, filled with the
// identity by the caller.  The plan (S slots a group, Q position subsets,
// span positions a tile) comes from ops/sketch_grid.py::plan; one that does
// not cover (n, P, m) is refused with cudaErrorInvalidValue.
extern "C" int launch_sketch_grid(int is_min, const void* x, const void* a,
                                  const void* b, const void* valid,
                                  const void* slotc, void* out, long long n,
                                  long long P, int m, int S, int Q,
                                  long long span, void* stream) {
  if (n <= 0 || P <= 0) return 0;
  if (m < 1 || S < 1 || S > m || Q < 1 || S * Q > kThreads || span < 1 ||
      (is_min && (a == nullptr || b == nullptr)))
    return (int)cudaErrorInvalidValue;
  const long long spans = (P + span - 1) / span;
  const long long groups = (m + S - 1) / S;
  if (spans > 0x7FFFFFFF || groups > 0x7FFFFFFF)
    return (int)cudaErrorInvalidValue;
  const long long tiles = n * spans * groups;
  const int threads = (S * Q + 31) / 32 * 32;
  const long long blocks = tiles < 0x7FFFFFFFLL ? tiles : 0x7FFFFFFFLL;
  const cudaStream_t st = (cudaStream_t)stream;
  if (is_min)
    grid_kernel<true><<<(unsigned)blocks, threads, 0, st>>>(
        (const uint32_t*)x, (const uint32_t*)a, (const uint32_t*)b,
        (const uint8_t*)valid, (const uint32_t*)slotc, (uint32_t*)out, P, m,
        S, Q, span, (int)spans, (int)groups, tiles);
  else
    grid_kernel<false><<<(unsigned)blocks, threads, 0, st>>>(
        (const uint32_t*)x, nullptr, nullptr, (const uint8_t*)valid,
        (const uint32_t*)slotc, (uint32_t*)out, P, m, S, Q, span, (int)spans,
        (int)groups, tiles);
  return (int)cudaGetLastError();
}
