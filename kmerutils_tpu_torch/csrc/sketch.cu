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
// What bounds them: the function needs per (position, slot) pair 6 integer
// operations (G2), or 10 plus 5 for each round of the permutation (G1: ~16
// at m = 200 with the walk rounds the data needs), against 13 (G1) or 5
// (G2) input bytes per position: 1.2e9 pairs for a 1024 x 6000 batch at
// m = 200.  So the bound is the instruction issue rate
// (kmerutils_tpu_torch/roofline.py::grid_work counts the operations).  On
// Hopper the shifts, logic ops, compares and min/max issue on the ALU pipe
// (64 lanes an SM), the integer multiplies on the FMA pipe (64 lanes), so
// a kernel made only of ALU work reaches half of that bound at best.
//
// Common to both: a tile is (one row, a span of positions, a group of
// slots).  The host plan (ops/sketch_grid.py::plan) splits a row's
// positions over spans when the tiles of whole rows are too few to fill the
// card (one row of 6.1 M positions in sketch_collection).  Blocks walk the
// tiles with a 64-bit grid-stride loop.  Chunks of positions are staged in
// shared memory, the valid ones only (compacted with one ballot and one
// shared atomicAdd per warp; the order does not matter to a min or a max).
// Each slot's result of a tile goes to the output with one unsigned
// atomicMin / atomicMax (skipped when it is the identity); the wrapper
// fills the output with the identity first.  Min and max do not depend on
// the order, so the result is exact and deterministic however tiles run.
//
// G2 (grid_max_kernel) is designed around its ALU work: the function needs 6
// instructions a pair (LOP3, IMAD, SHF, LOP3, IMAD, IMNMX), 4 of them on the
// ALU pipe, so everything else is paid per position or per tile:
// - kG2R slots a thread, in registers.  Thread t owns slots ts + r * T of
//   the group (ts = t % T, r < kG2R; T = ceil(group / kG2R) threads a slot
//   set) and position subset t / T, and keeps for each slot its salt and
//   its running maximum.
// - A staged position is read once for all kG2R slots: the subsets own
//   whole groups of kG2Vec consecutive staged positions (subset q the
//   groups q, q + Q, ...), each group one broadcast LDS.64 / LDS.128, so
//   the loop's load and control are paid once for kG2Vec x kG2R pairs.
//   When a chunk's count of valid positions is not a multiple of kG2Vec,
//   copies of staged position 0 fill its last group: a max is idempotent,
//   so a repeated valid x changes no maximum.
// - nvcc folds the maxima of two positions into one VIMNMX3 (a Hopper DPX
//   instruction) by itself, so a pair costs 3.5 ALU instructions, not 4
//   (an explicit __vimax3_u32 gave the same SASS by pipe).
// - At the end of a tile the register maxima of the Q subsets meet in
//   shared memory (atomicMax), then go to the output.
//
// G1 (grid_min_kernel) is designed around its ALU work:
// - kR slots a thread, in registers.  Thread t owns slots ts + r * T of the
//   group (ts = t % T, r < kR; T = ceil(group / kR) threads a slot set) and
//   position subset t / T, and keeps for each slot its running minimum, its
//   permutation input and slotc[j].  A staged position is one 16-byte
//   record {x, a, b, 0}: one broadcast LDS.128 feeds kR pairs, and the loop
//   control is paid once for kR pairs.
// - Permutation values x < 2^nbits are held aligned at bit 30 (X = x << u,
//   u = 31 - nbits): the multiply mod 2^nbits is a plain u32 multiply, the
//   key's pack is 2 X + u, and bit 31 of X + (2^31 - (m << u)) says x >= m,
//   so a funnel shift collects a thread's kR walk flags in one ALU op per
//   pair.  The flag's add and the key's doubling are multiplies by one and
//   two (kernel parameters, so the compiler keeps them): they issue on the
//   FMA pipe, which the shifts, xors and minima of the ALU pipe leave idle.
// - Only the walk rounds the data needs.  The main loop runs the first
//   round and kInline more as selects (at m = 200, 22 % of the pairs walk
//   after the first round, 5 % after the second).  A thread appends, for a
//   position where one of its slots is still >= m, the position and the
//   mask of those slots to its own queue in shared memory (one store and
//   one add a position).  Every kQueue positions the thread drains its
//   queue: each queued pair is walked again from the start (the first
//   round, at most four more while >= m, the clamp to m - 1), hashed and
//   folded into its slot's minimum in shared memory with an atomicMin.  The
//   main loop's key of a queued pair has a permutation field >= m, so it is
//   larger than every finished key of its slot and never wins once the
//   pair's finished key is in.
// - At the end of a tile the register minima of the Q subsets meet the
//   drains' minima in shared memory (atomicMin), then go to the output.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // threads per block at most (G1 and G2)
constexpr int kWalks = 4;       // cycle-walk rounds after the first
constexpr int kMaxGroup = 2048; // slots a group at most (G1 and G2)

constexpr int kG2R = 4;         // G2: slots a thread holds in registers
constexpr int kG2Vec = 4;       // G2: staged positions a shared load
constexpr int kG2Chunk = 2048;  // G2: positions staged per step
static_assert(kG2R >= 1 && kG2R <= 32, "G2's slots a thread");
static_assert(kG2Vec == 1 || kG2Vec == 2 || kG2Vec == 4,
              "a shared load is 4, 8 or 16 bytes");
static_assert(kG2Chunk >= 32 && kG2Chunk % kG2Vec == 0, "G2's chunk");
static_assert((kG2Chunk + kMaxGroup) * 4 + 4 <= 48 * 1024,
              "G2's static shared memory");

constexpr int kR = 8;             // G1: slots a thread holds in registers
constexpr int kMinChunk = 1024;   // G1: positions staged per step
constexpr int kInline = 1;        // G1: walk rounds in the main loop
constexpr int kQueue = 16;        // G1: main-loop positions between drains
static_assert(kR >= 1 && kR <= 16, "a queue entry holds 16 slot bits");
static_assert(kMinChunk >= 32 && kMinChunk <= 1 << 16,
              "a queue entry holds a 16-bit position");
static_assert(kMinChunk * 16 + (kQueue * kThreads + kMaxGroup) * 4 + 4 <=
                  48 * 1024,
              "G1's static shared memory");
static_assert(kInline >= 0 && kInline <= kWalks, "inline rounds");

// ---------------------------------------------------------------------------
// G2
// ---------------------------------------------------------------------------

// V staged positions, read with one shared load (LDS, LDS.64, LDS.128)
template <int V>
struct __align__(4 * V) Words {
  uint32_t w[V];
};

// SetSketch's hash of a pair: position fold x, register salt s
__device__ __forceinline__ uint32_t hll_hash(uint32_t x, uint32_t s) {
  uint32_t h = (x ^ s) * 0x9E3779B1u;
  h ^= h >> 15;
  return h * 0x85EBCA77u;
}

__global__ void __launch_bounds__(kThreads)
    grid_max_kernel(const uint32_t* __restrict__ x,
                    const uint8_t* __restrict__ valid,
                    const uint32_t* __restrict__ salts,
                    uint32_t* __restrict__ out, long long P, int m, int T,
                    int Q, long long span, int spans, int groups,
                    long long tiles) {
  __shared__ __align__(16) uint32_t sx[kG2Chunk];
  __shared__ uint32_t sbest[kMaxGroup];
  __shared__ int scount;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int ts = t % T;
  const int sub = t / T;
  const bool worker = sub < Q;
  const int G = T * kG2R;

  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int g = (int)(tile % groups);
    const long long rs = tile / groups;
    const int sp = (int)(rs % spans);
    const long long row = rs / spans;
    const int j0 = g * G + ts;
    uint32_t sc[kG2R], best[kG2R];
#pragma unroll
    for (int r = 0; r < kG2R; ++r) {
      const int j = j0 + r * T;
      sc[r] = worker && j < m ? salts[j] : 0u;
      best[r] = 0u;
    }
    for (int s = t; s < G; s += blockDim.x) sbest[s] = 0u;
    const long long p0 = (long long)sp * span;
    const long long p1 = p0 + span < P ? p0 + span : P;
    const long long base_off = row * P;

    for (long long c0 = p0; c0 < p1; c0 += kG2Chunk) {
      if (t == 0) scount = 0;
      __syncthreads();
      const int cn = (int)(p1 - c0 < kG2Chunk ? p1 - c0 : kG2Chunk);
      for (int i0 = 0; i0 < cn; i0 += blockDim.x) {
        const int i = i0 + t;
        const long long p = base_off + c0 + i;
        const bool v = i < cn && valid[p] != 0;
        const unsigned bal = __ballot_sync(0xFFFFFFFFu, v);
        int off = 0;
        if (lane == 0 && bal) off = atomicAdd(&scount, __popc(bal));
        off = __shfl_sync(0xFFFFFFFFu, off, 0);
        if (v) sx[off + __popc(bal & ((1u << lane) - 1u))] = x[p];
      }
      __syncthreads();
      const int cnt = scount;
      const int vgroups = (cnt + kG2Vec - 1) / kG2Vec;
      if (cnt % kG2Vec != 0) {      // block-uniform: cnt is shared
        if (t < vgroups * kG2Vec - cnt) sx[cnt + t] = sx[0];
        __syncthreads();
      }
      if (worker) {
        for (int vg = sub; vg < vgroups; vg += Q) {
          const Words<kG2Vec> xs =
              reinterpret_cast<const Words<kG2Vec>*>(sx)[vg];
#pragma unroll
          for (int r = 0; r < kG2R; ++r)
#pragma unroll
            for (int v = 0; v < kG2Vec; ++v)
              best[r] = max(best[r], hll_hash(xs.w[v], sc[r]));
        }
      }
      __syncthreads();
    }

    if (worker) {
#pragma unroll
      for (int r = 0; r < kG2R; ++r)
        if (j0 + r * T < m && best[r] != 0u)
          atomicMax(&sbest[ts + r * T], best[r]);
    }
    __syncthreads();
    for (int s = t; s < G; s += blockDim.x) {
      const int j = g * G + s;
      const uint32_t v = sbest[s];
      if (j < m && v != 0u) atomicMax(out + row * m + j, v);
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// G1
// ---------------------------------------------------------------------------

// G1's constants for one m.  A permutation value x < 2^nbits is held
// aligned at bit 30, X = x << u with u = 31 - nbits: the multiply mod
// 2^nbits is a u32 multiply (bit 31 masked off), the key is 2 X +
// (h >> nbits), and bit 31 of X + bias says x >= m.  The adds go through
// multiplies by one and two (kernel parameters, so the compiler keeps them)
// to issue on the FMA pipe, which the ALU work leaves idle.
struct Perm {
  uint32_t top;      // bits u..30: the value bits
  uint32_t low31;    // 0x7FFFFFFF
  uint32_t lim;      // m << u: x >= m while X >= lim
  uint32_t bias;     // 2^31 - lim
  uint32_t clamp;    // (m - 1) << u
  uint32_t balign;   // 2^u: b * balign aligns b
  uint32_t pw;       // 2^(32 - nbits): mulhi(h, pw) = h >> nbits
  uint32_t one, two;
  int sh;            // max(nbits / 2, 1)
};

// one round of the keyed permutation on an aligned value
__device__ __forceinline__ uint32_t encrypt31(uint32_t X, uint32_t a,
                                              uint32_t bt, const Perm& c) {
  X = ((X * a) ^ bt) & c.low31;
  return X ^ ((X >> c.sh) & c.top);
}

// the packed key of a pair: its aligned permutation value X and the slot
// draw of h = x_p ^ slotc[j]
__device__ __forceinline__ uint32_t pack_key(uint32_t X, uint32_t h,
                                             const Perm& c) {
  h *= 0x85EBCA77u;
  h ^= h >> 13;
  h *= 0xC2B2AE3Du;
  h ^= h >> 16;
  return __umulhi(h, c.pw) + X * c.two;
}

// the whole cycle walk of one pair from its aligned slot index J: the
// first round, at most kWalks more while the value is >= m, then the clamp
// to m - 1
__device__ __forceinline__ uint32_t walk(uint32_t J, uint32_t a, uint32_t bt,
                                         const Perm& c) {
  uint32_t X = encrypt31(J, a, bt, c);
  for (int w = 0; w < kWalks && X >= c.lim; ++w) X = encrypt31(X, a, bt, c);
  return X < c.clamp ? X : c.clamp;
}

// a thread's drain of its queue: entry k is a staged position i and the
// mask of the thread's slots still >= m there (bit kR - 1 - r for slot r);
// each such pair is walked from the start, hashed and folded into its
// slot's minimum in shared memory, one pair a step
__device__ __forceinline__ void drain(const uint32_t* squeue, int qn,
                                      const uint4* srec,
                                      const uint32_t* __restrict__ slotc,
                                      uint32_t* sbest, int t, int ts, int T,
                                      int g0, const Perm& c) {
  uint32_t mask = 0, xr = 0, ar = 0, bt = 0;
  for (int k = 0;;) {
    if (mask == 0u) {
      if (k == qn) break;
      const uint32_t e = squeue[k++ * kThreads + t];
      const uint4 rec = srec[e & 0xFFFFu];
      mask = e >> 16;
      xr = rec.x;
      ar = rec.y;
      bt = rec.z * c.balign;
    }
    const int s = ts + (kR - __ffs(mask)) * T;
    mask &= mask - 1u;
    const uint32_t key = pack_key(walk((uint32_t)(g0 + s) * c.balign, ar,
                                       bt, c), xr ^ slotc[g0 + s], c);
    atomicMin(&sbest[s], key);
  }
}

__global__ void __launch_bounds__(kThreads)
    grid_min_kernel(const uint32_t* __restrict__ x,
                    const uint32_t* __restrict__ a,
                    const uint32_t* __restrict__ b,
                    const uint8_t* __restrict__ valid,
                    const uint32_t* __restrict__ slotc,
                    uint32_t* __restrict__ out, long long P, int m, int T,
                    int Q, long long span, int spans, int groups,
                    long long tiles, Perm c) {
  __shared__ uint4 srec[kMinChunk];               // {x, a, b, 0}
  __shared__ uint32_t squeue[kQueue * kThreads];  // entry k of thread t
  __shared__ uint32_t sbest[kMaxGroup];
  __shared__ int scount;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int ts = t % T;
  const int sub = t / T;
  const bool worker = sub < Q;
  const int G = T * kR;

  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int g = (int)(tile % groups);
    const long long rs = tile / groups;
    const int sp = (int)(rs % spans);
    const long long row = rs / spans;
    const int j0 = g * G + ts;
    uint32_t J[kR], sc[kR], best[kR];
    uint32_t real = 0;           // bit kR - 1 - r: slot r lies below m
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int j = j0 + r * T;
      const bool in = worker && j < m;
      J[r] = (uint32_t)j * c.balign;
      sc[r] = in ? slotc[j] : 0u;
      best[r] = 0xFFFFFFFFu;
      real |= in ? 1u << (kR - 1 - r) : 0u;
    }
    for (int s = t; s < G; s += blockDim.x) sbest[s] = 0xFFFFFFFFu;
    const long long p0 = (long long)sp * span;
    const long long p1 = p0 + span < P ? p0 + span : P;
    const long long base_off = row * P;

    for (long long c0 = p0; c0 < p1; c0 += kMinChunk) {
      if (t == 0) scount = 0;
      __syncthreads();
      const int cn = (int)(p1 - c0 < kMinChunk ? p1 - c0 : kMinChunk);
      for (int i0 = 0; i0 < cn; i0 += blockDim.x) {
        const int i = i0 + t;
        const long long p = base_off + c0 + i;
        const bool v = i < cn && valid[p] != 0;
        const unsigned bal = __ballot_sync(0xFFFFFFFFu, v);
        int off = 0;
        if (lane == 0 && bal) off = atomicAdd(&scount, __popc(bal));
        off = __shfl_sync(0xFFFFFFFFu, off, 0);
        if (v)
          srec[off + __popc(bal & ((1u << lane) - 1u))] =
              make_uint4(x[p], a[p], b[p], 0u);
      }
      __syncthreads();
      const int cnt = scount;
      const int iters = worker && sub < cnt ? (cnt - sub + Q - 1) / Q : 0;
      for (int it0 = 0; it0 < iters; it0 += kQueue) {
        const int itn = iters - it0 < kQueue ? iters : it0 + kQueue;
        int qn = 0;
        for (int it = it0; it < itn; ++it) {
          const int i = sub + it * Q;
          const uint4 rec = srec[i];
          const uint32_t bt = rec.z * c.balign;
          uint32_t need = 0;
#pragma unroll
          for (int r = 0; r < kR; ++r) {
            uint32_t X = encrypt31(J[r], rec.y, bt, c);
#pragma unroll
            for (int w = 0; w < kInline; ++w) {
              const uint32_t Y = encrypt31(X, rec.y, bt, c);
              X = X >= c.lim ? Y : X;
            }
            need = __funnelshift_l(X * c.one + c.bias, need, 1);
            const uint32_t key = pack_key(X, rec.x ^ sc[r], c);
            best[r] = key < best[r] ? key : best[r];
          }
          need &= real;
          squeue[qn * kThreads + t] = (uint32_t)i | need << 16;
          qn += need != 0u;
        }
        drain(squeue, qn, srec, slotc, sbest, t, ts, T, g * G, c);
      }
      __syncthreads();
    }

    if (worker) {
#pragma unroll
      for (int r = 0; r < kR; ++r)
        if (real >> (kR - 1 - r) & 1u) atomicMin(&sbest[ts + r * T], best[r]);
    }
    __syncthreads();
    for (int s = t; s < G; s += blockDim.x) {
      const int j = g * G + s;
      const uint32_t v = sbest[s];
      if (j < m && v != 0xFFFFFFFFu) atomicMin(out + row * m + j, v);
    }
    __syncthreads();
  }
}

long long cdiv(long long p, long long q) { return (p + q - 1) / q; }

}  // namespace

// out[0] = threads per block at most, out[1] = G2's positions staged per
// step, out[2] = G1's slots a thread, out[3] = G1's positions staged per
// step, out[4] = slots a group at most (G1 and G2), out[5] = G2's slots a
// thread, out[6] = G2's staged positions a shared load:
// ops/sketch_grid.py checks them against its own constants.
extern "C" int sketch_grid_config(int* out) {
  out[0] = kThreads;
  out[1] = kG2Chunk;
  out[2] = kR;
  out[3] = kMinChunk;
  out[4] = kMaxGroup;
  out[5] = kG2R;
  out[6] = kG2Vec;
  return 0;
}

// G1: x, a, b [n, P] u32 (fold, permutation key halves), valid [n, P]
// bytes, slotc [m] u32, out [n, m] u32 filled with 0xFFFFFFFF by the
// caller.  The plan (T threads a slot set holding kR slots each, Q position
// subsets, span positions a tile) comes from ops/sketch_grid.py::plan; one
// that does not cover (n, P, m) is refused with cudaErrorInvalidValue.
extern "C" int launch_grid_min(const void* x, const void* a, const void* b,
                               const void* valid, const void* slotc,
                               void* out, long long n, long long P, int m,
                               int T, int Q, long long span, void* stream) {
  if (n <= 0 || P <= 0) return 0;
  if (m < 1 || T < 1 || Q < 1 || T * Q > kThreads || T * kR > kMaxGroup ||
      span < 1)
    return (int)cudaErrorInvalidValue;
  const long long spans = cdiv(P, span);
  const long long groups = cdiv(m, (long long)T * kR);
  if (spans > 0x7FFFFFFF || groups > 0x7FFFFFFF)
    return (int)cudaErrorInvalidValue;
  const int nbits = m > 1 ? 32 - __builtin_clz((unsigned)(m - 1)) : 1;
  const int u = 31 - nbits;
  Perm c;
  c.top = 0x7FFFFFFFu & ~((1u << u) - 1u);
  c.low31 = 0x7FFFFFFFu;
  c.lim = (uint32_t)m << u;
  c.bias = 0x80000000u - c.lim;
  c.clamp = (uint32_t)(m - 1) << u;
  c.balign = 1u << u;
  c.pw = (uint32_t)(0x100000000ULL >> nbits);
  c.one = 1u;
  c.two = 2u;
  c.sh = nbits / 2 > 1 ? nbits / 2 : 1;
  const long long tiles = n * spans * groups;
  const int threads = (T * Q + 31) / 32 * 32;
  const long long blocks = tiles < 0x7FFFFFFFLL ? tiles : 0x7FFFFFFFLL;
  grid_min_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x, (const uint32_t*)a, (const uint32_t*)b,
      (const uint8_t*)valid, (const uint32_t*)slotc, (uint32_t*)out, P, m, T,
      Q, span, (int)spans, (int)groups, tiles, c);
  return (int)cudaGetLastError();
}

// G2: x [n, P] u32, valid [n, P] bytes, salts [m] u32, out [n, m] u32
// filled with 0 by the caller.  The plan (T threads a slot set holding
// kG2R slots each, Q position subsets, span positions a tile) comes from
// ops/sketch_grid.py::plan; one that does not cover (n, P, m) is refused
// with cudaErrorInvalidValue.
extern "C" int launch_grid_max(const void* x, const void* valid,
                               const void* salts, void* out, long long n,
                               long long P, int m, int T, int Q,
                               long long span, void* stream) {
  if (n <= 0 || P <= 0) return 0;
  if (m < 1 || T < 1 || Q < 1 || T * Q > kThreads ||
      T * kG2R > kMaxGroup || span < 1)
    return (int)cudaErrorInvalidValue;
  const long long spans = cdiv(P, span);
  const long long groups = cdiv(m, (long long)T * kG2R);
  if (spans > 0x7FFFFFFF || groups > 0x7FFFFFFF)
    return (int)cudaErrorInvalidValue;
  const long long tiles = n * spans * groups;
  const int threads = (T * Q + 31) / 32 * 32;
  const long long blocks = tiles < 0x7FFFFFFFLL ? tiles : 0x7FFFFFFFLL;
  grid_max_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x, (const uint8_t*)valid, (const uint32_t*)salts,
      (uint32_t*)out, P, m, T, Q, span, (int)spans, (int)groups, tiles);
  return (int)cudaGetLastError();
}
