// ProbMinHash weighted tournament kernels for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of kmerutils_tpu/ops/tournament.py:
//   K1  weighted_tournament     (_tournament_kernel, u32 items)
//   K2  weighted_tournament_u64 (_tournament_kernel_u64, u64 items as lo/hi)
//
// For row r and slot s the winner is the position p that maximises
//     e(p, s) = logf(u) * winv[r, p],   u = ((h >> 8) + 1) * 2^-24,
//     h = mix32(x_p ^ slotc[s])  (x * 0x9E3779B1, ^ x >> 15, * 0x85EBCA77)
// with x_p the item (K1) or the fold lo ^ hi (K2).  Ties: K1 keeps the
// smallest payload, which is the item itself or, in positions mode, the
// position; K2 keeps the first position and returns that position's lo/hi
// halves.  Positions with winv <= 0 (or NaN) never win; a row without a
// valid position yields 0.  winv is 1 / multiplicity (finite, < 2^100).
//
// What bounds it: per (position, slot) a hash (two integer multiplies), a
// precise logf and an fmul - about 1.2e9 draws for a 1024 x 6000 batch at
// m = 200, each ~39-41 thread instructions in the SASS of the inner loop
// (logf alone ~27 of them), while the inputs are 8-12 bytes per position.
// So the bound is the instruction issue rate (kmerutils_tpu_torch/
// roofline.py counts the loop), and the design's job is to keep every SM
// issuing draws whatever the row shape.
//
// Design.
// - Tiles, not rows.  A tile is (a group of R rows, a span of S positions,
//   a group of slots).  The host plan (ops/tournament.py::plan; the
//   tile_bounds() of tests/test_torch_tournament.py mirrors the tile
//   arithmetic here) picks them from (n, P, m), the SM count and the
//   blocks per SM of this kernel, which tournament_config() reports with
//   the tile constants below (the host checks them against its own);
//   launch_tournament() refuses a plan that does not cover (n, P, m)
//   exactly or overflows a buffer.  Several short rows per tile in block
//   mode (P = 512), one row per tile for long rows, and a row's positions
//   split over spans when the tiles of whole rows would be fewer than
//   eight waves (one row of 6.1 M keys in
//   sketch_collection, a tail of a few reads, and the 1024-read bench
//   batch on this card).  Blocks walk the tiles with a 64-bit grid-stride
//   loop, so any n launches.
// - A tile stages its positions, at most kStage at a time, into shared
//   memory as (draw input, winv) pairs, once; then its threads sweep that
//   copy.  A unit of work is (row, group of kGroup = 8 slots, j): positions
//   j, j + J, ... of the chunk against the group's slots, with the best
//   (e, payload) of each slot in registers, so one shared-memory load
//   serves eight draws.  J comes from the plan (about three units per
//   thread).  Consecutive threads take consecutive groups of one j, so a
//   warp reads one staged position at a time (a broadcast) and skips an
//   invalid position together.  Positions go up within a unit, so the
//   strict "e > best" keeps the first position on a tie; with item
//   payloads an equal e also takes a smaller item.  Both tests sit behind
//   one "e >= best" branch, taken only when a slot's record moves.
// - One packed key per (unit, slot): order32(e) << 32 | ~payload, where
//   order32(e) = ~bits(e) for e < 0 and 0x7FFFFFFF for e == 0 (+0 or -0).
//   e is finite and <= 0 (u <= 1, 0 < winv < 2^100), and e == 0 exactly
//   when h >> 8 == 2^24 - 1, so ~bits is monotone over every e that
//   occurs, lies in [0x007FFFFF, 0x7FFFFFFE] and stays below the value
//   given to 0: the unsigned max of the keys is the comparator "larger e,
//   then smaller payload", with +0 and -0 equal as float == has them.  Key
//   0 means "no valid position".  Units meet in a shared-memory atomicMax
//   per (row, slot).  The key must agree with the reference's comparator
//   (kmerutils_tpu/ops/tournament.py, "better"), which the plain version
//   (ops/tournament.py::_best) states directly: an argmax of e, then the
//   smallest payload among equal e.  tests/test_torch_tournament.py holds
//   a copy of pack() against that comparator on adversarial ties, and the
//   card's checks hold the kernels against the plain version.
// - A tile that holds whole rows maps its keys to the outputs itself.  When
//   rows are split, each tile atomicMax-es its keys into a u64 scratch [n, m]
//   (zeroed first) and a short epilogue kernel maps them.  Max does not
//   depend on the order, so the result is exact and deterministic.
// - Exact skip: a position whose draw input and winv equal those of the
//   position before it in the row has the same draw for every slot and
//   loses every tie to it (same item, or a larger position), so staging
//   marks it invalid.  Rows arrive sorted from the sketch, so this drops
//   the repeated k-mers of a read.
// - The draw is logf (not __logf, no fast math) of the exact
//   u = h24 * 2^-24 + 2^-24 (both steps exact, so FMA contraction cannot
//   change it), bit for bit the plain PyTorch version's.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// A launch's tiles (ops/tournament.py::Plan, passed as
// _build.TournamentPlan); outside the unnamed namespace because the C
// entry point launch_tournament takes it.
struct Plan {
  long long tiles;
  int rows, slots, span, chunk, sub, spans, slot_groups;
};

namespace {

constexpr int kThreads = 256;
constexpr int kStage = 2048;     // staged (row, position) entries per chunk
constexpr int kMaxPairs = 1024;  // (row, slot) keys of one tile
constexpr int kGroup = 8;        // slots a thread sweeps together
constexpr long long kMaxGrid = 1 << 20;

typedef unsigned long long u64;

__device__ __forceinline__ float draw(uint32_t x, uint32_t slot_const,
                                      float winv) {
  uint32_t h = x ^ slot_const;
  h *= 0x9E3779B1u;
  h ^= h >> 15;
  h *= 0x85EBCA77u;
  const float u = (float)(h >> 8) * 0x1p-24f + 0x1p-24f;
  return logf(u) * winv;
}

__device__ __forceinline__ u64 pack(float e, uint32_t payload) {
  const uint32_t hi = e < 0.0f ? ~__float_as_uint(e) : 0x7FFFFFFFu;
  return ((u64)hi << 32) | (uint32_t)~payload;
}

// (draw input, winv bits) of the flat position g at column col of its row;
// winv 0 marks a position that cannot win (invalid, or a repeat of the
// position before it).
template <bool kWide>
__device__ __forceinline__ uint2 stage_entry(const uint32_t* __restrict__ a,
                                             const uint32_t* __restrict__ b,
                                             const float* __restrict__ winv,
                                             size_t g, int col) {
  const uint32_t x = kWide ? (a[g] ^ b[g]) : a[g];
  float w = winv[g];
  if (w > 0.0f && col > 0) {
    const uint32_t xp = kWide ? (a[g - 1] ^ b[g - 1]) : a[g - 1];
    if (xp == x && __float_as_uint(winv[g - 1]) == __float_as_uint(w))
      w = 0.0f;
  }
  return make_uint2(x, __float_as_uint(w));
}

// Output o of row `row` from its key: 0 without a valid position, else the
// payload (K1) or the halves at the winning position (K2).
template <bool kWide>
__device__ __forceinline__ void finish(u64 key, long long row, int P,
                                       size_t o, const uint32_t* __restrict__ a,
                                       const uint32_t* __restrict__ b,
                                       uint32_t* __restrict__ out_a,
                                       uint32_t* __restrict__ out_b) {
  const uint32_t pay = ~(uint32_t)key;
  if (!kWide) {
    out_a[o] = key ? pay : 0u;
  } else if (key) {
    const size_t g = (size_t)row * P + pay;
    out_a[o] = a[g];
    out_b[o] = b[g];
  } else {
    out_a[o] = 0u;
    out_b[o] = 0u;
  }
}

// The plan fits the buffers and its tiles cover rows [0, n), positions
// [0, P) and slots [0, m) exactly once.
bool plan_fits(const Plan& pl, long long n, int P, int m) {
  if (pl.rows < 1 || pl.slots < 1 || pl.sub < 1 || pl.chunk < 1 ||
      pl.spans < 1 || pl.span < 0 || pl.slot_groups < 0 ||
      (long long)pl.rows * pl.slots > kMaxPairs ||
      (long long)pl.rows * pl.chunk > kStage)
    return false;
  const bool positions = P == 0 ? pl.spans == 1
      : pl.span > 0 && (long long)pl.span * pl.spans >= P &&
        (long long)pl.span * (pl.spans - 1) < P;
  const bool slots = (long long)pl.slots * pl.slot_groups >= m &&
                     (long long)pl.slots * (pl.slot_groups - 1) < m;
  return positions && slots &&
         pl.tiles == (n + pl.rows - 1) / pl.rows * pl.spans * pl.slot_groups;
}

// kItem: the payload is the item (K1), else the position (K1 positions
// mode, K2).
template <bool kWide, bool kItem>
__global__ void __launch_bounds__(kThreads)
tournament_kernel(const uint32_t* __restrict__ a,
                  const uint32_t* __restrict__ b,
                  const float* __restrict__ winv,
                  const uint32_t* __restrict__ slotc,
                  uint32_t* __restrict__ out_a, uint32_t* __restrict__ out_b,
                  u64* __restrict__ scratch, long long n, int P, int m,
                  Plan pl) {
  __shared__ uint2 stage[kStage];
  __shared__ u64 keys[kMaxPairs];
  const int J = pl.sub;
  for (long long t = blockIdx.x; t < pl.tiles; t += gridDim.x) {
    // tile t = ((row group * spans) + span) * slot_groups + slot group
    const int sg = (int)(t % pl.slot_groups);
    const long long rest = t / pl.slot_groups;
    const int c0 = (int)(rest % pl.spans) * pl.span;
    const long long r0 = (rest / pl.spans) * pl.rows;
    const int c1 = min(P, c0 + pl.span);
    const int s0 = sg * pl.slots;
    const int ns = min(pl.slots, m - s0);
    const int nr = (int)min((long long)pl.rows, n - r0);
    const int gpr = (ns + kGroup - 1) / kGroup;  // slot groups per row
    const int groups = nr * gpr;
    const int units = J * groups;
    for (int i = threadIdx.x; i < nr * ns; i += kThreads) keys[i] = 0ull;
    for (int cs = c0; cs < c1; cs += pl.chunk) {
      const int cn = min(pl.chunk, c1 - cs);
      __syncthreads();  // keys set / the previous chunk swept
      for (int i = threadIdx.x; i < nr * cn; i += kThreads) {
        const int r = i / cn, c = i - r * cn;
        stage[i] = stage_entry<kWide>(a, b, winv,
                                      (size_t)(r0 + r) * P + cs + c, cs + c);
      }
      __syncthreads();
      // unit (j, row, group): positions j, j + J, ... of the chunk against
      // the group's kGroup slots, best (e, payload) per slot in registers.
      // Positions go up, so "e > best" keeps the first position on a tie.
      for (int u = threadIdx.x; u < units; u += kThreads) {
        const int j = u / groups, gi = u - j * groups;
        const int r = gi / gpr, g0 = (gi - r * gpr) * kGroup;
        const uint2* row = stage + r * cn;
        uint32_t sc[kGroup], bp[kGroup];
        float be[kGroup];
#pragma unroll
        for (int s = 0; s < kGroup; ++s) {
          sc[s] = g0 + s < ns ? __ldg(slotc + s0 + g0 + s) : 0u;  // extra
          // slots of the last group are swept but never stored
          be[s] = -INFINITY;
          bp[s] = 0xFFFFFFFFu;
        }
        for (int c = j; c < cn; c += J) {
          const uint2 v = row[c];
          const float w = __uint_as_float(v.y);
          if (!(w > 0.0f)) continue;
          const uint32_t pay = kItem ? v.x : (uint32_t)(cs + c);
#pragma unroll
          for (int s = 0; s < kGroup; ++s) {
            const float e = draw(v.x, sc[s], w);
            if (e >= be[s]) {  // rare after the first positions
              if (e > be[s] || (kItem && pay < bp[s])) {
                be[s] = e;
                bp[s] = pay;
              }
            }
          }
        }
        const int top = min(kGroup, ns - g0);
        for (int s = 0; s < top; ++s)
          if (be[s] != -INFINITY)
            atomicMax(&keys[r * ns + g0 + s], pack(be[s], bp[s]));
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < nr * ns; i += kThreads) {
      const int r = i / ns;
      const long long row = r0 + r;
      const size_t o = (size_t)row * m + s0 + (i - r * ns);
      if (scratch) {
        if (keys[i]) atomicMax(scratch + o, keys[i]);
      } else {
        finish<kWide>(keys[i], row, P, o, a, b, out_a, out_b);
      }
    }
    __syncthreads();  // keys are read before the next tile resets them
  }
}

// The outputs of split rows from their keys in scratch.
template <bool kWide>
__global__ void __launch_bounds__(kThreads)
tournament_finish_kernel(const u64* __restrict__ scratch,
                         const uint32_t* __restrict__ a,
                         const uint32_t* __restrict__ b,
                         uint32_t* __restrict__ out_a,
                         uint32_t* __restrict__ out_b, long long n, int P,
                         int m) {
  const long long total = n * m;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
       i < total; i += (long long)gridDim.x * kThreads)
    finish<kWide>(scratch[i], i / m, P, (size_t)i, a, b, out_a, out_b);
}

template <bool kWide, bool kItem>
int launch(const void* a, const void* b, const void* winv, const void* slotc,
           void* out_a, void* out_b, void* scratch, long long n, int P,
           int m, const Plan& pl, cudaStream_t stream) {
  if (n < 0 || P < 0 || m < 0 || !plan_fits(pl, n, P, m) ||
      (pl.spans > 1) != (scratch != nullptr))
    return (int)cudaErrorInvalidValue;
  if (pl.tiles == 0) return (int)cudaSuccess;
  const long long total = n * m;
  if (scratch) {
    cudaError_t err = cudaMemsetAsync(scratch, 0, (size_t)total * sizeof(u64),
                                      stream);
    if (err != cudaSuccess) return (int)err;
  }
  const int grid = (int)(pl.tiles < kMaxGrid ? pl.tiles : kMaxGrid);
  tournament_kernel<kWide, kItem><<<grid, kThreads, 0, stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (const float*)winv,
      (const uint32_t*)slotc, (uint32_t*)out_a, (uint32_t*)out_b,
      (u64*)scratch, n, P, m, pl);
  if (scratch) {
    const long long blocks = (total + kThreads - 1) / kThreads;
    tournament_finish_kernel<kWide>
        <<<(int)(blocks < kMaxGrid ? blocks : kMaxGrid), kThreads, 0,
           stream>>>(
        (const u64*)scratch, (const uint32_t*)a, (const uint32_t*)b,
        (uint32_t*)out_a, (uint32_t*)out_b, n, P, m);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// out[0]: resident blocks per SM of the kernel that launch_tournament(wide,
// pos_payload) runs (the plan sizes waves with it); out[1..4]: kThreads,
// kStage, kMaxPairs, kGroup.  Returns a CUDA error code.
extern "C" int tournament_config(int wide, int pos_payload, int* out) {
  int nb = 0;
  const cudaError_t err =
      wide ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 &nb, tournament_kernel<true, false>, kThreads, 0)
      : pos_payload ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                          &nb, tournament_kernel<false, false>, kThreads, 0)
                    : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                          &nb, tournament_kernel<false, true>, kThreads, 0);
  out[0] = nb;
  out[1] = kThreads;
  out[2] = kStage;
  out[3] = kMaxPairs;
  out[4] = kGroup;
  return (int)err;
}

// K1 (wide = 0): a = items [n, P] (u32 bit patterns), out_a [n, m] the
// winning items, or positions when pos_payload != 0; b, out_b unused.
// K2 (wide = 1): a, b = lo, hi halves [n, P]; out_a, out_b [n, m] the
// winning item's halves.  winv [n, P] f32; slotc [m] u32.  scratch: null
// when the plan keeps rows whole, else u64 [n, m] (zeroed here).  The plan
// comes from ops/tournament.py::plan; one that does not fit (n, P, m) is
// refused with cudaErrorInvalidValue.
extern "C" int launch_tournament(int wide, const void* a, const void* b,
                                 const void* winv, const void* slotc,
                                 void* out_a, void* out_b, void* scratch,
                                 long long n, int P, int m, int pos_payload,
                                 const Plan* plan, void* stream) {
  const Plan& pl = *plan;
  const cudaStream_t st = (cudaStream_t)stream;
  if (wide)
    return launch<true, false>(a, b, winv, slotc, out_a, out_b, scratch, n,
                               P, m, pl, st);
  if (pos_payload)
    return launch<false, false>(a, b, winv, slotc, out_a, out_b, scratch, n,
                                P, m, pl, st);
  return launch<false, true>(a, b, winv, slotc, out_a, out_b, scratch, n, P,
                             m, pl, st);
}
