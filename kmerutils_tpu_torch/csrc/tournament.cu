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
// m = 200, each ~39-41 thread instructions in the SASS of K2's inner loop
// (logf alone ~27 of them), while the inputs are 8-12 bytes per position.
// So the bound is the instruction issue rate (kmerutils_tpu_torch/
// roofline.py counts the loops), and the design's job is to keep every SM
// issuing draws whatever the row shape; K1 also takes logf for few of its
// draws (below).
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
//
// K1 (u32 items) rejects most draws on the hash alone.  At weight 1 the
// draw is f(h24) = logf((h24 + 1) * 2^-24), and f is monotone
// non-decreasing over its 2^24 arguments (chip_smoke.py checks every one
// on the card).  So for a (row, slot) whose best draw so far is be, a
// weight-1 draw with h24 < T(be), the smallest t with f(t) >= be, is below
// be, and every draw that reaches be, a tie included, has h24 >= T(be).  T
// is exact (threshold24: a guess from expf, corrected with f itself), so
// the test h < T << 8 changes no result and no tie.  Each test uses the
// tile's best, not a unit's:
// - Staging splits each row's chunk into its weight-1 entries (at the
//   front) and its other valid ones (at the back) and drops the invalid
//   ones, so a warp's lanes take one path.  Units compare by "larger e,
//   then smaller payload" whatever order they meet their entries in, and
//   positions mode keeps each entry's column beside it.
// - Phase B sweeps the other weights first, every draw through logf as
//   above: weights below 1 give the larger draws, so the tile's best after
//   it is already high.  Their keys meet in keys[] as K2's do; then one
//   thread per (row, slot) turns keys[] into thr[] = T(best) << 8.
// - Phase A sweeps the weight-1 entries.  A unit keeps only T per slot,
//   from thr[] at its start, every kRefresh of its positions and after
//   each drain of its warp's queue.  A draw that passes goes to the warp's
//   queue; 32 queued draws take logf together, one a lane (so a warp pays
//   a logf for 32 passes, not for each position where one lane passes),
//   each meeting the tile's key at once (the packed key's atomicMax is the
//   comparator); one that raises the key sends its T (walk_down: one more
//   logf) to thr[] by a shared atomicMax.  thr[] only ever holds T of a
//   draw the tile holds, so a rejected draw is below a draw of the tile.
// The counters (k1_counts, when not null): [0] the draws whose logf was
// taken for the result, phase B's and phase A's passes (not
// threshold24's), summed over lanes; [1] the warp steps of phase A (two
// positions of each lane a step) where some lane's draw passed.

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
constexpr int kRefresh = 8;      // K1 phase A: positions between thr[] reads
constexpr int kPerThread = kStage / kThreads;  // K1: entries a thread stages
constexpr uint32_t kOne = 0x3F800000u;  // the bits of 1.0f

typedef unsigned long long u64;

__device__ __forceinline__ uint32_t mix32(uint32_t x, uint32_t slot_const) {
  uint32_t h = x ^ slot_const;
  h *= 0x9E3779B1u;
  h ^= h >> 15;
  return h * 0x85EBCA77u;
}

__device__ __forceinline__ float draw(uint32_t x, uint32_t slot_const,
                                      float winv) {
  const uint32_t h = mix32(x, slot_const);
  const float u = (float)(h >> 8) * 0x1p-24f + 0x1p-24f;
  return logf(u) * winv;
}

// f(t): the draw at weight 1 of a hash with h >> 8 == t, as draw() gives it.
__device__ __forceinline__ float unit_log(uint32_t t) {
  return logf((float)t * 0x1p-24f + 0x1p-24f);
}

// The smallest t' <= t with f(t') >= e, given f(t) >= e.
__device__ __noinline__ uint32_t walk_down(float e, uint32_t t) {
  while (t > 0 && unit_log(t - 1) >= e) --t;
  return t;
}

// T(e): the smallest t in [0, 2^24) with f(t) >= e, for e <= 0 (f(2^24 - 1)
// = logf(1) = 0); 0 for e = -inf.  expf guesses t + 1 to a few units; f
// itself then moves the guess to the exact boundary.
__device__ __noinline__ uint32_t threshold24(float e) {
  const float g = expf(e) * 0x1p24f;
  uint32_t t = g >= 0x1p24f ? 0xFFFFFFu : g >= 1.0f ? (uint32_t)g - 1u : 0u;
  while (t < 0xFFFFFFu && unit_log(t) < e) ++t;
  return walk_down(e, t);
}

// The draw e of a key (pack() inverted), -inf for key 0.
__device__ __forceinline__ float key_draw(u64 key) {
  const uint32_t hi = (uint32_t)(key >> 32);
  return key == 0 ? -INFINITY : hi == 0x7FFFFFFFu ? 0.0f : __uint_as_float(~hi);
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

// K1's queued weight-1 draws q[0, n), one a lane of the warp (every lane
// calls it): each takes logf and meets the tile's key; one that raises it
// sends its T to thr[].  An entry is (item, row << 21 | slot << 11 |
// column) of the tile's chunk at cs.
__device__ __forceinline__ void k1_drain(const uint2* q, int n, int lane,
                                         u64* keys, uint32_t* thr,
                                         const uint32_t* __restrict__ slotc,
                                         int s0, int ns, int cs, bool item,
                                         uint32_t& logf_n) {
  __syncwarp();
  if (lane < n) {
    const uint2 qe = q[lane];
    const int slot = (int)(qe.y >> 11 & 0x3FFu);
    const int i = (int)(qe.y >> 21) * ns + slot;
    const uint32_t h24 = mix32(qe.x, __ldg(slotc + s0 + slot)) >> 8;
    const float e = unit_log(h24);
    ++logf_n;
    const u64 key =
        pack(e, item ? qe.x : (uint32_t)(cs + (int)(qe.y & 0x7FFu)));
    if (key > atomicMax(&keys[i], key))
      atomicMax(&thr[i], walk_down(e, h24) << 8);
  }
  __syncwarp();
}

// K1 (the notes at the top): the tile walk and outputs of K2's kernel
// below, with each chunk staged by weight and swept in two phases.  kItem:
// the payload is the item, else the position.  k1_counts: its two
// counters, or null.  An overload of K2's template, not an instance of it,
// so that its own __launch_bounds__ hold it to 64 registers (four blocks
// an SM) without touching K2's code.
template <bool kWide, bool kItem>
__global__ void __launch_bounds__(kThreads, 4)
tournament_kernel(const uint32_t* __restrict__ a,
                  const float* __restrict__ winv,
                  const uint32_t* __restrict__ slotc,
                  uint32_t* __restrict__ out_a, u64* __restrict__ scratch,
                  long long n, int P, int m, Plan pl,
                  u64* __restrict__ k1_counts) {
  static_assert(!kWide, "K1 takes u32 items");
  __shared__ uint2 stage[kStage];       // weight 1: (item, column); else
                                        // (item, winv bits)
  __shared__ uint16_t cols[kStage];     // the column of a weight != 1 entry
  __shared__ u64 keys[kMaxPairs];
  __shared__ uint32_t thr[kMaxPairs];   // T(the tile's best) << 8
  __shared__ uint32_t counts[kMaxPairs];  // a row's entries: weight 1 in
                                          // the low half, others above
  __shared__ uint2 queue[kThreads / 32][64];  // phase A: each warp's passes
  __shared__ u64 block_counts[2];
  const int J = pl.sub;
  const int lane = threadIdx.x & 31;
  uint32_t logf_n = 0u, steps_n = 0u;
  for (long long t = blockIdx.x; t < pl.tiles; t += gridDim.x) {
    const int sg = (int)(t % pl.slot_groups);
    const long long rest = t / pl.slot_groups;
    const int c0 = (int)(rest % pl.spans) * pl.span;
    const long long r0 = (rest / pl.spans) * pl.rows;
    const int c1 = min(P, c0 + pl.span);
    const int s0 = sg * pl.slots;
    const int ns = min(pl.slots, m - s0);
    const int nr = (int)min((long long)pl.rows, n - r0);
    const int gpr = (ns + kGroup - 1) / kGroup;
    const int groups = nr * gpr;
    const int units = J * groups;
    // phase B's position subsets: about a unit a thread
    const int JB = max(1, min(J, kThreads / groups));
    for (int i = threadIdx.x; i < nr * ns; i += kThreads) keys[i] = 0ull;
    for (int cs = c0; cs < c1; cs += pl.chunk) {
      const int cn = min(pl.chunk, c1 - cs);
      __syncthreads();  // keys set / the previous chunk swept
      for (int i = threadIdx.x; i < nr; i += kThreads) counts[i] = 0u;
      __syncthreads();
      // each valid entry to the front (weight 1) or the back (other
      // weights) of its row's stage, one shared atomicAdd a (warp, row,
      // kind); a thread loads its kStage / kThreads entries first, and
      // whole warps run each step for __match_any_sync
      uint2 v[kPerThread];
#pragma unroll
      for (int q = 0; q < kPerThread; ++q) {
        const int i = q * kThreads + threadIdx.x;
        const int r = i / cn, c = i - r * cn;
        v[q] = i < nr * cn ? stage_entry<false>(
                                 a, a, winv, (size_t)(r0 + r) * P + cs + c,
                                 cs + c)
                           : make_uint2(0u, 0u);
      }
#pragma unroll
      for (int q = 0; q < kPerThread; ++q) {
        const int i = q * kThreads + threadIdx.x;
        const int r = i / cn, c = i - r * cn;
        const bool valid = __uint_as_float(v[q].y) > 0.0f;
        const bool one = v[q].y == kOne;
        const unsigned peers =
            __match_any_sync(0xFFFFFFFFu, valid ? 2 * r + (int)one : -1);
        const int leader = __ffs(peers) - 1;
        uint32_t at = 0u;
        if (valid && lane == leader)
          at = atomicAdd(&counts[r], (uint32_t)__popc(peers) << (one ? 0 : 16));
        at = __shfl_sync(0xFFFFFFFFu, at, leader);
        if (valid) {
          const int k = (int)(one ? at & 0xFFFFu : at >> 16) +
                        __popc(peers & ((1u << lane) - 1u));
          if (one) {
            stage[r * cn + k] = make_uint2(v[q].x, (uint32_t)c);
          } else {
            stage[r * cn + cn - 1 - k] = v[q];
            cols[r * cn + cn - 1 - k] = (uint16_t)c;
          }
        }
      }
      __syncthreads();
      // phase B: unit (j, row, group) sweeps entries j, j + JB, ... of the
      // row's other weights, every draw through logf
      for (int u = threadIdx.x; u < JB * groups; u += kThreads) {
        const int j = u / groups, gi = u - j * groups;
        const int r = gi / gpr, g0 = (gi - r * gpr) * kGroup;
        const int nb = (int)(counts[r] >> 16);
        if (j >= nb) continue;
        const int top = min(kGroup, ns - g0);
        const int base = r * cn + cn - nb;
        uint32_t sc[kGroup], bp[kGroup];
        float be[kGroup];
#pragma unroll
        for (int s = 0; s < kGroup; ++s) {
          sc[s] = s < top ? __ldg(slotc + s0 + g0 + s) : 0u;
          be[s] = -INFINITY;
          bp[s] = 0xFFFFFFFFu;
        }
        for (int k = j; k < nb; k += JB) {
          const uint2 e2 = stage[base + k];
          const float w = __uint_as_float(e2.y);
          const uint32_t pay = kItem ? e2.x : (uint32_t)(cs + cols[base + k]);
#pragma unroll
          for (int s = 0; s < kGroup; ++s) {
            const float e = draw(e2.x, sc[s], w);
            if (e >= be[s] && (e > be[s] || pay < bp[s])) {
              be[s] = e;
              bp[s] = pay;
            }
          }
          logf_n += top;
        }
        for (int s = 0; s < top; ++s)
          if (be[s] != -INFINITY)
            atomicMax(&keys[r * ns + g0 + s], pack(be[s], bp[s]));
      }
      __syncthreads();
      for (int i = threadIdx.x; i < nr * ns; i += kThreads)
        thr[i] = threshold24(key_draw(keys[i])) << 8;
      __syncthreads();
      // phase A: the weight-1 entries.  A unit keeps only T per slot.  A
      // draw whose hash reaches it goes to its warp's queue as (item, row,
      // slot, column); 32 queued draws take logf together, one a lane,
      // each meeting the tile's key at once (the packed key's atomicMax is
      // the comparator), and one that raises the key sends its T to thr[]
      // for every unit; then the warp's units take thr[] again.  Whole
      // warps step together, so every lane meets each queue operation.
      uint2* const q = queue[threadIdx.x >> 5];
      int qn = 0;  // entries in the warp's queue, the same in every lane
      for (int u0 = threadIdx.x - lane; u0 < units; u0 += kThreads) {
        const int u = u0 + lane;
        const int j = u / groups, gi = u - j * groups;
        const int r = gi / gpr, g0 = (gi - r * gpr) * kGroup;
        const int na = u < units ? (int)(counts[r] & 0xFFFFu) : 0;
        const int top = u < units ? min(kGroup, ns - g0) : 0;
        const uint32_t real = (1u << top) - 1u;  // extra slots of the last
        const uint2* row = stage + r * cn;       // group: never drawn
        const uint32_t* tt = thr + r * ns + g0;
        uint32_t sc[kGroup], T[kGroup];
#pragma unroll
        for (int s = 0; s < kGroup; ++s) {
          sc[s] = s < top ? __ldg(slotc + s0 + g0 + s) : 0u;
          T[s] = s < top ? tt[s] : 0xFFFFFFFFu;
        }
        int since = 0;
        // two positions a step, k and k + J
        for (int k = j; __any_sync(0xFFFFFFFFu, k < na); k += 2 * J) {
          if (++since == kRefresh / 2) {
            since = 0;
#pragma unroll
            for (int s = 0; s < kGroup; ++s)
              if (s < top) T[s] = max(T[s], tt[s]);
          }
          const uint2 v0 = k < na ? row[k] : make_uint2(0u, 0u);
          const uint2 v1 = k + J < na ? row[k + J] : make_uint2(0u, 0u);
          uint32_t pass0 = 0u, pass1 = 0u;
#pragma unroll
          for (int s = 0; s < kGroup; ++s) {
            pass0 |= (uint32_t)(mix32(v0.x, sc[s]) >= T[s]) << s;
            pass1 |= (uint32_t)(mix32(v1.x, sc[s]) >= T[s]) << s;
          }
          pass0 &= k < na ? real : 0u;
          pass1 &= k + J < na ? real : 0u;
          if (!__any_sync(0xFFFFFFFFu, pass0 | pass1)) continue;  // common
          steps_n += lane == 0;
          do {  // a round queues each lane's lowest passing slot
            const unsigned want = __ballot_sync(0xFFFFFFFFu, pass0 | pass1);
            if (pass0 | pass1) {
              const bool first = pass0 != 0u;
              const int s = __ffs(first ? pass0 : pass1) - 1;
              if (first)
                pass0 &= pass0 - 1u;
              else
                pass1 &= pass1 - 1u;
              const uint2 v = first ? v0 : v1;
              q[qn + __popc(want & ((1u << lane) - 1u))] = make_uint2(
                  v.x, (uint32_t)r << 21 | (uint32_t)(g0 + s) << 11 | v.y);
            }
            qn += __popc(want);
            if (qn >= 32) {
              k1_drain(q, 32, lane, keys, thr, slotc, s0, ns, cs, kItem,
                       logf_n);
              qn -= 32;
              if (lane < qn) q[lane] = q[32 + lane];
              __syncwarp();
#pragma unroll
              for (int s = 0; s < kGroup; ++s)
                if (s < top) T[s] = max(T[s], tt[s]);
            }
          } while (__any_sync(0xFFFFFFFFu, pass0 | pass1));
        }
      }
      k1_drain(q, qn, lane, keys, thr, slotc, s0, ns, cs, kItem, logf_n);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < nr * ns; i += kThreads) {
      const int r = i / ns;
      const long long row = r0 + r;
      const size_t o = (size_t)row * m + s0 + (i - r * ns);
      if (scratch) {
        if (keys[i]) atomicMax(scratch + o, keys[i]);
      } else {
        finish<false>(keys[i], row, P, o, a, a, out_a, out_a);
      }
    }
    __syncthreads();  // keys are read before the next tile resets them
  }
  if (k1_counts) {  // one global atomicAdd a block and counter
    if (threadIdx.x < 2) block_counts[threadIdx.x] = 0ull;
    __syncthreads();
    u64 sum[2] = {logf_n, steps_n};
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      for (int o = 16; o > 0; o >>= 1)
        sum[q] += __shfl_down_sync(0xFFFFFFFFu, sum[q], o);
      if (lane == 0) atomicAdd(&block_counts[q], sum[q]);
    }
    __syncthreads();
    if (threadIdx.x < 2) atomicAdd(k1_counts + threadIdx.x,
                                   block_counts[threadIdx.x]);
  }
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
           int m, const Plan& pl, void* k1_counts, cudaStream_t stream) {
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
  if constexpr (!kWide)
    tournament_kernel<false, kItem><<<grid, kThreads, 0, stream>>>(
        (const uint32_t*)a, (const float*)winv, (const uint32_t*)slotc,
        (uint32_t*)out_a, (u64*)scratch, n, P, m, pl, (u64*)k1_counts);
  else
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

// chip_smoke.py's probes of K1's weight-1 test (tournament_threshold_probe)
__global__ void unit_log_kernel(float* __restrict__ logs, long long n) {
  for (long long t = (long long)blockIdx.x * kThreads + threadIdx.x; t < n;
       t += (long long)gridDim.x * kThreads)
    logs[t] = unit_log((uint32_t)t);
}

__global__ void threshold24_kernel(const float* __restrict__ e,
                                   uint32_t* __restrict__ thr, long long n) {
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads)
    thr[i] = threshold24(e[i]);
}

}  // namespace

// out[0]: resident blocks per SM of the kernel that launch_tournament(wide,
// pos_payload) runs (the plan sizes waves with it); out[1..4]: kThreads,
// kStage, kMaxPairs, kGroup.  Returns a CUDA error code.
extern "C" int tournament_config(int wide, int pos_payload, int* out) {
  // the two kernel templates (K1's, K2's) by their parameters
  typedef void (*K1)(const uint32_t*, const float*, const uint32_t*,
                     uint32_t*, u64*, long long, int, int, Plan, u64*);
  typedef void (*K2)(const uint32_t*, const uint32_t*, const float*,
                     const uint32_t*, uint32_t*, uint32_t*, u64*, long long,
                     int, int, Plan);
  const K2 k2 = tournament_kernel<true, false>;
  const K1 k1 = pos_payload ? (K1)tournament_kernel<false, false>
                            : (K1)tournament_kernel<false, true>;
  int nb = 0;
  const cudaError_t err =
      wide ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, k2, kThreads,
                                                           0)
           : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, k1, kThreads,
                                                           0);
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
// refused with cudaErrorInvalidValue.  k1_counts: null, or K1's two u64
// counters (the notes at the top), added to; K2 ignores it.
extern "C" int launch_tournament(int wide, const void* a, const void* b,
                                 const void* winv, const void* slotc,
                                 void* out_a, void* out_b, void* scratch,
                                 long long n, int P, int m, int pos_payload,
                                 const Plan* plan, void* k1_counts,
                                 void* stream) {
  const Plan& pl = *plan;
  const cudaStream_t st = (cudaStream_t)stream;
  if (wide)
    return launch<true, false>(a, b, winv, slotc, out_a, out_b, scratch, n,
                               P, m, pl, nullptr, st);
  if (pos_payload)
    return launch<false, false>(a, b, winv, slotc, out_a, out_b, scratch, n,
                                P, m, pl, k1_counts, st);
  return launch<false, true>(a, b, winv, slotc, out_a, out_b, scratch, n, P,
                             m, pl, k1_counts, st);
}

// Probes of K1's weight-1 test for chip_smoke.py, on no path of the port:
// logs[t] = f(t) for t < n (n <= 2^24) when logs is not null, and
// thr[i] = T(e[i]) for i < n when e is not null (csrc: unit_log,
// threshold24).
extern "C" int tournament_threshold_probe(const void* e, void* thr,
                                          void* logs, long long n,
                                          void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (n < 0 || (logs && n > (1ll << 24))) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const long long blocks = (n + kThreads - 1) / kThreads;
  const int grid = (int)(blocks < kMaxGrid ? blocks : kMaxGrid);
  if (logs) unit_log_kernel<<<grid, kThreads, 0, st>>>((float*)logs, n);
  if (e)
    threshold24_kernel<<<grid, kThreads, 0, st>>>((const float*)e,
                                                  (uint32_t*)thr, n);
  return (int)cudaGetLastError();
}
