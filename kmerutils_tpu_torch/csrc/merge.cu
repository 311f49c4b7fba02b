// Merge and run-aggregation kernels of the streaming count table, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernels of kmerutils_tpu/ops/merge_pallas.py:
//   K3  merge_fold_i32        (_merge_fold_kernel, split merge_path_partition_dyn)
//   K5  merge_sorted_u32      (_merge_kernel, split merge_path_partition)
//   K4  aggregate_fold_i32    (_aggfold_kernel, core _agg_tile_compute)
//   K6  aggregate_compact_u32 (_aggcompact_kernel, the same core)
//   K7  compact_live_u32      (_compact_kernel)
//
// Entries are struct-of-arrays: an unsigned key (uint32_t, or uint64_t for
// k > 16), a uint32_t count, and optionally a uint64_t coordinate
// (read_num << 32 | pos, so the lexicographic minimum is the unsigned one).
// Keys compare as unsigned words: none of the TPU kernels' sign flips, key
// bias, reversed B side or aligned DMA windows is needed here.
//
// Merge (K3, K5): stable, A first on ties, each side's equal keys in their
// order.  One block per output tile of kMergeTile = 256 x 16 entries.  The
// tile's splits of A and B at its two output diagonals (merge path: the
// number of A entries among the first d outputs) come from two warps, one
// per diagonal, each in a few round trips to device memory: a round tests
// 32 evenly spaced points of the remaining range at once (one a lane, both
// loads issued together) and a ballot narrows the range 32-fold, so 5
// rounds at 8 Mi entries and 6 at 48 M, where a binary search by one
// thread waits on ~23-26 dependent loads with the rest of the block idle.
// (More points a round save a round but each costs two scattered 32-byte
// sectors: 128 a round made the two searches move up to twice a K5 tile's
// bytes and cost 5-24 % more time, PERF.md section 6.)  The tile's A
// keys and then its B keys are loaded striped (every load issued before
// any is stored) into a shared buffer padded by one word per 128 bytes;
// each thread finds its own split there (a binary search over the padded
// buffer, which keeps the threads' probes 8 or 16 entries apart on
// distinct banks) and merges its 16 outputs into registers, writing their
// 16-bit source indices to a second shared buffer as it goes.  The outputs
// are then staged in order in the key buffer and stored a full warp per
// 32 consecutive entries (128 or 256 bytes per instruction); counts (K3)
// and coordinates are gathered by source index from the tile's two
// contiguous input windows, half a tile's worth of loads in flight at a
// time.  K3 is this kernel with a count word on the A
// side (the table) and an implicit count of 1 on the B side (the batch
// run); only the first n_out outputs are written, so merged entries past
// the table's capacity (the largest keys) are dropped.  K5 has no count
// word.  The output never aliases the inputs (a block would otherwise
// overwrite A entries another block has yet to read): the table is folded
// into a second buffer.
//
// Aggregation (K4, K6): one entry per run of equal keys, count = the sum of
// the run's counts saturated at 2^32 - 1, coordinate = the run's unsigned
// minimum, kept when lo <= count <= hi, compacted stably.  Partial sums
// saturate at every addition: for non-negative terms saturating addition is
// associative and equals the saturation of the exact (64-bit) sum, so one
// 32-bit word carries them.  A tile is kAggTile = 4096 entries, 16 per
// thread, held in registers.  Warp w takes the tile's 512 consecutive
// entries from 512 w: it loads them striped (round r, lane l: entry 32 r +
// l), every load issued before any is used, so each load instruction
// reads 128 consecutive bytes per 4-byte word, and turns them through a
// shared-memory buffer padded by one word per 128 bytes (no bank
// conflicts) into 16 consecutive entries per lane.  An entry is a boundary
// when it is dead, the array's first, or its key differs from the previous
// one's (the previous key of a lane's first entry comes from
// __shfl_up_sync, and from one load per warp at the warp's edge); a live
// boundary heads a run.  Each lane scans its 16 entries in order (the sum
// and minimum restart at a boundary), one warp scan of the lanes'
// aggregates (five shuffles) and one pass over the warps' aggregates give
// each lane the carry that its entries before their first boundary add.
// Every entry is visited a fixed number of times, whatever the run
// lengths: a run of 10 M equal keys costs what 10 M distinct keys cost.
// (Scanning each round of 32 striped entries across the warp instead, five
// shuffle steps a round, cost 10-20 shuffle instructions per entry and
// 1.5-1.7x the time, PERF.md section 6.)  A
// run ends on the entry whose next entry is a boundary, and that lane holds
// the run's aggregate and key.  CUDA blocks run in no order, so runs that
// cross a tile boundary are joined through per-tile summaries instead of
// the TPU's in-order SMEM carry (four launches):
//   1. summary: per tile, from keys and counts only, the aggregate of its
//      leading continuation (the entries before its first boundary), whether
//      it has a boundary, the number of kept runs that close inside it, and
//      the partial aggregate of its last run when that run reaches the
//      tile's end; coordinates are read only for the leading continuation and
//      that last run (those of the tile's first and last 32 entries are
//      loaded with the keys, the rest only when a run is longer);
//   2. resolve: per tile with such an open run, walk the following tiles'
//      leading continuations until a tile with a boundary, and decide the
//      open run (each tile is walked by one owner at most);
//   3. scan: exclusive scan of the per-tile emit counts (one block);
//   4. emit: each tile recomputes its runs with their coordinates; each kept
//      run is written by the lane holding its last entry, which stages it in
//      its warp's buffer at the warp scan of the lanes' emit counts, and the
//      warp then stores the buffer, lane x writing entries x, x + 32, ..., at
//      the tile's offset plus the runs of the warps before it: coalesced
//      stores, keys from registers.  A tile's open last run takes the
//      resolved aggregate.
// K4 takes the live prefix [0, n) of a table; K6 a raw array whose dead
// entries (key all ones) trail, and fills the output past n_live with all
// ones.  Output and input are different buffers.
//
// Compaction (K7): stable compaction of 1-5 arrays of u32 words, an entry
// dead when its first word is all ones, in one pass over the entries and
// one launch (after a memset of the scratch).  A tile is kLiveTile =
// kLiveThreads x kLiveIpt entries; thread x of the block holds the tile's
// entries r kLiveThreads + x (round r), so each load instruction reads 128
// consecutive bytes per warp.  Each block draws its tile id from an atomic
// counter, not from blockIdx: a tile then only ever waits on tiles whose
// blocks are already running, and the look-back below cannot deadlock,
// whatever order the hardware starts blocks in.  A thread issues all its
// loads of the liveness word, then those of the other arrays for its live
// entries, before anything waits on the tiles before it.  A ballot per
// round and one warp scan of the (round, warp) counts rank the tile's live
// entries in order.  The tile's offset comes from a decoupled look-back
// (Merrill & Garland, "Single-pass Parallel Prefix Scan with Decoupled
// Look-back", NVIDIA 2016): every tile has one 64-bit status word, a 2-bit
// flag (empty, aggregate, inclusive prefix) over a 62-bit live count; a
// tile publishes its aggregate as soon as it is ranked, then one warp reads
// its 32 predecessors' words at a time and sums back to the nearest
// inclusive prefix, and the tile publishes its own inclusive prefix.
// Memory order: flag and count travel in one aligned 64-bit word, stored
// with release and loaded with acquire semantics at device scope, so a
// reader sees a whole old word or a whole new one, never a flag without its
// count; no other data is published through the word, so nothing else needs
// ordering.  Every status word, the tile counter and the n_live word are
// zeroed by a cudaMemsetAsync on the same stream just before the kernel
// (the caching allocator hands back the last call's scratch).  The tile's
// live entries are then staged in order in shared memory, one array at a
// time (two buffers in turn, one barrier per array), and each array is
// stored contiguously at [excl, excl + live), a full warp per store
// instruction.  The dead entries need no global total: tile t has d_t =
// len_t - live_t dead entries and D_t = start_t - excl_t dead entries in
// the tiles before it, and writes all ones at [n - D_t - d_t, n - D_t).
// D_0 = 0 and D_t+1 = D_t + d_t, so the intervals of tiles 0, 1, ... lie
// end to end from n downwards and cover [n - D_total, n) = [n_live, n)
// exactly, each slot once.  The tile that draws the last id writes its
// inclusive prefix, n_live, to the scratch's last word.  The TPU kernel's
// butterfly concentrator and aligned DMA windows have no counterpart here.
//
// What bounds them on this card: memory traffic.  Per entry the merge reads
// and writes the key, count and coordinate once: at 3.35 TB/s an 8
// Mi-entry batch folded into a 40 M-entry table with u32 keys and counts
// moves about 0.74 GB, ~0.22 ms, and two 8 Mi-entry runs of u32 keys 134
// MB, ~0.04 ms.  A block moves its tile's bytes only between its split
// search and its merge; the blocks resident on an SM (registers and shared
// memory allow several) overlap those phases, and the few round trips of
// the warp search keep a block's idle head short.  Aggregation reads keys
// and counts twice (summary and emit), coordinates once, and writes each
// kept run once: 50 M entries with u32 keys, counts and coordinates and 19
// M kept runs move ~1.5 GB, ~0.45 ms.  Neither pass
// streams at the card's full rate (PERF.md gives each kernel's time): a
// block loads its tile, then scans it with the memory idle, and the two or
// three blocks resident on an SM (registers) overlap only in part.  K7
// reads every word once (the other arrays only where the entry is live) and
// writes every output word once: 64 Mi entries of five arrays move at most
// 2.7 GB, 0.80 ms at 3.35 TB/s.  What it adds to the bytes is the chain of
// look-backs, one L2 round trip or a few per tile, hidden while enough
// other tiles are loading on the same SM.

#include <cuda/atomic>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kScanThreads = 1024;
constexpr unsigned long long kNoCoord = ~0ull;
constexpr unsigned kFull = 0xFFFFFFFFu;

// Element e of a shared buffer of 2-, 4- or 8-byte words, padded by one
// word per 128 bytes: a warp reading or writing 32 consecutive elements,
// or one element at each of 32 positions a fixed stride of 8 or 16
// elements apart, hits 32 different banks.
template <typename T>
__host__ __device__ constexpr int staged(int e) {
  return e + e / (128 / (int)sizeof(T));
}

// ---------------------------------------------------------------------------
// merge (K3, K5)
// ---------------------------------------------------------------------------

constexpr int kMergeIpt = 16;      // outputs per thread
constexpr int kMergeTile = kThreads * kMergeIpt;
static_assert(kMergeTile <= 65536, "source indices are staged as 16 bits");

// Number of A entries among the first d outputs of the stable (A first)
// merge of sorted a[0, na) and b[0, nb): the largest x in [max(0, d - nb),
// min(d, na)] that is the low end or has a_le_b(x) (a[x-1] <= b[d-x]).
template <typename Le>
__device__ __forceinline__ int merge_path(int na, int nb, int d, Le a_le_b) {
  int lo = d > nb ? d - nb : 0;
  int hi = d < na ? d : na;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (a_le_b(mid)) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

// merge_path in device memory by one warp, in a few round trips instead of
// log2(n): each round lane l tests the point lo + (l + 1) s (both loads
// issued before the test), s the least step with which the 32 points reach
// hi, the ballot counts the points that pass (a prefix, since the test is
// monotone in x), and the range shrinks to the s - 1 points after the last
// one that passes: log(n) / 5 rounds.
template <typename K>
__device__ long long warp_merge_path(const K* __restrict__ a, long long na,
                                     const K* __restrict__ b, long long nb,
                                     long long d, int lane) {
  long long lo = d > nb ? d - nb : 0;
  long long hi = d < na ? d : na;
  while (lo < hi) {
    const long long s = (hi - lo + 31) / 32;
    const long long x = lo + (lane + 1) * s;
    const bool in = x <= hi;
    const K av = in ? a[x - 1] : K(0);
    const K bv = in ? b[d - x] : K(0);
    const int c = __popc(__ballot_sync(kFull, in && av <= bv));
    const long long top = lo + (c + 1) * s - 1;
    lo += c * s;
    hi = top < hi ? top : hi;
  }
  return lo;
}

// Bytes of dynamic shared memory of merge_kernel: the tile's keys (then
// its outputs) and, with payloads, their 16-bit source indices.
template <typename K, bool kSrc>
constexpr int merge_smem_bytes() {
  return (int)sizeof(K) * staged<K>(kMergeTile) +
         (kSrc ? 2 * staged<uint16_t>(kMergeTile) : 0);
}

// One output tile [d0, d0 + kMergeTile) per block; see the header.
template <typename K, bool kCnt, bool kCrd>
__global__ void __launch_bounds__(kThreads)
merge_kernel(const K* __restrict__ a_key, const uint32_t* __restrict__ a_cnt,
             const uint64_t* __restrict__ a_crd, long long na,
             const K* __restrict__ b_key, const uint64_t* __restrict__ b_crd,
             long long nb, K* __restrict__ o_key, uint32_t* __restrict__ o_cnt,
             uint64_t* __restrict__ o_crd, long long n_out) {
  constexpr bool kSrc = kCnt || kCrd;   // payloads gathered by source
  extern __shared__ __align__(16) unsigned char merge_smem[];
  K* s_key = (K*)merge_smem;
  uint16_t* s_src = (uint16_t*)(s_key + staged<K>(kMergeTile));
  __shared__ long long s_split[2];
  const int tid = (int)threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long d0 = (long long)blockIdx.x * kMergeTile;
  const long long total = na + nb;
  const long long d1 = d0 + kMergeTile < total ? d0 + kMergeTile : total;
  if (warp < 2) {
    const long long x =
        warp_merge_path<K>(a_key, na, b_key, nb, warp ? d1 : d0, lane);
    if (lane == 0) s_split[warp] = x;
  }
  __syncthreads();
  const long long a0 = s_split[0];
  const long long b0 = d0 - a0;
  const int n = (int)(d1 - d0);
  const int la = (int)(s_split[1] - a0);
  const int lb = n - la;
  {  // the tile's A keys, then its B keys: striped, all loads issued first
    K v[kMergeIpt];
#pragma unroll
    for (int r = 0; r < kMergeIpt; ++r) {
      const int j = r * kThreads + tid;
      v[r] = j < la ? a_key[a0 + j] : j < n ? b_key[b0 + (j - la)] : K(0);
    }
#pragma unroll
    for (int r = 0; r < kMergeIpt; ++r) {
      const int j = r * kThreads + tid;
      if (j < n) s_key[staged<K>(j)] = v[r];
    }
  }
  __syncthreads();
  // this thread's outputs [dl, dl + m) of the tile, merged into registers
  const int dl = tid * kMergeIpt < n ? tid * kMergeIpt : n;
  const int m = n - dl < kMergeIpt ? n - dl : kMergeIpt;
  int ia = merge_path(la, lb, dl, [&](int x) {
    return s_key[staged<K>(x - 1)] <= s_key[staged<K>(la + dl - x)];
  });
  int ib = dl - ia;
  K ka = ia < la ? s_key[staged<K>(ia)] : K(0);
  K kb = ib < lb ? s_key[staged<K>(la + ib)] : K(0);
  K out[kMergeIpt];
#pragma unroll
  for (int i = 0; i < kMergeIpt; ++i) {
    const bool take_a = ib >= lb || (ia < la && ka <= kb);
    out[i] = take_a ? ka : kb;
    if (kSrc && i < m) {  // s_src is not read before the next barrier
      s_src[staged<uint16_t>(dl + i)] = (uint16_t)(take_a ? ia : la + ib);
    }
    // advance the side taken and load its next key: one shared load
    ia += take_a ? 1 : 0;
    ib += take_a ? 0 : 1;
    const int next = take_a ? ia : la + ib;
    const K k = (take_a ? ia < la : ib < lb) ? s_key[staged<K>(next)] : K(0);
    ka = take_a ? k : ka;
    kb = take_a ? kb : k;
  }
  __syncthreads();  // every key of the tile has been read
  // outputs staged in order, then stored a warp per 32 consecutive
  // entries
#pragma unroll
  for (int i = 0; i < kMergeIpt; ++i) {
    if (i < m) s_key[staged<K>(dl + i)] = out[i];
  }
  __syncthreads();
  const long long room = n_out - d0;
  const int n_write = room < n ? (int)room : n;
#pragma unroll
  for (int r = 0; r < kMergeIpt; ++r) {
    const int j = r * kThreads + tid;
    if (j < n_write) o_key[d0 + j] = s_key[staged<K>(j)];
  }
  if (!kSrc) return;
  // payloads gathered from the tile's two input windows, in two halves
  // (fewer registers): each half's loads issued before its stores
  constexpr int kHalf = kMergeIpt / 2;
#pragma unroll
  for (int h = 0; h < kMergeIpt; h += kHalf) {
    uint32_t cv[kHalf];
    uint64_t rv[kHalf];
#pragma unroll
    for (int r = 0; r < kHalf; ++r) {
      const int j = (h + r) * kThreads + tid;
      const int s = j < n_write ? (int)s_src[staged<uint16_t>(j)] : 0;
      const bool from_a = s < la;
      if (kCnt) cv[r] = j < n_write && from_a ? a_cnt[a0 + s] : 1u;
      if (kCrd) {
        rv[r] = j >= n_write ? 0ull : from_a ? a_crd[a0 + s]
                                             : b_crd[b0 + (s - la)];
      }
    }
#pragma unroll
    for (int r = 0; r < kHalf; ++r) {
      const int j = (h + r) * kThreads + tid;
      if (j < n_write) {
        if (kCnt) o_cnt[d0 + j] = cv[r];
        if (kCrd) o_crd[d0 + j] = rv[r];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// aggregation
// ---------------------------------------------------------------------------

constexpr int kWarps = kThreads / 32;
constexpr int kAggIpt = 16;                      // entries per thread
constexpr int kSpan = 32 * kAggIpt;              // consecutive entries a warp
constexpr int kAggTile = kThreads * kAggIpt;     // entries per tile
constexpr int kStage = kSpan + kSpan / 16;       // 8-byte words a warp stages

// Per-tile scratch, laid out as consecutive arrays of n_tiles words (int64
// words, used as uint64_t where noted), then offs[n_tiles + 1].
struct AggScratch {
  unsigned long long* pre_sum;   // sum over the leading continuation
  unsigned long long* pre_min;   // its coordinate minimum
  unsigned long long* tail_sum;  // open last run: partial, then resolved
  unsigned long long* tail_min;
  long long* flags;              // bit 0: has a boundary; bit 1: open run
  long long* offs;               // emits per tile, then exclusive offsets;
                                 // offs[n_tiles] = total
};

__host__ __device__ inline AggScratch agg_scratch(long long* base,
                                                  long long n_tiles) {
  AggScratch s;
  s.pre_sum = (unsigned long long*)base;
  s.pre_min = (unsigned long long*)(base + n_tiles);
  s.tail_sum = (unsigned long long*)(base + 2 * n_tiles);
  s.tail_min = (unsigned long long*)(base + 3 * n_tiles);
  s.flags = base + 4 * n_tiles;
  s.offs = base + 5 * n_tiles;
  return s;
}

__device__ __forceinline__ uint32_t sat32(unsigned long long sum) {
  return sum > 0xFFFFFFFFull ? 0xFFFFFFFFu : (uint32_t)sum;
}

__device__ __forceinline__ bool in_range(unsigned long long sum, uint32_t lo,
                                         uint32_t hi) {
  const uint32_t c = sat32(sum);
  return c >= lo && c <= hi;
}

// Saturating addition: for non-negative terms it is associative and equals
// the saturation of the exact sum, so 32 bits carry every partial run sum.
__device__ __forceinline__ uint32_t sat_add(uint32_t a, uint32_t b) {
  const uint32_t s = a + b;
  return s < a ? 0xFFFFFFFFu : s;
}

__device__ __forceinline__ unsigned long long umin64(unsigned long long a,
                                                     unsigned long long b) {
  return a < b ? a : b;
}

__device__ __forceinline__ unsigned long long warp_min(unsigned long long v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v = umin64(v, __shfl_xor_sync(kFull, v, d));
  return v;
}

// The aggregate of a stretch of entries: whether it holds a boundary (then
// sum and mn run from its last boundary), the saturated count sum and the
// coordinate minimum.
struct Agg {
  int f;
  uint32_t sum;
  unsigned long long mn;
};

// a followed by b.
__device__ __forceinline__ Agg agg_then(Agg a, Agg b) {
  if (b.f) return b;
  return Agg{a.f, sat_add(a.sum, b.sum), umin64(a.mn, b.mn)};
}

template <bool kMin>
__device__ __forceinline__ Agg agg_shfl_up(Agg a, int d) {
  Agg x;
  x.f = __shfl_up_sync(kFull, a.f, d);
  x.sum = __shfl_up_sync(kFull, a.sum, d);
  x.mn = kMin ? __shfl_up_sync(kFull, a.mn, d) : kNoCoord;
  return x;
}

// v[r] holds the warp's entry 32 r + lane (a coalesced load); returns with
// v[i] = entry kAggIpt lane + i, through the warp's staging buffer.
template <typename T>
__device__ __forceinline__ void to_blocked(T (&v)[kAggIpt], T* buf,
                                           int lane) {
#pragma unroll
  for (int r = 0; r < kAggIpt; ++r) buf[staged<T>(32 * r + lane)] = v[r];
  __syncwarp();
#pragma unroll
  for (int i = 0; i < kAggIpt; ++i) v[i] = buf[staged<T>(kAggIpt * lane + i)];
  __syncwarp();
}

// Shared memory of one tile: each warp's staging buffer and aggregates.
struct AggShared {
  unsigned long long stage[kWarps][kStage];
  Agg warp_agg[kWarps];
  int warp_first[kWarps];  // each warp's first boundary (len when none)
  int warp_last[kWarps];   // and its last (-1 when none)
  int warp_emit[kWarps];   // runs each warp emits
  int end_live;            // the tile's last entry is live
};

// A tile's runs, in registers.  Warp w holds the tile's entries [kSpan w,
// kSpan (w + 1)), lane l the kAggIpt consecutive ones from kSpan w +
// kAggIpt l (j = kSpan w + kAggIpt l + i for i < kAggIpt).
template <typename K>
struct TileRuns {
  K k[kAggIpt];
  uint32_t s[kAggIpt];             // the live entry's segment sum up to it
  unsigned long long m[kAggIpt];   // and coordinate minimum (with kMin)
  unsigned live;                   // bit i: entry i is live
  unsigned ends;                   // bit i: the next entry is a boundary or
                                   // lies past the tile
  unsigned head;                   // bit i: its segment is headed in the tile
  int first_b, last_b;             // the tile's first (len when none) and
                                   // last (-1) boundaries
};

// Loads tile [start, start + len) and leaves in s[i] (with kMin also m[i])
// the aggregate of live entry i's segment from its start, or from the
// tile's start for the leading continuation, up to the entry.  An entry
// starts a segment (is a boundary) when it is dead, the array's first, or
// its key differs from the previous entry's; a live boundary heads a run.
// Each lane scans its entries in order, one warp scan of the lanes'
// aggregates and one pass over the warps' give the carries.  One barrier.
template <typename K, bool kSent, bool kMin>
__device__ __forceinline__ void tile_runs(const K* __restrict__ key,
                                          const uint32_t* __restrict__ cnt,
                                          const uint64_t* __restrict__ crd,
                                          long long start, int len,
                                          AggShared& sm, TileRuns<K>& R) {
  const int tid = (int)threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int w0 = warp * kSpan;             // the warp's first entry
  const long long g0 = start + w0;
  const int wlen = len - w0 < 0 ? 0 : (len - w0 < kSpan ? len - w0 : kSpan);
  // every load issued before any is used: striped, coalesced
#pragma unroll
  for (int r = 0; r < kAggIpt; ++r) {
    const int e = 32 * r + lane;
    R.k[r] = e < wlen ? key[g0 + e] : K(0);
    R.s[r] = e < wlen ? cnt[g0 + e] : 0u;
    if (kMin) R.m[r] = e < wlen ? crd[g0 + e] : kNoCoord;
  }
  // the entries just before and after the warp's span
  const K before = w0 < len && g0 > 0 ? key[g0 - 1] : K(0);
  const K after = w0 + kSpan < len ? key[g0 + kSpan] : K(0);
  to_blocked<K>(R.k, (K*)sm.stage[warp], lane);
  to_blocked<uint32_t>(R.s, (uint32_t*)sm.stage[warp], lane);
  if (kMin) to_blocked<unsigned long long>(R.m, sm.stage[warp], lane);
  // lane l's neighbours: the last entry of lane l - 1, the first of l + 1
  K prev = (K)__shfl_up_sync(kFull, (unsigned long long)R.k[kAggIpt - 1], 1);
  K next = (K)__shfl_down_sync(kFull, (unsigned long long)R.k[0], 1);
  if (lane == 0) prev = before;
  if (lane == 31) next = after;
  const int j0 = w0 + kAggIpt * lane;
  Agg a{0, 0u, kNoCoord};
  unsigned bnds = 0u;
  R.live = R.ends = 0u;
#pragma unroll
  for (int i = 0; i < kAggIpt; ++i) {
    const int j = j0 + i;
    const K kp = i == 0 ? prev : R.k[i - 1];
    const K kn = i + 1 == kAggIpt ? next : R.k[i + 1];
    const bool live = j < len && (!kSent || R.k[i] != ~K(0));
    const bool bnd = j < len && (!live || start + j == 0 || R.k[i] != kp);
    const uint32_t v = live ? R.s[i] : 0u;
    const unsigned long long mv = kMin && live ? R.m[i] : kNoCoord;
    if (bnd) {
      a = Agg{1, v, mv};
    } else {
      a.sum = sat_add(a.sum, v);
      if (kMin) a.mn = umin64(a.mn, mv);
    }
    R.s[i] = a.sum;
    if (kMin) R.m[i] = a.mn;
    bnds |= bnd ? 1u << i : 0u;
    R.live |= live ? 1u << i : 0u;
    R.ends |= j + 1 >= len || kn != R.k[i] ? 1u << i : 0u;
    if (j == len - 1) sm.end_live = live ? 1 : 0;
  }
  // exclusive segmented scan of the lanes' aggregates
  Agg inc = a;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Agg x = agg_shfl_up<kMin>(inc, d);
    if (lane >= d) inc = agg_then(x, inc);
  }
  Agg excl = agg_shfl_up<kMin>(inc, 1);
  if (lane == 0) excl = Agg{0, 0u, kNoCoord};
  const int first =
      __reduce_min_sync(kFull, bnds ? j0 + __ffs(bnds) - 1 : len);
  const int last = __reduce_max_sync(kFull, bnds ? j0 + 31 - __clz(bnds) : -1);
  if (lane == 31) sm.warp_agg[warp] = inc;
  if (lane == 0) {
    sm.warp_first[warp] = first;
    sm.warp_last[warp] = last;
  }
  __syncthreads();
  Agg carry{0, 0u, kNoCoord};
  R.first_b = len;
  R.last_b = -1;
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) carry = agg_then(carry, sm.warp_agg[w]);
    R.first_b = R.first_b < sm.warp_first[w] ? R.first_b : sm.warp_first[w];
    R.last_b = R.last_b > sm.warp_last[w] ? R.last_b : sm.warp_last[w];
  }
  carry = agg_then(carry, excl);
  // the entries before the lane's first boundary take the carry
  const unsigned lead = bnds ? (bnds & (0u - bnds)) - 1u : ~0u;
  R.head = ~lead;
#pragma unroll
  for (int i = 0; i < kAggIpt; ++i) {
    if ((lead >> i) & 1u) {
      R.s[i] = sat_add(carry.sum, R.s[i]);
      if (kMin) R.m[i] = umin64(carry.mn, R.m[i]);
      R.head |= carry.f ? 1u << i : 0u;
    }
  }
}

template <typename K, bool kCrd, bool kSent>
__global__ void __launch_bounds__(kThreads, 3)
agg_summary_kernel(const K* __restrict__ key, const uint32_t* __restrict__ cnt,
                   const uint64_t* __restrict__ crd, long long n, uint32_t lo,
                   uint32_t hi, long long* scratch, long long n_tiles) {
  __shared__ AggShared sm;
  __shared__ int s_closed[kWarps];
  __shared__ unsigned long long s_min[2][kWarps];
  __shared__ uint32_t s_pre, s_tail;
  const AggScratch S = agg_scratch(scratch, n_tiles);
  const int tid = (int)threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long t = blockIdx.x;
  const long long start = t * kAggTile;
  const int len = (int)(n - start < kAggTile ? n - start : kAggTile);
  if (tid == 0) {
    s_pre = 0u;
    s_tail = 0u;
  }
  // coordinates of the tile's first and last 32 entries, the common
  // leading continuation and open run, loaded ahead
  unsigned long long c_first = kNoCoord, c_last = kNoCoord;
  if (kCrd && warp == 0 && lane < len) c_first = crd[start + lane];
  if (kCrd && warp == kWarps - 1 && len - 32 + lane >= 0) {
    c_last = crd[start + len - 32 + lane];
  }
  TileRuns<K> R;
  tile_runs<K, kSent, false>(key, cnt, crd, start, len, sm, R);
  const int j0 = warp * kSpan + kAggIpt * lane;
  int closed = 0;
#pragma unroll
  for (int i = 0; i < kAggIpt; ++i) {
    if (!((R.live & R.ends) >> i & 1u)) continue;
    const uint32_t s = R.s[i];
    if (!((R.head >> i) & 1u)) {
      s_pre = s;  // the end of the leading continuation
    } else if (j0 + i + 1 < len) {
      closed += s >= lo && s <= hi ? 1 : 0;
    } else {
      s_tail = s;  // the tile's last run reaches its end
    }
  }
  const bool open = R.last_b >= 0 && sm.end_live;
  if (kCrd) {  // only the leading continuation's and the open run's
    unsigned long long pmin = kNoCoord, tmin = kNoCoord;
    if (R.first_b <= 32 && (!open || R.last_b >= len - 32)) {
      if (warp == 0 && lane < R.first_b) pmin = c_first;
      if (open && warp == kWarps - 1 && len - 32 + lane >= R.last_b) {
        tmin = c_last;
      }
    } else {
#pragma unroll
      for (int r = 0; r < kAggIpt; ++r) {
        const int j = r * kThreads + tid;
        if (j < R.first_b) {
          pmin = umin64(pmin, crd[start + j]);
        } else if (open && j >= R.last_b && j < len) {
          tmin = umin64(tmin, crd[start + j]);
        }
      }
    }
    pmin = warp_min(pmin);
    tmin = warp_min(tmin);
    if (lane == 0) {
      s_min[0][warp] = pmin;
      s_min[1][warp] = tmin;
    }
  }
  closed = __reduce_add_sync(kFull, closed);
  if (lane == 0) s_closed[warp] = closed;
  __syncthreads();
  if (tid == 0) {
    int total = 0;
    unsigned long long pmin = kNoCoord, tmin = kNoCoord;
    for (int w = 0; w < kWarps; ++w) {
      total += s_closed[w];
      if (kCrd) {
        pmin = umin64(pmin, s_min[0][w]);
        tmin = umin64(tmin, s_min[1][w]);
      }
    }
    S.pre_sum[t] = s_pre;
    S.pre_min[t] = pmin;
    S.tail_sum[t] = s_tail;
    S.tail_min[t] = tmin;
    S.flags[t] = (R.first_b < len ? 1 : 0) | (open ? 2 : 0);
    S.offs[t] = total;
  }
}

// One thread per tile: decide the tile's open last run, if any, by walking
// the leading continuations of the following tiles.
__global__ void agg_resolve_kernel(long long* scratch, long long n_tiles,
                                   uint32_t lo, uint32_t hi) {
  const AggScratch S = agg_scratch(scratch, n_tiles);
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_tiles || !(S.flags[t] & 2)) return;
  unsigned long long sum = S.tail_sum[t];
  unsigned long long mn = S.tail_min[t];
  for (long long u = t + 1; u < n_tiles; ++u) {
    sum += S.pre_sum[u];
    mn = umin64(mn, S.pre_min[u]);
    if (S.flags[u] & 1) break;
  }
  S.tail_sum[t] = sum;
  S.tail_min[t] = mn;
  if (in_range(sum, lo, hi)) S.offs[t] += 1;
}

// Exclusive scan of offs[0, n) in place, offs[n] = total; one block.
__global__ void __launch_bounds__(kScanThreads)
scan_kernel(long long* offs, long long n) {
  __shared__ long long s[kScanThreads];
  const int tid = (int)threadIdx.x;
  const long long per = (n + kScanThreads - 1) / kScanThreads;
  const long long beg = tid * per < n ? tid * per : n;
  const long long end = beg + per < n ? beg + per : n;
  long long sum = 0;
  for (long long i = beg; i < end; ++i) sum += offs[i];
  s[tid] = sum;
  __syncthreads();
  for (int off = 1; off < kScanThreads; off <<= 1) {
    const long long x = tid >= off ? s[tid - off] : 0;
    __syncthreads();
    s[tid] += x;
    __syncthreads();
  }
  long long run = s[tid] - sum;
  for (long long i = beg; i < end; ++i) {
    const long long x = offs[i];
    offs[i] = run;
    run += x;
  }
  if (tid == kScanThreads - 1) offs[n] = s[tid];
}

// Writes array v's emitted entries (bits of emit) of each lane at
// out[base + pos ...) in order: staged in the warp's buffer at the lane's
// offset pos, then stored by the whole warp, lane x writing entries x, x +
// 32, ..., so the stores are coalesced.
template <typename T>
__device__ __forceinline__ void emit_array(const T (&v)[kAggIpt],
                                           unsigned emit, int pos, int total,
                                           T* buf, T* __restrict__ out,
                                           long long base, int lane) {
#pragma unroll
  for (int i = 0; i < kAggIpt; ++i) {
    if ((emit >> i) & 1u) buf[staged<T>(pos++)] = v[i];
  }
  __syncwarp();
  for (int x = lane; x < total; x += 32) out[base + x] = buf[staged<T>(x)];
  __syncwarp();
}

// Each tile recomputes its runs with their coordinate minima; each kept run
// is emitted by the lane holding its last entry, at the tile's offset + the
// runs of the warps and lanes before it.
template <typename K, bool kCrd, bool kSent>
__global__ void __launch_bounds__(kThreads, kCrd ? 2 : 3)
agg_emit_kernel(const K* __restrict__ key, const uint32_t* __restrict__ cnt,
                const uint64_t* __restrict__ crd, long long n, uint32_t lo,
                uint32_t hi, long long* scratch, long long n_tiles,
                K* __restrict__ o_key, uint32_t* __restrict__ o_cnt,
                uint64_t* __restrict__ o_crd) {
  __shared__ AggShared sm;
  const AggScratch S = agg_scratch(scratch, n_tiles);
  const int tid = (int)threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long t = blockIdx.x;
  const long long start = t * kAggTile;
  const int len = (int)(n - start < kAggTile ? n - start : kAggTile);
  const long long tile_off = S.offs[t];
  TileRuns<K> R;
  tile_runs<K, kSent, kCrd>(key, cnt, crd, start, len, sm, R);
  const int j0 = warp * kSpan + kAggIpt * lane;
  unsigned emit = 0u;
#pragma unroll
  for (int i = 0; i < kAggIpt; ++i) {
    if (!((R.live & R.ends & R.head) >> i & 1u)) continue;
    bool e;
    if (j0 + i + 1 < len) {
      e = R.s[i] >= lo && R.s[i] <= hi;
    } else {  // the open last run, resolved across the following tiles
      const unsigned long long sum = S.tail_sum[t];
      e = in_range(sum, lo, hi);
      R.s[i] = sat32(sum);
      if (kCrd) R.m[i] = S.tail_min[t];
    }
    emit |= e ? 1u << i : 0u;
  }
  const int mine = __popc(emit);
  int inc = mine;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int x = __shfl_up_sync(kFull, inc, d);
    if (lane >= d) inc += x;
  }
  if (lane == 31) sm.warp_emit[warp] = inc;
  __syncthreads();
  long long base = tile_off;
  for (int w = 0; w < warp; ++w) base += sm.warp_emit[w];
  const int total = sm.warp_emit[warp];
  const int pos = inc - mine;
  emit_array<K>(R.k, emit, pos, total, (K*)sm.stage[warp], o_key, base, lane);
  emit_array<uint32_t>(R.s, emit, pos, total, (uint32_t*)sm.stage[warp],
                       o_cnt, base, lane);
  if (kCrd) {
    emit_array<unsigned long long>(R.m, emit, pos, total, sm.stage[warp],
                                   (unsigned long long*)o_crd, base, lane);
  }
  if (kSent) {  // all ones past the last emitted entry
    const long long all = S.offs[n_tiles];
    for (int j = tid; j < len; j += kThreads) {
      const long long i = start + j;
      if (i < all) continue;
      o_key[i] = ~K(0);
      o_cnt[i] = 0xFFFFFFFFu;
      if (kCrd) o_crd[i] = ~0ull;
    }
  }
}

// ---------------------------------------------------------------------------
// stable compaction (K7)
// ---------------------------------------------------------------------------

constexpr int kMaxArrays = 5;
constexpr int kLiveThreads = 256;   // threads per block
constexpr int kLiveIpt = 16;        // entries per thread
constexpr int kLiveWarps = kLiveThreads / 32;
constexpr int kLiveTile = kLiveThreads * kLiveIpt;
constexpr int kRanks = kLiveIpt * kLiveWarps;    // (round, warp) live counts
constexpr int kRanksPerLane = (kRanks + 31) / 32;
// two staging buffers used in turn where they fit in the 48 KB of static
// shared memory, else one (and a second barrier per array)
constexpr int kLiveBufs =
    2 * kLiveTile * 4 + 4 * kRanks + 64 <= 48 * 1024 ? 2 : 1;
static_assert(kLiveThreads % 32 == 0 && kLiveThreads <= 1024,
              "K7: whole warps, at most 1024 threads");
static_assert(kLiveIpt <= 32 && kLiveTile * 4 + 4 * kRanks + 64 <= 48 * 1024,
              "K7: the tile must fit in static shared memory");

// A tile's status word: a flag in bits 62-63 (0: nothing published yet),
// the live count of the tile (aggregate) or of the tiles up to it
// (inclusive prefix) below.
constexpr unsigned long long kAggregate = 1ull << 62;
constexpr unsigned long long kPrefix = 2ull << 62;
constexpr unsigned long long kCountBits = kAggregate - 1;

using StatusRef =
    cuda::atomic_ref<unsigned long long, cuda::thread_scope_device>;

__device__ __forceinline__ void publish(unsigned long long* word,
                                        unsigned long long v) {
  StatusRef(*word).store(v, cuda::std::memory_order_release);
}

__device__ __forceinline__ unsigned long long status_of(
    unsigned long long* word) {
  return StatusRef(*word).load(cuda::std::memory_order_acquire);
}

struct CompactArrays {
  const uint32_t* in[kMaxArrays];
  uint32_t* out[kMaxArrays];
};

// The live entries of the tiles before tile t > 0, by one warp.  Tile t's
// aggregate is published first.  The warp then reads the status words of
// tiles [end - 32, end), lane 31 the nearest, each lane waiting until its
// word is no longer empty, and adds the counts from the nearest inclusive
// prefix on; without one it adds all 32 and reads the 32 tiles before.
// Every tile before t has drawn its id, so its block is running and
// publishes its aggregate without waiting on anything: the wait ends.
// Tile t then publishes its inclusive prefix.
__device__ long long look_back(unsigned long long* status, long long t,
                               int live, int lane) {
  if (lane == 0) publish(status + t, kAggregate | (unsigned long long)live);
  long long excl = 0;
  for (long long end = t;; end -= 32) {
    const long long u = end - 32 + lane;
    unsigned long long w = kPrefix;        // before tile 0: a prefix of 0
    if (u >= 0) {
      do {
        w = status_of(status + u);
      } while (w >> 62 == 0);
    }
    const unsigned pre = __ballot_sync(kFull, (w & ~kCountBits) == kPrefix);
    const int from = pre ? 31 - __clz(pre) : 0;
    long long c = lane >= from ? (long long)(w & kCountBits) : 0;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) c += __shfl_xor_sync(kFull, c, d);
    excl += c;
    if (pre) break;
  }
  if (lane == 0) {
    publish(status + t, kPrefix | (unsigned long long)(excl + live));
  }
  return excl;
}

// One tile per block, drawn from *next_tile; see the header.  status[t] is
// tile t's status word, *n_live receives the live count; all three zeroed
// before the launch.
template <int kNarr>
__global__ void __launch_bounds__(kLiveThreads)
compact_kernel(CompactArrays a, long long n, long long n_tiles,
               unsigned long long* status, unsigned* next_tile,
               long long* n_live) {
  __shared__ uint32_t s_buf[kLiveBufs][kLiveTile];
  __shared__ int s_rank[kRanks];  // (round, warp) counts, then offsets
  __shared__ long long s_excl;
  __shared__ int s_live;
  __shared__ unsigned s_tile;
  const int tid = (int)threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) s_tile = atomicAdd(next_tile, 1u);
  __syncthreads();
  const long long t = s_tile;
  const long long start = t * kLiveTile;
  const int len = (int)(n - start < kLiveTile ? n - start : kLiveTile);
  // every load issued before anything waits on another tile: the liveness
  // word, then the other arrays' words of the live entries
  uint32_t v[kNarr][kLiveIpt];
#pragma unroll
  for (int r = 0; r < kLiveIpt; ++r) {
    const int j = r * kLiveThreads + tid;
    v[0][r] = j < len ? a.in[0][start + j] : ~0u;
  }
#pragma unroll
  for (int q = 1; q < kNarr; ++q) {
#pragma unroll
    for (int r = 0; r < kLiveIpt; ++r) {
      const int j = r * kLiveThreads + tid;
      v[q][r] = v[0][r] != ~0u ? a.in[q][start + j] : 0u;
    }
  }
  // ranks in the tile: a ballot per round, one warp scan of the counts in
  // entry order (round-major, then warp)
  unsigned ballot[kLiveIpt];
#pragma unroll
  for (int r = 0; r < kLiveIpt; ++r) {
    ballot[r] = __ballot_sync(kFull, v[0][r] != ~0u);
    if (lane == 0) s_rank[r * kLiveWarps + warp] = __popc(ballot[r]);
  }
  __syncthreads();
  if (warp == 0) {
    int c[kRanksPerLane];
    int sum = 0;
#pragma unroll
    for (int i = 0; i < kRanksPerLane; ++i) {
      const int k = lane * kRanksPerLane + i;
      c[i] = k < kRanks ? s_rank[k] : 0;
      sum += c[i];
    }
    int inc = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int x = __shfl_up_sync(kFull, inc, d);
      if (lane >= d) inc += x;
    }
    int run = inc - sum;
#pragma unroll
    for (int i = 0; i < kRanksPerLane; ++i) {
      const int k = lane * kRanksPerLane + i;
      if (k < kRanks) s_rank[k] = run;
      run += c[i];
    }
    const int live = __shfl_sync(kFull, inc, 31);
    long long excl = 0;
    if (t > 0) {
      excl = look_back(status, t, live, lane);
    } else if (lane == 0) {
      publish(status, kPrefix | (unsigned long long)live);
    }
    if (lane == 0) {
      s_excl = excl;
      s_live = live;
      if (t == n_tiles - 1) *n_live = excl + live;
    }
  }
  __syncthreads();
  const long long excl = s_excl;
  const int live = s_live;
  const unsigned below = (1u << lane) - 1u;
  int pos[kLiveIpt];  // each live entry's rank in the tile, -1 when dead
#pragma unroll
  for (int r = 0; r < kLiveIpt; ++r) {
    pos[r] = (ballot[r] >> lane) & 1u
                 ? s_rank[r * kLiveWarps + warp] + __popc(ballot[r] & below)
                 : -1;
  }
  // each array staged in order, then stored at [excl, excl + live)
#pragma unroll
  for (int q = 0; q < kNarr; ++q) {
    uint32_t* buf = s_buf[q % kLiveBufs];
    if (kLiveBufs == 1 && q > 0) __syncthreads();  // the last stores read it
#pragma unroll
    for (int r = 0; r < kLiveIpt; ++r) {
      if (pos[r] >= 0) buf[pos[r]] = v[q][r];
    }
    __syncthreads();
    uint32_t* out = a.out[q] + excl;
    for (int x = tid; x < live; x += kLiveThreads) out[x] = buf[x];
  }
  // all ones at [n - D - dead, n - D), D the dead entries before the tile
  const int dead = len - live;
  const long long f0 = n - (start - excl) - dead;
#pragma unroll
  for (int q = 0; q < kNarr; ++q) {
    for (int x = tid; x < dead; x += kLiveThreads) a.out[q][f0 + x] = ~0u;
  }
}

template <typename K, bool kCnt, bool kCrd>
int merge_typed(const void* a_key, const void* a_cnt, const void* a_crd,
                long long na, const void* b_key, const void* b_crd,
                long long nb, void* o_key, void* o_cnt, void* o_crd,
                long long n_out, cudaStream_t st) {
  const long long blocks = (n_out + kMergeTile - 1) / kMergeTile;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidConfiguration;
  constexpr int smem = merge_smem_bytes<K, kCnt || kCrd>();
  if (smem > 48 * 1024) {  // only tiles larger than the kernels' own
    const int rc = (int)cudaFuncSetAttribute(
        merge_kernel<K, kCnt, kCrd>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != 0) return rc;
  }
  merge_kernel<K, kCnt, kCrd><<<(unsigned)blocks, kThreads, smem, st>>>(
      (const K*)a_key, (const uint32_t*)a_cnt, (const uint64_t*)a_crd, na,
      (const K*)b_key, (const uint64_t*)b_crd, nb, (K*)o_key,
      (uint32_t*)o_cnt, (uint64_t*)o_crd, n_out);
  return (int)cudaGetLastError();
}

template <typename K, bool kCnt>
int merge_crd(int has_crd, const void* a_key, const void* a_cnt,
              const void* a_crd, long long na, const void* b_key,
              const void* b_crd, long long nb, void* o_key, void* o_cnt,
              void* o_crd, long long n_out, cudaStream_t st) {
  return has_crd ? merge_typed<K, kCnt, true>(a_key, a_cnt, a_crd, na, b_key,
                                              b_crd, nb, o_key, o_cnt, o_crd,
                                              n_out, st)
                 : merge_typed<K, kCnt, false>(a_key, a_cnt, a_crd, na, b_key,
                                               b_crd, nb, o_key, o_cnt, o_crd,
                                               n_out, st);
}

template <typename K, bool kCrd, bool kSent>
int aggregate_typed(const void* key, const void* cnt, const void* crd,
                    long long n, uint32_t lo, uint32_t hi, void* o_key,
                    void* o_cnt, void* o_crd, long long* scratch,
                    cudaStream_t st) {
  const long long n_tiles = (n + kAggTile - 1) / kAggTile;
  if (n_tiles > 0x7FFFFFFFLL) return (int)cudaErrorInvalidConfiguration;
  agg_summary_kernel<K, kCrd, kSent><<<(unsigned)n_tiles, kThreads, 0, st>>>(
      (const K*)key, (const uint32_t*)cnt, (const uint64_t*)crd, n, lo, hi,
      scratch, n_tiles);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  const unsigned rblocks = (unsigned)((n_tiles + kThreads - 1) / kThreads);
  agg_resolve_kernel<<<rblocks, kThreads, 0, st>>>(scratch, n_tiles, lo, hi);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  scan_kernel<<<1, kScanThreads, 0, st>>>(agg_scratch(scratch, n_tiles).offs,
                                          n_tiles);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  agg_emit_kernel<K, kCrd, kSent><<<(unsigned)n_tiles, kThreads, 0, st>>>(
      (const K*)key, (const uint32_t*)cnt, (const uint64_t*)crd, n, lo, hi,
      scratch, n_tiles, (K*)o_key, (uint32_t*)o_cnt, (uint64_t*)o_crd);
  return (int)cudaGetLastError();
}

template <typename K>
int aggregate_key(int has_crd, int sentinel, const void* key, const void* cnt,
                  const void* crd, long long n, uint32_t lo, uint32_t hi,
                  void* o_key, void* o_cnt, void* o_crd, long long* scratch,
                  cudaStream_t st) {
  if (has_crd) {
    return sentinel ? aggregate_typed<K, true, true>(key, cnt, crd, n, lo, hi,
                                                     o_key, o_cnt, o_crd,
                                                     scratch, st)
                    : aggregate_typed<K, true, false>(key, cnt, crd, n, lo, hi,
                                                      o_key, o_cnt, o_crd,
                                                      scratch, st);
  }
  return sentinel ? aggregate_typed<K, false, true>(key, cnt, crd, n, lo, hi,
                                                    o_key, o_cnt, o_crd,
                                                    scratch, st)
                  : aggregate_typed<K, false, false>(key, cnt, crd, n, lo, hi,
                                                     o_key, o_cnt, o_crd,
                                                     scratch, st);
}

}  // namespace

// int64 words of scratch that launch_aggregate needs for n entries.
extern "C" long long aggregate_scratch_words(long long n) {
  const long long n_tiles = (n + kAggTile - 1) / kAggTile;
  return 6 * n_tiles + 1;
}

// Entries per tile of K4/K6 (ops/merge.py's AGG_TILE).
extern "C" int aggregate_tile_entries() { return kAggTile; }

// Outputs per tile of K3/K5 (ops/merge.py's MERGE_TILE).
extern "C" int merge_tile_entries() { return kMergeTile; }

// K3 (has_cnt = 1) and K5 (has_cnt = 0): stable merge of a[0, na) and
// b[0, nb), A first on ties; writes the first n_out <= na + nb outputs.
// Keys are key_bytes (4 or 8) unsigned words; counts u32 (A side only, B
// entries count 1); coordinates u64 on both sides when has_crd.
extern "C" int launch_merge(int key_bytes, int has_cnt, int has_crd,
                            const void* a_key, const void* a_cnt,
                            const void* a_crd, long long na,
                            const void* b_key, const void* b_crd,
                            long long nb, void* o_key, void* o_cnt,
                            void* o_crd, long long n_out, void* stream) {
  if (n_out <= 0) return (int)cudaSuccess;
  if (n_out > na + nb || (key_bytes != 4 && key_bytes != 8)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  if (key_bytes == 4) {
    return has_cnt ? merge_crd<uint32_t, true>(has_crd, a_key, a_cnt, a_crd,
                                               na, b_key, b_crd, nb, o_key,
                                               o_cnt, o_crd, n_out, st)
                   : merge_crd<uint32_t, false>(has_crd, a_key, a_cnt, a_crd,
                                                na, b_key, b_crd, nb, o_key,
                                                o_cnt, o_crd, n_out, st);
  }
  return has_cnt ? merge_crd<uint64_t, true>(has_crd, a_key, a_cnt, a_crd, na,
                                             b_key, b_crd, nb, o_key, o_cnt,
                                             o_crd, n_out, st)
                 : merge_crd<uint64_t, false>(has_crd, a_key, a_cnt, a_crd, na,
                                              b_key, b_crd, nb, o_key, o_cnt,
                                              o_crd, n_out, st);
}

// K4 (sentinel = 0: entries [0, n) live) and K6 (sentinel = 1: an entry is
// live when its key is not all ones; dead entries trail; the output past
// n_live is filled with all ones): aggregate runs of equal keys, keep those
// with lo <= count <= hi, compact.  scratch holds aggregate_scratch_words(n)
// int64 words; its last word receives n_live.
extern "C" int launch_aggregate(int key_bytes, int has_crd, int sentinel,
                                const void* key, const void* cnt,
                                const void* crd, long long n, unsigned lo,
                                unsigned hi, void* o_key, void* o_cnt,
                                void* o_crd, void* scratch, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (key_bytes == 4) {
    return aggregate_key<uint32_t>(has_crd, sentinel, key, cnt, crd, n, lo, hi,
                                   o_key, o_cnt, o_crd, (long long*)scratch,
                                   st);
  }
  if (key_bytes == 8) {
    return aggregate_key<uint64_t>(has_crd, sentinel, key, cnt, crd, n, lo, hi,
                                   o_key, o_cnt, o_crd, (long long*)scratch,
                                   st);
  }
  return (int)cudaErrorInvalidValue;
}

// int64 words of scratch that launch_compact needs for n entries: a status
// word per tile, the tile counter, then the live count.
extern "C" long long compact_scratch_words(long long n) {
  return (n + kLiveTile - 1) / kLiveTile + 2;
}

// Entries per tile of K7 (ops/merge.py's LIVE_TILE).
extern "C" int compact_tile_entries() { return kLiveTile; }

// K7: stable compaction of narr (1-5) arrays of n u32 words.  An entry is
// live when ins[0] is not all ones; outs receive the live entries first, in
// order, and all ones after them.  ins and outs are host arrays of narr
// device pointers; scratch holds compact_scratch_words(n) int64 words,
// cleared here on the stream before the one kernel, and its last word
// receives the live count.
extern "C" int launch_compact(int narr, void* const* ins, void* const* outs,
                              long long n, void* scratch, void* stream) {
  if (narr < 1 || narr > kMaxArrays) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaSuccess;
  const long long n_tiles = (n + kLiveTile - 1) / kLiveTile;
  if (n_tiles > 0x7FFFFFFFLL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = (cudaStream_t)stream;
  CompactArrays a = {};
  for (int q = 0; q < narr; ++q) {
    a.in[q] = (const uint32_t*)ins[q];
    a.out[q] = (uint32_t*)outs[q];
  }
  long long* s = (long long*)scratch;
  int rc = (int)cudaMemsetAsync(
      s, 0, (size_t)compact_scratch_words(n) * sizeof(long long), st);
  if (rc != 0) return rc;
  unsigned long long* status = (unsigned long long*)s;
  unsigned* next_tile = (unsigned*)(s + n_tiles);
  long long* n_live = s + n_tiles + 1;
  const unsigned grid = (unsigned)n_tiles;
  switch (narr) {
    case 1:
      compact_kernel<1><<<grid, kLiveThreads, 0, st>>>(a, n, n_tiles, status,
                                                       next_tile, n_live);
      break;
    case 2:
      compact_kernel<2><<<grid, kLiveThreads, 0, st>>>(a, n, n_tiles, status,
                                                       next_tile, n_live);
      break;
    case 3:
      compact_kernel<3><<<grid, kLiveThreads, 0, st>>>(a, n, n_tiles, status,
                                                       next_tile, n_live);
      break;
    case 4:
      compact_kernel<4><<<grid, kLiveThreads, 0, st>>>(a, n, n_tiles, status,
                                                       next_tile, n_live);
      break;
    default:
      compact_kernel<5><<<grid, kLiveThreads, 0, st>>>(a, n, n_tiles, status,
                                                       next_tile, n_live);
  }
  return (int)cudaGetLastError();
}
