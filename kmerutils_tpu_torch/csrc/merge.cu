// Merge and run-aggregation kernels of the streaming count table, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernels of kmerutils_tpu/ops/merge_pallas.py:
//   K3  merge_fold_i32        (_merge_fold_kernel, split merge_path_partition_dyn)
//   K5  merge_sorted_u32      (_merge_kernel, split merge_path_partition)
//   K4  aggregate_fold_i32    (_aggfold_kernel, core _agg_tile_compute)
//   K6  aggregate_compact_u32 (_aggcompact_kernel, the same core)
//
// Entries are struct-of-arrays: an unsigned key (uint32_t, or uint64_t for
// k > 16), a uint32_t count, and optionally a uint64_t coordinate
// (read_num << 32 | pos, so the lexicographic minimum is the unsigned one).
// Keys compare as unsigned words: none of the TPU kernels' sign flips, key
// bias, reversed B side or aligned DMA windows is needed here.
//
// Merge (K3, K5): stable, A first on ties.  Grid over output tiles of
// kTile entries.  Each block finds its own merge-path split of A and B at
// the tile's two output diagonals (a binary search in device memory), loads
// the tile's A and B keys into shared memory, and each thread merges kIpt
// outputs from its own split in shared memory.  The block then writes keys,
// counts and coordinates coalesced, gathering payloads by source index.
// K3 is this kernel with a count word on the A side (the table) and an
// implicit count of 1 on the B side (the batch run); only the first n_out
// outputs are written, so merged entries past the table's capacity (the
// largest keys) are dropped.  K5 has no count word.  The output never
// aliases the inputs (a block would otherwise overwrite A entries another
// block has yet to read): the table is folded into a second buffer.
//
// Aggregation (K4, K6): one entry per run of equal keys, count = the sum of
// the run's counts saturated at 2^32 - 1 (summed in 64 bits: non-negative
// saturating addition is associative), coordinate = the run's minimum, kept
// when lo <= count <= hi, compacted stably.  CUDA blocks run in no order, so
// runs that cross a tile boundary are joined through per-tile summaries
// instead of the TPU's in-order SMEM carry:
//   1. summary: per tile, the aggregate of its leading continuation (the
//      elements before its first run boundary), whether it has a boundary,
//      the number of emitted runs that close inside it, and the partial
//      aggregate of its last run when that run reaches the tile's end;
//   2. resolve: per tile with such an open run, walk the following tiles'
//      leading continuations until a tile with a boundary, and decide the
//      open run (each tile is walked by one owner at most);
//   3. scan: exclusive scan of the per-tile emit counts (one block);
//   4. emit: each block recomputes its runs and writes them at its offset.
// K4 takes the live prefix [0, n) of a table; K6 a raw array whose dead
// entries (key all ones) trail, and fills the output past n_live with all
// ones.  Output and input are different buffers.
//
// What bounds them on this card: memory traffic.  Per entry the merge reads
// and writes the key, count and coordinate once (plus a log2(n) binary
// search per block); aggregation reads every entry twice (summary and emit)
// and writes each run once.  At 3.35 TB/s an 8 Mi-entry batch folded into a
// 40 M-entry table with u32 keys and counts moves about 0.77 GB, ~0.23 ms.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kIpt = 8;
constexpr int kTile = kThreads * kIpt;
constexpr int kScanThreads = 1024;
constexpr unsigned long long kNoCoord = ~0ull;

// Number of A elements among the first d outputs of the stable (A first)
// merge of sorted a[0, na) and b[0, nb): the largest x with a[x-1] <= b[d-x].
template <typename K, typename I>
__device__ __forceinline__ I merge_path(const K* a, I na, const K* b, I nb,
                                        I d) {
  I lo = d > nb ? d - nb : 0;
  I hi = d < na ? d : na;
  while (lo < hi) {
    const I mid = (lo + hi + 1) >> 1;
    if (a[mid - 1] <= b[d - mid]) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

template <typename K, bool kCnt, bool kCrd>
__global__ void __launch_bounds__(kThreads)
merge_kernel(const K* __restrict__ a_key, const uint32_t* __restrict__ a_cnt,
             const uint64_t* __restrict__ a_crd, long long na,
             const K* __restrict__ b_key, const uint64_t* __restrict__ b_crd,
             long long nb, K* __restrict__ o_key, uint32_t* __restrict__ o_cnt,
             uint64_t* __restrict__ o_crd, long long n_out) {
  __shared__ K s_key[kTile];
  __shared__ int s_src[kTile];
  __shared__ long long s_split[2];
  const int tid = (int)threadIdx.x;
  const long long d0 = (long long)blockIdx.x * kTile;
  const long long total = na + nb;
  const long long d1 = d0 + kTile < total ? d0 + kTile : total;
  if (tid < 2) {
    s_split[tid] = merge_path<K, long long>(a_key, na, b_key, nb,
                                            tid == 0 ? d0 : d1);
  }
  __syncthreads();
  const long long a0 = s_split[0];
  const long long b0 = d0 - a0;
  const int la = (int)(s_split[1] - a0);
  const int n = (int)(d1 - d0);
  const int lb = n - la;
  for (int j = tid; j < n; j += kThreads) {
    s_key[j] = j < la ? a_key[a0 + j] : b_key[b0 + (j - la)];
  }
  __syncthreads();
  // this thread's outputs [dl, dl + kIpt) of the tile
  const int dl = tid * kIpt < n ? tid * kIpt : n;
  int ia = merge_path<K, int>(s_key, la, s_key + la, lb, dl);
  int ib = dl - ia;
  for (int i = 0; i < kIpt && dl + i < n; ++i) {
    const bool take_a = ia < la && (ib >= lb || s_key[ia] <= s_key[la + ib]);
    s_src[dl + i] = take_a ? ia++ : la + ib++;
  }
  __syncthreads();
  const long long room = n_out - d0;
  const int n_write = room < n ? (int)room : n;
  for (int j = tid; j < n_write; j += kThreads) {
    const int s = s_src[j];
    const long long o = d0 + j;
    o_key[o] = s_key[s];
    if (s < la) {
      if (kCnt) o_cnt[o] = a_cnt[a0 + s];
      if (kCrd) o_crd[o] = a_crd[a0 + s];
    } else {
      if (kCnt) o_cnt[o] = 1u;
      if (kCrd) o_crd[o] = b_crd[b0 + (s - la)];
    }
  }
}

// ---------------------------------------------------------------------------
// aggregation
// ---------------------------------------------------------------------------

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

__device__ __forceinline__ bool in_range(unsigned long long sum, uint32_t lo,
                                         uint32_t hi) {
  const uint32_t c = sum > 0xFFFFFFFFull ? 0xFFFFFFFFu : (uint32_t)sum;
  return c >= lo && c <= hi;
}

__device__ __forceinline__ unsigned long long umin64(unsigned long long a,
                                                     unsigned long long b) {
  return a < b ? a : b;
}

// Flag bits of a tile element in shared memory.
constexpr unsigned char kBoundary = 1;  // not a continuation of the previous
constexpr unsigned char kHead = 2;      // first element of a live run

// Load tile [start, start + len) of the counts and coordinates into shared
// memory with each element's flags.  An element continues the previous
// one's run when it is live and has the same key; with kSent an element is
// live when its key is not all ones, otherwise every element below n is.
template <typename K, bool kCrd, bool kSent>
__device__ void load_tile(const K* key, const uint32_t* cnt,
                          const uint64_t* crd, long long start, int len,
                          uint32_t* s_cnt, unsigned long long* s_crd,
                          unsigned char* s_flag) {
  for (int j = (int)threadIdx.x; j < len; j += kThreads) {
    const long long i = start + j;
    const K k = key[i];
    const bool live = !kSent || k != ~K(0);
    const bool bnd = !live || i == 0 || k != key[i - 1];
    s_flag[j] = (unsigned char)((bnd ? kBoundary : 0) |
                                (bnd && live ? kHead : 0));
    s_cnt[j] = cnt[i];
    if (kCrd) s_crd[j] = crd[i];
  }
}

// Aggregate of the run whose head is at j, within the tile; returns whether
// the run closes inside the tile (false: it reaches the tile's end).
template <bool kCrd>
__device__ __forceinline__ bool walk_run(int j, int len, const uint32_t* s_cnt,
                                         const unsigned long long* s_crd,
                                         const unsigned char* s_flag,
                                         unsigned long long* sum,
                                         unsigned long long* mn) {
  unsigned long long s = s_cnt[j];
  unsigned long long m = kCrd ? s_crd[j] : kNoCoord;
  int e = j + 1;
  while (e < len && !(s_flag[e] & kBoundary)) {
    s += s_cnt[e];
    if (kCrd) m = umin64(m, s_crd[e]);
    ++e;
  }
  *sum = s;
  *mn = m;
  return e < len;
}

// Block-wide sum / min / exclusive scan through shared memory (every thread
// of the block calls them).
__device__ unsigned long long block_sum(unsigned long long v,
                                        unsigned long long* red) {
  const int tid = (int)threadIdx.x;
  __syncthreads();
  red[tid] = v;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] += red[tid + s];
    __syncthreads();
  }
  return red[0];
}

__device__ unsigned long long block_min(unsigned long long v,
                                        unsigned long long* red) {
  const int tid = (int)threadIdx.x;
  __syncthreads();
  red[tid] = v;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] = umin64(red[tid], red[tid + s]);
    __syncthreads();
  }
  return red[0];
}

__device__ unsigned long long block_exclusive_scan(unsigned long long v,
                                                   unsigned long long* red) {
  const int tid = (int)threadIdx.x;
  __syncthreads();
  red[tid] = v;
  __syncthreads();
  for (int off = 1; off < kThreads; off <<= 1) {
    const unsigned long long x = tid >= off ? red[tid - off] : 0ull;
    __syncthreads();
    red[tid] += x;
    __syncthreads();
  }
  return red[tid] - v;
}

template <typename K, bool kCrd, bool kSent>
__global__ void __launch_bounds__(kThreads)
agg_summary_kernel(const K* __restrict__ key, const uint32_t* __restrict__ cnt,
                   const uint64_t* __restrict__ crd, long long n, uint32_t lo,
                   uint32_t hi, long long* scratch, long long n_tiles) {
  __shared__ uint32_t s_cnt[kTile];
  __shared__ unsigned long long s_crd[kCrd ? kTile : 1];
  __shared__ unsigned char s_flag[kTile];
  __shared__ unsigned long long red[kThreads];
  __shared__ int s_open;
  const AggScratch S = agg_scratch(scratch, n_tiles);
  const int tid = (int)threadIdx.x;
  const long long t = blockIdx.x;
  const long long start = t * kTile;
  const int len = (int)(n - start < kTile ? n - start : kTile);
  if (tid == 0) s_open = 0;
  load_tile<K, kCrd, kSent>(key, cnt, crd, start, len, s_cnt, s_crd, s_flag);
  __syncthreads();
  const int j0 = tid * kIpt;
  const int j1 = j0 + kIpt < len ? j0 + kIpt : len;
  // first boundary of the tile (len when there is none)
  unsigned long long fb = (unsigned long long)len;
  for (int j = j0; j < j1; ++j) {
    if (s_flag[j] & kBoundary) {
      fb = (unsigned long long)j;
      break;
    }
  }
  const int first_b = (int)block_min(fb, red);
  // the leading continuation [0, first_b): part of a run from earlier tiles
  unsigned long long psum = 0, pmin = kNoCoord;
  for (int j = j0; j < j1 && j < first_b; ++j) {
    psum += s_cnt[j];
    if (kCrd) pmin = umin64(pmin, s_crd[j]);
  }
  psum = block_sum(psum, red);
  if (kCrd) pmin = block_min(pmin, red);
  // runs headed in this thread's elements
  unsigned long long closed = 0;
  for (int j = j0; j < j1; ++j) {
    if (!(s_flag[j] & kHead)) continue;
    unsigned long long sum, mn;
    if (walk_run<kCrd>(j, len, s_cnt, s_crd, s_flag, &sum, &mn)) {
      closed += in_range(sum, lo, hi) ? 1 : 0;
    } else {  // the tile's last run reaches its end: one thread at most
      S.tail_sum[t] = sum;
      S.tail_min[t] = mn;
      s_open = 1;
    }
  }
  closed = block_sum(closed, red);  // its barriers also publish s_open
  if (tid == 0) {
    S.pre_sum[t] = psum;
    S.pre_min[t] = pmin;
    S.flags[t] = (first_b < len ? 1 : 0) | (s_open ? 2 : 0);
    S.offs[t] = (long long)closed;
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

template <typename K, bool kCrd, bool kSent>
__global__ void __launch_bounds__(kThreads)
agg_emit_kernel(const K* __restrict__ key, const uint32_t* __restrict__ cnt,
                const uint64_t* __restrict__ crd, long long n, uint32_t lo,
                uint32_t hi, long long* scratch, long long n_tiles,
                K* __restrict__ o_key, uint32_t* __restrict__ o_cnt,
                uint64_t* __restrict__ o_crd) {
  __shared__ uint32_t s_cnt[kTile];
  __shared__ unsigned long long s_crd[kCrd ? kTile : 1];
  __shared__ unsigned char s_flag[kTile];
  __shared__ unsigned long long red[kThreads];
  const AggScratch S = agg_scratch(scratch, n_tiles);
  const int tid = (int)threadIdx.x;
  const long long t = blockIdx.x;
  const long long start = t * kTile;
  const int len = (int)(n - start < kTile ? n - start : kTile);
  load_tile<K, kCrd, kSent>(key, cnt, crd, start, len, s_cnt, s_crd, s_flag);
  __syncthreads();
  const int j0 = tid * kIpt;
  const int j1 = j0 + kIpt < len ? j0 + kIpt : len;
  // pass 1: how many runs this thread emits; pass 2: write them in order
  unsigned long long mine = 0;
  for (int pass = 0; pass < 2; ++pass) {
    long long o = 0;
    if (pass == 1) o = S.offs[t] + (long long)block_exclusive_scan(mine, red);
    for (int j = j0; j < j1; ++j) {
      if (!(s_flag[j] & kHead)) continue;
      unsigned long long sum, mn;
      if (!walk_run<kCrd>(j, len, s_cnt, s_crd, s_flag, &sum, &mn)) {
        sum = S.tail_sum[t];  // resolved across the following tiles
        mn = S.tail_min[t];
      }
      if (!in_range(sum, lo, hi)) continue;
      if (pass == 0) {
        ++mine;
        continue;
      }
      o_key[o] = key[start + j];
      o_cnt[o] = sum > 0xFFFFFFFFull ? 0xFFFFFFFFu : (uint32_t)sum;
      if (kCrd) o_crd[o] = mn;
      ++o;
    }
  }
  if (kSent) {  // all ones past the last emitted entry
    const long long total = S.offs[n_tiles];
    for (int j = tid; j < len; j += kThreads) {
      const long long i = start + j;
      if (i < total) continue;
      o_key[i] = ~K(0);
      o_cnt[i] = 0xFFFFFFFFu;
      if (kCrd) o_crd[i] = ~0ull;
    }
  }
}

template <typename K, bool kCnt, bool kCrd>
int merge_typed(const void* a_key, const void* a_cnt, const void* a_crd,
                long long na, const void* b_key, const void* b_crd,
                long long nb, void* o_key, void* o_cnt, void* o_crd,
                long long n_out, cudaStream_t st) {
  const long long blocks = (n_out + kTile - 1) / kTile;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidConfiguration;
  merge_kernel<K, kCnt, kCrd><<<(unsigned)blocks, kThreads, 0, st>>>(
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
  const long long n_tiles = (n + kTile - 1) / kTile;
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
  const long long n_tiles = (n + kTile - 1) / kTile;
  return 6 * n_tiles + 1;
}

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
