// The weights stage of ProbMinHash for Hopper (sm_90a): each row sorted and
// each position's run length, in one pass (KW).
//
// Not a replacement of a TPU kernel: the JAX package writes this stage as
// plain array code (kmerutils_tpu/sketch/probminhash.py: a jnp.sort of
// each row, then _run_multiplicities' cummax and reversed cummin) and XLA
// fuses it.  Eager PyTorch runs it as some twenty passes over [n, P]: a
// where, a sort that also fills and carries an int64 index nobody reads,
// two sign xors, and int64 scans, flips and index arrays.  This kernel
// computes, per row r of P positions (one block a row):
//   key      items[r, p] where valid[r, p], else the all-ones sentinel;
//   s        the keys sorted in unsigned order (the sentinels last);
//   is_real  s != sentinel (a real item equal to the sentinel is padding,
//            as in the JAX package);
//   winv     1 / (end - start) in IEEE float32 (1.0f / w, no fast math,
//            as torch's reciprocal gives it), where start is the last run
//            head at or before p (a real key unlike the key before it; -1
//            when there is none) and end the first stop after p (a head or
//            a padding position; P past the row).  At a real position that
//            is its run's length; at padding, p + 1 - (the last real run's
//            head), the plain version's values bit for bit.
//
// What bounds it: bytes, 14 a position at int32 (4 of item and 1 of valid
// in; 4 of s, 4 of winv and 1 of is_real out) and 22 at int64: ~91 MB, or
// ~27 us at 3.35 TB/s, for the ~6.5 M positions of a sketch call.  The
// sort is the work: a keys-only block radix sort (CUB's BlockRadixSort, 4
// bits a pass: 8 passes over shared memory at int32, 16 at int64), which
// costs more instructions and shared-memory traffic a key than the bytes
// allow, so the design keeps everything else to one read and one write.
//
// Design: a batch is length-sorted and padded to one width P, so one tile
// class (threads x keys a thread, a compile-time pair from the table
// below) serves every row of a call: launch_sort_weights takes the
// narrowest that holds P, and rows wider than every class take the wide
// route (weights_wide.cu).  A block loads its row striped (thread t takes
// positions t, t + threads, ...: each warp reads 128 or 256 contiguous
// bytes; rows start anywhere, so wider loads would not be aligned) and
// pads the tile past P with the sentinel.  The sort leaves the keys
// blocked (thread t holds positions t * ipt .. t * ipt + ipt - 1).  Heads
// compare each key with the one before it (the thread's own registers,
// and the previous thread's last key through shared memory).  Starts take
// an inclusive max of heads and ends an inclusive min of stops, forward
// and backward at once: in the thread's registers, across the warp by
// shuffles, and across warps through a word a warp in shared memory.  The
// sorted keys and winv go back to the striped order through shared memory
// (CUB's BlockExchange) and out coalesced.  The sort's storage is reused
// for both exchanges; above 48 KB it is dynamic shared memory.  No index
// array and no sign flip: CUB sorts unsigned keys in unsigned order.

#include <atomic>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cub/block/block_exchange.cuh>
#include <cub/block/block_radix_sort.cuh>

#include "weights.cuh"

namespace {

typedef unsigned long long u64;

// tile classes (threads, keys a thread), narrowest first; every row of a
// call takes the narrowest class whose tile holds P, and rows wider than
// the widest take the wide route.  The 32-bit classes come from a sweep at
// the sketch cell's row widths on an H100 (2-4 shapes a tile size, 32-1024
// threads, 4-32 keys a thread, 4-6 radix bits): within 6 % of the fastest
// at every width, 1.3 % over the cell's mix of widths, with CUB's default
// 4 radix bits.  The 64-bit classes (k > 16) double from 512 to 8,192
// positions, then hold 12,288 and 16,384: a row's tile is at most twice its
// width.  The two widest come from a sweep at the k=21 sketch cell's widths
// on an H100 (512 rows of 12,268 and of 16,364 positions; 384-1,024
// threads, 12-32 keys a thread): 384 x 32 took 0.278 ms at 12,268 (the
// other shapes 0.329-0.515, the wide route 0.867) and 512 x 32 0.399 ms at
// 16,364 (1,024 x 16 0.538, the wide route 1.144).  Each class pays for
// itself: without the 1,024 one, KW took 2.0x as long at P = 700 and
// 1,000 on an H100.
template <int T, int I>
struct Tile {
  static constexpr int kThreads = T;
  static constexpr int kIpt = I;
};
template <typename... Ts>
struct Tiles {};
using Tiles32 = Tiles<Tile<64, 8>, Tile<128, 8>, Tile<128, 16>, Tile<256, 12>,
                      Tile<256, 16>, Tile<512, 12>, Tile<512, 16>,
                      Tile<768, 16>, Tile<512, 32>>;
using Tiles64 = Tiles<Tile<64, 8>, Tile<128, 8>, Tile<256, 8>, Tile<256, 16>,
                      Tile<512, 16>, Tile<384, 32>, Tile<512, 32>>;

template <typename K, int kT, int kIpt>
struct Weights {
  static_assert(kT % 32 == 0 && kIpt <= 32, "whole warps, <= 32 keys");
  static constexpr int kTile = kT * kIpt;
  static constexpr int kWarps = kT / 32;
  using BlockSort = cub::BlockRadixSort<K, kT, kIpt>;
  using KeyExchange = cub::BlockExchange<K, kT, kIpt>;
  using WinvExchange = cub::BlockExchange<float, kT, kIpt>;
  struct Smem {
    union {
      typename BlockSort::TempStorage sort;
      typename KeyExchange::TempStorage keys;
      typename WinvExchange::TempStorage winv;
    } big;
    K last[kT];            // each thread's last sorted key
    int head_max[kWarps];  // each warp's last run head, -1 if none
    int stop_min[kWarps];  // each warp's first stop, kTile if none
  };
};

template <typename K, int kT, int kIpt>
__global__ void __launch_bounds__(kT)
sort_weights_kernel(const K* __restrict__ items,
                    const uint8_t* __restrict__ valid, K* __restrict__ sorted,
                    float* __restrict__ winv, uint8_t* __restrict__ is_real,
                    int P) {
  using W = Weights<K, kT, kIpt>;
  using BlockSort = typename W::BlockSort;
  using KeyExchange = typename W::KeyExchange;
  using WinvExchange = typename W::WinvExchange;
  constexpr K kSent = ~K(0);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  typename W::Smem& sm = *reinterpret_cast<typename W::Smem*>(smem_raw);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (t == 0) {
    // the host sized the storage from CUB's types: stop on a mismatch
    unsigned bytes;
    asm("mov.u32 %0, %%dynamic_smem_size;" : "=r"(bytes));
    if (bytes < sizeof(typename W::Smem)) __trap();
  }
  const long long off = (long long)blockIdx.x * P;
  items += off;
  valid += off;
  sorted += off;
  winv += off;
  is_real += off;

  K key[kIpt];
#pragma unroll
  for (int i = 0; i < kIpt; ++i) {
    const int p = i * kT + t;
    key[i] = kSent;
    if (p < P && valid[p]) key[i] = items[p];
  }
  BlockSort(sm.big.sort).Sort(key);       // blocked: p = t * kIpt + i
  sm.last[t] = key[kIpt - 1];
  __syncthreads();

  // heads (a real key unlike the key before it) and stops (a head or a
  // sentinel): the thread's last head and first stop
  const int base = t * kIpt;
  K prev = t > 0 ? sm.last[t - 1] : kSent;
  unsigned heads = 0, stops = 0;
  int head = -1, stop = W::kTile;
#pragma unroll
  for (int i = 0; i < kIpt; ++i) {
    const bool real = key[i] != kSent;
    const bool h = real && key[i] != prev;
    prev = key[i];
    heads |= (unsigned)h << i;
    stops |= (unsigned)(h || !real) << i;
    if (h) head = base + i;
    if ((h || !real) && stop == W::kTile) stop = base + i;
  }
  // the last head before this thread and the first stop after it: an
  // inclusive max forward and min backward across the warp, then the
  // warps before and after
  int hmax = head, smin = stop;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int a = __shfl_up_sync(0xFFFFFFFFu, hmax, d);
    const int b = __shfl_down_sync(0xFFFFFFFFu, smin, d);
    if (lane >= d) hmax = max(hmax, a);
    if (lane + d < 32) smin = min(smin, b);
  }
  if (lane == 31) sm.head_max[warp] = hmax;
  if (lane == 0) sm.stop_min[warp] = smin;
  int start = __shfl_up_sync(0xFFFFFFFFu, hmax, 1);
  int end = __shfl_down_sync(0xFFFFFFFFu, smin, 1);
  if (lane == 0) start = -1;
  if (lane == 31) end = W::kTile;
  __syncthreads();
  for (int w = 0; w < warp; ++w) start = max(start, sm.head_max[w]);
  for (int w = warp + 1; w < W::kWarps; ++w) end = min(end, sm.stop_min[w]);

  // every position: w = end - start >= 1 (a real position has a head at or
  // before it and a stop after it; padding p has end p + 1)
  int first[kIpt];
  float wv[kIpt];
#pragma unroll
  for (int i = 0; i < kIpt; ++i) {
    if ((heads >> i) & 1u) start = base + i;
    first[i] = start;
  }
#pragma unroll
  for (int i = kIpt - 1; i >= 0; --i) {
    wv[i] = 1.0f / (float)(end - first[i]);
    if ((stops >> i) & 1u) end = base + i;
  }

  // the sort's storage is free: every thread has passed the barrier after
  // it.  Back to striped order, then coalesced stores.
  KeyExchange(sm.big.keys).BlockedToStriped(key, key);
#pragma unroll
  for (int i = 0; i < kIpt; ++i) {
    const int p = i * kT + t;
    if (p < P) {
      sorted[p] = key[i];
      is_real[p] = key[i] != kSent;
    }
  }
  __syncthreads();
  WinvExchange(sm.big.winv).BlockedToStriped(wv, wv);
#pragma unroll
  for (int i = 0; i < kIpt; ++i) {
    const int p = i * kT + t;
    if (p < P) winv[p] = wv[i];
  }
}

template <typename K, int kT, int kIpt>
int launch_class(const kw::Args& a) {
  constexpr int kBytes = (int)sizeof(typename Weights<K, kT, kIpt>::Smem);
  auto kernel = sort_weights_kernel<K, kT, kIpt>;
  if (kBytes > 48 * 1024) {
    // once a device: the attribute holds for the process's context there
    static std::atomic<u64> raised{0};
    int dev = 0;
    int rc = (int)cudaGetDevice(&dev);
    if (rc != 0) return rc;
    const u64 bit = dev < 64 ? 1ull << dev : 0;
    if (!(raised.load(std::memory_order_relaxed) & bit)) {
      rc = (int)cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
      if (rc != 0) return rc;
      raised.fetch_or(bit, std::memory_order_relaxed);
    }
  }
  kernel<<<(unsigned)a.n, kT, kBytes, a.stream>>>(
      (const K*)a.items, (const uint8_t*)a.valid, (K*)a.sorted,
      (float*)a.winv, (uint8_t*)a.is_real, a.P);
  return (int)cudaGetLastError();
}

template <typename... Ts>
constexpr int widest(Tiles<Ts...>) {
  int w = 0;
  (void)((w = w > Ts::kThreads * Ts::kIpt ? w : Ts::kThreads * Ts::kIpt),
         ...);
  return w;
}

// the narrowest class that holds P (the table is narrowest first)
template <typename K, typename... Ts>
int dispatch(Tiles<Ts...>, const kw::Args& a) {
  int rc = (int)cudaErrorInvalidValue;
  (void)((a.P <= Ts::kThreads * Ts::kIpt &&
          ((rc = launch_class<K, Ts::kThreads, Ts::kIpt>(a)), true)) ||
         ...);
  return rc;
}

bool fits(bool wide, long long P) {
  return P <= (wide ? widest(Tiles64{}) : widest(Tiles32{}));
}

}  // namespace

// Bytes of scratch that launch_sort_weights takes for n rows of P
// positions of 64-bit (wide = 1) or 32-bit items: 0 when P fits a tile
// class, the wide route's otherwise; -1 for n or P outside [1, 2^31).
extern "C" long long sort_weights_scratch_bytes(int wide, long long n,
                                                long long P) {
  if (n < 1 || n > 0x7FFFFFFFLL || P < 1 || P > 0x7FFFFFFFLL) return -1;
  return fits(wide, P) ? 0 : kw::wide_scratch_bytes(wide, n, (int)P);
}

// KW: items [n, P] (int32 u32 patterns, or int64 u64 patterns when wide),
// valid [n, P] bool -> sorted [n, P] (the items' type), winv [n, P] float32
// and is_real [n, P] bool: one block of the narrowest class that holds P a
// row, or the wide route with the scratch that sort_weights_scratch_bytes
// asks for.  n or P outside [1, 2^31) is refused with
// cudaErrorInvalidValue, as is a scratch short of what the route takes.
extern "C" int launch_sort_weights(int wide, const void* items,
                                   const void* valid, void* sorted,
                                   void* winv, void* is_real, long long n,
                                   long long P, void* scratch,
                                   long long scratch_bytes, void* stream) {
  if (n < 1 || n > 0x7FFFFFFFLL || P < 1 || P > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  const kw::Args a{items, valid, sorted, winv, is_real, n, (int)P,
                   scratch, scratch_bytes, (cudaStream_t)stream};
  if (!fits(wide, P)) return kw::launch_wide(wide, a);
  return wide ? dispatch<u64>(Tiles64{}, a)
              : dispatch<uint32_t>(Tiles32{}, a);
}
