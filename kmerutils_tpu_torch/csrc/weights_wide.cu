// KW's route for rows wider than every tile class of weights.cu (16,384
// positions at 32 and at 64 bits): the same s, winv and is_real, bit for
// bit, for any P.  Such rows come from long reads (a batch is padded to
// its longest), not from the sketch cells, whose widest rows are 16,377
// positions at k=8 and 16,364 at k=21.  A chunk of rows takes three
// launches:
//
//   sort_weights_keys_kernel  each key (the item where valid, else the
//                             all-ones sentinel) into the scratch, and the
//                             rows' offsets;
//   CUB's segmented radix sort, keys only, a segment a row, between the
//                             scratch and s as a double buffer (unsigned
//                             order, no index, no sign flip);
//   sort_weights_runs_kernel  each position's run in its sorted row by a
//                             galloping search, back to the run's first
//                             key and on past its last (reads grow with
//                             the log of the run's length, so heavy
//                             duplicates and long padding cost little),
//                             then winv and is_real, and s where the sort
//                             left the keys in the scratch.
//
// At a real position w is its run's length; at padding p, p + 1 - (the
// first position of the last real run), or p + 2 when the row has none:
// weights.cu's values.  Rows go in chunks of at most 2^31 - 1 positions,
// as CUB counts its items in int.  What bounds it: the sort's passes over
// global memory (a 4-byte key is read and written once a radix digit),
// where the tile route keeps them in shared memory.  This file is its own
// nvcc process, so CUB's device headers do not lengthen weights.cu's.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cub/device/device_segmented_radix_sort.cuh>

#include "weights.cuh"

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 256;
constexpr int kPerThread = 8;      // positions a thread, at most, a launch

// the first q <= p with s[q] == s[p], s sorted
template <typename K>
__device__ __forceinline__ long long run_first(const K* __restrict__ s,
                                               long long p) {
  const K k = s[p];
  long long in = p, out = -1, d = 1;   // s[in] == k; out < first
  while (p - d >= 0) {
    if (s[p - d] != k) {
      out = p - d;
      break;
    }
    in = p - d;
    d <<= 1;
  }
  while (in - out > 1) {
    const long long m = out + (in - out) / 2;
    if (s[m] == k) in = m; else out = m;
  }
  return in;
}

// the first q > p with s[q] != s[p], or P
template <typename K>
__device__ __forceinline__ long long run_end(const K* __restrict__ s,
                                             long long p, long long P) {
  const K k = s[p];
  long long in = p, out = P, d = 1;    // s[in] == k; out >= end
  while (p + d < P) {
    if (s[p + d] != k) {
      out = p + d;
      break;
    }
    in = p + d;
    d <<= 1;
  }
  while (out - in > 1) {
    const long long m = in + (out - in) / 2;
    if (s[m] == k) in = m; else out = m;
  }
  return out;
}

// grid (rows, slices of a row); a block's threads stride through its row
template <typename K>
__global__ void __launch_bounds__(kThreads)
sort_weights_keys_kernel(const K* __restrict__ items,
                         const uint8_t* __restrict__ valid,
                         K* __restrict__ keys, int* __restrict__ offsets,
                         int P) {
  constexpr K kSent = ~K(0);
  const long long off = (long long)blockIdx.x * P;
  for (long long p = (long long)blockIdx.y * kThreads + threadIdx.x; p < P;
       p += (long long)gridDim.y * kThreads)
    keys[off + p] = valid[off + p] ? items[off + p] : kSent;
  if (blockIdx.y == 0 && threadIdx.x == 0) {
    offsets[blockIdx.x] = (int)off;
    if (blockIdx.x == gridDim.x - 1) offsets[gridDim.x] = (int)(off + P);
  }
}

// out: where s goes, or null when the sort left the keys in s already
template <typename K>
__global__ void __launch_bounds__(kThreads)
sort_weights_runs_kernel(const K* __restrict__ cur, K* __restrict__ out,
                         float* __restrict__ winv,
                         uint8_t* __restrict__ is_real, int P) {
  constexpr K kSent = ~K(0);
  const long long off = (long long)blockIdx.x * P;
  const K* s = cur + off;
  for (long long p = (long long)blockIdx.y * kThreads + threadIdx.x; p < P;
       p += (long long)gridDim.y * kThreads) {
    const K k = s[p];
    const bool real = k != kSent;
    long long w;
    if (real) {
      w = run_end(s, p, (long long)P) - run_first(s, p);
    } else {
      const long long f = run_first(s, p);     // the first sentinel
      w = p + 1 - (f > 0 ? run_first(s, f - 1) : -1);
    }
    winv[off + p] = 1.0f / (float)w;
    is_real[off + p] = real;
    if (out) out[off + p] = k;
  }
}

constexpr size_t align256(size_t b) { return (b + 255) & ~size_t(255); }

struct Layout {
  long long chunk;       // rows a chunk
  size_t keys, offsets, temp, total;
};

template <typename K>
cudaError_t layout(long long n, int P, Layout& L) {
  L.chunk = n < INT_MAX / P ? n : INT_MAX / P;
  L.keys = align256((size_t)L.chunk * P * sizeof(K));
  L.offsets = align256((size_t)(L.chunk + 1) * sizeof(int));
  cub::DoubleBuffer<K> d(nullptr, nullptr);
  size_t temp = 0;
  const cudaError_t rc = cub::DeviceSegmentedRadixSort::SortKeys(
      nullptr, temp, d, (int)(L.chunk * P), (int)L.chunk, (int*)nullptr,
      (int*)nullptr, 0, (int)sizeof(K) * 8);
  L.temp = align256(temp);
  L.total = L.keys + L.offsets + L.temp;
  return rc;
}

template <typename K>
int wide_route(const kw::Args& a) {
  Layout L;
  cudaError_t rc = layout<K>(a.n, a.P, L);
  if (rc != cudaSuccess) return (int)rc;
  if (a.scratch == nullptr || a.scratch_bytes < (long long)L.total)
    return (int)cudaErrorInvalidValue;
  char* base = (char*)a.scratch;
  K* keys = (K*)base;
  int* offsets = (int*)(base + L.keys);
  void* temp = base + L.keys + L.offsets;
  long long slices = ((long long)a.P + kThreads * kPerThread - 1) /
                     (kThreads * kPerThread);
  if (slices > 65535) slices = 65535;
  for (long long r0 = 0; r0 < a.n; r0 += L.chunk) {
    const long long rows = a.n - r0 < L.chunk ? a.n - r0 : L.chunk;
    const long long off = r0 * a.P;
    const dim3 grid((unsigned)rows, (unsigned)slices);
    sort_weights_keys_kernel<K><<<grid, kThreads, 0, a.stream>>>(
        (const K*)a.items + off, (const uint8_t*)a.valid + off, keys,
        offsets, a.P);
    rc = cudaGetLastError();
    if (rc != cudaSuccess) return (int)rc;
    K* s = (K*)a.sorted + off;
    cub::DoubleBuffer<K> d(keys, s);
    size_t temp_bytes = L.temp;
    rc = cub::DeviceSegmentedRadixSort::SortKeys(
        temp, temp_bytes, d, (int)(rows * a.P), (int)rows, offsets,
        offsets + 1, 0, (int)sizeof(K) * 8, a.stream);
    if (rc != cudaSuccess) return (int)rc;
    sort_weights_runs_kernel<K><<<grid, kThreads, 0, a.stream>>>(
        d.Current(), d.Current() == s ? nullptr : s, (float*)a.winv + off,
        (uint8_t*)a.is_real + off, a.P);
    rc = cudaGetLastError();
    if (rc != cudaSuccess) return (int)rc;
  }
  return 0;
}

}  // namespace

namespace kw {

long long wide_scratch_bytes(bool wide, long long n, int P) {
  Layout L;
  const cudaError_t rc =
      wide ? layout<u64>(n, P, L) : layout<uint32_t>(n, P, L);
  return rc == cudaSuccess ? (long long)L.total : -1;
}

int launch_wide(bool wide, const Args& a) {
  return wide ? wide_route<u64>(a) : wide_route<uint32_t>(a);
}

}  // namespace kw
