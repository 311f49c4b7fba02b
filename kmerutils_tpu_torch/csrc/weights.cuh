// What KW's two routes share (weights.cu: a block a row, for rows that fit
// a tile class; weights_wide.cu: rows wider than every class): one call's
// arguments and the wide route's entry points.

#pragma once

#include <cuda_runtime.h>

namespace kw {

struct Args {
  const void* items;       // [n, P] u32 or u64 bit patterns
  const void* valid;       // [n, P] bool
  void* sorted;            // [n, P] the items' type
  void* winv;              // [n, P] float32
  void* is_real;           // [n, P] bool
  long long n;
  int P;
  void* scratch;           // the wide route's; null on the tile route
  long long scratch_bytes;
  cudaStream_t stream;
};

// Bytes of scratch the wide route takes for n rows of P positions of
// 64-bit (wide) or 32-bit items; -1 when CUB cannot size its sort.
long long wide_scratch_bytes(bool wide, long long n, int P);

// The wide route: the outputs of the tile route, bit for bit, for any P.
int launch_wide(bool wide, const Args& a);

}  // namespace kw
