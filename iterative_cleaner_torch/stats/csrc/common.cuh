// Shared device helpers of the port's kernels: the order-preserving
// float32 -> int32 key map of the exact k-th select, NaN-propagating
// min/max (the reductions the reference's compiler lowers jnp.max/min
// and jnp.maximum to), and warp/block reductions with a fixed order.
//
// Build with -fmad=false: the kernels reproduce the reference's float32
// op sequences, and a contracted multiply-add would round differently.
// Where a kernel wants a fused multiply-add (the DFT), it says so with
// __fmaf_rn.
#pragma once

#include <climits>
#include <cmath>
#include <cuda_runtime.h>

#define ICLN_KEY_MASKED 0x7F800000  // key of +inf: the masked sentinel

__device__ __forceinline__ int icln_ordered_key(float x) {
  // signed int order of the key == float order; NaN above +inf
  const int b = __float_as_int(x);
  return b ^ ((b >> 31) & 0x7FFFFFFF);
}

__device__ __forceinline__ float icln_key_to_float(int o) {
  // the map is an involution
  return __int_as_float(o ^ ((o >> 31) & 0x7FFFFFFF));
}

__device__ __forceinline__ float icln_nan() { return __int_as_float(0x7FC00000); }

__device__ __forceinline__ bool icln_isnan(float x) { return x != x; }

__device__ __forceinline__ float icln_max(float a, float b) {
  return (icln_isnan(a) || icln_isnan(b)) ? icln_nan() : fmaxf(a, b);
}

__device__ __forceinline__ float icln_min(float a, float b) {
  return (icln_isnan(a) || icln_isnan(b)) ? icln_nan() : fminf(a, b);
}

__device__ __forceinline__ float icln_warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float icln_warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = icln_max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float icln_warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = icln_min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int icln_warp_sum_int(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int icln_warp_min_int(int v) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int icln_warp_max_int(int v) {
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide integer reductions with ONE __syncthreads each: the warp
// partials go to one of two 32-slot halves of `red` (alternating per
// call through `parity`), and every thread folds them itself.  A half is
// rewritten two calls later, after a barrier every thread reaches only
// once it has finished reading it.  Integer ops: exact in any order.
enum IclnOp { ICLN_SUM, ICLN_MIN, ICLN_MAX };

template <IclnOp OP>
__device__ __forceinline__ int icln_block_reduce_int(int v, int* red, int& parity) {
  if (OP == ICLN_SUM) v = icln_warp_sum_int(v);
  if (OP == ICLN_MIN) v = icln_warp_min_int(v);
  if (OP == ICLN_MAX) v = icln_warp_max_int(v);
  int* half = red + 32 * parity;
  parity ^= 1;
  if ((threadIdx.x & 31) == 0) half[threadIdx.x >> 5] = v;
  __syncthreads();
  const int nw = blockDim.x >> 5;
  int r = half[0];
  for (int i = 1; i < nw; ++i) {
    if (OP == ICLN_SUM) r += half[i];
    if (OP == ICLN_MIN) r = min(r, half[i]);
    if (OP == ICLN_MAX) r = max(r, half[i]);
  }
  return r;
}
