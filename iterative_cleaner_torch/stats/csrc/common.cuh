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
#include <cstdint>
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

// ---- Hopper's bulk copies (TMA, 1-D) completing on an mbarrier ----
// One thread arms a stage's barrier with the bytes it expects and issues
// the copy; the consumers wait on the barrier's phase parity.  Source,
// destination and size must be multiples of 16 bytes.

__device__ __forceinline__ unsigned icln_smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void icln_mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(icln_smem_addr(bar)),
               "r"(count) : "memory");
}

// make the barriers' initialisation visible to the async proxy
__device__ __forceinline__ void icln_mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void icln_mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(icln_smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void icln_mbar_arrive_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   icln_smem_addr(bar)),
               "r"(bytes) : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void icln_mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned a = icln_smem_addr(bar);
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
  }
}

// order this thread's (and, after a block barrier, the block's) earlier
// shared-memory accesses before the async proxy's next writes
__device__ __forceinline__ void icln_fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void icln_bulk_load(void* dst, const void* src, unsigned bytes,
                                               uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(icln_smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(icln_smem_addr(bar))
      : "memory");
}
