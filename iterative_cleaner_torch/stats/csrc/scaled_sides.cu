// K3: one scaler orientation for all four diagnostics.
//
// Replaces iterative_cleaner_tpu/stats/pallas_kernels.py
// _scaled_sides_body (launched by scaled_sides_pallas through
// _scaled_sides_axis0 / _scaled_sides_axis1): per line, the exact masked
// median, centring, the MAD, then the _masked_side epilogue for std,
// mean and ptp, and the plain path (NaN-line patch, IEEE inf/nan flowing
// onward) for the rFFT diagnostic.
//
// Bound: bytes.  Four float (nsub, nchan) planes and the bool mask in,
// four float planes out (33 bytes per cell, 138 MB at 1024x4096); the
// selects are integer compares on data already in shared memory.
//
// Design: one block per line; the line's values and mask live in shared
// memory for the whole launch.  The median is the TPU kernel's exact
// select on order-preserving int32 keys (masked entries take the key of
// +inf, NaN sorts above it): a 32-step bisection for the k_lo-th key and
// one more pass for its successor, with k_lo = (n-1)//2, k_hi = n//2 and
// 0.0 for an empty line.  Every float op repeats the reference's
// sequence, so the outputs are bit-equal to it: median 0.5f*(lo+hi),
// centring, true division by the MAD, and the threshold applied as a
// multiply by float32(1/thresh) — the reference's compiler rewrites the
// division by its constant threshold that way.  Both orientations read
// the (nsub, nchan) planes as they lie in memory: a line is (start,
// stride) into them, so axis 0 walks a column and axis 1 a row, with no
// transposed copies through device memory.

#include "common.cuh"

struct IclnLine {
  const float* vals;
  const unsigned char* msk;
  int n;
};

// key of entry e: masked entries (use_mask) take +inf's key; `absval`
// selects on |value| (the MAD pass).
__device__ __forceinline__ int icln_line_key(const IclnLine& L, int e, bool use_mask,
                                             bool absval) {
  if (use_mask && L.msk[e]) return ICLN_KEY_MASKED;
  const float v = L.vals[e];
  return icln_ordered_key(absval ? fabsf(v) : v);
}

// Median of the line's (unmasked) keys, nv of them, as the reference's
// _masked_median_lanes computes it.  Ends with a block barrier after the
// last read of L.vals, so callers may rewrite their own entries at once.
__device__ float icln_line_median(const IclnLine& L, bool use_mask, bool absval,
                                  int nv, int* red, int& parity) {
  const int k_lo = max(nv - 1, 0) / 2, k_hi = nv / 2;
  int lo = INT_MIN, hi = INT_MAX;
  for (int step = 0; step < 32; ++step) {
    const int mid = (lo >> 1) + (hi >> 1) + (lo & hi & 1);  // floor midpoint
    int cnt = 0;
    for (int e = threadIdx.x; e < L.n; e += blockDim.x)
      cnt += icln_line_key(L, e, use_mask, absval) <= mid;
    cnt = icln_block_reduce_int<ICLN_SUM>(cnt, red, parity);
    if (cnt >= k_lo + 1) hi = mid;
    else lo = (int)((unsigned)mid + 1u);
  }
  const int lo_key = lo;
  int cnt = 0, succ = INT_MAX;
  for (int e = threadIdx.x; e < L.n; e += blockDim.x) {
    const int k = icln_line_key(L, e, use_mask, absval);
    cnt += k <= lo_key;
    if (k > lo_key) succ = min(succ, k);
  }
  cnt = icln_block_reduce_int<ICLN_SUM>(cnt, red, parity);
  succ = icln_block_reduce_int<ICLN_MIN>(succ, red, parity);
  const int hi_key = cnt > k_hi ? lo_key : succ;
  const float med = 0.5f * (icln_key_to_float(lo_key) + icln_key_to_float(hi_key));
  return nv == 0 ? 0.0f : med;
}

__global__ void icln_scaled_sides_kernel(
    const float* __restrict__ d0, const float* __restrict__ d1,
    const float* __restrict__ d2, const float* __restrict__ d3,
    const unsigned char* __restrict__ mask, float* __restrict__ o0,
    float* __restrict__ o1, float* __restrict__ o2, float* __restrict__ o3,
    int n, long long line_stride, long long elem_stride, float inv_t) {
  extern __shared__ float smem[];
  __shared__ int red[64];
  int parity = 0;
  float* vals = smem;
  unsigned char* msk = reinterpret_cast<unsigned char*>(smem + n);
  const IclnLine L{vals, msk, n};
  const long long base = (long long)blockIdx.x * line_stride;

  int valid = 0;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const unsigned char m = mask[base + e * elem_stride];
    msk[e] = m;
    valid += m == 0;
  }
  const int nv = icln_block_reduce_int<ICLN_SUM>(valid, red, parity);

  const float* const masked_in[3] = {d0, d1, d2};
  float* const masked_out[3] = {o0, o1, o2};
  for (int i = 0; i < 3; ++i) {
    // each thread rewrites only entries it alone touches between barriers
    for (int e = threadIdx.x; e < n; e += blockDim.x)
      vals[e] = masked_in[i][base + e * elem_stride];
    __syncthreads();
    const float med = icln_line_median(L, true, false, nv, red, parity);
    for (int e = threadIdx.x; e < n; e += blockDim.x)
      if (!msk[e]) vals[e] = vals[e] - med;  // masked entries pass through
    __syncthreads();
    const float mad = icln_line_median(L, true, true, nv, red, parity);
    // _masked_side: zero-MAD / empty lines go dead, data passes undivided
    const bool line_dead = (mad == 0.0f) || (nv == 0);
    const float safe_mad = line_dead ? 1.0f : mad;
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      const float centred = vals[e];
      const bool dead = msk[e] || line_dead;
      const float mag = fabsf(dead ? centred : centred / safe_mad);
      masked_out[i][base + e * elem_stride] = dead ? mag : mag * inv_t;
    }
  }

  // the rFFT diagnostic: plain path over every entry
  int nan_in = 0;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const float v = d3[base + e * elem_stride];
    vals[e] = v;
    nan_in |= icln_isnan(v);
  }
  nan_in = icln_block_reduce_int<ICLN_MAX>(nan_in, red, parity);
  float med = icln_line_median(L, false, false, n, red, parity);
  if (nan_in) med = icln_nan();
  int nan_abs = 0;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const float centred = vals[e] - med;
    vals[e] = centred;
    nan_abs |= icln_isnan(fabsf(centred));
  }
  nan_abs = icln_block_reduce_int<ICLN_MAX>(nan_abs, red, parity);
  float mad = icln_line_median(L, false, true, n, red, parity);
  if (nan_abs) mad = icln_nan();
  for (int e = threadIdx.x; e < n; e += blockDim.x)
    o3[base + e * elem_stride] = fabsf(vals[e] / mad) * inv_t;
}

extern "C" int icln_scaled_sides(const float* d0, const float* d1, const float* d2,
                                 const float* d3, const unsigned char* mask,
                                 float* o0, float* o1, float* o2, float* o3, int n,
                                 int nlines, long long line_stride,
                                 long long elem_stride, float inv_t, int threads,
                                 long long smem_bytes, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(icln_scaled_sides_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_bytes);
  if (err != cudaSuccess) return (int)err;
  icln_scaled_sides_kernel<<<nlines, threads, (size_t)smem_bytes, (cudaStream_t)stream>>>(
      d0, d1, d2, d3, mask, o0, o1, o2, o3, n, line_stride, elem_stride, inv_t);
  return (int)cudaGetLastError();
}
