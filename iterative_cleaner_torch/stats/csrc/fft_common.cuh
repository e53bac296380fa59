// The FFT builds' shared device helpers (cell_fft.cu, K2f, and
// cell_fft_global.cu, K2g): complex values of the arithmetic type, their
// sums and products, fixed-order block reductions, and the real split's
// |X_k|^2.
#pragma once

#include "cell_stats.cuh"

template <class R>
struct IclnCplx;

template <>
struct IclnCplx<float> {
  using type = float2;
};

template <>
struct IclnCplx<double> {
  using type = double2;
};

template <class R>
using icln_cplx_t = typename IclnCplx<R>::type;

template <class C2>
__device__ __forceinline__ C2 icln_cadd(C2 a, C2 b) {
  C2 r;
  r.x = a.x + b.x;
  r.y = a.y + b.y;
  return r;
}

template <class C2>
__device__ __forceinline__ C2 icln_csub(C2 a, C2 b) {
  C2 r;
  r.x = a.x - b.x;
  r.y = a.y - b.y;
  return r;
}

// a * w, each part one multiply and one fused multiply-add
template <class C2>
__device__ __forceinline__ C2 icln_cmul(C2 a, C2 w) {
  C2 r;
  r.x = icln_fma(a.x, w.x, -(a.y * w.y));
  r.y = icln_fma(a.x, w.y, a.y * w.x);
  return r;
}

struct IclnFftSum {
  template <class R>
  __device__ R operator()(R a, R b) const {
    return a + b;
  }
};

struct IclnFftMax {
  template <class R>
  __device__ R operator()(R a, R b) const {
    return icln_max(a, b);
  }
};

struct IclnFftMin {
  template <class R>
  __device__ R operator()(R a, R b) const {
    return icln_min(a, b);
  }
};

// A fixed-order block reduction: warp shuffles, then lane 0's partials of
// the warps in order; every thread returns the same value.
template <class R, class Op>
__device__ __forceinline__ R icln_fft_fold(R v, R* red, Op op) {
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(ICLN_FULL, v, o));
  const int nw = blockDim.x >> 5;
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  R r = red[0];
  for (int i = 1; i < nw; ++i) r = op(r, red[i]);
  __syncthreads();  // red is free again
  return r;
}

// Two or three fixed-order block reductions at once (one pair of
// barriers): the sums a and b (the fit's dot products), or a sum, a max
// and a min (the residual's).
template <class R>
__device__ __forceinline__ void icln_fft_fold2(R& a, R& b, R* red) {
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(ICLN_FULL, a, o);
    b += __shfl_xor_sync(ICLN_FULL, b, o);
  }
  const int nw = blockDim.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    red[threadIdx.x >> 5] = a;
    red[32 + (threadIdx.x >> 5)] = b;
  }
  __syncthreads();
  a = red[0];
  b = red[32];
  for (int i = 1; i < nw; ++i) {
    a += red[i];
    b += red[32 + i];
  }
  __syncthreads();
}

template <class R>
__device__ __forceinline__ void icln_fft_fold3(R& sum, R& mx, R& mn, R* red) {
  for (int o = 16; o > 0; o >>= 1) {
    sum += __shfl_xor_sync(ICLN_FULL, sum, o);
    mx = icln_max(mx, __shfl_xor_sync(ICLN_FULL, mx, o));
    mn = icln_min(mn, __shfl_xor_sync(ICLN_FULL, mn, o));
  }
  const int nw = blockDim.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    red[threadIdx.x >> 5] = sum;
    red[32 + (threadIdx.x >> 5)] = mx;
    red[64 + (threadIdx.x >> 5)] = mn;
  }
  __syncthreads();
  sum = red[0];
  mx = red[32];
  mn = red[64];
  for (int i = 1; i < nw; ++i) {
    sum += red[i];
    mx = icln_max(mx, red[32 + i]);
    mn = icln_min(mn, red[64 + i]);
  }
  __syncthreads();
}

// |X_k|^2 of the real row's spectrum from A = Z[k] and B = Z[N/2 - k]:
// X[k] = (A + conj B) / 2 - i W^k (A - conj B) / 2
template <class R, class C2>
__device__ __forceinline__ R icln_split_one(C2 A, C2 B, C2 w) {
  const R er = R(0.5) * (A.x + B.x), ei = R(0.5) * (A.y - B.y);
  const R orr = R(0.5) * (A.x - B.x), oi = R(0.5) * (A.y + B.y);
  const R wor = w.x * orr - w.y * oi, woi = w.x * oi + w.y * orr;
  const R xr = er + woi, xi = ei - wor;
  return xr * xr + xi * xi;
}
