// The combine kernel: both scaler sides -> 4-way median -> zap.
//
// Replaces the tail iterative_cleaner_tpu/stats/pallas_kernels.py
// _combine_zap -> _median4 shared by fused_sweep_pallas (K4) and
// fused_combine_pallas (K8): per cell, the elementwise max of the
// channel-side and subint-side plane of each diagnostic (NaN-propagating,
// as jnp.maximum), the median of those four as a min/max network on
// ordered int32 keys with any-NaN poisoning, the median taken as
// lo*0.5f + hi*0.5f (numpy's linear-quantile arithmetic, not
// 0.5f*(lo+hi)), and then scores >= 1 zeroing orig_weights.
//
// Bound: bytes.  Nine planes in, two out (44 bytes per cell, 185 MB at
// 1024x4096); a dozen integer ops per cell.
//
// Design: one thread per cell, consecutive threads on consecutive cells.
//
// float64 planes (dtype="float64") are the same kernel in double with
// the 64-bit keys (icln_ordered_key(double)): 88 bytes per cell, 369 MB
// at 1024x4096.

#include "common.cuh"

template <class T>
__global__ void icln_combine_zap_kernel(
    const T* __restrict__ c0, const T* __restrict__ c1, const T* __restrict__ c2,
    const T* __restrict__ c3, const T* __restrict__ s0, const T* __restrict__ s1,
    const T* __restrict__ s2, const T* __restrict__ s3, const T* __restrict__ worig,
    T* __restrict__ new_w, T* __restrict__ scores, long long n) {
  using IK = IclnKeys<T>;
  using Key = typename IK::Key;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const T a = icln_max(c0[i], s0[i]);
  const T b = icln_max(c1[i], s1[i]);
  const T c = icln_max(c2[i], s2[i]);
  const T d = icln_max(c3[i], s3[i]);
  const bool any_nan = icln_isnan(a) || icln_isnan(b) || icln_isnan(c) || icln_isnan(d);
  const Key ka = IK::key(a), kb = IK::key(b);
  const Key kc = IK::key(c), kd = IK::key(d);
  const Key x = max(min(ka, kb), min(kc, kd));
  const Key y = min(max(ka, kb), max(kc, kd));
  const T med = IK::value(min(x, y)) * T(0.5) + IK::value(max(x, y)) * T(0.5);
  const T score = any_nan ? icln_nan_of<T>() : med;
  scores[i] = score;
  new_w[i] = score >= T(1) ? T(0) : worig[i];
}

template <class T>
static int icln_combine_zap_launch(const void* const* p, const void* worig, void* new_w,
                                   void* scores, long long n, cudaStream_t st) {
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  icln_combine_zap_kernel<T><<<(unsigned)blocks, threads, 0, st>>>(
      static_cast<const T*>(p[0]), static_cast<const T*>(p[1]), static_cast<const T*>(p[2]),
      static_cast<const T*>(p[3]), static_cast<const T*>(p[4]), static_cast<const T*>(p[5]),
      static_cast<const T*>(p[6]), static_cast<const T*>(p[7]), static_cast<const T*>(worig),
      static_cast<T*>(new_w), static_cast<T*>(scores), n);
  return (int)cudaGetLastError();
}

// f64: the planes are float64 (double), else float32.
extern "C" int icln_combine_zap(const void* c0, const void* c1, const void* c2, const void* c3,
                                const void* s0, const void* s1, const void* s2, const void* s3,
                                const void* worig, void* new_w, void* scores, long long n,
                                int f64, void* stream) {
  const void* const p[8] = {c0, c1, c2, c3, s0, s1, s2, s3};
  cudaStream_t st = (cudaStream_t)stream;
  return f64 ? icln_combine_zap_launch<double>(p, worig, new_w, scores, n, st)
             : icln_combine_zap_launch<float>(p, worig, new_w, scores, n, st);
}
