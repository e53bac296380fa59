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

#include "common.cuh"

__global__ void icln_combine_zap_kernel(
    const float* __restrict__ c0, const float* __restrict__ c1,
    const float* __restrict__ c2, const float* __restrict__ c3,
    const float* __restrict__ s0, const float* __restrict__ s1,
    const float* __restrict__ s2, const float* __restrict__ s3,
    const float* __restrict__ worig, float* __restrict__ new_w,
    float* __restrict__ scores, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float a = icln_max(c0[i], s0[i]);
  const float b = icln_max(c1[i], s1[i]);
  const float c = icln_max(c2[i], s2[i]);
  const float d = icln_max(c3[i], s3[i]);
  const bool any_nan = icln_isnan(a) || icln_isnan(b) || icln_isnan(c) || icln_isnan(d);
  const int ka = icln_ordered_key(a), kb = icln_ordered_key(b);
  const int kc = icln_ordered_key(c), kd = icln_ordered_key(d);
  const int x = max(min(ka, kb), min(kc, kd));
  const int y = min(max(ka, kb), max(kc, kd));
  const float med = icln_key_to_float(min(x, y)) * 0.5f + icln_key_to_float(max(x, y)) * 0.5f;
  const float score = any_nan ? icln_nan() : med;
  scores[i] = score;
  new_w[i] = score >= 1.0f ? 0.0f : worig[i];
}

extern "C" int icln_combine_zap(const float* c0, const float* c1, const float* c2,
                                const float* c3, const float* s0, const float* s1,
                                const float* s2, const float* s3, const float* worig,
                                float* new_w, float* scores, long long n,
                                void* stream) {
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  icln_combine_zap_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      c0, c1, c2, c3, s0, s1, s2, s3, worig, new_w, scores, n);
  return (int)cudaGetLastError();
}
