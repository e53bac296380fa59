// K1: both weighted marginals of the dispersed cube in one read.
//
// Replaces iterative_cleaner_tpu/stats/pallas_kernels.py
// _marginals_kernel (launched by weighted_marginals_pallas):
//     A[c, b]  = sum_s w[s, c] * disp[s, c, b]     (nchan, nbin)
//     t1[s, b] = sum_c w[s, c] * disp[s, c, b]     (nsub, nbin)
//
// Bound: bytes.  The cube is read once (4 * nsub * nchan * nbin bytes;
// 2.15 GB at 1024x4096x128), against a few MB of outputs.
//
// Design: the TPU kernel carries both sums in scratch across its
// sequential grid.  Hopper blocks run in no order, so each block owns a
// (sb subints x cb channels) tile and writes per-tile partial sums —
// A partials per subint block, t1 partials per channel block — and a
// second pass adds the partials in a fixed order.  No float atomics:
// results are identical from run to run.  Inside a tile, one subint's
// (cb, nbin) slab is contiguous in memory; threads read it coalesced,
// stage the weighted products in shared memory, accumulate A in shared
// memory (each thread owns its elements) and sum t1 over the staged
// channels in channel order.

#include "common.cuh"

__global__ void icln_marginals_tile(const float* __restrict__ disp,
                                    const float* __restrict__ w,
                                    float* __restrict__ a_part,
                                    float* __restrict__ t1_part,
                                    int nsub, int nchan, int nbin, int sb, int cb) {
  extern __shared__ float smem[];
  const int cblk = blockIdx.x, sblk = blockIdx.y;
  const int c0 = cblk * cb, s0 = sblk * sb;
  const int cn = min(cb, nchan - c0), sn = min(sb, nsub - s0);
  const int te = cn * nbin;  // elements of one subint's slab in this tile
  float* stage = smem;
  float* acc = stage + cb * nbin;
  float* wrow = acc + cb * nbin;
  for (int e = threadIdx.x; e < te; e += blockDim.x) acc[e] = 0.0f;
  for (int s = 0; s < sn; ++s) {
    const size_t srow = (size_t)(s0 + s);
    for (int c = threadIdx.x; c < cn; c += blockDim.x)
      wrow[c] = w[srow * nchan + c0 + c];
    __syncthreads();
    const float* src = disp + (srow * nchan + c0) * (size_t)nbin;
    for (int e = threadIdx.x; e < te; e += blockDim.x) {
      const float x = src[e] * wrow[e / nbin];
      stage[e] = x;
      acc[e] += x;
    }
    __syncthreads();
    float* t1_out = t1_part + ((size_t)cblk * nsub + srow) * nbin;
    for (int b = threadIdx.x; b < nbin; b += blockDim.x) {
      float t = 0.0f;
      for (int c = 0; c < cn; ++c) t += stage[c * nbin + b];
      t1_out[b] = t;
    }
    __syncthreads();  // stage and wrow are rewritten next subint
  }
  float* a_out = a_part + (size_t)sblk * nchan * nbin + (size_t)c0 * nbin;
  for (int e = threadIdx.x; e < te; e += blockDim.x) a_out[e] = acc[e];
}

// out[i] = sum_p part[p, i], partials added in index order.
__global__ void icln_sum_parts(const float* __restrict__ part,
                               float* __restrict__ out, int nparts, size_t n) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float t = 0.0f;
  for (int p = 0; p < nparts; ++p) t += part[(size_t)p * n + i];
  out[i] = t;
}

extern "C" int icln_weighted_marginals(const float* disp, const float* w,
                                       float* a_part, float* t1_part,
                                       float* a, float* t1, int nsub, int nchan,
                                       int nbin, int sb, int cb, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int ncb = (nchan + cb - 1) / cb, nsb = (nsub + sb - 1) / sb;
  const size_t smem = (size_t)(2 * cb * nbin + cb) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      icln_marginals_tile, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  icln_marginals_tile<<<dim3(ncb, nsb), 256, smem, st>>>(disp, w, a_part, t1_part,
                                                         nsub, nchan, nbin, sb, cb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t na = (size_t)nchan * nbin, nt = (size_t)nsub * nbin;
  icln_sum_parts<<<(unsigned)((na + 255) / 256), 256, 0, st>>>(a_part, a, nsb, na);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  icln_sum_parts<<<(unsigned)((nt + 255) / 256), 256, 0, st>>>(t1_part, t1, ncb, nt);
  return (int)cudaGetLastError();
}

extern "C" const char* icln_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
