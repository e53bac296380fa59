// K2: dispersed-frame one-read cell diagnostics.
//
// Replaces iterative_cleaner_tpu/stats/pallas_kernels.py
// _cell_stats_disp_kernel (launched by cell_diagnostics_pallas_disp):
// the body _wres_disp (fit against the per-channel rotated template, the
// Nyquist round-trip term, weighting) followed by _diag_tail (mean, ptp
// with 1e20 on masked cells, two-pass std, max over k of |DFT|^2, sqrt).
//
// Bound: operations.  The DFT against (nbin, nbin//2+1) cos/sin tables
// is nbin * (nbin//2+1) * 2 FMA per cell — 140 GFLOP at 1024x4096x128,
// about 2 ms at the card's 67 TFLOP/s float32 peak (TF32 is not allowed:
// the reference runs this product at full float32 precision), against
// about 0.66 ms to read the cube once.
//
// Design: a block takes groups of `group` cells (consecutive cells: one
// contiguous run of the cube).  Phase 1: one warp per cell, lanes across
// bins; the warp forms the weighted residual in shared memory with
// fixed-order shuffle reductions and writes std/mean/ptp.  Phase 2: the
// block's threads split (cell, k) pairs; each takes its cell's centred
// row from shared memory and runs the DFT with explicit fp32 FMA against
// the tables held in shared memory.  The tables are staged once per
// block when they fit (nbin <= 155 in the 96 KB table budget) and otherwise
// streamed in k-chunks per group, as the TPU kernel's _k_chunk sweep
// does.  Blocks loop over groups, so the table load is amortised.

#include "common.cuh"

__global__ void icln_cell_stats_disp_kernel(
    const float* __restrict__ disp, const float* __restrict__ rott,
    const float* __restrict__ nyq, const float* __restrict__ w,
    const unsigned char* __restrict__ mask, const float* __restrict__ cos_t,
    const float* __restrict__ sin_t, const float* __restrict__ tt,
    float* __restrict__ d_std, float* __restrict__ d_mean,
    float* __restrict__ d_ptp, float* __restrict__ d_fft, long long ncells,
    int nchan, int nbin, int group, int kchunk, float inv_n) {
  extern __shared__ float smem[];
  const int nk = nbin / 2 + 1;
  const int rowp = nbin + 1;  // padded row: cells of one warp hit different banks
  float* cen = smem;
  float* cos_s = cen + group * rowp;
  float* sin_s = cos_s + nbin * kchunk;
  float* red = sin_s + nbin * kchunk;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int tpc = blockDim.x / group;  // DFT threads per cell
  const int g_dft = tid / tpc, r_dft = tid % tpc;
  const float tt_safe = tt[0];
  const bool tt_zero = tt[1] != 0.0f;
  const int nchunks = (nk + kchunk - 1) / kchunk;
  const long long ngroups = (ncells + group - 1) / group;

  if (nchunks == 1) {
    for (int i = tid; i < nbin * nk; i += blockDim.x) {
      cos_s[i] = cos_t[i];
      sin_s[i] = sin_t[i];
    }
    __syncthreads();
  }

  for (long long grp = blockIdx.x; grp < ngroups; grp += gridDim.x) {
    const long long cell0 = grp * group;
    // ---- phase 1: weighted residual + moments, one warp per cell ----
    for (int g = warp; g < group; g += nwarps) {
      const long long cell = cell0 + g;
      if (cell >= ncells) break;
      const int c = (int)(cell % nchan);
      const float* x = disp + cell * nbin;
      const float* rt = rott + (size_t)c * nbin;
      const float* nr = nyq ? nyq + (size_t)c * nbin : nullptr;
      float* row = cen + g * rowp;
      float tp = 0.0f, nq = 0.0f;
      for (int b = lane; b < nbin; b += 32) {
        const float v = x[b];
        row[b] = v;
        tp += v * rt[b];
        nq += (b & 1) ? -v : v;  // disp * (-1)^b
      }
      tp = icln_warp_sum(tp);
      nq = icln_warp_sum(nq);
      const float amp = tt_zero ? 1.0f : tp / tt_safe;
      const float wc = w[cell];
      float sum = 0.0f, mx = -INFINITY, mn = INFINITY;
      for (int b = lane; b < nbin; b += 32) {
        const float v = row[b];
        const float base = nr ? v + nq * nr[b] : v;
        const float wres = (amp * rt[b] - base) * wc;
        row[b] = wres;
        sum += wres;
        mx = icln_max(mx, wres);
        mn = icln_min(mn, wres);
      }
      sum = icln_warp_sum(sum);
      mx = icln_warp_max(mx);
      mn = icln_warp_min(mn);
      const float mean = sum * inv_n;
      const bool m = mask[cell] != 0;
      const float centre = m ? 0.0f : mean;
      float var = 0.0f;
      for (int b = lane; b < nbin; b += 32) {
        const float cv = row[b] - centre;
        row[b] = cv;
        var += cv * cv;
      }
      var = icln_warp_sum(var);
      if (lane == 0) {
        d_mean[cell] = m ? 0.0f : mean;
        d_ptp[cell] = m ? 1e20f : mx - mn;
        d_std[cell] = m ? 0.0f : sqrtf(var * inv_n);
      }
    }
    __syncthreads();
    // ---- phase 2: max over k of |DFT(centred row)|^2 ----
    const long long cell = cell0 + g_dft;
    const bool live = g_dft < group && cell < ncells;
    float best = 0.0f;  // |X_k|^2 >= 0, so 0 never wins over a real term
    for (int ch = 0; ch < nchunks; ++ch) {
      const int k0 = ch * kchunk;
      const int kn = min(kchunk, nk - k0);
      if (nchunks > 1) {
        __syncthreads();
        for (int i = tid; i < nbin * kn; i += blockDim.x) {
          const int b = i / kn, kk = i % kn;
          cos_s[b * kchunk + kk] = cos_t[(size_t)b * nk + k0 + kk];
          sin_s[b * kchunk + kk] = sin_t[(size_t)b * nk + k0 + kk];
        }
        __syncthreads();
      }
      if (live) {
        const float* row = cen + g_dft * rowp;
        for (int kk = r_dft; kk < kn; kk += tpc) {
          float re = 0.0f, im = 0.0f;
          for (int b = 0; b < nbin; ++b) {
            const float v = row[b];
            re = __fmaf_rn(v, cos_s[b * kchunk + kk], re);
            im = __fmaf_rn(v, sin_s[b * kchunk + kk], im);
          }
          best = icln_max(best, re * re + im * im);
        }
      }
    }
    red[tid] = best;
    __syncthreads();
    if (live && r_dft == 0) {
      float mm = red[tid];
      for (int r = 1; r < tpc; ++r) mm = icln_max(mm, red[tid + r]);
      d_fft[cell] = sqrtf(mm);
    }
    __syncthreads();  // cen and red are rewritten by the next group
  }
}

extern "C" int icln_cell_stats_disp(
    const float* disp, const float* rott, const float* nyq, const float* w,
    const unsigned char* mask, const float* cos_t, const float* sin_t,
    const float* tt, float* d_std, float* d_mean, float* d_ptp, float* d_fft,
    long long ncells, int nchan, int nbin, int group, int kchunk, int threads,
    int grid, long long smem_bytes, float inv_n, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(icln_cell_stats_disp_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_bytes);
  if (err != cudaSuccess) return (int)err;
  icln_cell_stats_disp_kernel<<<grid, threads, (size_t)smem_bytes, (cudaStream_t)stream>>>(
      disp, rott, nyq, w, mask, cos_t, sin_t, tt, d_std, d_mean, d_ptp, d_fft,
      ncells, nchan, nbin, group, kchunk, inv_n);
  return (int)cudaGetLastError();
}
