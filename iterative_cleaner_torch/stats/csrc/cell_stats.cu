// Cell diagnostics: K2 (dispersed one-read), K7 (two-read), K6
// (dedispersed).  One kernel template over the residual each forms; the
// diagnostics tail is shared, as the TPU kernels share _diag_tail.
//
// Replaces iterative_cleaner_tpu/stats/pallas_kernels.py
//   K2 _cell_stats_disp_kernel (cell_diagnostics_pallas_disp): _wres_disp,
//      the fit against the per-channel rotated template with the Nyquist
//      round-trip term;
//   K7 _cell_stats_kernel (cell_diagnostics_pallas): the fit <ded, t> with
//      the UNWINDOWED template, residual amp * rot_t - disp_base;
//   K6 _cell_stats_dedisp_kernel (cell_diagnostics_pallas_dedisp):
//      _wres_dedisp, the fit on ded, residual (amp * t - ded) * window;
// each weighted by the cell's weight and followed by _diag_tail (mean, ptp
// with 1e20 on masked cells, two-pass std, max over k of |DFT|^2, sqrt).
//
// Bound: bytes.  The function's least work is an rFFT per cell plus the
// moments, about 4k operations per cell at nbin 128 — 17 GFLOP at
// 1024x4096x128, 0.25 ms at the card's 67 TFLOP/s float32 peak — against
// about 0.67 ms to read one cube (K2, K6) or 1.31 ms to read two (K7).
// This kernel does more: its DFT against (nbin, nbin//2+1) cos/sin
// tables is nbin * (nbin//2+1) * 2 FMA per cell, 140 GFLOP, about 2 ms at
// that peak (TF32 is not allowed: the reference runs this product at
// full float32 precision).
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
// does.  Blocks loop over groups, so the table load is amortised.  Only
// the residual of phase 1 differs between the three kernels: a struct
// per kernel with fit() (the template amplitude, staging the cube row in
// shared memory where the residual reads it again) and at(b) (the
// weighted residual at bin b, in the reference's op order).  K2 takes the
// Nyquist term as a compile-time flag: a run-time test of the row
// pointer in every bin made it measurably slower on the card.

#include "common.cuh"

struct CellStatsArgs {
  const float* cube;   // K2: disp; K6, K7: ded — (ncells, nbin)
  const float* base;   // K7: disp_base (ncells, nbin)
  const float* rott;   // K2, K7: (nchan, nbin) rotated template rows
  const float* nyq;    // K2: (nchan, nbin) Nyquist rows, or null
  const float* tmpl;   // K6, K7: (nbin,) template
  const float* win;    // K6: (nbin,) pulse window
  const float* w;
  const unsigned char* mask;
  const float* cos_t;
  const float* sin_t;
  const float* tt;     // [<t,t> (1 where 0), 1 if <t,t> == 0]
  float* d_std;
  float* d_mean;
  float* d_ptp;
  float* d_fft;
  long long ncells;
  int nchan, nbin, group, kchunk;
  float inv_n;
};

__device__ __forceinline__ float icln_amp(const CellStatsArgs& p, float tp) {
  return p.tt[1] != 0.0f ? 1.0f : tp / p.tt[0];
}

// K2 (_wres_disp): (amp * rot_t - (disp + nq * nyq)) * w; the Nyquist
// term only with NYQ (fourier rotation, even nbin)
template <bool NYQ>
struct ResDisp {
  const float* rt;
  const float* nr;
  float amp, nq, wc;
  __device__ void fit(const CellStatsArgs& p, long long cell, float* row,
                      int lane) {
    const int c = (int)(cell % p.nchan);
    const float* x = p.cube + cell * p.nbin;
    rt = p.rott + (size_t)c * p.nbin;
    // (the pointer test stays: written as `NYQ ? ...` it compiled to a
    // slower K2 on sm_90a, the DFT loop laid out differently)
    nr = p.nyq ? p.nyq + (size_t)c * p.nbin : nullptr;
    float tp = 0.0f, q = 0.0f;
    for (int b = lane; b < p.nbin; b += 32) {
      const float v = x[b];
      row[b] = v;
      tp += v * rt[b];
      q += (b & 1) ? -v : v;  // disp * (-1)^b
    }
    tp = icln_warp_sum(tp);
    nq = icln_warp_sum(q);
    amp = icln_amp(p, tp);
    wc = p.w[cell];
  }
  __device__ float at(const float* row, int b) const {
    const float v = row[b];
    const float base = NYQ ? v + nq * nr[b] : v;
    return (amp * rt[b] - base) * wc;
  }
};

// K7 (_cell_stats_kernel): tp = <ded, t>, (amp * rot_t - disp_base) * w
struct ResTwoRead {
  const float* rt;
  const float* y;
  float amp, wc;
  __device__ void fit(const CellStatsArgs& p, long long cell, float*,
                      int lane) {
    const int c = (int)(cell % p.nchan);
    const float* x = p.cube + cell * p.nbin;
    rt = p.rott + (size_t)c * p.nbin;
    y = p.base + cell * p.nbin;
    float tp = 0.0f;
    for (int b = lane; b < p.nbin; b += 32)
      tp += x[b] * p.tmpl[b];
    amp = icln_amp(p, icln_warp_sum(tp));
    wc = p.w[cell];
  }
  __device__ float at(const float*, int b) const {
    return (amp * rt[b] - y[b]) * wc;
  }
};

// K6 (_wres_dedisp): ((amp * t - ded) * window) * w
struct ResDedisp {
  const float* t;
  const float* win;
  float amp, wc;
  __device__ void fit(const CellStatsArgs& p, long long cell, float* row,
                      int lane) {
    const float* x = p.cube + cell * p.nbin;
    t = p.tmpl;
    win = p.win;
    float tp = 0.0f;
    for (int b = lane; b < p.nbin; b += 32) {
      const float v = x[b];
      row[b] = v;
      tp += v * t[b];
    }
    amp = icln_amp(p, icln_warp_sum(tp));
    wc = p.w[cell];
  }
  __device__ float at(const float* row, int b) const {
    return ((amp * t[b] - row[b]) * win[b]) * wc;
  }
};

template <class Res>
__global__ void icln_cell_stats_kernel(const CellStatsArgs p) {
  extern __shared__ float smem[];
  const int nbin = p.nbin, group = p.group, kchunk = p.kchunk;
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
  const int nchunks = (nk + kchunk - 1) / kchunk;
  const long long ngroups = (p.ncells + group - 1) / group;

  if (nchunks == 1) {
    for (int i = tid; i < nbin * nk; i += blockDim.x) {
      cos_s[i] = p.cos_t[i];
      sin_s[i] = p.sin_t[i];
    }
    __syncthreads();
  }

  for (long long grp = blockIdx.x; grp < ngroups; grp += gridDim.x) {
    const long long cell0 = grp * group;
    // ---- phase 1: weighted residual + moments, one warp per cell ----
    for (int g = warp; g < group; g += nwarps) {
      const long long cell = cell0 + g;
      if (cell >= p.ncells) break;
      float* row = cen + g * rowp;
      Res res;
      res.fit(p, cell, row, lane);
      float sum = 0.0f, mx = -INFINITY, mn = INFINITY;
      for (int b = lane; b < nbin; b += 32) {
        const float wres = res.at(row, b);
        row[b] = wres;
        sum += wres;
        mx = icln_max(mx, wres);
        mn = icln_min(mn, wres);
      }
      sum = icln_warp_sum(sum);
      mx = icln_warp_max(mx);
      mn = icln_warp_min(mn);
      const float mean = sum * p.inv_n;
      const bool m = p.mask[cell] != 0;
      const float centre = m ? 0.0f : mean;
      float var = 0.0f;
      for (int b = lane; b < nbin; b += 32) {
        const float cv = row[b] - centre;
        row[b] = cv;
        var += cv * cv;
      }
      var = icln_warp_sum(var);
      if (lane == 0) {
        p.d_mean[cell] = m ? 0.0f : mean;
        p.d_ptp[cell] = m ? 1e20f : mx - mn;
        p.d_std[cell] = m ? 0.0f : sqrtf(var * p.inv_n);
      }
    }
    __syncthreads();
    // ---- phase 2: max over k of |DFT(centred row)|^2 ----
    const long long cell = cell0 + g_dft;
    const bool live = g_dft < group && cell < p.ncells;
    float best = 0.0f;  // |X_k|^2 >= 0, so 0 never wins over a real term
    for (int ch = 0; ch < nchunks; ++ch) {
      const int k0 = ch * kchunk;
      const int kn = min(kchunk, nk - k0);
      if (nchunks > 1) {
        __syncthreads();
        for (int i = tid; i < nbin * kn; i += blockDim.x) {
          const int b = i / kn, kk = i % kn;
          cos_s[b * kchunk + kk] = p.cos_t[(size_t)b * nk + k0 + kk];
          sin_s[b * kchunk + kk] = p.sin_t[(size_t)b * nk + k0 + kk];
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
      p.d_fft[cell] = sqrtf(mm);
    }
    __syncthreads();  // cen and red are rewritten by the next group
  }
}

template <class Res>
static int icln_cell_stats_launch(const CellStatsArgs& p, int threads,
                                  int grid, long long smem_bytes,
                                  void* stream) {
  cudaError_t err = cudaFuncSetAttribute(icln_cell_stats_kernel<Res>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_bytes);
  if (err != cudaSuccess) return (int)err;
  icln_cell_stats_kernel<Res><<<grid, threads, (size_t)smem_bytes, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

static CellStatsArgs icln_cell_stats_args(
    const unsigned char* mask, const float* w, const float* cos_t,
    const float* sin_t, const float* tt, float* d_std, float* d_mean,
    float* d_ptp, float* d_fft, long long ncells, int nchan, int nbin,
    int group, int kchunk, float inv_n) {
  CellStatsArgs p = {};
  p.w = w;
  p.mask = mask;
  p.cos_t = cos_t;
  p.sin_t = sin_t;
  p.tt = tt;
  p.d_std = d_std;
  p.d_mean = d_mean;
  p.d_ptp = d_ptp;
  p.d_fft = d_fft;
  p.ncells = ncells;
  p.nchan = nchan;
  p.nbin = nbin;
  p.group = group;
  p.kchunk = kchunk;
  p.inv_n = inv_n;
  return p;
}

extern "C" int icln_cell_stats_disp(
    const float* disp, const float* rott, const float* nyq, const float* w,
    const unsigned char* mask, const float* cos_t, const float* sin_t,
    const float* tt, float* d_std, float* d_mean, float* d_ptp, float* d_fft,
    long long ncells, int nchan, int nbin, int group, int kchunk, int threads,
    int grid, long long smem_bytes, float inv_n, void* stream) {
  CellStatsArgs p = icln_cell_stats_args(mask, w, cos_t, sin_t, tt, d_std,
                                         d_mean, d_ptp, d_fft, ncells, nchan,
                                         nbin, group, kchunk, inv_n);
  p.cube = disp;
  p.rott = rott;
  p.nyq = nyq;
  if (nyq)
    return icln_cell_stats_launch<ResDisp<true>>(p, threads, grid, smem_bytes,
                                                 stream);
  return icln_cell_stats_launch<ResDisp<false>>(p, threads, grid, smem_bytes,
                                                stream);
}

extern "C" int icln_cell_stats_two_read(
    const float* ded, const float* disp_base, const float* rott,
    const float* tmpl, const float* w, const unsigned char* mask,
    const float* cos_t, const float* sin_t, const float* tt, float* d_std,
    float* d_mean, float* d_ptp, float* d_fft, long long ncells, int nchan,
    int nbin, int group, int kchunk, int threads, int grid,
    long long smem_bytes, float inv_n, void* stream) {
  CellStatsArgs p = icln_cell_stats_args(mask, w, cos_t, sin_t, tt, d_std,
                                         d_mean, d_ptp, d_fft, ncells, nchan,
                                         nbin, group, kchunk, inv_n);
  p.cube = ded;
  p.base = disp_base;
  p.rott = rott;
  p.tmpl = tmpl;
  return icln_cell_stats_launch<ResTwoRead>(p, threads, grid, smem_bytes,
                                            stream);
}

extern "C" int icln_cell_stats_dedisp(
    const float* ded, const float* tmpl, const float* win, const float* w,
    const unsigned char* mask, const float* cos_t, const float* sin_t,
    const float* tt, float* d_std, float* d_mean, float* d_ptp, float* d_fft,
    long long ncells, int nchan, int nbin, int group, int kchunk, int threads,
    int grid, long long smem_bytes, float inv_n, void* stream) {
  CellStatsArgs p = icln_cell_stats_args(mask, w, cos_t, sin_t, tt, d_std,
                                         d_mean, d_ptp, d_fft, ncells, nchan,
                                         nbin, group, kchunk, inv_n);
  p.cube = ded;
  p.tmpl = tmpl;
  p.win = win;
  return icln_cell_stats_launch<ResDedisp>(p, threads, grid, smem_bytes,
                                           stream);
}
