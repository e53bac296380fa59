// The cell-diagnostics kernel template shared by K2, K6, K7
// (cell_stats.cu) and K10 (shard_stats.cu): one kernel over a residual
// struct, the diagnostics tail shared, as the TPU kernels share
// _diag_tail.  cell_stats.cu states the design and the bound.
//
// PIPE (K10) stages the cube rows of a block's next group of cells into
// a second shared-memory buffer with cp.async while the block works on
// the current group, the counterpart of the TPU kernel's double-buffered
// _fetch_cube_tile; without PIPE (K2, K6, K7) phase 1 reads the rows
// from device memory itself.  Only where the row comes from differs: the
// arithmetic is the same code, so K10's planes are bit-equal to K2's and
// K6's.

#pragma once

#include <cstdint>

#include "common.cuh"

struct CellStatsArgs {
  const float* cube;   // K2, K10 disp: disp; K6, K7, K10 dedisp: ded — (ncells, nbin)
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
  int vec16;           // PIPE: rows start 16-byte aligned (16-byte copies)
};

__device__ __forceinline__ float icln_amp(const CellStatsArgs& p, float tp) {
  return p.tt[1] != 0.0f ? 1.0f : tp / p.tt[0];
}

// K2 (_wres_disp): (amp * rot_t - (disp + nq * nyq)) * w; the Nyquist
// term only with NYQ (fourier rotation, even nbin).  fit() reads the
// cell's row from x (device memory, or the staged row itself under PIPE)
// and keeps it in row.
template <bool NYQ>
struct ResDisp {
  const float* rt;
  const float* nr;
  float amp, nq, wc;
  __device__ void fit(const CellStatsArgs& p, long long cell, const float* x,
                      float* row, int lane) {
    const int c = (int)(cell % p.nchan);
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

// K7 (_cell_stats_kernel): tp = <ded, t>, (amp * rot_t - disp_base) * w.
// K7 has no PIPE form; it reads its row from p.cube itself (taking the
// kernel's pointer compiled to a K7 8% slower on sm_90a, PERF.md).
struct ResTwoRead {
  const float* rt;
  const float* y;
  float amp, wc;
  __device__ void fit(const CellStatsArgs& p, long long cell, const float*,
                      float*, int lane) {
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
  __device__ void fit(const CellStatsArgs& p, long long cell, const float* x,
                      float* row, int lane) {
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

// ---- PIPE: asynchronous copies of cube rows into shared memory ----

__device__ __forceinline__ void icln_cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void icln_cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void icln_cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most one committed group (the one just started) is pending
__device__ __forceinline__ void icln_cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Shared-memory pitch of a staged row: a multiple of four floats (each row
// starts 16-byte aligned for cp.async), plus four so that the cells one
// warp reads in phase 2 fall in different banks.
__host__ __device__ __forceinline__ int icln_pipe_pitch(int nbin) {
  return (nbin + 3) / 4 * 4 + 4;
}

// Start (without waiting) the copies of group grp's cube rows into buf,
// row g at buf + g * pitch; cells past the end are not copied.
static __device__ void icln_stage_group(const CellStatsArgs& p,
                                        long long grp, float* buf,
                                        int pitch) {
  const long long cell0 = grp * p.group;
  const int cells = (int)min((long long)p.group, p.ncells - cell0);
  const float* src = p.cube + cell0 * p.nbin;
  if (p.vec16) {
    const int per_row = p.nbin / 4;
    for (int i = threadIdx.x; i < cells * per_row; i += blockDim.x) {
      const int g = i / per_row, q = (i % per_row) * 4;
      icln_cp_async16(buf + g * pitch + q, src + (size_t)g * p.nbin + q);
    }
  } else {
    for (int i = threadIdx.x; i < cells * p.nbin; i += blockDim.x) {
      const int g = i / p.nbin, b = i % p.nbin;
      icln_cp_async4(buf + g * pitch + b, src + (size_t)g * p.nbin + b);
    }
  }
}

template <class Res, bool PIPE>
__global__ void icln_cell_stats_kernel(const CellStatsArgs p) {
  extern __shared__ __align__(16) float smem[];
  const int nbin = p.nbin, group = p.group, kchunk = p.kchunk;
  const int nk = nbin / 2 + 1;
  // padded row: cells of one warp hit different banks
  const int rowp = PIPE ? icln_pipe_pitch(nbin) : nbin + 1;
  float* cen = smem;  // PIPE: two buffers of `group` rows each
  float* cos_s = cen + (PIPE ? 2 : 1) * group * rowp;
  float* sin_s = cos_s + nbin * kchunk;
  float* red = sin_s + nbin * kchunk;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int tpc = blockDim.x / group;  // DFT threads per cell
  const int g_dft = tid / tpc, r_dft = tid % tpc;
  const int nchunks = (nk + kchunk - 1) / kchunk;
  const long long ngroups = (p.ncells + group - 1) / group;

  if (PIPE && blockIdx.x < ngroups) {
    icln_stage_group(p, blockIdx.x, cen, rowp);
    icln_cp_async_commit();
  }
  if (nchunks == 1) {
    for (int i = tid; i < nbin * nk; i += blockDim.x) {
      cos_s[i] = p.cos_t[i];
      sin_s[i] = p.sin_t[i];
    }
    __syncthreads();
  }

  long long it = 0;
  for (long long grp = blockIdx.x; grp < ngroups; grp += gridDim.x, ++it) {
    const long long cell0 = grp * group;
    float* buf = cen;
    if (PIPE) {
      // the next group's rows go to the other buffer (free: the previous
      // group's work on it ended at the loop's closing barrier) while
      // this group's, committed one round earlier, are awaited
      buf = cen + (it & 1) * group * rowp;
      const long long nxt = grp + gridDim.x;
      if (nxt < ngroups)
        icln_stage_group(p, nxt, cen + ((it + 1) & 1) * group * rowp, rowp);
      icln_cp_async_commit();
      icln_cp_async_wait_prev();
      __syncthreads();
    }
    // ---- phase 1: weighted residual + moments, one warp per cell ----
    for (int g = warp; g < group; g += nwarps) {
      const long long cell = cell0 + g;
      if (cell >= p.ncells) break;
      float* row = buf + g * rowp;
      Res res;
      res.fit(p, cell, PIPE ? row : p.cube + cell * p.nbin, row, lane);
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
        const float* row = buf + g_dft * rowp;
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
    __syncthreads();  // buf and red are rewritten by the next group
  }
}

template <class Res, bool PIPE>
static int icln_cell_stats_launch(const CellStatsArgs& p, int threads,
                                  int grid, long long smem_bytes,
                                  void* stream) {
  cudaError_t err = cudaFuncSetAttribute(icln_cell_stats_kernel<Res, PIPE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_bytes);
  if (err != cudaSuccess) return (int)err;
  icln_cell_stats_kernel<Res, PIPE>
      <<<grid, threads, (size_t)smem_bytes, (cudaStream_t)stream>>>(p);
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
