// The cell-diagnostics kernel template shared by K2, K6, K7
// (cell_stats.cu) and K10 (shard_stats.cu): one kernel over a residual
// struct, the diagnostics tail shared, as the TPU kernels share
// _diag_tail.  cell_stats.cu states what it replaces, what bounds it and
// the design; this file is the design.
//
// One block per SM walks groups of `group` consecutive cells (one
// contiguous run of the cube), its warps split in two roles that work on
// consecutive groups at once (kernels.cell_stats_geometry sizes both;
// at nbin 128, 60 cells, 12 producer and 8 consumer warps):
//   staging    a producer thread issues group g + 1's run as one TMA bulk
//              copy into the other of two stage slots, completing on that
//              slot's mbarrier, while group g is worked; the producers
//              read group g + 1's weights and mask into shared memory
//              then too.  A group whose run is not 16-byte aligned (the
//              cube's start, or nbin not a multiple of four), every K7
//              group (its residual reads two cubes, ResTwoRead) and the
//              one-cell groups of the longest profiles are read from
//              device memory by phase 1 instead; the slot's barrier is
//              then armed with a plain arrival, so its phases stay in
//              step.
//   producers  phase 1: one warp per cell, lanes across bins, fixed-order
//              shuffle reductions: the weighted residual (Res::setup,
//              ::fit, ::finish, ::at), mean, ptp and the two-pass std —
//              the arithmetic and order of the first design — and the
//              centred row written TRANSPOSED into centred-row buffer
//              g & 1, [b][cell].
//   consumers  phase 2 of group g - 1 from the other buffer: max over k
//              of |DFT|^2 as a register-tiled product.  Each thread holds
//              `CT` cells x 4 columns of re and im (32 accumulators at
//              CT = 4) and per bin loads its cells' values as one 16-byte
//              word and its four cos and four sin entries as two more,
//              for 8 * CT FMAs.  The tables are laid out [b][k], k padded
//              with zero columns to a multiple of four (|X|^2 = 0 never
//              wins: `best` starts at 0, and a row holding NaN or inf is
//              NaN in a real column too).  Every (cell, k) keeps its chain
//              of __fmaf_rn over b = 0 .. nbin-1 in order, so d_fft is
//              bit-equal to the first design's; where the table does not
//              fit it is streamed in (column x row) chunks, the
//              accumulators staying in registers across the row chunks.
//              The max over k is order-free: each thread folds its
//              columns with icln_max and the consumers meet in a shared
//              int atomicMax (the values are >= +0 or the positive quiet
//              NaN, whose int order is the float order with NaN on top).
// Named barriers hand the two centred-row buffers between the roles
// (ICLN_BAR_FULL / ICLN_BAR_EMPTY); each role also has its own.  The
// split is the measured design: with one role per block and the phases
// in turn, two blocks an SM ran the same arithmetic in 8.8 ms at
// 1024x4096x128, their phases in step; split, 7.1-7.6 ms (PERF.md).

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
  const float* cos_t;  // (nbin, nkp), zero past nbin/2 + 1
  const float* sin_t;
  const float* tt;     // [<t,t> (1 where 0), 1 if <t,t> == 0]
  float* d_std;
  float* d_mean;
  float* d_ptp;
  float* d_fft;
  long long ncells;
  int nchan, nbin, group, kchunk, bchunk, nkp;
  float inv_n;
  int aligned;         // the cube starts 16-byte aligned
  int producers;       // warps running phase 1; the rest run phase 2
};

// tt = (<t,t> (1 where 0), 1 if <t,t> == 0), read once per block
__device__ __forceinline__ float icln_amp(float2 tt, float tp) {
  return tt.y != 0.0f ? 1.0f : tp / tt.x;
}

// Each residual struct works a bin at a time, so that phase 1 can run
// two cells' bins in one loop: setup() points it at its cell's rows,
// fit() takes bin b of the row (reading x, the staged row itself or
// device memory, keeping it in row) into the lane's partial sums of
// <x, t> (and for K2 of x * (-1)^b), finish() takes those after the warp
// sums, and at() is the weighted residual at bin b.  The arithmetic and
// its order are the first design's.

// K2 (_wres_disp): (amp * rot_t - (disp + nq * nyq)) * w; the Nyquist
// term only with NYQ (fourier rotation, even nbin).
template <bool NYQ>
struct ResDisp {
  static constexpr bool kStaged = true;
  const float* rt;
  const float* nr;
  float amp, nq, wc;
  __device__ void setup(const CellStatsArgs& p, long long, int c) {
    rt = p.rott + (size_t)c * p.nbin;
    // (the pointer test stays: written as `NYQ ? ...` it compiled to a
    // slower K2 on sm_90a, the loop laid out differently)
    nr = p.nyq ? p.nyq + (size_t)c * p.nbin : nullptr;
  }
  __device__ void fit(const float* x, float* row, int b, float& tp, float& q) const {
    const float v = x[b];
    row[b] = v;
    tp += v * __ldg(rt + b);
    q += (b & 1) ? -v : v;  // disp * (-1)^b
  }
  __device__ void finish(float2 tt, float w, float tp, float q) {
    nq = q;
    amp = icln_amp(tt, tp);
    wc = w;
  }
  __device__ float at(const float* row, int b) const {
    const float v = row[b];
    const float base = NYQ ? v + nq * __ldg(nr + b) : v;
    return (amp * __ldg(rt + b) - base) * wc;
  }
};

// K7 (_cell_stats_kernel): tp = <ded, t>, (amp * rot_t - disp_base) * w.
// Reads both cubes from device memory itself, unstaged (a ring of two
// cubes' rows would halve the group; taking the kernel's pointer compiled
// to a K7 8% slower on sm_90a, PERF.md).
struct ResTwoRead {
  static constexpr bool kStaged = false;
  const float* x;
  const float* t;
  const float* rt;
  const float* y;
  float amp, wc;
  __device__ void setup(const CellStatsArgs& p, long long cell, int c) {
    x = p.cube + cell * p.nbin;
    t = p.tmpl;
    rt = p.rott + (size_t)c * p.nbin;
    y = p.base + cell * p.nbin;
  }
  __device__ void fit(const float*, float*, int b, float& tp, float&) const {
    tp += __ldg(x + b) * __ldg(t + b);
  }
  __device__ void finish(float2 tt, float w, float tp, float) {
    amp = icln_amp(tt, tp);
    wc = w;
  }
  __device__ float at(const float*, int b) const {
    return (amp * __ldg(rt + b) - __ldg(y + b)) * wc;
  }
};

// K6 (_wres_dedisp): ((amp * t - ded) * window) * w
struct ResDedisp {
  static constexpr bool kStaged = true;
  const float* t;
  const float* win;
  float amp, wc;
  __device__ void setup(const CellStatsArgs& p, long long, int) {
    t = p.tmpl;
    win = p.win;
  }
  __device__ void fit(const float* x, float* row, int b, float& tp, float&) const {
    const float v = x[b];
    row[b] = v;
    tp += v * __ldg(t + b);
  }
  __device__ void finish(float2 tt, float w, float tp, float) {
    amp = icln_amp(tt, tp);
    wc = w;
  }
  __device__ float at(const float* row, int b) const {
    return ((amp * __ldg(t + b) - row[b]) * __ldg(win + b)) * wc;
  }
};

// Byte offsets of the block's shared memory (kernels.cell_stats_smem
// mirrors its size): the two stage slots' mbarriers, the cos and sin table
// chunks (bchunk rows of kchunk columns each), two buffers of centred
// rows transposed [b][group], two stage slots of `group` rows (none at
// one cell a group), the per-cell maxima (int), and two rows each of
// weights and mask bytes.
struct IclnCellLayout {
  long long tables, cen, cslot, stage, red, wsm, msm, total;
};

__host__ __device__ inline long long icln_a16(long long x) { return (x + 15) / 16 * 16; }

__host__ __device__ inline IclnCellLayout icln_cell_layout(int nbin, int group, int kchunk,
                                                           int bchunk) {
  IclnCellLayout L;
  L.tables = 16;
  L.cen = L.tables + 2LL * bchunk * kchunk * 4;
  L.cslot = icln_a16((long long)group * nbin * 4);
  // one cell a group (the longest profiles): no staging, phase 1 works in
  // the centred-row buffer itself, [b][1] being the row
  L.stage = group == 1 ? L.cen : L.cen + 2 * L.cslot;
  L.red = L.stage + 2 * L.cslot;
  L.wsm = L.red + (long long)group * 4;
  L.msm = L.wsm + 2LL * group * 4;
  L.total = L.msm + 2LL * group;
  return L;
}

#define ICLN_CELL_MAX_THREADS 640  // 20 warps: at most 102 registers a thread
// named barriers (0 is __syncthreads)
#define ICLN_BAR_PRODUCERS 1
#define ICLN_BAR_CONSUMERS 2
#define ICLN_BAR_FULL 3   // + buffer: centred rows ready
#define ICLN_BAR_EMPTY 5  // + buffer: centred rows consumed

__device__ __forceinline__ void icln_bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void icln_bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Whether group `cell0` (of `cells` cells) comes by bulk copy: the
// producer and every consumer decide alike.
template <class Res>
__device__ __forceinline__ bool icln_group_staged(const CellStatsArgs& p, long long cell0,
                                                  int cells) {
  return Res::kStaged && p.group > 1 && p.aligned && (cell0 * p.nbin) % 4 == 0
         && ((long long)cells * p.nbin) % 4 == 0;
}

__device__ __forceinline__ int icln_group_cells(const CellStatsArgs& p, long long grp) {
  return (int)min((long long)p.group, p.ncells - grp * p.group);
}

// One thread: start group grp's run into `slot`, or arm the barrier alone.
template <class Res>
__device__ void icln_cell_issue(const CellStatsArgs& p, long long grp, float* slot,
                                uint64_t* bar) {
  const long long cell0 = grp * p.group;
  const int cells = icln_group_cells(p, grp);
  if (icln_group_staged<Res>(p, cell0, cells)) {
    const unsigned bytes = (unsigned)((long long)cells * p.nbin * 4);
    icln_mbar_arrive_tx(bar, bytes);
    icln_bulk_load(slot, p.cube + cell0 * p.nbin, bytes, bar);
  } else {
    icln_mbar_arrive(bar);
  }
}

// Threads t < the group's cell count: its weights and mask into smem.
__device__ __forceinline__ void icln_cell_scalars(const CellStatsArgs& p, long long grp,
                                                  int t, float* wsm, unsigned char* msm) {
  if (t < icln_group_cells(p, grp)) {
    wsm[t] = p.w[grp * p.group + t];
    msm[t] = p.mask[grp * p.group + t];
  }
}

// Threads t of nt: table rows [b0, b0 + bn) x columns [4 * kt0,
// 4 * (kt0 + mc)) into the chunk buffers at pitch kchunk, 16 bytes a load.
__device__ __forceinline__ void icln_fill_tables(const CellStatsArgs& p, float* cos_s,
                                                 float* sin_s, int b0, int bn, int kt0,
                                                 int mc, int t, int nt) {
  for (int i = t; i < bn * mc; i += nt) {
    const int r = i / mc, q = i % mc;
    const size_t src = (size_t)(b0 + r) * p.nkp + 4 * (kt0 + q);
    const int dst = r * p.kchunk + 4 * q;
    *reinterpret_cast<float4*>(cos_s + dst) = *reinterpret_cast<const float4*>(p.cos_t + src);
    *reinterpret_cast<float4*>(sin_s + dst) = *reinterpret_cast<const float4*>(p.sin_t + src);
  }
}

// Warp-specialised: warps [0, p.producers) run phase 1 of group it into
// centred-row buffer it & 1 while the other warps run phase 2 of group
// it - 1 from the other buffer.  Named barriers hand the buffers over:
// FULL + j (producers arrive once their rows are written, consumers
// wait) and EMPTY + j (consumers arrive once their DFT is done, producers
// wait before rewriting the buffer).
template <class Res, int CT>
__global__ void __launch_bounds__(ICLN_CELL_MAX_THREADS)
    icln_cell_stats_kernel(const CellStatsArgs p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nbin = p.nbin, group = p.group, kchunk = p.kchunk, bchunk = p.bchunk;
  const IclnCellLayout L = icln_cell_layout(nbin, group, kchunk, bchunk);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw);
  float* cos_s = reinterpret_cast<float*>(smem_raw + L.tables);
  float* sin_s = cos_s + bchunk * kchunk;
  const long long slot_fl = L.cslot / 4;
  float* cen_base = reinterpret_cast<float*>(smem_raw + L.cen);
  float* stage = reinterpret_cast<float*>(smem_raw + L.stage);
  int* rmax = reinterpret_cast<int*>(smem_raw + L.red);
  float* wsm = reinterpret_cast<float*>(smem_raw + L.wsm);
  unsigned char* msm = smem_raw + L.msm;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x, npw = p.producers, nprod = 32 * npw;
  const int ncons = nthreads - nprod;
  const int ktiles = p.nkp / 4, ct = group / CT, per = kchunk / 4;
  const int nkc = (ktiles + per - 1) / per, nbc = (nbin + bchunk - 1) / bchunk;
  const bool resident = nkc == 1 && nbc == 1;  // the whole table, loaded once
  const long long ngroups = (p.ncells + group - 1) / group;
  const long long nit =
      blockIdx.x < ngroups ? (ngroups - 1 - blockIdx.x) / gridDim.x + 1 : 0;

  if (tid == 0) {
    icln_mbar_init(&bar[0], 1);
    icln_mbar_init(&bar[1], 1);
    icln_mbar_init_fence();
  }
  if (resident) icln_fill_tables(p, cos_s, sin_s, 0, nbin, 0, ktiles, tid, nthreads);
  if (nit > 0) icln_cell_scalars(p, blockIdx.x, tid, wsm, msm);
  __syncthreads();

  if (warp < npw) {
    // ---- producers, phase 1: weighted residual + moments, one warp per
    // cell, the centred rows written transposed ----
    const float2 tt = make_float2(p.tt[0], p.tt[1]);
    if (tid == 0 && nit > 0) icln_cell_issue<Res>(p, blockIdx.x, stage, &bar[0]);
    for (long long it = 0; it < nit; ++it) {
      const int j = (int)(it & 1);
      const long long grp = blockIdx.x + it * gridDim.x;
      // slot j ^ 1 and scalar row j ^ 1 were last read in the previous
      // group's phase 1, before the producers' barrier that ended it
      if (it + 1 < nit) {
        if (tid == 0) {
          icln_fence_proxy_async();
          icln_cell_issue<Res>(p, grp + gridDim.x, stage + (j ^ 1) * slot_fl, &bar[j ^ 1]);
        }
        icln_cell_scalars(p, grp + gridDim.x, tid, wsm + (j ^ 1) * group,
                          msm + (j ^ 1) * group);
      }
      if (it >= 2) icln_bar_sync(ICLN_BAR_EMPTY + j, nthreads);
      icln_mbar_wait(&bar[j], (unsigned)((it >> 1) & 1));
      const long long cell0 = grp * group;
      const int cells = icln_group_cells(p, grp);
      const bool staged = icln_group_staged<Res>(p, cell0, cells);
      const int chan0 = (int)(cell0 % p.nchan);  // the group's first channel
      float* buf = stage + j * slot_fl;
      float* cen = cen_base + j * slot_fl;
      const float* wg = wsm + j * group;
      const unsigned char* mg = msm + j * group;
      for (int g = warp; g < cells; g += npw) {
        const long long cell = cell0 + g;
        float* row = buf + (size_t)g * nbin;
        const float* x = staged ? row : p.cube + cell * nbin;
        Res res;
        res.setup(p, cell, (chan0 + g) % p.nchan);
        float tp = 0.0f, q = 0.0f;
#pragma unroll 4
        for (int b = lane; b < nbin; b += 32) res.fit(x, row, b, tp, q);
        tp = icln_warp_sum(tp);
        q = icln_warp_sum(q);
        res.finish(tt, wg[g], tp, q);
        float sum = 0.0f, mx = -INFINITY, mn = INFINITY;
#pragma unroll 4
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
        const bool m = mg[g] != 0;
        const float centre = m ? 0.0f : mean;
        float var = 0.0f;
#pragma unroll 4
        for (int b = lane; b < nbin; b += 32) {
          const float cv = row[b] - centre;
          cen[(size_t)b * group + g] = cv;
          var += cv * cv;
        }
        var = icln_warp_sum(var);
        if (lane == 0) {
          p.d_mean[cell] = m ? 0.0f : mean;
          p.d_ptp[cell] = m ? 1e20f : mx - mn;
          p.d_std[cell] = m ? 0.0f : sqrtf(var * p.inv_n);
        }
      }
      icln_bar_arrive(ICLN_BAR_FULL + j, nthreads);
      icln_bar_sync(ICLN_BAR_PRODUCERS, nprod);
    }
  } else {
    // ---- consumers, phase 2: max over k of |DFT(centred row)|^2 as
    // register tiles ----
    const int t = tid - nprod;
    for (long long it = 0; it < nit; ++it) {
      const int j = (int)(it & 1);
      const long long cell0 = (blockIdx.x + it * gridDim.x) * group;
      const int cells = icln_group_cells(p, blockIdx.x + it * gridDim.x);
      if (t < cells) rmax[t] = 0;  // +0.0f: every |X_k|^2 is at least that
      icln_bar_sync(ICLN_BAR_FULL + j, nthreads);
      const float* cen = cen_base + j * slot_fl;
      for (int kc = 0; kc < nkc; ++kc) {
        const int kt0 = kc * per, mc = min(per, ktiles - kt0);
        const bool mine = t < ct * mc;
        const int ctl = t % ct, ktl = t / ct;
        float re[CT][4], im[CT][4];
#pragma unroll
        for (int c = 0; c < CT; ++c)
#pragma unroll
          for (int q = 0; q < 4; ++q) re[c][q] = im[c][q] = 0.0f;
        for (int bc = 0; bc < nbc; ++bc) {
          const int b0 = bc * bchunk, bn = min(bchunk, nbin - b0);
          if (!resident) {
            icln_bar_sync(ICLN_BAR_CONSUMERS, ncons);
            icln_fill_tables(p, cos_s, sin_s, b0, bn, kt0, mc, t, ncons);
            icln_bar_sync(ICLN_BAR_CONSUMERS, ncons);
          }
          if (mine) {
            const float* tc = cos_s + 4 * ktl;
            const float* ts = sin_s + 4 * ktl;
            const float* cv = cen + (size_t)b0 * group + CT * ctl;
#pragma unroll 8
            for (int b = 0; b < bn; ++b) {
              float v[CT];
              if constexpr (CT == 4) {
                const float4 v4 = *reinterpret_cast<const float4*>(cv + (size_t)b * group);
                v[0] = v4.x;
                v[1] = v4.y;
                v[2] = v4.z;
                v[3] = v4.w;
              } else {
                v[0] = cv[(size_t)b * group];
              }
              const float4 c4 = *reinterpret_cast<const float4*>(tc + b * kchunk);
              const float4 s4 = *reinterpret_cast<const float4*>(ts + b * kchunk);
#pragma unroll
              for (int c = 0; c < CT; ++c) {
                re[c][0] = __fmaf_rn(v[c], c4.x, re[c][0]);
                im[c][0] = __fmaf_rn(v[c], s4.x, im[c][0]);
                re[c][1] = __fmaf_rn(v[c], c4.y, re[c][1]);
                im[c][1] = __fmaf_rn(v[c], s4.y, im[c][1]);
                re[c][2] = __fmaf_rn(v[c], c4.z, re[c][2]);
                im[c][2] = __fmaf_rn(v[c], s4.z, im[c][2]);
                re[c][3] = __fmaf_rn(v[c], c4.w, re[c][3]);
                im[c][3] = __fmaf_rn(v[c], s4.w, im[c][3]);
              }
            }
          }
        }
        if (mine) {
#pragma unroll
          for (int c = 0; c < CT; ++c) {
            float best = 0.0f;
#pragma unroll
            for (int q = 0; q < 4; ++q)
              best = icln_max(best, re[c][q] * re[c][q] + im[c][q] * im[c][q]);
            const int g = CT * ctl + c;
            if (g < cells) atomicMax(&rmax[g], __float_as_int(best));
          }
        }
      }
      icln_bar_sync(ICLN_BAR_CONSUMERS, ncons);  // every column folded in
      if (t < cells) p.d_fft[cell0 + t] = sqrtf(__int_as_float(rmax[t]));
      // the producers wait for buffer j only where they will fill it again
      if (it + 2 < nit) icln_bar_arrive(ICLN_BAR_EMPTY + j, nthreads);
      icln_bar_sync(ICLN_BAR_CONSUMERS, ncons);  // rmax is reset next group
    }
  }
}

template <class Res, int CT>
static cudaError_t icln_cell_stats_start(const CellStatsArgs& p, int threads, int grid,
                                         long long smem_bytes, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(icln_cell_stats_kernel<Res, CT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_bytes);
  if (err != cudaSuccess) return err;
  icln_cell_stats_kernel<Res, CT><<<grid, threads, (size_t)smem_bytes, stream>>>(p);
  return cudaGetLastError();
}

template <class Res>
static int icln_cell_stats_launch(CellStatsArgs p, int ctile, int producers, int threads,
                                  int grid, long long smem_bytes, void* stream) {
  const IclnCellLayout L = icln_cell_layout(p.nbin, p.group, p.kchunk, p.bchunk);
  const int ncons = threads - 32 * producers;
  if (L.total > smem_bytes || threads > ICLN_CELL_MAX_THREADS || threads % 32
      || producers < 1 || ncons < 32 || p.group > ncons || p.kchunk % 4 || p.nkp % 4
      || (ctile != 4 && ctile != 1) || p.group % ctile
      || (p.group / ctile) * (p.kchunk / 4) > ncons)
    return (int)cudaErrorInvalidValue;
  p.aligned = (uintptr_t)p.cube % 16 == 0;
  p.producers = producers;
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(ctile == 4 ? icln_cell_stats_start<Res, 4>(p, threads, grid, smem_bytes, st)
                          : icln_cell_stats_start<Res, 1>(p, threads, grid, smem_bytes, st));
}

static CellStatsArgs icln_cell_stats_args(
    const unsigned char* mask, const float* w, const float* cos_t,
    const float* sin_t, const float* tt, float* d_std, float* d_mean,
    float* d_ptp, float* d_fft, long long ncells, int nchan, int nbin,
    int group, int kchunk, int bchunk, int nkp, float inv_n) {
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
  p.bchunk = bchunk;
  p.nkp = nkp;
  p.inv_n = inv_n;
  return p;
}
