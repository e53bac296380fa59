// Cell diagnostics: K2 (dispersed one-read), K7 (two-read), K6
// (dedispersed).  One kernel template over the residual each forms
// (cell_stats.cuh, shared with K10 in shard_stats.cu); the diagnostics
// tail is shared, as the TPU kernels share _diag_tail.
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

#include "cell_stats.cuh"

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
    return icln_cell_stats_launch<ResDisp<true>, false>(p, threads, grid,
                                                        smem_bytes, stream);
  return icln_cell_stats_launch<ResDisp<false>, false>(p, threads, grid,
                                                       smem_bytes, stream);
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
  return icln_cell_stats_launch<ResTwoRead, false>(p, threads, grid,
                                                   smem_bytes, stream);
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
  return icln_cell_stats_launch<ResDedisp, false>(p, threads, grid,
                                                  smem_bytes, stream);
}
