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
// Bound: bytes for the function — one read of the cube (0.67 ms at
// 1024x4096x128 on 3.35 TB/s; K7 reads two, 1.31 ms) against an rFFT's
// worth of operations per cell (17 GFLOP, 0.25 ms at the 67 TFLOP/s
// float32 peak).  This form is bound by operations: its DFT against
// (nbin, nbin/2+1) cos/sin tables is nbin * (nbin/2+1) * 2 FMA per cell,
// 140 GFLOP at that shape, 2.1 ms at the float32 peak (TF32 is not
// allowed: the reference runs this product at full float32 precision).
//
// What held the first design back (17.4 ms on an NVIDIA H100 80GB HBM3
// at 700 W): each pair of DFT FMAs read three floats from shared memory
// (the row value, a cos and a sin entry), 1.5 shared words per FMA
// against the SM's 32 words and 128 FMA a clock, so the DFT ran near a
// fifth of the float32 peak; phase 1 read its rows from device memory
// with nothing overlapping them; and 8 threads a cell over 65 columns
// left one thread in eight a ninth round.
//
// Design (cell_stats.cuh): rows staged a group ahead by TMA bulk copy;
// producer warps run phase 1 (the residual and moments, warp per cell)
// and write the centred rows transposed, [b][cell], while consumer warps
// run the previous group's DFT as a register-tiled product, 4 cells x 4
// columns a thread, three 16-byte shared loads per 32 FMAs, each (cell,
// k) keeping its FMA chain over b in order, so the planes are bit-equal
// to the first design's (SHA-256 of the planes, tools/time_cell_stats.py,
// parent and change in one call).  On the card (NVIDIA H100 80GB HBM3,
// 700.00 W): K2 7.1-7.6 ms against the first design's 17.3-17.5 in the
// same calls, about 3.4x the 2.1 ms operation floor of this DFT.  Long
// profiles stream the table in chunks and take one cell a tile.  K2 takes
// the Nyquist term as a compile-time flag: a run-time test of the row
// pointer in every bin made it measurably slower on the card.

#include "cell_stats.cuh"

extern "C" int icln_cell_stats_disp(
    const float* disp, const float* rott, const float* nyq, const float* w,
    const unsigned char* mask, const float* cos_t, const float* sin_t,
    const float* tt, float* d_std, float* d_mean, float* d_ptp, float* d_fft,
    long long ncells, int nchan, int nbin, int group, int ctile, int kchunk,
    int bchunk, int nkp, int producers, int threads, int grid, long long smem_bytes, float inv_n,
    void* stream) {
  CellStatsArgs p = icln_cell_stats_args(mask, w, cos_t, sin_t, tt, d_std,
                                         d_mean, d_ptp, d_fft, ncells, nchan,
                                         nbin, group, kchunk, bchunk, nkp,
                                         inv_n);
  p.cube = disp;
  p.rott = rott;
  p.nyq = nyq;
  if (nyq)
    return icln_cell_stats_launch<ResDisp<true>>(p, ctile, producers, threads, grid, smem_bytes,
                                                   stream);
  return icln_cell_stats_launch<ResDisp<false>>(p, ctile, producers, threads, grid, smem_bytes,
                                                   stream);
}

extern "C" int icln_cell_stats_two_read(
    const float* ded, const float* disp_base, const float* rott,
    const float* tmpl, const float* w, const unsigned char* mask,
    const float* cos_t, const float* sin_t, const float* tt, float* d_std,
    float* d_mean, float* d_ptp, float* d_fft, long long ncells, int nchan,
    int nbin, int group, int ctile, int kchunk, int bchunk, int nkp, int producers,
    int threads,
    int grid, long long smem_bytes, float inv_n, void* stream) {
  CellStatsArgs p = icln_cell_stats_args(mask, w, cos_t, sin_t, tt, d_std,
                                         d_mean, d_ptp, d_fft, ncells, nchan,
                                         nbin, group, kchunk, bchunk, nkp,
                                         inv_n);
  p.cube = ded;
  p.base = disp_base;
  p.rott = rott;
  p.tmpl = tmpl;
  return icln_cell_stats_launch<ResTwoRead>(p, ctile, producers, threads, grid, smem_bytes,
                                                   stream);
}

extern "C" int icln_cell_stats_dedisp(
    const float* ded, const float* tmpl, const float* win, const float* w,
    const unsigned char* mask, const float* cos_t, const float* sin_t,
    const float* tt, float* d_std, float* d_mean, float* d_ptp, float* d_fft,
    long long ncells, int nchan, int nbin, int group, int ctile, int kchunk,
    int bchunk, int nkp, int producers, int threads, int grid, long long smem_bytes, float inv_n,
    void* stream) {
  CellStatsArgs p = icln_cell_stats_args(mask, w, cos_t, sin_t, tt, d_std,
                                         d_mean, d_ptp, d_fft, ncells, nchan,
                                         nbin, group, kchunk, bchunk, nkp,
                                         inv_n);
  p.cube = ded;
  p.tmpl = tmpl;
  p.win = win;
  return icln_cell_stats_launch<ResDedisp>(p, ctile, producers, threads, grid, smem_bytes,
                                                   stream);
}
