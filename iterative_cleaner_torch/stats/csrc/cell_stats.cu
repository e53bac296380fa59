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
//
// A bf16-stored cube (`bf16`; the mixed-precision mode) runs the same
// kernel over 2-byte elements, each upcast where phase 1 reads it
// (cell_stats.cuh): the planes are bit-equal to the float32 launch on the
// upcast cube, the staged bytes halve, and the DFT, which bounds it, is
// unchanged.
//
// A float64 cube (`kind` 2; dtype="float64") runs the same kernel in
// double (cell_stats.cuh): the reference's float64 route computes these
// planes in float64 through XLA (no TPU kernel takes float64).  The DFT is
// then DFMA chains (no tensor-core path keeps them exact): about 4.2 ms
// at 1024x4096x128 at the 34 TFLOP/s FP64 rate outside the tensor cores,
// twice the float32 floor, and the cube read doubles (1.34 ms).
//
// A batch of equal-shaped archives is one launch over all their cells
// (`cpa` cells an archive; cell_stats.cuh): the TPU kernels fold the
// batch into their subint grid (_FusedScaffold's batch=).

#include "cell_stats.cuh"

// Launch K2 on cubes of element type T (`nyq` null: no Nyquist term).
template <class T>
static int icln_cell_stats_disp_t(CellStatsArgs<icln_real_t<T>> p, int ctile, int producers,
                                  int threads, int grid, long long smem_bytes, void* stream) {
  return p.nyq ? icln_cell_stats_launch<ResDisp<T, true>>(p, ctile, producers, threads, grid,
                                                          smem_bytes, stream)
               : icln_cell_stats_launch<ResDisp<T, false>>(p, ctile, producers, threads, grid,
                                                           smem_bytes, stream);
}

// `kind`: the cubes' storage, 0 float32, 1 bf16, 2 float64 (every other
// pointer then double).
extern "C" int icln_cell_stats_disp(
    const void* disp, const void* rott, const void* nyq, const void* w,
    const unsigned char* mask, const void* cos_t, const void* sin_t, const void* tt,
    void* d_std, void* d_mean, void* d_ptp, void* d_fft, long long ncells, long long cpa,
    int nchan, int nbin, int group, int ctile, int kchunk, int bchunk, int nkp, int producers,
    int threads, int grid, long long smem_bytes, double inv_n, int kind, void* stream) {
  if (kind == 2) {
    CellStatsArgs<double> p = icln_cell_stats_args<double>(
        mask, w, cos_t, sin_t, tt, d_std, d_mean, d_ptp, d_fft, ncells, cpa, nchan, nbin, group,
        kchunk, bchunk, nkp, inv_n);
    p.cube = disp;
    p.rott = static_cast<const double*>(rott);
    p.nyq = static_cast<const double*>(nyq);
    return icln_cell_stats_disp_t<double>(p, ctile, producers, threads, grid, smem_bytes,
                                          stream);
  }
  CellStatsArgs<float> p = icln_cell_stats_args<float>(
      mask, w, cos_t, sin_t, tt, d_std, d_mean, d_ptp, d_fft, ncells, cpa, nchan, nbin, group,
      kchunk, bchunk, nkp, inv_n);
  p.cube = disp;
  p.rott = static_cast<const float*>(rott);
  p.nyq = static_cast<const float*>(nyq);
  return kind == 1 ? icln_cell_stats_disp_t<icln_bf16>(p, ctile, producers, threads, grid,
                                                       smem_bytes, stream)
                   : icln_cell_stats_disp_t<float>(p, ctile, producers, threads, grid,
                                                   smem_bytes, stream);
}

extern "C" int icln_cell_stats_two_read(
    const void* ded, const void* disp_base, const void* rott, const void* tmpl, const void* w,
    const unsigned char* mask, const void* cos_t, const void* sin_t, const void* tt,
    void* d_std, void* d_mean, void* d_ptp, void* d_fft, long long ncells, long long cpa,
    int nchan, int nbin, int group, int ctile, int kchunk, int bchunk, int nkp, int producers,
    int threads, int grid, long long smem_bytes, double inv_n, int kind, void* stream) {
  if (kind == 2) {
    CellStatsArgs<double> p = icln_cell_stats_args<double>(
        mask, w, cos_t, sin_t, tt, d_std, d_mean, d_ptp, d_fft, ncells, cpa, nchan, nbin, group,
        kchunk, bchunk, nkp, inv_n);
    p.cube = ded;
    p.base = disp_base;
    p.rott = static_cast<const double*>(rott);
    p.tmpl = static_cast<const double*>(tmpl);
    return icln_cell_stats_launch<ResTwoRead<double>>(p, ctile, producers, threads, grid,
                                                      smem_bytes, stream);
  }
  CellStatsArgs<float> p = icln_cell_stats_args<float>(
      mask, w, cos_t, sin_t, tt, d_std, d_mean, d_ptp, d_fft, ncells, cpa, nchan, nbin, group,
      kchunk, bchunk, nkp, inv_n);
  p.cube = ded;
  p.base = disp_base;
  p.rott = static_cast<const float*>(rott);
  p.tmpl = static_cast<const float*>(tmpl);
  return kind == 1 ? icln_cell_stats_launch<ResTwoRead<icln_bf16>>(p, ctile, producers, threads,
                                                                   grid, smem_bytes, stream)
                   : icln_cell_stats_launch<ResTwoRead<float>>(p, ctile, producers, threads,
                                                               grid, smem_bytes, stream);
}

extern "C" int icln_cell_stats_dedisp(
    const void* ded, const void* tmpl, const void* win, const void* w, const unsigned char* mask,
    const void* cos_t, const void* sin_t, const void* tt, void* d_std, void* d_mean,
    void* d_ptp, void* d_fft, long long ncells, long long cpa, int nchan, int nbin, int group,
    int ctile, int kchunk, int bchunk, int nkp, int producers, int threads, int grid,
    long long smem_bytes, double inv_n, int kind, void* stream) {
  if (kind == 2) {
    CellStatsArgs<double> p = icln_cell_stats_args<double>(
        mask, w, cos_t, sin_t, tt, d_std, d_mean, d_ptp, d_fft, ncells, cpa, nchan, nbin, group,
        kchunk, bchunk, nkp, inv_n);
    p.cube = ded;
    p.tmpl = static_cast<const double*>(tmpl);
    p.win = static_cast<const double*>(win);
    return icln_cell_stats_launch<ResDedisp<double>>(p, ctile, producers, threads, grid,
                                                     smem_bytes, stream);
  }
  CellStatsArgs<float> p = icln_cell_stats_args<float>(
      mask, w, cos_t, sin_t, tt, d_std, d_mean, d_ptp, d_fft, ncells, cpa, nchan, nbin, group,
      kchunk, bchunk, nkp, inv_n);
  p.cube = ded;
  p.tmpl = static_cast<const float*>(tmpl);
  p.win = static_cast<const float*>(win);
  return kind == 1 ? icln_cell_stats_launch<ResDedisp<icln_bf16>>(p, ctile, producers, threads,
                                                                  grid, smem_bytes, stream)
                   : icln_cell_stats_launch<ResDedisp<float>>(p, ctile, producers, threads,
                                                              grid, smem_bytes, stream);
}
