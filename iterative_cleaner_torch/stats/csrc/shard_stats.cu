// K10: the cell diagnostics of one rank's (subint, channel) shard in the
// cell-sharded clean, dispersed frame (ResDisp, K2's values) and
// dedispersed frame (ResDedisp, K6's values).
//
// Replaces iterative_cleaner_tpu/stats/pallas_kernels.py
// sweep_shard_diags_disp / sweep_shard_diags_dedisp (_dma_disp_kernel,
// _dma_dedisp_kernel): K2's and K6's bodies on the local shard with the
// cube tile fetched by a double-buffered async copy (_fetch_cube_tile).
//
// Bound: as K2 and K6 (cell_stats.cu) on a quarter of the cells on each
// rank of a 2x2 mesh: one read of the shard's cube against its DFT's
// operations.
//
// Design: cell_stats.cuh's kernel, the same instantiations as K2 and K6
// under the shard's own entry points and launch count.  Its rows were
// the first to be staged (a cp.async double buffer); since K2 and K6
// stage theirs by TMA bulk copy too, the three are one kernel, and K10's
// planes are bit-equal to K2's and K6's on the same shard.

#include "cell_stats.cuh"

extern "C" int icln_shard_stats_disp(
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

extern "C" int icln_shard_stats_dedisp(
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
