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
// planes are bit-equal to K2's and K6's on the same shard.  A bf16-stored
// block (`bf16`; the TPU kernels' _dma_scratch stages the storage dtype)
// takes K2's and K6's bf16 instantiations.  A float64 block (`kind` 2;
// dtype="float64" on a cell mesh) takes their float64 instantiations:
// CellStatsArgs<double>, double rows, window and planes, so its planes
// are bit-equal to K2's and K6's float64 launches on the same shard.
//
// Bound of the float64 build at 1024x4096x128 on one rank: the cube read
// is 4.29 GB (1.28 ms at 3.35 TB/s) and the DFT's DFMA chains need 4.2
// ms at the 34 TFLOP/s FP64 rate, so it is bound by operations.

#include "cell_stats.cuh"

// `kind`: the block's storage, 0 float32, 1 bf16, 2 float64 (every other
// pointer then double).
extern "C" int icln_shard_stats_disp(
    const void* disp, const void* rott, const void* nyq, const void* w,
    const unsigned char* mask, const void* cos_t, const void* sin_t, const void* tt,
    void* d_std, void* d_mean, void* d_ptp, void* d_fft, long long ncells, long long cpa,
    int nchan, int nbin, int group, int ctile, int kchunk, int bchunk, int nkp, int producers,
    int threads, int grid, long long smem_bytes, double inv_n, int kind, void* stream) {
  if (kind < 0 || kind > 2) return (int)cudaErrorInvalidValue;
  if (kind == 2) {
    CellStatsArgs<double> p = icln_cell_stats_args<double>(
        mask, w, cos_t, sin_t, tt, d_std, d_mean, d_ptp, d_fft, ncells, cpa, nchan, nbin, group,
        kchunk, bchunk, nkp, inv_n);
    p.cube = disp;
    p.rott = static_cast<const double*>(rott);
    p.nyq = static_cast<const double*>(nyq);
    return p.nyq ? icln_cell_stats_launch<ResDisp<double, true>>(p, ctile, producers, threads,
                                                                 grid, smem_bytes, stream)
                 : icln_cell_stats_launch<ResDisp<double, false>>(
                       p, ctile, producers, threads, grid, smem_bytes, stream);
  }
  CellStatsArgs<float> p = icln_cell_stats_args<float>(
      mask, w, cos_t, sin_t, tt, d_std, d_mean, d_ptp, d_fft, ncells, cpa, nchan, nbin, group,
      kchunk, bchunk, nkp, inv_n);
  p.cube = disp;
  p.rott = static_cast<const float*>(rott);
  p.nyq = static_cast<const float*>(nyq);
  if (kind == 1)
    return p.nyq ? icln_cell_stats_launch<ResDisp<icln_bf16, true>>(p, ctile, producers, threads,
                                                                    grid, smem_bytes, stream)
                 : icln_cell_stats_launch<ResDisp<icln_bf16, false>>(
                       p, ctile, producers, threads, grid, smem_bytes, stream);
  return p.nyq ? icln_cell_stats_launch<ResDisp<float, true>>(p, ctile, producers, threads, grid,
                                                              smem_bytes, stream)
               : icln_cell_stats_launch<ResDisp<float, false>>(p, ctile, producers, threads,
                                                               grid, smem_bytes, stream);
}

extern "C" int icln_shard_stats_dedisp(
    const void* ded, const void* tmpl, const void* win, const void* w, const unsigned char* mask,
    const void* cos_t, const void* sin_t, const void* tt, void* d_std, void* d_mean,
    void* d_ptp, void* d_fft, long long ncells, long long cpa, int nchan, int nbin, int group,
    int ctile, int kchunk, int bchunk, int nkp, int producers, int threads, int grid,
    long long smem_bytes, double inv_n, int kind, void* stream) {
  if (kind < 0 || kind > 2) return (int)cudaErrorInvalidValue;
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
