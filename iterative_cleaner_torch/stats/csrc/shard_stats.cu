// K10: the cell diagnostics of one rank's (subint, channel) shard in the
// cell-sharded clean, dispersed frame (ResDisp, K2's values) and
// dedispersed frame (ResDedisp, K6's values).
//
// Replaces iterative_cleaner_tpu/stats/pallas_kernels.py
// sweep_shard_diags_disp / sweep_shard_diags_dedisp (_dma_disp_kernel,
// _dma_dedisp_kernel): K2's and K6's bodies on the local shard with the
// cube tile fetched by a double-buffered async copy (_fetch_cube_tile).
//
// Bound: bytes, as K2 and K6: one read of the shard's cube (0.67 ms for
// the whole 1024x4096x128 cube at 3.35 TB/s, a quarter of it on each
// rank of a 2x2 mesh) against an rFFT's worth of operations per cell.
// Like K2 it runs far above that bound: its DFT against tables does
// about 8x an rFFT's operations (cell_stats.cu).
//
// Design: cell_stats.cuh's kernel template with PIPE set.  A block works
// through groups of consecutive cells; while it runs phase 1 and the DFT
// of group g from one shared-memory buffer, the cube rows of its group
// g + gridDim.x arrive in the other through 16-byte cp.async.cg copies
// (4-byte cp.async.ca where a row is not 16-byte aligned), committed as
// one group and awaited (cp.async.wait_group 1, then a block barrier)
// when the block reaches it.  The rows are staged unpadded at a pitch of
// nbin rounded up to four floats plus four, so each row starts 16-byte
// aligned and the cells of one warp still fall in different banks; the
// second buffer costs the table chunk or the group size at long nbin
// (kernels.cell_stats_geometry).  Phase 1 then reads the staged row in
// place of device memory, with the same arithmetic as K2 and K6, so its
// planes are bit-equal to theirs on the same shard.

#include "cell_stats.cuh"

static void icln_shard_vec16(CellStatsArgs& p) {
  p.vec16 = (p.nbin % 4 == 0) && ((uintptr_t)p.cube % 16 == 0);
}

extern "C" int icln_shard_stats_disp(
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
  icln_shard_vec16(p);
  if (nyq)
    return icln_cell_stats_launch<ResDisp<true>, true>(p, threads, grid,
                                                       smem_bytes, stream);
  return icln_cell_stats_launch<ResDisp<false>, true>(p, threads, grid,
                                                      smem_bytes, stream);
}

extern "C" int icln_shard_stats_dedisp(
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
  icln_shard_vec16(p);
  return icln_cell_stats_launch<ResDedisp, true>(p, threads, grid,
                                                 smem_bytes, stream);
}
