// K2g's cluster mode (cell_fft_global.cu, design (e)): the launch's
// arguments and its entry, one instantiation a residual form and element
// type, defined in fftg_cluster_impl.cuh and built in
// cell_fftg_cluster_{f32,bf16,f64}.cu.
#pragma once

#include "fft_common.cuh"

// the tables a launch reads: the two-level table of W_tab (tw, lt, tmul)
// and the passes' tables and orders (wf, perm)
struct IclnFftgTabs {
  const void* tw;
  const void* wf;
  const int* perm;
  int lt, tmul;
};

// (e) the cluster mode's launch: `cluster` blocks of `threads` a cell,
// `smem` bytes a block; M = odd 2^log2l points
struct IclnFftgCluster {
  int cluster, odd, threads;
  long long smem;
};

// The cluster mode's launch for the residual form Res (cell_stats.cuh):
// checks, the persistent grid of clusters, cudaErrorLaunchOutOfResources
// where a cluster does not fit; n = M, the transform's points.
template <class Res>
int icln_fftg_cluster_launch(const CellStatsArgs<typename Res::Real>& p, const void* chirp,
                             const void* bhat, int n, const IclnFftgTabs& tb,
                             const IclnFftgCluster& cl, void* stream);
