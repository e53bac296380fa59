// K2g's cluster mode (cell_fft_global.cu, design (e)): the kernel and its
// launch, on K2f's transform (fft_cluster.cuh).  Included by the sources
// that instantiate it, one an element type (ICLN_FFTG_CLUSTER_BUILD).
#pragma once

#include "fft_cluster.cuh"
#include "fftg_cluster.cuh"

// the cluster mode: the most threads a block (the plan's,
// kernels.FFTG_CLUSTER_THREADS, within it; one such block an SM caps its
// registers at 128, which its shared memory allows anyway: one block an
// SM in float64, two of 256 threads in float32), and log2 of its local
// register passes' points (16 points, where K2f, at six blocks an SM,
// takes 8; K2f's 8 and clusters of 16 blocks ran slower at (L5b),
// tools/time_cell_fft.py --fftg-sweep, PERF.md)
#define ICLN_FFTG_CLUSTER_THREADS 512
#define ICLN_FFTG_CLUSTER_PASS_LOG 4

// (e): K2g's cluster mode, Bluestein's convolution of one cell in one
// thread-block cluster, nothing through device memory but the cube row,
// the chirp and B^ (both read through L2: every cell reads them) and the
// planes.  M = P 2^m points (P = 3^a 5^b), block r holding positions
// [r Q, (r + 1) Q), Q = M / C, in K2f's swizzled layout beside K2f's
// two-level table of W_(2M) (the transform is K2f's of a row of 2M bins):
//   the residual  bins [r Q, min((r + 1) Q, N)) of the cube row read
//                 through the residual structs of cell_stats.cuh (the
//                 fit, then the sum, max and min; a float32 or float64 row
//                 kept in shared memory as it is read, a bf16 row read
//                 again, the same operations on the same upcast values),
//                 the blocks' partials met in rank order (K2f's);
//   the chirp     each value centred, its square summed (fixed order),
//                 times w_j (the wrapper's table); positions from N on
//                 are zero, taken so by the cross-cluster step unread;
//   forward       K2f's transform: the cross-cluster step, the register
//                 passes (of 16 points here), the odd stages
//                 (icln_fft_cross, icln_fft_pass, icln_fft_odd);
//   times B^      the chirp row's spectrum / M in the forward's output
//                 order (kernels._fftg_bhat); at an odd part of 3 or 5
//                 the one odd stage, B^ and that stage's inverse in one
//                 sweep (icln_fft_odd_mul_inv);
//   inverse       the forward mirrored: the odd stages, the register
//                 passes, the cross-cluster step last (decimation in time,
//                 conjugate twiddles), which leaves the convolution c in
//                 natural order in registers;
//   the max       max over k < K = N/2 + 1 of |c_k|^2 (icln_max from +0;
//                 the post-chirp has modulus one and is left out), one
//                 sqrt.
// Persistent: as many cells as the card holds at once (the occupancy
// API at the plan's shared memory; cudaErrorLaunchOutOfResources where a
// cluster does not fit), each cluster walking the rest in K2f's cell
// order.
template <class R>
struct FftgClusterArgs {
  CellStatsArgs<R> c;
  const icln_cplx_t<R>* tw;     // K2f's table of W_(2M): 2^lt low entries, then the high part
  const icln_cplx_t<R>* chirp;  // (nbin,)
  const icln_cplx_t<R>* bhat;   // (M,) in the forward's order
  int odd, log2l, lt, ntw;
};

template <class Res>
__global__ void __launch_bounds__(ICLN_FFTG_CLUSTER_THREADS, 1)
    icln_fftg_cluster_kernel(const FftgClusterArgs<typename Res::Real> a) {
  using T = typename Res::Elem;
  using R = typename Res::Real;
  using C2 = icln_cplx_t<R>;
  constexpr bool kKeep = std::is_same<T, R>::value && Res::kStaged;
  constexpr int S = icln_fft_sw<R>(), LR = ICLN_FFTG_CLUSTER_PASS_LOG;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ R red[96];
  // the cluster's partials, one slot a block: tp, q, sum, max, min, the
  // sum of squares, the max
  __shared__ R xch[7][ICLN_FFT_CLUSTER_MAX];
  const CellStatsArgs<R>& p = a.c;
  IclnFftGroup grp;
  icln_cluster_arrive();
  const int C = grp.size(), rank = grp.rank();
  const int lc = C == 8 ? 3 : C == 4 ? 2 : 1;
  const int nbin = p.nbin, K = nbin / 2 + 1;
  const int P = a.odd, lm = a.log2l, lq = lm - lc, Q = P << lq;
  const int b0 = rank * Q, b1 = b0 + Q < nbin ? b0 + Q : nbin;  // this block's bins
  const int tid = threadIdx.x, nt = blockDim.x;
  C2* z = reinterpret_cast<C2*>(smem_raw);
  C2* lo = z + ((Q + (1 << S) - 1) >> S << S);
  C2* hi = lo + (1 << a.lt);
  for (int e = tid; e < a.ntw; e += nt) {
    const int h = e - (1 << a.lt);
    (h < 0 ? lo : hi)[icln_swz<S>(h < 0 ? e : h)] = __ldg(a.tw + e);
  }
  const long long first_lin = (long long)(blockIdx.x >> lc), stride = gridDim.x >> lc;
  for (long long lin = first_lin; lin < p.ncells; lin += stride) {
    long long chan, arch;
    const long long cell = icln_fft_cell(p, lin, chan, arch);
    const T* x = static_cast<const T*>(p.cube) + cell * nbin;
    Res res;
    res.setup(p, cell, (int)chan, arch);

    // ---- the fit ----
    R tp = R(0), q = R(0);
#pragma unroll 8
    for (int b = b0 + tid; b < b1; b += nt) {
      R v = R(0);
      if constexpr (Res::kStaged) v = icln_ldr(x + b);
      res.fitv(v, b, tp, q);
      if constexpr (kKeep) z[icln_swz<S>(b - b0)].x = v;
    }
    icln_fft_fold2(tp, q, red);
    if (lin == first_lin) icln_cluster_wait();
    icln_fft_push(grp, xch[0], rank, tp);
    icln_fft_push(grp, xch[1], rank, q);
    grp.sync();
    tp = icln_fft_meet(xch[0], C, IclnFftSum());
    q = icln_fft_meet(xch[1], C, IclnFftSum());
    res.finish(icln_tt(p, arch), p.w[cell], tp, q);

    // ---- the weighted residual, its sum, max and min ----
    R sum = R(0), mx = -INFINITY, mn = INFINITY;
#pragma unroll 8
    for (int b = b0 + tid; b < b1; b += nt) {
      const int sb = icln_swz<S>(b - b0);
      R v = R(0);
      if constexpr (kKeep) {
        v = z[sb].x;
      } else if constexpr (Res::kStaged) {
        v = icln_ldr(x + b);
      }
      const R r = res.atv(v, b);
      z[sb].x = r;
      sum += r;
      mx = icln_max(mx, r);
      mn = icln_min(mn, r);
    }
    icln_fft_fold3(sum, mx, mn, red);
    icln_fft_push(grp, xch[2], rank, sum);
    icln_fft_push(grp, xch[3], rank, mx);
    icln_fft_push(grp, xch[4], rank, mn);
    grp.sync();
    sum = icln_fft_meet(xch[2], C, IclnFftSum());
    mx = icln_fft_meet(xch[3], C, IclnFftMax());
    mn = icln_fft_meet(xch[4], C, IclnFftMin());
    const R mean = sum * p.inv_n;
    const bool m = p.mask[cell] != 0;
    const R centre = m ? R(0) : mean;

    // the next cell's bins into L2 while this one is transformed
    if (lin + stride < p.ncells && b1 > b0) {
      long long nch, nar;
      const char* nx = reinterpret_cast<const char*>(
          static_cast<const T*>(p.cube) + icln_fft_cell(p, lin + stride, nch, nar) * nbin + b0);
      const int bytes = (b1 - b0) * (int)sizeof(T);
      for (int o = tid * 128; o < bytes; o += nt * 128)
        asm volatile("prefetch.global.L2 [%0];" ::"l"(nx + o));
    }

    // ---- centred, its squares, times the chirp (the cross-cluster step
    // takes every position from nbin on as zero, unread) ----
    R var = R(0);
#pragma unroll 8
    for (int b = b0 + tid; b < b1; b += nt) {
      const int si = icln_swz<S>(b - b0);
      const R r = z[si].x - centre;
      var = icln_fma(r, r, var);
      const C2 w = __ldg(a.chirp + b);
      C2 zc;
      zc.x = r * w.x;
      zc.y = r * w.y;
      z[si] = zc;
    }
    var = icln_fft_fold(var, red, IclnFftSum());
    if (tid == 0) grp.at(xch[5], 0)[rank] = var;
    grp.sync();  // every block's row in place

    // ---- forward: K2f's transform ----
    R none = R(0);
    if (lc == 1)
      icln_fft_cross<1, R, IclnFftGroup, false>(grp, z, lo, hi, a.lt, Q, R(0), none, nbin);
    if (lc == 2)
      icln_fft_cross<2, R, IclnFftGroup, false>(grp, z, lo, hi, a.lt, Q, R(0), none, nbin);
    if (lc == 3)
      icln_fft_cross<3, R, IclnFftGroup, false>(grp, z, lo, hi, a.lt, Q, R(0), none, nbin);
    grp.sync();
    icln_fft_passes<LR, R>(z, lo, hi, a.lt, P, lq, lm);

    // ---- the odd stages, times B^, their inverse ----
    const C2* bh = a.bhat + (long long)rank * Q;
    if (P == 3) icln_fft_odd_mul_inv<3, R>(z, lo, hi, a.lt, lq, 2 << lm, bh);
    if (P == 5) icln_fft_odd_mul_inv<5, R>(z, lo, hi, a.lt, lq, 2 << lm, bh);
    if (P != 3 && P != 5) {
      if (P > 1) {
        icln_fft_odd<R>(z, lo, hi, a.lt, lq, P, 2 << lm);
        __syncthreads();
      }
      for (int i = tid; i < Q; i += nt) {
        const int si = icln_swz<S>(i);
        z[si] = icln_cmul(z[si], __ldg(bh + i));
      }
      __syncthreads();
      if (P > 1) icln_fft_odd_inv<R>(z, lo, hi, a.lt, lq, P, 2 << lm);
    } else {
      __syncthreads();
    }

    // ---- inverse, the max ----
    icln_fft_passes_inv<LR, R>(z, lo, hi, a.lt, P, lq, lm);
    grp.sync();  // every block's slice, before the cross-cluster step
    R best = R(0);
    if (lc == 1) best = icln_fft_cross_inv_max<1, R>(grp, z, lo, hi, a.lt, Q, K);
    if (lc == 2) best = icln_fft_cross_inv_max<2, R>(grp, z, lo, hi, a.lt, Q, K);
    if (lc == 3) best = icln_fft_cross_inv_max<3, R>(grp, z, lo, hi, a.lt, Q, K);
    best = icln_fft_fold(best, red, IclnFftMax());
    if (tid == 0) grp.at(xch[6], 0)[rank] = best;
    // no block leaves, or takes its next cell, while another may still
    // read its shared memory
    grp.sync();
    if (rank == 0 && tid == 0) {
      var = icln_fft_meet(xch[5], C, IclnFftSum());
      p.d_mean[cell] = m ? R(0) : mean;
      p.d_ptp[cell] = m ? icln_ma_fill<R>() : mx - mn;
      p.d_std[cell] = m ? R(0) : icln_sqrt(var * p.inv_n);
      p.d_fft[cell] = icln_sqrt(icln_fft_meet(xch[6], C, IclnFftMax()));
    }
  }
}

template <class Res>
int icln_fftg_cluster_launch(const CellStatsArgs<typename Res::Real>& p, const void* chirp,
                                    const void* bhat, int n, const IclnFftgTabs& tb,
                                    const IclnFftgCluster& cl, void* stream) {
  using R = typename Res::Real;
  using C2 = icln_cplx_t<R>;
  FftgClusterArgs<R> a = {};
  a.c = p;
  a.tw = static_cast<const C2*>(tb.tw);
  a.chirp = static_cast<const C2*>(chirp);
  a.bhat = static_cast<const C2*>(bhat);
  a.odd = cl.odd;
  a.lt = tb.lt;
  const long long two_m = 2LL * n;
  a.ntw = icln_fft_table_len((int)two_m);
  int lg = 0;
  while (cl.odd > 0 && (long long)cl.odd << lg < n && lg < 30) ++lg;
  a.log2l = lg;
  int odd = cl.odd;
  while (odd > 1 && odd % 5 == 0) odd /= 5;
  while (odd > 1 && odd % 3 == 0) odd /= 3;
  const long long run = 1LL << icln_fft_sw<R>();
  const long long slice = ((long long)n / cl.cluster + run - 1) / run * run;
  if (p.nbin < 2 || cl.odd < 1 || odd != 1 || (long long)cl.odd << lg != n ||
      n < (long long)p.nbin + p.nbin / 2 || two_m > 0x7FFFFFFFLL ||
      (cl.cluster != 2 && cl.cluster != 4 && cl.cluster != ICLN_FFT_CLUSTER_MAX) ||
      (1LL << lg) % (2 * cl.cluster) || cl.threads % 32 || cl.threads < 32 ||
      cl.threads > ICLN_FFTG_CLUSTER_THREADS || chirp == nullptr || bhat == nullptr ||
      tb.tw == nullptr || tb.lt != icln_fft_table_lt((int)two_m) ||
      cl.smem < slice * 2 * (long long)sizeof(R) +
                    2LL * icln_fft_table_slots((int)two_m) * (long long)sizeof(R) ||
      p.cpa < 1 || p.ncells % p.cpa || p.cpa % p.nchan || p.ncells * cl.cluster > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  void (*kernel)(const FftgClusterArgs<R>) = icln_fftg_cluster_kernel<Res>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)cl.smem);
  if (err != cudaSuccess) return (int)icln_take_error(err);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cl.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(p.ncells * cl.cluster));
  cfg.blockDim = dim3((unsigned)cl.threads);
  cfg.dynamicSmemBytes = (size_t)cl.smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  long long active = 0;
  err = icln_fft_resident((const void*)kernel, cl.cluster, cl.threads, cl.smem, &cfg, &active);
  if (err != cudaSuccess) return (int)icln_take_error(err);
  if (active < 1) return (int)cudaErrorLaunchOutOfResources;
  if (p.ncells > active) cfg.gridDim = dim3((unsigned)(active * cl.cluster));
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return (int)icln_take_error(err);
  return (int)cudaGetLastError();
}

// the launch's four residual forms on cubes of element type T: K2's with
// and without the Nyquist term, K7's, K6's (K10's entries run K2's and
// K6's)
#define ICLN_FFTG_CLUSTER_BUILD(T)                                                          \
  template int icln_fftg_cluster_launch<ResDisp<T, true>>(                                 \
      const CellStatsArgs<icln_real_t<T>>&, const void*, const void*, int,                 \
      const IclnFftgTabs&, const IclnFftgCluster&, void*);                                 \
  template int icln_fftg_cluster_launch<ResDisp<T, false>>(                                \
      const CellStatsArgs<icln_real_t<T>>&, const void*, const void*, int,                 \
      const IclnFftgTabs&, const IclnFftgCluster&, void*);                                 \
  template int icln_fftg_cluster_launch<ResTwoRead<T>>(                                    \
      const CellStatsArgs<icln_real_t<T>>&, const void*, const void*, int,                 \
      const IclnFftgTabs&, const IclnFftgCluster&, void*);                                 \
  template int icln_fftg_cluster_launch<ResDedisp<T>>(                                     \
      const CellStatsArgs<icln_real_t<T>>&, const void*, const void*, int,                 \
      const IclnFftgTabs&, const IclnFftgCluster&, void*);
