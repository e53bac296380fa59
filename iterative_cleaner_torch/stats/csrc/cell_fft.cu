// Cell diagnostics past the DFT tables (K2f): the four planes of K2, K7,
// K6 and K10 (d_std, d_mean, d_ptp, d_fft) on profiles longer than the
// DFT route takes (stats.kernels.cell_stats_route "fft"), the spectrum
// by a real FFT in shared memory in place of the (nbin, nbin/2 + 1)
// cos/sin tables.
//
// Replaces no Pallas kernel: past FUSED_STATS_MAX_NBIN = 4096 bins
// (iterative_cleaner_tpu/stats/pallas_kernels.py:596, refused at
// :1132-1135) the reference computes these planes on its XLA route
// (backends/jax_backend.py:100-130): cell_diagnostics_jax with
// jnp.fft.rfft (iterative_cleaner_tpu/stats/masked_jax.py:128-179).  This
// kernel computes what that route computes on the residual each of K2
// (with and without the Nyquist term), K7, K6 and K10 forms: the mean,
// the two-pass centred variance, the ptp of the weighted residual,
// masked cells patched per rule 4, and max over k of |rFFT(centred)|.
//
// Bound: bytes.  One read of the cube row (and of the template rows) per
// cell, four planes out; the FFT's (5/2) N log2 N + 6 N operations a cell
// are under half of that at the float32 peak (at 32 x 256 x 65536: the
// cube's 2.15 GB take 0.64 ms at 3.35 TB/s, 2.5e10 operations 0.37 ms at
// 67 TFLOP/s; telemetry/profiling.py kernel_costs "*_fft").  The DFT form
// at that shape would be about 7e13 operations.
//
// Design: one block a cell, or one thread-block cluster of C = 2, 4 or 8
// blocks a cell where the row does not fit one block's shared memory
// (kernels.cell_fft_plan: one block of the most threads where the row
// fits, else C = 8 blocks of 256 threads, the fastest width in
// tools/time_cell_fft.py's sweep past one block).  Block r of the
// cell holds bins [r N / C, (r + 1) N / C) of its row, in place, 4 N / C
// bytes (8 N / C in float64):
//   the fit       each thread reads its bins of the cube row from device
//                 memory once through the residual struct of
//                 cell_stats.cuh (Res::setup / fit / finish / at, so every
//                 residual form of K2, K7, K6 and K10 has its entry), a
//                 float32 (float64) row kept in shared memory as it is
//                 read; a bf16 row is not kept: the residual is
//                 recomputed from the cube row where it lies, the same
//                 operations on the same upcast values, so a bf16 launch
//                 is bit-equal to the float32 launch on the upcast cube;
//   the moments   the dot products, the residual's sum, max and min and
//                 the centred row's sum of squares each by a fixed-order
//                 block reduction (warp shuffles, then the warps' partials
//                 in order), and on a cluster every block's partial pushed
//                 into every block's shared memory (distributed shared
//                 memory) and summed there in rank order after a cluster
//                 barrier: every block holds the same bits;
//   the FFT       z[n] = x[2n] + i x[2n+1] is the row itself read as N/2
//                 complex values in natural order.  N/2 = P 2^m with P =
//                 1, 3 or 5: m radix-2 decimation-in-frequency stages
//                 (half-spans N/4 down to P, each butterfly a' = a + b,
//                 b' = (a - b) W), then one radix-P stage on contiguous
//                 groups of P; Z[rev_m(s) + 2^m t] lands at position
//                 s P + t.  On a cluster the first log2 C stages (half-
//                 spans of a block's slice or more) exchange through
//                 distributed shared memory, a cluster barrier after
//                 each; every later stage is local;
//   the split     X[k] = (Z[k] + conj Z[N/2 - k]) / 2 - i W^k (Z[k] -
//                 conj Z[N/2 - k]) / 2 for each position's k (the
//                 partner read through distributed shared memory on a
//                 cluster), X[N/2] = Re Z[0] - Im Z[0];
//   the max       |X_k|^2 maxed per thread with the NaN-propagating
//                 icln_max from +0, then by block reduction, the blocks'
//                 maxima meeting in the leader's shared memory (order-
//                 free), and one sqrt: sqrt is monotone, so it commutes
//                 with the max.
// Each thread's loops over bins, butterflies and positions are unrolled
// (8 or 4 deep) so that a thread keeps several loads in flight: one
// block of a row that fits is all an SM holds.
// The twiddles W_N^j, j < N/2, come from a table the wrapper builds in
// float64 on the host and rounds to the arithmetic type, cached per device
// and N as the DFT tables are; W_N^(j + N/2) = -W_N^j.  No float atomics.
//
// A batch of equal-shaped archives is one launch over all their cells
// (cell / cpa is the cell's archive): each cell's arithmetic is its own,
// so each archive's planes are bit-equal to a launch on it alone, and
// K10's entries run the very instantiations of K2's and K6's.  A float64
// cube runs the same kernel in double (CellStatsArgs<double>, double
// twiddles, rows and planes).  `out=` tiles come as plane pointers.
//
// The cluster launch (cudaLaunchKernelEx with the cluster-dimension
// attribute) first asks cudaOccupancyMaxActiveClusters whether the
// cluster fits an SM group at the plan's shared memory and returns
// cudaErrorLaunchOutOfResources where it does not, as sides_cluster.cu
// does; the wrapper raises on any error and never falls back.

#include <cooperative_groups.h>

#include "cell_stats.cuh"

namespace cg = cooperative_groups;

#define ICLN_FFT_CLUSTER_MAX 8   // portable cluster size
#define ICLN_FFT_THREADS 1024
#define ICLN_FFT_THREADS_F64 512  // double butterflies: twice the registers

template <class R>
__host__ __device__ constexpr int icln_fft_max_threads() {
  return sizeof(R) == 8 ? ICLN_FFT_THREADS_F64 : ICLN_FFT_THREADS;
}

template <class R>
struct IclnCplx;

template <>
struct IclnCplx<float> {
  using type = float2;
};

template <>
struct IclnCplx<double> {
  using type = double2;
};

template <class R>
using icln_cplx_t = typename IclnCplx<R>::type;

template <class C2>
__device__ __forceinline__ C2 icln_cadd(C2 a, C2 b) {
  C2 r;
  r.x = a.x + b.x;
  r.y = a.y + b.y;
  return r;
}

template <class C2>
__device__ __forceinline__ C2 icln_csub(C2 a, C2 b) {
  C2 r;
  r.x = a.x - b.x;
  r.y = a.y - b.y;
  return r;
}

template <class C2>
__device__ __forceinline__ C2 icln_cmul(C2 a, C2 w) {
  C2 r;
  r.x = a.x * w.x - a.y * w.y;
  r.y = a.x * w.y + a.y * w.x;
  return r;
}

template <class R>
struct CellFftArgs {
  CellStatsArgs<R> c;  // the residual's operands, the planes and the counts
  const R* tw;         // (nbin/2, 2): W_N^j = (cos, sin)(-2 pi j / N), j < N/2
  int odd;             // P: nbin/2 = P * 2^log2l
  int log2l;
};

// W_N^j for j in [0, N): the table's entry, negated past N/2
template <class R>
__device__ __forceinline__ icln_cplx_t<R> icln_twiddle(const R* tw, int half, int j) {
  using C2 = icln_cplx_t<R>;
  const bool neg = j >= half;
  C2 w = __ldg(reinterpret_cast<const C2*>(tw) + (neg ? j - half : j));
  if (neg) {
    w.x = -w.x;
    w.y = -w.y;
  }
  return w;
}

// The blocks of one cell: one block, or a thread-block cluster.
template <bool CL>
struct IclnFftGroup;

template <>
struct IclnFftGroup<false> {
  __device__ int size() const { return 1; }
  __device__ int rank() const { return 0; }
  __device__ void sync() const { __syncthreads(); }
  template <class X>
  __device__ X* at(X* p, int) const {
    return p;
  }
};

template <>
struct IclnFftGroup<true> {
  cg::cluster_group cl;
  __device__ IclnFftGroup() : cl(cg::this_cluster()) {}
  __device__ int size() const { return (int)cl.num_blocks(); }
  __device__ int rank() const { return (int)cl.block_rank(); }
  __device__ void sync() { cl.sync(); }
  template <class X>
  __device__ X* at(X* p, int r) {
    return cl.map_shared_rank(p, r);
  }
};

struct IclnFftSum {
  template <class R>
  __device__ R operator()(R a, R b) const {
    return a + b;
  }
};

struct IclnFftMax {
  template <class R>
  __device__ R operator()(R a, R b) const {
    return icln_max(a, b);
  }
};

struct IclnFftMin {
  template <class R>
  __device__ R operator()(R a, R b) const {
    return icln_min(a, b);
  }
};

// A fixed-order block reduction: warp shuffles, then lane 0's partials of
// the warps in order; every thread returns the same value.
template <class R, class Op>
__device__ __forceinline__ R icln_fft_fold(R v, R* red, Op op) {
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(ICLN_FULL, v, o));
  const int nw = blockDim.x >> 5;
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  R r = red[0];
  for (int i = 1; i < nw; ++i) r = op(r, red[i]);
  __syncthreads();  // red is free again
  return r;
}

// This block's partial into slot `rank` of `slot` in every block of the
// cluster (read after the next cluster barrier).
template <class R, class G>
__device__ __forceinline__ void icln_fft_push(G& grp, R* slot, int rank, R v) {
  if (threadIdx.x < grp.size()) grp.at(slot, (int)threadIdx.x)[rank] = v;
}

template <class R, class Op>
__device__ __forceinline__ R icln_fft_meet(const R* slot, int C, Op op) {
  R r = slot[0];
  for (int q = 1; q < C; ++q) r = op(r, slot[q]);
  return r;
}

// One length-P DFT (P = 3 or 5) on each contiguous group of P of this
// block's Q complex values: the last stage of the decimation in frequency.
template <int P, class R>
__device__ void icln_fft_radix(icln_cplx_t<R>* z, int Q, const R* tw, int half, int step) {
  using C2 = icln_cplx_t<R>;
  C2 w[P];
#pragma unroll
  for (int v = 0; v < P; ++v) w[v] = icln_twiddle(tw, half, v * step);  // W_P^v
  for (int s = threadIdx.x; s < Q / P; s += blockDim.x) {
    C2* zs = z + s * P;
    C2 in[P];
#pragma unroll
    for (int u = 0; u < P; ++u) in[u] = zs[u];
#pragma unroll
    for (int t = 0; t < P; ++t) {
      C2 acc = in[0];
#pragma unroll
      for (int u = 1; u < P; ++u) acc = icln_cadd(acc, icln_cmul(in[u], w[(u * t) % P]));
      zs[t] = acc;
    }
  }
}

template <class Res, bool CL>
__global__ void __launch_bounds__(icln_fft_max_threads<typename Res::Real>())
    icln_cell_fft_kernel(const CellFftArgs<typename Res::Real> a) {
  using T = typename Res::Elem;
  using R = typename Res::Real;
  using C2 = icln_cplx_t<R>;
  // the row is kept as it is read (float32 and float64 cubes)
  constexpr bool kRow = std::is_same<T, R>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ R red[32];
  // the cluster's partials, one slot a block: tp, q, sum, max, min, the
  // sum of squares, the spectrum's max
  __shared__ R xch[7][ICLN_FFT_CLUSTER_MAX];
  const CellStatsArgs<R>& p = a.c;
  IclnFftGroup<CL> grp;
  const int C = grp.size(), rank = grp.rank();
  // every block of the cluster runs before any writes into another's
  // shared memory
  if (CL) grp.sync();
  const long long cell = blockIdx.x / C;
  const int nbin = p.nbin, per = nbin / C, b0 = rank * per, b1 = b0 + per;
  const int tid = threadIdx.x, nt = blockDim.x;
  const long long arch = cell / p.cpa;
  R* row = reinterpret_cast<R*>(smem_raw);
  R* rowg = row - b0;  // indexed by the bin
  const T* x = static_cast<const T*>(p.cube) + cell * nbin;
  Res res;
  res.setup(p, cell, (int)((cell % p.cpa) % p.nchan), arch);

  // ---- the fit: <x, t> (and K2's x * (-1)^b) over the row ----
  R tp = R(0), q = R(0);
#pragma unroll 8
  for (int b = b0 + tid; b < b1; b += nt) res.fit(x, rowg, b, tp, q);
  tp = icln_fft_fold(tp, red, IclnFftSum());
  q = icln_fft_fold(q, red, IclnFftSum());
  if (CL) {
    icln_fft_push(grp, xch[0], rank, tp);
    icln_fft_push(grp, xch[1], rank, q);
    grp.sync();
    tp = icln_fft_meet(xch[0], C, IclnFftSum());
    q = icln_fft_meet(xch[1], C, IclnFftSum());
  }
  res.finish(icln_tt(p, arch), p.w[cell], tp, q);

  // ---- the weighted residual, its sum, max and min ----
  R sum = R(0), mx = -INFINITY, mn = INFINITY;
#pragma unroll 8
  for (int b = b0 + tid; b < b1; b += nt) {
    R v;
    if constexpr (kRow) {
      v = res.at(rowg, b);
    } else {
      v = res.at(x, b);
    }
    rowg[b] = v;
    sum += v;
    mx = icln_max(mx, v);
    mn = icln_min(mn, v);
  }
  sum = icln_fft_fold(sum, red, IclnFftSum());
  mx = icln_fft_fold(mx, red, IclnFftMax());
  mn = icln_fft_fold(mn, red, IclnFftMin());
  if (CL) {
    icln_fft_push(grp, xch[2], rank, sum);
    icln_fft_push(grp, xch[3], rank, mx);
    icln_fft_push(grp, xch[4], rank, mn);
    grp.sync();
    sum = icln_fft_meet(xch[2], C, IclnFftSum());
    mx = icln_fft_meet(xch[3], C, IclnFftMax());
    mn = icln_fft_meet(xch[4], C, IclnFftMin());
  }
  const R mean = sum * p.inv_n;
  const bool m = p.mask[cell] != 0;
  const R centre = m ? R(0) : mean;

  // ---- the centred row (the spectrum's input) and its sum of squares ----
  R var = R(0);
#pragma unroll 8
  for (int b = b0 + tid; b < b1; b += nt) {
    const R cv = rowg[b] - centre;
    rowg[b] = cv;
    var += cv * cv;
  }
  var = icln_fft_fold(var, red, IclnFftSum());
  if (CL) {
    icln_fft_push(grp, xch[5], rank, var);
    grp.sync();  // also: every block's centred row is in place
    var = icln_fft_meet(xch[5], C, IclnFftSum());
  } else {
    __syncthreads();
  }
  if (rank == 0 && tid == 0) {
    p.d_mean[cell] = m ? R(0) : mean;
    p.d_ptp[cell] = m ? icln_ma_fill<R>() : mx - mn;
    p.d_std[cell] = m ? R(0) : icln_sqrt(var * p.inv_n);
  }

  // ---- the complex FFT of z[n] = x[2n] + i x[2n+1], in place ----
  C2* z = reinterpret_cast<C2*>(row);
  const int half = nbin / 2, Q = half / C;  // complex values a block
  const int P = a.odd, lm = a.log2l, L = 1 << lm;
  const int nbf = half / 2 / C, jb = rank * nbf;  // butterflies a block a stage
  for (int k = 1; k <= lm; ++k) {
    const int S = half >> k;  // half-span
    const bool cross = CL && S >= Q;
#pragma unroll 4
    for (int jj = tid; jj < nbf; jj += nt) {
      const int j = jb + jj;
      const int g = j / S, i = j - g * S;
      const int pa = 2 * g * S + i, pb = pa + S;
      C2* za;
      C2* zb;
      if (cross) {
        za = grp.at(z, pa / Q) + pa % Q;
        zb = grp.at(z, pb / Q) + pb % Q;
      } else {
        za = z + (pa - rank * Q);
        zb = z + (pb - rank * Q);
      }
      const C2 u = *za, v = *zb;
      *za = icln_cadd(u, v);
      *zb = icln_cmul(icln_csub(u, v), icln_twiddle(a.tw, half, i << k));  // W_{2S}^i
    }
    if (cross) {
      grp.sync();
    } else {
      __syncthreads();
    }
  }
  if (P == 3) icln_fft_radix<3, R>(z, Q, a.tw, half, 2 * L);  // W_P = W_N^(N/P)
  if (P == 5) icln_fft_radix<5, R>(z, Q, a.tw, half, 2 * L);
  grp.sync();  // the whole spectrum, every block's, before the split

  // ---- the split: |X_k|^2 of the real row's spectrum, maxed ----
  R best = R(0);
#pragma unroll 4
  for (int o = tid; o < Q; o += nt) {
    const int pos = rank * Q + o;
    const int s = pos / P, t = pos - s * P;
    const int kk = (int)(__brev((unsigned)s) >> (32 - lm)) + L * t;
    const int kp = kk == 0 ? 0 : half - kk;
    const int pp = (int)(__brev((unsigned)(kp & (L - 1))) >> (32 - lm)) * P + (kp >> lm);
    const C2 A = z[o];
    const C2 B = *(grp.at(z, pp / Q) + pp % Q);  // Z[N/2 - k], conjugated below
    const R er = R(0.5) * (A.x + B.x), ei = R(0.5) * (A.y - B.y);
    const R orr = R(0.5) * (A.x - B.x), oi = R(0.5) * (A.y + B.y);
    const C2 w = icln_twiddle(a.tw, half, kk);
    const R wor = w.x * orr - w.y * oi, woi = w.x * oi + w.y * orr;
    const R xr = er + woi, xi = ei - wor;
    best = icln_max(best, xr * xr + xi * xi);
    if (kk == 0) {  // X[N/2]
      const R xn = A.x - A.y;
      best = icln_max(best, xn * xn);
    }
  }
  best = icln_fft_fold(best, red, IclnFftMax());
  if (CL) {
    if (tid == 0) grp.at(xch[6], 0)[rank] = best;
    // no block leaves while another may still read its shared memory
    grp.sync();
    if (rank == 0 && tid == 0) p.d_fft[cell] = icln_sqrt(icln_fft_meet(xch[6], C, IclnFftMax()));
  } else if (tid == 0) {
    p.d_fft[cell] = icln_sqrt(best);
  }
}

template <class Res>
static int icln_cell_fft_launch(const CellFftArgs<typename Res::Real>& a, int cluster,
                                int threads, long long smem_bytes, void* stream) {
  using R = typename Res::Real;
  const CellStatsArgs<R>& p = a.c;
  const int half = p.nbin / 2;
  if (p.nbin < 4 || p.nbin % 2 || (a.odd != 1 && a.odd != 3 && a.odd != 5) || a.log2l < 1 ||
      a.log2l > 30 || (long long)a.odd << a.log2l != half ||
      (cluster != 1 && cluster != 2 && cluster != 4 && cluster != ICLN_FFT_CLUSTER_MAX) ||
      (1 << a.log2l) % (2 * cluster) || threads % 32 || threads < 32 ||
      threads > icln_fft_max_threads<R>() ||
      smem_bytes < (long long)p.nbin / cluster * (long long)sizeof(R) || p.cpa < 1 ||
      p.ncells % p.cpa || p.cpa % p.nchan || p.ncells * cluster > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned blocks = (unsigned)(p.ncells * cluster);
  if (cluster == 1) {
    void (*kernel)(const CellFftArgs<R>) = icln_cell_fft_kernel<Res, false>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem_bytes);
    if (err != cudaSuccess) return (int)icln_take_error(err);
    kernel<<<blocks, threads, (size_t)smem_bytes, st>>>(a);
    return (int)cudaGetLastError();
  }
  void (*kernel)(const CellFftArgs<R>) = icln_cell_fft_kernel<Res, true>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
  if (err != cudaSuccess) return (int)icln_take_error(err);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = (size_t)smem_bytes;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // a cluster of this size at this shared memory must fit an SM group
  int active = 0;
  err = cudaOccupancyMaxActiveClusters(&active, kernel, &cfg);
  if (err != cudaSuccess) return (int)icln_take_error(err);
  if (active < 1) return (int)cudaErrorLaunchOutOfResources;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return (int)icln_take_error(err);
  return (int)cudaGetLastError();
}

template <class R>
static CellFftArgs<R> icln_cell_fft_args(const unsigned char* mask, const void* w, const void* tw,
                                         const void* tt, void* d_std, void* d_mean, void* d_ptp,
                                         void* d_fft, long long ncells, long long cpa, int nchan,
                                         int nbin, int odd, double inv_n) {
  CellFftArgs<R> a = {};
  a.c = icln_cell_stats_args<R>(mask, w, nullptr, nullptr, tt, d_std, d_mean, d_ptp, d_fft,
                                ncells, cpa, nchan, nbin, 1, 0, 0, 0, inv_n);
  a.tw = static_cast<const R*>(tw);
  a.odd = odd;
  // log2 of the power of two nbin/2 = odd * 2^log2l (the launch checks it)
  const int l = odd > 0 ? nbin / 2 / odd : 0;
  int lg = 0;
  while ((1 << lg) < l && lg < 30) ++lg;
  a.log2l = l > 0 && (1 << lg) == l ? lg : -1;
  return a;
}

// K2's residual (`nyq` null: no Nyquist term), on cubes of element type T
template <class T>
static int icln_cell_fft_disp_t(CellFftArgs<icln_real_t<T>> a, const void* disp,
                                const void* rott, const void* nyq, int cluster, int threads,
                                long long smem_bytes, void* stream) {
  using R = icln_real_t<T>;
  a.c.cube = disp;
  a.c.rott = static_cast<const R*>(rott);
  a.c.nyq = static_cast<const R*>(nyq);
  return a.c.nyq ? icln_cell_fft_launch<ResDisp<T, true>>(a, cluster, threads, smem_bytes, stream)
                 : icln_cell_fft_launch<ResDisp<T, false>>(a, cluster, threads, smem_bytes,
                                                           stream);
}

template <class T>
static int icln_cell_fft_two_read_t(CellFftArgs<icln_real_t<T>> a, const void* ded,
                                    const void* disp_base, const void* rott, const void* tmpl,
                                    int cluster, int threads, long long smem_bytes,
                                    void* stream) {
  using R = icln_real_t<T>;
  a.c.cube = ded;
  a.c.base = disp_base;
  a.c.rott = static_cast<const R*>(rott);
  a.c.tmpl = static_cast<const R*>(tmpl);
  return icln_cell_fft_launch<ResTwoRead<T>>(a, cluster, threads, smem_bytes, stream);
}

template <class T>
static int icln_cell_fft_dedisp_t(CellFftArgs<icln_real_t<T>> a, const void* ded,
                                  const void* tmpl, const void* win, int cluster, int threads,
                                  long long smem_bytes, void* stream) {
  using R = icln_real_t<T>;
  a.c.cube = ded;
  a.c.tmpl = static_cast<const R*>(tmpl);
  a.c.win = static_cast<const R*>(win);
  return icln_cell_fft_launch<ResDedisp<T>>(a, cluster, threads, smem_bytes, stream);
}

// The entries.  `kind`: the cubes' storage, 0 float32, 1 bf16, 2 float64
// (every other pointer then double); `tw` the (nbin/2, 2) twiddles of
// the arithmetic type; inv_n float32(1/nbin) for float, 1/nbin for
// double; cluster the blocks a cell (1, 2, 4 or 8), odd the odd part of
// nbin/2 (1, 3 or 5).

#define ICLN_FFT_ARGS(R)                                                                      \
  icln_cell_fft_args<R>(mask, w, tw, tt, d_std, d_mean, d_ptp, d_fft, ncells, cpa, nchan, nbin, \
                        odd, inv_n)

static int icln_fft_disp_entry(const void* disp, const void* rott, const void* nyq, const void* w,
                               const unsigned char* mask, const void* tw, const void* tt,
                               void* d_std, void* d_mean, void* d_ptp, void* d_fft,
                               long long ncells, long long cpa, int nchan, int nbin, int cluster,
                               int odd, int threads, long long smem_bytes, double inv_n, int kind,
                               void* stream) {
  if (kind == 2)
    return icln_cell_fft_disp_t<double>(ICLN_FFT_ARGS(double), disp, rott, nyq, cluster, threads,
                                        smem_bytes, stream);
  if (kind == 1)
    return icln_cell_fft_disp_t<icln_bf16>(ICLN_FFT_ARGS(float), disp, rott, nyq, cluster,
                                           threads, smem_bytes, stream);
  if (kind == 0)
    return icln_cell_fft_disp_t<float>(ICLN_FFT_ARGS(float), disp, rott, nyq, cluster, threads,
                                       smem_bytes, stream);
  return (int)cudaErrorInvalidValue;
}

static int icln_fft_dedisp_entry(const void* ded, const void* tmpl, const void* win, const void* w,
                                 const unsigned char* mask, const void* tw, const void* tt,
                                 void* d_std, void* d_mean, void* d_ptp, void* d_fft,
                                 long long ncells, long long cpa, int nchan, int nbin,
                                 int cluster, int odd, int threads, long long smem_bytes,
                                 double inv_n, int kind, void* stream) {
  if (kind == 2)
    return icln_cell_fft_dedisp_t<double>(ICLN_FFT_ARGS(double), ded, tmpl, win, cluster,
                                          threads, smem_bytes, stream);
  if (kind == 1)
    return icln_cell_fft_dedisp_t<icln_bf16>(ICLN_FFT_ARGS(float), ded, tmpl, win, cluster,
                                             threads, smem_bytes, stream);
  if (kind == 0)
    return icln_cell_fft_dedisp_t<float>(ICLN_FFT_ARGS(float), ded, tmpl, win, cluster, threads,
                                         smem_bytes, stream);
  return (int)cudaErrorInvalidValue;
}

// K2's residual
extern "C" int icln_cell_fft_disp(const void* disp, const void* rott, const void* nyq,
                                  const void* w, const unsigned char* mask, const void* tw,
                                  const void* tt, void* d_std, void* d_mean, void* d_ptp,
                                  void* d_fft, long long ncells, long long cpa, int nchan,
                                  int nbin, int cluster, int odd, int threads,
                                  long long smem_bytes, double inv_n, int kind, void* stream) {
  return icln_fft_disp_entry(disp, rott, nyq, w, mask, tw, tt, d_std, d_mean, d_ptp, d_fft,
                             ncells, cpa, nchan, nbin, cluster, odd, threads, smem_bytes, inv_n,
                             kind, stream);
}

// K7's residual (two reads)
extern "C" int icln_cell_fft_two_read(const void* ded, const void* disp_base, const void* rott,
                                      const void* tmpl, const void* w, const unsigned char* mask,
                                      const void* tw, const void* tt, void* d_std, void* d_mean,
                                      void* d_ptp, void* d_fft, long long ncells, long long cpa,
                                      int nchan, int nbin, int cluster, int odd, int threads,
                                      long long smem_bytes, double inv_n, int kind,
                                      void* stream) {
  if (kind == 2)
    return icln_cell_fft_two_read_t<double>(ICLN_FFT_ARGS(double), ded, disp_base, rott, tmpl,
                                            cluster, threads, smem_bytes, stream);
  if (kind == 1)
    return icln_cell_fft_two_read_t<icln_bf16>(ICLN_FFT_ARGS(float), ded, disp_base, rott, tmpl,
                                               cluster, threads, smem_bytes, stream);
  if (kind == 0)
    return icln_cell_fft_two_read_t<float>(ICLN_FFT_ARGS(float), ded, disp_base, rott, tmpl,
                                           cluster, threads, smem_bytes, stream);
  return (int)cudaErrorInvalidValue;
}

// K6's residual
extern "C" int icln_cell_fft_dedisp(const void* ded, const void* tmpl, const void* win,
                                    const void* w, const unsigned char* mask, const void* tw,
                                    const void* tt, void* d_std, void* d_mean, void* d_ptp,
                                    void* d_fft, long long ncells, long long cpa, int nchan,
                                    int nbin, int cluster, int odd, int threads,
                                    long long smem_bytes, double inv_n, int kind, void* stream) {
  return icln_fft_dedisp_entry(ded, tmpl, win, w, mask, tw, tt, d_std, d_mean, d_ptp, d_fft,
                               ncells, cpa, nchan, nbin, cluster, odd, threads, smem_bytes, inv_n,
                               kind, stream);
}

// K10's entries: K2's and K6's instantiations on one rank's shard, so
// their planes are bit-equal to those entries' on the same shard
extern "C" int icln_shard_fft_disp(const void* disp, const void* rott, const void* nyq,
                                   const void* w, const unsigned char* mask, const void* tw,
                                   const void* tt, void* d_std, void* d_mean, void* d_ptp,
                                   void* d_fft, long long ncells, long long cpa, int nchan,
                                   int nbin, int cluster, int odd, int threads,
                                   long long smem_bytes, double inv_n, int kind, void* stream) {
  return icln_fft_disp_entry(disp, rott, nyq, w, mask, tw, tt, d_std, d_mean, d_ptp, d_fft,
                             ncells, cpa, nchan, nbin, cluster, odd, threads, smem_bytes, inv_n,
                             kind, stream);
}

extern "C" int icln_shard_fft_dedisp(const void* ded, const void* tmpl, const void* win,
                                     const void* w, const unsigned char* mask, const void* tw,
                                     const void* tt, void* d_std, void* d_mean, void* d_ptp,
                                     void* d_fft, long long ncells, long long cpa, int nchan,
                                     int nbin, int cluster, int odd, int threads,
                                     long long smem_bytes, double inv_n, int kind, void* stream) {
  return icln_fft_dedisp_entry(ded, tmpl, win, w, mask, tw, tt, d_std, d_mean, d_ptp, d_fft,
                               ncells, cpa, nchan, nbin, cluster, odd, threads, smem_bytes, inv_n,
                               kind, stream);
}
