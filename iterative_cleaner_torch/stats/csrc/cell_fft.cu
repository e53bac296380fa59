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
// at that shape would be about 7e13 operations.  What bounds it in
// practice is its own instructions a bin (the first design, one radix-2
// pass and one barrier a stage, a division and a device-memory twiddle a
// butterfly, took about 7 SM-cycles a bin); this design cuts them.
//
// Design: one thread-block cluster of C = 2, 4 or 8 blocks a cell
// (kernels.cell_fft_plan, from tools/time_cell_fft.py's sweep: the
// fewest blocks whose slices hold at most 8192 bins, 128 threads each).
// The launch is persistent (as many cells as the card holds at once,
// each cluster walking the rest) and takes each archive's
// cells channel by channel (8 channels at a time in float64; the cells in
// flight share their template rows in L2), the next cell's slice of the
// cube prefetched into L2.  Block r of the cell holds bins [r N / C,
// (r + 1) N / C) of its row as Q = N / 2C complex values z[n] = x[2n] +
// i x[2n+1], value a of the slice at slot a ^ ((a >> S) & (2^S - 1)) (an
// XOR swizzle within aligned runs of 2^S, 16 values in float32 and 8 in
// float64, one 128-byte wavefront, so that the strided register loads
// below hit distinct banks), beside the twiddle tables:
//   the fit       each thread reads two bins of the cube row (one complex
//                 value) at a time from device memory through the residual
//                 struct of cell_stats.cuh (Res::setup / finish and the
//                 value forms fitv / atv, so every residual form of K2, K7,
//                 K6 and K10 has its entry), a float32 (float64) row kept
//                 in shared memory as it is read; a bf16 row is not kept:
//                 the residual is recomputed from the cube row where it
//                 lies, the same operations on the same upcast values, so
//                 a bf16 launch is bit-equal to the float32 launch on the
//                 upcast cube;
//   the moments   the dot products, then the residual's sum, max and min,
//                 by fixed-order block reductions (warp shuffles, then the
//                 warps' partials in order; the dot products in one pair of
//                 barriers, the sum, max and min in another), and on a
//                 cluster every block's partial pushed into every block's
//                 shared memory (distributed shared memory) and summed in rank
//                 order after a cluster barrier: every block holds the same
//                 bits.  The centred row is not a pass of its own: the
//                 FFT's first pass subtracts the mean as it loads each value
//                 and sums the squares (folded in the same fixed order, the
//                 blocks' partials met in the leader in rank order);
//   the FFT       N/2 = P 2^m with P = 3^a 5^b, decimation in frequency
//                 in passes of 2^r-point butterflies held in registers: a
//                 pass at stride s = P 2^x loads the 2^r values u0 P + v +
//                 k s (k < 2^r) of one group, runs r radix-2 stages on them
//                 with constant twiddles (the 2^r-point DFT, its outputs in
//                 bit-reversed register order), multiplies register k by
//                 W_M^(i brev(k)) (M = 2^r s, i the group's offset in its
//                 span) and stores each register where it was loaded: the
//                 same layout as r radix-2 stages, with one load and one
//                 store a value and one barrier a pass.  On a cluster the
//                 first log2 C stages are one step: each thread gathers the
//                 C values one slice apart, one from each block, through
//                 distributed shared memory, runs them as one C-point pass
//                 and writes them back, with one cluster barrier.  Then the
//                 block's slice in passes of 8 points, the first taking the
//                 remainder (a group whose offset i is 0 skips its unit
//                 twiddles); at 65,536 float32 bins on a cluster of 8, one
//                 cluster step and four local passes where the first design
//                 ran 15 stages and 15 barriers.  Then the odd part's
//                 stages on contiguous groups of P, radix 5 while the span
//                 holds a factor 5, then radix 3, each with its own
//                 twiddles W_sp^(j t) from the table (icln_fft_odd; at P =
//                 3 or 5 one stage, the first design's, its indices free
//                 of run-time divisions); Z[rev_m(s) + 2^m
//                 f(t)] lands at position s P + t, f(t) the odd stages'
//                 digit reversal (icln_fft_odd_freq).  Every span and
//                 slice is P times a power of two: positions are u P + v
//                 with u's fields taken by shifts and masks, P a multiplier
//                 (the radix a template parameter only where it sizes
//                 registers); a slice is padded to a whole run of the
//                 swizzle in shared memory;
//   the twiddles  a group of 2^L values takes W_N^(m e1), m < 2^L: its L
//                 powers of two from a two-level table, W_N^e = W_N^(e_hi
//                 T) W_N^(e_lo), of T + N / T entries (T = 2^(ceil(log2 N)
//                 / 2), 512 entries at 65,536 bins) that the wrapper builds
//                 in float64 on the host and rounds to the arithmetic type,
//                 cached per device and N (each block copies it into shared
//                 memory once, each part swizzled as the row is: a pass's
//                 threads read the low part at strides of 2^k entries),
//                 every other m the product of its highest power of two and
//                 the rest;
//   the split     X[k] = (Z[k] + conj Z[N/2 - k]) / 2 - i W^k (Z[k] -
//                 conj Z[N/2 - k]) / 2, a pair (k, N/2 - k) at a time from
//                 its two values (the partner read through distributed
//                 shared memory on a cluster; W^(N/2 - k) = -conj W^k),
//                 X[N/2] = Re Z[0] - Im Z[0];
//   the max       |X_k|^2 maxed per thread with the NaN-propagating
//                 icln_max from +0, then by block reduction, the blocks'
//                 maxima meeting in the leader's shared memory (order-
//                 free), and one sqrt: sqrt is monotone, so it commutes
//                 with the max.
// Multiplies and adds of the FFT fuse where the code says so (icln_fma);
// no float atomics.  The CPU tests hold a numpy model of these index maps
// and tables to np.fft.rfft (tests/test_torch_cell_fft_schedule.py).
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
// does (the answer, which also sizes the persistent grid, cached per
// device and launch shape); the wrapper raises on any error and never
// falls back.

#include "fft_cluster.cuh"

template <class R>
struct CellFftArgs {
  CellStatsArgs<R> c;  // the residual's operands, the planes and the counts
  const R* tw;         // (ntw, 2): W_N^j for j < 2^lt, then W_N^(h 2^lt) for h < ntw - 2^lt
  int odd;             // P: nbin/2 = P * 2^log2l
  int log2l;
  int lt;              // log2 of the table's low part
  int ntw;             // the table's entries
};

// The split's max of |X_k|^2 over this block's share of the pairs (k,
// N/2 - k), k <= N/2 - k, each pair's two bins from its two values (so
// every value is read once): position s P + t (s = rank 2^lq + sl) holds
// Z[k], k = rev_m(s) + 2^m f(t) (f the odd stages' order,
// icln_fft_odd_freq); its partner Z[N/2 - k] is found by the inverse
// maps, in whichever block holds it, and W^(N/2 - k) = -conj W^k.
// With odd part 1 the pairs' first members are the even positions and
// position 1 (k = N/4, its own partner); else every position is visited
// and the second members pass.
template <class R, class G>
__device__ __forceinline__ R icln_fft_split(G& grp, icln_cplx_t<R>* z,
                                            const icln_cplx_t<R>* lo, const icln_cplx_t<R>* hi,
                                            int lt, int P, int lq, int lm, int rank) {
  using C2 = icln_cplx_t<R>;
  constexpr int S = icln_fft_sw<R>();
  const int half = P << lm, L = 1 << lm, mq = (1 << lq) - 1, even = 1 << (lq - 1);
  R best = R(0);
  const int n = P == 1 ? even + 1 : P << lq;
#pragma unroll 4
  for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
    const int t = P == 1 ? 0 : idx >> lq;
    const int sl = P == 1 ? (idx < even ? 2 * idx : 1) : idx & mq;
    const int s = (rank << lq) + sl;
    const int kk =
        (int)(__brev((unsigned)s) >> (32 - lm)) + ((P <= 5 ? t : icln_fft_odd_freq(P, t)) << lm);
    const int kp = kk == 0 ? 0 : half - kk;
    if (kk > kp) continue;
    const int sp = (int)(__brev((unsigned)(kp & (L - 1))) >> (32 - lm));
    const C2 A = z[icln_swz<S>(sl * P + t)];
    const int tp = P <= 5 ? kp >> lm : icln_fft_odd_pos(P, kp >> lm);
    const C2 B = grp.at(z, sp >> lq)[icln_swz<S>((sp & mq) * P + tp)];
    const C2 w = icln_tw(lo, hi, lt, kk);
    best = icln_max(best, icln_split_one<R>(A, B, w));
    if (kp != kk) {  // X[N/2 - k]
      C2 wp;
      wp.x = -w.x;
      wp.y = w.y;
      best = icln_max(best, icln_split_one<R>(B, A, wp));
    }
    if (kk == 0) {  // X[N/2]
      const R xn = A.x - A.y;
      best = icln_max(best, xn * xn);
    }
  }
  return best;
}

template <class Res>
__global__ void __launch_bounds__(ICLN_FFT_THREADS,
                                  icln_fft_min_blocks<typename Res::Real>())
    icln_cell_fft_kernel(const CellFftArgs<typename Res::Real> a) {
  using T = typename Res::Elem;
  using R = typename Res::Real;
  using C2 = icln_cplx_t<R>;
  // the row is kept as it is read (float32 and float64 cubes of the
  // residuals that read the cube row)
  constexpr bool kKeep = std::is_same<T, R>::value && Res::kStaged;
  constexpr int S = icln_fft_sw<R>(), LR = ICLN_FFT_PASS_LOG;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ R red[96];
  // the cluster's partials, one slot a block: tp, q, sum, max, min, the
  // sum of squares, the spectrum's max
  __shared__ R xch[7][ICLN_FFT_CLUSTER_MAX];
  const CellStatsArgs<R>& p = a.c;
  IclnFftGroup grp;
  icln_cluster_arrive();
  const int C = grp.size(), rank = grp.rank();
  const int lc = C == 8 ? 3 : C == 4 ? 2 : 1;
  const int nbin = p.nbin, b0 = rank * (nbin >> lc);
  const int P = a.odd, lm = a.log2l, lq = lm - lc, Q = P << lq;
  const int tid = threadIdx.x, nt = blockDim.x;
  C2* z = reinterpret_cast<C2*>(smem_raw);
  // the slice padded to a whole run of the swizzle, which then maps it
  // into itself
  C2* lo = z + ((Q + (1 << S) - 1) >> S << S);
  C2* hi = lo + (1 << a.lt);
  for (int e = tid; e < a.ntw; e += nt) {
    const int h = e - (1 << a.lt);
    (h < 0 ? lo : hi)[icln_swz<S>(h < 0 ? e : h)] =
        __ldg(reinterpret_cast<const C2*>(a.tw) + e);
  }
  // persistent: as many cells (blocks or clusters) as the card holds at
  // once, each walking the launch order by the grid's stride
  const long long first_lin = (long long)(blockIdx.x >> lc), stride = gridDim.x >> lc;
  for (long long lin = first_lin; lin < p.ncells; lin += stride) {
    long long chan, arch;
    const long long cell = icln_fft_cell(p, lin, chan, arch);
    const T* x = static_cast<const T*>(p.cube) + cell * nbin;
    Res res;
    res.setup(p, cell, (int)chan, arch);

    // ---- the fit: <x, t> (and K2's x * (-1)^b) over the row, two bins a step ----
    R tp = R(0), q = R(0);
#pragma unroll 8
    for (int c = tid; c < Q; c += nt) {
      const int b = b0 + 2 * c;
      R v0 = R(0), v1 = R(0);
      if constexpr (Res::kStaged) {
        v0 = icln_ldr(x + b);
        v1 = icln_ldr(x + b + 1);
      }
      res.fitv(v0, b, tp, q);
      res.fitv(v1, b + 1, tp, q);
      if constexpr (kKeep) {
        C2 zc;
        zc.x = v0;
        zc.y = v1;
        z[icln_swz<S>(c)] = zc;
      }
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
    for (int c = tid; c < Q; c += nt) {
      const int b = b0 + 2 * c, sc = icln_swz<S>(c);
      R v0 = R(0), v1 = R(0);
      if constexpr (kKeep) {
        const C2 zc = z[sc];
        v0 = zc.x;
        v1 = zc.y;
      } else if constexpr (Res::kStaged) {
        v0 = icln_ldr(x + b);
        v1 = icln_ldr(x + b + 1);
      }
      C2 zc;
      zc.x = res.atv(v0, b);
      zc.y = res.atv(v1, b + 1);
      z[sc] = zc;
      sum += zc.x;
      sum += zc.y;
      mx = icln_max(icln_max(mx, zc.x), zc.y);
      mn = icln_min(icln_min(mn, zc.x), zc.y);
    }
    icln_fft_fold3(sum, mx, mn, red);
    icln_fft_push(grp, xch[2], rank, sum);
    icln_fft_push(grp, xch[3], rank, mx);
    icln_fft_push(grp, xch[4], rank, mn);
    grp.sync();  // also: every block's residual row is in place
    sum = icln_fft_meet(xch[2], C, IclnFftSum());
    mx = icln_fft_meet(xch[3], C, IclnFftMax());
    mn = icln_fft_meet(xch[4], C, IclnFftMin());
    const R mean = sum * p.inv_n;
    const bool m = p.mask[cell] != 0;
    const R centre = m ? R(0) : mean;

    // the next cell's slice of the cube into L2 while this one is
    // transformed (its fit then reads L2, not device memory)
    if (lin + stride < p.ncells) {
      long long nch, nar;
      const char* nx = reinterpret_cast<const char*>(
          static_cast<const T*>(p.cube) + icln_fft_cell(p, lin + stride, nch, nar) * nbin + b0);
      const int bytes = (nbin >> lc) * (int)sizeof(T);
      for (int o = tid * 128; o < bytes; o += nt * 128)
        asm volatile("prefetch.global.L2 [%0];" ::"l"(nx + o));
    }

    // ---- the complex FFT of z, in place; the cluster step centres ----
    R var = R(0);
    if (lc == 1) icln_fft_cross<1, R>(grp, z, lo, hi, a.lt, Q, centre, var);
    if (lc == 2) icln_fft_cross<2, R>(grp, z, lo, hi, a.lt, Q, centre, var);
    if (lc == 3) icln_fft_cross<3, R>(grp, z, lo, hi, a.lt, Q, centre, var);
    var = icln_fft_fold(var, red, IclnFftSum());
    if (tid == 0) grp.at(xch[5], 0)[rank] = var;
    grp.sync();  // every block's slice is its own sub-transform now
    for (int mu = lq, lr = lq % LR == 0 ? LR : lq % LR; mu > 0; mu -= lr, lr = LR) {
      const int lx = mu - lr, sh = lm + 1 - mu;
      if (lr == 1) icln_fft_pass<1, R>(z, lo, hi, a.lt, P, lq, lx, sh);
      if (lr == 2) icln_fft_pass<2, R>(z, lo, hi, a.lt, P, lq, lx, sh);
      if (lr == 3) icln_fft_pass<3, R>(z, lo, hi, a.lt, P, lq, lx, sh);
      __syncthreads();
    }
    if (P > 1) icln_fft_odd<R>(z, lo, hi, a.lt, lq, P, 2 << lm);
    grp.sync();  // the whole spectrum, every block's, before the split
    if (rank == 0 && tid == 0) {
      var = icln_fft_meet(xch[5], C, IclnFftSum());
      p.d_mean[cell] = m ? R(0) : mean;
      p.d_ptp[cell] = m ? icln_ma_fill<R>() : mx - mn;
      p.d_std[cell] = m ? R(0) : icln_sqrt(var * p.inv_n);
    }

    // ---- the split: |X_k|^2 of the real row's spectrum, maxed ----
    R best = icln_fft_split<R>(grp, z, lo, hi, a.lt, P, lq, lm, rank);
    best = icln_fft_fold(best, red, IclnFftMax());
    if (tid == 0) grp.at(xch[6], 0)[rank] = best;
    // no block leaves while another may still read its shared memory
    grp.sync();
    if (rank == 0 && tid == 0) p.d_fft[cell] = icln_sqrt(icln_fft_meet(xch[6], C, IclnFftMax()));
  }
}


template <class Res>
static int icln_cell_fft_launch(const CellFftArgs<typename Res::Real>& a, int cluster,
                                int threads, long long smem_bytes, void* stream) {
  using R = typename Res::Real;
  const CellStatsArgs<R>& p = a.c;
  const int half = p.nbin / 2;
  int odd = a.odd;
  while (odd > 1 && odd % 5 == 0) odd /= 5;
  while (odd > 1 && odd % 3 == 0) odd /= 3;
  const long long run = 1LL << icln_fft_sw<R>();
  const long long slice = ((long long)p.nbin / (2 * cluster) + run - 1) / run * run;
  if (p.nbin < 4 || p.nbin % 2 || a.odd < 1 || odd != 1 || a.log2l < 1 ||
      a.log2l > 30 || (long long)a.odd << a.log2l != half ||
      (cluster != 2 && cluster != 4 && cluster != ICLN_FFT_CLUSTER_MAX) ||
      (1 << a.log2l) % (2 * cluster) || threads % 32 || threads < 32 ||
      threads > ICLN_FFT_THREADS ||
      a.ntw != icln_fft_table_len(p.nbin) ||
      smem_bytes < slice * 2 * (long long)sizeof(R) +
                       2LL * icln_fft_table_slots(p.nbin) * (long long)sizeof(R) ||
      p.cpa < 1 || p.ncells % p.cpa || p.cpa % p.nchan || p.ncells * cluster > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  // persistent: the grid is the cells the card holds at once (each
  // cluster walks the rest by the grid's stride)
  void (*kernel)(const CellFftArgs<R>) = icln_cell_fft_kernel<Res>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
  if (err != cudaSuccess) return (int)icln_take_error(err);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(p.ncells * cluster));
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = (size_t)smem_bytes;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  long long active = 0;
  err = icln_fft_resident((const void*)kernel, cluster, threads, smem_bytes, &cfg, &active);
  if (err != cudaSuccess) return (int)icln_take_error(err);
  if (active < 1) return (int)cudaErrorLaunchOutOfResources;
  if (p.ncells > active) cfg.gridDim = dim3((unsigned)(active * cluster));
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
  a.lt = icln_fft_table_lt(nbin);
  a.ntw = icln_fft_table_len(nbin);
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
// (every other pointer then double); `tw` the (T + N/T, 2) two-level
// twiddle table of the arithmetic type (kernels._fft_twiddles); inv_n float32(1/nbin) for float, 1/nbin for
// double; cluster the blocks a cell (2, 4 or 8), odd the odd part of
// nbin/2 (3^a 5^b).

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
