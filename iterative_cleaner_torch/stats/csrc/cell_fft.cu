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

#include <cooperative_groups.h>

#include <map>
#include <mutex>
#include <tuple>

#include "fft_common.cuh"

namespace cg = cooperative_groups;

#define ICLN_FFT_CLUSTER_MAX 8  // portable cluster size
// the most threads a block, float and double alike
#define ICLN_FFT_THREADS 256
// channels a block of the launch's cell order (icln_fft_cell): one in
// float32, 8 in float64 (the faster of the two in each dtype,
// tools/time_cell_fft.py --stages)
#define ICLN_FFT_CHAN_BLOCK_F32 1
#define ICLN_FFT_CHAN_BLOCK_F64 8

// log2 of the local passes' points: 8 (a 16-point float32 pass held 128
// registers a thread, and ran at a third of the occupancy:
// tools/time_cell_fft.py --stages)
#define ICLN_FFT_PASS_LOG 3

// blocks of 256 threads an SM the build is compiled for, which caps its
// registers: 3 in float32 (at most 85 a thread, so that six 128-thread
// blocks, the plan's, fit an SM as their shared memory does: at 92 the
// build ran a sixth slower), 2 in float64 (at most 128: at 200 it ran a
// third slower; tools/time_cell_fft.py --stages, PERF.md)
template <class R>
__host__ __device__ constexpr int icln_fft_min_blocks() {
  return sizeof(R) == 8 ? 2 : 3;
}

// log2 of the swizzle's run: 16 values in float32, 8 in float64 (one
// 128-byte wavefront)
template <class R>
__host__ __device__ constexpr int icln_fft_sw() {
  return sizeof(R) == 8 ? 3 : 4;
}

template <class R>
struct CellFftArgs {
  CellStatsArgs<R> c;  // the residual's operands, the planes and the counts
  const R* tw;         // (ntw, 2): W_N^j for j < 2^lt, then W_N^(h 2^lt) for h < ntw - 2^lt
  int odd;             // P: nbin/2 = P * 2^log2l
  int log2l;
  int lt;              // log2 of the table's low part
  int ntw;             // the table's entries
};

// x * W_16^m (m < 8): the constant twiddles inside a pass (m is a
// constant once the pass's loops are unrolled)
template <class C2>
__device__ __forceinline__ C2 icln_mul_w16(C2 x, int m) {
  using R = decltype(x.x);
  if (m == 0) return x;
  C2 r;
  if (m == 4) {  // -i
    r.x = x.y;
    r.y = -x.x;
    return r;
  }
  R c, s;
  switch (m) {
    case 1: c = R(0.92387953251128674); s = R(-0.38268343236508977); break;
    case 2: c = R(0.70710678118654752); s = R(-0.70710678118654752); break;
    case 3: c = R(0.38268343236508977); s = R(-0.92387953251128674); break;
    case 5: c = R(-0.38268343236508977); s = R(-0.92387953251128674); break;
    case 6: c = R(-0.70710678118654752); s = R(-0.70710678118654752); break;
    default: c = R(-0.92387953251128674); s = R(-0.38268343236508977); break;
  }
  C2 w;
  w.x = c;
  w.y = s;
  return icln_cmul(x, w);
}

// The 2^LR-point DFT of v by LR radix-2 decimation-in-frequency stages in
// registers: v[k] ends as the DFT's output brev(k).
template <int LR, class C2>
__device__ __forceinline__ void icln_dif_regs(C2 (&v)[1 << LR]) {
  constexpr int n = 1 << LR;
#pragma unroll
  for (int st = 0; st < LR; ++st) {
    const int h = n >> (st + 1);
#pragma unroll
    for (int k = 0; k < n; ++k) {
      if (k & h) continue;
      const C2 a = v[k], b = v[k + h];
      v[k] = icln_cadd(a, b);
      v[k + h] = icln_mul_w16(icln_csub(a, b), (k & (h - 1)) * (8 / h));  // W_2h^i
    }
  }
}

// a slice's value a in shared memory: an XOR swizzle within aligned runs
// of 2^S values (a bijection on every slice length the plans take)
template <int S>
__device__ __forceinline__ int icln_swz(int a) {
  return a ^ ((a >> S) & ((1 << S) - 1));
}

// W_N^e, e < N, from the two-level table in shared memory, each part
// stored at its index's swizzled slot (a pass's threads read the low part
// at strides of 2^k entries)
template <class C2>
__device__ __forceinline__ C2 icln_tw(const C2* lo, const C2* hi, int lt, int e) {
  constexpr int S = sizeof(C2) == 16 ? 3 : 4;
  return icln_cmul(hi[icln_swz<S>(e >> lt)], lo[icln_swz<S>(e & ((1 << lt) - 1))]);
}

// w[k] = W_N^(brev(k) e1), k = 1 .. 2^L - 1: register k's twiddle in a
// group of 2^L values.  The k that are powers of two (brev(k) =
// 2^(L-1) / k) from the table; every other k the product of its lowest set
// bit's and the rest's (brev maps disjoint bits to disjoint bits), at most
// L - 1 products deep: a group reads L twiddles where it would read 2^L - 1.
// Indexed by k alone, so that the array stays in registers.
template <int L, class C2>
__device__ __forceinline__ void icln_tw_regs(C2 (&w)[1 << L], const C2* lo, const C2* hi, int lt,
                                             int e1) {
#pragma unroll
  for (int k = 1; k < (1 << L); ++k) {
    const int low = k & -k;
    w[k] = low == k ? icln_tw(lo, hi, lt, ((1 << (L - 1)) / k) * e1)
                    : icln_cmul(w[low], w[k - low]);
  }
}

// The blocks of one cell: a thread-block cluster.
struct IclnFftGroup {
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

// the cluster barrier split in two: every block arrives at the kernel's
// start and waits before it first writes into another's shared memory
__device__ __forceinline__ void icln_cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void icln_cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
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

// The first pass's centring: the mean off both bins of v, their squares
// into var.
template <class C2, class R>
__device__ __forceinline__ void icln_fft_centre(C2& v, R ctr, R& var) {
  v.x -= ctr;
  v.y -= ctr;
  var = icln_fma(v.x, v.x, var);
  var = icln_fma(v.y, v.y, var);
}

// One local pass of 2^LR-point butterflies over a block's Q = P 2^lq
// values (position u P + v), at stride P 2^lx: group (v, blk, iu) holds
// u = blk 2^(lx + LR) + iu + k 2^lx in register k; its offset in its span
// is i = iu P + v, and register k leaves times W_M^(i brev(k)), M = P
// 2^(lx + LR), which is W_N^((i brev(k)) << sh).
template <int LR, class R>
__device__ __forceinline__ void icln_fft_pass(icln_cplx_t<R>* z, const icln_cplx_t<R>* lo,
                                              const icln_cplx_t<R>* hi, int lt, int P, int lq,
                                              int lx, int sh) {
  using C2 = icln_cplx_t<R>;
  constexpr int n = 1 << LR, S = icln_fft_sw<R>();
  const int lg = lq - LR;  // log2 of the groups of one residue v
  const int ng = P << lg;
#pragma unroll 2
  for (int g = threadIdx.x; g < ng; g += blockDim.x) {
    const int v = g >> lg, rest = g & ((1 << lg) - 1);
    const int iu = rest & ((1 << lx) - 1);
    const int u0 = ((rest >> lx) << (lx + LR)) + iu;
    const int i = iu * P + v;
    C2 r[n];
#pragma unroll
    for (int k = 0; k < n; ++k) r[k] = z[icln_swz<S>((u0 + (k << lx)) * P + v)];
    icln_dif_regs<LR>(r);
    if (i != 0) {  // the last pass of an odd part 1: every group's i is 0
      C2 w[n];
      icln_tw_regs<LR>(w, lo, hi, lt, i << sh);
#pragma unroll
      for (int k = 1; k < n; ++k) r[k] = icln_cmul(r[k], w[k]);
    }
#pragma unroll
    for (int k = 0; k < n; ++k) z[icln_swz<S>((u0 + (k << lx)) * P + v)] = r[k];
  }
}

// The cluster's first log2 C = LC stages as one step: value j of every
// block's slice (global positions j + k Q) in register k, the C-point
// butterflies, register k times W_(N/2)^(j brev(k)) = W_N^(2 j brev(k))
// back into block k.  Centres as it loads.
template <int LC, class R, class G>
__device__ __forceinline__ void icln_fft_cross(G& grp, icln_cplx_t<R>* z,
                                               const icln_cplx_t<R>* lo,
                                               const icln_cplx_t<R>* hi, int lt, int Q, R ctr,
                                               R& var) {
  using C2 = icln_cplx_t<R>;
  constexpr int n = 1 << LC, S = icln_fft_sw<R>();
  C2* zb[n];
#pragma unroll
  for (int k = 0; k < n; ++k) zb[k] = grp.at(z, k);
#pragma unroll 2
  for (int j = grp.rank() * (int)blockDim.x + (int)threadIdx.x; j < Q; j += n * (int)blockDim.x) {
    const int sj = icln_swz<S>(j);
    C2 r[n];
#pragma unroll
    for (int k = 0; k < n; ++k) r[k] = zb[k][sj];
#pragma unroll
    for (int k = 0; k < n; ++k) icln_fft_centre(r[k], ctr, var);
    icln_dif_regs<LC>(r);
    C2 w[n];
    icln_tw_regs<LC>(w, lo, hi, lt, j << 1);
#pragma unroll
    for (int k = 1; k < n; ++k) r[k] = icln_cmul(r[k], w[k]);
#pragma unroll
    for (int k = 0; k < n; ++k) zb[k][sj] = r[k];
  }
}

// The odd part's stages: P = 3^a 5^b points on each contiguous group of P
// of this block's Q = P 2^lq values, the last stages of the decimation in
// frequency, radix 5 while the span holds a factor 5, then radix 3.  A
// stage of radix p at span sp (sp = P first, then sp / p, ...) runs the
// p-point DFT on the values j + u d (d = sp / p, j < d, u < p) of each
// span, output t times W_sp^(j t) (no product where j t is 0) back at j +
// t d; W_p^v = W_N^(v N / p) and W_sp^e = W_N^(e N / sp), N / sp = 2L P /
// sp.  ONE: the odd part is p itself (P = 3 or 5), one stage whose spans
// are the groups (d = 1, j = 0), every index a shift or a product by a
// constant: the radix-P stage of the first design, the same operations in
// the same order, with no division.
template <int p, bool ONE, class R>
__device__ __forceinline__ void icln_fft_odd_stage(icln_cplx_t<R>* z, const icln_cplx_t<R>* lo,
                                                   const icln_cplx_t<R>* hi, int lt, int lq,
                                                   int P, int sp, int nsp) {
  using C2 = icln_cplx_t<R>;
  constexpr int S = icln_fft_sw<R>();
  const int d = ONE ? 1 : sp / p, per = ONE ? 1 : P / p;
  C2 w[p];
#pragma unroll
  for (int v = 0; v < p; ++v) w[v] = icln_tw(lo, hi, lt, v * (nsp * d));
  for (int idx = threadIdx.x; idx < (per << lq); idx += blockDim.x) {
    const int s = ONE ? idx : idx / per, r = ONE ? 0 : idx - s * per, j = ONE ? 0 : r % d;
    const int base = ONE ? s * p : s * P + (r / d) * sp + j;
    C2 in[p];
#pragma unroll
    for (int u = 0; u < p; ++u) in[u] = z[icln_swz<S>(base + u * d)];
#pragma unroll
    for (int t = 0; t < p; ++t) {
      C2 acc = in[0];
#pragma unroll
      for (int u = 1; u < p; ++u) acc = icln_cadd(acc, icln_cmul(in[u], w[(u * t) % p]));
      if (j != 0 && t != 0) acc = icln_cmul(acc, icln_tw(lo, hi, lt, j * t * nsp));
      z[icln_swz<S>(base + t * d)] = acc;
    }
  }
}

// the radix of the odd stage at span sp: 5 while sp holds a factor 5
__host__ __device__ __forceinline__ int icln_fft_odd_radix(int sp) { return sp % 5 == 0 ? 5 : 3; }

// every odd stage; two_l = 2L = N / P
template <class R>
__device__ void icln_fft_odd(icln_cplx_t<R>* z, const icln_cplx_t<R>* lo,
                             const icln_cplx_t<R>* hi, int lt, int lq, int P, int two_l) {
  if (P == 3) return icln_fft_odd_stage<3, true, R>(z, lo, hi, lt, lq, 3, 3, two_l);
  if (P == 5) return icln_fft_odd_stage<5, true, R>(z, lo, hi, lt, lq, 5, 5, two_l);
  for (int sp = P; sp > 1;) {
    const int p = icln_fft_odd_radix(sp), nsp = two_l * (P / sp);
    if (p == 5) icln_fft_odd_stage<5, false, R>(z, lo, hi, lt, lq, P, sp, nsp);
    if (p == 3) icln_fft_odd_stage<3, false, R>(z, lo, hi, lt, lq, P, sp, nsp);
    sp /= p;
    if (sp > 1) __syncthreads();
  }
}

// The odd stages' order: position t of a group of P holds the P-point
// DFT's output f = t_1 + p_1 t_2 + p_1 p_2 t_3 + ... for t = t_1 P / p_1 +
// t_2 P / (p_1 p_2) + ... (the digits of t in the stages' radices, most
// significant first); icln_fft_odd_pos is the inverse map.  Both are the
// identity at P = 1, 3 and 5, where the split does not call them.
__device__ __forceinline__ int icln_fft_odd_freq(int P, int t) {
  int f = 0, mult = 1;
  for (int sp = P; sp > 1;) {
    const int p = icln_fft_odd_radix(sp), d = sp / p, digit = t / d;
    t -= digit * d;
    f += digit * mult;
    mult *= p;
    sp = d;
  }
  return f;
}

__device__ __forceinline__ int icln_fft_odd_pos(int P, int f) {
  int t = 0;
  for (int sp = P; sp > 1;) {
    const int p = icln_fft_odd_radix(sp), d = sp / p, digit = f % p;
    f /= p;
    t += digit * d;
    sp = d;
  }
  return t;
}

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

// The cell at launch position `lin`, with its channel and archive.  The
// launch walks each archive's cells a block of channels at a time (one in
// float32: channel by channel), every subint of one block before the next,
// so that the cells in flight share their channels' template (and
// Nyquist) rows in L2 (in (subint, channel) order every cell's rows came
// from device memory again: K2's 128 MB of them at 256 x 65536).
template <class R>
__device__ __forceinline__ long long icln_fft_cell(const CellStatsArgs<R>& p, long long lin,
                                                   long long& chan, long long& arch) {
  constexpr long long kBlock =
      sizeof(R) == 8 ? ICLN_FFT_CHAN_BLOCK_F64 : ICLN_FFT_CHAN_BLOCK_F32;
  arch = lin / p.cpa;
  const long long nsa = p.cpa / p.nchan, rest = lin - arch * p.cpa;
  const long long cb = p.nchan < kBlock ? p.nchan : kBlock;
  const long long full = p.nchan / cb * cb, blk = rest / (nsa * cb) * cb;
  const long long width = blk < full ? cb : p.nchan - full;
  const long long within = rest - blk * nsa;
  chan = blk + within % width;
  return arch * p.cpa + within / width * p.nchan + chan;
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

// log2 of the twiddle table's low part at N bins: half of ceil(log2 N)
// (kernels._fft_table_lt)
static inline int icln_fft_table_lt(int nbin) {
  int c = 0;
  while ((1LL << c) < (long long)nbin) ++c;
  return c / 2;
}

static inline int icln_fft_table_len(int nbin) {
  const int t = 1 << icln_fft_table_lt(nbin);
  return t + (nbin + t - 1) / t;
}

// the table's entries in shared memory: the high part padded to a whole
// run of the swizzle (16 entries), which the swizzle maps onto itself
static inline int icln_fft_table_slots(int nbin) {
  const int t = 1 << icln_fft_table_lt(nbin);
  return t + ((nbin + t - 1) / t + 15) / 16 * 16;
}

// The clusters (cells) a launch of `kernel` holds at once on the current
// device, asked of the occupancy API once per device, kernel, cluster,
// threads and shared memory: the answer does not change, and a launch of
// a few hundred cells lasts 0.2 ms.
static cudaError_t icln_fft_resident(const void* kernel, int cluster, int threads,
                                     long long smem_bytes, cudaLaunchConfig_t* cfg,
                                     long long* resident) {
  static std::mutex mu;
  static std::map<std::tuple<int, const void*, int, int, long long>, long long> cache;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const auto key = std::make_tuple(dev, kernel, cluster, threads, smem_bytes);
  {
    std::lock_guard<std::mutex> lock(mu);
    const auto it = cache.find(key);
    if (it != cache.end()) {
      *resident = it->second;
      return cudaSuccess;
    }
  }
  // a cluster of this size at this shared memory must fit an SM group
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, kernel, cfg);
  if (err != cudaSuccess) return err;
  *resident = n;
  std::lock_guard<std::mutex> lock(mu);
  cache[key] = n;
  return cudaSuccess;
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
