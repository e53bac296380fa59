// Cell diagnostics past the DFT tables on every row the cluster build
// (K2f, cell_fft.cu) does not take (K2g, stats.kernels.cell_stats_route
// "fft_global"): lengths with a prime factor of 7 or more, odd lengths,
// and rows past a cluster's shared memory.  The four planes of K2, K7, K6
// and K10 (d_std, d_mean, d_ptp, d_fft), the spectrum by an FFT whose
// passes run through device memory.
//
// Replaces no Pallas kernel: past FUSED_STATS_MAX_NBIN = 4096 bins
// (iterative_cleaner_tpu/stats/pallas_kernels.py:596) the reference takes
// its XLA route, cell_diagnostics_jax with jnp.fft.rfft
// (iterative_cleaner_tpu/stats/masked_jax.py:128-179), at any length.
// This build computes what that route computes on each residual form of
// K2 (with and without the Nyquist term), K7, K6 and K10: the mean, the
// two-pass centred variance, the ptp of the weighted residual, masked
// cells patched per rule 4, and max over k <= N/2 of |rFFT(centred)|.
//
// Bound: bytes, as K2f's (the same function; telemetry/profiling.py
// kernel_costs "*_fftg" counts the same bytes and operations).  The
// passes through device memory move more: the centred row goes through a
// scratch buffer and every pass reads and writes it once.
//
// A Bluestein row needs only the convolution's first K = N/2 + 1 outputs
// (the max's), which a cyclic convolution of M >= N + N/2 points gives
// without wrap-around.  Where K2f's cluster takes a transform of M such
// points (kernels.cell_fft_global_plan, mode "cluster"), the whole
// convolution of a cell runs in one thread-block cluster, (e) below, and
// nothing but the cube row, the tables and the planes crosses device
// memory.  Every other row (the split rows; Bluestein past a cluster, on
// the least 2^a 3^b 5^c M >= N + N/2) takes the passes, per chunk of
// cells (the wrapper sizes the chunk so that its scratch, chunk x n
// complex values, stays within 1 GiB), four kernels:
//   (a) the residual  one block a cell streams its row through the
//                     residual structs of cell_stats.cuh (Res::setup /
//                     finish, fitv / atv, every form's entry) three times:
//                     the fit's dot products; the weighted residual's sum,
//                     max and min; the residual again, centred, into the
//                     scratch row (its one write) with its squares summed:
//                     d_mean, d_std, d_ptp, masked cells patched per rule
//                     4.  Fixed-order block reductions.
//                     An even N whose N/2 is 2^a 3^b 5^c ("split") packs
//                     the row as n = N/2 complex values x[2j] + i x[2j+1];
//                     any other N (Bluestein) takes n = M, the least
//                     2^a 3^b 5^c >= N + N/2: the centred row times the
//                     chirp w_j = exp(-i pi j^2 / N) (the wrapper's table,
//                     j^2 mod 2N taken in integers, built in float64 on
//                     the host), zero past N;
//   (b) the passes    the forward transform of each scratch row in place
//                     as passes of F_1 .. F_k points (n = F_1 ... F_k, each
//                     F <= 1024, kernels.cell_fft_global_plan), decimation
//                     in frequency: pass j at stride s_j = n / (F_1 ... F_j)
//                     takes the F_j values c + m s_j of each column c < s_j
//                     of each span of F_j s_j into a tile in shared memory
//                     (G_j columns a tile, G_j dividing s_j, so that a row
//                     of the tile is G_j contiguous values; a persistent
//                     grid, each block walking the tiles with the next
//                     one's cp.async copy in flight while this one's
//                     stages run, the pass's tables in shared memory), runs the
//                     F_j-point DFT there in stages of radix 5, 3, 4 and 2
//                     (each stage's twiddles W_sp^(j q) from the pass's
//                     table of W_F_j, the tile's indices divided by
//                     multiplies), and writes output q, in natural order
//                     (the stages' order undone by the pass's table perm),
//                     times W_(F_j s_j)^(c q), to c + q s_j.  Position
//                     q_1 s_1 + q_2 s_2 + ... + q_k then holds
//                     X[q_1 + F_1 q_2 + F_1 F_2 q_3 + ...]: the passes' own
//                     order, never transposed;
//   (c) Bluestein     the chirp's spectrum B^ (of b_j = conj w_j at the
//                     lags -N < j < K, zero between), made once per (N,
//                     device, dtype) by
//                     the same forward passes on the card in float64,
//                     scaled by 1 / M and rounded to the arithmetic type,
//                     is held in the passes' order: the last forward pass
//                     (stride 1, one span a block) multiplies it in and runs
//                     its inverse in the same block, and the other inverse
//                     passes, the forward ones mirrored (k - 1 down to 1,
//                     the column twiddle conjugated on the load, the
//                     stages' twiddles conjugated), bring the convolution
//                     back in natural order;
//   (d) the max       max over k <= N/2 of |X_k|^2 with the NaN-propagating
//                     icln_max from +0, one sqrt: for a split row X_k from
//                     the pair Z[k], Z[n - k] (each found at its position
//                     in the passes' order, every value read once,
//                     icln_split_one), for Bluestein |conv_k|^2 (|X_k| =
//                     |w_k conv_k| = |conv_k|: the post-chirp has modulus
//                     one and is not applied);
//   (e) the cluster   Bluestein in one thread-block cluster a cell, on K2f's
//                     transform of M = P 2^m points (P = 3^a 5^b within
//                     kernels.FFT_ODD_STAGES, 2M bins within K2f's
//                     capacity): the residual, centred and times the chirp
//                     into the blocks' shared memory, K2f's forward, times
//                     B^ (the host's float64 FFT of the chirp row in the
//                     forward's order, kernels._fftg_bhat), the forward
//                     mirrored as its inverse, the max from registers
//                     (fftg_cluster_impl.cuh, built in its own sources,
//                     cell_fftg_cluster_{f32,bf16,f64}.cu, one an element
//                     type, so that the library's parallel build is not
//                     held by one long compile).
// The column twiddles W_n^e come from a two-level table
// (kernels._fft_twiddles) of the table's length (N for a split row, whose
// n = N/2 reads W_N^(2e); M for Bluestein), the stages' from each pass's
// table of W_F (kernels._fftg_pass_tables), all built in float64 on the
// host and read through the read-only cache.  Multiplies and adds
// fuse where the code says so (icln_fma, icln_cmul); no float atomics;
// every reduction runs in a fixed order.  The CPU tests hold a numpy
// model of the passes, the chirp, B^, the split and the cluster mode's
// forward and inverse to np.fft (tests/test_torch_cell_fft_schedule.py).
//
// A batch of equal-shaped archives is one launch over their cells (cell /
// cpa is the archive), each cell's arithmetic its own, so each archive's
// planes are bit-equal to a launch on it alone; the chunks do not change
// a cell's arithmetic either, and K10's entries run K2's and K6's
// instantiations.  A float64 cube runs the same kernels in double; a
// bf16 cube is read through icln_ldr, so its planes are bit-equal to the
// float32 launch on the upcast cube.  Every launch's error is returned;
// the wrapper raises on any and never falls back.

#include <map>
#include <mutex>
#include <tuple>

#include "fftg_cluster.cuh"

// the residual and max kernels' threads
#define ICLN_FFTG_THREADS 256
// the most threads a block of the pass kernel (the plan's,
// kernels.FFTG_PASS_THREADS, within it)
#define ICLN_FFTG_PASS_THREADS 512
#define ICLN_FFTG_MAX_PASSES 4
#define ICLN_FFTG_PASS_MAX 1024
// the largest tile the plan may ask for (kernels.FFTG_TILE_BYTES, within
// it): two in flight and the pass's tables fit a block's shared memory
#define ICLN_FFTG_TILE_MAX 65536

// The passes of one transform of n points: F_j points and G_j columns a
// tile, pass j at stride n / (F_1 ... F_j); `threads` a block, `tile` the
// bytes a tile may take (the fused pass's two tiles together).
struct IclnFftgPasses {
  int n, np;
  int f[ICLN_FFTG_MAX_PASSES], g[ICLN_FFTG_MAX_PASSES];
  int threads, tile;
};

// W_n^e from the two-level table of W_tab^j (tab = n * mul): W_tab^(e mul)
// = hi[(e mul) >> lt] lo[(e mul) & (2^lt - 1)]
template <class C2>
struct IclnFftgTable {
  const C2* tw;
  int lt, mul;
  __device__ __forceinline__ C2 operator()(long long e) const {
    const long long x = e * mul;
    return icln_cmul(__ldg(tw + (1 << lt) + (x >> lt)), __ldg(tw + (x & ((1 << lt) - 1))));
  }
};

// -i a (forward) or i a (inverse)
template <class C2>
__device__ __forceinline__ C2 icln_mul_mi(C2 a, bool inv) {
  C2 r;
  r.x = inv ? -a.y : a.y;
  r.y = inv ? a.x : -a.x;
  return r;
}

// the stages' radix at span sp: 5, then 3, then 4, then 2
__device__ __forceinline__ int icln_fftg_radix(int sp) {
  return sp % 5 == 0 ? 5 : sp % 3 == 0 ? 3 : sp % 4 == 0 ? 4 : 2;
}

// The P-point DFT of v into y (W_P = exp(-2 pi i / P); its conjugate when
// inv): P = 2 and 4 exactly, 3 and 5 by their conjugate-pair forms.
template <int P, class C2>
__device__ __forceinline__ void icln_fftg_dft(const C2 (&v)[P], C2 (&y)[P], bool inv) {
  using R = decltype(v[0].x);
  if constexpr (P == 2) {
    y[0] = icln_cadd(v[0], v[1]);
    y[1] = icln_csub(v[0], v[1]);
  } else if constexpr (P == 4) {
    const C2 a = icln_cadd(v[0], v[2]), b = icln_csub(v[0], v[2]);
    const C2 c = icln_cadd(v[1], v[3]), d = icln_mul_mi(icln_csub(v[1], v[3]), inv);
    y[0] = icln_cadd(a, c);
    y[2] = icln_csub(a, c);
    y[1] = icln_cadd(b, d);
    y[3] = icln_csub(b, d);
  } else if constexpr (P == 3) {
    const R c1 = R(-0.5), s1 = R(0.86602540378443865);
    const C2 a = icln_cadd(v[1], v[2]), b = icln_csub(v[1], v[2]);
    C2 m, q;
    m.x = v[0].x + c1 * a.x;
    m.y = v[0].y + c1 * a.y;
    q.x = s1 * b.x;
    q.y = s1 * b.y;
    q = icln_mul_mi(q, inv);  // -i s1 (v1 - v2)
    y[0] = icln_cadd(v[0], a);
    y[1] = icln_cadd(m, q);
    y[2] = icln_csub(m, q);
  } else {
    static_assert(P == 5, "radix 2, 3, 4 or 5");
    const R c1 = R(0.30901699437494742), c2 = R(-0.80901699437494742);
    const R s1 = R(0.95105651629515357), s2 = R(0.58778525229247313);
    const C2 a1 = icln_cadd(v[1], v[4]), b1 = icln_csub(v[1], v[4]);
    const C2 a2 = icln_cadd(v[2], v[3]), b2 = icln_csub(v[2], v[3]);
    C2 m1, m2, q1, q2;
    m1.x = v[0].x + c1 * a1.x + c2 * a2.x;
    m1.y = v[0].y + c1 * a1.y + c2 * a2.y;
    m2.x = v[0].x + c2 * a1.x + c1 * a2.x;
    m2.y = v[0].y + c2 * a1.y + c1 * a2.y;
    q1.x = s1 * b1.x + s2 * b2.x;
    q1.y = s1 * b1.y + s2 * b2.y;
    q2.x = s2 * b1.x - s1 * b2.x;
    q2.y = s2 * b1.y - s1 * b2.y;
    q1 = icln_mul_mi(q1, inv);
    q2 = icln_mul_mi(q2, inv);
    y[0] = icln_cadd(v[0], icln_cadd(a1, a2));
    y[1] = icln_cadd(m1, q1);
    y[4] = icln_csub(m1, q1);
    y[2] = icln_cadd(m2, q2);
    y[3] = icln_csub(m2, q2);
  }
}

// x / d by a multiply (d >= 1): m = floor((2^32 - 1) / d) + 1 is exact
// for 0 <= x with x d < 2^32, which holds inside a tile (x, d <= 8192)
struct IclnFastDiv {
  unsigned m;
  int d;
  __device__ __forceinline__ explicit IclnFastDiv(int d_) : m(0xFFFFFFFFu / (unsigned)d_ + 1u), d(d_) {}
  __device__ __forceinline__ int div(int x) const {
    return d == 1 ? x : (int)__umulhi((unsigned)x, m);
  }
};

// One butterfly of a stage of radix P at span sp inside the tile (values
// [m][G], column gi): the P values m0 + u d, their DFT, output q times
// W_sp^(j q) = W_F^(j q F / sp) from the pass's table wf in shared memory
// (conjugated when inv), back to m0 + q d.
template <int P, class C2>
__device__ __forceinline__ void icln_fftg_bfly(C2* t, int G, int gi, int m0, int d, int j,
                                               int fsp, const C2* wf, bool inv) {
  C2 v[P], y[P];
#pragma unroll
  for (int u = 0; u < P; ++u) v[u] = t[(m0 + u * d) * G + gi];
  icln_fftg_dft<P>(v, y, inv);
#pragma unroll
  for (int q = 0; q < P; ++q) {
    C2 o = y[q];
    if (j != 0 && q != 0) {
      const C2 w = wf[j * q * fsp];
      o = icln_cmul(o, inv ? icln_conj(w) : w);
    }
    t[(m0 + q * d) * G + gi] = o;
  }
}

// The F-point DFT of each of the tile's G columns in place, in stages of
// radix 5, 3, 4 and 2 (decimation in frequency): position t of a column
// then holds output f of its DFT, perm[f] = t.
template <class C2>
__device__ __forceinline__ void icln_fftg_stages(C2* t, int F, int G, const C2* wf, bool inv) {
  const int tot = F * G;
  const IclnFastDiv fg(G);
  for (int sp = F; sp > 1;) {
    const int r = icln_fftg_radix(sp), d = sp / r, nb = tot / r, fsp = F / sp;
    const IclnFastDiv fd(d);
    for (int b = threadIdx.x; b < nb; b += blockDim.x) {
      const int rest = fg.div(b), gi = b - rest * G;
      const int sb = fd.div(rest), j = rest - sb * d, m0 = sb * sp + j;
      if (r == 5) icln_fftg_bfly<5>(t, G, gi, m0, d, j, fsp, wf, inv);
      if (r == 3) icln_fftg_bfly<3>(t, G, gi, m0, d, j, fsp, wf, inv);
      if (r == 4) icln_fftg_bfly<4>(t, G, gi, m0, d, j, fsp, wf, inv);
      if (r == 2) icln_fftg_bfly<2>(t, G, gi, m0, d, j, fsp, wf, inv);
    }
    __syncthreads();
    sp = d;
  }
}

// B bytes from device memory into shared memory, asynchronously
// (cp.async: 16 bytes through L2 alone, 8 bytes through L1)
template <int B>
__device__ __forceinline__ void icln_cp_async(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (B == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void icln_cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every group of this thread's copies but the newest complete
__device__ __forceinline__ void icln_cp_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// (b): one pass of F points at stride s over the scratch rows of n values,
// G columns a tile (F x G values in shared memory, [m][G]): G consecutive
// columns of one span where s > 1, G consecutive spans (each a contiguous
// column, c = 0) where s = 1; wf the pass's table W_F^e (e < F) and perm
// its stages' order (the wrapper's, kernels._fftg_pass_tables), both
// copied into shared memory once a block.  Persistent: each block walks
// the `total` tiles of the launch by the grid's stride with two tiles in
// flight, the next tile's copy (cp.async) issued before this tile's
// stages run and waited for before its own.  Forward: the stages, output
// q times W_(F s)^(c q) stored at c + q s.  Inverse (inv): the tile times
// conj W_(F s)^(c m), the stages with conjugate twiddles, stored.  Fused (the last pass, s = 1,
// Bluestein): the forward pass, its outputs times B^ (mul) into a third
// tile, and the inverse pass on it.  Each value's operations and their
// order do not depend on where or when its tile and tables are loaded:
// any tile size and grid give the same bits.
template <class R>
__global__ void __launch_bounds__(ICLN_FFTG_PASS_THREADS)
    icln_fftg_pass_kernel(icln_cplx_t<R>* buf, int n, int F, int s, int G, long long total,
                          IclnFftgTable<icln_cplx_t<R>> tw, const icln_cplx_t<R>* wf,
                          const int* perm, int inv, int fused, const icln_cplx_t<R>* mul) {
  using C2 = icln_cplx_t<R>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tot = F * G;
  C2* slots = reinterpret_cast<C2*>(smem_raw);
  C2* t2 = slots + 2 * tot;  // the fused pass's inverse tile
  C2* wfs = t2 + (fused ? tot : 0);
  int* perms = reinterpret_cast<int*>(wfs + F);
  for (int e = threadIdx.x; e < F; e += blockDim.x) {
    wfs[e] = __ldg(wf + e);
    perms[e] = __ldg(perm + e);
  }
  const int tiles = n / tot;  // a row's
  const bool spans = s == 1;
  const long long tS = n / (F * (long long)s);  // W_(F s) = W_n^tS
  // value e of a tile: (column gi, point m), consecutive e on consecutive
  // addresses (along a span's column where s = 1)
  const IclnFastDiv fg(G), ff(F);
  // the tile's groups g0 .. g0 + G - 1: columns of one span (G divides s),
  // or G whole spans (s = 1); its first value's position in the row
  auto origin = [&](long long ti, long long& pos0, int& c0) -> C2* {
    const long long row = ti / tiles;
    const long long g0 = (ti - row * tiles) * G;
    pos0 = (g0 / s) * F * (long long)s + g0 % s;
    c0 = (int)(g0 % s);
    return buf + row * n + pos0;
  };
  // float32 values in pairs, 16 bytes a copy and a store, where a pair of
  // a tile's row is a pair in the row (G, s and the tile's first
  // position even; across spans the stores alone, along the row)
  constexpr bool kPairs = sizeof(C2) == 8;
  const IclnFastDiv fh(G / 2 > 0 ? G / 2 : 1);
  auto issue = [&](long long ti, C2* t) {
    long long pos0;
    int c0;
    const C2* x = origin(ti, pos0, c0);
    if constexpr (kPairs) {
      if (!spans && G % 2 == 0 && s % 2 == 0 && (x - buf) % 2 == 0) {
        for (int e = threadIdx.x; e < tot / 2; e += blockDim.x) {
          const int m = fh.div(e), gi = 2 * (e - m * (G / 2));
          icln_cp_async<16>(t + m * G + gi, x + gi + (long long)m * s);
        }
        return;
      }
    }
    for (int e = threadIdx.x; e < tot; e += blockDim.x) {
      const int gi = spans ? ff.div(e) : e - fg.div(e) * G;
      const int m = spans ? e - gi * F : fg.div(e);
      icln_cp_async<sizeof(C2)>(t + m * G + gi, x + (spans ? e : gi + (long long)m * s));
    }
  };
  // output e of the tile: its value (the stages' order undone, forward
  // passes times W_(F s)^(c q)) and its place in the row
  auto output = [&](const C2* tt, int c0, int e, long long& at) -> C2 {
    const int gi = spans ? ff.div(e) : e - fg.div(e) * G;
    const int u = spans ? e - gi * F : fg.div(e);
    C2 v = tt[perms[u] * G + gi];
    if (!inv && !spans) {
      const long long ex = (long long)(c0 + gi) * u;
      if (ex) v = icln_cmul(v, tw(ex * tS));
    }
    at = spans ? e : gi + (long long)u * s;
    return v;
  };
  long long ti = blockIdx.x;
  if (ti < total) issue(ti, slots);
  icln_cp_commit();
  for (int cur = 0; ti < total; ti += gridDim.x, cur ^= 1) {
    if (ti + gridDim.x < total) issue(ti + gridDim.x, slots + (cur ^ 1) * tot);
    icln_cp_commit();
    icln_cp_wait_prior();  // this tile's copies, this thread's
    __syncthreads();       // everyone's, and (the first time) the tables
    C2* t = slots + cur * tot;
    long long pos0;
    int c0;
    C2* x = origin(ti, pos0, c0);
    if (inv && !spans) {
      for (int e = threadIdx.x; e < tot; e += blockDim.x) {
        const int gi = e - fg.div(e) * G, m = fg.div(e);
        const long long ex = (long long)(c0 + gi) * m;
        if (ex) t[m * G + gi] = icln_cmul(t[m * G + gi], icln_conj(tw(ex * tS)));
      }
      __syncthreads();
    }
    icln_fftg_stages(t, F, G, wfs, inv);
    if (fused) {
      for (int e = threadIdx.x; e < tot; e += blockDim.x) {
        const int gi = ff.div(e), u = e - gi * F;
        t2[u * G + gi] = icln_cmul(t[perms[u] * G + gi], __ldg(mul + pos0 + e));
      }
      __syncthreads();
      icln_fftg_stages(t2, F, G, wfs, true);
    }
    const C2* tt = fused ? t2 : t;
    bool paired = false;
    if constexpr (kPairs) {
      if ((x - buf) % 2 == 0 && (spans ? tot % 2 == 0 : G % 2 == 0 && s % 2 == 0)) {
        // pairs (e, e + 1) adjacent in the row: along a span where s = 1,
        // columns gi, gi + 1 of one point where s > 1
        paired = true;
        for (int e2 = threadIdx.x; e2 < tot / 2; e2 += blockDim.x) {
          int e = 2 * e2;
          if (!spans) {
            const int m = fh.div(e2);
            e = m * G + 2 * (e2 - m * (G / 2));
          }
          long long at0, at1;
          const C2 v0 = output(tt, c0, e, at0), v1 = output(tt, c0, e + 1, at1);
          *reinterpret_cast<float4*>(x + at0) = make_float4(v0.x, v0.y, v1.x, v1.y);
        }
      }
    }
    if (!paired) {
      for (int e = threadIdx.x; e < tot; e += blockDim.x) {
        long long at;
        const C2 v = output(tt, c0, e, at);
        x[at] = v;
      }
    }
    __syncthreads();  // the tile is read: its slot takes the tile after next
  }
}

// (a): the residual of cell cell0 + blockIdx.x into its scratch row,
// centred; d_mean, d_std, d_ptp.  Three reads of the cube row (the fit;
// the residual's sum, max and min; the residual again, centred, into the
// scratch row with its squares summed: one write of the scratch), each
// residual value the same operations on the same values.  BLUE: the
// Bluestein row (times the chirp, zero past nbin); else the split row
// (two bins a value).
template <class Res, bool BLUE>
__global__ void __launch_bounds__(ICLN_FFTG_THREADS)
    icln_fftg_residual_kernel(const CellStatsArgs<typename Res::Real> p, long long cell0,
                              icln_cplx_t<typename Res::Real>* scratch, int n,
                              const icln_cplx_t<typename Res::Real>* chirp) {
  using T = typename Res::Elem;
  using R = typename Res::Real;
  using C2 = icln_cplx_t<R>;
  __shared__ R red[96];
  const long long cell = cell0 + blockIdx.x;
  const long long arch = cell / p.cpa;
  const int chan = (int)((cell - arch * p.cpa) % p.nchan);
  const int nbin = p.nbin, tid = threadIdx.x, nt = blockDim.x;
  const T* x = static_cast<const T*>(p.cube) + cell * nbin;
  C2* z = scratch + (long long)blockIdx.x * n;
  Res res;
  res.setup(p, cell, chan, arch);
  // the cube's value at bin b (0 where the residual reads its cubes itself)
  auto ld = [&](int b) -> R {
    if constexpr (Res::kStaged) return icln_ldr(x + b);
    return R(0);
  };

  // ---- the fit ----
  R tp = R(0), q = R(0);
  for (int b = tid; b < nbin; b += nt) res.fitv(ld(b), b, tp, q);
  icln_fft_fold2(tp, q, red);
  res.finish(icln_tt(p, arch), p.w[cell], tp, q);

  // ---- the weighted residual's sum, max, min ----
  R sum = R(0), mx = -INFINITY, mn = INFINITY;
  if constexpr (BLUE) {
    for (int b = tid; b < nbin; b += nt) {
      const R r = res.atv(ld(b), b);
      sum += r;
      mx = icln_max(mx, r);
      mn = icln_min(mn, r);
    }
  } else {
    for (int c = tid; c < n; c += nt) {
      const int b = 2 * c;
      const R r0 = res.atv(ld(b), b), r1 = res.atv(ld(b + 1), b + 1);
      sum += r0;
      sum += r1;
      mx = icln_max(icln_max(mx, r0), r1);
      mn = icln_min(icln_min(mn, r0), r1);
    }
  }
  icln_fft_fold3(sum, mx, mn, red);
  const R mean = sum * p.inv_n;
  const bool m = p.mask[cell] != 0;
  const R centre = m ? R(0) : mean;

  // ---- centred into the scratch row, the squares ----
  R var = R(0);
  if constexpr (BLUE) {
    for (int b = tid; b < nbin; b += nt) {
      const R r = res.atv(ld(b), b) - centre;
      var = icln_fma(r, r, var);
      const C2 w = __ldg(chirp + b);
      C2 zc;
      zc.x = r * w.x;
      zc.y = r * w.y;
      z[b] = zc;
    }
    C2 zero;
    zero.x = R(0);
    zero.y = R(0);
    for (int b = nbin + tid; b < n; b += nt) z[b] = zero;
  } else {
    for (int c = tid; c < n; c += nt) {
      const int b = 2 * c;
      C2 zc;
      zc.x = res.atv(ld(b), b) - centre;
      zc.y = res.atv(ld(b + 1), b + 1) - centre;
      var = icln_fma(zc.x, zc.x, var);
      var = icln_fma(zc.y, zc.y, var);
      z[c] = zc;
    }
  }
  var = icln_fft_fold(var, red, IclnFftSum());
  if (tid == 0) {
    p.d_mean[cell] = m ? R(0) : mean;
    p.d_ptp[cell] = m ? icln_ma_fill<R>() : mx - mn;
    p.d_std[cell] = m ? R(0) : icln_sqrt(var * p.inv_n);
  }
}

// x / d by a 64-bit multiply: m = floor((2^64 - 1) / d) + 1 is exact for
// 0 <= x < 2^31, d < 2^31 (x d < 2^64)
struct IclnFastDiv64 {
  unsigned long long m;
  int d;
  __device__ __forceinline__ void set(int d_) {
    d = d_;
    m = 0xFFFFFFFFFFFFFFFFull / (unsigned long long)d_ + 1ull;
  }
  __device__ __forceinline__ int div(int x) const {
    return d == 1 ? x : (int)__umul64hi((unsigned long long)x, m);
  }
};

// the split max's index maps: the passes' strides s_j and points F_j as
// multiplies
struct IclnFftgOrder {
  IclnFastDiv64 s[ICLN_FFTG_MAX_PASSES], f[ICLN_FFTG_MAX_PASSES];
  int np;
  __device__ explicit IclnFftgOrder(const IclnFftgPasses& ps) : np(ps.np) {
    int st = ps.n;
    for (int j = 0; j < ps.np; ++j) {
      st /= ps.f[j];
      s[j].set(st);
      f[j].set(ps.f[j]);
    }
  }
  // the frequency at position pos of the passes' order
  __device__ __forceinline__ int freq(int pos) const {
    int fr = 0, mult = 1;
    for (int j = 0; j < np; ++j) {
      const int q = s[j].div(pos);
      pos -= q * s[j].d;
      fr += q * mult;
      mult *= f[j].d;
    }
    return fr;
  }
  // and the position of frequency fr
  __device__ __forceinline__ int at(int fr) const {
    int pos = 0;
    for (int j = 0; j < np; ++j) {
      const int q = f[j].div(fr);
      pos += (fr - q * f[j].d) * s[j].d;
      fr = q;
    }
    return pos;
  }
};

// (d): d_fft of cell cell0 + blockIdx.x from its transformed scratch row
template <class R, bool BLUE>
__global__ void __launch_bounds__(ICLN_FFTG_THREADS)
    icln_fftg_max_kernel(R* d_fft, long long cell0, const icln_cplx_t<R>* scratch,
                         IclnFftgPasses ps, int nbin, IclnFftgTable<icln_cplx_t<R>> tw) {
  using C2 = icln_cplx_t<R>;
  __shared__ R red[32];
  const int n = ps.n;
  const C2* z = scratch + (long long)blockIdx.x * n;
  R best = R(0);
  if constexpr (BLUE) {
    for (int k = threadIdx.x; k <= nbin / 2; k += blockDim.x) {
      const C2 v = z[k];
      best = icln_max(best, v.x * v.x + v.y * v.y);
    }
  } else {
    // position p holds Z[f]; the pair (f, n - f) from its first member
    // (f <= n - f), X[n - f] with W_N^(n - f) = -conj W_N^f, X[N/2] from
    // Z[0]; tw is W_N = W_(2n), here read with mul 1
    const IclnFftgOrder ord(ps);
    for (int pos = threadIdx.x; pos < n; pos += blockDim.x) {
      const int f = ord.freq(pos), fp = f == 0 ? 0 : n - f;
      if (f > fp) continue;
      const C2 A = z[pos];
      const C2 B = z[ord.at(fp)];
      const C2 w = tw(f);
      best = icln_max(best, icln_split_one<R>(A, B, w));
      if (fp != f) {
        C2 wp;
        wp.x = -w.x;
        wp.y = w.y;
        best = icln_max(best, icln_split_one<R>(B, A, wp));
      }
      if (f == 0) {
        const R xn = A.x - A.y;
        best = icln_max(best, xn * xn);
      }
    }
  }
  best = icln_fft_fold(best, red, IclnFftMax());
  if (threadIdx.x == 0) d_fft[cell0 + blockIdx.x] = icln_sqrt(best);
}

static bool icln_fftg_smooth(int x) {
  if (x < 1) return false;
  for (int p : {2, 3, 5})
    while (x % p == 0) x /= p;
  return x == 1;
}

// the passes' checks: n = F_1 ... F_k, each F 2^a 3^b 5^c <= 1024, G_j
// dividing s_j (the last pass's, s = 1: the row's spans), a tile within
// ps.tile (<= ICLN_FFTG_TILE_MAX; the last pass's two where `fused`),
// whole warps of threads
template <class R>
static bool icln_fftg_passes_ok(const IclnFftgPasses& ps, bool fused) {
  if (ps.n < 1 || ps.np < 1 || ps.np > ICLN_FFTG_MAX_PASSES || ps.tile < 1 ||
      ps.tile > ICLN_FFTG_TILE_MAX || ps.threads < 32 || ps.threads % 32 ||
      ps.threads > ICLN_FFTG_PASS_THREADS)
    return false;
  long long s = ps.n;
  for (int j = 0; j < ps.np; ++j) {
    const int F = ps.f[j], G = ps.g[j];
    if (F < 1 || F > ICLN_FFTG_PASS_MAX || !icln_fftg_smooth(F) || s % F) return false;
    const long long spans = ps.n / s;  // the pass's spans of s values
    s /= F;
    const long long two = fused && j == ps.np - 1 ? 2 : 1;
    if (G < 1 || (s > 1 ? s % G : spans % G) ||
        (long long)F * G * 2 * (long long)sizeof(R) * two > ps.tile)
      return false;
  }
  return s == 1;
}

// The blocks of `kernel` the current device holds at once at `threads`
// and `smem` bytes (asked once per device and launch shape): the pass
// kernel's persistent grid.
static cudaError_t icln_fftg_resident(const void* kernel, int threads, size_t smem,
                                      long long* resident) {
  static std::mutex mu;
  static std::map<std::tuple<int, const void*, int, size_t>, long long> cache;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const auto key = std::make_tuple(dev, kernel, threads, smem);
  {
    std::lock_guard<std::mutex> lock(mu);
    const auto it = cache.find(key);
    if (it != cache.end()) {
      *resident = it->second;
      return cudaSuccess;
    }
  }
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  *resident = (long long)per_sm * sms;
  std::lock_guard<std::mutex> lock(mu);
  cache[key] = *resident;
  return cudaSuccess;
}

// The passes over `rows` rows: `mode` 0 forward (passes 1 .. k), 1
// inverse (k .. 1), 2 Bluestein's convolution (forward 1 .. k - 1, the
// fused last pass times `mul`, inverse k - 1 .. 1); wf and perm hold every
// pass's table and order, pass j's at F_1 + ... + F_(j-1).  Each launch a
// persistent grid, two tiles a block in flight.
template <class R>
static cudaError_t icln_fftg_run_passes(icln_cplx_t<R>* buf, long long rows,
                                        const IclnFftgPasses& ps,
                                        IclnFftgTable<icln_cplx_t<R>> tw,
                                        const icln_cplx_t<R>* wf, const int* perm, int mode,
                                        const icln_cplx_t<R>* mul, cudaStream_t st) {
  using C2 = icln_cplx_t<R>;
  void (*kernel)(C2*, int, int, int, int, long long, IclnFftgTable<C2>, const C2*, const int*,
                 int, int, const C2*) = icln_fftg_pass_kernel<R>;
  int strides[ICLN_FFTG_MAX_PASSES], offs[ICLN_FFTG_MAX_PASSES];
  long long s = ps.n;
  for (int j = 0, o = 0; j < ps.np; o += ps.f[j], ++j) {
    strides[j] = (int)(s /= ps.f[j]);
    offs[j] = o;
  }
  // (pass, inverse, fused) in order
  int seq[2 * ICLN_FFTG_MAX_PASSES][3], ns = 0;
  const int k = ps.np;
  if (mode == 0)
    for (int j = 0; j < k; ++j) seq[ns][0] = j, seq[ns][1] = 0, seq[ns++][2] = 0;
  if (mode == 1)
    for (int j = k - 1; j >= 0; --j) seq[ns][0] = j, seq[ns][1] = 1, seq[ns++][2] = 0;
  if (mode == 2) {
    for (int j = 0; j < k - 1; ++j) seq[ns][0] = j, seq[ns][1] = 0, seq[ns++][2] = 0;
    seq[ns][0] = k - 1, seq[ns][1] = 0, seq[ns++][2] = 1;
    for (int j = k - 2; j >= 0; --j) seq[ns][0] = j, seq[ns][1] = 1, seq[ns++][2] = 0;
  }
  for (int i = 0; i < ns; ++i) {
    const int j = seq[i][0], F = ps.f[j], G = ps.g[j], fused = seq[i][2];
    const long long total = rows * (ps.n / ((long long)F * G));
    // two tiles in flight, the fused pass's third, the pass's tables
    const size_t tile = (size_t)F * G * sizeof(C2);
    const size_t smem = tile * (fused ? 3 : 2) + (size_t)F * (sizeof(C2) + sizeof(int));
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return icln_take_error(err);
    long long resident = 0;
    err = icln_fftg_resident((const void*)kernel, ps.threads, smem, &resident);
    if (err != cudaSuccess) return icln_take_error(err);
    if (resident < 1) return cudaErrorLaunchOutOfResources;
    const long long grid = total < resident ? total : resident;
    kernel<<<(unsigned)grid, ps.threads, smem, st>>>(buf, ps.n, F, strides[j], G, total, tw,
                                                    wf + offs[j], perm + offs[j], seq[i][1],
                                                    fused, fused ? mul : nullptr);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

static IclnFftgPasses icln_fftg_make_passes(int n, const int* f, const int* g, int threads,
                                            int tile) {
  IclnFftgPasses ps = {};
  ps.n = n;
  ps.threads = threads;
  ps.tile = tile;
  for (int j = 0; j < ICLN_FFTG_MAX_PASSES && f[j] > 1; ++j) {
    ps.f[j] = f[j];
    ps.g[j] = g[j];
    ps.np = j + 1;
  }
  if (ps.np == 0 && n == 1) {  // one pass of one point
    ps.f[0] = ps.g[0] = 1;
    ps.np = 1;
  }
  return ps;
}

template <class Res>
static int icln_fftg_launch(const CellStatsArgs<typename Res::Real>& p, void* scratch,
                            const void* chirp, const void* bhat, const IclnFftgPasses& ps,
                            long long chunk, const IclnFftgTabs& tb, const IclnFftgCluster& cl,
                            void* stream) {
  using R = typename Res::Real;
  using C2 = icln_cplx_t<R>;
  if (cl.cluster > 0)
    return icln_fftg_cluster_launch<Res>(p, chirp, bhat, ps.n, tb, cl, stream);
  const bool blue = chirp != nullptr;
  const long long tab = (long long)ps.n * tb.tmul;
  if (p.nbin < 2 || !icln_fftg_passes_ok<R>(ps, blue) || chunk < 1 ||
      scratch == nullptr || tb.tw == nullptr || tb.wf == nullptr || tb.perm == nullptr ||
      (blue != (bhat != nullptr)) ||
      (blue ? (tb.tmul != 1 || ps.n < (long long)p.nbin + p.nbin / 2)
            : (tb.tmul != 2 || p.nbin % 2 || 2LL * ps.n != p.nbin)) ||
      tb.lt < 0 || tb.lt > 30 || (1LL << (2 * tb.lt)) < tab / 2 || p.cpa < 1 ||
      p.ncells % p.cpa || p.cpa % p.nchan || chunk > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  C2* buf = static_cast<C2*>(scratch);
  const C2* wf = static_cast<const C2*>(tb.wf);
  // the passes read W_n^e = W_tab^(e tmul); the split's max W_N = W_tab
  const IclnFftgTable<C2> tp = {static_cast<const C2*>(tb.tw), tb.lt, tb.tmul};
  const IclnFftgTable<C2> tn = {static_cast<const C2*>(tb.tw), tb.lt, 1};
  cudaError_t err = cudaSuccess;
  for (long long c0 = 0; c0 < p.ncells; c0 += chunk) {
    const long long nc = p.ncells - c0 < chunk ? p.ncells - c0 : chunk;
    if (blue) {
      icln_fftg_residual_kernel<Res, true><<<(unsigned)nc, ICLN_FFTG_THREADS, 0, st>>>(
          p, c0, buf, ps.n, static_cast<const C2*>(chirp));
    } else {
      icln_fftg_residual_kernel<Res, false><<<(unsigned)nc, ICLN_FFTG_THREADS, 0, st>>>(
          p, c0, buf, ps.n, nullptr);
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    err = icln_fftg_run_passes<R>(buf, nc, ps, tp, wf, tb.perm, blue ? 2 : 0,
                                  static_cast<const C2*>(bhat), st);
    if (err != cudaSuccess) return (int)err;
    if (blue) {
      icln_fftg_max_kernel<R, true><<<(unsigned)nc, ICLN_FFTG_THREADS, 0, st>>>(
          p.d_fft, c0, buf, ps, p.nbin, tn);
    } else {
      icln_fftg_max_kernel<R, false><<<(unsigned)nc, ICLN_FFTG_THREADS, 0, st>>>(
          p.d_fft, c0, buf, ps, p.nbin, tn);
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

// K2's residual (`nyq` null: no Nyquist term), on cubes of element type T
template <class T>
static int icln_fftg_disp_t(CellStatsArgs<icln_real_t<T>> p, const void* disp, const void* rott,
                            const void* nyq, void* scratch, const void* chirp, const void* bhat,
                            const IclnFftgPasses& ps, long long chunk, const IclnFftgTabs& tb,
                            const IclnFftgCluster& cl, void* stream) {
  using R = icln_real_t<T>;
  p.cube = disp;
  p.rott = static_cast<const R*>(rott);
  p.nyq = static_cast<const R*>(nyq);
  return p.nyq ? icln_fftg_launch<ResDisp<T, true>>(p, scratch, chirp, bhat, ps, chunk, tb, cl,
                                                    stream)
               : icln_fftg_launch<ResDisp<T, false>>(p, scratch, chirp, bhat, ps, chunk, tb, cl,
                                                     stream);
}

template <class T>
static int icln_fftg_two_read_t(CellStatsArgs<icln_real_t<T>> p, const void* ded,
                                const void* disp_base, const void* rott, const void* tmpl,
                                void* scratch, const void* chirp, const void* bhat,
                                const IclnFftgPasses& ps, long long chunk,
                                const IclnFftgTabs& tb, const IclnFftgCluster& cl,
                                void* stream) {
  using R = icln_real_t<T>;
  p.cube = ded;
  p.base = disp_base;
  p.rott = static_cast<const R*>(rott);
  p.tmpl = static_cast<const R*>(tmpl);
  return icln_fftg_launch<ResTwoRead<T>>(p, scratch, chirp, bhat, ps, chunk, tb, cl, stream);
}

template <class T>
static int icln_fftg_dedisp_t(CellStatsArgs<icln_real_t<T>> p, const void* ded, const void* tmpl,
                              const void* win, void* scratch, const void* chirp, const void* bhat,
                              const IclnFftgPasses& ps, long long chunk, const IclnFftgTabs& tb,
                              const IclnFftgCluster& cl, void* stream) {
  using R = icln_real_t<T>;
  p.cube = ded;
  p.tmpl = static_cast<const R*>(tmpl);
  p.win = static_cast<const R*>(win);
  return icln_fftg_launch<ResDedisp<T>>(p, scratch, chirp, bhat, ps, chunk, tb, cl, stream);
}

// The entries.  `kind`: the cubes' storage, 0 float32, 1 bf16, 2 float64
// (every other pointer then double); n the transform's points (nbin / 2
// for a split row, M for Bluestein); inv_n float32(1/nbin) for float,
// 1/nbin for double; `chirp` (nbin,) and `bhat` (n,) complex values for
// Bluestein, both null for a split row.  The passes (cluster 0): `tw` the
// two-level table of W_tab (kernels._fft_twiddles(tab), tab = n * tmul:
// nbin for a split row, tmul 2; M for Bluestein, tmul 1), lt log2 of its
// low part; `wf` and `perm` the passes' tables W_F^e and stages' orders
// (kernels._fftg_pass_tables), pass after pass; `scratch` (chunk, n)
// complex values; the passes' points f0..f3 and columns g0..g3 (f 1 past
// the last pass), `threads` a block, `tile` the bytes a tile may take.
// The cluster mode (cluster 2, 4 or 8 blocks a cell, Bluestein alone):
// `tw` K2f's table of W_(2M) (lt its low part's log2), n = odd 2^m,
// `threads` and `smem` a block; wf, perm and scratch unused (null).

#define ICLN_FFTG_PARAMS                                                                        \
  const void *w, const unsigned char *mask, const void *tw, const void *wf, const int *perm,   \
      const void *tt, void *d_std, void *d_mean, void *d_ptp, void *d_fft, void *scratch,      \
      const void *chirp, const void *bhat, long long ncells, long long cpa, int nchan,         \
      int nbin, int n, int f0, int f1, int f2, int f3, int g0, int g1, int g2, int g3,         \
      int chunk, int lt, int tmul, int threads, int tile, int cluster, int odd,               \
      long long smem, double inv_n, int kind, void *stream

#define ICLN_FFTG_ARGS(R)                                                                      \
  icln_cell_stats_args<R>(mask, w, nullptr, nullptr, tt, d_std, d_mean, d_ptp, d_fft, ncells, \
                          cpa, nchan, nbin, 1, 0, 0, 0, inv_n)

#define ICLN_FFTG_PS                                                                           \
  const int fs[ICLN_FFTG_MAX_PASSES] = {f0, f1, f2, f3};                                       \
  const int gs[ICLN_FFTG_MAX_PASSES] = {g0, g1, g2, g3};                                       \
  const IclnFftgTabs tb = {tw, wf, perm, lt, tmul};                                            \
  const IclnFftgCluster cl = {cluster, odd, threads, smem};

#define ICLN_FFTG_TAIL \
  scratch, chirp, bhat, icln_fftg_make_passes(n, fs, gs, threads, tile), chunk, tb, cl, stream

static int icln_fftg_disp_entry(const void* disp, const void* rott, const void* nyq,
                                ICLN_FFTG_PARAMS) {
  ICLN_FFTG_PS
  if (kind == 2)
    return icln_fftg_disp_t<double>(ICLN_FFTG_ARGS(double), disp, rott, nyq, ICLN_FFTG_TAIL);
  if (kind == 1)
    return icln_fftg_disp_t<icln_bf16>(ICLN_FFTG_ARGS(float), disp, rott, nyq, ICLN_FFTG_TAIL);
  if (kind == 0)
    return icln_fftg_disp_t<float>(ICLN_FFTG_ARGS(float), disp, rott, nyq, ICLN_FFTG_TAIL);
  return (int)cudaErrorInvalidValue;
}

static int icln_fftg_dedisp_entry(const void* ded, const void* tmpl, const void* win,
                                  ICLN_FFTG_PARAMS) {
  ICLN_FFTG_PS
  if (kind == 2)
    return icln_fftg_dedisp_t<double>(ICLN_FFTG_ARGS(double), ded, tmpl, win, ICLN_FFTG_TAIL);
  if (kind == 1)
    return icln_fftg_dedisp_t<icln_bf16>(ICLN_FFTG_ARGS(float), ded, tmpl, win, ICLN_FFTG_TAIL);
  if (kind == 0)
    return icln_fftg_dedisp_t<float>(ICLN_FFTG_ARGS(float), ded, tmpl, win, ICLN_FFTG_TAIL);
  return (int)cudaErrorInvalidValue;
}

#define ICLN_FFTG_FWD                                                                          \
  w, mask, tw, wf, perm, tt, d_std, d_mean, d_ptp, d_fft, scratch, chirp, bhat, ncells, cpa,   \
      nchan, nbin, n, f0, f1, f2, f3, g0, g1, g2, g3, chunk, lt, tmul, threads, tile, cluster, \
      odd, smem, inv_n, kind, stream

// K2's residual
extern "C" int icln_cell_fftg_disp(const void* disp, const void* rott, const void* nyq,
                                   ICLN_FFTG_PARAMS) {
  return icln_fftg_disp_entry(disp, rott, nyq, ICLN_FFTG_FWD);
}

// K7's residual (two reads)
extern "C" int icln_cell_fftg_two_read(const void* ded, const void* disp_base, const void* rott,
                                       const void* tmpl, ICLN_FFTG_PARAMS) {
  ICLN_FFTG_PS
  if (kind == 2)
    return icln_fftg_two_read_t<double>(ICLN_FFTG_ARGS(double), ded, disp_base, rott, tmpl,
                                        ICLN_FFTG_TAIL);
  if (kind == 1)
    return icln_fftg_two_read_t<icln_bf16>(ICLN_FFTG_ARGS(float), ded, disp_base, rott, tmpl,
                                           ICLN_FFTG_TAIL);
  if (kind == 0)
    return icln_fftg_two_read_t<float>(ICLN_FFTG_ARGS(float), ded, disp_base, rott, tmpl,
                                       ICLN_FFTG_TAIL);
  return (int)cudaErrorInvalidValue;
}

// K6's residual
extern "C" int icln_cell_fftg_dedisp(const void* ded, const void* tmpl, const void* win,
                                     ICLN_FFTG_PARAMS) {
  return icln_fftg_dedisp_entry(ded, tmpl, win, ICLN_FFTG_FWD);
}

// K10's entries: K2's and K6's instantiations on one rank's shard
extern "C" int icln_shard_fftg_disp(const void* disp, const void* rott, const void* nyq,
                                    ICLN_FFTG_PARAMS) {
  return icln_fftg_disp_entry(disp, rott, nyq, ICLN_FFTG_FWD);
}

extern "C" int icln_shard_fftg_dedisp(const void* ded, const void* tmpl, const void* win,
                                      ICLN_FFTG_PARAMS) {
  return icln_fftg_dedisp_entry(ded, tmpl, win, ICLN_FFTG_FWD);
}

// The passes alone on `rows` rows of n complex values in place (kind 0
// float, 2 double): `mode` 0 forward into the passes' order, 1 inverse from
// it (`mul` null), `threads` a block, `tile` the bytes a tile may take.
// The wrapper makes the passes' chirp spectrum B^ with mode 0 (float64),
// and the card tests hold the passes to torch.fft.
extern "C" int icln_fftg_passes(void* buf, const void* mul, long long rows, int n, int f0, int f1,
                                int f2, int f3, int g0, int g1, int g2, int g3, const void* tw,
                                const void* wf, const int* perm, int lt, int tmul, int mode,
                                int threads, int tile, int kind, void* stream) {
  const int fs[ICLN_FFTG_MAX_PASSES] = {f0, f1, f2, f3};
  const int gs[ICLN_FFTG_MAX_PASSES] = {g0, g1, g2, g3};
  cudaStream_t st = (cudaStream_t)stream;
  const IclnFftgPasses ps = icln_fftg_make_passes(n, fs, gs, threads, tile);
  if (rows < 1 || lt < 0 || lt > 30 || tmul < 1 || (mode != 0 && mode != 1) || mul != nullptr ||
      tw == nullptr || wf == nullptr || perm == nullptr)
    return (int)cudaErrorInvalidValue;
  if (kind == 2) {
    if (!icln_fftg_passes_ok<double>(ps, false)) return (int)cudaErrorInvalidValue;
    const IclnFftgTable<double2> t = {static_cast<const double2*>(tw), lt, tmul};
    return (int)icln_fftg_run_passes<double>(static_cast<double2*>(buf), rows, ps, t,
                                             static_cast<const double2*>(wf), perm, mode,
                                             static_cast<const double2*>(mul), st);
  }
  if (kind == 0) {
    if (!icln_fftg_passes_ok<float>(ps, false)) return (int)cudaErrorInvalidValue;
    const IclnFftgTable<float2> t = {static_cast<const float2*>(tw), lt, tmul};
    return (int)icln_fftg_run_passes<float>(static_cast<float2*>(buf), rows, ps, t,
                                            static_cast<const float2*>(wf), perm, mode,
                                            static_cast<const float2*>(mul), st);
  }
  return (int)cudaErrorInvalidValue;
}
