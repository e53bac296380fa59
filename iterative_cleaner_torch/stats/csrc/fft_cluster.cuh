// The cluster FFT of the cell diagnostics past the DFT tables, shared by
// K2f (cell_fft.cu) and K2g's cluster mode (cell_fft_global.cu): a row
// of Q = P 2^lq complex values a block of a thread-block cluster, the
// cross-cluster step, the local passes of 8 points in registers and the
// odd stages (decimation in frequency, cell_fft.cu's design notes), their
// mirrored inverse (decimation in time, conjugate twiddles), the
// two-level twiddle table in shared memory, and the occupancy query that
// sizes a persistent grid of clusters.
#pragma once

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
// back into block k.  Centres as it loads (CENTRE); K2g's cluster mode
// loads its rows centred already, and zero from position nz on: those
// registers are set, not loaded.
template <int LC, class R, class G, bool CENTRE = true>
__device__ __forceinline__ void icln_fft_cross(G& grp, icln_cplx_t<R>* z,
                                               const icln_cplx_t<R>* lo,
                                               const icln_cplx_t<R>* hi, int lt, int Q, R ctr,
                                               R& var, int nz = 0) {
  using C2 = icln_cplx_t<R>;
  constexpr int n = 1 << LC, S = icln_fft_sw<R>();
  C2* zb[n];
#pragma unroll
  for (int k = 0; k < n; ++k) zb[k] = grp.at(z, k);
#pragma unroll 2
  for (int j = grp.rank() * (int)blockDim.x + (int)threadIdx.x; j < Q; j += n * (int)blockDim.x) {
    const int sj = icln_swz<S>(j);
    C2 r[n];
    if constexpr (CENTRE) {
#pragma unroll
      for (int k = 0; k < n; ++k) r[k] = zb[k][sj];
#pragma unroll
      for (int k = 0; k < n; ++k) icln_fft_centre(r[k], ctr, var);
    } else {
#pragma unroll
      for (int k = 0; k < n; ++k) {
        r[k].x = R(0);
        r[k].y = R(0);
        if (j + k * Q < nz) r[k] = zb[k][sj];
      }
    }
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

// ---- the inverse (K2g's cluster mode): the forward's steps mirrored,
// last first, decimation in time, every twiddle conjugated and applied
// before its butterfly: from the forward's output order back to natural
// order, times the points ----

// x * conj W_16^m (m < 8)
template <class C2>
__device__ __forceinline__ C2 icln_mul_w16c(C2 x, int m) {
  if (m == 0) return x;
  if (m == 4) {  // i
    C2 r;
    r.x = -x.y;
    r.y = x.x;
    return r;
  }
  const C2 w = icln_mul_w16(C2{1, 0}, m);
  return icln_cmul(x, icln_conj(w));
}

// The inverse of icln_dif_regs: v[k] holding the DFT's output brev(k)
// ends as 2^LR times input k.
template <int LR, class C2>
__device__ __forceinline__ void icln_dit_regs(C2 (&v)[1 << LR]) {
  constexpr int n = 1 << LR;
#pragma unroll
  for (int st = LR - 1; st >= 0; --st) {
    const int h = n >> (st + 1);
#pragma unroll
    for (int k = 0; k < n; ++k) {
      if (k & h) continue;
      const C2 a = v[k], b = icln_mul_w16c(v[k + h], (k & (h - 1)) * (8 / h));
      v[k] = icln_cadd(a, b);
      v[k + h] = icln_csub(a, b);
    }
  }
}

// The inverse of icln_fft_pass: each group's registers times conj
// W_M^(i brev(k)), then icln_dit_regs.
template <int LR, class R>
__device__ __forceinline__ void icln_fft_pass_inv(icln_cplx_t<R>* z, const icln_cplx_t<R>* lo,
                                                  const icln_cplx_t<R>* hi, int lt, int P, int lq,
                                                  int lx, int sh) {
  using C2 = icln_cplx_t<R>;
  constexpr int n = 1 << LR, S = icln_fft_sw<R>();
  const int lg = lq - LR;
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
    if (i != 0) {
      C2 w[n];
      icln_tw_regs<LR>(w, lo, hi, lt, i << sh);
#pragma unroll
      for (int k = 1; k < n; ++k) r[k] = icln_cmul(r[k], icln_conj(w[k]));
    }
    icln_dit_regs<LR>(r);
#pragma unroll
    for (int k = 0; k < n; ++k) z[icln_swz<S>((u0 + (k << lx)) * P + v)] = r[k];
  }
}

// The local passes of 2^LR points (the first taking the remainder), as
// K2f's kernel runs them, each followed by a barrier.
template <int LR, class R>
__device__ __forceinline__ void icln_fft_passes(icln_cplx_t<R>* z, const icln_cplx_t<R>* lo,
                                                const icln_cplx_t<R>* hi, int lt, int P, int lq,
                                                int lm) {
  static_assert(LR >= 1 && LR <= 4, "passes of 2 to 16 points");
  for (int mu = lq, lr = lq % LR == 0 ? LR : lq % LR; mu > 0; mu -= lr, lr = LR) {
    const int lx = mu - lr, sh = lm + 1 - mu;
    if (lr == 1) icln_fft_pass<1, R>(z, lo, hi, lt, P, lq, lx, sh);
    if (lr == 2) icln_fft_pass<2, R>(z, lo, hi, lt, P, lq, lx, sh);
    if (lr == 3) icln_fft_pass<3, R>(z, lo, hi, lt, P, lq, lx, sh);
    if constexpr (LR >= 4)
      if (lr == 4) icln_fft_pass<4, R>(z, lo, hi, lt, P, lq, lx, sh);
    __syncthreads();
  }
}

// The local passes' inverse, the forward's in reverse order (the forward
// runs lx = lq - r0, lq - r0 - LR, ..., 0 with r0 points first), each
// followed by a barrier.
template <int LR, class R>
__device__ __forceinline__ void icln_fft_passes_inv(icln_cplx_t<R>* z, const icln_cplx_t<R>* lo,
                                                    const icln_cplx_t<R>* hi, int lt, int P,
                                                    int lq, int lm) {
  static_assert(LR >= 1 && LR <= 4, "passes of 2 to 16 points");
  const int r0 = lq % LR == 0 ? LR : lq % LR;
  for (int lx = 0; lx < lq;) {
    const int lr = lx == lq - r0 ? r0 : LR, sh = lm + 1 - (lx + lr);
    if (lr == 1) icln_fft_pass_inv<1, R>(z, lo, hi, lt, P, lq, lx, sh);
    if (lr == 2) icln_fft_pass_inv<2, R>(z, lo, hi, lt, P, lq, lx, sh);
    if (lr == 3) icln_fft_pass_inv<3, R>(z, lo, hi, lt, P, lq, lx, sh);
    if constexpr (LR >= 4)
      if (lr == 4) icln_fft_pass_inv<4, R>(z, lo, hi, lt, P, lq, lx, sh);
    __syncthreads();
    lx += lr;
  }
}

// At an odd part p = 3 or 5 (one odd stage, its spans the groups of p
// contiguous values: no twiddle but W_p's): the forward stage, its
// outputs times B^ (`bh`, this block's slice in the forward's order), and
// the inverse stage, a group at a time in registers, one sweep.
template <int p, class R>
__device__ __forceinline__ void icln_fft_odd_mul_inv(icln_cplx_t<R>* z, const icln_cplx_t<R>* lo,
                                                     const icln_cplx_t<R>* hi, int lt, int lq,
                                                     int two_l, const icln_cplx_t<R>* bh) {
  using C2 = icln_cplx_t<R>;
  constexpr int S = icln_fft_sw<R>();
  C2 w[p];
#pragma unroll
  for (int v = 0; v < p; ++v) w[v] = icln_tw(lo, hi, lt, v * two_l);
  for (int s = threadIdx.x; s < (1 << lq); s += blockDim.x) {
    const int base = s * p;
    C2 in[p], y[p];
#pragma unroll
    for (int u = 0; u < p; ++u) in[u] = z[icln_swz<S>(base + u)];
#pragma unroll
    for (int t = 0; t < p; ++t) {
      C2 acc = in[0];
#pragma unroll
      for (int u = 1; u < p; ++u) acc = icln_cadd(acc, icln_cmul(in[u], w[(u * t) % p]));
      y[t] = icln_cmul(acc, __ldg(bh + base + t));
    }
#pragma unroll
    for (int u = 0; u < p; ++u) {
      C2 acc = y[0];
#pragma unroll
      for (int t = 1; t < p; ++t) acc = icln_cadd(acc, icln_cmul(y[t], icln_conj(w[(u * t) % p])));
      z[icln_swz<S>(base + u)] = acc;
    }
  }
}

// The inverse of icln_fft_odd_stage: outputs t times conj W_sp^(j t),
// then the p-point DFT with conjugate twiddles back to j + u d.
template <int p, bool ONE, class R>
__device__ __forceinline__ void icln_fft_odd_stage_inv(icln_cplx_t<R>* z,
                                                       const icln_cplx_t<R>* lo,
                                                       const icln_cplx_t<R>* hi, int lt, int lq,
                                                       int P, int sp, int nsp) {
  using C2 = icln_cplx_t<R>;
  constexpr int S = icln_fft_sw<R>();
  const int d = ONE ? 1 : sp / p, per = ONE ? 1 : P / p;
  C2 w[p];
#pragma unroll
  for (int v = 0; v < p; ++v) w[v] = icln_conj(icln_tw(lo, hi, lt, v * (nsp * d)));
  for (int idx = threadIdx.x; idx < (per << lq); idx += blockDim.x) {
    const int s = ONE ? idx : idx / per, r = ONE ? 0 : idx - s * per, j = ONE ? 0 : r % d;
    const int base = ONE ? s * p : s * P + (r / d) * sp + j;
    C2 y[p];
#pragma unroll
    for (int t = 0; t < p; ++t) {
      y[t] = z[icln_swz<S>(base + t * d)];
      if (j != 0 && t != 0) y[t] = icln_cmul(y[t], icln_conj(icln_tw(lo, hi, lt, j * t * nsp)));
    }
#pragma unroll
    for (int u = 0; u < p; ++u) {
      C2 acc = y[0];
#pragma unroll
      for (int t = 1; t < p; ++t) acc = icln_cadd(acc, icln_cmul(y[t], w[(u * t) % p]));
      z[icln_swz<S>(base + u * d)] = acc;
    }
  }
}

// every odd stage's inverse, the last stage first, a barrier after each
template <class R>
__device__ void icln_fft_odd_inv(icln_cplx_t<R>* z, const icln_cplx_t<R>* lo,
                                 const icln_cplx_t<R>* hi, int lt, int lq, int P, int two_l) {
  if (P == 3) icln_fft_odd_stage_inv<3, true, R>(z, lo, hi, lt, lq, 3, 3, two_l);
  if (P == 5) icln_fft_odd_stage_inv<5, true, R>(z, lo, hi, lt, lq, 5, 5, two_l);
  if (P == 3 || P == 5) {
    __syncthreads();
    return;
  }
  int sps[16], ns = 0;
  for (int sp = P; sp > 1 && ns < 16; sp /= icln_fft_odd_radix(sp)) sps[ns++] = sp;
  for (int i = ns - 1; i >= 0; --i) {
    const int sp = sps[i], p = icln_fft_odd_radix(sp), nsp = two_l * (P / sp);
    if (p == 5) icln_fft_odd_stage_inv<5, false, R>(z, lo, hi, lt, lq, P, sp, nsp);
    if (p == 3) icln_fft_odd_stage_inv<3, false, R>(z, lo, hi, lt, lq, P, sp, nsp);
    __syncthreads();
  }
}

// The cross-cluster step's inverse, last: value j of every block's slice
// in register k, times conj W_N^(2 j brev(k)), the inverse C-point
// butterflies; register k then holds the result at position j + k Q, in
// natural order, and |.|^2 of those below K is maxed (icln_max from +0)
// and returned: nothing is stored.
template <int LC, class R, class G>
__device__ __forceinline__ R icln_fft_cross_inv_max(G& grp, icln_cplx_t<R>* z,
                                                    const icln_cplx_t<R>* lo,
                                                    const icln_cplx_t<R>* hi, int lt, int Q,
                                                    int K) {
  using C2 = icln_cplx_t<R>;
  constexpr int n = 1 << LC, S = icln_fft_sw<R>();
  C2* zb[n];
#pragma unroll
  for (int k = 0; k < n; ++k) zb[k] = grp.at(z, k);
  R best = R(0);
  const int jmax = K < Q ? K : Q;  // j + k Q < K needs j < K
#pragma unroll 2
  for (int j = grp.rank() * (int)blockDim.x + (int)threadIdx.x; j < jmax;
       j += n * (int)blockDim.x) {
    const int sj = icln_swz<S>(j);
    C2 r[n];
#pragma unroll
    for (int k = 0; k < n; ++k) r[k] = zb[k][sj];
    C2 w[n];
    icln_tw_regs<LC>(w, lo, hi, lt, j << 1);
#pragma unroll
    for (int k = 1; k < n; ++k) r[k] = icln_cmul(r[k], icln_conj(w[k]));
    icln_dit_regs<LC>(r);
#pragma unroll
    for (int k = 0; k < n; ++k)
      if (j + k * Q < K) best = icln_max(best, r[k].x * r[k].x + r[k].y * r[k].y);
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
