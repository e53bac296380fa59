// The cell-diagnostics kernel template shared by K2, K6, K7
// (cell_stats.cu) and K10 (shard_stats.cu): one kernel over a residual
// struct, the diagnostics tail shared, as the TPU kernels share
// _diag_tail.  cell_stats.cu states what it replaces, what bounds it and
// the design; this file is the design.
//
// One block per SM walks groups of `group` consecutive cells (one
// contiguous run of the cube), its warps split in two roles that work on
// consecutive groups at once (kernels.cell_stats_geometry sizes both;
// at nbin 128, 60 cells, 12 producer and 8 consumer warps):
//   staging    a producer thread issues group g + 1's run as one TMA bulk
//              copy into the other of two stage slots, completing on that
//              slot's mbarrier, while group g is worked; the producers
//              read group g + 1's weights and mask into shared memory
//              then too.  A group whose run is not 16-byte aligned (the
//              cube's start, or nbin not a multiple of four), every K7
//              group (its residual reads two cubes, ResTwoRead) and the
//              one-cell groups of the longest profiles are read from
//              device memory by phase 1 instead; the slot's barrier is
//              then armed with a plain arrival, so its phases stay in
//              step.
//   producers  phase 1: one warp per cell, lanes across bins, fixed-order
//              shuffle reductions: the weighted residual (Res::setup,
//              ::fit, ::finish, ::at), mean, ptp and the two-pass std —
//              the arithmetic and order of the first design — and the
//              centred row written TRANSPOSED into centred-row buffer
//              g & 1, [b][cell].
//   consumers  phase 2 of group g - 1 from the other buffer: max over k
//              of |DFT|^2 as a register-tiled product.  Each thread holds
//              `CT` cells x 4 columns of re and im (32 accumulators at
//              CT = 4) and per bin loads its cells' values as one 16-byte
//              word and its four cos and four sin entries as two more,
//              for 8 * CT FMAs.  The tables are laid out [b][k], k padded
//              with zero columns to a multiple of four (|X|^2 = 0 never
//              wins: `best` starts at 0, and a row holding NaN or inf is
//              NaN in a real column too).  Every (cell, k) keeps its chain
//              of __fmaf_rn over b = 0 .. nbin-1 in order, so d_fft is
//              bit-equal to the first design's; where the table does not
//              fit it is streamed in (column x row) chunks, the
//              accumulators staying in registers across the row chunks.
//              The max over k is order-free: each thread folds its
//              columns with icln_max and the consumers meet in a shared
//              int atomicMax (the values are >= +0 or the positive quiet
//              NaN, whose int order is the float order with NaN on top).
// A batch of equal-shaped archives is one launch over all their cells,
// B * nsub * nchan of them, the cube, weights, mask and outputs being
// contiguous across archives: each cell finds its archive as cell / cpa
// (cells per archive) and reads that archive's template rows, template
// and <t,t>; the DFT tables are shared.  A group may straddle two
// archives, which changes nothing: every cell's arithmetic is its own, so
// each archive's planes are bit-equal to a launch on it alone.  That
// addressing is a compile-time flag (BATCH): one archive's launch keeps
// the single-archive form (no division per cell, <t,t> read once a
// block), which the per-cell form had made 3-8% slower at 1024 x 4096 x
// 128 on one H100 (tools/time_cell_stats.py, both forms in turns).
// A bf16-stored cube (the mixed-precision mode) is the same kernel over
// 2-byte elements (Res<icln_bf16>): the stage slots hold the group's bf16
// run (half the bytes of a float32 slot; a run is staged where it starts
// and ends on a 16-byte word, 8 elements), and each element is upcast to
// float32 where phase 1 reads it (icln_real, icln_ldr), the counterpart of
// _wres_disp / _wres_dedisp / _cell_stats_kernel upcasting each staged
// block on the TPU.  A float32 slot doubles as the row's working buffer
// (the residual is written over the staged row); a bf16 slot cannot hold
// float32 rows, so phase 1 recomputes the weighted residual from the
// staged row where the float32 form re-reads the buffer — the same
// operations on the same values, so the centred rows, and all four
// planes, are bit-equal to the float32 kernel's on the upcast cube.  The
// centred-row buffers the DFT reads stay float32.
// A float64 cube (dtype="float64"; the reference's float64 route is its
// XLA einsums and FFT, no TPU kernel) is the same kernel in double
// (Res<double>: icln_real_t<double> is double): the rows, templates,
// weights, DFT tables, centred-row buffers and planes are double, every
// sum and the DFT's chains (__fma_rn) double, the 16-byte words of the
// stage slots and of the phase-2 loads hold 2 doubles (a CT = 4 tile's
// cells and columns are two loads each), the per-cell maxima meet in an
// int64 atomicMax, and the masked ptp is 1e20 as a double.  Its block
// is at most 16 warps (Res::kMaxThreads), so that a consumer's 32 double
// accumulators stay in registers.
// Named barriers hand the two centred-row buffers between the roles
// (ICLN_BAR_FULL / ICLN_BAR_EMPTY); each role also has its own.  The
// split is the measured design: with one role per block and the phases
// in turn, two blocks an SM ran the same arithmetic in 8.8 ms at
// 1024x4096x128, their phases in step; split, 7.1-7.6 ms (PERF.md).

#pragma once

#include <cstdint>
#include <type_traits>

#include "common.cuh"

// R: the arithmetic type (float for float32 and bf16 cubes, double for
// float64 ones); every operand but the cubes is R.
template <class R>
struct CellStatsArgs {
  const void* cube;    // K2, K10 disp: disp; K6, K7, K10 dedisp: ded — (ncells, nbin),
                       // float, icln_bf16 or double (the Res struct's element type)
  const void* base;    // K7: disp_base (ncells, nbin), of the cube's type
  const R* rott;       // K2, K7: (B, nchan, nbin) rotated template rows
  const R* nyq;        // K2: (B, nchan, nbin) Nyquist rows, or null
  const R* tmpl;       // K6, K7: (B, nbin) templates
  const R* win;        // K6: (nbin,) pulse window, shared
  const R* w;
  const unsigned char* mask;
  const R* cos_t;      // (nbin, nkp), zero past nbin/2 + 1
  const R* sin_t;
  const R* tt;         // (B, 2): [<t,t> (1 where 0), 1 if <t,t> == 0]
  R* d_std;
  R* d_mean;
  R* d_ptp;
  R* d_fft;
  long long ncells;    // B * cpa
  long long cpa;       // cells per archive, nsub * nchan
  int nchan, nbin, group, kchunk, bchunk, nkp;
  R inv_n;
  int aligned;         // the cube starts 16-byte aligned
  int producers;       // warps running phase 1; the rest run phase 2
};

template <class R>
struct IclnTT {
  R tt;    // <t,t>, 1 where it is 0
  R zero;  // 1 if <t,t> == 0
};

// tt = (<t,t> (1 where 0), 1 if <t,t> == 0) of archive `arch`
template <class R>
__device__ __forceinline__ IclnTT<R> icln_tt(const CellStatsArgs<R>& p, long long arch) {
  return IclnTT<R>{p.tt[2 * arch], p.tt[2 * arch + 1]};
}

template <class R>
__device__ __forceinline__ R icln_amp(IclnTT<R> tt, R tp) {
  return tt.zero != R(0) ? R(1) : tp / tt.tt;
}

// Each residual struct works a bin at a time, so that phase 1 can run
// two cells' bins in one loop: setup() points it at its cell's rows (of
// channel c of archive a),
// fit() takes bin b of the row (reading x, the staged row itself or
// device memory, keeping it in row for a float32 cube) into the lane's
// partial sums of <x, t> (and for K2 of x * (-1)^b), finish() takes
// those after the warp sums, and at() is the weighted residual at bin b
// (from the kept row; for a bf16 cube from x again).  The arithmetic and
// its order are the first design's.  T is the cube's element type.

// K2 (_wres_disp): (amp * rot_t - (disp + nq * nyq)) * w; the Nyquist
// term only with NYQ (fourier rotation, even nbin).
// The most threads a block of the kernel over cube elements T takes:
// 20 warps (at most 102 registers a thread), 16 for double arithmetic.
#define ICLN_CELL_MAX_THREADS 640
#define ICLN_CELL_MAX_THREADS_F64 512

template <class T>
__host__ __device__ constexpr int icln_cell_max_threads() {
  return std::is_same<icln_real_t<T>, double>::value ? ICLN_CELL_MAX_THREADS_F64
                                                     : ICLN_CELL_MAX_THREADS;
}

template <class T, bool NYQ>
struct ResDisp {
  using Elem = T;
  using Real = icln_real_t<T>;
  using R = Real;
  static constexpr bool kStaged = true;
  const R* rt;
  const R* nr;
  R amp, nq, wc;
  __device__ void setup(const CellStatsArgs<R>& p, long long, int c, long long a) {
    const size_t row = ((size_t)a * p.nchan + c) * p.nbin;
    rt = p.rott + row;
    // (the pointer test stays: written as `NYQ ? ...` it compiled to a
    // slower K2 on sm_90a, the loop laid out differently)
    nr = p.nyq ? p.nyq + row : nullptr;
  }
  __device__ void fit(const T* x, R* row, int b, R& tp, R& q) const {
    const R v = icln_real(x[b]);
    if constexpr (std::is_same<T, R>::value) row[b] = v;
    tp += v * __ldg(rt + b);
    q += (b & 1) ? -v : v;  // disp * (-1)^b
  }
  __device__ void finish(IclnTT<R> tt, R w, R tp, R q) {
    nq = q;
    amp = icln_amp(tt, tp);
    wc = w;
  }
  __device__ R at(const T* row, int b) const {
    const R v = icln_real(row[b]);
    const R base = NYQ ? v + nq * __ldg(nr + b) : v;
    return (amp * __ldg(rt + b) - base) * wc;
  }
};

// K7 (_cell_stats_kernel): tp = <ded, t>, (amp * rot_t - disp_base) * w.
// Reads both cubes from device memory itself, unstaged (a ring of two
// cubes' rows would halve the group; taking the kernel's pointer compiled
// to a K7 8% slower on sm_90a, PERF.md).
template <class T>
struct ResTwoRead {
  using Elem = T;
  using Real = icln_real_t<T>;
  using R = Real;
  static constexpr bool kStaged = false;
  const T* x;
  const R* t;
  const R* rt;
  const T* y;
  R amp, wc;
  __device__ void setup(const CellStatsArgs<R>& p, long long cell, int c, long long a) {
    x = static_cast<const T*>(p.cube) + cell * p.nbin;
    t = p.tmpl + a * p.nbin;
    rt = p.rott + ((size_t)a * p.nchan + c) * p.nbin;
    y = static_cast<const T*>(p.base) + cell * p.nbin;
  }
  __device__ void fit(const T*, R*, int b, R& tp, R&) const {
    tp += icln_ldr(x + b) * __ldg(t + b);
  }
  __device__ void finish(IclnTT<R> tt, R w, R tp, R) {
    amp = icln_amp(tt, tp);
    wc = w;
  }
  __device__ R at(const T*, int b) const {
    return (amp * __ldg(rt + b) - icln_ldr(y + b)) * wc;
  }
};

// K6 (_wres_dedisp): ((amp * t - ded) * window) * w
template <class T>
struct ResDedisp {
  using Elem = T;
  using Real = icln_real_t<T>;
  using R = Real;
  static constexpr bool kStaged = true;
  const R* t;
  const R* win;
  R amp, wc;
  __device__ void setup(const CellStatsArgs<R>& p, long long, int, long long a) {
    t = p.tmpl + a * p.nbin;
    win = p.win;
  }
  __device__ void fit(const T* x, R* row, int b, R& tp, R&) const {
    const R v = icln_real(x[b]);
    if constexpr (std::is_same<T, R>::value) row[b] = v;
    tp += v * __ldg(t + b);
  }
  __device__ void finish(IclnTT<R> tt, R w, R tp, R) {
    amp = icln_amp(tt, tp);
    wc = w;
  }
  __device__ R at(const T* row, int b) const {
    return ((amp * __ldg(t + b) - icln_real(row[b])) * __ldg(win + b)) * wc;
  }
};

// Byte offsets of the block's shared memory (kernels.cell_stats_smem
// mirrors its size): the two stage slots' mbarriers, the cos and sin table
// chunks (bchunk rows of kchunk columns each), two buffers of centred
// rows transposed [b][group], two stage slots of `group` rows of
// `es`-byte cube elements (none at one cell a group), the per-cell maxima
// (the bits of each as an int of the value's width), and two rows each of
// weights and mask bytes; the tables, rows, maxima and weights are of the
// `rs`-byte arithmetic type.
struct IclnCellLayout {
  long long tables, cen, cslot, sslot, stage, red, wsm, msm, total;
};

__host__ __device__ inline long long icln_a16(long long x) { return (x + 15) / 16 * 16; }

__host__ __device__ inline IclnCellLayout icln_cell_layout(int nbin, int group, int kchunk,
                                                           int bchunk, int es, int rs) {
  IclnCellLayout L;
  L.tables = 16;
  L.cen = L.tables + 2LL * bchunk * kchunk * rs;
  L.cslot = icln_a16((long long)group * nbin * rs);
  L.sslot = icln_a16((long long)group * nbin * es);
  // one cell a group (the longest profiles): no staging, phase 1 works in
  // the centred-row buffer itself, [b][1] being the row (a bf16 cube's
  // phase 1 keeps no row)
  L.stage = group == 1 ? L.cen : L.cen + 2 * L.cslot;
  L.red = group == 1 ? L.cen + 2 * L.cslot : L.stage + 2 * L.sslot;
  L.wsm = L.red + (long long)group * rs;
  L.msm = L.wsm + 2LL * group * rs;
  L.total = L.msm + 2LL * group;
  return L;
}

// named barriers (0 is __syncthreads)
#define ICLN_BAR_PRODUCERS 1
#define ICLN_BAR_CONSUMERS 2
#define ICLN_BAR_FULL 3   // + buffer: centred rows ready
#define ICLN_BAR_EMPTY 5  // + buffer: centred rows consumed

__device__ __forceinline__ void icln_bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void icln_bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Whether group `cell0` (of `cells` cells) comes by bulk copy: the
// producer and every consumer decide alike.
template <class Res>
__device__ __forceinline__ bool icln_group_staged(const CellStatsArgs<typename Res::Real>& p,
                                                  long long cell0, int cells) {
  constexpr int kWord = 16 / (int)sizeof(typename Res::Elem);  // elements a 16-byte word
  return Res::kStaged && p.group > 1 && p.aligned && (cell0 * p.nbin) % kWord == 0
         && ((long long)cells * p.nbin) % kWord == 0;
}

template <class R>
__device__ __forceinline__ int icln_group_cells(const CellStatsArgs<R>& p, long long grp) {
  return (int)min((long long)p.group, p.ncells - grp * p.group);
}

// One thread: start group grp's run into `slot`, or arm the barrier alone.
template <class Res>
__device__ void icln_cell_issue(const CellStatsArgs<typename Res::Real>& p, long long grp,
                                void* slot, uint64_t* bar) {
  using T = typename Res::Elem;
  const long long cell0 = grp * p.group;
  const int cells = icln_group_cells(p, grp);
  if (icln_group_staged<Res>(p, cell0, cells)) {
    const unsigned bytes = (unsigned)((long long)cells * p.nbin * sizeof(T));
    icln_mbar_arrive_tx(bar, bytes);
    icln_bulk_load(slot, static_cast<const T*>(p.cube) + cell0 * p.nbin, bytes, bar);
  } else {
    icln_mbar_arrive(bar);
  }
}

// Threads t < the group's cell count: its weights and mask into smem.
template <class R>
__device__ __forceinline__ void icln_cell_scalars(const CellStatsArgs<R>& p, long long grp,
                                                  int t, R* wsm, unsigned char* msm) {
  if (t < icln_group_cells(p, grp)) {
    wsm[t] = p.w[grp * p.group + t];
    msm[t] = p.mask[grp * p.group + t];
  }
}

// Four consecutive values, 16-byte aligned: one 16-byte load of float32,
// two of float64.
__device__ __forceinline__ void icln_ld4(const float* p, float (&v)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
}

__device__ __forceinline__ void icln_ld4(const double* p, double (&v)[4]) {
  const double2 x = *reinterpret_cast<const double2*>(p);
  const double2 y = *reinterpret_cast<const double2*>(p + 2);
  v[0] = x.x, v[1] = x.y, v[2] = y.x, v[3] = y.y;
}

__device__ __forceinline__ void icln_copy4(float* dst, const float* src) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
}

__device__ __forceinline__ void icln_copy4(double* dst, const double* src) {
  *reinterpret_cast<double2*>(dst) = *reinterpret_cast<const double2*>(src);
  *reinterpret_cast<double2*>(dst + 2) = *reinterpret_cast<const double2*>(src + 2);
}

// the bits of a per-cell maximum (>= +0 or the positive quiet NaN: their
// signed int order is the value order, NaN on top), and back
__device__ __forceinline__ int icln_max_bits(float x) { return __float_as_int(x); }

__device__ __forceinline__ long long icln_max_bits(double x) { return __double_as_longlong(x); }

__device__ __forceinline__ float icln_from_bits(int b) { return __int_as_float(b); }

__device__ __forceinline__ double icln_from_bits(long long b) { return __longlong_as_double(b); }

template <class R>
using icln_bits_t = typename std::conditional<sizeof(R) == 8, long long, int>::type;

// Threads t of nt: table rows [b0, b0 + bn) x columns [4 * kt0,
// 4 * (kt0 + mc)) into the chunk buffers at pitch kchunk, 16 bytes a load.
template <class R>
__device__ __forceinline__ void icln_fill_tables(const CellStatsArgs<R>& p, R* cos_s,
                                                 R* sin_s, int b0, int bn, int kt0, int mc,
                                                 int t, int nt) {
  for (int i = t; i < bn * mc; i += nt) {
    const int r = i / mc, q = i % mc;
    const size_t src = (size_t)(b0 + r) * p.nkp + 4 * (kt0 + q);
    const int dst = r * p.kchunk + 4 * q;
    icln_copy4(cos_s + dst, p.cos_t + src);
    icln_copy4(sin_s + dst, p.sin_t + src);
  }
}

// Warp-specialised: warps [0, p.producers) run phase 1 of group it into
// centred-row buffer it & 1 while the other warps run phase 2 of group
// it - 1 from the other buffer.  Named barriers hand the buffers over:
// FULL + j (producers arrive once their rows are written, consumers
// wait) and EMPTY + j (consumers arrive once their DFT is done, producers
// wait before rewriting the buffer).
template <class Res, int CT, bool BATCH>
__global__ void __launch_bounds__(icln_cell_max_threads<typename Res::Elem>())
    icln_cell_stats_kernel(const CellStatsArgs<typename Res::Real> p) {
  using T = typename Res::Elem;
  using R = typename Res::Real;
  using Bits = icln_bits_t<R>;
  // the staged row is the working row (float32 and float64 cubes)
  constexpr bool kRow = std::is_same<T, R>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nbin = p.nbin, group = p.group, kchunk = p.kchunk, bchunk = p.bchunk;
  const IclnCellLayout L =
      icln_cell_layout(nbin, group, kchunk, bchunk, (int)sizeof(T), (int)sizeof(R));
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw);
  R* cos_s = reinterpret_cast<R*>(smem_raw + L.tables);
  R* sin_s = cos_s + bchunk * kchunk;
  const long long slot_fl = L.cslot / (long long)sizeof(R);
  R* cen_base = reinterpret_cast<R*>(smem_raw + L.cen);
  unsigned char* stage = smem_raw + L.stage;
  const T* cube = static_cast<const T*>(p.cube);
  Bits* rmax = reinterpret_cast<Bits*>(smem_raw + L.red);
  R* wsm = reinterpret_cast<R*>(smem_raw + L.wsm);
  unsigned char* msm = smem_raw + L.msm;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x, npw = p.producers, nprod = 32 * npw;
  const int ncons = nthreads - nprod;
  const int ktiles = p.nkp / 4, ct = group / CT, per = kchunk / 4;
  const int nkc = (ktiles + per - 1) / per, nbc = (nbin + bchunk - 1) / bchunk;
  const bool resident = nkc == 1 && nbc == 1;  // the whole table, loaded once
  const long long ngroups = (p.ncells + group - 1) / group;
  const long long nit =
      blockIdx.x < ngroups ? (ngroups - 1 - blockIdx.x) / gridDim.x + 1 : 0;

  if (tid == 0) {
    icln_mbar_init(&bar[0], 1);
    icln_mbar_init(&bar[1], 1);
    icln_mbar_init_fence();
  }
  if (resident) icln_fill_tables(p, cos_s, sin_s, 0, nbin, 0, ktiles, tid, nthreads);
  if (nit > 0) icln_cell_scalars(p, blockIdx.x, tid, wsm, msm);
  __syncthreads();

  if (warp < npw) {
    // ---- producers, phase 1: weighted residual + moments, one warp per
    // cell, the centred rows written transposed ----
    const IclnTT<R> tt1 = BATCH ? IclnTT<R>{R(0), R(0)} : icln_tt(p, 0);
    if (tid == 0 && nit > 0) icln_cell_issue<Res>(p, blockIdx.x, stage, &bar[0]);
    for (long long it = 0; it < nit; ++it) {
      const int j = (int)(it & 1);
      const long long grp = blockIdx.x + it * gridDim.x;
      // slot j ^ 1 and scalar row j ^ 1 were last read in the previous
      // group's phase 1, before the producers' barrier that ended it
      if (it + 1 < nit) {
        if (tid == 0) {
          icln_fence_proxy_async();
          icln_cell_issue<Res>(p, grp + gridDim.x, stage + (j ^ 1) * L.sslot, &bar[j ^ 1]);
        }
        icln_cell_scalars(p, grp + gridDim.x, tid, wsm + (j ^ 1) * group,
                          msm + (j ^ 1) * group);
      }
      if (it >= 2) icln_bar_sync(ICLN_BAR_EMPTY + j, nthreads);
      icln_mbar_wait(&bar[j], (unsigned)((it >> 1) & 1));
      const long long cell0 = grp * group;
      const int cells = icln_group_cells(p, grp);
      const bool staged = icln_group_staged<Res>(p, cell0, cells);
      const int chan0 = (int)(cell0 % p.nchan);  // the group's first channel
      T* buf = reinterpret_cast<T*>(stage + j * L.sslot);
      R* cen = cen_base + j * slot_fl;
      const R* wg = wsm + j * group;
      const unsigned char* mg = msm + j * group;
      for (int g = warp; g < cells; g += npw) {
        const long long cell = cell0 + g, arch = BATCH ? cell / p.cpa : 0;
        // a float32 (float64) cube's row is the staged one, or a copy in
        // its place; a bf16 cube's is read where it lies, staged or in
        // device memory
        T* srow = buf + (size_t)g * nbin;
        const T* x = staged ? srow : cube + cell * nbin;
        R* row = kRow ? reinterpret_cast<R*>(srow) : nullptr;
        const IclnTT<R> tt = BATCH ? icln_tt(p, arch) : tt1;
        Res res;
        res.setup(p, cell, (chan0 + g) % p.nchan, arch);
        R tp = R(0), q = R(0);
#pragma unroll 4
        for (int b = lane; b < nbin; b += 32) res.fit(x, row, b, tp, q);
        tp = icln_warp_sum(tp);
        q = icln_warp_sum(q);
        res.finish(tt, wg[g], tp, q);
        R sum = R(0), mx = -INFINITY, mn = INFINITY;
#pragma unroll 4
        for (int b = lane; b < nbin; b += 32) {
          R wres;
          if constexpr (kRow) {
            wres = res.at(srow, b);
            row[b] = wres;
          } else {
            wres = res.at(x, b);
          }
          sum += wres;
          mx = icln_max(mx, wres);
          mn = icln_min(mn, wres);
        }
        sum = icln_warp_sum(sum);
        mx = icln_warp_max(mx);
        mn = icln_warp_min(mn);
        const R mean = sum * p.inv_n;
        const bool m = mg[g] != 0;
        const R centre = m ? R(0) : mean;
        R var = R(0);
#pragma unroll 4
        for (int b = lane; b < nbin; b += 32) {
          R cv;
          if constexpr (kRow) {
            cv = row[b] - centre;
          } else {
            cv = res.at(x, b) - centre;
          }
          cen[(size_t)b * group + g] = cv;
          var += cv * cv;
        }
        var = icln_warp_sum(var);
        if (lane == 0) {
          p.d_mean[cell] = m ? R(0) : mean;
          p.d_ptp[cell] = m ? icln_ma_fill<R>() : mx - mn;
          p.d_std[cell] = m ? R(0) : icln_sqrt(var * p.inv_n);
        }
      }
      icln_bar_arrive(ICLN_BAR_FULL + j, nthreads);
      icln_bar_sync(ICLN_BAR_PRODUCERS, nprod);
    }
  } else {
    // ---- consumers, phase 2: max over k of |DFT(centred row)|^2 as
    // register tiles ----
    const int t = tid - nprod;
    for (long long it = 0; it < nit; ++it) {
      const int j = (int)(it & 1);
      const long long cell0 = (blockIdx.x + it * gridDim.x) * group;
      const int cells = icln_group_cells(p, blockIdx.x + it * gridDim.x);
      if (t < cells) rmax[t] = 0;  // +0: every |X_k|^2 is at least that
      icln_bar_sync(ICLN_BAR_FULL + j, nthreads);
      const R* cen = cen_base + j * slot_fl;
      for (int kc = 0; kc < nkc; ++kc) {
        const int kt0 = kc * per, mc = min(per, ktiles - kt0);
        const bool mine = t < ct * mc;
        const int ctl = t % ct, ktl = t / ct;
        R re[CT][4], im[CT][4];
#pragma unroll
        for (int c = 0; c < CT; ++c)
#pragma unroll
          for (int q = 0; q < 4; ++q) re[c][q] = im[c][q] = R(0);
        for (int bc = 0; bc < nbc; ++bc) {
          const int b0 = bc * bchunk, bn = min(bchunk, nbin - b0);
          if (!resident) {
            icln_bar_sync(ICLN_BAR_CONSUMERS, ncons);
            icln_fill_tables(p, cos_s, sin_s, b0, bn, kt0, mc, t, ncons);
            icln_bar_sync(ICLN_BAR_CONSUMERS, ncons);
          }
          if (mine) {
            const R* tc = cos_s + 4 * ktl;
            const R* ts = sin_s + 4 * ktl;
            const R* cv = cen + (size_t)b0 * group + CT * ctl;
#pragma unroll 8
            for (int b = 0; b < bn; ++b) {
              R v[CT];
              if constexpr (CT == 4) {
                icln_ld4(cv + (size_t)b * group, v);
              } else {
                v[0] = cv[(size_t)b * group];
              }
              R c4[4], s4[4];
              icln_ld4(tc + b * kchunk, c4);
              icln_ld4(ts + b * kchunk, s4);
#pragma unroll
              for (int c = 0; c < CT; ++c) {
                re[c][0] = icln_fma(v[c], c4[0], re[c][0]);
                im[c][0] = icln_fma(v[c], s4[0], im[c][0]);
                re[c][1] = icln_fma(v[c], c4[1], re[c][1]);
                im[c][1] = icln_fma(v[c], s4[1], im[c][1]);
                re[c][2] = icln_fma(v[c], c4[2], re[c][2]);
                im[c][2] = icln_fma(v[c], s4[2], im[c][2]);
                re[c][3] = icln_fma(v[c], c4[3], re[c][3]);
                im[c][3] = icln_fma(v[c], s4[3], im[c][3]);
              }
            }
          }
        }
        if (mine) {
#pragma unroll
          for (int c = 0; c < CT; ++c) {
            R best = R(0);
#pragma unroll
            for (int q = 0; q < 4; ++q)
              best = icln_max(best, re[c][q] * re[c][q] + im[c][q] * im[c][q]);
            const int g = CT * ctl + c;
            if (g < cells) atomicMax(&rmax[g], icln_max_bits(best));
          }
        }
      }
      icln_bar_sync(ICLN_BAR_CONSUMERS, ncons);  // every column folded in
      if (t < cells) p.d_fft[cell0 + t] = icln_sqrt(icln_from_bits(rmax[t]));
      // the producers wait for buffer j only where they will fill it again
      if (it + 2 < nit) icln_bar_arrive(ICLN_BAR_EMPTY + j, nthreads);
      icln_bar_sync(ICLN_BAR_CONSUMERS, ncons);  // rmax is reset next group
    }
  }
}

template <class Res, int CT, bool BATCH>
static cudaError_t icln_cell_stats_start(const CellStatsArgs<typename Res::Real>& p, int threads,
                                         int grid, long long smem_bytes, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(icln_cell_stats_kernel<Res, CT, BATCH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_bytes);
  if (err != cudaSuccess) return err;
  icln_cell_stats_kernel<Res, CT, BATCH><<<grid, threads, (size_t)smem_bytes, stream>>>(p);
  return cudaGetLastError();
}

template <class Res, int CT>
static cudaError_t icln_cell_stats_start(const CellStatsArgs<typename Res::Real>& p, int threads,
                                         int grid, long long smem_bytes, cudaStream_t stream) {
  return p.cpa == p.ncells
             ? icln_cell_stats_start<Res, CT, false>(p, threads, grid, smem_bytes, stream)
             : icln_cell_stats_start<Res, CT, true>(p, threads, grid, smem_bytes, stream);
}

template <class Res>
static int icln_cell_stats_launch(CellStatsArgs<typename Res::Real> p, int ctile, int producers,
                                  int threads, int grid, long long smem_bytes, void* stream) {
  using T = typename Res::Elem;
  const IclnCellLayout L = icln_cell_layout(p.nbin, p.group, p.kchunk, p.bchunk,
                                            (int)sizeof(T), (int)sizeof(typename Res::Real));
  const int ncons = threads - 32 * producers;
  if (L.total > smem_bytes || threads > icln_cell_max_threads<T>() || threads % 32
      || producers < 1 || ncons < 32 || p.group > ncons || p.kchunk % 4 || p.nkp % 4
      || (ctile != 4 && ctile != 1) || p.group % ctile
      || (p.group / ctile) * (p.kchunk / 4) > ncons || p.cpa < 1 || p.ncells % p.cpa
      || p.cpa % p.nchan)
    return (int)cudaErrorInvalidValue;
  p.aligned = (uintptr_t)p.cube % 16 == 0;
  p.producers = producers;
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(ctile == 4 ? icln_cell_stats_start<Res, 4>(p, threads, grid, smem_bytes, st)
                          : icln_cell_stats_start<Res, 1>(p, threads, grid, smem_bytes, st));
}

// The entries' arguments: every pointer but the cubes' is of the
// arithmetic type R (float for float32 and bf16 cubes, double for float64
// ones); inv_n is float32(1/nbin) for float, 1/nbin for double.
template <class R>
static CellStatsArgs<R> icln_cell_stats_args(
    const unsigned char* mask, const void* w, const void* cos_t, const void* sin_t,
    const void* tt, void* d_std, void* d_mean, void* d_ptp, void* d_fft, long long ncells,
    long long cpa, int nchan, int nbin, int group, int kchunk, int bchunk, int nkp,
    double inv_n) {
  CellStatsArgs<R> p = {};
  p.w = static_cast<const R*>(w);
  p.mask = mask;
  p.cos_t = static_cast<const R*>(cos_t);
  p.sin_t = static_cast<const R*>(sin_t);
  p.tt = static_cast<const R*>(tt);
  p.d_std = static_cast<R*>(d_std);
  p.d_mean = static_cast<R*>(d_mean);
  p.d_ptp = static_cast<R*>(d_ptp);
  p.d_fft = static_cast<R*>(d_fft);
  p.ncells = ncells;
  p.cpa = cpa;
  p.nchan = nchan;
  p.nbin = nbin;
  p.group = group;
  p.kchunk = kchunk;
  p.bchunk = bchunk;
  p.nkp = nkp;
  p.inv_n = (R)inv_n;
  return p;
}
