// K3 on lines longer than one block holds: one scaler orientation for
// all four diagnostics, one thread-block cluster a line.
//
// Replaces iterative_cleaner_tpu/stats/pallas_kernels.py
// _scaled_sides_body (scaled_sides_pallas, :433) on lines over
// LONGEST_BLOCK_LINE entries (LONGEST_BLOCK_LINE_F64 for float64 planes):
// per line, the exact masked median, centring, the MAD, then the
// _masked_side epilogue for std, mean and ptp, and for the rFFT
// diagnostic the NaN-line patch and |c / mad| * float32(1/thresh) — K3's
// function (scaled_sides.cu), which holds a whole line in one block's
// shared memory at 5 bytes an entry against 232,448.  Up to the cluster's
// capacity (stats.kernels.scaled_sides_cluster_capacity) this kernel
// takes the place of the long-line composition (two K9 grid selects a
// diagnostic around side_centre and side_scale, 48 device operations an
// orientation and about 248 bytes a cell), which stays for longer lines.
//
// Bound: bytes, as K3: four planes and the bool mask in, four planes out
// (33 bytes a cell in float32, 65 in float64); the selects are integer
// work on data in shared memory.
//
// Design: a cluster of C blocks (2, 4 or 8: portable sizes; no
// non-portable 16) takes W adjacent lines (along axis 0, where a line is
// a column: the most of 8, 4, 2, 1 that fit, so that a warp reads row
// segments of W entries; W = 1 along axis 1) and D of the four
// diagnostics at a time (4 / D turns).  Block r of the cluster holds
// entries [r * slice, (r + 1) * slice) of each of its W lines, as keys in
// its dynamic shared memory with the lines' mask as bits, the way K3
// holds whole lines.  The select is common.cuh's radix select cut in two
// at each pass: every block counts its keys' digits into its own 256
// bins a line (int32 shared atomics), the non-leader blocks add their
// bins into the leader's through distributed shared memory (integer
// atomics: exact in any order), cluster.sync(), one warp of the leader
// scans each line's bins (common.cuh's icln_warp_pick) and writes the
// digit, the rank left, the count and the successor into every block's
// select state, cluster.sync().  As in K3 the upper middle comes from
// the last pass's bins and the least radix above the bucket (each
// block's minimum, read by the leader), with no successor pass; masked
// entries key as +inf, NaN above +inf, -0 below +0.  The valid counts
// and the rFFT diagnostic's NaN flags are summed (or'ed) over the
// cluster's blocks the same way.  After the medians each block rewrites
// its slice's unmasked keys in place as the keys of |centred|, the
// second select gives the MADs, and the epilogue writes the sides: the
// planes are read once and written once.  Every float op repeats K3's
// sequence, so the sides are bit-equal to K3's and to the plain version.
// Per pass: two cluster barriers and one block barrier; per select 8
// (float32) or 16 (float64) cluster barriers.
//
// A batch of (B, nsub, nchan) planes is one launch, lines addressed in
// place through K3's lpa / archive_stride scheme (scaled_sides.cu): line
// l starts at (l / lpa) * archive_stride + (l % lpa) * line_stride.  A
// cluster's W lines may straddle two archives; each line's select is its
// own, so every archive's sides are bit-equal to a launch on it alone.
//
// float64 planes: the same kernel over double values and 64-bit keys
// (eight passes a select, 8 bytes a key in shared memory).
//
// The launch (cudaLaunchKernelEx with the cluster-dimension attribute)
// first asks cudaOccupancyMaxActiveClusters whether such a cluster fits
// an SM group at the plan's shared memory, and returns
// cudaErrorLaunchOutOfResources where it does not; the wrapper raises on
// any error, and never falls back to another route.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

#define ICLN_CLUSTER_MAX 8   // portable cluster size

// common.cuh's block select over this block's slice of M lines (sn keys
// of each, line m at keys + m * ls), the counts of every block of the
// cluster summed into the leader's (rank 0's) bins.  Call with st.nv set
// to the lines' valid entries over the whole cluster, hist zero and a
// barrier after them; returns with hist zero again and
// icln_sel_median(st, m) readable by every thread of every block.
template <class T>
__device__ inline void icln_cluster_select(cg::cluster_group& cluster,
                                           const typename IclnKeys<T>::Key* keys, int sn, int ls,
                                           int M, int* hist, const unsigned* mbits,
                                           IclnSelState<T>& st) {
  using IK = IclnKeys<T>;
  using Key = typename IK::Key;
  using Radix = typename IK::Radix;
  constexpr int kPasses = IK::kPasses;
  constexpr Radix kNone = ~(Radix)0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const unsigned rank = cluster.block_rank();
  const int C = (int)cluster.num_blocks();
  int* lead_hist = cluster.map_shared_rank(hist, 0);
  const int cpl = (sn + ICLN_SEL_CHUNK - 1) / ICLN_SEL_CHUNK;  // chunks a line
  for (int pass = 0; pass < kPasses; ++pass) {
    const int shift = 8 * (kPasses - 1 - pass);
    const bool last = pass == kPasses - 1;
    for (int it = warp; it < M * cpl; it += nwarps) {
      const int m = it / cpl;
      const int e = (it - m * cpl) * ICLN_SEL_CHUNK + 8 * lane;
      const int lim = min(8, sn - e);
      const Radix want = st.prefix[m];
      int* h = hist + m * 256;
      Radix above = kNone;
      if (lim > 0) {
        Key q[8];
        icln_load8(keys + m * ls + e, q);
        if (st.moff[m] >= 0) {
          const unsigned bits = (mbits[st.moff[m] + (e >> 5)] >> (e & 31)) & 255u;
          if (bits) {
#pragma unroll
            for (int j = 0; j < 8; ++j)
              if ((bits >> j) & 1u) q[j] = IK::kMasked;
          }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (j >= lim) break;
          const Radix u = IK::radix(q[j]);
          if (pass == 0 || (u >> (shift + 8)) == want)
            atomicAdd(&h[(unsigned)(u >> shift) & 255u], 1);
          else if (last && (u >> 8) > want)
            above = min(above, u);
        }
      }
      if (last) {
        for (int o = 16; o > 0; o >>= 1) above = min(above, __shfl_xor_sync(ICLN_FULL, above, o));
        if (lane == 0 && above != kNone) atomicMin(&st.above[m], above);
      }
    }
    __syncthreads();
    // the other blocks' bins into the leader's
    if (rank != 0) {
      for (int i = threadIdx.x; i < M * 256; i += blockDim.x) {
        const int v = hist[i];
        if (v) {
          atomicAdd(lead_hist + i, v);
          hist[i] = 0;
        }
      }
    }
    cluster.sync();
    if (rank == 0) {
      for (int m = warp; m < M; m += nwarps) {
        int* h = hist + m * 256 + 8 * lane;
        int b[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) b[i] = h[i];
#pragma unroll
        for (int i = 0; i < 8; ++i) h[i] = 0;
        const int k = pass == 0 ? icln_sel_klo(st.nv[m]) : st.krem[m];
        const IclnPick p = icln_warp_pick(b, k);
        Radix succ = 0;
        if (last) {
          // the least radix above the bucket, over the cluster's blocks
          Radix above = lane < C ? cluster.map_shared_rank(&st, lane)->above[m] : kNone;
          for (int o = 16; o > 0; o >>= 1)
            above = min(above, __shfl_xor_sync(ICLN_FULL, above, o));
          succ = icln_successor_radix<Radix>(b, p.digit, st.prefix[m], above);
        }
        const Radix prefix =
            pass == 0 ? (Radix)p.digit : (st.prefix[m] << 8) | (Radix)p.digit;
        __syncwarp();
        if (lane < C) {
          IclnSelState<T>* s = cluster.map_shared_rank(&st, lane);
          s->krem[m] = k - p.below;
          s->prefix[m] = prefix;
          s->clast[m] = p.count;
          s->above[m] = kNone;
          s->succ[m] = IK::from_radix(succ);
        }
      }
    }
    cluster.sync();
  }
}

template <class T, int D>
__global__ void __launch_bounds__(1024)
    icln_sides_cluster_kernel(const T* __restrict__ d0, const T* __restrict__ d1,
                              const T* __restrict__ d2, const T* __restrict__ d3,
                              const unsigned char* __restrict__ mask, T* __restrict__ o0,
                              T* __restrict__ o1, T* __restrict__ o2, T* __restrict__ o3,
                              int n, int slice, int nlines, long long line_stride,
                              long long elem_stride, long long lpa, long long archive_stride,
                              int W, T inv_t) {
  using IK = IclnKeys<T>;
  using Key = typename IK::Key;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ IclnSelState<T> st;
  // per line of the block: this block's slice's counts (read by the
  // cluster's other blocks), and the cluster's totals
  __shared__ int nvalid[8], nan_in[8], nan_abs[8];
  __shared__ int nv_all[8], nan_in_all[8], nan_abs_all[8];
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int M = W * D;
  const int ls = icln_key_stride(slice);  // line m = d * W + c at keys + m * ls
  const int nw = (slice + 31) >> 5;        // mask words a line
  const int sn = max(0, min(slice, n - rank * slice));  // this block's entries a line
  Key* keys = reinterpret_cast<Key*>(smem_raw);
  int* hist = reinterpret_cast<int*>(keys + M * ls);
  unsigned* mbits = reinterpret_cast<unsigned*>(hist + M * 256);
  for (int i = threadIdx.x; i < M * 256; i += blockDim.x) hist[i] = 0;
  for (int i = threadIdx.x; i < W * nw; i += blockDim.x) mbits[i] = 0u;
  if (threadIdx.x < 8) nvalid[threadIdx.x] = nan_in[threadIdx.x] = nan_abs[threadIdx.x] = 0;
  __syncthreads();

  // thread t works on line c = t % W of the cluster's W lines, entries
  // r = t / W + j * (threads / W) of this block's slice
  const int c = threadIdx.x & (W - 1);
  const int r0 = threadIdx.x / W, rstep = blockDim.x / W;
  const long long line = (long long)(blockIdx.x / C) * W + c;
  const bool live = line < nlines;  // the ragged last cluster
  const long long base = (line / lpa) * archive_stride + (line % lpa) * line_stride +
                         (long long)rank * slice * elem_stride;
  unsigned* mb = mbits + c * nw;

  const T* const ins[4] = {d0, d1, d2, d3};
  T* const outs[4] = {o0, o1, o2, o3};
  for (int g = 0; g < 4; g += D) {
    if (g) __syncthreads();
    const bool plain = g + D > 3;  // the group holds the rFFT diagnostic
    if (threadIdx.x < M) {
      const int m = threadIdx.x;
      st.moff[m] = g + m / W == 3 ? -1 : (m % W) * nw;
    }
    int valid = 0, nan_v = 0;
    for (int rb = r0; rb < sn; rb += ICLN_LOAD_BATCH * rstep) {
      T v[ICLN_LOAD_BATCH][D];
      bool mk[ICLN_LOAD_BATCH];
#pragma unroll
      for (int j = 0; j < ICLN_LOAD_BATCH; ++j) {
        const int r = rb + j * rstep;
        const bool in = live && r < sn;
        const long long off = base + (long long)r * elem_stride;
        mk[j] = g == 0 && (!in || mask[off]);
#pragma unroll
        for (int d = 0; d < D; ++d) v[j][d] = in ? ins[g + d][off] : T(0);
      }
#pragma unroll
      for (int j = 0; j < ICLN_LOAD_BATCH; ++j) {
        const int r = rb + j * rstep;
        if (r >= sn) break;
        if (g == 0) {
          if (mk[j]) atomicOr(&mb[r >> 5], 1u << (r & 31));
          valid += live && !mk[j];
        }
#pragma unroll
        for (int d = 0; d < D; ++d) {
          keys[(d * W + c) * ls + r] = live ? IK::key(v[j][d]) : Key(0);
          if (g + d == 3) nan_v |= icln_isnan(v[j][d]);
        }
      }
    }
    if (g == 0) icln_lines_add(valid, W, nvalid);
    if (plain) icln_lines_or(nan_v, W, nan_in);
    if (g == 0 || plain) {
      // every block's counts are in: the cluster's totals
      cluster.sync();
      if (threadIdx.x < W) {
        int s = 0, o = 0;
        for (int q = 0; q < C; ++q) {
          if (g == 0) s += cluster.map_shared_rank(&nvalid[0], q)[threadIdx.x];
          if (plain) o |= cluster.map_shared_rank(&nan_in[0], q)[threadIdx.x];
        }
        if (g == 0) nv_all[threadIdx.x] = s;
        if (plain) nan_in_all[threadIdx.x] = o;
      }
    }
    __syncthreads();
    if (threadIdx.x < M) {
      const int m = threadIdx.x;
      st.nv[m] = g + m / W == 3 ? n : nv_all[m % W];  // read at the first pick
    }

    // round 1: the medians; then each unmasked key becomes |centred|'s
    icln_cluster_select<T>(cluster, keys, sn, ls, M, hist, mbits, st);
    T med[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      med[d] = icln_sel_median(st, d * W + c);
      if (g + d == 3 && nan_in_all[c]) med[d] = icln_nan_of<T>();
    }
    int nan_a = 0;
#pragma unroll 2
    for (int r = r0; r < sn; r += rstep) {
      const bool masked = (mb[r >> 5] >> (r & 31)) & 1u;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const int i = g + d;
        if (i < 3 && masked) continue;  // masked entries pass through
        Key* kp = keys + (d * W + c) * ls + r;
        const T a = icln_abs(IK::value(*kp) - med[d]);
        *kp = IK::key(a);
        if (i == 3) nan_a |= icln_isnan(a);
      }
    }
    if (plain) icln_lines_or(nan_a, W, nan_abs);
    __syncthreads();

    // round 2: the MADs (its cluster barriers order every block's
    // nan_abs before the reads below); then the sides
    icln_cluster_select<T>(cluster, keys, sn, ls, M, hist, mbits, st);
    if (plain) {
      if (threadIdx.x < W) {
        int o = 0;
        for (int q = 0; q < C; ++q) o |= cluster.map_shared_rank(&nan_abs[0], q)[threadIdx.x];
        nan_abs_all[threadIdx.x] = o;
      }
      __syncthreads();
    }
    if (!live) continue;
    T mad[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      mad[d] = icln_sel_median(st, d * W + c);
      if (g + d == 3 && nan_abs_all[c]) mad[d] = icln_nan_of<T>();
    }
    const bool empty = nv_all[c] == 0;
#pragma unroll 2
    for (int r = r0; r < sn; r += rstep) {
      const bool masked = (mb[r >> 5] >> (r & 31)) & 1u;
      const long long off = base + r * elem_stride;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const int i = g + d;
        // |centred|, or a masked entry's value (it passes through)
        const T a = IK::value(keys[(d * W + c) * ls + r]);
        T out;
        if (i == 3) {
          out = icln_abs(a / mad[d]) * inv_t;
        } else if (masked) {
          out = icln_abs(a);  // _masked_side: undivided
        } else {
          // _masked_side: zero-MAD / empty lines go dead, data undivided
          const bool line_dead = (mad[d] == T(0)) || empty;
          const T safe_mad = line_dead ? T(1) : mad[d];
          const T mag = line_dead ? a : icln_abs(a / safe_mad);
          out = line_dead ? mag : mag * inv_t;
        }
        outs[i][off] = out;
      }
    }
  }
  // no block leaves while another may still read its shared memory
  cluster.sync();
}

template <class T, int D>
static int icln_sides_cluster_launch(const void* const* d, const unsigned char* mask,
                                     void* const* o, int n, int slice, int nlines,
                                     long long line_stride, long long elem_stride, long long lpa,
                                     long long archive_stride, double inv_t, int cluster,
                                     int lines, int threads, long long smem_bytes,
                                     cudaStream_t stream) {
  void (*kernel)(const T*, const T*, const T*, const T*, const unsigned char*, T*, T*, T*, T*,
                 int, int, int, long long, long long, long long, long long, int, T) =
      icln_sides_cluster_kernel<T, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
  if (err != cudaSuccess) return (int)icln_take_error(err);
  const int clusters = (nlines + lines - 1) / lines;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(clusters * cluster));
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = (size_t)smem_bytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // a cluster of this size at this shared memory must fit an SM group
  int active = 0;
  err = cudaOccupancyMaxActiveClusters(&active, kernel, &cfg);
  if (err != cudaSuccess) return (int)icln_take_error(err);
  if (active < 1) return (int)cudaErrorLaunchOutOfResources;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(d[0]),
                           static_cast<const T*>(d[1]), static_cast<const T*>(d[2]),
                           static_cast<const T*>(d[3]), mask, static_cast<T*>(o[0]),
                           static_cast<T*>(o[1]), static_cast<T*>(o[2]), static_cast<T*>(o[3]),
                           n, slice, nlines, line_stride, elem_stride, lpa, archive_stride, lines,
                           (T)inv_t);
  if (err != cudaSuccess) return (int)icln_take_error(err);
  return (int)cudaGetLastError();
}

template <class T>
static int icln_sides_cluster_diags(const void* const* d, const unsigned char* mask,
                                    void* const* o, int n, int slice, int nlines,
                                    long long line_stride, long long elem_stride, long long lpa,
                                    long long archive_stride, double inv_t, int cluster,
                                    int lines, int diags, int threads, long long smem_bytes,
                                    cudaStream_t s) {
  switch (diags) {
    case 4:
      return icln_sides_cluster_launch<T, 4>(d, mask, o, n, slice, nlines, line_stride,
                                             elem_stride, lpa, archive_stride, inv_t, cluster,
                                             lines, threads, smem_bytes, s);
    case 2:
      return icln_sides_cluster_launch<T, 2>(d, mask, o, n, slice, nlines, line_stride,
                                             elem_stride, lpa, archive_stride, inv_t, cluster,
                                             lines, threads, smem_bytes, s);
    case 1:
      return icln_sides_cluster_launch<T, 1>(d, mask, o, n, slice, nlines, line_stride,
                                             elem_stride, lpa, archive_stride, inv_t, cluster,
                                             lines, threads, smem_bytes, s);
    default:
      return (int)cudaErrorInvalidConfiguration;
  }
}

// cluster: C (2 to ICLN_CLUSTER_MAX), slice: the entries of a line one
// block holds (a multiple of 32, C * slice >= n), lines: W (1, 2, 4 or
// 8), diags: D (1, 2 or 4); threads a multiple of 32.  f64: the planes
// are float64 (double), else float32; inv_t is the threshold's reciprocal
// in the planes' type (a float32 value for them).
extern "C" int icln_sides_cluster(const void* d0, const void* d1, const void* d2,
                                  const void* d3, const unsigned char* mask, void* o0,
                                  void* o1, void* o2, void* o3, int n, int slice, int nlines,
                                  long long line_stride, long long elem_stride, long long lpa,
                                  long long archive_stride, double inv_t, int cluster,
                                  int lines, int diags, int threads, long long smem_bytes,
                                  int f64, void* stream) {
  if (cluster < 2 || cluster > ICLN_CLUSTER_MAX || slice < 32 || slice % 32 ||
      (long long)cluster * slice < n || lines < 1 || lines > 8 || (lines & (lines - 1)) ||
      diags * lines > ICLN_SEL_LINES || threads % 32 || threads > 1024 || lpa < 1 ||
      nlines % lpa)
    return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = (cudaStream_t)stream;
  const void* const d[4] = {d0, d1, d2, d3};
  void* const o[4] = {o0, o1, o2, o3};
  return f64 ? icln_sides_cluster_diags<double>(d, mask, o, n, slice, nlines, line_stride,
                                                elem_stride, lpa, archive_stride, inv_t, cluster,
                                                lines, diags, threads, smem_bytes, s)
             : icln_sides_cluster_diags<float>(d, mask, o, n, slice, nlines, line_stride,
                                               elem_stride, lpa, archive_stride, inv_t, cluster,
                                               lines, diags, threads, smem_bytes, s);
}
