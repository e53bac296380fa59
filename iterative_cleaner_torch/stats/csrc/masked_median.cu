// K9: the masked median along one axis of a 2-D float32 tensor.
//
// Replaces iterative_cleaner_tpu/stats/pallas_kernels.py
// masked_median_pallas (launched through _median_axis0, body
// _median_kernel -> _masked_median_lanes -> _select_adjacent ->
// _select_kth): per line, np.ma.median of the entries whose mask is
// False.  Masked entries take the key of +inf (0x7F800000) and stay in
// the population, NaN sorts above +inf and -0 below +0 (the reference's
// _ordered_key); k_lo = max(n-1, 0)/2 and k_hi = n/2 over the n valid
// entries, the k_hi-th key equal to the k_lo-th when more than k_hi keys
// lie at or below it and the smallest key above it otherwise; the
// median 0.5f*(lo+hi), and 0.0 for a line with no valid entry.  The
// select is exact, so the result is bit-equal to the reference's.
//
// Bound: bytes.  One read of the values and the mask, 5 bytes an entry:
// 21.0 MB for the residual-std telemetry's one line of 4,194,304 cells
// (1024 x 4096), 6.3 us at 3.35 TB/s.
//
// Design: the radix select of common.cuh (four 8-bit passes over the
// keys as unsigned, key ^ 0x80000000, one warp scanning each line's 256
// bins with a shuffle scan and a ballot; the upper middle from the last
// pass's bins or the least key above its bucket, so no successor pass),
// by one of two routes (stats.kernels.masked_median_geometry):
// - block: lines of up to 4096 entries, W of them a block (W = 8 along
//   dim 0, where a line is a column and a warp then reads 32-byte row
//   segments; 1 along dim 1), their keys made once into shared memory and
//   selected in one chain by icln_block_select.  One launch.
// - grid: longer lines spread over blocks of 4096 entries (the
//   telemetry's line takes 1024; a block cannot hold its 16.8 MB of
//   keys).  A pass is one launch: each warp of a block counts its digits
//   into its own 256 shared bins, and the block adds their sums to the
//   line's int32 bins in device memory with integer atomics, exact in any
//   order; then, after a __threadfence, the block that takes the line's
//   last ticket (an int atomicAdd) picks the digit with the warp scan,
//   clearing the bins as it reads them (atomicExch).  Pass 3's last block
//   also forms the median.  Four launches (and the memset of the
//   scratch), against ten, with a thread a line walking the bins serially,
//   before this design.  The state (prefix, rank, counts) stays in device
//   memory between launches: no host round trip.
// Every thread issues the loads of four entries before it uses any.  A
// line is (start, stride) into the tensor as it lies: no transposed copy
// is made.
//
// float64 values (dtype="float64"; the reference's float64 route is its
// XLA sort) take the same kernels over 64-bit keys (icln_ordered_key of
// a double, the masked key +inf's, 0x7FF0000000000000): eight passes a
// select, so the grid route is the memset and eight launches, its
// integer-atomic histograms counted once a pass; the block route's keys
// take 8 bytes each in shared memory, so along dim 0 fewer lines a block
// fit (stats.kernels.masked_median_geometry).  Bound: 9 bytes an entry.

#include "common.cuh"

template <class T>
struct IclnMmLines {
  const T* vals;
  const unsigned char* mask;
  int n;                  // entries per line
  int chunk;              // entries per block (grid route)
  int bpl;                // blocks per line (grid route)
  long long line_stride;  // elements between the starts of two lines
  long long elem_stride;  // elements between two entries of a line
};

// The keys of entries e + j * step of a line (j < ICLN_LOAD_BATCH), all
// loads issued before any is used; an entry at or past e1 gets the
// lowest key and counts as masked.  Masked entries take +inf's key.
template <class T>
__device__ __forceinline__ void icln_mm_keys(const IclnMmLines<T>& L, long long base, int e,
                                             int step, int e1,
                                             typename IclnKeys<T>::Key (&key)[ICLN_LOAD_BATCH],
                                             bool (&masked)[ICLN_LOAD_BATCH]) {
  using IK = IclnKeys<T>;
  T v[ICLN_LOAD_BATCH];
#pragma unroll
  for (int j = 0; j < ICLN_LOAD_BATCH; ++j) {
    const int ej = e + j * step;
    const long long off = base + (long long)ej * L.elem_stride;
    masked[j] = ej >= e1 || L.mask[off] != 0;
    v[j] = ej < e1 ? L.vals[off] : T(0);
  }
#pragma unroll
  for (int j = 0; j < ICLN_LOAD_BATCH; ++j)
    key[j] = e + j * step >= e1 ? IK::kLowest : masked[j] ? IK::kMasked : IK::key(v[j]);
}

// ---- block route: W lines a block, one launch ----

template <class T>
__global__ void __launch_bounds__(1024)
    icln_mm_block_kernel(IclnMmLines<T> L, int nlines, int W, T* __restrict__ out) {
  using Key = typename IclnKeys<T>::Key;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ IclnSelState<T> st;
  const int ls = icln_key_stride(L.n);
  Key* keys = reinterpret_cast<Key*>(smem_raw);
  int* hist = reinterpret_cast<int*>(keys + W * ls);
  for (int i = threadIdx.x; i < W * 256; i += blockDim.x) hist[i] = 0;
  if (threadIdx.x < W) {
    st.nv[threadIdx.x] = 0;
    st.moff[threadIdx.x] = -1;  // the keys hold the mask (the masked key)
  }
  __syncthreads();
  const int c = threadIdx.x & (W - 1);
  const long long line = (long long)blockIdx.x * W + c;
  const bool live = line < nlines;
  const long long base = line * L.line_stride;
  int valid = 0;
  const int rstep = blockDim.x / W;
  for (int rb = threadIdx.x / W; rb < L.n; rb += ICLN_LOAD_BATCH * rstep) {
    Key key[ICLN_LOAD_BATCH];
    bool masked[ICLN_LOAD_BATCH];
    icln_mm_keys(L, base, rb, rstep, live ? L.n : 0, key, masked);
#pragma unroll
    for (int j = 0; j < ICLN_LOAD_BATCH; ++j) {
      const int r = rb + j * rstep;
      if (r >= L.n) break;
      keys[c * ls + r] = live ? key[j] : Key(0);
      valid += !masked[j];
    }
  }
  icln_lines_add(valid, W, st.nv);
  __syncthreads();
  icln_block_select<T>(keys, L.n, W, hist, nullptr, st);
  if (threadIdx.x < W && (long long)blockIdx.x * W + threadIdx.x < nlines)
    out[(long long)blockIdx.x * W + threadIdx.x] = icln_sel_median(st, threadIdx.x);
}

// ---- grid route: a line over bpl blocks, a launch a pass ----

template <class T>
struct IclnMmState {
  using Key = typename IclnKeys<T>::Key;
  using Radix = typename IclnKeys<T>::Radix;
  int* hist;      // 256 bins a line
  int* nvalid;    // valid entries a line
  int* ticket;    // blocks of the line done with the current launch
  int* krem;      // rank left inside the prefix's bucket
  Key* above;     // least key above the last pass's bucket
  Radix* prefix;  // digits of lo found so far
};

// After a block's atomics: true in the block that finished the line's
// launch last (its ticket resets for the next launch).
template <class T>
__device__ __forceinline__ bool icln_mm_last_block(const IclnMmState<T>& S, int line, int bpl) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(&S.ticket[line], 1) == bpl - 1;
    if (last) S.ticket[line] = 0;
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

#define ICLN_MM_GRID_WARPS 8  // the grid route's blocks: 256 threads

__device__ __forceinline__ long long icln_block_reduce_min(long long v, int* red, int& parity) {
  // the int64 minimum as two exact int32 reductions: the high words, then
  // the low words (as unsigned order) of the entries holding the least high
  const int hi = icln_block_reduce_int<ICLN_MIN>((int)(v >> 32), red, parity);
  const unsigned lo = (int)(v >> 32) == hi ? (unsigned)v : 0xffffffffu;
  const int lo_m = icln_block_reduce_int<ICLN_MIN>((int)(lo ^ 0x80000000u), red, parity);
  return ((long long)hi << 32) | (unsigned)((unsigned)lo_m ^ 0x80000000u);
}

__device__ __forceinline__ int icln_block_reduce_min(int v, int* red, int& parity) {
  return icln_block_reduce_int<ICLN_MIN>(v, red, parity);
}

// Pass PASS: the histogram of the digit at shift 8 * (kPasses - 1 - PASS)
// over the keys whose higher digits equal the line's prefix (pass 0:
// every key, and the valid count; the last pass: also the least key above
// the bucket), each warp into its own 256 shared bins, their sums added
// to the line's bins in device memory; then the last block's pick, which
// after the last pass takes the least key above lo and writes the median.
template <class T, int PASS>
__global__ void icln_mm_pass_kernel(IclnMmLines<T> L, IclnMmState<T> S, T* __restrict__ out) {
  using IK = IclnKeys<T>;
  using Key = typename IK::Key;
  using Radix = typename IK::Radix;
  constexpr int kLast = IK::kPasses - 1;
  __shared__ int bins[ICLN_MM_GRID_WARPS][256];
  __shared__ int red[64];
  const int shift = 8 * (kLast - PASS);
  const int line = blockIdx.x / L.bpl;
  const int e0 = (blockIdx.x - line * L.bpl) * L.chunk;
  const int e1 = min(L.n, e0 + L.chunk);
  const long long base = (long long)line * L.line_stride;
  for (int i = threadIdx.x; i < ICLN_MM_GRID_WARPS * 256; i += blockDim.x) (&bins[0][0])[i] = 0;
  __syncthreads();
  int* wbins = bins[threadIdx.x >> 5];
  const Radix want = PASS == 0 ? (Radix)0 : S.prefix[line];
  const int lane = threadIdx.x & 31;
  int valid = 0;
  Key above = IK::kHighest;
  for (int eb = e0 + threadIdx.x; eb < e1; eb += ICLN_LOAD_BATCH * blockDim.x) {
    Key key[ICLN_LOAD_BATCH];
    bool masked[ICLN_LOAD_BATCH];
    icln_mm_keys(L, base, eb, blockDim.x, e1, key, masked);
#pragma unroll
    for (int j = 0; j < ICLN_LOAD_BATCH; ++j) {
      if (eb + j * blockDim.x >= e1) break;
      const Radix u = IK::radix(key[j]);
      valid += !masked[j];
      if (PASS == 0 || (u >> (shift + 8)) == want)
        atomicAdd(&wbins[(unsigned)(u >> shift) & 255u], 1);
      else if (PASS == kLast && (u >> 8) > want)
        above = min(above, key[j]);
    }
  }
  __syncthreads();
  int* h = S.hist + (long long)line * 256;
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    int sum = 0;
    for (int w = 0; w < ICLN_MM_GRID_WARPS; ++w) sum += bins[w][i];
    if (sum) atomicAdd(&h[i], sum);
  }
  int parity = 0;
  if (PASS == 0) {
    valid = icln_block_reduce_int<ICLN_SUM>(valid, red, parity);
    if (threadIdx.x == 0 && valid) atomicAdd(&S.nvalid[line], valid);
  }
  if (PASS == kLast) {
    above = icln_block_reduce_min(above, red, parity);
    if (threadIdx.x == 0 && above != IK::kHighest) atomicMin(&S.above[line], above);
  }
  if (!icln_mm_last_block(S, line, L.bpl) || threadIdx.x >= 32) return;
  int b[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) b[i] = atomicExch(&h[8 * lane + i], 0);
  const int nv = __ldcg(&S.nvalid[line]);
  const int k = PASS == 0 ? icln_sel_klo(nv) : S.krem[line];
  const IclnPick p = icln_warp_pick(b, k);
  if (PASS < kLast) {
    if (lane == 0) {
      S.krem[line] = k - p.below;
      S.prefix[line] = PASS == 0 ? (Radix)p.digit : (want << 8) | (Radix)p.digit;
      if (PASS == kLast - 1) S.above[line] = IK::kHighest;
    }
    return;
  }
  // lo, and hi where more than k_hi keys lie at or below lo, else the
  // least key above lo (K3's icln_sel_median)
  const Radix succ = icln_successor_radix<Radix>(b, p.digit, want,
                                                 IK::radix(__ldcg(&S.above[line])));
  if (lane == 0) {
    const Key lo = IK::from_radix((want << 8) | (Radix)p.digit);
    const int count_le = icln_sel_klo(nv) - (k - p.below) + p.count;
    const bool need = nv > 0 && count_le <= nv / 2;
    out[line] = icln_sel_median_of<T>(lo, need ? IK::from_radix(succ) : lo, nv);
  }
}

template <class T, int PASS>
static cudaError_t icln_mm_passes(const IclnMmLines<T>& L, const IclnMmState<T>& S, T* out,
                                  unsigned grid, unsigned threads, cudaStream_t s) {
  icln_mm_pass_kernel<T, PASS><<<grid, threads, 0, s>>>(L, S, out);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if constexpr (PASS + 1 < IclnKeys<T>::kPasses)
    return icln_mm_passes<T, PASS + 1>(L, S, out, grid, threads, s);
  return cudaSuccess;
}

template <class T>
static int icln_masked_median_t(const void* vals, const unsigned char* mask, void* out,
                                int* scratch, int n, int nlines, long long line_stride,
                                long long elem_stride, int chunk, int bpl, int lines,
                                int threads, long long smem_bytes, cudaStream_t s) {
  using Key = typename IclnKeys<T>::Key;
  using Radix = typename IclnKeys<T>::Radix;
  const IclnMmLines<T> L{static_cast<const T*>(vals), mask, n, chunk, bpl, line_stride,
                         elem_stride};
  T* o = static_cast<T*>(out);
  cudaError_t err;
  if (bpl == 1) {
    if (lines < 1 || lines > 8 || (lines & (lines - 1)) || threads % 32 || threads > 1024)
      return (int)cudaErrorInvalidConfiguration;
    err = cudaFuncSetAttribute(icln_mm_block_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
    if (err != cudaSuccess) return (int)err;
    icln_mm_block_kernel<T><<<(nlines + lines - 1) / lines, threads, (size_t)smem_bytes, s>>>(
        L, nlines, lines, o);
    return (int)cudaGetLastError();
  }
  IclnMmState<T> S;
  S.hist = scratch;
  S.nvalid = S.hist + (long long)nlines * 256;
  S.ticket = S.nvalid + nlines;
  S.krem = S.ticket + nlines;
  const size_t kw = sizeof(Key) / sizeof(int);
  const size_t wide = ((size_t)nlines * 259 + kw - 1) / kw * kw;
  S.above = reinterpret_cast<Key*>(scratch + wide);
  S.prefix = reinterpret_cast<Radix*>(scratch + wide + kw * (size_t)nlines);
  const long long blocks = (long long)nlines * bpl;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  const unsigned grid = (unsigned)blocks, threads_g = 32 * ICLN_MM_GRID_WARPS;
  // the bins, the valid counts and the tickets start at zero
  err = cudaMemsetAsync(scratch, 0, sizeof(int) * (size_t)nlines * 258, s);
  if (err != cudaSuccess) return (int)err;
  return (int)icln_mm_passes<T, 0>(L, S, o, grid, threads_g, s);
}

// Block route (bpl == 1): `lines` (W) lines a block of `threads` threads
// and smem_bytes of dynamic shared memory; scratch unused.  Grid route:
// scratch is int32 [nlines * 256 bins | nvalid | ticket | krem | above |
// prefix] (above and prefix in the keys' width, 8-byte aligned), the
// wrapper's allocation (stats.kernels._median_scratch_ints entries).
// f64: float64 values (double), else float32.
extern "C" int icln_masked_median(const void* vals, const unsigned char* mask, void* out,
                                  int* scratch, int n, int nlines, long long line_stride,
                                  long long elem_stride, int chunk, int bpl, int lines,
                                  int threads, long long smem_bytes, int f64, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return f64 ? icln_masked_median_t<double>(vals, mask, out, scratch, n, nlines, line_stride,
                                            elem_stride, chunk, bpl, lines, threads,
                                            smem_bytes, s)
             : icln_masked_median_t<float>(vals, mask, out, scratch, n, nlines, line_stride,
                                           elem_stride, chunk, bpl, lines, threads, smem_bytes,
                                           s);
}
