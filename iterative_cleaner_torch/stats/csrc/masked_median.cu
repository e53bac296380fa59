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

#include "common.cuh"

struct IclnMmLines {
  const float* vals;
  const unsigned char* mask;
  int n;                  // entries per line
  int chunk;              // entries per block (grid route)
  int bpl;                // blocks per line (grid route)
  long long line_stride;  // elements between the starts of two lines
  long long elem_stride;  // elements between two entries of a line
};

// The keys of entries e + j * step of a line (j < ICLN_LOAD_BATCH), all
// loads issued before any is used; an entry at or past e1 gets
// INT_MIN and counts as masked.  Masked entries take +inf's key.
__device__ __forceinline__ void icln_mm_keys(const IclnMmLines& L, long long base, int e,
                                             int step, int e1, int (&key)[ICLN_LOAD_BATCH],
                                             bool (&masked)[ICLN_LOAD_BATCH]) {
  float v[ICLN_LOAD_BATCH];
#pragma unroll
  for (int j = 0; j < ICLN_LOAD_BATCH; ++j) {
    const int ej = e + j * step;
    const long long off = base + (long long)ej * L.elem_stride;
    masked[j] = ej >= e1 || L.mask[off] != 0;
    v[j] = ej < e1 ? L.vals[off] : 0.0f;
  }
#pragma unroll
  for (int j = 0; j < ICLN_LOAD_BATCH; ++j)
    key[j] = e + j * step >= e1 ? INT_MIN : masked[j] ? ICLN_KEY_MASKED : icln_ordered_key(v[j]);
}

// ---- block route: W lines a block, one launch ----

__global__ void __launch_bounds__(1024)
    icln_mm_block_kernel(IclnMmLines L, int nlines, int W, float* __restrict__ out) {
  extern __shared__ int smem[];
  __shared__ IclnSelState st;
  const int ls = icln_key_stride(L.n);
  int* keys = smem;
  int* hist = keys + W * ls;
  for (int i = threadIdx.x; i < W * 256; i += blockDim.x) hist[i] = 0;
  if (threadIdx.x < W) {
    st.nv[threadIdx.x] = 0;
    st.moff[threadIdx.x] = -1;  // the keys hold the mask (ICLN_KEY_MASKED)
  }
  __syncthreads();
  const int c = threadIdx.x & (W - 1);
  const long long line = (long long)blockIdx.x * W + c;
  const bool live = line < nlines;
  const long long base = line * L.line_stride;
  int valid = 0;
  const int rstep = blockDim.x / W;
  for (int rb = threadIdx.x / W; rb < L.n; rb += ICLN_LOAD_BATCH * rstep) {
    int key[ICLN_LOAD_BATCH];
    bool masked[ICLN_LOAD_BATCH];
    icln_mm_keys(L, base, rb, rstep, live ? L.n : 0, key, masked);
#pragma unroll
    for (int j = 0; j < ICLN_LOAD_BATCH; ++j) {
      const int r = rb + j * rstep;
      if (r >= L.n) break;
      keys[c * ls + r] = live ? key[j] : 0;
      valid += !masked[j];
    }
  }
  icln_lines_add(valid, W, st.nv);
  __syncthreads();
  icln_block_select(keys, L.n, W, hist, nullptr, st);
  if (threadIdx.x < W && (long long)blockIdx.x * W + threadIdx.x < nlines)
    out[(long long)blockIdx.x * W + threadIdx.x] = icln_sel_median(st, threadIdx.x);
}

// ---- grid route: a line over bpl blocks, a launch a pass ----

struct IclnMmState {
  int* hist;         // 256 bins a line
  int* nvalid;       // valid entries a line
  int* ticket;       // blocks of the line done with the current launch
  int* above;        // least key above the last pass's bucket
  int* krem;         // rank left inside the prefix's bucket
  unsigned* prefix;  // digits of lo found so far
};

// After a block's atomics: true in the block that finished the line's
// launch last (its ticket resets for the next launch).
__device__ __forceinline__ bool icln_mm_last_block(const IclnMmState& S, int line, int bpl) {
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

// Pass PASS: the histogram of the digit at shift 24 - 8 * PASS over the
// keys whose higher digits equal the line's prefix (pass 0: every key,
// and the valid count; pass 3: also the least key above the bucket),
// each warp into its own 256 shared bins, their sums added to the line's
// bins in device memory; then the last block's pick, which after pass 3
// takes the least key above lo and writes the median.
template <int PASS>
__global__ void icln_mm_pass_kernel(IclnMmLines L, IclnMmState S, float* __restrict__ out) {
  __shared__ int bins[ICLN_MM_GRID_WARPS][256];
  __shared__ int red[64];
  const int shift = 24 - 8 * PASS;
  const int line = blockIdx.x / L.bpl;
  const int e0 = (blockIdx.x - line * L.bpl) * L.chunk;
  const int e1 = min(L.n, e0 + L.chunk);
  const long long base = (long long)line * L.line_stride;
  for (int i = threadIdx.x; i < ICLN_MM_GRID_WARPS * 256; i += blockDim.x) (&bins[0][0])[i] = 0;
  __syncthreads();
  int* wbins = bins[threadIdx.x >> 5];
  const unsigned want = PASS == 0 ? 0u : S.prefix[line];
  const int lane = threadIdx.x & 31;
  int valid = 0, above = INT_MAX;
  for (int eb = e0 + threadIdx.x; eb < e1; eb += ICLN_LOAD_BATCH * blockDim.x) {
    int key[ICLN_LOAD_BATCH];
    bool masked[ICLN_LOAD_BATCH];
    icln_mm_keys(L, base, eb, blockDim.x, e1, key, masked);
#pragma unroll
    for (int j = 0; j < ICLN_LOAD_BATCH; ++j) {
      if (eb + j * blockDim.x >= e1) break;
      const unsigned u = icln_radix(key[j]);
      valid += !masked[j];
      if (PASS == 0 || (u >> (shift + 8)) == want)
        atomicAdd(&wbins[(u >> shift) & 255u], 1);
      else if (PASS == 3 && (u >> 8) > want)
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
  if (PASS == 3) {
    above = icln_block_reduce_int<ICLN_MIN>(above, red, parity);
    if (threadIdx.x == 0 && above != INT_MAX) atomicMin(&S.above[line], above);
  }
  if (!icln_mm_last_block(S, line, L.bpl) || threadIdx.x >= 32) return;
  int b[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) b[i] = atomicExch(&h[8 * lane + i], 0);
  const int nv = __ldcg(&S.nvalid[line]);
  const int k = PASS == 0 ? icln_sel_klo(nv) : S.krem[line];
  const IclnPick p = icln_warp_pick(b, k);
  if (PASS < 3) {
    if (lane == 0) {
      S.krem[line] = k - p.below;
      S.prefix[line] = PASS == 0 ? (unsigned)p.digit : (want << 8) | (unsigned)p.digit;
      if (PASS == 2) S.above[line] = INT_MAX;
    }
    return;
  }
  // lo, and hi where more than k_hi keys lie at or below lo, else the
  // least key above lo (K3's icln_sel_median)
  const unsigned succ = icln_successor_radix(b, p.digit, want, icln_radix(__ldcg(&S.above[line])));
  if (lane == 0) {
    const int lo = (int)icln_radix((int)((want << 8) | (unsigned)p.digit));
    const int count_le = icln_sel_klo(nv) - (k - p.below) + p.count;
    const bool need = nv > 0 && count_le <= nv / 2;
    out[line] = icln_sel_median_of(lo, need ? (int)icln_radix((int)succ) : lo, nv);
  }
}

// Block route (bpl == 1): `lines` (W) lines a block of `threads` threads
// and smem_bytes of dynamic shared memory; scratch unused.  Grid route:
// scratch is int32 [nlines * 256 bins | nvalid | ticket | above | krem |
// prefix], nlines * 261 entries, the wrapper's allocation.
extern "C" int icln_masked_median(const float* vals, const unsigned char* mask, float* out,
                                  int* scratch, int n, int nlines, long long line_stride,
                                  long long elem_stride, int chunk, int bpl, int lines,
                                  int threads, long long smem_bytes, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const IclnMmLines L{vals, mask, n, chunk, bpl, line_stride, elem_stride};
  cudaError_t err;
  if (bpl == 1) {
    if (lines < 1 || lines > 8 || (lines & (lines - 1)) || threads % 32 || threads > 1024)
      return (int)cudaErrorInvalidConfiguration;
    err = cudaFuncSetAttribute(icln_mm_block_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
    if (err != cudaSuccess) return (int)err;
    icln_mm_block_kernel<<<(nlines + lines - 1) / lines, threads, (size_t)smem_bytes, s>>>(
        L, nlines, lines, out);
    return (int)cudaGetLastError();
  }
  IclnMmState S;
  S.hist = scratch;
  S.nvalid = S.hist + (long long)nlines * 256;
  S.ticket = S.nvalid + nlines;
  S.above = S.ticket + nlines;
  S.krem = S.above + nlines;
  S.prefix = reinterpret_cast<unsigned*>(S.krem + nlines);
  const long long blocks = (long long)nlines * bpl;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  const unsigned grid = (unsigned)blocks, threads_g = 32 * ICLN_MM_GRID_WARPS;
  err = cudaMemsetAsync(scratch, 0, sizeof(int) * (size_t)nlines * 258, s);
  if (err != cudaSuccess) return (int)err;
  icln_mm_pass_kernel<0><<<grid, threads_g, 0, s>>>(L, S, out);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  icln_mm_pass_kernel<1><<<grid, threads_g, 0, s>>>(L, S, out);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  icln_mm_pass_kernel<2><<<grid, threads_g, 0, s>>>(L, S, out);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  icln_mm_pass_kernel<3><<<grid, threads_g, 0, s>>>(L, S, out);
  return (int)cudaGetLastError();
}
