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
// Design: a radix select over the order-preserving keys (as unsigned,
// key ^ 0x80000000), 8 bits a pass, lines split over as many blocks as
// it takes to fill the card (a block per 4096 entries: the telemetry's
// line takes 1024 blocks; a Hopper block cannot hold its 16.8 MB of
// keys, and the TPU kernel's whole line in VMEM has no counterpart).
// Pass p histograms byte p of the keys whose higher bytes equal the
// prefix found so far: each block counts into 256 shared-memory bins
// (the lanes of a warp holding the same digit add once, through
// __match_any_sync) and adds its bins to the line's 256 int32 bins in
// device memory with integer atomics, exact in any order.  After each
// pass one thread per line walks its bins to the digit holding the
// remaining rank, appends it to the prefix and clears the bins.  Four
// passes give the k_lo-th key; a fifth read counts the keys at or below
// it and takes the least key above it (int32 atomicAdd / atomicMin), and
// one thread per line forms the median.  The state (prefix, rank, valid
// count) stays in device memory between launches: no host round trip.
// A line is (start, stride) into the tensor as it lies, so no transposed
// copy is made; along dim 0 the entries a warp reads are a row apart.
// The work moves the bytes five times (31 us at the byte rate for the
// telemetry's line) plus ten short launches: 0.12 ms on that line on an
// NVIDIA H100 80GB HBM3 at 700 W, against 0.43-0.46 ms for the
// torch.sort route it replaced (chip_smoke.py).

#include "common.cuh"

// unsigned order of the digits == signed order of the keys
__device__ __forceinline__ unsigned icln_mm_radix(int key) {
  return (unsigned)key ^ 0x80000000u;
}

struct IclnMmLines {
  const float* vals;
  const unsigned char* mask;
  int n;                  // entries per line
  int chunk;              // entries per block
  int bpl;                // blocks per line
  long long line_stride;  // elements between the starts of two lines
  long long elem_stride;  // elements between two entries of a line
};

__device__ __forceinline__ int icln_mm_key(const IclnMmLines& L, long long base, int e,
                                           bool* masked) {
  const long long off = base + (long long)e * L.elem_stride;
  *masked = L.mask[off] != 0;
  return *masked ? ICLN_KEY_MASKED : icln_ordered_key(L.vals[off]);
}

// One pass of the radix select: the histogram of the digit at `shift`
// over the keys whose higher digits equal prefix[line].  FIRST (the top
// digit) takes every key and also counts the line's valid entries.
template <bool FIRST>
__global__ void icln_mm_histogram_kernel(IclnMmLines L, int shift,
                                         const unsigned* __restrict__ prefix,
                                         int* __restrict__ hist, int* __restrict__ nvalid) {
  __shared__ int bins[256];
  __shared__ int red[64];
  const int line = blockIdx.x / L.bpl;
  const int e0 = (blockIdx.x - line * L.bpl) * L.chunk;
  const int e1 = min(L.n, e0 + L.chunk);
  const long long base = (long long)line * L.line_stride;
  for (int i = threadIdx.x; i < 256; i += blockDim.x) bins[i] = 0;
  __syncthreads();
  const unsigned want = FIRST ? 0u : prefix[line];
  const int lane = threadIdx.x & 31;
  int valid = 0;
  // the trip count is the warp's, so all its lanes meet at the match
  for (int w0 = e0 + (threadIdx.x & ~31); w0 < e1; w0 += blockDim.x) {
    const int e = w0 + lane;
    int digit = -1;
    if (e < e1) {
      bool masked;
      const unsigned u = icln_mm_radix(icln_mm_key(L, base, e, &masked));
      valid += !masked;
      if (FIRST || (u >> (shift + 8)) == want) digit = (int)((u >> shift) & 255u);
    }
    const unsigned peers = __match_any_sync(0xffffffffu, digit);
    if (digit >= 0 && lane == __ffs(peers) - 1) atomicAdd(&bins[digit], __popc(peers));
  }
  __syncthreads();
  int* h = hist + (long long)line * 256;
  for (int i = threadIdx.x; i < 256; i += blockDim.x)
    if (bins[i]) atomicAdd(&h[i], bins[i]);
  if (FIRST) {
    int parity = 0;
    valid = icln_block_reduce_int<ICLN_SUM>(valid, red, parity);
    if (threadIdx.x == 0) atomicAdd(&nvalid[line], valid);
  }
}

// One thread per line: the digit whose bins hold the remaining rank
// (the k_lo-th key's, set from the valid count on the first pass), the
// prefix extended by it, the bins cleared for the next pass; the last
// pass also arms the successor pass's accumulators.
__global__ void icln_mm_select_kernel(int nlines, bool first, bool last,
                                      int* __restrict__ hist, const int* __restrict__ nvalid,
                                      int* __restrict__ krem, unsigned* __restrict__ prefix,
                                      int* __restrict__ cnt_le, int* __restrict__ succ) {
  const int line = blockIdx.x * blockDim.x + threadIdx.x;
  if (line >= nlines) return;
  const int k = first ? max(nvalid[line] - 1, 0) / 2 : krem[line];
  int* h = hist + (long long)line * 256;
  int digit = 0, below = 0;
  for (; digit < 255; ++digit) {
    const int c = h[digit];
    if (below + c > k) break;
    below += c;
  }
  for (int i = 0; i < 256; ++i) h[i] = 0;
  krem[line] = k - below;
  prefix[line] = first ? (unsigned)digit : (prefix[line] << 8) | (unsigned)digit;
  if (last) {
    cnt_le[line] = 0;
    succ[line] = INT_MAX;
  }
}

// The reference's _select_adjacent tail: keys at or below the k_lo-th
// key, and the least key above it.
__global__ void icln_mm_successor_kernel(IclnMmLines L, const unsigned* __restrict__ prefix,
                                         int* __restrict__ cnt_le, int* __restrict__ succ) {
  __shared__ int red[64];
  int parity = 0;
  const int line = blockIdx.x / L.bpl;
  const int e0 = (blockIdx.x - line * L.bpl) * L.chunk;
  const int e1 = min(L.n, e0 + L.chunk);
  const long long base = (long long)line * L.line_stride;
  const int lo = (int)(prefix[line] ^ 0x80000000u);
  int cnt = 0, above = INT_MAX;
  for (int e = e0 + threadIdx.x; e < e1; e += blockDim.x) {
    bool masked;
    const int k = icln_mm_key(L, base, e, &masked);
    cnt += k <= lo;
    if (k > lo) above = min(above, k);
  }
  cnt = icln_block_reduce_int<ICLN_SUM>(cnt, red, parity);
  above = icln_block_reduce_int<ICLN_MIN>(above, red, parity);
  if (threadIdx.x == 0) {
    atomicAdd(&cnt_le[line], cnt);
    atomicMin(&succ[line], above);
  }
}

__global__ void icln_mm_final_kernel(int nlines, const int* __restrict__ nvalid,
                                     const unsigned* __restrict__ prefix,
                                     const int* __restrict__ cnt_le,
                                     const int* __restrict__ succ, float* __restrict__ out) {
  const int line = blockIdx.x * blockDim.x + threadIdx.x;
  if (line >= nlines) return;
  const int nv = nvalid[line];
  const int lo = (int)(prefix[line] ^ 0x80000000u);
  const int hi = cnt_le[line] > nv / 2 ? lo : succ[line];
  const float med = 0.5f * (icln_key_to_float(lo) + icln_key_to_float(hi));
  out[line] = nv == 0 ? 0.0f : med;
}

// scratch: int32 [nlines * 256 bins | nvalid | krem | prefix | cnt_le |
// succ], nlines * 261 entries, the wrapper's allocation.
extern "C" int icln_masked_median(const float* vals, const unsigned char* mask, float* out,
                                  int* scratch, int n, int nlines, long long line_stride,
                                  long long elem_stride, int chunk, int bpl, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int* hist = scratch;
  int* nvalid = hist + (long long)nlines * 256;
  int* krem = nvalid + nlines;
  unsigned* prefix = reinterpret_cast<unsigned*>(krem + nlines);
  int* cnt_le = krem + 2 * (long long)nlines;
  int* succ = cnt_le + nlines;
  const IclnMmLines L{vals, mask, n, chunk, bpl, line_stride, elem_stride};
  const long long blocks = (long long)nlines * bpl;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  const int threads = 256, sel_threads = 128;
  const int sel_blocks = (nlines + sel_threads - 1) / sel_threads;
  cudaError_t err = cudaMemsetAsync(hist, 0, sizeof(int) * (size_t)nlines * 257, s);
  if (err != cudaSuccess) return (int)err;
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = 24 - 8 * pass;
    if (pass == 0)
      icln_mm_histogram_kernel<true><<<(unsigned)blocks, threads, 0, s>>>(L, shift, prefix,
                                                                          hist, nvalid);
    else
      icln_mm_histogram_kernel<false><<<(unsigned)blocks, threads, 0, s>>>(L, shift, prefix,
                                                                           hist, nvalid);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    icln_mm_select_kernel<<<sel_blocks, sel_threads, 0, s>>>(nlines, pass == 0, pass == 3, hist,
                                                             nvalid, krem, prefix, cnt_le, succ);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  icln_mm_successor_kernel<<<(unsigned)blocks, threads, 0, s>>>(L, prefix, cnt_le, succ);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  icln_mm_final_kernel<<<sel_blocks, sel_threads, 0, s>>>(nlines, nvalid, prefix, cnt_le, succ,
                                                          out);
  return (int)cudaGetLastError();
}
