// K3: one scaler orientation for all four diagnostics.
//
// Replaces iterative_cleaner_tpu/stats/pallas_kernels.py
// _scaled_sides_body (launched by scaled_sides_pallas through
// _scaled_sides_axis0 / _scaled_sides_axis1): per line, the exact masked
// median, centring, the MAD, then the _masked_side epilogue for std,
// mean and ptp, and the plain path (NaN-line patch, IEEE inf/nan flowing
// onward) for the rFFT diagnostic.
//
// Bound: bytes.  Four float (nsub, nchan) planes and the bool mask in,
// four float planes out (33 bytes per cell, 138 MB at 1024x4096: 41 us at
// 3.35 TB/s); the selects are integer work on data in shared memory.
//
// Design: a block takes W adjacent lines (along axis 0, where a line is
// a column, the most of 8, 4, 2, 1 that fit: 8, and a warp reading
// 32-byte row segments, up to 6,752 subints; W = 1 along axis 1, where a
// line is a row) and D of the four diagnostics at once (the most of 4, 2, 1 that
// fit with the W lines, in turns), and holds W * D lines of int32 keys
// plus the lines' mask as bits in shared memory.
// Each key is made once per select round: round 1 selects the W * D
// medians in one chain of common.cuh's block radix select (four 8-bit
// passes over chunks of 256 entries dealt out to the warps, eight keys a
// lane from two 16-byte loads, int32 shared atomics; one warp scanning
// each line's 256 bins; the upper middle from the last pass's bins, no
// successor pass; a masked entry read as +inf's key from the mask bits);
// the centring then rewrites every unmasked key in place as the key of
// |centred|, and round 2 selects the MADs.  A value is its key mapped
// back (the map is an involution), so no float copy is kept: the output
// reads |centred|, or a masked entry's value, from the key.  The planes
// are read once (four entries' loads in flight a thread) and written
// once; 19 barriers a block at D = 4, against some 280 of the 32-step
// bisection this replaced.  Every float op repeats the reference's
// sequence, so the outputs are bit-equal to it: median 0.5f*(lo+hi) (0.0
// on an empty line), centring, true division by the MAD (|c / mad| ==
// ||c| / mad|, the rounding being symmetric), and the threshold applied
// as a multiply by float32(1/thresh) — the reference's compiler rewrites
// the division by its constant threshold that way.  The launch plan (W,
// D, threads, shared memory) is stats.kernels.scaled_sides_geometry.

#include "common.cuh"

template <int D>
__global__ void __launch_bounds__(1024)
    icln_scaled_sides_kernel(const float* __restrict__ d0, const float* __restrict__ d1,
                             const float* __restrict__ d2, const float* __restrict__ d3,
                             const unsigned char* __restrict__ mask, float* __restrict__ o0,
                             float* __restrict__ o1, float* __restrict__ o2,
                             float* __restrict__ o3, int n, int nlines, long long line_stride,
                             long long elem_stride, int W, float inv_t) {
  extern __shared__ int smem[];
  __shared__ IclnSelState st;
  __shared__ int nvalid[8], nan_in[8], nan_abs[8];  // per line of the block
  const int M = W * D;
  const int ls = icln_key_stride(n);  // line m = d * W + c at keys + m * ls
  const int nw = (n + 31) >> 5;         // mask words a line
  int* keys = smem;
  int* hist = keys + M * ls;
  unsigned* mbits = reinterpret_cast<unsigned*>(hist + M * 256);
  for (int i = threadIdx.x; i < M * 256; i += blockDim.x) hist[i] = 0;
  for (int i = threadIdx.x; i < W * nw; i += blockDim.x) mbits[i] = 0u;
  if (threadIdx.x < 8) nvalid[threadIdx.x] = nan_in[threadIdx.x] = nan_abs[threadIdx.x] = 0;
  __syncthreads();

  // thread t works on line c = t % W of the block's W lines, entries
  // r = t / W + j * (threads / W): a warp reads 32 / W entries of W lines
  const int c = threadIdx.x & (W - 1);
  const int r0 = threadIdx.x / W, rstep = blockDim.x / W;
  const long long line = (long long)blockIdx.x * W + c;
  const bool live = line < nlines;  // the ragged last block
  const long long base = line * line_stride;
  unsigned* mb = mbits + c * nw;

  const float* const ins[4] = {d0, d1, d2, d3};
  float* const outs[4] = {o0, o1, o2, o3};
  for (int g = 0; g < 4; g += D) {
    // the previous group's threads have read st and their medians
    if (g) __syncthreads();
    const bool plain = g + D > 3;  // the group holds the rFFT diagnostic
    if (threadIdx.x < M) {
      const int m = threadIdx.x;
      st.moff[m] = g + m / W == 3 ? -1 : (m % W) * nw;
    }
    // every entry's key is its value's (the select reads the mask bits);
    // ICLN_LOAD_BATCH entries' loads in flight a thread
    int valid = 0, nan_v = 0;
    for (int rb = r0; rb < n; rb += ICLN_LOAD_BATCH * rstep) {
      float v[ICLN_LOAD_BATCH][D];
      bool mk[ICLN_LOAD_BATCH];
#pragma unroll
      for (int j = 0; j < ICLN_LOAD_BATCH; ++j) {
        const int r = rb + j * rstep;
        const bool in = live && r < n;
        const long long off = base + (long long)r * elem_stride;
        mk[j] = g == 0 && (!in || mask[off]);
#pragma unroll
        for (int d = 0; d < D; ++d) v[j][d] = in ? ins[g + d][off] : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < ICLN_LOAD_BATCH; ++j) {
        const int r = rb + j * rstep;
        if (r >= n) break;
        if (g == 0) {
          if (mk[j]) atomicOr(&mb[r >> 5], 1u << (r & 31));
          valid += live && !mk[j];
        }
#pragma unroll
        for (int d = 0; d < D; ++d) {
          keys[(d * W + c) * ls + r] = live ? icln_ordered_key(v[j][d]) : 0;
          if (g + d == 3) nan_v |= icln_isnan(v[j][d]);
        }
      }
    }
    if (g == 0) icln_lines_add(valid, W, nvalid);
    if (plain) icln_lines_or(nan_v, W, nan_in);
    __syncthreads();
    if (threadIdx.x < M) {
      const int m = threadIdx.x;
      st.nv[m] = g + m / W == 3 ? n : nvalid[m % W];  // read at the first pick
    }

    // round 1: the medians; then each unmasked key becomes |centred|'s
    icln_block_select(keys, n, M, hist, mbits, st);
    float med[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      med[d] = icln_sel_median(st, d * W + c);
      if (g + d == 3 && nan_in[c]) med[d] = icln_nan();
    }
    int nan_a = 0;
#pragma unroll 2
    for (int r = r0; r < n; r += rstep) {
      const bool masked = (mb[r >> 5] >> (r & 31)) & 1u;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const int i = g + d;
        if (i < 3 && masked) continue;  // masked entries pass through
        int* kp = keys + (d * W + c) * ls + r;
        const float a = fabsf(icln_key_to_float(*kp) - med[d]);
        *kp = icln_ordered_key(a);
        if (i == 3) nan_a |= icln_isnan(a);
      }
    }
    if (plain) icln_lines_or(nan_a, W, nan_abs);
    __syncthreads();

    // round 2: the MADs; then the sides
    icln_block_select(keys, n, M, hist, mbits, st);
    if (!live) continue;
    float mad[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      mad[d] = icln_sel_median(st, d * W + c);
      if (g + d == 3 && nan_abs[c]) mad[d] = icln_nan();
    }
    const bool empty = nvalid[c] == 0;
#pragma unroll 2
    for (int r = r0; r < n; r += rstep) {
      const bool masked = (mb[r >> 5] >> (r & 31)) & 1u;
      const long long off = base + r * elem_stride;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const int i = g + d;
        // |centred|, or a masked entry's value (it passes through)
        const float a = icln_key_to_float(keys[(d * W + c) * ls + r]);
        float out;
        if (i == 3) {
          out = fabsf(a / mad[d]) * inv_t;
        } else if (masked) {
          out = fabsf(a);  // _masked_side: undivided
        } else {
          // _masked_side: zero-MAD / empty lines go dead, data undivided
          const bool line_dead = (mad[d] == 0.0f) || empty;
          const float safe_mad = line_dead ? 1.0f : mad[d];
          const float mag = line_dead ? a : fabsf(a / safe_mad);
          out = line_dead ? mag : mag * inv_t;
        }
        outs[i][off] = out;
      }
    }
  }
}

template <int D>
static int icln_scaled_sides_launch(const float* d0, const float* d1, const float* d2,
                                    const float* d3, const unsigned char* mask, float* o0,
                                    float* o1, float* o2, float* o3, int n, int nlines,
                                    long long line_stride, long long elem_stride, float inv_t,
                                    int lines, int threads, long long smem_bytes,
                                    cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(icln_scaled_sides_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (nlines + lines - 1) / lines;
  icln_scaled_sides_kernel<D><<<blocks, threads, (size_t)smem_bytes, stream>>>(
      d0, d1, d2, d3, mask, o0, o1, o2, o3, n, nlines, line_stride, elem_stride, lines, inv_t);
  return (int)cudaGetLastError();
}

// lines: W (1, 2, 4 or 8), diags: D (1, 2 or 4); threads a multiple of 32.
extern "C" int icln_scaled_sides(const float* d0, const float* d1, const float* d2,
                                 const float* d3, const unsigned char* mask,
                                 float* o0, float* o1, float* o2, float* o3, int n,
                                 int nlines, long long line_stride,
                                 long long elem_stride, float inv_t, int lines, int diags,
                                 int threads, long long smem_bytes, void* stream) {
  if (lines < 1 || lines > 8 || (lines & (lines - 1)) || diags * lines > ICLN_SEL_LINES ||
      threads % 32 || threads > 1024)
    return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = (cudaStream_t)stream;
  switch (diags) {
    case 4:
      return icln_scaled_sides_launch<4>(d0, d1, d2, d3, mask, o0, o1, o2, o3, n, nlines,
                                         line_stride, elem_stride, inv_t, lines, threads,
                                         smem_bytes, s);
    case 2:
      return icln_scaled_sides_launch<2>(d0, d1, d2, d3, mask, o0, o1, o2, o3, n, nlines,
                                         line_stride, elem_stride, inv_t, lines, threads,
                                         smem_bytes, s);
    case 1:
      return icln_scaled_sides_launch<1>(d0, d1, d2, d3, mask, o0, o1, o2, o3, n, nlines,
                                         line_stride, elem_stride, inv_t, lines, threads,
                                         smem_bytes, s);
    default:
      return (int)cudaErrorInvalidConfiguration;
  }
}
