// K1: both weighted marginals of the dispersed cube in one read.
//
// Replaces iterative_cleaner_tpu/stats/pallas_kernels.py
// _marginals_kernel (launched by weighted_marginals_pallas):
//     A[c, b]  = sum_s w[s, c] * disp[s, c, b]     (nchan, nbin)
//     t1[s, b] = sum_c w[s, c] * disp[s, c, b]     (nsub, nbin)
//
// Bound: bytes.  The cube is read once (4 * nsub * nchan * nbin bytes;
// 2.15 GB at 1024x4096x128, 0.65 ms at 3.35 TB/s), against a few MB of
// outputs and three float operations an element.
//
// What held the first design back (1.655 ms, 39% of the bound, on an
// NVIDIA H100 80GB HBM3 at 700 W): every thread issued scalar 4-byte
// loads, each followed by a shared-memory store and an accumulate, and
// three block barriers per subint kept the next subint's loads from
// being issued until the column sums finished, so few bytes were in
// flight on an SM.
//
// Design: the TPU kernel carries both sums in scratch across its
// sequential grid.  Hopper blocks run in no order, so each block owns a
// tile of cb channels x bb bins across a run of sb subints and writes
// per-tile partial sums — A partials per subint run, t1 partials per
// channel tile — and a second pass adds the partials in a fixed order.
// No float atomics: two runs are bit-equal.
//   * One subint's slab of a tile (cb rows of bb floats; one contiguous
//     run when the tile spans whole rows) and the tile's weights for that
//     subint arrive by TMA bulk copies (cp.async.bulk) into a ring of
//     three shared-memory stages, each completing on its own mbarrier.
//     One thread issues them, so the next two subints are in flight
//     while one is reduced; a slab is at most 32 KB, so two blocks fit
//     an SM.
//   * Each thread owns fixed (channel, bin) elements of the tile: one bin
//     and J = 32 channels (c = j * G + g for its channel group g).  It
//     keeps their A sums in registers across the subints and sums its
//     channels of the subint in channel order for t1; the G groups'
//     partials are added in group order in shared memory.  One block
//     barrier per subint, after which the freed stage is refilled.
//   * Tiles of 64 channels at 128 bins (cb = G * 32) halve the t1
//     partials of the first design's 32.
//   * Long profiles tile the bins (bb = 256 when nbin > 256, one bulk
//     copy per row).  Where the cube or the weights are not 16-byte
//     aligned, or nbin or nchan is not a multiple of four, the threads
//     read their elements from device memory instead (`TMA` false).
// On the card (NVIDIA H100 80GB HBM3, 700.00 W): 0.79-0.86 ms at
// 1024x4096x128, 75-82% of the byte bound, against the first design's
// 1.67 ms and the two einsums' 1.52-1.57 ms (PERF.md).

#include "common.cuh"

#define ICLN_MARG_THREADS 256
#define ICLN_MARG_J 32      // channels per thread
#define ICLN_MARG_STAGES 3

struct MargArgs {
  const float* disp;
  const float* w;
  float* a_part;   // (nsb, nchan, nbin)
  float* t1_part;  // (ncb, nsub, nbin)
  int nsub, nchan, nbin;
  int sb, cb, bb;  // subints per run, channels and bins per tile
  int lanes;       // bin lanes per channel group (a power of two >= bb)
  int ncb;         // channel tiles
};

// floats of one stage: the slab at pitch bb, then the tile's weights
__host__ __device__ inline int icln_marg_stage_floats(int cb, int bb) {
  return cb * bb + cb;
}

// Issue the bulk copies of subint s of this block's tile into `st`.
static __device__ void icln_marg_issue(const MargArgs& p, int s, int c0, int cn, int b0,
                                       int bn, float* st, uint64_t* bar) {
  const size_t row0 = (size_t)s * p.nchan + c0;
  icln_mbar_arrive_tx(bar, (unsigned)((cn * bn + cn) * sizeof(float)));
  if (bn == p.nbin) {
    icln_bulk_load(st, p.disp + row0 * p.nbin, (unsigned)(cn * bn * sizeof(float)), bar);
  } else {
    for (int c = 0; c < cn; ++c)
      icln_bulk_load(st + c * p.bb, p.disp + (row0 + c) * p.nbin + b0,
                     (unsigned)(bn * sizeof(float)), bar);
  }
  icln_bulk_load(st + p.cb * p.bb, p.w + row0, (unsigned)(cn * sizeof(float)), bar);
}

template <bool TMA>
__global__ void __launch_bounds__(ICLN_MARG_THREADS)
    icln_marginals_kernel(const MargArgs p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw);  // ICLN_MARG_STAGES
  float* red = reinterpret_cast<float*>(smem_raw + 32);    // 2 x 256
  float* stages = red + 2 * ICLN_MARG_THREADS;
  const int sfl = icln_marg_stage_floats(p.cb, p.bb);
  const int tid = threadIdx.x;
  const int cblk = blockIdx.x % p.ncb, bblk = blockIdx.x / p.ncb;
  const int sblk = blockIdx.y;
  const int c0 = cblk * p.cb, cn = min(p.cb, p.nchan - c0);
  const int b0 = bblk * p.bb, bn = min(p.bb, p.nbin - b0);
  const int s0 = sblk * p.sb, sn = min(p.sb, p.nsub - s0);
  const int G = ICLN_MARG_THREADS / p.lanes;
  const int lb = tid % p.lanes, g = tid / p.lanes;
  const bool live = lb < bn;

  if (TMA) {
    if (tid == 0) {
      for (int i = 0; i < ICLN_MARG_STAGES; ++i) icln_mbar_init(&bar[i], 1);
      icln_mbar_init_fence();
    }
    __syncthreads();
    if (tid == 0)
      for (int i = 0; i < min(ICLN_MARG_STAGES, sn); ++i)
        icln_marg_issue(p, s0 + i, c0, cn, b0, bn, stages + i * sfl, &bar[i]);
  }

  float acc[ICLN_MARG_J];
#pragma unroll
  for (int j = 0; j < ICLN_MARG_J; ++j) acc[j] = 0.0f;

  for (int i = 0; i < sn; ++i) {
    const int slot = i % ICLN_MARG_STAGES;
    const float* st = stages + slot * sfl;
    const size_t srow = (size_t)(s0 + i);
    if (TMA) icln_mbar_wait(&bar[slot], (unsigned)((i / ICLN_MARG_STAGES) & 1));
    float t = 0.0f;
    if (live) {
#pragma unroll
      for (int j = 0; j < ICLN_MARG_J; ++j) {
        const int c = j * G + g;
        if (c < cn) {
          float v, wc;
          if (TMA) {
            v = st[c * p.bb + lb];
            wc = st[p.cb * p.bb + c];
          } else {
            v = p.disp[(srow * p.nchan + c0 + c) * p.nbin + b0 + lb];
            wc = p.w[srow * p.nchan + c0 + c];
          }
          const float x = v * wc;
          acc[j] += x;
          t += x;
        }
      }
    }
    float* t1_out = p.t1_part + ((size_t)cblk * p.nsub + srow) * p.nbin + b0;
    if (G == 1) {
      if (live) t1_out[lb] = t;
    } else {
      red[(i & 1) * ICLN_MARG_THREADS + tid] = t;
    }
    __syncthreads();  // the stage is consumed; the group partials are in
    if (G > 1 && g == 0 && live) {
      const float* r = red + (i & 1) * ICLN_MARG_THREADS + lb;
      float tt = r[0];
      for (int q = 1; q < G; ++q) tt += r[q * p.lanes];
      t1_out[lb] = tt;
    }
    if (TMA && tid == 0 && i + ICLN_MARG_STAGES < sn) {
      icln_fence_proxy_async();
      icln_marg_issue(p, s0 + i + ICLN_MARG_STAGES, c0, cn, b0, bn,
                      stages + slot * sfl, &bar[slot]);
    }
  }
  if (live) {
    float* a_out = p.a_part + ((size_t)sblk * p.nchan + c0) * p.nbin + b0 + lb;
#pragma unroll
    for (int j = 0; j < ICLN_MARG_J; ++j) {
      const int c = j * G + g;
      if (c < cn) a_out[(size_t)c * p.nbin] = acc[j];
    }
  }
}

// out[i] = sum_p part[p, i], partials added in index order.
__global__ void icln_sum_parts(const float* __restrict__ part,
                               float* __restrict__ out, int nparts, size_t n) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float t = 0.0f;
  for (int p = 0; p < nparts; ++p) t += part[(size_t)p * n + i];
  out[i] = t;
}

extern "C" int icln_weighted_marginals(const float* disp, const float* w,
                                       float* a_part, float* t1_part,
                                       float* a, float* t1, int nsub, int nchan,
                                       int nbin, int sb, int cb, int bb, int lanes,
                                       long long smem_bytes, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  MargArgs p{disp, w, a_part, t1_part, nsub, nchan, nbin, sb, cb, bb, lanes,
             (nchan + cb - 1) / cb};
  const int nbt = (nbin + bb - 1) / bb, nsb = (nsub + sb - 1) / sb;
  const long long need =
      32 + (2LL * ICLN_MARG_THREADS
            + (long long)ICLN_MARG_STAGES * icln_marg_stage_floats(cb, bb)) * sizeof(float);
  if (need > smem_bytes || cb != (ICLN_MARG_THREADS / lanes) * ICLN_MARG_J || bb > lanes)
    return (int)cudaErrorInvalidValue;
  const bool tma = nbin % 4 == 0 && nchan % 4 == 0 && (uintptr_t)disp % 16 == 0
                   && (uintptr_t)w % 16 == 0;
  const dim3 grid((unsigned)(p.ncb * nbt), (unsigned)nsb);
  cudaError_t err;
  if (tma) {
    err = cudaFuncSetAttribute(icln_marginals_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
    if (err != cudaSuccess) return (int)err;
    icln_marginals_kernel<true><<<grid, ICLN_MARG_THREADS, (size_t)smem_bytes, st>>>(p);
  } else {
    err = cudaFuncSetAttribute(icln_marginals_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
    if (err != cudaSuccess) return (int)err;
    icln_marginals_kernel<false><<<grid, ICLN_MARG_THREADS, (size_t)smem_bytes, st>>>(p);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t na = (size_t)nchan * nbin, nt = (size_t)nsub * nbin;
  icln_sum_parts<<<(unsigned)((na + 255) / 256), 256, 0, st>>>(a_part, a, nsb, na);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  icln_sum_parts<<<(unsigned)((nt + 255) / 256), 256, 0, st>>>(t1_part, t1, p.ncb, nt);
  return (int)cudaGetLastError();
}

extern "C" const char* icln_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
