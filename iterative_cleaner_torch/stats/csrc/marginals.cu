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
//
// A batch of equal-shaped archives, (nb, nsub, nchan, nbin), is one
// launch: grid.z is the archive, each archive has its own partials, and
// the second pass adds each archive's partials in the same fixed order.
// The plan (sb, cb, bb) is the one archive's, so every archive's sums are
// bit-equal to a launch on that archive alone.  TMA is taken only where
// every archive's slab (not only the first) starts 16-byte aligned.
//
// A bf16-stored cube (the mixed-precision mode; the TPU kernel upcasts
// each staged block, pallas_kernels.py _marginals_kernel) is the same
// kernel over 2-byte elements: the ring's slabs hold bf16 (half the bytes
// of a stage, so the bulk copies move half the bytes), and each element
// is upcast to float32 where a thread reads it, before the product with
// its weight, so every sum is the float32 kernel's on the upcast cube,
// bit for bit.  A bulk copy needs 16-byte rows: 8 bf16 elements, so TMA
// takes nbin a multiple of 8 there (4 for float32); the weights stay
// float32 (nchan a multiple of 4).  Bound: 2 * nsub * nchan * nbin bytes,
// half the float32 cube's.

#include "common.cuh"

#define ICLN_MARG_THREADS 256
#define ICLN_MARG_J 32      // channels per thread
#define ICLN_MARG_STAGES 3

struct MargArgs {
  const void* disp;   // (nb, nsub, nchan, nbin) float or icln_bf16: archive blockIdx.z
  const float* w;
  float* a_part;   // (nb, nsb, nchan, nbin)
  float* t1_part;  // (nb, ncb, nsub, nbin)
  int nsub, nchan, nbin;
  int sb, cb, bb;  // subints per run, channels and bins per tile
  int lanes;       // bin lanes per channel group (a power of two >= bb)
  int ncb;         // channel tiles
  int nsb;         // subint runs
};

// bytes of one stage: the slab of `es`-byte elements at pitch bb, then
// the tile's float32 weights
__host__ __device__ inline int icln_marg_stage_bytes(int cb, int bb, int es) {
  return cb * bb * es + cb * (int)sizeof(float);
}

// Issue the bulk copies of subint s of this block's tile into `st`.
template <class T>
static __device__ void icln_marg_issue(const MargArgs& p, const T* disp, int s, int c0,
                                       int cn, int b0, int bn, unsigned char* st,
                                       uint64_t* bar) {
  const size_t row0 = (size_t)s * p.nchan + c0;
  T* slab = reinterpret_cast<T*>(st);
  icln_mbar_arrive_tx(bar, (unsigned)(cn * bn * sizeof(T) + cn * sizeof(float)));
  if (bn == p.nbin) {
    icln_bulk_load(slab, disp + row0 * p.nbin, (unsigned)(cn * bn * sizeof(T)), bar);
  } else {
    for (int c = 0; c < cn; ++c)
      icln_bulk_load(slab + c * p.bb, disp + (row0 + c) * p.nbin + b0,
                     (unsigned)(bn * sizeof(T)), bar);
  }
  icln_bulk_load(st + (size_t)p.cb * p.bb * sizeof(T), p.w + row0,
                 (unsigned)(cn * sizeof(float)), bar);
}

template <class T, bool TMA>
__global__ void __launch_bounds__(ICLN_MARG_THREADS)
    icln_marginals_kernel(MargArgs p) {
  const T* disp;
  {  // this block's archive
    const size_t z = blockIdx.z, cells = (size_t)p.nsub * p.nchan;
    disp = static_cast<const T*>(p.disp) + z * cells * p.nbin;
    p.w += z * cells;
    p.a_part += z * p.nsb * (size_t)p.nchan * p.nbin;
    p.t1_part += z * p.ncb * (size_t)p.nsub * p.nbin;
  }
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw);  // ICLN_MARG_STAGES
  float* red = reinterpret_cast<float*>(smem_raw + 32);    // 2 x 256
  unsigned char* stages = smem_raw + 32 + 2 * ICLN_MARG_THREADS * sizeof(float);
  const int sbytes = icln_marg_stage_bytes(p.cb, p.bb, (int)sizeof(T));
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
        icln_marg_issue<T>(p, disp, s0 + i, c0, cn, b0, bn, stages + i * sbytes, &bar[i]);
  }

  float acc[ICLN_MARG_J];
#pragma unroll
  for (int j = 0; j < ICLN_MARG_J; ++j) acc[j] = 0.0f;

  for (int i = 0; i < sn; ++i) {
    const int slot = i % ICLN_MARG_STAGES;
    const T* st = reinterpret_cast<const T*>(stages + slot * sbytes);
    const float* wst = reinterpret_cast<const float*>(st + p.cb * p.bb);
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
            v = icln_f32(st[c * p.bb + lb]);
            wc = wst[c];
          } else {
            v = icln_f32(disp[(srow * p.nchan + c0 + c) * p.nbin + b0 + lb]);
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
      icln_marg_issue<T>(p, disp, s0 + i + ICLN_MARG_STAGES, c0, cn, b0, bn,
                         stages + slot * sbytes, &bar[slot]);
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

// out[z, i] = sum_p part[z, p, i] for archive z = blockIdx.y, partials
// added in index order.
__global__ void icln_sum_parts(const float* __restrict__ part,
                               float* __restrict__ out, int nparts, size_t n) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  part += (size_t)blockIdx.y * nparts * n;
  float t = 0.0f;
  for (int p = 0; p < nparts; ++p) t += part[(size_t)p * n + i];
  out[(size_t)blockIdx.y * n + i] = t;
}

template <class T, bool TMA>
static cudaError_t icln_marginals_start(const MargArgs& p, dim3 grid, long long smem_bytes,
                                        cudaStream_t st) {
  const cudaError_t err =
      cudaFuncSetAttribute(icln_marginals_kernel<T, TMA>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
  if (err != cudaSuccess) return err;
  icln_marginals_kernel<T, TMA><<<grid, ICLN_MARG_THREADS, (size_t)smem_bytes, st>>>(p);
  return cudaGetLastError();
}

// `bf16`: the cube is bf16-stored (icln_bf16 elements), else float32.
extern "C" int icln_weighted_marginals(const void* disp, const float* w,
                                       float* a_part, float* t1_part,
                                       float* a, float* t1, int nb, int nsub,
                                       int nchan, int nbin, int sb, int cb, int bb,
                                       int lanes, int bf16, long long smem_bytes,
                                       void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int nbt = (nbin + bb - 1) / bb, nsb = (nsub + sb - 1) / sb;
  const int es = bf16 ? (int)sizeof(icln_bf16) : (int)sizeof(float);
  MargArgs p{disp, w, a_part, t1_part, nsub, nchan, nbin, sb, cb, bb, lanes,
             (nchan + cb - 1) / cb, nsb};
  const long long need = 32 + 2LL * ICLN_MARG_THREADS * sizeof(float)
                         + (long long)ICLN_MARG_STAGES * icln_marg_stage_bytes(cb, bb, es);
  if (need > smem_bytes || cb != (ICLN_MARG_THREADS / lanes) * ICLN_MARG_J || bb > lanes
      || nb < 1 || nb > 65535)
    return (int)cudaErrorInvalidValue;
  // every archive's cube slab and weights start 16-byte aligned: the first
  // one's pointers, and the archive strides a multiple of 16 bytes; a row
  // of bins is whole 16-byte words (4 float32 or 8 bf16 elements)
  const size_t cells = (size_t)nsub * nchan;
  const bool tma = nbin % (16 / es) == 0 && nchan % 4 == 0 && (uintptr_t)disp % 16 == 0
                   && (uintptr_t)w % 16 == 0 && (cells * nbin * es) % 16 == 0
                   && (cells * sizeof(float)) % 16 == 0;
  const dim3 grid((unsigned)(p.ncb * nbt), (unsigned)nsb, (unsigned)nb);
  cudaError_t err;
  if (bf16)
    err = tma ? icln_marginals_start<icln_bf16, true>(p, grid, smem_bytes, st)
              : icln_marginals_start<icln_bf16, false>(p, grid, smem_bytes, st);
  else
    err = tma ? icln_marginals_start<float, true>(p, grid, smem_bytes, st)
              : icln_marginals_start<float, false>(p, grid, smem_bytes, st);
  if (err != cudaSuccess) return (int)err;
  const size_t na = (size_t)nchan * nbin, nt = (size_t)nsub * nbin;
  icln_sum_parts<<<dim3((unsigned)((na + 255) / 256), (unsigned)nb), 256, 0, st>>>(
      a_part, a, nsb, na);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  icln_sum_parts<<<dim3((unsigned)((nt + 255) / 256), (unsigned)nb), 256, 0, st>>>(
      t1_part, t1, p.ncb, nt);
  return (int)cudaGetLastError();
}

extern "C" const char* icln_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
