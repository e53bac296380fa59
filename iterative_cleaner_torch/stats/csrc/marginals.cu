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
//
// A float64 cube (dtype="float64"; the reference's float64 route is its
// XLA einsum pair, no TPU kernel) is the same kernel in double: the
// weights, every sum, the partials and the outputs double, the same
// fixed-order partials and second pass, no float atomics.  Its slabs are
// 8-byte elements, so a stage holds twice the float32 stage's bytes and
// the ring has two stages, not three (64 KB each at 128 bins: one block
// an SM, 128 KB in flight); TMA takes nbin even and nchan even.  Bound:
// 8 * nsub * nchan * nbin bytes, 4.29 GB at 1024x4096x128, 1.28 ms at
// 3.35 TB/s.

#include "common.cuh"

#define ICLN_MARG_THREADS 256
#define ICLN_MARG_J 32      // channels per thread
#define ICLN_MARG_STAGES 3  // float32 and bf16 cubes; float64 takes 2

// the stages of the ring for cube elements of type T
template <class T>
__host__ __device__ constexpr int icln_marg_stages() {
  return sizeof(T) == 8 ? 2 : ICLN_MARG_STAGES;
}

template <class R>
struct MargArgs {
  const void* disp;   // (nb, nsub, nchan, nbin) float, icln_bf16 or double: archive blockIdx.z
  const R* w;
  R* a_part;   // (nb, nsb, nchan, nbin)
  R* t1_part;  // (nb, ncb, nsub, nbin)
  int nsub, nchan, nbin;
  int sb, cb, bb;  // subints per run, channels and bins per tile
  int lanes;       // bin lanes per channel group (a power of two >= bb)
  int ncb;         // channel tiles
  int nsb;         // subint runs
};

// bytes of one stage: the slab of `es`-byte elements at pitch bb, then
// the tile's weights of `ws` bytes each
__host__ __device__ inline int icln_marg_stage_bytes(int cb, int bb, int es, int ws) {
  return cb * bb * es + cb * ws;
}

// Issue the bulk copies of subint s of this block's tile into `st`.
template <class T, class R>
static __device__ void icln_marg_issue(const MargArgs<R>& p, const T* disp, int s, int c0,
                                       int cn, int b0, int bn, unsigned char* st,
                                       uint64_t* bar) {
  const size_t row0 = (size_t)s * p.nchan + c0;
  T* slab = reinterpret_cast<T*>(st);
  icln_mbar_arrive_tx(bar, (unsigned)(cn * bn * sizeof(T) + cn * sizeof(R)));
  if (bn == p.nbin) {
    icln_bulk_load(slab, disp + row0 * p.nbin, (unsigned)(cn * bn * sizeof(T)), bar);
  } else {
    for (int c = 0; c < cn; ++c)
      icln_bulk_load(slab + c * p.bb, disp + (row0 + c) * p.nbin + b0,
                     (unsigned)(bn * sizeof(T)), bar);
  }
  icln_bulk_load(st + (size_t)p.cb * p.bb * sizeof(T), p.w + row0,
                 (unsigned)(cn * sizeof(R)), bar);
}

template <class T, bool TMA>
__global__ void __launch_bounds__(ICLN_MARG_THREADS)
    icln_marginals_kernel(MargArgs<icln_real_t<T>> p) {
  using R = icln_real_t<T>;
  constexpr int kStages = icln_marg_stages<T>();
  const T* disp;
  {  // this block's archive
    const size_t z = blockIdx.z, cells = (size_t)p.nsub * p.nchan;
    disp = static_cast<const T*>(p.disp) + z * cells * p.nbin;
    p.w += z * cells;
    p.a_part += z * p.nsb * (size_t)p.nchan * p.nbin;
    p.t1_part += z * p.ncb * (size_t)p.nsub * p.nbin;
  }
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw);  // kStages
  R* red = reinterpret_cast<R*>(smem_raw + 32);           // 2 x 256
  unsigned char* stages = smem_raw + 32 + 2 * ICLN_MARG_THREADS * sizeof(R);
  const int sbytes = icln_marg_stage_bytes(p.cb, p.bb, (int)sizeof(T), (int)sizeof(R));
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
      for (int i = 0; i < kStages; ++i) icln_mbar_init(&bar[i], 1);
      icln_mbar_init_fence();
    }
    __syncthreads();
    if (tid == 0)
      for (int i = 0; i < min(kStages, sn); ++i)
        icln_marg_issue<T>(p, disp, s0 + i, c0, cn, b0, bn, stages + i * sbytes, &bar[i]);
  }

  R acc[ICLN_MARG_J];
#pragma unroll
  for (int j = 0; j < ICLN_MARG_J; ++j) acc[j] = R(0);

  for (int i = 0; i < sn; ++i) {
    const int slot = i % kStages;
    const T* st = reinterpret_cast<const T*>(stages + slot * sbytes);
    const R* wst = reinterpret_cast<const R*>(st + p.cb * p.bb);
    const size_t srow = (size_t)(s0 + i);
    if (TMA) icln_mbar_wait(&bar[slot], (unsigned)((i / kStages) & 1));
    R t = R(0);
    if (live) {
#pragma unroll
      for (int j = 0; j < ICLN_MARG_J; ++j) {
        const int c = j * G + g;
        if (c < cn) {
          R v, wc;
          if (TMA) {
            v = icln_real(st[c * p.bb + lb]);
            wc = wst[c];
          } else {
            v = icln_real(disp[(srow * p.nchan + c0 + c) * p.nbin + b0 + lb]);
            wc = p.w[srow * p.nchan + c0 + c];
          }
          const R x = v * wc;
          acc[j] += x;
          t += x;
        }
      }
    }
    R* t1_out = p.t1_part + ((size_t)cblk * p.nsub + srow) * p.nbin + b0;
    if (G == 1) {
      if (live) t1_out[lb] = t;
    } else {
      red[(i & 1) * ICLN_MARG_THREADS + tid] = t;
    }
    __syncthreads();  // the stage is consumed; the group partials are in
    if (G > 1 && g == 0 && live) {
      const R* r = red + (i & 1) * ICLN_MARG_THREADS + lb;
      R tt = r[0];
      for (int q = 1; q < G; ++q) tt += r[q * p.lanes];
      t1_out[lb] = tt;
    }
    if (TMA && tid == 0 && i + kStages < sn) {
      icln_fence_proxy_async();
      icln_marg_issue<T>(p, disp, s0 + i + kStages, c0, cn, b0, bn, stages + slot * sbytes,
                         &bar[slot]);
    }
  }
  if (live) {
    R* a_out = p.a_part + ((size_t)sblk * p.nchan + c0) * p.nbin + b0 + lb;
#pragma unroll
    for (int j = 0; j < ICLN_MARG_J; ++j) {
      const int c = j * G + g;
      if (c < cn) a_out[(size_t)c * p.nbin] = acc[j];
    }
  }
}

// out[z, i] = sum_p part[z, p, i] for archive z = blockIdx.y, partials
// added in index order.
template <class R>
__global__ void icln_sum_parts(const R* __restrict__ part, R* __restrict__ out, int nparts,
                               size_t n) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  part += (size_t)blockIdx.y * nparts * n;
  R t = R(0);
  for (int p = 0; p < nparts; ++p) t += part[(size_t)p * n + i];
  out[(size_t)blockIdx.y * n + i] = t;
}

template <class T, bool TMA>
static cudaError_t icln_marginals_start(const MargArgs<icln_real_t<T>>& p, dim3 grid,
                                        long long smem_bytes, cudaStream_t st) {
  const cudaError_t err =
      cudaFuncSetAttribute(icln_marginals_kernel<T, TMA>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
  if (err != cudaSuccess) return err;
  icln_marginals_kernel<T, TMA><<<grid, ICLN_MARG_THREADS, (size_t)smem_bytes, st>>>(p);
  return cudaGetLastError();
}

template <class T>
static int icln_marginals_t(const void* disp, const void* w, void* a_part, void* t1_part,
                            void* a, void* t1, int nb, int nsub, int nchan, int nbin, int sb,
                            int cb, int bb, int lanes, long long smem_bytes, cudaStream_t st) {
  using R = icln_real_t<T>;
  const int nbt = (nbin + bb - 1) / bb, nsb = (nsub + sb - 1) / sb;
  const int es = (int)sizeof(T), ws = (int)sizeof(R);
  MargArgs<R> p{disp, static_cast<const R*>(w), static_cast<R*>(a_part),
                static_cast<R*>(t1_part), nsub, nchan, nbin, sb, cb, bb, lanes,
                (nchan + cb - 1) / cb, nsb};
  const long long need = 32 + 2LL * ICLN_MARG_THREADS * ws
                         + (long long)icln_marg_stages<T>() * icln_marg_stage_bytes(cb, bb, es, ws);
  if (need > smem_bytes || cb != (ICLN_MARG_THREADS / lanes) * ICLN_MARG_J || bb > lanes
      || nb < 1 || nb > 65535)
    return (int)cudaErrorInvalidValue;
  // every archive's cube slab and weights start 16-byte aligned: the first
  // one's pointers, and the archive strides a multiple of 16 bytes; a row
  // of bins is whole 16-byte words (4 float32, 8 bf16 or 2 float64
  // elements), and so is a tile's row of weights
  const size_t cells = (size_t)nsub * nchan;
  const bool tma = nbin % (16 / es) == 0 && nchan % (16 / ws) == 0 && (uintptr_t)disp % 16 == 0
                   && (uintptr_t)w % 16 == 0 && (cells * nbin * es) % 16 == 0
                   && (cells * ws) % 16 == 0;
  const dim3 grid((unsigned)(p.ncb * nbt), (unsigned)nsb, (unsigned)nb);
  cudaError_t err = tma ? icln_marginals_start<T, true>(p, grid, smem_bytes, st)
                        : icln_marginals_start<T, false>(p, grid, smem_bytes, st);
  if (err != cudaSuccess) return (int)err;
  const size_t na = (size_t)nchan * nbin, nt = (size_t)nsub * nbin;
  icln_sum_parts<R><<<dim3((unsigned)((na + 255) / 256), (unsigned)nb), 256, 0, st>>>(
      p.a_part, static_cast<R*>(a), nsb, na);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  icln_sum_parts<R><<<dim3((unsigned)((nt + 255) / 256), (unsigned)nb), 256, 0, st>>>(
      p.t1_part, static_cast<R*>(t1), p.ncb, nt);
  return (int)cudaGetLastError();
}

// `kind`: the cube's storage, 0 float32, 1 bf16 (icln_bf16 elements; the
// weights and outputs float32), 2 float64 (weights and outputs double).
extern "C" int icln_weighted_marginals(const void* disp, const void* w, void* a_part,
                                       void* t1_part, void* a, void* t1, int nb, int nsub,
                                       int nchan, int nbin, int sb, int cb, int bb, int lanes,
                                       int kind, long long smem_bytes, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (kind) {
    case 0:
      return icln_marginals_t<float>(disp, w, a_part, t1_part, a, t1, nb, nsub, nchan, nbin, sb,
                                     cb, bb, lanes, smem_bytes, st);
    case 1:
      return icln_marginals_t<icln_bf16>(disp, w, a_part, t1_part, a, t1, nb, nsub, nchan, nbin,
                                         sb, cb, bb, lanes, smem_bytes, st);
    case 2:
      return icln_marginals_t<double>(disp, w, a_part, t1_part, a, t1, nb, nsub, nchan, nbin,
                                      sb, cb, bb, lanes, smem_bytes, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* icln_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
