// Shared device helpers of the port's kernels: the order-preserving
// float -> integer key maps of the exact k-th select (float32 -> int32,
// float64 -> int64), NaN-propagating min/max (the reductions the
// reference's compiler lowers jnp.max/min and jnp.maximum to), and
// warp/block reductions with a fixed order.
//
// Build with -fmad=false: the kernels reproduce the reference's op
// sequences, and a contracted multiply-add would round differently.
// Where a kernel wants a fused multiply-add (the DFT), it says so with
// __fmaf_rn / __fma_rn (icln_fma).
#pragma once

#include <climits>
#include <cmath>
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

// a refused call's error, taken off the runtime's last-error state so
// that the next launch's check does not report it again (the cluster
// kernels' launches)
static inline cudaError_t icln_take_error(cudaError_t err) {
  cudaGetLastError();
  return err;
}

#define ICLN_KEY_MASKED 0x7F800000  // key of +inf: the masked sentinel
#define ICLN_KEY64_MASKED 0x7FF0000000000000LL  // key of +inf as a double

__device__ __forceinline__ int icln_ordered_key(float x) {
  // signed int order of the key == float order; NaN above +inf
  const int b = __float_as_int(x);
  return b ^ ((b >> 31) & 0x7FFFFFFF);
}

__device__ __forceinline__ float icln_key_to_float(int o) {
  // the map is an involution
  return __int_as_float(o ^ ((o >> 31) & 0x7FFFFFFF));
}

// the float64 keys: signed int64 order == double order, NaN above +inf,
// -0 below +0 (as the 32-bit keys)
__device__ __forceinline__ long long icln_ordered_key(double x) {
  const long long b = __double_as_longlong(x);
  return b ^ ((b >> 63) & 0x7FFFFFFFFFFFFFFFLL);
}

__device__ __forceinline__ double icln_key_to_double(long long o) {
  return __longlong_as_double(o ^ ((o >> 63) & 0x7FFFFFFFFFFFFFFFLL));
}

// The key type of each value type, for the selects (K3, K9) and the
// combine: Key (signed, the value order), Radix (unsigned, the same
// order: key ^ the sign bit), kPasses 8-bit digits, the masked sentinel.
template <class T>
struct IclnKeys;

template <>
struct IclnKeys<float> {
  using Key = int;
  using Radix = unsigned;
  static constexpr int kPasses = 4;
  static constexpr Key kMasked = ICLN_KEY_MASKED;
  static constexpr Key kLowest = INT_MIN;
  static constexpr Key kHighest = INT_MAX;
  static __device__ __forceinline__ Key key(float x) { return icln_ordered_key(x); }
  static __device__ __forceinline__ float value(Key k) { return icln_key_to_float(k); }
  static __device__ __forceinline__ Radix radix(Key k) { return (unsigned)k ^ 0x80000000u; }
  static __device__ __forceinline__ Key from_radix(Radix r) { return (int)(r ^ 0x80000000u); }
};

template <>
struct IclnKeys<double> {
  using Key = long long;
  using Radix = unsigned long long;
  static constexpr int kPasses = 8;
  static constexpr Key kMasked = ICLN_KEY64_MASKED;
  static constexpr Key kLowest = LLONG_MIN;
  static constexpr Key kHighest = LLONG_MAX;
  static __device__ __forceinline__ Key key(double x) { return icln_ordered_key(x); }
  static __device__ __forceinline__ double value(Key k) { return icln_key_to_double(k); }
  static __device__ __forceinline__ Radix radix(Key k) {
    return (unsigned long long)k ^ 0x8000000000000000ull;
  }
  static __device__ __forceinline__ Key from_radix(Radix r) {
    return (long long)(r ^ 0x8000000000000000ull);
  }
};

// A bf16-stored cube element (the mixed-precision mode): the high 16 bits
// of a float32, so the upcast is a shift and exact.  K1, K2, K6, K7 and
// K10 read every cube element through icln_real / icln_ldr, the one
// upcast point of each, as the TPU kernels upcast each staged block.
struct icln_bf16 {
  unsigned short bits;
};

// The arithmetic type of a cube element type: float for float32 and
// bf16 storage, double for float64 (storage and arithmetic alike).
template <class T>
struct IclnReal {
  using type = float;
};

template <>
struct IclnReal<double> {
  using type = double;
};

template <class T>
using icln_real_t = typename IclnReal<T>::type;

__device__ __forceinline__ float icln_real(float x) { return x; }

__device__ __forceinline__ double icln_real(double x) { return x; }

__device__ __forceinline__ float icln_real(icln_bf16 x) {
  return __uint_as_float((unsigned)x.bits << 16);
}

// a read-only (__ldg) load of a cube element, in its arithmetic type
__device__ __forceinline__ float icln_ldr(const float* p) { return __ldg(p); }

__device__ __forceinline__ double icln_ldr(const double* p) { return __ldg(p); }

__device__ __forceinline__ float icln_ldr(const icln_bf16* p) {
  return __uint_as_float((unsigned)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
}

__device__ __forceinline__ float icln_fma(float a, float b, float c) { return __fmaf_rn(a, b, c); }

__device__ __forceinline__ double icln_fma(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

__device__ __forceinline__ float icln_abs(float x) { return fabsf(x); }

__device__ __forceinline__ double icln_abs(double x) { return fabs(x); }

__device__ __forceinline__ float icln_sqrt(float x) { return sqrtf(x); }

__device__ __forceinline__ double icln_sqrt(double x) { return sqrt(x); }

// numpy.ma's float fill value, as the value type rounds it
template <class R>
__device__ __forceinline__ R icln_ma_fill();

template <>
__device__ __forceinline__ float icln_ma_fill<float>() { return 1e20f; }

template <>
__device__ __forceinline__ double icln_ma_fill<double>() { return 1e20; }

__device__ __forceinline__ float icln_nan() { return __int_as_float(0x7FC00000); }

// the quiet NaN of the value type
template <class R>
__device__ __forceinline__ R icln_nan_of() {
  return icln_nan();
}

template <>
__device__ __forceinline__ double icln_nan_of<double>() {
  return __longlong_as_double(0x7FF8000000000000LL);
}

__device__ __forceinline__ bool icln_isnan(float x) { return x != x; }

__device__ __forceinline__ bool icln_isnan(double x) { return x != x; }

__device__ __forceinline__ float icln_max(float a, float b) {
  return (icln_isnan(a) || icln_isnan(b)) ? icln_nan() : fmaxf(a, b);
}

__device__ __forceinline__ float icln_min(float a, float b) {
  return (icln_isnan(a) || icln_isnan(b)) ? icln_nan() : fminf(a, b);
}

__device__ __forceinline__ double icln_max(double a, double b) {
  return (icln_isnan(a) || icln_isnan(b)) ? icln_nan_of<double>() : fmax(a, b);
}

__device__ __forceinline__ double icln_min(double a, double b) {
  return (icln_isnan(a) || icln_isnan(b)) ? icln_nan_of<double>() : fmin(a, b);
}

template <class R>
__device__ __forceinline__ R icln_warp_sum(R v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <class R>
__device__ __forceinline__ R icln_warp_max(R v) {
  for (int o = 16; o > 0; o >>= 1)
    v = icln_max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <class R>
__device__ __forceinline__ R icln_warp_min(R v) {
  for (int o = 16; o > 0; o >>= 1)
    v = icln_min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int icln_warp_sum_int(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int icln_warp_min_int(int v) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int icln_warp_max_int(int v) {
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide integer reductions with ONE __syncthreads each: the warp
// partials go to one of two 32-slot halves of `red` (alternating per
// call through `parity`), and every thread folds them itself.  A half is
// rewritten two calls later, after a barrier every thread reaches only
// once it has finished reading it.  Integer ops: exact in any order.
enum IclnOp { ICLN_SUM, ICLN_MIN, ICLN_MAX };

template <IclnOp OP>
__device__ __forceinline__ int icln_block_reduce_int(int v, int* red, int& parity) {
  if (OP == ICLN_SUM) v = icln_warp_sum_int(v);
  if (OP == ICLN_MIN) v = icln_warp_min_int(v);
  if (OP == ICLN_MAX) v = icln_warp_max_int(v);
  int* half = red + 32 * parity;
  parity ^= 1;
  if ((threadIdx.x & 31) == 0) half[threadIdx.x >> 5] = v;
  __syncthreads();
  const int nw = blockDim.x >> 5;
  int r = half[0];
  for (int i = 1; i < nw; ++i) {
    if (OP == ICLN_SUM) r += half[i];
    if (OP == ICLN_MIN) r = min(r, half[i]);
    if (OP == ICLN_MAX) r = max(r, half[i]);
  }
  return r;
}

// ---- The exact median select: a radix select over the ordered keys ----
//
// The select of the reference's _select_kth / _select_adjacent /
// _masked_median_lanes (pallas_kernels.py:136-213), ported once for K3
// and K9.  Over a line's keys, nv of them valid (masked entries hold the
// masked key, +inf's, and stay in the population): lo is the k_lo-th key,
// k_lo = max(nv-1, 0)/2; hi is lo when more than k_hi = nv/2 keys lie at
// or below lo, else the least key above lo; the median 0.5*(lo+hi) in the
// value type, 0 for a line with no valid entry.  The select is exact, so
// any algorithm finding these keys gives the reference's bits.
//
// 8-bit passes over the keys' radix, key ^ the sign bit (unsigned order
// == signed key order): four for the 32-bit keys of float32, eight for
// the 64-bit keys of float64.  Pass p histograms digit p of the keys
// whose higher digits equal the prefix found so far, then one warp scans
// the 256 bins for the digit holding the remaining rank.  The keys below
// lo are summed on the way and the last pass counts the keys equal to
// lo, which tells whether hi is lo; where it is not, hi is the next
// nonempty bin of the last pass's bucket, or the least key above that
// bucket, which the last pass also takes: no pass of its own.

#define ICLN_FULL 0xffffffffu
#define ICLN_LOAD_BATCH 4   // entries a thread loads before it uses any
#define ICLN_SEL_LINES 32  // most lines one block selects in one chain

// unsigned order of the digits == signed order of the keys
__device__ __forceinline__ unsigned icln_radix(int key) { return (unsigned)key ^ 0x80000000u; }

__device__ __forceinline__ int icln_sel_klo(int nv) { return max(nv - 1, 0) / 2; }

struct IclnPick {
  int digit;  // the digit holding rank k
  int below;  // keys in the bins below it
  int count;  // keys in its bin
};

// One warp, lane l holding bins 8l..8l+7 in b: the least digit with more
// than k keys in the bins up to and including it (255 when none has), by
// an inclusive scan of the lanes' sums and a ballot.  Every lane gets it.
__device__ __forceinline__ IclnPick icln_warp_pick(const int (&b)[8], int k) {
  const int lane = threadIdx.x & 31;
  int s = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) s += b[i];
  int incl = s;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(ICLN_FULL, incl, o);
    if (lane >= o) incl += t;
  }
  const unsigned over = __ballot_sync(ICLN_FULL, incl > k);
  const int src = over ? __ffs(over) - 1 : 31;
  int below = incl - s, digit = 8 * lane + 7, count = b[7];
  bool found = false;
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    if (!found && below + b[i] > k) {
      digit = 8 * lane + i;
      count = b[i];
      found = true;
    }
    if (!found) below += b[i];
  }
  IclnPick p;
  p.digit = __shfl_sync(ICLN_FULL, digit, src);
  p.below = __shfl_sync(ICLN_FULL, below, src);
  p.count = __shfl_sync(ICLN_FULL, count, src);
  return p;
}

// The select's per-line state, in shared memory for the block select, of
// the keys of value type T.
template <class T>
struct IclnSelState {
  using Key = typename IclnKeys<T>::Key;
  using Radix = typename IclnKeys<T>::Radix;
  int nv[ICLN_SEL_LINES];          // valid entries (set by the caller)
  int moff[ICLN_SEL_LINES];        // the line's mask words, or -1 (set by the caller)
  Radix prefix[ICLN_SEL_LINES];    // digits of lo found so far
  int krem[ICLN_SEL_LINES];        // rank left inside the prefix's bucket
  int clast[ICLN_SEL_LINES];       // keys equal to lo (after the last pass)
  Radix above[ICLN_SEL_LINES];     // least radix above the last pass's bucket
  Key succ[ICLN_SEL_LINES];        // least key above lo
};

// Does line m need the successor pass: are there at most k_hi keys at or
// below lo (the keys below lo, k_lo - krem, and those equal, clast)?
template <class T>
__device__ __forceinline__ bool icln_sel_needs_successor(const IclnSelState<T>& st, int m) {
  const int nv = st.nv[m];
  return nv > 0 && icln_sel_klo(nv) - st.krem[m] + st.clast[m] <= nv / 2;
}

template <class T>
__device__ __forceinline__ T icln_sel_median_of(typename IclnKeys<T>::Key lo,
                                                typename IclnKeys<T>::Key hi, int nv) {
  using IK = IclnKeys<T>;
  const T med = T(0.5) * (IK::value(lo) + IK::value(hi));
  return nv == 0 ? T(0) : med;
}

template <class T>
__device__ __forceinline__ T icln_sel_median(const IclnSelState<T>& st, int m) {
  using IK = IclnKeys<T>;
  const typename IK::Key lo = IK::from_radix(st.prefix[m]);
  return icln_sel_median_of<T>(lo, icln_sel_needs_successor(st, m) ? st.succ[m] : lo, st.nv[m]);
}

// Shared-memory keys a line of n takes in a block select: n rounded up
// to 32, plus 4, so that rows stay 16-byte aligned and the same entry of
// adjacent lines falls 4 (32-bit keys) or 8 (64-bit keys) banks apart.
__device__ __forceinline__ int icln_key_stride(int n) { return ((n + 31) & ~31) + 4; }

#define ICLN_SEL_CHUNK 256  // entries of a line a warp takes at a time: 8 a lane

// The least radix above lo, from the last pass's bins of lo's bucket (lane
// l holding bins 8l..8l+7 in b; lo's digit `digit`, the bucket's prefix
// `bucket`): the next nonempty bin's radix, else `above`, the least radix
// above the bucket.  Every lane of the warp gets it.
template <class U>
__device__ __forceinline__ U icln_successor_radix(const int (&b)[8], int digit, U bucket,
                                                  U above) {
  const int lane = threadIdx.x & 31;
  int next = 256;
#pragma unroll
  for (int i = 7; i >= 0; --i)
    if (b[i] > 0 && 8 * lane + i > digit) next = 8 * lane + i;
  next = icln_warp_min_int(next);
  return next < 256 ? (bucket << 8) | (U)next : above;
}

// Eight consecutive keys from shared memory, 16-byte aligned: two 16-byte
// loads of 32-bit keys, four of 64-bit ones.
__device__ __forceinline__ void icln_load8(const int* k, int (&q)[8]) {
  const int4 v0 = *reinterpret_cast<const int4*>(k);
  const int4 v1 = *reinterpret_cast<const int4*>(k + 4);
  q[0] = v0.x, q[1] = v0.y, q[2] = v0.z, q[3] = v0.w;
  q[4] = v1.x, q[5] = v1.y, q[6] = v1.z, q[7] = v1.w;
}

__device__ __forceinline__ void icln_load8(const long long* k, long long (&q)[8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const longlong2 v = *reinterpret_cast<const longlong2*>(k + 2 * i);
    q[2 * i] = v.x;
    q[2 * i + 1] = v.y;
  }
}

// Block select over M <= ICLN_SEL_LINES lines of n keys of value type T
// in shared memory (line m at keys + m * icln_key_stride(n), 16-byte
// aligned), each with its own 256 bins in hist: every pass serves all M
// lines, so the chain is kPasses passes (4 for float32, 8 for float64) of
// two barriers each.  A pass's work is cut into chunks of ICLN_SEL_CHUNK
// entries of one line, dealt out to the warps in turn: a lane reads eight
// keys with 16-byte loads and adds each counted digit to its bin with an
// int32 shared atomic (exact in any order).  The last pass also takes the
// least key above its bucket, so the least key above lo (the median's
// upper middle where lo's run ends at k_lo) comes from its bins or that
// minimum, with no pass of its own.  Line m's masked entries are the set
// bits of mbits + st.moff[m] (one word a 32 entries) and take the masked
// key whatever their key slot holds; a line with moff -1 has none.  Call
// with st.nv and st.moff set, hist zero and a barrier after them; returns
// with hist zero again, a barrier after the last read of the keys, and
// icln_sel_median(st, m) readable by every thread.
template <class T>
__device__ inline void icln_block_select(const typename IclnKeys<T>::Key* keys, int n, int M,
                                         int* hist, const unsigned* mbits,
                                         IclnSelState<T>& st) {
  using IK = IclnKeys<T>;
  using Key = typename IK::Key;
  using Radix = typename IK::Radix;
  constexpr int kPasses = IK::kPasses;
  constexpr Radix kNone = ~(Radix)0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int ls = icln_key_stride(n);
  const int cpl = (n + ICLN_SEL_CHUNK - 1) / ICLN_SEL_CHUNK;  // chunks a line
  for (int pass = 0; pass < kPasses; ++pass) {
    const int shift = 8 * (kPasses - 1 - pass);
    const bool last = pass == kPasses - 1;
    for (int it = warp; it < M * cpl; it += nwarps) {
      const int m = it / cpl;
      const int e = (it - m * cpl) * ICLN_SEL_CHUNK + 8 * lane;
      const int lim = min(8, n - e);  // this lane's entries: 8, fewer at the end
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
    for (int m = warp; m < M; m += nwarps) {
      int* h = hist + m * 256 + 8 * lane;
      int b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) b[i] = h[i];
#pragma unroll
      for (int i = 0; i < 8; ++i) h[i] = 0;
      const int k = pass == 0 ? icln_sel_klo(st.nv[m]) : st.krem[m];
      const IclnPick p = icln_warp_pick(b, k);
      const Radix succ =
          last ? icln_successor_radix<Radix>(b, p.digit, st.prefix[m], st.above[m]) : (Radix)0;
      if (lane == 0) {
        st.krem[m] = k - p.below;
        st.prefix[m] = pass == 0 ? (Radix)p.digit : (st.prefix[m] << 8) | (Radix)p.digit;
        st.clast[m] = p.count;
        st.above[m] = kNone;
        st.succ[m] = IK::from_radix(succ);
      }
    }
    __syncthreads();
  }
}

// The per-line sums of a block whose thread t always works on line
// t % W of its W lines (W a power of two <= 32): the lanes of a warp on
// one line fold their values, and lane c < W adds line c's into dst[c].
__device__ __forceinline__ void icln_lines_add(int v, int W, int* dst) {
  for (int o = 16; o >= W; o >>= 1) v += __shfl_xor_sync(ICLN_FULL, v, o);
  if ((threadIdx.x & 31) < W && v) atomicAdd(&dst[threadIdx.x & 31], v);
}

__device__ __forceinline__ void icln_lines_or(int v, int W, int* dst) {
  for (int o = 16; o >= W; o >>= 1) v |= __shfl_xor_sync(ICLN_FULL, v, o);
  if ((threadIdx.x & 31) < W && v) atomicOr(&dst[threadIdx.x & 31], v);
}

// ---- Hopper's bulk copies (TMA, 1-D) completing on an mbarrier ----
// One thread arms a stage's barrier with the bytes it expects and issues
// the copy; the consumers wait on the barrier's phase parity.  Source,
// destination and size must be multiples of 16 bytes.

__device__ __forceinline__ unsigned icln_smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void icln_mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(icln_smem_addr(bar)),
               "r"(count) : "memory");
}

// make the barriers' initialisation visible to the async proxy
__device__ __forceinline__ void icln_mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void icln_mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(icln_smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void icln_mbar_arrive_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   icln_smem_addr(bar)),
               "r"(bytes) : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void icln_mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned a = icln_smem_addr(bar);
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
  }
}

// order this thread's (and, after a block barrier, the block's) earlier
// shared-memory accesses before the async proxy's next writes
__device__ __forceinline__ void icln_fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void icln_bulk_load(void* dst, const void* src, unsigned bytes,
                                               uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(icln_smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(icln_smem_addr(bar))
      : "memory");
}
