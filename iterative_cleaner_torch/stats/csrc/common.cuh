// Shared device helpers of the port's kernels: the order-preserving
// float32 -> int32 key map of the exact k-th select, NaN-propagating
// min/max (the reductions the reference's compiler lowers jnp.max/min
// and jnp.maximum to), and warp/block reductions with a fixed order.
//
// Build with -fmad=false: the kernels reproduce the reference's float32
// op sequences, and a contracted multiply-add would round differently.
// Where a kernel wants a fused multiply-add (the DFT), it says so with
// __fmaf_rn.
#pragma once

#include <climits>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#define ICLN_KEY_MASKED 0x7F800000  // key of +inf: the masked sentinel

__device__ __forceinline__ int icln_ordered_key(float x) {
  // signed int order of the key == float order; NaN above +inf
  const int b = __float_as_int(x);
  return b ^ ((b >> 31) & 0x7FFFFFFF);
}

__device__ __forceinline__ float icln_key_to_float(int o) {
  // the map is an involution
  return __int_as_float(o ^ ((o >> 31) & 0x7FFFFFFF));
}

__device__ __forceinline__ float icln_nan() { return __int_as_float(0x7FC00000); }

__device__ __forceinline__ bool icln_isnan(float x) { return x != x; }

__device__ __forceinline__ float icln_max(float a, float b) {
  return (icln_isnan(a) || icln_isnan(b)) ? icln_nan() : fmaxf(a, b);
}

__device__ __forceinline__ float icln_min(float a, float b) {
  return (icln_isnan(a) || icln_isnan(b)) ? icln_nan() : fminf(a, b);
}

__device__ __forceinline__ float icln_warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float icln_warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = icln_max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float icln_warp_min(float v) {
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
// and K9.  Over a line's keys, nv of them valid (masked entries hold
// ICLN_KEY_MASKED and stay in the population): lo is the k_lo-th key,
// k_lo = max(nv-1, 0)/2; hi is lo when more than k_hi = nv/2 keys lie at
// or below lo, else the least key above lo; the median 0.5f*(lo+hi),
// 0.0f for a line with no valid entry.  The select is exact, so any
// algorithm finding these keys gives the reference's bits.
//
// Four 8-bit passes over key ^ 0x80000000 (unsigned order == signed key
// order): pass p histograms digit p of the keys whose higher digits equal
// the prefix found so far, then one warp scans the 256 bins for the digit
// holding the remaining rank.  The keys below lo are summed on the way
// and the last pass counts the keys equal to lo, which tells whether hi
// is lo; where it is not, hi is the next nonempty bin of the last pass's
// bucket, or the least key above that bucket, which the last pass also
// takes: no pass of its own.

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

// The select's per-line state, in shared memory for the block select.
struct IclnSelState {
  int nv[ICLN_SEL_LINES];          // valid entries (set by the caller)
  int moff[ICLN_SEL_LINES];        // the line's mask words, or -1 (set by the caller)
  unsigned prefix[ICLN_SEL_LINES];  // digits of lo found so far
  int krem[ICLN_SEL_LINES];        // rank left inside the prefix's bucket
  int clast[ICLN_SEL_LINES];       // keys equal to lo (after the last pass)
  unsigned above[ICLN_SEL_LINES];   // least radix above the last pass's bucket
  int succ[ICLN_SEL_LINES];        // least key above lo
};

// Does line m need the successor pass: are there at most k_hi keys at or
// below lo (the keys below lo, k_lo - krem, and those equal, clast)?
__device__ __forceinline__ bool icln_sel_needs_successor(const IclnSelState& st, int m) {
  const int nv = st.nv[m];
  return nv > 0 && icln_sel_klo(nv) - st.krem[m] + st.clast[m] <= nv / 2;
}

__device__ __forceinline__ float icln_sel_median_of(int lo, int hi, int nv) {
  const float med = 0.5f * (icln_key_to_float(lo) + icln_key_to_float(hi));
  return nv == 0 ? 0.0f : med;
}

__device__ __forceinline__ float icln_sel_median(const IclnSelState& st, int m) {
  const int lo = (int)icln_radix((int)st.prefix[m]);
  return icln_sel_median_of(lo, icln_sel_needs_successor(st, m) ? st.succ[m] : lo, st.nv[m]);
}

// Shared-memory int32 keys a line of n takes in a block select: n
// rounded up to 32, plus 4, so that rows stay 16-byte aligned and the
// same entry of adjacent lines falls 4 banks apart.
__device__ __forceinline__ int icln_key_stride(int n) { return ((n + 31) & ~31) + 4; }

#define ICLN_SEL_CHUNK 256  // entries of a line a warp takes at a time: 8 a lane

// The least radix above lo, from the last pass's bins of lo's bucket (lane
// l holding bins 8l..8l+7 in b; lo's digit `digit`, the bucket's 24-bit
// prefix `bucket`): the next nonempty bin's radix, else `above`, the
// least radix above the bucket.  Every lane of the warp gets it.
__device__ __forceinline__ unsigned icln_successor_radix(const int (&b)[8], int digit,
                                                         unsigned bucket, unsigned above) {
  const int lane = threadIdx.x & 31;
  int next = 256;
#pragma unroll
  for (int i = 7; i >= 0; --i)
    if (b[i] > 0 && 8 * lane + i > digit) next = 8 * lane + i;
  next = icln_warp_min_int(next);
  return next < 256 ? (bucket << 8) | (unsigned)next : above;
}

// Block select over M <= ICLN_SEL_LINES lines of n keys in shared memory
// (line m at keys + m * icln_key_stride(n), 16-byte aligned), each with
// its own 256 bins in hist: every pass serves all M lines, so the chain
// is 4 passes of two barriers each.  A pass's work is cut into chunks of
// ICLN_SEL_CHUNK entries of one line, dealt out to the warps in turn: a
// lane reads eight keys with two 16-byte loads and adds each counted
// digit to its bin with an int32 shared atomic (exact in any order).
// The last pass also takes the least key above its bucket, so the least
// key above lo (the median's upper middle where lo's run ends at k_lo)
// comes from its bins or that minimum, with no pass of its own.  Line
// m's masked entries are the set bits of mbits + st.moff[m] (one word a
// 32 entries) and take the key ICLN_KEY_MASKED whatever their key slot
// holds; a line with moff -1 has none.  Call with st.nv and st.moff set,
// hist zero and a barrier after them; returns with hist zero again, a
// barrier after the last read of the keys, and icln_sel_median(st, m)
// readable by every thread.
__device__ inline void icln_block_select(const int* keys, int n, int M, int* hist,
                                         const unsigned* mbits, IclnSelState& st) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int ls = icln_key_stride(n);
  const int cpl = (n + ICLN_SEL_CHUNK - 1) / ICLN_SEL_CHUNK;  // chunks a line
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = 24 - 8 * pass;
    for (int it = warp; it < M * cpl; it += nwarps) {
      const int m = it / cpl;
      const int e = (it - m * cpl) * ICLN_SEL_CHUNK + 8 * lane;
      const int lim = min(8, n - e);  // this lane's entries: 8, fewer at the end
      const unsigned want = st.prefix[m];
      int* h = hist + m * 256;
      unsigned above = 0xffffffffu;
      if (lim > 0) {
        const int* k = keys + m * ls + e;
        const int4 v0 = *reinterpret_cast<const int4*>(k);
        const int4 v1 = *reinterpret_cast<const int4*>(k + 4);
        int q[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
        if (st.moff[m] >= 0) {
          const unsigned bits = (mbits[st.moff[m] + (e >> 5)] >> (e & 31)) & 255u;
          if (bits) {
#pragma unroll
            for (int j = 0; j < 8; ++j)
              if ((bits >> j) & 1u) q[j] = ICLN_KEY_MASKED;
          }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (j >= lim) break;
          const unsigned u = icln_radix(q[j]);
          if (pass == 0 || (u >> (shift + 8)) == want)
            atomicAdd(&h[(u >> shift) & 255u], 1);
          else if (pass == 3 && (u >> 8) > want)
            above = min(above, u);
        }
      }
      if (pass == 3) {
        for (int o = 16; o > 0; o >>= 1) above = min(above, __shfl_xor_sync(ICLN_FULL, above, o));
        if (lane == 0 && above != 0xffffffffu) atomicMin(&st.above[m], above);
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
      const unsigned succ =
          pass == 3 ? icln_successor_radix(b, p.digit, st.prefix[m], st.above[m]) : 0u;
      if (lane == 0) {
        st.krem[m] = k - p.below;
        st.prefix[m] = pass == 0 ? (unsigned)p.digit : (st.prefix[m] << 8) | (unsigned)p.digit;
        st.clast[m] = p.count;
        st.above[m] = 0xffffffffu;
        st.succ[m] = (int)icln_radix((int)succ);
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
