// The scaler's tail on lines too long for K3: the centring and the
// side epilogue of one diagnostic plane along one axis, around K9's
// medians.
//
// Replaces, for scaler lines over 46,486 entries, the tail of
// iterative_cleaner_tpu/stats/pallas_kernels.py _scaled_sides_body
// (scaled_sides_pallas): centring by the line's median and the
// _masked_side epilogue for std, mean and ptp; the NaN-line patch and
// |c / mad| * float32(1/thresh) for the rFFT diagnostic.  K3 holds a
// whole line in one block's shared memory (5 bytes an entry against
// 232,448); a longer line takes K9 (masked_median.cu), which spreads a
// line over many blocks, for its median and its MAD, and these two
// kernels between and after them (stats.kernels._scaled_sides_long).
//
// Bound: bytes.  side_centre reads a plane, the mask and the line
// medians and writes the centred plane and its magnitudes (13 bytes an
// entry); side_scale reads the centred plane, the mask and the MADs and
// writes the side (9 bytes an entry); a few float ops an entry.
//
// Design: one thread per entry, consecutive threads on consecutive
// entries of the (nsub, nchan) plane as it lies; an entry's line is its
// channel (axis 0) or its subint (axis 1).  Every float op repeats K3's
// sequence, so the sides are bit-equal to it: centring `d - med` on
// unmasked entries (masked ones pass through), `line_dead` where the MAD
// is 0 (K9 gives an empty line a median of 0, so its MAD is 0 too),
// `fabsf(dead ? c : c / mad)` and the multiply by float32(1/thresh).  On
// the plain (rFFT) path K3 makes a line's median NaN when the line holds
// a NaN, and its MAD NaN when a centred magnitude is NaN: side_centre
// records both per line in an int (bit 1, bit 2; integer atomicOr, exact
// in any order) and side_scale applies them, a NaN median making every
// centred entry NaN.
//
// float64 planes (dtype="float64") take the same kernels in double, with
// K9's float64 build for the medians (lines over LONGEST_BLOCK_LINE_F64
// entries): twice the bytes an entry.

#include "common.cuh"

__device__ __forceinline__ long long icln_tail_line(long long i, int nchan, int axis) {
  return axis == 0 ? i % nchan : i / nchan;
}

template <class T, bool MASKED>
__global__ void icln_side_centre_kernel(const T* __restrict__ d,
                                        const unsigned char* __restrict__ mask,
                                        const T* __restrict__ med, T* __restrict__ centred,
                                        T* __restrict__ absc, int* __restrict__ flags,
                                        long long n, int nchan, int axis) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long line = icln_tail_line(i, nchan, axis);
    const T v = d[i];
    T c;
    if (MASKED) {
      c = mask[i] ? v : v - med[line];
    } else {
      c = v - med[line];
      const int f = (icln_isnan(v) ? 1 : 0) | (icln_isnan(icln_abs(c)) ? 2 : 0);
      if (f) atomicOr(&flags[line], f);
    }
    centred[i] = c;
    absc[i] = icln_abs(c);
  }
}

template <class T, bool MASKED>
__global__ void icln_side_scale_kernel(const T* __restrict__ centred,
                                       const unsigned char* __restrict__ mask,
                                       const T* __restrict__ mad,
                                       const int* __restrict__ flags, T* __restrict__ out,
                                       long long n, int nchan, int axis, T inv_t) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long line = icln_tail_line(i, nchan, axis);
    const T c = centred[i];
    const T m = mad[line];
    if (MASKED) {
      const bool line_dead = m == T(0);
      const T safe_mad = line_dead ? T(1) : m;
      const bool dead = mask[i] || line_dead;
      const T mag = icln_abs(dead ? c : c / safe_mad);
      out[i] = dead ? mag : mag * inv_t;
    } else {
      const int f = flags[line];
      const T ce = (f & 1) ? icln_nan_of<T>() : c;
      const T me = f ? icln_nan_of<T>() : m;
      out[i] = icln_abs(ce / me) * inv_t;
    }
  }
}

static unsigned icln_tail_blocks(long long n) {
  const long long b = (n + 255) / 256;
  return (unsigned)(b < 65535LL * 16 ? b : 65535LL * 16);
}

template <class T>
static int icln_side_centre_launch(const void* d, const unsigned char* mask, const void* med,
                                   void* centred, void* absc, int* flags, long long n,
                                   int nchan, int axis, int masked, cudaStream_t st) {
  const T* dd = static_cast<const T*>(d);
  const T* mm = static_cast<const T*>(med);
  T* cc = static_cast<T*>(centred);
  T* aa = static_cast<T*>(absc);
  if (masked)
    icln_side_centre_kernel<T, true><<<icln_tail_blocks(n), 256, 0, st>>>(
        dd, mask, mm, cc, aa, flags, n, nchan, axis);
  else
    icln_side_centre_kernel<T, false><<<icln_tail_blocks(n), 256, 0, st>>>(
        dd, mask, mm, cc, aa, flags, n, nchan, axis);
  return (int)cudaGetLastError();
}

template <class T>
static int icln_side_scale_launch(const void* centred, const unsigned char* mask,
                                  const void* mad, const int* flags, void* out, long long n,
                                  int nchan, int axis, int masked, double inv_t,
                                  cudaStream_t st) {
  const T* cc = static_cast<const T*>(centred);
  const T* md = static_cast<const T*>(mad);
  T* oo = static_cast<T*>(out);
  if (masked)
    icln_side_scale_kernel<T, true><<<icln_tail_blocks(n), 256, 0, st>>>(
        cc, mask, md, flags, oo, n, nchan, axis, (T)inv_t);
  else
    icln_side_scale_kernel<T, false><<<icln_tail_blocks(n), 256, 0, st>>>(
        cc, mask, md, flags, oo, n, nchan, axis, (T)inv_t);
  return (int)cudaGetLastError();
}

// f64: the planes are float64 (double), else float32.
extern "C" int icln_side_centre(const void* d, const unsigned char* mask, const void* med,
                                void* centred, void* absc, int* flags, long long n,
                                int nchan, int axis, int masked, int f64, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return f64 ? icln_side_centre_launch<double>(d, mask, med, centred, absc, flags, n, nchan,
                                               axis, masked, st)
             : icln_side_centre_launch<float>(d, mask, med, centred, absc, flags, n, nchan,
                                              axis, masked, st);
}

// inv_t: the threshold's reciprocal in the planes' type (a float32 value
// for float32 planes).
extern "C" int icln_side_scale(const void* centred, const unsigned char* mask,
                               const void* mad, const int* flags, void* out, long long n,
                               int nchan, int axis, int masked, double inv_t, int f64,
                               void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return f64 ? icln_side_scale_launch<double>(centred, mask, mad, flags, out, n, nchan, axis,
                                              masked, inv_t, st)
             : icln_side_scale_launch<float>(centred, mask, mad, flags, out, n, nchan, axis,
                                             masked, inv_t, st);
}
