// Native ICAR archive loader/writer.
//
// Implements the C ABI consumed by iterative_cleaner_torch/io/native.py:
//   icar_open / icar_header_ptr / icar_freqs_ptr / icar_weights_ptr /
//   icar_data_ptr / icar_close / icar_write
//
// The reader mmaps the file read-only so the multi-GB data cube is paged
// straight from the file cache into the numpy view (and onward to the device
// transfer) without an intermediate heap copy — the role PSRCHIVE's C++
// Archive_load plays for the original cleaner.
// The writer streams header + arrays in order through write(2).
//
// File layout (all little-endian; see io/native.py for the authoritative spec):
//   0    8                       magic "ICAR\x00\x01\x00\x00" (version 1)
//   8    4*u32                   nsub, npol, nchan, nbin
//   24   6*f64                   period_s, dm, centre_freq_mhz, mjd0, mjd1, res
//   72   2*u32                   flags, pol_state
//   80   64s                     source
//   144  f64[nchan]              freqs_mhz
//   ...  f32[nsub*nchan]         weights
//   ...  f32[nsub*npol*nchan*nbin] data

#include <cerrno>
#include <cstdint>
#include <cstring>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <sys/uio.h>
#include <unistd.h>

namespace {

constexpr size_t kHeaderSize = 144;
constexpr unsigned char kMagic[8] = {'I', 'C', 'A', 'R', 0, 1, 0, 0};

struct Dims {
  uint32_t nsub = 0, npol = 0, nchan = 0, nbin = 0;

  size_t freqs_off() const { return kHeaderSize; }
  size_t freqs_bytes() const { return size_t(nchan) * 8; }
  size_t weights_off() const { return freqs_off() + freqs_bytes(); }
  size_t weights_bytes() const { return size_t(nsub) * nchan * 4; }
  size_t data_off() const { return weights_off() + weights_bytes(); }
  size_t data_bytes() const {
    return size_t(nsub) * npol * nchan * nbin * 4;
  }
  size_t file_bytes() const { return data_off() + data_bytes(); }
};

bool parse_dims(const unsigned char* hdr, Dims* out) {
  if (std::memcmp(hdr, kMagic, sizeof(kMagic)) != 0) return false;
  std::memcpy(&out->nsub, hdr + 8, 4);
  std::memcpy(&out->npol, hdr + 12, 4);
  std::memcpy(&out->nchan, hdr + 16, 4);
  std::memcpy(&out->nbin, hdr + 20, 4);
  if (out->nsub == 0 || out->npol == 0 || out->nchan == 0 || out->nbin == 0)
    return false;
  // Reject dimension combinations whose byte counts overflow 64-bit
  // arithmetic (a crafted header could otherwise wrap file_bytes() past the
  // size validation and send readers beyond the mapping).
  uint64_t cells = 0, elems = 0, bytes = 0;
  if (__builtin_mul_overflow(uint64_t(out->nsub) * out->npol,
                             uint64_t(out->nchan), &cells) ||
      __builtin_mul_overflow(cells, uint64_t(out->nbin), &elems) ||
      __builtin_mul_overflow(elems, uint64_t(4), &bytes) ||
      bytes > (uint64_t(1) << 46))  // 64 TiB cap, far beyond any archive
    return false;
  return true;
}

struct IcarHandle {
  unsigned char* map = nullptr;
  size_t map_size = 0;
  Dims dims;
};

}  // namespace

extern "C" {

void* icar_open(const char* path) {
  int fd = ::open(path, O_RDONLY | O_CLOEXEC);
  if (fd < 0) return nullptr;

  struct stat st;
  if (::fstat(fd, &st) != 0 || size_t(st.st_size) < kHeaderSize) {
    ::close(fd);
    return nullptr;
  }
  void* map = ::mmap(nullptr, size_t(st.st_size), PROT_READ, MAP_PRIVATE, fd, 0);
  ::close(fd);  // the mapping keeps the file alive
  if (map == MAP_FAILED) return nullptr;

  auto* h = new IcarHandle;
  h->map = static_cast<unsigned char*>(map);
  h->map_size = size_t(st.st_size);
  if (!parse_dims(h->map, &h->dims) || h->map_size < h->dims.file_bytes()) {
    ::munmap(map, h->map_size);
    delete h;
    return nullptr;
  }
  // The caller is about to stream the whole cube; prime readahead.
  ::madvise(map, h->map_size, MADV_WILLNEED);
  return h;
}

const char* icar_header_ptr(void* handle) {
  auto* h = static_cast<IcarHandle*>(handle);
  return reinterpret_cast<const char*>(h->map);
}

const double* icar_freqs_ptr(void* handle) {
  auto* h = static_cast<IcarHandle*>(handle);
  return reinterpret_cast<const double*>(h->map + h->dims.freqs_off());
}

const float* icar_weights_ptr(void* handle) {
  auto* h = static_cast<IcarHandle*>(handle);
  return reinterpret_cast<const float*>(h->map + h->dims.weights_off());
}

const float* icar_data_ptr(void* handle) {
  auto* h = static_cast<IcarHandle*>(handle);
  return reinterpret_cast<const float*>(h->map + h->dims.data_off());
}

void icar_close(void* handle) {
  auto* h = static_cast<IcarHandle*>(handle);
  if (h == nullptr) return;
  if (h->map != nullptr) ::munmap(h->map, h->map_size);
  delete h;
}

// Returns 0 on success, a positive errno-style code on failure.
int icar_write(const char* path, const char* header, const char* freqs,
               const char* weights, const char* data) {
  Dims dims;
  if (!parse_dims(reinterpret_cast<const unsigned char*>(header), &dims))
    return EINVAL;

  int fd = ::open(path, O_WRONLY | O_CREAT | O_TRUNC | O_CLOEXEC, 0644);
  if (fd < 0) return errno ? errno : EIO;

  struct Chunk {
    const char* ptr;
    size_t len;
  } chunks[4] = {
      {header, kHeaderSize},
      {freqs, dims.freqs_bytes()},
      {weights, dims.weights_bytes()},
      {data, dims.data_bytes()},
  };

  for (const Chunk& c : chunks) {
    size_t done = 0;
    while (done < c.len) {
      ssize_t n = ::write(fd, c.ptr + done, c.len - done);
      if (n < 0) {
        if (errno == EINTR) continue;
        int err = errno ? errno : EIO;
        ::close(fd);
        ::unlink(path);
        return err;
      }
      done += size_t(n);
    }
  }
  if (::close(fd) != 0) return errno ? errno : EIO;
  return 0;
}

}  // extern "C"
