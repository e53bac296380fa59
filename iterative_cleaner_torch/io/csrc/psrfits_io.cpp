// Native PSRFITS fold-mode reader.
//
// Implements the C ABI consumed by iterative_cleaner_torch/io/psrfits.py:
//   psrfits_open / psrfits_dims / psrfits_meta_v2 / psrfits_read /
//   psrfits_close  (the same ABI, and the same work in the same order, as
//   the reference package's reader of this subset)
//
// Mirrors the supported subset defined by the pure-Python reader in
// iterative_cleaner_torch/io/psrfits.py (the authoritative spec, which also
// reads every file this reader declines): fold-mode SUBINT binary table,
// DATA as big-endian int16 (+ DAT_SCL/DAT_OFFS per (pol, channel)) or
// float32, folding period from the SUBINT PERIOD key, a POLYCO table's
// REF_F0, or TBIN*NBIN.  The file is mmap'd read-only and the hot loop —
// byte swap + scale/offset of the cube — runs natively straight out of the
// page cache into the caller's float64 buffer, one pass (the role
// PSRCHIVE's C++ unpackers play for the original cleaner's Archive_load).
// Built with -ffp-contract=off: `s * double(x) + o` must round as the
// Python reader's separate multiply and add do.

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <map>
#include <string>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr size_t kBlock = 2880;
constexpr size_t kCard = 80;

inline uint16_t bswap16(uint16_t v) { return __builtin_bswap16(v); }
inline uint32_t bswap32(uint32_t v) { return __builtin_bswap32(v); }
inline uint64_t bswap64(uint64_t v) { return __builtin_bswap64(v); }

inline float be_f32(const unsigned char* p) {
  uint32_t b;
  std::memcpy(&b, p, 4);
  b = bswap32(b);
  float f;
  std::memcpy(&f, &b, 4);
  return f;
}

inline double be_f64(const unsigned char* p) {
  uint64_t b;
  std::memcpy(&b, p, 8);
  b = bswap64(b);
  double d;
  std::memcpy(&d, &b, 8);
  return d;
}

inline int16_t be_i16(const unsigned char* p) {
  uint16_t b;
  std::memcpy(&b, p, 2);
  return static_cast<int16_t>(bswap16(b));
}

std::string strip(const std::string& s) {
  size_t a = s.find_first_not_of(" \t");
  if (a == std::string::npos) return "";
  size_t b = s.find_last_not_of(" \t");
  return s.substr(a, b - a + 1);
}

using Cards = std::map<std::string, std::string>;

// Parse one header starting at `off`; fills `cards` (first value wins, like
// the Python reader) and sets `data_off` to the first byte after the header
// padding.  Returns false on truncation or a missing END card.
bool parse_header(const unsigned char* buf, size_t size, size_t off,
                  Cards* cards, size_t* data_off) {
  size_t pos = off;
  bool end_seen = false;
  while (!end_seen) {
    if (pos + kBlock > size) return false;
    for (size_t i = 0; i < kBlock; i += kCard) {
      const char* card = reinterpret_cast<const char*>(buf + pos + i);
      std::string key = strip(std::string(card, 8));
      if (key == "END") {
        end_seen = true;
        break;
      }
      if (key.empty() || key == "COMMENT" || key == "HISTORY" ||
          card[8] != '=' || card[9] != ' ')
        continue;
      std::string rest(card + 10, kCard - 10);
      std::string value;
      size_t a = rest.find_first_not_of(' ');
      if (a != std::string::npos && rest[a] == '\'') {
        // quoted string; '' escapes a quote
        for (size_t j = a + 1; j < rest.size(); ++j) {
          if (rest[j] == '\'') {
            if (j + 1 < rest.size() && rest[j + 1] == '\'') {
              value += '\'';
              ++j;
            } else {
              break;
            }
          } else {
            value += rest[j];
          }
        }
        // trailing padding inside the quotes is not significant
        size_t e = value.find_last_not_of(' ');
        value = (e == std::string::npos) ? "" : value.substr(0, e + 1);
      } else {
        size_t slash = rest.find('/');
        value = strip(rest.substr(0, slash));
      }
      if (!cards->count(key)) (*cards)[key] = value;
    }
    pos += kBlock;
  }
  *data_off = pos;
  return true;
}

long as_int(const Cards& c, const std::string& key, long def, bool* ok) {
  auto it = c.find(key);
  if (it == c.end()) return def;
  char* end = nullptr;
  double v = std::strtod(it->second.c_str(), &end);
  if (end == it->second.c_str()) {
    *ok = false;
    return def;
  }
  return static_cast<long>(v);
}

double as_float(const Cards& c, const std::string& key, double def) {
  auto it = c.find(key);
  if (it == c.end()) return def;
  return std::strtod(it->second.c_str(), nullptr);
}

size_t tform_bytes(char code) {
  switch (code) {
    case 'L': case 'X': case 'B': case 'A': return 1;
    case 'I': return 2;
    case 'J': case 'E': return 4;
    case 'K': case 'D': case 'C': return 8;
    case 'M': return 16;
    default: return 0;
  }
}

struct Column {
  char code = 0;
  size_t repeat = 0;
  size_t offset = 0;
};

// TTYPEn/TFORMn -> name -> (code, repeat, byte offset); returns row width.
bool parse_columns(const Cards& c, std::map<std::string, Column>* cols,
                   size_t* row_bytes) {
  bool ok = true;
  long tfields = as_int(c, "TFIELDS", 0, &ok);
  size_t off = 0;
  for (long i = 1; i <= tfields; ++i) {
    std::string idx = std::to_string(i);
    auto tt = c.find("TTYPE" + idx);
    auto tf = c.find("TFORM" + idx);
    if (tf == c.end()) return false;
    const std::string& form = tf->second;
    size_t p = 0;
    while (p < form.size() && form[p] >= '0' && form[p] <= '9') ++p;
    if (p >= form.size()) return false;
    size_t repeat = p ? std::strtoul(form.c_str(), nullptr, 10) : 1;
    char code = form[p];
    size_t w = tform_bytes(code);
    if (w == 0) return false;
    Column col{code, repeat, off};
    if (tt != c.end()) (*cols)[strip(tt->second)] = col;
    off += repeat * w;
  }
  *row_bytes = off;
  return tfields > 0;
}

// False on a negative NAXISn/PCOUNT: casting those to size_t would wrap
// the HDU walk backwards/around (same clamp as the Python reader's
// _hdu_data_bytes — corrupt files must be rejected, never spun on).
bool hdu_data_bytes(const Cards& c, size_t* out) {
  bool ok = true;
  *out = 0;
  long naxis = as_int(c, "NAXIS", 0, &ok);
  if (naxis < 0) return false;
  if (naxis == 0) return true;
  size_t n = 1;
  for (long i = 1; i <= naxis; ++i) {
    long v = as_int(c, "NAXIS" + std::to_string(i), 0, &ok);
    if (v < 0) return false;
    n *= static_cast<size_t>(v);
  }
  long pcount = as_int(c, "PCOUNT", 0, &ok);
  if (pcount < 0) return false;
  size_t el = static_cast<size_t>(
      labs(as_int(c, "BITPIX", 8, &ok))) / 8;
  n *= el;
  n += static_cast<size_t>(pcount) * el;
  *out = n;
  return true;
}

struct PsrfitsHandle {
  unsigned char* map = nullptr;
  size_t map_size = 0;

  Cards primary;
  Cards subint;
  size_t table_off = 0;
  size_t row_bytes = 0;
  std::map<std::string, Column> cols;

  uint32_t nsub = 0, npol = 0, nchan = 0, nbin = 0;
  double period = 0, dm = 0, cfreq = 0, mjd_start = 0, mjd_end = 0;
  int dedisp = 0;
  int pol_code = 0;  // index into archive.py POL_STATES
  std::string source;
};

// Walk every HDU looking for EXTNAME=POLYCO and return 1/REF_F0 of the last
// row, or 0 when absent (caller then applies TBIN*NBIN).
double polyco_period(const unsigned char* buf, size_t size) {
  size_t off = 0;
  bool first = true;
  while (off < size) {
    Cards cards;
    size_t data_off;
    if (!parse_header(buf, size, off, &cards, &data_off)) return 0;
    size_t bytes;
    if (!hdu_data_bytes(cards, &bytes) || bytes > size) return 0;
    if (!first && strip(cards.count("EXTNAME") ? cards["EXTNAME"] : "") ==
        "POLYCO") {
      std::map<std::string, Column> cols;
      size_t row_bytes;
      bool ok = true;
      long nrows = as_int(cards, "NAXIS2", 0, &ok);
      if (parse_columns(cards, &cols, &row_bytes) && nrows > 0 &&
          cols.count("REF_F0") && cols["REF_F0"].code == 'D') {
        size_t p = data_off + size_t(nrows - 1) * row_bytes +
                   cols["REF_F0"].offset;
        if (p + 8 <= size) {
          double f0 = be_f64(buf + p);
          if (f0 > 0) return 1.0 / f0;
        }
      }
    }
    first = false;
    off = data_off + bytes + ((kBlock - bytes % kBlock) % kBlock);
  }
  return 0;
}

}  // namespace

extern "C" {

void* psrfits_open(const char* path) {
  int fd = ::open(path, O_RDONLY | O_CLOEXEC);
  if (fd < 0) return nullptr;
  struct stat st;
  if (::fstat(fd, &st) != 0 || st.st_size < long(kBlock)) {
    ::close(fd);
    return nullptr;
  }
  void* map = ::mmap(nullptr, size_t(st.st_size), PROT_READ, MAP_PRIVATE, fd, 0);
  ::close(fd);
  if (map == MAP_FAILED) return nullptr;

  auto* h = new PsrfitsHandle;
  h->map = static_cast<unsigned char*>(map);
  h->map_size = size_t(st.st_size);

  auto fail = [h]() {
    ::munmap(h->map, h->map_size);
    delete h;
    return nullptr;
  };

  if (std::memcmp(h->map, "SIMPLE", 6) != 0) return fail();

  // primary header, then walk to the SUBINT table
  size_t off = 0, data_off = 0;
  if (!parse_header(h->map, h->map_size, 0, &h->primary, &data_off))
    return fail();
  std::string mode = h->primary.count("OBS_MODE")
                         ? strip(h->primary["OBS_MODE"]) : "PSR";
  if (mode != "PSR" && mode != "CAL") return fail();
  size_t bytes;
  if (!hdu_data_bytes(h->primary, &bytes) || bytes > h->map_size)
    return fail();
  off = data_off + bytes + ((kBlock - bytes % kBlock) % kBlock);
  bool found = false;
  while (off < h->map_size) {
    Cards cards;
    if (!parse_header(h->map, h->map_size, off, &cards, &data_off))
      return fail();
    if (!hdu_data_bytes(cards, &bytes) || bytes > h->map_size)
      return fail();
    if (strip(cards.count("EXTNAME") ? cards["EXTNAME"] : "") == "SUBINT") {
      h->subint = cards;
      h->table_off = data_off;
      found = true;
      break;
    }
    off = data_off + bytes + ((kBlock - bytes % kBlock) % kBlock);
  }
  if (!found) return fail();

  bool ok = true;
  h->nsub = uint32_t(as_int(h->subint, "NAXIS2", 0, &ok));
  h->nbin = uint32_t(as_int(h->subint, "NBIN", 0, &ok));
  h->nchan = uint32_t(as_int(h->subint, "NCHAN", 0, &ok));
  h->npol = uint32_t(as_int(h->subint, "NPOL", 0, &ok));
  if (!ok || !h->nsub || !h->nbin || !h->nchan || !h->npol) return fail();
  if (!parse_columns(h->subint, &h->cols, &h->row_bytes)) return fail();
  if (h->row_bytes != size_t(as_int(h->subint, "NAXIS1", 0, &ok)))
    return fail();
  for (const char* need :
       {"DAT_FREQ", "DAT_WTS", "DAT_SCL", "DAT_OFFS", "DATA"})
    if (!h->cols.count(need)) return fail();
  const Column& dc = h->cols["DATA"];
  if ((dc.code != 'I' && dc.code != 'E') ||
      dc.repeat != size_t(h->npol) * h->nchan * h->nbin)
    return fail();
  if (h->cols["DAT_SCL"].repeat < size_t(h->npol) * h->nchan ||
      h->cols["DAT_OFFS"].repeat < size_t(h->npol) * h->nchan ||
      h->cols["DAT_WTS"].repeat < h->nchan ||
      h->cols["DAT_FREQ"].repeat < h->nchan)
    return fail();
  // DAT_FREQ: E (float32, common) or D (float64, what save_psrfits writes)
  if (h->cols["DAT_FREQ"].code != 'E' && h->cols["DAT_FREQ"].code != 'D')
    return fail();
  if (h->table_off + size_t(h->nsub) * h->row_bytes > h->map_size)
    return fail();

  // metadata (same resolution rules as the Python reader)
  h->period = as_float(h->subint, "PERIOD", 0);
  if (h->period <= 0) h->period = polyco_period(h->map, h->map_size);
  if (h->period <= 0)
    h->period = as_float(h->subint, "TBIN", 0) * h->nbin;
  if (!(h->period > 0)) return fail();  // pure reader raises; stay in sync
  h->dm = as_float(h->subint, "CHAN_DM", as_float(h->subint, "DM", 0));
  h->dedisp = int(as_int(h->subint, "DEDISP", 0, &ok));
  h->mjd_start = double(as_int(h->primary, "STT_IMJD", 0, &ok)) +
                 double(as_int(h->primary, "STT_SMJD", 0, &ok)) / 86400.0 +
                 as_float(h->primary, "STT_OFFS", 0) / 86400.0;
  double total_s = 0;
  if (h->cols.count("TSUBINT") && h->cols["TSUBINT"].code == 'D') {
    for (uint32_t i = 0; i < h->nsub; ++i)
      total_s += be_f64(h->map + h->table_off + size_t(i) * h->row_bytes +
                        h->cols["TSUBINT"].offset);
  }
  h->mjd_end = h->mjd_start + total_s / 86400.0;
  // NAN marks "key absent" so the Python wrapper can apply the same
  // mid-channel fallback as the pure reader (OBSFREQ=0 stays 0)
  h->cfreq = as_float(h->primary, "OBSFREQ", NAN);
  h->source = h->primary.count("SRC_NAME") ? strip(h->primary["SRC_NAME"])
                                           : "unknown";
  std::string pt = h->subint.count("POL_TYPE") ? strip(h->subint["POL_TYPE"])
                                               : "INTEN";
  if (pt == "INTEN" || pt == "AA+BB")
    h->pol_code = 0;
  else if (pt == "IQUV" || pt == "STOKE")
    h->pol_code = 1;
  else if (pt == "AABBCRCI" || pt == "AABB")  // AABB: intensity = AA + BB
    h->pol_code = 2;
  else
    h->pol_code = h->npol == 1 ? 0 : 1;

  ::madvise(h->map, h->map_size, MADV_WILLNEED);
  return h;
}

int psrfits_dims(void* handle, uint32_t* nsub, uint32_t* npol,
                 uint32_t* nchan, uint32_t* nbin) {
  auto* h = static_cast<PsrfitsHandle*>(handle);
  *nsub = h->nsub;
  *npol = h->npol;
  *nchan = h->nchan;
  *nbin = h->nbin;
  return 0;
}

int psrfits_meta_v2(void* handle, double* period, double* dm, double* cfreq,
                 double* mjd_start, double* mjd_end, int* dedisp,
                 int* pol_code, int* data_nbits, char* source64) {
  auto* h = static_cast<PsrfitsHandle*>(handle);
  *period = h->period;
  *dm = h->dm;
  *cfreq = h->cfreq;
  *mjd_start = h->mjd_start;
  *mjd_end = h->mjd_end;
  *dedisp = h->dedisp;
  *pol_code = h->pol_code;
  *data_nbits = h->cols["DATA"].code == 'I' ? 16 : 32;
  std::memset(source64, 0, 64);
  std::memcpy(source64, h->source.c_str(),
              h->source.size() < 63 ? h->source.size() : 63);
  return 0;
}

// Fill caller buffers: data (nsub*npol*nchan*nbin f64, scale/offset applied
// in double precision — bit-identical to the pure-Python reader), weights
// (nsub*nchan f64), freqs (nchan f64, from row 0).  Returns 0.
int psrfits_read(void* handle, double* data, double* weights, double* freqs) {
  auto* h = static_cast<PsrfitsHandle*>(handle);
  const size_t ncell = size_t(h->npol) * h->nchan;
  const size_t nbin = h->nbin;
  const Column& cf = h->cols["DAT_FREQ"];
  const Column& cw = h->cols["DAT_WTS"];
  const Column& cs = h->cols["DAT_SCL"];
  const Column& co = h->cols["DAT_OFFS"];
  const Column& cd = h->cols["DATA"];

  const unsigned char* row0 = h->map + h->table_off;
  for (uint32_t c = 0; c < h->nchan; ++c)
    freqs[c] = cf.code == 'D'
                   ? be_f64(row0 + cf.offset + 8 * size_t(c))
                   : double(be_f32(row0 + cf.offset + 4 * size_t(c)));

  std::vector<double> scl(ncell), offs(ncell);
  for (uint32_t isub = 0; isub < h->nsub; ++isub) {
    const unsigned char* row = h->map + h->table_off +
                               size_t(isub) * h->row_bytes;
    for (uint32_t c = 0; c < h->nchan; ++c)
      weights[size_t(isub) * h->nchan + c] =
          double(be_f32(row + cw.offset + 4 * size_t(c)));
    for (size_t j = 0; j < ncell; ++j) {
      scl[j] = double(be_f32(row + cs.offset + 4 * j));
      offs[j] = double(be_f32(row + co.offset + 4 * j));
    }
    double* out = data + size_t(isub) * ncell * nbin;
    const unsigned char* src = row + cd.offset;
    if (cd.code == 'I') {
      for (size_t j = 0; j < ncell; ++j) {
        const double s = scl[j], o = offs[j];
        const unsigned char* p = src + 2 * j * nbin;
        double* q = out + j * nbin;
        for (size_t b = 0; b < nbin; ++b)
          q[b] = s * double(be_i16(p + 2 * b)) + o;
      }
    } else {
      for (size_t j = 0; j < ncell; ++j) {
        const double s = scl[j], o = offs[j];
        const unsigned char* p = src + 4 * j * nbin;
        double* q = out + j * nbin;
        for (size_t b = 0; b < nbin; ++b)
          q[b] = s * double(be_f32(p + 4 * b)) + o;
      }
    }
  }
  return 0;
}

void psrfits_close(void* handle) {
  auto* h = static_cast<PsrfitsHandle*>(handle);
  if (h == nullptr) return;
  if (h->map != nullptr) ::munmap(h->map, h->map_size);
  delete h;
}

}  // extern "C"
