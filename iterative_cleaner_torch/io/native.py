"""The port's host I/O library and the ``.icar`` container.

The library, ``libicln_io_<digest>.so``, is built at first use with the
host C++ compiler (``g++``, else ``c++``) from ``io/csrc/archive_io.cpp``
(the ``.icar`` mmap reader and writer) and ``io/csrc/psrfits_io.cpp``
(the one-pass PSRFITS reader of :mod:`~iterative_cleaner_torch.io.
psrfits`) into ``iterative_cleaner_torch/_build/``, named by a digest of
the sources and flags so a changed source builds a new file and an old
one is never loaded.  ``-ffp-contract=off`` and no ``-march=native`` or
``-ffast-math``: the PSRFITS reader's ``s * x + o`` must round as the
pure-Python reader's multiply and add do.  A missing compiler, a failed
build or a failed ``dlopen`` raises ``RuntimeError`` with the compiler's
output; nothing then reads the file another way.

``.icar`` is the zero-copy on-disk layout: a fixed little-endian header
followed by raw arrays, so the loader can mmap the cube.  The byte
layout, the same as the reference package's, so either package reads
the other's files (all little-endian):

  0   8   magic  b"ICAR\\x00\\x01\\x00\\x00" (version 1)
  8   4*u32   nsub, npol, nchan, nbin
  24  6*f64   period_s, dm, centre_freq_mhz, mjd_start, mjd_end, reserved
  72  u32     flags (bit0: dedispersed, bit1: float32 PSRFITS re-save
              encoding), u32 pol_state enum
  80  64s     source (utf-8, NUL padded)
  144 f64[nchan]              freqs_mhz
  ... f32[nsub,nchan]         weights
  ... f32[nsub,npol,nchan,nbin] data

:func:`_load_icar_python` and :func:`_save_icar_python` are the format's
definition in Python; the tests hold the library to them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import threading
from pathlib import Path

import numpy as np

from iterative_cleaner_torch.archive import POL_STATES, Archive
from iterative_cleaner_torch.io.atomic import atomic_output

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("archive_io.cpp", "psrfits_io.cpp")
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-ffp-contract=off", "-shared")

MAGIC = b"ICAR\x00\x01\x00\x00"
_HEADER = struct.Struct("<8s4I6d2I64s")
assert _HEADER.size == 144

_LIB = None
_LIB_LOCK = threading.Lock()

# Files read through the library, by reader; read like the kernels'
# launch counts (stats.kernels.launch_counts).  A prefetching session
# loads on worker threads, hence the lock.
_LOAD_COUNTS = {"psrfits": 0, "icar": 0}
_COUNT_LOCK = threading.Lock()


def load_counts() -> dict:
    """Files read through the native library since the last reset."""
    with _COUNT_LOCK:
        return dict(_LOAD_COUNTS)


def reset_load_counts() -> None:
    with _COUNT_LOCK:
        for key in _LOAD_COUNTS:
            _LOAD_COUNTS[key] = 0


def count_load(reader: str) -> None:
    with _COUNT_LOCK:
        _LOAD_COUNTS[reader] += 1


def _compiler() -> str:
    for name in ("g++", "c++"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError("no C++ compiler (g++ or c++) found: the port's host "
                       "I/O library is built from source at first use")


def _source_digest() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    return h.hexdigest()[:16]


def build_library() -> Path:
    """Compile the host sources into one shared library (cached by
    digest) and return its path.  The compiler writes a temporary file
    beside it that is renamed into place (``io/atomic.py``), so a process
    racing this one never loads a half-written file."""
    out = BUILD_DIR / f"libicln_io_{_source_digest()}.so"
    if out.exists():
        return out
    cxx = _compiler()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with atomic_output(str(out)) as lib_tmp:
        proc = subprocess.run(
            [cxx, *CXX_FLAGS, "-o", lib_tmp,
             *(str(CSRC_DIR / name) for name in SOURCES)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"building the host I/O library with {cxx} failed (rc "
                f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    return out


_C, _P, _U32P, _DP, _IP = (ctypes.c_char_p, ctypes.c_void_p,
                           ctypes.POINTER(ctypes.c_uint32),
                           ctypes.POINTER(ctypes.c_double),
                           ctypes.POINTER(ctypes.c_int))
_SIGNATURES = {
    "icar_open": (_P, [_C]),
    "icar_header_ptr": (_P, [_P]),
    "icar_freqs_ptr": (_P, [_P]),
    "icar_weights_ptr": (_P, [_P]),
    "icar_data_ptr": (_P, [_P]),
    "icar_close": (None, [_P]),
    "icar_write": (ctypes.c_int, [_C] * 5),
    "psrfits_open": (_P, [_C]),
    "psrfits_dims": (ctypes.c_int, [_P] + [_U32P] * 4),
    "psrfits_meta_v2": (ctypes.c_int, [_P] + [_DP] * 5 + [_IP] * 3 + [_C]),
    "psrfits_read": (ctypes.c_int, [_P, _DP, _DP, _DP]),
    "psrfits_close": (None, [_P]),
}


def load_library():
    """The bound host I/O library, built on first use (``RuntimeError``
    when it cannot be built or loaded)."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            path = build_library()
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as exc:
                raise RuntimeError(
                    f"loading the host I/O library {path} failed: {exc}") \
                    from exc
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _LIB = lib
    return _LIB


def _pack_header(ar: Archive) -> bytes:
    # flags bit0: dedispersed; bit1: PSRFITS re-save encoding is float32
    # (psrfits_nbits == 32); files without it read as the default, 16
    flags = (1 if ar.dedispersed else 0) | (2 if ar.psrfits_nbits == 32 else 0)
    return _HEADER.pack(
        MAGIC, ar.nsub, ar.npol, ar.nchan, ar.nbin,
        ar.period_s, ar.dm, ar.centre_freq_mhz, ar.mjd_start, ar.mjd_end, 0.0,
        flags, POL_STATES.index(ar.pol_state),
        ar.source.encode("utf-8")[:64],
    )


def _unpack_header(buf: bytes) -> dict:
    (magic, nsub, npol, nchan, nbin, period, dm, cfreq, mjd0, mjd1, _res,
     flags, pol_idx, source) = _HEADER.unpack(buf[: _HEADER.size])
    if magic != MAGIC:
        raise ValueError("not an ICAR v1 file")
    return dict(
        nsub=nsub, npol=npol, nchan=nchan, nbin=nbin, period_s=period, dm=dm,
        centre_freq_mhz=cfreq, mjd_start=mjd0, mjd_end=mjd1,
        dedispersed=bool(flags & 1), pol_state=POL_STATES[pol_idx],
        psrfits_nbits=32 if flags & 2 else 16,
        source=source.split(b"\x00", 1)[0].decode("utf-8"),
    )


_META_FIELDS = ("period_s", "dm", "centre_freq_mhz", "mjd_start", "mjd_end",
                "dedispersed", "pol_state", "psrfits_nbits", "source")


def _icar_arrays(ar: Archive):
    return (_pack_header(ar),
            np.ascontiguousarray(ar.freqs_mhz, dtype="<f8"),
            np.ascontiguousarray(ar.weights, dtype="<f4"),
            np.ascontiguousarray(ar.data, dtype="<f4"))


def save_icar(ar: Archive, path: str) -> None:
    """Write ``ar`` as ``.icar`` through the library's ``icar_write``,
    under a temporary name renamed into place (an interrupted writer
    never leaves a torn file under the final name)."""
    lib = load_library()
    header, freqs, weights, data = _icar_arrays(ar)
    with atomic_output(path) as tmp:
        rc = lib.icar_write(tmp.encode(), header,
                            freqs.ctypes.data_as(ctypes.c_char_p),
                            weights.ctypes.data_as(ctypes.c_char_p),
                            data.ctypes.data_as(ctypes.c_char_p))
        if rc != 0:
            raise OSError(rc, f"icar_write failed for {path}: "
                              f"{os.strerror(rc)}")


def load_icar(path: str) -> Archive:
    """Read an ``.icar`` file through the library's mmap; the arrays are
    copied out as float64 so the mapping closes at once."""
    lib = load_library()
    handle = lib.icar_open(path.encode())
    if not handle:
        raise OSError(f"icar_open failed for {path} (missing, truncated or "
                      "not an ICAR v1 file)")
    try:
        meta = _unpack_header(ctypes.string_at(lib.icar_header_ptr(handle),
                                               _HEADER.size))
        nsub, npol, nchan, nbin = (meta["nsub"], meta["npol"], meta["nchan"],
                                   meta["nbin"])
        freqs = np.ctypeslib.as_array(
            ctypes.cast(lib.icar_freqs_ptr(handle),
                        ctypes.POINTER(ctypes.c_double)), (nchan,)).copy()
        weights = np.ctypeslib.as_array(
            ctypes.cast(lib.icar_weights_ptr(handle),
                        ctypes.POINTER(ctypes.c_float)), (nsub, nchan))
        data = np.ctypeslib.as_array(
            ctypes.cast(lib.icar_data_ptr(handle),
                        ctypes.POINTER(ctypes.c_float)),
            (nsub, npol, nchan, nbin))
        ar = Archive(data=data.astype(np.float64),
                     weights=weights.astype(np.float64), freqs_mhz=freqs,
                     filename=path, **{k: meta[k] for k in _META_FIELDS})
    finally:
        lib.icar_close(handle)
    count_load("icar")
    return ar


def read_icar_header(path: str) -> dict:
    """Just the 144-byte header as a dict: no array I/O."""
    with open(path, "rb") as f:
        return _unpack_header(f.read(_HEADER.size))


def read_icar_weights(path: str) -> np.ndarray:
    """Just the (nsub, nchan) float32 weights, never the data cube."""
    with open(path, "rb") as f:
        meta = _unpack_header(f.read(_HEADER.size))
        f.seek(_HEADER.size + meta["nchan"] * 8)
        n = meta["nsub"] * meta["nchan"]
        w = np.frombuffer(f.read(n * 4), dtype="<f4")
    return w.reshape(meta["nsub"], meta["nchan"])


def _save_icar_python(ar: Archive, path: str) -> None:
    """The format's writer in Python (the same bytes as :func:`save_icar`)."""
    header, freqs, weights, data = _icar_arrays(ar)
    with atomic_output(path) as tmp:
        with open(tmp, "wb") as f:
            f.write(header)
            f.write(freqs.tobytes())
            f.write(weights.tobytes())
            f.write(data.tobytes())


def _load_icar_python(path: str) -> Archive:
    """The format's reader in Python (the same arrays as :func:`load_icar`)."""
    with open(path, "rb") as f:
        buf = f.read()
    meta = _unpack_header(buf)
    off = _HEADER.size
    nsub, npol, nchan, nbin = (meta["nsub"], meta["npol"], meta["nchan"],
                               meta["nbin"])
    freqs = np.frombuffer(buf, dtype="<f8", count=nchan, offset=off).copy()
    off += nchan * 8
    weights = np.frombuffer(buf, dtype="<f4", count=nsub * nchan, offset=off)
    off += nsub * nchan * 4
    data = np.frombuffer(buf, dtype="<f4", count=nsub * npol * nchan * nbin,
                         offset=off).reshape(nsub, npol, nchan, nbin)
    return Archive(data=data.astype(np.float64),
                   weights=weights.reshape(nsub, nchan).astype(np.float64),
                   freqs_mhz=freqs, filename=path,
                   **{k: meta[k] for k in _META_FIELDS})
