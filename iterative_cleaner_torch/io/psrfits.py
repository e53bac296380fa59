"""PSRFITS fold-mode archives, read and written in pure Python.

Most modern ``.ar`` archives are PSRFITS (Hotan, van Straten & Manchester
2004): FITS files whose ``SUBINT`` binary table holds the fold-mode data
cube.  This is the port's own copy of the reference package's pure-Python
reader and writer of that subset (``iterative_cleaner_tpu/io/psrfits.py``),
byte for byte the same files.  The reference's native C++ reader (an mmap
fast path for the same subset) is not ported: ROADMAP.md 'Modules still to
port' item 2.

Supported layout:

- Fold-mode (``OBS_MODE='PSR'``/``'CAL'``) single-file archives; other
  modes (search) are refused with a clear error.
- A ``SUBINT`` binary table with per-row columns ``TSUBINT``,
  ``OFFS_SUB``, ``DAT_FREQ``, ``DAT_WTS``, ``DAT_SCL``, ``DAT_OFFS`` and
  ``DATA``, in any column order (columns resolve by TTYPE name through
  TFORM byte offsets).  Padded repeats are tolerated on every column but
  ``DATA``, whose repeat must equal ``NPOL*NCHAN*NBIN``.
- ``DATA`` as ``E`` (float32) or ``I`` (int16, scaled by ``DAT_SCL`` /
  ``DAT_OFFS`` per (pol, channel)); ``DAT_FREQ`` as ``E`` or ``D``.
- ``TDIM`` on DATA is informative only; the cube shape comes from
  NBIN/NCHAN/NPOL.
- Other HDUs anywhere are skipped; the first ``SUBINT`` HDU is
  authoritative; trailing non-FITS bytes after the last HDU are ignored;
  the long-string convention (``&`` + ``CONTINUE``) is parsed.
- The folding period: the ``PERIOD`` key of the SUBINT header (this
  writer emits it), then ``1/REF_F0`` from a ``POLYCO`` table, then
  ``TBIN * NBIN``; none usable is an error.

FITS structure: 2880-byte units, 80-character header cards, big-endian
table payloads, header and data padding.
"""

from __future__ import annotations

import re
import struct

import numpy as np

from iterative_cleaner_torch.archive import POL_STATES, Archive

BLOCK = 2880
CARD = 80

# PSRFITS POL_TYPE strings <-> the archive's pol_state (archive.py).
_POL_TYPE_OF_STATE = {
    "Intensity": "INTEN",
    "Stokes": "IQUV",
    "Coherence": "AABBCRCI",
}
_STATE_OF_POL_TYPE = {
    "INTEN": "Intensity",
    "STOKE": "Stokes",
    "IQUV": "Stokes",
    "AABBCRCI": "Coherence",
    "AABB": "Coherence",   # two-product coherence: intensity = AA + BB
    "AA+BB": "Intensity",  # already summed
}


# ---------------------------------------------------------------------------
# FITS primitives
# ---------------------------------------------------------------------------

def _card(key: str, value, comment: str = "") -> bytes:
    """One 80-byte header card."""
    if value is None:  # bare keyword (COMMENT/END handled separately)
        body = f"{key:<8}"
    elif isinstance(value, bool):
        body = f"{key:<8}= {'T' if value else 'F':>20}"
    elif isinstance(value, int):
        body = f"{key:<8}= {value:>20}"
    elif isinstance(value, float):
        body = f"{key:<8}= {value:>20.14G}"
    else:  # string: quoted, closing quote at col >= 20
        s = str(value).replace("'", "''")
        body = f"{key:<8}= '{s:<8}'"
    if comment:
        body = f"{body} / {comment}"
    out = body[:CARD].ljust(CARD).encode("ascii")
    return out


def _end_pad(header_cards: list) -> bytes:
    raw = b"".join(header_cards) + b"END".ljust(CARD)
    pad = (-len(raw)) % BLOCK
    return raw + b" " * pad


_VALUE_RE = re.compile(
    r"^(?:'(?P<str>(?:[^']|'')*)'|(?P<num>[^/]*?))\s*(?:/.*)?$")


def _parse_header(buf: memoryview, off: int):
    """Parse one FITS header starting at ``off``; returns (dict, data_off).

    Repeated keys keep the first value; COMMENT/HISTORY/blank cards are
    skipped.  The dict preserves raw string values stripped of padding.
    The long-string convention is honoured: a string value ending in ``&``
    is extended by following ``CONTINUE`` cards (psrchive writes long
    PSRPARAM/HISTORY values this way).
    """
    cards = {}
    pos = off
    end_seen = False
    pending = None  # key whose string value ended with '&'
    while not end_seen:
        if pos + BLOCK > len(buf):
            raise ValueError("truncated FITS header")
        block = bytes(buf[pos: pos + BLOCK])
        pos += BLOCK
        for i in range(0, BLOCK, CARD):
            card = block[i: i + CARD].decode("ascii", "replace")
            key = card[:8].strip()
            if key == "END":
                end_seen = True
                break
            if key == "CONTINUE":
                if pending is not None:
                    m = _VALUE_RE.match(card[8:].strip())
                    if m and m.group("str") is not None:
                        s = m.group("str").rstrip().replace("''", "'")
                        cards[pending] = cards[pending][:-1] + s
                        if not s.endswith("&"):
                            pending = None
                    else:
                        # a CONTINUE that is not a quoted string ENDS the
                        # long string (FITS convention) — stitching a later
                        # CONTINUE across it would silently drop a chunk
                        pending = None
                continue
            if key in ("", "COMMENT", "HISTORY") or card[8:10] != "= ":
                pending = None
                continue
            m = _VALUE_RE.match(card[10:].strip())
            pending = None
            if not m or key in cards:
                continue
            if m.group("str") is not None:
                val = m.group("str").rstrip().replace("''", "'")
                cards[key] = val
                if val.endswith("&"):
                    pending = key
            else:
                cards[key] = m.group("num").strip()
    return cards, pos


def _as_int(cards, key, default=None):
    if key not in cards:
        if default is None:
            raise ValueError(f"FITS header missing {key}")
        return default
    return int(float(cards[key]))


def _as_float(cards, key, default=None):
    if key not in cards:
        if default is None:
            raise ValueError(f"FITS header missing {key}")
        return default
    return float(cards[key])


_TFORM_RE = re.compile(r"^(\d*)([LXBIJKAEDCM])")
_TFORM_BYTES = {"L": 1, "X": 1, "B": 1, "I": 2, "J": 4, "K": 8, "A": 1,
                "E": 4, "D": 8, "C": 8, "M": 16}


def _columns(cards):
    """[(name, code, repeat, byte_offset)] for a BINTABLE header."""
    tfields = _as_int(cards, "TFIELDS")
    cols = []
    off = 0
    for i in range(1, tfields + 1):
        name = cards.get(f"TTYPE{i}", f"COL{i}").strip()
        tform = cards.get(f"TFORM{i}", "")
        m = _TFORM_RE.match(tform.strip())
        if not m:
            raise ValueError(f"unsupported TFORM{i} {tform!r}")
        repeat = int(m.group(1)) if m.group(1) else 1
        code = m.group(2)
        cols.append((name, code, repeat, off))
        off += repeat * _TFORM_BYTES[code]
    return cols, off


def _hdu_data_bytes(cards) -> int:
    naxis = _as_int(cards, "NAXIS", 0)
    if naxis < 0:
        raise ValueError(f"negative NAXIS {naxis}")
    if naxis == 0:
        return 0
    n = 1
    for i in range(1, naxis + 1):
        v = _as_int(cards, f"NAXIS{i}")
        if v < 0:
            raise ValueError(f"negative NAXIS{i} {v}")
        n *= v
    pcount = _as_int(cards, "PCOUNT", 0)
    if pcount < 0:
        raise ValueError(f"negative PCOUNT {pcount}")
    n *= abs(_as_int(cards, "BITPIX", 8)) // 8
    n += pcount * abs(_as_int(cards, "BITPIX", 8)) // 8
    return n


def _iter_hdus(buf: memoryview, stopped_early: "list | None" = None):
    """Yield (cards, data_offset) for each HDU.

    Negative NAXISn/PCOUNT raise (``_hdu_data_bytes``) rather than walking
    the offset backwards, and the next offset must strictly advance — a
    crafted header can therefore never make this loop revisit offsets
    (the corruption-fuzz contract: reject or load, never hang)."""
    off = 0
    first = True
    while off < len(buf):
        if not first and bytes(buf[off: off + 8]) != b"XTENSION":
            # not an extension header: trailing non-FITS bytes some foreign
            # writers leave after the last HDU — stop the walk.  The flag
            # lets _resolve_period warn if the stop hid a possible POLYCO
            # table.
            if stopped_early is not None:
                stopped_early.append(off)
            break
        cards, data_off = _parse_header(buf, off)
        yield cards, data_off
        size = _hdu_data_bytes(cards)
        nxt = data_off + size + ((-size) % BLOCK)
        if nxt <= off:  # pragma: no cover - guarded by the raises above
            raise ValueError("corrupt FITS: HDU walk does not advance")
        off = nxt
        first = False


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------

def save_psrfits(ar: Archive, path: str, nbits: "int | None" = None) -> None:
    """Write a fold-mode PSRFITS archive.

    ``nbits=16`` stores DATA as int16 with per-(pol, channel) DAT_SCL/DAT_OFFS
    (the common on-disk layout; quantisation error ~ span/65534 per cell);
    ``nbits=32`` stores float32 (exact for float32-precision cubes).  The
    default (None) follows ``ar.psrfits_nbits`` — the source file's own
    encoding for archives loaded from PSRFITS — so a clean round-trip never
    degrades fidelity.  Cubes containing non-finite values are always
    stored float32 — int16 scaling is undefined for NaN/Inf, and float32
    round-trips them.
    """
    if nbits is None:
        nbits = ar.psrfits_nbits
    if nbits not in (16, 32):
        raise ValueError("nbits must be 16 (int16+scale) or 32 (float32)")
    nsub, npol, nchan, nbin = ar.nsub, ar.npol, ar.nchan, ar.nbin
    cube = np.ascontiguousarray(ar.data, dtype=np.float64)
    if nbits == 16 and not np.isfinite(cube).all():
        nbits = 32

    stt_imjd = int(ar.mjd_start)
    stt_smjd = (ar.mjd_start - stt_imjd) * 86400.0
    primary = _end_pad([
        _card("SIMPLE", True, "file does conform to FITS standard"),
        _card("BITPIX", 8),
        _card("NAXIS", 0),
        _card("EXTEND", True),
        _card("HDRVER", "6.1", "header version"),
        _card("FITSTYPE", "PSRFITS", "FITS definition for pulsar data"),
        _card("OBS_MODE", "PSR", "fold-mode data"),
        _card("SRC_NAME", ar.source[:24]),
        _card("OBSFREQ", float(ar.centre_freq_mhz), "centre frequency (MHz)"),
        _card("OBSNCHAN", nchan),
        _card("OBSBW", float(ar.freqs_mhz[-1] - ar.freqs_mhz[0])
              if nchan > 1 else 0.0, "bandwidth (MHz)"),
        _card("STT_IMJD", stt_imjd, "start MJD (UTC days)"),
        _card("STT_SMJD", int(stt_smjd), "start time (s past UTC 0h)"),
        _card("STT_OFFS", stt_smjd - int(stt_smjd), "start time fraction"),
    ])

    tsub = ((ar.mjd_end - ar.mjd_start) * 86400.0 / nsub) if nsub else 0.0
    if nbits == 16:
        data_code, data_np = "I", ">i2"
    else:
        data_code, data_np = "E", ">f4"
    ncell = npol * nchan
    row_bytes = (8 + 8 + 8 * nchan + 4 * nchan + 4 * ncell + 4 * ncell
                 + (nbits // 8) * ncell * nbin)
    subint = _end_pad([
        _card("XTENSION", "BINTABLE", "binary table extension"),
        _card("BITPIX", 8),
        _card("NAXIS", 2),
        _card("NAXIS1", row_bytes, "bytes per row"),
        _card("NAXIS2", nsub, "number of subintegrations"),
        _card("PCOUNT", 0),
        _card("GCOUNT", 1),
        _card("TFIELDS", 7),
        _card("EXTNAME", "SUBINT", "fold-mode subintegration data"),
        _card("NBIN", nbin, "phase bins"),
        _card("NCHAN", nchan, "frequency channels"),
        _card("NPOL", npol, "polarisations"),
        _card("POL_TYPE", _POL_TYPE_OF_STATE[ar.pol_state]),
        _card("NBITS", nbits),
        _card("TBIN", ar.period_s / nbin if nbin else 0.0,
              "time per phase bin (s) = PERIOD/NBIN"),
        _card("PERIOD", float(ar.period_s), "folding period (s)"),
        _card("CHAN_DM", float(ar.dm), "DM used for on-line dedispersion"),
        _card("DEDISP", 1 if ar.dedispersed else 0,
              "1 if channel delays removed"),
        _card("TTYPE1", "TSUBINT"), _card("TFORM1", "1D"),
        _card("TTYPE2", "OFFS_SUB"), _card("TFORM2", "1D"),
        # DAT_FREQ is written float64 ('D', PSRFITS permits it): channel
        # frequencies survive an icar/npz -> PSRFITS round-trip exactly
        # instead of being squeezed through float32
        _card("TTYPE3", "DAT_FREQ"), _card("TFORM3", f"{nchan}D"),
        _card("TTYPE4", "DAT_WTS"), _card("TFORM4", f"{nchan}E"),
        _card("TTYPE5", "DAT_SCL"), _card("TFORM5", f"{ncell}E"),
        _card("TTYPE6", "DAT_OFFS"), _card("TFORM6", f"{ncell}E"),
        _card("TTYPE7", "DATA"), _card("TFORM7", f"{ncell * nbin}{data_code}"),
        _card("TDIM7", f"({nbin},{nchan},{npol})", "DATA row shape"),
    ])

    # per-(sub, pol, chan) scale/offset; float32 rows keep identity scaling.
    # scl/offs are stored as float32, so quantisation must use the float32-
    # rounded values the reader will reconstruct with — otherwise a large
    # baseline offset adds |offs|*2^-24 of error on top of span/65534.
    if nbits == 16:
        lo = cube.min(axis=3)                      # (nsub, npol, nchan)
        hi = cube.max(axis=3)
        # offs rounds to float32 first; scl then covers the true range
        # around the *rounded* centre (else the float32 shift of offs —
        # up to |offs|*2^-24 — pushes values past +-32767 into clipping),
        # and itself rounds UP to the next float32 so the range still fits.
        offs = ((lo + hi) / 2.0).astype(np.float32).astype(np.float64)
        amp = np.maximum(hi - offs, offs - lo)
        scl32 = np.where(amp == 0, 1.0, amp / 32767.0).astype(np.float32)
        need = np.where(amp == 0, 1.0, amp / 32767.0)
        scl32 = np.where(scl32.astype(np.float64) < need,
                         np.nextafter(scl32, np.float32(np.inf)), scl32)
        scl = scl32.astype(np.float64)
        quant = np.rint((cube - offs[..., None]) / scl[..., None])
        rows_data = np.clip(quant, -32767, 32767).astype(data_np)
    else:
        scl = np.ones((nsub, npol, nchan))
        offs = np.zeros((nsub, npol, nchan))
        rows_data = cube.astype(data_np)

    # callers (io/npz.save_archive) give a temp name and rename it
    with open(path, "wb") as f:
        f.write(primary)
        f.write(subint)
        freqs_be = np.asarray(ar.freqs_mhz, dtype=">f8").tobytes()
        for isub in range(nsub):
            f.write(struct.pack(">d", tsub))
            f.write(struct.pack(">d", (isub + 0.5) * tsub))
            f.write(freqs_be)
            f.write(np.asarray(ar.weights[isub], dtype=">f4").tobytes())
            f.write(np.asarray(scl[isub], dtype=">f4").tobytes())
            f.write(np.asarray(offs[isub], dtype=">f4").tobytes())
            f.write(rows_data[isub].tobytes())
        f.write(b"\x00" * ((-f.tell()) % BLOCK))


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------

def _find_subint(buf: memoryview):
    primary = None
    stopped = []
    for cards, data_off in _iter_hdus(buf, stopped_early=stopped):
        if primary is None:
            primary = cards
            continue
        if cards.get("EXTNAME", "").strip() == "SUBINT":
            return primary, cards, data_off
    if stopped:
        # the walk ended at non-FITS bytes BEFORE any SUBINT table: that
        # is corruption/truncation, not a non-fold-mode archive — keep the
        # distinct error the pre-tolerance reader gave such files
        raise ValueError(
            f"no SUBINT table before non-FITS bytes at offset {stopped[0]} "
            "(corrupt or truncated FITS?)")
    raise ValueError("no SUBINT binary table in file (not a fold-mode "
                     "PSRFITS archive?)")


def _resolve_period(buf: memoryview, subint_cards) -> float:
    period = _as_float(subint_cards, "PERIOD", 0.0)  # 0 = unset
    if period > 0:
        return period
    stopped = []
    for cards, data_off in _iter_hdus(buf, stopped_early=stopped):
        if cards.get("EXTNAME", "").strip() == "POLYCO":
            cols, row_bytes = _columns(cards)
            nrows = _as_int(cards, "NAXIS2")
            for name, code, repeat, off in cols:
                if name == "REF_F0" and code == "D" and nrows:
                    last = data_off + (nrows - 1) * row_bytes + off
                    if last + 8 > len(buf):
                        # truncated POLYCO: no usable REF_F0 — fall through
                        # to the TBIN identity (struct.error would escape
                        # otherwise)
                        continue
                    f0 = struct.unpack(">d", bytes(buf[last: last + 8]))[0]
                    if f0 > 0:
                        return 1.0 / f0
    # fold-mode identity: TBIN = PERIOD / NBIN
    period = _as_float(subint_cards, "TBIN", 0.0) * _as_int(subint_cards,
                                                            "NBIN")
    if period > 0:
        if stopped:
            # the POLYCO search ended at non-FITS bytes, so a POLYCO table
            # beyond them would have been missed: the TBIN identity may
            # not be the writer's intended period source — load, but say so
            import warnings

            warnings.warn(
                "PSRFITS period resolved from TBIN*NBIN, but the HDU walk "
                f"stopped at non-FITS bytes (offset {stopped[0]}) before "
                "the POLYCO search completed — verify the folding period",
                stacklevel=2)
        return period
    raise ValueError("cannot determine the folding period (no usable "
                     "PERIOD key, POLYCO REF_F0, or TBIN)")



def _mmap_parse(path: str, parser):
    """Run ``parser(memoryview, path)`` over an mmap of the file.

    mmap instead of read(): the raw file never goes resident on top of the
    arrays being built (parsers only return copies).  Zero-byte files get a
    clear not-a-FITS error instead of mmap's internal one."""
    import mmap

    with open(path, "rb") as f:
        try:
            mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        except ValueError as e:
            raise ValueError(f"{path} is not a FITS file ({e})") from None
    try:
        return parser(memoryview(mm), path)
    finally:
        try:
            mm.close()
        except BufferError:
            pass  # an error traceback still holds views; GC closes it later




def load_psrfits(path: str) -> Archive:
    """Load a fold-mode PSRFITS archive (the pure-Python reader)."""
    return _mmap_parse(path, _parse_psrfits)


def _parse_psrfits(buf: memoryview, path: str) -> Archive:
    if bytes(buf[:6]) != b"SIMPLE":
        raise ValueError(f"{path} is not a FITS file")
    primary, sub, data_off = _find_subint(buf)
    if primary.get("OBS_MODE", "PSR").strip() not in ("PSR", "CAL"):
        raise ValueError(
            f"OBS_MODE={primary.get('OBS_MODE')!r}: only fold-mode (PSR/CAL) "
            "PSRFITS is supported")

    nsub = _as_int(sub, "NAXIS2")
    nbin = _as_int(sub, "NBIN")
    nchan = _as_int(sub, "NCHAN")
    npol = _as_int(sub, "NPOL")
    cols, row_bytes = _columns(sub)
    if row_bytes != _as_int(sub, "NAXIS1"):
        raise ValueError("SUBINT NAXIS1 disagrees with TFORM column widths")
    col = {name: (code, repeat, off) for name, code, repeat, off in cols}
    for need in ("DAT_FREQ", "DAT_WTS", "DAT_SCL", "DAT_OFFS", "DATA"):
        if need not in col:
            raise ValueError(f"SUBINT table missing column {need}")
    dcode, drepeat, d_off = col["DATA"]
    if dcode not in ("I", "E"):
        raise ValueError(f"DATA column type {dcode!r} unsupported "
                         "(expected I=int16 or E=float32)")
    if drepeat != npol * nchan * nbin:
        raise ValueError("DATA repeat count disagrees with NBIN*NCHAN*NPOL")
    ncell = npol * nchan

    table = np.frombuffer(buf, dtype=np.uint8, count=nsub * row_bytes,
                          offset=data_off).reshape(nsub, row_bytes)

    def column(name, dtype, count):
        # repeat > count is tolerated (padded columns; the first `count`
        # values are the payload); repeat < count errors
        code, repeat, off = col[name]
        if repeat < count:
            raise ValueError(
                f"SUBINT column {name}: repeat {repeat} < expected {count}")
        width = count * _TFORM_BYTES[code]
        flat = np.ascontiguousarray(table[:, off: off + width])
        return flat.view(dtype).reshape(nsub, count)

    tsubint = column("TSUBINT", ">f8", 1)[:, 0] if "TSUBINT" in col else \
        np.zeros(nsub)
    # DAT_FREQ may be E (float32, the common layout) or D (float64, what
    # this writer emits); honour the column's own code
    fcode = col["DAT_FREQ"][0]
    if fcode not in ("E", "D"):
        raise ValueError(f"DAT_FREQ column type {fcode!r} unsupported "
                         "(expected E=float32 or D=float64)")
    freqs = column("DAT_FREQ", ">f8" if fcode == "D" else ">f4",
                   nchan)[0].astype(np.float64)
    weights = column("DAT_WTS", ">f4", nchan).astype(np.float64)
    scl = column("DAT_SCL", ">f4", ncell).astype(np.float64)
    offs = column("DAT_OFFS", ">f4", ncell).astype(np.float64)
    if dcode == "I":
        rawd = column("DATA", ">i2", drepeat).astype(np.float64)
    else:
        rawd = column("DATA", ">f4", drepeat).astype(np.float64)
    cube = (rawd.reshape(nsub, ncell, nbin) * scl[:, :, None]
            + offs[:, :, None]).reshape(nsub, npol, nchan, nbin)

    mjd_start = (_as_int(primary, "STT_IMJD", 0)
                 + _as_int(primary, "STT_SMJD", 0) / 86400.0
                 + _as_float(primary, "STT_OFFS", 0.0) / 86400.0)
    mjd_end = mjd_start + float(np.sum(tsubint)) / 86400.0
    pol_type = sub.get("POL_TYPE", "INTEN").strip().upper()
    pol_state = _STATE_OF_POL_TYPE.get(pol_type,
                                       "Intensity" if npol == 1 else "Stokes")
    if pol_state not in POL_STATES:  # pragma: no cover - mapping is closed
        pol_state = "Intensity"
    return Archive(
        data=cube,
        weights=weights,
        freqs_mhz=freqs,
        period_s=_resolve_period(buf, sub),
        dm=_as_float(sub, "CHAN_DM", _as_float(sub, "DM", 0.0)),
        centre_freq_mhz=_as_float(primary, "OBSFREQ",
                                  float(freqs[nchan // 2])),
        source=primary.get("SRC_NAME", "unknown").strip(),
        mjd_start=mjd_start,
        mjd_end=mjd_end,
        filename=path,
        pol_state=pol_state,
        dedispersed=bool(_as_int(sub, "DEDISP", 0)),
        psrfits_nbits=16 if dcode == "I" else 32,
    )


def is_fits(path: str) -> bool:
    """Cheap magic sniff: FITS files begin with the SIMPLE card."""
    try:
        with open(path, "rb") as f:
            return f.read(6) == b"SIMPLE"
    except OSError:
        return False
