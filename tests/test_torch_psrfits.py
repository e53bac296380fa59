"""The port's PSRFITS readers and writer and its archive dispatch, against
the reference package's on identical archives.

Exact throughout: the port writes the same bytes as the reference for
the same archive (int16 and float32 DATA, every pol state, non-finite
cubes), each package loads the other's file to equal arrays and
metadata, foreign writers' layouts and corrupted files load to the same
archive or are refused by both.  The port's native reader (the host
library's C++ reader, the default) is bit-equal to its pure-Python
reader and to the reference's ``load_psrfits`` on every layout the
parser takes (int16 and float32 DATA, float32 and float64 DAT_FREQ,
padded repeats, shuffled columns, a POLYCO and a TBIN period, OBSFREQ
absent), declines what lies outside its subset, and such files then
load or fail as the reference's do.
"""

import dataclasses
import struct
import warnings

import numpy as np
import pytest

from iterative_cleaner_tpu.io import load_archive as ref_load_archive
from iterative_cleaner_tpu.io import psrfits as ref_psrfits
from iterative_cleaner_tpu.io import save_archive as ref_save_archive
from iterative_cleaner_tpu.io.synthetic import (
    make_synthetic_archive as ref_make_synthetic_archive,
)
from iterative_cleaner_torch.convert import archive_from_reference
from iterative_cleaner_torch.io import load_archive, save_archive
from iterative_cleaner_torch.io import psrfits
from tests.test_psrfits import _strip_card, _write_foreign_variant

_META = ("period_s", "dm", "centre_freq_mhz", "source", "mjd_start",
         "mjd_end", "pol_state", "dedispersed", "psrfits_nbits")


def _pair(npol=1, pol_state=None, **kw):
    """The same synthetic archive in both packages."""
    args = dict(nsub=6, nchan=8, nbin=32, seed=1, n_prezapped=3)
    args.update(kw)
    ref, _ = ref_make_synthetic_archive(npol=npol, **args)
    if pol_state:
        ref.pol_state = pol_state
    return ref, archive_from_reference(ref)


def _assert_same_archive(got, want):
    np.testing.assert_array_equal(got.data, want.data)
    np.testing.assert_array_equal(got.weights, want.weights)
    np.testing.assert_array_equal(got.freqs_mhz, want.freqs_mhz)
    for key in _META:
        assert getattr(got, key) == getattr(want, key), key


@pytest.mark.parametrize("nbits", [16, 32, None])
@pytest.mark.parametrize("npol,pol_state", [(1, None), (4, "Stokes"),
                                            (4, "Coherence")])
def test_writer_bytes_equal_reference(tmp_path, nbits, npol, pol_state):
    ref, ar = _pair(npol=npol, pol_state=pol_state)
    mine, theirs = str(tmp_path / "port.sf"), str(tmp_path / "ref.sf")
    psrfits.save_psrfits(ar, mine, nbits=nbits)
    ref_psrfits.save_psrfits(ref, theirs, nbits=nbits)
    with open(mine, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()


def test_nonfinite_cube_written_float32_like_reference(tmp_path):
    ref, ar = _pair()
    for a in (ref, ar):
        a.data = a.data.copy()
        a.data[0, 0, 1, 3] = np.nan
        a.data[1, 0, 2, 4] = np.inf
    mine, theirs = str(tmp_path / "port.sf"), str(tmp_path / "ref.sf")
    psrfits.save_psrfits(ar, mine, nbits=16)
    ref_psrfits.save_psrfits(ref, theirs, nbits=16)
    with open(mine, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
    back = psrfits.load_psrfits(mine)
    assert back.psrfits_nbits == 32
    np.testing.assert_array_equal(back.data, ref_psrfits.load_psrfits(
        theirs, prefer_native=False).data)


@pytest.mark.parametrize("ext", [".sf", ".rf", ".fits", ".psrfits", ".ar"])
@pytest.mark.parametrize("nbits", [16, 32])
def test_each_package_loads_the_others_file(tmp_path, ext, nbits):
    ref, ar = _pair(npol=2, pol_state="Coherence")
    ar.psrfits_nbits = ref.psrfits_nbits = nbits
    mine = str(tmp_path / ("port" + ext))
    theirs = str(tmp_path / ("ref" + ext))
    save_archive(ar, mine)
    ref_save_archive(ref, theirs)
    got = load_archive(theirs)
    want = ref_psrfits.load_psrfits(theirs, prefer_native=False)
    _assert_same_archive(got, archive_from_reference(want))
    assert got.filename == theirs
    back = ref_load_archive(mine)
    _assert_same_archive(load_archive(mine), archive_from_reference(back))


def test_float32_round_trip_exact(tmp_path):
    ref, ar = _pair()
    ar.data = np.asarray(ar.data, np.float32).astype(np.float64)
    path = str(tmp_path / "f.sf")
    psrfits.save_psrfits(ar, path, nbits=32)
    back = psrfits.load_psrfits(path)
    np.testing.assert_array_equal(back.data, ar.data)
    np.testing.assert_array_equal(back.weights, ar.weights)
    assert back.psrfits_nbits == 32


def test_is_fits_matches_reference(tmp_path):
    _, ar = _pair(nsub=5, nchan=12, nbin=16)
    fits, npz = str(tmp_path / "i.sf"), str(tmp_path / "i.npz")
    psrfits.save_psrfits(ar, fits)
    save_archive(ar, npz)
    for path, want in ((fits, True), (npz, False),
                       (str(tmp_path / "missing.sf"), False)):
        assert psrfits.is_fits(path) == ref_psrfits.is_fits(path) == want


def test_npz_container_unchanged(tmp_path):
    ref, ar = _pair()
    path = str(tmp_path / "a.npz")
    save_archive(ar, path)
    _assert_same_archive(load_archive(path),
                         archive_from_reference(ref_load_archive(path)))


def test_ar_dispatch_by_fits_magic(tmp_path):
    """A cleaned ``.ar`` is written as PSRFITS; an ``.ar`` with the FITS
    magic loads through the PSRFITS reader."""
    ref, ar = _pair()
    path = str(tmp_path / "obs.ar")
    save_archive(ar, path)
    assert psrfits.is_fits(path)
    _assert_same_archive(load_archive(path), archive_from_reference(
        ref_psrfits.load_psrfits(path, prefer_native=False)))


FOREIGN_VARIANTS = [
    dict(order=["DATA", "DAT_OFFS", "DAT_SCL", "DAT_WTS", "DAT_FREQ",
                "OFFS_SUB", "TSUBINT"]),
    dict(tdim="none"),
    dict(tdim="spaces"),
    dict(leading_hdu=True, trailing_hdu=True, long_string=True,
         period="polyco", data_code="I"),
    dict(data_code="B"),
]


@pytest.mark.parametrize("variant", FOREIGN_VARIANTS)
def test_foreign_writer_variants_load_like_reference(tmp_path, variant):
    """Layouts another writer may emit: the port loads each to the
    reference's archive, or refuses it as the reference does."""
    ar, _ = ref_make_synthetic_archive(nsub=4, nchan=6, nbin=16, seed=11,
                                       n_rfi_cells=2)
    ar.data = np.asarray(ar.data, dtype=np.float32).astype(np.float64)
    ar.freqs_mhz = np.asarray(ar.freqs_mhz, np.float32).astype(np.float64)
    path = str(tmp_path / "foreign.sf")
    _write_foreign_variant(ar, path, **variant)
    try:
        want = ref_psrfits.load_psrfits(path, prefer_native=False)
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            psrfits.load_psrfits(path)
        assert str(got.value) == str(exc)
        return
    _assert_same_archive(psrfits.load_psrfits(path),
                         archive_from_reference(want))


def _corrupted_files(tmp_path, trials=36):
    """Truncations, bit flips and garbage blocks of one good file
    (seeded), each written to the same path in turn."""
    ref, ar = _pair(nsub=4, nchan=6, nbin=16)
    good = tmp_path / "g.sf"
    psrfits.save_psrfits(ar, str(good))
    raw = good.read_bytes()
    rng = np.random.default_rng(2)
    bad = tmp_path / "bad.sf"
    for trial in range(trials):
        buf = bytearray(raw)
        kind = trial % 3
        if kind == 0:
            buf = buf[: int(rng.integers(1, len(buf)))]
        elif kind == 1:
            for _ in range(int(rng.integers(1, 50))):
                i = int(rng.integers(0, len(buf)))
                buf[i] ^= int(rng.integers(1, 256))
        else:
            i = int(rng.integers(0, len(buf)))
            n = int(rng.integers(1, 2880))
            buf[i: i + n] = bytes(rng.integers(0, 256, size=n,
                                               dtype=np.uint8))
        bad.write_bytes(bytes(buf))
        yield str(bad)


def _load_or_fail_like_reference(path, prefer_native):
    with np.errstate(all="ignore"), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            want = ref_psrfits.load_psrfits(path, prefer_native=prefer_native)
        except Exception as exc:  # the reference refuses: so must we
            with pytest.raises(type(exc)):
                psrfits.load_psrfits(path, prefer_native=prefer_native)
            return
        got = psrfits.load_psrfits(path, prefer_native=prefer_native)
    np.testing.assert_array_equal(got.data, want.data)
    np.testing.assert_array_equal(got.weights, want.weights)


def test_corrupted_files_load_or_fail_like_reference(tmp_path):
    """The port loads each corrupted file to the archive the reference's
    ``load_psrfits`` gives or raises where it raises, both preferring
    their native readers as they do by default (the reference prefers
    its library when it loads in this process), and the two native
    readers decline the same files."""
    prefer = ref_psrfits._psrfits_lib() is not None
    for path in _corrupted_files(tmp_path):
        _load_or_fail_like_reference(path, prefer)
        with np.errstate(all="ignore"):
            nat = psrfits._load_psrfits_native(path)
            ref_nat = ref_psrfits._load_psrfits_native(path)
        if prefer:
            assert (nat is None) == (ref_nat is None)
        if nat is not None and ref_nat is not None:
            _assert_same_archive(nat, archive_from_reference(ref_nat))


def test_corrupted_files_pure_reader_like_reference(tmp_path):
    for path in _corrupted_files(tmp_path):
        _load_or_fail_like_reference(path, prefer_native=False)


def _same_three_ways(path):
    """The port's native reader, its pure-Python reader and the
    reference's ``load_psrfits`` on one file: equal bits everywhere."""
    nat = psrfits._load_psrfits_native(path)
    assert nat is not None, "the native reader declined a supported file"
    pure = psrfits.load_psrfits(path, prefer_native=False)
    ref = archive_from_reference(ref_psrfits.load_psrfits(path))
    for got in (nat, pure):
        _assert_same_archive(got, ref)
        assert got.filename == path
    _assert_same_archive(psrfits.load_psrfits(path), nat)
    return nat


@pytest.mark.parametrize("variant", FOREIGN_VARIANTS)
def test_native_reader_bit_equal_on_foreign_variants(tmp_path, variant):
    """float32 DAT_FREQ, shuffled columns, TDIM spellings, extra HDUs,
    long strings: the three readers agree.  A layout the reference
    refuses (8-bit DATA; int16 TFORM over float32 rows) the native
    reader declines, and the port fails with the reference's error."""
    ar, _ = ref_make_synthetic_archive(nsub=4, nchan=6, nbin=16, seed=11,
                                       n_rfi_cells=2)
    ar.data = np.asarray(ar.data, dtype=np.float32).astype(np.float64)
    ar.freqs_mhz = np.asarray(ar.freqs_mhz, np.float32).astype(np.float64)
    path = str(tmp_path / "foreign.sf")
    _write_foreign_variant(ar, path, **variant)
    try:
        ref_psrfits.load_psrfits(path)
    except ValueError as exc:
        assert psrfits._load_psrfits_native(path) is None
        with pytest.raises(ValueError) as got:
            psrfits.load_psrfits(path)
        assert str(got.value) == str(exc)
        return
    _same_three_ways(path)


def _append_polyco(path, out, f0):
    """``path`` without its PERIOD card and with a POLYCO table whose
    last row's REF_F0 is ``f0``."""
    polyco = psrfits._end_pad([
        psrfits._card("XTENSION", "BINTABLE"),
        psrfits._card("BITPIX", 8),
        psrfits._card("NAXIS", 2),
        psrfits._card("NAXIS1", 8),
        psrfits._card("NAXIS2", 2),
        psrfits._card("PCOUNT", 0),
        psrfits._card("GCOUNT", 1),
        psrfits._card("TFIELDS", 1),
        psrfits._card("EXTNAME", "POLYCO"),
        psrfits._card("TTYPE1", "REF_F0"),
        psrfits._card("TFORM1", "1D"),
    ])
    rows = struct.pack(">d", 1.0) + struct.pack(">d", f0)
    rows += b"\x00" * ((-len(rows)) % psrfits.BLOCK)
    with open(out, "wb") as f:
        f.write(_strip_card(path, "PERIOD"))
        f.write(polyco)
        f.write(rows)


@pytest.mark.parametrize("layout", ["int16", "float32", "coherence16",
                                    "polyco", "tbin", "no_obsfreq",
                                    "padded"])
def test_native_reader_bit_equal_on_layouts(tmp_path, layout):
    """The port's writer's layouts (float64 DAT_FREQ) and the period and
    OBSFREQ rules: int16 and float32 DATA, a four-pol coherence cube,
    the period from a POLYCO table and from TBIN * NBIN, OBSFREQ absent
    (the middle channel's frequency stands in), padded repeats."""
    npol, state = (4, "Coherence") if layout == "coherence16" else (1, None)
    ref, ar = _pair(npol=npol, pol_state=state, nsub=9, nchan=10, nbin=24)
    ar.data[0, 0, 1, 2] = -3.0e5   # a wide int16 scale in one cell
    path = str(tmp_path / "obs.sf")
    psrfits.save_psrfits(ar, path, nbits=32 if layout == "float32" else 16)
    if layout in ("polyco", "tbin", "no_obsfreq"):
        out = str(tmp_path / f"{layout}.sf")
        if layout == "polyco":
            _append_polyco(path, out, f0=2.5)
        else:
            with open(out, "wb") as f:
                f.write(_strip_card(path, "PERIOD" if layout == "tbin"
                                    else "OBSFREQ"))
        path = out
    if layout == "padded":
        # every column but DATA one entry longer than its payload
        raw = bytearray(open(path, "rb").read())
        nchan, ncell = ar.nchan, ar.npol * ar.nchan
        for key, old, new in (("TFORM3", f"{nchan}D", f"{nchan + 1}D"),
                              ("TFORM4", f"{nchan}E", f"{nchan + 1}E"),
                              ("TFORM5", f"{ncell}E", f"{ncell + 1}E"),
                              ("TFORM6", f"{ncell}E", f"{ncell + 1}E")):
            card = psrfits._card(key, old)
            i = bytes(raw).index(card)
            raw[i: i + 80] = psrfits._card(key, new)
        # the rows grow: rewrite them from the unpadded file's columns
        path = _repad_rows(bytes(raw), ar, str(tmp_path / "padded.sf"))
    got = _same_three_ways(path)
    if layout == "polyco":
        assert got.period_s == 1.0 / 2.5
    if layout == "no_obsfreq":
        assert got.centre_freq_mhz == got.freqs_mhz[ar.nchan // 2]


def _repad_rows(header_raw, ar, out):
    """A file with ``header_raw``'s headers (TFORMs already padded by one
    entry) whose rows carry one zero entry after each padded column's
    payload, NAXIS1 to match."""
    nchan, ncell = ar.nchan, ar.npol * ar.nchan
    buf = memoryview(header_raw)
    primary_end = psrfits._parse_header(buf, 0)[1]
    sub_cards, data_off = psrfits._parse_header(buf, primary_end)
    cols, _ = psrfits._columns(sub_cards)
    old_row = int(sub_cards["NAXIS1"])
    new_row = old_row + 8 + 4 + 4 + 4
    head = bytearray(header_raw[:data_off])
    i = bytes(head).index(psrfits._card("NAXIS1", old_row, "bytes per row"))
    head[i: i + 80] = psrfits._card("NAXIS1", new_row, "bytes per row")
    nsub = int(sub_cards["NAXIS2"])
    pads = {"DAT_FREQ": 8, "DAT_WTS": 4, "DAT_SCL": 4, "DAT_OFFS": 4}
    widths = {"TSUBINT": 8, "OFFS_SUB": 8, "DAT_FREQ": 8 * nchan,
              "DAT_WTS": 4 * nchan, "DAT_SCL": 4 * ncell,
              "DAT_OFFS": 4 * ncell}
    rows = bytearray()
    for isub in range(nsub):
        row = header_raw[data_off + isub * old_row:
                         data_off + (isub + 1) * old_row]
        off = 0
        for name, _code, _repeat, _off in cols:
            width = widths.get(name, len(row) - off)
            rows += row[off: off + width] + b"\x00" * pads.get(name, 0)
            off += width
    rows += b"\x00" * ((-(len(head) + len(rows))) % psrfits.BLOCK)
    with open(out, "wb") as f:
        f.write(bytes(head) + bytes(rows))
    return out


@pytest.mark.parametrize("kind", ["search_mode", "truncated", "zero_byte",
                                  "not_fits", "no_period"])
def test_declined_files_load_or_fail_like_reference(tmp_path, kind):
    """Files outside the native reader's subset: it declines each (as
    the reference's does), and the port then loads or fails as the
    reference's ``load_psrfits`` does, the same error and message."""
    _, ar = _pair()
    good = str(tmp_path / "g.sf")
    psrfits.save_psrfits(ar, good)
    raw = open(good, "rb").read()
    if kind == "search_mode":
        raw = raw.replace(b"'PSR     '", b"'SEARCH  '", 1)
    elif kind == "truncated":
        raw = raw[: len(raw) // 2]
    elif kind == "zero_byte":
        raw = b""
    elif kind == "not_fits":
        raw = b"\x00" * 5760
    else:
        raw = _strip_card(good, "PERIOD")
        open(good, "wb").write(raw)
        raw = _strip_card(good, "TBIN")
    path = str(tmp_path / f"{kind}.sf")
    open(path, "wb").write(raw)
    assert psrfits._load_psrfits_native(path) is None
    assert ref_psrfits._load_psrfits_native(path) is None
    try:
        want = ref_psrfits.load_psrfits(path)
    except Exception as exc:
        with pytest.raises(type(exc)) as got:
            psrfits.load_psrfits(path)
        assert str(got.value) == str(exc)
        return
    _assert_same_archive(psrfits.load_psrfits(path),
                         archive_from_reference(want))


def test_pscrunch_matches_reference():
    for npol, state in ((4, "Coherence"), (4, "Stokes"), (1, None)):
        ref, ar = _pair(npol=npol, pol_state=state)
        c = dataclasses.replace(ar, data=ar.data.copy())
        rc = ref.clone()
        c.pscrunch()
        rc.pscrunch()
        c.pscrunch()   # idempotent
        np.testing.assert_array_equal(c.data, rc.data)
        assert c.pol_state == rc.pol_state == "Intensity"
        assert c.npol == 1 and ar.npol == npol