"""The port's PSRFITS reader and writer and its archive dispatch, against
the reference package's pure-Python ones on identical archives.

Exact throughout: the port writes the same bytes as the reference for
the same archive (int16 and float32 DATA, every pol state, non-finite
cubes), each package loads the other's file to equal arrays and
metadata, foreign writers' layouts and corrupted files load to the same
archive or are refused by both, and the extension dispatch refuses what
is not ported (``.icar``, TIMER-format ``.ar``) with
``NotImplementedError``.
"""

import dataclasses
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
from tests.test_psrfits import _write_foreign_variant

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


def test_unported_containers_refused(tmp_path):
    ref, ar = _pair()
    icar = str(tmp_path / "a.icar")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        save_archive(ar, icar)
    ref_save_archive(ref, icar)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        load_archive(icar)
    timer = str(tmp_path / "old.ar")
    with open(timer, "wb") as f:
        f.write(b"TIMER archive header" + b"\0" * 512)
    assert not psrfits.is_fits(timer)
    with pytest.raises(NotImplementedError, match="TIMER"):
        load_archive(timer)


@pytest.mark.parametrize("variant", [
    dict(order=["DATA", "DAT_OFFS", "DAT_SCL", "DAT_WTS", "DAT_FREQ",
                "OFFS_SUB", "TSUBINT"]),
    dict(tdim="none"),
    dict(tdim="spaces"),
    dict(leading_hdu=True, trailing_hdu=True, long_string=True,
         period="polyco", data_code="I"),
    dict(data_code="B"),
])
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


def test_corrupted_files_load_or_fail_like_reference(tmp_path):
    """Truncations, bit flips and garbage blocks (seeded): the port
    loads each to the reference's archive or raises where it raises."""
    ref, ar = _pair(nsub=4, nchan=6, nbin=16)
    good = tmp_path / "g.sf"
    psrfits.save_psrfits(ar, str(good))
    raw = good.read_bytes()
    rng = np.random.default_rng(2)
    bad = tmp_path / "bad.sf"
    for trial in range(36):
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
        with np.errstate(all="ignore"), warnings.catch_warnings():
            warnings.simplefilter("ignore")
            try:
                want = ref_psrfits.load_psrfits(str(bad), prefer_native=False)
            except Exception as exc:  # the reference refuses: so must we
                with pytest.raises(type(exc)):
                    psrfits.load_psrfits(str(bad))
                continue
            got = psrfits.load_psrfits(str(bad))
        np.testing.assert_array_equal(got.data, want.data)
        np.testing.assert_array_equal(got.weights, want.weights)


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