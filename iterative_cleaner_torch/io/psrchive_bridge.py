"""The PSRCHIVE bridge: TIMER-format (pre-PSRFITS) ``.ar`` archives.

When the ``psrchive`` Python bindings are importable, an ``.ar`` file
PSRCHIVE reads is loaded into the port's :class:`Archive`, and a
cleaned archive is written back by clone-and-set (the original
cleaner's ``Archive_load``/``unload``).  Without the bindings every
call raises ``ImportError``; :mod:`~iterative_cleaner_torch.io.npz`
turns that into the conversion hint.  The port's own copy of the
reference package's bridge.
"""

from __future__ import annotations

import numpy as np

from iterative_cleaner_torch.archive import Archive


def _psrchive():
    try:
        import psrchive  # type: ignore
    except ImportError as e:
        raise ImportError(
            "Reading/writing PSRCHIVE .ar files requires the psrchive Python "
            "bindings, which are not installed. Convert archives to the .npz "
            "container instead (iterative_cleaner_torch.io.save_archive)."
        ) from e
    return psrchive


def _map_state(state: str, npol: int) -> str:
    """A PSRCHIVE Signal::State as the archive's pol_state: the coherence
    family (AABBCRCI and the two-product PPQQ) sums its first two
    products for total intensity, Stokes keeps I, and anything single
    product is Intensity."""
    if npol == 1 or state == "Intensity":
        return "Intensity"
    if state in ("Coherence", "PPQQ"):
        return "Coherence"
    return "Stokes"


def load_ar(path: str) -> Archive:
    psr = _psrchive()
    ar = psr.Archive_load(path)
    nchan = ar.get_nchan()
    freqs = np.array(
        [ar.get_Integration(0).get_centre_frequency(c) for c in range(nchan)],
        dtype=np.float64,
    )
    return Archive(
        data=ar.get_data().astype(np.float64),
        weights=ar.get_weights().astype(np.float64),
        freqs_mhz=freqs,
        period_s=float(ar.get_Integration(0).get_folding_period()),
        dm=float(ar.get_dispersion_measure()),
        centre_freq_mhz=float(ar.get_centre_frequency()),
        source=str(ar.get_source()),
        mjd_start=float(ar.start_time().in_days()),
        mjd_end=float(ar.end_time().in_days()),
        filename=path,
        pol_state=_map_state(str(ar.get_state()), int(ar.get_npol())),
        dedispersed=bool(ar.get_dedispersed()),
    )


def save_ar(archive: Archive, path: str) -> None:
    """Write ``archive`` to ``path`` in its source's PSRCHIVE format.

    A PSRCHIVE file carries far more header state than the
    :class:`Archive`, so the write is clone-and-set: reload the source
    (``archive.filename``), overwrite its (nsub, nchan) weights, write
    the amplitudes back when the model still has the source's (nsub,
    npol, nchan, nbin) shape (a pscrunched model scrunches the reload
    first: ``-p`` writes a single-pol archive), and ``unload`` to
    ``path``.  Not atomic: PSRCHIVE's ``unload`` owns the file, so an
    interrupted write can leave a torn file under ``path``.
    """
    psr = _psrchive()
    if not archive.filename:
        raise ValueError(
            "save_ar writes via clone-and-set and needs archive.filename to "
            "point at the psrchive-readable source file; for archives born "
            "in-framework use io.save_archive (.npz/PSRFITS) instead.")
    ar = psr.Archive_load(archive.filename)
    if archive.npol == 1 and ar.get_npol() > 1:
        ar.pscrunch()
    nsub, nchan = ar.get_nsubint(), ar.get_nchan()
    weights = np.asarray(archive.weights, dtype=np.float64)
    if weights.shape != (nsub, nchan):
        raise ValueError(
            f"weights shape {weights.shape} does not match the source "
            f"archive's ({nsub}, {nchan}); save_ar cannot clone-and-set "
            "across a reshaped cell grid")
    _set_weights(ar, weights)
    data = np.asarray(archive.data)
    if data.shape == (nsub, ar.get_npol(), nchan, ar.get_nbin()):
        # a weights-only save carries the source's data untouched: one
        # cube comparison costs far less than a binding call per profile
        src_data = np.asarray(ar.get_data(), dtype=data.dtype)
        if not np.array_equal(data, src_data):
            for isub, ipol, ichan in np.ndindex(*data.shape[:3]):
                prof = ar.get_Profile(isub, ipol, ichan)
                prof.get_amps()[:] = data[isub, ipol, ichan]
    ar.unload(path)


def _set_weights(ar, weights: np.ndarray) -> None:
    """Overwrite a loaded psrchive Archive's (nsub, nchan) weights in place."""
    for isub in range(ar.get_nsubint()):
        integ = ar.get_Integration(isub)
        for ichan in range(ar.get_nchan()):
            integ.set_weight(ichan, float(weights[isub, ichan]))


def apply_weights_to_ar(ar_path: str, out_path: str,
                        weights: np.ndarray) -> None:
    """Load ``ar_path`` with PSRCHIVE, overwrite its (nsub, nchan)
    weights with ``weights`` and unload it to ``out_path``."""
    psr = _psrchive()
    ar = psr.Archive_load(ar_path)
    _set_weights(ar, weights)
    ar.unload(out_path)
