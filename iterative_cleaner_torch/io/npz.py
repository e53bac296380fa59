"""Archive containers and the dispatch by extension.

- ``.npz``: the portable container (the same member layout as the
  reference package's, so either package reads the other's files).
- ``.icar``: the native container (:mod:`~iterative_cleaner_torch.io.
  native`), read through an mmap.
- ``.sf``/``.rf``/``.fits``/``.psrfits``, and ``.ar`` files that carry
  the FITS magic: fold-mode PSRFITS (:mod:`~iterative_cleaner_torch.io.
  psrfits`, the native reader first).
- ``.ar`` files without the FITS magic (TIMER format): the psrchive
  bridge (:mod:`~iterative_cleaner_torch.io.psrchive_bridge`) when its
  bindings are installed.  A cleaned archive whose source is a TIMER
  ``.ar`` is written back in that format through the bridge; any other
  ``.ar`` is written as PSRFITS.

Every writer but the bridge's is atomic (temp file + ``os.replace``).
"""

from __future__ import annotations

import os

import numpy as np

from iterative_cleaner_torch.archive import Archive
from iterative_cleaner_torch.io import native, psrfits
from iterative_cleaner_torch.io.atomic import atomic_output

_META_KEYS = ("period_s", "dm", "centre_freq_mhz", "mjd_start", "mjd_end")

PSRFITS_EXTS = (".sf", ".rf", ".fits", ".psrfits")


def _ext(path: str) -> str:
    return os.path.splitext(path)[1].lower()


def save_archive(ar: Archive, path: str) -> None:
    """Write ``ar`` to ``path`` in the container its extension names
    (``.npz`` when it has none).  The npz is written through a file
    object so numpy cannot append '.npz' to the name."""
    ext = _ext(path)
    if ext == ".icar":
        native.save_icar(ar, path)
        return
    if ext in PSRFITS_EXTS or ext == ".ar":
        src = ar.filename
        if ext == ".ar" and src and src.lower().endswith(".ar"):
            if not os.path.exists(src):
                import warnings

                warnings.warn(
                    f"source archive {src} is no longer on disk; writing "
                    f"{path} in the built-in PSRFITS layout (a TIMER-format "
                    "source would otherwise round-trip through the psrchive "
                    "bridge)", stacklevel=2)
            elif not psrfits.is_fits(src):
                # a TIMER source keeps its format (PSRCHIVE's unload);
                # the bridge loaded it, so its bindings import here
                from iterative_cleaner_torch.io import psrchive_bridge

                psrchive_bridge.save_ar(ar, path)
                return
        with atomic_output(path) as tmp:
            psrfits.save_psrfits(ar, tmp)
        return
    with atomic_output(path) as tmp:
        with open(tmp, "wb") as f:
            np.savez_compressed(
                f,
                data=ar.data,
                weights=ar.weights,
                freqs_mhz=ar.freqs_mhz,
                period_s=ar.period_s,
                dm=ar.dm,
                centre_freq_mhz=ar.centre_freq_mhz,
                mjd_start=ar.mjd_start,
                mjd_end=ar.mjd_end,
                source=np.array(ar.source),
                pol_state=np.array(ar.pol_state),
                dedispersed=np.array(ar.dedispersed),
                psrfits_nbits=np.array(ar.psrfits_nbits),
            )


def peek_shape(path: str, cheap_only: bool = False):
    """``(nsub, nchan, nbin, dedispersed)`` without reading the data cube:
    the key the CLI's ``--batch`` prepass groups archives by (a batch
    cleans equal keys only).  ``.icar`` reads its header, PSRFITS its
    header cards (an mmap), ``.npz`` the ``data`` member's npy header and
    the ``dedispersed`` member.  A TIMER ``.ar`` has no header-only read:
    it is loaded through the bridge, or with ``cheap_only`` raises
    ``ValueError`` (the prepass then leaves it to the group loop's load
    instead of loading it twice)."""
    ext = _ext(path)
    if ext == ".icar":
        m = native.read_icar_header(path)
        return m["nsub"], m["nchan"], m["nbin"], m["dedispersed"]
    if ext in PSRFITS_EXTS or ext == ".ar":
        if ext != ".ar" or psrfits.is_fits(path):
            return psrfits.read_psrfits_shape(path)
        if cheap_only:
            raise ValueError(
                f"{path}: TIMER-format .ar has no header-only shape peek")
        ar = load_archive(path)
        return ar.nsub, ar.nchan, ar.nbin, ar.dedispersed
    import zipfile

    from numpy.lib import format as npy_format

    with zipfile.ZipFile(path) as z:
        with z.open("data.npy") as f:
            version = npy_format.read_magic(f)
            if version == (1, 0):
                shape, _, _ = npy_format.read_array_header_1_0(f)
            else:
                shape, _, _ = npy_format.read_array_header_2_0(f)
        with z.open("dedispersed.npy") as f:
            ded = bool(npy_format.read_array(f, allow_pickle=False))
    nsub, _npol, nchan, nbin = shape
    return int(nsub), int(nchan), int(nbin), ded


def load_archive(path: str) -> Archive:
    """Read the archive at ``path``, by its extension (and, for ``.ar``,
    its FITS magic)."""
    ext = _ext(path)
    if ext == ".icar":
        return native.load_icar(path)
    if ext in PSRFITS_EXTS:
        return psrfits.load_psrfits(path)
    if ext == ".ar":
        if psrfits.is_fits(path):
            return psrfits.load_psrfits(path)
        from iterative_cleaner_torch.io import psrchive_bridge

        try:
            return psrchive_bridge.load_ar(path)
        except ImportError as e:
            raise ValueError(
                f"{path} is a pre-PSRFITS (TIMER-format) .ar archive and "
                "the psrchive Python bindings are not installed. Either "
                "convert it once with PSRCHIVE's own tools — "
                "`psrconv -o PSRFITS " + os.path.basename(path) + "` (or "
                "`pam -a PSRFITS`) — and clean the resulting PSRFITS file, "
                "or run in an environment where `import psrchive` works "
                "(the optional bridge then loads TIMER directly). See "
                "MIGRATION.md."
            ) from e
    with np.load(path, allow_pickle=False) as z:
        kwargs = {k: float(z[k]) for k in _META_KEYS}
        return Archive(
            data=z["data"],
            weights=z["weights"],
            freqs_mhz=z["freqs_mhz"],
            source=str(z["source"]),
            pol_state=str(z["pol_state"]),
            dedispersed=bool(z["dedispersed"]),
            psrfits_nbits=int(z["psrfits_nbits"])
            if "psrfits_nbits" in z.files else 16,
            filename=path,
            **kwargs,
        )
