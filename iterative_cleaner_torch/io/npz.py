"""Archive containers and the dispatch by extension.

- ``.npz``: the portable container (the same member layout as the
  reference package's, so either package reads the other's files).
- ``.sf``/``.rf``/``.fits``/``.psrfits``, and ``.ar`` files that carry
  the FITS magic: fold-mode PSRFITS (:mod:`~iterative_cleaner_torch.io.
  psrfits`); a cleaned ``.ar`` is written as PSRFITS.
- ``.icar`` (the reference's native container) and TIMER-format ``.ar``
  archives (no FITS magic; the reference reads them through the psrchive
  bridge) are not ported: ROADMAP.md 'Modules still to port' item 2.

Every writer is atomic (temp file + ``os.replace``).
"""

from __future__ import annotations

import os

import numpy as np

from iterative_cleaner_torch.archive import Archive
from iterative_cleaner_torch.io import psrfits
from iterative_cleaner_torch.io.atomic import atomic_output

_META_KEYS = ("period_s", "dm", "centre_freq_mhz", "mjd_start", "mjd_end")

PSRFITS_EXTS = (".sf", ".rf", ".fits", ".psrfits")

_NOT_PORTED = "is not ported yet (ROADMAP.md 'Modules still to port' item 2)"


def _ext(path: str) -> str:
    return os.path.splitext(path)[1].lower()


def save_archive(ar: Archive, path: str) -> None:
    """Write ``ar`` to ``path`` atomically, in the container its
    extension names (``.npz`` when it has none).  The npz is written
    through a file object so numpy cannot append '.npz' to the name."""
    ext = _ext(path)
    if ext == ".icar":
        raise NotImplementedError(f"{path}: the .icar container {_NOT_PORTED}")
    if ext in PSRFITS_EXTS or ext == ".ar":
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


def load_archive(path: str) -> Archive:
    """Read the archive at ``path``, by its extension (and, for ``.ar``,
    its FITS magic)."""
    ext = _ext(path)
    if ext == ".icar":
        raise NotImplementedError(f"{path}: the .icar container {_NOT_PORTED}")
    if ext in PSRFITS_EXTS:
        return psrfits.load_psrfits(path)
    if ext == ".ar":
        if psrfits.is_fits(path):
            return psrfits.load_psrfits(path)
        raise NotImplementedError(
            f"{path}: a pre-PSRFITS (TIMER-format) .ar archive; the psrchive "
            f"bridge that reads it {_NOT_PORTED}.  Convert it once with "
            f"PSRCHIVE (`psrconv -o PSRFITS {os.path.basename(path)}`) and "
            f"clean the PSRFITS file")
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
