"""The portable ``.npz`` archive container (the same member layout as the
reference package's, so either package reads the other's files).
PSRFITS and the native ``.icar`` loader are not ported yet (ROADMAP.md
'Modules still to port' item 2)."""

from __future__ import annotations

import os

import numpy as np

from iterative_cleaner_torch.archive import Archive
from iterative_cleaner_torch.io.atomic import atomic_output

_META_KEYS = ("period_s", "dm", "centre_freq_mhz", "mjd_start", "mjd_end")


def _check_npz(path: str) -> None:
    ext = os.path.splitext(path)[1].lower()
    if ext not in ("", ".npz"):
        raise NotImplementedError(
            f"{path}: only .npz archives are ported yet (ROADMAP.md "
            f"'Modules still to port' item 2)")


def save_archive(ar: Archive, path: str) -> None:
    """Write ``ar`` to ``path`` atomically.  Written through a file
    object so numpy cannot append '.npz' to the target name."""
    _check_npz(path)
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
    _check_npz(path)
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
