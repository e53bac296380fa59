"""Host-side archive data model: a fold-mode pulsar archive as numpy
arrays — the ``(nsub, npol, nchan, nbin)`` cube, the ``(nsub, nchan)``
weights and a small metadata record.  The port's own copy of the
reference package's ``archive.py`` (same fields, same semantics)."""

from __future__ import annotations

import dataclasses
import os

import numpy as np

# Dispersion constant: delay(s) = KDM_S * DM * f_MHz^-2, DM in pc cm^-3
# (the tempo/PSRCHIVE convention 1/2.41e-4).
KDM_S = 1.0 / 2.41e-4

# "Intensity" = already total intensity (npol == 1); "Stokes" = (I, Q, U,
# V), total intensity is component 0; "Coherence" = (AA, BB, Re, Im),
# total intensity is AA + BB.
POL_STATES = ("Intensity", "Stokes", "Coherence")


@dataclasses.dataclass
class Archive:
    """A pulsar fold-mode archive held as host numpy arrays."""

    data: np.ndarray           # (nsub, npol, nchan, nbin) float
    weights: np.ndarray        # (nsub, nchan) float
    freqs_mhz: np.ndarray      # (nchan,) sky frequency of each channel
    period_s: float            # folding period
    dm: float                  # dispersion measure, pc cm^-3
    centre_freq_mhz: float
    source: str = "synthetic"
    mjd_start: float = 60000.0
    mjd_end: float = 60000.01
    filename: str = ""
    pol_state: str = "Intensity"
    dedispersed: bool = False  # True once channel delays have been removed
    psrfits_nbits: int = 16    # DATA encoding if written as PSRFITS

    def __post_init__(self) -> None:
        if self.data.ndim != 4:
            raise ValueError(f"data must be 4-D (nsub,npol,nchan,nbin), "
                             f"got {self.data.shape}")
        if self.weights.shape != (self.data.shape[0], self.data.shape[2]):
            raise ValueError(f"weights shape {self.weights.shape} does not "
                             f"match data {self.data.shape}")
        if self.freqs_mhz.shape != (self.data.shape[2],):
            raise ValueError("freqs_mhz must have one entry per channel")
        if self.pol_state not in POL_STATES:
            raise ValueError(f"pol_state must be one of {POL_STATES}")

    @property
    def nsub(self) -> int:
        return self.data.shape[0]

    @property
    def npol(self) -> int:
        return self.data.shape[1]

    @property
    def nchan(self) -> int:
        return self.data.shape[2]

    @property
    def nbin(self) -> int:
        return self.data.shape[3]

    @property
    def mjd_mid(self) -> float:
        return 0.5 * (self.mjd_start + self.mjd_end)

    def total_intensity(self) -> np.ndarray:
        """The (nsub, nchan, nbin) total-intensity cube, without mutating."""
        if self.pol_state == "Coherence" and self.npol > 1:
            return self.data[:, 0] + self.data[:, 1]
        return self.data[:, 0]

    def display_name(self) -> str:
        """Base name used in output naming and the clean log."""
        return os.path.basename(self.filename) if self.filename \
            else self.source
