"""Synthetic archive generator with ground-truth RFI masks (numpy only).

A dispersed pulse of known shape plus injected RFI of the three
morphologies the detector targets (impulsive per-cell, narrowband
per-channel, broadband per-subint).  The port's own copy of the
reference generator: the same seed gives byte-identical arrays, which is
what lets ``chip_smoke.py`` rebuild the full-size golden archive without
the reference package.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from iterative_cleaner_torch.archive import KDM_S, Archive


@dataclasses.dataclass
class SyntheticTruth:
    """Ground truth accompanying a synthetic archive."""

    rfi_cells: np.ndarray      # (n, 2) injected impulsive (isub, ichan) pairs
    rfi_channels: np.ndarray   # (k,) channels with persistent narrowband RFI
    rfi_subints: np.ndarray    # (j,) subints with broadband RFI
    pulse_phase: float         # pulse centre as phase [0, 1)
    prezapped: np.ndarray      # (nsub, nchan) bool: weight 0 on input

    def expected_zap(self, nsub: int, nchan: int) -> np.ndarray:
        mask = np.zeros((nsub, nchan), dtype=bool)
        if len(self.rfi_cells):
            mask[self.rfi_cells[:, 0], self.rfi_cells[:, 1]] = True
        mask[:, self.rfi_channels] = True
        mask[self.rfi_subints, :] = True
        mask |= self.prezapped
        return mask


def bench_rfi_density(nsub: int, nchan: int) -> dict:
    """The benchmark RFI-density rules (~0.05% impulsive cells, one bad
    channel per 512, one bad subint per 512) the full-size golden was
    generated with."""
    return dict(n_rfi_cells=max(8, nsub * nchan // 2048),
                n_rfi_channels=max(1, nchan // 512),
                n_rfi_subints=max(1, nsub // 512))


# (nsub, nchan, nbin) of the full-size golden (tests/goldens/fullsize_mask.npz)
FULLSIZE_SHAPE = (1024, 4096, 128)


def make_fullsize_archive():
    """The full-size golden's archive: :data:`FULLSIZE_SHAPE`, seed 0,
    :func:`bench_rfi_density` RFI, dispersed, float64."""
    nsub, nchan, nbin = FULLSIZE_SHAPE
    ar, _ = make_synthetic_archive(nsub=nsub, nchan=nchan, nbin=nbin,
                                   **bench_rfi_density(nsub, nchan), seed=0,
                                   dtype=np.float64, disperse=True)
    return ar


def _disperse_cube(cube, freqs_mhz, dm, ref_freq_mhz, period_s):
    """Re-apply the per-channel dispersion delays with the fourier
    (rFFT phase-ramp) rotation, in numpy at the cube's dtype — the
    reference's ``dedisperse_cube(..., np, forward=False)``, op for op."""
    nbin = cube.shape[-1]
    freqs = np.asarray(freqs_mhz, dtype=cube.dtype)
    delay_s = KDM_S * dm * (freqs ** -2.0 - ref_freq_mhz ** -2.0)
    shift = np.asarray(delay_s / period_s * nbin)[..., None]
    k = np.arange(nbin // 2 + 1)
    spec = np.fft.rfft(cube, axis=-1)
    phase = np.exp(-2j * np.pi * k * shift / nbin)
    return np.fft.irfft(spec * phase, n=nbin, axis=-1).astype(cube.dtype)


def _dispersion_phase(freqs_mhz, dm, ref_freq_mhz, period_s, nbin, device):
    """:func:`_disperse_cube`'s phase ramp, (nchan, nbin/2 + 1), in torch
    complex128 on ``device``."""
    import torch

    freqs = np.asarray(freqs_mhz, dtype=np.float64)
    delay_s = KDM_S * dm * (freqs ** -2.0 - ref_freq_mhz ** -2.0)
    shift = torch.from_numpy(delay_s / period_s * nbin).to(device)
    k = torch.arange(nbin // 2 + 1, dtype=torch.float64, device=device)
    return torch.exp(-2j * np.pi * k[None, :] * shift[:, None] / nbin)


def _disperse_rows_torch(x, phase):
    """:func:`_disperse_cube`'s rotation of the (..., nchan, nbin) float64
    tensor ``x`` (the same formula in torch; another FFT's rounding)."""
    import torch

    spec = torch.fft.rfft(x, dim=-1) * phase
    return torch.fft.irfft(spec, n=x.shape[-1], dim=-1)


def _noisy_cube_torch(clean_row, nsub, noise_sigma, baseline_level, seed,
                      phase, device):
    """The clean pulse (one subint's (nchan, nbin) rows) plus Gaussian
    noise drawn on ``device`` (a torch generator seeded with ``seed``:
    another stream than numpy's) plus the baseline, each subint
    dispersed there with ``phase`` (None: not dispersed), as a float64
    numpy cube: a long profile's cube in seconds where numpy takes
    minutes (a prime length's FFT)."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    clean = torch.from_numpy(np.ascontiguousarray(clean_row,
                                                  dtype=np.float64)).to(device)
    out = np.empty((nsub,) + clean.shape, dtype=np.float64)
    for s in range(nsub):
        x = clean + noise_sigma * torch.randn(
            clean.shape, generator=g, dtype=torch.float64, device=device)
        x = x + baseline_level
        if phase is not None:
            x = _disperse_rows_torch(x, phase)
        out[s] = x.cpu().numpy()
    return out


def make_synthetic_archive(
    nsub: int = 16,
    nchan: int = 32,
    nbin: int = 128,
    npol: int = 1,
    n_rfi_cells: int = 6,
    n_rfi_channels: int = 1,
    n_rfi_subints: int = 1,
    n_prezapped: int = 0,
    rfi_strength: float = 40.0,
    pulse_snr: float = 30.0,
    noise_sigma: float = 1.0,
    dm: float = 26.76,
    period_s: float = 0.714,
    centre_freq_mhz: float = 1400.0,
    bandwidth_mhz: float = 200.0,
    baseline_level: float = 100.0,
    seed: int = 0,
    dtype=np.float64,
    disperse: bool = True,
    device=None,
):
    """Build a dispersed, noisy archive with injected RFI.

    Returns ``(Archive, SyntheticTruth)``.  The pulse is a Gaussian in
    phase with a smooth per-channel spectral index; the cube is dispersed
    with the archive's DM so dedispersion has real work to do
    (``disperse=False`` skips that rotation).  ``device`` (a torch
    device) draws the noise and runs the dispersion there
    (:func:`_noisy_cube_torch`: another random stream than numpy's, the
    same pulse, baseline, RFI rules and fields).
    """
    rng = np.random.default_rng(seed)
    freqs = centre_freq_mhz + bandwidth_mhz * (np.arange(nchan) / nchan - 0.5)

    phase = (np.arange(nbin) + 0.5) / nbin
    pulse_phase = 0.3
    width = 0.02
    profile = np.exp(-0.5 * ((phase - pulse_phase) / width) ** 2)

    spectrum = (freqs / centre_freq_mhz) ** -1.4
    amp = pulse_snr * noise_sigma
    clean = amp * spectrum[None, :, None] * profile[None, None, :]
    if device is not None:
        phase_ramp = _dispersion_phase(freqs, dm, centre_freq_mhz, period_s,
                                       nbin, device) if disperse else None
        cube = _noisy_cube_torch(clean[0].astype(dtype), nsub, noise_sigma,
                                 baseline_level, seed, phase_ramp, device)
    else:
        clean = np.broadcast_to(clean,
                                (nsub, nchan, nbin)).astype(dtype).copy()
        noise = rng.normal(0.0, noise_sigma, size=(nsub, nchan, nbin))
        cube = clean + noise + baseline_level
        if disperse:
            cube = _disperse_cube(cube, freqs, dm, centre_freq_mhz, period_s)

    # --- inject RFI (after dispersion: RFI is not dispersed) ---
    if nsub * nchan > 65536:
        # vectorised draw for big grids; small grids keep the per-cell
        # shuffle so seeded fixtures stay stable
        flat = rng.choice(nsub * nchan, size=n_rfi_cells, replace=False)
        all_cells = list(zip(*np.unravel_index(flat, (nsub, nchan))))
    else:
        all_cells = [(s, c) for s in range(nsub) for c in range(nchan)]
        rng.shuffle(all_cells)
    rfi_cells = []
    for s, c in all_cells:
        if len(rfi_cells) >= n_rfi_cells:
            break
        rfi_cells.append((int(s), int(c)))
        kind = rng.integers(3)
        if kind == 0:  # impulsive spike in a few bins
            bins = rng.integers(0, nbin, size=max(1, nbin // 16))
            cube[s, c, bins] += rfi_strength * noise_sigma
        elif kind == 1:  # broadband noise burst
            cube[s, c, :] += rng.normal(
                0.0, rfi_strength * noise_sigma / 4.0, nbin
            )
        else:  # strong sinusoid (caught by the rFFT diagnostic)
            cube[s, c, :] += (
                rfi_strength * noise_sigma * np.sin(2 * np.pi * 5 * phase)
            )
    rfi_cells = np.array(rfi_cells, dtype=np.int64).reshape(-1, 2)

    taken_ch = set(rfi_cells[:, 1]) if len(rfi_cells) else set()
    free_ch = [c for c in range(nchan) if c not in taken_ch]
    n_ch = min(n_rfi_channels, len(free_ch))
    rfi_channels = np.array(
        sorted(rng.choice(free_ch, size=n_ch, replace=False)) if n_ch else [],
        dtype=np.int64)
    for c in rfi_channels:
        # persistent narrowband RFI: an elevated noise floor riding a DC jump
        cube[:, c, :] += (
            rfi_strength * noise_sigma * rng.normal(1.0, 0.2, (nsub, 1))
            + rng.normal(0.0, rfi_strength * noise_sigma / 4.0, (nsub, nbin))
        )

    taken_sub = set(rfi_cells[:, 0]) if len(rfi_cells) else set()
    free_sub = [s for s in range(nsub) if s not in taken_sub]
    n_sub = min(n_rfi_subints, len(free_sub))
    rfi_subints = np.array(
        sorted(rng.choice(free_sub, size=n_sub, replace=False)) if n_sub else [],
        dtype=np.int64)
    for s in rfi_subints:
        cube[s, :, :] += rfi_strength * noise_sigma * np.abs(
            np.sin(2 * np.pi * 11 * phase)
        )

    weights = np.ones((nsub, nchan), dtype=dtype)
    prezapped = np.zeros((nsub, nchan), dtype=bool)
    if n_prezapped:
        flat = rng.choice(nsub * nchan, size=n_prezapped, replace=False)
        prezapped[np.unravel_index(flat, (nsub, nchan))] = True
        weights[prezapped] = 0.0

    data = cube[:, None, :, :]
    if npol > 1:
        extra = rng.normal(0.0, noise_sigma, size=(nsub, npol - 1, nchan, nbin))
        data = np.concatenate([data, extra + baseline_level], axis=1)

    ar = Archive(
        data=data.astype(dtype),
        weights=weights,
        freqs_mhz=freqs.astype(dtype),
        period_s=period_s,
        dm=dm,
        centre_freq_mhz=centre_freq_mhz,
        source=f"FAKE{seed:04d}+{nchan:02d}",
        pol_state="Intensity" if npol == 1 else "Stokes",
        filename="",
    )
    truth = SyntheticTruth(
        rfi_cells=rfi_cells,
        rfi_channels=rfi_channels,
        rfi_subints=rfi_subints,
        pulse_phase=pulse_phase,
        prezapped=prezapped,
    )
    return ar, truth


def make_bf16_exact_archive(nsub: int = 8, nchan: int = 16, nbin: int = 32,
                            seed: int = 0):
    """An archive whose whole clean is lossless in bf16 storage (the
    reference's ``tests/test_mixed_precision.py`` construction): samples
    on the bf16 grid, DM 0 (zero shifts), the last quarter of every
    profile exactly zero (with non-negative samples the baseline window
    lands there, so the subtracted baseline is exactly 0), RFI spikes in
    the first half.  With ``rotation='roll'`` its bf16 masks equal its
    float32 masks.  The metadata are :func:`make_synthetic_archive`'s
    (float32, DM 0, undispersed), its cube not drawn."""
    import torch

    freqs = 1400.0 + 200.0 * (np.arange(nchan) / nchan - 0.5)
    rng = np.random.default_rng(seed)
    phase = (np.arange(nbin) + 0.5) / nbin
    profile = np.exp(-0.5 * ((phase - 0.3) / 0.05) ** 2)
    spectrum = 1.0 + 0.5 * np.arange(nchan) / nchan
    gain = 1.0 + 0.3 * np.arange(nsub) / max(1, nsub)
    cube = (30.0 * gain[:, None, None] * spectrum[None, :, None]
            * profile[None, None, :]).astype(np.float32)
    cube[:, :, 3 * nbin // 4:] = 0.0
    cells = rng.choice(nsub * nchan, size=max(4, nsub * nchan // 24),
                       replace=False)
    for s, c in zip(*np.unravel_index(cells, (nsub, nchan))):
        bins = rng.integers(0, nbin // 2, size=max(1, nbin // 16))
        cube[s, c, bins] += 40.0
    data = torch.from_numpy(cube).to(torch.bfloat16).float().numpy()
    return Archive(
        data=data[:, None], weights=np.ones((nsub, nchan), np.float32),
        freqs_mhz=freqs.astype(np.float32), period_s=0.714, dm=0.0,
        centre_freq_mhz=1400.0, source=f"FAKE{seed:04d}+{nchan:02d}",
        pol_state="Intensity", filename="")
