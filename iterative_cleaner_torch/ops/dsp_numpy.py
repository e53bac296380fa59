"""The DSP primitives of the float64 numpy oracle, in plain numpy.

The port's own copy of the numpy branches of the reference package's
``ops/dsp.py`` that its oracle calls (the reference writes each function
once over an ``xp`` handle; here ``xp`` is numpy and the handle is gone).
The port's torch engine has its own primitives in
:mod:`iterative_cleaner_torch.ops.dsp`.  Every operation is the
reference's numpy operation, in its order, so the oracle's floats are
bit-equal to the reference oracle's.

- dispersion: :func:`dispersion_shift_bins`, :func:`rotate_bins`
  (``fourier``: rFFT phase ramp; ``roll``: nearest-integer gather),
  :func:`dedisperse_cube`;
- baselines: :func:`circular_window_sums` (the cumulative-sum form),
  :func:`baseline_offsets`, :func:`remove_baseline`;
- the preambles: :func:`prepare_cube`, :func:`prepare_cube_integration`,
  :func:`prepare_cube_with_correction`;
- the template stage: :func:`weighted_template_numerator`,
  :func:`weighted_template`, :func:`fit_template_amplitudes`,
  :func:`template_residuals`.
"""

from __future__ import annotations

import numpy as np

from iterative_cleaner_torch.archive import KDM_S


def dispersion_shift_bins(freqs_mhz, dm, ref_freq_mhz, period_s, nbin):
    """Per-channel dispersion shift in fractional pulse bins (positive
    below the reference frequency: the dispersed data has the pulse
    rotated right by this many bins)."""
    delay_s = KDM_S * dm * (freqs_mhz ** -2.0 - ref_freq_mhz ** -2.0)
    return delay_s / period_s * nbin


def rotate_bins(x, shift_bins, method="fourier"):
    """Circularly rotate profiles right by ``shift_bins`` along the last
    axis (``np.roll`` semantics for integer shifts; ``shift_bins``
    broadcasts against the leading axes).  ``fourier``: rFFT phase ramp
    (a fractional shift attenuates the Nyquist bin by cos(pi*s));
    ``roll``: nearest-integer gather."""
    nbin = x.shape[-1]
    shift = np.asarray(shift_bins)[..., None]
    if method == "roll":
        base = np.arange(nbin)
        s_full = np.broadcast_to(np.round(shift).astype(base.dtype),
                                 x.shape[:-1] + (1,))
        idx = (base - s_full) % nbin  # out[..., i] = x[..., (i - s) % nbin]
        return np.take_along_axis(x, idx, axis=-1)
    if method != "fourier":
        raise ValueError(f"unknown rotation method {method!r}")
    k = np.arange(nbin // 2 + 1)
    spec = np.fft.rfft(x, axis=-1)
    phase = np.exp(-2j * np.pi * k * shift / nbin)
    return np.fft.irfft(spec * phase, n=nbin, axis=-1).astype(x.dtype)


def dedisperse_cube(cube, freqs_mhz, dm, ref_freq_mhz, period_s,
                    method="fourier", forward=True):
    """Remove (``forward``) or re-apply the per-channel dispersion delays
    of a (nsub, nchan, nbin) cube."""
    nbin = cube.shape[-1]
    shifts = dispersion_shift_bins(
        np.asarray(freqs_mhz, dtype=cube.dtype), dm, ref_freq_mhz, period_s,
        nbin)
    signed = -shifts if forward else shifts
    return rotate_bins(cube, signed, method=method)


def circular_window_sums(profiles, w, centred=False):
    """Sliding circular window sums along the last axis: the window at
    ``c`` covers ``[c, c+w)``, or ``[c - w//2, c - w//2 + w)`` with
    ``centred``; by cumulative sums."""
    nbin = profiles.shape[-1]
    shift = (w // 2) if centred else 0
    ext = np.concatenate([profiles, profiles[..., : w - 1]], axis=-1) \
        if w > 1 else profiles
    cs = np.cumsum(ext, axis=-1)
    zero = np.zeros_like(cs[..., :1])
    cz = np.concatenate([zero, cs], axis=-1)
    sums = cz[..., w: w + nbin] - cz[..., :nbin]
    return np.roll(sums, shift, axis=-1) if shift else sums


def baseline_offsets(profiles, duty=0.15):
    """Per-profile baseline level of ``baseline_mode='profile'``: the
    mean of the ``round(duty * nbin)``-bin circular window with the
    smallest mean."""
    nbin = profiles.shape[-1]
    w = max(1, int(round(duty * nbin)))
    return np.min(circular_window_sums(profiles, w), axis=-1) / w


def remove_baseline(profiles, duty=0.15):
    """Subtract each profile's :func:`baseline_offsets` level."""
    return profiles - baseline_offsets(profiles, duty=duty)[..., None]


def prepare_cube(cube, freqs_mhz, dm, ref_freq_mhz, period_s, *,
                 baseline_duty, rotation, dedispersed=False,
                 baseline_mode="profile", weights=None):
    """The cleaning preamble: baseline removal, then the forward
    dedispersion, skipped for a DEDISP=1 input (the back-shifts stay
    unchanged).  Returns ``(ded_cube, back_shifts)``."""
    if baseline_mode == "integration":
        ded, shifts, _, _ = prepare_cube_integration(
            cube, weights, freqs_mhz, dm, ref_freq_mhz, period_s,
            baseline_duty=baseline_duty, rotation=rotation,
            dedispersed=dedispersed)
        return ded, shifts
    if baseline_mode != "profile":
        raise ValueError(f"unknown baseline mode {baseline_mode!r}")
    nbin = cube.shape[-1]
    shifts = dispersion_shift_bins(
        np.asarray(freqs_mhz, dtype=cube.dtype), dm, ref_freq_mhz, period_s,
        nbin)
    ded = remove_baseline(cube, duty=baseline_duty)
    if not dedispersed:
        ded = rotate_bins(ded, -shifts, method=rotation)
    return ded, shifts


def prepare_cube_with_correction(cube, weights, freqs_mhz, dm, ref_freq_mhz,
                                 period_s, *, baseline_duty, rotation,
                                 dedispersed=False,
                                 baseline_mode="profile"):
    """The oracle's preamble dispatch: ``(ded_cube, back_shifts,
    baseline_corr)``, ``baseline_corr`` the ``(disp_clean, base_offsets,
    duty)`` triple of the integration mode's per-iteration template
    correction, None under the profile mode."""
    if baseline_mode == "integration":
        ded, shifts, disp_clean, offsets = prepare_cube_integration(
            cube, weights, freqs_mhz, dm, ref_freq_mhz, period_s,
            baseline_duty=baseline_duty, rotation=rotation,
            dedispersed=dedispersed)
        return ded, shifts, (disp_clean, offsets, baseline_duty)
    ded, shifts = prepare_cube(
        cube, freqs_mhz, dm, ref_freq_mhz, period_s,
        baseline_duty=baseline_duty, rotation=rotation,
        dedispersed=dedispersed, baseline_mode=baseline_mode)
    return ded, shifts, None


def prepare_cube_integration(cube, weights, freqs_mhz, dm, ref_freq_mhz,
                             period_s, *, baseline_duty, rotation,
                             dedispersed=False):
    """The integration-baseline preamble: ``(ded_cube, back_shifts,
    disp_clean, base_offsets)``, ``disp_clean = cube - offsets`` in the
    archive's own frame and ``base_offsets`` the (nsub, nchan) consensus
    levels under ``weights``."""
    from iterative_cleaner_torch.ops.psrchive_baseline_numpy import (
        baseline_offsets_integration,
    )

    nbin = cube.shape[-1]
    shifts = dispersion_shift_bins(
        np.asarray(freqs_mhz, dtype=cube.dtype), dm, ref_freq_mhz, period_s,
        nbin)
    offsets, _ = baseline_offsets_integration(
        cube, np.asarray(weights, dtype=cube.dtype), baseline_duty)
    disp_clean = cube - offsets[..., None]
    ded = disp_clean
    if not dedispersed:
        ded = rotate_bins(ded, -shifts, method=rotation)
    return ded, shifts, disp_clean, offsets


def weighted_template_numerator(cube, weights):
    """The un-normalised weighted profile sum over all (subint, channel)
    cells (exact streaming accumulates it per subint tile)."""
    return np.einsum("sc,scb->b", weights, cube)


def weighted_template(cube, weights):
    """Weighted mean profile over all (subint, channel) cells; an
    all-zero weight matrix gives the zero template."""
    num = weighted_template_numerator(cube, weights)
    den = np.sum(weights)
    safe = np.where(den == 0, np.ones_like(den), den)
    return np.where(den == 0, np.zeros_like(num), num / safe)


def fit_template_amplitudes(cube, template):
    """Closed-form least-squares amplitude of ``template`` in every
    profile, ``<template, prof> / <template, template>``; an all-zero
    template gives 1.0 (the reference fit's initial guess)."""
    tt = np.sum(template * template)
    tp = np.einsum("scb,b->sc", cube, template)
    safe_tt = np.where(tt == 0, np.ones_like(tt), tt)
    return np.where(tt == 0, np.ones_like(tp), tp / safe_tt)


def template_residuals(cube, template, amps, pulse_slice, pulse_scale,
                       apply_pulse_region):
    """``amp * template - prof`` per cell (the reference's sign), the
    bins ``[start, end)`` scaled by ``pulse_scale`` when the pulse region
    is active."""
    resid = amps[..., None] * template - cube
    if apply_pulse_region:
        start, end = pulse_slice
        window = resid[..., start:end] * pulse_scale
        resid = resid.copy()
        resid[..., start:end] = window
    return resid
