"""DSP primitives of the default route, in torch: dispersion shifts,
per-channel rotation of (nchan, nbin) rows, the integration-baseline
preamble, and the template stage's algebra.

Each function mirrors the reference package's float32 route op for op
(``iterative_cleaner_tpu/ops/dsp.py``): the fourier rotation of rows is
the rFFT -> phase ramp -> irFFT decomposition as three small matmuls
against cos/sin tables; the roll rotation is an exact gather.  Matmuls
run in full float32 (TF32 is switched off by
:func:`iterative_cleaner_torch.backends.torch_backend.clean_cube`).
"""

from __future__ import annotations

import math

import torch

from iterative_cleaner_torch.archive import KDM_S


def dispersion_shift_bins(freqs_mhz, dm, ref_freq_mhz, period_s, nbin):
    """Per-channel dispersion shift in fractional pulse bins (positive
    below the reference frequency: dispersed data is rotated right by
    this much).  Tensors in, tensor out, at ``freqs_mhz``'s dtype."""
    delay_s = KDM_S * dm * (freqs_mhz ** -2.0 - ref_freq_mhz ** -2.0)
    return delay_s / period_s * nbin


def _rfft_tables(nbin: int, dtype, device):
    """(nbin, nbin//2+1) cos/sin tables of the row rotation, float32 as
    the reference builds them: angle = float32(2*pi/nbin) * b * k."""
    b = torch.arange(nbin, dtype=dtype, device=device)
    kf = torch.arange(nbin // 2 + 1, dtype=dtype, device=device)
    ang = (2.0 * math.pi / nbin) * torch.outer(b, kf)
    return torch.cos(ang), torch.sin(ang)


def rotate_bins(x, shift_bins, method="fourier"):
    """Circularly rotate (nchan, nbin) rows right by per-channel
    ``shift_bins``: ``out[c, i] == x[c, (i - s_c) % nbin]`` for integer
    shifts.

    ``fourier``: fractional rotation through an rFFT phase ramp (the
    Nyquist bin of a fractionally rotated row attenuates by cos(pi*s));
    ``roll``: nearest-integer gather, exact."""
    if x.ndim != 2:
        raise ValueError(f"rotate_bins takes (nchan, nbin) rows, got "
                         f"{tuple(x.shape)}")
    nchan, nbin = x.shape
    if method == "roll":
        base = torch.arange(nbin, device=x.device)
        s = torch.round(shift_bins).to(torch.int64)
        idx = torch.remainder(base[None, :] - s[:, None], nbin)
        return torch.gather(x, 1, idx)
    if method != "fourier":
        raise ValueError(f"unknown rotation method {method!r}")
    dtype = x.dtype
    cos_bk, sin_bk = _rfft_tables(nbin, dtype, x.device)
    k = torch.arange(nbin // 2 + 1, device=x.device)
    kf = k.to(dtype)
    # irfft reconstruction weights: DC and (even-n) Nyquist count once
    w = torch.where((k == 0) | ((k == nbin // 2) & (nbin % 2 == 0)),
                    1.0, 2.0).to(torch.float64)
    s_chan = torch.broadcast_to(shift_bins.to(dtype), (nchan,))
    xr = x @ cos_bk
    xi = -(x @ sin_bk)
    theta = (2.0 * math.pi / nbin) * torch.outer(s_chan, kf)
    pr = torch.cos(theta)
    pi_ = -torch.sin(theta)
    xr_p = xr * pr - xi * pi_
    xi_p = xr * pi_ + xi * pr
    wk = (w / nbin).to(dtype)[None, :]
    return (xr_p * wk) @ cos_bk.T - (xi_p * wk) @ sin_bk.T


def circular_window_sums(profiles, w: int, centred=False):
    """Sliding circular window sums along the last axis, as one 0/1
    circulant matmul (the reference's float32 form).  ``centred=False``:
    the window at ``c`` covers ``[c, c+w)``; ``centred=True``:
    ``[c - w//2, c - w//2 + w)``."""
    nbin = profiles.shape[-1]
    shift = (w // 2) if centred else 0
    j = torch.arange(nbin, device=profiles.device)
    box = (torch.remainder(j[:, None] - j[None, :] + shift, nbin) < w).to(
        profiles.dtype)
    return profiles @ box


def prepare_cube_integration(cube, weights, freqs_mhz, dm, ref_freq_mhz,
                             period_s, *, baseline_duty):
    """Integration-baseline preamble of the dispersed-frame route.

    Returns ``(disp_clean, back_shifts, base_offsets)``.  ``disp_clean``
    is ``cube - offsets`` in the archive's own (dispersed) frame, computed
    IN PLACE in ``cube``: the caller uploads the cube for this purpose and
    it is the one resident cube of the whole clean.  The reference's
    preamble also rotates the cube into the dedispersed frame, which its
    compiler then eliminates as dead code under this route; the port never
    computes that rotation at all.
    """
    from iterative_cleaner_torch.ops.psrchive_baseline import (
        baseline_offsets_integration,
    )

    nbin = cube.shape[-1]
    shifts = dispersion_shift_bins(freqs_mhz.to(cube.dtype), dm,
                                   ref_freq_mhz, period_s, nbin)
    offsets = baseline_offsets_integration(cube, weights.to(cube.dtype),
                                           baseline_duty)
    cube.sub_(offsets[..., None])
    return cube, shifts, offsets


def weighted_marginal_totals(disp, weights):
    """Both weighted marginals of the dispersed cube:
    ``A[c, b] = sum_s w[s, c] * disp[s, c, b]`` and
    ``t1[s, b] = sum_c w[s, c] * disp[s, c, b]``.

    The plain version of kernel K1
    (:func:`iterative_cleaner_torch.stats.kernels.weighted_marginals`):
    products first, then the two sums, as the TPU kernel forms them."""
    wx = disp * weights[:, :, None]
    return wx.sum(dim=0), wx.sum(dim=1)


def template_numerator_from_channel_profiles(a, back_shifts, rotation):
    """Template numerator ``sum_c rot_c^{-1}(A[c])``: the dedispersion
    rotation applied to the (nchan, nbin) channel profiles instead of
    the cube (rotation is linear, weighting bin-independent)."""
    return rotate_bins(a, -back_shifts, method=rotation).sum(dim=0)


def fit_template_amplitudes_disp(disp, rot_t, template):
    """Closed-form template amplitudes in the dispersed frame:
    ``amp = <disp, rot_t_c> / <t, t>``; an all-zero template gives 1.0
    (the reference fit's initial guess)."""
    tt = torch.sum(template * template)
    tp = torch.einsum("scb,cb->sc", disp, rot_t)
    safe_tt = torch.where(tt == 0, torch.ones_like(tt), tt)
    return torch.where(tt == 0, torch.ones_like(tp), tp / safe_tt)
