"""DSP primitives in torch: dispersion shifts, per-channel rotation of
(nchan, nbin) rows and of (nsub, nchan, nbin) cubes, the two baseline
preambles, the DEDISP=1 skip rule, and the template stage's algebra.

Each function mirrors the reference package's float32 route op for op
(``iterative_cleaner_tpu/ops/dsp.py``).  Rotations:

- fourier rows: the rFFT -> phase ramp -> irFFT decomposition as three
  small matmuls against cos/sin tables;
- fourier cubes: the per-channel (nbin, nbin) rotation operator applied
  as a batched matmul while the (nchan, nbin, nbin) operator tensor stays
  under the reference's ``_ROT_MATMUL_MAX_ELEMS``; above it,
  ``torch.fft.rfft``/``irfft``;
- roll: an exact gather (the reference's one-hot matmul selects the same
  elements).

Cubes are rotated in channel chunks, so the temporaries stay a bounded
slice of the cube.  These are plain products that the reference computes
outside any Pallas kernel.  Matmuls run in full float32 (TF32 is switched
off by :func:`iterative_cleaner_torch.backends.torch_backend.clean_cube`).
"""

from __future__ import annotations

import math

import torch

from iterative_cleaner_torch.archive import KDM_S

# The reference's gate for the matmul rotation of cubes: the
# (nchan, nbin, nbin) operator tensor, in elements (512 MB of float32).
_ROT_MATMUL_MAX_ELEMS = 2 ** 27
# Elements of the cube one channel chunk of a cube rotation covers
# (256 MB of float32): bounds each chunk's permuted copies.
_ROTATE_CHUNK_ELEMS = 2 ** 26


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


def _irfft_weights(nbin: int, device):
    """irfft reconstruction weights over k, float64 as the reference
    forms them: DC and (even-n) Nyquist count once, the rest twice."""
    k = torch.arange(nbin // 2 + 1, device=device)
    return torch.where((k == 0) | ((k == nbin // 2) & (nbin % 2 == 0)),
                       1.0, 2.0).to(torch.float64)


def _use_matmul_rotation(nchan: int, nbin: int, ndim: int, dtype) -> bool:
    """The reference's ``_use_matmul_rotation`` for the fourier method:
    float32 only, and the operator (rows: the two tables) within
    ``_ROT_MATMUL_MAX_ELEMS``."""
    if dtype != torch.float32:
        return False
    nk = nbin // 2 + 1
    if ndim == 2:
        elems = 2 * nbin * nk
    else:
        elems = max(nchan * nbin * nbin, nk * nbin * nbin)
    return elems <= _ROT_MATMUL_MAX_ELEMS


def _rotate_fft(x, s_chan):
    """Fourier rotation through ``torch.fft`` (the reference's path above
    the matmul gate): ``irfft(rfft(x) * exp(-2j*pi*k*s/nbin))``."""
    nbin = x.shape[-1]
    k = torch.arange(nbin // 2 + 1, device=x.device)
    phase = torch.exp((-2j * math.pi) * k * s_chan[:, None] / nbin)
    spec = torch.fft.rfft(x, dim=-1)
    return torch.fft.irfft(spec * phase, n=nbin, dim=-1).to(x.dtype)


def _rotate_rows(x, s_chan):
    """(nchan, nbin) rows, each rotated by its own fourier shift."""
    nchan, nbin = x.shape
    if not _use_matmul_rotation(nchan, nbin, 2, x.dtype):
        return _rotate_fft(x, s_chan)
    dtype = x.dtype
    cos_bk, sin_bk = _rfft_tables(nbin, dtype, x.device)
    kf = torch.arange(nbin // 2 + 1, device=x.device).to(dtype)
    xr = x @ cos_bk
    xi = -(x @ sin_bk)
    theta = (2.0 * math.pi / nbin) * torch.outer(s_chan, kf)
    pr = torch.cos(theta)
    pi_ = -torch.sin(theta)
    xr_p = xr * pr - xi * pi_
    xi_p = xr * pi_ + xi * pr
    wk = (_irfft_weights(nbin, x.device) / nbin).to(dtype)[None, :]
    return (xr_p * wk) @ cos_bk.T - (xi_p * wk) @ sin_bk.T


def rotation_operators(s_chan, nbin: int):
    """(nchan, nbin, nbin) per-channel fourier rotation matrices,
    ``R_c[b, i] = (1/n) sum_k w_k cos(2*pi*k*(i - b - s_c)/n)``, built as
    the reference builds them: two products of (k, b, i) cos/sin tables
    with the per-channel phases."""
    dtype, dev = s_chan.dtype, s_chan.device
    nk = nbin // 2 + 1
    kf = torch.arange(nk, device=dev).to(dtype)
    b = torch.arange(nbin, dtype=dtype, device=dev)
    alpha = (2.0 * math.pi / nbin) * kf[:, None, None] * (
        b[None, None, :] - b[None, :, None])       # (k, b, i): i - b
    wk = (_irfft_weights(nbin, dev) / nbin).to(dtype)[:, None, None]
    cos_tab = (wk * torch.cos(alpha)).reshape(nk, nbin * nbin)
    sin_tab = (wk * torch.sin(alpha)).reshape(nk, nbin * nbin)
    theta = (2.0 * math.pi / nbin) * torch.outer(s_chan, kf)
    rot = torch.cos(theta) @ cos_tab + torch.sin(theta) @ sin_tab
    return rot.reshape(-1, nbin, nbin)


def rotate_bins(x, shift_bins, method="fourier"):
    """Circularly rotate profiles right by per-channel ``shift_bins``
    along the last axis: ``out[..., c, i] == x[..., c, (i - s_c) % nbin]``
    for integer shifts.  ``x`` is (nchan, nbin) rows or a (..., nchan,
    nbin) cube; the result is a new tensor.

    ``fourier``: fractional rotation through an rFFT phase ramp (the
    Nyquist bin of a fractionally rotated profile attenuates by
    cos(pi*s)); ``roll``: nearest-integer gather, exact."""
    if method not in ("fourier", "roll"):
        raise ValueError(f"unknown rotation method {method!r}")
    if x.ndim < 2:
        raise ValueError(f"rotate_bins takes (..., nchan, nbin) profiles, "
                         f"got {tuple(x.shape)}")
    nchan, nbin = x.shape[-2:]
    s_chan = torch.broadcast_to(shift_bins.to(x.dtype), (nchan,))
    if method == "roll":
        base = torch.arange(nbin, device=x.device)
        s = torch.round(s_chan).to(torch.int64)
        idx = torch.remainder(base[None, :] - s[:, None], nbin)
        return torch.gather(x, -1, idx.expand(x.shape))
    if x.ndim == 2:
        return _rotate_rows(x, s_chan)
    matmul = _use_matmul_rotation(nchan, nbin, 3, x.dtype)
    flat = x.reshape(-1, nchan, nbin)
    out = torch.empty_like(flat)
    step = max(1, _ROTATE_CHUNK_ELEMS // max(1, flat.shape[0] * nbin))
    for c0 in range(0, nchan, step):
        sl = slice(c0, c0 + step)
        out[:, sl] = (torch.einsum("ncb,cbi->nci", flat[:, sl],
                                   rotation_operators(s_chan[sl], nbin))
                      if matmul else _rotate_fft(flat[:, sl], s_chan[sl]))
    return out.reshape(x.shape)


def circular_window_sums(profiles, w: int, centred=False):
    """Sliding circular window sums along the last axis.  ``centred=
    False``: the window at ``c`` covers ``[c, c+w)``; ``centred=True``:
    ``[c - w//2, c - w//2 + w)``.  float32 with nbin <= 1024: one 0/1
    circulant matmul (the reference's float32 form); otherwise the
    reference's cumulative-sum form."""
    nbin = profiles.shape[-1]
    shift = (w // 2) if centred else 0
    if nbin <= 1024 and profiles.dtype == torch.float32:
        j = torch.arange(nbin, device=profiles.device)
        box = (torch.remainder(j[:, None] - j[None, :] + shift, nbin)
               < w).to(profiles.dtype)
        return profiles @ box
    ext = torch.cat([profiles, profiles[..., : w - 1]], dim=-1) \
        if w > 1 else profiles
    cs = torch.cumsum(ext, dim=-1)
    cz = torch.cat([torch.zeros_like(cs[..., :1]), cs], dim=-1)
    sums = cz[..., w: w + nbin] - cz[..., :nbin]
    return torch.roll(sums, shift, dims=-1) if shift else sums


def baseline_offsets(profiles, duty=0.15):
    """Per-profile baseline level of ``baseline_mode='profile'``: the
    mean of the ``round(duty * nbin)``-bin circular window with the
    smallest mean."""
    from iterative_cleaner_torch.ops.psrchive_baseline import window_width

    w = window_width(profiles.shape[-1], duty)
    return torch.min(circular_window_sums(profiles, w), dim=-1).values / w


def remove_baseline(profiles, duty=0.15):
    """Subtract each profile's :func:`baseline_offsets` level, IN PLACE
    (the callers hand over a freshly uploaded cube); returns it."""
    return profiles.sub_(baseline_offsets(profiles, duty)[..., None])


def prepare_cube_integration(cube, weights, freqs_mhz, dm, ref_freq_mhz,
                             period_s, *, baseline_duty, rotation,
                             dedispersed=False, with_ded=True, mesh=None):
    """Integration-baseline preamble.

    Returns ``(ded, back_shifts, disp_clean, base_offsets)``.
    ``disp_clean`` is ``cube - offsets`` in the archive's own frame,
    computed IN PLACE in ``cube`` (the caller uploads the cube for this
    purpose).  ``ded`` is its rotation into the dedispersed frame — a new
    cube — or ``disp_clean`` itself for a DEDISP=1 input (the state-aware
    dedispersion no-ops; the back-shifts stay unchanged).  ``with_ded=
    False`` skips the rotation (``ded`` is None): the default route never
    reads it.  On a cell ``mesh`` the arguments are a rank's shard and its
    channels' frequencies; only the baseline window's total profile
    crosses ranks."""
    from iterative_cleaner_torch.ops.psrchive_baseline import (
        baseline_offsets_integration,
    )

    nbin = cube.shape[-1]
    shifts = dispersion_shift_bins(freqs_mhz.to(cube.dtype), dm,
                                   ref_freq_mhz, period_s, nbin)
    offsets = baseline_offsets_integration(cube, weights.to(cube.dtype),
                                           baseline_duty, mesh)
    disp_clean = cube.sub_(offsets[..., None])
    ded = None
    if with_ded:
        ded = disp_clean if dedispersed else rotate_bins(
            disp_clean, -shifts, method=rotation)
    return ded, shifts, disp_clean, offsets


def prepare_cube_with_correction(cube, weights, freqs_mhz, dm, ref_freq_mhz,
                                 period_s, *, baseline_duty, rotation,
                                 dedispersed=False, baseline_mode="profile",
                                 mesh=None):
    """Cleaning preamble: baseline removal (in place in ``cube``), then
    the forward dedispersion, skipped for a DEDISP=1 input (the
    back-shifts stay unchanged).  Returns ``(ded_cube, back_shifts,
    baseline_corr)``, where ``baseline_corr`` is the ``(disp_clean,
    base_offsets, duty)`` triple of the integration mode's per-iteration
    template correction and None under the profile mode.  ``mesh``: as
    :func:`prepare_cube_integration` (the profile baseline is
    cell-local)."""
    if baseline_mode == "integration":
        ded, shifts, disp_clean, offsets = prepare_cube_integration(
            cube, weights, freqs_mhz, dm, ref_freq_mhz, period_s,
            baseline_duty=baseline_duty, rotation=rotation,
            dedispersed=dedispersed, mesh=mesh)
        return ded, shifts, (disp_clean, offsets, baseline_duty)
    if baseline_mode != "profile":
        raise ValueError(f"unknown baseline mode {baseline_mode!r}")
    shifts = dispersion_shift_bins(freqs_mhz.to(cube.dtype), dm,
                                   ref_freq_mhz, period_s, cube.shape[-1])
    ded = remove_baseline(cube, baseline_duty)
    if not dedispersed:
        ded = rotate_bins(ded, -shifts, method=rotation)
    return ded, shifts, None


def weighted_marginal_totals(disp, weights):
    """Both weighted marginals of the dispersed cube:
    ``A[c, b] = sum_s w[s, c] * disp[s, c, b]`` and
    ``t1[s, b] = sum_c w[s, c] * disp[s, c, b]``.

    The plain version of kernel K1
    (:func:`iterative_cleaner_torch.stats.kernels.weighted_marginals`):
    products first, then the two sums, as the TPU kernel forms them."""
    wx = disp * weights[:, :, None]
    return wx.sum(dim=0), wx.sum(dim=1)


def template_numerator_from_channel_profiles(a, back_shifts, rotation,
                                             mesh=None):
    """Template numerator ``sum_c rot_c^{-1}(A[c])``: the dedispersion
    rotation applied to the (nchan, nbin) channel profiles instead of
    the cube (rotation is linear, weighting bin-independent).  On a cell
    ``mesh``, ``a`` holds the rank's channels and the sum crosses its
    row."""
    num = rotate_bins(a, -back_shifts, method=rotation).sum(dim=0)
    return num if mesh is None else mesh.total(num, "chan")


def weighted_template_numerator(cube, weights):
    """The un-normalised weighted profile sum over all (subint, channel)
    cells, grouped as the reference groups it: per-subint (1, C) x (C, B)
    products, then the sum over subints.  Exact streaming accumulates it
    per subint tile on the routes other than the default."""
    return torch.einsum("sc,scb->sb", weights, cube).sum(dim=0)


def weighted_template(cube, weights, mesh=None):
    """Weighted mean profile over all (subint, channel) cells; an
    all-zero weight matrix gives the zero template.  On a cell ``mesh``
    both sums run over every rank's shard."""
    num = weighted_template_numerator(cube, weights)
    den = torch.sum(weights)
    if mesh is not None:
        num, den = mesh.total(num, "all"), mesh.total(den, "all")
    safe = torch.where(den == 0, torch.ones_like(den), den)
    return torch.where(den == 0, torch.zeros_like(num), num / safe)


def fit_template_amplitudes(cube, template):
    """Closed-form least-squares amplitude of ``template`` in every
    profile: ``<template, prof> / <template, template>``; an all-zero
    template gives 1.0 (the reference fit's initial guess)."""
    tt = torch.sum(template * template)
    tp = torch.einsum("scb,b->sc", cube, template)
    safe_tt = torch.where(tt == 0, torch.ones_like(tt), tt)
    return torch.where(tt == 0, torch.ones_like(tp), tp / safe_tt)


def fit_template_amplitudes_disp(disp, rot_t, template):
    """Closed-form template amplitudes in the dispersed frame:
    ``amp = <disp, rot_t_c> / <t, t>``; an all-zero template gives 1.0
    (the reference fit's initial guess)."""
    tt = torch.sum(template * template)
    tp = torch.einsum("scb,cb->sc", disp, rot_t)
    safe_tt = torch.where(tt == 0, torch.ones_like(tt), tt)
    return torch.where(tt == 0, torch.ones_like(tp), tp / safe_tt)


def template_residuals(cube, template, amps, pulse_slice, pulse_scale,
                       apply_pulse_region):
    """``amp * template - prof`` per cell (the reference's sign), with
    the bins ``[start, end)`` scaled by ``pulse_scale`` when the pulse
    region is active.  A new tensor."""
    resid = amps[..., None] * template - cube
    if apply_pulse_region:
        start, end = pulse_slice
        resid[..., start:end] *= pulse_scale
    return resid
