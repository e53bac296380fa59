"""Detection statistics over (value, mask) pairs, in torch.

The same observable semantics as the reference's ``numpy.ma`` layer,
with its behaviour made explicit (rules pinned by the reference package's
``stats/masked_jax.py`` and its parity tests):

1. Binary ops leave masked entries' ``.data`` untouched (pass-through);
   unary ``abs`` computes on all data.
2. A zero-MAD or empty line masks the whole line, leaving the centred
   numerator as ``.data`` (undivided).
3. The final ``/threshold`` does not touch masked entries' data.
4. Fully-masked reductions leave ``.data`` 0 for std/mean and the
   ``np.ma`` float fill 1e20 for ptp.
5. The rFFT diagnostic drops masks entirely: it is scaled on the *plain*
   path where zero MAD produces IEEE inf/nan.
6. The ``np.max`` stacking and the final 4-way median run on raw data.

Masks are cell-uniform across pulse bins (they come from the (nsub,
nchan) weights), so the bin-axis reductions are mask-free and patched.

These are the sort-route functions: :func:`masked_median` is the
composition's median (the engine's residual-std telemetry takes kernel
K9, ``stats.kernels.masked_median``), :func:`cell_diagnostics` is the
body of kernel K2's plain version, :func:`_masked_side` and
:func:`_patch_nan_lines` are the epilogues kernel K3 reproduces, and
:func:`scale_and_combine` is the reference's sort-route combine that the
kernel route is held against.
"""

from __future__ import annotations

import math

import torch

# numpy.ma default float fill value, observable through rule 4.
MA_FILL = 1e20


def masked_median(values, mask, dim):
    """``np.ma.median`` along ``dim`` (keepdims): the median of unmasked
    entries, even counts averaging the two middle order statistics with
    ``0.5 * (lo + hi)``; lines with no valid entry give 0.0.  Sort route:
    masked entries become +inf and sort above every real (NaN above
    +inf)."""
    sentinel = torch.full((), math.inf, dtype=values.dtype,
                          device=values.device)
    ordered = torch.sort(torch.where(mask, sentinel, values), dim=dim).values
    n = torch.sum(~mask, dim=dim, keepdim=True)
    size = values.shape[dim]
    lo = torch.gather(ordered, dim, torch.clamp((n - 1) // 2, 0, size - 1))
    hi = torch.gather(ordered, dim, torch.clamp(n // 2, 0, size - 1))
    med = 0.5 * (lo + hi)
    return torch.where(n == 0, torch.zeros_like(med), med)


def inverse_threshold(thresh, like):
    """``float32(1) / float32(thresh)`` as a 0-d tensor beside ``like``.

    The reference's compiler rewrites every division by a compile-time
    constant threshold into a multiplication by its float32 reciprocal,
    so the port multiplies too — with a device tensor, so that no
    backend picks its own scalar-division shortcut."""
    one = torch.ones((), dtype=like.dtype, device=like.device)
    # filled on the device: a tensor made from a host value would be a
    # blocking host-to-card copy each call
    return one / torch.full((), float(thresh), dtype=like.dtype,
                            device=like.device)


def _masked_side(centred, mad, mask, n, thresh):
    """Masked-path epilogue (rules 1-4): zero-MAD/empty lines go dead
    (centred data passes through undivided), live entries are
    ``|centred / mad| / thresh``."""
    line_dead = (mad == 0) | (n == 0)
    safe_mad = torch.where(line_dead, torch.ones_like(mad), mad)
    dead = mask | line_dead
    mag = torch.abs(torch.where(dead, centred, centred / safe_mad))
    return torch.where(dead, mag, mag * inverse_threshold(thresh, mag))


def scale_lines_masked(diag, mask, dim, thresh):
    """Masked-path line normalisation, post ``|.|/threshold``."""
    n = torch.sum(~mask, dim=dim, keepdim=True)
    med = masked_median(diag, mask, dim)
    centred = torch.where(mask, diag, diag - med)
    mad = masked_median(torch.abs(centred), mask, dim)
    return _masked_side(centred, mad, mask, n, thresh)


def _patch_nan_lines(med, values, dim):
    """NaN-bearing lines median to NaN (``np.median`` propagation)."""
    has_nan = torch.any(torch.isnan(values), dim=dim, keepdim=True)
    return torch.where(has_nan, torch.full_like(med, math.nan), med)


def _plain_median(diag, dim):
    """``np.median`` (keepdims, NaN-propagating) as the all-false-mask
    :func:`masked_median` with NaN lines patched."""
    med = masked_median(diag, torch.zeros_like(diag, dtype=torch.bool), dim)
    return _patch_nan_lines(med, diag, dim)


def scale_lines_plain(diag, dim, thresh):
    """Plain-path normalisation (the rFFT diagnostic): IEEE semantics —
    zero MAD yields inf/nan that flow onward (rule 5)."""
    med = _plain_median(diag, dim)
    centred = diag - med
    mad = _plain_median(torch.abs(centred), dim)
    return torch.abs(centred / mad) * inverse_threshold(thresh, centred)


def dft_tables(nbin: int, dtype, device):
    """(nbin, nbin//2+1) cos/sin tables of the forward real DFT, built in
    float32 by the reference formula: angle = float32(-2*pi/nbin) * b * k."""
    b = torch.arange(nbin, dtype=dtype, device=device)
    k = torch.arange(nbin // 2 + 1, dtype=dtype, device=device)
    ang = (-2.0 * math.pi / nbin) * torch.outer(b, k)
    return torch.cos(ang), torch.sin(ang)


def rfft_magnitudes(x, mode="dft"):
    """``|rfft|`` along the last axis: ``fft`` through ``torch.fft``,
    ``dft`` as two real matmuls against the cos/sin tables (the form
    kernel K2 evaluates)."""
    if mode == "fft":
        return torch.abs(torch.fft.rfft(x, dim=-1))
    if mode != "dft":
        raise ValueError(f"unknown fft mode {mode!r}")
    cos_t, sin_t = dft_tables(x.shape[-1], x.dtype, x.device)
    re = x @ cos_t
    im = x @ sin_t
    return torch.sqrt(re * re + im * im)


def cell_diagnostics(resid_weighted, cell_mask, fft_mode="dft"):
    """The four per-cell diagnostics as (nsub, nchan) planes:
    (d_std, d_mean, d_ptp, d_fft).  Two-pass centred variance; masked
    cells patched per rule 4; the spectrum taken of the centred rows."""
    x = resid_weighted
    m = cell_mask
    n = x.shape[2]
    mean_b = torch.sum(x, dim=2) / n
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    d_mean = torch.where(m, zero, mean_b)
    centred = x - torch.where(m, zero, mean_b)[..., None]
    var = torch.sum(centred * centred, dim=2) / n
    d_std = torch.where(m, zero, torch.sqrt(var))
    fill = torch.full((), MA_FILL, dtype=x.dtype, device=x.device)
    d_ptp = torch.where(m, fill, torch.amax(x, dim=2) - torch.amin(x, dim=2))
    d_fft = torch.amax(rfft_magnitudes(centred, fft_mode), dim=2)
    return d_std, d_mean, d_ptp, d_fft


def median_of_four(a, b, c, d):
    """``np.median`` of four stacked planes, elementwise: the two middle
    order statistics combined as ``lo*0.5 + hi*0.5`` (numpy's linear
    quantile arithmetic), NaN wherever any input is NaN."""
    s = torch.sort(torch.stack([a, b, c, d]), dim=0).values
    med = s[1] * 0.5 + s[2] * 0.5
    any_nan = torch.isnan(a) | torch.isnan(b) | torch.isnan(c) | torch.isnan(d)
    return torch.where(any_nan, torch.full_like(med, math.nan), med)


def scale_and_combine(diagnostics, cell_mask, chanthresh, subintthresh):
    """Channel/subint scaling + 4-way median over precomputed
    diagnostics, by the sort route (reference :220-226).  The engine
    runs the same function as kernels K3 (both orientations) and the
    combine kernel; this composition is their independent reference."""
    d_std, d_mean, d_ptp, d_fft = diagnostics
    m = cell_mask
    per_diag = []
    for diag in (d_std, d_mean, d_ptp):
        per_diag.append(torch.maximum(
            scale_lines_masked(diag, m, 0, chanthresh),
            scale_lines_masked(diag, m, 1, subintthresh)))
    per_diag.append(torch.maximum(scale_lines_plain(d_fft, 0, chanthresh),
                                  scale_lines_plain(d_fft, 1, subintthresh)))
    return median_of_four(*per_diag)
