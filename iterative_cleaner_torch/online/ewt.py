"""Exponentially-weighted running template of a live stream.

The batch loop refits its template from the whole cube every iteration;
a live stream cannot afford a growing-cube refit per subint.  The online
session keeps instead

    T_0     = p_0
    T_n     = (1 - alpha) * T_{n-1} + alpha * p_n

where ``p_n`` is subint ``n``'s weighted mean profile, a forgetting
horizon of ``1/alpha`` subints.  The provisional zap fits the EW
template as the batch fit fits its own (the fit normalises per cell, so
the template's scale cancels); the reconciles then replace every
provisional decision with the batch cleaner's, so EW-versus-refit drift
never reaches the final mask.

Tensors in, tensors out, on the device that holds them: the session's
step (:mod:`.step`) calls these between the preamble and the cell
kernel, and the template and its count never leave the device.
"""

from __future__ import annotations

import torch


def subint_profile(ded_tile, weights_row):
    """Weighted mean profile of one ``(k, nchan, nbin)`` dedispersed tile
    with ``(k, nchan)`` weights -> ``(nbin,)``.  An all-zapped tile gives
    zeros (the EW update then keeps the previous template)."""
    wsum = torch.sum(weights_row)
    num = torch.sum(ded_tile * weights_row[:, :, None], dim=(0, 1))
    safe = torch.where(wsum > 0, wsum, torch.ones_like(wsum))
    return torch.where(wsum > 0, num / safe, torch.zeros_like(num))


def ew_update(template, count, profile, alpha: float):
    """One EW step.  ``count`` is how many profiles preceded this one:
    the first real profile seeds the template outright (alpha would
    otherwise anchor it to the zero start); skipping an all-zapped
    subint is the caller's job."""
    seeded = (1.0 - alpha) * template + alpha * profile
    return torch.where(count > 0, seeded, profile)
