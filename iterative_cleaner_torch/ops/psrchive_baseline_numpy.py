"""The PSRCHIVE-spec baseline of the float64 numpy oracle, in plain numpy.

The port's own copy of the numpy branches of the reference package's
``ops/psrchive_baseline.py`` that its oracle uses: the integration
baseline (one minimum window a subint, placed on the weighted total
profile's smoothed minimum, each channel's mean over it subtracted) and
the per-iteration template correction.  The conventions are the
reference's: ``w = max(1, round(duty * nbin))``, the window centred at
``c`` covers ``(c - w//2 + j) % nbin`` for ``j`` in ``[0, w)``, ties to
the lowest bin.  The torch engine's counterpart is
:mod:`iterative_cleaner_torch.ops.psrchive_baseline`.
"""

from __future__ import annotations

import numpy as np

from iterative_cleaner_torch.ops.dsp_numpy import circular_window_sums


def window_width(nbin: int, duty: float) -> int:
    """``w = max(1, round(duty * nbin))``: the baseline window's bins."""
    return max(1, int(round(duty * nbin)))


def centred_window_means(profiles, w: int):
    """Mean of the ``w``-bin circular window centred at every bin."""
    return circular_window_sums(profiles, w, centred=True) / w


def integration_window_centres(total_profiles, duty: float):
    """Per-subint smoothed-minimum bin of the (nsub, nbin) total
    profiles, ties to the lowest bin."""
    w = window_width(total_profiles.shape[-1], duty)
    sm = centred_window_means(total_profiles, w)
    return np.argmin(sm, axis=-1)


def baseline_offsets_integration(cube, weights, duty: float):
    """Per-(subint, channel) baseline levels: ``(offsets (nsub, nchan),
    centres (nsub,))``, each channel's mean over its subint's window,
    the window placed on the ``weights``-weighted total profile."""
    nbin = cube.shape[-1]
    w = window_width(nbin, duty)
    total = np.einsum("sc,scb->sb", weights, cube)
    centres = integration_window_centres(total, duty)
    wm = centred_window_means(cube, w)
    offsets = np.take_along_axis(
        wm, centres[:, None, None], axis=-1)[..., 0]
    return offsets, centres


def template_correction(disp_clean, base_offsets, weights, duty: float):
    """The template's shift from the current weights' baseline windows
    against the hoisted (original-weights) ones, one scalar:
    ``[sum(w * V) - sum_s min_p sm_w(s, p)] / sum(w)``."""
    t1 = np.einsum("sc,scb->sb", weights, disp_clean)
    return template_correction_from_totals(t1, base_offsets, weights, duty)


def template_correction_numerator_from_totals(t1, base_offsets, weights,
                                              duty):
    """The correction's numerator from the per-subint weighted totals
    ``t1 = sum_c w * disp_clean``."""
    w = window_width(t1.shape[-1], duty)
    r = np.sum(weights * base_offsets, axis=1)
    sm = centred_window_means(t1, w) + r[:, None]
    return np.sum(weights * base_offsets) - np.sum(np.min(sm, axis=-1))


def template_correction_from_totals(t1, base_offsets, weights, duty):
    """:func:`template_correction` from the totals ``t1``."""
    num = template_correction_numerator_from_totals(
        t1, base_offsets, weights, duty)
    den = np.sum(weights)
    safe = np.where(den == 0, np.ones_like(den), den)
    return np.where(den == 0, np.zeros_like(num), num / safe)


def template_correction_numerator_raw(cube_raw, base_offsets, weights,
                                      duty: float):
    """The correction's numerator over a subint tile of the RAW cube
    (exact streaming accumulates it per tile and divides by the whole
    weight sum)."""
    w = window_width(cube_raw.shape[-1], duty)
    t1 = np.einsum("sc,scb->sb", weights, cube_raw)
    sm = centred_window_means(t1, w)
    return np.sum(weights * base_offsets) - np.sum(np.min(sm, axis=-1))
