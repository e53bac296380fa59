"""The detection statistics of the float64 numpy oracle, on ``numpy.ma``.

The port's own copy of the reference package's ``stats/masked_numpy.py``.
Working in ``numpy.ma`` end to end, the masked-array corner cases the
final mask depends on are numpy's own: the mask dropped at the stacking
``np.max``, zero-MAD lines masked with the numerator left in ``.data``,
and the mask-ignoring rFFT, whose diagnostic is scaled on the plain
path (IEEE inf/nan flowing on).  The torch engine states the same rules
explicitly (:mod:`iterative_cleaner_torch.stats.masked_torch`).
"""

from __future__ import annotations

import numpy as np


def robust_scale_lines(diag, axis):
    """Median/MAD-normalise each line of a 2-D diagnostic along ``axis``
    (``axis=0``: every channel across subints; ``axis=1``: every subint
    across channels).  A masked diagnostic's zero-MAD line comes back
    fully masked with the centred numerator in ``.data``; a plain one's
    gives IEEE inf/nan."""
    with np.errstate(invalid="ignore", divide="ignore"):
        if isinstance(diag, np.ma.MaskedArray):
            med = np.ma.median(diag, axis=axis, keepdims=True)
            centred = diag - med
            mad = np.ma.median(np.abs(centred), axis=axis, keepdims=True)
            return centred / mad
        med = np.median(diag, axis=axis, keepdims=True)
        centred = diag - med
        mad = np.median(np.abs(centred), axis=axis, keepdims=True)
        return centred / mad


def cell_diagnostics_numpy(resid_weighted, cell_mask):
    """The four per-cell diagnostics as (nsub, nchan) arrays: std, mean
    and ptp masked, the rFFT one plain (``np.fft.rfft`` drops the mask).
    Each reduces only the bin axis, so tiles of subints compute apart
    (exact streaming)."""
    mask3 = np.broadcast_to(cell_mask[:, :, None], resid_weighted.shape)
    cube = np.ma.masked_array(resid_weighted, mask=mask3)

    diagnostics = [
        np.ma.std(cube, axis=2),
        np.ma.mean(cube, axis=2),
        np.ma.ptp(cube, axis=2),
    ]
    centred = cube - np.expand_dims(cube.mean(axis=2), axis=2)
    diagnostics.append(np.max(np.abs(np.fft.rfft(centred, axis=2)), axis=2))
    return diagnostics


def scale_and_combine_numpy(diagnostics, chanthresh, subintthresh):
    """The channel and subint scalers and the 4-way median over the
    diagnostics."""
    per_diag = []
    for diag in diagnostics:
        chan_side = np.abs(robust_scale_lines(diag, axis=0)) / chanthresh
        subint_side = np.abs(robust_scale_lines(diag, axis=1)) / subintthresh
        # stacking through np.max drops masks; the raw .data flows on
        per_diag.append(np.max((chan_side, subint_side), axis=0))
    return np.median(per_diag, axis=0)


def surgical_scores_numpy(resid_weighted, cell_mask, chanthresh,
                          subintthresh):
    """Zap scores of every (subint, channel) cell (score >= 1 zaps) from
    the weighted residual cube and the cell mask (original weight 0)."""
    return scale_and_combine_numpy(
        cell_diagnostics_numpy(resid_weighted, cell_mask),
        chanthresh, subintthresh,
    )
