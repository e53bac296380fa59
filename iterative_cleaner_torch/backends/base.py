"""The clean's result record and the post-loop whole-line sweep."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class CleanResult:
    """Everything the reference's ``clean()`` makes observable, as host
    numpy arrays."""

    final_weights: np.ndarray        # (nsub, nchan) cleaned weight matrix
    scores: np.ndarray               # last iteration's zap scores
    loops: int                       # iterations actually run
    converged: bool
    n_bad_subints: int = 0           # whole-line removals by the sweep
    n_bad_channels: int = 0
    loop_diffs: Optional[np.ndarray] = None      # (loops,) cells changed
    loop_rfi_frac: Optional[np.ndarray] = None   # (loops,) zero-weight fraction
    # (loops+1, nsub, nchan) weight matrices, with config.record_history
    weight_history: Optional[np.ndarray] = None
    # (loops, 4) float32: zap_count, mask_churn, residual_std, template_peak
    iter_metrics: Optional[np.ndarray] = None

    @property
    def rfi_fraction(self) -> float:
        """Fraction of zero-weight cells."""
        w = self.final_weights
        return float((w.size - np.count_nonzero(w)) / w.size)

    def zap_mask(self) -> np.ndarray:
        """(nsub, nchan) bool: True where the cell is zapped."""
        return self.final_weights == 0


def apply_bad_parts(result: CleanResult, config) -> CleanResult:
    """Run the optional whole-line sweep, gated as the reference gates it
    (only when either threshold differs from 1).  Mutates and returns
    ``result``."""
    if config.bad_chan != 1 or config.bad_subint != 1:
        swept, nbs, nbc = sweep_bad_lines(
            result.final_weights, config.bad_subint, config.bad_chan)
        result.final_weights = swept
        result.n_bad_subints = nbs
        result.n_bad_channels = nbc
    return result


def sweep_bad_lines(weights: np.ndarray, bad_subint: float, bad_chan: float):
    """Whole-subint/channel removal (reference ``find_bad_parts``).

    Fractions are computed once on the weights as passed and compared
    strictly (``>``), so thresholds of 1.0 disable the sweep.  Returns
    ``(new_weights, n_bad_subints, n_bad_channels)``."""
    nsub, nchan = weights.shape
    subint_frac = 1.0 - np.count_nonzero(weights, axis=1) / float(nchan)
    chan_frac = 1.0 - np.count_nonzero(weights, axis=0) / float(nsub)
    bad_rows = subint_frac > bad_subint
    bad_cols = chan_frac > bad_chan
    out = weights.copy()
    out[bad_rows, :] = 0.0
    out[:, bad_cols] = 0.0
    return out, int(bad_rows.sum()), int(bad_cols.sum())
