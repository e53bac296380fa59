"""PSRCHIVE-spec integration-consensus baseline, in torch.

One phase window per subintegration, placed at the smoothed minimum of
the subint's weighted total profile (``w = max(1, round(duty * nbin))``
bins, centred window ``(c - w//2 + j) % nbin``, ties to the lowest bin);
every channel subtracts its own mean over those shared bins.  Same
conventions as ``iterative_cleaner_tpu/ops/psrchive_baseline.py``.
"""

from __future__ import annotations

import torch


def window_width(nbin: int, duty: float) -> int:
    """``w = max(1, round(duty * nbin))`` — BaselineWindow's bin count."""
    return max(1, int(round(duty * nbin)))


def centred_window_means(profiles, w: int):
    """Mean of the ``w``-bin circular window centred at every bin."""
    from iterative_cleaner_torch.ops.dsp import circular_window_sums

    return circular_window_sums(profiles, w, centred=True) / w


def integration_window_centres(total_profiles, duty: float):
    """Per-subint smoothed-minimum bin of (nsub, nbin) total profiles."""
    w = window_width(total_profiles.shape[-1], duty)
    return torch.argmin(centred_window_means(total_profiles, w), dim=-1)


def baseline_offsets_integration(cube, weights, duty: float):
    """Per-(subint, channel) baseline levels, (nsub, nchan).

    Each channel's level is its mean over the subint's shared window:
    the cube contracted with the subint's 0/1 window row, then ``/ w`` —
    the column of the reference's circulant window-sum matmul at the
    centre bin, without forming the other ``nbin - 1`` columns."""
    nbin = cube.shape[-1]
    w = window_width(nbin, duty)
    total = torch.einsum("sc,scb->sb", weights, cube)
    centres = integration_window_centres(total, duty)
    j = torch.arange(nbin, device=cube.device)
    window = torch.remainder(j[None, :] - centres[:, None] + w // 2,
                             nbin) < w
    return torch.einsum("scb,sb->sc", cube, window.to(cube.dtype)) / w


def template_correction_from_totals(t1, base_offsets, weights, duty):
    """Per-iteration template shift of the integration baseline under the
    CURRENT weights, from the per-subint weighted totals
    ``t1 = sum_c w * disp_clean`` (reference :88-94 recomputes baselines
    on every template build; the hoisted preamble used the original
    weights, and the difference is this scalar)."""
    w = window_width(t1.shape[-1], duty)
    r = torch.sum(weights * base_offsets, dim=1)
    sm = centred_window_means(t1, w) + r[:, None]
    num = torch.sum(weights * base_offsets) \
        - torch.sum(torch.min(sm, dim=-1).values)
    den = torch.sum(weights)
    safe = torch.where(den == 0, torch.ones_like(den), den)
    return torch.where(den == 0, torch.zeros_like(num), num / safe)
