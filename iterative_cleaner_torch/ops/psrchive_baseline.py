"""PSRCHIVE-spec integration-consensus baseline, in torch.

The per-iteration template correction also takes a batch of equal-shaped
archives (a leading dimension B; one correction per archive).

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


def baseline_offsets_integration(cube, weights, duty: float, mesh=None):
    """Per-(subint, channel) baseline levels, (nsub, nchan).

    Each channel's level is its mean over the subint's shared window:
    the cube contracted with the subint's 0/1 window row, then ``/ w`` —
    the column of the reference's circulant window-sum matmul at the
    centre bin, without forming the other ``nbin - 1`` columns.  On a
    cell ``mesh`` (a rank's shard) the weighted total profile sums over
    the channel blocks of the rank's row."""
    nbin = cube.shape[-1]
    w = window_width(nbin, duty)
    total = torch.einsum("sc,scb->sb", weights, cube)
    if mesh is not None:
        total = mesh.total(total, "chan")
    centres = integration_window_centres(total, duty)
    j = torch.arange(nbin, device=cube.device)
    window = torch.remainder(j[None, :] - centres[:, None] + w // 2,
                             nbin) < w
    return torch.einsum("scb,sb->sc", cube, window.to(cube.dtype)) / w


def template_correction(disp_clean, base_offsets, weights, duty,
                        mesh=None):
    """:func:`template_correction_from_totals` from the baseline-removed
    dispersed cube itself: one contraction ``t1 = sum_c w * disp_clean``
    (the routes whose template stage does not take both marginals in
    one read); on a cell ``mesh`` summed over the rank's row."""
    from iterative_cleaner_torch.ops.dsp import weighted_channel_sum

    t1 = weighted_channel_sum(weights, disp_clean)
    if mesh is not None:
        t1 = mesh.total(t1, "chan")
    return template_correction_from_totals(t1, base_offsets, weights, duty,
                                           mesh)


def template_correction_numerator_from_totals(t1, base_offsets, weights,
                                              duty, mesh=None):
    """Un-normalised correction over a (tile of) per-subint weighted
    totals ``t1 = sum_c w * disp_clean``: every term is local to a subint
    row or a plain sum, so tile numerators add up to the whole archive's
    (exact streaming's default-route partial).  On a cell ``mesh`` ``t1``
    is this rank's subints' (summed over its row already): the per-subint
    offset sums cross the row, the sum of the minima the column, the
    weighted offsets' total every rank."""
    from iterative_cleaner_torch.ops.dsp import each_archive, trailing_sum

    w = window_width(t1.shape[-1], duty)
    r = each_archive(lambda x: torch.sum(x, dim=-1), 2,
                     weights * base_offsets)
    if mesh is not None:
        r = mesh.total(r, "chan")
    sm = each_archive(lambda t: centred_window_means(t, w), 2, t1) \
        + r[..., None]
    total = trailing_sum(weights * base_offsets, 2)
    minima = trailing_sum(torch.min(sm, dim=-1).values, 1)
    if mesh is not None:
        total, minima = mesh.total(total, "all"), mesh.total(minima, "sub")
    return total - minima


def template_correction_numerator_raw(cube_raw, base_offsets, weights,
                                      duty, mesh=None):
    """Un-normalised correction over a subint tile of the RAW
    (pre-baseline) cube: the smoothed total straight from the raw
    weighted sum (``wm(sum_c w*(clean + V)) = wm(sum_c w*clean) + sum_c
    w*V``).  Exact streaming accumulates these per tile on the routes
    other than the default and divides by the global weight sum.  On a
    cell ``mesh`` (a rank's block of the tile) the totals sum over the
    rank's row, the minima over its column, the weighted offsets over
    every rank."""
    from iterative_cleaner_torch.ops.dsp import weighted_channel_sum

    w = window_width(cube_raw.shape[-1], duty)
    t1 = weighted_channel_sum(weights, cube_raw)
    if mesh is not None:
        t1 = mesh.total(t1, "chan")
    sm = centred_window_means(t1, w)
    total = torch.sum(weights * base_offsets)
    minima = torch.sum(torch.min(sm, dim=-1).values)
    if mesh is not None:
        total, minima = mesh.total(total, "all"), mesh.total(minima, "sub")
    return total - minima


def template_correction_from_totals(t1, base_offsets, weights, duty,
                                    mesh=None):
    """Per-iteration template shift of the integration baseline under the
    CURRENT weights, from the per-subint weighted totals
    ``t1 = sum_c w * disp_clean`` (reference :88-94 recomputes baselines
    on every template build; the hoisted preamble used the original
    weights, and the difference is this scalar): the numerator over the
    weight sum (over every rank of a cell ``mesh``)."""
    from iterative_cleaner_torch.ops.dsp import trailing_sum

    num = template_correction_numerator_from_totals(t1, base_offsets,
                                                    weights, duty, mesh)
    den = trailing_sum(weights, 2)
    if mesh is not None:
        den = mesh.total(den, "all")
    safe = torch.where(den == 0, torch.ones_like(den), den)
    return torch.where(den == 0, torch.zeros_like(num), num / safe)
