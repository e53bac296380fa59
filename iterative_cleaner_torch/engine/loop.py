"""The cleaning iteration of the default route (the reference's
``disp_iteration``), in torch.

- Every iteration rebuilds the template from the ORIGINAL data under the
  previous iteration's weights, so zaps re-derive from scratch and a cell
  can be un-zapped (the reference re-clones its archive each round).
- The baseline-removed DISPERSED cube ``disp`` is the one resident cube;
  it is read twice per iteration: once by the marginal kernel (K1) for the
  template stage, once by the cell-diagnostics kernel (K2).  Rotations act
  on (nchan, nbin) rows only.
- Convergence is cycle detection against every earlier weight matrix,
  held in a ``(max_iter+1)``-deep history seeded with the original
  weights.  That flag is the loop's only host synchronisation; the
  per-iteration telemetry stays on the device until the loop ends.
- The final mask applies the last iteration's scores to the original
  weights.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from iterative_cleaner_torch.ops.dsp import (
    rotate_bins,
    template_numerator_from_channel_profiles,
)
from iterative_cleaner_torch.ops.psrchive_baseline import (
    template_correction_from_totals,
)
from iterative_cleaner_torch.stats.kernels import (
    cell_diagnostics_disp,
    combine_zap,
    scaled_sides,
    weighted_marginals,
)
from iterative_cleaner_torch.stats.masked_torch import masked_median

# columns of CleanOutputs.iter_metrics
ITER_METRICS_WIDTH = 4  # zap_count, mask_churn, residual_std, template_peak


class CleanOutputs(NamedTuple):
    final_weights: torch.Tensor   # (nsub, nchan) cleaned weights
    loops: int                    # iterations run
    converged: bool
    scores: torch.Tensor          # (nsub, nchan) last iteration's scores
    loop_diffs: torch.Tensor      # (max_iter,) cells changed per loop
    loop_rfi_frac: torch.Tensor   # (max_iter,) zero-weight fraction per loop
    history: torch.Tensor         # (max_iter+1, nsub, nchan) weight matrices
    history_count: int            # entries [0:history_count] are populated
    iter_metrics: torch.Tensor    # (max_iter, ITER_METRICS_WIDTH) float32


def nyq_correction_row(back_shifts, nbin, rotation, dtype):
    """(nchan, nbin) Nyquist round-trip correction rows of the one-read
    fit, or None where the rotation round-trips exactly (roll rotation,
    odd nbin).  A fourier rotation by a fractional shift s attenuates the
    Nyquist bin, so R(s)R(-s)x = x + (cos^2(pi s) - 1) * nyq(x) with
    nyq(x)[b] = (1/n)(-1)^b sum_b' (-1)^b' x[b']; K2 applies that rank-one
    term per cell."""
    if rotation != "fourier" or nbin % 2 != 0:
        return None
    frac = back_shifts - torch.round(back_shifts)
    gamma = torch.cos(math.pi * frac.to(dtype)) ** 2 - 1.0
    alt = (1.0 - 2.0 * (torch.arange(nbin, device=back_shifts.device) % 2)
           ).to(dtype)
    return (gamma / nbin)[:, None] * alt[None, :]


def build_template(disp, weights, back_shifts, base_offsets, *, rotation,
                   baseline_duty):
    """Template stage of one iteration: both weighted marginals of the
    dispersed cube in one read (K1); the dedispersion rotation applied
    to the (nchan, nbin) channel profiles; the integration-baseline
    correction under the current weights; the reference's x10000."""
    a, t1 = weighted_marginals(disp, weights)
    num = template_numerator_from_channel_profiles(a, back_shifts, rotation)
    den = torch.sum(weights)
    safe = torch.where(den == 0, torch.ones_like(den), den)
    template = torch.where(den == 0, torch.zeros_like(num), num / safe)
    template = template + template_correction_from_totals(
        t1, base_offsets, weights, baseline_duty)
    return template * 10000.0


def iteration_step(disp, weights, orig_weights, cell_mask, back_shifts,
                   base_offsets, *, chanthresh, subintthresh, rotation,
                   baseline_duty):
    """One iteration: template -> fit -> residual diagnostics (K2) ->
    both scaler orientations (K3) -> 4-way median and zap (combine).
    Returns ``(new_weights, scores, residual_std, template_peak)``, the
    last two as device scalars for the telemetry rows."""
    nchan, nbin = disp.shape[1:]
    template = build_template(disp, weights, back_shifts, base_offsets,
                              rotation=rotation, baseline_duty=baseline_duty)
    rot_t = rotate_bins(template.expand(nchan, nbin), back_shifts,
                        method=rotation).contiguous()
    nyq_row = nyq_correction_row(back_shifts, nbin, rotation, disp.dtype)
    diags = cell_diagnostics_disp(disp, rot_t, nyq_row, template,
                                  orig_weights, cell_mask)
    chan = scaled_sides(diags, cell_mask, 0, chanthresh)
    sub = scaled_sides(diags, cell_mask, 1, subintthresh)
    new_weights, scores = combine_zap(chan, sub, orig_weights)
    rstd = masked_median(diags[0].reshape(1, -1), cell_mask.reshape(1, -1),
                         1)[0, 0]
    return new_weights, scores, rstd, torch.max(template)


def clean_dispersed(disp, orig_weights, back_shifts, base_offsets, *,
                    max_iter, chanthresh, subintthresh, rotation,
                    baseline_duty) -> CleanOutputs:
    """Run the iteration loop on the baseline-removed dispersed cube."""
    nsub, nchan, _ = disp.shape
    dev = disp.device
    cell_mask = orig_weights == 0
    history = torch.zeros((max_iter + 1, nsub, nchan), dtype=orig_weights.dtype,
                          device=dev)
    history[0] = orig_weights
    loop_diffs = torch.zeros((max_iter,), dtype=torch.int32, device=dev)
    loop_rfi_frac = torch.zeros((max_iter,), dtype=disp.dtype, device=dev)
    iter_metrics = torch.zeros((max_iter, ITER_METRICS_WIDTH),
                               dtype=torch.float32, device=dev)
    weights = orig_weights
    scores = torch.zeros((nsub, nchan), dtype=disp.dtype, device=dev)
    count, loops, converged = 1, max_iter, False
    for x in range(max_iter):
        new_w, scores, rstd, tpeak = iteration_step(
            disp, weights, orig_weights, cell_mask, back_shifts,
            base_offsets, chanthresh=chanthresh, subintthresh=subintthresh,
            rotation=rotation, baseline_duty=baseline_duty)
        repeat = (history[:count] == new_w[None]).flatten(1).all(dim=1).any()
        history[count] = new_w
        count += 1
        loop_diffs[x] = torch.sum(new_w != weights)
        loop_rfi_frac[x] = torch.mean((new_w == 0).to(disp.dtype))
        iter_metrics[x] = torch.stack([
            torch.sum(new_w == 0).to(torch.float32),
            torch.sum((new_w == 0) != (weights == 0)).to(torch.float32),
            rstd.to(torch.float32), tpeak.to(torch.float32)])
        weights = new_w
        if bool(repeat):  # the loop's one host sync
            converged, loops = True, x + 1
            break
    return CleanOutputs(
        final_weights=weights, loops=loops, converged=converged,
        scores=scores, loop_diffs=loop_diffs, loop_rfi_frac=loop_rfi_frac,
        history=history, history_count=count, iter_metrics=iter_metrics)
