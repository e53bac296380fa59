"""The float64 numpy oracle: ``clean_cube`` on the host, in numpy.

The port's own copy of the reference package's ``backends/
numpy_backend.py``: the reference algorithm re-expressed in vectorised
float64 numpy (the per-cell fit in closed form), on the numpy DSP ops
(:mod:`iterative_cleaner_torch.ops.dsp_numpy`, :mod:`~iterative_cleaner_
torch.ops.psrchive_baseline_numpy`) and the ``numpy.ma`` statistics
(:mod:`iterative_cleaner_torch.stats.masked_numpy`).  It is the yardstick
the torch engine's float64 mode is held to (``tools selftest``): the
inputs are cast to float64 whatever ``config.dtype`` says, and
``config.device`` means nothing here.
"""

from __future__ import annotations

import numpy as np

from iterative_cleaner_torch.backends.base import CleanResult
from iterative_cleaner_torch.config import CleanConfig
from iterative_cleaner_torch.ops.dsp_numpy import (
    fit_template_amplitudes,
    prepare_cube_with_correction,
    rotate_bins,
    template_residuals,
    weighted_template,
)
from iterative_cleaner_torch.ops.psrchive_baseline_numpy import (
    template_correction,
)
from iterative_cleaner_torch.stats.masked_numpy import surgical_scores_numpy


def clean_cube(cube, orig_weights, freqs_mhz, dm, ref_freq_mhz, period_s,
               config: CleanConfig, *, dedispersed: bool = False,
               registry=None) -> CleanResult:
    """Clean a total-intensity (nsub, nchan, nbin) cube in float64 numpy.
    ``dedispersed=True`` marks a DEDISP=1 input: the preamble skips only
    the forward rotation.  ``registry`` is accepted for the torch
    backend's signature and unused."""
    del registry
    cube = np.asarray(cube, dtype=np.float64)
    orig_weights = np.asarray(orig_weights, dtype=np.float64)

    ded, shifts, baseline_corr = prepare_cube_with_correction(
        cube, orig_weights, freqs_mhz, dm, ref_freq_mhz, period_s,
        baseline_duty=config.baseline_duty, rotation=config.rotation,
        dedispersed=dedispersed, baseline_mode=config.baseline_mode,
    )

    cell_mask = orig_weights == 0
    history = [orig_weights.copy()]  # the loop's history, seeded
    weights = orig_weights
    scores = np.zeros_like(orig_weights)
    residual = None
    converged = False
    loops = config.max_iter
    loop_diffs = []
    loop_rfi_frac = []
    iter_metrics = []

    for x in range(1, config.max_iter + 1):
        template = weighted_template(ded, weights)
        if baseline_corr is not None:
            # integration mode: the current weights' consensus correction
            template = template + template_correction(
                *baseline_corr[:2], weights, baseline_corr[2])
        template = template * 10000.0
        amps = fit_template_amplitudes(ded, template)
        resid = template_residuals(
            ded, template, amps, config.pulse_slice, config.pulse_scale,
            config.pulse_region_active,
        )
        resid = rotate_bins(resid, shifts, method=config.rotation)
        if config.unload_res:
            residual = resid
        weighted = resid * orig_weights[:, :, None]
        scores = surgical_scores_numpy(
            weighted, cell_mask, config.chanthresh, config.subintthresh
        )
        new_weights = np.where(scores >= 1.0, 0.0, orig_weights)
        loop_diffs.append(int(np.sum(new_weights != weights)))
        loop_rfi_frac.append(float(np.mean(new_weights == 0)))
        # the telemetry row: the residual std is the median over the
        # valid cells of the per-cell residual std diagnostic
        d_std = np.std(weighted, axis=2)
        valid = ~cell_mask
        rstd = float(np.median(d_std[valid])) if valid.any() else 0.0
        iter_metrics.append((float(np.sum(new_weights == 0)),
                             float(np.sum((new_weights == 0)
                                          != (weights == 0))),
                             rstd, float(np.max(template))))

        # cycle detection against every earlier weight matrix
        if any(np.array_equal(new_weights, old) for old in history):
            converged = True
            loops = x
            weights = new_weights
            history.append(new_weights)
            break
        history.append(new_weights)
        weights = new_weights

    return CleanResult(
        final_weights=weights,
        scores=scores,
        loops=loops,
        converged=converged,
        residual=residual,
        loop_diffs=np.asarray(loop_diffs),
        loop_rfi_frac=np.asarray(loop_rfi_frac),
        weight_history=np.stack(history) if config.record_history else None,
        iter_metrics=np.asarray(iter_metrics, dtype=np.float32).reshape(
            len(iter_metrics), 4),
    )
