"""Quicklook: the single-pass, template-free triage cleaner.

Baseline removal and dedispersion, then the four surgical-scrub
diagnostics of the weighted dedispersed data itself (no template is
fitted or subtracted), the channel and subint scalers, the 4-way median
and the zap: one statistics pass instead of ``max_iter`` template
iterations (``loops=1``, ``converged=True``), then the whole-line sweep.
The per-channel and per-subint scaling absorbs a steady pulse, so strong
RFI stands out.  The reference is ``iterative_cleaner_tpu/models/
quicklook.py``: the same steps, the same result fields.

On the card it runs on the kernels the flagship's routes already launch:
K6 (``cell_diagnostics_dedisp``) with an all-zero template and a window
of ones, K3 along each axis, then the combine kernel; no plain PyTorch
version runs there.  K6's fit gives an amplitude of 1 where <t, t> = 0,
so its residual is ``(0 - ded) * 1 * w``, exactly ``-(w * ded)``: the
standard deviation, peak-to-peak and spectral maximum of each cell are
those of ``w * ded``, its mean is exactly negated, and since every scaler
side takes ``|d - median|`` the scores are bit-equal to those of
``w * ded``.  Quicklook computes in ``config.dtype`` (the float64 builds
of the three kernels under ``dtype='float64'``) and ignores
``compute_dtype``, as the reference does; it keeps only the dedispersed
cube on the card (no template correction cube) and records no
``iter_metrics`` (so it launches no K9).

``max_iter``, the pulse window and ``stats_frame`` parameterise the
template stage only and are ignored; ``chanthresh``, ``subintthresh``,
``baseline_duty``, ``baseline_mode``, ``rotation`` and the ``bad_*``
sweep apply as usual.  ``backend='numpy'`` runs the float64 numpy twin
(:func:`_clean_quicklook_numpy`), bit-equal to the reference's.
"""

from __future__ import annotations

import numpy as np
import torch

from iterative_cleaner_torch.backends.base import CleanResult, apply_bad_parts
from iterative_cleaner_torch.config import CleanConfig
from iterative_cleaner_torch.engine.loop import scores_and_zap
from iterative_cleaner_torch.ops.dsp import prepare_cube_with_correction
from iterative_cleaner_torch.stats.kernels import cell_diagnostics_dedisp
from iterative_cleaner_torch.utils.tracing import stage

# The kernels quicklook launches, once each but K3 once per axis
# (launch-count names of stats.kernels).
QUICKLOOK_KERNELS = ("cell_diagnostics_dedisp", "scaled_sides_axis0",
                     "scaled_sides_axis1", "combine_zap")


def quicklook_prepare(cube, weights, freqs_mhz, dm, ref_freq_mhz, period_s,
                      config: CleanConfig, *, dedispersed: bool):
    """The preamble's dedispersed cube of the uploaded ``cube`` (consumed:
    the baseline is removed in place), as the flagship prepares it; the
    integration baseline's pre-rotation cube is dropped before this
    returns."""
    return prepare_cube_with_correction(
        cube, weights, freqs_mhz, dm, ref_freq_mhz, period_s,
        baseline_duty=config.baseline_duty, rotation=config.rotation,
        dedispersed=dedispersed, baseline_mode=config.baseline_mode)[0]


def quicklook_scores(ded, weights, chanthresh, subintthresh):
    """``(new_weights, scores)`` of the dedispersed cube: K6 with a zero
    template and a ones window (the diagnostics of ``-(w * ded)``), K3
    along each axis, the combine kernel; their plain versions for CPU
    tensors."""
    nbin = ded.shape[-1]
    cell_mask = weights == 0
    zero = torch.zeros((nbin,), dtype=ded.dtype, device=ded.device)
    ones = torch.ones((nbin,), dtype=ded.dtype, device=ded.device)
    with stage("icln_residual_stats"):
        diags = cell_diagnostics_dedisp(ded, zero, ones, weights, cell_mask)
    return scores_and_zap(diags, cell_mask, weights, chanthresh,
                          subintthresh)


def _result(new_w, scores, orig_weights, config) -> CleanResult:
    result = CleanResult(
        final_weights=new_w,
        scores=scores,
        loops=1,
        converged=True,   # single-pass by construction
        loop_diffs=np.asarray([(new_w != orig_weights).sum()],
                              dtype=np.int64),
        loop_rfi_frac=np.asarray([(new_w == 0).mean()]),
    )
    return apply_bad_parts(result, config)


def _clean_quicklook_numpy(archive, config: CleanConfig) -> CleanResult:
    """The float64 numpy twin of the quicklook: the oracle of the
    strategy, on the port's numpy modules, op for op the reference's."""
    from iterative_cleaner_torch.ops.dsp_numpy import prepare_cube
    from iterative_cleaner_torch.stats.masked_numpy import (
        surgical_scores_numpy,
    )

    cube = np.asarray(archive.total_intensity(), dtype=np.float64)
    weights = np.asarray(archive.weights, dtype=np.float64)
    ded, _ = prepare_cube(
        cube, archive.freqs_mhz, archive.dm, archive.centre_freq_mhz,
        archive.period_s, baseline_duty=config.baseline_duty,
        rotation=config.rotation, dedispersed=archive.dedispersed,
        baseline_mode=config.baseline_mode, weights=weights,
    )
    cell_mask = weights == 0
    scores = surgical_scores_numpy(ded * weights[:, :, None], cell_mask,
                                   config.chanthresh, config.subintthresh)
    new_w = np.where(scores >= 1.0, 0.0, weights)
    return _result(new_w, scores, weights, config)


def clean_archive_quicklook(archive, config: CleanConfig) -> CleanResult:
    """Single-pass template-free clean of one archive on
    ``config.device`` (a CUDA device raises where none is present), or on
    the numpy twin with ``backend='numpy'``; the signature of
    :func:`iterative_cleaner_torch.backends.clean_archive`."""
    if config.backend == "numpy":
        return _clean_quicklook_numpy(archive, config)
    from iterative_cleaner_torch.backends.torch_backend import (
        clean_device,
        engine_dtype,
        upload,
        upload_meta,
    )

    device = clean_device(config)
    dtype = engine_dtype(config)
    weights = upload(archive.weights, device, dtype)
    ded = quicklook_prepare(
        upload(archive.total_intensity(), device, dtype), weights,
        *upload_meta(archive.freqs_mhz, archive.dm, archive.centre_freq_mhz,
                     archive.period_s, device, dtype),
        config, dedispersed=bool(archive.dedispersed))
    new_w, scores = quicklook_scores(ded, weights, config.chanthresh,
                                     config.subintthresh)
    return _result(new_w.cpu().numpy(), scores.cpu().numpy(),
                   np.asarray(archive.weights), config)
