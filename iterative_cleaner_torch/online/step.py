"""The per-subint step: one function of tensors, shared by the solo
session and the mux.

:func:`build_subint_step` returns

    step(tile, w_row, freqs, dm, ref, period, template, count)
      -> (new_weights, scores, new_template, updated)

with no stream state in its closure: only the resolved configuration
(thresholds, pulse window, EW alpha, the storage dtype) and the geometry,
which together are the step's key (:func:`step_build_key`; the mux's
bucket).  Stream identity (frequency table, DM, reference frequency,
period) and the EW state (template, count) ride the arguments.  The
step, for one subint:

1. the cell-local preamble (:func:`~iterative_cleaner_torch.ops.dsp.
   prepare_cube_with_correction`, ``baseline_mode="profile"`` always: a
   per-subint step cannot see the integration baseline's whole-archive
   window; the reconciles run the configured mode);
2. the subint's weighted profile (:func:`.ewt.subint_profile`);
3. the EW template update under ``updated = wsum > 0``, a ``torch.where``
   on the device (an all-zapped subint keeps the template and its count);
4. the bf16 store of the dedispersed tile where
   ``resolve_compute_dtype(..., stage="online")`` gives bfloat16;
5. kernel K6 (``stats.kernels.cell_diagnostics_dedisp``) with the pulse
   window, or a row of ones where the window is off;
6. :func:`~iterative_cleaner_torch.engine.loop.scores_and_zap`: K3 along
   axis 0 (lines of one entry: each channel's only subint), K3 along
   axis 1, then the combine kernel.

Steps 5 and 6 are the reference's one-launch ``fused_sweep_pallas_dedisp``
(K5) at nsub = 1, as the port runs K5 everywhere (K6, K3 x 2, combine).
The reference also has a non-sweep XLA/rFFT branch for the step (a
float64 pipeline, or a sweep-ineligible geometry); the port has no sweep
gate, so every dtype and geometry takes the kernels (their float64 builds
under ``dtype="float64"``).

The same function takes a leading lane axis: ``(B, 1, nchan, nbin)``
tiles, ``(B, 1, nchan)`` weights, ``(B, nchan)`` frequencies, ``(B,)``
DMs, reference frequencies and periods, ``(B, nbin)`` templates and
``(B,)`` counts: the mux's batch (:mod:`.mux`), in place of the
reference's ``vmap``.  Steps 1 to 4 run lane by lane at one lane's
shapes, so each lane's floats are those of a solo step; steps 5 and 6
are one launch of each kernel for the whole batch, each lane its own
(K6 per-lane templates, K3 per line, the combine per cell), so every
lane's mask and scores are bit-equal to a solo session's.
"""

from __future__ import annotations

from typing import Tuple

import torch

from iterative_cleaner_torch.config import CleanConfig

__all__ = ["build_subint_step", "step_build_key", "STEP_KERNELS"]

# The kernels one step launches (launch-count names of stats.kernels),
# once each per step, solo or lane-batched.
STEP_KERNELS = ("cell_diagnostics_dedisp", "scaled_sides_axis0",
                "scaled_sides_axis1", "combine_zap")


def _resolved(config: CleanConfig, registry=None):
    """``(device, engine dtype, compute dtype)`` of the online stage."""
    from iterative_cleaner_torch.backends.torch_backend import (
        clean_device,
        config_compute_dtype,
        engine_dtype,
    )

    device = clean_device(config)
    return (device, engine_dtype(config),
            config_compute_dtype(config, "online", device, registry))


def step_build_key(config: CleanConfig, nchan: int, nbin: int,
                   dedispersed: bool, alpha: float) -> Tuple:
    """Everything the step's program depends on: the geometry, DEDISP,
    the device, the dtype and the resolved compute dtype, the thresholds,
    the baseline duty, the rotation, the pulse-window knobs and the EW
    alpha.  Streams with equal keys run one step on their stacked lanes
    (the mux's bucket).  The port has no TPU route knob to key on."""
    device, dtype, compute_dtype = _resolved(config)
    return (
        int(nchan), int(nbin), bool(dedispersed), str(device),
        str(dtype).replace("torch.", ""), compute_dtype,
        float(config.chanthresh), float(config.subintthresh),
        float(config.baseline_duty), config.rotation,
        tuple(config.pulse_slice) if config.pulse_region_active else None,
        float(config.pulse_scale) if config.pulse_region_active else None,
        float(alpha),
    )


def build_subint_step(config: CleanConfig, nchan: int, nbin: int,
                      dedispersed: bool, alpha: float, registry=None):
    """The step of one ``(config, geometry)`` key.  Returns ``(step,
    device, dtype)``: ``step`` takes ``(tile (1, nchan, nbin), w_row (1,
    nchan), freqs (nchan,), dm (), ref (), period (), template (nbin,),
    count () int32)`` tensors on ``device`` in ``dtype`` (the count
    int32), or each with a leading lane axis, and returns ``(new_w (1,
    nchan), scores (1, nchan), new_template (nbin,), updated () bool)``
    (each with the lane axis), all on the device.  ``registry`` receives
    the compute dtype's downgrade count, where one happens."""
    from iterative_cleaner_torch.engine.loop import (
        pulse_window,
        scores_and_zap,
    )
    from iterative_cleaner_torch.ops.dsp import prepare_cube_with_correction
    from iterative_cleaner_torch.online.ewt import ew_update, subint_profile
    from iterative_cleaner_torch.stats.kernels import cell_diagnostics_dedisp
    from iterative_cleaner_torch.utils.tracing import stage

    cfg = config
    device, dtype, compute_dtype = _resolved(cfg, registry)
    alpha = float(alpha)
    window = pulse_window(nbin, cfg.pulse_slice, cfg.pulse_scale,
                          cfg.pulse_region_active, dtype, device)
    if window is None:
        window = torch.ones((nbin,), dtype=dtype, device=device)

    def lane(tile, w_row, freqs, dm, ref, period, template, count):
        # the cell-local preamble (consumes the tile: the baseline is
        # removed in place), the profile and the EW update of one lane
        ded, _, _ = prepare_cube_with_correction(
            tile, w_row, freqs, dm, ref, period,
            baseline_duty=cfg.baseline_duty, rotation=cfg.rotation,
            dedispersed=dedispersed, baseline_mode="profile")
        with stage("icln_template"):
            profile = subint_profile(ded, w_row)
            updated = torch.sum(w_row) > 0
            new_template = torch.where(
                updated, ew_update(template, count, profile, alpha),
                template)
        return ded, new_template, updated

    def step(tile, w_row, freqs, dm, ref, period, template, count):
        if tile.dim() == 4:
            outs = [lane(*(a[b] for a in (tile, w_row, freqs, dm, ref,
                                          period, template, count)))
                    for b in range(tile.shape[0])]
            ded, new_template, updated = (torch.stack(parts)
                                          for parts in zip(*outs))
        else:
            ded, new_template, updated = lane(tile, w_row, freqs, dm, ref,
                                              period, template, count)
        if compute_dtype == "bfloat16":
            ded = ded.to(torch.bfloat16)
        cell_mask = w_row == 0
        with stage("icln_residual_stats"):
            diags = cell_diagnostics_dedisp(ded, new_template, window,
                                            w_row, cell_mask)
        new_w, scores = scores_and_zap(diags, cell_mask, w_row,
                                       cfg.chanthresh, cfg.subintthresh)
        return new_w, scores, new_template, updated

    return step, device, dtype
