"""The PyTorch/CUDA backend: one upload of the cube, the preamble and the
iteration loop on the device, one download of the (nsub, nchan) results
(and of the residual cube with ``unload_res``)."""

from __future__ import annotations

import numpy as np
import torch

from iterative_cleaner_torch.backends.base import CleanResult
from iterative_cleaner_torch.config import CleanConfig
from iterative_cleaner_torch.engine.loop import (
    clean_loop,
    prepare,
    unload_residual,
)


def resolve_device(name: str) -> torch.device:
    """The torch device a clean runs on.  A CUDA request without a CUDA
    device raises: the port never falls back to the CPU on its own."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but no CUDA device is present; "
            f"pass device='cpu' to run the plain PyTorch versions")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r}")
    return device


def clean_cube(cube, orig_weights, freqs_mhz, dm, ref_freq_mhz, period_s,
               config: CleanConfig, *, dedispersed: bool = False
               ) -> CleanResult:
    """Clean a total-intensity (nsub, nchan, nbin) cube on
    ``config.device``.  ``dedispersed=True`` marks an already-dedispersed
    input (PSRFITS ``DEDISP=1``): the preamble skips only the forward
    rotation."""
    device = resolve_device(config.device)
    # The reference runs its products at full float32 precision; TF32
    # would keep ~3 decimal digits.  Process-wide torch settings, set on
    # every clean so no other code path can leave them on.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    f32 = torch.float32

    def upload(a):
        return torch.from_numpy(
            np.ascontiguousarray(a, dtype=np.float32)).to(device, copy=True)

    weights_t = upload(orig_weights)
    # the uploaded cube is consumed by the preamble: it becomes
    # disp_clean (integration baseline) or ded (profile baseline, DEDISP=1)
    # where the route reads it, and is freed here otherwise
    prep = prepare(
        upload(cube), weights_t, upload(freqs_mhz),
        torch.tensor(dm, dtype=f32, device=device),
        torch.tensor(ref_freq_mhz, dtype=f32, device=device),
        torch.tensor(period_s, dtype=f32, device=device),
        config, dedispersed=dedispersed)
    outs = clean_loop(
        prep, weights_t, max_iter=config.max_iter,
        chanthresh=config.chanthresh, subintthresh=config.subintthresh,
        rotation=config.rotation, baseline_duty=config.baseline_duty)
    residual = None
    if config.unload_res:
        residual = unload_residual(
            prep, outs.template_weights, rotation=config.rotation,
            baseline_duty=config.baseline_duty,
            pulse_slice=config.pulse_slice, pulse_scale=config.pulse_scale,
            pulse_active=config.pulse_region_active).cpu().numpy()
    loops = outs.loops
    history = None
    if config.record_history:
        history = outs.history[: outs.history_count].cpu().numpy()
    return CleanResult(
        final_weights=outs.final_weights.cpu().numpy(),
        scores=outs.scores.cpu().numpy(),
        loops=loops,
        converged=outs.converged,
        residual=residual,
        loop_diffs=outs.loop_diffs[:loops].cpu().numpy(),
        loop_rfi_frac=outs.loop_rfi_frac[:loops].cpu().numpy(),
        weight_history=history,
        iter_metrics=outs.iter_metrics[:loops].cpu().numpy(),
    )
