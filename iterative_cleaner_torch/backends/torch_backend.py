"""The PyTorch/CUDA backend: one upload of the cube, the preamble and the
iteration loop on the device, one download of the (nsub, nchan) results
(and of the residual cube with ``unload_res``).  The device set-up and
the uploads are shared with exact streaming
(:mod:`iterative_cleaner_torch.parallel.streaming_exact`)."""

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


def clean_device(config: CleanConfig) -> torch.device:
    """:func:`resolve_device` of ``config.device``, with TF32 switched
    off: the reference runs its products at full float32 precision, and
    TF32 would keep about 3 decimal digits.  Process-wide torch settings,
    set on every clean so no other code path can leave them on."""
    device = resolve_device(config.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return device


def upload(a, device) -> torch.Tensor:
    """A host array as a new float32 tensor on ``device``."""
    return torch.from_numpy(
        np.ascontiguousarray(a, dtype=np.float32)).to(device, copy=True)


def upload_meta(freqs_mhz, dm, ref_freq_mhz, period_s, device):
    """The archive's dispersion metadata as float32 device tensors, in
    the preamble's argument order."""
    f32 = torch.float32
    return (upload(freqs_mhz, device),
            torch.tensor(dm, dtype=f32, device=device),
            torch.tensor(ref_freq_mhz, dtype=f32, device=device),
            torch.tensor(period_s, dtype=f32, device=device))


def clean_cube(cube, orig_weights, freqs_mhz, dm, ref_freq_mhz, period_s,
               config: CleanConfig, *, dedispersed: bool = False
               ) -> CleanResult:
    """Clean a total-intensity (nsub, nchan, nbin) cube on
    ``config.device``.  ``dedispersed=True`` marks an already-dedispersed
    input (PSRFITS ``DEDISP=1``): the preamble skips only the forward
    rotation."""
    device = clean_device(config)
    weights_t = upload(orig_weights, device)
    # the uploaded cube is consumed by the preamble: it becomes
    # disp_clean (integration baseline) or ded (profile baseline, DEDISP=1)
    # where the route reads it, and is freed here otherwise
    prep = prepare(
        upload(cube, device), weights_t,
        *upload_meta(freqs_mhz, dm, ref_freq_mhz, period_s, device),
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
