"""The PyTorch/CUDA backend: one upload of the cube, the preamble and the
iteration loop on the device, one download of the (nsub, nchan) results
(and of the residual cube with ``unload_res``).  The device set-up and
the uploads are shared with exact streaming
(:mod:`iterative_cleaner_torch.parallel.streaming_exact`).

It also resolves the mixed-precision knob (:func:`resolve_compute_dtype`,
the reference's ``backends/jax_backend.py`` ladder: the env mirror, the
once-per-process parity probe, the per-stage downgrade to float32 and
its ``compute_dtype_ineligible{stage=,reason=}`` counter)."""

from __future__ import annotations

import os
import sys
import threading

import numpy as np
import torch

from iterative_cleaner_torch.backends.base import CleanResult
from iterative_cleaner_torch.config import COMPUTE_DTYPES, CleanConfig
from iterative_cleaner_torch.engine.loop import (
    Prepared,
    clean_loop,
    prepare_stored,
    store_prepared,
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


# --- mixed-precision resolution (compute_dtype) ----------------------------
#
# The probe's verdict (per device type) and the per-(stage, reason)
# downgrade counts live at module scope: the probe runs once per process
# (tests monkeypatch the cache), and the counts outlive callers that have
# no telemetry registry while folding into one where the CLI has it.
_COMPUTE_DTYPE_PROBE_CACHE: dict = {}
_COMPUTE_DTYPE_LOCK = threading.Lock()
_COMPUTE_DTYPE_COUNTS: dict = {}
_COMPUTE_DTYPE_NOTICED: set = set()


def bf16_exact_micro_cube():
    """The parity probe's cube (the reference's): 4 x 8 x 32 normal
    samples from seed 7 with two RFI spikes, rounded to the bf16 grid, as
    float32."""
    rng = np.random.default_rng(7)
    cube = rng.normal(0.0, 1.0, (4, 8, 32)).astype(np.float32)
    cube[1, 2] += 40.0
    cube[3, 5, :8] += 60.0
    return torch.from_numpy(cube).to(torch.bfloat16).float()


def _compute_dtype_probe_ok(device) -> bool:
    """The parity self-probe: clean :func:`bf16_exact_micro_cube` through
    the port's engine on ``device`` under float32 and under bf16 storage
    and compare the masks bit for bit, on each route (so on the card the
    bf16 builds of K1, K2, K7 and K6 themselves).  As the reference's
    probe, the cube is fed as prepared (zero shifts, ``roll``, no
    baseline): bf16 storage is then lossless by construction, and any
    mask difference is the arithmetic's."""
    cube = bf16_exact_micro_cube().to(device)
    nsub, nchan, nbin = cube.shape
    weights = torch.ones((nsub, nchan), dtype=torch.float32, device=device)
    zeros = torch.zeros((nchan,), dtype=torch.float32, device=device)
    ones = torch.ones((nbin,), dtype=torch.float32, device=device)
    offsets = torch.zeros((nsub, nchan), dtype=torch.float32, device=device)
    routes = (Prepared("default", zeros, None, cube, cube, offsets, None),
              Prepared("two_read", zeros, cube, cube, None, None, None),
              Prepared("dedispersed", zeros, cube, None, None, None, ones))
    for prep in routes:
        masks = [clean_loop(store_prepared(prep, cd), weights, max_iter=2,
                            chanthresh=5.0, subintthresh=5.0,
                            rotation="roll", baseline_duty=0.15
                            ).final_weights.cpu()
                 for cd in COMPUTE_DTYPES]
        if not torch.equal(masks[0], masks[1]):
            return False
    return True


def _compute_dtype_downgrade(stage: str, reason: str, registry=None) -> str:
    """One rung of the degradation ladder: count the downgrade (module
    counter, and ``registry`` where given), print the one-line notice once
    per (stage, reason) per process, return ``'float32'``."""
    from iterative_cleaner_torch.telemetry.registry import labeled

    key = labeled("compute_dtype_ineligible", stage=stage, reason=reason)
    with _COMPUTE_DTYPE_LOCK:
        _COMPUTE_DTYPE_COUNTS[key] = _COMPUTE_DTYPE_COUNTS.get(key, 0) + 1
        first = (stage, reason) not in _COMPUTE_DTYPE_NOTICED
        _COMPUTE_DTYPE_NOTICED.add((stage, reason))
    if registry is not None:
        registry.counter_inc(key)
    if first:
        print("compute_dtype=bfloat16 ineligible at stage '%s' (%s): "
              "staying in float32 (masks unchanged, full-width cube "
              "traffic)" % (stage, reason), file=sys.stderr)
    return "float32"


def compute_dtype_ineligible_counts() -> dict:
    """The process's ``compute_dtype_ineligible{...}`` counters (labeled
    key -> count): the CLI folds them into its run report, tests and
    ``chip_smoke.py`` read them."""
    with _COMPUTE_DTYPE_LOCK:
        return dict(_COMPUTE_DTYPE_COUNTS)


def resolve_compute_dtype(compute_dtype, dtype="float32", *,
                          stage: str = "engine", registry=None,
                          device="cpu") -> str:
    """The mixed-precision knob resolved to ``'float32'`` or
    ``'bfloat16'``.

    ``None`` defers to the ``ICLEAN_COMPUTE_DTYPE`` environment variable,
    then ``'float32'``.  ``'bfloat16'`` is a request: two rungs of the
    degradation ladder downgrade this ``stage`` to float32 with a notice
    and a ``compute_dtype_ineligible{stage=,reason=}`` count, never an
    error:

    * ``reason=dtype``: the pipeline ``dtype`` is not float32;
    * ``reason=parity_probe``: :func:`_compute_dtype_probe_ok`, run once
      per process and device type on ``device``, found the bf16 masks
      differing from the float32 ones on a bf16-exact cube."""
    if compute_dtype is None:
        compute_dtype = os.environ.get("ICLEAN_COMPUTE_DTYPE", "") \
            or "float32"
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(
            f"unknown compute dtype {compute_dtype!r} (choose 'float32' "
            f"or 'bfloat16')")
    if compute_dtype == "float32":
        return "float32"
    if str(dtype).replace("torch.", "") != "float32":
        return _compute_dtype_downgrade(stage, "dtype", registry)
    kind = torch.device(device).type
    with _COMPUTE_DTYPE_LOCK:
        ok = _COMPUTE_DTYPE_PROBE_CACHE.get(kind)
    if ok is None:
        ok = _compute_dtype_probe_ok(device)
        with _COMPUTE_DTYPE_LOCK:
            _COMPUTE_DTYPE_PROBE_CACHE.setdefault(kind, ok)
    if not ok:
        return _compute_dtype_downgrade(stage, "parity_probe", registry)
    return "bfloat16"


def config_compute_dtype(config: CleanConfig, stage: str, device,
                         registry=None) -> str:
    """:func:`resolve_compute_dtype` of ``config`` on ``device``."""
    return resolve_compute_dtype(config.compute_dtype, config.dtype,
                                 stage=stage, registry=registry,
                                 device=device)


def engine_dtype(config: CleanConfig) -> torch.dtype:
    """The torch dtype the engine stores and computes in:
    ``config.dtype`` (float32, or float64 in the oracle-parity mode)."""
    return torch.float64 if config.dtype == "float64" else torch.float32


def upload(a, device, dtype=torch.float32) -> torch.Tensor:
    """A host array as a new tensor of ``dtype`` (float32 or float64)
    on ``device``."""
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    return torch.from_numpy(
        np.ascontiguousarray(a, dtype=np_dtype)).to(device, copy=True)


def upload_meta(freqs_mhz, dm, ref_freq_mhz, period_s, device,
                dtype=torch.float32):
    """The archive's dispersion metadata as device tensors of ``dtype``,
    in the preamble's argument order."""
    return (upload(freqs_mhz, device, dtype),
            torch.tensor(dm, dtype=dtype, device=device),
            torch.tensor(ref_freq_mhz, dtype=dtype, device=device),
            torch.tensor(period_s, dtype=dtype, device=device))


def clean_cube(cube, orig_weights, freqs_mhz, dm, ref_freq_mhz, period_s,
               config: CleanConfig, *, dedispersed: bool = False,
               registry=None) -> CleanResult:
    """Clean a total-intensity (nsub, nchan, nbin) cube on
    ``config.device``.  ``dedispersed=True`` marks an already-dedispersed
    input (PSRFITS ``DEDISP=1``): the preamble skips only the forward
    rotation.  Under ``compute_dtype='bfloat16'`` the route's cubes are
    stored bf16 after the float32 preamble, which then uploads and
    prepares the cube a piece of subints at a time (a downgrade counted in
    ``registry`` where given).  Under ``dtype='float64'`` every upload,
    cube, plane and score is float64 and the kernels' float64 builds run
    (``iter_metrics`` stays float32, as in the reference)."""
    device = clean_device(config)
    compute_dtype = config_compute_dtype(config, "engine", device, registry)
    dtype = engine_dtype(config)
    weights_t = upload(orig_weights, device, dtype)
    # each upload is consumed by the preamble: it becomes disp_clean
    # (integration baseline) or ded (profile baseline, DEDISP=1) where the
    # route reads it, and is freed here otherwise (or, in bf16 storage,
    # once narrowed)
    prep = prepare_stored(
        lambda sl: upload(cube[sl], device, dtype), cube.shape, weights_t,
        *upload_meta(freqs_mhz, dm, ref_freq_mhz, period_s, device, dtype),
        config, dedispersed=dedispersed, compute_dtype=compute_dtype)
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
