"""Cleaning configuration of the port.

The reference-algorithm fields keep the reference package's names and
defaults.  The TPU route knobs (``stats_impl``, ``median_impl``,
``fft_mode``, ``fused_sweep``) have no counterpart: on the port the
device decides the kernels.  ``backend`` picks the torch engine (on
``device``, the default) or the float64 numpy oracle (``"numpy"``, the
reference's ``--backend numpy``; host only, whatever ``dtype`` and
``device`` say).  ``dtype="float64"`` runs the torch engine in float64,
the reference's oracle-parity mode (the float64 builds of the kernels on
the card).  ``compute_dtype`` is the reference's
mixed-precision mode: ``"bfloat16"`` stores the cube-sized operands in
bf16 after the float32 preamble and every stage still computes in
float32 (resolved, env mirror and parity probe included, by
:func:`iterative_cleaner_torch.backends.torch_backend.
resolve_compute_dtype`).  The route itself follows from
the algorithm fields and the archive, as in the reference
(``disp_iteration_enabled`` and the stats frame; see
:mod:`iterative_cleaner_torch.engine.loop`).  What the port cannot run
yet is refused here with ``NotImplementedError`` naming the ROADMAP.md
item that will bring it, never silently approximated.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# ROADMAP.md "Modules still to port" items the refusals point at.
ROADMAP_F64_MESH = ("ROADMAP.md 'Modules still to port' item 1b (float64 "
                    "on a mesh and in a batch)")
ROADMAP_FLEET_3B = ("ROADMAP.md 'Modules still to port' item 3b (--coordinator, "
                    "a ('batch',) mesh under the fleet, the hybrid batch-cell "
                    "mesh)")
ROADMAP_CONTROL_PLANE = ("ROADMAP.md 'Modules still to port' item 8 (the "
                         "control plane)")

BACKENDS = ("torch", "numpy")

DTYPES = ("float32", "float64")

COMPUTE_DTYPES = ("float32", "bfloat16")

MESH_MODES = ("off", "cell", "batch")

STATS_FRAMES = ("auto", "dispersed", "dedispersed")


def resolve_stats_frame(stats_frame: str) -> str:
    """``auto`` is the reference-exact dispersed frame (the reference
    package's ``resolve_stats_frame``); ``dedispersed`` is an explicit
    opt-in whose borderline cells may zap differently under the fourier
    rotation."""
    return "dispersed" if stats_frame == "auto" else stats_frame


@dataclasses.dataclass(frozen=True)
class CleanConfig:
    chanthresh: float = 5.0      # -c
    subintthresh: float = 5.0    # -s
    max_iter: int = 5            # -m
    # -r: the reference's help says (start, end, factor) but its code
    # uses [0] as the scale factor and [1], [2] as start/end; stored as
    # the code consumes it: (scale, start, end)
    pulse_region: Tuple[float, float, float] = (0.0, 0.0, 1.0)
    bad_chan: float = 1.0        # --bad_chan
    bad_subint: float = 1.0      # --bad_subint
    rotation: str = "fourier"    # {"fourier", "roll"} dedispersion rotation
    # frame of the detection statistics: "dispersed" (= "auto") re-rotates
    # the residual as the reference does; "dedispersed" skips that
    # rotation (one cube read per iteration, borderline cells may differ
    # under the fourier rotation)
    stats_frame: str = "auto"
    baseline_duty: float = 0.15  # off-pulse window fraction
    baseline_mode: str = "integration"  # or "profile"
    # "torch": the engine on `device`; "numpy": the float64 oracle (host)
    backend: str = "torch"
    # the engine's storage and arithmetic: "float32" or "float64" (the
    # oracle-parity mode)
    dtype: str = "float32"
    # mixed-precision storage: "bfloat16" keeps the cube-sized operands
    # in bf16 on the device (and exact streaming's host store and
    # uploads) while every sum, select and threshold stays float32;
    # None defers to ICLEAN_COMPUTE_DTYPE, then "float32"
    compute_dtype: Optional[str] = None
    record_history: bool = False
    unload_res: bool = False     # -u: also return the pulse-free residual
    # torch device the clean runs on; "cuda" raises when no card is
    # present — the port never falls back to the CPU on its own
    device: str = "cuda"
    # device byte budget (MiB) of exact streaming's tile cache
    # (parallel/tile_cache.py); None takes a card-sized default; 0 pins
    # nothing (an archive larger than the card: every pass re-streams
    # its tiles)
    stream_hbm_mb: Optional[float] = None
    # fleet scheduler (parallel/fleet.py): the reference's (nsub_step,
    # nchan_step) grid that merges near-miss geometries into one padded
    # bucket.  Validated and accepted for the reference CLI's sake; the
    # port pads nothing and buckets by exact shape, so it changes no
    # bucket, group or launch
    fleet_bucket_pad: Tuple[int, int] = (0, 0)
    # largest batch one fleet group cleans at (--batch B with --fleet)
    fleet_group_size: int = 8
    # per-stage retry budget of the fleet's resilience ladder; None
    # defers to ICLEAN_RETRIES, then 2
    fleet_retries: Optional[int] = None
    # per-stage watchdog deadline (s) of fleet stage attempts; None
    # defers to ICLEAN_STAGE_TIMEOUT, then off; 0 means off
    stage_timeout_s: Optional[float] = None
    # multi-host fleet: how many hosts share the fleet through one
    # journal and which one this process is; None defers to
    # ICLEAN_HOSTS / ICLEAN_HOST_ID, then one host
    fleet_hosts: Optional[int] = None
    fleet_host_id: Optional[int] = None
    # claim-lease duration (s) of a multi-host bucket; None defers to
    # ICLEAN_CLAIM_TTL, then 60
    fleet_claim_ttl_s: Optional[float] = None
    # directory the CUDA kernel library is built into and loaded from
    # (stats/kernels.py); None defers to ICLEAN_COMPILE_CACHE, then the
    # package's _build/
    compile_cache_dir: Optional[str] = None
    # online mode (online/session.py): mid-stream reconciliation period in
    # subints; None defers to ICLEAN_STREAM_RECONCILE_EVERY, then 8; 0
    # reconciles only at close (the close reconcile always runs, so
    # neither online knob can change a closed stream's final mask)
    stream_reconcile_every: Optional[int] = None
    # EW running-template weight of the online per-subint step
    # (online/ewt.py): T_n = (1-alpha) T_{n-1} + alpha p_n; None defers
    # to ICLEAN_STREAM_EW_ALPHA, then 0.2
    stream_ew_alpha: Optional[float] = None
    # a live stream's quality monitor (telemetry/quality.py): the
    # trailing window (subints) and the zap-fraction departure from its
    # median that raises quality_drift_alerts{stream=}; None defers to
    # ICLEAN_QUALITY_WINDOW / ICLEAN_QUALITY_DRIFT, then 16 / 0.15.
    # Observers of host copies: they never change a mask
    quality_window: Optional[int] = None
    quality_drift: Optional[float] = None

    @property
    def pulse_region_active(self) -> bool:
        """The reference skips the window when -r is exactly (0, 0, 1)."""
        return tuple(self.pulse_region) != (0.0, 0.0, 1.0)

    @property
    def pulse_slice(self) -> Tuple[int, int]:
        """(start, end) bins of the scaled window: ``pulse_region[1:3]``."""
        return int(self.pulse_region[1]), int(self.pulse_region[2])

    @property
    def pulse_scale(self) -> float:
        """The window's scale factor: ``pulse_region[0]``."""
        return float(self.pulse_region[0])

    def __post_init__(self) -> None:
        if self.rotation not in ("fourier", "roll"):
            raise ValueError(f"unknown rotation method {self.rotation!r}")
        if self.baseline_mode not in ("integration", "profile"):
            raise ValueError(f"unknown baseline mode {self.baseline_mode!r}")
        if self.stats_frame not in STATS_FRAMES:
            raise ValueError(f"unknown stats frame {self.stats_frame!r}")
        if self.max_iter < 1:
            raise ValueError("max_iter must be >= 1")
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.stream_hbm_mb is not None and self.stream_hbm_mb < 0:
            raise ValueError(
                f"stream_hbm_mb must be >= 0 (0 disables the stream tile "
                f"cache), got {self.stream_hbm_mb}")
        if self.stream_reconcile_every is not None \
                and self.stream_reconcile_every < 0:
            raise ValueError(
                f"stream_reconcile_every must be >= 0 (0 = reconcile only "
                f"at close), got {self.stream_reconcile_every}")
        if self.stream_ew_alpha is not None \
                and not 0 < self.stream_ew_alpha <= 1:
            raise ValueError(
                f"stream_ew_alpha must be in (0, 1], got "
                f"{self.stream_ew_alpha}")
        if self.quality_window is not None and self.quality_window < 2:
            raise ValueError(
                f"quality_window must be >= 2 (a drift baseline needs at "
                f"least two subints), got {self.quality_window}")
        if self.quality_drift is not None and self.quality_drift <= 0:
            raise ValueError(
                f"quality_drift must be > 0, got {self.quality_drift}")
        if self.compute_dtype is not None \
                and self.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(
                f"unknown compute dtype {self.compute_dtype!r} (choose "
                f"'float32' or 'bfloat16')")
        if self.compute_dtype == "bfloat16" and self.dtype != "float32":
            raise ValueError(
                "compute_dtype='bfloat16' requires dtype='float32' (the "
                "bf16 storage mode upcasts into float32 arithmetic)")
        if self.dtype == "bfloat16":
            # the reference accepts the field and its clean then raises
            # ValueError (its rFFT takes float32 or float64); the port
            # says so up front
            raise ValueError(
                "dtype='bfloat16' runs no clean (arithmetic in bf16 is "
                "not offered): use dtype='float32' with "
                "compute_dtype='bfloat16' for bf16 cube storage")
        if self.dtype not in DTYPES:
            raise ValueError(f"unknown dtype {self.dtype!r} (choose "
                             f"'float32' or 'float64')")
        if (len(tuple(self.fleet_bucket_pad)) != 2
                or any(int(v) < 0 for v in self.fleet_bucket_pad)):
            raise ValueError(
                f"fleet_bucket_pad must be two non-negative grid steps "
                f"(nsub, nchan; 0 = no quantization on that axis), got "
                f"{self.fleet_bucket_pad!r}")
        if self.fleet_group_size < 1:
            raise ValueError(
                f"fleet_group_size must be >= 1, got {self.fleet_group_size}")
        if self.fleet_retries is not None and self.fleet_retries < 0:
            raise ValueError(
                f"fleet_retries must be >= 0, got {self.fleet_retries}")
        if self.stage_timeout_s is not None and self.stage_timeout_s < 0:
            raise ValueError(
                f"stage_timeout_s must be >= 0 (0/None disables the "
                f"watchdog), got {self.stage_timeout_s}")
        if self.fleet_hosts is not None and self.fleet_hosts < 1:
            raise ValueError(
                f"fleet_hosts must be >= 1, got {self.fleet_hosts}")
        if self.fleet_host_id is not None:
            if self.fleet_hosts is None:
                raise ValueError(
                    "fleet_host_id without fleet_hosts: a host index is "
                    "meaningless without the host count")
            if not 0 <= self.fleet_host_id < self.fleet_hosts:
                raise ValueError(
                    f"fleet_host_id must be in [0, {self.fleet_hosts}), "
                    f"got {self.fleet_host_id}")
        if self.fleet_claim_ttl_s is not None and self.fleet_claim_ttl_s <= 0:
            raise ValueError(
                f"fleet_claim_ttl_s must be > 0, got {self.fleet_claim_ttl_s}")


def check_mesh(mesh: str, config: CleanConfig) -> None:
    """Refuse what the multi-GPU clean does not run: on a mesh, the
    outputs that are not gathered across ranks (``unload_res``,
    ``record_history``) and the numpy oracle (``ValueError``, as in the
    reference); float64 (``NotImplementedError``, item 1b).
    ``mesh='cell'`` runs every route, whole or streamed in subint tiles;
    ``mesh='batch'`` splits a batch of archives over the ranks
    (``parallel/batch.py``)."""
    if mesh not in MESH_MODES:
        raise ValueError(f"unknown mesh {mesh!r}")
    if mesh == "off":
        return
    if config.backend != "torch":
        raise ValueError("a mesh requires the torch backend")
    if config.unload_res or config.record_history:
        raise ValueError(
            "unload_res/record_history are not supported on the sharded "
            "path (residual cubes and weight histories are not gathered); "
            "clean unsharded for those outputs")
    check_float64_mesh(config, f"mesh={mesh!r}")


def check_float64_mesh(config: CleanConfig, what: str) -> None:
    """Refuse ``dtype='float64'`` where it would need K10's float64 build
    or 64-bit sharded selects: on a mesh and in a batch."""
    if config.dtype == "float64":
        raise NotImplementedError(
            f"dtype='float64' with {what}: {ROADMAP_F64_MESH}")
