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
import os
from typing import Optional, Tuple

# ROADMAP.md "Modules still to port" items the refusals point at.
ROADMAP_F64_MESH = ("ROADMAP.md 'Modules still to port' item 1b (float64 "
                    "on a mesh and in a batch)")
ROADMAP_FLEET_3B = ("ROADMAP.md 'Modules still to port' item 3b (--coordinator, "
                    "a ('batch',) mesh under the fleet, the hybrid batch-cell "
                    "mesh)")

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


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """The service daemon's knobs (``--serve``; ``serve/`` package).  The
    device its requests clean on is its base :class:`CleanConfig`'s
    (``device="cuda"`` by default: a daemon with no card raises at
    start, it never cleans on the host by itself).

    Deliberately a SEPARATE record from :class:`CleanConfig`: none of
    these change any archive's mask, so they must stay out of the
    checkpoint/journal config identity — a request served under a
    different queue bound still matches its journal entries.  The CLI
    builds one from the ``--spool``/``--http-port``/``--max-inflight``
    (and elastic ``--join``/``--member-ttl``/``--result-cache``) flags;
    the env mirrors (``ICLEAN_SPOOL``, ``ICLEAN_HTTP_PORT``,
    ``ICLEAN_MAX_INFLIGHT``, ``ICLEAN_SERVE_QUEUE``, ``ICLEAN_JOIN``,
    ``ICLEAN_MEMBER_TTL``, ``ICLEAN_RESULT_CACHE``) cover container
    deployments where flags are awkward (explicit flags win).
    """

    # watched spool directory: drop `<request>.json` files here to submit
    # (claimed files are renamed, so a submission is ingested exactly once);
    # None disables the spool intake
    spool_dir: Optional[str] = None
    # HTTP/JSON intake + live /healthz + /metrics on 127.0.0.1:<port>;
    # 0 binds an ephemeral port (printed at startup), None disables HTTP
    http_port: Optional[int] = None
    # admission control: max requests one tenant may have admitted but not
    # yet finished (queued + running); the 429/REJECTED backpressure bound
    max_inflight: int = 8
    # global bound on the scheduler's queue across all tenants
    queue_limit: int = 64
    # spool scan / idle loop period (seconds)
    poll_s: float = 0.2
    # request lifecycle + per-archive completion journal (crash-safe
    # restart state); relative paths resolve against the daemon's cwd
    journal_path: str = "serve.journal.jsonl"
    # growth bounds for a long-lived process: compact the journal when it
    # exceeds journal_max_mb, trim clean.log beyond log_max_mb
    journal_max_mb: float = 16.0
    log_max_mb: float = 16.0
    # segmented journal (``--journal DIR``): seal a shard's active
    # segment once it reaches this size (``--journal-segment-mb`` /
    # ``ICLEAN_JOURNAL_SEGMENT_MB``); None = backend default (4 MB).
    # Ignored by the single-file backend.
    journal_segment_mb: Optional[float] = None
    # Perfetto/Chrome trace_events export path: every finished span also
    # spools to `<trace_out>.spans.jsonl` and the daemon renders the full
    # trace file at shutdown; None disables the export (spans still live
    # in the bounded in-memory store behind GET /trace/<id>)
    trace_out: Optional[str] = None
    # crash flight-recorder dump path (written on watchdog trips,
    # unhandled daemon exceptions, SIGQUIT and second-signal force-exit);
    # ON by default for a long-lived daemon — "" disables
    flight_recorder: str = "serve.flight.json"
    # elastic pool membership (``--join`` / ``ICLEAN_JOIN``): announce
    # this daemon in the shared journal, adopt journaled requests from
    # other members, evict members whose heartbeat lapses and steal
    # their claimed requests.  Requires every member to share one
    # journal_path (and usually one spool) on common storage.
    join: bool = False
    # membership + request-claim lease duration: a SIGKILLed member's
    # requests become stealable this many seconds after its last
    # heartbeat (``--member-ttl`` / ``ICLEAN_MEMBER_TTL``)
    member_ttl_s: float = 15.0
    # content-addressed result cache (``--result-cache`` /
    # ``ICLEAN_RESULT_CACHE``): serve repeat archive+config submissions
    # from journaled 'cache' lines with zero device work (entries are
    # signature-verified before reuse; failures fall through to a clean)
    result_cache: bool = False
    # torch.profiler capture directory for POST /profile, which also turns
    # on the profiler's first-call peak measurements of the bucket, online
    # and mux programs (``--profile-dir`` / ``ICLEAN_PROFILE_DIR``); None
    # disables on-demand trace capture
    profile_dir: Optional[str] = None
    # stream multiplexing (``--mux`` / ``ICLEAN_MUX``): route every
    # kind:"stream" request through one shared StreamMux so concurrent
    # streams' subints batch into one device dispatch per tick
    # (online/mux.py); per-stream masks stay bit-equal with the
    # per-request sessions this replaces, so — like every knob here —
    # it must stay out of the config identity
    mux: bool = False
    # mux latency SLO: a pending subint never waits longer than this
    # before its bucket dispatches a partial batch (``--mux-max-wait-ms``
    # / ``ICLEAN_MUX_MAX_WAIT_MS``; None = online/mux.py default)
    mux_max_wait_ms: Optional[float] = None
    # largest batched dispatch (``--mux-max-batch`` /
    # ``ICLEAN_MUX_MAX_BATCH``; None = online/mux.py default)
    mux_max_batch: Optional[int] = None

    @classmethod
    def from_env(cls, **overrides) -> "ServeConfig":
        """Resolve the env mirrors, explicit ``overrides`` winning."""
        def env(name, cast, default):
            raw = os.environ.get(name, "")
            return cast(raw) if raw else default

        def flag(raw):
            return str(raw).strip().lower() in ("1", "true", "yes", "on")

        fields = {
            "spool_dir": env("ICLEAN_SPOOL", str, None),
            "http_port": env("ICLEAN_HTTP_PORT", int, None),
            "max_inflight": env("ICLEAN_MAX_INFLIGHT", int, 8),
            "queue_limit": env("ICLEAN_SERVE_QUEUE", int, 64),
            "trace_out": env("ICLEAN_TRACE_OUT", str, None),
            "join": env("ICLEAN_JOIN", flag, False),
            "journal_segment_mb": env("ICLEAN_JOURNAL_SEGMENT_MB",
                                      float, None),
            "member_ttl_s": env("ICLEAN_MEMBER_TTL", float, 15.0),
            "result_cache": env("ICLEAN_RESULT_CACHE", flag, False),
            "profile_dir": env("ICLEAN_PROFILE_DIR", str, None),
            "mux": env("ICLEAN_MUX", flag, False),
            "mux_max_wait_ms": env("ICLEAN_MUX_MAX_WAIT_MS", float, None),
            "mux_max_batch": env("ICLEAN_MUX_MAX_BATCH", int, None),
        }
        # "" is a meaningful override here (recorder OFF), so resolve it
        # outside the none-filtered update below
        fields["flight_recorder"] = os.environ.get(
            "ICLEAN_FLIGHT_RECORDER", "serve.flight.json")
        if "flight_recorder" in overrides \
                and overrides["flight_recorder"] is not None:
            fields["flight_recorder"] = overrides["flight_recorder"]
        overrides = {k: v for k, v in overrides.items()
                     if k != "flight_recorder"}
        fields.update({k: v for k, v in overrides.items() if v is not None})
        return cls(**fields)

    def __post_init__(self) -> None:
        if self.spool_dir is None and self.http_port is None:
            raise ValueError(
                "serve needs at least one intake: a spool directory "
                "and/or an HTTP port")
        if self.http_port is not None and not 0 <= self.http_port <= 65535:
            raise ValueError(
                f"http_port must be in [0, 65535] (0 = ephemeral), got "
                f"{self.http_port}")
        if self.max_inflight < 1:
            raise ValueError(
                f"max_inflight must be >= 1, got {self.max_inflight}")
        if self.queue_limit < 1:
            raise ValueError(
                f"queue_limit must be >= 1, got {self.queue_limit}")
        if self.poll_s <= 0:
            raise ValueError(f"poll_s must be > 0, got {self.poll_s}")
        if not self.journal_path:
            raise ValueError("serve requires a journal path (the "
                             "crash-safe queue state lives there)")
        if self.journal_max_mb <= 0 or self.log_max_mb <= 0:
            raise ValueError("journal_max_mb/log_max_mb must be > 0")
        if self.journal_segment_mb is not None \
                and self.journal_segment_mb <= 0:
            raise ValueError(
                f"journal_segment_mb must be > 0 (the segmented "
                f"backend's seal threshold), got {self.journal_segment_mb}")
        if self.member_ttl_s <= 0:
            raise ValueError(
                f"member_ttl_s must be > 0 (the membership lease "
                f"duration), got {self.member_ttl_s}")
        if self.mux_max_wait_ms is not None and self.mux_max_wait_ms < 0:
            raise ValueError(
                f"mux_max_wait_ms must be >= 0, got {self.mux_max_wait_ms}")
        if self.mux_max_batch is not None and self.mux_max_batch < 1:
            raise ValueError(
                f"mux_max_batch must be >= 1, got {self.mux_max_batch}")
