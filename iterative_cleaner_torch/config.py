"""Cleaning configuration of the port.

The reference-algorithm fields keep the reference package's names and
defaults.  The TPU route knobs (``stats_impl``, ``median_impl``,
``fft_mode``, ``fused_sweep``, ``compute_dtype``) have no counterpart: on
the port the device decides the kernels.  The route itself follows from
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
_ROADMAP_F64 = "ROADMAP.md 'Modules still to port' item 1 (float64)"
_ROADMAP_BF16 = "ROADMAP.md 'Modules still to port' item 6 (mixed precision)"
_ROADMAP_BATCH = "ROADMAP.md 'Modules still to port' item 3 (batch and fleet)"
ROADMAP_MESH = "ROADMAP.md 'Modules still to port' item 7 (multi-GPU)"

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
    dtype: str = "float32"
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
        if self.stream_hbm_mb is not None and self.stream_hbm_mb < 0:
            raise ValueError(
                f"stream_hbm_mb must be >= 0 (0 disables the stream tile "
                f"cache), got {self.stream_hbm_mb}")
        if self.dtype == "bfloat16":
            raise NotImplementedError(
                f"bfloat16 is not ported yet: {_ROADMAP_BF16}")
        if self.dtype != "float32":
            raise NotImplementedError(
                f"dtype={self.dtype!r}: the port runs float32 only (the "
                f"kernels' order-preserving keys are 32-bit): "
                f"{_ROADMAP_F64}")


def check_mesh(mesh: str, config: CleanConfig, *, dedispersed: bool = False,
               streaming: bool = False) -> None:
    """Refuse, with ``NotImplementedError`` naming its ROADMAP.md item,
    what the multi-GPU clean does not run yet: ``mesh='batch'``, the
    cell-sharded clean in subint tiles (the reference's streamed shard
    path), and the cell-sharded two_read route (the dispersed frame under
    the profile baseline, a pulse window or a DEDISP=1 input; the
    reference runs it through K7 per shard and
    ``sharded_scale_and_combine``).  ``mesh='cell'`` runs the default
    route and the dedispersed frame."""
    if mesh not in MESH_MODES:
        raise ValueError(f"unknown mesh {mesh!r}")
    if mesh == "batch":
        raise NotImplementedError(
            f"--mesh batch is not ported yet: {_ROADMAP_BATCH}")
    if mesh == "off":
        return
    if streaming:
        raise NotImplementedError(
            f"the cell-sharded clean in subint tiles (--mesh cell with "
            f"--stream) is not ported yet: {ROADMAP_MESH}")
    if resolve_stats_frame(config.stats_frame) == "dispersed" and (
            config.baseline_mode != "integration"
            or config.pulse_region_active or dedispersed):
        raise NotImplementedError(
            f"the cell-sharded two_read route (the dispersed frame with "
            f"the profile baseline, a pulse window or a DEDISP=1 input) "
            f"is not ported yet: {ROADMAP_MESH}")
