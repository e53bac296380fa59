"""Cleaning configuration of the port.

The reference-algorithm fields keep the reference package's names and
defaults.  The TPU route knobs (``stats_impl``, ``median_impl``,
``fft_mode``, ``fused_sweep``, ``compute_dtype``) have no counterpart: on
the port the device decides the route, and there is one route.  What the
port cannot run yet is refused here with ``NotImplementedError`` naming
the ROADMAP.md item that will bring it, never silently approximated.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

# ROADMAP.md "Modules still to port" items the refusals point at.
_ROADMAP_ROUTES = "ROADMAP.md 'Modules still to port' item 1 (other engine routes)"
_ROADMAP_BF16 = "ROADMAP.md 'Modules still to port' item 6 (mixed precision)"


@dataclasses.dataclass(frozen=True)
class CleanConfig:
    chanthresh: float = 5.0      # -c
    subintthresh: float = 5.0    # -s
    max_iter: int = 5            # -m
    # -r, stored as the reference consumes it: (scale, start, end)
    pulse_region: Tuple[float, float, float] = (0.0, 0.0, 1.0)
    bad_chan: float = 1.0        # --bad_chan
    bad_subint: float = 1.0      # --bad_subint
    rotation: str = "fourier"    # {"fourier", "roll"} dedispersion rotation
    baseline_duty: float = 0.15  # off-pulse window fraction
    baseline_mode: str = "integration"
    dtype: str = "float32"
    record_history: bool = False
    unload_res: bool = False     # -u (not ported yet: refused below)
    # torch device the clean runs on; "cuda" raises when no card is
    # present — the port never falls back to the CPU on its own
    device: str = "cuda"

    @property
    def pulse_region_active(self) -> bool:
        """The reference skips the window when -r is exactly (0, 0, 1)."""
        return tuple(self.pulse_region) != (0.0, 0.0, 1.0)

    def __post_init__(self) -> None:
        if self.rotation not in ("fourier", "roll"):
            raise ValueError(f"unknown rotation method {self.rotation!r}")
        if self.baseline_mode not in ("integration", "profile"):
            raise ValueError(f"unknown baseline mode {self.baseline_mode!r}")
        if self.max_iter < 1:
            raise ValueError("max_iter must be >= 1")
        if self.baseline_mode == "profile":
            raise NotImplementedError(
                f"baseline_mode='profile' is not ported yet: {_ROADMAP_ROUTES}")
        if self.pulse_region_active:
            raise NotImplementedError(
                f"an active pulse window (-r) is not ported yet: "
                f"{_ROADMAP_ROUTES}")
        if self.unload_res:
            raise NotImplementedError(
                f"unload_res (-u) is not ported yet: {_ROADMAP_ROUTES}")
        if self.dtype == "bfloat16":
            raise NotImplementedError(
                f"bfloat16 is not ported yet: {_ROADMAP_BF16}")
        if self.dtype != "float32":
            raise NotImplementedError(
                f"dtype={self.dtype!r}: the port runs float32 only (the "
                f"kernels' order-preserving keys are 32-bit): "
                f"{_ROADMAP_ROUTES}")


def refuse_dedispersed() -> None:
    """The refusal for a DEDISP=1 input (an archive property, so it is
    raised where the archive meets the engine, not by the config)."""
    raise NotImplementedError(
        f"already-dedispersed (DEDISP=1) inputs are not ported yet: "
        f"{_ROADMAP_ROUTES}")
