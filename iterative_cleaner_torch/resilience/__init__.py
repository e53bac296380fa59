"""Fleet resilience: fault injection, retries, watchdogs, journaled resume.

The port's counterpart of ``iterative_cleaner_tpu/resilience/``, with
its public names and semantics.  Four pieces, composed by
:func:`iterative_cleaner_torch.parallel.fleet.clean_fleet` through one
:class:`ResiliencePlan`:

- :mod:`~iterative_cleaner_torch.resilience.faults` — a deterministic
  seed+spec fault injector (``--faults`` / ``ICLEAN_FAULTS``) raising at
  the named pipeline sites, including a synthetic ``RESOURCE_EXHAUSTED``
  that takes a real ``torch.OutOfMemoryError``'s route, so every
  recovery path drills on the CPU;
- :mod:`~iterative_cleaner_torch.resilience.retry` — transient/permanent/
  OOM error classification, bounded deterministic backoff, and per-stage
  watchdog deadlines (a hung stage fails its archive instead of wedging
  the run);
- the execute path's OOM ladder (in the fleet module): batch-halving
  down to singletons; a singleton that still exhausts the device fails
  with its OOM error (the port moves no clean off the device);
- :mod:`~iterative_cleaner_torch.resilience.journal` — a crash-safe
  JSON-lines completion journal keyed by checkpoint fingerprints,
  backing ``--resume`` with zero duplicated cleans after a ``kill -9``
  (the reference's line format: each package reads the other's files).

Recovery telemetry lands in the shared registry: ``fleet_retries``,
``fleet_oom_splits``, ``fleet_watchdog_trips``, ``fleet_resumed_skips``,
``fleet_callback_errors``, ``fault_injected``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

from iterative_cleaner_torch.resilience.faults import (  # noqa: F401
    FaultInjector,
    FaultSpecError,
    InjectedFault,
    InjectedPermanentFault,
    SyntheticResourceExhausted,
    parse_fault_spec,
)
from iterative_cleaner_torch.resilience.journal import (  # noqa: F401
    CLAIM_STATES,
    MEMBER_STATES,
    REQUEST_TERMINAL,
    FleetJournal,
    SingleFileLog,
    entry_is_current,
    entry_key,
)
from iterative_cleaner_torch.resilience.segmented import (  # noqa: F401
    SegmentedLog,
)
from iterative_cleaner_torch.resilience.retry import (  # noqa: F401
    OOM,
    PERMANENT,
    TIMEOUT,
    TRANSIENT,
    RetryPolicy,
    StageTimeout,
    call_with_deadline,
    classify_error,
    run_with_retries,
)

ENV_RETRIES = "ICLEAN_RETRIES"
ENV_STAGE_TIMEOUT = "ICLEAN_STAGE_TIMEOUT"


def resolve_retries(value: Optional[int] = None) -> int:
    """Per-stage retry budget: explicit value, else ``ICLEAN_RETRIES``,
    else 2."""
    if value is None:
        env = os.environ.get(ENV_RETRIES, "")
        value = int(env) if env else 2
    value = int(value)
    if value < 0:
        raise ValueError(f"retries must be >= 0, got {value}")
    return value


def resolve_stage_timeout(value: Optional[float] = None) -> Optional[float]:
    """Per-stage watchdog deadline in seconds: explicit value, else
    ``ICLEAN_STAGE_TIMEOUT``, else None (watchdog off); 0 means off."""
    if value is None:
        env = os.environ.get(ENV_STAGE_TIMEOUT, "")
        value = float(env) if env else None
    if value is not None:
        value = float(value)
        if value < 0:
            raise ValueError(f"stage timeout must be >= 0, got {value}")
        if value == 0:
            value = None
    return value


@dataclasses.dataclass
class ResiliencePlan:
    """Everything :func:`clean_fleet` needs to survive a bad day.

    The default instance (no faults, 2 retries, no deadline, no journal)
    reproduces the pre-resilience pipeline exactly for a fault-free run —
    retries and deadlines only change behaviour when a stage fails."""

    faults: Optional[FaultInjector] = None
    retry: RetryPolicy = dataclasses.field(default_factory=RetryPolicy)
    stage_timeout_s: Optional[float] = None
    journal: Optional[FleetJournal] = None
    resume: bool = False

    @classmethod
    def from_env(cls, config=None, registry=None) -> "ResiliencePlan":
        """Library/bench entry: honour the ``ICLEAN_*`` mirrors and the
        config's ``fleet_retries`` / ``stage_timeout_s`` knobs (explicit
        config values win over env; None defers to env, then defaults)."""
        return cls(
            faults=FaultInjector.from_env(registry=registry),
            retry=RetryPolicy(max_retries=resolve_retries(
                getattr(config, "fleet_retries", None))),
            stage_timeout_s=resolve_stage_timeout(
                getattr(config, "stage_timeout_s", None)),
        )
