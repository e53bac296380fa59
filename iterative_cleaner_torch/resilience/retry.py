"""Staged retries, error classification and watchdog deadlines.

The fleet pipeline's stages (peek/load/compile/execute/write) fail in
three distinct ways that want three distinct answers:

- **transient** (an IO hiccup, a flaky filesystem, an injected drill
  fault): retry with bounded deterministic backoff — no jitter, this is
  one host draining its own queue, and determinism is what makes the
  fault-injection soak reproducible;
- **permanent** (a corrupt archive, a shape that contradicts its header
  — ``ValueError``/``TypeError`` territory — and a CUDA error that leaves
  the context broken, such as an illegal address or a launch failure: a
  retry on a dead context only fails again): fail the archive
  immediately;
- **resource exhaustion** (``torch.OutOfMemoryError``, a failed
  allocation whose message says "out of memory", or the injector's
  synthetic ``RESOURCE_EXHAUSTED`` twin): raised through to the caller —
  the execute path answers OOM structurally (batch-halving, then the
  numpy oracle), not by replaying the same oversized batch.

A hung stage is none of these: it never raises.
:func:`call_with_deadline` puts a per-stage deadline on it that fails
the archive (``StageTimeout``, counted as ``fleet_watchdog_trips``)
instead of wedging the process.  The abandoned attempt keeps running on
a daemon thread — Python cannot kill a thread — but the pipeline moves
on and the interpreter can still exit.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Optional

TRANSIENT = "transient"
PERMANENT = "permanent"
OOM = "oom"
TIMEOUT = "timeout"

# Exception types whose retry would deterministically repeat the failure:
# bad values, bad types, broken invariants.  Everything else (OSError,
# RuntimeError, injected transients) is worth the bounded retry budget.
_PERMANENT_TYPES = (ValueError, TypeError, NotImplementedError,
                    AssertionError, KeyError, AttributeError, EOFError)


class StageTimeout(RuntimeError):
    """A stage attempt exceeded its watchdog deadline."""


# Messages of CUDA errors that leave the context unusable: every later
# call on it fails the same way, so retrying (or halving the batch) can
# only repeat the failure.
_BROKEN_CONTEXT = ("illegal memory access", "illegal address",
                   "unspecified launch failure", "launch failure",
                   "misaligned address", "illegal instruction",
                   "device-side assert", "cuda error: an illegal",
                   "context is destroyed", "hardware stack error")


def _is_torch_oom(exc: BaseException) -> bool:
    """A ``torch.OutOfMemoryError`` (``torch.cuda.OutOfMemoryError``),
    recognised by type without importing torch when it is not loaded."""
    import sys

    torch = sys.modules.get("torch")
    oom = getattr(torch, "OutOfMemoryError", None) if torch else None
    return oom is not None and isinstance(exc, oom)


def classify_error(exc: BaseException) -> str:
    """``oom`` | ``timeout`` | ``permanent`` | ``transient``.

    OOM is recognised by type (``torch.OutOfMemoryError``) and by
    message: ``RESOURCE_EXHAUSTED`` (the injector's
    :class:`~iterative_cleaner_torch.resilience.faults.
    SyntheticResourceExhausted`, the reference's marker) or "out of
    memory" (the caching allocator's message, and a failed ``cudaMalloc``
    in a kernel wrapper, which raises ``RuntimeError`` naming it), so
    drills and real exhaustion take the identical route.  A CUDA error
    that breaks the context is permanent."""
    if isinstance(exc, StageTimeout):
        return TIMEOUT
    if _is_torch_oom(exc):
        return OOM
    msg = str(exc)
    low = msg.lower()
    if "RESOURCE_EXHAUSTED" in msg or "out of memory" in low:
        return OOM
    if any(marker in low for marker in _BROKEN_CONTEXT):
        return PERMANENT
    if isinstance(exc, _PERMANENT_TYPES):
        return PERMANENT
    return TRANSIENT


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded deterministic backoff: attempt k sleeps
    ``min(cap, base * factor**k)`` — 50ms, 100ms, 200ms ... by default."""

    max_retries: int = 2
    backoff_base_s: float = 0.05
    backoff_factor: float = 2.0
    backoff_cap_s: float = 2.0

    def __post_init__(self) -> None:
        if self.max_retries < 0:
            raise ValueError(
                f"max_retries must be >= 0, got {self.max_retries}")
        if self.backoff_base_s < 0 or self.backoff_cap_s < 0:
            raise ValueError("backoff times must be >= 0")
        if self.backoff_factor < 1.0:
            raise ValueError(
                f"backoff_factor must be >= 1, got {self.backoff_factor}")

    def backoff(self, attempt: int) -> float:
        """Sleep before retry ``attempt`` (0-based)."""
        return min(self.backoff_cap_s,
                   self.backoff_base_s * self.backoff_factor ** attempt)


def call_with_deadline(fn: Callable[[], object],
                       timeout_s: Optional[float],
                       stage: str,
                       registry=None, span=None):
    """Run ``fn`` under a watchdog deadline.

    ``timeout_s`` None/0 runs inline (zero overhead — the default).
    Otherwise ``fn`` runs on a daemon thread and a deadline overrun
    raises :class:`StageTimeout` (counting ``fleet_watchdog_trips``); the
    overrunning attempt is abandoned, not interrupted — its thread is a
    daemon so a wedged call can never block interpreter exit.  On the
    card an abandoned execute attempt that was already launching goes on
    launching its batch's kernels and holding their memory until its
    loop ends: the fleet's next group runs beside it.

    A trip is a black-box moment: it lands as an event on ``span`` (a
    tracing span, when tracing) and dumps the active flight recorder at
    once (``telemetry/recorder.py``), whose dump holds every thread's
    stack, the abandoned attempt's among them."""
    if not timeout_s:
        return fn()
    done = threading.Event()
    box: dict = {}

    def run() -> None:
        try:
            box["value"] = fn()
        except BaseException as exc:  # noqa: BLE001 -- boxed and re-raised on the caller's thread below
            box["error"] = exc
        finally:
            done.set()

    worker = threading.Thread(target=run, daemon=True,
                              name=f"icln-deadline-{stage}")
    worker.start()
    if not done.wait(timeout_s):
        if registry is not None:
            registry.counter_inc("fleet_watchdog_trips")
        if span is not None:
            span.event("watchdog_trip", stage=stage, timeout_s=timeout_s)
        from iterative_cleaner_torch.telemetry.recorder import (
            dump_active,
            record_active,
        )

        record_active("retry", "event",
                      {"name": "watchdog_trip", "stage": stage,
                       "timeout_s": timeout_s})
        dump_active("watchdog-trip:" + stage)
        raise StageTimeout(
            f"{stage} stage exceeded its {timeout_s:g}s watchdog deadline")
    if "error" in box:
        raise box["error"]
    return box["value"]


def run_with_retries(fn: Callable[[], object], *, stage: str,
                     policy: RetryPolicy, registry=None, faults=None,
                     site: Optional[str] = None,
                     deadline_s: Optional[float] = None,
                     sleep: Callable[[float], None] = time.sleep,
                     span=None):
    """The per-stage resilience ladder for peek/load/write (execute has
    its own OOM-splitting ladder in the fleet module).

    Each attempt optionally fires the fault injector at ``site`` and runs
    under the watchdog deadline.  Transient errors retry up to
    ``policy.max_retries`` times (counting ``fleet_retries``); permanent
    errors, OOM and watchdog trips propagate immediately.  ``span`` (a
    tracing span, optional) receives one ``retry`` event per transient
    retry."""
    site = site or stage
    attempt = 0
    while True:
        def guarded():
            if faults is not None:
                faults.fire(site)
            return fn()

        try:
            return call_with_deadline(guarded, deadline_s, stage,
                                      registry=registry, span=span)
        except StageTimeout:
            raise
        except Exception as exc:
            if classify_error(exc) != TRANSIENT \
                    or attempt >= policy.max_retries:
                raise
            if registry is not None:
                registry.counter_inc("fleet_retries")
            if span is not None:
                span.event("retry", stage=stage, attempt=attempt,
                           error="%s: %s" % (type(exc).__name__,
                                             str(exc)[:120]))
            sleep(policy.backoff(attempt))
            attempt += 1
