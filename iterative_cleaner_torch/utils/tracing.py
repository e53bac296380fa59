"""``--trace DIR``: a ``torch.profiler`` capture of a whole CLI session.

The trace holds the host's torch operations and, on a CUDA machine, the
card's kernels, copies and memsets (CUPTI), written into ``DIR`` as one
Chrome/Perfetto trace-event JSON file per process (``trace.rank<r>.json``,
rank 0 outside a mesh).  The session's ranges show in it by name: the
host phases as ``icln:load``, ``icln:clean`` and ``icln:write``
(``telemetry/registry.PhaseTimer``) and each iteration's stages as
``icln_template``, ``icln_residual_stats``, ``icln_scores``, ``icln_zap``
and ``icln_iter_metrics`` (:data:`STAGES`, the reference's scope names,
``engine/loop.py``).  Without ``--trace`` no profiler starts, and the
stage ranges cost one flag check each.
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import Iterator, Optional

import torch

from iterative_cleaner_torch.io.atomic import atomic_output

# The iteration's stage ranges (the reference's jax.named_scope names).
STAGES = ("icln_template", "icln_residual_stats", "icln_scores", "icln_zap")
_NO_RANGE = contextlib.nullcontext()


def stage(name: str):
    """A ``record_function`` range of one iteration stage while a profiler
    is on, else a shared no-op context: a ``record_function`` enters the
    dispatcher even with no profiler to record it, and an iteration opens
    five ranges."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_RANGE


def trace_path(trace_dir: str, rank: int = 0) -> str:
    """The trace file of process ``rank`` in ``trace_dir``."""
    return os.path.join(trace_dir, f"trace.rank{rank}.json")


@contextlib.contextmanager
def device_trace(trace_dir: Optional[str], rank: int = 0) -> Iterator[None]:
    """Profile the body into :func:`trace_path` of ``trace_dir`` (CPU
    activities, and CUDA's where a card is present), published atomically
    when the body ends, however it ends.  No-op when ``trace_dir`` is
    falsy."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(trace_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        with atomic_output(trace_path(trace_dir, rank)) as tmp:
            prof.export_chrome_trace(tmp)


def trace_event_counts(path: str, cat: Optional[str] = None) -> dict:
    """Each name of a trace file's complete events (of category ``cat``
    where given: ``user_annotation`` for the host's ranges, ``kernel`` for
    the card's kernels) with its count."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    counts: dict = {}
    for e in events:
        name = e.get("name")
        if name is None or e.get("ph") != "X" \
                or (cat is not None and e.get("cat") != cat):
            continue
        counts[name] = counts.get(name, 0) + 1
    return counts
