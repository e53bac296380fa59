"""MetricsRegistry: counters, gauges, histograms and phase timings.

The process-local metric store the CLI session writes into and the
exporters (:mod:`~iterative_cleaner_torch.telemetry.exporters`) read:
a dict of floats, since its consumers are a JSON report and a
Prometheus textfile written at the session's end.

:class:`PhaseTimer` is the registry's ``phases`` section.  Its report
is deterministic (phases sorted by name), a callback per completed
phase feeds the event log, and each phase opens a
``torch.profiler.record_function`` range, so a ``torch.profiler``
trace of a session shows its load, clean and write bands above the
card's kernels.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch

# Histogram bucket upper bounds for small counts (loops per archive,
# cells flipped per iteration), the default.
COUNTS = (1.0, 2.0, 5.0, 10.0, 25.0, 50.0, 100.0)
# Histogram bucket upper bounds for durations in seconds (the fleet's
# load and compile stalls, the journal's folds).
SECONDS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025,
           0.005, 0.025, 0.1, 0.5, 1.0, 2.5, 10.0, 30.0, 120.0)


def labeled(name: str, **labels) -> str:
    """The label-suffix convention: a flat registry key that renders as a
    Prometheus label set — ``labeled("quality_zap_frac_final",
    stream="a")`` is ``'quality_zap_frac_final{stream=a}'``.  Label keys
    sort, so one (name, labels) pair always folds to one key."""
    if not labels:
        return name
    body = ",".join("%s=%s" % (k, labels[k]) for k in sorted(labels))
    return "%s{%s}" % (name, body)


def split_labels(name: str):
    """Inverse of :func:`labeled`: ``(base_name, {label: value})``."""
    if "{" not in name or not name.endswith("}"):
        return name, {}
    base, _, body = name.partition("{")
    out = {}
    for part in body[:-1].split(","):
        k, sep, v = part.partition("=")
        if sep:
            out[k.strip()] = v.strip()
    return base, out


class PhaseTimer:
    """Accumulates wall-clock seconds per named phase (load, clean,
    write).  ``on_phase(name, seconds)`` is called after every completed
    phase (the event log's hook); :meth:`report` lists the phases in
    sorted name order."""

    def __init__(self, on_phase: Optional[Callable[[str, float],
                                                   None]] = None) -> None:
        self.seconds: Dict[str, float] = {}
        self._on_phase = on_phase

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function("icln:" + name):
                yield
        finally:
            dt = time.perf_counter() - t0
            self.seconds[name] = self.seconds.get(name, 0.0) + dt
            if self._on_phase is not None:
                self._on_phase(name, dt)

    def report(self) -> str:
        total = sum(self.seconds.values())
        parts = ["%s %.3fs" % (k, self.seconds[k])
                 for k in sorted(self.seconds)]
        return "Timing: %s (total %.3fs)" % (", ".join(parts), total)


class Histogram:
    """Prometheus-style cumulative histogram: fixed upper bounds, +Inf
    implicit, plus sum and count."""

    def __init__(self, buckets: Tuple[float, ...] = COUNTS) -> None:
        self.bounds: Tuple[float, ...] = tuple(sorted(buckets))
        self.bucket_counts: List[int] = [0] * (len(self.bounds) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        v = float(value)
        self.sum += v
        self.count += 1
        for i, b in enumerate(self.bounds):
            if v <= b:
                self.bucket_counts[i] += 1
                return
        self.bucket_counts[-1] += 1

    def snapshot(self) -> dict:
        cum, acc = [], 0
        for c in self.bucket_counts:
            acc += c
            cum.append(acc)
        return {
            "buckets": list(self.bounds),
            "cumulative_counts": cum,  # the last entry is count (+Inf)
            "sum": self.sum,
            "count": self.count,
        }


class MetricsRegistry:
    """Counters (monotonic), gauges (last value), histograms, phases.
    Thread-safe: every writer takes one lock."""

    def __init__(self, on_phase: Optional[Callable[[str, float],
                                                   None]] = None) -> None:
        self._lock = threading.Lock()
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.histograms: Dict[str, Histogram] = {}
        self.timer = PhaseTimer(on_phase=on_phase)

    def counter_inc(self, name: str, value: float = 1.0) -> None:
        if value < 0:
            raise ValueError(f"counter {name!r} cannot decrease ({value})")
        with self._lock:
            self.counters[name] = self.counters.get(name, 0.0) + float(value)

    def gauge_set(self, name: str, value: float) -> None:
        with self._lock:
            self.gauges[name] = float(value)

    def histogram_observe(self, name: str, value: float,
                          buckets: Tuple[float, ...] = COUNTS
                          ) -> None:
        with self._lock:
            h = self.histograms.get(name)
            if h is None:
                h = self.histograms[name] = Histogram(buckets)
            h.observe(value)

    def counters_mark(self) -> Dict[str, float]:
        """A copy of every counter now, for :meth:`counters_since`."""
        with self._lock:
            return dict(self.counters)

    def counters_since(self, mark: Dict[str, float]) -> Dict[str, float]:
        """Each counter's increase since ``mark`` (a :meth:`counters_mark`
        result); counters that did not move are left out."""
        with self._lock:
            return {k: v - mark.get(k, 0.0)
                    for k, v in self.counters.items()
                    if v != mark.get(k, 0.0)}

    def snapshot(self) -> dict:
        """Deterministic (sorted-key) plain-dict view, JSON-ready."""
        with self._lock:
            return {
                "counters": {k: self.counters[k]
                             for k in sorted(self.counters)},
                "gauges": {k: self.gauges[k] for k in sorted(self.gauges)},
                "histograms": {k: self.histograms[k].snapshot()
                               for k in sorted(self.histograms)},
                "phases_s": {k: self.timer.seconds[k]
                             for k in sorted(self.timer.seconds)},
            }
