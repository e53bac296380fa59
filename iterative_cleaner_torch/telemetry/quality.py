"""Cleaning-quality observables, from the masks alone.

* **Occupancy.**  :func:`observe_mask` folds a finished (nsub, nchan)
  mask into the ``quality_chan_occupancy`` / ``quality_subint_occupancy``
  histograms over :data:`FRACTION_BUCKETS` and returns its summary (the
  run report's per-archive ``quality`` entry; a live stream's series
  labelled ``{stream=}``); :func:`observe_result` adds the churn series
  of the engine's iteration history as ``quality_iter_churn``.
* **A live stream** (:class:`QualityMonitor`, one per online session):
  the per-subint provisional zap fraction (``quality_zap_frac{stream=}``),
  the reconcile-repaired cells (``quality_mask_churn{stream=}``) and the
  relative step-to-step movement of the EW template
  (``quality_ew_drift{stream=}``).
* **Drift alerts.**  The monitor keeps a trailing window of per-subint
  zap fractions; once it is full, a subint whose fraction departs the
  window's median by more than the threshold raises
  ``quality_drift_alerts{stream=}``.

Everything here reads host numpy copies the session already made, so it
can never change a mask.
"""

from __future__ import annotations

import collections
import os
import time
from typing import Optional

import numpy as np

from iterative_cleaner_torch.telemetry.registry import COUNTS, labeled

# Trailing-window length (subints) and the absolute zap-fraction
# departure that raises a drift alert; CleanConfig's quality_window /
# quality_drift override, the env mirrors serve deployments.
DEFAULT_QUALITY_WINDOW = 16
DEFAULT_QUALITY_DRIFT = 0.15

# Occupancy is a fraction in [0, 1]; the bounds resolve the healthy
# tail (a few per cent) and the saturated end.
FRACTION_BUCKETS = (0.01, 0.02, 0.05, 0.1, 0.2, 0.35, 0.5, 0.75, 1.0)


def resolve_quality_window(value: Optional[int]) -> int:
    """Explicit config value, else ICLEAN_QUALITY_WINDOW, else
    :data:`DEFAULT_QUALITY_WINDOW`."""
    if value is not None:
        return int(value)
    raw = os.environ.get("ICLEAN_QUALITY_WINDOW", "")
    return int(raw) if raw else DEFAULT_QUALITY_WINDOW


def resolve_quality_drift(value: Optional[float]) -> float:
    """Explicit config value, else ICLEAN_QUALITY_DRIFT, else
    :data:`DEFAULT_QUALITY_DRIFT`."""
    if value is not None:
        return float(value)
    raw = os.environ.get("ICLEAN_QUALITY_DRIFT", "")
    return float(raw) if raw else DEFAULT_QUALITY_DRIFT


def observe_mask(weights, registry, *, stream: Optional[str] = None
                 ) -> dict:
    """Fold one finished (nsub, nchan) mask into the occupancy
    histograms and return its summary: the zapped fraction and the worst
    channel and subint.  ``stream`` labels the series of a live session;
    a batch run leaves them unlabelled."""
    zapped = np.asarray(weights) == 0
    nsub, nchan = zapped.shape
    chan_occ = zapped.mean(axis=0)      # (nchan,) fraction of subints
    sub_occ = zapped.mean(axis=1)       # (nsub,) fraction of channels
    label = {} if stream is None else {"stream": stream}
    if registry is not None:
        for f in chan_occ:
            registry.histogram_observe(
                labeled("quality_chan_occupancy", **label), float(f),
                buckets=FRACTION_BUCKETS)
        for f in sub_occ:
            registry.histogram_observe(
                labeled("quality_subint_occupancy", **label), float(f),
                buckets=FRACTION_BUCKETS)
        registry.gauge_set(labeled("quality_zap_frac_final", **label),
                           float(zapped.mean()))
    return {
        "zap_frac": float(zapped.mean()),
        "nsub": int(nsub),
        "nchan": int(nchan),
        "worst_channel": int(np.argmax(chan_occ)),
        "worst_channel_frac": float(chan_occ.max()),
        "worst_subint": int(np.argmax(sub_occ)),
        "worst_subint_frac": float(sub_occ.max()),
    }


def observe_result(result, registry) -> dict:
    """:func:`observe_mask` on a :class:`CleanResult`'s final mask, plus
    its per-iteration churn (``engine.loop.iter_quality_series``) as
    ``quality_iter_churn`` observations.  Returns the mask summary."""
    from iterative_cleaner_torch.engine.loop import iter_quality_series

    summary = observe_mask(result.final_weights, registry)
    im = getattr(result, "iter_metrics", None)
    if im is None or registry is None:
        return summary
    w = np.asarray(result.final_weights)
    series = iter_quality_series(im, int(w.size))
    for churn in series.get("mask_churn", ()):
        registry.histogram_observe("quality_iter_churn", float(churn),
                                   buckets=COUNTS)
    return summary


class QualityMonitor:
    """One live stream's cleaning-quality follower (see the module
    docstring): one per
    :class:`~iterative_cleaner_torch.online.session.OnlineSession`, every
    method reading host numpy copies only."""

    def __init__(self, *, stream: str = "local",
                 window: Optional[int] = None,
                 drift: Optional[float] = None, registry=None) -> None:
        self.stream = str(stream)
        self.window = resolve_quality_window(window)
        if self.window < 2:
            raise ValueError(
                f"quality window must be >= 2 subints, got {self.window}")
        self.drift = resolve_quality_drift(drift)
        if not self.drift > 0:
            raise ValueError(
                f"quality drift threshold must be > 0, got {self.drift}")
        self.registry = registry
        self._fracs = collections.deque(maxlen=self.window)
        self._prev_template: Optional[np.ndarray] = None
        self.n_subints = 0
        self.alerts = 0
        self.mask_churn = 0
        self.last_zap_frac = 0.0
        self.last_baseline: Optional[float] = None
        self.last_ew_drift = 0.0
        self.last_alert_subint: Optional[int] = None
        self.last_alert_ts: Optional[float] = None

    def _labeled(self, name: str) -> str:
        return labeled(name, stream=self.stream)

    def observe_subint(self, mask_row, template=None) -> bool:
        """One provisional per-subint mask row (and the EW template where
        given).  Returns True when this subint raised a drift alert."""
        frac = float(np.mean(np.asarray(mask_row) == 0))
        alerted = False
        baseline = None
        if len(self._fracs) == self.window:
            baseline = float(np.median(self._fracs))
            if abs(frac - baseline) > self.drift:
                alerted = True
                self.alerts += 1
                self.last_alert_subint = self.n_subints
                self.last_alert_ts = time.time()
        self._fracs.append(frac)
        self.n_subints += 1
        self.last_zap_frac = frac
        self.last_baseline = baseline
        if template is not None:
            t = np.asarray(template, dtype=np.float64)
            if self._prev_template is not None:
                denom = float(np.linalg.norm(self._prev_template)) or 1.0
                self.last_ew_drift = float(
                    np.linalg.norm(t - self._prev_template)) / denom
            self._prev_template = t
        if self.registry is not None:
            self.registry.gauge_set(self._labeled("quality_zap_frac"), frac)
            self.registry.histogram_observe(
                self._labeled("quality_subint_occupancy"), frac,
                buckets=FRACTION_BUCKETS)
            if template is not None:
                self.registry.gauge_set(
                    self._labeled("quality_ew_drift"), self.last_ew_drift)
            if alerted:
                self.registry.counter_inc(
                    self._labeled("quality_drift_alerts"))
        return alerted

    def observe_reconcile(self, drift_cells: int) -> None:
        """Reconcile-repaired provisional cells: the mask-churn series."""
        self.mask_churn += int(drift_cells)
        if self.registry is not None and drift_cells:
            self.registry.counter_inc(self._labeled("quality_mask_churn"),
                                      int(drift_cells))

    def observe_close(self, final_weights) -> dict:
        """The finished mask's occupancy histograms and summary."""
        return observe_mask(final_weights, self.registry,
                            stream=self.stream)

    def summary(self) -> dict:
        """One JSON-ready view of the stream's quality."""
        return {
            "stream": self.stream,
            "n_subints": self.n_subints,
            "window": self.window,
            "drift_threshold": self.drift,
            "zap_frac": self.last_zap_frac,
            "baseline": self.last_baseline,
            "ew_drift": self.last_ew_drift,
            "mask_churn": self.mask_churn,
            "alerts": self.alerts,
            "last_alert_subint": self.last_alert_subint,
            "last_alert_ts": self.last_alert_ts,
        }
