"""Telemetry of a cleaning session: the run report, the Prometheus
textfile and the JSON-lines event log.

The port's own copy of the reference package's ``telemetry`` layer, as
far as the CLI session uses it:

- :class:`~iterative_cleaner_torch.telemetry.registry.MetricsRegistry`:
  counters, gauges, histograms and wall-clock phase timings, exported
  as JSON or Prometheus text
  (:mod:`~iterative_cleaner_torch.telemetry.exporters`).
- The engine's per-iteration history (``CleanResult.iter_metrics``, a
  ``(loops, 4)`` float32 matrix filled on the device and fetched with
  the result): zap count, mask churn, the residual std (kernel K9's
  masked median) and the template peak; :data:`ITER_METRIC_FIELDS`
  names the columns.
- :class:`~iterative_cleaner_torch.telemetry.events.RunEventLog`: one
  JSON object per line for each archive, iteration and phase
  (``--log-format json``), beside the reference-format ``clean.log``.
- :mod:`~iterative_cleaner_torch.telemetry.quality`: zap-occupancy
  histograms and the per-iteration churn series of a finished clean.
- :class:`~iterative_cleaner_torch.telemetry.run.RunTelemetry`: the one
  object a CLI session threads through, flushed at its end.

Profiling, request tracing, the flight recorder, the benchmark tracker
and the live quality monitor are not ported (ROADMAP.md 'Modules still
to port' items 5 and 8).
"""

from __future__ import annotations

# Columns of the engine's iteration history, in storage order.
# zap_count:     zero-weight cells after the iteration (prezapped included)
# mask_churn:    cells whose zap state flipped against the previous one
# residual_std:  masked median over the valid cells of the per-cell
#                residual std (kernel K9 on the card)
# template_peak: max of the iteration's (scaled) template profile
ITER_METRIC_FIELDS = ("zap_count", "mask_churn", "residual_std",
                      "template_peak")

METRICS_SCHEMA = "icln-run-report/1"
EVENT_SCHEMA = "icln-event/1"

from iterative_cleaner_torch.telemetry.events import RunEventLog  # noqa: E402,F401
from iterative_cleaner_torch.telemetry.exporters import (  # noqa: E402,F401
    metrics_to_json,
    metrics_to_prometheus,
    parse_prometheus_text,
    write_metrics_json,
    write_prometheus_textfile,
)
from iterative_cleaner_torch.telemetry.quality import (  # noqa: E402,F401
    observe_mask,
    observe_result,
)
from iterative_cleaner_torch.telemetry.registry import (  # noqa: E402,F401
    MetricsRegistry,
    PhaseTimer,
    labeled,
)
from iterative_cleaner_torch.telemetry.run import RunTelemetry  # noqa: E402,F401


def iter_metrics_dict(iter_metrics) -> dict:
    """``(loops, 4)`` iteration history -> ``{field: [per-loop]}``, the
    counts as ints and the float columns as floats (JSON-ready); ``None``
    (a clean without an iteration history) maps to ``{}``."""
    if iter_metrics is None:
        return {}
    import numpy as np

    m = np.asarray(iter_metrics)
    out = {}
    for j, name in enumerate(ITER_METRIC_FIELDS):
        col = m[:, j]
        if name in ("zap_count", "mask_churn"):
            out[name] = [int(round(float(v))) for v in col]
        else:
            out[name] = [float(v) for v in col]
    return out
