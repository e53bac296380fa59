"""RunTelemetry: the one object a CLI session threads through.

It bundles the :class:`MetricsRegistry`, the optional JSON-lines event
log and the per-archive iteration histories, and writes them to the
``--metrics-json`` / ``--prom-textfile`` destinations at the session's
end.  Under ``--mesh cell`` every rank cleans the same archive and rank
0 alone writes the output, so rank 0 alone records: the other ranks
hold an empty :class:`RunTelemetry` (nothing configured), and no
counter crosses ranks.  A multi-host fleet started with
``--coordinator`` is one process a host, each exporting its own share:
there :meth:`RunTelemetry.report` sums :data:`_AGGREGATED_COUNTERS`
over the hosts (``parallel.distributed.
aggregate_metrics_across_processes``), the reference's reduction.
"""

from __future__ import annotations

from typing import Optional

from iterative_cleaner_torch.telemetry.events import RunEventLog
from iterative_cleaner_torch.telemetry.exporters import (
    write_metrics_json,
    write_prometheus_textfile,
)
from iterative_cleaner_torch.telemetry.registry import COUNTS, MetricsRegistry

# Counters summed over the hosts of a --coordinator group at export (the
# reference's tuple).  A fixed key set (a missing key counts 0) keeps the
# reduction's shape the same on every host, whatever its share did; a
# host that served nothing takes part with zeros.  The reduction runs on
# the session's exit path, which every live host reaches; a host killed
# mid-run leaves the others to degrade to their local counters, and the
# fleet's whole-slice totals fold from the journal's per-host stats lines
# (parallel/fleet._publish_host_stats) without any collective.
_AGGREGATED_COUNTERS = ("archives_cleaned", "archives_converged",
                        "archives_failed", "cells_total", "cells_zapped",
                        "iterations_total", "fleet_cleaned",
                        "fleet_failures", "fleet_resumed_skips",
                        "fleet_stolen", "fleet_buckets_owned")


class RunTelemetry:
    """Session-scoped metric and event sink.

    ``metrics_json`` / ``prom_textfile`` are output paths (``None``
    skips that exporter); ``events`` is a bound :class:`RunEventLog` or
    ``None``.  Phases timed through ``self.registry.timer.phase(...)`` also
    emit ``phase`` events when the event log is on."""

    def __init__(self, metrics_json: Optional[str] = None,
                 prom_textfile: Optional[str] = None,
                 events: Optional[RunEventLog] = None) -> None:
        self.metrics_json = metrics_json
        self.prom_textfile = prom_textfile
        self.events = events
        self.registry = MetricsRegistry(on_phase=self._on_phase)
        self.archives: list = []  # per-archive report entries, in order

    @classmethod
    def from_args(cls, args) -> "RunTelemetry":
        """From the parsed CLI namespace: ``--metrics-json``,
        ``--prom-textfile``, ``--event-log`` (or ``--log-format json``,
        which writes ``clean.events.jsonl``)."""
        event_path = getattr(args, "event_log", None) or None
        if event_path is None and getattr(args, "log_format", "text") == "json":
            event_path = "clean.events.jsonl"
        events = RunEventLog(event_path) if event_path else None
        return cls(metrics_json=getattr(args, "metrics_json", None) or None,
                   prom_textfile=getattr(args, "prom_textfile", None) or None,
                   events=events)

    def _on_phase(self, name: str, seconds: float) -> None:
        if self.events is not None:
            self.events.emit("phase", phase=name, seconds=seconds)

    def record_archive(self, path: str, result) -> None:
        """Fold one cleaned archive's :class:`CleanResult` into the run
        totals, keep its iteration history for the report, and emit its
        ``iteration`` events and its ``archive`` event."""
        from iterative_cleaner_torch.telemetry import iter_metrics_dict
        from iterative_cleaner_torch.telemetry.quality import observe_result

        r = self.registry
        w = result.final_weights
        zapped = int(w.size) - int((w != 0).sum())
        loops = int(result.loops)
        r.counter_inc("archives_cleaned")
        r.counter_inc("iterations_total", loops)
        r.counter_inc("cells_total", int(w.size))
        r.counter_inc("cells_zapped", zapped)
        if result.converged:
            r.counter_inc("archives_converged")
        r.gauge_set("last_rfi_fraction", float(result.rfi_fraction))
        r.histogram_observe("loops_per_archive", loops, buckets=COUNTS)

        quality = observe_result(result, r)
        history = iter_metrics_dict(getattr(result, "iter_metrics", None))
        entry = {
            "path": str(path),
            "loops": loops,
            "converged": bool(result.converged),
            "cells_zapped": zapped,
            "rfi_fraction": float(result.rfi_fraction),
            "iter_history": history,
            "quality": quality,
        }
        self.archives.append(entry)
        if self.events is not None:
            if history:
                n = len(next(iter(history.values())))
                for i in range(n):
                    self.events.emit(
                        "iteration", path=str(path), iteration=i,
                        **{k: v[i] for k, v in history.items()})
            self.events.emit("archive", **entry)

    def record_failure(self, path: str, error: BaseException) -> None:
        self.registry.counter_inc("archives_failed")
        if self.events is not None:
            self.events.emit("error", path=str(path),
                             error=f"{type(error).__name__}: {error}")

    def report(self) -> dict:
        """The run report: the registry's snapshot, the schema and the
        archives' entries.  In a ``--coordinator`` group of more than one
        host process the :data:`_AGGREGATED_COUNTERS` are the hosts' sums
        (every host must reach this point: it sits on the session's exit
        path); otherwise no collective runs."""
        from iterative_cleaner_torch.parallel import distributed
        from iterative_cleaner_torch.telemetry import METRICS_SCHEMA

        doc = self.registry.snapshot()
        if distributed.coordinated_processes() > 1:
            local = {k: doc["counters"].get(k, 0.0)
                     for k in _AGGREGATED_COUNTERS}
            doc["counters"].update(
                {k: v for k, v in
                 distributed.aggregate_metrics_across_processes(
                     local, registry=self.registry,
                     events=self.events).items() if v})
            # a degrade counted just now belongs in this export
            degraded = self.registry.snapshot()["counters"].get(
                "telemetry_degraded")
            if degraded:
                doc["counters"]["telemetry_degraded"] = degraded
        doc["schema"] = METRICS_SCHEMA
        doc["archives"] = list(self.archives)
        return doc

    def finalize(self) -> None:
        """Emit ``run_end`` and write the configured exporters' files
        (nothing when nothing is configured)."""
        failed = int(self.registry.counters.get("archives_failed", 0))
        if self.events is not None:
            self.events.emit("run_end", ok=len(self.archives), failed=failed)
        if self.metrics_json is None and self.prom_textfile is None:
            return
        doc = self.report()
        if self.metrics_json is not None:
            write_metrics_json(self.metrics_json, doc)
        if self.prom_textfile is not None:
            write_prometheus_textfile(self.prom_textfile, doc)
