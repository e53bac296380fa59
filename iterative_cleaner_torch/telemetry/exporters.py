"""Metric exporters: the JSON run report and the Prometheus textfile.

Both read :meth:`MetricsRegistry.snapshot` (or a dict of the same
shape).  The Prometheus output is the text exposition format that the
node_exporter textfile collector scrapes; the write is atomic (temp file
and rename), so a scrape never sees a torn file.
"""

from __future__ import annotations

import json
import math
import re

from iterative_cleaner_torch.io.atomic import atomic_output
from iterative_cleaner_torch.telemetry.registry import split_labels

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _escape_label_value(v) -> str:
    """Backslash, double quote and newline escaped as the exposition
    format wants them (backslash first, so the other escapes are not
    escaped again)."""
    return (str(v).replace("\\", "\\\\")
            .replace('"', '\\"')
            .replace("\n", "\\n"))


def _prom_name(name: str, prefix: str) -> str:
    """Sanitise to the Prometheus metric-name charset."""
    n = _NAME_RE.sub("_", name)
    return f"{prefix}_{n}" if prefix else n


def _prom_parts(name: str, prefix: str, suffix: str = ""):
    """A label-suffixed registry key (``base{k=v}``) as the sanitised
    metric name and a label-body string."""
    base, labels = split_labels(name)
    m = _prom_name(base, prefix)
    if suffix and not m.endswith(suffix):
        m += suffix
    body = ",".join('%s="%s"' % (_NAME_RE.sub("_", k),
                                 _escape_label_value(v))
                    for k, v in sorted(labels.items()))
    return m, body


def _prom_num(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    return repr(float(v))


def metrics_to_json(snapshot: dict, extra: dict = None) -> str:
    """One JSON document: the snapshot's sections plus any ``extra``
    top-level fields, keys sorted (byte-stable for equal inputs)."""
    doc = dict(snapshot)
    if extra:
        doc.update(extra)
    return json.dumps(doc, sort_keys=True, indent=2)


def write_metrics_json(path: str, snapshot: dict, extra: dict = None) -> None:
    with atomic_output(path) as tmp:
        with open(tmp, "w") as f:
            f.write(metrics_to_json(snapshot, extra))
            f.write("\n")


def metrics_to_prometheus(snapshot: dict, prefix: str = "icln") -> str:
    """Prometheus text exposition of the snapshot: counters with the
    ``_total`` suffix, phase timings as ``<prefix>_phase_seconds_total
    {phase="..."}``, histograms as ``_bucket``/``_sum``/``_count`` with
    cumulative ``le`` buckets."""
    lines = []
    typed = set()

    def _type_line(m: str, kind: str) -> None:
        if m not in typed:  # one TYPE row per family, even with labels
            typed.add(m)
            lines.append(f"# TYPE {m} {kind}")

    for name in sorted(snapshot.get("counters", {})):
        m, body = _prom_parts(name, prefix, "_total")
        _type_line(m, "counter")
        sel = ("%s{%s}" % (m, body)) if body else m
        lines.append(f"{sel} {_prom_num(snapshot['counters'][name])}")

    for name in sorted(snapshot.get("gauges", {})):
        m, body = _prom_parts(name, prefix)
        _type_line(m, "gauge")
        sel = ("%s{%s}" % (m, body)) if body else m
        lines.append(f"{sel} {_prom_num(snapshot['gauges'][name])}")

    phases = snapshot.get("phases_s", {})
    if phases:
        m = _prom_name("phase_seconds", prefix) + "_total"
        lines.append(f"# TYPE {m} counter")
        for name in sorted(phases):
            lines.append('%s{phase="%s"} %s'
                         % (m, _escape_label_value(name),
                            _prom_num(phases[name])))

    for name in sorted(snapshot.get("histograms", {})):
        h = snapshot["histograms"][name]
        m, body = _prom_parts(name, prefix)
        _type_line(m, "histogram")
        pre = body + "," if body else ""
        bounds = list(h["buckets"]) + [float("inf")]
        for le, c in zip(bounds, h["cumulative_counts"]):
            lines.append('%s_bucket{%sle="%s"} %d'
                         % (m, pre, _prom_num(le), c))
        suffix = ("{%s}" % body) if body else ""
        lines.append(f"{m}_sum{suffix} {_prom_num(h['sum'])}")
        lines.append(f"{m}_count{suffix} {h['count']}")

    return "\n".join(lines) + ("\n" if lines else "")


def write_prometheus_textfile(path: str, snapshot: dict,
                              prefix: str = "icln") -> None:
    with atomic_output(path) as tmp:
        with open(tmp, "w") as f:
            f.write(metrics_to_prometheus(snapshot, prefix))


def parse_prometheus_text(text: str) -> dict:
    """Inverse of :func:`metrics_to_prometheus`:
    ``{metric_name_with_labels: float_value}``; comment and blank lines
    skipped."""
    out = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        key, _, val = line.rpartition(" ")
        out[key] = float(val)
    return out
