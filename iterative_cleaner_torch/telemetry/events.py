"""JSON-lines run-event log: one event object per line.

The structured sibling of the reference-format ``clean.log``.  Events
share one schema tag (:data:`~iterative_cleaner_torch.telemetry.
EVENT_SCHEMA`) and carry a wall-clock timestamp, an event kind and its
fields:

``run_start`` / ``run_end``
    the CLI session's bounds; ``run_end`` carries ``ok``/``failed``.
``archive``
    one cleaned archive: path, loops, zapped cells, its iteration
    history and quality summary.
``iteration``
    one engine iteration (from the history fetched with the result):
    its index and the :data:`ITER_METRIC_FIELDS` values.
``phase``
    one completed host phase (load, clean, write) and its seconds.
``error``
    an archive that failed under ``--keep_going``.

Appends go through :func:`~iterative_cleaner_torch.utils.logging.
locked_append`, so processes sharing one event file never interleave
lines.
"""

from __future__ import annotations

import datetime
import json
from typing import Optional

from iterative_cleaner_torch.utils.logging import locked_append


class RunEventLog:
    """Append-only JSON-lines event sink bound to one file path."""

    def __init__(self, path: str, schema: Optional[str] = None) -> None:
        from iterative_cleaner_torch.telemetry import EVENT_SCHEMA

        self.path = path
        self.schema = schema or EVENT_SCHEMA

    def emit(self, event: str, **fields) -> None:
        """Append one event line; ``fields`` must be JSON-serialisable
        (a ``ts`` field pins the timestamp)."""
        doc = {"schema": self.schema, "event": event}
        if "ts" not in fields:
            doc["ts"] = datetime.datetime.now().isoformat()
        doc.update(fields)
        locked_append(self.path, json.dumps(doc, sort_keys=True) + "\n")


def read_events(path: str) -> list:
    """The events of a JSON-lines file as a list of dicts (blank lines
    skipped)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
