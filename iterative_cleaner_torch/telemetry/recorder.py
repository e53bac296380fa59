"""Crash flight recorder: a bounded in-memory black box, dumped on doom.

Long-lived serving means the interesting failure is rarely reproducible:
a watchdog trip at 03:00, a daemon thread dying on an exception nobody
anticipated, an operator mashing Ctrl-C twice.  The flight recorder
keeps a ring of the last N spans and events **per subsystem** (serve /
sched / fleet / retry / journal), costing a bounded few hundred dicts of
memory, and dumps the whole state atomically to JSON the moment any of
the doom paths fire:

* a per-stage watchdog trip (``resilience/retry.py``),
* an unhandled exception escaping the daemon loop (``serve/daemon.py``),
* ``SIGQUIT`` (live snapshot — the process keeps running, like the JVM's
  thread-dump signal),
* the second-signal force exit (``os._exit`` path, where atexit never
  runs).

The dump includes every thread's current stack, so a wedged stage is
diagnosable from the black box alone.  A module-level *active recorder*
(:func:`set_active` / :func:`dump_active`) lets deep call sites — the
retry watchdog lives five frames below anything that knows about
serving — trigger a dump without threading a recorder handle through
every fleet signature.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
import traceback
from collections import deque
from typing import Dict, Optional

FLIGHT_SCHEMA = "icln-flight/1"

_active_lock = threading.Lock()
_active: Optional["FlightRecorder"] = None


class FlightRecorder:
    """Per-subsystem bounded rings of recent spans/events plus an atomic
    JSON dump.  Thread-safe; ``record`` is O(1) and allocation-light so
    it can sit on serving paths."""

    def __init__(self, path: Optional[str] = None, ring: int = 256) -> None:
        self.path = path
        self.ring = int(ring)
        self._lock = threading.Lock()
        self._rings: Dict[str, deque] = {}
        self._dumps = 0

    def record(self, subsystem: str, kind: str, payload: dict) -> None:
        entry = {"ts": time.time(), "kind": kind}
        entry.update(payload)
        with self._lock:
            ring = self._rings.get(subsystem)
            if ring is None:
                ring = self._rings[subsystem] = deque(maxlen=self.ring)
            ring.append(entry)

    def event(self, subsystem: str, name: str, **fields) -> None:
        fields["name"] = name
        self.record(subsystem, "event", fields)

    def snapshot(self, reason: str) -> dict:
        with self._lock:
            rings = {k: list(v) for k, v in sorted(self._rings.items())}
        frames = sys._current_frames()
        threads = {}
        names = {t.ident: t.name for t in threading.enumerate()}
        for tid, frame in frames.items():
            label = "%s (%s)" % (names.get(tid, "?"), tid)
            threads[label] = "".join(traceback.format_stack(frame))
        return {
            "schema": FLIGHT_SCHEMA,
            "reason": reason,
            "ts": time.time(),
            "pid": os.getpid(),
            "rings": rings,
            "threads": threads,
        }

    def dump(self, reason: str, path: Optional[str] = None) -> Optional[str]:
        """Write the black box.  Atomic (tmp + rename) so a dump racing a
        crash or a second dump never leaves a torn file; successive dumps
        in one process get distinct ``.N`` suffixed names so a SIGQUIT
        snapshot is not clobbered by the force-exit dump that follows.
        Swallows all IO errors — the recorder must never make a bad
        situation worse.  Returns the path written, or None."""
        target = path or self.path
        if not target:
            return None
        with self._lock:
            n = self._dumps
            self._dumps += 1
        if n:
            base, ext = os.path.splitext(target)
            target = "%s.%d%s" % (base, n, ext or "")
        try:
            from iterative_cleaner_torch.io.atomic import atomic_output

            doc = self.snapshot(reason)
            with atomic_output(target) as tmp:
                with open(tmp, "w") as f:
                    json.dump(doc, f, sort_keys=True, indent=1)
                    f.write("\n")
            return target
        except Exception:  # noqa: BLE001 -- the recorder dumps from crash and watchdog paths and must never make a bad situation worse; None says no file landed
            return None


def set_active(recorder: Optional[FlightRecorder]) -> None:
    """Install ``recorder`` as the process-wide active flight recorder
    (the one :func:`dump_active` and deep call sites hit)."""
    global _active
    with _active_lock:
        _active = recorder


def get_active() -> Optional[FlightRecorder]:
    return _active


def record_active(subsystem: str, kind: str, payload: dict) -> None:
    """Record into the active recorder if one is installed; no-op (one
    global read) otherwise — safe on hot-ish paths."""
    rec = _active
    if rec is not None:
        rec.record(subsystem, kind, payload)


def dump_active(reason: str) -> Optional[str]:
    """Dump the active recorder (if installed and given a path)."""
    rec = _active
    if rec is not None:
        return rec.dump(reason)
    return None


def install_sigquit() -> bool:
    """``kill -QUIT <pid>`` → live black-box snapshot, process keeps
    running.  Main-thread only (signal module restriction); returns
    whether the handler was installed."""
    import signal

    if threading.current_thread() is not threading.main_thread():
        return False

    def _on_quit(signum, frame):
        dump_active("sigquit")

    try:
        signal.signal(signal.SIGQUIT, _on_quit)
        return True
    except (ValueError, OSError, AttributeError):
        return False
