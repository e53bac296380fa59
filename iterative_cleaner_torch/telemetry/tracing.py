"""Distributed tracing: spans across serve → fleet → multi-host.

A *span* is one timed unit of work — a request's queue wait, a bucket's
compile, one archive's write — carrying ``trace_id`` (the whole request
tree), ``span_id`` (this node) and ``parent_id`` (its parent node).  The
daemon mints a trace at intake (honoring a client-supplied ``trace``
field), threads it through the scheduler and fleet, and the multi-host
journal carries trace context on claim lines so a stolen bucket's spans
stitch under the originating request even though the stealer never saw
the request itself.

Design constraints, in order:

* **Zero overhead when off.**  The fleet/batch hot paths take
  ``tracer=None`` by default and guard with :func:`maybe_span`; a
  disabled run executes not one extra instruction beyond the ``None``
  test.  Masks never depend on tracing either way.
* **Dependency-free**: the standard library and the port's own
  ``utils/logging`` and ``io/atomic``.
* **Multi-process by construction.**  Spans spool as JSON lines through
  the same ``locked_append`` flock discipline as the journal, so N host
  processes share one ``<trace-out>.spans.jsonl``; each host re-renders
  the Perfetto file atomically at exit from the full fold (the last
  finisher produces the complete picture).

Export formats:

* JSON-lines span records (``icln-span/1``) — both the spool file and,
  when a :class:`~iterative_cleaner_torch.telemetry.events.RunEventLog`
  sink is attached, ``span`` events in the run-event log.
* Chrome/Perfetto ``trace_events`` JSON (:func:`render_perfetto`) —
  ``pid`` lanes are hosts, ``tid`` lanes are buckets/subsystems; load
  the file straight into ``ui.perfetto.dev``.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import OrderedDict, deque
from typing import Dict, Iterator, List, Optional

from iterative_cleaner_torch.utils.logging import locked_append

SPAN_SCHEMA = "icln-span/1"

# trace ids are 16 hex chars, span ids 8 — wide enough to never collide
# within one service's lifetime, short enough to read in a journal line.
_TRACE_ID_HEX = 8
_SPAN_ID_HEX = 4


def new_trace_id() -> str:
    return os.urandom(_TRACE_ID_HEX).hex()


def new_span_id() -> str:
    return os.urandom(_SPAN_ID_HEX).hex()


def valid_trace_id(s) -> bool:
    """Client-supplied trace ids: 1-64 chars of [0-9a-zA-Z_-].  Anything
    else is rejected at intake rather than laundered into journal lines
    and file names."""
    if not isinstance(s, str) or not 0 < len(s) <= 64:
        return False
    return all(c.isalnum() or c in "_-" for c in s)


class Span:
    """One in-flight span.  Not thread-safe per instance — each span is
    owned by the thread that opened it (events from other threads go
    through their own child spans)."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "subsystem",
                 "host", "lane", "start_ts", "end_ts", "attrs", "events",
                 "status", "_tracer")

    def __init__(self, tracer: "Tracer", name: str, *, trace_id: str,
                 parent_id: Optional[str], subsystem: str, host: str,
                 lane: Optional[str], attrs: Optional[dict]) -> None:
        self._tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = new_span_id()
        self.parent_id = parent_id
        self.subsystem = subsystem
        self.host = host
        self.lane = lane or subsystem
        self.start_ts = time.time()
        self.end_ts: Optional[float] = None
        self.attrs: dict = dict(attrs) if attrs else {}
        self.events: List[dict] = []
        self.status = "ok"

    def set(self, key: str, value) -> None:
        self.attrs[key] = value

    def event(self, name: str, **attrs) -> None:
        """Attach a point-in-time event (a retry, an OOM split, a steal)
        to this span."""
        ev = {"ts": time.time(), "name": name}
        if attrs:
            ev.update(attrs)
        self.events.append(ev)

    def context(self) -> Dict[str, str]:
        """The wire form other processes need to stitch under this span:
        journal claim lines and ``clean_fleet(trace=...)`` both carry
        exactly this dict."""
        return {"trace_id": self.trace_id, "span_id": self.span_id}

    def end(self, status: Optional[str] = None) -> None:
        if self.end_ts is not None:
            return
        if status is not None:
            self.status = status
        self.end_ts = time.time()
        self._tracer._finish(self)

    def to_dict(self) -> dict:
        d = {
            "schema": SPAN_SCHEMA,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "subsystem": self.subsystem,
            "host": self.host,
            "lane": self.lane,
            "start_ts": self.start_ts,
            "end_ts": self.end_ts,
            "status": self.status,
        }
        if self.attrs:
            d["attrs"] = dict(self.attrs)
        if self.events:
            d["events"] = list(self.events)
        return d


class Tracer:
    """Mints, finishes and fans out spans.

    Finished spans go to (all optional, all cheap when unset):

    * a bounded in-memory store keyed by trace id — feeds the daemon's
      ``GET /trace/<request-id>`` endpoint and the flight recorder;
    * a JSON-lines spool file (flock-appended, multi-process safe) —
      the raw material :func:`render_perfetto` folds at exit;
    * a ``RunEventLog`` sink — spans ride the existing event machinery.

    Thread-safe: the daemon's scheduler, heartbeats and fleet IO pools
    all finish spans concurrently.
    """

    MAX_TRACES = 64          # traces retained for /trace/<id>
    MAX_SPANS_PER_TRACE = 512

    def __init__(self, *, host: str = "h0", spool_path: Optional[str] = None,
                 events=None, recorder=None) -> None:
        self.host = host
        self.spool_path = spool_path
        self.events = events
        self.recorder = recorder
        self._lock = threading.Lock()
        # OrderedDict for LRU eviction of whole traces
        self._traces: "OrderedDict[str, List[dict]]" = OrderedDict()
        self._recent: deque = deque(maxlen=256)

    # -- opening spans -----------------------------------------------------
    def start(self, name: str, *, trace_id: Optional[str] = None,
              parent_id: Optional[str] = None, subsystem: str = "",
              lane: Optional[str] = None, **attrs) -> Span:
        return Span(self, name, trace_id=trace_id or new_trace_id(),
                    parent_id=parent_id, subsystem=subsystem,
                    host=self.host, lane=lane, attrs=attrs or None)

    @contextlib.contextmanager
    def span(self, name: str, *, trace_id: Optional[str] = None,
             parent_id: Optional[str] = None, subsystem: str = "",
             lane: Optional[str] = None, **attrs) -> Iterator[Span]:
        s = self.start(name, trace_id=trace_id, parent_id=parent_id,
                       subsystem=subsystem, lane=lane, **attrs)
        try:
            yield s
        except BaseException as exc:
            s.event("error", type=type(exc).__name__, message=str(exc)[:200])
            s.end(status="error")
            raise
        else:
            s.end()

    # -- finishing ---------------------------------------------------------
    def _finish(self, span: Span) -> None:
        d = span.to_dict()
        with self._lock:
            spans = self._traces.get(span.trace_id)
            if spans is None:
                while len(self._traces) >= self.MAX_TRACES:
                    self._traces.popitem(last=False)
                spans = self._traces[span.trace_id] = []
            else:
                self._traces.move_to_end(span.trace_id)
            if len(spans) < self.MAX_SPANS_PER_TRACE:
                spans.append(d)
            self._recent.append(d)
        if self.recorder is not None:
            self.recorder.record(span.subsystem or "span", "span", d)
        if self.spool_path:
            try:
                locked_append(self.spool_path,
                              json.dumps(d, sort_keys=True) + "\n")
            except OSError:
                pass  # tracing must never fail the work it observes
        if self.events is not None:
            try:
                self.events.emit("span", **{
                    k: v for k, v in d.items() if k != "schema"})
            except OSError:
                pass

    # -- readers -----------------------------------------------------------
    def spans_for(self, trace_id: str) -> List[dict]:
        with self._lock:
            return list(self._traces.get(trace_id, ()))

    def recent(self, n: int = 50) -> List[dict]:
        with self._lock:
            items = list(self._recent)
        return items[-n:]

    def flush_perfetto(self, out_path: str) -> None:
        """Fold the shared spool (all hosts' spans) and atomically render
        the Perfetto file.  Each host calls this at exit; the last
        finisher's render sees everyone's spans."""
        spans = read_spans(self.spool_path) if self.spool_path else []
        if not spans:  # single-process / no spool: render our own store
            with self._lock:
                spans = [s for t in self._traces.values() for s in t]
        write_perfetto(out_path, spans)


@contextlib.contextmanager
def maybe_span(tracer: Optional[Tracer], name: str, **kwargs
               ) -> Iterator[Optional[Span]]:
    """The hot-path guard: a ``None`` tracer costs one comparison and
    yields ``None`` (callers write ``if s is not None: s.event(...)``)."""
    if tracer is None:
        yield None
        return
    with tracer.span(name, **kwargs) as s:
        yield s


def span_context(span: Optional[Span]) -> Optional[Dict[str, str]]:
    """``span.context()`` tolerant of the disabled (``None``) case."""
    return None if span is None else span.context()


def read_spans(path: str) -> List[dict]:
    """Parse a span spool file, tolerant of a torn tail line (a host
    killed mid-append) and foreign lines."""
    out: List[dict] = []
    try:
        with open(path) as f:
            text = f.read()
    except OSError:
        return out
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            d = json.loads(line)
        except ValueError:
            continue  # torn tail / partial write: skip, keep the rest
        if isinstance(d, dict) and d.get("schema") == SPAN_SCHEMA:
            out.append(d)
    return out


def render_perfetto(spans: List[dict]) -> dict:
    """Chrome ``trace_events`` document: one complete ("X") event per
    span, instant ("i") events for span events, metadata ("M") rows
    naming the host (pid) and lane (tid) tracks."""
    events: List[dict] = []
    pids: Dict[str, int] = {}
    tids: Dict[tuple, int] = {}

    def pid_of(host: str) -> int:
        if host not in pids:
            pids[host] = len(pids) + 1
            events.append({"ph": "M", "name": "process_name",
                           "pid": pids[host], "tid": 0,
                           "args": {"name": "host %s" % host}})
        return pids[host]

    def tid_of(host: str, lane: str) -> int:
        key = (host, lane)
        if key not in tids:
            tids[key] = sum(1 for h, _ in tids if h == host) + 1
            events.append({"ph": "M", "name": "thread_name",
                           "pid": pid_of(host), "tid": tids[key],
                           "args": {"name": lane}})
        return tids[key]

    for s in sorted(spans, key=lambda d: (d.get("start_ts") or 0.0)):
        start = s.get("start_ts")
        end = s.get("end_ts")
        if start is None:
            continue
        host = str(s.get("host", "h0"))
        lane = str(s.get("lane") or s.get("subsystem") or "main")
        pid, tid = pid_of(host), tid_of(host, lane)
        args = {"trace_id": s.get("trace_id"), "span_id": s.get("span_id"),
                "parent_id": s.get("parent_id"), "status": s.get("status")}
        args.update(s.get("attrs") or {})
        events.append({
            "ph": "X", "name": s.get("name", "?"),
            "cat": s.get("subsystem") or "span",
            "ts": start * 1e6,
            "dur": max(((end or start) - start) * 1e6, 1.0),
            "pid": pid, "tid": tid, "args": args,
        })
        for ev in s.get("events") or ():
            events.append({
                "ph": "i", "s": "t", "name": ev.get("name", "event"),
                "cat": s.get("subsystem") or "span",
                "ts": (ev.get("ts") or start) * 1e6,
                "pid": pid, "tid": tid,
                "args": {k: v for k, v in ev.items()
                         if k not in ("ts", "name")},
            })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_perfetto(path: str, spans: List[dict]) -> None:
    """Atomic render: a monitoring scrape or a racing host's concurrent
    render never sees a torn file (last ``os.replace`` wins with the
    fuller fold, since every host renders from the shared spool)."""
    from iterative_cleaner_torch.io.atomic import atomic_output

    doc = render_perfetto(spans)
    with atomic_output(path) as tmp:
        with open(tmp, "w") as f:
            json.dump(doc, f, sort_keys=True)
            f.write("\n")


def spool_path_for(trace_out: str) -> str:
    """The shared spans spool next to the requested Perfetto output."""
    return trace_out + ".spans.jsonl"
