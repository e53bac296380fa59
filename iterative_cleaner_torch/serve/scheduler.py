"""Admission control + priority/deadline scheduling for the serve daemon.

The scheduler is the daemon's backpressure boundary.  Admission
(:meth:`ServeScheduler.submit`) is synchronous and cheap — the HTTP
thread and the spool watcher both call it — and can refuse: a full global
queue or a tenant at its in-flight cap returns a
:class:`Rejection` (HTTP 429 / spool ``.rejected``) instead of queueing
unboundedly, and the ``serve_rejected`` counter records it.  Accepted
requests order by ``(priority desc, deadline asc, arrival)`` —
:func:`~iterative_cleaner_torch.serve.request.request_key` — and a request
whose deadline passed while it queued is failed fast at pop time
(``serve_deadline_expired``), never cleaned late.

Multi-tenancy: ``max_inflight`` bounds each tenant's ADMITTED-BUT-
UNFINISHED requests (queued + running).  One greedy tenant saturates its
own cap and starts drawing 429s while other tenants' requests keep
flowing — the per-tenant fairness floor, without a full weighted-share
scheduler.

In an elastic pool the bound is POOL-wide: ``pool_inflight`` (a
callable ``tenant -> count``, backed by the shared journal's request
fold) lets admission see the tenant's unfinished requests across every
member, so a greedy tenant cannot multiply its cap by spraying
submissions at each member's front door.  A failing pool view falls
back to the local count — admission degrades to per-host fairness,
it never wedges intake.  The fold is backend-agnostic: on a segmented
journal it reads only manifest-listed live segments, so admission
latency stays flat as the journal ages (sealed history is compacted
away underneath it, concurrently with this very fold).

``kind: "stream"`` requests pass admission here (``submit`` with
``enqueue=False`` — the per-tenant cap counts an OPEN stream as one
in-flight unit for its whole lifetime) but their per-subint flow is
not this scheduler's: subints go straight to the stream's session, or
under ``--mux`` onto the shared multiplexer ring, whose bounded
capacity + latency SLO is a second, finer backpressure boundary
(:mod:`iterative_cleaner_torch.online.mux`).  Only the close
reconciliation re-enters the queue (``enqueue_admitted``) to compete
with batch work for the single device worker.
"""

from __future__ import annotations

import heapq
import threading
import time
from typing import Dict, List, Optional, Tuple

from iterative_cleaner_torch.serve.request import ServeRequest, request_key


class Rejection(Exception):
    """An admission refusal: ``reason`` is one of ``queue_full``,
    ``tenant_limit``, ``draining``, ``duplicate``."""

    def __init__(self, reason: str, detail: str) -> None:
        super().__init__(detail)
        self.reason = reason
        self.detail = detail


class ServeScheduler:
    """Bounded priority/EDF queue with per-tenant admission control.

    Thread-safe; producers (HTTP handler threads, the spool watcher) call
    :meth:`submit`, the single worker loop calls :meth:`pop` /
    :meth:`mark_done`.  ``registry`` (a MetricsRegistry) receives the
    ``serve_*`` counters and queue-depth gauges."""

    def __init__(self, *, queue_limit: int, max_inflight: int,
                 registry=None, faults=None, tracer=None,
                 pool_inflight=None) -> None:
        self.queue_limit = int(queue_limit)
        self.max_inflight = int(max_inflight)
        self.registry = registry
        self.faults = faults
        self.tracer = tracer
        # elastic pools: tenant -> unfinished count across ALL members
        # (journal-backed); None keeps admission per-host
        self.pool_inflight = pool_inflight
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._heap: List[Tuple[Tuple, ServeRequest]] = []
        self._seq = 0
        # tenant -> admitted-but-unfinished count (queued + running)
        self._inflight: Dict[str, int] = {}
        self._known_ids: set = set()
        self._draining = False
        # request_id -> open queue-wait span (submit opens, pop closes)
        self._queue_spans: Dict[str, object] = {}

    # ------------------------------------------------------------ helpers
    def _count(self, name: str, n: float = 1.0) -> None:
        if self.registry is not None:
            self.registry.counter_inc(name, n)

    def _gauges(self) -> None:
        if self.registry is not None:
            self.registry.gauge_set("serve_queue_depth", len(self._heap))
            self.registry.gauge_set(
                "serve_requests_inflight",
                float(sum(self._inflight.values())))

    def _open_queue_span(self, req: ServeRequest) -> None:
        """Start the queue-wait span at admission: its duration IS the
        request's scheduling delay, stitched under the daemon's root
        request span (``req.root_span_id``, set by the daemon's admit)."""
        if self.tracer is None:
            return
        self._queue_spans[req.request_id] = self.tracer.start(
            "queue", trace_id=req.trace_id,
            parent_id=getattr(req, "root_span_id", None),
            subsystem="sched", lane="sched",
            request_id=req.request_id, tenant=req.tenant,
            priority=req.priority)

    def _close_queue_span(self, req: ServeRequest, status: str) -> None:
        span = self._queue_spans.pop(req.request_id, None)
        if span is not None:
            span.end(status=status)

    @property
    def draining(self) -> bool:
        with self._lock:
            return self._draining

    def start_drain(self) -> None:
        """Refuse all further admissions and wake any popper."""
        with self._lock:
            self._draining = True
            self._not_empty.notify_all()

    def depth(self) -> int:
        with self._lock:
            return len(self._heap)

    def queued_requests(self) -> List[ServeRequest]:
        """The still-queued requests (drain reporting; no pop)."""
        with self._lock:
            return [req for _k, req in sorted(self._heap)]

    # ---------------------------------------------------------- admission
    def submit(self, req: ServeRequest,
               already_journaled: bool = False,
               enqueue: bool = True) -> None:
        """Admit or raise :class:`Rejection`.  ``already_journaled``
        (restart re-enqueue) bypasses the duplicate check — the id is
        known precisely because the journal recorded it.

        ``enqueue=False`` admits WITHOUT queueing for the worker: the
        request passes every admission check and takes its tenant
        in-flight slot, but stays out of the heap.  This is the open
        phase of a stream request — it must count against backpressure
        from acceptance (an open stream is real admitted work), yet the
        single worker only runs it at close (:meth:`enqueue_admitted`)."""
        with self._lock:
            if self._draining:
                self._count("serve_rejected")
                raise Rejection("draining",
                                "daemon is draining; resubmit later")
            if not already_journaled and req.request_id in self._known_ids:
                self._count("serve_rejected")
                raise Rejection(
                    "duplicate",
                    f"request id {req.request_id!r} already admitted")
            if len(self._heap) >= self.queue_limit:
                self._count("serve_rejected")
                raise Rejection(
                    "queue_full",
                    f"queue at its bound ({self.queue_limit}); backpressure")
            inflight = self._inflight.get(req.tenant, 0)
            # the admission check may see a larger POOL-wide count, but
            # the stored counter stays strictly local: it only ever
            # decrements on local mark_done, so folding pool work into
            # it would inflate it permanently (spurious tenant_limit
            # 429s long after the pool went idle)
            effective = inflight
            if self.pool_inflight is not None and not already_journaled:
                # fair-share across the POOL: the journal sees every
                # member's unfinished requests; take the larger of the
                # two views (the local one includes admitted-but-not-
                # yet-journaled work the fold can't see yet)
                try:
                    effective = max(inflight,
                                    int(self.pool_inflight(req.tenant)))
                except Exception:  # noqa: BLE001 -- counted below
                    # a torn journal read must not wedge admission:
                    # degrade to the per-host view
                    self._count("serve_pool_view_errors")
            if effective >= self.max_inflight:
                self._count("serve_rejected")
                raise Rejection(
                    "tenant_limit",
                    f"tenant {req.tenant!r} at its in-flight cap "
                    f"({self.max_inflight})")
            self._known_ids.add(req.request_id)
            self._inflight[req.tenant] = inflight + 1
            self._count("serve_accepted")
            if enqueue:
                self._seq += 1
                heapq.heappush(self._heap,
                               (request_key(req, self._seq), req))
                self._open_queue_span(req)
                self._not_empty.notify()
            self._gauges()

    def enqueue_admitted(self, req: ServeRequest) -> None:
        """Queue a request previously admitted with ``enqueue=False`` (a
        stream reaching close).  No admission re-checks and no second
        accounting: the slot was taken at open."""
        with self._lock:
            self._seq += 1
            heapq.heappush(self._heap, (request_key(req, self._seq), req))
            self._open_queue_span(req)
            self._gauges()
            self._not_empty.notify()

    # ------------------------------------------------------------ serving
    def pop(self, timeout: Optional[float] = None
            ) -> Tuple[Optional[ServeRequest], List[ServeRequest]]:
        """Next request to run, blocking up to ``timeout`` seconds.

        Returns ``(request | None, expired)``: ``expired`` are requests
        whose deadline passed while queued — already charged
        (``serve_deadline_expired``) and removed; the caller journals them
        failed.  ``None`` request means timeout or drain with an empty
        queue.  The ``sched`` fault site fires here: an injected
        scheduler fault surfaces as a normal empty pop plus a
        ``serve_retries`` count — the daemon's loop simply comes back."""
        expired: List[ServeRequest] = []
        deadline = None if timeout is None else time.time() + timeout
        with self._lock:
            while True:
                if self.faults is not None:
                    try:
                        self.faults.fire("sched")
                    except Exception:  # noqa: BLE001 -- counted below
                        # a faulty scheduler pass never wedges or kills the
                        # daemon: charge a retry, hand back to the loop
                        self._count("serve_retries")
                        return None, expired
                now = time.time()
                while self._heap:
                    key, req = self._heap[0]
                    if req.expired(now):
                        heapq.heappop(self._heap)
                        self._count("serve_deadline_expired")
                        self._close_queue_span(req, "expired")
                        expired.append(req)
                        continue
                    break
                if self._heap:
                    _key, req = heapq.heappop(self._heap)
                    self._close_queue_span(req, "ok")
                    self._gauges()
                    return req, expired
                if self._draining:
                    return None, expired
                remaining = (None if deadline is None
                             else deadline - time.time())
                if remaining is not None and remaining <= 0:
                    return None, expired
                self._not_empty.wait(remaining)

    def mark_done(self, req: ServeRequest) -> None:
        """Release the tenant's in-flight slot (done, failed or expired —
        every admitted request must be marked exactly once)."""
        with self._lock:
            n = self._inflight.get(req.tenant, 0)
            if n <= 1:
                self._inflight.pop(req.tenant, None)
            else:
                self._inflight[req.tenant] = n - 1
            self._gauges()

    # ------------------------------------------------------ elastic pool
    def knows(self, request_id: str) -> bool:
        """Has this scheduler ever admitted ``request_id``?  The pool
        adoption scan uses this to skip requests already queued, running
        or finished HERE (the journal says what finished anywhere)."""
        with self._lock:
            return request_id in self._known_ids

    def forget(self, request_id: str) -> None:
        """Drop a request id from the admitted set — the claim-lost
        path: another member won the execution lease, so THIS member
        must be able to re-adopt the id later if that member dies
        (``already_journaled`` re-admission would also bypass the
        duplicate check, but a forgotten id keeps the set's size honest
        in a long-lived pool)."""
        with self._lock:
            self._known_ids.discard(request_id)
