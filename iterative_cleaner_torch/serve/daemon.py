"""The long-lived cleaning service: ``python -m iterative_cleaner_torch --serve``.

One process, alive across requests, so everything the batch CLI pays per
invocation is paid once: torch's start, the CUDA context, the kernel
library's load (its ``nvcc`` build only where ``--compile-cache`` has no
library for its sources), and the process-global caches (the bucket
warm-up memo, the DFT tables, the cell kernels' launch plans).  A
repeat-geometry request on a warm daemon is served entirely from
``fleet_precompile_hits`` with no kernel-library build.  Every request
cleans on the base config's device (the card by default): archive
requests through :func:`~iterative_cleaner_torch.parallel.fleet.
clean_fleet` (K1, K2 or K6 or K7, K3 x 2, the combine and K9, once per
batch iteration), stream requests through :class:`~iterative_cleaner_
torch.online.OnlineSession` (K6, K3 x 2 and the combine a subint) or,
with ``--mux``, the daemon's :class:`~iterative_cleaner_torch.online.
StreamMux`.  A request whose clean fails ends ``failed``; nothing is
retried on the host.  A request's ``backend`` override (the numpy oracle)
is part of its config's identity, not its engine (:func:`engine_config`).

Lifecycle (one request)::

    intake (spool scan / HTTP POST)          [intake fault site]
      -> admission  (ServeScheduler.submit)  -> 429/.rejected on pressure
      -> journal    "accepted" (+ full request description)
      -> scheduler  priority + earliest-deadline pop  [sched fault site]
      -> journal    "running"
      -> clean_fleet(resume=True, shared journal)  [peek/load/compile/
                                                    execute/write sites]
      -> journal    "done" | "failed"

Crash safety is the journal: a ``kill -9`` at ANY point restarts into
:meth:`ServeDaemon.recover`, which re-enqueues every request whose last
journaled state is non-terminal; the re-run goes through the fleet's
``resume`` path, so archives whose per-path 'done' entries verify are
skipped — zero duplicated cleans, byte-identical outputs.

Drain (SIGTERM/SIGINT): intake stops (HTTP 503, spool files untouched),
the in-flight request finishes and journals, queued requests stay
journaled 'accepted' for the next start, telemetry flushes, exit 0.
A second signal force-exits non-zero immediately.

**Elastic pool** (``--join``): daemons sharing one journal form a
coordinator-free pool.  Each member announces itself with journaled
membership leases (serve/membership.py), adopts journaled 'accepted'
requests from the shared fold — so ANY member may run the HTTP/spool
front door, and whichever healthy member pops a request first runs it —
and leases each request's execution through the journal's claim grammar
before running it, so two members popping the same request resolve to
exactly one winner.  A SIGKILLed member stops heartbeating: survivors
evict it (``serve_members_evicted``), steal its leased requests
(``serve_requests_stolen``, latency in ``serve_failover_s``) and the
fleet's per-archive journal entries keep the re-run exactly-once.  With
``--result-cache`` a completed request also indexes its outputs under
(input signature × config hash); an identical resubmission is answered
from the verified index with zero device work (serve/result_cache.py).
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import threading
import time
from typing import Dict, List, Optional

from iterative_cleaner_torch.config import CleanConfig, ServeConfig
from iterative_cleaner_torch.serve.request import (
    RequestError,
    ServeRequest,
    request_work_key,
)
from iterative_cleaner_torch.serve.scheduler import Rejection, ServeScheduler
from iterative_cleaner_torch.serve.spool import SpoolWatcher

FORCE_EXIT_CODE = 70  # second signal mid-drain: EX_SOFTWARE-ish, non-zero

# journal/request fields safe to echo back over GET /requests/<id>
_STATUS_FIELDS = ("state", "tenant", "priority", "deadline_ts",
                  "submitted_ts", "paths", "error", "n_cleaned",
                  "n_skipped", "n_failed", "n_cached", "duration_s",
                  "trace_id", "kind", "chunks", "n_ingested", "closed",
                  "n_subints", "out", "mask_drift", "reconciles",
                  "recompiles_steady", "subint_p99_ms", "member")


@dataclasses.dataclass
class _StreamState:
    """One open ``kind: "stream"`` request: its in-memory session plus
    the chunk/dedup bookkeeping mirrored into the journal.  ``lock``
    serializes the HTTP intake threads per stream (chunks within one
    stream are ordered; different streams ingest concurrently)."""

    req: ServeRequest
    session: object = None          # OnlineSession, built on first chunk
    chunks: List[str] = dataclasses.field(default_factory=list)
    keys: set = dataclasses.field(default_factory=set)
    lock: threading.Lock = dataclasses.field(default_factory=threading.Lock)
    closed: bool = False


def engine_config(cfg: CleanConfig) -> CleanConfig:
    """The config a request is cleaned under: its own with the torch
    engine.  The request's own config stays its identity (journal lines,
    result-cache key)."""
    # the reference's batched clean reads no backend, so a numpy request
    # is cleaned on the card there too
    return dataclasses.replace(cfg, backend="torch")


def default_out_path(p: str) -> str:
    """The CLI's default output naming (``--output ""``): daemon outputs
    are bit-identical to a batch-CLI run over the same archives."""
    return p + "_cleaned" + (os.path.splitext(p)[1] or ".npz")


class ServeDaemon:
    """Composes ServeConfig + CleanConfig + scheduler + intakes + journal
    around a single-worker serve loop (device compute is serialized by
    design — one card, one fleet at a time; concurrency lives in the
    fleet's own IO pools).  The base config's device must exist: with
    ``device="cuda"`` (the default) and no card the constructor raises."""

    def __init__(self, serve_config: ServeConfig, base_config: CleanConfig,
                 *, registry=None, faults=None, retry=None,
                 stage_timeout_s: Optional[float] = None,
                 io_workers: Optional[int] = None,
                 quiet: bool = False, events=None) -> None:
        from iterative_cleaner_torch.backends.torch_backend import (
            resolve_device,
        )
        from iterative_cleaner_torch.resilience import (
            FleetJournal,
            RetryPolicy,
            resolve_retries,
            resolve_stage_timeout,
        )
        from iterative_cleaner_torch.telemetry import (
            MetricsRegistry,
            profiling,
        )
        from iterative_cleaner_torch.telemetry.recorder import (
            FlightRecorder,
            set_active,
        )
        from iterative_cleaner_torch.telemetry.tracing import (
            Tracer,
            spool_path_for,
        )

        # the card must be there (no card, no daemon): resolve_device
        # raises for a CUDA device with none present
        resolve_device(base_config.device)
        self.serve_config = serve_config
        self.base_config = base_config
        self.registry = registry if registry is not None else MetricsRegistry()
        self.faults = faults
        if self.faults is not None:
            self.faults.bind(self.registry)
        self.retry = retry if retry is not None else RetryPolicy(
            max_retries=resolve_retries(
                getattr(base_config, "fleet_retries", None)))
        self.stage_timeout_s = resolve_stage_timeout(
            stage_timeout_s if stage_timeout_s is not None
            else getattr(base_config, "stage_timeout_s", None))
        self.io_workers = io_workers
        self.quiet = quiet
        self.events = events
        self.journal = FleetJournal(
            serve_config.journal_path, registry=self.registry,
            segment_mb=getattr(serve_config, "journal_segment_mb", None))
        # the black box: always armed in a daemon (a crash with no dump
        # is the failure mode this PR exists to kill); path "" disables.
        self.recorder = (FlightRecorder(path=serve_config.flight_recorder)
                         if serve_config.flight_recorder else None)
        set_active(self.recorder)
        # spans are always recorded in-memory (bounded; they feed
        # GET /trace/<id> and the flight recorder); the spool/Perfetto
        # export only exists under --trace-out, the event-log export
        # only under an events sink.
        self.trace_out = serve_config.trace_out or None
        self.tracer = Tracer(
            host="serve",
            spool_path=(spool_path_for(self.trace_out)
                        if self.trace_out else None),
            events=events, recorder=self.recorder)
        # leaf lock for daemon-local maps written from both the HTTP
        # handler threads and the worker loop (_streams, _root_spans,
        # _pool_fold, _journal_read_ts): held only around the dict/
        # scalar op itself, NEVER across a journal or scheduler call
        self._state_lock = threading.Lock()
        self._root_spans: Dict[str, object] = {}
        # elastic pool membership (--join): None for a standalone daemon
        self.membership = None
        if serve_config.join:
            from iterative_cleaner_torch.serve.membership import (
                PoolMembership,
            )

            self.membership = PoolMembership(
                self.journal, ttl_s=serve_config.member_ttl_s,
                registry=self.registry)
        # content-addressed result cache (--result-cache)
        self.result_cache = None
        if serve_config.result_cache:
            from iterative_cleaner_torch.serve.result_cache import (
                ResultCache,
            )

            self.result_cache = ResultCache(self.journal,
                                            registry=self.registry)
        self.scheduler = ServeScheduler(
            queue_limit=serve_config.queue_limit,
            max_inflight=serve_config.max_inflight,
            registry=self.registry, faults=self.faults,
            tracer=self.tracer,
            pool_inflight=(self._pool_tenant_inflight
                           if self.membership is not None else None))
        self.spool = (SpoolWatcher(
            serve_config.spool_dir,
            on_request=lambda req, _path: self.admit(req, source="spool"),
            base_config=base_config, registry=self.registry,
            faults=self.faults)
            if serve_config.spool_dir else None)
        self._httpd = None
        self._http_thread = None
        self._signals = 0
        self._started_ts = time.time()
        self._running_id: Optional[str] = None
        # when this process last derived state from the journal fold —
        # /healthz reports the age as journal_lag_s (in a pool, the
        # liveness of the eviction/adoption scanner)
        self._journal_read_ts: Optional[float] = None
        self._last_pool_scan = 0.0
        # adoption/eviction scan cadence: a fraction of the membership
        # ttl so a lapsed member is noticed well within one lease
        self._pool_scan_s = min(1.0, serve_config.member_ttl_s / 3.0)
        # memoized request-state fold for pool admission: every submit
        # consults the pool-wide tenant view under the scheduler lock,
        # and re-reading the whole journal per request would make
        # admission latency grow with journal size.  A briefly stale
        # fold is safe — the scheduler takes max(local, pool), so the
        # local counter still bounds what the fold hasn't seen yet.
        self._pool_fold = (0.0, None)
        self._pool_fold_ttl_s = min(0.5, self._pool_scan_s)
        # the running request's execution-lease heartbeat (elastic only)
        self._exec_hb = None
        # open online streams by request id (kind: "stream"); entries
        # leave at finalize (worker pop after close) or terminal failure
        self._streams: Dict[str, _StreamState] = {}
        # stream multiplexer (--mux): all kind:"stream" requests share
        # one StreamMux — concurrent streams' subints coalesce into one
        # batched dispatch per tick instead of one launch per stream.
        # Journal/dedup/replay semantics are untouched: the mux sits
        # strictly between the (already journaled) ingest and the device
        self.mux = None
        if serve_config.mux:
            from iterative_cleaner_torch.online.mux import StreamMux

            self.mux = StreamMux(
                max_batch=serve_config.mux_max_batch,
                max_wait_ms=serve_config.mux_max_wait_ms,
                registry=self.registry, tracer=self.tracer)
        # POST /profile serialization: torch.profiler runs one trace at a
        # time, so a second capture while one runs is a 409, not a queue
        self._profile_lock = threading.Lock()
        # --profile-dir also turns on the profiler's first-call peak
        # measurements of the bucket, online and mux programs
        self._profiling_set = bool(serve_config.profile_dir)
        if self._profiling_set:
            profiling.set_enabled(True)

    # ------------------------------------------------------------- intake
    def admit(self, req: ServeRequest, source: str) -> None:
        """Admission + journal, in that order: a rejected request never
        reaches the journal (a restart must not resurrect it), and a
        crash after admission but before the journal append loses only a
        request its submitter never saw acknowledged (the HTTP 200 /
        spool ``.accepted`` rename both happen strictly after this
        returns) — so the submitter's retry is correct.

        The worker queue is fed strictly AFTER the 'accepted' line lands:
        admission takes the slot without enqueueing, the journal append
        happens, then the request becomes poppable.  A result-cache hit
        finishes in microseconds, so enqueueing first would let the
        worker's 'running'/'done' lines race ahead of this thread's
        'accepted' line — and a journal whose last line says 'accepted'
        reads as unfinished forever (and adoptable by pool peers)."""
        self._open_root_span(req, source=source)
        try:
            # a stream is admitted (slot taken, backpressure counted) but
            # never queued here: the worker only runs it once it closes
            self.scheduler.submit(req, enqueue=False)
        except Rejection:
            with self._state_lock:
                self._root_spans.pop(req.request_id, None)  # never admitted
            raise
        if req.kind == "stream":
            with self._state_lock:
                self._streams[req.request_id] = _StreamState(req=req)
        extra = {}
        if self.membership is not None:
            # which member's front door accepted it — pool members use
            # this to leave a LIVE acceptor's streams alone
            extra["member"] = self.membership.member_id
        try:
            self.journal.record_request(req.request_id, "accepted",
                                        source=source, **extra,
                                        **req.journal_fields())
        except Exception:
            # the journal append failed (disk full, I/O error): the
            # request was never acknowledged, so roll the admission all
            # the way back — otherwise the tenant slot leaks forever and
            # the id stays in the known set, poisoning the submitter's
            # documented-correct retry as a 'duplicate'
            with self._state_lock:
                self._streams.pop(req.request_id, None)
            self.scheduler.mark_done(req)
            self.scheduler.forget(req.request_id)
            self._close_root_span(req, "error")
            raise
        if req.kind != "stream":
            self.scheduler.enqueue_admitted(req)
        if req.kind == "stream":
            self._say("serve: opened stream %s (%s, tenant=%s)"
                      % (req.request_id, source, req.tenant))
        else:
            self._say("serve: accepted %s (%s, tenant=%s, %d path%s)"
                      % (req.request_id, source, req.tenant, len(req.paths),
                         "" if len(req.paths) == 1 else "s"))

    def recover(self) -> int:
        """Re-enqueue every journaled request whose last state is
        non-terminal (the crash-restart path).  Returns how many.

        In a pool the journal also holds OTHER members' work: requests
        under a live member's execution lease, and streams whose
        accepting member is alive, stay theirs (the adoption scan picks
        them up later if that member lapses); everything else — a dead
        member's requests included — re-enqueues here exactly like our
        own."""
        from iterative_cleaner_torch.resilience.journal import (
            REQUEST_TERMINAL,
        )

        n = 0
        roster: Dict[str, dict] = {}
        claims: Dict[str, dict] = {}
        if self.membership is not None:
            now = time.time()
            roster = self.membership.members(now=now)
            claims = self.journal.claim_table(now=now)
            with self._state_lock:
                self._journal_read_ts = now
        for rid, view in sorted(self.journal.request_states().items()):
            if view.get("state") in REQUEST_TERMINAL:
                continue
            if self._owned_elsewhere(rid, view, roster, claims):
                continue
            try:
                req = ServeRequest.from_journal_entry(rid, view)
                if req.kind == "stream":
                    n += self._recover_stream(rid, req, view)
                    continue
                self._open_root_span(req, source="recover")
                self.scheduler.submit(req, already_journaled=True)
            except (RequestError, Rejection) as exc:
                # un-replayable (compacted away, corrupt, or beyond the
                # queue bound): fail it terminally rather than loop on it
                with self._state_lock:
                    self._root_spans.pop(rid, None)
                self.journal.record_request(rid, "failed",
                                            error=f"unrecoverable: {exc}")
                self.registry.counter_inc("serve_failed")
                continue
            n += 1
        if n:
            self.registry.counter_inc("serve_recovered", n)
            self._say("serve: recovered %d journaled request%s"
                      % (n, "" if n == 1 else "s"))
        return n

    # ------------------------------------------------------ elastic pool
    def _owned_elsewhere(self, rid: str, view: dict, roster: dict,
                         claims: dict) -> bool:
        """Is this journaled request another LIVE member's to run?

        A live execution lease held by a foreign nonce always wins.  A
        stream additionally belongs to its accepting member while that
        member lives (its session is in-memory there; chunks keep
        POSTing to its front door) — but a dead acceptor's stream is
        adoptable, replayed from its journaled chunk files."""
        if self.membership is None:
            return False
        owner = claims.get(request_work_key(rid))
        if (owner is not None and owner.get("live")
                and owner.get("nonce") != self.membership.member_id):
            return True
        if (view.get("kind") or "clean") == "stream":
            member = view.get("member")
            if member and member != self.membership.member_id:
                lease = roster.get(member)
                if lease is not None and lease.get("live"):
                    return True
        return False

    def _pool_tenant_inflight(self, tenant: str) -> int:
        """The scheduler's pool-wide fair-share view: how many of this
        tenant's requests are journaled non-terminal anywhere in the
        pool (every member's front door folds the same journal).  The
        fold is memoized for ``_pool_fold_ttl_s`` so a submission burst
        costs one journal read, not one per request."""
        from iterative_cleaner_torch.resilience.journal import (
            REQUEST_TERMINAL,
        )

        now = time.time()
        with self._state_lock:
            ts, states = self._pool_fold
        if states is None or now - ts > self._pool_fold_ttl_s:
            states = self.journal.request_states()
            with self._state_lock:
                self._pool_fold = (now, states)
                self._journal_read_ts = now
        return sum(1 for view in states.values()
                   if view.get("state") not in REQUEST_TERMINAL
                   and str(view.get("tenant") or "default") == str(tenant))

    def _elastic_tick(self) -> None:
        """One pool-maintenance pass from the daemon loop: heartbeat our
        membership lease (self-throttled), then — on the scan cadence —
        observe evictions and adopt adoptable journaled requests."""
        if self.membership is None:
            return
        now = time.time()
        self.membership.heartbeat(now=now)
        if now - self._last_pool_scan < self._pool_scan_s:
            return
        self._last_pool_scan = now
        for member in self.membership.evict_lapsed(now=now):
            self._say("serve: evicted member %s (heartbeat lapsed; "
                      "its requests are now stealable)" % member)
        self._poll_pool(now)

    def _poll_pool(self, now: float) -> None:
        """Adopt journaled 'accepted'/'running' requests this member can
        run: anything non-terminal, not already known here, and not
        another live member's (:meth:`_owned_elsewhere`).  This is both
        halves of elasticity in one scan — load sharing (a healthy
        peer's queued intake is claimed by whoever pops first) and
        failover (a dead member's leases expired, so its requests stop
        being owned elsewhere).  Hash affinity only ORDERS adoption
        (members prefer their own shard of the id space, shrinking
        claim races); any member takes any request once it is free."""
        from iterative_cleaner_torch.parallel.distributed import shard_owner
        from iterative_cleaner_torch.resilience.journal import (
            REQUEST_TERMINAL,
        )

        states = self.journal.request_states()
        claims = self.journal.claim_table(now=now)
        roster = self.membership.members(now=now)
        with self._state_lock:
            self._journal_read_ts = now
        live = [m for m, lease in roster.items() if lease["live"]]
        candidates = []
        for rid, view in states.items():
            if view.get("state") in REQUEST_TERMINAL:
                continue
            if self.scheduler.knows(rid):
                continue
            if self._owned_elsewhere(rid, view, roster, claims):
                continue
            candidates.append(rid)
        candidates.sort(key=lambda rid: (
            0 if shard_owner(rid, live) == self.membership.member_id else 1,
            rid))
        for rid in candidates:
            if (states[rid].get("kind") or "clean") == "stream":
                # a stream reaching here lost its acceptor (the member
                # lease on its 'member' field lapsed — a live acceptor
                # is _owned_elsewhere): replay it from journaled chunks
                self._adopt_stream(rid, states[rid], now)
                continue
            try:
                req = ServeRequest.from_journal_entry(rid, states[rid])
                self._open_root_span(req, source="pool")
                self.scheduler.submit(req, already_journaled=True)
            except RequestError as exc:
                with self._state_lock:
                    self._root_spans.pop(rid, None)
                self.journal.record_request(rid, "failed",
                                            error=f"unrecoverable: {exc}")
                self.registry.counter_inc("serve_failed")
                continue
            except Rejection:
                # our queue is full right now; the request stays
                # journaled and the next scan (or another member) takes it
                with self._state_lock:
                    self._root_spans.pop(rid, None)
                break
            self.registry.counter_inc("serve_pool_adopted")
            self._say("serve: adopted %s from the pool" % rid)

    def _adopt_stream(self, rid: str, view: dict, now: float) -> None:
        """Adopt a dead acceptor's stream at loop time — the in-memory
        session died with its member, so replay the journaled chunks
        into a fresh one exactly like the restart path, then journal a
        'running' line re-homing the stream's ``member`` field so peers
        see the new live acceptor (and the client's re-POSTed chunks,
        re-routed to any surviving front door, dedup against the
        restored keys).  Without this, a stream whose acceptor crash-
        restarted under a fresh member id — leaving the stale lease to
        block recover() — would stay non-terminal forever.

        Two survivors scanning concurrently are serialized through the
        claim grammar: exactly one wins the adoption lease; it is
        released once the re-home line landed (ownership rides the
        member field + our live membership lease from then on)."""
        work = request_work_key(rid)
        won = self.journal.try_claim(
            work, host=self.membership.host,
            nonce=self.membership.member_id,
            ttl_s=self.serve_config.member_ttl_s, now=now,
            trace=({"trace_id": view["trace_id"]}
                   if view.get("trace_id") else None))
        if not won:
            self.registry.counter_inc("serve_claim_lost")
            return
        try:
            try:
                req = ServeRequest.from_journal_entry(rid, view)
            except RequestError as exc:
                self.journal.record_request(rid, "failed",
                                            error=f"unrecoverable: {exc}")
                self.registry.counter_inc("serve_failed")
                return
            if not self._recover_stream(rid, req, view, source="pool",
                                        fail_on_reject=False):
                return
            self.journal.record_request(rid, "running",
                                        member=self.membership.member_id)
            self.registry.counter_inc("serve_pool_adopted")
            self._say("serve: adopted stream %s from the pool" % rid)
        finally:
            try:
                # stamp with the same scan clock as the claim: a release
                # stamped behind its own claim line breaks the journal's
                # lease monotonicity (fsck flags it as replayed lines)
                self.journal.release(work, host=self.membership.host,
                                     nonce=self.membership.member_id,
                                     now=now)
            except OSError:
                pass  # an unreleased adoption lease merely expires

    def _claim_for_execute(self, req: ServeRequest) -> bool:
        """Lease this request's execution through the journal before
        running it (pool members only; streams are session-local and a
        standalone daemon is its own pool).  Returns False when another
        member holds the lease — the caller drops the request and lets
        the winner run it.  Winning a lease a LAPSED member held is a
        steal: counted, timed (``serve_failover_s`` measures now minus
        the victim's last sign of life) and re-parented under the
        originating trace exactly like stolen fleet buckets."""
        if self.membership is None or req.kind == "stream":
            return True
        work = request_work_key(req.request_id)
        now = time.time()
        prev = self.journal.claim_table(now=now).get(work)
        won = self.journal.try_claim(
            work, host=self.membership.host,
            nonce=self.membership.member_id,
            ttl_s=self.serve_config.member_ttl_s, now=now,
            trace={"trace_id": req.trace_id,
                   "span_id": req.root_span_id})
        if not won:
            self.registry.counter_inc("serve_claim_lost")
            return False
        if (prev is not None
                and prev.get("nonce") != self.membership.member_id
                and prev.get("expires", 0.0) <= now):
            from iterative_cleaner_torch.telemetry.registry import SECONDS

            failover = max(
                now - (prev["expires"] - prev.get("ttl", 0.0)), 0.0)
            self.registry.counter_inc("serve_requests_stolen")
            self.registry.histogram_observe("serve_failover_s", failover,
                                            buckets=SECONDS)
            self.registry.gauge_set("serve_last_failover_s",
                                    round(failover, 3))
            self._say("serve: stole %s from lapsed member (%.1fs since "
                      "its last heartbeat)" % (req.request_id, failover))
        from iterative_cleaner_torch.parallel.fleet import ClaimHeartbeat

        self._exec_hb = ClaimHeartbeat(
            self.journal, work, self.membership.host,
            self.membership.member_id, self.serve_config.member_ttl_s,
            registry=self.registry, counter="serve_heartbeat_errors")
        return True

    def _release_execute_claim(self, req: ServeRequest) -> None:
        hb, self._exec_hb = self._exec_hb, None
        if hb is not None:
            hb.stop()
        if self.membership is None or req.kind == "stream":
            return
        try:
            self.journal.release(request_work_key(req.request_id),
                                 host=self.membership.host,
                                 nonce=self.membership.member_id)
        except OSError:
            pass  # an unreleased lease merely expires

    # ------------------------------------------------------ observability
    def _open_root_span(self, req: ServeRequest, *, source: str) -> None:
        """The request's root span: intake → terminal state.  Everything
        else (queue wait, execute, every fleet stage on every host)
        parents under it via ``req.trace_id``/``req.root_span_id``."""
        root = self.tracer.start(
            "request", trace_id=req.trace_id, subsystem="serve",
            lane="serve", request_id=req.request_id, tenant=req.tenant,
            source=source, n_paths=len(req.paths))
        req.root_span_id = root.span_id
        with self._state_lock:
            self._root_spans[req.request_id] = root

    def _close_root_span(self, req: ServeRequest, status: str) -> None:
        with self._state_lock:
            root = self._root_spans.pop(req.request_id, None)
        if root is not None:
            root.end(status=status)

    def health(self) -> dict:
        """GET /healthz: one signal shared by the pool's eviction logic
        and external load balancers — liveness, drain state, this
        member's roster view and how stale its journal fold is."""
        snap = self.registry.snapshot()
        counters = snap.get("counters", {})
        draining = self.scheduler.draining
        now = time.time()
        if self.membership is not None:
            table = self.membership.members(now=now)
            members = {
                "n": sum(1 for lease in table.values() if lease["live"]),
                "self": "draining" if draining else "member",
                "id": self.membership.member_id,
                "evicted": int(counters.get("serve_members_evicted", 0)),
            }
        else:
            members = {"n": 1,
                       "self": "draining" if draining else "standalone",
                       "id": None, "evicted": 0}
        mux = None
        if self.mux is not None:
            mux = {
                "streams": len(self.mux.streams()),
                "pending": self.mux.pending(),
                "dispatches": self.mux.dispatches,
                "max_batch": self.mux.max_batch,
                "max_wait_ms": self.mux.max_wait_ms,
                "recompiles_steady": self.mux.recompiles_steady,
            }
        return {
            "status": "draining" if draining else "ok",
            "draining": draining,
            "pid": os.getpid(),
            "uptime_s": round(now - self._started_ts, 3),
            "queued": self.scheduler.depth(),
            "running": self._running_id,
            "streams": len(self._streams),
            "mux": mux,
            "members": members,
            # age of this process's last journal fold: None before the
            # first fold, else how far behind the shared state the
            # eviction/adoption scanner is running
            "journal_lag_s": (round(now - self._journal_read_ts, 3)
                              if self._journal_read_ts is not None
                              else None),
            # which JournalLog backend this pool folds over, and — for
            # the segmented one — the live sealed-segment count per
            # shard (the shape a maintenance-role stall shows up in)
            "journal_backend": self.journal.backend,
            "journal_segments": ({str(k): v for k, v in
                                  sorted(self.journal.segment_counts()
                                         .items())}
                                 if self.journal.backend == "segmented"
                                 else None),
            "accepted": int(counters.get("serve_accepted", 0)),
            "completed": int(counters.get("serve_completed", 0)),
            "failed": int(counters.get("serve_failed", 0)),
            "rejected": int(counters.get("serve_rejected", 0)),
            "deadline_expired": int(
                counters.get("serve_deadline_expired", 0)),
        }

    def request_state(self, request_id: str) -> Optional[dict]:
        """The journaled lifecycle view of one request (GET
        /requests/<id>) — reading the journal means the answer survives
        restarts and never races the worker loop."""
        view = self.journal.request_states().get(request_id)
        with self._state_lock:
            self._journal_read_ts = time.time()
        if view is None:
            return None
        doc = {k: view[k] for k in _STATUS_FIELDS if k in view}
        doc["id"] = request_id
        return doc

    def trace_view(self, trace_or_request_id: str) -> Optional[dict]:
        """GET /trace/<id>: the finished spans of one trace, accepting
        either the trace id itself or a request id (resolved through the
        journal, so it works after the in-memory request map moved on)."""
        spans = self.tracer.spans_for(trace_or_request_id)
        trace_id = trace_or_request_id
        if not spans:
            view = self.journal.request_states().get(trace_or_request_id)
            if view is None or not view.get("trace_id"):
                return None
            trace_id = str(view["trace_id"])
            spans = self.tracer.spans_for(trace_id)
        return {"trace_id": trace_id, "n_spans": len(spans), "spans": spans}

    def debug_vars(self) -> dict:
        """GET /debug/vars: one scrape with everything a live debugging
        session starts from — health, config, counters, recent spans."""
        snap = self.registry.snapshot()
        return {
            "health": self.health(),
            "serve_config": dataclasses.asdict(self.serve_config),
            "counters": snap.get("counters", {}),
            "gauges": snap.get("gauges", {}),
            "recent_spans": self.tracer.recent(50),
            "flight_recorder": getattr(self.recorder, "path", None),
            "trace_out": self.trace_out,
            "program_costs": self._program_costs(),
            "kernel_launches": self._kernel_launches(),
        }

    @staticmethod
    def _kernel_launches() -> dict:
        """The process's kernel launch counts since it started (the
        wrappers' counters of ``stats/kernels.py``; none on the CPU),
        the launched ones only."""
        from iterative_cleaner_torch.stats.kernels import launch_counts

        return {k: v for k, v in launch_counts().items() if v}

    @staticmethod
    def _program_costs() -> dict:
        from iterative_cleaner_torch.telemetry import profiling

        return profiling.costs_snapshot()  # already plain dicts

    def profile_capture(self, seconds: float) -> dict:
        """POST /profile: capture ``seconds`` of ``torch.profiler`` trace
        (CPU and CUDA activities: the worker's kernels, whatever request
        runs meanwhile) into the configured ``profile_dir`` and publish it
        atomically.  Runs on the handler's own thread
        (ThreadingHTTPServer), so other scrapes keep flowing while the
        capture sleeps; a concurrent second capture is refused, not
        queued, and a capture that cannot start raises its error (no
        host timer stands in for it)."""
        from iterative_cleaner_torch.telemetry import profiling

        if not self.serve_config.profile_dir:
            raise RequestError(
                "profiling is disabled: start the daemon with "
                "--profile-dir/ICLEAN_PROFILE_DIR to enable POST /profile")
        if not 0 < seconds <= 60:
            raise RequestError(
                f"seconds must be in (0, 60], got {seconds}")
        if not self._profile_lock.acquire(blocking=False):
            raise Rejection("profile_busy",
                            "a profile capture is already in progress")
        try:
            out_dir = profiling.capture_for(
                self.serve_config.profile_dir, seconds,
                registry=self.registry, label="on-demand")
        except profiling.CaptureBusy as exc:
            raise Rejection("profile_busy", str(exc)) from None
        finally:
            self._profile_lock.release()
        self.registry.counter_inc("serve_profile_captures")
        return {"profile_dir": out_dir, "seconds": seconds}

    def quality_view(self) -> dict:
        """GET /quality: per-stream quality summaries (zap fraction,
        drift baseline, alerts) for every open online session, plus the
        registry's quality_* series.  Stream list is copied under the
        state lock; each session's summary is read without holding any
        daemon lock (QualityMonitor methods only touch its own state)."""
        with self._state_lock:
            streams = list(self._streams.items())
        per_stream = {}
        for rid, st in streams:
            sess = st.session
            mon = getattr(sess, "quality", None) if sess else None
            if mon is not None:
                per_stream[rid] = mon.summary()
        snap = self.registry.snapshot()
        series = {}
        for group in ("counters", "gauges"):
            for k, v in snap.get(group, {}).items():
                if k.startswith("quality_"):
                    series[k] = v
        return {"streams": per_stream, "series": series}

    def _say(self, msg: str) -> None:
        if not self.quiet:
            print(msg, flush=True)

    # ------------------------------------------------------------ serving
    def _execute(self, req: ServeRequest) -> None:
        """Run one admitted request through the fleet.  Every archive-level
        recovery (retry ladder, OOM splits, degradation) happens inside
        clean_fleet; here a request only ends 'done' (all paths cleaned or
        journal-skipped) or 'failed' (any path failed, or the overrides/
        setup raised)."""
        from iterative_cleaner_torch.parallel.fleet import clean_fleet
        from iterative_cleaner_torch.resilience import ResiliencePlan

        if req.kind == "stream":
            self._execute_stream(req)
            return
        self._running_id = req.request_id
        self.journal.record_request(req.request_id, "running")
        mark = self.registry.counters_mark()
        t0 = time.perf_counter()
        span = self.tracer.start(
            "execute", trace_id=req.trace_id,
            parent_id=req.root_span_id, subsystem="serve", lane="serve",
            request_id=req.request_id, tenant=req.tenant)
        cfg_hash = None
        try:
            cfg = req.effective_config(self.base_config)
            if self.result_cache is not None:
                from iterative_cleaner_torch.utils.checkpoint import (
                    config_hash,
                )

                cfg_hash = config_hash(cfg)
                hits = self.result_cache.lookup(req.paths, cfg_hash)
                if hits is not None:
                    # every path's output verified against its recorded
                    # signatures: answer without touching the device —
                    # no load, no compile, no execute, no fleet spans
                    dt = time.perf_counter() - t0
                    span.set("cached", True)
                    span.set("n_cached", len(hits))
                    span.end(status="ok")
                    self.journal.record_request(
                        req.request_id, "done", n_cached=len(hits),
                        n_cleaned=0, n_skipped=0, n_failed=0,
                        duration_s=round(dt, 6))
                    self.registry.counter_inc("serve_completed")
                    self._observe_latency(req, dt)
                    self._close_root_span(req, "ok")
                    self._say("serve: done %s from result cache "
                              "(%d path%s, %.3fs, zero device work)"
                              % (req.request_id, len(hits),
                                 "" if len(hits) == 1 else "s", dt))
                    return
            plan = ResiliencePlan(
                faults=self.faults, retry=self.retry,
                stage_timeout_s=self.stage_timeout_s,
                journal=self.journal, resume=True)
            report = clean_fleet(
                req.paths, engine_config(cfg), identity=cfg,
                registry=self.registry,
                io_workers=self.io_workers,
                write_fn=self._write_one, resilience=plan,
                out_path_fn=default_out_path,
                tracer=self.tracer, trace=span.context())
        except Exception as exc:  # noqa: BLE001 -- setup/override errors, not per-archive: the request fails
            dt = time.perf_counter() - t0
            span.event("error", type=type(exc).__name__,
                       message=str(exc)[:200])
            span.end(status="error")
            self.journal.record_request(
                req.request_id, "failed",
                error=f"{type(exc).__name__}: {exc}",
                duration_s=round(dt, 6))
            self.registry.counter_inc("serve_failed")
            self._observe_latency(req, dt)
            self._close_root_span(req, "failed")
            self._say("serve: failed %s: %s" % (req.request_id, exc))
            return
        finally:
            self._running_id = None
        dt = time.perf_counter() - t0
        delta = self.registry.counters_since(mark)
        fields = {
            "n_cleaned": len(report.results),
            "n_skipped": len(report.skipped),
            "n_failed": len(report.failures),
            "duration_s": round(dt, 6),
        }
        span.set("n_cleaned", len(report.results))
        span.set("n_failed", len(report.failures))
        span.end(status="ok" if report.ok else "failed")
        self._observe_latency(req, dt)
        if report.ok:
            self.journal.record_request(req.request_id, "done", **fields)
            self.registry.counter_inc("serve_completed")
            if self.result_cache is not None and cfg_hash is not None:
                # index the finished outputs so an identical resubmission
                # anywhere in the pool answers with zero device work
                self.result_cache.publish(
                    req.paths, cfg_hash, out_path_fn=default_out_path,
                    trace={"trace_id": req.trace_id,
                           "span_id": req.root_span_id})
            self._close_root_span(req, "ok")
            self._say("serve: done %s (%d cleaned, %d resumed, %.2fs, "
                      "%d precompile hits)"
                      % (req.request_id, len(report.results),
                         len(report.skipped), dt,
                         int(delta.get("fleet_precompile_hits", 0))))
        else:
            stages = ", ".join("%s@%s" % (os.path.basename(p), stage)
                               for p, stage, _exc in report.failures[:4])
            self.journal.record_request(
                req.request_id, "failed",
                error=f"{len(report.failures)} archive(s) failed: {stages}",
                **fields)
            self.registry.counter_inc("serve_failed")
            self._close_root_span(req, "failed")
            self._say("serve: failed %s (%d of %d archives)"
                      % (req.request_id, len(report.failures),
                         len(req.paths)))

    # ------------------------------------------------------------ streams
    def stream_ingest(self, request_id: str, chunk_path: str,
                      seq=None) -> dict:
        """One subint chunk into an open stream (POST /stream/<id>/subint).

        Dedup key = ``seq`` (client sequence number) when given, else the
        chunk path.  A key already journaled answers ``duplicate: true``
        WITHOUT re-ingesting — so a client blindly re-POSTing after a
        daemon restart is idempotent, and the SIGKILL-resume test can
        assert zero duplicate ingests.  The journal 'running' entry
        carries the CUMULATIVE chunk list: compaction keeps one merged
        line per request, so state must never ride deltas."""
        st = self._streams.get(request_id)
        if st is None:
            raise RequestError(
                f"no open stream {request_id!r} (not opened, already "
                f"closed, or finished)")
        with st.lock:
            if st.closed:
                raise RequestError(
                    f"stream {request_id!r} is closed; no further subints")
            if self.scheduler.draining:
                raise Rejection("draining",
                                "daemon is draining; resubmit later")
            key = str(seq) if seq is not None else str(chunk_path)
            if key in st.keys:
                self.registry.counter_inc("online_duplicate_subints")
                return {"duplicate": True, "id": request_id, "seq": seq,
                        "n_ingested": len(st.chunks)}
            n = self._ingest_chunk(st, str(chunk_path))
            st.chunks.append(str(chunk_path))
            st.keys.add(key)
            # an open stream is acceptor-local while the acceptor's
            # MEMBERSHIP lease lives (peers see it as owned via the
            # 'member' field); the execution claim exists from close on
            # icln: ignore[journal-append-without-claim] -- acceptor-owned line
            self.journal.record_request(
                request_id, "running", chunks=list(st.chunks),
                keys=sorted(st.keys), n_ingested=len(st.chunks))
            return {"ingested": True, "id": request_id, "seq": seq,
                    "n_ingested": len(st.chunks), "n_subints": n}

    def stream_close(self, request_id: str) -> dict:
        """End an open stream (POST /stream/<id>/close): the request now
        queues for the worker, whose pop runs the close reconciliation
        and writes the cleaned archive.  Idempotent — a repeat close
        answers ``duplicate: true``."""
        st = self._streams.get(request_id)
        if st is None:
            raise RequestError(
                f"no open stream {request_id!r} (not opened, already "
                f"closed, or finished)")
        with st.lock:
            if st.closed:
                return {"closed": True, "duplicate": True,
                        "id": request_id, "n_ingested": len(st.chunks)}
            if not st.chunks:
                raise RequestError(
                    f"stream {request_id!r} has no ingested subints; "
                    f"POST at least one chunk before closing")
            st.closed = True
            # the close line is still the acceptor's (membership lease,
            # not execution claim): the worker claims when it pops
            # icln: ignore[journal-append-without-claim] -- acceptor-owned line
            self.journal.record_request(
                request_id, "running", closed=True,
                chunks=list(st.chunks), keys=sorted(st.keys),
                n_ingested=len(st.chunks))
        self.scheduler.enqueue_admitted(st.req)
        self._say("serve: closed stream %s (%d subints), queued for "
                  "reconcile" % (request_id, len(st.chunks)))
        return {"closed": True, "id": request_id,
                "n_ingested": len(st.chunks)}

    def _ingest_chunk(self, st: _StreamState, chunk_path: str) -> int:
        """Load one chunk file and feed it to the stream's session
        (created lazily on the first chunk, with the request's effective
        config).  IO and geometry errors become RequestError — a bad
        chunk 400s, it never kills the daemon."""
        from iterative_cleaner_torch.online.chunks import (
            StreamMeta,
            load_chunk,
        )
        from iterative_cleaner_torch.online.session import OnlineSession

        meta = None
        if st.session is not None:
            meta = st.session.meta
        elif st.req.meta:
            meta = StreamMeta.from_dict(st.req.meta)
        try:
            data, weights, meta = load_chunk(chunk_path, meta)
        except (OSError, ValueError) as exc:
            raise RequestError(
                f"chunk {os.path.basename(chunk_path)!r}: {exc}") from exc
        if st.session is None:
            cfg = st.req.effective_config(self.base_config)
            if self.mux is not None:
                st.session = self.mux.open(
                    st.req.request_id, meta, engine_config(cfg),
                    trace_id=st.req.trace_id,
                    parent_span_id=st.req.root_span_id,
                    profile=(True if self.serve_config.profile_dir
                             else None))
            else:
                st.session = OnlineSession(
                    meta, engine_config(cfg), registry=self.registry,
                    tracer=self.tracer,
                    trace_id=st.req.trace_id,
                    parent_span_id=st.req.root_span_id,
                    stream_id=st.req.request_id,
                    profile=(True if self.serve_config.profile_dir
                             else None))
        if self.mux is not None:
            # journaled ingest never drops: a full ring applies
            # backpressure (the HTTP response waits) instead of 429ing
            # a chunk the journal already recorded
            self.mux.ingest(st.req.request_id, data, weights,
                            label=os.path.basename(chunk_path), block=True)
            return st.session.n_subints + self.mux.pending(
                st.req.request_id)
        return st.session.ingest(
            data, weights, label=os.path.basename(chunk_path))

    def _stream_out_path(self, req: ServeRequest, st: _StreamState) -> str:
        """Cleaned-stream output: next to the first chunk, named by the
        request id (chunk names are per-subint, so the batch naming rule
        would label the output after one arbitrary subint)."""
        base = os.path.dirname(os.path.abspath(st.chunks[0]))
        return os.path.join(base, req.request_id + "_cleaned.npz")

    def _execute_stream(self, req: ServeRequest) -> None:
        """Finalize a closed stream: close-reconcile the session (the
        offline batch clean over the full assembled cube — bit-equal with
        batch by construction) and write the cleaned archive."""
        from iterative_cleaner_torch import io as ar_io

        with self._state_lock:
            st = self._streams.pop(req.request_id, None)
        self._running_id = req.request_id
        self.journal.record_request(req.request_id, "running")
        t0 = time.perf_counter()
        span = self.tracer.start(
            "execute", trace_id=req.trace_id,
            parent_id=req.root_span_id, subsystem="serve", lane="serve",
            request_id=req.request_id, tenant=req.tenant, kind="stream")
        try:
            if st is None or st.session is None or not st.chunks:
                raise RequestError(
                    f"stream {req.request_id!r} reached the worker with "
                    f"no ingested subints")
            if self.mux is not None:
                # drain the stream's pending subints (partial batches
                # become due immediately) then close — the mux returns
                # the same OnlineResult the solo session would
                result = self.mux.close_stream(req.request_id)
            else:
                result = st.session.close()
            out = self._stream_out_path(req, st)
            ar_io.save_archive(result.archive, out)
        except Exception as exc:  # noqa: BLE001 -- the request fails
            if self.mux is not None:
                self.mux.abandon_stream(req.request_id)
            dt = time.perf_counter() - t0
            span.event("error", type=type(exc).__name__,
                       message=str(exc)[:200])
            span.end(status="error")
            self.journal.record_request(
                req.request_id, "failed",
                error=f"{type(exc).__name__}: {exc}",
                duration_s=round(dt, 6))
            self.registry.counter_inc("serve_failed")
            self._observe_latency(req, dt)
            self._close_root_span(req, "failed")
            self._say("serve: failed stream %s: %s" % (req.request_id, exc))
            return
        finally:
            self._running_id = None
        dt = time.perf_counter() - t0
        fields = {
            "n_subints": result.n_subints,
            "out": out,
            "mask_drift": int(result.mask_drift + result.final_drift),
            "reconciles": int(result.reconciles),
            "recompiles_steady": int(result.recompiles_steady),
            "subint_p99_ms": round(result.p99_ms(), 3),
            "duration_s": round(dt, 6),
        }
        span.set("n_subints", result.n_subints)
        span.set("recompiles_steady", int(result.recompiles_steady))
        span.end(status="ok")
        self._observe_latency(req, dt)
        self.journal.record_request(req.request_id, "done", **fields)
        self.registry.counter_inc("serve_completed")
        self._close_root_span(req, "ok")
        self._say("serve: done stream %s (%d subints, %.2fs, p99 %.1fms, "
                  "%d steady recompiles)"
                  % (req.request_id, result.n_subints, dt,
                     fields["subint_p99_ms"], fields["recompiles_steady"]))

    def _recover_stream(self, rid: str, req: ServeRequest,
                        view: dict, source: str = "recover",
                        fail_on_reject: bool = True) -> int:
        """Restart path for a journaled open stream (also the pool
        adoption path, ``source="pool"``): re-admit (no queue), replay
        its journaled chunk files from disk into a fresh session —
        counted ``online_replayed_subints``, never as new ingests — and
        restore the dedup keys so a client's re-POST of an already-
        journaled subint answers ``duplicate``.  A stream journaled
        closed re-queues for the worker immediately.

        ``fail_on_reject=False`` (the adoption path) treats an admission
        Rejection as transient pressure: the stream stays journaled for
        the next scan instead of failing terminally."""
        self._open_root_span(req, source=source)
        try:
            self.scheduler.submit(req, already_journaled=True,
                                  enqueue=False)
        except Rejection as exc:
            with self._state_lock:
                self._root_spans.pop(rid, None)
            if not fail_on_reject:
                return 0
            self.journal.record_request(rid, "failed",
                                        error=f"unrecoverable: {exc}")
            self.registry.counter_inc("serve_failed")
            return 0
        st = _StreamState(req=req)
        with self._state_lock:
            self._streams[rid] = st
        chunks = [str(c) for c in (view.get("chunks") or [])]
        try:
            for chunk in chunks:
                self._ingest_chunk(st, chunk)
                st.chunks.append(chunk)
        except (RequestError, Rejection) as exc:
            with self._state_lock:
                self._streams.pop(rid, None)
            if self.mux is not None:
                self.mux.abandon_stream(rid)
            self.scheduler.mark_done(req)
            self._close_root_span(req, "failed")
            self.journal.record_request(
                rid, "failed", error=f"unrecoverable stream: {exc}")
            self.registry.counter_inc("serve_failed")
            return 0
        st.keys = set(str(k) for k in (view.get("keys") or [])) \
            or set(st.chunks)
        if self.mux is not None and st.session is not None:
            # replayed subints must be committed (not pending) before
            # the replay counter reads n_subints — and recovery may run
            # before the dispatcher thread starts
            self.mux.drain(rid)
        if st.session is not None:
            self.registry.counter_inc("online_replayed_subints",
                                      st.session.n_subints)
        if view.get("closed"):
            st.closed = True
            self.scheduler.enqueue_admitted(req)
        self._say("serve: recovered stream %s (%d chunk%s replayed%s)"
                  % (rid, len(chunks), "" if len(chunks) == 1 else "s",
                     ", closed" if st.closed else ""))
        return 1

    def request_index(self) -> dict:
        """GET /requests: every journaled request's id/state/kind/tenant
        (the journal is the source of truth, so the index survives
        restarts and includes terminal requests)."""
        states = self.journal.request_states()
        with self._state_lock:
            self._journal_read_ts = time.time()
        return {
            "n": len(states),
            "requests": [
                {"id": rid,
                 "state": view.get("state"),
                 "kind": view.get("kind") or "clean",
                 "tenant": view.get("tenant") or "default"}
                for rid, view in sorted(states.items())
            ],
        }

    def _observe_latency(self, req: ServeRequest, run_s: float) -> None:
        """The SLO signals: run duration, plus end-to-end (submit →
        terminal, queue wait included) both global and per-tenant via the
        label-suffix convention — ``serve_e2e_s{tenant=...}`` renders as
        a real Prometheus label on /metrics."""
        from iterative_cleaner_torch.telemetry.registry import (
            SECONDS,
            labeled,
        )

        e2e = max(time.time() - req.submitted_ts, 0.0)
        self.registry.histogram_observe("serve_request_s", run_s,
                                        buckets=SECONDS)
        self.registry.histogram_observe("serve_e2e_s", e2e, buckets=SECONDS)
        self.registry.histogram_observe(
            labeled("serve_e2e_s", tenant=req.tenant), e2e, buckets=SECONDS)

    def _write_one(self, path, ar, result) -> None:
        from iterative_cleaner_torch import io as ar_io

        out = dataclasses.replace(
            ar, weights=result.final_weights.astype(ar.weights.dtype))
        ar_io.save_archive(out, default_out_path(path))

    def _fail_expired(self, expired) -> None:
        for req in expired:
            self.journal.record_request(
                req.request_id, "failed",
                error="deadline expired before scheduling")
            self.registry.counter_inc("serve_failed")
            self._close_root_span(req, "expired")
            self.scheduler.mark_done(req)
            self._say("serve: deadline expired for %s" % req.request_id)

    # -------------------------------------------------------- maintenance
    def _maintain(self) -> None:
        """Idle-time growth bounds: compact the journal, trim clean.log
        and rotate the event log once they cross their configured sizes.
        Single-file journal compaction holds the appenders' flock (safe
        under live traffic); segmented compaction touches only sealed
        segments, so it does not even contend — pool members coordinate
        per shard through ``maint:<shard>`` leases instead
        (:meth:`_maintain_segments`)."""
        from iterative_cleaner_torch.telemetry.registry import labeled
        from iterative_cleaner_torch.utils.logging import rotate_log, trim_log

        cfg = self.serve_config
        jsz = self.journal.size_bytes()
        self.registry.gauge_set("journal_live_bytes", float(jsz))
        seg_counts = self.journal.segment_counts()
        for shard, n in sorted(seg_counts.items()):
            self.registry.gauge_set(
                labeled("journal_segments", shard=str(shard)), float(n))
        if self.journal.backend == "segmented":
            self._maintain_segments(
                seg_counts, force=jsz > cfg.journal_max_mb * 1e6)
        elif jsz > cfg.journal_max_mb * 1e6:
            if self.journal.compact():
                self.registry.counter_inc("serve_journal_compactions")
                self._say("serve: compacted journal (%d -> %d bytes)"
                          % (jsz, self.journal.size_bytes()))
        if trim_log("clean.log", int(cfg.log_max_mb * 1e6)):
            self.registry.counter_inc("serve_log_trims")
        # the event log is append-only spans/events: unlike clean.log its
        # old lines matter (they are the trace export), so rotation keeps
        # one full previous generation (.1) instead of trimming in place
        ev_path = getattr(self.events, "path", None)
        if ev_path and rotate_log(ev_path, int(cfg.log_max_mb * 1e6)):
            self.registry.counter_inc("serve_eventlog_rotations")
            self._say("serve: rotated event log %s -> %s.1"
                      % (ev_path, ev_path))

    def _maintain_segments(self, seg_counts: Dict[int, int],
                           force: bool) -> None:
        """The segmented journal's background maintenance role: compact
        any shard with a sealed backlog (≥ 2 live segments; with
        ``force`` — live bytes over ``--journal-max-mb`` — a lone
        uncompacted segment qualifies too).  In a pool, a member only
        grinds a shard after winning its ``maint:<shard>`` lease through
        the ordinary claim grammar, so concurrent members shard the
        maintenance work instead of duplicating it; compaction itself
        touches only sealed segments, concurrent with everyone's live
        appends."""
        for shard, n in sorted(seg_counts.items()):
            if n < (1 if force else 2):
                continue
            if self.membership is not None:
                if not self.membership.claim_maintenance(shard):
                    continue  # another member holds this shard's lease
                try:
                    self._compact_one_shard(shard)
                finally:
                    self.membership.release_maintenance(shard)
            else:
                self._compact_one_shard(shard)

    def _compact_one_shard(self, shard: int) -> None:
        if self.journal.compact_shard(shard):
            self.registry.counter_inc("serve_journal_compactions")
            self._say("serve: compacted journal shard %d" % shard)

    # ------------------------------------------------------------ signals
    def _on_signal(self, signum, _frame) -> None:
        self._signals += 1
        if self._signals >= 2:
            # a stuck drain must still be killable without SIGKILL; this
            # is the one exit where atexit never runs, so the black box
            # dumps here or not at all
            if self.recorder is not None:
                self.recorder.dump("force-exit")
            print("serve: second signal, forcing exit", flush=True)
            os._exit(FORCE_EXIT_CODE)
        print("serve: %s received, draining (queued requests stay "
              "journaled; signal again to force exit)"
              % signal.Signals(signum).name, flush=True)
        self.scheduler.start_drain()

    # ---------------------------------------------------------------- run
    def run(self) -> int:
        """The daemon main loop; returns the process exit code (0 for a
        clean drain)."""
        import threading

        from iterative_cleaner_torch.telemetry.recorder import install_sigquit

        if threading.current_thread() is threading.main_thread():
            # in-process tests drive run() from a worker thread and
            # deliver "signals" by calling _on_signal directly
            signal.signal(signal.SIGTERM, self._on_signal)
            signal.signal(signal.SIGINT, self._on_signal)
            install_sigquit()  # kill -QUIT: live black-box snapshot
            if self.serve_config.profile_dir:
                # POST /profile captures start on handler threads: the
                # profiler's tracer must be set up here first
                from iterative_cleaner_torch.telemetry import profiling

                profiling.prepare()
        if self.membership is not None:
            self.membership.join()
            # the loop executes requests inline, so a background beat
            # keeps a busy member's lease alive (stopped by leave())
            self.membership.start_auto_beat(registry=self.registry)
            print("serve: joined pool as %s (member ttl %.1fs)"
                  % (self.membership.member_id,
                     self.serve_config.member_ttl_s), flush=True)
        if self.mux is not None:
            # dispatcher up BEFORE recovery: replayed chunks flow through
            # the same ring, and a blocked (backpressured) replay needs a
            # consumer
            self.mux.start()
            print("serve: stream mux on (max batch %d, SLO %.1fms)"
                  % (self.mux.max_batch, self.mux.max_wait_ms), flush=True)
        self.recover()
        if self.serve_config.http_port is not None:
            from iterative_cleaner_torch.serve.http import (
                make_server,
                start_server_thread,
            )

            self._httpd = make_server(self, self.serve_config.http_port)
            self._http_thread = start_server_thread(self._httpd)
            # fixed grep-able format: tests and scripts parse the port
            print("serve: http listening on 127.0.0.1:%d"
                  % self._httpd.server_address[1], flush=True)
        if self.spool is not None:
            print("serve: watching spool %s" % self.spool.spool_dir,
                  flush=True)
        print("serve: ready (journal %s, max_inflight %d, queue %d)"
              % (self.journal.path, self.serve_config.max_inflight,
                 self.serve_config.queue_limit), flush=True)
        try:
            while True:
                draining = self.scheduler.draining
                if self.spool is not None:
                    self.spool.scan_once(stop_intake=draining)
                if not draining:
                    self._elastic_tick()
                req, expired = self.scheduler.pop(
                    timeout=self.serve_config.poll_s)
                self._fail_expired(expired)
                if self.scheduler.draining:
                    # anything just popped stays journaled 'accepted' and
                    # re-enqueues on the next start — drain only finishes
                    # work that already reached 'running'
                    break
                if req is None:
                    self._maintain()
                    continue
                if not self._claim_for_execute(req):
                    # another member leased this request first: drop it
                    # here (and forget the id so it is re-adoptable if
                    # that member dies) — the winner journals its fate
                    self.scheduler.mark_done(req)
                    self.scheduler.forget(req.request_id)
                    self._close_root_span(req, "lost")
                    self._say("serve: %s is leased by another member, "
                              "skipping" % req.request_id)
                    continue
                try:
                    self._execute(req)
                finally:
                    self._release_execute_claim(req)
                    self.scheduler.mark_done(req)
        except Exception:  # noqa: BLE001 -- dumped, then re-raised
            # an exception escaping the serve loop is exactly what the
            # flight recorder exists for: dump, then die loudly
            if self.recorder is not None:
                self.recorder.dump("daemon-exception")
            raise
        finally:
            self._shutdown()
        return 0

    def _shutdown(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        if self.mux is not None:
            # stop dispatching; open streams stay journaled and replay on
            # the next start (the same abandoned-stream contract as the
            # per-session path)
            self.mux.stop()
        if self.membership is not None:
            # leave BEFORE compacting: the roster forgets a drained
            # member immediately (never "evicted") and the compaction
            # below drops our membership lines with us
            self.membership.leave()
            self._say("serve: left pool (%s)"
                      % self.membership.member_id)
        queued = self.scheduler.depth()
        self.journal.compact()
        if self.trace_out:
            try:
                self.tracer.flush_perfetto(self.trace_out)
                self._say("serve: wrote trace %s" % self.trace_out)
            except OSError as exc:
                print("serve: trace export failed: %s" % exc, flush=True)
        snap = self.registry.snapshot()
        print("serve: drained (%d request%s left journaled) %s"
              % (queued, "" if queued == 1 else "s",
                 json.dumps({k: v for k, v in
                             sorted(snap.get("counters", {}).items())
                             if k.startswith("serve_")},
                            sort_keys=True)),
              flush=True)
        from iterative_cleaner_torch.telemetry import profiling
        from iterative_cleaner_torch.telemetry.recorder import (
            get_active,
            set_active,
        )

        # release the process-global black box if it is still ours: an
        # embedder outliving this daemon (the in-process tests) must not
        # have ITS later watchdog trips dumped to our recorder path
        if self.recorder is not None and get_active() is self.recorder:
            set_active(None)
        if self._profiling_set:
            profiling.set_enabled(None)


def run_serve(serve_config: ServeConfig, base_config: CleanConfig, *,
              registry=None, faults=None, io_workers=None,
              quiet: bool = False, events=None) -> int:
    """CLI entry: build and run a daemon; returns its exit code."""
    daemon = ServeDaemon(serve_config, base_config, registry=registry,
                         faults=faults, io_workers=io_workers, quiet=quiet,
                         events=events)
    return daemon.run()
