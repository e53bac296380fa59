"""Stream multiplexer: many live streams, one batched step a tick.

One :class:`~iterative_cleaner_torch.online.session.OnlineSession` per
stream is the right *state* model (each stream keeps its own EW
template, ring, provisional masks, reconcile schedule and quality
monitor) but the wrong *dispatch* model: N concurrent streams cost N
launches of each kernel on a ``(1, nchan, nbin)`` plane, and such a
plane keeps the card idle between launches.  :class:`StreamMux` keeps
the sessions and replaces the dispatch:

* **Buckets.**  A bucket is one exact geometry and the step's key
  (:func:`~iterative_cleaner_torch.online.step.step_build_key`), so every
  stream in it runs the same step on its own data.  The reference pads
  channels up the ``--bucket-pad`` grid; the port pads nothing (padding
  is not exact on the card: sums run in another order at a padded
  width), so streams of different channel counts never share a bucket.

* **One launch a tick per bucket.**  Ready subints stack into a ``(B, 1,
  nchan, nbin)`` batch and go through the step's lane form: the preamble
  and the EW update lane by lane, then K6, K3 along each axis and the
  combine once each for all B lanes.  Per-stream metadata and EW state
  ride the batch as arguments, and every lane is computed as a solo
  step computes it, so each lane's provisional mask and scores are
  bit-equal to a solo session's.  A tick dispatches exactly its lanes:
  the port compiles nothing per batch size, so there is no rung to pad
  up to (the reference's power-of-two ladder with inert lanes).

* **A bounded ring with a latency deadline.**  Between ingest and the
  device sits a bounded ring of pending subints.  Bursts coalesce into
  full batches, but a subint never waits past ``--mux-max-wait-ms``: at
  the deadline its bucket dispatches partly full.  Only stream *heads*
  join a batch (subint ``n+1`` needs the template subint ``n`` made), one
  per stream per dispatch, oldest first: a chatty stream gets one lane a
  tick however deep its backlog.

Two locks in a fixed order, ``_dispatch_lock`` then ``_lock``.  ``_lock``
is a leaf guarding the stream table, the pending deques and the ring's
occupancy, held only around those reads and writes, never across a
device call, a commit or a reconcile.  ``_dispatch_lock`` serialises
whole dispatch cycles (select, device, commit), so each stream's commits
follow its ingest order even when :meth:`StreamMux.pump` races a
closing stream's drain.

Builds: the port's only builds are the kernel library's (``stats.
kernels.library_builds``); one during a bucket's first dispatch is
warm-up, a later one a steady recompile (which must stay 0).

Profiling: a bucket's dispatch of B lanes is the profiler's
``mux_step/<nchan>x<nbin>x<B>`` program (``telemetry/profiling.py``: the
step's kernels' modelled cost on B lanes), captured at its first
dispatch (with its device peak when profiling is on); each later
dispatch's seconds are its walltime.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import threading
import time
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from iterative_cleaner_torch.config import CleanConfig
from iterative_cleaner_torch.online.chunks import StreamMeta
from iterative_cleaner_torch.online.session import (
    OnlineResult,
    OnlineSession,
    PendingSubint,
    download_rows,
)
from iterative_cleaner_torch.stats.kernels import library_builds

DEFAULT_MUX_MAX_WAIT_MS = 5.0
DEFAULT_MUX_MAX_BATCH = 64
# ring bound: pending subints (all streams together) between ingest and
# the device, in multiples of max_batch, before ingest blocks or refuses
DEFAULT_MUX_RING_FACTOR = 16

__all__ = ["StreamMux", "MuxRingFull", "resolve_mux_max_wait_ms",
           "resolve_mux_max_batch", "DEFAULT_MUX_MAX_WAIT_MS",
           "DEFAULT_MUX_MAX_BATCH", "DEFAULT_MUX_RING_FACTOR"]


def resolve_mux_max_wait_ms(value: Optional[float]) -> float:
    """Explicit config value, else ICLEAN_MUX_MAX_WAIT_MS, else
    :data:`DEFAULT_MUX_MAX_WAIT_MS`.  0 dispatches every pending subint
    at once (batching only within one ingest burst)."""
    if value is not None:
        return float(value)
    raw = os.environ.get("ICLEAN_MUX_MAX_WAIT_MS", "")
    return float(raw) if raw else DEFAULT_MUX_MAX_WAIT_MS


def resolve_mux_max_batch(value: Optional[int]) -> int:
    """Explicit config value, else ICLEAN_MUX_MAX_BATCH, else
    :data:`DEFAULT_MUX_MAX_BATCH`."""
    if value is not None:
        return int(value)
    raw = os.environ.get("ICLEAN_MUX_MAX_BATCH", "")
    return int(raw) if raw else DEFAULT_MUX_MAX_BATCH


class MuxRingFull(RuntimeError):
    """A non-blocking ingest found the ring at capacity, or a blocking
    one waited out its timeout."""


@dataclasses.dataclass
class _MuxStream:
    """One multiplexed stream: its session, its bucket and its FIFO of
    pending subints."""

    key: str
    session: OnlineSession
    bucket: tuple
    # (arrival, pend): arrival is stamped by the mux's own clock, not
    # pend.t0 (perf_counter, for the commit's latency): the deadline must
    # use the injectable clock, or the deadline tests are not
    # deterministic
    pending: Deque[Tuple[float, PendingSubint]] = dataclasses.field(
        default_factory=collections.deque)
    closing: bool = False
    # heads popped by _select_batch and not yet committed by _dispatch: a
    # drain waits for these too, or close() races the commit
    inflight: int = 0


@dataclasses.dataclass
class _MuxBucket:
    """One bucket: what its step is built from."""

    key: tuple
    config: CleanConfig        # representative (the key resolves alike)
    nchan: int
    nbin: int
    dedispersed: bool
    alpha: float
    step: object = None
    # (max_batch, 1, nchan, nbin) host buffer of the engine dtype, pinned
    # where the step runs on a card: each lane's float64 tile is cast
    # into it in one pass and the batch goes up in one copy
    staging: object = None


class StreamMux:
    """Multiplex many live streams through one batched step a tick; see
    the module docstring."""

    def __init__(self, *, max_batch: Optional[int] = None,
                 max_wait_ms: Optional[float] = None,
                 ring_capacity: Optional[int] = None,
                 registry=None, tracer=None, clock=None):
        self.max_batch = resolve_mux_max_batch(max_batch)
        if self.max_batch < 1:
            raise ValueError("mux max_batch must be >= 1")
        self.max_wait_ms = resolve_mux_max_wait_ms(max_wait_ms)
        if self.max_wait_ms < 0:
            raise ValueError("mux max_wait_ms must be >= 0")
        self.ring_capacity = (int(ring_capacity) if ring_capacity
                              else DEFAULT_MUX_RING_FACTOR * self.max_batch)
        if self.ring_capacity < 1:
            raise ValueError("mux ring_capacity must be >= 1")
        self.registry = registry
        self.tracer = tracer
        self._clock = clock or time.monotonic
        # _lock is a LEAF: held only around the stream table, the deques
        # and the occupancy below, never across a device call, a commit
        # or another lock
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._dispatch_lock = threading.Lock()
        self._streams: Dict[str, _MuxStream] = {}
        self._buckets: Dict[tuple, _MuxBucket] = {}
        self._dispatched_buckets = set()
        self._pending_total = 0
        self._stop_flag = False
        self._thread: Optional[threading.Thread] = None
        # accounting
        self.dispatches = 0
        self.partial_dispatches = 0
        self.subints = 0
        self.warmup_compiles = 0
        self.recompiles_steady = 0
        self.batch_occupancies: List[float] = []

    # ------------------------------------------------------------ streams
    def open(self, key: str, meta: StreamMeta, config: CleanConfig, *,
             trace_id: Optional[str] = None,
             parent_span_id: Optional[str] = None,
             profile: Optional[bool] = None) -> OnlineSession:
        """Register a stream.  Its session is built as the solo path
        builds it (the same knobs, its own quality monitor labelled
        ``key``, its spans under ``trace_id``/``parent_span_id``), but it
        never steps alone: the mux's batched step does every dispatch."""
        from iterative_cleaner_torch.online.step import step_build_key

        session = OnlineSession(meta, config, registry=self.registry,
                                tracer=self.tracer, trace_id=trace_id,
                                parent_span_id=parent_span_id,
                                stream_id=key, profile=profile)
        alpha = session.alpha
        bucket = step_build_key(config, meta.nchan, meta.nbin,
                                meta.dedispersed, alpha)
        st = _MuxStream(key=key, session=session, bucket=bucket)
        with self._lock:
            if key in self._streams:
                raise ValueError(f"stream {key!r} is already multiplexed")
            self._streams[key] = st
            if bucket not in self._buckets:
                self._buckets[bucket] = _MuxBucket(
                    key=bucket, config=config, nchan=meta.nchan,
                    nbin=meta.nbin, dedispersed=bool(meta.dedispersed),
                    alpha=alpha)
            n_streams = len(self._streams)
        if self.registry is not None:
            self.registry.gauge_set("mux_streams", n_streams)
        return session

    def session(self, key: str) -> OnlineSession:
        with self._lock:
            return self._streams[key].session

    def streams(self) -> List[str]:
        with self._lock:
            return list(self._streams)

    def pending(self, key: Optional[str] = None) -> int:
        with self._lock:
            if key is None:
                return self._pending_total
            return len(self._streams[key].pending)

    # ------------------------------------------------------------- ingest
    def ingest(self, key: str, data, weights=None, *, label: str = "",
               block: bool = False, timeout_s: float = 30.0) -> int:
        """Queue one chunk (``(nchan, nbin)`` or ``(k, nchan, nbin)``) on
        the ring.  With ``block=False`` a full ring raises
        :class:`MuxRingFull`; with ``block=True`` ingest waits for the
        dispatcher to make room (backpressure, never a dropped chunk).
        Returns the stream's pending count."""
        with self._lock:
            st = self._streams[key]
        data = np.asarray(data, dtype=np.float64)
        if data.ndim == 2:
            data = data[None]
        if weights is None:
            weights = np.ones(data.shape[:2], dtype=np.float64)
        weights = np.asarray(weights, dtype=np.float64)
        if weights.ndim == 1:
            weights = weights[None]
        if weights.shape != data.shape[:2]:
            raise ValueError(
                f"chunk weights shape {weights.shape} does not match data "
                f"{data.shape[:2]}")
        n = 0
        for i in range(data.shape[0]):
            self._reserve_slot(block=block, timeout_s=timeout_s)
            try:
                pend = st.session.begin_subint(data[i], weights[i],
                                               label=label)
            except BaseException:
                with self._lock:
                    self._pending_total -= 1
                    self._cond.notify_all()
                raise
            with self._lock:
                st.pending.append((self._clock(), pend))
                n = self._pending_total
                self._cond.notify_all()
        if self.registry is not None:
            self.registry.gauge_set("mux_pending", n)
        with self._lock:
            return len(st.pending)

    def _reserve_slot(self, *, block: bool, timeout_s: float) -> None:
        deadline = self._clock() + timeout_s
        with self._lock:
            while self._pending_total >= self.ring_capacity:
                if not block:
                    raise MuxRingFull(
                        f"mux ring at capacity ({self.ring_capacity} "
                        f"pending subints)")
                remaining = deadline - self._clock()
                if remaining <= 0 or not self._cond.wait(
                        timeout=min(remaining, 0.1)):
                    if self._clock() >= deadline:
                        raise MuxRingFull(
                            f"mux ring still full after {timeout_s:.1f}s "
                            f"of backpressure")
            self._pending_total += 1

    # ----------------------------------------------------------- dispatch
    def pump(self, now: Optional[float] = None, force: bool = False) -> int:
        """Run every due dispatch (full buckets, heads past the deadline,
        closing streams; everything with ``force``).  Returns the number
        of dispatches.  The dispatcher thread calls this in a loop; tests
        and drivers call it by hand (an injected clock makes the deadline
        deterministic)."""
        dispatched = 0
        while True:
            with self._dispatch_lock:
                picked = self._select_batch(
                    self._clock() if now is None else now, force)
                if picked is None:
                    break
                self._dispatch(*picked)
            dispatched += 1
        return dispatched

    def _select_batch(self, now: float, force: bool):
        """Pick one due bucket and pop up to ``max_batch`` stream heads,
        oldest first.  Called with ``_dispatch_lock`` held; takes the leaf
        ``_lock`` only around the table walk and the pops."""
        wait_s = self.max_wait_ms / 1000.0
        with self._lock:
            ready: Dict[tuple, List[_MuxStream]] = {}
            for st in self._streams.values():
                if st.pending:
                    ready.setdefault(st.bucket, []).append(st)
            chosen = None
            for bucket, sts in ready.items():
                due = (force or len(sts) >= self.max_batch
                       or any(s.closing for s in sts)
                       or min(s.pending[0][0] for s in sts)
                       <= now - wait_s)
                if due:
                    chosen = (bucket, sts)
                    break
            if chosen is None:
                return None
            bucket, sts = chosen
            sts.sort(key=lambda s: s.pending[0][0])
            lanes = [(s, s.pending.popleft()[1])
                     for s in sts[:self.max_batch]]
            for s, _pend in lanes:
                s.inflight += 1
            self._pending_total -= len(lanes)
            self._cond.notify_all()
        return self._buckets[bucket], lanes

    def _dispatch(self, binfo: _MuxBucket, lanes) -> None:
        """Stack the popped heads into one ``(B, 1, nchan, nbin)`` batch,
        run the bucket's step on it, download its outputs in one transfer
        and commit each lane to its session.  Called with
        ``_dispatch_lock`` held and ``_lock`` NOT held: a commit may
        reconcile (a whole batch clean) and must not stall ingest."""
        from iterative_cleaner_torch.backends.torch_backend import upload
        from iterative_cleaner_torch.online.session import step_costs
        from iterative_cleaner_torch.online.step import build_subint_step
        from iterative_cleaner_torch.telemetry import profiling

        b = len(lanes)
        before = library_builds()
        sessions = [st.session for st, _ in lanes]
        if binfo.step is None:
            binfo.step = build_subint_step(
                binfo.config, binfo.nchan, binfo.nbin, binfo.dedispersed,
                binfo.alpha, self.registry)[0]
        device, dtype = sessions[0].device, sessions[0].dtype
        if binfo.staging is None:
            binfo.staging = torch.empty(
                (self.max_batch, 1, binfo.nchan, binfo.nbin), dtype=dtype,
                pin_memory=device.type == "cuda")
        stage = binfo.staging[:b]
        host = stage.numpy()
        for i, (_, pend) in enumerate(lanes):
            host[i, 0] = pend.tile     # the cast a solo upload makes
        ws = np.stack([pend.w_row for _, pend in lanes])[:, None]
        meta = [torch.stack([s._meta_args[i] for s in sessions])
                for i in range(4)]
        program = "mux_step/%dx%dx%d" % (binfo.nchan, binfo.nbin, b)
        warm = profiling.has_cost(program)
        if not warm:
            profiling.capture_compiled(
                program, step_costs(binfo.config, binfo.nchan, binfo.nbin,
                                    lanes=b),
                registry=self.registry, dtype=binfo.config.dtype)
        t0 = time.perf_counter()
        # the previous dispatch ended in a synchronising download, so its
        # copy out of the staging buffer is done (on the CPU the step
        # consumes the buffer itself, which the next dispatch rewrites)
        with profiling.first_call_peak(program, device,
                                       registry=self.registry):
            new_w, scores, new_t, updated = binfo.step(
                stage.to(device, non_blocking=True),
                upload(ws, device, dtype), *meta,
                torch.stack([s._template for s in sessions]),
                torch.stack([s._count for s in sessions]))
            host_w, host_s, host_t = download_rows(new_w, scores, new_t)
        dt = time.perf_counter() - t0
        if warm:
            profiling.record_walltime(program, dt, registry=self.registry)
        built = library_builds() - before
        for i, (st, pend) in enumerate(lanes):
            st.session.commit_subint(pend, host_w[i], host_s[i], new_t[i],
                                     updated[i], template_host=host_t[i])
        occupancy = b / float(self.max_batch)
        with self._lock:
            for st, _pend in lanes:
                st.inflight -= 1
            steady = binfo.key in self._dispatched_buckets
            self._dispatched_buckets.add(binfo.key)
            if steady:
                self.recompiles_steady += built
            else:
                self.warmup_compiles += built
            self.dispatches += 1
            self.subints += b
            self.partial_dispatches += int(b < self.max_batch)
            self.batch_occupancies.append(occupancy)
            self._cond.notify_all()
        if self.registry is not None:
            from iterative_cleaner_torch.telemetry.quality import (
                FRACTION_BUCKETS,
            )
            from iterative_cleaner_torch.telemetry.registry import SECONDS

            if built:
                self.registry.counter_inc(
                    "mux_recompiles_steady" if steady
                    else "mux_warmup_compiles", built)
            self.registry.counter_inc("mux_dispatches")
            self.registry.counter_inc("mux_subints", b)
            if b < self.max_batch:
                self.registry.counter_inc("mux_partial_dispatches")
            self.registry.histogram_observe("mux_batch_occupancy",
                                            occupancy,
                                            buckets=FRACTION_BUCKETS)
            self.registry.histogram_observe("mux_dispatch_s", dt,
                                            buckets=SECONDS)

    # -------------------------------------------------------- drain/close
    def drain(self, key: Optional[str] = None, timeout_s: float = 60.0
              ) -> None:
        """Dispatch until ``key``'s (or every) pending queue is empty.
        With the dispatcher thread running this waits for it (a closing
        stream's partial batches are due at once); without one it pumps
        here."""
        deadline = self._clock() + timeout_s
        while True:
            with self._lock:
                if key is None:
                    empty = (self._pending_total == 0
                             and all(st.inflight == 0
                                     for st in self._streams.values()))
                else:
                    st = self._streams[key]
                    empty = not st.pending and st.inflight == 0
            if empty:
                return
            if self._thread is not None and self._thread.is_alive():
                with self._lock:
                    self._cond.notify_all()
                time.sleep(0.002)
            else:
                self.pump(force=True)
            if self._clock() > deadline:
                raise TimeoutError(
                    f"mux drain of {key or '<all>'} timed out after "
                    f"{timeout_s:.0f}s")

    def close_stream(self, key: str, timeout_s: float = 60.0
                     ) -> OnlineResult:
        """Drain a stream's pending subints (its partial batches are due
        at once, so closing never stalls its bucket's other streams) and
        run its session's close."""
        with self._lock:
            st = self._streams[key]
            st.closing = True
            self._cond.notify_all()
        self.drain(key, timeout_s=timeout_s)
        with self._lock:
            st = self._streams.pop(key)
            n_streams = len(self._streams)
        if self.registry is not None:
            self.registry.gauge_set("mux_streams", n_streams)
        return st.session.close()

    def abandon_stream(self, key: str) -> None:
        """Drop a stream without closing its session, freeing its ring
        slots (a daemon's shutdown: its journal replays the stream)."""
        with self._lock:
            st = self._streams.pop(key, None)
            if st is not None:
                self._pending_total -= len(st.pending)
                self._cond.notify_all()

    # --------------------------------------------------------- dispatcher
    def start(self) -> None:
        """Start the background dispatcher.  Tests and burst drivers call
        :meth:`pump` by hand instead."""
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop_flag = False
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="icln-mux-dispatch")
        self._thread.start()

    def stop(self, timeout_s: float = 10.0) -> None:
        """Stop the dispatcher thread and wait for it."""
        with self._lock:
            self._stop_flag = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=timeout_s)
            if self._thread.is_alive():
                raise TimeoutError(
                    f"mux dispatcher still running after {timeout_s:.0f}s")
            self._thread = None

    def _run(self) -> None:
        wait_s = max(self.max_wait_ms / 1000.0, 0.001)
        while True:
            with self._lock:
                if self._stop_flag:
                    return
            self.pump()
            with self._lock:
                if self._stop_flag:
                    return
                # sleep until the oldest head's deadline (or an ingest or
                # close notify), so a partial batch leaves at most one
                # scheduling quantum past it
                now = self._clock()
                oldest = None
                for st in self._streams.values():
                    if st.pending:
                        t0 = st.pending[0][0]
                        oldest = t0 if oldest is None else min(oldest, t0)
                if oldest is None:
                    timeout = wait_s
                else:
                    timeout = max(0.001, oldest + wait_s - now)
                self._cond.wait(timeout=min(timeout, wait_s))

    # -------------------------------------------------------------- views
    def occupancy_mean(self) -> float:
        """Mean lanes per dispatch over ``max_batch``."""
        if not self.batch_occupancies:
            return 0.0
        return float(np.mean(self.batch_occupancies))
