"""Coordinator-free pool membership for the elastic serving tier.

A pool is whatever set of daemons shares one journal: each member
announces itself with journaled membership lines (``--join``), and the
roster is derived by folding the journal
(:meth:`~iterative_cleaner_torch.resilience.journal.FleetJournal.member_table`)
— no registry service, no leader, no gossip.  Membership reuses the
claim-lease grammar: a member IS a lease on pool membership, granted by
'join', extended by 'hb' and ended by 'leave'.

Liveness is the lease: a SIGKILLed member stops heartbeating and its
lease expires after ``ttl_s``.  Eviction is not an action anyone takes —
it is an observation every surviving member makes independently from
the same journal fold (and journal compaction drops the lapsed member's
lines, so a compacted roster carries no ghosts).  The first time THIS
process observes a previously-live member lapse it counts
``serve_members_evicted`` once, the pool's eviction signal.

Member ids are per-incarnation (pid + random tag): a restarted daemon
re-joins under a fresh id and its dead predecessor simply expires —
the same rule as claim nonces, and for the same reason (a new process
must never inherit a lease it cannot know the state of).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional


class PoolMembership:
    """One daemon's view of (and presence in) the pool.

    :meth:`heartbeat` and :meth:`evict_lapsed` are called from the
    daemon loop (which ticks every ``poll_s``) and throttle themselves.
    The loop alone is not enough, though: the daemon executes requests
    INLINE, so a member mid-way through a long clean would stop beating
    and be spuriously evicted by its peers.  :meth:`start_auto_beat`
    therefore runs the same throttled heartbeat from a background
    thread (the :class:`~iterative_cleaner_torch.parallel.fleet.ClaimHeartbeat`
    pattern), stopped explicitly before :meth:`leave` so nothing can
    re-grant the lease after a drain departed."""

    def __init__(self, journal, *, ttl_s: float = 15.0,
                 member_id: Optional[str] = None,
                 host: Optional[int] = None, registry=None) -> None:
        self.journal = journal
        self.ttl_s = float(ttl_s)
        self.host = int(os.getpid() if host is None else host)
        # per-incarnation identity, never inherited across restarts
        self.member_id = (str(member_id) if member_id
                          else "m%d-%s" % (self.host, os.urandom(3).hex()))
        self.registry = registry
        self._last_beat = 0.0
        self._joined = False
        self._beat_stop: Optional[threading.Event] = None
        self._beat_thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        # members this process has seen live — the eviction edge detector
        self._seen_live: set = set()
        self._evicted: set = set()

    # ------------------------------------------------------------ lease
    def join(self, now: Optional[float] = None) -> None:
        now = time.time() if now is None else now
        self.journal.record_member(self.member_id, "join",
                                   host=self.host, ttl_s=self.ttl_s,
                                   now=now)
        # under the same lock heartbeat() takes: an auto-beat thread
        # started early must see join's throttle stamp, not a torn pair
        with self._lock:
            self._joined = True
            self._last_beat = now
        self._seen_live.add(self.member_id)
        self._gauge(now)

    def heartbeat(self, now: Optional[float] = None) -> bool:
        """Extend this member's lease; self-throttled to ``ttl/3`` (the
        claim-heartbeat cadence) so the daemon loop and the auto-beat
        thread can both call it freely.  Returns True when a line was
        actually appended."""
        now = time.time() if now is None else now
        with self._lock:
            if (not self._joined
                    or now - self._last_beat < self.ttl_s / 3.0):
                return False
            self._last_beat = now
        self.journal.record_member(self.member_id, "hb",
                                   host=self.host, ttl_s=self.ttl_s,
                                   now=now)
        return True

    def start_auto_beat(self, registry=None) -> None:
        """Keep the membership lease alive from a background thread while
        the daemon loop is blocked executing a request inline — a busy
        member must read as live, not evictable.  Idempotent; errors
        count ``serve_heartbeat_errors`` (a missed beat only risks a
        spurious eviction, and eviction is an observation peers revisit
        on the next fold)."""
        if self._beat_thread is not None:
            return
        self._beat_stop = threading.Event()
        stop, reg = self._beat_stop, registry or self.registry

        def beat() -> None:
            while not stop.wait(self.ttl_s / 3.0):
                try:
                    self.heartbeat()
                except Exception:  # noqa: BLE001 -- a missed beat only risks a spurious eviction; counted
                    if reg is not None:
                        reg.counter_inc("serve_heartbeat_errors")

        self._beat_thread = threading.Thread(target=beat, daemon=True,
                                             name="icln-member-hb")
        self._beat_thread.start()

    def stop_auto_beat(self) -> None:
        thread, self._beat_thread = self._beat_thread, None
        if thread is not None:
            self._beat_stop.set()
            thread.join(timeout=5.0)

    def leave(self, now: Optional[float] = None) -> None:
        """Graceful departure (drain): the roster forgets us immediately
        instead of after a ttl, so a drained member never counts as
        evicted.  Stops the auto-beat first — nothing may re-grant a
        lease the member just gave up."""
        self.stop_auto_beat()
        with self._lock:
            if not self._joined:
                return
            self._joined = False
        self.journal.record_member(self.member_id, "leave",
                                   host=self.host, ttl_s=0.0, now=now)

    # ------------------------------------------------------ maintenance
    def claim_maintenance(self, shard: int,
                          now: Optional[float] = None) -> bool:
        """Try to win the ``maint:<shard>`` lease — the segmented
        journal's background maintenance role, taken through the
        ordinary claim grammar so ANY member may grind any shard and
        two members never compact the same shard concurrently.  The
        ttl covers one compaction pass; a member that dies mid-grind
        simply lets the lease lapse and a peer takes over."""
        return self.journal.try_claim(
            "maint:%d" % int(shard), host=self.host,
            nonce=self.member_id, ttl_s=max(self.ttl_s, 30.0), now=now)

    def release_maintenance(self, shard: int,
                            now: Optional[float] = None) -> None:
        self.journal.release("maint:%d" % int(shard), host=self.host,
                             nonce=self.member_id, now=now)

    # ------------------------------------------------------------- view
    def members(self, now: Optional[float] = None) -> Dict[str, dict]:
        """The folded roster: member-id -> ``{"host", "expires", "live"}``."""
        return self.journal.member_table(now=now)

    def live_members(self, now: Optional[float] = None) -> List[str]:
        table = self.members(now=now)
        return sorted(m for m, lease in table.items() if lease["live"])

    def evict_lapsed(self, now: Optional[float] = None) -> List[str]:
        """Observe the roster and report members whose lease lapsed since
        THIS process last saw them live — each counted
        ``serve_members_evicted`` exactly once per incarnation.  Also
        keeps the ``serve_members`` gauge current.  Returns the newly
        evicted ids (the caller logs and steals their work through the
        ordinary claim-lease rules)."""
        now = time.time() if now is None else now
        table = self.members(now=now)
        evicted: List[str] = []
        for member, lease in table.items():
            if member == self.member_id:
                continue  # self-eviction is meaningless (we ARE running)
            if lease["live"]:
                self._seen_live.add(member)
                self._evicted.discard(member)
            elif member in self._seen_live and member not in self._evicted:
                self._evicted.add(member)
                evicted.append(member)
        if evicted and self.registry is not None:
            self.registry.counter_inc("serve_members_evicted", len(evicted))
        self._gauge(now, table=table)
        return evicted

    def _gauge(self, now: float, table: Optional[dict] = None) -> None:
        if self.registry is None:
            return
        if table is None:
            table = self.members(now=now)
        self.registry.gauge_set(
            "serve_members",
            float(sum(1 for lease in table.values() if lease["live"])))
