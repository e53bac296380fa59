"""Crash-safe JSON-lines fleet journal: the ``--resume`` substrate.

One line per completed archive, appended under
:func:`~iterative_cleaner_torch.utils.logging.locked_append` (flock +
O_APPEND) AFTER its output write returned — so a ``kill -9`` at any
instant leaves at worst one torn trailing line, which the reader skips.
Combined with the IO layer's atomic temp-file + ``os.replace`` output
writes, "a journal entry exists" implies "the output file is complete".

Entry format (one JSON object per line, sorted keys)::

    {"schema": "icln-fleet-journal/1", "event": "done",
     "path": "/abs/in.npz", "sig": "<file_signature of the input>",
     "config": "<config_hash>",
     "out": "/abs/in.npz_cleaned.npz", "out_sig": "<file_signature>"}

``config`` is :func:`~iterative_cleaner_torch.utils.checkpoint.config_hash`
— a digest of the mask-identity config JSON, so a journal written under
different cleaning parameters never satisfies a resume.  ``sig``/
``out_sig`` are cheap header signatures (size, mtime_ns, head hash):
a resumed run re-verifies BOTH before skipping — a rewritten input or a
missing/truncated output re-cleans instead of being trusted
(:func:`entry_is_current`).

**Request lifecycle events** (the serve daemon's crash-safe queue state)
share the file under the same schema::

    {"schema": "icln-fleet-journal/1", "event": "req",
     "state": "accepted" | "running" | "done" | "failed",
     "req": "<request id>", ...request fields on 'accepted'...}

A request's 'accepted' entry carries everything needed to re-run it
(paths, overrides, priority, deadline, tenant), so a killed daemon
rebuilds its queue from the journal alone: any request whose LAST state
is non-terminal re-enqueues, and the per-archive 'done' entries above
make the re-run skip every archive that already finished — exactly-once
cleaning across the crash.  The two event kinds never collide: archive
readers filter ``event == "done"``, request readers ``event == "req"``.

**Claim events** (the multi-host fleet's work-stealing substrate) share
the file too::

    {"schema": "icln-fleet-journal/1", "event": "claim",
     "work": "<bucket key>", "host": 0, "nonce": "<unique claimant id>",
     "state": "claim" | "hb" | "release", "t": <epoch s>, "ttl": <s>,
     "trace": {"trace_id": "...", "span_id": "..."}}   # optional

``trace`` is the claimant's distributed-tracing span context; the fold
keeps it on the lease, so a host stealing an expired claim recovers the
originating request's trace context from the journal alone and its
bucket span stitches under that request's tree (ARCHITECTURE.md
"Observability" — journal trace-context grammar).

Claims are leases, not locks: a 'claim' grants ``work`` to ``nonce``
when the work is unowned, already owned by the same nonce, or the
current owner's lease had expired at the claim's timestamp; 'hb'
(heartbeat) extends the owner's lease; 'release' ends it.  Because
appends are serialized by the flock and every reader folds the SAME
line order through the SAME rule (:meth:`FleetJournal.claim_table`),
all hosts agree on every work item's owner without any other channel —
:meth:`FleetJournal.try_claim` is append-then-read-back.  A dead host
stops heartbeating, its lease expires, and a finisher steals the work;
the per-archive 'done' entries above keep the steal idempotent (already
-finished archives are skipped, never re-cleaned).

**Host stats events** carry each host's final ``fleet_*`` counter
deltas (``event: "stats"``) so any process — or a post-mortem reader —
can aggregate whole-slice telemetry from the journal alone, without a
collective that a dead host would hang.

**Membership events** (the elastic serving pool's roster) reuse the
claim-lease shape — a member IS a lease on pool membership::

    {"schema": "icln-fleet-journal/1", "event": "member",
     "member": "<unique member id>", "host": <pid>,
     "state": "join" | "hb" | "leave", "t": <epoch s>, "ttl": <s>}

'join' and 'hb' both (re)grant the membership lease until ``t + ttl``
(so a compacted roster — where only a member's LAST line survives —
folds identically), 'leave' ends it.  Membership is derived by folding
the journal (:meth:`FleetJournal.member_table`); there is no
coordinator.  A member whose heartbeat lapses simply expires out of
the fold — eviction is an observation every surviving member makes
independently, and the expired member's claimed requests become
stealable through the ordinary claim-lease rules above.

**Cache events** index completed work content-addressed: the key is
the journal's existing resume identity, input ``file_signature`` ×
``config_hash``::

    {"schema": "icln-fleet-journal/1", "event": "cache",
     "key": "<sig>|<config_hash>", "path": "/abs/in.npz",
     "sig": "...", "config": "...", "out": "/abs/out.npz",
     "out_sig": "...", "trace": {...}}   # trace optional

A repeat submission of the same archive + config can short-circuit to
the recorded output — but only after re-verifying BOTH signatures
(:func:`entry_is_current`): a rewritten input or a corrupted output
never serves from cache, it falls through to a real clean.

**Compaction** (:meth:`FleetJournal.compact`): a long-lived daemon's
journal grows one line per archive forever; compaction atomically
rewrites it keeping only the live lines — the last 'done' entry per
archive path, the last 'req' entry per request id (terminal request
ids keep one line apiece so accepted-entry replay stays impossible),
every claim line of works whose lease is still granted (the fold needs
the history; released works drop all their lines), the last 'stats'
line per host, the last 'member' line of each member whose lease is
still unexpired (left and evicted members drop entirely) and the last
'cache' line per key that still verifies (:func:`entry_is_current` —
an entry whose input or output signature drifted can never hit again,
so compaction ages it out and the cache index stays bounded by the
inputs that actually exist).  The rewrite runs under the appenders'
flock via
:func:`~iterative_cleaner_torch.utils.logging.compact_under_lock`, so
compacting under live traffic loses no entries.

**Backends.**  :class:`FleetJournal` delegates storage to a
:class:`JournalLog` backend: :class:`SingleFileLog` (the historical
one-file layout above — the default, byte-compatible, zero migration)
or the segmented backend
(:class:`~iterative_cleaner_torch.resilience.segmented.SegmentedLog`,
selected by pointing ``--journal`` at a DIRECTORY): per-shard sealed
segment files hash-partitioned by each entry's identity key
(:func:`entry_key`), an ``icln-journal/2`` manifest, and compaction
that touches only sealed files so it runs concurrently with live
appends.  The line grammar, the folds and every protocol invariant
are backend-independent.

The line grammar and its version (``icln-fleet-journal/1``, the
``icln-journal/2`` manifest) are the reference package's
(``iterative_cleaner_tpu/resilience/journal.py``), so each package's
:class:`FleetJournal` reads the other's files, torn tails included.
``config`` is each package's own :func:`config_hash`: the port's
identity holds ``device`` and the reference's holds its kernel routes,
so a reference ``done`` line never satisfies a port resume (it reads as
another config's line and the archive is cleaned again).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional

SCHEMA = "icln-fleet-journal/1"

# request lifecycle states; the daemon may only trust "done"/"failed" as
# final — anything else re-enqueues on restart
REQUEST_TERMINAL = ("done", "failed")

# claim lease states: grant / extend / end
CLAIM_STATES = ("claim", "hb", "release")

# membership lease states: announce / extend / depart.  "join" and "hb"
# fold identically (both re-grant the lease) so a compacted roster —
# which keeps only each member's last line, often an hb — stays whole.
MEMBER_STATES = ("join", "hb", "leave")


def entry_is_current(entry: dict) -> bool:
    """May a resume trust this 'done' entry?  The input must still match
    its recorded signature, and a recorded output must still exist with
    its recorded signature — anything else re-cleans."""
    from iterative_cleaner_torch.utils.checkpoint import file_signature

    path = entry.get("path", "")
    sig = entry.get("sig", "")
    if not path or not sig or file_signature(path) != sig:
        return False
    out = entry.get("out", "")
    if out:
        out_sig = entry.get("out_sig", "")
        if not os.path.exists(out):
            return False
        if out_sig and file_signature(out) != out_sig:
            return False
    return True


def _parse_lines(text: str):
    """Yield the parseable schema-matching dict entries of a journal text;
    torn tails and foreign lines are skipped, never fatal."""
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            entry = json.loads(line)
        except ValueError:
            continue
        if isinstance(entry, dict) and entry.get("schema") == SCHEMA:
            yield entry


def entry_key(entry: dict) -> str:
    """One entry's identity key — the string every fold groups by, and
    therefore the segmented backend's shard-routing key.  Partitioning
    by this key preserves each key's total line order across segments,
    which is the one property the folds need (every fold is
    per-identity-key; none observes cross-key interleaving)."""
    event = entry.get("event", "")
    if event == "done":
        return "done:%s" % entry.get("path", "")
    if event == "req":
        return "req:%s" % entry.get("req", "")
    if event == "claim":
        return "claim:%s" % entry.get("work", "")
    if event == "member":
        return "member:%s" % entry.get("member", "")
    if event == "cache":
        return "cache:%s" % entry.get("key", "")
    if event == "stats":
        return "stats:%s" % entry.get("host", "")
    return "event:%s" % event


class JournalLog:
    """The storage contract :class:`FleetJournal` folds over: append /
    scan / seal / compact.  Two implementations — the historical
    :class:`SingleFileLog` and the per-shard
    :class:`~iterative_cleaner_torch.resilience.segmented.SegmentedLog` —
    must be fold-equivalent: for any append sequence, ``scan_text``
    parses to the same per-key line order, so every fold produces the
    same tables."""

    backend = "abstract"
    n_shards = 1

    def append(self, key: str, text: str) -> bool:
        """Durably append one pre-serialized line routed by ``key``;
        returns True when a torn-tail heal fired."""
        raise NotImplementedError

    def scan_text(self) -> str:
        """Every live line as one text (the folds' input)."""
        raise NotImplementedError

    def exists(self) -> bool:
        raise NotImplementedError

    def size_bytes(self) -> int:
        """The bytes a fold must read (the compaction trigger)."""
        raise NotImplementedError

    def seal(self) -> int:
        """Retire open segments (no-op for a single file); returns how
        many sealed."""
        raise NotImplementedError

    def compact(self, live_lines_fn, now=None) -> bool:
        """Rewrite keeping only ``live_lines_fn(text, now)``; True when
        a rewrite happened."""
        raise NotImplementedError

    def compact_shard(self, shard: int, live_lines_fn, now=None) -> bool:
        """Compact one shard (the maintenance role's unit of work)."""
        raise NotImplementedError

    def segment_counts(self) -> Dict[int, int]:
        """shard -> live sealed segment count ({} for a single file)."""
        raise NotImplementedError


class SingleFileLog(JournalLog):
    """The historical backend: one flock'd JSON-lines file.  Default,
    byte-compatible with every journal ever written, zero migration."""

    backend = "file"
    n_shards = 1

    def __init__(self, path: str) -> None:
        self.path = os.path.abspath(path)

    def append(self, key: str, text: str) -> bool:
        from iterative_cleaner_torch.utils.logging import locked_append

        # heal a torn tail: a writer killed mid-line leaves no trailing
        # newline, and appending straight after it would glue THIS line
        # onto the garbage — losing a good entry, not just the torn one.
        # The probe races other appenders at worst into a spurious blank
        # line, which readers skip.
        healed = False
        try:
            with open(self.path, "rb") as f:
                f.seek(-1, os.SEEK_END)
                if f.read(1) != b"\n":
                    text = "\n" + text
                    healed = True
        except (OSError, ValueError):
            pass          # absent or empty file: nothing to heal
        locked_append(self.path, text)
        return healed

    def scan_text(self) -> str:
        if not os.path.exists(self.path):
            return ""
        with open(self.path, "r") as f:
            return f.read()

    def exists(self) -> bool:
        return os.path.exists(self.path)

    def size_bytes(self) -> int:
        try:
            return os.path.getsize(self.path)
        except OSError:
            return 0

    def seal(self) -> int:
        return 0

    def compact(self, live_lines_fn, now=None) -> bool:
        from iterative_cleaner_torch.utils.logging import compact_under_lock

        def rewrite(text: str) -> str:
            return "".join(ln + "\n" for ln in live_lines_fn(text, now))

        return compact_under_lock(self.path, rewrite)

    def compact_shard(self, shard: int, live_lines_fn, now=None) -> bool:
        # one file IS one shard; any shard id maps onto it
        return self.compact(live_lines_fn, now=now)

    def segment_counts(self) -> Dict[int, int]:
        return {}


def _looks_segmented(abs_path: str, raw_path: str) -> bool:
    """Backend auto-detection: a directory (existing, or spelled with a
    trailing separator, or holding an ``icln-journal/2`` manifest)
    selects the segmented backend; any plain file path keeps the
    byte-compatible single-file backend — zero migration."""
    from iterative_cleaner_torch.resilience.segmented import MANIFEST_NAME

    if os.path.isdir(abs_path):
        return True
    if str(raw_path).endswith(("/", os.sep)):
        return True
    return os.path.isfile(os.path.join(abs_path, MANIFEST_NAME))


class FleetJournal:
    """Append-only completion log for one fleet output set.

    Sharing one journal between concurrent fleets over disjoint path sets
    is safe (flock'd appends, per-path keys); the reader keeps the LAST
    entry per path, so re-cleans of a changed input supersede.

    ``path`` names either a single journal file (default backend) or a
    segment directory (segmented backend — see :func:`_looks_segmented`
    for the detection rule; ``backend=`` forces one).  ``registry`` (a
    ``MetricsRegistry``) turns on journal health telemetry:
    ``journal_torn_heals``, ``journal_compactions`` and the
    ``journal_fold_s`` histogram."""

    def __init__(self, path: str, *, backend: Optional[str] = None,
                 segment_mb: Optional[float] = None,
                 n_shards: Optional[int] = None,
                 registry=None) -> None:
        self.path = os.path.abspath(path)
        self.registry = registry
        if backend is None:
            backend = ("segmented" if _looks_segmented(self.path, path)
                       else "file")
        if backend == "segmented":
            from iterative_cleaner_torch.resilience.segmented import (
                SegmentedLog,
            )

            seg_bytes = (int(segment_mb * 1e6)
                         if segment_mb else None)
            self.log: JournalLog = SegmentedLog(
                self.path, segment_bytes=seg_bytes, n_shards=n_shards)
        elif backend == "file":
            self.log = SingleFileLog(self.path)
        else:
            raise ValueError(f"unknown journal backend {backend!r}")

    @property
    def backend(self) -> str:
        return self.log.backend

    def _append(self, entry: dict) -> None:
        text = json.dumps(entry, sort_keys=True) + "\n"
        healed = self.log.append(entry_key(entry), text)
        if healed:
            # a heal means some writer died mid-line here since the last
            # append: counted, with a flight-recorder breadcrumb, so
            # post-crash restarts are not silent
            if self.registry is not None:
                self.registry.counter_inc("journal_torn_heals")
            from iterative_cleaner_torch.telemetry.recorder import (
                record_active,
            )

            record_active("journal", "event",
                          {"name": "torn_heal", "path": self.path,
                           "backend": self.log.backend})

    def _scan_text(self) -> str:
        """The backend's full text, fold-timed into ``journal_fold_s``
        when a registry is attached (every fold below starts here, so
        one observation point covers them all)."""
        if self.registry is None:
            return self.log.scan_text()
        t0 = time.perf_counter()
        text = self.log.scan_text()
        from iterative_cleaner_torch.telemetry.registry import SECONDS

        self.registry.histogram_observe(
            "journal_fold_s", time.perf_counter() - t0, buckets=SECONDS)
        return text

    def record_done(self, in_path: str, *, config_hash: str,
                    out_path: Optional[str] = None,
                    trace: Optional[dict] = None) -> None:
        """Append one completion entry; signatures are taken now, i.e.
        after the (atomic) output write landed.  ``trace`` (a span's
        ``{"trace_id", "span_id"}`` context) records which request tree
        this archive finished under — post-mortem trace stitching."""
        from iterative_cleaner_torch.utils.checkpoint import file_signature

        entry = {
            "schema": SCHEMA,
            "event": "done",
            "path": os.path.abspath(in_path),
            "sig": file_signature(in_path),
            "config": config_hash,
        }
        if out_path:
            entry["out"] = os.path.abspath(out_path)
            entry["out_sig"] = file_signature(out_path)
        if trace:
            entry["trace"] = dict(trace)
        self._append(entry)

    def completed(self, config_hash: str) -> Dict[str, dict]:
        """abs-path -> last 'done' entry recorded under this config hash.
        Unparseable lines (the torn tail of a killed writer) and entries
        from other configs/schemas are skipped, never fatal."""
        out: Dict[str, dict] = {}
        for entry in _parse_lines(self._scan_text()):
            if (entry.get("event") != "done"
                    or entry.get("config") != config_hash
                    or not entry.get("path")):
                continue
            out[entry["path"]] = entry
        return out

    # ---------------------------------------------- request lifecycle

    def record_request(self, request_id: str, state: str, **fields) -> None:
        """Append one request lifecycle entry.  'accepted' entries should
        carry the full request description (``fields``) so a restarted
        daemon can re-run the request from the journal alone; state
        transitions after that only need the id."""
        if state not in ("accepted", "running") + REQUEST_TERMINAL:
            raise ValueError(f"unknown request state {state!r}")
        entry = {"schema": SCHEMA, "event": "req",
                 "req": str(request_id), "state": state}
        entry.update(fields)
        self._append(entry)

    def request_states(self) -> Dict[str, dict]:
        """request-id -> merged view of its lifecycle: the 'accepted'
        entry's fields (the request description) overlaid with the LAST
        state seen.  The torn-tail/foreign-line tolerance of
        :meth:`completed` applies."""
        out: Dict[str, dict] = {}
        for entry in _parse_lines(self._scan_text()):
            if entry.get("event") != "req" or not entry.get("req"):
                continue
            rid = entry["req"]
            prev = out.get(rid, {})
            merged = dict(prev)
            merged.update(entry)
            out[rid] = merged
        return out

    # ------------------------------------------------------ work claims

    def record_claim(self, work: str, *, host: int, nonce: str,
                     ttl_s: float, state: str = "claim",
                     now: Optional[float] = None,
                     trace: Optional[dict] = None) -> None:
        """Append one claim-lease line.  ``work`` is an opaque work-item
        key (the fleet uses the bucket geometry), ``nonce`` uniquely
        identifies the claimant attempt (host id + pid + random tag — a
        restarted host must not inherit its dead predecessor's lease),
        ``ttl_s`` the lease duration from ``now``.

        ``trace`` (``{"trace_id", "span_id"}``) is the claimant's span
        context.  It rides the lease through the fold, which is how a
        stolen bucket's spans stitch under the ORIGINATING request: the
        stealer never saw the request, but it reads the dead owner's
        trace context off the expired lease and parents its own bucket
        span there."""
        if state not in CLAIM_STATES:
            raise ValueError(f"unknown claim state {state!r}")
        entry = {
            "schema": SCHEMA, "event": "claim", "work": str(work),
            "host": int(host), "nonce": str(nonce), "state": state,
            "t": float(time.time() if now is None else now),
            "ttl": float(ttl_s),
        }
        if trace:
            entry["trace"] = dict(trace)
        self._append(entry)

    @staticmethod
    def _fold_claims(entries) -> Dict[str, dict]:
        """Fold claim lines (file order) into work -> owner.  Every
        reader applies this same rule to the same flock-serialized line
        order, so all hosts agree on each lease with no other channel:
        a 'claim' wins iff the work is unowned, owned by the same nonce,
        or the owner's lease had already expired at the claim's own
        timestamp; 'hb' extends the owner's lease; 'release' ends it."""
        owners: Dict[str, dict] = {}
        for entry in entries:
            if entry.get("event") != "claim" or not entry.get("work"):
                continue
            work, state = entry["work"], entry.get("state")
            t = float(entry.get("t", 0.0))
            ttl = float(entry.get("ttl", 0.0))
            cur = owners.get(work)
            if state == "claim":
                if (cur is None or cur["nonce"] == entry.get("nonce")
                        or cur["expires"] <= t):
                    own = {"host": int(entry.get("host", -1)),
                           "nonce": str(entry.get("nonce", "")),
                           "expires": t + ttl, "ttl": ttl}
                    # trace context survives the fold so a stealer can
                    # stitch its span under the dead owner's request
                    trace = entry.get("trace")
                    if isinstance(trace, dict):
                        own["trace"] = trace
                    owners[work] = own
            elif state == "hb":
                if cur is not None and cur["nonce"] == entry.get("nonce"):
                    cur["expires"] = t + ttl
                    cur["ttl"] = ttl
            elif state == "release":
                if cur is not None and cur["nonce"] == entry.get("nonce"):
                    del owners[work]
        return owners

    def claim_table(self, now: Optional[float] = None) -> Dict[str, dict]:
        """work -> ``{"host", "nonce", "expires", "live"}`` for every
        work item whose lease was granted and not released.  ``live`` is
        False once the lease expired (stealable).  Torn tails and
        foreign lines are skipped, never fatal."""
        if now is None:
            now = time.time()
        owners = self._fold_claims(_parse_lines(self._scan_text()))
        for own in owners.values():
            own["live"] = own["expires"] > now
        return owners

    def try_claim(self, work: str, *, host: int, nonce: str,
                  ttl_s: float, now: Optional[float] = None,
                  trace: Optional[dict] = None) -> bool:
        """Atomically try to take (or steal) ``work``: append a claim
        line, then read the fold back — True iff this ``nonce`` is the
        owner.  Losing a race costs one dead line; the flock'd append
        order guarantees exactly one winner, on every host's reading."""
        self.record_claim(work, host=host, nonce=nonce, ttl_s=ttl_s,
                          now=now, trace=trace)
        own = self.claim_table(now=now).get(str(work))
        return own is not None and own["nonce"] == str(nonce)

    def heartbeat(self, work: str, *, host: int, nonce: str,
                  ttl_s: float, now: Optional[float] = None) -> None:
        """Extend a held lease (no-op in the fold if the lease was lost
        — a heartbeat never steals)."""
        self.record_claim(work, host=host, nonce=nonce, ttl_s=ttl_s,
                          state="hb", now=now)

    def release(self, work: str, *, host: int, nonce: str,
                now: Optional[float] = None) -> None:
        self.record_claim(work, host=host, nonce=nonce, ttl_s=0.0,
                          state="release", now=now)

    # ------------------------------------------------------- host stats

    def record_host_stats(self, host: int, counters: Dict[str, float]
                          ) -> None:
        """Append one per-host telemetry snapshot (the host's fleet_*
        counter deltas for this run) — the collective-free aggregation
        substrate: any process can sum the slice from the journal even
        when another host is dead."""
        self._append({"schema": SCHEMA, "event": "stats",
                      "host": int(host),
                      "counters": {str(k): float(v)
                                   for k, v in counters.items()}})

    def host_stats(self) -> Dict[int, dict]:
        """host id -> last recorded counter snapshot."""
        out: Dict[int, dict] = {}
        for entry in _parse_lines(self._scan_text()):
            if entry.get("event") != "stats":
                continue
            try:
                host = int(entry.get("host"))
            except (TypeError, ValueError):
                continue
            counters = entry.get("counters")
            if isinstance(counters, dict):
                out[host] = counters
        return out

    # ------------------------------------------------- pool membership

    def record_member(self, member: str, state: str, *, host: int,
                      ttl_s: float, now: Optional[float] = None) -> None:
        """Append one membership-lease line.  ``member`` uniquely
        identifies one daemon incarnation (a restarted process must
        re-join under a fresh id, never inherit its dead predecessor's
        lease — same rule as claim nonces)."""
        if state not in MEMBER_STATES:
            raise ValueError(f"unknown member state {state!r}")
        self._append({
            "schema": SCHEMA, "event": "member", "member": str(member),
            "host": int(host), "state": state,
            "t": float(time.time() if now is None else now),
            "ttl": float(ttl_s),
        })

    @staticmethod
    def _fold_members(entries) -> Dict[str, dict]:
        """Fold member lines (file order) into member -> lease.  'join'
        and 'hb' both (re)grant the lease until ``t + ttl`` — unlike
        work claims there is nothing to steal, a member only ever
        extends ITSELF — and 'leave' ends it."""
        members: Dict[str, dict] = {}
        for entry in entries:
            if entry.get("event") != "member" or not entry.get("member"):
                continue
            member, state = entry["member"], entry.get("state")
            t = float(entry.get("t", 0.0))
            ttl = float(entry.get("ttl", 0.0))
            if state in ("join", "hb"):
                members[member] = {"host": int(entry.get("host", -1)),
                                   "expires": t + ttl}
            elif state == "leave":
                members.pop(member, None)
        return members

    def member_table(self, now: Optional[float] = None) -> Dict[str, dict]:
        """member-id -> ``{"host", "expires", "live"}`` for every member
        that joined and did not leave.  ``live`` is False once the
        membership lease expired — the member is evictable and its
        claimed requests stealable.  Torn tails and foreign lines are
        skipped, never fatal."""
        if now is None:
            now = time.time()
        members = self._fold_members(_parse_lines(self._scan_text()))
        for m in members.values():
            m["live"] = m["expires"] > now
        return members

    # ------------------------------------------------------ result cache

    @staticmethod
    def cache_key(sig: str, config_hash: str) -> str:
        """The content address of one cleaned archive: input signature
        × config identity — the same pair a resume verifies, so "cache
        hit" and "resume skip" trust exactly the same evidence."""
        return f"{sig}|{config_hash}"

    def record_cache(self, in_path: str, *, config_hash: str,
                     out_path: str,
                     trace: Optional[dict] = None) -> None:
        """Append one result-cache index line; signatures are taken now,
        i.e. after the (atomic) output write landed — like
        :meth:`record_done`, "a cache entry exists" implies "the output
        file was complete when indexed"."""
        from iterative_cleaner_torch.utils.checkpoint import file_signature

        sig = file_signature(in_path)
        entry = {
            "schema": SCHEMA,
            "event": "cache",
            "key": self.cache_key(sig, config_hash),
            "path": os.path.abspath(in_path),
            "sig": sig,
            "config": config_hash,
            "out": os.path.abspath(out_path),
            "out_sig": file_signature(out_path),
        }
        if trace:
            entry["trace"] = dict(trace)
        self._append(entry)

    def cache_index(self) -> Dict[str, dict]:
        """cache key -> last 'cache' entry.  Entries are an INDEX, not
        proof: a reader must re-verify the recorded signatures
        (:func:`entry_is_current`) before serving the recorded output."""
        out: Dict[str, dict] = {}
        for entry in _parse_lines(self._scan_text()):
            if entry.get("event") != "cache" or not entry.get("key"):
                continue
            out[entry["key"]] = entry
        return out

    # ----------------------------------------------------- compaction

    def live_lines(self, text: str,
                   now: Optional[float] = None) -> List[str]:
        """The keep-set of a compaction pass over ``text``: the last
        'done' line per archive path, the last 'req' line per request
        id, every claim line of works still under a granted lease (the
        lease fold needs the full history; released works drop all
        their claim lines), the last 'stats' line per host, the last
        'member' line of each member whose lease is unexpired at ``now``
        (left and lapsed members drop entirely — a compacted roster
        carries no ghosts) and the last 'cache' line per key that still
        verifies (dead entries are aged out — they can never hit), in
        last-seen order.  For a request the kept line is re-serialized
        from the MERGED lifecycle view, so the accepted entry's
        description survives even though only its final state line is
        kept."""
        if now is None:
            now = time.time()
        done: Dict[str, str] = {}
        reqs: Dict[str, dict] = {}
        claims: Dict[str, List[str]] = {}
        claim_entries: List[dict] = []
        stats: Dict[str, str] = {}
        members: Dict[str, str] = {}
        member_entries: List[dict] = []
        cache: Dict[str, dict] = {}
        order: List[str] = []

        def touch(key: str) -> None:
            if key in order:
                order.remove(key)
            order.append(key)

        for entry in _parse_lines(text):
            if entry.get("event") == "done" and entry.get("path"):
                key = "done:" + entry["path"]
                done[entry["path"]] = json.dumps(entry, sort_keys=True)
                touch(key)
            elif entry.get("event") == "req" and entry.get("req"):
                rid = entry["req"]
                merged = dict(reqs.get(rid, {}))
                merged.update(entry)
                reqs[rid] = merged
                touch("req:" + rid)
            elif entry.get("event") == "claim" and entry.get("work"):
                work = entry["work"]
                claims.setdefault(work, []).append(
                    json.dumps(entry, sort_keys=True))
                claim_entries.append(entry)
                touch("claim:" + work)
            elif entry.get("event") == "stats" \
                    and entry.get("host") is not None:
                hid = str(entry["host"])
                stats[hid] = json.dumps(entry, sort_keys=True)
                touch("stats:" + hid)
            elif entry.get("event") == "member" and entry.get("member"):
                mid = entry["member"]
                members[mid] = json.dumps(entry, sort_keys=True)
                member_entries.append(entry)
                touch("member:" + mid)
            elif entry.get("event") == "cache" and entry.get("key"):
                cache[entry["key"]] = entry
                touch("cache:" + entry["key"])
        owned = self._fold_claims(claim_entries)
        roster = self._fold_members(member_entries)
        lines = []
        for key in order:
            kind, _, ident = key.partition(":")
            if kind == "done":
                lines.append(done[ident])
            elif kind == "req":
                lines.append(json.dumps(reqs[ident], sort_keys=True))
            elif kind == "claim":
                if ident in owned:      # released works drop entirely
                    lines.extend(claims[ident])
            elif kind == "member":
                # only unexpired members survive: a leave removed the
                # member from the fold, a lapsed lease drops here —
                # eviction IS compaction forgetting you
                lease = roster.get(ident)
                if lease is not None and lease["expires"] > now:
                    lines.append(members[ident])
            elif kind == "cache":
                # age out, don't keep unconditionally: a line whose
                # recorded signatures no longer verify can never hit
                # again (lookup re-checks the same evidence), and with
                # varied inputs "one line per key forever" is unbounded
                # growth that every pool fold then pays to re-read
                if entry_is_current(cache[ident]):
                    lines.append(json.dumps(cache[ident], sort_keys=True))
            else:
                lines.append(stats[ident])
        return lines

    def compact(self) -> bool:
        """Rewrite the journal keeping only the live lines
        (:meth:`live_lines`) — the long-lived daemon's growth bound.
        Single-file backend: one atomic rewrite under the appenders'
        flock (concurrent appenders detect the inode swap and lose
        nothing).  Segmented backend: per-shard compaction of SEALED
        segments only, fully concurrent with live appends.  Returns
        True when a rewrite happened."""
        changed = self.log.compact(self.live_lines)
        if changed and self.registry is not None:
            self.registry.counter_inc("journal_compactions")
        return changed

    def compact_shard(self, shard: int) -> bool:
        """Compact one shard — the maintenance role's unit of work, so
        members holding a ``maint:<shard>`` lease each grind their own
        shard without contending.  On the single-file backend every
        shard id maps onto the one file."""
        changed = self.log.compact_shard(int(shard), self.live_lines)
        if changed and self.registry is not None:
            self.registry.counter_inc("journal_compactions")
        return changed

    def seal(self) -> int:
        """Retire open segments (segmented backend; no-op on a single
        file) so a short-lived writer leaves its lines compactable by
        whoever holds the maintenance lease next."""
        return self.log.seal()

    def n_shards(self) -> int:
        return self.log.n_shards

    def size_bytes(self) -> int:
        """The bytes a fold must read — the daemon's compaction
        trigger, meaningful on both backends."""
        return self.log.size_bytes()

    def segment_counts(self) -> Dict[int, int]:
        """shard -> live sealed segment count ({} on the single-file
        backend) — the healthz / telemetry view of journal shape."""
        return self.log.segment_counts()
