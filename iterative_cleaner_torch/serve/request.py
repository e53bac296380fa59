"""The serve daemon's request model and JSON wire format.

One request = one journaled unit of work: a list of archive paths plus
per-request cleaning overrides, a tenant, a priority and an optional
deadline.  Requests arrive as JSON objects — a spool file's content or an
HTTP POST body::

    {"paths": ["/data/a.npz", "/data/b.npz"],
     "tenant": "survey-A",            # optional, default "default"
     "priority": 5,                   # optional, higher serves sooner
     "deadline_s": 120.0,             # optional, relative to acceptance
     "overrides": {"max_iter": 3},    # optional CleanConfig overrides
     "trace": "req-7f3a"}             # optional client trace id (minted
                                      # at intake when absent)

A second request kind serves live streams (the online/ subsystem)::

    {"kind": "stream", "id": "obs-42",
     "meta": {...StreamMeta.to_dict()...}}  # needed for bare .npy chunks

A stream opens with no paths; per-subint chunk files arrive through
``POST /stream/<id>/subint`` and ``POST /stream/<id>/close`` ends it.

``overrides`` may only name whitelisted :class:`CleanConfig` fields — the
mask-relevant per-request knobs.  Output/IO/resilience knobs stay
daemon-level: a request must not redirect outputs or disable the journal.
Every parse failure raises :class:`RequestError` with a message fit for a
400 response or a spool ``.rejected`` marker — a malformed submission
must never take the daemon down.

The port's difference from the reference's wire format: the reference's
TPU route knobs (``fft_mode``, ``median_impl``, ``stats_impl``) are not
overridable, since the port has one route and no such knob (the CLI's
parser refuses them too).  ``backend: "numpy"`` is accepted as the
reference accepts it; the daemon keeps it in the request's config (its
journal lines and result-cache key) and cleans on the card, as the
reference's batched clean does whatever ``backend`` names
(:func:`~iterative_cleaner_torch.serve.daemon.engine_config`).
"""

from __future__ import annotations

import dataclasses
import json
import time
import uuid
from typing import Dict, List, Optional, Tuple

from iterative_cleaner_torch.config import CleanConfig
from iterative_cleaner_torch.telemetry.tracing import (
    new_trace_id,
    valid_trace_id,
)

# CleanConfig fields a request may override: the per-request cleaning
# semantics, nothing that changes where outputs land or how the daemon
# survives.  (backend is included: a tenant may ask for the numpy oracle.)
OVERRIDABLE = (
    "chanthresh", "subintthresh", "max_iter", "pulse_region",
    "bad_chan", "bad_subint", "backend", "rotation", "stats_frame",
    "baseline_mode", "stream_reconcile_every", "stream_ew_alpha",
)

# The reference's TPU route knobs, overridable there: the port has one
# route and refuses them by name.
ROUTE_KNOBS = ("fft_mode", "median_impl", "stats_impl")

# request kinds: a batch "clean" (paths known up front) or an online
# "stream" (kind: "stream"; subints arrive via POST /stream/<id>/subint
# and the payload grows until /close)
KINDS = ("clean", "stream")


class RequestError(ValueError):
    """A submission that cannot become a request (HTTP 400 material)."""


@dataclasses.dataclass
class ServeRequest:
    """One admitted unit of work; ``deadline_ts`` is absolute (unix
    seconds) so it survives the journal round trip unchanged."""

    request_id: str
    paths: List[str]
    # "clean" (batch, the default) or "stream" (online/: paths start
    # empty and chunk files accumulate through the stream endpoints)
    kind: str = "clean"
    # stream metadata (online/chunks.py StreamMeta.to_dict()) for bare
    # .npy chunks; empty for "clean" requests and archive-container chunks
    meta: Dict[str, object] = dataclasses.field(default_factory=dict)
    tenant: str = "default"
    priority: int = 0
    deadline_ts: Optional[float] = None
    overrides: Dict[str, object] = dataclasses.field(default_factory=dict)
    submitted_ts: float = dataclasses.field(default_factory=time.time)
    # distributed-tracing root for this request: minted at intake unless
    # the client supplied one ('trace' wire field) — every span the
    # request generates, on any host, carries this id.
    trace_id: str = dataclasses.field(default_factory=new_trace_id)
    # process-local: the daemon's root request span id, set at admission
    # so child spans (queue wait, execute) parent under it.  Never
    # journaled — a restarted daemon opens a fresh root span.
    root_span_id: Optional[str] = None

    def expired(self, now: Optional[float] = None) -> bool:
        if self.deadline_ts is None:
            return False
        return (time.time() if now is None else now) >= self.deadline_ts

    def effective_config(self, base: CleanConfig) -> CleanConfig:
        """The request's cleaning config: daemon base + overrides.  The
        CleanConfig validators run here, so an override combination the
        config rejects fails the REQUEST, not the daemon."""
        if not self.overrides:
            return base
        try:
            return dataclasses.replace(base, **self.overrides)
        except (TypeError, ValueError) as exc:
            raise RequestError(f"invalid overrides: {exc}") from exc

    def journal_fields(self) -> dict:
        """What the 'accepted' journal entry records — everything needed
        to re-run this request after a daemon restart."""
        return {
            "paths": list(self.paths),
            "kind": self.kind,
            "meta": dict(self.meta),
            "tenant": self.tenant,
            "priority": self.priority,
            "deadline_ts": self.deadline_ts,
            "overrides": dict(self.overrides),
            "submitted_ts": self.submitted_ts,
            "trace_id": self.trace_id,
        }

    @classmethod
    def from_journal_entry(cls, request_id: str,
                           entry: dict) -> "ServeRequest":
        """Rebuild a request from its merged journal lifecycle view (the
        restart path).  Overrides re-validate: a journal edited into an
        invalid state raises :class:`RequestError` and the daemon fails
        that request instead of crashing."""
        kind = str(entry.get("kind") or "clean")
        if kind not in KINDS:
            raise RequestError(
                f"journaled request {request_id!r} has unknown kind "
                f"{kind!r}")
        paths = entry.get("paths")
        if paths is None and kind == "stream":
            paths = []  # a stream's paths are its journaled chunks
        if not isinstance(paths, list) or (not paths and kind != "stream"):
            raise RequestError(
                f"journaled request {request_id!r} carries no paths "
                f"(compacted away or foreign entry)")
        overrides = entry.get("overrides") or {}
        _check_overrides(overrides)
        meta = entry.get("meta") or {}
        if not isinstance(meta, dict):
            raise RequestError(
                f"journaled request {request_id!r} has non-object meta")
        return cls(
            request_id=request_id,
            paths=[str(p) for p in paths],
            kind=kind,
            meta=meta,
            tenant=str(entry.get("tenant") or "default"),
            priority=int(entry.get("priority") or 0),
            deadline_ts=(float(entry["deadline_ts"])
                         if entry.get("deadline_ts") is not None else None),
            overrides=overrides,
            submitted_ts=float(entry.get("submitted_ts") or time.time()),
            # a pre-tracing journal has no trace_id: mint one so the
            # recovered re-run still traces end to end
            trace_id=(str(entry["trace_id"]) if entry.get("trace_id")
                      else new_trace_id()),
        )


def _check_overrides(overrides: dict) -> dict:
    if not isinstance(overrides, dict):
        raise RequestError("'overrides' must be a JSON object")
    route = sorted(set(overrides) & set(ROUTE_KNOBS))
    if route:
        raise RequestError(
            f"overrides {', '.join(route)}: the port has one route and no "
            f"such knob (the device decides the kernels)")
    bad = sorted(set(overrides) - set(OVERRIDABLE))
    if bad:
        raise RequestError(
            f"overrides {', '.join(bad)} are not request-overridable; "
            f"allowed: {', '.join(OVERRIDABLE)}")
    # pulse_region arrives as a JSON list; CleanConfig stores a tuple
    if "pulse_region" in overrides:
        try:
            overrides["pulse_region"] = tuple(
                float(v) for v in overrides["pulse_region"])
        except (TypeError, ValueError):
            raise RequestError("pulse_region must be three numbers")
    return overrides


def parse_request(payload, *, request_id: Optional[str] = None,
                  base_config: Optional[CleanConfig] = None,
                  now: Optional[float] = None) -> ServeRequest:
    """JSON text/bytes/dict -> validated :class:`ServeRequest`.

    ``request_id`` (e.g. a spool file's stem) wins over a payload ``id``;
    absent both, a fresh uuid suffix is minted.  With ``base_config`` the
    overrides are validated against the real CleanConfig constructors at
    parse time — rejection happens at intake, not mid-clean."""
    if isinstance(payload, (bytes, bytearray)):
        try:
            payload = payload.decode("utf-8")
        except UnicodeDecodeError as exc:
            raise RequestError(f"request body is not UTF-8: {exc}") from exc
    if isinstance(payload, str):
        try:
            payload = json.loads(payload)
        except ValueError as exc:
            raise RequestError(f"request body is not JSON: {exc}") from exc
    if not isinstance(payload, dict):
        raise RequestError("request must be a JSON object")

    kind = payload.get("kind", "clean")
    if kind not in KINDS:
        raise RequestError(
            f"'kind' must be one of {', '.join(KINDS)}, got {kind!r}")

    paths = payload.get("paths")
    if isinstance(paths, str):
        paths = [paths]
    if kind == "stream":
        # a stream opens empty: chunk paths arrive via the stream
        # endpoints, never in the opening submission
        if paths:
            raise RequestError(
                "a stream request opens with no 'paths'; POST chunks to "
                "/stream/<id>/subint instead")
        paths = []
    elif not isinstance(paths, list) or not paths \
            or not all(isinstance(p, str) and p for p in paths):
        raise RequestError("'paths' must be a non-empty list of archive "
                           "path strings")

    meta = payload.get("meta") or {}
    if not isinstance(meta, dict):
        raise RequestError("'meta' must be a JSON object")
    if meta and kind != "stream":
        raise RequestError("'meta' only applies to stream requests")
    if meta:
        from iterative_cleaner_torch.online.chunks import StreamMeta

        try:
            StreamMeta.from_dict(meta)  # validate at intake, not mid-ingest
        except ValueError as exc:
            raise RequestError(str(exc)) from None

    rid = request_id or payload.get("id") or uuid.uuid4().hex[:12]
    rid = str(rid)
    if not rid or len(rid) > 128 or any(c in rid for c in "\n\r/\\"):
        raise RequestError(f"invalid request id {rid!r}")

    try:
        priority = int(payload.get("priority", 0))
    except (TypeError, ValueError):
        raise RequestError("'priority' must be an integer")

    tenant = payload.get("tenant", "default")
    if not isinstance(tenant, str) or not tenant:
        raise RequestError("'tenant' must be a non-empty string")

    deadline_ts = None
    if payload.get("deadline_s") is not None:
        try:
            deadline_s = float(payload["deadline_s"])
        except (TypeError, ValueError):
            raise RequestError("'deadline_s' must be a number of seconds")
        if deadline_s <= 0:
            raise RequestError("'deadline_s' must be > 0")
        deadline_ts = (time.time() if now is None else now) + deadline_s

    overrides = _check_overrides(payload.get("overrides") or {})

    trace_id = payload.get("trace")
    if trace_id is not None and not valid_trace_id(trace_id):
        raise RequestError("'trace' must be a short alphanumeric trace id")

    known = {"paths", "id", "priority", "tenant", "deadline_s", "overrides",
             "trace", "kind", "meta"}
    unknown = sorted(set(payload) - known)
    if unknown:
        raise RequestError(f"unknown request fields: {', '.join(unknown)}")

    req = ServeRequest(request_id=rid, paths=list(paths), kind=kind,
                       meta=dict(meta), tenant=tenant,
                       priority=priority, deadline_ts=deadline_ts,
                       overrides=overrides,
                       trace_id=(str(trace_id) if trace_id
                                 else new_trace_id()))
    if base_config is not None:
        req.effective_config(base_config)  # validate now, reject at intake
    return req


def request_key(req: ServeRequest, seq: int) -> Tuple:
    """The scheduler's heap key: higher priority first, then earliest
    deadline, then submission order — a total order, so scheduling is
    deterministic for a given intake sequence."""
    deadline = req.deadline_ts if req.deadline_ts is not None else float("inf")
    return (-req.priority, deadline, seq)


def request_work_key(request_id: str) -> str:
    """The journal claim-lease key under which an elastic pool member
    leases one request's EXECUTION (the fleet's bucket keys play the
    same role one layer down).  Namespaced so request leases and bucket
    leases can never collide in a shared journal."""
    return "req:" + str(request_id)
