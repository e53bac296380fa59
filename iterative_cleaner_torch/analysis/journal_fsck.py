"""Journal fsck: validate a fleet journal against its explicit grammar.

The journal (resilience/journal.py) is the system's single source of
truth for exactly-once cleaning, pool membership and failover — so a
malformed journal is not a logging bug, it is a correctness bug.  This
module encodes the six line kinds as an explicit state machine and
checks any journal file against it:

* **grammar** — every parseable line must carry the schema tag, a known
  ``event`` and that event's required fields with the right types
  (``done`` needs path/sig/config; ``claim`` needs work/host/nonce/
  state/t/ttl; and so on).  A JSON line under a foreign schema is an
  error: the journal is exclusively ours.
* **request state machine** — per request id, states may only move
  forward (``accepted`` → ``running`` → ``done``/``failed``).  A
  regression (a 'running' or terminal line followed by 'accepted') is
  exactly the admit-ordering hazard the daemon's admission order
  prevents: the fold would read the finished request as unfinished
  forever, and a pool peer would adopt and duplicate-clean it.  A line after a terminal state is an
  error for the same reason.
* **torn-tail healing** — an unparseable line is a WARNING, not an
  error: a writer killed mid-line leaves one, and the next appender
  heals it by prefixing a newline (the reader skips the garbage).  The
  state machine therefore accepts garbage lines and blank lines
  anywhere; what it refuses is structurally valid JSON that lies about
  its shape.
* **lease monotonicity** — claim and member lease lines are appended
  under the file flock by processes reading a monotonic clock, so per
  work item / member id the ``t`` stamps must be non-decreasing (up to
  ``skew_s`` for cross-host clock skew).  A backwards stamp means a
  writer bypassed the locked append path or replayed stale lines —
  either breaks the fold's "everyone reads the same order" guarantee.

* **segment directories** — a segmented journal (``--journal DIR``,
  resilience/segmented.py) is checked as a whole: the manifest must
  parse under its own schema and only name well-formed segment files of
  the right shard; each shard's stream (live sealed segments in
  sequence order, then the active segment) runs through the same state
  machine — per-key total order is preserved within a shard, so the
  lifecycle and lease checks stay valid verbatim; and every line must
  actually ROUTE to the shard it lives in (``entry_key`` →
  ``stable_shard``), because a mis-routed line breaks the per-key
  ordering guarantee every fold depends on.

Entry points: :func:`fsck_journal` (one file or segment directory →
:class:`FsckReport`), ``icln-lint-torch --journal-fsck PATH`` (analysis/cli.py)
and :func:`record_fsck` (counters for /metrics — the CI gate and the serve
daemon both publish the verdict of the journals they actually produced).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Tuple

from iterative_cleaner_torch.resilience.journal import (
    CLAIM_STATES,
    MEMBER_STATES,
    REQUEST_TERMINAL,
    SCHEMA,
)

#: the six journal line kinds, in the order they entered the grammar
EVENT_KINDS = ("done", "req", "claim", "stats", "member", "cache")

#: request lifecycle rank: transitions may never lower it
_REQ_RANK = {"accepted": 0, "running": 1, "done": 2, "failed": 2}

_REQUEST_STATES = ("accepted", "running") + REQUEST_TERMINAL


@dataclasses.dataclass(frozen=True)
class FsckIssue:
    """One violation (``severity == "error"``) or accepted anomaly
    (``severity == "warning"``, e.g. a healed torn line)."""

    line: int
    kind: str
    severity: str
    message: str

    def render(self) -> str:
        return f"line {self.line}: {self.severity} [{self.kind}] {self.message}"


@dataclasses.dataclass
class FsckReport:
    path: str
    n_lines: int = 0
    #: segment files examined (0 for a single-file journal)
    n_segments: int = 0
    counts: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {k: 0 for k in EVENT_KINDS})
    issues: List[FsckIssue] = dataclasses.field(default_factory=list)

    @property
    def errors(self) -> List[FsckIssue]:
        return [i for i in self.issues if i.severity == "error"]

    @property
    def warnings(self) -> List[FsckIssue]:
        return [i for i in self.issues if i.severity == "warning"]

    @property
    def ok(self) -> bool:
        """Warnings (torn lines the readers heal) do not fail the gate;
        grammar/state-machine/lease errors do."""
        return not self.errors

    def to_dict(self) -> dict:
        return {
            "path": self.path,
            "ok": self.ok,
            "n_lines": self.n_lines,
            "n_segments": self.n_segments,
            "counts": dict(self.counts),
            "errors": [dataclasses.asdict(i) for i in self.errors],
            "warnings": [dataclasses.asdict(i) for i in self.warnings],
        }

    def render_text(self) -> str:
        out = [i.render() for i in self.issues]
        tally = ", ".join("%d %s" % (self.counts[k], k)
                          for k in EVENT_KINDS if self.counts[k])
        seg = ("" if not self.n_segments
               else " in %d segment%s" % (self.n_segments,
                                          "" if self.n_segments == 1
                                          else "s"))
        out.append("%s: %s — %d line%s%s (%s), %d error%s, %d warning%s"
                   % (self.path, "ok" if self.ok else "FAILED",
                      self.n_lines, "" if self.n_lines == 1 else "s", seg,
                      tally or "empty",
                      len(self.errors), "" if len(self.errors) == 1 else "s",
                      len(self.warnings),
                      "" if len(self.warnings) == 1 else "s"))
        return "\n".join(out)


def _type_name(value) -> str:
    return type(value).__name__


def _check_fields(entry: dict, spec: Dict[str, tuple],
                  lineno: int, issues: List[FsckIssue]) -> bool:
    """Required-field presence + type check; returns True when all hold
    (transition checks only run on grammatically whole lines)."""
    ok = True
    for field, types in spec.items():
        if field not in entry:
            issues.append(FsckIssue(
                lineno, "grammar", "error",
                f"{entry.get('event')} line is missing required field "
                f"{field!r}"))
            ok = False
        elif not isinstance(entry[field], types):
            issues.append(FsckIssue(
                lineno, "grammar", "error",
                f"{entry.get('event')} field {field!r} has type "
                f"{_type_name(entry[field])}, expected "
                f"{'/'.join(t.__name__ for t in types)}"))
            ok = False
    return ok


_NUM = (int, float)

#: required fields (and types) per event kind — bool is an int subclass,
#: so numeric fields explicitly refuse it where a bool would be a lie
_FIELD_SPECS: Dict[str, Dict[str, tuple]] = {
    "done": {"path": (str,), "sig": (str,), "config": (str,)},
    "req": {"req": (str,), "state": (str,)},
    "claim": {"work": (str,), "host": (int,), "nonce": (str,),
              "state": (str,), "t": _NUM, "ttl": _NUM},
    "stats": {"host": (int,), "counters": (dict,)},
    "member": {"member": (str,), "host": (int,), "state": (str,),
               "t": _NUM, "ttl": _NUM},
    "cache": {"key": (str,), "path": (str,), "sig": (str,),
              "config": (str,), "out": (str,), "out_sig": (str,)},
}


class _LeaseMonotony:
    """Per-key non-decreasing ``t`` check for claim/member lines."""

    def __init__(self, what: str, skew_s: float) -> None:
        self.what = what
        self.skew_s = skew_s
        self.last: Dict[str, Tuple[float, int]] = {}

    def observe(self, key: str, t: float, lineno: int,
                issues: List[FsckIssue]) -> None:
        prev = self.last.get(key)
        if prev is not None and t < prev[0] - self.skew_s:
            issues.append(FsckIssue(
                lineno, "lease-monotonicity", "error",
                f"{self.what} {key!r} lease stamp went backwards "
                f"(t={t:g} after t={prev[0]:g} on line {prev[1]}): "
                f"flock-serialized appends of a monotonic clock can "
                f"never do this — a writer bypassed the locked append "
                f"or replayed stale lines"))
        if prev is None or t > prev[0]:
            self.last[key] = (t, lineno)


def fsck_text(text: str, *, skew_s: float = 0.0) -> Tuple[
        List[FsckIssue], Dict[str, int], int]:
    """Validate journal ``text``; returns (issues, per-kind counts,
    n_lines).  Pure function of the text — the model checker and the
    unit tests call it on synthetic journals."""
    issues: List[FsckIssue] = []
    counts = {k: 0 for k in EVENT_KINDS}
    lines = text.splitlines()
    # request lifecycle: rid -> (rank, state, lineno of last transition)
    req_state: Dict[str, Tuple[int, str, int]] = {}
    claim_mono = _LeaseMonotony("claim work", skew_s)
    member_mono = _LeaseMonotony("member", skew_s)
    last_content = 0
    for i, raw in enumerate(lines, start=1):
        if raw.strip():
            last_content = i
    for lineno, raw in enumerate(lines, start=1):
        line = raw.strip()
        if not line:
            continue  # heal probes leave blank lines; readers skip them
        try:
            entry = json.loads(line)
        except ValueError:
            where = ("torn tail" if lineno == last_content
                     else "healed torn line")
            issues.append(FsckIssue(
                lineno, "torn-line", "warning",
                f"unparseable line ({where}): a writer died mid-append; "
                f"readers skip it and the next append healed it"))
            continue
        if not isinstance(entry, dict):
            issues.append(FsckIssue(
                lineno, "grammar", "error",
                f"parseable JSON but not an object "
                f"({_type_name(entry)}): not a journal line"))
            continue
        if entry.get("schema") != SCHEMA:
            issues.append(FsckIssue(
                lineno, "grammar", "error",
                f"foreign or missing schema tag {entry.get('schema')!r} "
                f"(expected {SCHEMA!r}): the journal file is exclusively "
                f"the fleet's"))
            continue
        event = entry.get("event")
        if event not in EVENT_KINDS:
            issues.append(FsckIssue(
                lineno, "grammar", "error",
                f"unknown event {event!r} (known: "
                f"{', '.join(EVENT_KINDS)})"))
            continue
        counts[event] += 1
        if not _check_fields(entry, _FIELD_SPECS[event], lineno, issues):
            continue
        if event == "done":
            if bool(entry.get("out")) != bool(entry.get("out_sig")):
                issues.append(FsckIssue(
                    lineno, "grammar", "error",
                    "done line has 'out' without 'out_sig' (or vice "
                    "versa): a recorded output must carry the signature "
                    "a resume re-verifies"))
        elif event == "req":
            state = entry["state"]
            if state not in _REQUEST_STATES:
                issues.append(FsckIssue(
                    lineno, "grammar", "error",
                    f"request state {state!r} is not one of "
                    f"{'/'.join(_REQUEST_STATES)}"))
                continue
            rid = entry["req"]
            rank = _REQ_RANK[state]
            prev = req_state.get(rid)
            if prev is not None:
                prev_rank, prev_state, prev_line = prev
                if prev_rank >= _REQ_RANK["done"] and state != prev_state:
                    issues.append(FsckIssue(
                        lineno, "state-machine", "error",
                        f"request {rid!r}: {state!r} after terminal "
                        f"{prev_state!r} (line {prev_line}) — a finished "
                        f"request's lifecycle is closed"))
                elif (prev_rank >= _REQ_RANK["done"]
                        and state == prev_state):
                    issues.append(FsckIssue(
                        lineno, "state-machine", "error",
                        f"request {rid!r}: duplicate terminal "
                        f"{state!r} (first on line {prev_line}) — "
                        f"exactly-once means one terminal line"))
                elif rank < prev_rank:
                    issues.append(FsckIssue(
                        lineno, "state-machine", "error",
                        f"request {rid!r}: state regressed "
                        f"{prev_state!r} (line {prev_line}) -> {state!r} "
                        f"— the admit-ordering hazard: the fold now "
                        f"reads a finished request as unfinished and a "
                        f"pool peer would duplicate-clean it"))
            if prev is None or rank >= prev[0]:
                req_state[rid] = (rank, state, lineno)
        elif event == "claim":
            if entry["state"] not in CLAIM_STATES:
                issues.append(FsckIssue(
                    lineno, "grammar", "error",
                    f"claim state {entry['state']!r} is not one of "
                    f"{'/'.join(CLAIM_STATES)}"))
                continue
            if entry["ttl"] < 0:
                issues.append(FsckIssue(
                    lineno, "grammar", "error",
                    f"claim ttl is negative ({entry['ttl']:g}): a lease "
                    f"cannot expire before it was granted"))
            claim_mono.observe(entry["work"], float(entry["t"]),
                               lineno, issues)
        elif event == "member":
            if entry["state"] not in MEMBER_STATES:
                issues.append(FsckIssue(
                    lineno, "grammar", "error",
                    f"member state {entry['state']!r} is not one of "
                    f"{'/'.join(MEMBER_STATES)}"))
                continue
            if entry["ttl"] < 0:
                issues.append(FsckIssue(
                    lineno, "grammar", "error",
                    f"member ttl is negative ({entry['ttl']:g})"))
            member_mono.observe(entry["member"], float(entry["t"]),
                                lineno, issues)
        elif event == "stats":
            bad = [k for k, v in entry["counters"].items()
                   if not isinstance(v, _NUM) or isinstance(v, bool)]
            if bad:
                issues.append(FsckIssue(
                    lineno, "grammar", "error",
                    f"stats counters {sorted(bad)!r} are not numeric"))
        elif event == "cache":
            want = f"{entry['sig']}|{entry['config']}"
            if entry["key"] != want:
                issues.append(FsckIssue(
                    lineno, "grammar", "error",
                    f"cache key {entry['key']!r} != sig|config "
                    f"({want!r}): a mis-keyed entry can serve the wrong "
                    f"output to a matching lookup"))
    return issues, counts, len(lines)


def _check_manifest(path: str, report: FsckReport) -> Optional[dict]:
    """Validate a segment directory's manifest grammar; returns the
    parsed manifest, or None when it is too broken to fold over (the
    errors are already on the report)."""
    from iterative_cleaner_torch.resilience.segmented import (
        MANIFEST_NAME, MANIFEST_SCHEMA, segment_parts)

    man_path = os.path.join(path, MANIFEST_NAME)
    if not os.path.isfile(man_path):
        report.issues.append(FsckIssue(
            0, "manifest", "error",
            f"segment directory has no {MANIFEST_NAME}: not a segmented "
            f"journal (or its atomic initial write never landed)"))
        return None
    try:
        with open(man_path, "r", encoding="utf-8") as f:
            man = json.load(f)
    except ValueError as exc:
        report.issues.append(FsckIssue(
            0, "manifest", "error",
            f"{MANIFEST_NAME} is not valid JSON ({exc}): manifest "
            f"rewrites are atomic, so a torn manifest means a writer "
            f"bypassed the locked rewrite path"))
        return None
    if not isinstance(man, dict) or man.get("schema") != MANIFEST_SCHEMA:
        report.issues.append(FsckIssue(
            0, "manifest", "error",
            f"{MANIFEST_NAME} schema is "
            f"{man.get('schema') if isinstance(man, dict) else man!r}, "
            f"expected {MANIFEST_SCHEMA!r}"))
        return None
    n_shards = man.get("n_shards")
    if not isinstance(n_shards, int) or isinstance(n_shards, bool) \
            or n_shards <= 0:
        report.issues.append(FsckIssue(
            0, "manifest", "error",
            f"n_shards is {n_shards!r}, expected a positive int"))
        return None
    shards = man.get("shards")
    if not isinstance(shards, dict):
        report.issues.append(FsckIssue(
            0, "manifest", "error",
            f"shards is {_type_name(shards)}, expected an object"))
        return None
    ok = True
    for key in sorted(shards):
        ent = shards[key]
        if not (key.isdigit() and int(key) < n_shards):
            report.issues.append(FsckIssue(
                0, "manifest", "error",
                f"shard key {key!r} is not a decimal index in "
                f"[0, {n_shards})"))
            ok = False
            continue
        if not isinstance(ent, dict):
            report.issues.append(FsckIssue(
                0, "manifest", "error",
                f"shard {key} entry is {_type_name(ent)}, expected an "
                f"object"))
            ok = False
            continue
        for field in ("segments", "dead"):
            names = ent.get(field)
            if not isinstance(names, list):
                report.issues.append(FsckIssue(
                    0, "manifest", "error",
                    f"shard {key} {field!r} is "
                    f"{_type_name(names)}, expected a list"))
                ok = False
                continue
            for name in names:
                parts = (segment_parts(name)
                         if isinstance(name, str) else None)
                if parts is None or parts[1] != int(key):
                    report.issues.append(FsckIssue(
                        0, "manifest", "error",
                        f"shard {key} {field} entry {name!r} is not a "
                        f"segment name of this shard"))
                    ok = False
    return man if ok else None


def _fsck_segment_dir(path: str, *, skew_s: float) -> FsckReport:
    """Validate a segmented journal directory: manifest grammar, every
    shard's stream through the single-file state machine (per-key order
    is preserved within a shard, so lifecycle/lease checks carry over
    verbatim), plus the shard-routing invariant."""
    from iterative_cleaner_torch.parallel.distributed import stable_shard
    from iterative_cleaner_torch.resilience.journal import entry_key
    from iterative_cleaner_torch.resilience.segmented import SegmentedLog

    report = FsckReport(path=path)
    man = _check_manifest(path, report)
    if man is None:
        return report
    log = SegmentedLog(path)  # manifest exists: read-only construction
    n_shards = log.n_shards
    names = log._names_on_disk()
    for shard in range(n_shards):
        chunks = []
        for name in log._effective(shard, man, names):
            seg_path = os.path.join(path, name)
            try:
                chunks.append(log._read_file(seg_path))
                report.n_segments += 1
            except OSError:
                report.issues.append(FsckIssue(
                    0, "manifest", "error",
                    f"shard {shard}: listed segment {name} is missing "
                    f"on disk (and not on the dead list) — a manifest "
                    f"swap retired it without listing it dead"))
        try:
            chunks.append(log._read_file(log._active_path(shard)))
            report.n_segments += 1
        except OSError:
            pass  # no active segment: this shard is fully sealed
        text = "".join(chunks)
        issues, counts, n_lines = fsck_text(text, skew_s=skew_s)
        report.issues.extend(dataclasses.replace(
            i, message=f"shard {shard}: {i.message}") for i in issues)
        for kind, n in counts.items():
            report.counts[kind] += n
        report.n_lines += n_lines
        for lineno, raw in enumerate(text.splitlines(), start=1):
            line = raw.strip()
            if not line:
                continue
            try:
                entry = json.loads(line)
            except ValueError:
                continue  # torn line: already a warning above
            if not isinstance(entry, dict) \
                    or entry.get("event") not in EVENT_KINDS:
                continue  # grammar error: already reported above
            want = stable_shard(entry_key(entry), n_shards)
            if want != shard:
                report.issues.append(FsckIssue(
                    lineno, "shard-routing", "error",
                    f"shard {shard}: {entry.get('event')} line with key "
                    f"{entry_key(entry)!r} routes to shard {want} — a "
                    f"mis-routed line breaks per-key total order, the "
                    f"one property every fold depends on"))
    return report


def fsck_journal(path: str, *, skew_s: float = 0.0) -> FsckReport:
    """Validate one journal — a single file, or a segmented journal
    directory (dispatches on ``os.path.isdir``).  A missing path is an
    error (the gate is pointed at journals a drill claims to have
    produced)."""
    if os.path.isdir(path):
        return _fsck_segment_dir(path, skew_s=skew_s)
    report = FsckReport(path=path)
    if not os.path.isfile(path):
        report.issues.append(FsckIssue(
            0, "grammar", "error", f"journal file not found: {path}"))
        return report
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        text = f.read()
    report.issues, report.counts, report.n_lines = fsck_text(
        text, skew_s=skew_s)
    return report


def record_fsck(registry, report: FsckReport) -> None:
    """Publish one fsck verdict into a MetricsRegistry alongside the
    lint counters: ``journal_fsck_errors{kind=...}`` /
    ``journal_fsck_warnings{kind=...}`` per issue, plus the ok gauge."""
    from iterative_cleaner_torch.telemetry.registry import labeled

    registry.gauge_set("journal_fsck_ok", 1 if report.ok else 0)
    registry.gauge_set("journal_fsck_lines", report.n_lines)
    registry.gauge_set("journal_fsck_segments", report.n_segments)
    for issue in report.issues:
        name = ("journal_fsck_errors" if issue.severity == "error"
                else "journal_fsck_warnings")
        registry.counter_inc(labeled(name, kind=issue.kind))
