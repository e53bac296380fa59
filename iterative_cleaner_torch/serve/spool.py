"""Watched-spool intake: drop a ``.json`` file, get a cleaning request.

The zero-dependency submission path (LOFAR-pipeline shaped: an upstream
stage writes archives plus a request file into a shared directory).  The
watcher scans ``spool_dir`` every ``poll_s`` for ``*.json`` files and
claims each by RENAMING it before parsing — rename is atomic on a POSIX
filesystem, so a file is ingested exactly once even if a second daemon
watches the same spool.  Outcomes are visible in the directory itself::

    req1.json            pending (a mid-drain submission stays like this)
    req1.json.accepted   admitted; lifecycle continues in the journal
    req1.json.rejected   refused (backpressure or malformed; reason inside
                         a trailing "#" comment-line is NOT added — the
                         journal and daemon log carry the reason)

Producers should write-then-rename into the spool themselves (write
``.tmp``, rename to ``.json``) so the watcher never claims a
half-written file.  For producers that don't, the watcher tells the two
failure shapes apart: a file whose JSON breaks mid-document is truly
malformed and is rejected (rejection is visible and debuggable; a silent
retry loop on it would spin forever), while a file that is empty or
whose JSON simply STOPS — truncated at end-of-buffer, the signature of a
write still in flight — is unclaimed back to ``.json`` for the next scan
(``serve_spool_torn``) so a slow writer's request is never lost.  The
``intake`` fault site fires per scanned file: an injected transient
skips the file this scan (``serve_retries``) and the next scan retries
it — intake faults never wedge or kill the daemon.
"""

from __future__ import annotations

import os
from typing import Callable, List

from iterative_cleaner_torch.serve.request import (
    RequestError,
    ServeRequest,
    parse_request,
)

ACCEPTED_SUFFIX = ".accepted"
REJECTED_SUFFIX = ".rejected"


def _json_truncated(raw: bytes) -> bool:
    """Does ``raw`` look like a JSON document cut off mid-write?  True
    for empty/whitespace-only content and for JSON whose parse error sits
    at the end of the buffer (the document just STOPS — ``{"paths": ["/a``)
    rather than at a syntax error mid-document (``{"paths": [}`` — that
    file will never become valid, so it must reject, not retry)."""
    import json

    text = raw.decode("utf-8", errors="replace")
    if not text.strip():
        return True
    try:
        json.loads(text)
    except json.JSONDecodeError as exc:
        if exc.pos >= len(text.rstrip()):
            return True
        # an unterminated string always runs to end-of-input: the error
        # anchors at its opening quote, but the tear is at EOF
        return exc.msg.startswith("Unterminated string")
    return False  # valid JSON that failed request validation: malformed


class SpoolWatcher:
    """One scan pass at a time (the daemon loop calls :meth:`scan_once`
    between queue polls; no thread of its own — the daemon owns timing).

    ``on_request(req, claimed_path)`` admits the parsed request and
    returns normally, or raises
    :class:`~iterative_cleaner_torch.serve.scheduler.Rejection`; the
    watcher renames the claimed file to match the outcome."""

    def __init__(self, spool_dir: str, *,
                 on_request: Callable[[ServeRequest, str], None],
                 base_config=None, registry=None, faults=None) -> None:
        self.spool_dir = os.path.abspath(spool_dir)
        self.on_request = on_request
        self.base_config = base_config
        self.registry = registry
        self.faults = faults
        os.makedirs(self.spool_dir, exist_ok=True)

    def _count(self, name: str) -> None:
        if self.registry is not None:
            self.registry.counter_inc(name)

    def pending_files(self) -> List[str]:
        try:
            names = sorted(os.listdir(self.spool_dir))
        except OSError:
            return []
        return [os.path.join(self.spool_dir, n) for n in names
                if n.endswith(".json") and not n.startswith(".")]

    def scan_once(self, stop_intake: bool = False) -> int:
        """Claim and submit every pending spool file; returns how many
        were admitted.  With ``stop_intake`` (draining) the scan is a
        no-op: mid-drain submissions stay untouched ``.json`` files for
        the next daemon start."""
        if stop_intake:
            return 0
        admitted = 0
        for path in self.pending_files():
            admitted += self._ingest(path)
        return admitted

    def _ingest(self, path: str) -> int:
        from iterative_cleaner_torch.serve.scheduler import Rejection

        if self.faults is not None:
            try:
                self.faults.fire("intake", detail=os.path.basename(path))
            except Exception:  # noqa: BLE001 -- counted below
                # transient intake fault: leave the file for the next
                # scan — submissions are never lost to a flaky intake
                self._count("serve_retries")
                return 0
        claimed = path + ".claimed"
        try:
            os.rename(path, claimed)  # atomic claim: exactly-once intake
        except OSError:
            return 0                  # raced another claimer / withdrawn
        stem = os.path.basename(path)[:-len(".json")]
        try:
            with open(claimed, "rb") as f:
                raw = f.read()
        except OSError as exc:
            self._reject(claimed, f"unreadable: {exc}")
            return 0
        try:
            req = parse_request(raw, request_id=stem,
                                base_config=self.base_config)
        except RequestError as exc:
            if _json_truncated(raw):
                # torn write: the producer is mid-rename-less write (or
                # crashed mid-write); unclaim so the next scan retries
                # once the file is whole — never reject a partial file
                self._count("serve_spool_torn")
                try:
                    os.rename(claimed, path)
                except OSError:
                    pass
                return 0
            self._reject(claimed, f"malformed: {exc}")
            return 0
        try:
            self.on_request(req, claimed)
        except Rejection as exc:
            self._reject(claimed, exc.detail)
            return 0
        # icln: ignore[atomic-write] -- state-machine rename between two existing spool names (.claimed -> .accepted), not a file publish
        os.replace(claimed, path + ACCEPTED_SUFFIX)
        return 1

    def _reject(self, claimed: str, detail: str) -> None:
        self._count("serve_rejected_spool")
        print(f"serve: rejected spool file "
              f"{os.path.basename(claimed)}: {detail}", flush=True)
        try:
            # icln: ignore[atomic-write] -- state-machine rename between two existing spool names (.claimed -> .rejected), not a file publish
            os.replace(claimed, claimed[:-len(".claimed")] + REJECTED_SUFFIX)
        except OSError:
            pass
