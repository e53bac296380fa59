"""Content-addressed result cache over the fleet journal.

The journal already carries the cleaner's resume identity: an archive's
input ``file_signature`` and the mask-identity ``config_hash``.  The
result cache indexes completed outputs under exactly that pair
(``event: "cache"`` lines, :meth:`FleetJournal.record_cache`), so a
repeat submission of the same archive under the same config
short-circuits to the recorded cleaned output with zero device work —
no load, no compile, no execute.

Trust ladder (verify, then fall back): an index entry is a CLAIM, not
proof.  Before serving from cache the
lookup re-verifies, per path,

1. the entry was recorded for THIS path (a ``cp -p`` copy or hardlink
   of a cleaned input carries the same signature, but its output lives
   next to the ORIGINAL path — a cross-path "hit" would answer done
   without materializing this path's output; it misses instead),
2. the input still matches the recorded signature (the key embeds it,
   and :func:`entry_is_current` re-checks — a rewritten input misses),
3. the recorded output still exists,
4. the output still matches its recorded signature (a truncated or
   hand-edited output is a corruption, not a hit).

Any rung failing counts ``serve_cache_rejected`` and the request falls
through to a real clean — a broken cache can cost time, never
correctness.  A request is served from cache only when EVERY path
verifies (all-or-nothing): partial hits run the fleet, whose journaled
resume skips the already-done archives anyway.

The index fold (:meth:`FleetJournal.cache_index`) is backend-agnostic:
cache lines hash to one shard of a segmented journal by their cache
key, so compaction retires superseded entries per shard without the
cache ever seeing a torn index.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

from iterative_cleaner_torch.resilience.journal import entry_is_current


class ResultCache:
    """Read/write view of the journal's cache index for one daemon."""

    def __init__(self, journal, registry=None) -> None:
        self.journal = journal
        self.registry = registry

    def _count(self, name: str, n: float = 1.0) -> None:
        if self.registry is not None:
            self.registry.counter_inc(name, n)

    def lookup(self, paths: List[str],
               config_hash: str) -> Optional[Dict[str, dict]]:
        """path -> verified cache entry for EVERY path, or None.

        None means "run the real clean": either some path has no index
        entry (a plain miss, ``serve_cache_misses``) or an entry failed
        signature verification (``serve_cache_rejected``, the
        corruption counter)."""
        from iterative_cleaner_torch.utils.checkpoint import file_signature

        index = self.journal.cache_index()
        hits: Dict[str, dict] = {}
        for p in paths:
            try:
                sig = file_signature(p)
            except OSError:
                self._count("serve_cache_misses")
                return None  # unreadable input: let the fleet report it
            entry = index.get(self.journal.cache_key(sig, config_hash))
            if entry is None:
                self._count("serve_cache_misses")
                return None
            if entry.get("path") != os.path.abspath(p):
                # same content, different path (a cp -p copy or hardlink
                # of a cleaned input): the recorded output belongs to the
                # ORIGINAL path — serving it would journal this request
                # done without ever materializing THIS path's output.
                # A plain miss: the real clean writes the right file.
                self._count("serve_cache_misses")
                return None
            if not entry.get("out") or not entry_is_current(entry):
                # indexed but no longer trustworthy: input rewritten,
                # output missing, or output signature drifted
                self._count("serve_cache_rejected")
                return None
            hits[p] = entry
        self._count("serve_cache_hits", len(hits))
        return hits

    def publish(self, paths: List[str], config_hash: str, *,
                out_path_fn, trace: Optional[dict] = None) -> int:
        """Index every path whose output landed (called after a request
        finished ok).  Signatures are taken now — after the atomic
        output writes — so an entry existing implies the output was
        whole when indexed.  A path whose files moved underneath us is
        skipped (``serve_cache_publish_errors``), never fatal: the cache
        is an accelerator, not a ledger."""
        n = 0
        for p in paths:
            out = out_path_fn(p)
            try:
                if not os.path.exists(out):
                    raise OSError(f"output missing: {out}")
                self.journal.record_cache(p, config_hash=config_hash,
                                          out_path=out, trace=trace)
                n += 1
            except OSError:
                self._count("serve_cache_publish_errors")
        return n
