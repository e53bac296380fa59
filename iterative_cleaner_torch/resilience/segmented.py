"""Segmented journal backend: per-shard sealed segments + a manifest.

The single-file journal serializes every admission, claim, heartbeat,
membership beat, cache line and done record of the whole pool through
one flock'd file — fine for a 2-member CI drill, a wall at hundreds of
members: ``compact()`` rewrites the entire history under the appenders'
lock and every fold re-reads every line ever written.  This backend
bounds both by partitioning the journal into per-shard segment files
hash-routed like ``bucket_host`` (:func:`stable_shard` over the entry's
identity key), so appends contend only within a shard, compaction
touches only SEALED files (never the file being appended to — live
traffic and compaction run concurrently by construction), and folds
read only the manifest-listed live segments.

On-disk layout (``--journal DIR``)::

    DIR/MANIFEST.json            {"schema": "icln-journal/2",
                                  "n_shards": N,
                                  "shards": {"0": {"segments": [...],
                                                   "dead": [...]}, ...}}
    DIR/shard-00.active.jsonl    the shard's open segment (flock'd appends)
    DIR/seg-00-000001.jsonl      sealed segments (immutable)
    DIR/cmp-00-000003.jsonl      compacted segments (immutable)

State machine (every arrow is one atomic ``os.replace``):

* **seal** — when a shard's active segment passes the size threshold it
  is renamed to ``seg-<shard>-<seq>`` under the appenders' flock
  (:func:`~iterative_cleaner_torch.utils.logging.seal_log`; concurrent
  appenders detect the inode swap and re-create a fresh active), then
  the manifest adds the sealed name.  A crash between the two leaves a
  ``seg-`` *orphan*: readers and compactors adopt any ``seg-`` file
  that is neither listed nor on the shard's dead list, so no sealed
  line is ever invisible.
* **compact** — fold the shard's sealed segments (manifest-listed plus
  adopted orphans) through the caller's keep-set, write the survivors
  to ``cmp-<shard>-<maxseq>`` via ``atomic_output``, then swap the
  manifest in one rewrite: segments become ``[cmp] + survivors``, the
  inputs move to the shard's ``dead`` list.  Only then are the input
  files unlinked and the dead list cleared.  A crash at any boundary
  is recoverable: an unswapped ``cmp-`` file is an ignored orphan (the
  inputs are still listed), a swapped-but-not-unlinked input is
  excluded via ``dead`` and garbage-collected by the next pass.
  Sequence numbers are allocated as max(manifest + directory) + 1 per
  shard, so names never collide with history.

Correctness of per-shard folding: every journal fold (done per path,
req per request id, claim per work key, member per member id, stats
per host, cache per key) is keyed by the same identity string the
router hashes, so hash-partitioning preserves each key's total line
order — a fold over the concatenated shard texts equals the fold over
the single file.

Lint discipline: the only flock/rename primitives used are the
sanctioned chokepoints — ``locked_append``/``seal_log``/
``compact_under_lock`` (utils/logging.py) and ``atomic_output``
(io/atomic.py); this module never takes a lock of its own.
"""

from __future__ import annotations

import json
import os
import re
import time
from typing import Callable, Dict, List, Optional, Set

MANIFEST_SCHEMA = "icln-journal/2"
MANIFEST_NAME = "MANIFEST.json"
DEFAULT_N_SHARDS = 8
DEFAULT_SEGMENT_BYTES = 4 * 1000 * 1000

#: sealed/compacted segment names: ``seg-<shard>-<seq>.jsonl`` /
#: ``cmp-<shard>-<seq>.jsonl``.  ``cmp`` files only ever enter service
#: through a manifest swap — an unlisted ``cmp`` orphan is a crashed
#: compaction and is never adopted (its inputs are still listed).
_SEG_RE = re.compile(r"^(seg|cmp)-(\d+)-(\d+)\.jsonl$")


def active_name(shard: int) -> str:
    return "shard-%02d.active.jsonl" % int(shard)


def sealed_name(shard: int, seq: int) -> str:
    return "seg-%02d-%06d.jsonl" % (int(shard), int(seq))


def compacted_name(shard: int, seq: int) -> str:
    return "cmp-%02d-%06d.jsonl" % (int(shard), int(seq))


def segment_parts(name: str):
    """``(kind, shard, seq)`` of a segment file name, or None."""
    m = _SEG_RE.match(name)
    if m is None:
        return None
    return m.group(1), int(m.group(2)), int(m.group(3))


class SegmentedLog:
    """The segmented ``JournalLog`` backend (see module docstring).

    ``segment_bytes`` is the seal threshold for THIS writer only — it is
    deliberately not persisted, so readers need no knob and mixed
    thresholds across writers merely seal at different sizes.
    ``n_shards`` is persisted in the manifest and wins over the
    constructor argument on an existing directory: every writer must
    route identically or per-key line order breaks."""

    backend = "segmented"

    def __init__(self, root: str, *,
                 segment_bytes: Optional[int] = None,
                 n_shards: Optional[int] = None) -> None:
        self.root = os.path.abspath(root)
        self.segment_bytes = int(segment_bytes or DEFAULT_SEGMENT_BYTES)
        os.makedirs(self.root, exist_ok=True)
        self._manifest_path = os.path.join(self.root, MANIFEST_NAME)
        if not os.path.exists(self._manifest_path):
            self._init_manifest(int(n_shards or DEFAULT_N_SHARDS))
        self.n_shards = int(self._read_manifest().get(
            "n_shards", DEFAULT_N_SHARDS))

    # ------------------------------------------------------------ manifest

    def _init_manifest(self, n_shards: int) -> None:
        from iterative_cleaner_torch.io.atomic import atomic_output

        man = {"schema": MANIFEST_SCHEMA, "n_shards": int(n_shards),
               "shards": {str(i): {"segments": [], "dead": []}
                          for i in range(int(n_shards))}}
        # racing initializers write byte-identical content (atomic
        # replace, last wins) as long as they agree on n_shards — which
        # shared-config deployments do by construction
        with atomic_output(self._manifest_path) as tmp:
            with open(tmp, "w") as f:
                json.dump(man, f, indent=1, sort_keys=True)
                f.write("\n")

    def _read_manifest(self) -> dict:
        with open(self._manifest_path, "r") as f:
            man = json.load(f)
        if not isinstance(man, dict) or man.get("schema") != MANIFEST_SCHEMA:
            raise ValueError(
                f"{self._manifest_path}: not an {MANIFEST_SCHEMA} manifest")
        return man

    def _shard_entry(self, man: dict, shard: int) -> dict:
        return man.setdefault("shards", {}).setdefault(
            str(int(shard)), {"segments": [], "dead": []})

    def _update_manifest(self, mutate: Callable[[dict], bool]) -> bool:
        """Apply ``mutate(manifest) -> commit?`` as one atomic rewrite
        under the manifest's flock.  ``compact_under_lock`` yields to a
        racing rewrite (inode swap) rather than applying ours on stale
        text, so retry until our rewrite actually ran."""
        from iterative_cleaner_torch.utils.logging import compact_under_lock

        outcome = {"ran": False, "committed": False}

        def rewrite(text: str) -> str:
            outcome["ran"] = True
            man = json.loads(text)
            if not isinstance(man, dict) \
                    or man.get("schema") != MANIFEST_SCHEMA:
                raise ValueError(
                    f"{self._manifest_path}: not an {MANIFEST_SCHEMA} "
                    f"manifest")
            if mutate(man):
                outcome["committed"] = True
                return json.dumps(man, indent=1, sort_keys=True) + "\n"
            return text
        for _ in range(64):
            if not os.path.exists(self._manifest_path):
                self._init_manifest(self.n_shards)
            outcome["ran"] = False
            if compact_under_lock(self._manifest_path, rewrite) \
                    or outcome["ran"]:
                return outcome["committed"]
        raise RuntimeError(
            f"{self._manifest_path}: manifest rewrite starved after 64 "
            f"attempts")

    # ------------------------------------------------------------- naming

    def _active_path(self, shard: int) -> str:
        return os.path.join(self.root, active_name(shard))

    def _names_on_disk(self) -> Set[str]:
        try:
            return set(os.listdir(self.root))
        except OSError:
            return set()

    def _next_seq(self, shard: int) -> int:
        """max(manifest ∪ directory) + 1 for this shard — monotone even
        across crashed seals (the orphan is on disk) and compactions
        (the cmp file carries its inputs' max seq)."""
        man = self._read_manifest()
        ent = man.get("shards", {}).get(str(int(shard)), {})
        names = set(ent.get("segments", [])) | set(ent.get("dead", []))
        names |= self._names_on_disk()
        top = 0
        for name in names:
            parts = segment_parts(name)
            if parts is not None and parts[1] == int(shard):
                top = max(top, parts[2])
        return top + 1

    def _effective(self, shard: int, man: dict,
                   names: Set[str]) -> List[str]:
        """The shard's live sealed segments in fold order: the manifest
        list plus adopted ``seg-`` orphans (a crashed seal's rename
        landed but its manifest update did not), minus nothing — dead
        files are excluded by the list itself.  Sorted by sequence
        number, which by construction is chronological."""
        ent = man.get("shards", {}).get(str(int(shard)), {})
        listed = [n for n in ent.get("segments", [])
                  if segment_parts(n) is not None]
        dead = set(ent.get("dead", []))
        have = set(listed) | dead
        orphans = []
        for name in names:
            parts = segment_parts(name)
            if (parts is not None and parts[0] == "seg"
                    and parts[1] == int(shard) and name not in have):
                orphans.append(name)
        return sorted(set(listed) | set(orphans),
                      key=lambda n: (segment_parts(n)[2], n))

    # ------------------------------------------------------------- append

    def append(self, key: str, text: str) -> bool:
        """Append one pre-serialized line to ``key``'s shard; heal a
        torn tail first (same probe as the single-file backend, scoped
        to the shard's active segment).  Seals the active segment when
        it passes the threshold.  Returns True when a heal fired."""
        from iterative_cleaner_torch.parallel.distributed import stable_shard
        from iterative_cleaner_torch.utils.logging import locked_append

        shard = stable_shard(key, self.n_shards)
        path = self._active_path(shard)
        healed = False
        try:
            with open(path, "rb") as f:
                f.seek(-1, os.SEEK_END)
                if f.read(1) != b"\n":
                    text = "\n" + text
                    healed = True
        except (OSError, ValueError):
            pass          # absent or empty active: nothing to heal
        locked_append(path, text)
        try:
            if os.path.getsize(path) >= self.segment_bytes:
                self.seal_shard(shard)
        except OSError:
            pass          # sealed under us: the racing sealer handled it
        return healed

    # --------------------------------------------------------------- seal

    def seal_shard(self, shard: int) -> bool:
        """Retire the shard's active segment to a sealed name (atomic
        rename under the appenders' flock), then list it in the
        manifest.  Crash between the two steps leaves an adoptable
        ``seg-`` orphan — see :meth:`_effective`."""
        from iterative_cleaner_torch.utils.logging import seal_log

        path = self._active_path(shard)
        try:
            if os.path.getsize(path) == 0:
                return False
        except OSError:
            return False
        name = sealed_name(shard, self._next_seq(shard))
        if not seal_log(path, os.path.join(self.root, name)):
            return False  # raced another sealer: theirs won

        def mutate(man: dict) -> bool:
            ent = self._shard_entry(man, shard)
            if name in ent["segments"] or name in ent["dead"]:
                return False
            ent["segments"] = sorted(
                set(ent["segments"]) | {name},
                key=lambda n: (segment_parts(n)[2], n))
            return True
        self._update_manifest(mutate)
        return True

    def seal(self) -> int:
        """Force-seal every non-empty active segment (shutdown / test
        hook); returns how many sealed."""
        return sum(1 for shard in range(self.n_shards)
                   if self.seal_shard(shard))

    # -------------------------------------------------------------- folds

    def _read_file(self, path: str) -> str:
        """One segment's text with a guaranteed trailing newline, so a
        torn tail (killed writer) becomes a torn LINE at concatenation —
        which every fold's parser already skips (heal-aware)."""
        with open(path, "r") as f:
            text = f.read()
        if text and not text.endswith("\n"):
            text += "\n"
        return text

    def scan_text(self) -> str:
        """The whole journal as one text: per shard, the live sealed
        segments (seq order) then the active segment.  Per-key line
        order is the append order (a key lives in exactly one shard);
        cross-shard interleaving is arbitrary, which no fold observes —
        every fold is per-identity-key.  A concurrent compaction can
        unlink a listed segment mid-scan; the manifest re-read retries
        that race away."""
        last_err: Optional[BaseException] = None
        for _ in range(6):
            try:
                man = self._read_manifest()
                names = self._names_on_disk()
                parts: List[str] = []
                for shard in range(self.n_shards):
                    for name in self._effective(shard, man, names):
                        parts.append(
                            self._read_file(os.path.join(self.root, name)))
                    try:
                        parts.append(self._read_file(
                            self._active_path(shard)))
                    except FileNotFoundError:
                        pass  # nothing appended to this shard yet
                return "".join(parts)
            except FileNotFoundError as err:
                last_err = err  # raced a compactor: re-read the manifest
        raise RuntimeError(
            f"{self.root}: scan kept losing races with compaction "
            f"({last_err})")

    def exists(self) -> bool:
        return os.path.exists(self._manifest_path)

    def size_bytes(self) -> int:
        """Total live bytes: manifest-listed (+ adopted) segments plus
        active segments — what a fold must read."""
        try:
            man = self._read_manifest()
        except (OSError, ValueError):
            return 0
        names = self._names_on_disk()
        total = 0
        for shard in range(self.n_shards):
            for name in self._effective(shard, man, names):
                try:
                    total += os.path.getsize(os.path.join(self.root, name))
                except OSError:
                    pass
            try:
                total += os.path.getsize(self._active_path(shard))
            except OSError:
                pass
        return total

    def segment_counts(self) -> Dict[int, int]:
        """shard -> live sealed segment count (telemetry / healthz)."""
        try:
            man = self._read_manifest()
        except (OSError, ValueError):
            return {}
        names = self._names_on_disk()
        return {shard: len(self._effective(shard, man, names))
                for shard in range(self.n_shards)}

    # ----------------------------------------------------------- compact

    def _gc_dead(self, shard: int) -> None:
        """Finish a crashed compaction's retirement: unlink the shard's
        dead files, then drop the dead entries whose files are actually
        gone.  Entries whose files still exist stay on the list (they
        keep the file excluded from orphan adoption — clearing them
        early would resurrect compacted-away lines)."""
        try:
            man = self._read_manifest()
        except (OSError, ValueError):
            return
        dead = list(man.get("shards", {}).get(str(int(shard)),
                                              {}).get("dead", []))
        if not dead:
            return
        for name in dead:
            try:
                os.unlink(os.path.join(self.root, name))
            except OSError:
                pass

        def mutate(man: dict) -> bool:
            ent = self._shard_entry(man, shard)
            kept = [n for n in ent["dead"]
                    if os.path.exists(os.path.join(self.root, n))]
            if kept == ent["dead"]:
                return False
            ent["dead"] = kept
            return True
        self._update_manifest(mutate)

    def compact_shard(self, shard: int,
                      live_lines_fn: Callable[..., List[str]],
                      now: Optional[float] = None) -> bool:
        """Compact one shard's SEALED segments — never the active one,
        so live appends and compaction proceed concurrently: fold the
        effective segments through ``live_lines_fn(text, now)``, publish
        the keep-set as a ``cmp-`` segment (atomic), swap the manifest,
        then retire the inputs.  Loses a race with another compactor
        gracefully (the manifest swap validates its inputs are still
        listed).  Returns True when the shard was rewritten."""
        from iterative_cleaner_torch.io.atomic import atomic_output

        if now is None:
            now = time.time()
        self._gc_dead(shard)
        try:
            man = self._read_manifest()
        except (OSError, ValueError):
            return False
        inputs = self._effective(shard, man, self._names_on_disk())
        if not inputs:
            return False
        if len(inputs) == 1 and segment_parts(inputs[0])[0] == "cmp":
            return False  # already fully compacted
        try:
            text = "".join(self._read_file(os.path.join(self.root, n))
                           for n in inputs)
        except FileNotFoundError:
            return False  # raced another compactor: theirs won
        lines = live_lines_fn(text, now)
        name = compacted_name(shard, max(segment_parts(n)[2]
                                         for n in inputs))
        with atomic_output(os.path.join(self.root, name)) as tmp:
            with open(tmp, "w") as f:
                f.write("".join(ln + "\n" for ln in lines))

        inset = set(inputs)

        def mutate(man: dict) -> bool:
            ent = self._shard_entry(man, shard)
            listed = set(ent["segments"])
            dead = set(ent["dead"])
            if inset & dead:
                return False  # raced: some input is already retired
            for n in inputs:
                # a seg input missing from the list is a still-unadopted
                # orphan (fine: the cmp covers it, it goes to dead); a
                # cmp input missing from the list was replaced by a
                # racing compactor — committing would double-count it
                if segment_parts(n)[0] == "cmp" and n not in listed:
                    return False
            ent["segments"] = sorted(
                {name} | (listed - inset),
                key=lambda n: (segment_parts(n)[2], n))
            ent["dead"] = sorted((dead | inset) - {name})
            return True
        if not self._update_manifest(mutate):
            # leave the cmp file: either the winning compactor published
            # the same name (same inputs fold to the same bytes) or it
            # is an ignored orphan — unlinking could delete the winner's
            return False
        self._gc_dead(shard)
        return True

    def compact(self, live_lines_fn: Callable[..., List[str]],
                now: Optional[float] = None) -> bool:
        """Compact every shard (see :meth:`compact_shard`).  Seals
        nothing: lines still in active segments are by definition
        recent, and the single-writer CLI path seals on size alone."""
        changed = False
        for shard in range(self.n_shards):
            changed = self.compact_shard(shard, live_lines_fn,
                                         now=now) or changed
        return changed
