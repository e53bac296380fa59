"""The append-only logs of a CLI session: the reference-format
``clean.log`` line per archive, the locked append that the event log
and the fleet journal share, the journal's locked compaction and seal,
and the serve daemon's size bounds on its logs (:func:`trim_log`,
:func:`rotate_log`)."""

from __future__ import annotations

import datetime
import fcntl
import os


def locked_append(path: str, text: str) -> None:
    """Append ``text`` to ``path`` under an exclusive advisory lock
    (``flock``), so processes appending to one log never interleave
    within a line; the seek after locking lands past what another
    appender wrote meanwhile.  After taking the lock the path is
    re-stat'ed: if :func:`compact_under_lock` or :func:`seal_log`
    replaced the file while this appender waited, it reopens the new
    file instead of appending to the orphaned inode (a lost line)."""
    while True:
        with open(path, "a") as f:
            fcntl.flock(f.fileno(), fcntl.LOCK_EX)
            try:
                try:
                    if os.stat(path).st_ino != os.fstat(f.fileno()).st_ino:
                        continue  # replaced while we waited: reopen
                except OSError:
                    continue      # unlinked mid-compact: reopen
                f.seek(0, os.SEEK_END)
                f.write(text)
                f.flush()
                return
            finally:
                fcntl.flock(f.fileno(), fcntl.LOCK_UN)


def compact_under_lock(path: str, rewrite) -> bool:
    """Atomically rewrite ``path`` as ``rewrite(old_text) -> new_text``
    while excluding concurrent :func:`locked_append` writers: the flock
    is taken on the current inode and the replacement is an atomic
    temp-file + ``os.replace`` while it is held, so compacting a journal
    under live traffic loses no lines.  False (no rewrite) when the file
    does not exist or a racing compactor replaced it first."""
    from iterative_cleaner_torch.io.atomic import atomic_output

    if not os.path.exists(path):
        return False
    with open(path, "r+") as f:
        fcntl.flock(f.fileno(), fcntl.LOCK_EX)
        try:
            try:
                if os.stat(path).st_ino != os.fstat(f.fileno()).st_ino:
                    return False  # raced another compactor: theirs won
            except OSError:
                return False
            f.seek(0)
            new_text = rewrite(f.read())
            with atomic_output(path) as tmp:
                with open(tmp, "w") as out:
                    out.write(new_text)
            return True
        finally:
            fcntl.flock(f.fileno(), fcntl.LOCK_UN)


def seal_log(path: str, sealed_path: str) -> bool:
    """Atomically retire the append-log file at ``path`` to
    ``sealed_path`` while excluding concurrent :func:`locked_append`
    writers (the segmented journal's seal step): every append lands in
    the sealed file or in the fresh active file an appender re-creates.
    ``sealed_path`` must not exist (sealed segments are immutable).
    False (no rename) when ``path`` does not exist or ``sealed_path``
    already does."""
    while True:
        if os.path.exists(sealed_path):
            return False
        try:
            f = open(path, "rb")
        except OSError:
            return False
        try:
            fcntl.flock(f.fileno(), fcntl.LOCK_EX)
            try:
                if os.stat(path).st_ino != os.fstat(f.fileno()).st_ino:
                    continue  # swapped while we waited: retry on the new one
            except OSError:
                return False  # unlinked/sealed by a racing sealer
            if os.path.exists(sealed_path):
                return False  # racing sealer won while we waited
            os.replace(path, sealed_path)
            return True
        finally:
            try:
                fcntl.flock(f.fileno(), fcntl.LOCK_UN)
            except OSError:
                pass
            f.close()


def trim_log(path: str, max_bytes: int, keep_lines: int = 10000) -> bool:
    """Bound an append-only log of a long-lived process: once ``path``
    exceeds ``max_bytes``, rewrite it as its last ``keep_lines`` lines
    under :func:`compact_under_lock` (concurrent appenders lose nothing).
    False below the threshold or when the file is absent."""
    try:
        if os.path.getsize(path) <= max_bytes:
            return False
    except OSError:
        return False

    def rewrite(text: str) -> str:
        return "".join(text.splitlines(keepends=True)[-keep_lines:])

    return compact_under_lock(path, rewrite)


def rotate_log(path: str, max_bytes: int) -> bool:
    """Keep-one rotation for a log whose old lines still matter (the
    event log carries the spans): once ``path`` exceeds ``max_bytes`` its
    whole text moves to ``path.1`` (replacing the previous generation)
    and the live file restarts empty, under :func:`compact_under_lock`."""
    try:
        if os.path.getsize(path) <= max_bytes:
            return False
    except OSError:
        return False
    from iterative_cleaner_torch.io.atomic import atomic_output

    def rewrite(text: str) -> str:
        with atomic_output(path + ".1") as tmp:
            with open(tmp, "w") as f:
                f.write(text)
        return ""

    return compact_under_lock(path, rewrite)


def append_clean_log(ar_name: str, args_namespace, loops: int,
                     log_path: str = "clean.log", timestamp=None) -> None:
    """The reference's ``clean.log`` line: timestamp, archive name, the
    argument namespace and the loop count.  ``timestamp`` (a
    ``datetime.datetime``, default now) pins the line for tests."""
    if timestamp is None:
        timestamp = datetime.datetime.now()
    locked_append(log_path, "\n %s: Cleaned %s with %s, required loops=%s"
                  % (timestamp, ar_name, args_namespace, loops))
