"""The append-only logs of a CLI session: the reference-format
``clean.log`` line per archive, and the locked append that the event
log shares."""

from __future__ import annotations

import datetime
import fcntl
import os


def locked_append(path: str, text: str) -> None:
    """Append ``text`` to ``path`` under an exclusive advisory lock
    (``flock``), so processes appending to one log never interleave
    within a line; the seek after locking lands past what another
    appender wrote meanwhile."""
    with open(path, "a") as f:
        fcntl.flock(f.fileno(), fcntl.LOCK_EX)
        try:
            f.seek(0, os.SEEK_END)
            f.write(text)
            f.flush()
        finally:
            fcntl.flock(f.fileno(), fcntl.LOCK_UN)


def append_clean_log(ar_name: str, args_namespace, loops: int,
                     log_path: str = "clean.log", timestamp=None) -> None:
    """The reference's ``clean.log`` line: timestamp, archive name, the
    argument namespace and the loop count.  ``timestamp`` (a
    ``datetime.datetime``, default now) pins the line for tests."""
    if timestamp is None:
        timestamp = datetime.datetime.now()
    locked_append(log_path, "\n %s: Cleaned %s with %s, required loops=%s"
                  % (timestamp, ar_name, args_namespace, loops))
