"""Atomic output writes: temp file (or directory) + ``os.replace``, so
an interrupted run never leaves a truncated archive, or a half-written
profile capture, under the final name."""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Iterator


@contextlib.contextmanager
def atomic_output(path: str) -> Iterator[str]:
    """Yield a temp path next to ``path``; on clean exit rename it over
    ``path`` atomically; on error remove it and re-raise.  The temp name
    embeds pid and thread ident so racing writers never share an inode."""
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        yield tmp
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


@contextlib.contextmanager
def atomic_output_dir(path: str) -> Iterator[str]:
    """Directory flavour of :func:`atomic_output`: yield a private temp
    directory next to ``path``; on clean exit rename it to ``path`` in one
    ``os.replace``; on error remove the whole tree.  For outputs published
    as a unit (a profile capture: its trace and its manifest), so a
    watcher of the parent directory sees the finished tree or nothing.
    ``path`` must not exist yet (writers mint fresh names)."""
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    os.makedirs(tmp)
    try:
        yield tmp
        os.replace(tmp, path)
    finally:
        if os.path.isdir(tmp):
            import shutil

            shutil.rmtree(tmp, ignore_errors=True)
