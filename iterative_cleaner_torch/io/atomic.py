"""Atomic output writes: temp file + ``os.replace``, so an interrupted
run never leaves a truncated archive under the final name."""

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
