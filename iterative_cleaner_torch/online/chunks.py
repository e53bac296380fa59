"""Per-subint stream chunks and the assembled-archive round trip.

A live stream arrives as small files, one (or a few) subints each, in
one of two shapes:

* an archive container the io layer loads (``.npz``, PSRFITS, ``.ar``):
  the chunk carries its own frequency table, period, DM;
* a bare ``.npy`` tile of shape ``(nchan, nbin)`` or ``(k, nchan,
  nbin)``: the cheapest for an upstream beamformer to write, its
  metadata from a :class:`StreamMeta` header kept as a ``stream.json``
  file beside the chunks (``--stream DIR`` and ``--mux DIR...``).

The directory protocol: chunks are ingested in sorted-name order
(``000000.npy``, ``000001.npy``, ...), and an empty ``stream.close``
sentinel file ends the stream.  The protocol and the header are the
reference package's, so either package tails the other's directories.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Tuple

import numpy as np

from iterative_cleaner_torch.archive import Archive

STREAM_META_NAME = "stream.json"
CLOSE_SENTINEL = "stream.close"

_CHUNK_EXTS = (".npy", ".npz", ".ar", ".fits", ".sf", ".rf", ".cf")


@dataclasses.dataclass(frozen=True)
class StreamMeta:
    """The observation-level facts a bare per-subint tile cannot carry."""

    nchan: int
    nbin: int
    freqs_mhz: Tuple[float, ...]
    period_s: float
    dm: float
    centre_freq_mhz: float
    dedispersed: bool = False
    source: str = "stream"

    def __post_init__(self) -> None:
        if len(self.freqs_mhz) != self.nchan:
            raise ValueError(
                f"stream meta: {len(self.freqs_mhz)} frequencies for "
                f"nchan={self.nchan}")
        if self.nbin < 1 or self.nchan < 1:
            raise ValueError(
                f"stream meta: nchan/nbin must be >= 1, got "
                f"({self.nchan}, {self.nbin})")

    @classmethod
    def from_archive(cls, ar: Archive) -> "StreamMeta":
        return cls(nchan=ar.nchan, nbin=ar.nbin,
                   freqs_mhz=tuple(float(f) for f in ar.freqs_mhz),
                   period_s=float(ar.period_s), dm=float(ar.dm),
                   centre_freq_mhz=float(ar.centre_freq_mhz),
                   dedispersed=bool(ar.dedispersed),
                   source=ar.source or "stream")

    @classmethod
    def from_dict(cls, doc: dict) -> "StreamMeta":
        try:
            return cls(nchan=int(doc["nchan"]), nbin=int(doc["nbin"]),
                       freqs_mhz=tuple(float(f) for f in doc["freqs_mhz"]),
                       period_s=float(doc["period_s"]),
                       dm=float(doc["dm"]),
                       centre_freq_mhz=float(doc["centre_freq_mhz"]),
                       dedispersed=bool(doc.get("dedispersed", False)),
                       source=str(doc.get("source", "stream")))
        except (KeyError, TypeError, ValueError) as exc:
            raise ValueError(f"bad stream meta: {exc}") from None

    def to_dict(self) -> dict:
        return {"nchan": self.nchan, "nbin": self.nbin,
                "freqs_mhz": list(self.freqs_mhz),
                "period_s": self.period_s, "dm": self.dm,
                "centre_freq_mhz": self.centre_freq_mhz,
                "dedispersed": self.dedispersed, "source": self.source}


def save_stream_meta(directory: str, meta: StreamMeta) -> str:
    """Write the directory protocol's metadata header, atomically (a
    tailer never reads a torn header).  Returns its path."""
    from iterative_cleaner_torch.io.atomic import atomic_output

    path = os.path.join(directory, STREAM_META_NAME)
    with atomic_output(path) as tmp:
        with open(tmp, "w") as fh:
            json.dump(meta.to_dict(), fh)
    return path


def load_stream_meta(directory: str) -> Optional[StreamMeta]:
    """The header of ``directory``, None where it has none yet; an
    unreadable header raises ``ValueError``."""
    path = os.path.join(directory, STREAM_META_NAME)
    try:
        with open(path) as fh:
            return StreamMeta.from_dict(json.load(fh))
    except FileNotFoundError:
        return None
    except (OSError, ValueError) as exc:
        raise ValueError(f"unreadable {path}: {exc}") from None


def is_chunk_name(name: str) -> bool:
    """The directory protocol's chunk predicate: data files only, not the
    metadata header, the close sentinel, dotfiles (writes in progress)
    or the session's own ``*_cleaned`` outputs."""
    if name.startswith(".") or name in (STREAM_META_NAME, CLOSE_SENTINEL):
        return False
    stem = os.path.splitext(name)[0]
    if stem.endswith("_cleaned"):
        return False
    return name.lower().endswith(_CHUNK_EXTS)


def load_chunk(path: str, meta: Optional[StreamMeta] = None):
    """One chunk file -> ``(data, weights, meta)``: ``data`` is ``(k,
    nchan, nbin)`` float64 total intensity and ``weights`` ``(k,
    nchan)``, ``k`` usually 1.  A bare ``.npy`` tile needs ``meta`` and
    gets unit weights; an archive container carries its own metadata,
    its geometry held to ``meta``'s where both exist."""
    if path.lower().endswith(".npy"):
        if meta is None:
            raise ValueError(
                f"bare .npy chunk {path!r} needs stream metadata "
                f"({STREAM_META_NAME} or the stream request's 'meta')")
        data = np.load(path)
        if data.ndim == 2:
            data = data[None]
        if data.ndim != 3 or data.shape[1:] != (meta.nchan, meta.nbin):
            raise ValueError(
                f"chunk {path!r} has shape {data.shape}, stream is "
                f"(*, {meta.nchan}, {meta.nbin})")
        weights = np.ones(data.shape[:2], dtype=np.float64)
        return np.asarray(data, dtype=np.float64), weights, meta

    from iterative_cleaner_torch.io import load_archive

    ar = load_archive(path)
    chunk_meta = StreamMeta.from_archive(ar)
    if meta is not None and (chunk_meta.nchan, chunk_meta.nbin) != \
            (meta.nchan, meta.nbin):
        raise ValueError(
            f"chunk {path!r} geometry ({chunk_meta.nchan}, "
            f"{chunk_meta.nbin}) does not match the stream's "
            f"({meta.nchan}, {meta.nbin})")
    return (np.asarray(ar.total_intensity(), dtype=np.float64),
            np.asarray(ar.weights, dtype=np.float64),
            meta if meta is not None else chunk_meta)


def assemble_archive(meta: StreamMeta, data: np.ndarray,
                     weights: np.ndarray) -> Archive:
    """The accumulated stream as a regular :class:`Archive`: the object
    the batch cleaner, and the close's bit-equality, run on."""
    data = np.asarray(data)
    return Archive(
        data=np.ascontiguousarray(data[:, None, :, :]),
        weights=np.ascontiguousarray(np.asarray(weights)),
        freqs_mhz=np.asarray(meta.freqs_mhz, dtype=np.float64),
        period_s=meta.period_s, dm=meta.dm,
        centre_freq_mhz=meta.centre_freq_mhz,
        source=meta.source, pol_state="Intensity",
        dedispersed=meta.dedispersed,
    )
