"""Checkpoint, resume and the regression diff of cleaning runs.

Each archive's cleaning state (final weights, scores, the per-iteration
weight history with ``record_history``, the loop telemetry) is saved as
one ``.npz`` keyed by a content fingerprint of the input archive and the
identity of the cleaning config.  A batch run given ``--checkpoint DIR``
reuses the checkpoints whose input and config still match instead of
cleaning again, and two checkpoints (or a checkpoint and a cleaned
archive) diff cell by cell for regression tracking.

The file format (version 1), its keys and :func:`fingerprint_archive`'s
hex are the reference package's (``iterative_cleaner_tpu/utils/
checkpoint.py``), so each package's ``load_clean_checkpoint`` and ``tools
diff`` read the other's checkpoints.  The config identity is the port's
own: its :class:`~iterative_cleaner_torch.config.CleanConfig` has other
fields, so a reference checkpoint never matches a port config and is
cleaned again, never resumed.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import zipfile
from typing import Optional, Tuple

import numpy as np

from iterative_cleaner_torch.archive import Archive
from iterative_cleaner_torch.backends.base import CleanResult
from iterative_cleaner_torch.config import CleanConfig
from iterative_cleaner_torch.io.atomic import atomic_output

FORMAT_VERSION = 1

# Config fields outside a run's identity: the output-only flags (a
# checkpoint holding more than a run asks for still matches it) and
# compute_dtype (bf16 storage only moves where the float32 upcast
# happens: masks are bit-equal on bf16-exact inputs, and a stage whose
# parity probe disagrees stays float32, as in the reference).
_IDENTITY_EXCLUDE = frozenset({"unload_res", "record_history",
                               "compute_dtype",
                               # the fleet's knobs never change a mask:
                               # the port pads nothing, so the bucket
                               # grid and the group size only schedule;
                               # the retry budget, watchdog and host
                               # placement neither (a stolen bucket's
                               # done lines must satisfy the original
                               # host's resume); the build directory
                               # is only where the library lives
                               "fleet_bucket_pad", "fleet_group_size",
                               "fleet_retries", "stage_timeout_s",
                               "fleet_hosts", "fleet_host_id",
                               "fleet_claim_ttl_s", "compile_cache_dir",
                               # a live stream's quality monitor reads
                               # host copies of its masks only
                               "quality_window", "quality_drift"})
# Every other field is in config_identity/config_hash.  ``device`` is
# there on purpose: the card's kernels and the CPU's plain versions are
# not promised bit-equal, and implementation knobs stay in the hash for
# bit-parity bookkeeping, as the reference keeps its kernel routes there.
_IDENTITY_FIELDS = frozenset({
    "chanthresh", "subintthresh", "max_iter", "pulse_region", "bad_chan",
    "bad_subint", "backend", "rotation", "stats_frame", "baseline_duty",
    "baseline_mode", "dtype", "stream_hbm_mb", "device",
    "stream_reconcile_every", "stream_ew_alpha",
})

# a new CleanConfig field fails here until it is classified
assert _IDENTITY_FIELDS.isdisjoint(_IDENTITY_EXCLUDE), \
    "a CleanConfig field is classified both identity and excluded"
assert _IDENTITY_FIELDS | _IDENTITY_EXCLUDE == \
    {f.name for f in dataclasses.fields(CleanConfig)}, \
    "CleanConfig fields and the identity partition drifted apart"

# Subints of the cube hashed at a time by fingerprint_archive: bounds the
# float32 copy a float64 cube needs to a piece of this many bytes.
_FINGERPRINT_CHUNK_BYTES = 64 * 2 ** 20


def config_identity(config: CleanConfig) -> str:
    """The config fields that decide a run's mask, as sorted JSON."""
    d = dataclasses.asdict(config)
    for k in _IDENTITY_EXCLUDE:
        d.pop(k, None)
    return json.dumps(d, sort_keys=True)


def config_hash(config: CleanConfig) -> str:
    """An 8-byte hex digest of :func:`config_identity`."""
    return hashlib.blake2b(config_identity(config).encode(),
                           digest_size=8).hexdigest()


def file_signature(path: str) -> str:
    """The resume fast path's staleness signature of a file: its size,
    mtime in ns and a blake2b of its first 64 KiB (the header of every
    container).  An unchanged file matches the signature stored with
    its checkpoint and skips :func:`fingerprint_archive`'s hash of the
    whole cube; a touched but identical file falls back to that hash.
    Empty when the file cannot be read (the fingerprint then decides)."""
    try:
        st = os.stat(path)
        with open(path, "rb") as f:
            head = f.read(65536)
    except OSError:
        return ""
    h = hashlib.blake2b(head, digest_size=16)
    return "%d:%d:%s" % (st.st_size, st.st_mtime_ns, h.hexdigest())


def fingerprint_archive(ar: Archive) -> str:
    """Content fingerprint: the dims, the metadata, the weights, the
    frequencies and the whole cube as float32 (the reference's hex).  The
    cube is hashed a piece of subints at a time, so a float64 cube's
    float32 copy never exists whole."""
    h = hashlib.blake2b(digest_size=16)
    h.update(np.asarray(ar.data.shape, np.int64).tobytes())
    meta = (ar.period_s, ar.dm, ar.centre_freq_mhz, ar.mjd_start, ar.mjd_end)
    h.update(np.asarray(meta, np.float64).tobytes())
    h.update(ar.source.encode())
    h.update(np.ascontiguousarray(ar.weights, np.float64).tobytes())
    h.update(np.ascontiguousarray(ar.freqs_mhz, np.float64).tobytes())
    nsub = ar.data.shape[0]
    per_subint = max(1, ar.data[:1].size * 4)
    step = max(1, _FINGERPRINT_CHUNK_BYTES // per_subint)
    for s in range(0, nsub, step):
        h.update(np.ascontiguousarray(ar.data[s:s + step], np.float32))
    return h.hexdigest()


def checkpoint_path(directory: str, in_path: str) -> str:
    """The checkpoint file of ``in_path`` in ``directory``: its basename
    and a hash of its absolute path, so same-named archives of different
    directories never share one."""
    tag = hashlib.blake2b(os.path.abspath(in_path).encode(),
                          digest_size=4).hexdigest()
    return os.path.join(directory,
                        "%s.%s.ckpt.npz" % (os.path.basename(in_path), tag))


def save_clean_checkpoint(path: str, result: CleanResult,
                          config: CleanConfig, fingerprint: str,
                          file_sig: str = "") -> None:
    """Write ``result`` as a version-1 checkpoint, atomically (a per-writer
    temp file renamed over ``path``: racing writers of one directory, in
    processes or threads, never leave a torn file)."""
    arrays = dict(
        final_weights=result.final_weights,
        scores=result.scores,
        loops=np.int64(result.loops),
        converged=np.bool_(result.converged),
        n_bad_subints=np.int64(result.n_bad_subints),
        n_bad_channels=np.int64(result.n_bad_channels),
        fingerprint=np.str_(fingerprint),
        file_sig=np.str_(file_sig),
        config=np.str_(config_identity(config)),
        version=np.int64(FORMAT_VERSION),
    )
    if result.loop_diffs is not None:
        arrays["loop_diffs"] = np.asarray(result.loop_diffs)
        arrays["loop_rfi_frac"] = np.asarray(result.loop_rfi_frac)
    if result.weight_history is not None:
        arrays["weight_history"] = result.weight_history
    if result.iter_metrics is not None:
        arrays["iter_metrics"] = np.asarray(result.iter_metrics)
    with atomic_output(path) as tmp:
        with open(tmp, "wb") as f:
            np.savez_compressed(f, **arrays)


def load_clean_checkpoint(path: str) -> Tuple[CleanResult, str, str]:
    """``(result, fingerprint, config_identity_json)`` of a checkpoint;
    ``ValueError`` for another format version."""
    with np.load(path, allow_pickle=False) as z:
        if int(z["version"]) != FORMAT_VERSION:
            raise ValueError(
                f"checkpoint {path} has format v{int(z['version'])}, "
                f"expected v{FORMAT_VERSION}")

        def opt(key):
            return z[key] if key in z else None

        result = CleanResult(
            final_weights=z["final_weights"],
            scores=z["scores"],
            loops=int(z["loops"]),
            converged=bool(z["converged"]),
            n_bad_subints=int(z["n_bad_subints"]),
            n_bad_channels=int(z["n_bad_channels"]),
            loop_diffs=opt("loop_diffs"),
            loop_rfi_frac=opt("loop_rfi_frac"),
            weight_history=opt("weight_history"),
            iter_metrics=opt("iter_metrics"),
        )
        return result, str(z["fingerprint"]), str(z["config"])


def load_matching_checkpoint(directory: str, in_path: str, ar: Archive,
                             config: CleanConfig) -> Optional[CleanResult]:
    """The resume primitive: the saved result of ``in_path``, or None when
    there is none or it is stale (the input's content or the config's
    identity changed, or the run asks for an output it lacks)."""
    path = checkpoint_path(directory, in_path)
    if not os.path.exists(path):
        return None
    try:
        result, fp, cfg = load_clean_checkpoint(path)
        with np.load(path, allow_pickle=False) as z:
            stored_sig = str(z["file_sig"]) if "file_sig" in z else ""
    except (ValueError, KeyError, OSError, zipfile.BadZipFile):
        # a file caught mid-replace by a racing writer is stale, not fatal
        return None
    if cfg != config_identity(config):
        return None
    if not (stored_sig and stored_sig == file_signature(in_path)):
        if fp != fingerprint_archive(ar):
            return None
    # residual cubes are never checkpointed, histories only with
    # record_history: a run asking for them cleans again
    if config.unload_res and result.residual is None:
        return None
    if config.record_history and result.weight_history is None:
        return None
    return result


def diff_masks(a: np.ndarray, b: np.ndarray) -> dict:
    """Regression diff of two (nsub, nchan) weight matrices."""
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch: {a.shape} vs {b.shape}")
    za, zb = a == 0, b == 0
    return {
        "cells": int(a.size),
        "changed": int(np.sum(za != zb)),
        "newly_zapped": int(np.sum(~za & zb)),
        "unzapped": int(np.sum(za & ~zb)),
        "rfi_frac_a": float(za.mean()),
        "rfi_frac_b": float(zb.mean()),
    }


def diff_checkpoints(path_a: str, path_b: str) -> dict:
    """:func:`diff_masks` of two checkpoints' final weights, whether their
    inputs were the same, their loops, and the cells changed per
    iteration where both recorded the weight history."""
    ra, fpa, _ = load_clean_checkpoint(path_a)
    rb, fpb, _ = load_clean_checkpoint(path_b)
    out = diff_masks(ra.final_weights, rb.final_weights)
    out["same_input"] = fpa == fpb
    out["loops"] = (ra.loops, rb.loops)
    if ra.weight_history is not None and rb.weight_history is not None:
        out["per_iteration_changed"] = [
            diff_masks(wa, wb)["changed"]
            for wa, wb in zip(ra.weight_history, rb.weight_history)]
    return out
