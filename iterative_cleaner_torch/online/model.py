"""``online_ewt``: the EW-template online cleaner as a registry model.

Streams an archive's subints through an :class:`.OnlineSession` as a live
pipeline would, and returns the *provisional* exponentially weighted
template mask: the answer the online mode gives between reconciles.
Beside ``quicklook`` it is a cheap single-pass alternative to the
flagship ``surgical_scrub``, whose statistics are the per-subint step's
(EW template fit, cell-local diagnostics): "what would the live mode have
said, subint by subint, with no look-ahead?".

No reconcile runs here: with the whole archive on disk, a reconcile is
``surgical_scrub``.  The ``bad_chan``/``bad_subint`` sweep applies as
usual.
"""

from __future__ import annotations

import numpy as np

from iterative_cleaner_torch.backends.base import CleanResult, apply_bad_parts
from iterative_cleaner_torch.config import CleanConfig
from iterative_cleaner_torch.online.chunks import StreamMeta
from iterative_cleaner_torch.online.session import OnlineSession


def clean_archive_online_ewt(archive, config: CleanConfig) -> CleanResult:
    """The provisional mask of ``archive`` streamed subint by subint on
    ``config.device``; the signature of
    :func:`iterative_cleaner_torch.backends.clean_archive`."""
    meta = StreamMeta.from_archive(archive)
    session = OnlineSession(meta, config, reconcile_every=0)
    cube = np.asarray(archive.total_intensity(), dtype=np.float64)
    weights = np.asarray(archive.weights, dtype=np.float64)
    for i in range(archive.nsub):
        session.ingest(cube[i], weights[i])
    zap_frac = float(np.mean(session.provisional_weights == 0)) \
        if archive.nsub else 0.0
    result = CleanResult(
        final_weights=session.provisional_weights,
        scores=session.provisional_scores,
        loops=1, converged=True,
        loop_diffs=np.array([float(np.sum(
            (session.provisional_weights == 0) != (weights == 0)))]),
        loop_rfi_frac=np.array([zap_frac]),
    )
    return apply_bad_parts(result, config)
