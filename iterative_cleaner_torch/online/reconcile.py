"""Periodic full-archive reconciliation of an online session.

The per-subint EW step is a bounded-latency *provisional* zap; the ground
truth is the batch cleaner.  Every ``stream_reconcile_every`` subints the
session re-cleans its accumulated live rows ``[:n]`` through the batch
pipeline (``get_backend(config.backend).clean_cube``: the torch engine on
the card, or the numpy oracle), then runs the bad-parts sweep on the
result and repairs the provisional mask's drift.

The reference reconciles its capacity cube instead, the ring's spare rows
zero-weighted, so that its compiled shapes walk the capacity grid; its
padded reconcile is bit-equal to the unpadded one after cropping.  The
port compiles nothing per shape, and padding is not exact on the card
(the template's sums run in another order at a padded width), so it pads
nothing: the masks are those of the reference's crop.

Compile accounting: the port's only builds are the kernel library's
``nvcc`` runs (``stats.kernels.library_builds``).  Builds during the
session's first reconcile count as warm-up, later ones as steady (which
must stay 0: the library is built once per process).
"""

from __future__ import annotations

import numpy as np

from iterative_cleaner_torch.backends import apply_bad_parts, get_backend
from iterative_cleaner_torch.stats.kernels import library_builds


def reconcile_session(session) -> int:
    """Re-clean the session's live rows, repair provisional-mask drift,
    and return the number of repaired cells."""
    cfg = session.config
    meta = session.meta
    n = session.n_subints
    if n == 0:
        return 0
    before = library_builds()
    result = get_backend(cfg.backend).clean_cube(
        session.cube_rows(), session._weights[:n],
        np.asarray(meta.freqs_mhz, np.float64), meta.dm,
        meta.centre_freq_mhz, meta.period_s, cfg,
        dedispersed=meta.dedispersed, registry=session.registry)
    session._record_compiles(library_builds() - before,
                             warmup=session.reconciles == 0)
    apply_bad_parts(result, cfg)
    new_w = np.asarray(result.final_weights, np.float64)
    drift = int(np.sum((new_w == 0) != (session._pweights[:n] == 0)))
    session._pweights[:n] = new_w
    session._pscores[:n] = np.asarray(result.scores, np.float64)
    session.mask_drift += drift
    return drift
