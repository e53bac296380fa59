"""Cleaning-quality observables of a finished clean, from its masks
alone: zap occupancy per channel and per subint, and the per-iteration
mask churn.

:func:`observe_mask` folds a final (nsub, nchan) mask into the
``quality_chan_occupancy`` / ``quality_subint_occupancy`` histograms
over :data:`FRACTION_BUCKETS` and returns its summary (the run report's
per-archive ``quality`` entry); :func:`observe_result` adds the churn
series of the engine's iteration history as ``quality_iter_churn``.
Both read host numpy copies the session already holds, so they never
touch a mask.  The live per-stream monitor and its drift alerts wait
with the online session (ROADMAP.md item 5).
"""

from __future__ import annotations

import numpy as np

from iterative_cleaner_torch.telemetry.registry import COUNTS

# Occupancy is a fraction in [0, 1]; the bounds resolve the healthy
# tail (a few per cent) and the saturated end.
FRACTION_BUCKETS = (0.01, 0.02, 0.05, 0.1, 0.2, 0.35, 0.5, 0.75, 1.0)


def observe_mask(weights, registry) -> dict:
    """Fold one finished (nsub, nchan) mask into the occupancy
    histograms and return its summary: the zapped fraction and the worst
    channel and subint."""
    zapped = np.asarray(weights) == 0
    nsub, nchan = zapped.shape
    chan_occ = zapped.mean(axis=0)      # (nchan,) fraction of subints
    sub_occ = zapped.mean(axis=1)       # (nsub,) fraction of channels
    if registry is not None:
        for f in chan_occ:
            registry.histogram_observe(
                "quality_chan_occupancy", float(f),
                buckets=FRACTION_BUCKETS)
        for f in sub_occ:
            registry.histogram_observe(
                "quality_subint_occupancy", float(f),
                buckets=FRACTION_BUCKETS)
        registry.gauge_set("quality_zap_frac_final", float(zapped.mean()))
    return {
        "zap_frac": float(zapped.mean()),
        "nsub": int(nsub),
        "nchan": int(nchan),
        "worst_channel": int(np.argmax(chan_occ)),
        "worst_channel_frac": float(chan_occ.max()),
        "worst_subint": int(np.argmax(sub_occ)),
        "worst_subint_frac": float(sub_occ.max()),
    }


def observe_result(result, registry) -> dict:
    """:func:`observe_mask` on a :class:`CleanResult`'s final mask, plus
    its per-iteration churn (``engine.loop.iter_quality_series``) as
    ``quality_iter_churn`` observations.  Returns the mask summary."""
    from iterative_cleaner_torch.engine.loop import iter_quality_series

    summary = observe_mask(result.final_weights, registry)
    im = getattr(result, "iter_metrics", None)
    if im is None or registry is None:
        return summary
    w = np.asarray(result.final_weights)
    series = iter_quality_series(im, int(w.size))
    for churn in series.get("mask_churn", ()):
        registry.histogram_observe("quality_iter_churn", float(churn),
                                   buckets=COUNTS)
    return summary
