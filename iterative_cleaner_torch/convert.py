"""Carry an archive and a configuration over from the reference package.

The system has no weights: the archive and its configuration are what
crosses over.  Both functions read attributes by duck typing and import
nothing from the reference package, so the port stays free of it (and of
``jax``).
"""

from __future__ import annotations

import numpy as np

from iterative_cleaner_torch.archive import Archive
from iterative_cleaner_torch.config import CleanConfig


def archive_from_reference(obj) -> Archive:
    """The port's :class:`Archive` holding the same arrays and metadata
    as a reference-package ``Archive`` (or anything with its fields)."""
    return Archive(
        data=np.asarray(obj.data),
        weights=np.asarray(obj.weights),
        freqs_mhz=np.asarray(obj.freqs_mhz),
        period_s=float(obj.period_s),
        dm=float(obj.dm),
        centre_freq_mhz=float(obj.centre_freq_mhz),
        source=str(obj.source),
        mjd_start=float(obj.mjd_start),
        mjd_end=float(obj.mjd_end),
        filename=str(obj.filename),
        pol_state=str(obj.pol_state),
        dedispersed=bool(obj.dedispersed),
        psrfits_nbits=int(getattr(obj, "psrfits_nbits", 16)),
    )


def config_from_reference(cfg, device: str = "cuda") -> CleanConfig:
    """The port's :class:`CleanConfig` with a reference configuration's
    algorithm fields.  Its TPU route knobs have no counterpart (the
    device decides the kernels); a setting outside the port's slice
    raises ``NotImplementedError`` from the config."""
    return CleanConfig(
        chanthresh=float(cfg.chanthresh),
        subintthresh=float(cfg.subintthresh),
        max_iter=int(cfg.max_iter),
        pulse_region=tuple(float(v) for v in cfg.pulse_region),
        bad_chan=float(cfg.bad_chan),
        bad_subint=float(cfg.bad_subint),
        rotation=str(cfg.rotation),
        stats_frame=str(cfg.stats_frame),
        baseline_duty=float(cfg.baseline_duty),
        baseline_mode=str(cfg.baseline_mode),
        dtype=str(cfg.dtype),
        record_history=bool(cfg.record_history),
        unload_res=bool(cfg.unload_res),
        device=device,
        stream_hbm_mb=getattr(cfg, "stream_hbm_mb", None),
    )
