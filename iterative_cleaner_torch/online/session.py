"""Ring-buffered online cleaning session: one live stream, cleaned
subint by subint as it arrives.

* **The step.**  Every subint runs :mod:`.step` on the device: the
  cell-local preamble, the EW template update (:mod:`.ewt`), K6, K3 along
  each axis and the combine.  The float64 tile is uploaded and converted
  once; the EW template and its count stay on the device (an all-zapped
  subint's ``updated`` flag advances the count there, as a
  ``torch.where``), and the one download, of the subint's provisional
  weights and scores (with the template when a quality monitor reads
  it), is the step's only synchronisation.

* **The host ring.**  Raw tiles accumulate as float64 host blocks of
  :data:`DEFAULT_NSUB_STEP` subints (or ``fleet_bucket_pad[0]`` where
  set): growing the ring allocates one block and copies no tile, so a
  long stream's latency has no growth spikes; the (nsub, nchan) weights
  and provisional planes grow by copy, a block's step at a time.  No
  reconcile sees the spare rows.

* **Reconciliation** (:mod:`.reconcile`).  The per-subint zap is
  provisional.  Every ``stream_reconcile_every`` subints the live rows
  are re-cleaned by the batch pipeline and the provisional mask's drift
  is counted and repaired; :meth:`OnlineSession.close` cleans the
  assembled archive through ``clean_archive``, so the final mask is the
  batch clean's by construction.

* **Compiles.**  The port compiles nothing per shape: its only builds
  are the CUDA kernel library's ``nvcc`` runs
  (``stats.kernels.library_builds``, once per process, none where a
  ``--compile-cache`` directory holds the library).  ``warmup_compiles``
  counts the builds during the first subint and the first reconcile,
  ``recompiles_steady`` any later one; the steady count must stay 0.

With one subint in view the channel-axis scaling degenerates (each
channel line holds one entry: its median is the entry, its MAD 0), so a
provisional zap is driven by how a cell stands against the rest of its
own subint; the reconciles replace those decisions with the batch
cleaner's.

``tracer`` (a :class:`~iterative_cleaner_torch.telemetry.tracing.Tracer`)
records a ``subint`` span per subint, a ``reconcile`` span per reconcile
and a ``close_reconcile`` span, parented by ``trace_id`` /
``parent_span_id`` (the serve daemon's request).  ``profile`` (default:
:func:`~iterative_cleaner_torch.telemetry.profiling.profiling_enabled`)
captures the step as the profiler's ``online_step/<nchan>x<nbin>``
program: its kernels' modelled cost, its first call's device peak and
each later subint's latency as its walltime.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import time
from typing import List, Optional

import numpy as np
import torch

from iterative_cleaner_torch.backends.base import CleanResult
from iterative_cleaner_torch.config import CleanConfig
from iterative_cleaner_torch.online.chunks import StreamMeta, assemble_archive
from iterative_cleaner_torch.stats.kernels import library_builds

# Ring growth step (subints) where fleet_bucket_pad's nsub step is 0.
DEFAULT_NSUB_STEP = 16
DEFAULT_RECONCILE_EVERY = 8
DEFAULT_EW_ALPHA = 0.2


def resolve_reconcile_every(value: Optional[int]) -> int:
    """Explicit config value, else ICLEAN_STREAM_RECONCILE_EVERY, else
    :data:`DEFAULT_RECONCILE_EVERY`.  0 disables mid-stream reconciles
    (close still reconciles: the bit-equality with the batch clean is
    unconditional)."""
    if value is not None:
        return int(value)
    raw = os.environ.get("ICLEAN_STREAM_RECONCILE_EVERY", "")
    return int(raw) if raw else DEFAULT_RECONCILE_EVERY


def resolve_ew_alpha(value: Optional[float]) -> float:
    """Explicit config value, else ICLEAN_STREAM_EW_ALPHA, else
    :data:`DEFAULT_EW_ALPHA`."""
    if value is not None:
        return float(value)
    raw = os.environ.get("ICLEAN_STREAM_EW_ALPHA", "")
    return float(raw) if raw else DEFAULT_EW_ALPHA


def percentile_ms(latencies_s, q: float) -> float:
    """Exact (nearest-rank) percentile of a latency list, in ms."""
    if not latencies_s:
        return 0.0
    xs = sorted(latencies_s)
    idx = min(len(xs) - 1, max(0, math.ceil(q / 100.0 * len(xs)) - 1))
    return xs[idx] * 1000.0


@dataclasses.dataclass
class PendingSubint:
    """One staged subint between :meth:`OnlineSession.begin_subint` and
    :meth:`OnlineSession.commit_subint`.  The solo path commits at once;
    a :class:`~iterative_cleaner_torch.online.mux.StreamMux` parks these
    in its ring until its batched dispatch.  ``t0`` is the begin time, so
    the committed latency includes any ring wait (the number the mux's
    deadline bounds)."""

    tile: np.ndarray       # (nchan, nbin) float64
    w_row: np.ndarray      # (nchan,) float64
    t0: float
    span: object = None
    label: str = ""


@dataclasses.dataclass
class OnlineResult:
    """What :meth:`OnlineSession.close` returns: the cleaned assembled
    archive and the session's latency, build and drift accounting."""

    archive: object                 # Archive with the reconciled weights
    result: CleanResult             # the close's batch clean
    n_subints: int
    mask_drift: int                 # provisional cells repaired mid-stream
    final_drift: int                # provisional cells repaired at close
    warmup_compiles: int            # kernel-library builds at warm-up
    recompiles_steady: int          # later builds; must stay 0
    reconciles: int
    latencies_s: List[float]

    def p99_ms(self) -> float:
        return percentile_ms(self.latencies_s, 99.0)


_NO_PEAK = contextlib.nullcontext()


def step_costs(config: CleanConfig, nchan: int, nbin: int, lanes: int = 1):
    """The profiler's ``(operations, bytes)`` of one step on ``lanes``
    subints of ``nchan`` x ``nbin``: its kernels' (K6, K3 x 2, the
    combine) modelled cost at nsub = 1; the preamble is not counted."""
    from iterative_cleaner_torch.online.step import STEP_KERNELS
    from iterative_cleaner_torch.parallel.batch import _cube_bytes
    from iterative_cleaner_torch.telemetry.profiling import program_costs

    return program_costs(STEP_KERNELS, 1, nchan, nbin,
                         cube_bytes=_cube_bytes(config), batch=lanes)


def download_rows(new_w, scores, template=None):
    """Host float64 copies of a step's ``new_w`` and ``scores`` (and of
    ``template`` where given) in one device-to-host transfer: the step's
    one synchronisation.  Returns ``(new_w, scores, template or None)``
    shaped as given."""
    parts = [new_w, scores] + ([] if template is None else [template])
    flat = torch.cat([p.reshape(-1).to(torch.float64) for p in parts])
    host = flat.cpu().numpy()
    out, at = [], 0
    for p in parts:
        out.append(host[at:at + p.numel()].reshape(tuple(p.shape)))
        at += p.numel()
    return out[0], out[1], (out[2] if template is not None else None)


class OnlineSession:
    """Ingest subints one at a time; see the module docstring."""

    def __init__(self, meta: StreamMeta, config: CleanConfig, *,
                 reconcile_every: Optional[int] = None, registry=None,
                 tracer=None, trace_id: Optional[str] = None,
                 parent_span_id: Optional[str] = None,
                 stream_id: Optional[str] = None,
                 profile: Optional[bool] = None):
        self.meta = meta
        self.config = config
        self.alpha = resolve_ew_alpha(config.stream_ew_alpha)
        self.reconcile_every = (
            resolve_reconcile_every(config.stream_reconcile_every)
            if reconcile_every is None else int(reconcile_every))
        if self.reconcile_every < 0:
            raise ValueError("reconcile_every must be >= 0")
        self.nsub_step = int(config.fleet_bucket_pad[0]) or DEFAULT_NSUB_STEP
        self.registry = registry
        self.tracer = tracer
        self.trace_id = trace_id
        self.parent_span_id = parent_span_id
        # the quality monitor reads host copies only: it never changes a
        # mask
        self.quality = None
        if registry is not None:
            from iterative_cleaner_torch.telemetry.quality import (
                QualityMonitor,
            )

            self.quality = QualityMonitor(
                stream=stream_id or "local", window=config.quality_window,
                drift=config.quality_drift, registry=registry)
        from iterative_cleaner_torch.telemetry.profiling import (
            profiling_enabled,
        )

        self._profile = profiling_enabled(profile)
        self._program = None     # the profiler's name of the solo step
        self.closed = False
        # the host ring: raw tiles and their weights as ingested (what the
        # reconciles clean) and the provisional view
        self._n = 0
        self._cap = 0
        self._blocks = []        # (nsub_step, nchan, nbin) float64 each
        self._weights = None     # (cap, nchan) as ingested
        self._pweights = None    # (cap, nchan) provisional mask
        self._pscores = None     # (cap, nchan)
        # the device state: the EW template, its count, and the stream's
        # metadata as the step's arguments
        self.device = None
        self.dtype = None
        self._template = None
        self._count = None
        self._meta_args = None
        self._step = None
        # accounting
        self.warmup_compiles = 0
        self.recompiles_steady = 0
        self.reconciles = 0
        self.mask_drift = 0
        self.latencies_s: List[float] = []

    # ------------------------------------------------------------- views
    @property
    def n_subints(self) -> int:
        return self._n

    @property
    def capacity(self) -> int:
        return self._cap

    @property
    def provisional_weights(self) -> np.ndarray:
        return self._pweights[:self._n].copy()

    @property
    def provisional_scores(self) -> np.ndarray:
        return self._pscores[:self._n].copy()

    def raw_weights(self) -> np.ndarray:
        return self._weights[:self._n].copy()

    def template(self) -> np.ndarray:
        """A host copy of the EW template (zeros before the first
        subint)."""
        self._init_device_state()
        return self._template.cpu().numpy()

    def cube_rows(self) -> np.ndarray:
        """The ingested subints, ``(n, nchan, nbin)`` float64: one copy
        out of the ring's blocks."""
        full, rest = divmod(self._n, self.nsub_step)
        parts = self._blocks[:full] + ([self._blocks[full][:rest]]
                                       if rest else [])
        if not parts:
            return np.zeros((0, self.meta.nchan, self.meta.nbin), np.float64)
        return np.concatenate(parts, axis=0)

    def assembled(self):
        """The accumulated stream as a regular Archive (raw weights: the
        batch cleaner's input, not the provisional mask)."""
        return assemble_archive(self.meta, self.cube_rows(),
                                self._weights[:self._n])

    # ------------------------------------------------------------ ingest
    def _grow(self) -> None:
        """One more block of ``nsub_step`` subints: an allocation for the
        tiles, a copy of the (nsub, nchan) planes."""
        step, nchan = self.nsub_step, self.meta.nchan
        self._blocks.append(np.zeros((step, nchan, self.meta.nbin),
                                     np.float64))
        cap = self._cap + step
        planes = []
        for old in (self._weights, self._pweights, self._pscores):
            new = np.zeros((cap, nchan), np.float64)
            if old is not None:
                new[:self._n] = old[:self._n]
            planes.append(new)
        self._weights, self._pweights, self._pscores = planes
        self._cap = cap

    def _init_device_state(self) -> None:
        """The device, the dtype, the zero EW template, the zero count and
        the stream's metadata as device tensors: what a step caller (the
        solo ingest or a mux's dispatch) needs before the first subint.
        Launches no kernel."""
        if self._template is not None:
            return
        from iterative_cleaner_torch.backends.torch_backend import (
            clean_device,
            engine_dtype,
            upload_meta,
        )

        meta = self.meta
        self.device = clean_device(self.config)
        self.dtype = engine_dtype(self.config)
        self._template = torch.zeros((meta.nbin,), dtype=self.dtype,
                                     device=self.device)
        self._count = torch.zeros((), dtype=torch.int32, device=self.device)
        self._meta_args = upload_meta(
            np.asarray(meta.freqs_mhz, np.float64), meta.dm,
            meta.centre_freq_mhz, meta.period_s, self.device, self.dtype)

    def ingest(self, data, weights=None, *, label: str = "") -> int:
        """Feed one chunk: ``(nchan, nbin)`` or ``(k, nchan, nbin)`` total
        intensity (and optional ``(k, nchan)`` weights, all live by
        default).  Returns the stream's new subint count."""
        if self.closed:
            raise RuntimeError("stream session is closed")
        data = np.asarray(data, dtype=np.float64)
        if data.ndim == 2:
            data = data[None]
        if data.ndim != 3 or data.shape[1:] != (self.meta.nchan,
                                                self.meta.nbin):
            raise ValueError(
                f"chunk shape {data.shape} does not match stream geometry "
                f"(*, {self.meta.nchan}, {self.meta.nbin})")
        if weights is None:
            weights = np.ones(data.shape[:2], dtype=np.float64)
        weights = np.asarray(weights, dtype=np.float64)
        if weights.ndim == 1:
            weights = weights[None]
        if weights.shape != data.shape[:2]:
            raise ValueError(
                f"chunk weights shape {weights.shape} does not match data "
                f"{data.shape[:2]}")
        for i in range(data.shape[0]):
            self._ingest_one(data[i], weights[i], label=label)
        return self._n

    def _ingest_one(self, tile, w_row, *, label: str = "") -> None:
        from iterative_cleaner_torch.backends.torch_backend import upload
        from iterative_cleaner_torch.online.step import build_subint_step

        pend = self.begin_subint(tile, w_row, label=label)
        from iterative_cleaner_torch.telemetry import profiling

        before = library_builds()
        if self._step is None:
            meta = self.meta
            self._step = build_subint_step(
                self.config, meta.nchan, meta.nbin, meta.dedispersed,
                self.alpha, self.registry)[0]
            if self._profile:
                self._program = "online_step/%dx%d" % (meta.nchan, meta.nbin)
                profiling.capture_compiled(
                    self._program, step_costs(self.config, meta.nchan,
                                              meta.nbin),
                    registry=self.registry, dtype=self.config.dtype)
        with profiling.first_call_peak(self._program, self.device,
                                       registry=self.registry) \
                if self._program is not None else _NO_PEAK:
            outs = self._step(
                upload(pend.tile[None], self.device, self.dtype),
                upload(pend.w_row[None], self.device, self.dtype),
                *self._meta_args, self._template, self._count)
        self._record_compiles(library_builds() - before,
                              warmup=self._n == 0)
        self.commit_subint(pend, *outs)

    def begin_subint(self, tile, w_row, *, label: str = "") -> PendingSubint:
        """Stage one subint without touching the ring: validate the tile
        (float64; the caller keeps it unchanged until the commit), start
        the latency clock and the tracer span.
        The solo path steps and commits in the same call; a StreamMux
        parks the pending entry in its ring and commits after its
        dispatch.  A staged subint does not enter the ring: a reconcile
        before its commit must not see it."""
        if self.closed:
            raise RuntimeError("stream session is closed")
        tile = np.asarray(tile, dtype=np.float64)
        w_row = np.asarray(w_row, dtype=np.float64)
        if tile.shape != (self.meta.nchan, self.meta.nbin):
            raise ValueError(
                f"subint shape {tile.shape} does not match stream geometry "
                f"({self.meta.nchan}, {self.meta.nbin})")
        if w_row.shape != (self.meta.nchan,):
            raise ValueError(
                f"subint weights shape {w_row.shape} does not match "
                f"({self.meta.nchan},)")
        span = None
        if self.tracer is not None:
            span = self.tracer.start(
                "subint", trace_id=self.trace_id,
                parent_id=self.parent_span_id, subsystem="online",
                subint=self._n, label=label)
        self._init_device_state()
        return PendingSubint(tile=tile, w_row=w_row,
                             t0=time.perf_counter(), span=span, label=label)

    def commit_subint(self, pend: PendingSubint, new_w, scores,
                      new_template, updated, template_host=None) -> None:
        """Land one stepped subint: the ring write, the EW template and
        count advance (on the device), the provisional mask, the latency
        (now minus the begin time: a mux's ring wait included), telemetry
        and the reconcile schedule.  ``new_w`` and ``scores`` are the
        step's ``(1, nchan)`` outputs, device tensors (downloaded here in
        one transfer, with the template when the quality monitor reads
        it) or host arrays with ``template_host`` (a mux's lane of its
        one download)."""
        if isinstance(new_w, torch.Tensor):
            want_t = self.quality is not None
            new_w, scores, template_host = download_rows(
                new_w, scores, new_template if want_t else None)
        if self._n >= self._cap:
            self._grow()
        block, row = divmod(self._n, self.nsub_step)
        self._blocks[block][row] = pend.tile
        self._weights[self._n] = pend.w_row
        self._template = new_template
        self._count = self._count + updated.to(torch.int32)
        self._pweights[self._n] = new_w[0]
        self._pscores[self._n] = scores[0]
        self._n += 1
        dt = time.perf_counter() - pend.t0
        self.latencies_s.append(dt)
        if self.registry is not None:
            from iterative_cleaner_torch.telemetry.registry import SECONDS

            self.registry.counter_inc("online_subints")
            self.registry.gauge_set("online_nsub", self._n)
            self.registry.histogram_observe("online_subint_s", dt,
                                            buckets=SECONDS)
        if self._program is not None and self._n > 1:
            # warm subints only: the first one's latency holds the build
            from iterative_cleaner_torch.telemetry import profiling

            profiling.record_walltime(self._program, dt,
                                      registry=self.registry)
        if self.quality is not None:
            self.quality.observe_subint(self._pweights[self._n - 1],
                                        template=template_host)
        if pend.span is not None:
            pend.span.set("nsub", self._n)
            pend.span.set("zapped",
                          int(np.sum(self._pweights[self._n - 1] == 0)))
            pend.span.end()
        if self.reconcile_every > 0 and self._n % self.reconcile_every == 0:
            self.reconcile()

    def _record_compiles(self, delta: int, *, warmup: bool) -> None:
        if delta <= 0:
            return
        if warmup:
            self.warmup_compiles += delta
            if self.registry is not None:
                self.registry.counter_inc("online_warmup_compiles", delta)
        else:
            self.recompiles_steady += delta
            if self.registry is not None:
                self.registry.counter_inc("online_recompiles_steady", delta)

    # --------------------------------------------------------- reconcile
    def reconcile(self) -> int:
        """Mid-stream reconciliation (:mod:`.reconcile`); returns the
        number of drifted provisional cells repaired."""
        from iterative_cleaner_torch.online.reconcile import (
            reconcile_session,
        )

        span = None
        if self.tracer is not None:
            span = self.tracer.start(
                "reconcile", trace_id=self.trace_id,
                parent_id=self.parent_span_id, subsystem="online",
                nsub=self._n, capacity=self._cap)
        drift = reconcile_session(self)
        self.reconciles += 1
        if self.registry is not None:
            self.registry.counter_inc("online_reconciles")
            if drift:
                self.registry.counter_inc("online_mask_drift", drift)
        if self.quality is not None:
            self.quality.observe_reconcile(drift)
        if span is not None:
            span.set("drift", drift)
            span.end()
        return drift

    def close(self) -> OnlineResult:
        """End the stream: the final reconcile, ``clean_archive`` of the
        assembled archive (so the final mask is the batch clean's), and
        the session's accounting."""
        if self.closed:
            raise RuntimeError("stream session already closed")
        if self._n == 0:
            raise ValueError("cannot close an empty stream")
        from iterative_cleaner_torch.backends import clean_archive

        span = None
        if self.tracer is not None:
            span = self.tracer.start(
                "close_reconcile", trace_id=self.trace_id,
                parent_id=self.parent_span_id, subsystem="online",
                nsub=self._n)
        self.closed = True
        ar = self.assembled()
        result = clean_archive(ar, self.config)
        final_w = np.asarray(result.final_weights, dtype=np.float64)
        final_drift = int(np.sum(
            (final_w == 0) != (self._pweights[:self._n] == 0)))
        self._pweights[:self._n] = final_w
        self._pscores[:self._n] = np.asarray(result.scores, np.float64)
        cleaned = dataclasses.replace(ar, weights=final_w)
        if self.quality is not None:
            self.quality.observe_reconcile(final_drift)
            self.quality.observe_close(final_w)
        if span is not None:
            span.set("final_drift", final_drift)
            span.end()
        return OnlineResult(
            archive=cleaned, result=result, n_subints=self._n,
            mask_drift=self.mask_drift, final_drift=final_drift,
            warmup_compiles=self.warmup_compiles,
            recompiles_steady=self.recompiles_steady,
            reconciles=self.reconciles,
            latencies_s=list(self.latencies_s))
