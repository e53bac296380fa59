"""Shape-bucketed fleet scheduler: ragged multi-archive serving through
the batched clean, with the resilience ladder and multi-host serving.

The port's counterpart of ``iterative_cleaner_tpu/parallel/fleet.py``,
with its public names and semantics.  The batched clean
(:mod:`~iterative_cleaner_torch.parallel.batch`) takes equal-shaped
archives only; this module buckets a mixed fleet and serves it:

1. **Planner** (:func:`plan_fleet`): archives group by their ``(nsub,
   nchan, nbin, dedispersed)`` key (a bucket: its groups, its warm-up,
   its claim lease).  Buckets are served in sorted key order; archives
   keep their input order within a bucket.
2. **Pipeline** (:func:`clean_fleet`): a load pool (``io_workers``
   threads) stays one group ahead of the card, each group is one batched
   clean (K1, K2 / K6 / K7, K3 per orientation, the combine and K9, each
   launched once per batch iteration for the whole group), and a
   write-back pool drains outputs behind.  Only the calling thread
   touches the device: the pools' threads read and write files (the
   native PSRFITS and ``.icar`` readers release the interpreter lock in
   their C++ part); the upload happens in the batched clean.  Failures at
   any stage (peek/load/clean/write) are isolated to their archive.
3. **Bucket warm-up** (:class:`BucketPrecompiler`): the port compiles no
   program per shape, so the counterpart of the reference's background
   AOT compile is :func:`~iterative_cleaner_torch.parallel.batch.
   warm_bucket` for each bucket: the kernel library's ``nvcc`` build,
   once per source digest and build directory (``--compile-cache DIR``
   keeps it across processes, so a warm restart builds nothing).  It runs
   on the serving thread right after the first group's loads are
   submitted, so the build overlaps them; the DFT tables are made by the
   clean itself.  A warm-up that fails (the ``compile`` fault site) is a
   miss, and the bucket is warmed inline before its first group.
4. **No padding**: the reference pads a short trailing group's batch
   axis up to the bucket's group size, and quantizes near-miss geometries
   into one bucket (``bucket_pad``) by padding subints and channels, so
   that a bucket is one compiled program.  The port has no program to
   share, so it pads nothing: a bucket is one raw geometry, and a group
   launches at its own size.  Padding would only add work, and on the
   card it is not exact: the template stage's channel sums run in another
   order at the padded width, and on an H100 that moved the mask of one
   of four 64 x 120 x 512 archives padded to 128 channels by one cell.
   Unpadded, every archive's result is bit-equal to its single clean (a
   batch is bit-equal to its single cleans).  ``CleanConfig.
   fleet_bucket_pad`` (``--bucket-pad``) is accepted for the reference
   CLI's sake and changes no bucket, group or launch.
5. **Resilience ladder** (:mod:`iterative_cleaner_torch.resilience`):
   transient peek/load/write failures retry with bounded deterministic
   backoff (``fleet_retries``); every stage attempt may run under a
   watchdog deadline (``fleet_watchdog_trips``); a device OOM during a
   group's clean (``torch.OutOfMemoryError``, a kernel wrapper's "out of
   memory" error, or the injector's synthetic twin) empties the caching
   allocator and halves the batch down to singletons
   (``fleet_oom_splits``).  A singleton that still exhausts the device
   fails in the ``clean`` stage with its OOM error.  The reference goes
   one rung further and cleans it on the host with the numpy oracle; the
   port never moves a clean off the device on its own, so such an
   archive is named in the report and the session exits 1 — clean it
   alone with an explicit ``--backend numpy`` (the float64 oracle).  A
   watchdog cannot stop a launch: a tripped execute attempt runs on in
   its daemon thread, launching its batch's remaining iterations and
   holding their memory beside the next group, and its archives are
   failed (the ``exec:hang`` drill stalls on the host before any
   launch).  With a journal, each archive's ``done`` line is written
   strictly after its atomic output write, so ``--resume`` skips finished
   work with zero duplicated cleans (``fleet_resumed_skips``).
6. **Multi-host serving** (``hosts=`` / ``--hosts``): buckets partition
   across hosts by :func:`bucket_host`; every host computes the same plan
   and assignment, claims each bucket through the shared journal (a
   lease with heartbeats) before serving it, steals unclaimed or expired
   buckets once its own are done, and skips every archive a peer
   already journaled.  No collectives: a dead host cannot hang the
   others; whole-slice telemetry folds from the journal's per-host
   ``stats`` lines.

7. **Spans** (``tracer=``, a :class:`~iterative_cleaner_torch.telemetry.
   tracing.Tracer`; None costs one comparison per site): a ``fleet`` root
   span (parented by ``trace=``, e.g. the serve daemon's execute span),
   one ``group`` span per group with its ``execute`` child (retry and
   OOM-split events), a ``load`` and a ``write`` span per archive, and on
   a multi-host fleet one ``serve_bucket`` span per claimed bucket,
   parented by the victim's trace context when the bucket was stolen (the
   journal's claim lines carry it).
8. **Roofline**: each bucket's batch iteration is a program of
   :mod:`~iterative_cleaner_torch.telemetry.profiling` (captured by the
   warm-up); a full group's clean seconds over its iterations pair with
   it.

Not here: a ``('batch',)`` mesh under the fleet (ROADMAP item 3b):
``mesh`` raises ``NotImplementedError``.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import os
import sys
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple


from iterative_cleaner_torch.archive import Archive
from iterative_cleaner_torch.backends.base import CleanResult
from iterative_cleaner_torch.config import ROADMAP_FLEET_3B, CleanConfig

# (nsub, nchan, nbin, dedispersed) — a bucket's key
ShapeKey = Tuple[int, int, int, bool]


def resolve_io_workers(value: Optional[int] = None) -> int:
    """The fleet/prefetch IO-pool width: explicit value, else the
    ``ICLEAN_IO_WORKERS`` env var, else 2 (one loader ahead of the device
    plus one write-back drain)."""
    if value is None:
        env = os.environ.get("ICLEAN_IO_WORKERS", "")
        value = int(env) if env else 2
    value = int(value)
    if value < 1:
        raise ValueError(f"io_workers must be >= 1, got {value}")
    return value


def resolve_claim_ttl(value: Optional[float] = None) -> float:
    """The multi-host claim-lease duration: explicit value, else the
    ``ICLEAN_CLAIM_TTL`` env var, else 60 s (a serving host heartbeats
    at ttl/3, so a dead host's buckets are stealable within a minute)."""
    if value is None:
        env = os.environ.get("ICLEAN_CLAIM_TTL", "")
        value = float(env) if env else 60.0
    value = float(value)
    if value <= 0:
        raise ValueError(f"claim ttl must be > 0, got {value}")
    return value


def bucket_host(key: ShapeKey, n_hosts: int) -> int:
    """Deterministic bucket -> host affinity: a stable hash of the
    bucket's geometry key modulo the host count (the reference's hash, so
    both packages assign alike).  Every host computes the same full plan
    and the same assignment with zero communication, and warms exactly
    the buckets it will serve."""
    from iterative_cleaner_torch.parallel.distributed import stable_shard

    nsub, nchan, nbin, ded = key
    return stable_shard("%dx%dx%d:%d" % (int(nsub), int(nchan), int(nbin),
                                         int(bool(ded))), n_hosts)


def bucket_work_key(key: ShapeKey) -> str:
    """The journal claim key for one bucket — geometry, not host, so a
    steal targets exactly the work the dead host left."""
    nsub, nchan, nbin, ded = key
    return "bucket:%dx%dx%d:%d" % (int(nsub), int(nchan), int(nbin),
                                   int(bool(ded)))


@dataclasses.dataclass(frozen=True)
class FleetItem:
    """One archive's slot in the plan."""

    index: int                       # position in the input path list
    path: str
    raw_shape: Tuple[int, int, int]  # (nsub, nchan, nbin) as on disk
    dedispersed: bool


@dataclasses.dataclass
class FleetBucket:
    """The archives of one bucket key."""

    key: ShapeKey                    # the archives' geometry
    items: List[FleetItem]
    batch_dim: int                   # the largest group's batch size

    def groups(self) -> List[List[FleetItem]]:
        """Groups of at most ``batch_dim`` archives, in input order; a
        trailing partial group launches at its own size."""
        return [self.items[i:i + self.batch_dim]
                for i in range(0, len(self.items), self.batch_dim)]


@dataclasses.dataclass
class FleetPlan:
    buckets: List[FleetBucket]
    group_size: int

    @property
    def n_archives(self) -> int:
        return sum(len(b.items) for b in self.buckets)

    @property
    def n_groups(self) -> int:
        return sum(len(b.groups()) for b in self.buckets)


def plan_fleet(entries: Sequence[Tuple[str, ShapeKey]],
               group_size: int = 8,
               batch_multiple: int = 1) -> FleetPlan:
    """Bucket ``(path, (nsub, nchan, nbin, dedispersed))`` entries by
    their geometry.

    Bucket order is sorted by key — deterministic whatever the input
    order — and archives keep input order within each bucket.
    ``batch_multiple`` rounds each bucket's batch dimension up (a
    ('batch',) mesh needs the batch divisible by its rank count)."""
    if group_size < 1:
        raise ValueError(f"group_size must be >= 1, got {group_size}")
    buckets: Dict[ShapeKey, List[FleetItem]] = {}
    for index, (path, (nsub, nchan, nbin, ded)) in enumerate(entries):
        key = (int(nsub), int(nchan), int(nbin), bool(ded))
        buckets.setdefault(key, []).append(
            FleetItem(index=index, path=path,
                      raw_shape=(int(nsub), int(nchan), int(nbin)),
                      dedispersed=bool(ded)))
    out = []
    for key in sorted(buckets):
        items = buckets[key]
        dim = min(int(group_size), len(items))
        dim = -(-dim // int(batch_multiple)) * int(batch_multiple)
        out.append(FleetBucket(key=key, items=items, batch_dim=dim))
    return FleetPlan(buckets=out, group_size=int(group_size))


class BucketPrecompiler:
    """The warm-up of a fleet plan's buckets: :func:`~iterative_cleaner_
    torch.parallel.batch.warm_bucket` for each bucket, in the plan's
    (sorted) serving order, when :meth:`start` is called — the serve loop
    calls it right after submitting the first group's loads, so the
    library's one ``nvcc`` build runs while they read.

    Fresh warm-ups count once into ``fleet_compiles`` (and
    ``batch_compiles``), and the builds they ran into
    ``fleet_precompile_builds``; memo hits count nothing.  A failed
    warm-up (the ``compile`` fault site) is not fatal: :meth:`obtain`
    answers a miss and the serve loop warms the bucket inline."""

    def __init__(self, plan: FleetPlan, config: CleanConfig, *,
                 registry=None, faults=None) -> None:
        self._plan = plan
        self._config = config
        self._registry = registry
        self._faults = faults
        self._ready: Optional[Dict[ShapeKey, bool]] = None

    def start(self) -> None:
        """Warm every bucket of the plan (once; later calls return)."""
        from iterative_cleaner_torch.parallel.batch import warm_bucket

        if self._ready is not None:
            return
        self._ready = {}
        for bucket in self._plan.buckets:
            nsub, nchan, nbin, ded = bucket.key
            stats: Dict[str, object] = {}
            try:
                if self._faults is not None:
                    # the "compile" fault site: a failed warm-up must send
                    # the bucket to the inline path, never fail it
                    self._faults.fire("compile", detail="%dx%dx%d" % (
                        nsub, nchan, nbin))
                warm_bucket(self._config, nsub, nchan, nbin, ded,
                            bucket.batch_dim, registry=self._registry,
                            stats_out=stats)
            except Exception:  # noqa: BLE001  # icln: ignore[broad-except] -- a failed warm-up is a miss; the inline path warms the bucket and surfaces a real fault
                self._ready[bucket.key] = False
                continue
            self._ready[bucket.key] = True
            if self._registry is not None:
                if stats.get("fresh"):
                    self._registry.counter_inc("fleet_compiles")
                if stats.get("library_builds"):
                    self._registry.counter_inc("fleet_precompile_builds",
                                               stats["library_builds"])

    def obtain(self, bucket: FleetBucket) -> bool:
        """Whether ``bucket`` was warmed (a hit); a bucket outside the
        plan or whose warm-up failed is a miss."""
        self.start()
        return bool(self._ready.get(bucket.key, False))


@dataclasses.dataclass
class FleetReport:
    """What :func:`clean_fleet` hands back: per-path results (cleaned
    archives only), per-path failures with the stage they died in,
    journal-resumed skips, and the run's warm-up/recovery accounting.

    Every input path lands in exactly one of ``results`` (cleaned this
    run), ``skipped`` (journal-verified complete from a previous run, or
    by a peer host) or ``failures`` — except a clean-but-unwritable
    archive, which keeps its result AND a ``write`` failure."""

    results: Dict[str, CleanResult]
    failures: List[Tuple[str, str, BaseException]]  # (path, stage, error)
    skipped: List[str] = dataclasses.field(default_factory=list)
    n_buckets: int = 0
    n_groups: int = 0
    n_compiles: int = 0
    n_retries: int = 0
    n_oom_splits: int = 0
    n_watchdog_trips: int = 0
    host_id: int = 0
    n_hosts: int = 1
    n_buckets_owned: int = 0
    n_stolen: int = 0
    host_counters: Dict[int, Dict[str, float]] = dataclasses.field(
        default_factory=dict)

    @property
    def ok(self) -> bool:
        return not self.failures


# Header-peek memo for the default shape_fn, keyed by (path, mtime_ns,
# size) so a rewritten file re-peeks.  Bounded by a wholesale clear.
_PEEK_CACHE: Dict[Tuple[str, int, int], ShapeKey] = {}
_PEEK_CACHE_MAX = 8192
_PEEK_LOCK = threading.Lock()


def _default_shape_fn(path: str) -> ShapeKey:
    from iterative_cleaner_torch.io import peek_shape

    st = os.stat(path)
    key = (os.path.abspath(path), st.st_mtime_ns, st.st_size)
    with _PEEK_LOCK:
        hit = _PEEK_CACHE.get(key)
    if hit is not None:
        return hit
    nsub, nchan, nbin, ded = peek_shape(path)
    shape = (int(nsub), int(nchan), int(nbin), bool(ded))
    with _PEEK_LOCK:
        if len(_PEEK_CACHE) >= _PEEK_CACHE_MAX:
            _PEEK_CACHE.clear()
        _PEEK_CACHE[key] = shape
    return shape


def clean_fleet(paths: Sequence[str], config: CleanConfig, *,
                mesh=None, registry=None, events=None,
                io_workers: Optional[int] = None,
                group_size: Optional[int] = None,
                load_fn: Optional[Callable[[str], Archive]] = None,
                write_fn: Optional[Callable[[str, Archive, CleanResult],
                                            None]] = None,
                shape_fn: Optional[Callable[[str], ShapeKey]] = None,
                on_error: Optional[Callable[[str, BaseException, str],
                                            None]] = None,
                precompile: bool = True,
                resilience=None,
                out_path_fn: Optional[Callable[[str], str]] = None,
                hosts=None, tracer=None,
                trace: Optional[dict] = None,
                identity: Optional[CleanConfig] = None) -> FleetReport:
    """Serve an archive-path list through the batched clean on
    ``config.device``.

    ``group_size`` defaults to the config's ``fleet_group_size``,
    ``io_workers`` to :func:`resolve_io_workers`.  ``load_fn(path)``/``write_fn(path,
    raw_ar, result)`` are injectable (the CLI wires ``clean_one``);
    ``shape_fn(path)`` feeds the planner (default: a header peek, no cube
    read).  Per-archive failures never abort the
    fleet: each lands in the returned :class:`FleetReport` (and
    ``on_error(path, exc, stage)`` fires).  ``registry`` collects the
    ``fleet_*`` counters, gauges and histograms; ``events`` (a telemetry
    ``RunEventLog``) gets a ``fleet_plan`` event.

    ``precompile`` (default on) warms the plan's buckets with the
    :class:`BucketPrecompiler` while the first group loads; off, every
    bucket warms inline on its first group.  ``config.compile_cache_dir`` (applied here through
    :func:`~iterative_cleaner_torch.utils.configure_compilation_cache`)
    is the kernel library's build directory.

    ``resilience`` (a :class:`~iterative_cleaner_torch.resilience.
    ResiliencePlan`) configures the recovery ladder; the default resolves
    the ``ICLEAN_FAULTS``/``ICLEAN_RETRIES``/``ICLEAN_STAGE_TIMEOUT``
    mirrors and the config's knobs.  With a journal, ``out_path_fn(path)``
    names the output each completion line records, so a resume can
    re-verify it.  ``hosts`` (a :class:`~iterative_cleaner_torch.parallel.
    distributed.HostTopology`, default from the config's ``fleet_hosts``/
    ``fleet_host_id`` and their mirrors) serves this process's share of a
    multi-host fleet through the shared journal, which it then requires.
    ``tracer`` (a :class:`~iterative_cleaner_torch.telemetry.tracing.
    Tracer`, default None: tracing off) records the fleet's spans;
    ``trace`` (a ``{"trace_id", "span_id"}`` context, e.g. the serve
    daemon's execute span) parents its root span, and rides the
    journal's completion and claim lines.  ``identity`` (default
    ``config``) is the config whose hash keys the journal's lines: the
    serve daemon's request config, whose ``backend`` may name the numpy
    oracle while ``config`` names the torch engine.
    ``mesh`` is ROADMAP item 3b: ``NotImplementedError``."""
    from iterative_cleaner_torch.io import load_archive
    from iterative_cleaner_torch.parallel.batch import (
        record_builder_cache_stats,
    )
    from iterative_cleaner_torch.parallel.distributed import (
        HostTopology,
        resolve_host_topology,
    )
    from iterative_cleaner_torch.resilience import (
        ResiliencePlan,
        entry_is_current,
        run_with_retries,
    )
    from iterative_cleaner_torch.telemetry.registry import MetricsRegistry
    from iterative_cleaner_torch.utils import configure_compilation_cache
    from iterative_cleaner_torch.utils.checkpoint import config_hash

    if mesh is not None:
        raise NotImplementedError(
            f"clean_fleet over a ('batch',) mesh: {ROADMAP_FLEET_3B}")
    configure_compilation_cache(config.compile_cache_dir)

    group_size = (config.fleet_group_size if group_size is None
                  else int(group_size))
    io_workers = resolve_io_workers(io_workers)
    load_fn = load_fn if load_fn is not None else load_archive
    shape_fn = shape_fn if shape_fn is not None else _default_shape_fn
    reg = registry if registry is not None else MetricsRegistry()
    res = (resilience if resilience is not None
           else ResiliencePlan.from_env(config))
    if res.faults is not None:
        res.faults.bind(reg)

    topo: HostTopology = (hosts if hosts is not None
                          else resolve_host_topology(config.fleet_hosts,
                                                     config.fleet_host_id))
    if topo.is_multi and res.journal is None:
        raise ValueError(
            "multi-host fleet serving coordinates through the shared "
            "journal (claim leases, work stealing, exactly-once "
            "accounting); pass a ResiliencePlan with a journal on "
            "storage every host shares (--journal PATH)")

    # the run's root span; with no tracer every span site below is a None
    # check
    fleet_span = None
    if tracer is not None:
        ctx = trace or {}
        fleet_span = tracer.start(
            "fleet", trace_id=ctx.get("trace_id"),
            parent_id=ctx.get("span_id"), subsystem="fleet", lane="fleet",
            host_id=topo.host_id, n_paths=len(paths))

    report = FleetReport(results={}, failures=[],
                         host_id=topo.host_id, n_hosts=topo.n_hosts)

    def fail(path: str, stage: str, exc: BaseException) -> None:
        report.failures.append((path, stage, exc))
        reg.counter_inc("fleet_failures")
        if on_error is not None:
            try:
                on_error(path, exc, stage)
            except Exception as cb_exc:  # noqa: BLE001 -- a broken error callback must not abort the fleet on top of the failure it reports: counted and printed
                reg.counter_inc("fleet_callback_errors")
                print("WARNING: fleet on_error callback raised for %s: "
                      "%s: %s" % (path, type(cb_exc).__name__, cb_exc),
                      file=sys.stderr)

    # a caller-shared registry may hold earlier runs' counts; the
    # report's n_* fields are this run's deltas
    mark = reg.counters_mark()

    cfg_hash = (config_hash(config if identity is None else identity)
                if res.journal is not None else "")
    pending_paths = list(paths)
    if res.resume and res.journal is not None:
        done = res.journal.completed(cfg_hash)
        keep = []
        for p in pending_paths:
            entry = done.get(os.path.abspath(p))
            if entry is not None and entry_is_current(entry):
                report.skipped.append(p)
                reg.counter_inc("fleet_resumed_skips")
                if events is not None:
                    events.emit("fleet_resume_skip", path=p)
            else:
                keep.append(p)
        pending_paths = keep

    entries = []
    for p in pending_paths:
        try:
            entries.append((p, run_with_retries(
                lambda p=p: shape_fn(p), stage="peek", policy=res.retry,
                registry=reg, faults=res.faults,
                deadline_s=res.stage_timeout_s, span=fleet_span)))
        except Exception as exc:
            fail(p, "peek", exc)

    plan = plan_fleet(entries, group_size=group_size)
    groups = [(bucket, chunk)
              for bucket in plan.buckets for chunk in bucket.groups()]
    report.n_buckets = len(plan.buckets)
    report.n_groups = len(groups)
    reg.counter_inc("fleet_archives", len(entries))
    reg.gauge_set("fleet_buckets", len(plan.buckets))
    reg.gauge_set("fleet_groups", len(groups))
    if events is not None:
        events.emit("fleet_plan", n_archives=len(entries),
                    n_buckets=len(plan.buckets), n_groups=len(groups),
                    group_size=group_size)
    if fleet_span is not None:
        fleet_span.set("n_buckets", len(plan.buckets))
        fleet_span.set("n_groups", len(groups))
    if not groups and not topo.is_multi:
        if fleet_span is not None:
            fleet_span.end()
        return report

    serve_t0 = time.perf_counter()
    if topo.is_multi:
        reg.gauge_set("fleet_hosts", topo.n_hosts)
        reg.gauge_set("fleet_host_id", topo.host_id)
        if groups:
            _serve_multihost(plan, topo, config, reg, report, fail,
                             precompile, io_workers, load_fn, write_fn,
                             res, cfg_hash, out_path_fn, events,
                             tracer=tracer, parent_span=fleet_span)
    else:
        precompiler = (BucketPrecompiler(plan, config, registry=reg,
                                         faults=res.faults)
                       if precompile else None)
        _serve_groups(groups, config, reg, report, fail, precompiler,
                      io_workers, load_fn, write_fn, res, cfg_hash,
                      out_path_fn, tracer=tracer,
                      trace=(fleet_span.context()
                             if fleet_span is not None else trace))
    reg.gauge_set("fleet_serve_s", time.perf_counter() - serve_t0)
    delta = reg.counters_since(mark)
    report.n_compiles = int(delta.get("fleet_compiles", 0.0))
    report.n_retries = int(delta.get("fleet_retries", 0.0))
    report.n_oom_splits = int(delta.get("fleet_oom_splits", 0.0))
    report.n_watchdog_trips = int(delta.get("fleet_watchdog_trips", 0.0))
    reg.counter_inc("fleet_cleaned", len(report.results))
    if topo.is_multi:
        report.n_buckets_owned = int(delta.get("fleet_buckets_owned", 0.0))
        report.n_stolen = int(delta.get("fleet_stolen", 0.0))
        # paths another host finished land in `skipped`: every input path
        # still resolves to exactly one of results/skipped/failures
        done = res.journal.completed(cfg_hash)
        accounted = set(report.results)
        accounted.update(p for p, _stage, _exc in report.failures)
        accounted.update(report.skipped)
        for p in pending_paths:
            if p in accounted:
                continue
            if os.path.abspath(p) in done:
                report.skipped.append(p)
                reg.counter_inc("fleet_remote_done")
        _publish_host_stats(topo, reg, report, res.journal,
                            reg.counters_since(mark))
        # a segmented journal's active segments are sealed on exit, so the
        # next maintenance pass can compact them
        res.journal.seal()
    record_builder_cache_stats(reg)
    if fleet_span is not None:
        fleet_span.set("n_cleaned", len(report.results))
        fleet_span.set("n_failed", len(report.failures))
        fleet_span.end("ok" if not report.failures else "partial")
    return report


def _publish_host_stats(topo, reg, report, journal, delta) -> None:
    """Whole-slice telemetry without a collective: append this host's
    ``fleet_*`` counter deltas to the shared journal, then fold every
    host's last snapshot into per-host gauges (``<counter>_host<i>``) and
    slice totals (``<counter>_slice``).  The last host to finish sees the
    whole slice; earlier finishers see a prefix."""
    stats = {k: float(v) for k, v in delta.items()
             if k.startswith("fleet_")}
    journal.record_host_stats(topo.host_id, stats)
    all_stats = journal.host_stats()
    report.host_counters = {int(h): dict(c) for h, c in all_stats.items()}
    slice_totals: Dict[str, float] = {}
    for hid in sorted(all_stats):
        for k, v in sorted(all_stats[hid].items()):
            reg.gauge_set("%s_host%d" % (k, hid), float(v))
            slice_totals[k] = slice_totals.get(k, 0.0) + float(v)
    for k in sorted(slice_totals):
        reg.gauge_set(k + "_slice", slice_totals[k])


def _journal_done(done: Dict[str, dict], path: str) -> bool:
    """Is ``path`` verifiably complete per the shared journal: a ``done``
    entry that still re-verifies (input unchanged, output present)."""
    from iterative_cleaner_torch.resilience import entry_is_current

    entry = done.get(os.path.abspath(path))
    return entry is not None and entry_is_current(entry)


class ClaimHeartbeat:
    """Background lease refresher for one claimed work item: appends an
    'hb' line every ttl/3 until stopped, so a live (even slow) owner is
    never stolen from — only a dead one, whose heartbeats stop
    (``counter`` names the miss counter)."""

    def __init__(self, journal, work: str, host: int, nonce: str,
                 ttl_s: float, registry=None,
                 counter: str = "fleet_heartbeat_errors") -> None:
        self._stop = threading.Event()

        def beat() -> None:
            while not self._stop.wait(ttl_s / 3.0):
                try:
                    journal.heartbeat(work, host=host, nonce=nonce,
                                      ttl_s=ttl_s)
                except Exception:  # noqa: BLE001 -- a missed heartbeat only risks an early steal, and steals are idempotent; the counter keeps misses visible
                    if registry is not None:
                        registry.counter_inc(counter)

        self._thread = threading.Thread(target=beat, daemon=True,
                                        name="icln-claim-hb")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)


def _serve_multihost(plan, topo, config, reg, report, fail, precompile,
                     io_workers, load_fn, write_fn, res, cfg_hash,
                     out_path_fn, events, tracer=None,
                     parent_span=None) -> None:
    """:func:`clean_fleet`'s multi-host serve loop.

    Sweep the plan's buckets — own (hash-affine) buckets first, foreign
    ones only once own work is done — claiming each through the shared
    journal before serving it and releasing after its writes landed.
    Unclaimed and lease-expired foreign buckets are stolen; buckets under
    another host's live lease are left alone.  The loop exits when every
    bucket is journal-complete or was attempted here, so a host whose
    peers are still serving waits for their ``done`` lines (or their
    lease expiry) rather than exiting with the slice incomplete.  A stolen
    bucket's ``serve_bucket`` span is parented by the trace context on the
    victim's claim line, so the originating request's trace shows the
    bucket moving hosts."""
    journal = res.journal
    ttl = resolve_claim_ttl(config.fleet_claim_ttl_s)
    poll_s = min(1.0, ttl / 4.0)
    # host id + pid + random tag: a restarted host must not inherit its
    # dead predecessor's lease
    nonce = "h%d-%d-%s" % (topo.host_id, os.getpid(), os.urandom(4).hex())
    owned = [b for b in plan.buckets
             if bucket_host(b.key, topo.n_hosts) == topo.host_id]
    foreign = [b for b in plan.buckets
               if bucket_host(b.key, topo.n_hosts) != topo.host_id]
    own_keys = {b.key for b in owned}
    reg.counter_inc("fleet_buckets_owned", len(owned))
    if events is not None:
        events.emit("fleet_hosts", host_id=topo.host_id,
                    n_hosts=topo.n_hosts, owned=len(owned),
                    foreign=len(foreign), claim_ttl_s=ttl)
    # the warm-up covers this host's own buckets; stolen ones warm inline
    own_plan = FleetPlan(buckets=owned, group_size=plan.group_size)
    precompiler = (BucketPrecompiler(own_plan, config, registry=reg,
                                     faults=res.faults)
                   if precompile and owned else None)
    finished = set()        # bucket keys this host is done considering
    while True:
        progressed = False
        for bucket in owned + foreign:
            if bucket.key in finished:
                continue
            own_pending = any(b.key not in finished for b in owned)
            if bucket.key not in own_keys and own_pending:
                continue    # steal only once own work is done
            done = journal.completed(cfg_hash)
            remaining = [it for it in bucket.items
                         if not _journal_done(done, it.path)]
            if not remaining:
                finished.add(bucket.key)
                progressed = True
                continue
            work = bucket_work_key(bucket.key)
            owner = journal.claim_table().get(work)
            if (owner is not None and owner["live"]
                    and owner["nonce"] != nonce):
                continue    # live lease elsewhere: leave it be
            stolen = bucket.key not in own_keys
            bspan = None
            if tracer is not None:
                vtrace = (owner or {}).get("trace")
                if stolen and isinstance(vtrace, dict) \
                        and vtrace.get("trace_id"):
                    b_tid, b_pid = vtrace.get("trace_id"), \
                        vtrace.get("span_id")
                else:
                    pctx = (parent_span.context()
                            if parent_span is not None else {})
                    b_tid, b_pid = pctx.get("trace_id"), pctx.get("span_id")
                bspan = tracer.start(
                    "serve_bucket", trace_id=b_tid, parent_id=b_pid,
                    subsystem="fleet", lane=work, host_id=topo.host_id,
                    stolen=stolen, n_items=len(remaining))
            if not journal.try_claim(
                    work, host=topo.host_id, nonce=nonce, ttl_s=ttl,
                    trace=(bspan.context() if bspan is not None
                           else None)):
                reg.counter_inc("fleet_claim_conflicts")
                if bspan is not None:
                    bspan.end("claim_lost")
                continue    # lost the append race
            if stolen:
                reg.counter_inc("fleet_stolen")
                if bspan is not None:
                    bspan.event(
                        "stolen", from_host=int((owner or {}).get("host", -1)),
                        recovered_trace=isinstance(
                            (owner or {}).get("trace"), dict))
            if events is not None:
                events.emit("fleet_claim", work=work, stolen=stolen,
                            n_items=len(remaining))
            sub = FleetBucket(key=bucket.key, items=remaining,
                              batch_dim=bucket.batch_dim)
            sub_groups = [(sub, chunk) for chunk in sub.groups()]
            hb = ClaimHeartbeat(journal, work, topo.host_id, nonce, ttl,
                                registry=reg)
            try:
                _serve_groups(sub_groups, config, reg, report, fail,
                              precompiler, io_workers, load_fn,
                              write_fn, res, cfg_hash, out_path_fn,
                              journal_unwritten=True, tracer=tracer,
                              trace=(bspan.context() if bspan is not None
                                     else None))
            finally:
                hb.stop()
            journal.release(work, host=topo.host_id, nonce=nonce)
            if bspan is not None:
                bspan.end()
            finished.add(bucket.key)
            progressed = True
        if all(b.key in finished for b in plan.buckets):
            break
        if not progressed:
            time.sleep(poll_s)


def _empty_device_cache(config: CleanConfig) -> None:
    """After a device OOM: collect what the failed attempt left and
    return the caching allocator's free blocks to the card, so the
    halves are not crowded out by them."""
    if str(config.device).startswith("cuda"):
        import gc

        import torch

        if torch.cuda.is_available():
            gc.collect()
            torch.cuda.empty_cache()


def _serve_groups(groups, config, reg, report, fail, precompiler,
                  io_workers, load_fn, write_fn, res, cfg_hash,
                  out_path_fn, journal_unwritten: bool = False,
                  tracer=None, trace: Optional[dict] = None) -> None:
    """:func:`clean_fleet`'s pipeline body: load lookahead -> the bucket's
    warm-up -> batched clean (through the OOM/retry recovery ladder) ->
    journaled write-back.

    ``journal_unwritten`` (the multi-host loop sets it) journals a
    ``done`` line even with no ``write_fn``: with no output file the
    clean's completion is the unit of work peers must not repeat.
    ``tracer``/``trace`` as :func:`clean_fleet`'s: the spans parent under
    ``trace`` and each ``done`` line records it."""
    from iterative_cleaner_torch.backends.torch_backend import resolve_device
    from iterative_cleaner_torch.parallel.batch import (
        bucket_program,
        clean_archives_batched,
        warm_bucket,
    )
    from iterative_cleaner_torch.resilience import (
        OOM,
        TRANSIENT,
        StageTimeout,
        call_with_deadline,
        run_with_retries,
    )
    from iterative_cleaner_torch.resilience import classify_error as classify
    from iterative_cleaner_torch.telemetry import profiling
    from iterative_cleaner_torch.telemetry.registry import SECONDS
    from iterative_cleaner_torch.telemetry.tracing import maybe_span

    ctx = trace or {}
    t_tid, t_pid = ctx.get("trace_id"), ctx.get("span_id")
    done_trace = dict(trace) if trace else None

    def load_task(path: str) -> Archive:
        with maybe_span(tracer, "load", trace_id=t_tid, parent_id=t_pid,
                        subsystem="fleet", lane="io",
                        path=os.path.basename(path)) as s:
            return run_with_retries(
                lambda: load_fn(path), stage="load", policy=res.retry,
                registry=reg, faults=res.faults,
                deadline_s=res.stage_timeout_s, span=s)

    def write_task(path: str, ar: Archive, result: CleanResult) -> None:
        with maybe_span(tracer, "write", trace_id=t_tid, parent_id=t_pid,
                        subsystem="fleet", lane="io",
                        path=os.path.basename(path)) as s:
            run_with_retries(
                lambda: write_fn(path, ar, result), stage="write",
                policy=res.retry, registry=reg, faults=res.faults,
                deadline_s=res.stage_timeout_s, span=s)
        if res.journal is not None:
            # journal strictly after the (atomic) output write: a crash
            # between the two re-cleans the archive on resume — never a
            # journaled path with no output
            # icln: ignore[journal-append-without-claim] -- runs under the bucket lease: _serve_multihost try_claim'd it before serve()
            res.journal.record_done(
                path, config_hash=cfg_hash,
                out_path=out_path_fn(path) if out_path_fn else None,
                trace=done_trace)

    with cf.ThreadPoolExecutor(max_workers=io_workers) as load_pool, \
            cf.ThreadPoolExecutor(max_workers=io_workers) as write_pool:
        pending: Dict[int, list] = {}
        write_futs: List[Tuple[FleetItem, cf.Future]] = []

        def submit_loads(gi: int) -> None:
            if gi < len(groups):
                pending[gi] = [(it, load_pool.submit(load_task, it.path))
                               for it in groups[gi][1]]

        submit_loads(0)
        if precompiler is not None:
            # the warm-up (the library's build, if any) while they load
            precompiler.start()
        for gi, (bucket, chunk) in enumerate(groups):
            # the next group's host IO overlaps this group's clean
            submit_loads(gi + 1)
            # one span per group, its lane the bucket's work key; ended at
            # every exit (Span.end is idempotent)
            gspan = None
            if tracer is not None:
                gspan = tracer.start(
                    "group", trace_id=t_tid, parent_id=t_pid,
                    subsystem="fleet", lane=bucket_work_key(bucket.key),
                    group=gi, n_items=len(chunk))
            loaded = []
            t0 = time.perf_counter()
            for it, fut in pending.pop(gi):
                try:
                    ar = fut.result()
                except Exception as exc:
                    fail(it.path, "load", exc)
                    continue
                loaded.append((it, ar))
            load_stall = time.perf_counter() - t0
            reg.histogram_observe("fleet_load_stall_s", load_stall,
                                  buckets=SECONDS)
            if gspan is not None:
                gspan.set("load_stall_s", round(load_stall, 6))
            bad = [(it, ar) for it, ar in loaded
                   if (ar.nsub, ar.nchan, ar.nbin) != tuple(it.raw_shape)
                   or bool(ar.dedispersed) != it.dedispersed]
            if bad:
                # a shape that disagrees with its header peek (corrupt or
                # rewritten file): the whole group is suspect
                it, ar = bad[0]
                exc = ValueError(
                    f"{it.path}: loaded as {(ar.nsub, ar.nchan, ar.nbin)} "
                    f"(dedispersed {bool(ar.dedispersed)}), its header said "
                    f"{tuple(it.raw_shape)} ({it.dedispersed})")
                for it, _ar in loaded:
                    fail(it.path, "load", exc)
                if gspan is not None:
                    gspan.end("load_error")
                continue
            if not loaded:
                if gspan is not None:
                    gspan.end("empty")
                continue
            ready = False
            if precompiler is not None:
                ready = precompiler.obtain(bucket)
                reg.counter_inc("fleet_precompile_hits" if ready
                                else "fleet_precompile_misses")
            if gspan is not None:
                gspan.set("precompiled", bool(ready))
            results: List[Optional[CleanResult]] = [None] * len(loaded)
            espan = None
            if gspan is not None:
                espan = tracer.start(
                    "execute", trace_id=t_tid, parent_id=gspan.span_id,
                    subsystem="fleet", lane=bucket_work_key(bucket.key),
                    n_items=len(loaded))
            program = bucket_program(config, *bucket.key, bucket.batch_dim)

            def attempt_once(idx):
                """One batched-clean attempt over ``loaded[idx]`` at its
                own size, fault site and watchdog applied."""
                def run():
                    if res.faults is not None:
                        res.faults.fire(
                            "execute",
                            detail="%dx%dx%d[%d]" % (bucket.key[0],
                                                     bucket.key[1],
                                                     bucket.key[2],
                                                     len(idx)))
                    ars = [loaded[i][1] for i in idx]
                    if len(idx) != bucket.batch_dim:
                        return clean_archives_batched(ars, config,
                                                      registry=reg)
                    # the bucket's program at its size: its first call's
                    # peak (profiling on) and its seconds an iteration
                    t_run = time.perf_counter()
                    with profiling.first_call_peak(
                            program, resolve_device(config.device),
                            registry=reg):
                        out = clean_archives_batched(ars, config,
                                                     registry=reg)
                    loops = max((r.loops for r in out), default=0)
                    if loops:
                        profiling.record_walltime(
                            program, (time.perf_counter() - t_run) / loops,
                            registry=reg)
                    return out

                return call_with_deadline(run, res.stage_timeout_s,
                                          "execute", registry=reg,
                                          span=espan)

            def serve(idx, attempt=0):
                """Recovery ladder over ``loaded[idx]``: OOM halves the
                batch down to singletons, and a singleton that still
                exhausts the device fails with its OOM error; transients
                retry with backoff, watchdog trips and permanent errors
                fail the archives.  Fills ``results`` holes; never
                raises."""
                try:
                    out = attempt_once(idx)
                except StageTimeout as exc:
                    for i in idx:
                        fail(loaded[i][0].path, "clean", exc)
                    return
                except Exception as exc:
                    kind = classify(exc)
                    if kind != OOM:
                        if kind == TRANSIENT \
                                and attempt < res.retry.max_retries:
                            reg.counter_inc("fleet_retries")
                            if espan is not None:
                                espan.event("retry", stage="execute",
                                            attempt=attempt,
                                            error=type(exc).__name__)
                            time.sleep(res.retry.backoff(attempt))
                            serve(idx, attempt + 1)
                            return
                        for i in idx:
                            fail(loaded[i][0].path, "clean", exc)
                        return
                    # kept without its traceback, whose frames hold the
                    # failed attempt's tensors
                    oom = exc.with_traceback(None)
                else:
                    for i, r in zip(idx, out):
                        results[i] = r
                    return
                # OOM, handled outside the except block, so the allocator
                # can give the failed attempt's blocks back
                _empty_device_cache(config)
                if len(idx) == 1:
                    fail(loaded[idx[0]][0].path, "clean", oom)
                    return
                # halve the batch: a batch is bit-equal to its single
                # cleans
                reg.counter_inc("fleet_oom_splits")
                if espan is not None:
                    espan.event("oom_split", n=len(idx))
                mid = len(idx) // 2
                serve(idx[:mid])
                serve(idx[mid:])

            t0 = time.perf_counter()
            inline_compiles = 0
            if not ready:
                # the inline warm-up: no precompiler, or its warm-up of
                # this bucket failed.  One that fails here leaves the
                # clean to meet the same fault
                stats: Dict[str, object] = {}
                try:
                    nsub, nchan, nbin, ded = bucket.key
                    warm_bucket(config, nsub, nchan, nbin, ded,
                                bucket.batch_dim, registry=reg,
                                stats_out=stats)
                    inline_compiles = int(bool(stats.get("fresh")))
                except Exception:  # noqa: BLE001 -- counted; the clean below meets the same fault and fails its archives
                    reg.counter_inc("fleet_warm_errors")
            serve(list(range(len(loaded))))
            dt = time.perf_counter() - t0
            if espan is not None:
                espan.set("compiles", inline_compiles)
                espan.end("ok" if all(r is not None for r in results)
                          else "failed")
            if inline_compiles:
                # the warm-up pass counted its own warm-ups; an inline one
                # counts here — never both for one bucket
                reg.counter_inc("fleet_compiles", inline_compiles)
                reg.counter_inc("fleet_compile_misses")
                reg.histogram_observe("fleet_group_compile_s", dt,
                                      buckets=SECONDS)
            else:
                reg.counter_inc("fleet_compile_hits")
                reg.histogram_observe("fleet_group_execute_s", dt,
                                      buckets=SECONDS)
            for i, (it, ar) in enumerate(loaded):
                r = results[i]
                if r is None:
                    continue
                report.results[it.path] = r
                if write_fn is not None:
                    write_futs.append(
                        (it, write_pool.submit(write_task, it.path, ar, r)))
                elif journal_unwritten and res.journal is not None:
                    res.journal.record_done(
                        it.path, config_hash=cfg_hash,
                        out_path=out_path_fn(it.path) if out_path_fn
                        else None, trace=done_trace)
            if gspan is not None:
                gspan.end()
        for it, fut in write_futs:
            try:
                fut.result()
            except Exception as exc:
                # write-back is non-fatal per archive: the cleans are done
                # and the rest of the fleet's outputs must still land
                reg.counter_inc("fleet_write_failures")
                fail(it.path, "write", exc)
