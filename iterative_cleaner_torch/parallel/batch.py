"""Batched cleaning of equal-shaped archives: B archives cleaned as one
batch on the card, optionally split over the ranks of a
``torch.distributed`` job (a ('batch',) mesh).

The port's counterpart of ``iterative_cleaner_tpu/parallel/batch.py``
(``check_equal_shapes``, ``stack_archive_batch``, ``unpack_batch_results``
and ``clean_archives_batched``).  Where the reference ``jax.vmap``s its
clean and the Pallas kernels' ``custom_vmap`` rules fold the batch into
each launch's grid, the port stacks the archives along a leading batch
dimension and runs :func:`~iterative_cleaner_torch.engine.loop.
prepare_batch` and :func:`~iterative_cleaner_torch.engine.loop.
clean_loop_batch`: each iteration launches each of the route's kernels
once for the whole batch.  Each archive's result is that of a clean of it
alone: masks, loops, convergence, per-loop counts and scores equal,
bit for bit (the template stage runs each archive's tensor ops at one
archive's shapes).  Under ``compute_dtype='bfloat16'`` (resolved with
``stage='batch'``) the stacked resident cubes are bf16, each archive's
narrowed after its float32 preamble, and the folded K1, K2, K6 and K7
launches read them.

On a ('batch',) mesh (:func:`~iterative_cleaner_torch.parallel.mesh.
batch_mesh`) the batch is zero-weight padded to a multiple of the ranks,
each rank cleans its contiguous share, and the results go to rank 0
(``BatchMesh.fetch``); no collective crosses archives.

The fleet (:mod:`~iterative_cleaner_torch.parallel.fleet`) also calls
:func:`warm_bucket`, the port's counterpart of the reference's
``precompile_batched_executable``.  The port compiles no program per
shape: what a bucket needs before its first launch is the kernel library
(``nvcc``, once per source digest and build directory), so that is what
:func:`warm_bucket` makes ready, behind a memo keyed as the reference's
program label is.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import List, Optional, Sequence, Set

import numpy as np
import torch

from iterative_cleaner_torch.backends.base import CleanResult, apply_bad_parts
from iterative_cleaner_torch.backends.torch_backend import (
    clean_device,
    config_compute_dtype,
)
from iterative_cleaner_torch.config import CleanConfig
from iterative_cleaner_torch.engine.loop import (
    BatchOutputs,
    clean_loop_batch,
    prepare_batch,
)

# the fields of BatchOutputs a result is unpacked from, in the order the
# mesh gathers them
_RESULT_FIELDS = ("final_weights", "scores", "loops", "converged",
                  "loop_diffs", "loop_rfi_frac", "iter_metrics")


def check_equal_shapes(archives: Sequence) -> None:
    """``ValueError`` unless every archive has one (nsub, nchan, nbin)
    and one DEDISP state: both fix the batch's route and shapes."""
    shapes = {(a.nsub, a.nchan, a.nbin) for a in archives}
    if len(shapes) != 1:
        raise ValueError(
            f"batched cleaning needs equal-shaped archives, got {shapes}; "
            "bucket by shape first (parallel.streaming handles ragged time "
            "axes)")
    if len({bool(a.dedispersed) for a in archives}) != 1:
        raise ValueError(
            "batched cleaning needs a homogeneous dedispersed flag (the "
            "forward rotation is chosen per batch); split the batch by "
            "Archive.dedispersed first")


def stack_archive_batch(archives: Sequence, pad: int, device, like=None,
                        dtype=np.float32):
    """The batch's inputs on ``device``, stacked along a leading batch
    axis with ``pad`` trailing zero-weight slots: ``(cubes, weights,
    freqs, dms, refs, periods)`` as tensors of ``dtype`` (float32, or
    float64 under ``dtype='float64'``), and the bytes uploaded.  Each
    archive's total-intensity cube is converted straight into its slot of
    one host buffer (never a stack of the float64 cubes), which is
    uploaded once.  The pad slots' cube and
    weights are 0, their frequencies, reference frequency and period 1
    and their DM 0, so their dispersion shifts are exactly zero and they
    clean trivially.  ``like`` gives the shape where ``archives`` is
    empty (a mesh rank whose share is all padding)."""
    nb = len(archives) + pad
    like = archives[0] if archives else like
    nsub, nchan, nbin = like.nsub, like.nchan, like.nbin
    cubes = np.zeros((nb, nsub, nchan, nbin), dtype=dtype)
    weights = np.zeros((nb, nsub, nchan), dtype=dtype)
    freqs = np.ones((nb, nchan), dtype=dtype)
    meta = np.zeros((3, nb), dtype=np.float64)   # dm, ref freq, period
    meta[1:, len(archives):] = 1.0
    for b, a in enumerate(archives):
        np.copyto(cubes[b], a.total_intensity(), casting="unsafe")
        weights[b] = a.weights
        freqs[b] = a.freqs_mhz
        meta[:, b] = (a.dm, a.centre_freq_mhz, a.period_s)
    host = (cubes, weights, freqs, *meta.astype(dtype))
    return (tuple(torch.from_numpy(np.ascontiguousarray(x)).to(device)
                  for x in host),
            sum(int(x.nbytes) for x in host))


def unpack_batch_results(outs, n: int, config: CleanConfig
                         ) -> List[CleanResult]:
    """Per-archive :class:`CleanResult` from a batch's outputs (host
    arrays or tensors of :data:`_RESULT_FIELDS`, each with a leading batch
    dimension; slots past ``n``, the padding, dropped), each with the
    whole-line sweep applied."""
    host = {k: np.asarray(torch.as_tensor(getattr(outs, k)).cpu())
            for k in _RESULT_FIELDS}
    results = []
    for i in range(n):
        loops = int(host["loops"][i])
        results.append(apply_bad_parts(CleanResult(
            final_weights=host["final_weights"][i],
            scores=host["scores"][i],
            loops=loops,
            converged=bool(host["converged"][i]),
            loop_diffs=host["loop_diffs"][i][:loops],
            loop_rfi_frac=host["loop_rfi_frac"][i][:loops],
            iter_metrics=host["iter_metrics"][i][:loops]), config))
    return results


def _clean_stack(archives, pad, like, config: CleanConfig, device,
                 registry) -> BatchOutputs:
    """Upload, preamble and loop of one batch (``pad`` trailing pad
    slots; ``like`` an archive of the batch's shape and DEDISP state) on
    ``device``."""
    (cubes, weights, freqs, dms, refs, periods), nbytes = \
        stack_archive_batch(archives, pad, device, like,
                            np.float64 if config.dtype == "float64"
                            else np.float32)
    if registry is not None:
        registry.counter_inc("batch_h2d_bytes", nbytes)
    prep = prepare_batch(
        cubes, weights, freqs, dms, refs, periods, config,
        dedispersed=bool(like.dedispersed),
        compute_dtype=config_compute_dtype(config, "batch", device,
                                           registry))
    del cubes   # the route's resident cubes hold what it reads
    return clean_loop_batch(
        prep, weights, max_iter=config.max_iter,
        chanthresh=config.chanthresh, subintthresh=config.subintthresh,
        rotation=config.rotation, baseline_duty=config.baseline_duty)


def clean_archives_batched(archives: Sequence, config: CleanConfig,
                           mesh=None, registry=None
                           ) -> Optional[List[CleanResult]]:
    """Clean equal-shaped archives as one batch on ``config.device``:
    one list of :class:`CleanResult`, in the archives' order.

    ``mesh`` (a :class:`~iterative_cleaner_torch.parallel.mesh.BatchMesh`)
    splits the batch over the ranks of the process group: every rank
    passes the same archives, the batch is padded with zero-weight
    archives to a multiple of the ranks, each rank cleans its contiguous
    share on its own device, and rank 0 gathers the results (the other
    ranks return None).  ``registry`` (a telemetry registry) receives the
    bytes this call uploaded as ``batch_h2d_bytes``, the archives as
    ``batch_archives`` and the kernel library builds this call ran as
    ``kernel_library_builds``.  The residual (``unload_res``) and the
    weight history (``record_history``) are not batched, nor is the numpy
    oracle: ``ValueError``.  ``dtype='float64'`` uploads float64 and
    launches every kernel's float64 build for the whole batch."""
    if config.backend != "torch":
        raise ValueError("the batched clean requires the torch backend")
    if not archives:
        return []
    n = len(archives)
    device = _check_batch(archives, config, mesh, registry)
    with _counting_builds(registry):
        if mesh is None:
            outs = _clean_stack(archives, 0, archives[0], config, device,
                                registry)
            return unpack_batch_results(outs, n, config)
        outs = _clean_share(archives, config, mesh, registry)
        # (converged as int32: not every backend gathers bool tensors)
        parts = {k: mesh.fetch(getattr(outs, k).to(torch.int32)
                               if k == "converged" else getattr(outs, k))
                 for k in _RESULT_FIELDS}
    if mesh.rank != 0:
        return None
    gathered = BatchOutputs(**{k: torch.cat(v) for k, v in parts.items()},
                            template_weights=None, history=None)
    return unpack_batch_results(gathered, n, config)


def _check_batch(archives, config: CleanConfig, mesh, registry):
    """The batch's checks (config, shapes, the mesh's device type), its
    ``batch_archives`` count, and the device it runs on."""
    if config.backend != "torch":
        raise ValueError("the batched clean requires the torch backend")
    if config.unload_res or config.record_history:
        raise ValueError(
            "unload_res/record_history are not supported on the batched "
            "path (residual cubes and weight histories are not batched); "
            "clean archive by archive for those outputs")
    check_equal_shapes(archives)
    device = clean_device(config)
    if mesh is not None and device.type != mesh.device.type:
        raise ValueError(f"config.device {config.device!r} and the "
                         f"rank's device {mesh.device} differ in type")
    if registry is not None:
        registry.counter_inc("batch_archives", len(archives))
    return device


@contextlib.contextmanager
def _counting_builds(registry):
    """The kernel library builds run inside, counted as
    ``kernel_library_builds`` however the block ends."""
    from iterative_cleaner_torch.stats import kernels

    builds0 = kernels.library_builds()
    try:
        yield
    finally:
        built = kernels.library_builds() - builds0
        if registry is not None and built:
            registry.counter_inc("kernel_library_builds", built)


def _clean_share(archives, config: CleanConfig, mesh,
                 registry) -> BatchOutputs:
    """This rank's contiguous share of the zero-weight padded batch,
    cleaned on its device."""
    _, start, stop = mesh.share(len(archives))
    mine = list(archives[start:stop])
    return _clean_stack(mine, stop - start - len(mine), archives[0], config,
                        mesh.device, registry)


def clean_batch_share(archives: Sequence, config: CleanConfig, mesh,
                      registry=None) -> dict:
    """This rank's share of :func:`clean_archives_batched` over
    ``mesh``, without the gather: the :data:`_RESULT_FIELDS` of its slots
    of the padded batch as host arrays, with the same checks and counts.
    The fleet exchanges them over the mesh's side group (with its
    timeout) once every rank's clean is known to have succeeded; the
    shares, concatenated in rank order, are what
    :func:`unpack_batch_results` takes."""
    _check_batch(archives, config, mesh, registry)
    with _counting_builds(registry):
        outs = _clean_share(archives, config, mesh, registry)
        return {k: np.asarray(getattr(outs, k).cpu())
                for k in _RESULT_FIELDS}


# ------------------------------------------------------------ bucket warm-up

# The warm-up memo: the program labels this process has warmed.  The
# library, once loaded, stays loaded, so an entry never goes stale.
_WARMED: Set[tuple] = set()
_WARMED_LOCK = threading.Lock()


def clear_warm_memo() -> None:
    """Forget every warmed label (test isolation)."""
    with _WARMED_LOCK:
        _WARMED.clear()


def _program_label(config: CleanConfig, nsub: int, nchan: int, nbin: int,
                   dedispersed: bool, batch_dim: int, device: str) -> tuple:
    """The memo key of a bucket: the reference's program label (the
    resolved route knobs, the geometry, the batch) plus the device."""
    return (config.rotation, config.stats_frame, config.baseline_mode,
            config.pulse_region_active, config.dtype,
            config.compute_dtype, bool(dedispersed), int(batch_dim),
            int(nsub), int(nchan), int(nbin), str(device))


def bucket_program(config: CleanConfig, nsub: int, nchan: int, nbin: int,
                   dedispersed: bool, batch_dim: int) -> str:
    """The roofline profiler's name of a bucket's batch iteration
    (``telemetry/profiling.py``): ``fleet_bucket/<route>/<nsub>x<nchan>x
    <nbin>x<batch>``, with ``/bf16`` or ``/f64`` for those storages."""
    from iterative_cleaner_torch.engine.loop import select_route

    name = "fleet_bucket/%s/%dx%dx%dx%d" % (
        select_route(config, dedispersed), int(nsub), int(nchan), int(nbin),
        int(batch_dim))
    cube_bytes = _cube_bytes(config)
    return name + {2: "/bf16", 8: "/f64"}.get(cube_bytes, "")


def _cube_bytes(config: CleanConfig) -> int:
    """A cube element's bytes under ``config``: 8 in float64, 2 in bf16
    storage (the config's or ``ICLEAN_COMPUTE_DTYPE``'s), else 4."""
    import os

    if config.dtype == "float64":
        return 8
    cd = config.compute_dtype or os.environ.get("ICLEAN_COMPUTE_DTYPE", "")
    return 2 if cd == "bfloat16" else 4


def warm_bucket(config: CleanConfig, nsub: int, nchan: int, nbin: int,
                dedispersed: bool, batch_dim: int, *, registry=None,
                stats_out: Optional[dict] = None) -> None:
    """Make one bucket ready to launch: on the card, the kernel library
    built (into the configured build directory, if its digest is not
    there yet) and loaded, and the device's context made; on the CPU the
    plain versions need nothing.
    The DFT tables are the clean's to make, at its first launch.
    Memoized per :func:`_program_label`: a fresh warm-up counts
    ``batch_compiles`` once and each ``nvcc`` run
    ``kernel_library_builds``, and captures the bucket's batch iteration
    as a profiler program (:func:`bucket_program`: its route's kernels'
    modelled cost at the bucket's shapes and batch).  ``stats_out`` (a
    dict) receives ``fresh`` and ``library_builds``."""
    from iterative_cleaner_torch.engine.loop import (
        ROUTE_KERNELS,
        select_route,
        spectrum_kernels,
    )
    from iterative_cleaner_torch.stats import kernels
    from iterative_cleaner_torch.telemetry import profiling

    device = clean_device(config)
    key = _program_label(config, nsub, nchan, nbin, dedispersed, batch_dim,
                         str(device))
    with _WARMED_LOCK:
        fresh = key not in _WARMED
    built = 0
    if fresh:
        t0 = time.perf_counter()
        builds0 = kernels.library_builds()
        if device.type == "cuda":
            kernels.load_library()
            # the device's context too: made here, not inside the first
            # clean's watchdog deadline
            torch.zeros(1, device=device)
        built = kernels.library_builds() - builds0
        with _WARMED_LOCK:
            _WARMED.add(key)
        warm_s = time.perf_counter() - t0
        profiling.capture_compiled(
            bucket_program(config, nsub, nchan, nbin, dedispersed,
                           batch_dim),
            profiling.program_costs(
                spectrum_kernels(
                    ROUTE_KERNELS[select_route(config, dedispersed)], nbin,
                    config.dtype), nsub, nchan, nbin,
                cube_bytes=_cube_bytes(config), batch=batch_dim),
            registry=registry, compile_s=warm_s, dtype=config.dtype)
        if registry is not None:
            from iterative_cleaner_torch.telemetry.registry import SECONDS

            registry.counter_inc("batch_compiles")
            if built:
                registry.counter_inc("kernel_library_builds", built)
            registry.histogram_observe("batch_precompile_s", warm_s,
                                       buckets=SECONDS)
    if stats_out is not None:
        stats_out["fresh"] = fresh
        stats_out["library_builds"] = built


def record_builder_cache_stats(registry) -> None:
    """The port's caches as registry gauges: the DFT table cache (size
    and bound), the warm-up memo, and the cell kernels' plan cache hits
    and misses."""
    from iterative_cleaner_torch.stats import kernels

    tables = kernels._dft_tables_padded.cache_info()
    registry.gauge_set("dft_tables_cache_size", tables.currsize)
    registry.gauge_set("dft_tables_cache_maxsize", tables.maxsize)
    with _WARMED_LOCK:
        registry.gauge_set("bucket_warm_memo_size", len(_WARMED))
    info = kernels.cell_stats_geometry.cache_info()
    registry.gauge_set("cell_plan_cache_hits", info.hits)
    registry.gauge_set("cell_plan_cache_misses", info.misses)
