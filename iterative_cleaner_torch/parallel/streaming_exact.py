"""Exact streaming: whole-archive semantics in subint tiles, for archives
larger than the card.

The prepared tiles live in host memory; the card holds what the tile
cache's byte budget allows (:mod:`iterative_cleaner_torch.parallel.
tile_cache`).  Each iteration makes two passes over the tiles:

- **Template.**  The template is a global weighted sum, so pass 1
  accumulates per-tile partials (:func:`~iterative_cleaner_torch.engine.
  loop.template_partial`: K1's channel profiles and the correction
  numerator from its totals on the default route; the weighted numerator
  and, under the integration baseline, the raw tile's correction
  numerator on the others) on the device, in float32, in tile order, and
  :func:`~iterative_cleaner_torch.engine.loop.assemble_template` divides
  by the full weight plane's sum.
- **Diagnostics.**  The four diagnostics reduce only the bin axis, so
  pass 2 runs the route's cell-diagnostics kernel (K2, K7 or K6) per
  tile, each writing its rows of four full (nsub, nchan) planes on the
  device in place (the kernels' ``out=``): no concatenation, no round
  trip through the host.
- **Combine.**  K8 (:func:`~iterative_cleaner_torch.stats.kernels.
  fused_combine`) runs the scalers, the 4-way median and the zap on the
  full planes, so the scalers see every subint, as in a whole clean; the
  cycle check runs on the host against the whole weight history.

The route is :func:`~iterative_cleaner_torch.engine.loop.select_route`'s,
as for a whole clean; the prepared tile is ``disp_clean`` on the default
route and ``ded`` on the others.  The routes other than the default
under the integration baseline also keep the raw tiles (their template
correction smooths the current weights' raw totals): two host copies and
a third upload per tile per pass 1.  The two_read route rebuilds its
residual base per tile in pass 2.

The host backing store is one buffer (pinned on the card), allocated
once per clean; the raw cube is converted from float64 to float32 one
tile at a time.  At budget 0 (an archive larger than the card) every
pass uploads every tile, at most a few tiles are on the card at once
(``pipelined_sweep`` at depth 1, each drain waiting for its tile's
event), and the card uploads the cube ``1 + 2 * loops`` times on the
default route; under a budget that holds every tile, once.

Masks equal the whole clean's: every per-cell quantity is computed by
the same code on the same inputs, and only the template's cross-tile
sum is regrouped (K1 also sums its 64-subint partials per tile), which
may move the template by an ulp; masks are the contract.

Not ported from the reference (``iterative_cleaner_tpu/parallel/
streaming_exact.py``): ``_clean_exact_numpy`` (its numpy oracle: the
port's CPU path is its plain versions); ``_warm_tile_programs`` and
``_host_parallelism`` (XLA compile warm-up: torch compiles nothing);
the padding of the final tile, which let every tile share one compiled
program.  A ``mesh`` is refused (ROADMAP.md item 7).
"""

from __future__ import annotations

import time
from typing import List

import numpy as np
import torch

from iterative_cleaner_torch.backends.base import CleanResult, apply_bad_parts
from iterative_cleaner_torch.backends.torch_backend import (
    clean_device,
    upload,
    upload_meta,
)
from iterative_cleaner_torch.config import ROADMAP_MESH, CleanConfig
from iterative_cleaner_torch.engine.loop import (
    assemble_template,
    prepare,
    residual_std,
    route_diagnostics,
    select_route,
    template_partial,
    tile_prepared,
)
from iterative_cleaner_torch.parallel.tile_cache import (
    CopyStream,
    TileCache,
    host_copy,
    pipelined_sweep,
    resolve_budget_bytes,
)
from iterative_cleaner_torch.stats.kernels import fused_combine


# the torch.profiler range of each iteration
STREAM_ITERATION = "icln_stream_iteration"

# rows of the host store
_PREP, _RAW = 0, 1


def _tile_slices(nsub: int, chunk: int) -> List[slice]:
    return [slice(s, min(s + chunk, nsub)) for s in range(0, nsub, chunk)]


def _run_iterations(orig_weights, config: CleanConfig, step) -> CleanResult:
    """The host's convergence driver.

    ``step(cur_weights) -> (new_weights, scores[, aux])`` is one whole
    iteration (both passes and the combine) on host arrays; ``aux`` is
    the ``(residual_std, template_peak)`` pair of the telemetry rows.  As
    the whole clean: the history seeded with the original weights (the
    float32 values the card computes with, so the first cycle check can
    match), cycle detection against every earlier matrix, loops set on
    convergence or exhaustion."""
    history = [orig_weights.copy()]
    cur = orig_weights
    scores = np.zeros_like(orig_weights)
    converged = False
    loops = config.max_iter
    loop_diffs, loop_rfi, iter_rows = [], [], []
    for x in range(1, config.max_iter + 1):
        out = step(cur)
        new_w, scores = out[0], out[1]
        aux = out[2] if len(out) > 2 else (np.nan, np.nan)
        loop_diffs.append(int(np.sum(new_w != cur)))
        loop_rfi.append(float(np.mean(new_w == 0)))
        iter_rows.append((float(np.sum(new_w == 0)),
                          float(np.sum((new_w == 0) != (cur == 0))),
                          float(aux[0]), float(aux[1])))
        if any(np.array_equal(new_w, old) for old in history):
            converged, loops, cur = True, x, new_w
            history.append(new_w)
            break
        history.append(new_w)
        cur = new_w
    return CleanResult(
        final_weights=cur, scores=scores, loops=loops, converged=converged,
        loop_diffs=np.asarray(loop_diffs),
        loop_rfi_frac=np.asarray(loop_rfi),
        weight_history=np.stack(history) if config.record_history else None,
        iter_metrics=np.asarray(iter_rows, dtype=np.float32).reshape(
            len(iter_rows), 4),
    )


def _tile_event(device, timing=False):
    """A CUDA event recorded after the work enqueued so far on the
    compute stream (None on the CPU, whose work is done on return)."""
    if device.type != "cuda":
        return None
    event = torch.cuda.Event(enable_timing=timing)
    event.record(torch.cuda.current_stream(device))
    return event


def _clean_exact(cube, weights, freqs_mhz, dm, ref_freq_mhz, period_s,
                 config: CleanConfig, tiles, dedispersed,
                 registry=None) -> CleanResult:
    device = clean_device(config)
    on_card = device.type == "cuda"
    route = select_route(config, dedispersed)
    integration = config.baseline_mode == "integration"
    keep_raw = integration and route != "default"
    rotation = config.rotation
    nsub, nchan, nbin = cube.shape
    n_tiles = len(tiles)
    uploader = CopyStream(device) if on_card else host_copy
    cache = TileCache(resolve_budget_bytes(config.stream_hbm_mb, device),
                      uploader, registry=registry)

    def gauge(name, value):
        cache.registry.gauge_set(f"stream_{name}", value)

    # the host backing store: the prepared tiles (and the raw ones), one
    # buffer for the clean, pinned on the card so the uploads are
    # asynchronous
    t0 = time.perf_counter()
    store = torch.empty((2 if keep_raw else 1, nsub, nchan, nbin),
                        dtype=torch.float32, pin_memory=on_card)
    gauge("host_store_alloc_ms", (time.perf_counter() - t0) * 1e3)

    # the (nsub, nchan) planes stay on the device: nbin times smaller
    # than the cube
    orig32 = np.ascontiguousarray(weights, dtype=np.float32)
    orig_w_d = upload(orig32, device)
    cache.count_h2d(orig32.nbytes)
    cell_mask_d = orig_w_d == 0
    meta = upload_meta(freqs_mhz, dm, ref_freq_mhz, period_s, device)
    offsets_d = torch.empty((nsub, nchan), dtype=torch.float32,
                            device=device) if integration else None
    planes = [torch.empty((nsub, nchan), dtype=torch.float32, device=device)
              for _ in range(4)]

    def tile_bytes(sl):
        return (sl.stop - sl.start) * nchan * nbin * 4

    # the residency plan: the prepared tiles (two uploads per iteration
    # saved each), then the raw ones (one)
    plan = [(("prep", i), tile_bytes(sl)) for i, sl in enumerate(tiles)]
    if keep_raw:
        plan += [(("raw", i), tile_bytes(sl)) for i, sl in enumerate(tiles)]
    depth = n_tiles if cache.plan(plan) else 1

    # the preamble, tile by tile: every step of it is local to a subint
    t0 = time.perf_counter()
    shifts = window = None
    for i, sl in enumerate(tiles):
        slot = store[_RAW if keep_raw else _PREP, sl]
        slot.numpy()[...] = cube[sl]     # float64 -> float32, one tile
        raw_key = ("raw", i) if keep_raw else None
        raw_d = cache.get(raw_key, slot, cube=True)
        # the preamble subtracts in place: a pinned raw tile stays raw
        work = raw_d.clone() if keep_raw and cache.holds(raw_key) else raw_d
        p = prepare(work, orig_w_d[sl], *meta, config,
                    dedispersed=dedispersed, residual_base=False)
        tile_d = p.disp_base if route == "default" else p.ded
        shifts, window = p.back_shifts, p.window
        if integration:
            offsets_d[sl] = p.base_offsets
        # the host copy (a synchronous D2H: the preamble's per-tile sync)
        store[_PREP, sl].copy_(tile_d)
        cache.count_d2h(tile_bytes(sl))
        cache.adopt(("prep", i), tile_d, tile_bytes(sl))
        cache.mark_sync()
        del p, work, raw_d, tile_d
    gauge("prep_ms", (time.perf_counter() - t0) * 1e3)

    def host_tile(row, i):
        return store[row, tiles[i]]

    # the device copy of the host weights the next step starts from
    mirror = [orig32, orig_w_d]
    step_ms, pass_ms = [], []

    def step(cur):
        with torch.profiler.record_function(STREAM_ITERATION):
            return timed_step(cur)

    def timed_step(cur):
        t_step = time.perf_counter()
        marks = [_tile_event(device, timing=True)]
        if cur is mirror[0]:
            cur_d = mirror[1]
        else:
            cur_d = upload(cur, device)
            cache.count_h2d(cur.nbytes)
        acc = {}

        # pass 1: the template's partials, accumulated in tile order
        def put_template(i):
            ins = [cache.get(("prep", i), host_tile(_PREP, i), cube=True)]
            if keep_raw:
                ins.append(cache.get(("raw", i), host_tile(_RAW, i),
                                     cube=True))
            return ins

        def run_template(i, ins):
            sl = tiles[i]
            part = template_partial(
                route, ins[0], cur_d[sl],
                None if offsets_d is None else offsets_d[sl],
                ins[1] if keep_raw else None,
                baseline_duty=config.baseline_duty)
            return part, _tile_event(device)

        def drain_template(i, out):
            (num, corr), event = out
            acc["num"] = num if i == 0 else acc["num"] + num
            acc["corr"] = corr if i == 0 or corr is None \
                else acc["corr"] + corr
            cache.mark_sync(event)

        pipelined_sweep(n_tiles, put_template, run_template, drain_template,
                        depth=depth)
        template = assemble_template(route, acc["num"], acc["corr"], cur_d,
                                     shifts, rotation=rotation)
        marks.append(_tile_event(device, timing=True))

        # pass 2: each tile's kernel writes its rows of the full planes
        def put_diag(i):
            return cache.get(("prep", i), host_tile(_PREP, i), cube=True)

        def run_diag(i, tile_d):
            sl = tiles[i]
            route_diagnostics(
                tile_prepared(route, tile_d, shifts, window,
                              rotation=rotation),
                template, orig_w_d[sl], cell_mask_d[sl], rotation=rotation,
                out=[p[sl] for p in planes])
            return _tile_event(device)

        def drain_diag(i, event):
            cache.mark_sync(event)

        pipelined_sweep(n_tiles, put_diag, run_diag, drain_diag, depth=depth)
        marks.append(_tile_event(device, timing=True))

        new_w_d, scores_d = fused_combine(planes, cell_mask_d, orig_w_d,
                                          config.chanthresh,
                                          config.subintthresh)
        rstd = residual_std(planes[0], cell_mask_d)
        tpeak = torch.max(template)
        marks.append(_tile_event(device, timing=True))
        new_w = new_w_d.cpu().numpy()
        scores = scores_d.cpu().numpy()
        cache.count_d2h(new_w.nbytes + scores.nbytes)
        cache.mark_sync()   # the fetches synchronised the iteration
        mirror[:] = [new_w, new_w_d]
        step_ms.append((time.perf_counter() - t_step) * 1e3)
        if on_card:   # the fetches above completed every mark
            pass_ms.append([a.elapsed_time(b)
                            for a, b in zip(marks, marks[1:])])
        return new_w, scores, (float(rstd), float(tpeak))

    result = _run_iterations(orig32, config, step)
    gauge("iteration_ms", float(np.mean(step_ms)))
    if on_card:
        gauge("pass_ms_by_iteration", pass_ms)
        nbytes, ms = uploader.transfer()
        gauge("h2d_copy_bytes", nbytes)
        gauge("h2d_copy_ms", ms)
    cache.flush_stats()
    return result


def clean_streaming_exact(archive, chunk_nsub: int, config: CleanConfig,
                          mesh=None, registry=None) -> CleanResult:
    """Clean an archive in ``chunk_nsub``-subint tiles with whole-archive
    semantics on ``config.device``: masks equal to :func:`~iterative_
    cleaner_torch.backends.clean_archive`'s.  ``registry`` (anything with
    ``counter_inc``/``gauge_set``) receives the tile cache's transfer
    counters (``stream_h2d_bytes``, ``stream_h2d_cube_bytes``,
    ``stream_d2h_bytes``, hits, misses, residency gauges) and the
    clean's times: ``stream_host_store_alloc_ms``, ``stream_prep_ms``
    and ``stream_iteration_ms`` (host clock, each ending in a sync); on
    the card ``stream_pass_ms_by_iteration``, the compute stream's spans
    of the template pass, the diagnostics pass and the combine in each
    iteration (CUDA events, the waits for uploads included), and
    ``stream_h2d_copy_bytes`` and ``stream_h2d_copy_ms`` (every upload's
    bytes and the copy stream's event time of the copies).
    Each iteration is a ``torch.profiler`` range named
    ``icln_stream_iteration``."""
    if config.unload_res:
        raise ValueError(
            "unload_res is not supported in exact streaming mode (the "
            "residual cube is never materialised whole); use mode='online' "
            "or whole-archive cleaning")
    if mesh is not None:
        raise NotImplementedError(
            f"exact streaming over a device mesh is not ported yet: "
            f"{ROADMAP_MESH}")
    if chunk_nsub <= 0:
        raise ValueError(f"chunk_nsub must be positive, got {chunk_nsub}")
    cube = archive.total_intensity()
    tiles = _tile_slices(cube.shape[0], int(chunk_nsub))
    result = _clean_exact(
        cube, archive.weights, archive.freqs_mhz, archive.dm,
        archive.centre_freq_mhz, archive.period_s, config, tiles,
        archive.dedispersed, registry=registry)
    return apply_bad_parts(result, config)
