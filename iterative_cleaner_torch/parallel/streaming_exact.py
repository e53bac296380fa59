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
  numerator on the others) on the device, in the engine's dtype, in
  tile order, and
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
tile at a time (under ``dtype='float64'`` the store, the uploads and the
tile cache hold float64: 8 bytes a sample, the same budget pinning half
the tiles).  At budget 0 (an archive larger than the card) every
pass uploads every tile, at most a few tiles are on the card at once
(``pipelined_sweep`` at depth 1, each drain waiting for its tile's
event), and the card uploads the cube ``1 + 2 * loops`` times on the
default route; under a budget that holds every tile, once.

Mixed precision (``compute_dtype='bfloat16'``) follows the reference's
streaming quantization points, which are not the whole clean's: every
raw tile is converted from the host's float64 to bf16 (as ml_dtypes'
``astype`` rounds: through float32) before its upload, upcast on the
device for the float32 preamble, and the prepared tile is narrowed to
bf16; the host store, the uploads and the tile cache hold bf16, so the
cube bytes uploaded halve and the same budget pins twice the tiles.  The
two_read route's residual base is built in float32 from the upcast tile.

Masks equal the whole clean's: every per-cell quantity is computed by
the same code on the same inputs, and only the template's cross-tile
sum is regrouped (K1 also sums its 64-subint partials per tile), which
may move the template by an ulp; masks are the contract.

Over a cell ``mesh`` (the reference's streamed shard route, its
``_clean_exact_jax(mesh=...)``) each rank holds, uploads and prepares
only its (subint, channel) block of every tile: the template's partials
come from the route's kernels on the block and cross ranks in rank
order (:mod:`iterative_cleaner_torch.parallel.mesh`), each tile's four
diagnostic blocks are gathered into the tile's rows of the whole
planes, which every rank holds, and K8 runs on those replicated planes,
so every rank computes the same new weights and the masks are the
single-card stream's.  Each mesh axis must divide the tile grid (a
final partial tile is padded with zero-weight subints up to the 'sub'
axis); the tile cache's budget is 0 (every tile uploaded each pass, the
two-tile lookahead), as in the reference.  Rank 0 returns the result,
the other ranks None.

``backend='numpy'`` streams on the float64 numpy oracle
(:func:`_clean_exact_numpy`, the reference's, on the host).

Not ported from the reference (``iterative_cleaner_tpu/parallel/
streaming_exact.py``): ``_warm_tile_programs`` and
``_host_parallelism`` (XLA compile warm-up: torch compiles nothing);
the padding of the final tile to the full tile, which let every tile
share one compiled program.
"""

from __future__ import annotations

import time
from typing import List, NamedTuple

import numpy as np
import torch

from iterative_cleaner_torch.backends.base import CleanResult, apply_bad_parts
from iterative_cleaner_torch.backends.torch_backend import (
    clean_device,
    config_compute_dtype,
    engine_dtype,
    upload,
    upload_meta,
)
from iterative_cleaner_torch.config import CleanConfig, check_mesh
from iterative_cleaner_torch.engine.loop import (
    assemble_template,
    prepare,
    residual_std,
    route_diagnostics,
    select_route,
    template_partial,
    tile_prepared,
)
from iterative_cleaner_torch.parallel.sharding import check_tile_grid
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


class RankTiles(NamedTuple):
    """This rank's block of every subint tile: the rows of its local
    (n_local, c_loc) planes and host store.  Without a mesh (or on a
    grid of one rank) the block is the whole tile."""

    rows: np.ndarray     # (n_local,) archive subint of each local row, -1: pad
    local: List[slice]   # each tile's local rows
    chans: slice         # the rank's channels
    trivial: bool        # the local planes are the whole planes

    def local_of(self, plane):
        """This rank's rows and channels of a whole (nsub, nchan) host
        array or device tensor, zero on the pad rows (``plane`` itself
        when the layout is trivial)."""
        if self.trivial:
            return plane
        valid = self.rows >= 0
        idx = np.where(valid, self.rows, 0)
        if isinstance(plane, torch.Tensor):
            out = plane[torch.from_numpy(idx).to(plane.device),
                        self.chans].contiguous()
            out[torch.from_numpy(~valid).to(plane.device)] = 0
            return out
        out = np.ascontiguousarray(plane[idx, self.chans])
        out[~valid] = 0
        return out


def rank_tiles(tiles, nsub: int, nchan: int, mesh=None) -> RankTiles:
    """The :class:`RankTiles` of ``mesh``'s rank: tile ``t`` of ``n``
    subints is cut into ``a`` blocks of ``ceil(n / a)`` subints (rank
    (i, j) the i-th), the channels into ``b`` blocks of ``nchan / b``;
    the rows of the last blocks past the tile's end are padding."""
    if mesh is None or tuple(mesh.shape) == (1, 1):
        return RankTiles(np.arange(nsub), list(tiles), slice(0, nchan), True)
    (a, b), (i, j) = mesh.shape, mesh.coords
    rows, local, off = [], [], 0
    for sl in tiles:
        s_loc = -(-(sl.stop - sl.start) // a)
        g = np.arange(sl.start + i * s_loc, sl.start + (i + 1) * s_loc)
        rows.append(np.where(g < sl.stop, g, -1))
        local.append(slice(off, off + s_loc))
        off += s_loc
    c_loc = nchan // b
    return RankTiles(np.concatenate(rows), local,
                     slice(j * c_loc, (j + 1) * c_loc), False)


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


def host_store_tile(dst: torch.Tensor, src) -> None:
    """Write the host float64 (or float32) tile ``src`` into the store's
    ``dst`` (float32, float64 or bf16).  A float64 value goes to bf16 as
    the reference's ml_dtypes ``astype`` takes it: rounded to float32,
    then to bf16 (round to nearest even each time; torch's conversion from
    float64 rounds the same two steps)."""
    src = np.asarray(src)
    if dst.dtype in (torch.float32, torch.float64):
        dst.numpy()[...] = src
    else:
        dst.copy_(torch.from_numpy(np.ascontiguousarray(
            src, dtype=np.float32)))


def _clean_exact_numpy(cube, weights, freqs, dm, ref_freq, period,
                       config: CleanConfig, tiles, dedispersed
                       ) -> CleanResult:
    """Exact streaming on the float64 numpy oracle (the reference's
    ``_clean_exact_numpy``): the prepared tiles in host memory, pass 1
    the template's numerator (and the integration correction's from the
    raw tiles) accumulated in tile order, pass 2 each tile's four
    ``numpy.ma`` diagnostics concatenated, the scalers on the full
    planes."""
    from iterative_cleaner_torch.ops.dsp_numpy import (
        fit_template_amplitudes,
        prepare_cube,
        prepare_cube_integration,
        rotate_bins,
        template_residuals,
        weighted_template_numerator,
    )
    from iterative_cleaner_torch.ops.psrchive_baseline_numpy import (
        template_correction_numerator_raw,
    )
    from iterative_cleaner_torch.stats.masked_numpy import (
        cell_diagnostics_numpy,
        scale_and_combine_numpy,
    )

    cube = np.asarray(cube, dtype=np.float64)
    orig_weights = np.asarray(weights, dtype=np.float64)
    integration = config.baseline_mode == "integration"
    ded_tiles = []
    v_tiles = []  # each tile's consensus offsets (integration mode)
    shifts = None
    for sl in tiles:
        if integration:
            # the consensus window is subint-local, so tiling is exact
            ded_t, shifts, _, v_t = prepare_cube_integration(
                cube[sl], orig_weights[sl], freqs, dm, ref_freq, period,
                baseline_duty=config.baseline_duty,
                rotation=config.rotation, dedispersed=dedispersed)
            v_tiles.append(v_t)
        else:
            ded_t, shifts = prepare_cube(
                cube[sl], freqs, dm, ref_freq, period,
                baseline_duty=config.baseline_duty,
                rotation=config.rotation, dedispersed=dedispersed)
        ded_tiles.append(ded_t)
    cell_mask = orig_weights == 0

    def step(cur):
        # pass 1: the whole template, the partials in tile order
        num = np.zeros(cube.shape[-1], dtype=np.float64)
        for sl, ded_t in zip(tiles, ded_tiles):
            num += weighted_template_numerator(ded_t, cur[sl])
        den = np.sum(cur)
        template = np.zeros_like(num) if den == 0 else num / den
        if integration:
            corr = 0.0
            for sl, v_t in zip(tiles, v_tiles):
                corr += template_correction_numerator_raw(
                    cube[sl], v_t, cur[sl], config.baseline_duty)
            template = template + (0.0 if den == 0 else corr / den)
        template = template * 10000.0

        # pass 2: the cell-local diagnostics per tile, the scalers on the
        # full planes
        diag_tiles = []
        for sl, ded_t in zip(tiles, ded_tiles):
            amps = fit_template_amplitudes(ded_t, template)
            resid = template_residuals(
                ded_t, template, amps, config.pulse_slice,
                config.pulse_scale, config.pulse_region_active)
            resid = rotate_bins(resid, shifts, method=config.rotation)
            weighted = resid * orig_weights[sl][:, :, None]
            diag_tiles.append(
                cell_diagnostics_numpy(weighted, cell_mask[sl]))
        # the first three diagnostics are numpy.ma (their masks survive
        # the concatenation); the rFFT one stays plain, as a whole
        # clean's (np.ma.concatenate would make it masked and move its
        # zero-MAD lines onto the masked path)
        diags = [np.ma.concatenate([t[i] for t in diag_tiles], axis=0)
                 for i in range(3)]
        diags.append(np.concatenate([np.asarray(t[3]) for t in diag_tiles],
                                    axis=0))
        scores = scale_and_combine_numpy(diags, config.chanthresh,
                                         config.subintthresh)
        valid = ~cell_mask
        rstd = (float(np.median(np.ma.getdata(diags[0])[valid]))
                if valid.any() else 0.0)
        return (np.where(scores >= 1.0, 0.0, orig_weights), scores,
                (rstd, float(np.max(template))))

    return _run_iterations(orig_weights, config, step)


def _clean_exact(cube, weights, freqs_mhz, dm, ref_freq_mhz, period_s,
                 config: CleanConfig, tiles, dedispersed,
                 registry=None, mesh=None) -> CleanResult:
    device = clean_device(config)
    if mesh is not None:
        if device.type != mesh.device.type:
            raise ValueError(f"config.device {config.device!r} and the "
                             f"rank's device {mesh.device} differ in type")
        device = mesh.device
    on_card = device.type == "cuda"
    compute_dtype = config_compute_dtype(config, "streaming", device,
                                         registry)
    # the engine's dtype (float32, or float64: the host store, the
    # uploads and the tile cache at 8 bytes a sample), narrowed to bf16
    # for storage in the mixed-precision mode
    real = engine_dtype(config)
    store_dtype = torch.bfloat16 if compute_dtype == "bfloat16" else real
    route = select_route(config, dedispersed)
    integration = config.baseline_mode == "integration"
    keep_raw = integration and route != "default"
    rotation = config.rotation
    nsub, nchan, nbin = cube.shape
    n_tiles = len(tiles)
    lay = rank_tiles(tiles, nsub, nchan, mesh)
    n_local, c_loc = len(lay.rows), lay.chans.stop - lay.chans.start
    uploader = CopyStream(device) if on_card else host_copy
    # on a mesh every tile is uploaded each pass (the reference's budget)
    budget = 0 if mesh is not None else resolve_budget_bytes(
        config.stream_hbm_mb, device)
    cache = TileCache(budget, uploader, registry=registry)

    def gauge(name, value):
        cache.registry.gauge_set(f"stream_{name}", value)

    # the host backing store: the (rank's blocks of the) prepared tiles
    # (and the raw ones), one buffer for the clean, pinned on the card so
    # the uploads are asynchronous
    t0 = time.perf_counter()
    store = torch.empty((2 if keep_raw else 1, n_local, c_loc, nbin),
                        dtype=store_dtype, pin_memory=on_card)
    gauge("host_store_alloc_ms", (time.perf_counter() - t0) * 1e3)

    # the (nsub, nchan) planes stay on the device: nbin times smaller
    # than the cube; on a mesh each rank holds the whole planes the
    # combine reads and the local ones of its blocks
    orig_h = np.ascontiguousarray(
        weights, dtype=np.float64 if real == torch.float64 else np.float32)
    orig_local = lay.local_of(orig_h)
    orig_w_d = upload(orig_local, device, real)
    cache.count_h2d(orig_local.nbytes)
    cell_mask_d = orig_w_d == 0
    whole_w_d = orig_w_d
    if not lay.trivial:
        whole_w_d = upload(orig_h, device, real)
        cache.count_h2d(orig_h.nbytes)
    whole_mask_d = whole_w_d == 0
    meta = upload_meta(np.asarray(freqs_mhz)[lay.chans], dm, ref_freq_mhz,
                       period_s, device, real)
    offsets_d = torch.empty((n_local, c_loc), dtype=real,
                            device=device) if integration else None
    planes = [torch.empty((nsub, nchan), dtype=real, device=device)
              for _ in range(4)]

    def tile_bytes(i):
        sl = lay.local[i]
        return (sl.stop - sl.start) * c_loc * nbin * store.element_size()

    # the residency plan: the prepared tiles (two uploads per iteration
    # saved each), then the raw ones (one)
    plan = [(("prep", i), tile_bytes(i)) for i in range(n_tiles)]
    if keep_raw:
        plan += [(("raw", i), tile_bytes(i)) for i in range(n_tiles)]
    depth = n_tiles if cache.plan(plan) else 1

    # the preamble, tile by tile: every step of it is local to a subint
    # (on a mesh its sums cross the rank's row)
    t0 = time.perf_counter()
    shifts = window = None
    for i, lsl in enumerate(lay.local):
        slot = store[_RAW if keep_raw else _PREP, lsl]
        rows = lay.rows[lsl]
        n_real = int(np.sum(rows >= 0))   # the pad rows come last
        # float64 -> the store's dtype, one tile (block)
        host_store_tile(slot[:n_real],
                        cube[rows[0]:rows[0] + n_real, lay.chans])
        slot[n_real:] = 0
        raw_key = ("raw", i) if keep_raw else None
        raw_d = cache.get(raw_key, slot, cube=True)
        # the preamble subtracts in place: a pinned raw tile stays raw
        # (a bf16 one is upcast into a new float32 tile)
        work = raw_d.clone() if keep_raw and cache.holds(raw_key) \
            and store_dtype == real else raw_d.to(real)
        p = prepare(work, orig_w_d[lsl], *meta, config,
                    dedispersed=dedispersed, residual_base=False, mesh=mesh)
        tile_d = p.disp_base if route == "default" else p.ded
        tile_d = tile_d.to(store_dtype)
        shifts, window = p.back_shifts, p.window
        if integration:
            offsets_d[lsl] = p.base_offsets
        # the host copy (a synchronous D2H: the preamble's per-tile sync)
        store[_PREP, lsl].copy_(tile_d)
        cache.count_d2h(tile_bytes(i))
        cache.adopt(("prep", i), tile_d, tile_bytes(i))
        cache.mark_sync()
        del p, work, raw_d, tile_d
    gauge("prep_ms", (time.perf_counter() - t0) * 1e3)

    def host_tile(row, i):
        return store[row, lay.local[i]]

    # the device copy of the host weights the next step starts from
    mirror = [orig_h, orig_w_d]
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
            cur_local = lay.local_of(cur)
            cur_d = upload(cur_local, device, real)
            cache.count_h2d(cur_local.nbytes)
        acc = {}

        # pass 1: the template's partials, accumulated in tile order
        def put_template(i):
            ins = [cache.get(("prep", i), host_tile(_PREP, i), cube=True)]
            if keep_raw:
                ins.append(cache.get(("raw", i), host_tile(_RAW, i),
                                     cube=True))
            return ins

        def run_template(i, ins):
            lsl = lay.local[i]
            part = template_partial(
                route, ins[0], cur_d[lsl],
                None if offsets_d is None else offsets_d[lsl],
                ins[1] if keep_raw else None,
                baseline_duty=config.baseline_duty, mesh=mesh)
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
                                     shifts, rotation=rotation, mesh=mesh)
        marks.append(_tile_event(device, timing=True))

        # pass 2: each tile's kernel writes its rows of the full planes
        # (on a mesh its block's, gathered into the tile's rows)
        def put_diag(i):
            return cache.get(("prep", i), host_tile(_PREP, i), cube=True)

        def run_diag(i, tile_d):
            sl, lsl = tiles[i], lay.local[i]
            if route == "two_read":
                # its residual base in float32 from the upcast tile, as
                # the reference builds it (K7 then reads float32 cubes)
                tile_d = tile_d.to(real)
            diags = route_diagnostics(
                tile_prepared(route, tile_d, shifts, window,
                              rotation=rotation),
                template, orig_w_d[lsl], cell_mask_d[lsl], rotation=rotation,
                out=None if mesh is not None else [p[sl] for p in planes])
            if mesh is not None:
                whole = mesh.gather_cells(torch.stack(diags))
                for p, d in zip(planes, whole):
                    p[sl] = d[:sl.stop - sl.start]
            return _tile_event(device)

        def drain_diag(i, event):
            cache.mark_sync(event)

        pipelined_sweep(n_tiles, put_diag, run_diag, drain_diag, depth=depth)
        marks.append(_tile_event(device, timing=True))

        new_w_d, scores_d = fused_combine(planes, whole_mask_d, whole_w_d,
                                          config.chanthresh,
                                          config.subintthresh)
        rstd = residual_std(planes[0], whole_mask_d)
        tpeak = torch.max(template)
        marks.append(_tile_event(device, timing=True))
        new_w = new_w_d.cpu().numpy()
        scores = scores_d.cpu().numpy()
        cache.count_d2h(new_w.nbytes + scores.nbytes)
        cache.mark_sync()   # the fetches synchronised the iteration
        mirror[:] = [new_w, lay.local_of(new_w_d)]
        step_ms.append((time.perf_counter() - t_step) * 1e3)
        if on_card:   # the fetches above completed every mark
            pass_ms.append([a.elapsed_time(b)
                            for a, b in zip(marks, marks[1:])])
        return new_w, scores, (float(rstd), float(tpeak))

    result = _run_iterations(orig_h, config, step)
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
    ``icln_stream_iteration``.  ``mesh``: a cell mesh
    (:mod:`~iterative_cleaner_torch.parallel.mesh`) the tiles are
    sharded over (see the module docstring); every rank calls, rank 0
    gets the result and the others None."""
    if config.unload_res:
        raise ValueError(
            "unload_res is not supported in exact streaming mode (the "
            "residual cube is never materialised whole); use mode='online' "
            "or whole-archive cleaning")
    if chunk_nsub <= 0:
        raise ValueError(f"chunk_nsub must be positive, got {chunk_nsub}")
    cube = archive.total_intensity()
    if mesh is not None:
        check_mesh("cell", config)
        check_tile_grid(mesh, min(int(chunk_nsub), cube.shape[0]),
                        cube.shape[1])
    tiles = _tile_slices(cube.shape[0], int(chunk_nsub))
    if config.backend == "numpy":
        result = _clean_exact_numpy(
            cube, archive.weights, archive.freqs_mhz, archive.dm,
            archive.centre_freq_mhz, archive.period_s, config, tiles,
            archive.dedispersed)
    else:
        result = _clean_exact(
            cube, archive.weights, archive.freqs_mhz, archive.dm,
            archive.centre_freq_mhz, archive.period_s, config, tiles,
            archive.dedispersed, registry=registry, mesh=mesh)
    if mesh is not None and mesh.rank != 0:
        return None
    return apply_bad_parts(result, config)
