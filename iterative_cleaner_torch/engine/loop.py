"""The cleaning iteration, in torch: the reference's whole-archive routes.

- Every iteration rebuilds the template from the ORIGINAL data under the
  previous iteration's weights, so zaps re-derive from scratch and a cell
  can be un-zapped (the reference re-clones its archive each round).
- The preamble (baseline removal, dedispersion) is hoisted out of the
  loop; the cubes it leaves on the device depend on the route, which
  follows from the configuration and the archive as in the reference
  (``disp_iteration_enabled`` and the stats frame):

  - ``default`` (integration baseline, dispersed frame, no pulse window,
    a non-DEDISP input): K1 marginals -> K2 -> K3 x 2 -> combine; one
    resident cube ``disp_clean``, read twice per iteration.
  - ``two_read`` (dispersed frame and any of the pulse window, the
    profile baseline, a DEDISP=1 input): the template einsum over
    ``ded`` (+ the integration correction over ``disp_clean``) -> K7 ->
    K3 x 2 -> combine.
  - ``dedispersed`` (``stats_frame='dedispersed'``): the template einsum
    (+ correction) -> K6 -> K3 x 2 -> combine, the port's K5.

- Every route's iteration also takes the residual-std telemetry value,
  the masked median of the unmasked cells' ``d_std`` (kernel K9).
- Each stage runs under a ``torch.profiler`` range of the reference's
  scope name (``utils/tracing.stage``): ``icln_template``,
  ``icln_residual_stats`` (the cell kernel), ``icln_scores`` (K3 along
  each axis), ``icln_zap`` (the combine kernel's 4-way median and zap)
  and ``icln_iter_metrics`` (K9), so a ``--trace`` file shows them; with
  no profiler on a range is two flag checks.
- Convergence is cycle detection against every earlier weight matrix,
  held in a ``(max_iter+1)``-deep history seeded with the original
  weights.  That flag is the loop's only host synchronisation; the
  per-iteration telemetry stays on the device until the loop ends.
- The final mask applies the last iteration's scores to the original
  weights.

Exact streaming (``parallel/streaming_exact.py``) runs the same routes
tile by tile through :func:`template_partial`, :func:`assemble_template`
and :func:`tile_prepared` with :func:`route_diagnostics`.

The cell-sharded clean (``parallel/sharding.py``) runs :func:`prepare`,
:func:`build_template` and :func:`clean_loop` on each rank's (subint,
channel) shard with a ``mesh`` (a ``parallel.mesh.CellMesh``): the sums
that cross shards (the baseline window's total profile, the template's
numerators and weight sum, the marginals) are added in rank order, the
iteration's post-template half is the sharded sweep
(:func:`_sharded_sweep`), and the cycle check's flags and counts int32
all-reduces, so every rank leaves the loop at the same iteration.  The
sweep, by route (:data:`SHARD_KERNELS`): on ``default`` and
``dedispersed`` kernel K10 on the shard, the scalers and the telemetry
median as tree-reduced selects, the combine kernel; on ``two_read`` K7
on the shard, then the gathered scaler (the four diagnostic planes
gathered whole on every rank, K3 twice and the combine on them) and K9
on the gathered ``d_std``, as the reference runs that route.

A batch of equal-shaped archives (``parallel/batch.py``) runs the same
routes with a leading batch dimension on every per-archive tensor:
:func:`prepare_batch` runs the preamble archive by archive into stacked
resident cubes, and :func:`clean_loop_batch` iterates the batch as
``jax.vmap`` iterates the reference's ``while_loop``: until every
archive has stopped, each archive's carry frozen from the iteration it
stopped at.  Each iteration is one launch of each of the route's
kernels for the whole batch (the batch folded into the launch); the
template stage takes the batch in its tensor ops, its products and sums
archive by archive at one archive's shapes (``ops.dsp.each_archive``),
so that a batch's floats are bit-equal to its single cleans' on the
card too (a library product or reduction may pick its kernel, and so its
order of addition, by the shape it is given).

float64 (``CleanConfig.dtype='float64'``, the reference's oracle-parity
mode): the uploads, the cubes, every plane, sum, select and score are
float64 on every single-card route, and each kernel launches its float64
build (:func:`storage_kernels`); ``iter_metrics`` stays float32, as in
the reference.

Mixed precision (``CleanConfig.compute_dtype='bfloat16'``, the
reference's ``compute_dtype``): :func:`store_prepared` narrows the
route's cube-sized operands to bf16 after the float32 preamble, exactly
where the reference does; every kernel upcasts each element it reads
(K1, K2, K6, K7, K10 have bf16 builds), the template stage's products
upcast a piece of subints at a time (``ops.dsp.subint_chunks``), and
the plane-sized operands, the carries and every sum stay float32.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from iterative_cleaner_torch.config import CleanConfig, resolve_stats_frame
from iterative_cleaner_torch.ops.dsp import (
    fit_template_amplitudes,
    prepare_cube_integration,
    prepare_cube_with_correction,
    rotate_bins,
    subint_chunks,
    template_numerator_from_channel_profiles,
    template_residuals,
    trailing_sum,
    upcast_stored,
    weighted_template,
    weighted_template_numerator,
)
from iterative_cleaner_torch.ops.psrchive_baseline import (
    template_correction,
    template_correction_numerator_from_totals,
    template_correction_numerator_raw,
)
from iterative_cleaner_torch.stats.kernels import (
    cell_diagnostics_dedisp,
    cell_diagnostics_disp,
    cell_diagnostics_two_read,
    combine_zap,
    masked_median,
    scaled_sides,
    shard_diagnostics_dedisp,
    shard_diagnostics_disp,
    weighted_marginals,
)
from iterative_cleaner_torch.utils.tracing import stage

# columns of CleanOutputs.iter_metrics
ITER_METRICS_WIDTH = 4  # zap_count, mask_churn, residual_std, template_peak

# The routes, and the kernels (launch-count names of stats.kernels) each
# launches every iteration; a route launches none of the others.  K9
# (masked_median) is the residual-std telemetry's median.
_SHARED_KERNELS = ("scaled_sides_axis0", "scaled_sides_axis1", "combine_zap",
                   "masked_median")
ROUTE_KERNELS = {
    "default": ("weighted_marginals", "cell_diagnostics_disp")
    + _SHARED_KERNELS,
    "two_read": ("cell_diagnostics_two_read",) + _SHARED_KERNELS,
    "dedispersed": ("cell_diagnostics_dedisp",) + _SHARED_KERNELS,
}
# Exact streaming (parallel/streaming_exact.py) launches the same kernels
# per iteration, its combine as the sequence K8 (fused_combine).
STREAM_KERNELS = {route: kernels + ("fused_combine",)
                  for route, kernels in ROUTE_KERNELS.items()}
# The cell-sharded clean launches per iteration and rank: on the default
# and dedispersed routes K1 (default route), K10 and the combine kernel,
# its scalers and its telemetry median tree-reduced selects of torch ops,
# not K3 and K9; on the two_read route K7 on the rank's block, then K3
# twice, the combine and K9 on the gathered whole planes.
SHARD_KERNELS = {
    "default": ("weighted_marginals", "shard_diagnostics_disp",
                "combine_zap"),
    "two_read": ROUTE_KERNELS["two_read"],
    "dedispersed": ("shard_diagnostics_dedisp", "combine_zap"),
}
# The kernels that read the cube, each with a build for a bf16-stored
# cube counted apart (``<name>_bf16`` in stats.kernels.launch_counts).
CUBE_KERNELS = ("weighted_marginals", "cell_diagnostics_disp",
                "cell_diagnostics_two_read", "cell_diagnostics_dedisp",
                "shard_diagnostics_disp", "shard_diagnostics_dedisp")


def storage_kernels(kernels, compute_dtype: str,
                    dtype: str = "float32") -> tuple:
    """The launch-count names ``kernels`` (of :data:`ROUTE_KERNELS` and
    the others) run under at ``compute_dtype``: the cube kernels' bf16
    builds under ``'bfloat16'``, the rest (float32 planes) as named.
    Under ``dtype='float64'`` every kernel's float64 build
    (``<name>_f64``; the single-card routes', exact streaming's and the
    long lines' kernels have one, K10 none)."""
    if dtype == "float64":
        return tuple(k + "_f64" for k in kernels)
    if compute_dtype != "bfloat16":
        return tuple(kernels)
    return tuple(k + "_bf16" if k in CUBE_KERNELS else k for k in kernels)


# K3's routes on scaler lines over 46,486 entries (the archive's subints
# or channels; 28,224 in float64), on any route: the cluster kernel, one
# thread-block cluster a line, up to its capacity
# (stats.kernels.scaled_sides_route "cluster"); past it K9 for the
# medians and the two tail kernels for the centring and the side
# (stats.kernels.scaled_sides_long).
LONG_LINE_KERNELS = ("scaled_sides_cluster_axis0",
                     "scaled_sides_cluster_axis1", "side_centre",
                     "side_scale")


def iter_quality_series(iter_metrics, n_cells: int) -> dict:
    """The quality view of one run's ``iter_metrics``: named host-side
    series, the zap count normalised to the archive's ``n_cells``.
    Returns ``{"zap_frac": [...], "mask_churn": [...], "residual_std":
    [...], "template_peak": [...]}``, one entry per iteration run (read
    by ``telemetry.quality.observe_result``; kept beside the loop that
    fills the columns, so their order has one authority)."""
    im = np.asarray(iter_metrics, dtype=np.float64)
    if im.ndim != 2 or im.shape[1] != ITER_METRICS_WIDTH:
        raise ValueError(f"iter_metrics must be (loops, "
                         f"{ITER_METRICS_WIDTH}), got {im.shape}")
    cells = float(max(int(n_cells), 1))
    return {
        "zap_frac": [float(v) / cells for v in im[:, 0]],
        "mask_churn": [float(v) for v in im[:, 1]],
        "residual_std": [float(v) for v in im[:, 2]],
        "template_peak": [float(v) for v in im[:, 3]],
    }


def disp_iteration_enabled(baseline_mode: str, stats_frame: str,
                           pulse_active: bool, dedispersed: bool) -> bool:
    """The reference's eligibility predicate of the dispersed-frame route
    (the port's ``default``): the dispersed residual base IS the pristine
    ``disp_clean`` only under the integration preamble, the dispersed
    frame, no pulse window (the fit must see the unwindowed template) and
    a non-DEDISP input."""
    return (baseline_mode == "integration" and stats_frame == "dispersed"
            and not pulse_active and not dedispersed)


def select_route(config: CleanConfig, dedispersed: bool) -> str:
    """The route of :data:`ROUTE_KERNELS` ``config`` runs on an archive
    (``dedispersed``: a DEDISP=1 input), as the reference chooses it
    (``disp_iteration_enabled`` and the resolved stats frame)."""
    stats_frame = resolve_stats_frame(config.stats_frame)
    if stats_frame == "dedispersed":
        return "dedispersed"
    if disp_iteration_enabled(config.baseline_mode, stats_frame,
                              config.pulse_region_active, bool(dedispersed)):
        return "default"
    return "two_read"


def pulse_window(nbin, pulse_slice, pulse_scale, pulse_active, dtype,
                 device):
    """(nbin,) multiplier the reference applies to the residual's
    on-pulse bins: 1 everywhere, ``pulse_scale`` on [start, end), built
    in float64 and cast as the reference builds it.  None when
    inactive."""
    if not pulse_active:
        return None
    m = np.ones(nbin, dtype=np.float64)
    start, end = pulse_slice
    m[start:end] = pulse_scale
    return torch.from_numpy(m).to(device=device, dtype=dtype)


def dispersed_residual_base(ded, back_shifts, *, window, rotation):
    """Iteration-invariant part of the dispersed-frame residual:
    ``rot(ded * m)``.  The residual the statistics consume is
    ``rot(amps * t * m - ded * m)``; rotation is linear, so the cube part
    is rotated once here and each iteration rotates only the (nbin,)
    template."""
    masked = ded if window is None else ded * window
    return rotate_bins(masked, back_shifts, method=rotation)


class Prepared(NamedTuple):
    """What the preamble leaves on the device for one route (a batch's:
    each tensor but ``window`` with a leading batch dimension).  The
    cubes (``ded``, ``disp_base``, ``disp_clean``) are float32 (float64
    under ``dtype='float64'``), or bf16 after :func:`store_prepared`."""

    route: str
    back_shifts: torch.Tensor                 # (nchan,) re-dispersion shifts
    ded: Optional[torch.Tensor]               # dedispersed cube (not default)
    disp_base: Optional[torch.Tensor]         # default: disp_clean; two_read
    disp_clean: Optional[torch.Tensor]        # integration baseline only
    base_offsets: Optional[torch.Tensor]      # integration baseline only
    window: Optional[torch.Tensor]            # (nbin,) pulse window or None


def prepare(cube, weights, freqs_mhz, dm, ref_freq_mhz, period_s,
            config: CleanConfig, *, dedispersed,
            residual_base: bool = True, mesh=None) -> Prepared:
    """Run the preamble of the route :func:`select_route` picks on the
    uploaded ``cube`` (consumed: the baseline is subtracted in place) and
    keep only the cubes the route reads: ``disp_clean`` (default);
    ``ded`` and ``disp_base``, plus ``disp_clean`` under the integration
    baseline (two_read); ``ded``, plus ``disp_clean`` under the
    integration baseline (dedispersed).  Every argument but ``config``
    and ``dedispersed`` is a tensor on the device.  ``residual_base=
    False`` leaves the two_read route's ``disp_base`` unbuilt (exact
    streaming rebuilds it per tile, :func:`tile_prepared`).  ``mesh``:
    the arguments are a rank's shard (see the module docstring)."""
    route = select_route(config, dedispersed)
    rotation, duty = config.rotation, config.baseline_duty
    if route == "default":
        _, shifts, disp_clean, offsets = prepare_cube_integration(
            cube, weights, freqs_mhz, dm, ref_freq_mhz, period_s,
            baseline_duty=duty, rotation=rotation, with_ded=False, mesh=mesh)
        return Prepared(route, shifts, None, disp_clean, disp_clean, offsets,
                        None)
    window = pulse_window(cube.shape[-1], config.pulse_slice,
                          config.pulse_scale, config.pulse_region_active,
                          cube.dtype, cube.device)
    ded, shifts, corr = prepare_cube_with_correction(
        cube, weights, freqs_mhz, dm, ref_freq_mhz, period_s,
        baseline_duty=duty, rotation=rotation,
        dedispersed=bool(dedispersed), baseline_mode=config.baseline_mode,
        mesh=mesh)
    disp_clean, offsets = (corr[0], corr[1]) if corr is not None \
        else (None, None)
    disp_base = None
    if route == "two_read" and residual_base:
        disp_base = dispersed_residual_base(ded, shifts, window=window,
                                            rotation=rotation)
    elif window is None:
        # the dedispersed-frame kernel always takes a window row
        window = torch.ones(ded.shape[-1], dtype=ded.dtype,
                            device=ded.device)
    return Prepared(route, shifts, ded, disp_base, disp_clean, offsets,
                    window)


def store_prepared(prep: Prepared, compute_dtype: str) -> Prepared:
    """The route's cubes in the storage dtype of ``compute_dtype``: under
    ``'bfloat16'`` ``ded``, ``disp_base`` and ``disp_clean`` narrowed to
    bf16 after the float32 preamble (the reference's ``clean_dedispersed_
    jax``: the one narrowing of the mixed-precision mode; lossless where
    the prepared cube is bf16-exact), a cube the route keeps twice (the
    default route's ``disp_base`` is its ``disp_clean``) narrowed once.
    The shifts, offsets and window stay float32.  ``'float32'`` returns
    ``prep`` itself."""
    if compute_dtype == "float32":
        return prep
    if compute_dtype != "bfloat16":
        raise ValueError(f"unknown compute dtype {compute_dtype!r}")
    narrowed = {}

    def narrow(t):
        if t is None:
            return None
        if t.data_ptr() not in narrowed:
            narrowed[t.data_ptr()] = t.to(torch.bfloat16)
        return narrowed[t.data_ptr()]

    return prep._replace(ded=narrow(prep.ded),
                         disp_base=narrow(prep.disp_base),
                         disp_clean=narrow(prep.disp_clean))


def prepare_stored(piece, shape, weights, freqs_mhz, dm, ref_freq_mhz,
                   period_s, config: CleanConfig, *, dedispersed,
                   compute_dtype: str, mesh=None) -> Prepared:
    """:func:`prepare` then :func:`store_prepared` of a cube of ``shape``
    (nsub, nchan, nbin), its float32 subints ``sl`` uploaded by
    ``piece(sl)`` (each upload consumed by the preamble).  Under
    ``'float32'`` one piece, the whole cube.  Under ``'bfloat16'`` the
    preamble runs a :func:`~iterative_cleaner_torch.ops.dsp.subint_chunks`
    piece at a time (every step of it is local to a subint, as exact
    streaming uses it) and each piece's cubes are narrowed into the
    resident bf16 cubes, so that the whole float32 cube is never on the
    device and the peak falls to the resident bf16 cubes and one piece's
    temporaries.  A piece's float32 products may round differently from
    a whole cube's in the last bit, so an element next to a bf16 rounding
    boundary may store the other neighbour; every clean of a shape cuts
    the same pieces (a single clean, each archive of a batch, a one-rank
    mesh's block)."""
    meta = (freqs_mhz, dm, ref_freq_mhz, period_s)
    nsub = shape[0]
    if compute_dtype == "float32":
        return prepare(piece(slice(0, nsub)), weights, *meta, config,
                       dedispersed=dedispersed, mesh=mesh)
    names = ("ded", "disp_base", "disp_clean", "base_offsets")
    out, first = {}, None
    for sl in subint_chunks(*shape):
        part = store_prepared(prepare(piece(sl), weights[sl], *meta, config,
                                      dedispersed=dedispersed, mesh=mesh),
                              compute_dtype)
        if first is None:
            first, owner = part, {}
            for name in names:
                t = getattr(part, name)
                if t is not None and t.data_ptr() not in owner:
                    owner[t.data_ptr()] = t.new_empty((nsub,) + t.shape[1:])
                out[name] = None if t is None else owner[t.data_ptr()]
        done = set()
        for name in names:
            dst = out[name]
            if dst is not None and id(dst) not in done:
                dst[sl] = getattr(part, name)
                done.add(id(dst))
        del part
    return first._replace(**out)


def prepare_batch(cubes, weights, freqs_mhz, dms, ref_freqs_mhz, periods_s,
                  config: CleanConfig, *, dedispersed,
                  compute_dtype: str = "float32") -> Prepared:
    """:func:`prepare` on each archive of a batch: the stacked upload
    ``cubes`` (B, nsub, nchan, nbin) (consumed), ``weights`` (B, nsub,
    nchan), ``freqs_mhz`` (B, nchan) and the (B,) ``dms``,
    ``ref_freqs_mhz`` and ``periods_s``.  Archive b's preamble runs on
    its slices alone, so its cubes are bit-equal to a clean of it alone;
    a cube the route keeps in the upload itself (``disp_clean``, the
    profile baseline's ``ded``) stays there, the others are copied into
    stacked cubes allocated at the first archive, so the preamble's
    temporaries stay one archive's.  Under ``compute_dtype='bfloat16'``
    each archive's cubes are narrowed after its float32 preamble, a piece
    at a time as a single clean's (:func:`prepare_stored`), into stacked
    bf16 cubes.  The pulse window is shared."""
    names = ("back_shifts", "ded", "disp_base", "disp_clean", "base_offsets")
    stacked, prep = {}, None
    for b in range(cubes.shape[0]):
        prep = prepare_stored(
            lambda sl, b=b: cubes[b][sl], tuple(cubes.shape[1:]), weights[b],
            freqs_mhz[b], dms[b], ref_freqs_mhz[b], periods_s[b], config,
            dedispersed=dedispersed, compute_dtype=compute_dtype)
        if b == 0:
            owner = {cubes[0].data_ptr(): cubes}
            for name in names:
                t = getattr(prep, name)
                if t is not None and t.data_ptr() not in owner:
                    owner[t.data_ptr()] = t.new_empty(
                        (cubes.shape[0],) + tuple(t.shape))
                stacked[name] = None if t is None else owner[t.data_ptr()]
        for name in names:
            dst = stacked[name]
            if dst is not None and dst is not cubes:
                dst[b].copy_(getattr(prep, name))
    return Prepared(prep.route, *(stacked[n] for n in names), prep.window)


class CleanOutputs(NamedTuple):
    final_weights: torch.Tensor   # (nsub, nchan) cleaned weights
    loops: int                    # iterations run
    converged: bool
    scores: torch.Tensor          # (nsub, nchan) last iteration's scores
    template_weights: torch.Tensor  # weights the last template was built from
    loop_diffs: torch.Tensor      # (max_iter,) cells changed per loop
    loop_rfi_frac: torch.Tensor   # (max_iter,) zero-weight fraction per loop
    history: torch.Tensor         # (max_iter+1, nsub, nchan) weight matrices
    history_count: int            # entries [0:history_count] are populated
    iter_metrics: torch.Tensor    # (max_iter, ITER_METRICS_WIDTH) float32


def nyq_correction_row(back_shifts, nbin, rotation, dtype):
    """(nchan, nbin) Nyquist round-trip correction rows of the one-read
    fit, or None where the rotation round-trips exactly (roll rotation,
    odd nbin).  A fourier rotation by a fractional shift s attenuates the
    Nyquist bin, so R(s)R(-s)x = x + (cos^2(pi s) - 1) * nyq(x) with
    nyq(x)[b] = (1/n)(-1)^b sum_b' (-1)^b' x[b']; K2 applies that rank-one
    term per cell."""
    if rotation != "fourier" or nbin % 2 != 0:
        return None
    frac = back_shifts - torch.round(back_shifts)
    gamma = torch.cos(math.pi * frac.to(dtype)) ** 2 - 1.0
    alt = (1.0 - 2.0 * (torch.arange(nbin, device=back_shifts.device) % 2)
           ).to(dtype)
    return (gamma / nbin)[..., None] * alt


def template_partial(route, tile, weights, offsets, raw, *, baseline_duty,
                     mesh=None):
    """The template stage's partial over a subint tile (or the whole
    cube): ``(numerator, correction numerator)``, both summing over tiles
    to the whole archive's.  default: K1's ``(A, t1)`` on the dispersed
    ``tile``, the numerator being ``A`` and the correction's from the
    totals ``t1``.  Other routes: the weighted numerator over the
    dedispersed ``tile`` and, under the integration baseline (``raw``
    given), the correction's from the raw cube.  ``offsets`` are the
    tile's integration-baseline levels (None under the profile
    baseline).  On a cell ``mesh`` the arguments are the rank's block of
    the tile and the partials the whole tile's: on the default route K1
    per block, ``A`` summed over the rank's column and ``t1`` over its
    row; on the others the numerator summed over every rank."""
    if route == "default":
        if mesh is None:
            a, t1 = weighted_marginals(tile, weights)
        else:
            from iterative_cleaner_torch.parallel.shard_stats import (
                sharded_weighted_marginals,
            )

            a, t1 = sharded_weighted_marginals(mesh, tile, weights)
        return a, template_correction_numerator_from_totals(
            t1, offsets, weights, baseline_duty, mesh)
    num = weighted_template_numerator(tile, weights)
    if mesh is not None:
        num = mesh.total(num, "all")
    if raw is None:
        return num, None
    return num, template_correction_numerator_raw(raw, offsets, weights,
                                                  baseline_duty, mesh)


def assemble_template(route, num, corr, weights, back_shifts, *, rotation,
                      mesh=None):
    """The template from the accumulated partials and the full (nsub,
    nchan) weights: the default route's dedispersion rotation of the
    channel profiles ``A``, the ``den == 0`` guards, the reference's
    x10000.  On a cell ``mesh`` the rank's shard of the weights, the
    channel sum and the weight sum crossing ranks.  A batch's weights
    give one template per archive, (B, nbin)."""
    if route == "default":
        num = template_numerator_from_channel_profiles(num, back_shifts,
                                                       rotation, mesh)
    den = trailing_sum(weights, 2)
    if mesh is not None:
        den = mesh.total(den, "all")
    safe = torch.where(den == 0, torch.ones_like(den), den)
    template = torch.where(den[..., None] == 0, torch.zeros_like(num),
                           num / safe[..., None])
    if corr is not None:
        template = template + torch.where(den == 0, torch.zeros_like(corr),
                                          corr / safe)[..., None]
    return template * 10000.0


def build_template(prep: Prepared, weights, *, rotation, baseline_duty,
                   mesh=None):
    """Template stage of one iteration, the reference's x10000 included.

    default: both weighted marginals of the dispersed cube in one read
    (K1), the dedispersion rotation applied to the (nchan, nbin) channel
    profiles, the integration-baseline correction from the per-subint
    totals (:func:`template_partial` and :func:`assemble_template` over
    the whole cube).  Other routes: the weighted template over ``ded``
    and, under the integration baseline, the correction over
    ``disp_clean`` — plain products, as in the reference.  ``mesh``: the
    sums that cross a rank's shard (see the module docstring).  A batch's
    (B, nsub, nchan) ``weights`` give (B, nbin) templates, each bit-equal
    to its archive's single clean's."""
    if prep.route == "default":
        num, corr = template_partial("default", prep.disp_base, weights,
                                     prep.base_offsets, None,
                                     baseline_duty=baseline_duty, mesh=mesh)
        return assemble_template("default", num, corr, weights,
                                 prep.back_shifts, rotation=rotation,
                                 mesh=mesh)
    template = weighted_template(prep.ded, weights, mesh)
    if prep.disp_clean is not None:
        template = template + template_correction(
            prep.disp_clean, prep.base_offsets, weights, baseline_duty,
            mesh)[..., None]
    return template * 10000.0


def tile_prepared(route, tile, back_shifts, window, *, rotation
                  ) -> Prepared:
    """The :class:`Prepared` of one subint tile of the route's prepared
    cube (``disp_clean`` on the default route, ``ded`` on the others),
    for :func:`route_diagnostics`: the two_read route's residual base is
    built here, per tile."""
    if route == "default":
        return Prepared(route, back_shifts, None, tile, tile, None, None)
    disp_base = None
    if route == "two_read":
        disp_base = dispersed_residual_base(tile, back_shifts, window=window,
                                            rotation=rotation)
    return Prepared(route, back_shifts, tile, disp_base, None, None, window)


def route_diagnostics(prep: Prepared, template, orig_weights, cell_mask, *,
                      rotation, out=None):
    """The four per-cell diagnostic planes of the route's residual: K2
    (default), K7 (two_read) or K6 (dedispersed).  ``out``: four
    contiguous (nsub, nchan) float32 views the kernel writes (a tile's
    rows of the full planes)."""
    if prep.route == "dedispersed":
        return cell_diagnostics_dedisp(prep.ded, template, prep.window,
                                       orig_weights, cell_mask, out=out)
    rot_t, nyq_row = _dispersed_rows(prep, template, rotation)
    if prep.route == "two_read":
        return cell_diagnostics_two_read(prep.ded, prep.disp_base, rot_t,
                                         template, orig_weights, cell_mask,
                                         out=out)
    return cell_diagnostics_disp(prep.disp_base, rot_t, nyq_row, template,
                                 orig_weights, cell_mask, out=out)


def _dispersed_rows(prep: Prepared, template, rotation):
    """The dispersed-frame kernels' (nchan, nbin) rows: the (windowed)
    template rotated to each channel, and the Nyquist correction rows of
    the one-read fit (None where the rotation round-trips exactly);
    float32 whatever the cube's storage.  (B, nchan, nbin) for a batch,
    each archive's rows bit-equal to its single clean's."""
    nchan, nbin = prep.disp_base.shape[-2:]
    t = template if prep.window is None else template * prep.window
    rot_t = rotate_bins(t[..., None, :].expand(*t.shape[:-1], nchan, nbin),
                        prep.back_shifts, method=rotation).contiguous()
    return rot_t, nyq_correction_row(prep.back_shifts, nbin, rotation,
                                     prep.back_shifts.dtype)


def iteration_step(prep: Prepared, weights, orig_weights, cell_mask, *,
                   chanthresh, subintthresh, rotation, baseline_duty,
                   mesh=None):
    """One iteration: template -> fit -> residual diagnostics (K2, K6 or
    K7) -> both scaler orientations (K3) -> 4-way median and zap
    (combine); on a cell ``mesh`` the sharded sweep after the template
    (:func:`_sharded_sweep`).  Returns ``(new_weights, scores,
    residual_std, template_peak)``, the last two as device scalars for
    the telemetry rows ((B,) for a batch: each kernel launched once for
    the whole batch)."""
    with stage("icln_template"):
        template = build_template(prep, weights, rotation=rotation,
                                  baseline_duty=baseline_duty, mesh=mesh)
    if mesh is not None:
        new_weights, scores, rstd = _sharded_sweep(
            prep, template, orig_weights, cell_mask, mesh,
            chanthresh=chanthresh, subintthresh=subintthresh,
            rotation=rotation)
        return new_weights, scores, rstd, torch.max(template)
    with stage("icln_residual_stats"):
        diags = route_diagnostics(prep, template, orig_weights, cell_mask,
                                  rotation=rotation)
    new_weights, scores = scores_and_zap(diags, cell_mask, orig_weights,
                                         chanthresh, subintthresh)
    with stage("icln_iter_metrics"):
        return (new_weights, scores, residual_std(diags[0], cell_mask),
                torch.amax(template, dim=-1))


def scores_and_zap(diags, cell_mask, orig_weights, chanthresh,
                   subintthresh):
    """``(new_weights, scores)`` of the four diagnostic planes: K3 along
    each axis (the ``icln_scores`` range), then the combine kernel's
    4-way median and zap (the ``icln_zap`` range: one kernel takes the
    median and the zap, so the reference's last ``icln_scores`` step, the
    median, runs under ``icln_zap`` here)."""
    with stage("icln_scores"):
        chan = scaled_sides(diags, cell_mask, 0, chanthresh)
        sub = scaled_sides(diags, cell_mask, 1, subintthresh)
    with stage("icln_zap"):
        return combine_zap(chan, sub, orig_weights)


def _sharded_sweep(prep: Prepared, template, orig_weights, cell_mask, mesh,
                   *, chanthresh, subintthresh, rotation):
    """The post-template half of a sharded iteration on this rank's
    shard.  two_read (the reference's ``sharded_cell_diagnostics_fused``
    and ``sharded_scale_and_combine``): K7 on the shard, the gathered
    scaler, K9 on the gathered ``d_std``.  The others (the reference's
    ``sharded_fused_sweep``/``_dedisp``): kernel K10 on the shard, then
    the tree-reduced scalers, the combine and the tree-reduced telemetry
    median.  Returns ``(new_weights, scores, residual_std)``."""
    from iterative_cleaner_torch.parallel.shard_stats import (
        sharded_scale_and_combine,
        tree_combine_zap,
    )

    with stage("icln_residual_stats"):
        if prep.route == "two_read":
            diags = route_diagnostics(prep, template, orig_weights,
                                      cell_mask, rotation=rotation)
        elif prep.route == "dedispersed":
            diags = shard_diagnostics_dedisp(prep.ded, template, prep.window,
                                             orig_weights, cell_mask)
        else:
            rot_t, nyq_row = _dispersed_rows(prep, template, rotation)
            diags = shard_diagnostics_disp(prep.disp_base, rot_t, nyq_row,
                                           template, orig_weights, cell_mask)
    if prep.route == "two_read":
        # the gathered planes are whole on every rank
        new_weights, scores, d_std, d_mask = sharded_scale_and_combine(
            mesh, diags, orig_weights, chanthresh, subintthresh)
        d_mesh = None
    else:
        new_weights, scores = tree_combine_zap(
            diags, cell_mask, orig_weights, chanthresh, subintthresh, mesh)
        d_std, d_mask, d_mesh = diags[0], cell_mask, mesh
    with stage("icln_iter_metrics"):
        rstd = residual_std(d_std, d_mask, d_mesh)
    return new_weights, scores, rstd


def residual_std(d_std, cell_mask, mesh=None):
    """The residual-std telemetry value: the median of the unmasked
    cells' ``d_std`` (a device scalar), kernel K9 over the plane as one
    line (a batch's B planes as B lines, one launch: (B,) values); on a
    cell ``mesh`` over every rank's cells, by the tree-reduced select (the
    same value as K9 on the whole plane)."""
    if mesh is None:
        lead = d_std.shape[:-2]
        cells = d_std.shape[-2] * d_std.shape[-1]
        return masked_median(d_std.reshape(-1, cells),
                             cell_mask.reshape(-1, cells), 1).reshape(lead)
    from iterative_cleaner_torch.parallel.shard_stats import (
        tree_masked_median_lanes,
        tree_reducers,
    )

    med, _ = tree_masked_median_lanes(d_std.reshape(-1, 1),
                                      cell_mask.reshape(-1, 1), 0,
                                      tree_reducers(mesh, "all"))
    return med[0, 0]


def clean_loop(prep: Prepared, orig_weights, *, max_iter, chanthresh,
               subintthresh, rotation, baseline_duty,
               mesh=None) -> CleanOutputs:
    """Run the iteration loop on the prepared cubes.  On a cell ``mesh``
    each rank loops over its shard: the weights, scores and history are
    its shard's, the per-loop counts and the cycle check's verdict the
    whole grid's (int32 all-reduces)."""
    nsub, nchan = orig_weights.shape
    ncells = nsub * nchan * (1 if mesh is None else math.prod(mesh.shape))
    dev = orig_weights.device
    dtype = prep.back_shifts.dtype
    cell_mask = orig_weights == 0
    history = torch.zeros((max_iter + 1, nsub, nchan), dtype=orig_weights.dtype,
                          device=dev)
    history[0] = orig_weights
    loop_diffs = torch.zeros((max_iter,), dtype=torch.int32, device=dev)
    loop_rfi_frac = torch.zeros((max_iter,), dtype=dtype, device=dev)
    iter_metrics = torch.zeros((max_iter, ITER_METRICS_WIDTH),
                               dtype=torch.float32, device=dev)
    weights = template_weights = orig_weights
    scores = torch.zeros((nsub, nchan), dtype=dtype, device=dev)
    count, loops, converged = 1, max_iter, False
    for x in range(max_iter):
        new_w, scores, rstd, tpeak = iteration_step(
            prep, weights, orig_weights, cell_mask, chanthresh=chanthresh,
            subintthresh=subintthresh, rotation=rotation,
            baseline_duty=baseline_duty, mesh=mesh)
        same = (history[:count] == new_w[None]).flatten(1).all(dim=1)
        counts = torch.stack([torch.sum(new_w != weights),
                              torch.sum(new_w == 0),
                              torch.sum((new_w == 0) != (weights == 0))])
        if mesh is not None:
            # a history slot repeats only if it does on every shard
            same = mesh.reduce_int(same.to(torch.int32), "min") > 0
            counts = mesh.reduce_int(counts.to(torch.int32), "sum")
        repeat = same.any()
        diffs, zeros, churn = counts
        history[count] = new_w
        count += 1
        loop_diffs[x] = diffs
        loop_rfi_frac[x] = zeros.to(dtype) / ncells
        iter_metrics[x] = torch.stack([
            zeros.to(torch.float32), churn.to(torch.float32),
            rstd.to(torch.float32), tpeak.to(torch.float32)])
        template_weights, weights = weights, new_w
        if bool(repeat):  # the loop's one host sync, the same on every rank
            converged, loops = True, x + 1
            break
    return CleanOutputs(
        final_weights=weights, loops=loops, converged=converged,
        scores=scores, template_weights=template_weights,
        loop_diffs=loop_diffs, loop_rfi_frac=loop_rfi_frac,
        history=history, history_count=count, iter_metrics=iter_metrics)


class BatchOutputs(NamedTuple):
    """:class:`CleanOutputs` of a batch, every field with a leading batch
    dimension: ``loops`` (B,) int64 and ``converged`` (B,) bool device
    tensors, archive b's ``history`` populated in [0:loops[b] + 1]."""
    final_weights: torch.Tensor
    loops: torch.Tensor
    converged: torch.Tensor
    scores: torch.Tensor
    template_weights: torch.Tensor
    loop_diffs: torch.Tensor
    loop_rfi_frac: torch.Tensor
    history: torch.Tensor
    iter_metrics: torch.Tensor


def clean_loop_batch(prep: Prepared, orig_weights, *, max_iter, chanthresh,
                     subintthresh, rotation, baseline_duty) -> BatchOutputs:
    """:func:`clean_loop` over a batch (:func:`prepare_batch`'s
    ``prep``, (B, nsub, nchan) ``orig_weights``), as ``jax.vmap`` runs the
    reference's ``while_loop``: each iteration is one
    :func:`iteration_step` for the whole batch (each of the route's
    kernels launched once); an archive whose weights repeat a history
    entry stops there, and from the next iteration on its carry —
    weights, scores, history, loops, convergence, per-loop counts and
    telemetry rows — is frozen (its new values computed and discarded by
    a select), so each archive's outputs are those of its own
    :func:`clean_loop`.  The batch iterates until every archive has
    stopped or ``max_iter``; the per-archive ``active`` flags stay on the
    device and "all stopped?" is the loop's one host synchronisation."""
    nb, nsub, nchan = orig_weights.shape
    ncells = nsub * nchan
    dev = orig_weights.device
    dtype = prep.back_shifts.dtype
    cell_mask = orig_weights == 0
    history = torch.zeros((nb, max_iter + 1, nsub, nchan),
                          dtype=orig_weights.dtype, device=dev)
    history[:, 0] = orig_weights
    loop_diffs = torch.zeros((nb, max_iter), dtype=torch.int32, device=dev)
    loop_rfi_frac = torch.zeros((nb, max_iter), dtype=dtype, device=dev)
    iter_metrics = torch.zeros((nb, max_iter, ITER_METRICS_WIDTH),
                               dtype=torch.float32, device=dev)
    weights = template_weights = orig_weights
    scores = torch.zeros((nb, nsub, nchan), dtype=dtype, device=dev)
    active = torch.ones((nb,), dtype=torch.bool, device=dev)
    loops = torch.full((nb,), max_iter, dtype=torch.int64, device=dev)
    for x in range(max_iter):
        new_w, new_scores, rstd, tpeak = iteration_step(
            prep, weights, orig_weights, cell_mask, chanthresh=chanthresh,
            subintthresh=subintthresh, rotation=rotation,
            baseline_duty=baseline_duty)
        repeat = (history[:, :x + 1] == new_w[:, None]).flatten(2).all(
            dim=2).any(dim=1)
        diffs = torch.sum(new_w != weights, dim=(1, 2))
        zeros = torch.sum(new_w == 0, dim=(1, 2))
        churn = torch.sum((new_w == 0) != (weights == 0), dim=(1, 2))
        on = active[:, None, None]
        history[:, x + 1] = torch.where(on, new_w, history[:, x + 1])
        loop_diffs[:, x] = torch.where(active, diffs.to(torch.int32), 0)
        loop_rfi_frac[:, x] = torch.where(active, zeros.to(dtype) / ncells,
                                          0.0)
        rows = torch.stack([zeros.to(torch.float32), churn.to(torch.float32),
                            rstd.to(torch.float32), tpeak.to(torch.float32)],
                           dim=1)
        iter_metrics[:, x] = torch.where(active[:, None], rows, 0.0)
        template_weights = torch.where(on, weights, template_weights)
        weights = torch.where(on, new_w, weights)
        scores = torch.where(on, new_scores, scores)
        stops = active & repeat
        loops = torch.where(stops, x + 1, loops)
        active = active & ~repeat
        if not bool(active.any()):  # the loop's one host sync
            break
    return BatchOutputs(
        final_weights=weights, loops=loops, converged=~active,
        scores=scores, template_weights=template_weights,
        loop_diffs=loop_diffs, loop_rfi_frac=loop_rfi_frac, history=history,
        iter_metrics=iter_metrics)


def unload_residual(prep: Prepared, template_weights, *, rotation,
                    baseline_duty, pulse_slice, pulse_scale, pulse_active):
    """The last iteration's pulse-free residual in the archive's own
    (dispersed) frame, as the reference reconstructs it after its loop:
    the template from ``template_weights`` over ``ded`` (plus the
    integration correction), the closed-form fit, ``amp * t - ded`` with
    the pulse window's bins scaled, rotated back by the re-dispersion
    shifts.  The default route keeps no ``ded``: its ``disp_clean`` is
    rotated into the dedispersed frame here, once.  A bf16-stored cube is
    upcast whole here, once after the loop: the residual it gives is a
    float32 cube of the same size anyway."""
    ded = prep.ded
    if ded is None:
        ded = rotate_bins(upcast_stored(prep.disp_clean), -prep.back_shifts,
                          method=rotation)
    else:
        ded = upcast_stored(ded)
    template = weighted_template(ded, template_weights)
    if prep.disp_clean is not None:
        template = template + template_correction(
            prep.disp_clean, prep.base_offsets, template_weights,
            baseline_duty)
    template = template * 10000.0
    amps = fit_template_amplitudes(ded, template)
    resid = template_residuals(ded, template, amps, pulse_slice, pulse_scale,
                               pulse_active)
    del ded
    return rotate_bins(resid, prep.back_shifts, method=rotation)
