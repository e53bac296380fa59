"""The port's streaming (``iterative_cleaner_torch.parallel``) on the CPU,
every kernel through its plain PyTorch version, against the JAX package.

- K8 (``fused_combine``) against ``fused_combine_pallas`` in interpret
  mode: bit-equal, NaN included, at shapes that are not multiples of the
  TPU's (8, 128) tile (its padding must change nothing).
- Exact streaming against the JAX package's ``clean_streaming_exact``
  (float32) and against the port's own whole clean, on every route and
  on geometries with a partial final tile and with one tile: masks,
  loops and convergence equal; scores to rtol 1e-4 with a 1e-4 floor
  against the JAX package (its CPU route takes spectra by FFT, the port
  by DFT, as in tests/test_torch_routes.py).
- The tile cache's budget: nothing pinned and everything pinned give
  bit-equal results and the expected cube uploads.
- The tile cache and sweep policy with a fake upload (the counterparts
  of tests/test_tile_cache.py), the online mode against the JAX
  package's, the refusals and the CLI's ``--stream``.
"""

import os
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from iterative_cleaner_tpu.config import CleanConfig as RefConfig
from iterative_cleaner_tpu.io.synthetic import (
    make_synthetic_archive as ref_make_synthetic_archive,
)
from iterative_cleaner_tpu.parallel import (
    clean_streaming as ref_clean_streaming,
    clean_streaming_exact as ref_clean_streaming_exact,
)
from iterative_cleaner_tpu.stats import pallas_kernels as pk
from iterative_cleaner_torch import CleanConfig
from iterative_cleaner_torch.backends import clean_archive
from iterative_cleaner_torch.cli import main as cli_main
from iterative_cleaner_torch.convert import (
    archive_from_reference,
    config_from_reference,
)
from iterative_cleaner_torch.io import load_archive, save_archive
from iterative_cleaner_torch.parallel import (
    StreamingCleaner,
    clean_streaming,
    clean_streaming_exact,
)
from iterative_cleaner_torch.parallel.tile_cache import (
    DEFAULT_BUDGET_FRACTION,
    FALLBACK_BUDGET_BYTES,
    DictRegistry,
    TileCache,
    pipelined_sweep,
    resolve_budget_bytes,
)
from iterative_cleaner_torch.stats import kernels as tk


def _bits_equal(got, want):
    got = np.asarray(got, dtype=np.float32)
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape
    nan_g, nan_w = np.isnan(got), np.isnan(want)
    np.testing.assert_array_equal(nan_g, nan_w)
    np.testing.assert_array_equal(got[~nan_g].view(np.int32),
                                  want[~nan_w].view(np.int32))


# --- K8 ---------------------------------------------------------------------

def _diag_planes(nsub, nchan, seed):
    """Four diagnostic planes with the selects' corner cases: prezapped
    (masked) cells, a fully masked channel and subint, zero-MAD lines,
    ties, NaN and inf on the plain (rFFT) plane and NaN on a masked
    one."""
    rng = np.random.default_rng(seed)
    d = [rng.standard_normal((nsub, nchan)).astype(np.float32) * s
         for s in (1.0, 0.3, 5.0, 2.0)]
    mask = rng.random((nsub, nchan)) < 0.2
    mask[:, 2] = True                 # a fully masked channel
    mask[4, :] = True                 # a fully masked subint
    for p in d:
        p[:, 3] = 1.5                 # zero-MAD channel
        p[6, :] = -0.25               # zero-MAD subint
        p[7, ::3] = 2.0               # ties
    d[0][mask] = 0.0
    d[1][mask] = 0.0
    d[2][mask] = np.float32(1e20)     # the masked ptp fill
    d[3][1, 0] = np.nan
    d[3][9, 11] = np.inf
    d[3][:, 7] = 0.0                  # zero MAD on the plain path: inf/nan
    d[1][10, 12] = np.nan
    return d, mask


@pytest.mark.parametrize("nsub,nchan", [(13, 37), (24, 130), (16, 128)])
def test_fused_combine_bit_equal_to_pallas(nsub, nchan):
    d, mask = _diag_planes(nsub, nchan, seed=nsub)
    rng = np.random.default_rng(nchan)
    worig = np.where(mask, 0.0, rng.uniform(0.5, 2.0, mask.shape)
                     ).astype(np.float32)
    planes = [torch.from_numpy(p) for p in d]
    new_w, scores = tk.fused_combine(planes, torch.from_numpy(mask),
                                     torch.from_numpy(worig), 5.0, 4.0)
    want_w, want_s = pk.fused_combine_pallas(
        [jnp.asarray(p) for p in d], jnp.asarray(mask), jnp.asarray(worig),
        5.0, 4.0)
    assert np.isnan(np.asarray(want_s)).any()   # the corner cases bite
    _bits_equal(scores.numpy(), want_s)
    _bits_equal(new_w.numpy(), want_w)


# --- exact streaming: the JAX package and the whole clean -------------------

ROUTES = {
    "default": dict(),
    "profile": dict(baseline_mode="profile"),
    "dedispersed": dict(stats_frame="dedispersed"),
    "pulse-window": dict(pulse_region=(0.2, 20, 40)),
}
GEOMS = {"96x32": (5, 96, 32), "70x32": (7, 70, 32), "24x64": (11, 24, 64)}


def _archive(seed, nsub, **kw):
    params = dict(nchan=24, nbin=64, n_rfi_cells=12, n_rfi_channels=2,
                  n_rfi_subints=3, n_prezapped=20)
    params.update(kw)
    ar, _ = ref_make_synthetic_archive(nsub=nsub, seed=seed, **params)
    return ar


def _assert_same_clean(got, want, scores_tol=None):
    np.testing.assert_array_equal(got.final_weights, want.final_weights)
    assert (got.loops, got.converged) == (want.loops, want.converged)
    np.testing.assert_array_equal(got.loop_diffs, want.loop_diffs)
    np.testing.assert_array_equal(got.iter_metrics[:, :2],
                                  want.iter_metrics[:, :2])
    if scores_tol is not None:
        np.testing.assert_allclose(got.scores, want.scores, **scores_tol)


@pytest.mark.parametrize("geom", sorted(GEOMS))
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_exact_matches_reference_streaming(route, geom):
    seed, nsub, chunk = GEOMS[geom]
    ar = _archive(seed, nsub)
    ref_cfg = RefConfig(dtype="float32", **ROUTES[route])
    want = ref_clean_streaming_exact(ar, chunk, ref_cfg)
    got = clean_streaming_exact(archive_from_reference(ar), chunk,
                                config_from_reference(ref_cfg, device="cpu"))
    _assert_same_clean(got, want, dict(rtol=1e-4, atol=1e-4))
    np.testing.assert_allclose(got.iter_metrics[:, 2:],
                               want.iter_metrics[:, 2:], rtol=1e-4)


@pytest.mark.parametrize("geom", sorted(GEOMS))
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_exact_matches_whole_clean(route, geom):
    """The port's exact streaming against its own whole clean: masks
    bit-equal; scores move only by the template's regrouped sum."""
    seed, nsub, chunk = GEOMS[geom]
    ar = archive_from_reference(_archive(seed, nsub))
    cfg = CleanConfig(device="cpu", **ROUTES[route])
    whole = clean_archive(ar, cfg)
    got = clean_streaming(ar, chunk, cfg)
    _assert_same_clean(got, whole, dict(rtol=1e-4, atol=1e-4))


def test_exact_dedispersed_input_matches_whole_clean():
    """A DEDISP=1 input takes the two_read route with the raw tiles kept
    (the preamble's in-place baseline subtraction must not reach them)."""
    ar = archive_from_reference(_archive(13, 40, disperse=False))
    ar.dedispersed = True
    cfg = CleanConfig(device="cpu")
    _assert_same_clean(clean_streaming(ar, 16, cfg), clean_archive(ar, cfg))
    _assert_same_clean(
        clean_streaming(ar, 16, CleanConfig(device="cpu", stream_hbm_mb=0)),
        clean_archive(ar, cfg))


def test_exact_majority_prezapped_subint():
    """A subint with most channels prezapped drives the plain rFFT
    scaler's MAD to zero; its inf/nan placement survives tiling."""
    ar, _ = ref_make_synthetic_archive(nsub=48, nchan=16, nbin=32, seed=23,
                                       n_rfi_cells=6)
    ar.weights[7, :14] = 0.0
    ar.weights[30, :15] = 0.0
    ref_cfg = RefConfig(dtype="float32")
    cfg = config_from_reference(ref_cfg, device="cpu")
    port_ar = archive_from_reference(ar)
    whole = clean_archive(port_ar, cfg)
    got = clean_streaming_exact(port_ar, 16, cfg)
    want = ref_clean_streaming_exact(ar, 16, ref_cfg)
    assert not np.isfinite(whole.scores).all()
    for other in (whole, want):
        np.testing.assert_array_equal(got.final_weights, other.final_weights)
        np.testing.assert_array_equal(np.isfinite(got.scores),
                                      np.isfinite(other.scores))
        np.testing.assert_array_equal(np.isnan(got.scores),
                                      np.isnan(other.scores))


def test_exact_record_history():
    ar = _archive(19, 24, nchan=16, nbin=32, n_rfi_cells=6)
    ref_cfg = RefConfig(dtype="float32", record_history=True)
    cfg = config_from_reference(ref_cfg, device="cpu")
    port_ar = archive_from_reference(ar)
    got = clean_streaming_exact(port_ar, 8, cfg)
    np.testing.assert_array_equal(
        got.weight_history, clean_archive(port_ar, cfg).weight_history)
    np.testing.assert_array_equal(
        got.weight_history, ref_clean_streaming_exact(ar, 8,
                                                      ref_cfg).weight_history)


def test_exact_non_f32_weights_loop_count():
    """Weights like 0.1 are not float32-representable: the history is
    seeded with the float32 values, so nothing zapped converges at once
    as in the whole clean."""
    ar = archive_from_reference(_archive(31, 48, nchan=16, nbin=32,
                                         n_rfi_cells=0, n_rfi_channels=0,
                                         n_rfi_subints=0))
    ar.weights[ar.weights > 0] = 0.1
    cfg = CleanConfig(device="cpu", chanthresh=50.0, subintthresh=50.0)
    whole = clean_archive(ar, cfg)
    got = clean_streaming_exact(ar, 16, cfg)
    assert whole.converged and got.converged and whole.loops == 1
    _assert_same_clean(got, whole)


def test_exact_bad_parts_on_the_reassembled_archive():
    ar = archive_from_reference(_archive(17, 48, nchan=20, nbin=32,
                                         n_rfi_cells=8, n_prezapped=12))
    ar.weights[5, :16] = 0.0
    cfg = CleanConfig(device="cpu", bad_subint=0.5)
    got = clean_streaming(ar, 16, cfg)
    np.testing.assert_array_equal(got.final_weights,
                                  clean_archive(ar, cfg).final_weights)
    assert got.n_bad_subints >= 1


# --- the budget: nothing pinned against everything pinned ------------------

def _budget_run(ar, mb, chunk=8, **kw):
    reg = DictRegistry()
    res = clean_streaming_exact(
        ar, chunk, CleanConfig(device="cpu", stream_hbm_mb=mb, **kw),
        registry=reg)
    return res, reg


@pytest.mark.parametrize("route", ["default", "pulse-window"])
def test_budget_zero_bit_equal_to_all_pinned(route):
    ar = archive_from_reference(_archive(29, 32, nchan=16, nbin=32,
                                         n_rfi_cells=8, n_prezapped=10))
    pinned, reg_p = _budget_run(ar, 64.0, chunk=4, **ROUTES[route])
    zero, reg_0 = _budget_run(ar, 0.0, chunk=4, **ROUTES[route])
    assert pinned.loops >= 2, "the fixture must iterate for this to bite"
    for a, b in ((pinned.final_weights, zero.final_weights),
                 (pinned.scores, zero.scores)):
        _bits_equal(a, b)
    np.testing.assert_array_equal(pinned.iter_metrics, zero.iter_metrics)
    cube = 32 * 16 * 32 * 4
    # default: one upload at the preamble, then two passes an iteration;
    # the raw tiles of the pulse window's integration route add one pass
    passes = 2 if route == "default" else 3
    assert reg_0.counters["stream_h2d_cube_bytes"] \
        == (1 + passes * zero.loops) * cube
    assert reg_p.counters["stream_h2d_cube_bytes"] == cube
    assert reg_0.gauges["stream_cache_resident_bytes"] == 0
    assert reg_p.counters["stream_cache_hits"] > 0
    # the one-tile lookahead: three tiles' inputs of the cube's eight
    tile_inputs = (1 if route == "default" else 2) * cube // 8
    assert reg_0.gauges["stream_cache_peak_bytes"] == 3 * tile_inputs


def test_stream_line_reads_the_engine_gauges():
    """The line chip_smoke.py and profile_iteration print of an exact
    stream: the gauges the engine sets on the CPU, plus the card's."""
    from iterative_cleaner_torch.profile_iteration import stream_line

    ar = archive_from_reference(_archive(29, 32, nchan=16, nbin=32))
    _, reg = _budget_run(ar, 0.0)
    gauges = dict(reg.gauges, stream_pass_ms_by_iteration=[[2.0, 3.0, 1.0],
                                                           [4.0, 5.0, 1.0]],
                  stream_h2d_copy_bytes=4e9, stream_h2d_copy_ms=100.0)
    line = stream_line(gauges)
    assert "template pass 3.00, diagnostics pass 4.00, combine 1.00" in line
    assert "(40.00 GB/s)" in line


def test_device_busy_leaves_out_annotations():
    """The device work profile_iteration unions into the busy share:
    kernels and copies, never a profiler range's device-side copy, which
    spans the whole iteration."""
    from types import SimpleNamespace as NS

    from iterative_cleaner_torch.profile_iteration import (
        _device_work,
        _union_ms,
    )

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def ev(name, dev, a, b, annotation=False):
        return NS(name=name, device_type=dev, is_user_annotation=annotation,
                  time_range=NS(start=a, end=b))

    events = [ev("icln_stream_iteration", cpu, 0, 1000, True),
              ev("icln_stream_iteration", cuda, 0, 1000),
              ev("another_range", cuda, 0, 1000, True),
              ev("cell_stats_kernel", cuda, 100, 300),
              ev("Memcpy HtoD (Pinned -> Device)", cuda, 200, 600),
              ev("aten::add", cpu, 0, 50)]
    work = list(_device_work(NS(events=lambda: events)))
    assert [e.name for e in work] == ["cell_stats_kernel",
                                      "Memcpy HtoD (Pinned -> Device)"]
    assert _union_ms([(e.time_range.start, e.time_range.end)
                      for e in work]) == 0.5


def test_default_budget_knob():
    """``stream_hbm_mb=None`` takes the CPU's default budget, which holds
    this archive whole; the masks equal budget 0's."""
    ar = archive_from_reference(_archive(29, 32, nchan=16, nbin=32))
    zero, reg_0 = _budget_run(ar, 0.0)
    assert reg_0.gauges["stream_cache_budget_bytes"] == 0
    default, reg_def = _budget_run(ar, None)
    assert reg_def.gauges["stream_cache_budget_bytes"] \
        == FALLBACK_BUDGET_BYTES
    _bits_equal(zero.final_weights, default.final_weights)


# --- tile cache and sweep policy (no device) -------------------------------

def test_resolve_budget_precedence():
    assert resolve_budget_bytes(8) == 8 * 2 ** 20
    assert resolve_budget_bytes(0) == 0
    assert resolve_budget_bytes(0.5) == 2 ** 19
    with pytest.raises(ValueError, match=">= 0"):
        resolve_budget_bytes(-1)
    with pytest.raises(ValueError, match=">= 0"):
        CleanConfig(device="cpu", stream_hbm_mb=-1)


def test_resolve_budget_card_fraction_and_cpu(monkeypatch):
    asked = []

    def mem_get_info(device):
        asked.append(device)
        return 10 * 2 ** 30, 80 * 2 ** 30

    monkeypatch.setattr(torch.cuda, "mem_get_info", mem_get_info)
    assert resolve_budget_bytes(None, torch.device("cuda")) \
        == int(80 * 2 ** 30 * DEFAULT_BUDGET_FRACTION)
    assert asked == [torch.device("cuda")]
    assert resolve_budget_bytes(None, "cpu") == FALLBACK_BUDGET_BYTES
    assert resolve_budget_bytes(None) == FALLBACK_BUDGET_BYTES


def _arr(n_bytes):
    return np.zeros(n_bytes, dtype=np.uint8)


def _cache(budget, plan=(), registry=None):
    uploads = []

    def upload(a):
        uploads.append(a.nbytes)
        return ("dev", id(a))

    cache = TileCache(budget, upload, registry=registry)
    cache.plan(plan)
    return cache, uploads


def _gauge(cache, name):
    cache.flush_stats()
    return cache.registry.gauges[f"stream_cache_{name}"]


def _count(cache, name):
    return cache.registry.counters.get(name, 0)


def test_hit_returns_pinned_handle_without_upload():
    c, uploads = _cache(1000, [(("k",), 100)])
    a = _arr(100)
    assert c.get(("k",), a) is c.get(("k",), a)
    assert len(uploads) == 1
    assert (_count(c, "stream_cache_hits"), _count(c, "stream_cache_misses"),
            _count(c, "stream_cache_hit_bytes")) == (1, 1, 100)
    assert _gauge(c, "resident_bytes") == 100 and c.holds(("k",))


def test_unplanned_keys_stay_transient():
    """Only the plan's keys are pinned: a cache with no plan, however
    large its budget, uploads on every call."""
    c, uploads = _cache(1000)
    for _ in range(3):
        c.get(("a",), _arr(100))
    assert len(uploads) == 3 and not c.holds(("a",))
    assert _gauge(c, "resident_bytes") == 0
    assert _count(c, "stream_cache_misses") == 3


def test_oversized_and_keyless_stay_transient():
    c, uploads = _cache(100, [(("big",), 200)])
    c.get(("big",), _arr(200))
    c.get(None, _arr(50))
    assert _gauge(c, "resident_bytes") == 0 and len(uploads) == 2
    assert _gauge(c, "peak_bytes") == 250
    c.mark_sync()
    c.get(None, _arr(10))
    assert _gauge(c, "peak_bytes") == 250


def test_plan_admission_first_fit():
    c, _ = _cache(250)
    assert c.plan([(("a",), 100), (("b",), 100), (("c",), 100)]) is False
    c.get(("c",), _arr(100))          # left out of the plan: transient
    assert _gauge(c, "resident_bytes") == 0 and not c.holds(("c",))
    c.get(("a",), _arr(100))
    c.get(("b",), _arr(100))
    assert _gauge(c, "resident_bytes") == 200
    assert c.holds(("a",)) and c.holds(("b",))
    assert c.plan([(("a",), 100), (("b",), 100)]) is True


def test_adopt_pins_without_h2d():
    c, _ = _cache(100, [(("d",), 80), (("too-big",), 200)])
    assert c.adopt(("d",), "handle", 80) is True
    assert _gauge(c, "resident_bytes") == 80
    assert _count(c, "stream_h2d_bytes") == 0
    assert _count(c, "stream_cache_adopted_bytes") == 80
    assert c.get(("d",), _arr(80)) == "handle"
    assert _count(c, "stream_h2d_bytes") == 0
    assert c.adopt(("too-big",), "x", 200) is False


def test_registry_mirrors_measured_transfers():
    reg = DictRegistry()
    c, _ = _cache(150, [(("cube", 0), 100), (("cube", 1), 100)],
                  registry=reg)
    assert c.registry is reg
    c.get(("cube", 0), _arr(100), cube=True)
    c.get(("w", 0), _arr(20))
    c.get(("cube", 0), _arr(100), cube=True)   # hit
    c.get(("cube", 1), _arr(100), cube=True)   # outside the plan
    c.count_d2h(8)
    c.flush_stats()
    assert reg.counters["stream_h2d_bytes"] == 220
    assert reg.counters["stream_h2d_cube_bytes"] == 200
    assert reg.counters["stream_h2d_uploads"] == 3
    assert reg.counters["stream_cache_hits"] == 1
    assert reg.counters["stream_cache_misses"] == 3
    assert reg.counters["stream_d2h_bytes"] == 8
    assert reg.gauges["stream_cache_peak_bytes"] == 220
    assert reg.gauges["stream_cache_resident_tiles"] == 1
    assert reg.gauges["stream_cache_budget_bytes"] == 150


def test_budget_zero_pins_nothing_but_still_meters():
    c, _ = _cache(0, [(("k",), 100)])
    c.get(("k",), _arr(100), cube=True)
    c.get(("k",), _arr(100), cube=True)
    assert _gauge(c, "resident_bytes") == 0
    assert _count(c, "stream_cache_hits") == 0
    assert _count(c, "stream_h2d_bytes") == 200
    with pytest.raises(ValueError, match=">= 0"):
        TileCache(-1, lambda a: "h")


def test_mark_sync_waits_for_the_drained_event():
    class Event:
        waited = 0

        def synchronize(self):
            Event.waited += 1

    c, _ = _cache(0)
    c.get(None, _arr(64))
    c.mark_sync(Event())
    assert Event.waited == 1
    c.get(None, _arr(16))
    assert _gauge(c, "peak_bytes") == 64


def _sweep_trace(n_tiles, depth):
    events = []
    pipelined_sweep(
        n_tiles,
        put=lambda i: events.append(("put", i)) or i,
        run=lambda i, ins: events.append(("run", i)) or i,
        drain=lambda i, out: events.append(("drain", i)),
        depth=depth)
    return events


@pytest.mark.parametrize("n_tiles", [2, 4, 7])
def test_sweep_depth1_is_one_tile_lookahead(n_tiles):
    ev = _sweep_trace(n_tiles, depth=1)
    for i in range(2, n_tiles):
        assert ev.index(("drain", i - 2)) < ev.index(("run", i))
    for i in range(1, n_tiles):   # the next upload overlaps this tile
        assert ev.index(("put", i)) < ev.index(("drain", i - 1))
    assert [e for e in ev if e[0] == "drain"] == \
        [("drain", i) for i in range(n_tiles)]


def test_sweep_full_depth_dispatches_whole_pass_first():
    ev = _sweep_trace(4, depth=4)
    assert max(ev.index(("run", i)) for i in range(4)) < \
        ev.index(("drain", 0))
    assert [e for e in ev if e[0] == "drain"] == \
        [("drain", i) for i in range(4)]


def test_sweep_trivial_sizes():
    assert _sweep_trace(0, depth=1) == []
    assert [e[0] for e in _sweep_trace(1, depth=3)] == \
        ["put", "run", "drain"]


# --- online mode ------------------------------------------------------------

def _small(seed, **kw):
    params = dict(nsub=8, nchan=16, nbin=32)
    params.update(kw)
    ar, _ = ref_make_synthetic_archive(seed=seed, **params)
    return ar


ONLINE_REF = RefConfig(rotation="roll", dtype="float32")
ONLINE = config_from_reference(ONLINE_REF, device="cpu")


def test_online_single_tile_matches_whole_clean():
    ar = archive_from_reference(_small(30))
    whole = clean_archive(ar, ONLINE)
    online = clean_streaming(ar, ar.nsub, ONLINE, mode="online")
    np.testing.assert_array_equal(whole.final_weights, online.final_weights)
    assert (whole.loops, whole.converged) == (online.loops, online.converged)


def test_online_tiles_and_partial_padding():
    ar = archive_from_reference(_small(31))
    sc = StreamingCleaner(6, ONLINE, ar.freqs_mhz, ar.dm, ar.centre_freq_mhz,
                          ar.period_s)
    cube = ar.total_intensity()
    tiles = list(sc.push(cube[:5], ar.weights[:5]))
    assert tiles == []
    tiles += list(sc.push(cube[5:], ar.weights[5:]))
    assert len(tiles) == 1 and tiles[0].n_valid == 6
    tiles += list(sc.finish())
    assert len(tiles) == 2 and tiles[1].n_valid == 2
    assert tiles[1].weights.shape == (2, ar.nchan)
    assert tiles[1].result.final_weights.shape == (6, ar.nchan)
    assert np.all(tiles[1].result.final_weights[2:] == 0)   # the padding
    assert tiles[0].start_subint == 0 and tiles[1].start_subint == 6


def test_online_incremental_equals_bulk():
    ar = archive_from_reference(_small(32))
    cube = ar.total_intensity()

    def run(pushes):
        sc = StreamingCleaner(4, ONLINE, ar.freqs_mhz, ar.dm,
                              ar.centre_freq_mhz, ar.period_s)
        tiles = []
        for lo, hi in pushes:
            tiles += list(sc.push(cube[lo:hi], ar.weights[lo:hi]))
        tiles += list(sc.finish())
        return np.concatenate([t.weights for t in tiles])

    np.testing.assert_array_equal(run([(0, 8)]), run([(0, 1), (1, 3),
                                                      (3, 8)]))


@pytest.mark.parametrize("nsub,chunk,sweep", [(8, 4, False), (7, 4, True),
                                              (20, 6, False)])
def test_online_matches_reference(nsub, chunk, sweep):
    """Tile by tile (a padded final tile included), and with the bad-parts
    sweep once over the reassembled archive."""
    ar = _small(33 + nsub, nsub=nsub)
    kw = dict(bad_chan=0.5, bad_subint=0.5) if sweep else {}
    ref_cfg = RefConfig(rotation="roll", dtype="float32", **kw)
    want = ref_clean_streaming(ar, chunk, ref_cfg, mode="online")
    got = clean_streaming(archive_from_reference(ar), chunk,
                          config_from_reference(ref_cfg, device="cpu"),
                          mode="online")
    np.testing.assert_array_equal(got.final_weights, want.final_weights)
    assert (got.loops, got.converged) == (want.loops, want.converged)
    np.testing.assert_allclose(got.scores, want.scores, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got.iter_metrics[:, :2],
                                  want.iter_metrics[:, :2])
    assert (got.n_bad_subints, got.n_bad_channels) == \
        (want.n_bad_subints, want.n_bad_channels)


# --- refusals and the CLI ---------------------------------------------------

def test_refusals():
    ar = archive_from_reference(_small(1))
    cfg = CleanConfig(device="cpu")
    with pytest.raises(ValueError, match="unload_res"):
        clean_streaming_exact(ar, 4, CleanConfig(device="cpu",
                                                 unload_res=True))
    # a mesh whose 'sub' axis does not divide the tile: refused before any
    # work (the streamed shard route; tests/test_torch_shard_stream.py)
    mesh = types.SimpleNamespace(shape=(3, 1), rank=0, coords=(0, 0))
    for call in (lambda: clean_streaming_exact(ar, 4, cfg, mesh=mesh),
                 lambda: clean_streaming(ar, 4, cfg, mesh=mesh),
                 lambda: clean_streaming(ar, 4, cfg, mesh=mesh,
                                         mode="online"),
                 lambda: StreamingCleaner(4, cfg, ar.freqs_mhz, ar.dm,
                                          ar.centre_freq_mhz, ar.period_s,
                                          mesh=mesh)):
        with pytest.raises(ValueError, match="must divide the tile grid"):
            call()
    for chunk in (0, -3):
        with pytest.raises(ValueError, match="chunk_nsub"):
            clean_streaming(ar, chunk, cfg)
        with pytest.raises(ValueError, match="chunk_nsub"):
            clean_streaming(ar, chunk, cfg, mode="online")
    with pytest.raises(ValueError, match="mode"):
        clean_streaming(ar, 4, cfg, mode="bogus")


def test_cli_stream_matches_whole_clean(tmp_path, monkeypatch):
    ar = archive_from_reference(_archive(5, 48))
    path = str(tmp_path / "obs.npz")
    save_archive(ar, path)
    monkeypatch.chdir(tmp_path)
    assert cli_main(["--device", "cpu", "-o", "whole.npz", path]) == 0
    assert cli_main(["--device", "cpu", "--stream", "16", "--stream_hbm_mb",
                     "0", "-o", "exact.npz", path]) == 0
    assert cli_main(["--device", "cpu", "--stream", "16", "--stream_mode",
                     "online", "-o", "online.npz", path]) == 0
    whole = load_archive("whole.npz").weights
    np.testing.assert_array_equal(load_archive("exact.npz").weights, whole)
    online = load_archive("online.npz").weights
    assert online.shape == whole.shape
    assert np.mean((online == 0) != (whole == 0)) < 0.05
    with open("clean.log") as f:
        assert "stream='16'" in f.read()


def test_online_unload_res_reassembles_the_residual():
    ar = archive_from_reference(_small(35, nsub=7))
    cfg = CleanConfig(device="cpu", rotation="roll", unload_res=True)
    got = clean_streaming(ar, 4, cfg, mode="online")
    sc = StreamingCleaner(4, cfg, ar.freqs_mhz, ar.dm, ar.centre_freq_mhz,
                          ar.period_s)
    tiles = list(sc.push(ar.total_intensity(), ar.weights)) \
        + list(sc.finish())
    assert got.residual.shape == ar.total_intensity().shape
    np.testing.assert_array_equal(got.residual[:4], tiles[0].result.residual)
    np.testing.assert_array_equal(got.residual[4:],
                                  tiles[1].result.residual[:3])


def test_cli_stream_directory_refused(tmp_path):
    """A directory is the online mode (ported), which takes no archive
    argument: a parser error, as in the reference."""
    path = str(tmp_path / "obs.npz")
    save_archive(archive_from_reference(_small(2)), path)
    with pytest.raises(SystemExit) as ei:
        cli_main(["--device", "cpu", "--stream", str(tmp_path), path])
    assert ei.value.code == 2
    with pytest.raises(ValueError, match=">= 0"):
        cli_main(["--device", "cpu", "--stream", "-2", path])
    assert not os.path.exists(path + "_cleaned.npz")
