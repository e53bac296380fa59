"""The port's mixed-precision mode (``compute_dtype='bfloat16'``: the cube
stored in bf16, every stage computing in float32) against the JAX
package's, on the CPU (every kernel through its plain version, the JAX
Pallas kernels in interpret mode).

- The knob: validation, the ``ICLEAN_COMPUTE_DTYPE`` mirror, the
  degradation ladder's two rungs (``reason=dtype``, ``reason=parity_probe``)
  and their ``compute_dtype_ineligible{stage=,reason=}`` counters, the
  probe passing here, the CLI flags.
- Parity with JAX, on the reference's bf16-exact archive (bit for bit the
  reference test's construction) and on a general synthetic archive, each
  against the JAX bf16 route in its kernel form (fused stats, DFT,
  Pallas medians, one-launch sweep; interpret mode) and its default CPU
  form.  Masks, loops and per-loop diffs are equal.  On the bf16-exact
  archive each package's bf16 clean is bit-equal to its own float32
  clean (the storage is lossless there), so the port's floats differ from
  JAX's only as their float32 cleans do: float32 sums in another order,
  which the near-empty residuals of that archive amplify to 1e-3 of a
  score.  On the general archive both round their own float32 preamble's
  output to bf16; an element whose two float32 values straddle a bf16
  rounding boundary then differs by one bf16 step (2**-8 relative), so
  scores agree to rtol 1e-2 with the kernel form and 5e-2 with the
  default form (whose multi-kernel default route also rounds its Nyquist
  correction rows to bf16, where its sweep and the port keep them
  float32).
- Each kernel module's plain version on a bf16 cube: against the Pallas
  function on the same bf16 cube, and bit-equal to its own float32 form
  on ``cube.float()`` (batched too).
- The routes: the batch against the JAX ``clean_archives_batched`` and
  bit-equal to the port's single cleans; exact streaming (masks equal,
  the cube bytes uploaded exactly halved), in integration mode with the
  raw tiles kept, online; a two-rank gloo mesh.
- The three CLI flags the reference accepts (``--rotation``,
  ``--record_history``, ``--memory``) against the JAX CLI.
"""

import os
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from iterative_cleaner_torch import CleanConfig
from iterative_cleaner_torch import cli
from iterative_cleaner_torch.backends import clean_archive
from iterative_cleaner_torch.backends import torch_backend as tb
from iterative_cleaner_torch.convert import (
    archive_from_reference,
    config_from_reference,
)
from iterative_cleaner_torch.engine.loop import store_prepared, Prepared
from iterative_cleaner_torch.io import load_archive, save_archive
from iterative_cleaner_torch.io.synthetic import make_bf16_exact_archive
from iterative_cleaner_torch.parallel import clean_streaming
from iterative_cleaner_torch.parallel.batch import clean_archives_batched
from iterative_cleaner_torch.parallel.distributed import run_local_ranks
from iterative_cleaner_torch.parallel.streaming_exact import host_store_tile
from iterative_cleaner_torch.parallel.tile_cache import DictRegistry
from iterative_cleaner_torch.stats import kernels as tk
from iterative_cleaner_torch.telemetry.registry import (
    MetricsRegistry,
    labeled,
)
from iterative_cleaner_tpu import cli as ref_cli
from iterative_cleaner_tpu.backends import clean_archive as ref_clean_archive
from iterative_cleaner_tpu.config import CleanConfig as RefConfig
from iterative_cleaner_tpu.io import load_archive as ref_load_archive
from iterative_cleaner_tpu.io import save_archive as ref_save_archive
from iterative_cleaner_tpu.io.synthetic import (
    make_synthetic_archive as ref_make_synthetic_archive,
)
from iterative_cleaner_tpu.parallel import (
    clean_archives_batched as ref_clean_archives_batched,
)
from iterative_cleaner_tpu.parallel import (
    clean_streaming_exact as ref_clean_streaming_exact,
)
from iterative_cleaner_tpu.stats import pallas_kernels as pk
from tests.test_mixed_precision import _bf16_exact_archive
from tests.test_torch_kernels import (
    _bits_equal,
    _cell_inputs,
    _ded_inputs,
    _t,
)
from tests.torch_shard_ranks import clean_rank, jobs_rank

BF16 = dict(compute_dtype="bfloat16")
KERNEL_FORM = dict(stats_impl="fused", fft_mode="dft", median_impl="pallas",
                   fused_sweep="on")
ROUTES = {"default": dict(), "profile": dict(baseline_mode="profile"),
          "dedispersed": dict(stats_frame="dedispersed")}


def _cpu(**kw):
    return CleanConfig(device="cpu", **kw)


def _exact_cfg(**kw):
    """The reference mixed-precision tests' configuration: roll rotation
    (a zero fourier shift is not an exact identity), three iterations."""
    kw.setdefault("rotation", "roll")
    kw.setdefault("max_iter", 3)
    return _cpu(**kw)


def _same_clean(got, want, scores=True):
    np.testing.assert_array_equal(got.final_weights, want.final_weights)
    assert (got.loops, got.converged) == (want.loops, want.converged)
    np.testing.assert_array_equal(got.loop_diffs, want.loop_diffs)
    if scores:
        _bits_equal(got.scores, want.scores)
        _bits_equal(got.iter_metrics, want.iter_metrics)


# ------------------------------------------------------------- the knob

@pytest.mark.parametrize("kwargs,match", [
    (dict(compute_dtype="float16"), "unknown compute dtype"),
    (dict(compute_dtype="float64"), "unknown compute dtype"),
    (dict(dtype="float64", compute_dtype="bfloat16"),
     "requires dtype='float32'"),
    (dict(dtype="bfloat16"), "compute_dtype='bfloat16'"),
])
def test_config_validation(kwargs, match):
    with pytest.raises(ValueError, match=match):
        _cpu(**kwargs)
    assert _cpu(compute_dtype="bfloat16").compute_dtype == "bfloat16"
    assert _cpu().compute_dtype is None


def test_resolve_default_env_and_validation(monkeypatch):
    monkeypatch.delenv("ICLEAN_COMPUTE_DTYPE", raising=False)
    assert tb.resolve_compute_dtype(None) == "float32"
    assert tb.resolve_compute_dtype("float32", "float64") == "float32"
    with pytest.raises(ValueError, match="unknown compute dtype"):
        tb.resolve_compute_dtype("float16")
    # the mirror fills an unset knob only; an explicit value wins
    monkeypatch.setenv("ICLEAN_COMPUTE_DTYPE", "bfloat16")
    assert tb.resolve_compute_dtype("float32") == "float32"
    assert tb.resolve_compute_dtype(None) == "bfloat16"
    assert tb.config_compute_dtype(_cpu(), "engine", "cpu") == "bfloat16"
    monkeypatch.setenv("ICLEAN_COMPUTE_DTYPE", "float16")
    with pytest.raises(ValueError, match="unknown compute dtype"):
        tb.resolve_compute_dtype(None)


def test_env_mirror_runs_the_bf16_mode(monkeypatch):
    """``ICLEAN_COMPUTE_DTYPE=bfloat16`` under a config that leaves the
    knob unset stores bf16: the exact stream's cube uploads halve."""
    ar = make_bf16_exact_archive()
    h2d = {}
    for env in ("float32", "bfloat16"):
        monkeypatch.setenv("ICLEAN_COMPUTE_DTYPE", env)
        reg = DictRegistry()
        clean_streaming(ar, 2, _exact_cfg(max_iter=2), registry=reg)
        h2d[env] = reg.counters["stream_h2d_cube_bytes"]
    assert h2d["bfloat16"] * 2 == h2d["float32"]


def test_resolve_downgrades_wide_dtype_with_counter(capsys):
    key = labeled("compute_dtype_ineligible", stage="t_wide", reason="dtype")
    before = tb.compute_dtype_ineligible_counts().get(key, 0)
    reg = MetricsRegistry()
    for _ in range(2):
        assert tb.resolve_compute_dtype("bfloat16", "float64",
                                        stage="t_wide",
                                        registry=reg) == "float32"
    assert tb.compute_dtype_ineligible_counts()[key] == before + 2
    assert reg.counters[key] == 2
    # the notice prints once per (stage, reason) in a process
    assert capsys.readouterr().err.count("stage 't_wide' (dtype)") <= 1


def test_forced_probe_mismatch_downgrades_per_stage(monkeypatch, capsys):
    monkeypatch.setitem(tb._COMPUTE_DTYPE_PROBE_CACHE, "cpu", False)
    reg = MetricsRegistry()
    for stage in ("t_probe_a", "t_probe_b", "t_probe_a"):
        assert tb.resolve_compute_dtype("bfloat16", "float32", stage=stage,
                                        registry=reg) == "float32"
    a, b = (labeled("compute_dtype_ineligible", stage=s,
                    reason="parity_probe") for s in ("t_probe_a", "t_probe_b"))
    assert (reg.counters[a], reg.counters[b]) == (2, 1)
    err = capsys.readouterr().err
    assert err.count("stage 't_probe_a' (parity_probe)") == 1
    assert err.count("stage 't_probe_b' (parity_probe)") == 1
    # a rung, not an error: the clean runs, in float32
    ar = make_bf16_exact_archive(4, 8, 32)
    got = clean_archive(ar, _exact_cfg(max_iter=2, **BF16))
    _same_clean(got, clean_archive(ar, _exact_cfg(max_iter=2)))
    engine = labeled("compute_dtype_ineligible", stage="engine",
                     reason="parity_probe")
    assert tb.compute_dtype_ineligible_counts()[engine] >= 1


def test_probe_passes_on_the_cpu(monkeypatch):
    """The probe itself (not its cache) passes here, on every route: else
    the parity tests below would compare float32 with float32."""
    monkeypatch.delitem(tb._COMPUTE_DTYPE_PROBE_CACHE, "cpu", raising=False)
    assert tb._compute_dtype_probe_ok("cpu")
    assert tb.resolve_compute_dtype("bfloat16", "float32") == "bfloat16"
    assert tb._COMPUTE_DTYPE_PROBE_CACHE["cpu"] is True
    cube = tb.bf16_exact_micro_cube()
    assert cube.dtype == torch.float32 and tuple(cube.shape) == (4, 8, 32)
    assert torch.equal(cube.to(torch.bfloat16).float(), cube)


def test_cli_flags_parse_into_config():
    parser = cli.build_parser()
    for flag in ("--compute-dtype", "--compute_dtype"):
        cfg = cli.config_of(parser.parse_args([flag, "bfloat16", "x.npz"]))
        assert cfg.compute_dtype == "bfloat16"
    args = parser.parse_args(["x.npz"])
    cfg = cli.config_of(args)
    assert (cfg.compute_dtype, cfg.rotation, cfg.record_history,
            args.memory) == (None, "fourier", False, False)
    args = parser.parse_args(["--rotation", "roll", "--record_history",
                              "--memory", "x.npz"])
    cfg = cli.config_of(args)
    assert (cfg.rotation, cfg.record_history, args.memory) == (
        "roll", True, True)
    with pytest.raises(SystemExit):
        parser.parse_args(["--compute-dtype", "float16", "x.npz"])


def test_store_prepared_narrows_the_cubes_once():
    cube = torch.randn(4, 8, 32)
    shifts, offsets = torch.zeros(8), torch.zeros(4, 8)
    prep = Prepared("default", shifts, None, cube, cube, offsets, None)
    assert store_prepared(prep, "float32") is prep
    out = store_prepared(prep, "bfloat16")
    assert out.disp_base is out.disp_clean
    assert out.disp_base.dtype == torch.bfloat16
    assert out.back_shifts is shifts and out.base_offsets is offsets
    assert torch.equal(out.disp_base, cube.to(torch.bfloat16))


def test_host_store_rounds_as_ml_dtypes():
    """float64 host values go to bf16 as the reference's ml_dtypes
    ``astype`` takes them (through float32, round to nearest even each
    step), bit for bit, on values next to bf16 ties."""
    import ml_dtypes

    rng = np.random.default_rng(0)
    base = np.float64(1.0) + np.float64(2.0 ** -8)        # a bf16 tie
    near = base + np.array([-2.0 ** -30, -2.0 ** -25, 0.0, 2.0 ** -30,
                            2.0 ** -25, 2.0 ** -24, 2.0 ** -23, 3 * 2.0 ** -24])
    vals = np.concatenate([near, -near, near * 2.0 ** 40,
                           rng.normal(0.0, 100.0, 4000)]).reshape(4, 1, -1)
    dst = torch.empty(vals.shape, dtype=torch.bfloat16)
    host_store_tile(dst, vals)
    want = vals.astype(ml_dtypes.bfloat16)
    np.testing.assert_array_equal(dst.view(torch.int16).numpy(),
                                  want.view(np.int16))


# ------------------------------------------------------ parity with JAX

def _parity_case(kind):
    if kind == "bf16-exact":
        return _bf16_exact_archive(), dict(rotation="roll")
    ar, _ = ref_make_synthetic_archive(nsub=16, nchan=32, nbin=64,
                                       n_prezapped=5, seed=3)
    return ar, dict()


@pytest.mark.parametrize("form", ["jax-kernels", "jax-default"])
@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("kind", ["bf16-exact", "synthetic"])
def test_bf16_clean_matches_jax(kind, route, form):
    ar, kw = _parity_case(kind)
    jax_form = KERNEL_FORM if form == "jax-kernels" else {}
    ref_cfg = RefConfig(backend="jax", dtype="float32", max_iter=3,
                        **kw, **ROUTES[route], **jax_form, **BF16)
    want = ref_clean_archive(ar.clone(), ref_cfg)
    cfg = config_from_reference(ref_cfg, device="cpu")
    assert cfg.compute_dtype == "bfloat16"
    got = clean_archive(archive_from_reference(ar), cfg)
    _same_clean(got, want, scores=False)
    np.testing.assert_array_equal(got.iter_metrics[:, :2],
                                  want.iter_metrics[:, :2])
    if kind == "bf16-exact":
        # each package's bf16 clean is its float32 clean, bit for bit
        import dataclasses

        f32 = dataclasses.replace(ref_cfg, compute_dtype="float32")
        _same_clean(clean_archive(archive_from_reference(ar),
                                  config_from_reference(f32, device="cpu")),
                    got)
        ref32 = ref_clean_archive(ar.clone(), f32)
        _bits_equal(ref32.scores, want.scores)
        rtol = 1e-3
    else:
        rtol = 1e-2 if form == "jax-kernels" else 5e-2
    np.testing.assert_allclose(got.scores, want.scores, rtol=rtol, atol=rtol)
    np.testing.assert_allclose(got.iter_metrics[:, 2:],
                               want.iter_metrics[:, 2:], rtol=rtol)


def test_bf16_exact_archive_is_the_references():
    mine, theirs = make_bf16_exact_archive(), _bf16_exact_archive()
    for field in ("data", "weights", "freqs_mhz"):
        a, b = getattr(mine, field), getattr(theirs, field)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), field
    for field in ("period_s", "dm", "centre_freq_mhz", "source", "pol_state"):
        assert getattr(mine, field) == getattr(theirs, field), field


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_bf16_masks_equal_float32_on_bf16_exact(route):
    """The reference's ``test_engine_masks_bit_equal_on_bf16_exact_cube``
    for the port, on every route: masks (and here scores) of the bf16
    clean equal the float32 clean's, and the zap fires."""
    ar = make_bf16_exact_archive()
    w32 = clean_archive(ar, _exact_cfg(**ROUTES[route]))
    w16 = clean_archive(ar, _exact_cfg(**ROUTES[route], **BF16))
    _same_clean(w16, w32)
    assert np.sum(w16.final_weights == 0) > 0


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_pieces_of_subints(monkeypatch, route):
    """With pieces of 3 subints (``ops.dsp.UPCAST_CHUNK_BYTES``), the bf16
    preamble and the template stage's products run piece by piece: the
    clean keeps its masks and loops, and a batch stays bit-equal to its
    single cleans.  The pieces' float32 preamble differs from the whole
    one's in the last bits (float32 reassociation), which bf16 rounding
    turns into one bf16 step of some elements: scores within rtol 1e-2,
    as against JAX's on a general archive."""
    from iterative_cleaner_torch.ops import dsp

    ar = archive_from_reference(ref_make_synthetic_archive(
        nsub=16, nchan=32, nbin=64, n_prezapped=5, seed=3)[0])
    cfg = _cpu(**ROUTES[route], **BF16)
    whole = clean_archive(ar, cfg)
    monkeypatch.setattr(dsp, "UPCAST_CHUNK_BYTES", 3 * 4 * 32 * 64)
    assert len(dsp.subint_chunks(16, 32, 64)) == 6
    got = clean_archive(ar, cfg)
    _same_clean(got, whole, scores=False)
    np.testing.assert_allclose(got.scores, whole.scores, rtol=1e-2,
                               atol=1e-2)
    two = clean_archives_batched([ar, ar], cfg)
    _same_clean(two[1], got)


# ------------------------------------------------- each kernel module

def _bf16(a):
    """A float32 array rounded to bf16: (the bf16 tensor, its exact
    float32 values as a tensor, the bf16 array for JAX)."""
    t = _t(a).to(torch.bfloat16)
    return t, t.float(), jnp.asarray(a, jnp.bfloat16)


def _planes_bits(got, want):
    for g, w in zip(got, want):
        _bits_equal(g.numpy(), w.numpy())


def _planes_close(got, want, mask):
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        scale = np.abs(w).max()
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * scale)
        _bits_equal(g[mask], w[mask])


def test_k1_plain_on_a_bf16_cube():
    rng = np.random.default_rng(1)
    disp = rng.normal(5.0, 3.0, (16, 32, 64)).astype(np.float32)
    w = (rng.random((16, 32)) > 0.1).astype(np.float32)
    d16, d32, dj = _bf16(disp)
    a, t1 = tk.weighted_marginals(d16, _t(w))
    a32, t132 = tk.weighted_marginals(d32, _t(w))
    _bits_equal(a.numpy(), a32.numpy())
    _bits_equal(t1.numpy(), t132.numpy())
    ra, rt1 = pk.weighted_marginals_pallas(dj, jnp.asarray(w))
    absw = np.abs(d32.numpy() * w[..., None])
    np.testing.assert_array_less(np.abs(a.numpy() - np.asarray(ra)),
                                 1e-5 * absw.sum(axis=0) + 1e-30)
    np.testing.assert_array_less(np.abs(t1.numpy() - np.asarray(rt1)),
                                 1e-5 * absw.sum(axis=1) + 1e-30)
    # batched: each archive's the single call's
    d2 = torch.stack([d16, d16.flip(0)])
    a2, t2 = tk.weighted_marginals(d2, _t(np.stack([w, w[::-1]])))
    _bits_equal(a2[0].numpy(), a.numpy())
    _bits_equal(t2[1].numpy(),
                tk.weighted_marginals(d16.flip(0), _t(w[::-1].copy()))[1]
                .numpy())


@pytest.mark.parametrize("rotation", ["fourier", "roll"])
def test_k2_and_k10_plain_on_a_bf16_cube(rotation):
    x = _cell_inputs(16, 32, 64, rotation, seed=2)
    d16, d32, dj = _bf16(x["disp"])
    nyq = None if x["nyq"] is None else _t(x["nyq"])
    args = (_t(x["rot_t"]), nyq, _t(x["template"]), _t(x["weights"]),
            _t(x["mask"]))
    got = tk.cell_diagnostics_disp(d16, *args)
    _planes_bits(got, tk.cell_diagnostics_disp(d32, *args))
    _planes_bits(tk.shard_diagnostics_disp(d16, *args), got)
    want = pk.cell_diagnostics_pallas_disp(
        dj, jnp.asarray(x["rot_t"]),
        None if x["nyq"] is None else jnp.asarray(x["nyq"]),
        jnp.asarray(x["template"]), jnp.asarray(x["weights"]),
        jnp.asarray(x["mask"]))
    _planes_close(got, want, x["mask"])
    # batched
    two = tk.cell_diagnostics_disp(
        torch.stack([d16, d16]), *(None if a is None else torch.stack([a, a])
                                   for a in args))
    for g, w in zip(two, got):
        _bits_equal(g[1].numpy(), w.numpy())


@pytest.mark.parametrize("window_on", [False, True])
def test_k7_k6_plain_on_bf16_cubes(window_on):
    x = _ded_inputs(16, 32, 64, "fourier", window_on, seed=7)
    ded16, ded32, dedj = _bf16(x["ded"])
    base16, base32, basej = _bf16(x["disp_base"])
    w, m = _t(x["weights"]), _t(x["mask"])
    got = tk.cell_diagnostics_two_read(ded16, base16, _t(x["rot_t"]),
                                       _t(x["template"]), w, m)
    _planes_bits(got, tk.cell_diagnostics_two_read(
        ded32, base32, _t(x["rot_t"]), _t(x["template"]), w, m))
    want = pk.cell_diagnostics_pallas(
        dedj, basej, jnp.asarray(x["rot_t"]), jnp.asarray(x["template"]),
        jnp.asarray(x["weights"]), jnp.asarray(x["mask"]))
    _planes_close(got, want, x["mask"])
    window = _t(x["window"])
    got = tk.cell_diagnostics_dedisp(ded16, _t(x["template"]), window, w, m)
    _planes_bits(got, tk.cell_diagnostics_dedisp(ded32, _t(x["template"]),
                                                 window, w, m))
    _planes_bits(tk.shard_diagnostics_dedisp(ded16, _t(x["template"]),
                                             window, w, m), got)
    want = pk.cell_diagnostics_pallas_dedisp(
        dedj, jnp.asarray(x["template"]), jnp.asarray(x["window"]),
        jnp.asarray(x["weights"]), jnp.asarray(x["mask"]))
    _planes_close(got, want, x["mask"])


def test_bf16_plans_fit_a_block():
    """K1's and the cell kernels' launch plans for a bf16 cube: the
    shared memory they need fits a block and is less than float32's."""
    for nbin in (32, 36, 64, 128, 132, 512, 4096, 16384):
        p16, p32 = tk.cell_stats_geometry(nbin, 2), tk.cell_stats_geometry(nbin)
        assert p16.smem <= tk._SMEM_LIMIT
        assert p16.smem == tk.cell_stats_smem(nbin, p16.group, p16.kchunk,
                                              p16.bchunk, 2)
        if p16[:-1] == p32[:-1]:
            assert p16.smem < p32.smem or p16.group == 1
        m16 = tk.marginals_tiles(64, 4096, nbin, itemsize=2)
        m32 = tk.marginals_tiles(64, 4096, nbin)
        assert m16[:-1] == m32[:-1] and m16.smem < m32.smem <= tk._SMEM_LIMIT


# ------------------------------------------------------------ the routes

def test_batch_matches_jax_and_single_cleans():
    seeds = (0, 1, 2)
    cfg = _exact_cfg(max_iter=2, **BF16)
    got = clean_archives_batched([make_bf16_exact_archive(seed=s)
                                  for s in seeds], cfg)
    want = ref_clean_archives_batched(
        [_bf16_exact_archive(seed=s) for s in seeds],
        RefConfig(backend="jax", dtype="float32", rotation="roll",
                  max_iter=2, **BF16))
    f32 = clean_archives_batched([make_bf16_exact_archive(seed=s)
                                  for s in seeds], _exact_cfg(max_iter=2))
    for s, g, w, g32 in zip(seeds, got, want, f32):
        np.testing.assert_array_equal(g.final_weights, w.final_weights)
        _same_clean(g, g32)
        _same_clean(g, clean_archive(make_bf16_exact_archive(seed=s), cfg))
    # a general archive: bf16-lossy, still each archive's single clean
    ars = [archive_from_reference(ref_make_synthetic_archive(
        nsub=8, nchan=16, nbin=64, n_prezapped=3, seed=s)[0]) for s in (4, 5)]
    for a, g in zip(ars, clean_archives_batched(ars, _cpu(**BF16))):
        _same_clean(g, clean_archive(a, _cpu(**BF16)))


@pytest.mark.parametrize("route", ["default", "dedispersed"])
def test_exact_stream_masks_and_halved_uploads(route):
    """The reference's ``test_streaming_masks_bit_equal_and_h2d_halves``:
    masks equal the float32 stream's (and JAX's bf16 stream's), the
    bytes uploaded fall by exactly half the float32 cube, and the tile
    cache holds half the bytes.  The dedispersed frame under the
    integration baseline keeps the raw tiles (bf16 too)."""
    ar = make_bf16_exact_archive()
    res, h2d, peak = {}, {}, {}
    for mode in ("float32", "bfloat16"):
        reg = DictRegistry()
        res[mode] = clean_streaming(
            ar, 2, _exact_cfg(max_iter=2, compute_dtype=mode,
                              **ROUTES[route]), registry=reg)
        h2d[mode] = reg.counters["stream_h2d_bytes"]
        peak[mode] = reg.gauges["stream_cache_peak_bytes"]
    _same_clean(res["bfloat16"], res["float32"], scores=False)
    # every tile pinned: the cube is uploaded once (the raw tiles), the
    # planes' uploads are float32 in both runs
    cube_f32 = ar.nsub * ar.nchan * ar.nbin * 4
    assert h2d["float32"] - h2d["bfloat16"] == cube_f32 // 2, h2d
    assert 2 * peak["bfloat16"] == peak["float32"] > 0, peak
    want = ref_clean_streaming_exact(
        _bf16_exact_archive(), 2,
        RefConfig(backend="jax", dtype="float32", rotation="roll",
                  max_iter=2, **ROUTES[route], **BF16))
    np.testing.assert_array_equal(res["bfloat16"].final_weights,
                                  want.final_weights)


def test_exact_stream_general_archive_matches_jax():
    """A bf16-lossy archive: the stream quantizes the raw tiles before the
    preamble (the reference's points), and its masks are JAX's; every
    tile pinned or none, bit for bit."""
    ar, _ = ref_make_synthetic_archive(nsub=16, nchan=32, nbin=64,
                                       n_prezapped=5, seed=3)
    ref_cfg = RefConfig(backend="jax", dtype="float32", max_iter=3, **BF16)
    want = ref_clean_streaming_exact(ar.clone(), 4, ref_cfg)
    cfg = config_from_reference(ref_cfg, device="cpu")
    got = clean_streaming(archive_from_reference(ar), 4, cfg)
    np.testing.assert_array_equal(got.final_weights, want.final_weights)
    assert got.loops == want.loops
    import dataclasses

    none = clean_streaming(archive_from_reference(ar), 4,
                           dataclasses.replace(cfg, stream_hbm_mb=0))
    _same_clean(none, got)


def test_online_stream_masks_equal_float32():
    ar = make_bf16_exact_archive(16, 16, 32)
    got = clean_streaming(ar, 8, _exact_cfg(max_iter=2, **BF16),
                          mode="online")
    want = clean_streaming(ar, 8, _exact_cfg(max_iter=2), mode="online")
    _same_clean(got, want, scores=False)
    _bits_equal(got.scores, want.scores)


def test_two_rank_mesh(tmp_path):
    """The cell-sharded clean on two gloo ranks (K10's plain version on
    each rank's bf16 block): masks equal the rank's float32 clean and
    the single-device bf16 clean; one rank bit-equal to the whole
    clean."""
    ar = make_bf16_exact_archive(8, 16, 32)
    path = str(tmp_path / "obs.npz")
    save_archive(ar, path)
    kwargs = [dict(rotation="roll", max_iter=2, stats_frame=f, **cd)
              for f in ("dispersed", "dedispersed") for cd in (BF16, {})]
    for n in (1, 2):
        ranks = run_local_ranks(clean_rank, n, (path, kwargs),
                                workdir=str(tmp_path), timeout_s=240,
                                threads=1)
        assert all(r is None for r in ranks[1:])
        for kw, got in zip(kwargs, ranks[0]):
            whole = clean_archive(load_archive(path), _cpu(**kw))
            _same_clean(got, whole, scores=n == 1)
        for i in (0, 2):
            _same_clean(ranks[0][i], ranks[0][i + 1], scores=False)


def test_two_rank_mesh_streams(tmp_path):
    """Exact and online streams over two gloo ranks in bf16 (each rank's
    bf16 block of every tile): masks equal the single-device bf16
    streams' and, the archive being bf16-exact, the float32 stream's."""
    ar = make_bf16_exact_archive(8, 16, 32)
    path = str(tmp_path / "obs.npz")
    save_archive(ar, path)
    kw = dict(rotation="roll", max_iter=2, **BF16)
    jobs = [(path, 4, "exact", kw), (path, 4, "online", kw)]
    ranks = run_local_ranks(jobs_rank, 2, (jobs,), workdir=str(tmp_path),
                            timeout_s=240, threads=1)
    assert ranks[1] is None
    for (_, chunk, mode, _), got in zip(jobs, ranks[0]):
        single = clean_streaming(ar, chunk, _cpu(**kw), mode=mode)
        _same_clean(got, single, scores=False)
        f32 = clean_streaming(ar, chunk, _exact_cfg(max_iter=2), mode=mode)
        np.testing.assert_array_equal(got.final_weights, f32.final_weights)


# ----------------------------------------------------- the CLI's flags

@pytest.mark.parametrize("flags", [["--rotation", "roll"],
                                   ["--record_history"], ["--memory"],
                                   ["--compute-dtype", "bfloat16"]])
def test_cli_flags_match_the_jax_cli(tmp_path, monkeypatch, flags):
    ar, _ = ref_make_synthetic_archive(nsub=16, nchan=32, nbin=64,
                                       n_prezapped=5, seed=7)
    src = str(tmp_path / "obs.npz")
    ref_save_archive(ar, src)
    outs = {}
    for name, main, extra in (("ref", ref_cli.main, []),
                              ("port", cli.main, ["--device", "cpu"])):
        d = tmp_path / name
        d.mkdir()
        shutil.copy(src, d / "obs.npz")
        monkeypatch.chdir(d)
        assert main(extra + ["-q"] + flags + ["obs.npz"]) == 0
        outs[name] = str(d / "obs.npz_cleaned.npz")
    mine, theirs = load_archive(outs["port"]), ref_load_archive(outs["ref"])
    np.testing.assert_array_equal(mine.weights, theirs.weights)
    np.testing.assert_array_equal(mine.data, theirs.data)
    assert os.path.exists(tmp_path / "port" / "clean.log")


def test_cli_downgrade_lands_in_the_run_report(tmp_path, monkeypatch):
    """A stage the parity probe finds ineligible: the session still
    cleans (in float32, the mask of a float32 session) and its run report
    counts ``compute_dtype_ineligible{reason=parity_probe,stage=engine}``."""
    import json

    monkeypatch.setitem(tb._COMPUTE_DTYPE_PROBE_CACHE, "cpu", False)
    ar, _ = ref_make_synthetic_archive(nsub=8, nchan=16, nbin=64,
                                       n_prezapped=2, seed=9)
    ref_save_archive(ar, str(tmp_path / "obs.npz"))
    monkeypatch.chdir(tmp_path)
    assert cli.main(["--device", "cpu", "-q", "--compute-dtype", "bfloat16",
                     "--metrics-json", "run.json", "obs.npz"]) == 0
    doc = json.load(open(tmp_path / "run.json"))
    key = labeled("compute_dtype_ineligible", stage="engine",
                  reason="parity_probe")
    assert doc["counters"][key] >= 1
    got = load_archive(str(tmp_path / "obs.npz_cleaned.npz"))
    want = clean_archive(archive_from_reference(ar), _cpu())
    np.testing.assert_array_equal(got.weights, want.final_weights)
