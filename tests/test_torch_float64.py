"""The port in float64 (``CleanConfig(dtype="float64")``) on the CPU
against the reference package's float64 route and the port's own numpy
oracle.

- The whole clean on every route (default, profile baseline, pulse
  window, DEDISP=1 input, roll rotation, dedispersed frame, ``-u``)
  against the reference's float64 JAX clean (``tests/conftest.py``
  enables x64; its CPU route is XLA with FFT spectra): masks, loops,
  convergence and per-loop diffs bit-equal, scores within rtol 1e-9 and
  atol 1e-9.  The port takes DFT spectra and the reference FFT spectra
  (ROADMAP §3); the measured worst on these cases is about 4e-12
  relative, so the tolerance has three orders of margin.  Against the
  port's oracle (``backend="numpy"``): masks bit-equal, as ``tools
  selftest`` requires.
- Both stream modes in float64: masks equal to the whole float64 clean
  (exact) and to the reference's float64 stream.
- Each module that holds a kernel, its plain float64 version against the
  reference's float64 counterpart on the same inputs: K1 (the weighted
  marginals, 1e-12 of each sum's scale), K2, K6 and K7 (the cell
  diagnostics of each route's residual, 1e-10 of each plane's scale:
  DFT against FFT), K3 with the combine (the sort-route scaler and
  4-way median: scores within 1e-12 relative, NaN by position; the
  threshold is a multiply by float64(1/thresh) where the reference
  divides), K9 (bit-equal), and the tail kernels' plain versions
  bit-equal to K3's on lines past ``LONGEST_BLOCK_LINE_F64``.
- The 64-bit order-preserving keys (hypothesis), the float64 launch
  plans, and the configuration's rules: float64 passes the mesh check on
  both meshes and runs in a batch (bit-equal to its single cleans; the
  meshes and the batch are held in ``tests/test_torch_mesh_f64.py``);
  ``compute_dtype="bfloat16"`` with float64 raises ``ValueError``;
  ``ICLEAN_COMPUTE_DTYPE=bfloat16`` with float64 takes the
  ``reason=dtype`` downgrade.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from iterative_cleaner_tpu.backends import clean_archive as ref_clean_archive
from iterative_cleaner_tpu.config import CleanConfig as RefConfig
from iterative_cleaner_tpu.io.synthetic import (
    make_synthetic_archive as ref_make_synthetic_archive,
)
from iterative_cleaner_tpu.ops import dsp as ref_dsp
from iterative_cleaner_tpu.parallel.streaming import (
    clean_streaming as ref_clean_streaming,
)
from iterative_cleaner_tpu.stats import masked_jax as ref_mj
from iterative_cleaner_torch import CleanConfig
from iterative_cleaner_torch import clean_streaming
from iterative_cleaner_torch.backends import (
    clean_archive,
    clean_archives_batched,
)
from iterative_cleaner_torch.backends import torch_backend as tb
from iterative_cleaner_torch.config import check_mesh
from iterative_cleaner_torch.convert import archive_from_reference
from iterative_cleaner_torch.engine.loop import (
    LONG_LINE_KERNELS,
    ROUTE_KERNELS,
    storage_kernels,
)
from iterative_cleaner_torch.stats import kernels as tk
from iterative_cleaner_torch.stats.masked_torch import cell_diagnostics

SMALL = dict(nsub=16, nchan=32, nbin=64, n_prezapped=5, seed=3)
CASES = {
    "default": (SMALL, {}),
    "profile-baseline": (dict(SMALL, seed=11), dict(baseline_mode="profile")),
    "pulse-window": (SMALL, dict(pulse_region=(0.2, 30, 60))),
    "dedisp1-input": (dict(SMALL, disperse=False, dedispersed=True), {}),
    "roll": (dict(SMALL, nbin=63, seed=5), dict(rotation="roll")),
    "dedisp-frame": (SMALL, dict(stats_frame="dedispersed")),
    "unload-res": (SMALL, dict(unload_res=True)),
}
SCORE_RTOL = SCORE_ATOL = 1e-9
F64 = torch.float64


def _archive(spec):
    spec = dict(spec)
    dedispersed = spec.pop("dedispersed", False)
    ar, _ = ref_make_synthetic_archive(**spec)
    ar.dedispersed = dedispersed
    return ar


def _scale_close(got, want, rtol):
    """``got`` within ``rtol`` of ``want``'s largest finite magnitude,
    non-finite values at the same places."""
    got, want = np.asarray(got), np.asarray(want)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    scale = np.abs(want[fin]).max() if fin.any() else 1.0
    np.testing.assert_allclose(got[fin], want[fin], rtol=0,
                               atol=rtol * scale)


@pytest.mark.parametrize("case", sorted(CASES))
def test_float64_clean_matches_reference_and_oracle(case):
    spec, kwargs = CASES[case]
    ar = _archive(spec)
    want = ref_clean_archive(ar, RefConfig(dtype="float64", **kwargs))
    port_ar = archive_from_reference(ar)
    got = clean_archive(port_ar, CleanConfig(dtype="float64", device="cpu",
                                             **kwargs))
    assert got.scores.dtype == np.float64
    np.testing.assert_array_equal(got.final_weights, want.final_weights)
    assert (got.loops, got.converged) == (want.loops, want.converged)
    np.testing.assert_array_equal(got.loop_diffs, want.loop_diffs)
    np.testing.assert_allclose(got.scores, want.scores, rtol=SCORE_RTOL,
                               atol=SCORE_ATOL)
    assert got.iter_metrics.dtype == np.float32
    np.testing.assert_array_equal(got.iter_metrics[:, :2],
                                  want.iter_metrics[:, :2])
    if want.residual is not None:
        _scale_close(got.residual, want.residual, 1e-9)
    oracle = clean_archive(port_ar, CleanConfig(backend="numpy", **kwargs))
    np.testing.assert_array_equal(got.final_weights, oracle.final_weights)
    assert got.loops == oracle.loops


@pytest.mark.parametrize("mode,chunk", [("exact", 5), ("online", 8)])
@pytest.mark.parametrize("case", ["default", "profile-baseline",
                                  "pulse-window"])
def test_float64_streams(case, mode, chunk):
    spec, kwargs = CASES[case]
    ar = _archive(spec)
    cfg = CleanConfig(dtype="float64", device="cpu", stream_hbm_mb=0,
                      **kwargs)
    got = clean_streaming(archive_from_reference(ar), chunk, cfg, mode=mode)
    want = ref_clean_streaming(ar, chunk, RefConfig(dtype="float64",
                                                    **kwargs), mode=mode)
    np.testing.assert_array_equal(got.final_weights, want.final_weights)
    assert got.scores.dtype == np.float64
    if mode == "exact":
        whole = clean_archive(archive_from_reference(ar), cfg)
        np.testing.assert_array_equal(got.final_weights, whole.final_weights)
        assert (got.loops, got.converged) == (whole.loops, whole.converged)


def _inputs(nsub=12, nchan=24, nbin=48, seed=0):
    rng = np.random.default_rng(seed)
    cube = rng.normal(0.0, 1.0, (nsub, nchan, nbin))
    cube[2, 3] += 30.0
    w = (rng.random((nsub, nchan)) > 0.15).astype(np.float64)
    template = np.abs(rng.normal(0.0, 1.0, nbin)) * 1e4
    rot_t = rng.normal(0.0, 1.0, (nchan, nbin)) * 1e4
    return cube, w, template, rot_t


def test_k1_plain_float64_matches_reference():
    cube, w, _, _ = _inputs()
    a, t1 = tk.weighted_marginals(torch.from_numpy(cube), torch.from_numpy(w))
    assert a.dtype == t1.dtype == F64
    ra, rt1 = ref_dsp.weighted_marginal_totals(jnp.asarray(cube),
                                               jnp.asarray(w), jnp)
    _scale_close(a.numpy(), np.asarray(ra), 1e-12)
    _scale_close(t1.numpy(), np.asarray(rt1), 1e-12)


@pytest.mark.parametrize("kernel", ["K2", "K6", "K7"])
def test_cell_diagnostics_plain_float64_matches_reference(kernel):
    """Each cell kernel's plain float64 version against the reference's
    float64 residual of that route and its XLA diagnostics (FFT)."""
    cube, w, template, rot_t = _inputs()
    nbin = cube.shape[-1]
    mask = w == 0
    tt = torch.from_numpy
    jc, jw, jt, jr = (jnp.asarray(x) for x in (cube, w, template, rot_t))
    window = np.ones(nbin)
    window[5:11] = 0.3
    if kernel == "K2":
        nyq = np.random.default_rng(1).normal(0.0, 1e-3, rot_t.shape)
        got = tk.cell_diagnostics_disp(tt(cube), tt(rot_t), tt(nyq),
                                       tt(template), tt(w), tt(mask))
        amp = ref_dsp.fit_template_amplitudes_disp(jc, jr, jt, jnp)
        alt = jnp.asarray(1.0 - 2.0 * (np.arange(nbin) % 2))
        base = jc + jnp.sum(jc * alt, axis=2)[:, :, None] \
            * jnp.asarray(nyq)[None]
        wres = (amp[:, :, None] * jr[None] - base) * jw[:, :, None]
    elif kernel == "K6":
        got = tk.cell_diagnostics_dedisp(tt(cube), tt(template), tt(window),
                                         tt(w), tt(mask))
        amp = ref_dsp.fit_template_amplitudes(jc, jt, jnp)
        wres = ((amp[:, :, None] * jt - jc) * jnp.asarray(window)) \
            * jw[:, :, None]
    else:
        base = cube * 0.5
        got = tk.cell_diagnostics_two_read(tt(cube), tt(base), tt(rot_t),
                                           tt(template), tt(w), tt(mask))
        amp = ref_dsp.fit_template_amplitudes(jc, jt, jnp)
        wres = (amp[:, :, None] * jr[None] - jnp.asarray(base)) \
            * jw[:, :, None]
    want = ref_mj.cell_diagnostics_jax(wres, jnp.asarray(mask))
    for g, ww in zip(got, want):
        assert g.dtype == F64
        _scale_close(g.numpy(), np.asarray(ww), 1e-10)
    # the DFT against the FFT on identical rows
    for g, ww in zip(cell_diagnostics(tt(np.array(wres)), tt(mask), "dft"),
                     want):
        _scale_close(g.numpy(), np.asarray(ww), 1e-10)


def test_k3_combine_plain_float64_match_reference():
    rng = np.random.default_rng(4)
    mask = rng.random((40, 30)) < 0.1
    mask[7] = True                       # a fully masked subint
    diags = [rng.normal(0.0, 1.0, (40, 30)) for _ in range(4)]
    diags[1][:, 4] = 2.0                 # a zero-MAD channel
    diags[3][3, 3] = np.nan              # a NaN in the plain diagnostic
    td = [torch.from_numpy(d) for d in diags]
    tm = torch.from_numpy(mask)
    chan = tk.scaled_sides(td, tm, 0, 5.0)
    sub = tk.scaled_sides(td, tm, 1, 4.0)
    _, scores = tk.combine_zap(chan, sub, torch.ones(40, 30, dtype=F64))
    want = np.asarray(ref_mj.scale_and_combine(
        [jnp.asarray(d) for d in diags], jnp.asarray(mask), 5.0, 4.0))
    got = scores.numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-12)


@pytest.mark.parametrize("axis", [0, 1])
def test_k9_plain_float64_bit_equal_to_reference(axis):
    rng = np.random.default_rng(5)
    v = rng.normal(0.0, 1.0, (31, 17))
    m = rng.random((31, 17)) < 0.3
    m[:, 2] = True
    m[4] = True
    got = tk.masked_median(torch.from_numpy(v), torch.from_numpy(m), axis)
    want = np.asarray(ref_mj.masked_median(jnp.asarray(v), jnp.asarray(m),
                                           axis))
    assert got.dtype == F64
    np.testing.assert_array_equal(got.numpy(), want.reshape(got.shape))


@pytest.mark.parametrize("axis", [0, 1])
def test_float64_long_lines_bit_equal_to_k3_plain(axis):
    """Past LONGEST_BLOCK_LINE_F64 the card takes the cluster kernel, and
    past its capacity K9 and the tail kernels: their plain versions give
    K3's bits."""
    n = tk.LONGEST_BLOCK_LINE_F64 + 1
    assert tk.scaled_sides_route(n, F64) == "cluster"
    assert tk.scaled_sides_route(n - 1, F64) == "block"
    assert tk.scaled_sides_route(tk.scaled_sides_cluster_capacity(8) + 1,
                                 F64) == "long"
    rng = np.random.default_rng(6)
    shape = (n, 3) if axis == 0 else (3, n)
    d = [torch.from_numpy(rng.normal(0.0, 1.0, shape)) for _ in range(4)]
    d[3][1, 1] = float("nan")
    m = torch.from_numpy(rng.random(shape) < 0.05)
    got = tk.scaled_sides_long(d, m, axis, 5.0)
    want = tk.scaled_sides_plain(d, m, axis, 5.0)
    for g, w in zip(got, want):
        assert torch.equal(torch.isnan(g), torch.isnan(w))
        assert torch.equal(torch.nan_to_num(g, nan=7.0),
                           torch.nan_to_num(w, nan=7.0))


_F64_SPECIAL = st.sampled_from([0.0, -0.0, np.inf, -np.inf, np.nan, 5e-324,
                                -5e-324, 1.7976931348623157e308])


@settings(max_examples=60, deadline=None)
@given(st.lists(st.one_of(st.floats(allow_nan=True, allow_infinity=True),
                          _F64_SPECIAL), min_size=1, max_size=40))
def test_ordered_key_64_order_and_inverse(values):
    # NaN as arithmetic makes it on the card: the positive quiet NaN (a
    # NaN with its sign bit set keys below -inf, as with the 32-bit keys)
    values = [abs(v) if v != v else v for v in values]
    x = torch.tensor(values, dtype=F64)
    k = tk.ordered_key(x)
    assert k.dtype == torch.int64
    back = tk.key_to_float(k)
    assert torch.equal(back.view(torch.int64), x.view(torch.int64))
    # the key order is the value order: NaN above +inf, -0 below +0
    order = torch.argsort(k, stable=True)
    xs = x[order].numpy()
    fin = xs[~np.isnan(xs)]
    assert np.all(fin[:-1] <= fin[1:])
    assert np.all(np.isnan(xs[len(fin):]))
    zeros = fin[fin == 0]
    assert np.all(np.signbit(zeros)[:-1] >= np.signbit(zeros)[1:])
    # numpy's and torch's sorts give the same order, but for zeros' signs
    want = np.sort(x.numpy())
    np.testing.assert_array_equal(np.abs(xs), np.abs(want))
    np.testing.assert_array_equal(
        xs, torch.sort(x, stable=True).values.numpy() + 0.0)


def test_float64_launch_plans():
    # K3: the float64 boundary is where one line stops fitting a block;
    # the float32 boundary is where it has always been
    assert tk._sides_fits(tk.LONGEST_BLOCK_LINE_F64, 1, 1, 8)
    assert not tk._sides_fits(tk.LONGEST_BLOCK_LINE_F64 + 1, 1, 1, 8)
    assert tk.LONGEST_BLOCK_LINE == 46486
    assert tk.scaled_sides_route(46486) == "block"
    assert tk.scaled_sides_route(46487) == "cluster"
    for n in (1, 33, 4096, tk.LONGEST_BLOCK_LINE_F64):
        for axis in (0, 1):
            plan = tk.scaled_sides_geometry(n, axis, 8)
            assert plan.smem + 2048 <= 232448
    # K9: 8-byte keys fit four lines of 4096 a block along dim 0
    assert tk.masked_median_geometry(4096, 0, 8).lines == 4
    assert tk.masked_median_geometry(4096, 0, 4).lines == 8
    assert tk._median_scratch_ints(3, 4) == 3 * 261
    assert tk._median_scratch_ints(3, 8) == 778 + 12
    # K1 and the cell kernels: every float64 plan fits a block
    for nbin in (2, 3, 8, 63, 64, 128, 257, 1024, 8192):
        assert tk.marginals_tiles(64, 256, nbin, 132, 8).smem <= 232448
        plan = tk.cell_stats_geometry(nbin, 8)
        assert plan.smem <= 232448 and plan.threads <= 512
    assert tk.cell_stats_geometry(16384, 4).threads == 640
    # past 8192 float64 bins the cell diagnostics take an FFT build (the
    # DFT plan still refuses them) and K1 tiles any length; 8193 bins (odd
    # part 8193 = 3 x 2731) K2g, by Bluestein in a thread-block cluster
    assert tk.cell_stats_route(8192, 8) == "dft"
    assert tk.cell_stats_route(16384, 8) == "fft"
    with pytest.raises(NotImplementedError, match="item 9"):
        tk.cell_stats_geometry(8193, 8)
    assert tk.cell_stats_route(8193, 8) == "fft_global"
    assert tk.cell_fft_global_plan(8193, 8).mode == "cluster"
    assert tk.marginals_tiles(4, 4, 8193, 132, 8).smem <= 232448


def test_float64_launch_count_names():
    for route, kernels in ROUTE_KERNELS.items():
        names = storage_kernels(kernels, "float32", "float64")
        assert all(n.endswith("_f64") for n in names)
        assert set(names) <= set(tk.launch_counts())
    assert set(storage_kernels(LONG_LINE_KERNELS, "float32", "float64")) \
        <= set(tk.launch_counts())
    # a float64 CPU clean launches nothing (the plain versions)
    tk.reset_launch_counts()
    clean_archive(archive_from_reference(_archive(SMALL)),
                  CleanConfig(dtype="float64", device="cpu"))
    assert not any(tk.launch_counts().values())


def test_float64_refusals(monkeypatch):
    """float64 passes the mesh check on every mesh and runs in a batch
    (each archive bit-equal to its single float64 clean); what the
    reference refuses stays a ``ValueError``."""
    cfg = CleanConfig(dtype="float64", device="cpu")
    ar = archive_from_reference(_archive(SMALL))
    for mesh in ("off", "cell", "batch"):
        check_mesh(mesh, cfg)
    single = clean_archive(ar, cfg)
    for got in clean_archives_batched([ar, ar], cfg):
        assert got.final_weights.dtype == np.float64
        for field in ("final_weights", "scores", "loop_diffs",
                      "loop_rfi_frac"):
            np.testing.assert_array_equal(getattr(got, field),
                                          getattr(single, field))
        assert got.loops == single.loops
    with pytest.raises(ValueError, match="torch backend"):
        check_mesh("cell", CleanConfig(backend="numpy"))
    with pytest.raises(ValueError, match="torch backend"):
        clean_archives_batched([ar], CleanConfig(backend="numpy"))
    with pytest.raises(ValueError, match="requires dtype='float32'"):
        CleanConfig(dtype="float64", compute_dtype="bfloat16")
    with pytest.raises(ValueError, match="unknown dtype"):
        CleanConfig(dtype="float16")
    # the environment's bf16 request takes the ladder's dtype rung
    monkeypatch.setenv("ICLEAN_COMPUTE_DTYPE", "bfloat16")
    before = tb.compute_dtype_ineligible_counts()
    assert tb.config_compute_dtype(cfg, "engine", "cpu") == "float32"
    after = tb.compute_dtype_ineligible_counts()
    key = [k for k in after if "reason=dtype" in k and "stage=engine" in k]
    assert key and after[key[0]] == before.get(key[0], 0) + 1
