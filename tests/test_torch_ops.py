"""The port's DSP and sort-route statistics against the JAX package's, on
identical float32 inputs made with numpy.

Tolerances: exact where both sides move values without rounding (roll
rotation, the sort-route median, the sort-route combine under jit);
rtol 1e-5 (or 1e-4 of the row scale for the fourier rotation's
matmuls, and 1e-5 of the cube scale for the baselines) where float32
sums are taken in another order.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iterative_cleaner_tpu.engine import loop as ref_loop
from iterative_cleaner_tpu.ops import dsp as ref_dsp
from iterative_cleaner_tpu.ops import psrchive_baseline as ref_base
from iterative_cleaner_tpu.stats import masked_jax as ref_stats
from iterative_cleaner_torch.engine.loop import nyq_correction_row
from iterative_cleaner_torch.ops import dsp, psrchive_baseline as base
from iterative_cleaner_torch.stats import masked_torch as stats


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rows(nchan, nbin, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (nchan, nbin)).astype(np.float32)
    s = rng.uniform(-nbin / 2, nbin / 2, nchan).astype(np.float32)
    return x, s


@pytest.mark.parametrize("nbin", [64, 63, 128])
def test_rotate_rows_fourier(nbin):
    x, s = _rows(40, nbin, 0)
    got = dsp.rotate_bins(_t(x), _t(s), method="fourier").numpy()
    want = np.asarray(ref_dsp.rotate_bins(jnp.asarray(x), jnp.asarray(s),
                                          jnp, method="fourier"))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("nbin", [64, 63])
def test_rotate_rows_roll_exact(nbin):
    x, s = _rows(40, nbin, 1)
    got = dsp.rotate_bins(_t(x), _t(s), method="roll").numpy()
    want = np.asarray(ref_dsp.rotate_bins(jnp.asarray(x), jnp.asarray(s),
                                          jnp, method="roll"))
    np.testing.assert_array_equal(got, want)


def _cube(nsub, nchan, nbin, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(0, 1, (nsub, nchan, nbin)) + 100).astype(np.float32)
    x[:, :, nbin // 4: nbin // 4 + 6] += 30.0
    s = rng.uniform(-nbin / 2, nbin / 2, nchan).astype(np.float32)
    w = (rng.random((nsub, nchan)) > 0.2).astype(np.float32)
    return x, s, w


@pytest.mark.parametrize("gate", ["matmul", "fft"])
@pytest.mark.parametrize("method", ["fourier", "roll"])
@pytest.mark.parametrize("nbin", [64, 63])
def test_rotate_cube(nbin, method, gate, monkeypatch):
    """Cube rotation against the reference's: the per-channel operator
    tensor under its size gate, ``torch.fft`` above it (the gate lowered
    in both packages), an exact gather for roll; channel-chunked."""
    if gate == "fft":
        monkeypatch.setattr(ref_dsp, "_ROT_MATMUL_MAX_ELEMS", 16)
        monkeypatch.setattr(dsp, "_ROT_MATMUL_MAX_ELEMS", 16)
    monkeypatch.setattr(dsp, "_ROTATE_CHUNK_ELEMS", 12 * 7 * nbin)
    x, s, _ = _cube(12, 40, nbin, 6)
    x -= 100.0
    got = dsp.rotate_bins(_t(x), _t(s), method=method).numpy()
    want = np.asarray(ref_dsp.rotate_bins(jnp.asarray(x), jnp.asarray(s),
                                          jnp, method=method))
    if method == "roll":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("nbin", [64, 1100])
def test_profile_baseline(nbin):
    """``baseline_mode='profile'``: the min-mean window level of every
    profile (matmul form up to 1024 bins, cumulative sums above), and its
    in-place removal."""
    x, _, _ = _cube(4, 6, nbin, 7)
    got = dsp.baseline_offsets(_t(x), 0.15).numpy()
    want = np.asarray(ref_dsp.baseline_offsets(jnp.asarray(x), jnp, 0.15))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    cube = _t(x.copy())
    out = dsp.remove_baseline(cube, 0.15)
    assert out.data_ptr() == cube.data_ptr()
    want_r = np.asarray(ref_dsp.remove_baseline(jnp.asarray(x), jnp, 0.15))
    np.testing.assert_allclose(out.numpy(), want_r, rtol=0,
                               atol=1e-5 * np.abs(x).max())


@pytest.mark.parametrize("dedispersed", [False, True])
@pytest.mark.parametrize("mode", ["integration", "profile"])
def test_prepare_cube_dedisp_rule(mode, dedispersed):
    """The preamble against the reference's, DEDISP=1 included: only the
    forward rotation is skipped and the back-shifts stay unchanged."""
    x, _, w = _cube(8, 16, 64, 8)
    freqs = np.linspace(1300, 1500, 16).astype(np.float32)
    args = (np.float32(26.76), np.float32(1400.0), np.float32(0.714))
    kw = dict(baseline_duty=0.15, rotation="fourier",
              dedispersed=dedispersed, baseline_mode=mode)
    ded, shifts, corr = dsp.prepare_cube_with_correction(
        _t(x.copy()), _t(w), _t(freqs), *(torch.tensor(a) for a in args),
        **kw)
    r_ded, r_shifts, r_corr = ref_dsp.prepare_cube_with_correction(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(freqs),
        *(jnp.asarray(a) for a in args), jnp, **kw)
    np.testing.assert_allclose(shifts.numpy(), np.asarray(r_shifts),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ded.numpy(), np.asarray(r_ded), rtol=0,
                               atol=1e-5 * np.abs(x).max())
    assert (corr is None) == (r_corr is None) == (mode == "profile")
    if corr is not None:
        np.testing.assert_allclose(corr[0].numpy(), np.asarray(r_corr[0]),
                                   rtol=0, atol=1e-5 * np.abs(x).max())
        np.testing.assert_allclose(corr[1].numpy(), np.asarray(r_corr[1]),
                                   rtol=1e-5)
        if dedispersed:
            assert corr[0] is ded


def test_template_stage_of_the_dedispersed_cube():
    """The template einsum, the closed-form fit, the residual with the
    pulse window and the integration correction over ``disp_clean``."""
    x, _, w = _cube(8, 16, 64, 9)
    disp_clean = x - 100.0
    offsets = np.full((8, 16), 100.0, np.float32)
    tmpl = dsp.weighted_template(_t(disp_clean), _t(w))
    r_tmpl = ref_dsp.weighted_template(jnp.asarray(disp_clean),
                                       jnp.asarray(w), jnp)
    np.testing.assert_allclose(tmpl.numpy(), np.asarray(r_tmpl), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(r_tmpl)).max())
    amps = dsp.fit_template_amplitudes(_t(disp_clean), tmpl)
    r_amps = ref_dsp.fit_template_amplitudes(jnp.asarray(disp_clean),
                                             r_tmpl, jnp)
    np.testing.assert_allclose(amps.numpy(), np.asarray(r_amps), rtol=1e-5,
                               atol=1e-6)
    res = dsp.template_residuals(_t(disp_clean), tmpl, amps, (10, 30), 0.2,
                                 True)
    r_res = ref_dsp.template_residuals(jnp.asarray(disp_clean), r_tmpl,
                                       r_amps, (10, 30), 0.2, jnp, True)
    np.testing.assert_allclose(res.numpy(), np.asarray(r_res), rtol=0,
                               atol=1e-4 * np.abs(np.asarray(r_res)).max())
    corr = base.template_correction(_t(disp_clean), _t(offsets), _t(w), 0.15)
    r_corr = ref_base.template_correction(jnp.asarray(disp_clean),
                                          jnp.asarray(offsets),
                                          jnp.asarray(w), 0.15, jnp)
    np.testing.assert_allclose(float(corr), float(r_corr), rtol=1e-4,
                               atol=1e-4)


def test_dispersion_shifts_and_nyquist_rows():
    freqs = np.linspace(1300, 1500, 32).astype(np.float32)
    args = (np.float32(26.76), np.float32(1400.0), np.float32(0.714))
    got = dsp.dispersion_shift_bins(_t(freqs), *(torch.tensor(a) for a in args),
                                    128)
    want = ref_dsp.dispersion_shift_bins(
        jnp.asarray(freqs), *(jnp.asarray(a) for a in args), 128, jnp)
    # f**-2 rounds in each library's pow, then two close terms subtract
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))
    nyq = nyq_correction_row(got, 128, "fourier", torch.float32)
    ref_nyq = ref_loop._nyq_correction_row(jnp.asarray(got.numpy()), 128,
                                           "fourier", jnp.float32)
    np.testing.assert_allclose(nyq.numpy(), np.asarray(ref_nyq), rtol=1e-5,
                               atol=1e-9)
    assert nyq_correction_row(got, 127, "fourier", torch.float32) is None
    assert nyq_correction_row(got, 128, "roll", torch.float32) is None


def test_integration_baseline_and_template_correction():
    rng = np.random.default_rng(2)
    cube = (rng.normal(0, 1, (12, 24, 64)) + 100).astype(np.float32)
    cube[:, :, 20:26] += 30.0
    w = (rng.random((12, 24)) > 0.2).astype(np.float32)
    got = base.baseline_offsets_integration(_t(cube), _t(w), 0.15)
    want, _ = ref_base.baseline_offsets_integration(
        jnp.asarray(cube), jnp.asarray(w), 0.15, jnp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    t1 = np.einsum("sc,scb->sb", w, cube - np.asarray(want)[..., None])
    w2 = np.where(rng.random(w.shape) > 0.1, w, 0).astype(np.float32)
    got_c = base.template_correction_from_totals(_t(t1), got, _t(w2), 0.15)
    want_c = ref_base.template_correction_from_totals(
        jnp.asarray(t1), want, jnp.asarray(w2), 0.15, jnp)
    np.testing.assert_allclose(float(got_c), float(want_c), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("dim", [0, 1])
def test_sort_route_masked_median_bit_equal(dim):
    rng = np.random.default_rng(3)
    v = rng.standard_normal((17, 33)).astype(np.float32)
    m = rng.random(v.shape) < 0.3
    m[:, 0] = True
    m[0, :] = True
    v[:, 1] = 1.5
    got = stats.masked_median(_t(v), _t(m), dim).numpy()
    want = np.asarray(ref_stats.masked_median(jnp.asarray(v), jnp.asarray(m),
                                              dim))
    np.testing.assert_array_equal(got, want)


def test_cell_diagnostics_dft_vs_reference():
    rng = np.random.default_rng(4)
    x = rng.normal(0, 2, (8, 12, 64)).astype(np.float32)
    m = rng.random((8, 12)) < 0.2
    x[m] = 0.0
    got = stats.cell_diagnostics(_t(x), _t(m), "dft")
    want = ref_stats.cell_diagnostics_jax(jnp.asarray(x), jnp.asarray(m),
                                          "dft")
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max())
    fft = stats.rfft_magnitudes(_t(x), "fft").numpy()
    np.testing.assert_allclose(stats.rfft_magnitudes(_t(x), "dft").numpy(),
                               fft, rtol=1e-4, atol=1e-4 * fft.max())


def test_sort_route_combine_bit_equal_to_jitted_reference():
    rng = np.random.default_rng(5)
    d = [rng.standard_normal((16, 32)).astype(np.float32) * s
         for s in (1.0, 0.3, 5.0, 2.0)]
    m = rng.random((16, 32)) < 0.2
    m[:, 2] = True
    for p in d:
        p[:, 3] = 1.5
    d[3][1, 0] = np.nan
    got = stats.scale_and_combine([_t(p) for p in d], _t(m), 5.0, 4.0)
    ref = jax.jit(functools.partial(ref_stats.scale_and_combine,
                                    chanthresh=5.0, subintthresh=4.0,
                                    median_impl="sort"))
    want = np.asarray(ref([jnp.asarray(p) for p in d], jnp.asarray(m)))
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_array_equal(got.numpy()[ok].view(np.int32),
                                  want[ok].view(np.int32))
