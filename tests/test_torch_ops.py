"""The port's DSP and sort-route statistics against the JAX package's, on
identical float32 inputs made with numpy.

Tolerances: exact where both sides move values without rounding (roll
rotation, the sort-route median, the sort-route combine under jit);
rtol 1e-5 (or 1e-4 of the row scale for the fourier rotation's three
matmuls) where float32 sums are taken in another order.
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
