"""The port's kernels (plain PyTorch versions, on the CPU) against the
JAX package's Pallas kernels in interpret mode, on identical inputs.

Tolerances, and why:
- K1 marginals: |diff| <= 1e-5 * sum|w*disp| per output (float32 sums
  taken in another order).
- K2 cell diagnostics: rtol 1e-4 against each plane's scale (float32
  reassociation of the fit, moments and DFT); masked cells exact.
- K3 scaled sides and the combine: bit-equal, NaN included (the same
  exact selects and the same float op sequence).
- The composite sweep: masks equal, scores rtol 1e-4 with a 1e-4 floor
  (scores are in threshold units; near-median cells lose relative
  precision to cancellation).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from iterative_cleaner_tpu.stats import pallas_kernels as pk
from iterative_cleaner_torch.engine.loop import nyq_correction_row
from iterative_cleaner_torch.ops.dsp import rotate_bins
from iterative_cleaner_torch.stats import kernels as tk
from iterative_cleaner_torch.stats.masked_torch import scale_and_combine


def _bits_equal(got, want):
    got = np.asarray(got, dtype=np.float32)
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape
    nan_g, nan_w = np.isnan(got), np.isnan(want)
    np.testing.assert_array_equal(nan_g, nan_w)
    np.testing.assert_array_equal(got[~nan_g].view(np.int32),
                                  want[~nan_w].view(np.int32))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _cell_inputs(nsub, nchan, nbin, rotation, seed):
    """A weighted-residual fixture shaped like one iteration's inputs:
    a dispersed cube with a pulse and RFI, a template, per-channel
    shifts, weights with zeros (masked cells) and a fully masked line."""
    rng = np.random.default_rng(seed)
    phase = (np.arange(nbin) + 0.5) / nbin
    template = (1e4 * np.exp(-0.5 * ((phase - 0.3) / 0.03) ** 2)
                ).astype(np.float32)
    disp = rng.normal(0.0, 1.0, (nsub, nchan, nbin)).astype(np.float32)
    disp += 0.2 * template[None, None] / 1e4 * 30
    disp[2, 3] += 40.0 * np.sin(2 * np.pi * 5 * phase).astype(np.float32)
    disp[:, 5] *= 8.0
    weights = np.ones((nsub, nchan), np.float32)
    weights[rng.random((nsub, nchan)) < 0.1] = 0.0
    weights[:, 1] = 0.0
    shifts = rng.uniform(-nbin / 3, nbin / 3, nchan).astype(np.float32)
    shifts_t = _t(shifts)
    rot_t = rotate_bins(_t(template).expand(nchan, nbin), shifts_t,
                        method=rotation).contiguous()
    nyq = nyq_correction_row(shifts_t, nbin, rotation, torch.float32)
    return dict(disp=disp, rot_t=rot_t.numpy(), template=template,
                weights=weights, mask=weights == 0,
                nyq=None if nyq is None else nyq.numpy())


GEOMS = [(16, 32, 64, "fourier"), (20, 40, 128, "fourier"),
         (16, 32, 63, "roll")]


@pytest.mark.parametrize("nsub,nchan,nbin", [(16, 32, 64), (20, 40, 128)])
def test_k1_marginals_plain_vs_pallas(nsub, nchan, nbin):
    rng = np.random.default_rng(1)
    disp = rng.normal(5.0, 3.0, (nsub, nchan, nbin)).astype(np.float32)
    w = (rng.random((nsub, nchan)) > 0.1).astype(np.float32)
    a, t1 = tk.weighted_marginals(_t(disp), _t(w))
    ra, rt1 = pk.weighted_marginals_pallas(jnp.asarray(disp), jnp.asarray(w))
    absw = np.abs(disp * w[..., None])
    np.testing.assert_array_less(np.abs(a.numpy() - np.asarray(ra)),
                                 1e-5 * absw.sum(axis=0) + 1e-30)
    np.testing.assert_array_less(np.abs(t1.numpy() - np.asarray(rt1)),
                                 1e-5 * absw.sum(axis=1) + 1e-30)


@pytest.mark.parametrize("nsub,nchan,nbin,rotation", GEOMS)
def test_k2_cell_diagnostics_plain_vs_pallas(nsub, nchan, nbin, rotation):
    x = _cell_inputs(nsub, nchan, nbin, rotation, seed=2)
    got = tk.cell_diagnostics_disp(
        _t(x["disp"]), _t(x["rot_t"]),
        None if x["nyq"] is None else _t(x["nyq"]), _t(x["template"]),
        _t(x["weights"]), _t(x["mask"]))
    want = pk.cell_diagnostics_pallas_disp(
        jnp.asarray(x["disp"]), jnp.asarray(x["rot_t"]),
        None if x["nyq"] is None else jnp.asarray(x["nyq"]),
        jnp.asarray(x["template"]), jnp.asarray(x["weights"]),
        jnp.asarray(x["mask"]))
    m = x["mask"]
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        scale = np.abs(w).max()
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * scale)
    # masked cells exact: std/mean 0, ptp the np.ma fill, spectrum of zeros
    for g, w in zip(got, want):
        _bits_equal(g.numpy()[m], np.asarray(w)[m])


def _diag_planes(nsub, nchan, seed):
    """Diagnostic planes with the selects' corner cases: masked cells,
    exact ties, zero-MAD lines, a fully masked line, signed zeros, NaN
    and inf on the plain (rFFT) plane."""
    rng = np.random.default_rng(seed)
    d = [rng.standard_normal((nsub, nchan)).astype(np.float32) * s
         for s in (1.0, 0.3, 5.0, 2.0)]
    mask = rng.random((nsub, nchan)) < 0.2
    mask[:, 2] = True                 # a fully masked channel
    mask[4, :] = True                 # a fully masked subint
    for p in d:
        p[:, 3] = 1.5                 # zero-MAD channel (ties)
        p[6, :] = -0.25               # zero-MAD subint
        p[7, ::3] = 2.0               # ties
    d[0][mask] = 0.0                  # masked std/mean cells are 0 ...
    d[1][mask] = 0.0
    d[2][mask] = np.float32(1e20)     # ... and masked ptp the np.ma fill
    d[1][8, 9] = -0.0
    d[3][1, 0] = np.nan               # NaN lines on the plain path
    d[3][9, 11] = np.inf
    d[3][:, 7] = 0.0                  # zero MAD on the plain path: inf/nan
    d[1][10, 12] = np.nan             # NaN on a masked-path plane
    return d, mask


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("nsub,nchan", [(16, 32), (21, 37)])
def test_k3_scaled_sides_bit_equal(axis, nsub, nchan):
    d, mask = _diag_planes(nsub, nchan, seed=3)
    thresh = 5.0 if axis == 0 else 3.7
    got = tk.scaled_sides([_t(p) for p in d], _t(mask), axis, thresh)
    want = pk.scaled_sides_pallas([jnp.asarray(p) for p in d],
                                  jnp.asarray(mask), axis, thresh)
    for g, w in zip(got, want):
        _bits_equal(g.numpy(), w)


@pytest.mark.parametrize("nsub,nchan", [(16, 32), (21, 37)])
def test_combine_bit_equal_to_fused_combine(nsub, nchan):
    d, mask = _diag_planes(nsub, nchan, seed=4)
    rng = np.random.default_rng(5)
    worig = np.where(mask, 0.0, rng.uniform(0.5, 2.0, mask.shape)
                     ).astype(np.float32)
    planes = [_t(p) for p in d]
    chan = tk.scaled_sides(planes, _t(mask), 0, 5.0)
    sub = tk.scaled_sides(planes, _t(mask), 1, 4.0)
    new_w, scores = tk.combine_zap(chan, sub, _t(worig))
    want_w, want_s = pk.fused_combine_pallas(
        [jnp.asarray(p) for p in d], jnp.asarray(mask), jnp.asarray(worig),
        5.0, 4.0)
    _bits_equal(scores.numpy(), want_s)
    _bits_equal(new_w.numpy(), want_w)
    # the sort-route composition agrees too (the kernels' reference)
    _bits_equal(scale_and_combine(planes, _t(mask), 5.0, 4.0).numpy(),
                want_s)


@pytest.mark.parametrize("nsub,nchan,nbin,rotation", GEOMS)
def test_composite_sweep_vs_fused_sweep(nsub, nchan, nbin, rotation):
    """K2 -> K3 (both axes) -> combine, the port's one post-template
    route, against the one-launch TPU sweep."""
    x = _cell_inputs(nsub, nchan, nbin, rotation, seed=6)
    nyq = None if x["nyq"] is None else _t(x["nyq"])
    diags = tk.cell_diagnostics_disp(
        _t(x["disp"]), _t(x["rot_t"]), nyq, _t(x["template"]),
        _t(x["weights"]), _t(x["mask"]))
    chan = tk.scaled_sides(diags, _t(x["mask"]), 0, 5.0)
    sub = tk.scaled_sides(diags, _t(x["mask"]), 1, 5.0)
    new_w, scores = tk.combine_zap(chan, sub, _t(x["weights"]))
    want_w, want_s, _ = pk.fused_sweep_pallas(
        jnp.asarray(x["disp"]), jnp.asarray(x["rot_t"]),
        None if x["nyq"] is None else jnp.asarray(x["nyq"]),
        jnp.asarray(x["template"]), jnp.asarray(x["weights"]),
        jnp.asarray(x["mask"]), 5.0, 5.0)
    np.testing.assert_array_equal(new_w.numpy() == 0, np.asarray(want_w) == 0)
    np.testing.assert_allclose(scores.numpy(), np.asarray(want_s),
                               rtol=1e-4, atol=1e-4)


def test_wrappers_raise_on_cuda_without_a_card():
    """A CUDA request never reaches a plain version: with no CUDA device
    present, every wrapper raises before launching."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the wrappers would launch")
    meta = dict(device="meta", dtype=torch.float32)
    disp = torch.empty((4, 8, 16), **meta)
    w = torch.empty((4, 8), **meta)
    with pytest.raises(ValueError, match="unsupported device"):
        tk.weighted_marginals(disp, w)
    # stand-ins that report a CUDA device: refused before any launch
    fake = type("FakeCudaTensor", (), {"device": torch.device("cuda")})()
    calls = [
        lambda: tk.weighted_marginals(fake, fake),
        lambda: tk.cell_diagnostics_disp(fake, fake, None, fake, fake, fake),
        lambda: tk.scaled_sides([fake] * 4, fake, 0, 5.0),
        lambda: tk.scaled_sides([fake] * 4, fake, 1, 5.0),
        lambda: tk.combine_zap([fake] * 4, [fake] * 4, fake),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
