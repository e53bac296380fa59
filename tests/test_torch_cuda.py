"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``cuda``: they skip where no CUDA device is present, and
run on a GPU machine with

    python -m pytest -m cuda --noconftest tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest sets up JAX, which this file
does not use and a GPU machine need not have).

Tolerances as in tests/test_torch_kernels.py: K1 1e-5 of sum|w*disp|,
K2 rtol 1e-4 of each plane's scale with masked cells exact, K3 and the
combine bit-equal (NaN included), and the whole slice's mask equal to
the CPU run's.
"""

import numpy as np
import pytest
import torch

from iterative_cleaner_torch import CleanConfig
from iterative_cleaner_torch.backends import clean_archive
from iterative_cleaner_torch.engine.loop import nyq_correction_row
from iterative_cleaner_torch.io.synthetic import make_synthetic_archive
from iterative_cleaner_torch.ops.dsp import (
    rotate_bins,
    weighted_marginal_totals,
)
from iterative_cleaner_torch.stats import kernels as tk

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _bits_mismatch(got, want):
    nan_g, nan_w = torch.isnan(got), torch.isnan(want)
    same = (got.view(torch.int32) == want.view(torch.int32)) | (nan_g & nan_w)
    return int((~same).sum())


def _inputs(nsub, nchan, nbin, rotation, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    disp = (torch.randn(nsub, nchan, nbin, generator=g) * 3 + 1).to(dev)
    w = (torch.rand(nsub, nchan, generator=g) > 0.1).float().to(dev)
    w[:, 1] = 0
    phase = (torch.arange(nbin) + 0.5) / nbin
    template = (1e4 * torch.exp(-0.5 * ((phase - 0.3) / 0.03) ** 2)).to(dev)
    shifts = (torch.rand(nchan, generator=g) * nbin / 1.5 - nbin / 3).to(dev)
    rot_t = rotate_bins(template.expand(nchan, nbin), shifts,
                        method=rotation).contiguous()
    nyq = nyq_correction_row(shifts, nbin, rotation, torch.float32)
    return disp, w, w == 0, template, rot_t, nyq


GEOMS = [(20, 40, 128, "fourier"), (16, 32, 63, "roll"),
         (7, 300, 1024, "fourier")]


@pytest.mark.parametrize("nsub,nchan,nbin,rotation", GEOMS)
def test_kernels_match_plain_on_card(card, nsub, nchan, nbin, rotation):
    disp, w, mask, template, rot_t, nyq = _inputs(nsub, nchan, nbin,
                                                  rotation, card)
    a, t1 = tk.weighted_marginals(disp, w)
    pa, pt1 = weighted_marginal_totals(disp, w)
    sa, st1 = weighted_marginal_totals(disp.abs(), w)
    assert bool(((a - pa).abs() <= 1e-5 * sa).all())
    assert bool(((t1 - pt1).abs() <= 1e-5 * st1).all())
    diags = tk.cell_diagnostics_disp(disp, rot_t, nyq, template, w, mask)
    plain = tk.cell_diagnostics_disp_plain(disp, rot_t, nyq, template, w,
                                           mask)
    for g, p in zip(diags, plain):
        scale = float(p[~mask].abs().max())
        assert bool(((g - p).abs() <= 1e-4 * (p.abs() + scale)).all())
        assert _bits_mismatch(g[mask], p[mask]) == 0
    sides = []
    for axis in (0, 1):
        got = tk.scaled_sides(diags, mask, axis, 5.0)
        want = tk.scaled_sides_plain(diags, mask, axis, 5.0)
        assert [_bits_mismatch(g, p) for g, p in zip(got, want)] == [0] * 4
        sides.append(got)
    new_w, scores = tk.combine_zap(sides[0], sides[1], w)
    pw, ps = tk.combine_zap_plain(sides[0], sides[1], w)
    assert _bits_mismatch(scores, ps) == 0
    assert _bits_mismatch(new_w, pw) == 0


def test_slice_on_card_matches_cpu(card):
    ar, _ = make_synthetic_archive(nsub=64, nchan=256, nbin=128,
                                   n_prezapped=30, seed=1)
    tk.reset_launch_counts()
    on_card = clean_archive(ar, CleanConfig())
    counts = tk.launch_counts()
    on_cpu = clean_archive(ar, CleanConfig(device="cpu"))
    assert all(v == on_card.loops for v in counts.values()), counts
    np.testing.assert_array_equal(on_card.final_weights, on_cpu.final_weights)
    assert (on_card.loops, on_card.converged) == (on_cpu.loops,
                                                  on_cpu.converged)
    np.testing.assert_allclose(on_card.scores, on_cpu.scores, rtol=1e-4,
                               atol=1e-4)
