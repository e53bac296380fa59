"""The port's other whole-archive routes end to end, on the CPU (every
kernel through its plain PyTorch version), against the JAX package.

The routes (``iterative_cleaner_torch.engine.loop``): ``two_read`` (K7)
under the pulse window, the profile baseline and a DEDISP=1 input;
``dedispersed`` (K6, i.e. K5) under ``stats_frame='dedispersed'``; and
``-u`` on the default route.  Both packages clean the SAME archive
under the same configuration: the JAX package on its default CPU route
and on the explicit TPU kernel route (fused stats, DFT spectra, Pallas
medians; interpret mode) with its one-launch sweep on and off.  Final
masks, loop counts, convergence and per-loop diffs are equal; scores
agree to rtol 1e-4 with a 1e-4 floor, as in tests/test_torch_slice.py
(scores are in threshold units; near-median cells lose relative
precision to cancellation).  The ``-u`` residual agrees to 1e-4 of its
largest magnitude: float32 sums are taken in another order through the
template, the fit and two cube rotations.
"""

import os

import numpy as np
import pytest

from iterative_cleaner_tpu.backends import clean_archive as ref_clean_archive
from iterative_cleaner_tpu.config import CleanConfig as RefConfig
from iterative_cleaner_tpu.io.synthetic import (
    bench_rfi_density,
    make_synthetic_archive as ref_make_synthetic_archive,
)
from iterative_cleaner_torch import CleanConfig
from iterative_cleaner_torch.backends import clean_archive
from iterative_cleaner_torch.cli import main as cli_main
from iterative_cleaner_torch.convert import (
    archive_from_reference,
    config_from_reference,
)
from iterative_cleaner_torch.engine.loop import (
    LONG_LINE_KERNELS,
    ROUTE_KERNELS,
    SHARD_KERNELS,
    STREAM_KERNELS,
    select_route,
)
from iterative_cleaner_torch.io import load_archive, save_archive
from iterative_cleaner_torch.stats.kernels import launch_counts

SMALL = dict(nsub=16, nchan=32, nbin=64, n_prezapped=5, seed=3)
CASES = {
    # name: (archive spec, config, the port's route)
    "pulse-window": (SMALL, dict(pulse_region=(0.2, 30, 60)), "two_read"),
    "profile-baseline": (dict(nsub=20, nchan=40, nbin=128, n_prezapped=7,
                              seed=11),
                         dict(baseline_mode="profile"), "two_read"),
    "dedisp-frame-fourier": (SMALL, dict(stats_frame="dedispersed"),
                             "dedispersed"),
    "dedisp-frame-roll": (dict(nsub=16, nchan=32, nbin=63, n_prezapped=4,
                               seed=5),
                          dict(stats_frame="dedispersed", rotation="roll"),
                          "dedispersed"),
    "dedisp1-input": (dict(SMALL, disperse=False, dedispersed=True), dict(),
                      "two_read"),
    "unload-res": (SMALL, dict(unload_res=True), "default"),
}
ROUTES = {
    "jax-default": dict(),
    "jax-kernels": dict(stats_impl="fused", fft_mode="dft",
                        median_impl="pallas", fused_sweep="on"),
    "jax-kernels-nosweep": dict(stats_impl="fused", fft_mode="dft",
                                median_impl="pallas", fused_sweep="off"),
}


def _archive(spec):
    spec = dict(spec)
    dedispersed = spec.pop("dedispersed", False)
    ar, _ = ref_make_synthetic_archive(**spec)
    ar.dedispersed = dedispersed
    return ar


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_route_matches_reference(case, route):
    spec, kwargs, port_route = CASES[case]
    ar = _archive(spec)
    ref_cfg = RefConfig(**kwargs, **ROUTES[route])
    cfg = config_from_reference(ref_cfg, device="cpu")
    assert select_route(cfg, ar.dedispersed) == port_route
    want = ref_clean_archive(ar, ref_cfg)
    got = clean_archive(archive_from_reference(ar), cfg)
    np.testing.assert_array_equal(got.final_weights, want.final_weights)
    assert (got.loops, got.converged) == (want.loops, want.converged)
    np.testing.assert_array_equal(got.loop_diffs, want.loop_diffs)
    np.testing.assert_allclose(got.loop_rfi_frac, want.loop_rfi_frac,
                               rtol=1e-6)
    np.testing.assert_allclose(got.scores, want.scores, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got.iter_metrics[:, :2],
                                  want.iter_metrics[:, :2])
    # residual_std (the median of diags[0]) and template_peak: float32
    # sums in another order, as the scores
    np.testing.assert_allclose(got.iter_metrics[:, 2:],
                               want.iter_metrics[:, 2:], rtol=1e-4)
    assert (got.residual is None) == (want.residual is None)
    if want.residual is not None:
        assert got.residual.shape == want.residual.shape
        np.testing.assert_allclose(
            got.residual, want.residual, rtol=0,
            atol=1e-4 * np.abs(want.residual).max())


def test_route_kernels_cover_every_launch_counter():
    """``ROUTE_KERNELS``, ``STREAM_KERNELS`` and ``SHARD_KERNELS`` (what
    chip_smoke.py holds each whole clean's, each exact stream's and each
    sharded clean's launch counts to) and ``LONG_LINE_KERNELS`` (K3's
    route on lines too long for a block) name every counted kernel, each on
    some route; exact streaming launches a route's kernels and K8; the
    sharded routes are whole-clean routes with K10 for the cell
    diagnostics and no K3 or K9 (tree-reduced selects instead)."""
    named = {k for table in (ROUTE_KERNELS, STREAM_KERNELS, SHARD_KERNELS)
             for ks in table.values() for k in ks}
    assert named | set(LONG_LINE_KERNELS) == set(launch_counts())
    for route, kernels in ROUTE_KERNELS.items():
        assert set(STREAM_KERNELS[route]) == set(kernels) | {"fused_combine"}
    k10 = {"cell_diagnostics_disp": "shard_diagnostics_disp",
           "cell_diagnostics_dedisp": "shard_diagnostics_dedisp"}
    for route, kernels in SHARD_KERNELS.items():
        assert set(kernels) == {k10.get(k, k) for k in ROUTE_KERNELS[route]
                                if not k.startswith("scaled_sides")
                                and k != "masked_median"}


@pytest.mark.parametrize("case", ["pulse-window", "dedisp-frame-fourier",
                                  "dedisp1-input"])
def test_residual_on_every_route(case):
    """``-u`` beside the other routes: the residual the two_read and
    dedispersed routes reconstruct after their loops."""
    spec, kwargs, _ = CASES[case]
    ar = _archive(spec)
    ref_cfg = RefConfig(unload_res=True, **kwargs)
    want = ref_clean_archive(ar, ref_cfg)
    got = clean_archive(archive_from_reference(ar),
                        config_from_reference(ref_cfg, device="cpu"))
    np.testing.assert_array_equal(got.final_weights, want.final_weights)
    np.testing.assert_allclose(got.residual, want.residual, rtol=0,
                               atol=1e-4 * np.abs(want.residual).max())


def test_frames_contract_at_bench_density():
    """The two stats frames at the full-size golden's RFI density (cut to
    128 x 1024): the port's mask equals the reference's in each frame,
    and the frames disagree on under 1% of cells, each of them scored
    within [0.8, 1.3] by one of the two runs.  The reference's own
    one-sided form of that contract (the dispersed score alone,
    tests/test_stats_frame.py) does NOT hold for the reference here:
    ``chip_smoke.py`` holds the full-size run to the symmetric form."""
    nsub, nchan = 128, 1024
    ar, _ = ref_make_synthetic_archive(nsub=nsub, nchan=nchan, nbin=128,
                                       seed=0, **bench_rfi_density(nsub,
                                                                   nchan))
    runs = {}
    for frame in ("dispersed", "dedispersed"):
        ref_cfg = RefConfig(stats_frame=frame, dtype="float32")
        want = ref_clean_archive(ar, ref_cfg)
        got = clean_archive(archive_from_reference(ar),
                            config_from_reference(ref_cfg, device="cpu"))
        np.testing.assert_array_equal(got.final_weights, want.final_weights)
        runs[frame] = (got, want)

    def decided(r):
        return (r.scores < 0.8) | (r.scores > 1.3)

    for i in (0, 1):   # the port's runs, then the reference's
        a, b = runs["dispersed"][i], runs["dedispersed"][i]
        disagree = (a.final_weights == 0) != (b.final_weights == 0)
        assert 0 < disagree.mean() < 0.01
        assert not np.any(disagree & decided(a) & decided(b))
        assert np.any(disagree & decided(a))


def test_cli_pulse_window_and_residual(tmp_path, monkeypatch, capsys):
    """``-r`` is consumed as (factor, start, end) and ``-u`` writes the
    single-pol residual archive ``<name>_residual_<loops><ext>`` in the
    working directory, as the reference CLI names it."""
    ar = archive_from_reference(_archive(SMALL))
    path = str(tmp_path / "obs.npz")
    save_archive(ar, path)
    monkeypatch.chdir(tmp_path)
    assert cli_main(["-u", "-r", "0.2", "30", "60", "--device", "cpu",
                     path]) == 0
    want = clean_archive(load_archive(path), CleanConfig(
        pulse_region=(0.2, 30, 60), unload_res=True, device="cpu"))
    cleaned = load_archive(path + "_cleaned.npz")
    np.testing.assert_array_equal(cleaned.weights, want.final_weights)
    res_path = "obs.npz_residual_%d.npz" % want.loops
    assert os.path.exists(res_path)
    res = load_archive(res_path)
    assert res.npol == 1 and res.pol_state == "Intensity"
    np.testing.assert_array_equal(res.data[:, 0],
                                  want.residual.astype(ar.data.dtype))
    assert "RFI removal stops after" in capsys.readouterr().out


def test_cli_baseline_mode_and_stats_frame(tmp_path, monkeypatch):
    ar = archive_from_reference(_archive(SMALL))
    path = str(tmp_path / "obs.npz")
    save_archive(ar, path)
    monkeypatch.chdir(tmp_path)
    assert cli_main(["--baseline_mode", "profile", "--stats_frame",
                     "dedispersed", "--device", "cpu", path]) == 0
    want = clean_archive(load_archive(path), CleanConfig(
        baseline_mode="profile", stats_frame="dedispersed", device="cpu"))
    cleaned = load_archive(path + "_cleaned.npz")
    np.testing.assert_array_equal(cleaned.weights, want.final_weights)
    assert not [f for f in os.listdir(".") if "_residual_" in f]
    with open("clean.log") as f:
        log = f.read()
    assert "baseline_mode='profile'" in log
    assert "stats_frame='dedispersed'" in log
