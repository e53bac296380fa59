"""The port's default-config slice end to end, on the CPU (every kernel
through its plain PyTorch version), against the JAX package.

Both packages clean the SAME archive (the reference's synthetic
generator, carried over with ``convert.archive_from_reference``) under
the same configuration: the JAX package on its default CPU route and on
the explicit TPU kernel route (fused stats, DFT spectra, Pallas medians,
fused sweep; interpret mode).  Final masks, loop counts, convergence and
per-loop diffs are equal; scores agree to rtol 1e-4 with a 1e-4 floor
(scores are in threshold units; near-median cells lose relative
precision to cancellation, and the JAX default route takes its spectra
by FFT where the port takes them by DFT).
"""

import os

import numpy as np
import pytest
import torch

from iterative_cleaner_tpu.backends import clean_archive as ref_clean_archive
from iterative_cleaner_tpu.config import CleanConfig as RefConfig
from iterative_cleaner_tpu.io import load_archive as ref_load_archive
from iterative_cleaner_tpu.io.synthetic import (
    make_synthetic_archive as ref_make_synthetic_archive,
)
from iterative_cleaner_torch import CleanConfig
from iterative_cleaner_torch.backends import clean_archive
from iterative_cleaner_torch.cli import main as cli_main
from iterative_cleaner_torch.convert import (
    archive_from_reference,
    config_from_reference,
)
from iterative_cleaner_torch.io import load_archive, save_archive
from iterative_cleaner_torch.io.synthetic import (
    bench_rfi_density,
    make_synthetic_archive,
)

ARCHIVES = {
    "16x32x64": dict(nsub=16, nchan=32, nbin=64, n_prezapped=5, seed=3),
    "ragged-20x40x128": dict(nsub=20, nchan=40, nbin=128, n_prezapped=7,
                             seed=11),
    "roll-odd-16x32x63": dict(nsub=16, nchan=32, nbin=63, n_prezapped=4,
                              seed=5, rotation="roll"),
}
ROUTES = {
    "jax-default": dict(),
    "jax-kernels": dict(stats_impl="fused", fft_mode="dft",
                        median_impl="pallas", fused_sweep="on"),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("name", sorted(ARCHIVES))
def test_slice_matches_reference(name, route):
    spec = dict(ARCHIVES[name])
    rotation = spec.pop("rotation", "fourier")
    ar, _ = ref_make_synthetic_archive(**spec)
    ref_cfg = RefConfig(rotation=rotation, **ROUTES[route])
    want = ref_clean_archive(ar, ref_cfg)
    got = clean_archive(archive_from_reference(ar),
                        config_from_reference(ref_cfg, device="cpu"))
    np.testing.assert_array_equal(got.final_weights == 0,
                                  want.final_weights == 0)
    np.testing.assert_array_equal(got.final_weights, want.final_weights)
    assert (got.loops, got.converged) == (want.loops, want.converged)
    np.testing.assert_array_equal(got.loop_diffs, want.loop_diffs)
    np.testing.assert_allclose(got.loop_rfi_frac, want.loop_rfi_frac,
                               rtol=1e-6)
    np.testing.assert_allclose(got.scores, want.scores, rtol=1e-4, atol=1e-4)
    assert got.iter_metrics.shape == want.iter_metrics.shape
    np.testing.assert_array_equal(got.iter_metrics[:, :2],
                                  want.iter_metrics[:, :2])


@pytest.mark.parametrize("kwargs", [
    dict(nsub=16, nchan=32, nbin=128, n_prezapped=5, seed=42),
    dict(nsub=8, nchan=16, nbin=64, npol=2, seed=1, dtype=np.float32),
    dict(nsub=300, nchan=256, nbin=16, seed=0, disperse=False,
         **bench_rfi_density(300, 256)),
])
def test_synthetic_archive_byte_identical(kwargs):
    got, got_truth = make_synthetic_archive(**kwargs)
    want, want_truth = ref_make_synthetic_archive(**kwargs)
    for field in ("data", "weights", "freqs_mhz"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes(), field
    for field in ("period_s", "dm", "centre_freq_mhz", "source",
                  "pol_state", "dedispersed"):
        assert getattr(got, field) == getattr(want, field)
    for field in ("rfi_cells", "rfi_channels", "rfi_subints", "prezapped"):
        np.testing.assert_array_equal(getattr(got_truth, field),
                                      getattr(want_truth, field))


@pytest.mark.parametrize("kwargs", [
    dict(pulse_region=(0.5, 10, 20)),
    dict(baseline_mode="profile"),
    dict(unload_res=True),
    dict(dtype="bfloat16"),
    dict(dtype="float64"),
])
def test_out_of_slice_configs_refused(kwargs):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        CleanConfig(device="cpu", **kwargs)


def test_dedispersed_input_refused():
    ar, _ = make_synthetic_archive(nsub=4, nchan=8, nbin=32, seed=0)
    ar.dedispersed = True
    with pytest.raises(NotImplementedError, match="DEDISP"):
        clean_archive(ar, CleanConfig(device="cpu"))


def test_default_device_is_the_card():
    """The default config runs on CUDA; with no card present it raises
    rather than falling back to the CPU."""
    assert CleanConfig().device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    ar, _ = make_synthetic_archive(nsub=4, nchan=8, nbin=32, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        clean_archive(ar, CleanConfig())


def test_cli_cleans_and_logs(tmp_path, capsys):
    ar, _ = ref_make_synthetic_archive(nsub=16, nchan=32, nbin=64,
                                       n_prezapped=5, seed=7)
    path = str(tmp_path / "obs.npz")
    save_archive(archive_from_reference(ar), path)
    assert cli_main(["-c", "4.5", "--device", "cpu", path]) == 0
    out_path = path + "_cleaned.npz"
    assert os.path.exists(out_path)
    cleaned = load_archive(out_path)
    np.testing.assert_array_equal(cleaned.data, ar.data)
    want = clean_archive(load_archive(path),
                         CleanConfig(chanthresh=4.5, device="cpu"))
    np.testing.assert_array_equal(cleaned.weights, want.final_weights)
    # the reference package reads the port's output container
    np.testing.assert_array_equal(ref_load_archive(out_path).weights,
                                  cleaned.weights)
    with open(tmp_path / "clean.log") as f:
        log = f.read()
    assert "Cleaned obs.npz with Namespace(" in log
    assert "required loops=%d" % want.loops in log
    assert "RFI removal stops after" in capsys.readouterr().out
