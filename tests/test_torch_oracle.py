"""The port's float64 numpy oracle (``--backend numpy``) against the
reference package's.

The port keeps its own copy of the oracle (``backends/numpy_backend.py``,
``stats/masked_numpy.py``, ``ops/dsp_numpy.py``,
``ops/psrchive_baseline_numpy.py``); the same archive and configuration
through both give bit-equal results: final weights, scores (NaN by
position), loops, convergence, per-loop diffs and fractions,
``iter_metrics``, the residual and the weight history.  Covered: the
whole clean on the default configuration, the profile baseline, a pulse
window, a DEDISP=1 input, the ``roll`` rotation, the dedispersed frame;
exact and online streams; the modules on their own; the CLI's
``--backend numpy`` against the reference CLI's and its parser's
refusals; ``tools selftest --device cpu``.
"""

import numpy as np
import pytest

from iterative_cleaner_tpu import cli as ref_cli
from iterative_cleaner_tpu.backends import clean_archive as ref_clean_archive
from iterative_cleaner_tpu.config import CleanConfig as RefConfig
from iterative_cleaner_tpu.io import save_archive as ref_save_archive
from iterative_cleaner_tpu.io.synthetic import (
    make_synthetic_archive as ref_make_synthetic_archive,
)
from iterative_cleaner_tpu.ops import dsp as ref_dsp
from iterative_cleaner_tpu.ops import psrchive_baseline as ref_base
from iterative_cleaner_tpu.parallel.streaming import (
    clean_streaming as ref_clean_streaming,
)
from iterative_cleaner_tpu.stats import masked_numpy as ref_masked_numpy
from iterative_cleaner_torch import CleanConfig, clean_streaming, cli, tools
from iterative_cleaner_torch.backends import (
    clean_archive,
    get_backend,
    numpy_backend,
    torch_backend,
)
from iterative_cleaner_torch.convert import (
    archive_from_reference,
    config_from_reference,
)
from iterative_cleaner_torch.io import load_archive
from iterative_cleaner_torch.ops import dsp_numpy, psrchive_baseline_numpy
from iterative_cleaner_torch.stats import masked_numpy

SMALL = dict(nsub=16, nchan=32, nbin=64, n_prezapped=5, seed=3)
CASES = {
    "default": (SMALL, {}),
    "profile-baseline": (dict(SMALL, seed=11), dict(baseline_mode="profile")),
    "pulse-window": (SMALL, dict(pulse_region=(0.2, 30, 60))),
    "dedisp1-input": (dict(SMALL, disperse=False, dedispersed=True), {}),
    "roll": (dict(SMALL, nbin=63, seed=5), dict(rotation="roll")),
    "dedisp-frame": (SMALL, dict(stats_frame="dedispersed")),
    "unload-history": (SMALL, dict(unload_res=True, record_history=True,
                                   bad_chan=0.5)),
}


def _archive(spec):
    spec = dict(spec)
    dedispersed = spec.pop("dedispersed", False)
    ar, _ = ref_make_synthetic_archive(**spec)
    ar.dedispersed = dedispersed
    return ar


def _same_result(got, want):
    np.testing.assert_array_equal(got.final_weights, want.final_weights)
    np.testing.assert_array_equal(got.scores, want.scores)
    assert (got.loops, got.converged) == (want.loops, want.converged)
    assert (got.n_bad_subints, got.n_bad_channels) == (
        want.n_bad_subints, want.n_bad_channels)
    for name in ("loop_diffs", "loop_rfi_frac", "iter_metrics", "residual",
                 "weight_history"):
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None), name
        if b is not None:
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_oracle_bit_equal_to_reference_oracle(case):
    spec, kwargs = CASES[case]
    ar = _archive(spec)
    want = ref_clean_archive(ar, RefConfig(backend="numpy", **kwargs))
    got = clean_archive(archive_from_reference(ar),
                        CleanConfig(backend="numpy", **kwargs))
    _same_result(got, want)


@pytest.mark.parametrize("mode,chunk", [("exact", 5), ("online", 8)])
@pytest.mark.parametrize("case", ["default", "profile-baseline",
                                  "pulse-window", "dedisp1-input"])
def test_oracle_streams_bit_equal_to_reference(case, mode, chunk):
    """Both stream modes on the oracle (the reference's
    ``_clean_exact_numpy`` and its online tiles through ``get_backend``),
    a partial final tile included."""
    spec, kwargs = CASES[case]
    ar = _archive(spec)
    want = ref_clean_streaming(ar, chunk, RefConfig(backend="numpy",
                                                    **kwargs), mode=mode)
    got = clean_streaming(archive_from_reference(ar), chunk,
                          CleanConfig(backend="numpy", **kwargs), mode=mode)
    _same_result(got, want)


def test_oracle_modules_bit_equal_to_reference():
    """Each copied module's functions on the same inputs: the DSP ops,
    the baselines and the template correction, the ``numpy.ma``
    statistics."""
    rng = np.random.default_rng(7)
    cube = rng.normal(10.0, 2.0, (6, 12, 40))
    w = (rng.random((6, 12)) > 0.2).astype(np.float64)
    freqs = np.linspace(1300.0, 1500.0, 12)
    shifts = rng.normal(0.0, 3.0, 12)
    for method in ("fourier", "roll"):
        np.testing.assert_array_equal(
            dsp_numpy.rotate_bins(cube, shifts, method),
            ref_dsp.rotate_bins(cube, shifts, np, method))
        np.testing.assert_array_equal(
            dsp_numpy.dedisperse_cube(cube, freqs, 30.0, 1400.0, 0.5, method,
                                      forward=False),
            ref_dsp.dedisperse_cube(cube, freqs, 30.0, 1400.0, 0.5, np,
                                    method, forward=False))
    for mode in ("integration", "profile"):
        got = dsp_numpy.prepare_cube_with_correction(
            cube, w, freqs, 30.0, 1400.0, 0.5, baseline_duty=0.15,
            rotation="fourier", baseline_mode=mode)
        want = ref_dsp.prepare_cube_with_correction(
            cube, w, freqs, 30.0, 1400.0, 0.5, np, baseline_duty=0.15,
            rotation="fourier", baseline_mode=mode)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert (got[2] is None) == (want[2] is None)
    off, _ = psrchive_baseline_numpy.baseline_offsets_integration(cube, w,
                                                                  0.15)
    np.testing.assert_array_equal(
        off, ref_base.baseline_offsets_integration(cube, w, 0.15, np)[0])
    np.testing.assert_array_equal(
        psrchive_baseline_numpy.template_correction(cube - off[..., None],
                                                    off, w, 0.15),
        ref_base.template_correction(cube - off[..., None], off, w, 0.15,
                                     np))
    np.testing.assert_array_equal(
        psrchive_baseline_numpy.template_correction_numerator_raw(
            cube, off, w, 0.15),
        ref_base.template_correction_numerator_raw(cube, off, w, 0.15, np))
    t = dsp_numpy.weighted_template(cube, w)
    np.testing.assert_array_equal(t, ref_dsp.weighted_template(cube, w, np))
    amps = dsp_numpy.fit_template_amplitudes(cube, t)
    np.testing.assert_array_equal(
        amps, ref_dsp.fit_template_amplitudes(cube, t, np))
    resid = dsp_numpy.template_residuals(cube, t, amps, (3, 9), 0.2, True)
    np.testing.assert_array_equal(
        resid, ref_dsp.template_residuals(cube, t, amps, (3, 9), 0.2, np,
                                          True))
    mask = w == 0
    np.testing.assert_array_equal(
        masked_numpy.surgical_scores_numpy(resid * w[..., None], mask, 5, 4),
        ref_masked_numpy.surgical_scores_numpy(resid * w[..., None], mask,
                                               5, 4))


def test_get_backend_and_config():
    assert get_backend("numpy") is numpy_backend
    assert get_backend("torch") is torch_backend
    with pytest.raises(ValueError, match="unknown backend"):
        get_backend("jax")
    with pytest.raises(ValueError, match="unknown backend"):
        CleanConfig(backend="jax")
    assert CleanConfig().backend == "torch"
    # the reference's accelerator backend maps to the port's engine
    assert config_from_reference(RefConfig()).backend == "torch"
    assert config_from_reference(RefConfig(backend="numpy")).backend \
        == "numpy"
    # the oracle casts to float64 whatever dtype says, on the host
    ar = archive_from_reference(_archive(SMALL))
    a = clean_archive(ar, CleanConfig(backend="numpy", dtype="float32",
                                      device="cuda"))
    b = clean_archive(ar, CleanConfig(backend="numpy", dtype="float64"))
    np.testing.assert_array_equal(a.scores, b.scores)
    assert a.scores.dtype == np.float64


@pytest.mark.parametrize("stream", [[], ["--stream", "5"],
                                    ["--stream", "8", "--stream_mode",
                                     "online"]])
def test_cli_backend_numpy_matches_reference_cli(tmp_path, monkeypatch,
                                                 stream):
    ar = _archive(CASES["default"][0])
    out = {}
    for name, main, extra in (("ref", ref_cli.main, []),
                              ("port", cli.main, ["--device", "cpu"])):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        ref_save_archive(ar, "obs.npz")
        assert main(["-q", "--backend", "numpy", *stream, *extra,
                     "obs.npz"]) == 0
        out[name] = load_archive(str(d / "obs.npz_cleaned.npz")).weights
    np.testing.assert_array_equal(out["port"], out["ref"])


@pytest.mark.parametrize("flags", [["--batch", "2"], ["--mesh", "cell"],
                                   ["--mesh", "batch", "--batch", "2"]])
def test_cli_refuses_backend_numpy_where_the_reference_does(flags, capsys):
    for main in (ref_cli.main, cli.main):
        with pytest.raises(SystemExit) as exc:
            main(["--backend", "numpy", *flags, "obs.npz"])
        assert exc.value.code == 2
    assert "--backend" in capsys.readouterr().err


def test_tools_selftest_on_the_cpu(capsys):
    assert tools.main(["selftest", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "numpy [host]" in out and "torch [cpu]" in out
    assert "OK: masks bit-identical" in out
