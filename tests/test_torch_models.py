"""The port's model registry and quicklook (``models/``) against the
reference package's (``iterative_cleaner_tpu/models``).

- The cases of the reference's ``tests/test_models.py``: the facade, the
  injected RFI caught without false zaps, float64 parity of the torch and
  numpy quicklooks, pre-zapped cells kept.
- The torch quicklook on the CPU (K6, K3 and the combine through their
  plain versions) against the JAX ``clean_archive_quicklook`` with
  ``fft_mode='dft'`` and ``median_impl='pallas'`` (K3 in interpret mode):
  masks equal, scores within rtol 1e-4; the port's numpy twin bit-equal
  to the reference's ``_clean_quicklook_numpy``; the torch float64
  quicklook mask-equal to the numpy twin.  On the default configuration,
  the profile baseline, a DEDISP=1 input, the roll rotation, other
  thresholds and the whole-line sweep.
- The design's claim, on K6's plain version: with a zero template and a
  window of ones its planes are those of ``-(w * ded)`` (three planes
  bit-equal to the plain diagnostics of ``w * ded``, ``d_mean`` exactly
  negated) and the scores bit-equal, in float32 and float64.
- The CLI's ``--model`` against the reference CLI's (``tests/test_cli.py``
  quicklook cases): outputs, refusals, ``online_ewt`` (ported with the
  online mode; ``tests/test_torch_online.py`` holds it against the JAX
  model) writing the online session's provisional mask, no fallback to
  the CPU.
"""

import numpy as np
import pytest
import torch

from iterative_cleaner_tpu import cli as ref_cli
from iterative_cleaner_tpu.config import CleanConfig as RefConfig
from iterative_cleaner_tpu.io import save_archive as ref_save_archive
from iterative_cleaner_tpu.io.synthetic import (
    make_synthetic_archive as ref_make_synthetic_archive,
)
from iterative_cleaner_tpu.models import quicklook as ref_quicklook
from iterative_cleaner_torch import cli
from iterative_cleaner_torch.convert import archive_from_reference
from iterative_cleaner_torch.io import load_archive, save_archive
from iterative_cleaner_torch.io.synthetic import make_synthetic_archive
from iterative_cleaner_torch.models import (
    ONLINE_EWT,
    QUICKLOOK,
    REGISTRY,
    SURGICAL_SCRUB,
    CleanConfig,
    CleanResult,
    get_model,
)
from iterative_cleaner_torch.models import quicklook
from iterative_cleaner_torch.stats.kernels import (
    cell_diagnostics_dedisp_plain,
)
from iterative_cleaner_torch.stats.masked_torch import (
    cell_diagnostics,
    scale_and_combine,
)

CPU = dict(device="cpu")

BASE = dict(nsub=12, nchan=24, nbin=64, n_prezapped=4, seed=8)
CASES = {
    "default": (BASE, {}),
    "profile-baseline": (dict(BASE, seed=11), dict(baseline_mode="profile")),
    "dedisp1-input": (dict(BASE, disperse=False, dedispersed=True), {}),
    "roll": (dict(BASE, nbin=63, seed=5), dict(rotation="roll")),
    "thresholds": (dict(BASE, seed=2), dict(chanthresh=4.0,
                                            subintthresh=3.5)),
    "bad-parts": (dict(BASE, seed=3, rfi_strength=40.0),
                  dict(bad_chan=0.3, bad_subint=0.3)),
}


def _archive(spec):
    spec = dict(spec)
    dedispersed = spec.pop("dedispersed", False)
    ref, _ = ref_make_synthetic_archive(**spec)
    ref.dedispersed = dedispersed
    return ref, archive_from_reference(ref)


# ---------------------------------------------------------------------------
# the reference's tests/test_models.py, on the port
# ---------------------------------------------------------------------------

def test_models_facade():
    ar, _ = make_synthetic_archive(nsub=6, nchan=8, nbin=32, seed=0)
    res = get_model(SURGICAL_SCRUB)(ar, CleanConfig(backend="numpy",
                                                    dtype="float64"))
    assert isinstance(res, CleanResult)
    assert res.final_weights.shape == (6, 8)
    assert set(REGISTRY) == {SURGICAL_SCRUB, QUICKLOOK, ONLINE_EWT}
    with pytest.raises(ValueError, match="unknown cleaning model"):
        get_model("nope")


def test_quicklook_zaps_injected_rfi():
    """Most of the strong injected RFI, no false zaps, in one pass; the
    flagship catches at least as much."""
    ar, truth = make_synthetic_archive(nsub=16, nchan=32, nbin=64, seed=3,
                                       rfi_strength=60.0)
    res = get_model(QUICKLOOK)(ar, CleanConfig(**CPU))
    assert isinstance(res, CleanResult)
    assert res.loops == 1 and res.converged
    zapped = res.final_weights == 0
    expected = truth.expected_zap(ar.nsub, ar.nchan)
    caught = (zapped & expected).sum()
    assert caught >= 0.6 * expected.sum()
    assert (zapped & ~expected).sum() == 0
    full = get_model(SURGICAL_SCRUB)(ar, CleanConfig(**CPU))
    assert ((full.final_weights == 0) & expected).sum() >= caught


def test_quicklook_backend_parity_float64():
    ar, _ = make_synthetic_archive(nsub=12, nchan=24, nbin=64, seed=8,
                                   n_prezapped=4)
    tq = get_model(QUICKLOOK)(ar, CleanConfig(dtype="float64", **CPU))
    npy = get_model(QUICKLOOK)(ar, CleanConfig(backend="numpy",
                                               dtype="float64"))
    np.testing.assert_array_equal(tq.final_weights, npy.final_weights)
    np.testing.assert_allclose(tq.scores, npy.scores, rtol=1e-9, atol=1e-9)


def test_quicklook_preserves_prezapped_cells():
    ar, _ = make_synthetic_archive(nsub=8, nchan=16, nbin=32, seed=5,
                                   n_prezapped=6)
    pre = ar.weights == 0
    res = get_model(QUICKLOOK)(ar, CleanConfig(**CPU))
    assert ((res.final_weights == 0) & pre).sum() == pre.sum()
    assert res.scores.shape == (8, 16)


# ---------------------------------------------------------------------------
# against the reference's quicklook
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(CASES))
def test_quicklook_matches_the_jax_quicklook(case):
    spec, kw = CASES[case]
    ref, ar = _archive(spec)
    want = ref_quicklook.clean_archive_quicklook(
        ref, RefConfig(fft_mode="dft", median_impl="pallas", **kw))
    got = quicklook.clean_archive_quicklook(ar, CleanConfig(**CPU, **kw))
    np.testing.assert_array_equal(got.final_weights == 0,
                                  want.final_weights == 0)
    np.testing.assert_allclose(got.scores, want.scores, rtol=1e-4,
                               atol=1e-4)
    assert (got.loops, got.converged) == (want.loops, want.converged)
    assert (got.n_bad_subints, got.n_bad_channels) == (
        want.n_bad_subints, want.n_bad_channels)
    np.testing.assert_array_equal(got.loop_diffs, want.loop_diffs)
    np.testing.assert_array_equal(got.loop_rfi_frac, want.loop_rfi_frac)
    assert got.iter_metrics is None and got.weight_history is None


@pytest.mark.parametrize("case", sorted(CASES))
def test_numpy_twin_is_bit_equal_to_the_references(case):
    spec, kw = CASES[case]
    ref, ar = _archive(spec)
    want = ref_quicklook._clean_quicklook_numpy(
        ref, RefConfig(backend="numpy", **kw))
    got = quicklook.clean_archive_quicklook(
        ar, CleanConfig(backend="numpy", **kw))
    np.testing.assert_array_equal(got.final_weights, want.final_weights)
    np.testing.assert_array_equal(got.scores, want.scores)
    for name in ("loop_diffs", "loop_rfi_frac"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert (got.n_bad_subints, got.n_bad_channels) == (
        want.n_bad_subints, want.n_bad_channels)


@pytest.mark.parametrize("case", sorted(CASES))
def test_float64_quicklook_is_mask_equal_to_the_numpy_twin(case):
    spec, kw = CASES[case]
    _, ar = _archive(spec)
    got = quicklook.clean_archive_quicklook(
        ar, CleanConfig(dtype="float64", **CPU, **kw))
    want = quicklook.clean_archive_quicklook(
        ar, CleanConfig(backend="numpy", **kw))
    assert got.scores.dtype == np.float64
    np.testing.assert_array_equal(got.final_weights == 0,
                                  want.final_weights == 0)
    np.testing.assert_allclose(got.scores, want.scores, rtol=1e-9,
                               atol=1e-9)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("seed", range(4))
def test_k6_zero_template_gives_the_scores_of_w_ded(seed, dtype):
    """K6's plain version with an all-zero template and a ones window: the
    residual is -(w * ded), so d_std, d_ptp and d_fft are bit-equal to the
    plain diagnostics of w * ded, d_mean is exactly negated, and the
    scores are bit-equal; hot rows and columns and 10% pre-zapped cells."""
    g = torch.Generator().manual_seed(seed)
    nsub, nchan, nbin = 24, 40, 64
    ded = (torch.randn(nsub, nchan, nbin, generator=g) * 3 + 1).to(dtype)
    ded[3] += 25.0
    ded[:, 7] *= 9.0
    w = (torch.rand(nsub, nchan, generator=g) > 0.1).to(dtype)
    mask = w == 0
    zero = torch.zeros(nbin, dtype=dtype)
    ones = torch.ones(nbin, dtype=dtype)
    got = cell_diagnostics_dedisp_plain(ded, zero, ones, w, mask)
    want = cell_diagnostics(ded * w[:, :, None], mask, "dft")
    for i in (0, 2, 3):
        assert torch.equal(got[i], want[i]), i
    assert torch.equal(got[1], -want[1])
    s_got = scale_and_combine(got, mask, 5.0, 5.0)
    s_want = scale_and_combine(want, mask, 5.0, 5.0)
    assert torch.equal(torch.isnan(s_got), torch.isnan(s_want))
    assert torch.equal(torch.nan_to_num(s_got), torch.nan_to_num(s_want))
    # quicklook's own scoring, on the same inputs
    new_w, scores = quicklook.quicklook_scores(ded, w, 5.0, 5.0)
    assert torch.equal(torch.nan_to_num(scores), torch.nan_to_num(s_want))
    assert torch.equal(new_w, torch.where(scores >= 1, 0, w).to(dtype))


def test_quicklook_ignores_compute_dtype():
    ar, _ = make_synthetic_archive(nsub=8, nchan=16, nbin=32, seed=2)
    a = get_model(QUICKLOOK)(ar, CleanConfig(**CPU))
    b = get_model(QUICKLOOK)(ar, CleanConfig(compute_dtype="bfloat16", **CPU))
    np.testing.assert_array_equal(a.scores, b.scores)
    np.testing.assert_array_equal(a.final_weights, b.final_weights)


def test_quicklook_keeps_only_the_dedispersed_cube():
    """The preamble's pre-rotation cube (the integration baseline's
    template correction operand) is not returned."""
    ar, _ = make_synthetic_archive(nsub=4, nchan=8, nbin=32, seed=1)
    cube = torch.from_numpy(ar.total_intensity().astype(np.float32))
    w = torch.from_numpy(ar.weights.astype(np.float32))
    ded = quicklook.quicklook_prepare(
        cube.clone(), w, torch.from_numpy(ar.freqs_mhz.astype(np.float32)),
        torch.tensor(ar.dm, dtype=torch.float32),
        torch.tensor(ar.centre_freq_mhz, dtype=torch.float32),
        torch.tensor(ar.period_s, dtype=torch.float32), CleanConfig(**CPU),
        dedispersed=False)
    assert isinstance(ded, torch.Tensor) and ded.shape == cube.shape


def test_quicklook_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    ar, _ = make_synthetic_archive(nsub=4, nchan=8, nbin=32, seed=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_model(QUICKLOOK)(ar, CleanConfig())


def test_online_ewt_names_item_5():
    """Item 5 is ported: ``online_ewt`` is the online session's
    provisional mask, no longer a refusal naming the item."""
    from iterative_cleaner_torch.online import OnlineSession, StreamMeta

    ar, _ = make_synthetic_archive(nsub=4, nchan=8, nbin=32, seed=1)
    res = get_model(ONLINE_EWT)(ar, CleanConfig(**CPU))
    s = OnlineSession(StreamMeta.from_archive(ar), CleanConfig(**CPU),
                      reconcile_every=0)
    s.ingest(ar.total_intensity(), ar.weights)
    np.testing.assert_array_equal(res.final_weights, s.provisional_weights)
    assert (res.loops, res.converged) == (1, True)


# ---------------------------------------------------------------------------
# the CLI's --model (the reference's tests/test_cli.py quicklook cases)
# ---------------------------------------------------------------------------

@pytest.fixture()
def archive_file(tmp_path):
    ref, _ = ref_make_synthetic_archive(nsub=16, nchan=32, nbin=64, seed=1,
                                        n_prezapped=5)
    path = str(tmp_path / "obs.npz")
    ref_save_archive(ref, path)
    return path


def test_model_quicklook_cleans(archive_file, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert cli.main(["-q", "--device", "cpu", "--model", "quicklook",
                     archive_file]) == 0
    cleaned = load_archive(archive_file + "_cleaned.npz")
    orig = load_archive(archive_file)
    pre = orig.weights == 0
    assert ((cleaned.weights == 0) & pre).sum() == pre.sum()
    np.testing.assert_array_equal(cleaned.data, orig.data)


@pytest.mark.parametrize("more", [
    ["--batch", "2"], ["-u"], ["--checkpoint", "ck"], ["--record_history"],
    ["--mesh", "cell"], ["--stream", "8"],
])
@pytest.mark.parametrize("model", ["quicklook", "online_ewt"])
def test_model_incompatible_flags_are_the_reference_parsers(model, more,
                                                            tmp_path):
    for main in (cli.main, ref_cli.main):
        with pytest.raises(SystemExit) as ei:
            main(["--model", model] + more + [str(tmp_path / "x.npz")])
        assert ei.value.code == 2


def test_model_online_ewt_names_item_5(archive_file, tmp_path, monkeypatch):
    """Item 5 is ported: ``--model online_ewt`` cleans, writing the
    model's provisional mask."""
    monkeypatch.chdir(tmp_path)
    assert cli.main(["-q", "--device", "cpu", "--model", "online_ewt",
                     archive_file]) == 0
    want = get_model(ONLINE_EWT)(load_archive(archive_file),
                                 CleanConfig(**CPU))
    np.testing.assert_array_equal(
        load_archive(archive_file + "_cleaned.npz").weights,
        want.final_weights)


def test_model_quicklook_numpy_backend_matches_torch(archive_file, tmp_path,
                                                    monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert cli.main(["-q", "--model", "quicklook", "--backend", "numpy",
                     "-o", str(tmp_path / "np.npz"), archive_file]) == 0
    assert cli.main(["-q", "--device", "cpu", "--model", "quicklook",
                     archive_file]) == 0
    a = load_archive(str(tmp_path / "np.npz"))
    b = load_archive(archive_file + "_cleaned.npz")
    np.testing.assert_array_equal(a.weights == 0, b.weights == 0)


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_model_quicklook_cli_matches_the_reference_cli(backend, archive_file,
                                                       tmp_path, monkeypatch):
    """The two CLIs' quicklook outputs: bit-equal weights on the numpy
    oracle, equal masks on the torch engine (the reference's on the
    CPU)."""
    monkeypatch.chdir(tmp_path)
    ref_backend = "numpy" if backend == "numpy" else "jax"
    assert ref_cli.main(["-q", "-l", "--model", "quicklook", "--backend",
                         ref_backend, "-o", "ref.npz", archive_file]) == 0
    assert cli.main(["-q", "-l", "--model", "quicklook", "--backend",
                     backend, "--device", "cpu", "-o", "port.npz",
                     archive_file]) == 0
    a, b = load_archive("ref.npz").weights, load_archive("port.npz").weights
    if backend == "numpy":
        np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_array_equal(a == 0, b == 0)


def test_model_quicklook_cli_without_a_card_raises(archive_file, tmp_path,
                                                   monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["-q", "-l", "--model", "quicklook", archive_file])


def test_quicklook_pairs_with_save_archive_roundtrip(tmp_path):
    """A quicklook of an archive read back from disk is the quicklook of
    the archive in memory."""
    ar, _ = make_synthetic_archive(nsub=8, nchan=16, nbin=32, seed=6,
                                   n_prezapped=2)
    path = str(tmp_path / "a.npz")
    save_archive(ar, path)
    a = get_model(QUICKLOOK)(ar, CleanConfig(**CPU))
    b = get_model(QUICKLOOK)(load_archive(path), CleanConfig(**CPU))
    np.testing.assert_array_equal(a.scores, b.scores)
