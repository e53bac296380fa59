"""The port's online mode (``iterative_cleaner_torch/online``) against the
JAX package's (``iterative_cleaner_tpu/online``), on the CPU: every
kernel of the per-subint step (K6, K3 along each axis, the combine)
through its plain PyTorch version.

The JAX side runs its kernel route (``stats_impl='fused'``,
``fft_mode='dft'``, ``median_impl='pallas'``, ``fused_sweep='on'``,
interpret mode), whose step is the one-launch ``fused_sweep_pallas_
dedisp`` the port's K6 + K3 x 2 + combine reproduce; the close masks are
also held to the JAX default route.  Tolerances: provisional and final
masks bit-equal; scores bit-equal by position of their NaNs and within
rtol 1e-5 elsewhere (float32 reassociation through the template); EW
templates rtol 1e-6 of their peak.  At nsub = 1 every channel line of the
scaler holds one entry, so the rFFT diagnostic's channel side is 0 / 0:
both packages score every cell of a provisional subint NaN and zap only
what the upstream weights zapped; the reconciles and the close decide.

Covered: the chunk protocol and the EW template round trips; the step
per subint in float32, bf16 storage and float64, on the dispersed and a
DEDISP=1 input, with the pulse window on and off; a session's close
bit-equal to ``clean_archive``; mid-stream reconciles (drift counts,
provisional weights, the repaired mask equal to the prefix's batch
clean); the refusals; ``online_ewt``; the quality monitor against the
JAX monitor on one mask stream; ``--stream DIR`` through ``cli.main``
and the parser's refusals against the JAX parser's.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from iterative_cleaner_tpu import cli as ref_cli
from iterative_cleaner_tpu.backends import clean_archive as ref_clean_archive
from iterative_cleaner_tpu.config import CleanConfig as RefConfig
from iterative_cleaner_tpu.io.synthetic import (
    make_synthetic_archive as ref_make_synthetic_archive,
)
from iterative_cleaner_tpu.models import get_model as ref_get_model
from iterative_cleaner_tpu.online import OnlineSession as RefSession
from iterative_cleaner_tpu.online import StreamMeta as RefMeta
from iterative_cleaner_tpu.online import chunks as ref_chunks
from iterative_cleaner_tpu.online import ewt as ref_ewt
from iterative_cleaner_tpu.online.step import (
    build_subint_step as ref_build_subint_step,
)
from iterative_cleaner_tpu.telemetry import MetricsRegistry as RefRegistry
from iterative_cleaner_tpu.telemetry.quality import (
    QualityMonitor as RefMonitor,
)
from iterative_cleaner_torch import cli
from iterative_cleaner_torch.backends import clean_archive
from iterative_cleaner_torch.convert import (
    archive_from_reference,
    config_from_reference,
)
from iterative_cleaner_torch.io import load_archive
from iterative_cleaner_torch.models import ONLINE_EWT, get_model
from iterative_cleaner_torch.online import (
    CLOSE_SENTINEL,
    DEFAULT_EW_ALPHA,
    DEFAULT_RECONCILE_EVERY,
    OnlineSession,
    StreamMeta,
    assemble_archive,
    is_chunk_name,
    load_chunk,
    load_stream_meta,
    resolve_ew_alpha,
    resolve_reconcile_every,
    save_stream_meta,
)
from iterative_cleaner_torch.online.ewt import ew_update, subint_profile
from iterative_cleaner_torch.online.step import (
    STEP_KERNELS,
    build_subint_step,
    step_build_key,
)
from iterative_cleaner_torch.stats.kernels import (
    launch_counts,
    reset_launch_counts,
)
from iterative_cleaner_torch.telemetry import MetricsRegistry
from iterative_cleaner_torch.telemetry.quality import QualityMonitor

KERNEL_ROUTE = dict(stats_impl="fused", fft_mode="dft", median_impl="pallas",
                    fused_sweep="on")


def _ref_cfg(**kw):
    kw.setdefault("max_iter", 3)
    return RefConfig(**kw)


def _stream(nsub=10, nchan=16, nbin=32, seed=3, **kw):
    ar, _ = ref_make_synthetic_archive(nsub=nsub, nchan=nchan, nbin=nbin,
                                       seed=seed, **kw)
    return ar, np.asarray(ar.total_intensity(), np.float64)


def _meta(ar):
    return StreamMeta.from_archive(archive_from_reference(ar))


def _scores_close(got, want, rtol=1e-5):
    """Scores: NaN at the same cells, the rest within rtol."""
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=rtol, atol=1e-6)


def _template_close(got, want):
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=1e-6 * scale)


# ------------------------------------------------------------ the chunks

def test_stream_meta_round_trips_with_the_reference(tmp_path):
    ar, _ = _stream(nsub=2)
    meta = _meta(ar)
    assert meta.to_dict() == RefMeta.from_archive(ar).to_dict()
    save_stream_meta(str(tmp_path), meta)
    assert load_stream_meta(str(tmp_path)) == meta
    # either package reads the other's header
    assert ref_chunks.load_stream_meta(str(tmp_path)).to_dict() \
        == meta.to_dict()
    (tmp_path / "r").mkdir()
    ref_chunks.save_stream_meta(str(tmp_path / "r"), RefMeta.from_archive(ar))
    assert load_stream_meta(str(tmp_path / "r")) == meta
    assert load_stream_meta(str(tmp_path / "none")) is None
    assert StreamMeta.from_dict(json.loads(json.dumps(meta.to_dict()))) \
        == meta
    with pytest.raises(ValueError, match="frequencies"):
        StreamMeta(nchan=4, nbin=8, freqs_mhz=(1.0,), period_s=1.0, dm=0.0,
                   centre_freq_mhz=1.0)
    with pytest.raises(ValueError, match="bad stream meta"):
        StreamMeta.from_dict({"nchan": 4})
    (tmp_path / "torn").mkdir()
    (tmp_path / "torn" / "stream.json").write_text("")
    with pytest.raises(ValueError, match="unreadable"):
        load_stream_meta(str(tmp_path / "torn"))


@pytest.mark.parametrize("name", [
    "000001.npy", "subint.NPZ", "obs.ar", "x.sf", "x.fits", "stream.json",
    CLOSE_SENTINEL, ".000001.npy", "stream_cleaned.npz", "notes.txt",
    "a.icar"])
def test_is_chunk_name_is_the_references(name):
    assert is_chunk_name(name) == ref_chunks.is_chunk_name(name)


def test_load_chunk_and_assemble_match_the_reference(tmp_path):
    ar, cube = _stream(nsub=3)
    meta = _meta(ar)
    p = str(tmp_path / "c0.npy")
    np.save(p, cube[0])
    with pytest.raises(ValueError, match="needs stream metadata"):
        load_chunk(p)
    data, weights, got = load_chunk(p, meta)
    rdata, rweights, _ = ref_chunks.load_chunk(p, RefMeta.from_archive(ar))
    assert got is meta
    np.testing.assert_array_equal(data, rdata)
    np.testing.assert_array_equal(weights, rweights)
    bad = str(tmp_path / "bad.npy")
    np.save(bad, cube[0][:, :4])
    with pytest.raises(ValueError, match="shape"):
        load_chunk(bad, meta)
    # an archive container carries its own metadata
    from iterative_cleaner_tpu.io import save_archive as ref_save_archive

    pz = str(tmp_path / "chunk.npz")
    ref_save_archive(ar, pz)
    data, weights, got = load_chunk(pz)
    assert got == meta
    np.testing.assert_array_equal(data, cube)
    np.testing.assert_array_equal(weights, ar.weights)
    other = StreamMeta(nchan=4, nbin=8, freqs_mhz=(1.0, 2.0, 3.0, 4.0),
                       period_s=1.0, dm=0.0, centre_freq_mhz=2.0)
    with pytest.raises(ValueError, match="does not match the stream"):
        load_chunk(pz, other)
    w = np.ones((3, meta.nchan))
    w[1, 2] = 0.0
    back = assemble_archive(meta, cube, w)
    ref_back = ref_chunks.assemble_archive(RefMeta.from_archive(ar), cube, w)
    for field in ("data", "weights", "freqs_mhz"):
        np.testing.assert_array_equal(getattr(back, field),
                                      getattr(ref_back, field))
    assert (back.period_s, back.dm, back.dedispersed) == (
        ref_back.period_s, ref_back.dm, ref_back.dedispersed)


def test_ew_template_matches_the_reference():
    import jax.numpy as jnp

    rng = np.random.default_rng(5)
    ded = rng.normal(size=(1, 16, 32)).astype(np.float32)
    w = (rng.random((1, 16)) > 0.2).astype(np.float32)
    got = subint_profile(torch.from_numpy(ded), torch.from_numpy(w))
    want = np.asarray(ref_ewt.subint_profile(jnp.asarray(ded),
                                             jnp.asarray(w), jnp))
    _template_close(got.numpy(), want)
    # an all-zapped subint profiles to zeros
    zero = subint_profile(torch.from_numpy(ded), torch.zeros(1, 16))
    assert torch.count_nonzero(zero) == 0
    t = rng.normal(size=32).astype(np.float32)
    for count in (0, 3):
        got = ew_update(torch.from_numpy(t), torch.tensor(count),
                        torch.tensor(want), 0.2)
        ref = np.asarray(ref_ewt.ew_update(jnp.asarray(t), count,
                                           jnp.asarray(want), 0.2, jnp))
        np.testing.assert_array_equal(got.numpy(), ref)
    # the first real profile seeds the template outright
    np.testing.assert_array_equal(
        ew_update(torch.from_numpy(t), torch.tensor(0),
                  torch.tensor(want), 0.2).numpy(), want)


# -------------------------------------------------------------- the step

STEP_CASES = {
    # name: (dtype, compute_dtype, DEDISP=1 input, pulse window)
    "f32-disp-nowindow": ("float32", None, False, False),
    "f32-dedisp-window": ("float32", None, True, True),
    "bf16-disp-window": ("float32", "bfloat16", False, True),
    "bf16-dedisp-nowindow": ("float32", "bfloat16", True, False),
    "f64-disp-nowindow": ("float64", None, False, False),
    "f64-dedisp-window": ("float64", None, True, True),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_step_matches_the_reference_step(case):
    """The port's step (solo form) against the JAX step, subint by
    subint, each carrying its own EW template and count."""
    dtype, cdt, dedisp, window = STEP_CASES[case]
    nsub, nchan, nbin = 6, 16, 32
    spec = dict(disperse=False) if dedisp else {}
    ar, cube = _stream(nsub=nsub, nchan=nchan, nbin=nbin, seed=7,
                       n_prezapped=3, **spec)
    weights = np.asarray(ar.weights, np.float64)
    weights[4] = 0.0     # an all-zapped subint keeps the template
    # float64 takes the JAX step's XLA route (its kernels are float32)
    kw = dict(KERNEL_ROUTE if dtype == "float32" else {}, dtype=dtype,
              compute_dtype=cdt)
    if window:
        kw["pulse_region"] = (0.3, 8, 20)
    rc = _ref_cfg(**kw)
    pc = config_from_reference(rc, device="cpu")
    alpha = 0.3
    ref_step, ref_dt = ref_build_subint_step(rc, nchan, nbin, dedisp, alpha)
    ref_step = jax.jit(ref_step)
    step, dev, tdt = build_subint_step(pc, nchan, nbin, dedisp, alpha)
    assert (str(dev), tdt) == ("cpu", getattr(torch, dtype))
    np_dt = np.float64 if dtype == "float64" else np.float32
    freqs = np.asarray(ar.freqs_mhz, np.float64)
    scalars = (ar.dm, ar.centre_freq_mhz, ar.period_s)
    r_t, r_c = np.zeros(nbin, np_dt), np.int32(0)
    p_t = torch.zeros(nbin, dtype=tdt)
    p_c = torch.zeros((), dtype=torch.int32)
    for i in range(nsub):
        reset_launch_counts()
        rw, rs, r_t, r_up = (np.asarray(v) for v in ref_step(
            cube[i][None].astype(np_dt), weights[i][None].astype(np_dt),
            freqs.astype(np_dt), *(np_dt(v) for v in scalars), r_t, r_c))
        r_c = np.int32(r_c + int(r_up))
        pw, ps, p_t, p_up = step(
            torch.from_numpy(cube[i][None].astype(np_dt)),
            torch.from_numpy(weights[i][None].astype(np_dt)),
            torch.from_numpy(freqs.astype(np_dt)),
            *(torch.tensor(v, dtype=tdt) for v in scalars), p_t, p_c)
        p_c = p_c + p_up.to(torch.int32)
        np.testing.assert_array_equal(pw.numpy(), rw)
        _scores_close(ps.numpy(), rs)
        _template_close(p_t.numpy(), r_t)
        assert bool(p_up) == bool(r_up) == (i != 4)
        # the port's counters: its CPU route counts no launch
        assert not any(launch_counts().values())
    assert int(p_c) == int(r_c) == nsub - 1


def test_step_key_names_what_the_step_depends_on():
    from iterative_cleaner_torch import CleanConfig

    base = CleanConfig(device="cpu")
    key = step_build_key(base, 16, 32, False, 0.2)
    assert key == step_build_key(base, 16, 32, False, 0.2)
    for other in (step_build_key(base, 17, 32, False, 0.2),
                  step_build_key(base, 16, 32, True, 0.2),
                  step_build_key(base, 16, 32, False, 0.3),
                  step_build_key(CleanConfig(device="cpu", chanthresh=4.0),
                                 16, 32, False, 0.2),
                  step_build_key(CleanConfig(device="cpu", dtype="float64"),
                                 16, 32, False, 0.2),
                  step_build_key(CleanConfig(device="cpu",
                                             pulse_region=(0.2, 3, 9)),
                                 16, 32, False, 0.2)):
        assert other != key
    # the reconcile-only knobs are not in it
    assert step_build_key(CleanConfig(device="cpu", max_iter=2,
                                      stats_frame="dedispersed"),
                          16, 32, False, 0.2) == key
    assert STEP_KERNELS == ("cell_diagnostics_dedisp", "scaled_sides_axis0",
                            "scaled_sides_axis1", "combine_zap")


# ----------------------------------------------------------- the session

def test_session_close_is_the_batch_clean():
    ar, cube = _stream(nsub=10, seed=33, n_prezapped=4)
    rc = _ref_cfg()
    pc = config_from_reference(rc, device="cpu")
    s = OnlineSession(_meta(ar), pc, reconcile_every=0)
    for i in range(cube.shape[0]):
        assert s.ingest(cube[i], ar.weights[i]) == i + 1
    # the ring grows in steps of DEFAULT_NSUB_STEP; no reconcile sees it
    assert (s.capacity, s.n_subints) == (16, 10)
    np.testing.assert_array_equal(s.raw_weights(), ar.weights)
    res = s.close()
    whole = clean_archive(archive_from_reference(ar), pc)
    np.testing.assert_array_equal(res.archive.weights, whole.final_weights)
    assert np.array_equal(res.result.scores, whole.scores, equal_nan=True)
    # the JAX default route gives the same final mask
    np.testing.assert_array_equal(
        res.archive.weights == 0,
        np.asarray(ref_clean_archive(ar, rc).final_weights) == 0)
    # no kernel library is built on the CPU
    assert (res.warmup_compiles, res.recompiles_steady) == (0, 0)
    assert res.n_subints == 10 and len(res.latencies_s) == 10
    assert res.p99_ms() > 0 and res.reconciles == 0
    with pytest.raises(RuntimeError, match="closed"):
        s.ingest(cube[0])
    with pytest.raises(RuntimeError, match="closed"):
        s.close()


def test_session_reconciles_match_the_references():
    """Mid-stream reconciles against the JAX session's: the drift
    counts, the provisional weights after every subint and the final
    mask and drift equal; each reconcile's mask is the batch clean's of
    the prefix.  The JAX session reconciles its ring's capacity cube and
    the port the live rows only; its ring grows here in steps of the
    reconcile period, so each of its reconciles sees no spare row (with
    spare rows its reconcile is not the prefix's clean: the rFFT
    diagnostic's medians are unmasked, and the spare rows' zeros enter
    them)."""
    ar, cube = _stream(nsub=9, seed=5, n_prezapped=2)
    cube = cube.copy()
    cube[1, 2] += 40.0
    cube[5, 6] += 25.0
    rc = _ref_cfg(**KERNEL_ROUTE, stream_reconcile_every=3)
    pc = config_from_reference(rc, device="cpu")
    rs = RefSession(RefMeta.from_archive(ar),
                    RefConfig(**{**vars(rc), "fleet_bucket_pad": (3, 0)}))
    ps = OnlineSession(_meta(ar), pc)
    assert ps.reconcile_every == 3
    for i in range(cube.shape[0]):
        rs.ingest(cube[i], ar.weights[i])
        ps.ingest(cube[i], ar.weights[i])
        np.testing.assert_array_equal(ps.provisional_weights,
                                      rs.provisional_weights)
        assert ps.mask_drift == rs.mask_drift
        if (i + 1) % 3 == 0:
            prefix = clean_archive(ps.assembled(), pc)
            np.testing.assert_array_equal(ps.provisional_weights,
                                          prefix.final_weights)
            assert np.array_equal(ps.provisional_scores, prefix.scores,
                                  equal_nan=True)
    assert ps.reconciles == rs.reconciles == 3
    assert ps.mask_drift > 0
    _template_close(ps.template(), np.asarray(rs._template))
    pres, rres = ps.close(), rs.close()
    np.testing.assert_array_equal(pres.archive.weights,
                                  np.asarray(rres.archive.weights))
    assert (pres.final_drift, pres.mask_drift) == (rres.final_drift,
                                                   rres.mask_drift)


def test_session_manual_reconcile_and_the_bad_parts_sweep():
    ar, cube = _stream(nsub=6, seed=11)
    pc = config_from_reference(_ref_cfg(bad_chan=0.3, bad_subint=0.3),
                               device="cpu")
    s = OnlineSession(_meta(ar), pc, reconcile_every=0)
    for i in range(5):
        s.ingest(cube[i])
    assert s.reconcile() >= 0 and s.reconciles == 1
    prefix = clean_archive(s.assembled(), pc)
    np.testing.assert_array_equal(s.provisional_weights,
                                  prefix.final_weights)


def test_session_refusals_and_knobs(monkeypatch):
    ar, cube = _stream(nsub=2)
    from iterative_cleaner_torch import CleanConfig

    cfg = CleanConfig(device="cpu")
    s = OnlineSession(_meta(ar), cfg)
    with pytest.raises(ValueError, match="empty stream"):
        s.close()
    with pytest.raises(ValueError, match="geometry"):
        s.ingest(cube[0][:, :4])
    with pytest.raises(ValueError, match="weights"):
        s.ingest(cube[0], np.ones(3))
    with pytest.raises(ValueError, match="reconcile_every"):
        OnlineSession(_meta(ar), cfg, reconcile_every=-1)
    for bad in (dict(stream_reconcile_every=-1), dict(stream_ew_alpha=0.0),
                dict(stream_ew_alpha=1.5), dict(quality_window=1),
                dict(quality_drift=0.0)):
        with pytest.raises(ValueError):
            CleanConfig(device="cpu", **bad)
        with pytest.raises(ValueError):
            RefConfig(**bad)
    from iterative_cleaner_tpu.online import session as ref_session

    monkeypatch.delenv("ICLEAN_STREAM_RECONCILE_EVERY", raising=False)
    monkeypatch.delenv("ICLEAN_STREAM_EW_ALPHA", raising=False)
    assert (resolve_reconcile_every(None), resolve_ew_alpha(None)) == (
        DEFAULT_RECONCILE_EVERY, DEFAULT_EW_ALPHA) == (
        ref_session.resolve_reconcile_every(None),
        ref_session.resolve_ew_alpha(None))
    monkeypatch.setenv("ICLEAN_STREAM_RECONCILE_EVERY", "5")
    monkeypatch.setenv("ICLEAN_STREAM_EW_ALPHA", "0.5")
    assert (resolve_reconcile_every(None), resolve_ew_alpha(None)) == (5,
                                                                       0.5)
    assert (resolve_reconcile_every(2), resolve_ew_alpha(0.1)) == (2, 0.1)
    # the ring's growth step follows fleet_bucket_pad's nsub step
    s = OnlineSession(_meta(ar), CleanConfig(device="cpu",
                                             fleet_bucket_pad=(4, 0)))
    s.ingest(cube)
    assert s.capacity == 4


def test_session_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from iterative_cleaner_torch import CleanConfig

    ar, cube = _stream(nsub=2)
    s = OnlineSession(_meta(ar), CleanConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        s.ingest(cube[0])


def test_online_ewt_matches_the_reference_model():
    ar, _ = _stream(nsub=8, seed=9, n_prezapped=3)
    rc = _ref_cfg(**KERNEL_ROUTE, bad_chan=0.5)
    got = get_model(ONLINE_EWT)(archive_from_reference(ar),
                                config_from_reference(rc, device="cpu"))
    want = ref_get_model("online_ewt")(ar, rc)
    np.testing.assert_array_equal(got.final_weights,
                                  np.asarray(want.final_weights))
    _scores_close(got.scores, np.asarray(want.scores))
    assert (got.loops, got.converged) == (want.loops, want.converged)
    np.testing.assert_array_equal(got.loop_diffs, want.loop_diffs)
    np.testing.assert_array_equal(got.loop_rfi_frac, want.loop_rfi_frac)


def test_quality_monitor_matches_the_references():
    """One mask stream and template series through both monitors: the
    same alerts, summaries and registry series."""
    rng = np.random.default_rng(2)
    reg, ref_reg = MetricsRegistry(), RefRegistry()
    mon = QualityMonitor(stream="s", window=4, drift=0.1, registry=reg)
    ref = RefMonitor(stream="s", window=4, drift=0.1, registry=ref_reg)
    for i in range(14):
        row = (rng.random(32) > (0.6 if 6 <= i < 9 else 0.05)).astype(float)
        t = rng.normal(size=16)
        assert mon.observe_subint(row, t) == ref.observe_subint(row, t)
    mon.observe_reconcile(7)
    ref.observe_reconcile(7)
    final = (rng.random((14, 32)) > 0.1).astype(float)
    assert mon.observe_close(final) == ref.observe_close(final)
    got, want = mon.summary(), ref.summary()
    got.pop("last_alert_ts"), want.pop("last_alert_ts")
    assert got == want and mon.alerts >= 1
    snap, ref_snap = reg.snapshot(), ref_reg.snapshot()
    for kind in ("counters", "gauges"):
        assert snap[kind] == ref_snap[kind]
    assert sorted(snap["histograms"]) == sorted(ref_snap["histograms"])
    with pytest.raises(ValueError, match="window"):
        QualityMonitor(window=1)
    with pytest.raises(ValueError, match="drift"):
        QualityMonitor(drift=0.0)


def test_session_quality_monitor_never_changes_a_mask():
    ar, cube = _stream(nsub=6, seed=4)
    from iterative_cleaner_torch import CleanConfig

    cfg = CleanConfig(device="cpu", quality_window=2, quality_drift=0.2)
    on = OnlineSession(_meta(ar), cfg, reconcile_every=3,
                       registry=MetricsRegistry(), stream_id="q")
    off = OnlineSession(_meta(ar), cfg, reconcile_every=3)
    for i in range(cube.shape[0]):
        w = np.ones(16)
        if i >= 4:
            w[:12] = 0.0
        on.ingest(cube[i], w)
        off.ingest(cube[i], w)
    np.testing.assert_array_equal(on.provisional_weights,
                                  off.provisional_weights)
    r_on, r_off = on.close(), off.close()
    np.testing.assert_array_equal(r_on.archive.weights, r_off.archive.weights)
    assert on.quality.alerts >= 1 and off.quality is None
    assert on.quality.mask_churn == r_on.mask_drift + r_on.final_drift
    counters = on.registry.snapshot()["counters"]
    assert counters["online_subints"] == 6 and counters["online_reconciles"]


# --------------------------------------------------------------- the CLI

def _chunk_dir(d, ar, cube, close=True):
    os.makedirs(d, exist_ok=True)
    save_stream_meta(str(d), _meta(ar))
    for i in range(cube.shape[0]):
        np.save(os.path.join(d, "s%03d.npy" % i), cube[i])
    if close:
        open(os.path.join(d, CLOSE_SENTINEL), "w").close()


def test_cli_stream_directory_end_to_end(tmp_path, monkeypatch, capsys):
    ar, cube = _stream(nsub=6, seed=17)
    d = str(tmp_path / "live")
    _chunk_dir(d, ar, cube)
    monkeypatch.chdir(tmp_path)
    assert cli.main(["--device", "cpu", "--stream", d, "--max_iter", "2",
                     "--stream-reconcile-every", "2", "-l",
                     "--metrics-json", "r.json"]) == 0
    out = capsys.readouterr().out
    assert "stream: closed (sentinel) after 6 subints" in out
    assert "3 reconciles" in out
    cleaned = load_archive(os.path.join(d, "stream_cleaned.npz"))
    rc = _ref_cfg(max_iter=2)
    want = clean_archive(archive_from_reference(ar),
                         config_from_reference(rc, device="cpu"))
    np.testing.assert_array_equal(cleaned.weights, want.final_weights)
    np.testing.assert_array_equal(
        cleaned.weights == 0,
        np.asarray(ref_clean_archive(ar, rc).final_weights) == 0)
    np.testing.assert_array_equal(cleaned.data[:, 0], cube)
    counters = json.load(open("r.json"))["counters"]
    assert counters["online_subints"] == 6
    assert counters["online_reconciles"] == 3
    # -o names the output; an idle directory closes after
    # ICLEAN_STREAM_IDLE_S seconds; an empty one fails
    d2 = str(tmp_path / "idle")
    _chunk_dir(d2, ar, cube[:2], close=False)
    monkeypatch.setenv("ICLEAN_STREAM_IDLE_S", "0.2")
    assert cli.main(["--device", "cpu", "-q", "--stream", d2, "-o",
                     "two.npz"]) == 0
    assert load_archive("two.npz").weights.shape == (2, 16)
    (tmp_path / "empty").mkdir()
    assert cli.main(["--device", "cpu", "-q", "--stream",
                     str(tmp_path / "empty")]) == 1
    assert cli.main(["--device", "cpu", "-q", "--stream",
                     str(tmp_path / "missing")]) == 2


def test_cli_model_online_ewt_writes_the_provisional_mask(tmp_path,
                                                          monkeypatch):
    from iterative_cleaner_torch.io import save_archive

    ar, _ = _stream(nsub=6, seed=21, n_prezapped=3)
    path = str(tmp_path / "obs.npz")
    save_archive(archive_from_reference(ar), path)
    monkeypatch.chdir(tmp_path)
    assert cli.main(["-q", "--device", "cpu", "--model", "online_ewt",
                     "--stream-ew-alpha", "0.5", path]) == 0
    rc = _ref_cfg(stream_ew_alpha=0.5)
    want = get_model(ONLINE_EWT)(archive_from_reference(ar),
                                 config_from_reference(rc, device="cpu"))
    np.testing.assert_array_equal(load_archive(path + "_cleaned.npz").weights,
                                  want.final_weights)


ONLINE_REFUSALS = [
    # --stream DIR: no archives, one mode, the flagship on the engine
    ["--stream", "{d}", "x.npz"],
    ["--stream", "{d}", "--fleet"],
    ["--stream", "{d}", "--batch", "2"],
    ["--stream", "{d}", "--prefetch", "2"],
    ["--stream", "{d}", "--mesh", "cell"],
    ["--stream", "{d}", "-u"],
    ["--stream", "{d}", "--checkpoint", "ck"],
    ["--stream", "{d}", "--record_history"],
    ["--stream", "{d}", "--model", "quicklook"],
    ["--stream", "{d}", "--backend", "numpy"],
    # the online knobs without the online mode
    ["--stream-reconcile-every", "4", "x.npz"],
    ["--stream-ew-alpha", "0.5", "x.npz"],
    # --mux DIR...
    ["x.npz", "--mux", "{d}"],
    ["--mux", "{d}", "--stream", "{d}"],
    ["--mux", "{d}", "--batch", "2"],
    ["--mux", "{d}", "--stream", "4"],
    ["--mux", "{d}", "-o", "out.npz"],
    ["--mux", "{d}", "--model", "quicklook"],
    ["--mux", "{d}", "--backend", "numpy"],
    ["--mux", "{d}", "--mux-max-wait-ms", "-1"],
    ["--mux", "{d}", "--mux-max-batch", "0"],
    # bare --mux without --serve; the mux knobs without --mux
    ["--mux"],
    ["--mux", "--", "x.npz"],
    ["--mux-max-batch", "4", "x.npz"],
    ["--mux-max-wait-ms", "2", "x.npz"],
    # no input at all
    [],
]


@pytest.mark.parametrize("argv", ONLINE_REFUSALS, ids=" ".join)
def test_cli_online_refusals_are_the_reference_parsers(argv, tmp_path,
                                                       monkeypatch):
    monkeypatch.delenv("ICLEAN_MUX", raising=False)
    monkeypatch.chdir(tmp_path)
    (tmp_path / "d").mkdir()
    argv = [a.replace("{d}", str(tmp_path / "d")) for a in argv]
    for main in (cli.main, ref_cli.main):
        with pytest.raises(SystemExit) as ei:
            main(argv)
        assert ei.value.code == 2, main


def test_cli_bare_mux_under_serve_names_item_8(tmp_path, monkeypatch):
    """Bare ``--mux`` belongs to ``--serve`` (item 8b, ported): without
    an intake both parsers refuse it (exit 2); with one, the daemon's
    ServeConfig multiplexes its streams."""
    import iterative_cleaner_torch.serve as serve

    for name in ("ICLEAN_MUX", "ICLEAN_SPOOL", "ICLEAN_HTTP_PORT"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.chdir(tmp_path)
    for main in (cli.main, ref_cli.main):
        with pytest.raises(SystemExit) as ei:
            main(["--serve", "--mux"])
        assert ei.value.code == 2, main
    got = {}
    monkeypatch.setattr(serve, "run_serve",
                        lambda sc, cfg, **kw: got.setdefault("sc", sc) and 0)
    assert cli.main(["--device", "cpu", "--serve", "--mux", "--spool",
                     "sp", "--flight-recorder", ""]) == 0
    assert got["sc"].mux and got["sc"].spool_dir == "sp"
