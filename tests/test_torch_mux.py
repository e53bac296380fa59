"""The port's stream multiplexer (``iterative_cleaner_torch/online/mux.py``)
on the CPU: the ring and its deadline, the one-head-per-stream rule, a
closing stream's drain, the lanes bit-equal to solo sessions, and the
per-stream quality series, as the JAX package's ``tests/test_mux.py``
holds its own; the solo sessions' provisional masks against the JAX
package's; ``--mux D1 D2`` through ``cli.main``.

The deadline tests inject a fake clock: the mux stamps each arrival with
its own (injectable) clock, so the deadline is deterministic here.

Where the reference pads a partial batch up a power-of-two rung with
inert lanes and pads channels up the ``--bucket-pad`` grid, the port
dispatches exactly its lanes, each stream in the bucket of its own
geometry: the lanes are bit-equal to solo sessions for every
``max_batch`` (1, 2, 3 and 8 here), and streams of two channel counts
run in two buckets.
"""

import sys
import threading

import numpy as np
import pytest

from iterative_cleaner_tpu.config import CleanConfig as RefConfig
from iterative_cleaner_tpu.io.synthetic import (
    make_synthetic_archive as ref_make_synthetic_archive,
)
from iterative_cleaner_tpu.online import OnlineSession as RefSession
from iterative_cleaner_tpu.online import StreamMeta as RefMeta
from iterative_cleaner_torch import CleanConfig, cli
from iterative_cleaner_torch.convert import (
    archive_from_reference,
    config_from_reference,
)
from iterative_cleaner_torch.io import load_archive
from iterative_cleaner_torch.online import (
    CLOSE_SENTINEL,
    DEFAULT_MUX_MAX_BATCH,
    DEFAULT_MUX_MAX_WAIT_MS,
    MuxRingFull,
    OnlineSession,
    StreamMeta,
    StreamMux,
    resolve_mux_max_batch,
    resolve_mux_max_wait_ms,
    save_stream_meta,
)
from iterative_cleaner_torch.online.mux import DEFAULT_MUX_RING_FACTOR
from iterative_cleaner_torch.telemetry import MetricsRegistry
from iterative_cleaner_torch.telemetry.registry import labeled


class FakeClock:
    def __init__(self, t: float = 0.0) -> None:
        self.t = float(t)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += float(dt)


def _cfg(**kw):
    kw.setdefault("max_iter", 2)
    kw.setdefault("stream_reconcile_every", 0)
    return CleanConfig(device="cpu", **kw)


def _ref_stream(nsub=4, nchan=8, nbin=16, seed=7):
    ar, _ = ref_make_synthetic_archive(nsub=nsub, nchan=nchan, nbin=nbin,
                                       seed=seed, n_prezapped=2)
    return ar, np.asarray(ar.total_intensity(), np.float64)


def _stream(nsub=4, nchan=8, nbin=16, seed=7):
    ar, cube = _ref_stream(nsub, nchan, nbin, seed)
    return StreamMeta.from_archive(archive_from_reference(ar)), cube


# ------------------------------------------------------------- the knobs

def test_knobs_resolve_as_the_reference(monkeypatch):
    from iterative_cleaner_tpu.online import mux as ref_mux

    monkeypatch.delenv("ICLEAN_MUX_MAX_WAIT_MS", raising=False)
    monkeypatch.delenv("ICLEAN_MUX_MAX_BATCH", raising=False)
    assert (resolve_mux_max_wait_ms(None), resolve_mux_max_batch(None)) \
        == (DEFAULT_MUX_MAX_WAIT_MS, DEFAULT_MUX_MAX_BATCH) == (5.0, 64) \
        == (ref_mux.resolve_mux_max_wait_ms(None),
            ref_mux.resolve_mux_max_batch(None))
    monkeypatch.setenv("ICLEAN_MUX_MAX_WAIT_MS", "2.5")
    monkeypatch.setenv("ICLEAN_MUX_MAX_BATCH", "3")
    assert (resolve_mux_max_wait_ms(None), resolve_mux_max_batch(None)) \
        == (2.5, 3)
    assert (resolve_mux_max_wait_ms(0.0), resolve_mux_max_batch(9)) \
        == (0.0, 9)
    assert StreamMux().ring_capacity == DEFAULT_MUX_RING_FACTOR * 3
    for bad in (dict(max_batch=0), dict(max_wait_ms=-1.0),
                dict(ring_capacity=-1)):
        with pytest.raises(ValueError):
            StreamMux(**bad)


# ------------------------------------------------------ the ring, the SLO

def test_partial_batch_dispatches_at_the_deadline():
    clock = FakeClock()
    mux = StreamMux(max_batch=4, max_wait_ms=50.0, clock=clock)
    meta, cube = _stream()
    mux.open("a", meta, _cfg())
    mux.ingest("a", cube[0])
    # a lone head is not due before the deadline...
    assert mux.pump() == 0
    clock.advance(0.049)
    assert mux.pump() == 0
    assert mux.session("a").n_subints == 0
    # ...and leaves partly full the moment it passes
    clock.advance(0.002)
    assert mux.pump() == 1
    assert mux.session("a").n_subints == 1
    assert mux.partial_dispatches == 1 and mux.batch_occupancies == [0.25]
    assert (mux.warmup_compiles, mux.recompiles_steady) == (0, 0)


def test_full_bucket_dispatches_without_waiting():
    clock = FakeClock()
    mux = StreamMux(max_batch=2, max_wait_ms=60_000.0, clock=clock)
    meta, cube = _stream()
    cfg = _cfg()
    mux.open("a", meta, cfg)
    mux.open("b", meta, cfg)
    mux.ingest("a", cube[0])
    assert mux.pump() == 0          # half a batch, an hour of headroom
    mux.ingest("b", cube[1])
    assert mux.pump() == 1          # a full bucket does not wait
    assert mux.partial_dispatches == 0
    assert mux.batch_occupancies == [1.0] and mux.occupancy_mean() == 1.0


def test_ring_backpressure_nonblocking_and_blocking():
    mux = StreamMux(max_batch=1, max_wait_ms=60_000.0, ring_capacity=2)
    meta, cube = _stream()
    mux.open("a", meta, _cfg())
    mux.ingest("a", cube[0])
    mux.ingest("a", cube[1])
    with pytest.raises(MuxRingFull, match="capacity"):
        mux.ingest("a", cube[2])
    # a blocking ingest times out: nothing drains the ring
    with pytest.raises(MuxRingFull, match="backpressure"):
        mux.ingest("a", cube[2], block=True, timeout_s=0.15)
    assert mux.pending() == 2
    # a blocking ingest waits for the dispatcher to make room
    mux.start()
    try:
        assert mux.ingest("a", cube[2], block=True, timeout_s=30.0) >= 0
        mux.drain("a", timeout_s=30.0)
    finally:
        mux.stop()
    assert mux.session("a").n_subints == 3
    # abandoning a stream frees its ring slots
    mux.ingest("a", cube[3])
    mux.abandon_stream("a")
    assert mux.pending() == 0 and mux.streams() == []


def test_one_head_per_stream_oldest_first():
    clock = FakeClock()
    mux = StreamMux(max_batch=8, max_wait_ms=5.0, clock=clock)
    meta, cube = _stream(nsub=6)
    cfg = _cfg()
    mux.open("chatty", meta, cfg)
    mux.open("slow", meta, cfg)
    # the chatty stream backlogs five subints before slow's one arrives
    for i in range(5):
        mux.ingest("chatty", cube[i])
        clock.advance(0.001)
    mux.ingest("slow", cube[5])
    # one dispatch takes only stream heads, oldest first
    with mux._dispatch_lock:
        picked = mux._select_batch(clock(), True)
        assert picked is not None
        binfo, lanes = picked
        assert [s.key for s, _ in lanes] == ["chatty", "slow"]
        mux._dispatch(binfo, lanes)
    assert mux.session("slow").n_subints == 1
    assert mux.session("chatty").n_subints == 1
    assert mux.pending("chatty") == 4
    # the backlog then drains one lane a dispatch
    assert mux.pump(force=True) == 4
    assert mux.subints == 6 and mux.dispatches == 5


def test_closing_stream_drains_without_stalling_its_bucket():
    clock = FakeClock()
    mux = StreamMux(max_batch=8, max_wait_ms=60_000.0, clock=clock)
    meta, cube = _stream()
    cfg = _cfg()
    mux.open("a", meta, cfg)
    mux.open("b", meta, cfg)
    mux.ingest("a", cube[0])
    mux.ingest("a", cube[1])
    mux.ingest("b", cube[2])
    assert mux.pump() == 0          # nothing due: partial and fresh
    # closing "a" makes its pending due at once; "b"'s head rides the
    # same bucket's batches
    res = mux.close_stream("a")
    assert res.n_subints == 2 and res.recompiles_steady == 0
    assert "a" not in mux.streams()
    assert mux.session("b").n_subints == 1
    mux.ingest("b", cube[3])
    mux.pump(force=True)
    assert mux.close_stream("b").n_subints == 2
    with pytest.raises(ValueError, match="already multiplexed"):
        mux.open("c", meta, cfg)
        mux.open("c", meta, cfg)


# ------------------------------------------------- bit-equal to solo runs

_NSUB = 4


@pytest.fixture(scope="module")
def solo_baseline():
    """Three streams through solo sessions, closed once:
    ``(cfg, streams, [(pweights, pscores, template, final_weights)])``;
    the first stream's provisional weights also against the JAX
    package's solo session."""
    cfg = _cfg()
    ars = [_ref_stream(nsub=_NSUB, nchan=6, nbin=16, seed=100 + s)
           for s in range(3)]
    streams = [(StreamMeta.from_archive(archive_from_reference(ar)), cube,
                np.asarray(ar.weights)) for ar, cube in ars]
    refs = []
    for meta, cube, w in streams:
        sess = OnlineSession(meta, cfg)
        for i in range(_NSUB):
            sess.ingest(cube[i], w[i])
        refs.append((sess.provisional_weights, sess.provisional_scores,
                     sess.template(), sess.close().archive.weights))
    ar0, cube0 = ars[0]
    rc = RefConfig(max_iter=2, stream_reconcile_every=0, stats_impl="fused",
                   fft_mode="dft", median_impl="pallas", fused_sweep="on")
    assert config_from_reference(rc, device="cpu").max_iter == cfg.max_iter
    ref = RefSession(RefMeta.from_archive(ar0), rc)
    for i in range(_NSUB):
        ref.ingest(cube0[i], ar0.weights[i])
    np.testing.assert_array_equal(refs[0][0], ref.provisional_weights)
    assert np.array_equal(refs[0][1], ref.provisional_scores,
                          equal_nan=True)
    return cfg, streams, refs


@pytest.mark.parametrize("max_batch", [1, 2, 3, 8])
def test_mux_lanes_bit_equal_to_solo_sessions(max_batch, solo_baseline):
    """max_batch 2 splits the three streams over two dispatches a round;
    8 dispatches three lanes, with nothing padded."""
    cfg, streams, refs = solo_baseline
    mux = StreamMux(max_batch=max_batch, max_wait_ms=0.0)
    for k, (meta, _, _) in enumerate(streams):
        mux.open(f"s{k}", meta, cfg)
    for i in range(_NSUB):
        for k, (_, cube, w) in enumerate(streams):
            mux.ingest(f"s{k}", cube[i], w[i])
        mux.pump(force=True)
    assert mux.dispatches == _NSUB * -(-3 // max_batch)
    assert mux.subints == 3 * _NSUB
    assert mux.recompiles_steady == 0
    for k, (pw, ps, tmpl, final_w) in enumerate(refs):
        ms = mux.session(f"s{k}")
        np.testing.assert_array_equal(ms.provisional_weights, pw)
        # NaN placement is part of the contract
        assert np.array_equal(ms.provisional_scores, ps, equal_nan=True)
        np.testing.assert_array_equal(ms.template(), tmpl)
        res = mux.close_stream(f"s{k}")
        np.testing.assert_array_equal(res.archive.weights, final_w)


def test_two_geometries_run_in_two_buckets(solo_baseline):
    """A stream of another channel count is a bucket of its own (the
    port pads no channel), each lane still bit-equal to its solo run."""
    cfg, streams, refs = solo_baseline
    meta8, cube8 = _stream(nsub=_NSUB, nchan=8, nbin=16, seed=5)
    solo8 = OnlineSession(meta8, cfg)
    for i in range(_NSUB):
        solo8.ingest(cube8[i])
    mux = StreamMux(max_batch=8, max_wait_ms=0.0)
    mux.open("six", streams[0][0], cfg)
    mux.open("eight", meta8, cfg)
    for i in range(_NSUB):
        mux.ingest("six", streams[0][1][i], streams[0][2][i])
        mux.ingest("eight", cube8[i])
        mux.pump(force=True)
    assert len(mux._buckets) == 2 and mux.dispatches == 2 * _NSUB
    np.testing.assert_array_equal(mux.session("six").provisional_weights,
                                  refs[0][0])
    np.testing.assert_array_equal(mux.session("eight").provisional_weights,
                                  solo8.provisional_weights)
    assert np.array_equal(mux.session("eight").provisional_scores,
                          solo8.provisional_scores, equal_nan=True)


def test_dispatcher_thread_serves_concurrent_ingest(solo_baseline):
    """Three producer threads ingest while the dispatcher thread runs:
    every subint lands once, in its stream's order, bit-equal to the solo
    run."""
    cfg, streams, refs = solo_baseline
    mux = StreamMux(max_batch=2, max_wait_ms=1.0, ring_capacity=3)
    for k, (meta, _, _) in enumerate(streams):
        mux.open(f"s{k}", meta, cfg)
    mux.start()
    errors = []

    def produce(k):
        try:
            _, cube, w = streams[k]
            for i in range(_NSUB):
                mux.ingest(f"s{k}", cube[i], w[i], block=True,
                           timeout_s=60.0)
        except Exception as exc:  # reported below
            errors.append(exc)

    threads = [threading.Thread(target=produce, args=(k,))
               for k in range(3)]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)     # interleave the threads finely
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60.0)
            assert not t.is_alive()
        mux.drain(timeout_s=60.0)
    finally:
        sys.setswitchinterval(switch)
        mux.stop()
    assert not errors and mux.subints == 3 * _NSUB
    assert mux.pending() == 0
    for k, (pw, ps, _, _) in enumerate(refs):
        np.testing.assert_array_equal(
            mux.session(f"s{k}").provisional_weights, pw)


def test_quality_drift_alerts_stay_per_stream():
    reg = MetricsRegistry()
    cfg = _cfg(quality_window=2, quality_drift=0.25)
    meta, cube = _stream(nsub=4)
    mux = StreamMux(max_batch=4, max_wait_ms=0.0, registry=reg)
    mux.open("quiet", meta, cfg)
    mux.open("noisy", meta, cfg)
    for i in range(2):
        mux.ingest("quiet", cube[i])
        mux.ingest("noisy", cube[i])
        mux.pump(force=True)
    dead = np.ones(meta.nchan)
    dead[: (3 * meta.nchan) // 4] = 0.0
    mux.ingest("quiet", cube[2])
    mux.ingest("noisy", cube[2], dead)
    mux.pump(force=True)
    counters = reg.snapshot()["counters"]
    assert counters.get(labeled("quality_drift_alerts", stream="noisy")) == 1
    assert labeled("quality_drift_alerts", stream="quiet") not in counters
    assert mux.session("quiet").quality.alerts == 0
    assert counters["mux_dispatches"] == 3 and counters["mux_subints"] == 6


# --------------------------------------------------------------- the CLI

def test_cli_mux_end_to_end(tmp_path, monkeypatch, capsys):
    """``--mux D1 D2`` writes each stream's ``stream_cleaned.npz``, equal
    to a ``--stream DIR`` run of the same chunks and to the batch clean."""
    from iterative_cleaner_torch.backends import clean_archive

    monkeypatch.chdir(tmp_path)
    dirs, ars = [], []
    for k in range(2):
        ar, cube = _ref_stream(nsub=5, nchan=8, nbin=16, seed=40 + k)
        d = tmp_path / f"d{k}"
        d.mkdir()
        save_stream_meta(str(d), StreamMeta.from_archive(
            archive_from_reference(ar)))
        for i in range(5):
            np.save(str(d / ("%06d.npy" % i)), cube[i])
        (d / CLOSE_SENTINEL).touch()
        dirs.append(str(d))
        ars.append(ar)
    assert cli.main(["--device", "cpu", "--mux", *dirs, "--max_iter", "2",
                     "--mux-max-batch", "2", "--mux-max-wait-ms", "1",
                     "--stream-reconcile-every", "2"]) == 0
    out = capsys.readouterr().out
    assert "mux: 2 streams, 10 subints in" in out
    mux_w = [load_archive(d + "/stream_cleaned.npz").weights for d in dirs]
    for d, ar, w in zip(dirs, ars, mux_w):
        # bare .npy chunks carry no weights: every cell arrives live
        unit = archive_from_reference(ar)
        unit.weights = np.ones_like(unit.weights)
        want = clean_archive(unit, _cfg(max_iter=2))
        np.testing.assert_array_equal(w, want.final_weights)
        assert cli.main(["--device", "cpu", "-q", "--stream", d,
                         "--max_iter", "2", "-l"]) == 0
        np.testing.assert_array_equal(
            load_archive(d + "/stream_cleaned.npz").weights, w)
    # a missing directory is refused before any stream opens
    assert cli.main(["--device", "cpu", "-q", "--mux",
                     str(tmp_path / "missing")]) == 2
