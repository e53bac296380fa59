"""The port's profiler (``telemetry/profiling.py``): the roofline against
the JAX package's on equal costs, the H100 peaks and the kernel model
``chip_smoke.py`` reads for its bounds (no TPU peak anywhere), program
costs captured by the bucket warm-up, the online step and the mux, and
``torch.profiler`` captures published whole (``--profile-dir``, the
daemon's ``POST /profile``).  On the CPU, where the peaks are nominal."""

import ast
import json
import math
import os
import threading

import pytest

from iterative_cleaner_tpu.telemetry import profiling as ref_profiling
from iterative_cleaner_torch import CleanConfig, cli
from iterative_cleaner_torch.io import make_synthetic_archive, save_archive
from iterative_cleaner_torch.telemetry import (
    MetricsRegistry,
    labeled,
    profiling,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = CleanConfig(device="cpu", max_iter=2)


@pytest.fixture(autouse=True)
def fresh_costs(monkeypatch):
    from iterative_cleaner_torch.parallel.batch import clear_warm_memo

    monkeypatch.delenv("ICLEAN_PROFILE_DIR", raising=False)
    profiling.clear_costs()
    # a bucket warmed by an earlier test in this process is not captured
    # again: forget the warm-ups so that each test captures its own
    clear_warm_memo()
    yield
    profiling.clear_costs()
    profiling.set_enabled(None)


@pytest.mark.parametrize("kind", ["cpu", "some other card"])
@pytest.mark.parametrize("flops,nbytes,seconds", [
    (1e9, 4e8, 0.01), (2.5e6, 1e9, 0.5), (0.0, 1.0, 1e-12)])
def test_roofline_equals_the_references_on_equal_costs(kind, flops, nbytes,
                                                       seconds):
    fields = dict(program="p", flops=flops, bytes_accessed=nbytes,
                  peak_bytes=0, alias_bytes=0, compile_s=0.0,
                  device_kind=kind)
    got = profiling.roofline(profiling.ProgramCost(**fields), seconds)
    want = ref_profiling.roofline(ref_profiling.ProgramCost(**fields),
                                  seconds)
    assert got == want
    assert got["nominal_peaks"] is True      # off the card


def test_h100_peaks_and_no_tpu_peak():
    """The port's table holds the H100 SXM data sheet's figures, keyed on
    the card's name, and none of the reference's TPU rows."""
    name = "NVIDIA H100 80GB HBM3"
    assert profiling.device_peaks(name) == (67e12, 3.35e12, False)
    assert profiling.device_peaks(name, "float64") == (34e12, 3.35e12,
                                                       False)
    for tpu in ("TPU v5 lite", "TPU v4", "TPU v5p", "TPU v6 lite"):
        assert profiling.device_peaks(tpu)[2] is True
    assert set(profiling.DEVICE_PEAKS) == {"h100"}
    assert profiling.device_peaks()[2] is True   # this host has no card
    assert profiling.device_kind() == "cpu"


def test_chip_smoke_reads_the_model_from_here():
    """``chip_smoke.py`` keeps no peak or bound model of its own: it
    assigns no PEAK_* constant and defines no kernel_bounds."""
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    assigned = {t.id for node in ast.walk(tree)
                if isinstance(node, ast.Assign)
                for t in node.targets if isinstance(t, ast.Name)}
    assert not {n for n in assigned if n.startswith("PEAK_")}
    defined = {node.name for node in ast.walk(tree)
               if isinstance(node, ast.FunctionDef)}
    assert "kernel_bounds" not in defined


def test_kernel_model_at_the_golden_shape():
    """K1's and K3's bounds at 1024 x 4096 x 128, as the kernel table
    quotes them (float32; K1 bytes-bound at the cube read)."""
    S, C, B = 1024, 4096, 128
    kb = profiling.kernel_bounds(S, C, B)
    cells = S * C
    k1_bytes = 4 * cells * B + 4 * (cells + C * B + S * B)
    assert kb["weighted_marginals"] == (k1_bytes / 3.35e12 * 1e3, "bytes")
    assert math.isclose(kb["weighted_marginals"][0], 0.6468, rel_tol=1e-3)
    assert math.isclose(kb["scaled_sides_axis0"][0], 0.0413, rel_tol=1e-2)
    assert math.isclose(kb["combine_zap"][0], 0.0551, rel_tol=1e-2)
    # K10 on a 2 x 2 shard is K2's model at half of each axis
    half = profiling.kernel_bounds(S // 2, C // 2, B)
    assert half["cell_diagnostics_disp"][1] == "bytes"
    f64 = profiling.kernel_bounds(S, C, B, cube_bytes=8)
    assert math.isclose(f64["weighted_marginals"][0], 1.2937, rel_tol=1e-3)
    ops, nbytes = profiling.program_costs(
        ("weighted_marginals", "cell_diagnostics_disp_bf16"), S, C, B,
        cube_bytes=2, batch=3)
    costs = profiling.kernel_costs(S, C, B, cube_bytes=2)
    assert nbytes == 3 * (costs["weighted_marginals"][0]
                          + costs["cell_diagnostics_disp"][0])
    assert ops == 3 * (costs["weighted_marginals"][1]
                       + costs["cell_diagnostics_disp"][1])


def test_capture_and_walltime_publish_the_references_gauges():
    reg = MetricsRegistry()
    assert profiling.capture_compiled("p", None, registry=reg) is None
    assert reg.counters[labeled("prof_capture_errors", program="p")] == 1
    cost = profiling.capture_compiled("p", (1e9, 2e8), registry=reg,
                                      compile_s=0.5)
    assert profiling.has_cost("p") and cost.device_kind == "cpu"
    assert profiling.record_walltime("q", 1.0, registry=reg) is None
    frac = profiling.record_walltime("p", 0.25, registry=reg)
    for key in ("prof_flops", "prof_bytes", "prof_peak_bytes",
                "prof_step_s", "prof_flops_util", "prof_hbm_gbps",
                "prof_hbm_util", "prof_roofline_frac", "prof_compile_s"):
        assert labeled(key, program="p") in reg.gauges, key
    assert reg.gauges["prof_peak_nominal"] == 1.0
    assert frac["hbm_gbps"] == pytest.approx(0.8)
    snap = profiling.costs_snapshot()["p"]
    ref_fields = set(ref_profiling.ProgramCost.__dataclass_fields__)
    assert ref_fields <= set(snap) and snap["dtype"] == "float32"


def test_trace_capture_publishes_whole_and_one_at_a_time(tmp_path):
    """A capture lands as one renamed directory holding the trace and
    the manifest; a second capture while one runs is refused; a profiler
    that cannot start raises and leaves nothing."""
    import torch

    reg = MetricsRegistry()
    profiling.capture_compiled("p", (1.0, 2.0))
    with profiling.trace_capture(str(tmp_path), registry=reg,
                                 label="t") as final:
        assert not os.path.exists(final)
        torch.ones(64).sum()
        with pytest.raises(profiling.CaptureBusy):
            with profiling.trace_capture(str(tmp_path)):
                pass
    assert sorted(os.listdir(final)) == ["profile_manifest.json",
                                         "trace.json"]
    with open(os.path.join(final, "profile_manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["label"] == "t" and manifest["device_kind"] == "cpu"
    assert "p" in manifest["programs"]
    with open(os.path.join(final, "trace.json")) as f:
        assert json.load(f)["traceEvents"]
    assert reg.counters["prof_trace_captures"] == 1
    assert os.listdir(tmp_path) == [os.path.basename(final)]

    class Broken:
        def __init__(self, **kw):
            pass

        def start(self):
            raise RuntimeError("profiler refused")

    import torch.profiler as tp

    real = tp.profile
    tp.profile = Broken
    try:
        with pytest.raises(RuntimeError, match="refused"):
            with profiling.trace_capture(str(tmp_path / "b")):
                pass
    finally:
        tp.profile = real
    assert os.listdir(tmp_path / "b") == []
    # the lock was released: the next capture runs
    assert os.path.isdir(profiling.capture_for(str(tmp_path / "c"), 0.01))


def _write(tmp_path, geometries, seed0=80):
    paths = []
    for i, (nsub, nchan, nbin) in enumerate(geometries):
        ar, _ = make_synthetic_archive(nsub=nsub, nchan=nchan, nbin=nbin,
                                       seed=seed0 + i)
        paths.append(str(tmp_path / ("p%02d.npz" % i)))
        save_archive(ar, paths[-1])
    return paths


def test_fleet_bucket_program_is_captured_and_timed(tmp_path):
    """The bucket warm-up captures its batch iteration (the route's
    kernels at the bucket's shapes and batch); a full group's clean
    seconds over its iterations pair with it."""
    from iterative_cleaner_torch.parallel.batch import bucket_program
    from iterative_cleaner_torch.parallel.fleet import clean_fleet

    paths = _write(tmp_path, [(6, 8, 16)] * 2 + [(5, 8, 16)])
    reg = MetricsRegistry()
    rep = clean_fleet(paths, CFG, registry=reg, group_size=2)
    assert rep.ok
    name = bucket_program(CFG, 6, 8, 16, False, 2)
    assert name == "fleet_bucket/default/6x8x16x2"
    ops, nbytes = profiling.program_costs(
        ("weighted_marginals", "cell_diagnostics_disp",
         "scaled_sides_axis0", "scaled_sides_axis1", "combine_zap",
         "masked_median"), 6, 8, 16, batch=2)
    cost = profiling.costs_snapshot()[name]
    assert (cost["flops"], cost["bytes_accessed"]) == (ops, nbytes)
    assert 0 < reg.gauges[labeled("prof_hbm_util", program=name)] <= 1
    assert 0 < reg.gauges[labeled("prof_roofline_frac", program=name)] <= 1
    prof = bucket_program(CleanConfig(baseline_mode="profile",
                                      dtype="float64"), 4, 8, 16, False, 3)
    assert prof == "fleet_bucket/two_read/4x8x16x3/f64"


def test_online_and_mux_programs(tmp_path):
    """``OnlineSession(profile=True)`` captures its step and times each
    warm subint; the mux captures each lane count's dispatch."""
    from iterative_cleaner_torch.online import (
        OnlineSession,
        StreamMeta,
        StreamMux,
    )

    ar, _ = make_synthetic_archive(nsub=4, nchan=8, nbin=16, seed=2)
    meta = StreamMeta.from_archive(ar)
    reg = MetricsRegistry()
    sess = OnlineSession(meta, CFG, registry=reg, profile=True)
    for tile in ar.total_intensity():
        sess.ingest(tile)
    assert labeled("prof_step_s", program="online_step/8x16") in reg.gauges
    quiet = OnlineSession(meta, CFG, registry=MetricsRegistry())
    quiet.ingest(ar.total_intensity()[0])
    assert quiet._program is None          # profiling off by default
    mux = StreamMux(max_batch=2, max_wait_ms=0, registry=reg)
    for key in ("a", "b"):
        mux.open(key, meta, CFG)
    for tile in ar.total_intensity()[:2]:
        for key in ("a", "b"):
            mux.ingest(key, tile)
        mux.pump(force=True)
    assert labeled("prof_flops", program="mux_step/8x16x2") in reg.gauges
    assert labeled("prof_step_s", program="mux_step/8x16x2") in reg.gauges


def test_cli_profile_dir_captures_the_session(tmp_path, monkeypatch):
    """``--profile-dir`` records the session into a published capture;
    with ``--trace`` the trace wins and no capture is made."""
    monkeypatch.chdir(tmp_path)
    ar, _ = make_synthetic_archive(nsub=4, nchan=8, nbin=16, seed=1)
    save_archive(ar, "a.npz")
    assert cli.main(["--device", "cpu", "-q", "--profile-dir", "prof",
                     "a.npz"]) == 0
    (cap,) = os.listdir("prof")
    assert cap.startswith("capture-")
    with open(os.path.join("prof", cap, "profile_manifest.json")) as f:
        assert json.load(f)["label"] == "run"
    monkeypatch.setenv("ICLEAN_PROFILE_DIR", str(tmp_path / "env"))
    assert cli.main(["--device", "cpu", "-q", "--trace", "tr",
                     "a.npz"]) == 0
    assert not os.path.exists(tmp_path / "env")
    assert os.path.exists(os.path.join("tr", "trace.rank0.json"))
    assert profiling.profiling_enabled() is True     # the env mirror
    monkeypatch.delenv("ICLEAN_PROFILE_DIR")
    assert profiling.profiling_enabled() is False


def test_daemon_profile_endpoint(tmp_path):
    """``POST /profile?seconds=N``: a published capture under the
    daemon's profile dir; a bad N is a 400; a second capture while one
    runs is a 409."""
    import urllib.error
    import urllib.request

    from iterative_cleaner_torch.config import ServeConfig
    from iterative_cleaner_torch.serve import ServeDaemon
    from iterative_cleaner_torch.serve.http import make_server

    d = ServeDaemon(ServeConfig(
        http_port=0, journal_path=str(tmp_path / "j.jsonl"),
        flight_recorder="", profile_dir=str(tmp_path / "prof")), CFG,
        quiet=True)
    server = make_server(d, 0)
    threading.Thread(target=server.serve_forever,
                     kwargs={"poll_interval": 0.05}, daemon=True).start()
    url = "http://127.0.0.1:%d/profile" % server.server_address[1]

    def post(query):
        req = urllib.request.Request(url + query, data=b"{}")
        try:
            r = urllib.request.urlopen(req, timeout=60)
            return r.status, json.loads(r.read())
        except urllib.error.HTTPError as exc:
            return exc.code, json.loads(exc.read())

    try:
        assert profiling.profiling_enabled()       # the daemon's dir
        import time

        got = {}
        slow = threading.Thread(
            target=lambda: got.setdefault("a", post("?seconds=3")))
        slow.start()
        # the first capture is running once its private directory exists
        prof = tmp_path / "prof"
        deadline = time.time() + 30
        while not (prof.is_dir() and any(n.endswith(".tmp")
                                         for n in os.listdir(prof))):
            assert time.time() < deadline, "the capture never started"
            time.sleep(0.01)
        assert post("?seconds=0.1")[0] == 409
        slow.join(60)
        assert not slow.is_alive()
        status, doc = got["a"]
        assert status == 200 and os.path.isdir(doc["profile_dir"])
        assert post("?seconds=abc")[0] == 400
        assert post("?seconds=0")[0] == 400
        assert d.registry.counters["serve_profile_captures"] == 1
    finally:
        server.shutdown()
        server.server_close()
        d._shutdown()
    assert not profiling.profiling_enabled()
