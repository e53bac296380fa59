"""The port stands alone: importing it and running its main path (the
whole clean, in float32 and float64, the numpy oracle whole and in both
streaming modes, ``tools selftest``, both streaming modes, the batched
clean (``--batch``), the
cell-sharded clean on one rank
on the default and two_read routes, both streaming modes over that rank,
the CLI session on a PSRFITS archive with its run report, Prometheus
file and event log, PSRFITS and ``.icar`` files read through the
port's host library, ``--checkpoint`` and its resume, ``--model
quicklook``, ``--trace`` and ``tools diff``, ``sweep`` and
``borderline``; the fleet; the online mode: ``OnlineSession``, its
reconciles and close, ``StreamMux`` with its dispatcher thread,
``--stream DIR``, ``--mux D1 D2`` and ``--model online_ewt``; the serve
daemon with its spans, flight recorder and profiler; the analyzer: its
lint, journal fsck, race sweep, card contracts and ``--selfcheck``) never
loads
``jax`` or the reference package; no
source of the port (``parallel/*``, ``telemetry/*``, ``utils/*`` and
``io/*`` included), its timing tools (``tools/*.py``) or ``chip_smoke.py``
imports either, and none names
the reference's ``native/`` directory or its ``libicar.so``."""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "iterative_cleaner_torch")
FORBIDDEN = ("jax", "jaxlib", "iterative_cleaner_tpu")


# The reference's native directory and its library: the port builds its
# own from io/csrc into _build/.
FORBIDDEN_STRINGS = ("native/", "libicar.so")


def _port_sources(exts=(".py",)):
    for root, dirs, files in os.walk(PKG):
        dirs[:] = [d for d in dirs if d not in ("_build", "__pycache__")]
        for name in files:
            if name.endswith(exts):
                yield os.path.join(root, name)
    tools = os.path.join(REPO, "tools")
    for name in sorted(os.listdir(tools)):
        if name.endswith(exts):
            yield os.path.join(tools, name)
    yield os.path.join(REPO, "chip_smoke.py")


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(_port_sources()),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_forbidden_import_in_source(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize(
    "path", sorted(_port_sources((".py", ".cpp", ".cu", ".cuh"))),
    ids=lambda p: os.path.relpath(p, REPO))
def test_no_reference_native_library_in_source(path):
    with open(path) as f:
        text = f.read()
    bad = [s for s in FORBIDDEN_STRINGS if s in text]
    assert not bad, f"{path} names {bad}"


def test_cluster_kernel_and_its_timing_tool_are_scanned():
    """The scaler's cluster kernel and the tool that times it are among
    the scanned sources."""
    scanned = set(_port_sources((".py", ".cu")))
    assert os.path.join(PKG, "stats", "csrc", "sides_cluster.cu") in scanned
    assert os.path.join(REPO, "tools", "time_long_sides.py") in scanned


def test_batch_module_is_scanned():
    """The batched clean's module is among the scanned sources."""
    assert os.path.join(PKG, "parallel", "batch.py") in set(_port_sources())


@pytest.mark.parametrize("module", [
    ("models", "__init__.py"), ("models", "quicklook.py"),
    ("utils", "checkpoint.py"), ("utils", "tracing.py")])
def test_cli_surface_modules_are_scanned(module):
    """The modules of the rest of the CLI surface (checkpoints, models,
    the trace) are among the scanned sources."""
    assert os.path.join(PKG, *module) in set(_port_sources())


def test_main_path_runs_without_jax():
    code = """
import sys
import numpy as np
import iterative_cleaner_torch
from iterative_cleaner_torch import CleanConfig
from iterative_cleaner_torch.backends import clean_archive
from iterative_cleaner_torch.io.synthetic import make_synthetic_archive
import iterative_cleaner_torch.cli, iterative_cleaner_torch.convert
import iterative_cleaner_torch.parallel.tile_cache
from iterative_cleaner_torch.parallel import clean_streaming
ar, _ = make_synthetic_archive(nsub=8, nchan=16, nbin=32, seed=0)
res = clean_archive(ar, CleanConfig(device="cpu"))
assert res.loops >= 1
for mode in ("exact", "online"):
    assert clean_streaming(ar, 3, CleanConfig(device="cpu"),
                           mode=mode).loops >= 1
# float64, the numpy oracle (whole and streamed) and tools selftest
import iterative_cleaner_torch.backends.numpy_backend
import iterative_cleaner_torch.ops.dsp_numpy
import iterative_cleaner_torch.ops.psrchive_baseline_numpy
import iterative_cleaner_torch.stats.masked_numpy
import iterative_cleaner_torch.tools
assert clean_archive(ar, CleanConfig(device="cpu", dtype="float64")).loops >= 1
for mode in ("exact", "online"):
    assert clean_streaming(ar, 3, CleanConfig(backend="numpy"),
                           mode=mode).loops >= 1
assert iterative_cleaner_torch.tools.main(["selftest", "--device", "cpu"]) == 0
from iterative_cleaner_torch.parallel import clean_archives_batched
assert [r.loops for r in clean_archives_batched(
    [ar, ar], CleanConfig(device="cpu"))] == [res.loops] * 2
from iterative_cleaner_torch.parallel import distributed
from iterative_cleaner_torch.parallel.mesh import cell_mesh
from iterative_cleaner_torch import clean_archive_sharded
distributed.initialize(device="cpu")
try:
    mesh = cell_mesh()
    assert clean_archive_sharded(ar, CleanConfig(device="cpu"),
                                 mesh).loops >= 1
    assert clean_archive_sharded(
        ar, CleanConfig(device="cpu", baseline_mode="profile"),
        mesh).loops >= 1
    for mode in ("exact", "online"):
        assert clean_streaming(ar, 4, CleanConfig(device="cpu"), mesh,
                               mode=mode).loops >= 1
finally:
    distributed.shutdown()
import os, tempfile
import iterative_cleaner_torch.telemetry.events
import iterative_cleaner_torch.telemetry.exporters
import iterative_cleaner_torch.telemetry.quality
import iterative_cleaner_torch.telemetry.registry
import iterative_cleaner_torch.telemetry.run
import iterative_cleaner_torch.utils.logging
from iterative_cleaner_torch.io import psrfits, save_archive
os.chdir(tempfile.mkdtemp())
save_archive(ar, "obs.sf")
assert psrfits.is_fits("obs.sf")
assert iterative_cleaner_torch.cli.main([
    "--device", "cpu", "-q", "--metrics-json", "r.json", "--prom-textfile",
    "r.prom", "--log-format", "json", "--timing", "obs.sf"]) == 0
assert os.path.exists("obs.sf_cleaned.sf") and os.path.exists("r.json")
from iterative_cleaner_torch.io import load_archive, native
native.reset_load_counts()
save_archive(ar, "obs.icar")
for name in ("obs.sf", "obs.icar"):
    back = load_archive(name)
    assert np.array_equal(back.weights, ar.weights), name
assert native.load_counts() == {"psrfits": 1, "icar": 1}
assert iterative_cleaner_torch.cli.main([
    "--device", "cpu", "-q", "--batch", "2", "obs.sf", "obs.icar"]) == 0
# the CLI surface of item 2c: --checkpoint and its resume, --model
# quicklook, --trace, tools diff, sweep and borderline
import iterative_cleaner_torch.models.quicklook
import iterative_cleaner_torch.utils.checkpoint
import iterative_cleaner_torch.utils.tracing
for _ in range(2):
    assert iterative_cleaner_torch.cli.main([
        "--device", "cpu", "-q", "--checkpoint", "ck", "--trace", "tr",
        "obs.icar"]) == 0
assert iterative_cleaner_torch.cli.main([
    "--device", "cpu", "-q", "--model", "quicklook", "-o", "ql.icar",
    "obs.icar"]) == 0
tools = iterative_cleaner_torch.tools
assert tools.main(["diff", "obs.icar_cleaned.icar", "obs.sf_cleaned.sf"]) == 0
for cmd in (["sweep", "obs.icar", "-c", "5", "-s", "5", "--device", "cpu",
             "--model", "quicklook"], ["borderline", "obs.icar"]):
    assert tools.main(cmd) == 0
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "iterative_cleaner_tpu"))
print("LOADED", bad)
"""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


@pytest.mark.parametrize("module", [
    ("resilience", "__init__.py"), ("resilience", "faults.py"),
    ("resilience", "retry.py"), ("resilience", "journal.py"),
    ("resilience", "segmented.py"), ("parallel", "fleet.py")])
def test_fleet_modules_are_scanned(module):
    """The fleet's modules (the resilience package, the scheduler) are
    among the scanned sources."""
    assert os.path.join(PKG, *module) in set(_port_sources())


def test_fleet_path_runs_without_jax():
    """Importing the resilience package and the fleet, and running a
    journaled fleet through the library and the CLI (a fault drill,
    ``--resume``, ``--precompile``, two hosts over one journal in one
    process), loads neither ``jax`` nor the reference package."""
    code = """
import os, sys, tempfile
import iterative_cleaner_torch.resilience
import iterative_cleaner_torch.resilience.faults
import iterative_cleaner_torch.resilience.journal
import iterative_cleaner_torch.resilience.retry
import iterative_cleaner_torch.resilience.segmented
import iterative_cleaner_torch.parallel.fleet as fleet
from iterative_cleaner_torch import CleanConfig
from iterative_cleaner_torch.cli import main
from iterative_cleaner_torch.io import make_synthetic_archive, save_archive
from iterative_cleaner_torch.parallel.distributed import HostTopology
from iterative_cleaner_torch.resilience import (
    FaultInjector, FleetJournal, ResiliencePlan)
os.chdir(tempfile.mkdtemp())
paths = []
for i, shape in enumerate([(8, 16, 32), (8, 16, 32), (6, 12, 32)]):
    ar, _ = make_synthetic_archive(nsub=shape[0], nchan=shape[1],
                                   nbin=shape[2], seed=i)
    paths.append("a%d.npz" % i)
    save_archive(ar, paths[-1])
cfg = CleanConfig(device="cpu")
rep = fleet.clean_fleet(paths, cfg, resilience=ResiliencePlan(
    faults=FaultInjector("load:err@1,exec:oom@2", seed=0),
    journal=FleetJournal("j.d" + os.sep)))
assert rep.ok and len(rep.results) == 3, rep.failures
for h in (0, 1):
    fleet.clean_fleet(paths, cfg, hosts=HostTopology(h, 2),
                      resilience=ResiliencePlan(journal=FleetJournal("h.jsonl")))
assert main(["--device", "cpu", "-q", "--fleet", "--journal", "c.jsonl",
             *paths]) == 0
assert main(["--device", "cpu", "-q", "--fleet", "--journal", "c.jsonl",
             "--resume", *paths]) == 0
assert main(["--device", "cpu", "-q", "--precompile", "--compile-cache",
             "cc", "16x32x32"]) == 0
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "iterative_cleaner_tpu"))
print("LOADED", bad)
"""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


@pytest.mark.parametrize("name", [
    "__init__.py", "chunks.py", "ewt.py", "step.py", "session.py",
    "reconcile.py", "model.py", "mux.py"])
def test_online_modules_are_scanned(name):
    """The online mode's modules are among the scanned sources."""
    assert os.path.join(PKG, "online", name) in set(_port_sources())


def test_online_path_runs_without_jax():
    """Driving an ``OnlineSession`` (steps, a reconcile, the close), a
    ``StreamMux`` (by hand and through its dispatcher thread),
    ``--stream DIR``, ``--mux D1 D2`` and ``--model online_ewt`` on the
    CPU loads neither ``jax`` nor the reference package."""
    code = """
import os, sys, tempfile
import numpy as np
import iterative_cleaner_torch.online as online
import iterative_cleaner_torch.online.model
from iterative_cleaner_torch import CleanConfig
from iterative_cleaner_torch.cli import main
from iterative_cleaner_torch.io import make_synthetic_archive, save_archive
from iterative_cleaner_torch.telemetry import MetricsRegistry
os.chdir(tempfile.mkdtemp())
cfg = CleanConfig(device="cpu", max_iter=2)
ar, _ = make_synthetic_archive(nsub=6, nchan=8, nbin=16, seed=0)
meta = online.StreamMeta.from_archive(ar)
s = online.OnlineSession(meta, cfg, reconcile_every=3,
                         registry=MetricsRegistry(), stream_id="a")
s.ingest(ar.total_intensity(), ar.weights)
assert s.reconciles == 2 and s.close().n_subints == 6
mux = online.StreamMux(max_batch=2, max_wait_ms=0.0)
for key in ("a", "b"):
    mux.open(key, meta, cfg)
    mux.ingest(key, ar.total_intensity()[:3])
assert mux.pump(force=True) == 3
mux.start()
mux.ingest("a", ar.total_intensity()[3])
mux.drain()
mux.stop()
assert mux.close_stream("a").n_subints == 4
for d in ("s0", "s1", "s2"):
    os.makedirs(d)
    online.save_stream_meta(d, meta)
    for i in range(3):
        np.save(os.path.join(d, "%03d.npy" % i), ar.total_intensity()[i])
    open(os.path.join(d, online.CLOSE_SENTINEL), "w").close()
assert main(["--device", "cpu", "-q", "--stream", "s0"]) == 0
assert main(["--device", "cpu", "-q", "--mux", "s1", "s2"]) == 0
save_archive(ar, "obs.npz")
assert main(["--device", "cpu", "-q", "--model", "online_ewt",
             "obs.npz"]) == 0
assert all(os.path.exists(p) for p in (
    "s0/stream_cleaned.npz", "s1/stream_cleaned.npz",
    "s2/stream_cleaned.npz", "obs.npz_cleaned.npz"))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "iterative_cleaner_tpu"))
print("LOADED", bad)
"""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


@pytest.mark.parametrize("module", [
    ("serve", "__init__.py"), ("serve", "request.py"),
    ("serve", "scheduler.py"), ("serve", "spool.py"), ("serve", "http.py"),
    ("serve", "daemon.py"), ("serve", "membership.py"),
    ("serve", "result_cache.py"), ("telemetry", "tracing.py"),
    ("telemetry", "recorder.py"), ("telemetry", "profiling.py")])
def test_serve_modules_are_scanned(module):
    """The serve daemon's modules and the tracer, flight recorder and
    profiler are among the scanned sources."""
    assert os.path.join(PKG, *module) in set(_port_sources())


def test_serve_path_runs_without_jax():
    """Importing ``serve`` and ``telemetry.{tracing,recorder,profiling}``
    and running a daemon in this process (an archive request over HTTP
    with the result cache, a stream request, a profile capture, the drain)
    and ``--fleet --trace-out --flight-recorder`` loads neither ``jax`` nor
    the reference package."""
    code = """
import json, os, signal, sys, tempfile, threading, time, urllib.request
import numpy as np
import iterative_cleaner_torch.serve
import iterative_cleaner_torch.telemetry.tracing
import iterative_cleaner_torch.telemetry.recorder
import iterative_cleaner_torch.telemetry.profiling
from iterative_cleaner_torch import CleanConfig, online
from iterative_cleaner_torch.cli import main
from iterative_cleaner_torch.config import ServeConfig
from iterative_cleaner_torch.io import make_synthetic_archive, save_archive
from iterative_cleaner_torch.serve import ServeDaemon
os.chdir(tempfile.mkdtemp())
ar, _ = make_synthetic_archive(nsub=4, nchan=8, nbin=16, seed=1)
save_archive(ar, "a.npz")
for i in range(4):
    np.save("%03d.npy" % i, ar.total_intensity()[i])
d = ServeDaemon(ServeConfig(http_port=0, poll_s=0.02, journal_path="j.jsonl",
                            flight_recorder="f.json", trace_out="t.json",
                            result_cache=True, profile_dir="prof"),
                CleanConfig(device="cpu", max_iter=2), quiet=True)
t = threading.Thread(target=d.run, daemon=True)
t.start()
while d._httpd is None:
    time.sleep(0.01)
url = "http://127.0.0.1:%d" % d._httpd.server_address[1]
def post(path, doc):
    req = urllib.request.Request(url + path, data=json.dumps(doc).encode())
    return json.loads(urllib.request.urlopen(req, timeout=60).read())
def done(rid):
    for _ in range(1200):
        s = json.loads(urllib.request.urlopen(url + "/requests/" + rid).read())
        if s["state"] in ("done", "failed"):
            return s
        time.sleep(0.05)
post("/submit", {"paths": [os.path.abspath("a.npz")], "id": "r1"})
assert done("r1")["state"] == "done"
post("/submit", {"paths": [os.path.abspath("a.npz")], "id": "r2"})
assert done("r2")["n_cached"] == 1
post("/submit", {"id": "s", "kind": "stream",
                 "meta": online.StreamMeta.from_archive(ar).to_dict()})
for i in range(4):
    post("/stream/s/subint", {"path": os.path.abspath("%03d.npy" % i)})
post("/stream/s/close", {})
assert done("s")["state"] == "done"
assert os.path.isdir(post("/profile?seconds=0.1", {})["profile_dir"])
d._on_signal(signal.SIGTERM, None)
t.join(60)
assert os.path.exists("t.json")
assert main(["--device", "cpu", "-q", "--fleet", "--trace-out", "f.json",
             "--flight-recorder", "box.json", "-o", "x.npz", "a.npz"]) == 0
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "iterative_cleaner_tpu"))
print("LOADED", bad)
"""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


@pytest.mark.parametrize("name", [
    "__init__.py", "__main__.py", "core.py", "rules_io.py",
    "rules_project.py", "rules_threads.py", "journal_fsck.py",
    "interleave.py", "card_contracts.py", "cli.py"])
def test_analysis_modules_are_scanned(name):
    """The analyzer's modules are among the scanned sources."""
    assert os.path.join(PKG, "analysis", name) in set(_port_sources())


def test_analysis_path_runs_without_jax():
    """The port's analyzer — the lint over the package, ``--journal-fsck``
    of a fleet journal, the race sweep of a scenario with a seeded bug
    and its clean twin, the card contracts on the CPU and
    ``--selfcheck --device cpu`` through the CLI — loads neither ``jax``
    nor the reference package."""
    code = """
import os, sys, tempfile
import iterative_cleaner_torch.analysis
import iterative_cleaner_torch.analysis.card_contracts as cc
import iterative_cleaner_torch.analysis.interleave as il
from iterative_cleaner_torch.analysis import lint_paths
from iterative_cleaner_torch.analysis.cli import main as lint_main
from iterative_cleaner_torch.analysis.journal_fsck import fsck_journal
from iterative_cleaner_torch.cli import main
from iterative_cleaner_torch.resilience import FleetJournal
assert lint_paths().ok
os.chdir(tempfile.mkdtemp())
j = FleetJournal("j.jsonl")
j.record_request("r", "accepted")
j.try_claim("req:r", host=0, nonce="n", ttl_s=5.0)
j.record_request("r", "done")
assert fsck_journal("j.jsonl").ok
assert lint_main(["--journal-fsck", "j.jsonl"]) == 0
assert not il.explore(il.build_scenario("claim-race", bug="no-readback"),
                      budget_s=60).ok
assert il.explore(il.build_scenario("claim-race", backend="segmented"),
                  budget_s=60).ok
assert all(r.ok for r in cc.verify_hot_programs(
    "cpu", names=["online_step", "sharded_sweep"]))
assert main(["--selfcheck", "--device", "cpu", "--journal-fsck",
             "j.jsonl"]) == 0
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "iterative_cleaner_tpu"))
print("LOADED", bad)
"""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout
