"""The fleet's multi-process pieces on the CPU: the coordinator's counter
reduction (``--coordinator``), the fleet over a ('batch',) mesh of ranks
(``clean_fleet(mesh=...)``, ``--fleet --mesh batch``), as
``tests/test_telemetry.py`` and ``tests/test_fleet_multihost.py`` hold
the reference's.

- ``aggregate_metrics_across_processes``: a single process returns a
  copy with no collective (the reference's test); a failed collective
  degrades to the local counters, counted as ``telemetry_degraded`` on
  the registry, emitted as a ``telemetry_degraded`` event, and noted on
  stderr only when neither sink is given; two ranks of a coordinator
  group sum their counters in sorted key order.
- Two ``--hosts 2 --coordinator 127.0.0.1:PORT --journal J
  --metrics-json`` CLI processes: each report's ``_AGGREGATED_COUNTERS``
  equal the hosts' sums (the fleet counters as the journal's per-host
  stats fold them, the archive counters from the hosts' event logs and
  outputs), and the outputs equal a single ``--fleet`` process's.
- Two hosts of two ``torch.distributed.run`` ranks each (``--fleet
  --mesh batch --hosts 2 --coordinator``): each host splits its groups
  over its two ranks, and the counters and outputs are as above.
- ``clean_fleet`` over two gloo ranks with seeded load, OOM and
  transient execute faults: every rank's report holds the JAX
  ``clean_fleet``'s over a ('batch',) mesh of two of the conftest's host
  devices (masks and loops equal, failures equal by path, stage and
  error type, the same retries and OOM halvings), and the port's
  single-process fleet's bit for bit.  Where the OOM hits a singleton
  the reference cleans it on the host with its numpy oracle; the port
  never moves a clean off the device, so that archive fails instead.
- ``--fleet --mesh batch --batch 2`` under ``torch.distributed.run``
  with two ranks and a seeded fault: rank 0 alone writes, the outputs
  equal the JAX mesh fleet's masks, the faulted archive fails once.
- A rank that stalls past the side group's timeout fails its group, and
  every later group fails at once on both ranks: no rank's late
  collective pairs with another group's.

The JAX fleet runs the reference's kernel route (``fft_mode='dft'``, the
fused sweep); masks and loops are compared exactly, as
``tests/test_torch_fleet.py`` holds the single-process fleet.
Every spawned process and gloo job has its own timeout.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from iterative_cleaner_tpu.config import CleanConfig as RefConfig
from iterative_cleaner_tpu.parallel.fleet import clean_fleet as ref_clean_fleet
from iterative_cleaner_tpu.parallel.mesh import batch_mesh as ref_batch_mesh
from iterative_cleaner_tpu.resilience import FaultInjector as RefInjector
from iterative_cleaner_tpu.resilience import ResiliencePlan as RefPlan
from iterative_cleaner_torch.convert import config_from_reference
from iterative_cleaner_torch.io import load_archive, save_archive
from iterative_cleaner_torch.io.synthetic import make_synthetic_archive
from iterative_cleaner_torch.parallel import distributed
from iterative_cleaner_torch.parallel.distributed import (
    aggregate_metrics_across_processes,
    run_local_ranks,
)
from iterative_cleaner_torch.parallel.fleet import clean_fleet
from iterative_cleaner_torch.resilience import (
    FaultInjector,
    FleetJournal,
    ResiliencePlan,
)
from iterative_cleaner_torch.telemetry.events import RunEventLog
from iterative_cleaner_torch.telemetry.registry import MetricsRegistry
from iterative_cleaner_torch.telemetry.run import _AGGREGATED_COUNTERS
from tests.torch_shard_ranks import aggregate_rank, fleet_rank

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROC_TIMEOUT_S = 240
GROUP = 2
REF_CFG = RefConfig(dtype="float32", median_impl="pallas", stats_impl="fused",
                    fused_sweep="on", fft_mode="dft", rotation="roll",
                    max_iter=3)
# the CLI's --rotation roll --max_iter 3 --batch 2
CFG = dataclasses.replace(config_from_reference(REF_CFG, "cpu"),
                          fleet_group_size=GROUP)
# the 3rd execute call is the first group of two: it halves
FAULTS = "load:perm@2,exec:oom@3,execute:err@5"
# the 1st execute call is a singleton: the reference's numpy rung
FAULTS_SINGLETON_OOM = "load:perm@2,exec:oom@1,execute:err@3"


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    for var in ("ICLEAN_HOSTS", "ICLEAN_HOST_ID", "ICLEAN_FAULTS",
                "ICLEAN_COORDINATOR"):
        env.pop(var, None)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    return env


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _write_fleet(tmp_path, geoms):
    paths = []
    for i, (nsub, nchan, nbin) in enumerate(geoms):
        ar, _ = make_synthetic_archive(nsub=nsub, nchan=nchan, nbin=nbin,
                                       seed=40 + i)
        p = str(tmp_path / ("c_%02d.npz" % i))
        save_archive(ar, p)
        paths.append(p)
    return paths


GEOMS = [(8, 16, 32)] * 5 + [(4, 16, 32), (8, 8, 32), (8, 8, 32)]


def _named(report):
    """A fleet report keyed by file name: each result's (weights, loops),
    the sorted (name, stage, error type) failures, retries, halvings."""
    return ({os.path.basename(p): (r.final_weights, r.loops)
             for p, r in report.results.items()},
            sorted((os.path.basename(p), st, type(e).__name__)
                   for p, st, e in report.failures),
            report.n_retries, report.n_oom_splits)


@pytest.fixture(scope="module")
def jax_fleet(tmp_path_factory):
    """The JAX ``clean_fleet`` over a ('batch',) mesh of two of the
    conftest's host devices, on GEOMS's files and a missing one, with the
    seeded fault spec given (once per spec): :func:`_named`'s tuple."""
    d = tmp_path_factory.mktemp("jax_fleet")
    paths = _write_fleet(d, GEOMS) + [str(d / "missing.npz")]
    memo = {}

    def run(faults):
        if faults not in memo:
            memo[faults] = _named(ref_clean_fleet(
                paths, REF_CFG, mesh=ref_batch_mesh(2), group_size=GROUP,
                io_workers=1, resilience=RefPlan(
                    faults=RefInjector(faults, seed=0) if faults else None)))
        return memo[faults]
    return run


def _check_coordinated_counters(tmp_path, jpath, want):
    """Each host's metric export: every _AGGREGATED_COUNTERS key equals
    the hosts' sum (the fleet counters as the journal's per-host stats
    fold them, the archive counters from the hosts' event logs), with no
    degrade; ``want`` the masks by path."""
    fold = FleetJournal(jpath).host_stats()
    assert sorted(fold) == [0, 1]
    share = {k: sum(float(fold[h].get(k, 0.0)) for h in fold)
             for k in _AGGREGATED_COUNTERS if k.startswith("fleet_")}
    archive_events = [json.loads(x) for h in (0, 1)
                      for x in open(tmp_path / f"e{h}.jsonl")]
    archive_events = [e for e in archive_events if e.get("event") ==
                      "archive"]
    share["archives_cleaned"] = float(len(archive_events))
    share["archives_converged"] = float(sum(e["converged"]
                                            for e in archive_events))
    share["archives_failed"] = share["fleet_failures"]
    share["iterations_total"] = float(sum(e["loops"]
                                          for e in archive_events))
    share["cells_zapped"] = float(sum(e["cells_zapped"]
                                      for e in archive_events))
    share["cells_total"] = float(sum(w.size for w in want.values()))
    assert share["archives_cleaned"] == len(want) == share["fleet_cleaned"]
    for h in (0, 1):
        counters = json.load(open(tmp_path / f"m{h}.json"))["counters"]
        assert "telemetry_degraded" not in counters
        for k in _AGGREGATED_COUNTERS:
            assert counters.get(k, 0.0) == share[k], (h, k)


# ------------------------------------------------------------- aggregate

def test_aggregate_metrics_single_process_noop():
    counters = {"b": 2.0, "a": 1.0}
    out = aggregate_metrics_across_processes(counters)
    assert out == counters and out is not counters
    assert distributed.coordinated_processes() == 1


@pytest.mark.parametrize("sinks", ["registry", "events", "both", "none"])
def test_aggregate_metrics_degrades_to_local(monkeypatch, tmp_path, capsys,
                                             sinks):
    """A collective that fails (a dead host; the group's timeout) leaves
    the local counters, and the degrade is telemetry itself."""
    monkeypatch.setattr(distributed, "coordinated_processes", lambda: 2)

    def broken(x, group):
        raise RuntimeError("peer closed the connection")

    monkeypatch.setattr(distributed, "_all_gather", broken)
    reg = MetricsRegistry() if sinks in ("registry", "both") else None
    log = str(tmp_path / "ev.jsonl")
    events = RunEventLog(log) if sinks in ("events", "both") else None
    counters = {"archives_cleaned": 3.0, "cells_total": 96.0}
    out = aggregate_metrics_across_processes(counters, registry=reg,
                                             events=events)
    assert out == counters and out is not counters
    err = capsys.readouterr().err
    if reg is not None:
        assert reg.snapshot()["counters"]["telemetry_degraded"] == 1
    if events is not None:
        lines = [json.loads(x) for x in open(log)]
        (ev,) = [x for x in lines if x.get("event") == "telemetry_degraded"]
        assert ev["scope"] == "local_counters_only"
        assert "RuntimeError" in ev["error"]
    assert ("metric reduction unavailable" in err) == (sinks == "none")


def test_aggregate_metrics_over_two_ranks(tmp_path):
    store = str(tmp_path / "coord_store")
    ranks = run_local_ranks(
        aggregate_rank, 2, (store, [{"b": 2.0, "a": 1.0, "z": 0.0},
                                    {"b": 5.0, "a": 3.0, "z": 0.0}]),
        workdir=str(tmp_path), timeout_s=PROC_TIMEOUT_S, threads=1)
    for n, sums, degraded in ranks:
        assert n == 2 and degraded == 0
        assert sums == {"a": 4.0, "b": 7.0, "z": 0.0}


def test_coordinator_address():
    assert distributed.coordinator_address("127.0.0.1:1234") == \
        "tcp://127.0.0.1:1234"
    assert distributed.coordinator_address("tcp://h:1") == "tcp://h:1"
    for bad in ("host", ":12", "host:port"):
        with pytest.raises(ValueError, match="HOST:PORT"):
            distributed.coordinator_address(bad)
    with pytest.raises(ValueError, match="host count"):
        distributed.initialize(device="cpu", coordinator="127.0.0.1:1")


# ------------------------------------------------------ two CLI hosts

def _cli(paths, extra):
    return [sys.executable, "-m", "iterative_cleaner_torch", "--device",
            "cpu", "-q", "-l", "--fleet", "--rotation", "roll",
            "--max_iter", "3"] + extra + paths


def _run(procs):
    outs = []
    try:
        for proc in procs:
            out, _ = proc.communicate(timeout=PROC_TIMEOUT_S)
            outs.append(out)
            assert proc.returncode == 0, out[-4000:]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
    return outs


def test_two_process_cli_coordinator_sums_counters(tmp_path, jax_fleet):
    paths = _write_fleet(tmp_path, GEOMS)
    ref, _fails, _r, _o = jax_fleet("")
    want = {p: ref[os.path.basename(p)][0] for p in paths}
    jpath = str(tmp_path / "j.jsonl")
    port = _free_port()
    procs = [subprocess.Popen(_cli(paths, [
        "--hosts", "2", "--host-id", str(h), "--coordinator",
        f"127.0.0.1:{port}", "--journal", jpath, "--claim-ttl", "5",
        "--metrics-json", str(tmp_path / f"m{h}.json"),
        "--event-log", str(tmp_path / f"e{h}.jsonl")]),
        env=_env(), cwd=str(tmp_path), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for h in (0, 1)]
    _run(procs)
    for p in paths:
        np.testing.assert_array_equal(
            load_archive(p + "_cleaned.npz").weights, want[p])
    _check_coordinated_counters(tmp_path, jpath, want)


def _torchrun(nproc):
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc_per_node", str(nproc)]


def test_coordinator_two_hosts_of_two_ranks(tmp_path, jax_fleet):
    """``--coordinator`` under torchrun: two hosts of two ranks each, each
    host's groups split over its ranks (``local_batch_mesh``), one
    journal.  The outputs are the JAX mesh fleet's masks and the
    counters the hosts' sums."""
    paths = _write_fleet(tmp_path, GEOMS)
    ref, _fails, _r, _o = jax_fleet("")
    want = {p: ref[os.path.basename(p)][0] for p in paths}
    jpath = str(tmp_path / "j.jsonl")
    port = _free_port()
    procs = [subprocess.Popen(_torchrun(2) + _cli(paths, [
        "--mesh", "batch", "--batch", str(GROUP), "--io-workers", "1",
        "--hosts", "2", "--host-id", str(h), "--coordinator",
        f"127.0.0.1:{port}", "--journal", jpath, "--claim-ttl", "5",
        "--metrics-json", str(tmp_path / f"m{h}.json"),
        "--event-log", str(tmp_path / f"e{h}.jsonl")])[1:],
        env=_env(), cwd=str(tmp_path), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for h in (0, 1)]
    _run(procs)
    for p in paths:
        np.testing.assert_array_equal(
            load_archive(p + "_cleaned.npz").weights, want[p])
    _check_coordinated_counters(tmp_path, jpath, want)


# ------------------------------------------------------- the fleet's mesh

def _single_fleet(paths, faults):
    return clean_fleet(paths, CFG, resilience=ResiliencePlan(
        faults=FaultInjector(faults, seed=0)), io_workers=1)


@pytest.mark.parametrize("faults", [FAULTS, FAULTS_SINGLETON_OOM])
def test_fleet_over_two_ranks_with_faults(tmp_path, jax_fleet, faults):
    paths = _write_fleet(tmp_path, GEOMS)
    paths.append(str(tmp_path / "missing.npz"))
    single = _single_fleet(paths, faults)
    want, want_fail, retries, halvings = _named(single)
    assert {st for _p, st, _n in want_fail} >= {"peek", "load"}
    ref, ref_fail, ref_retries, ref_halvings = jax_fleet(faults)
    if faults == FAULTS:
        assert (retries, halvings) == (ref_retries, ref_halvings)
        assert halvings == 1
        assert want_fail == ref_fail
    else:
        # the reference cleaned the OOM singleton on the host
        (extra,) = sorted(set(want_fail) - set(ref_fail))
        assert extra[1:] == ("clean", "SyntheticResourceExhausted")
        assert extra[0] in ref and extra[0] not in want
        assert sorted(set(want_fail) - {extra}) == ref_fail
    for name, (w, loops) in want.items():
        np.testing.assert_array_equal(w, ref[name][0])
        assert loops == ref[name][1]
    ranks = run_local_ranks(
        fleet_rank, 2, (paths, CFG, faults, 0),
        workdir=str(tmp_path), timeout_s=PROC_TIMEOUT_S, threads=1)
    for results, failures, skipped in ranks:
        assert sorted((os.path.basename(p), st, n)
                      for p, st, n in failures) == want_fail
        assert skipped == []
        assert set(results) == set(single.results)
        for p, (w, loops) in results.items():
            np.testing.assert_array_equal(w, single.results[p].final_weights)
            assert loops == single.results[p].loops


def test_fleet_rank_stalled_past_the_timeout(tmp_path):
    """A rank slow but alive: its first load outlasts the side group's
    timeout.  Rank 0's agreement on that group times out and fails it;
    from then on no collective runs, so every later group fails at once
    on both ranks, and the stalled rank's late call pairs with nothing:
    no result lands on either rank."""
    paths = _write_fleet(tmp_path, GEOMS)
    ranks = run_local_ranks(
        fleet_rank, 2, (paths, CFG, "", 0, 6.0), workdir=str(tmp_path),
        timeout_s=PROC_TIMEOUT_S, threads=1, group_timeout_s=2.0)
    for results, failures, skipped in ranks:
        assert results == {} and skipped == []
        assert sorted(p for p, _st, _n in failures) == sorted(paths)
        assert {n for _p, _st, n in failures} == {"MeshTimeout"}


def test_cli_fleet_mesh_batch_under_torchrun(tmp_path, jax_fleet):
    paths = _write_fleet(tmp_path, GEOMS)
    ref, ref_fail, _r, _o = jax_fleet("load:perm@2")
    (bad,) = [n for n, st, _e in ref_fail if st == "load"]
    names = [os.path.basename(p) for p in paths]
    out = subprocess.run(
        _torchrun(2) + ["-m", "iterative_cleaner_torch",
         "--device", "cpu", "--fleet", "--mesh", "batch", "--batch", "2",
         "--rotation", "roll", "--max_iter", "3", "--io-workers", "1",
         "--faults", "load:perm@2", "--metrics-json", "run.json",
         "--keep_going", *names],
        cwd=tmp_path, env=_env(), capture_output=True, text=True,
        timeout=PROC_TIMEOUT_S)
    assert out.returncode == 1, out.stderr[-3000:]
    assert out.stderr.count("ERROR cleaning %s" % bad) == 1
    doc = json.load(open(tmp_path / "run.json"))
    assert doc["counters"]["fleet_cleaned"] == len(paths) - 1
    assert doc["counters"]["archives_failed"] == 1
    for p in paths:
        if os.path.basename(p) == bad:
            assert not os.path.exists(p + "_cleaned.npz")
            continue
        np.testing.assert_array_equal(
            load_archive(p + "_cleaned.npz").weights,
            ref[os.path.basename(p)][0])
    assert open(tmp_path / "clean.log").read().count("Cleaned") \
        == len(paths) - 1
