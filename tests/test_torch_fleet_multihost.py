"""The port's multi-host fleet (``clean_fleet(..., hosts=)``, ``--hosts N
--host-id I``) on the CPU, as ``tests/test_fleet_multihost.py`` holds the
reference's: the hash partition (equal to the reference's, so both
packages assign a bucket to the same host), topology resolution, config
and CLI validation, and the drills — two threads and two CLI processes
sharing one journal (every archive cleaned once, masks bit-equal to a
single-host serve, whole-slice counters folded from the journal), one
survivor draining the slice, and a host killed with SIGKILL while it
holds a lease, whose bucket the other steals with no duplicate clean.
Every spawned process has its own timeout.  The journal coordinates
the hosts' work; ``--coordinator`` (the reference's ``jax.distributed``
round trip) joins them in a process group whose counters reduction is
held in ``tests/test_torch_coordinator.py``."""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from iterative_cleaner_tpu.parallel.fleet import (
    bucket_host as ref_bucket_host,
    bucket_work_key as ref_bucket_work_key,
)
from iterative_cleaner_torch import CleanConfig
from iterative_cleaner_torch.io import (
    load_archive,
    make_synthetic_archive,
    save_archive,
)
from iterative_cleaner_torch.parallel.distributed import (
    HostTopology,
    resolve_host_topology,
    stable_shard,
)
from iterative_cleaner_torch.parallel.fleet import (
    bucket_host,
    bucket_work_key,
    clean_fleet,
    resolve_claim_ttl,
)
from iterative_cleaner_torch.resilience import FleetJournal, ResiliencePlan
from iterative_cleaner_torch.telemetry.registry import MetricsRegistry
from iterative_cleaner_torch.utils.checkpoint import config_hash

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = CleanConfig(device="cpu", rotation="roll", max_iter=2)
# two geometries whose buckets hash to different hosts under n_hosts=2
GEOM_H0 = (16, 32, 32)
GEOM_H1 = (12, 32, 32)
PROC_TIMEOUT_S = 240


def _write_fleet(tmp_path, n=4):
    paths = []
    for i in range(n):
        nsub, nchan, nbin = (GEOM_H0, GEOM_H1)[i % 2]
        ar, _ = make_synthetic_archive(nsub=nsub, nchan=nchan, nbin=nbin,
                                       seed=90 + i)
        p = str(tmp_path / ("mh_%02d.npz" % i))
        save_archive(ar, p)
        paths.append(p)
    return paths


def _done_counts(jpath):
    counts = {}
    with open(jpath) as f:
        for line in f:
            try:
                e = json.loads(line)
            except ValueError:
                continue
            if isinstance(e, dict) and e.get("event") == "done":
                counts[e["path"]] = counts.get(e["path"], 0) + 1
    return counts


def _env(**extra):
    env = dict(os.environ, **extra)
    for var in ("ICLEAN_HOSTS", "ICLEAN_HOST_ID", "ICLEAN_FAULTS"):
        if var not in extra:
            env.pop(var, None)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    return env


# ---- units ----------------------------------------------------------------

def test_stable_shard_deterministic_and_in_range():
    for key in ("a", "bucket:16x32x32:0", "x" * 200):
        for n in (1, 2, 3, 7):
            s = stable_shard(key, n)
            assert 0 <= s < n and s == stable_shard(key, n)
    assert stable_shard("bucket:16x32x32:0", 2) != \
        stable_shard("bucket:12x32x32:0", 2)


def test_bucket_host_split_and_the_reference_agrees():
    h0 = bucket_host((*GEOM_H0, False), 2)
    h1 = bucket_host((*GEOM_H1, False), 2)
    assert {h0, h1} == {0, 1}
    assert bucket_work_key((*GEOM_H0, False)) == "bucket:16x32x32:0"
    assert bucket_work_key((*GEOM_H0, True)) == "bucket:16x32x32:1"
    rng = np.random.default_rng(5)
    for _ in range(200):
        key = (int(rng.integers(1, 4096)), int(rng.integers(1, 8192)),
               int(rng.integers(8, 4096)), bool(rng.integers(2)))
        assert bucket_work_key(key) == ref_bucket_work_key(key)
        for n in (1, 2, 3, 8):
            assert bucket_host(key, n) == ref_bucket_host(key, n)


def test_resolve_host_topology(monkeypatch):
    for var in ("ICLEAN_HOSTS", "ICLEAN_HOST_ID"):
        monkeypatch.delenv(var, raising=False)
    assert resolve_host_topology() == HostTopology(0, 1)
    assert resolve_host_topology(3, 2) == HostTopology(host_id=2, n_hosts=3)
    with pytest.raises(ValueError):
        resolve_host_topology(2, None)
    with pytest.raises(ValueError):
        resolve_host_topology(None, 1)
    with pytest.raises(ValueError):
        HostTopology(host_id=2, n_hosts=2)
    monkeypatch.setenv("ICLEAN_HOSTS", "4")
    monkeypatch.setenv("ICLEAN_HOST_ID", "3")
    assert resolve_host_topology() == HostTopology(host_id=3, n_hosts=4)
    assert resolve_host_topology(2, 0) == HostTopology(host_id=0, n_hosts=2)


def test_resolve_claim_ttl(monkeypatch):
    monkeypatch.delenv("ICLEAN_CLAIM_TTL", raising=False)
    assert resolve_claim_ttl() == 60.0 and resolve_claim_ttl(5.0) == 5.0
    monkeypatch.setenv("ICLEAN_CLAIM_TTL", "7.5")
    assert resolve_claim_ttl() == 7.5 and resolve_claim_ttl(5.0) == 5.0
    with pytest.raises(ValueError):
        resolve_claim_ttl(0.0)


def test_config_validates_host_knobs():
    CleanConfig(fleet_hosts=2, fleet_host_id=1, fleet_claim_ttl_s=1.0)
    for bad in (dict(fleet_hosts=0), dict(fleet_host_id=0),
                dict(fleet_hosts=2, fleet_host_id=2),
                dict(fleet_claim_ttl_s=0.0), dict(fleet_group_size=0),
                dict(fleet_retries=-1), dict(stage_timeout_s=-1.0),
                dict(fleet_bucket_pad=(0, -1)), dict(fleet_bucket_pad=(1,))):
        with pytest.raises(ValueError):
            CleanConfig(**bad)


def test_host_knobs_never_change_run_identity():
    """Placement, retries, the watchdog, the group size, the bucket grid
    and the build directory must not invalidate journals: a stolen
    bucket's done lines have to satisfy the original hash, and a resume
    with another --batch must skip what was done."""
    assert config_hash(CFG) == config_hash(CleanConfig(
        device="cpu", rotation="roll", max_iter=2, fleet_hosts=2,
        fleet_host_id=1, fleet_claim_ttl_s=3.0, fleet_retries=7,
        stage_timeout_s=9.0, fleet_group_size=3, fleet_bucket_pad=(8, 16),
        compile_cache_dir="kc"))


def test_multihost_requires_journal(tmp_path):
    paths = _write_fleet(tmp_path, n=1)
    with pytest.raises(ValueError, match="journal"):
        clean_fleet(paths, CFG, hosts=HostTopology(host_id=0, n_hosts=2))


@pytest.mark.parametrize("argv,needle", [
    (["--hosts", "2", "--host-id", "0"], "--fleet"),
    (["--fleet", "--hosts", "2", "--host-id", "0"], "journal"),
    (["--fleet", "--host-id", "1"], "--hosts"),
    (["--fleet", "--hosts", "0"], "--hosts"),
    (["--fleet", "--hosts", "2", "--host-id", "-1", "--journal", "j"],
     "--host-id"),
    (["--fleet", "--hosts", "2", "--host-id", "0", "--journal", "j",
      "--claim-ttl", "0"], "--claim-ttl"),
    (["--claim-ttl", "5"], "--fleet"),
])
def test_cli_host_flag_validation(monkeypatch, capsys, argv, needle):
    from iterative_cleaner_torch.cli import main

    for var in ("ICLEAN_HOSTS", "ICLEAN_HOST_ID", "ICLEAN_COORDINATOR"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(SystemExit) as ei:
        main(["--device", "cpu", *argv, "x.npz"])
    assert ei.value.code == 2
    assert needle in capsys.readouterr().err


# ---- drills ---------------------------------------------------------------

def _single_reference(paths):
    ref = clean_fleet(paths, CFG, registry=MetricsRegistry())
    assert not ref.failures and len(ref.results) == len(paths)
    return {p: ref.results[p].final_weights for p in paths}


def test_two_worker_threads_share_slice_exactly_once(tmp_path):
    """Two ``clean_fleet`` callers on one journal partition the work:
    every archive cleaned once, the other side skipping it as done, masks
    bit-equal to a single-host serve, slice counters from the journal."""
    paths = _write_fleet(tmp_path, n=4)
    want = _single_reference(paths)
    jpath = str(tmp_path / "j.jsonl")
    out = {}

    def host(hid):
        cfg = CleanConfig(device="cpu", rotation="roll", max_iter=2,
                          fleet_claim_ttl_s=5.0)
        out[hid] = clean_fleet(
            paths, cfg, hosts=HostTopology(host_id=hid, n_hosts=2),
            resilience=ResiliencePlan(journal=FleetJournal(jpath)),
            registry=MetricsRegistry())

    threads = [threading.Thread(target=host, args=(h,)) for h in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=PROC_TIMEOUT_S)
    assert sorted(out) == [0, 1], "a host thread died"
    for p in paths:
        n = (p in out[0].results) + (p in out[1].results)
        assert n == 1, (p, n)
        other = out[1] if p in out[0].results else out[0]
        assert p in other.skipped
        served = out[0] if p in out[0].results else out[1]
        np.testing.assert_array_equal(served.results[p].final_weights,
                                      want[p])
    assert _done_counts(jpath) == {os.path.abspath(p): 1 for p in paths}
    fullest = max((out[0], out[1]), key=lambda r: len(r.host_counters))
    assert set(fullest.host_counters) == {0, 1}
    assert sum(c.get("fleet_cleaned", 0)
               for c in fullest.host_counters.values()) == len(paths)


def test_one_survivor_drains_whole_slice(tmp_path):
    """Host 0 of 2 alone steals every foreign bucket and finishes."""
    paths = _write_fleet(tmp_path, n=4)
    want = _single_reference(paths)
    cfg = CleanConfig(device="cpu", rotation="roll", max_iter=2,
                      fleet_claim_ttl_s=2.0)
    rep = clean_fleet(
        paths, cfg, hosts=HostTopology(host_id=0, n_hosts=2),
        resilience=ResiliencePlan(
            journal=FleetJournal(str(tmp_path / "j.jsonl"))),
        registry=MetricsRegistry())
    assert len(rep.results) == len(paths) and not rep.failures
    assert rep.n_stolen >= 1
    for p in paths:
        np.testing.assert_array_equal(rep.results[p].final_weights, want[p])


def test_owner_done_between_the_reads_is_not_cleaned_twice(tmp_path):
    """Host 0, its own bucket served, reads the done lines and then the
    claim table for host 1's bucket.  Between the two reads host 1
    serves that bucket whole: done lines written, lease released.  Host
    0's claim then succeeds, and it must read the done lines again
    under it: every archive done exactly once, host 1's archives skipped
    by host 0."""
    paths = _write_fleet(tmp_path, n=4)
    jpath = str(tmp_path / "j.jsonl")
    cfg = CleanConfig(device="cpu", rotation="roll", max_iter=2,
                      fleet_claim_ttl_s=5.0)
    own0 = {os.path.abspath(p) for p in paths[0::2]}
    out = {}

    class PeerFinishesBetweenReads(FleetJournal):
        fired = False

        def claim_table(self, now=None):
            if not self.fired and own0 <= set(
                    self.completed(config_hash(cfg))):
                self.fired = True
                out[1] = clean_fleet(
                    paths, cfg, hosts=HostTopology(host_id=1, n_hosts=2),
                    resilience=ResiliencePlan(journal=FleetJournal(jpath)),
                    registry=MetricsRegistry())
            return super().claim_table(now=now)

    journal = PeerFinishesBetweenReads(jpath)
    out[0] = clean_fleet(
        paths, cfg, hosts=HostTopology(host_id=0, n_hosts=2),
        resilience=ResiliencePlan(journal=journal),
        registry=MetricsRegistry())
    assert journal.fired
    assert not out[0].failures and not out[1].failures
    assert sorted(out[0].results) == sorted(paths[0::2])
    assert sorted(out[1].results) == sorted(paths[1::2])
    assert set(paths[1::2]) <= set(out[0].skipped)
    assert _done_counts(jpath) == {os.path.abspath(p): 1 for p in paths}


def _cli_cmd(paths, metrics, extra):
    return [sys.executable, "-m", "iterative_cleaner_torch", "--device",
            "cpu", "-q", "-l", "--fleet", "--rotation", "roll",
            "--max_iter", "2", "--metrics-json", metrics] + extra + paths


def _read_outputs(paths, delete=True):
    out = {}
    for p in paths:
        op = p + "_cleaned.npz"
        ar = load_archive(op)
        out[p] = (ar.weights.copy(), ar.data.copy())
        if delete:
            os.unlink(op)
    return out


def test_two_process_cli_fleet_parity(tmp_path):
    """Two ``--hosts 2`` CLI processes over one journal write the outputs
    of a single ``--fleet`` process, each archive journaled once; each
    report has ``fleet_hosts`` 2, the local ``fleet_cleaned`` sum to the
    fleet, and the later finisher's slice gauge is the whole total."""
    paths = _write_fleet(tmp_path, n=4)
    subprocess.run(_cli_cmd(paths, str(tmp_path / "m_single.json"), []),
                   env=_env(), check=True, timeout=PROC_TIMEOUT_S,
                   stdout=subprocess.DEVNULL, cwd=str(tmp_path))
    want = _read_outputs(paths)
    jpath = str(tmp_path / "j.jsonl")
    procs = []
    for hid in (0, 1):
        m = str(tmp_path / ("m_h%d.json" % hid))
        cmd = _cli_cmd(paths, m, ["--journal", jpath, "--hosts", "2",
                                  "--host-id", str(hid), "--claim-ttl", "5"])
        procs.append((m, subprocess.Popen(
            cmd, env=_env(), cwd=str(tmp_path), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    try:
        for hid, (m, proc) in enumerate(procs):
            out, _ = proc.communicate(timeout=PROC_TIMEOUT_S)
            assert proc.returncode == 0, f"host {hid}:\n{out[-4000:]}"
    finally:
        for _m, proc in procs:
            if proc.poll() is None:
                proc.kill()
    got = _read_outputs(paths)
    for p in paths:
        np.testing.assert_array_equal(want[p][0], got[p][0])
        np.testing.assert_array_equal(want[p][1], got[p][1])
    assert _done_counts(jpath) == {os.path.abspath(p): 1 for p in paths}
    docs = [json.load(open(m)) for m, _proc in procs]
    assert all(d["gauges"]["fleet_hosts"] == 2 for d in docs)
    assert sum(d["counters"].get("fleet_cleaned", 0) for d in docs) \
        == len(paths)
    assert max(d["gauges"].get("fleet_cleaned_slice", 0) for d in docs) \
        == len(paths)


def test_kill_one_host_mid_serve_steals_without_duplicates(tmp_path):
    """Host 1 claims its bucket, wedges inside its clean (an injected
    hang) and is SIGKILLed holding the lease; host 0 steals the bucket
    once the lease expires: outputs equal to a single-process run, every
    archive done exactly once."""
    paths = _write_fleet(tmp_path, n=4)
    subprocess.run(_cli_cmd(paths, str(tmp_path / "m_single.json"), []),
                   env=_env(), check=True, timeout=PROC_TIMEOUT_S,
                   stdout=subprocess.DEVNULL, cwd=str(tmp_path))
    want = _read_outputs(paths)
    jpath = str(tmp_path / "j.jsonl")
    victim = subprocess.Popen(
        _cli_cmd(paths, str(tmp_path / "m_h1.json"),
                 ["--journal", jpath, "--hosts", "2", "--host-id", "1",
                  "--claim-ttl", "3"]),
        env=_env(ICLEAN_FAULTS="execute:hang@1", ICLEAN_FAULT_HANG_S="600"),
        cwd=str(tmp_path), stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)

    def victim_claimed():
        try:
            with open(jpath) as f:
                for line in f:
                    try:
                        e = json.loads(line)
                    except ValueError:
                        continue
                    if (isinstance(e, dict) and e.get("event") == "claim"
                            and e.get("host") == 1
                            and e.get("state") == "claim"):
                        return True
        except OSError:
            pass
        return False

    try:
        deadline = time.time() + PROC_TIMEOUT_S
        while not victim_claimed():
            assert victim.poll() is None, "victim exited before claiming"
            assert time.time() < deadline, "victim never claimed a bucket"
            time.sleep(0.25)
    finally:
        victim.send_signal(signal.SIGKILL)
        victim.wait(timeout=60)
    m_survivor = str(tmp_path / "m_h0.json")
    subprocess.run(
        _cli_cmd(paths, m_survivor, ["--journal", jpath, "--hosts", "2",
                                     "--host-id", "0", "--claim-ttl", "3"]),
        env=_env(), check=True, timeout=PROC_TIMEOUT_S,
        stdout=subprocess.DEVNULL, cwd=str(tmp_path))
    got = _read_outputs(paths)
    for p in paths:
        np.testing.assert_array_equal(want[p][0], got[p][0])
        np.testing.assert_array_equal(want[p][1], got[p][1])
    assert _done_counts(jpath) == {os.path.abspath(p): 1 for p in paths}
    assert json.load(open(m_survivor))["counters"]["fleet_stolen"] >= 1
