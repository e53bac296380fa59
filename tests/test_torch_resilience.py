"""The port's resilience ladder (``resilience/`` and its wiring in
``parallel/fleet.py``) on the CPU, as ``tests/test_resilience.py`` holds
the reference's: the fault injector (its probability draws equal to the
reference injector's), error classification (``torch.OutOfMemoryError``
by type, a failed allocation by message, a broken CUDA context as
permanent), retries and watchdog deadlines, the journal, atomic outputs,
a seeded fault soak (bit-equal masks, every archive exactly once), the
OOM ladder down to single archives (a single archive that still
exhausts the device fails with its OOM error: the port moves no clean
off the device, where the reference degrades to the numpy oracle; the
user's explicit ``--backend numpy`` rerun is the oracle's clean, bit for
bit), journaled resume in-process and after a real ``kill -9``, and the
CLI's flag contracts.  Every spawned
process has its own timeout."""

import dataclasses
import glob
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from iterative_cleaner_tpu.resilience import (
    FaultInjector as RefInjector,
    classify_error as ref_classify,
)
from iterative_cleaner_torch import CleanConfig
from iterative_cleaner_torch.backends import clean_archive
from iterative_cleaner_torch.io import (
    load_archive,
    make_synthetic_archive,
    save_archive,
)
from iterative_cleaner_torch.io.atomic import atomic_output
from iterative_cleaner_torch.parallel import batch as batch_mod
from iterative_cleaner_torch.parallel.fleet import clean_fleet
from iterative_cleaner_torch.resilience import (
    OOM,
    PERMANENT,
    TIMEOUT,
    TRANSIENT,
    FaultInjector,
    FaultSpecError,
    FleetJournal,
    InjectedFault,
    InjectedPermanentFault,
    ResiliencePlan,
    RetryPolicy,
    StageTimeout,
    SyntheticResourceExhausted,
    call_with_deadline,
    classify_error,
    entry_is_current,
    parse_fault_spec,
    resolve_retries,
    resolve_stage_timeout,
    run_with_retries,
)
from iterative_cleaner_torch.telemetry.registry import MetricsRegistry
from iterative_cleaner_torch.utils.checkpoint import config_hash

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = CleanConfig(device="cpu", rotation="roll", max_iter=3)
# a fast policy for tests that exercise retries
FAST = RetryPolicy(max_retries=3, backoff_base_s=0.001, backoff_cap_s=0.01)
CLI_TIMEOUT_S = 240


def _write_fleet(tmp_path, geometries, ext=".npz"):
    paths = []
    for i, (nsub, nchan, nbin) in enumerate(geometries):
        ar, _ = make_synthetic_archive(nsub=nsub, nchan=nchan, nbin=nbin,
                                       seed=40 + i)
        p = str(tmp_path / ("fleet_%02d%s" % (i, ext)))
        save_archive(ar, p)
        paths.append(p)
    return paths


def _env(**extra):
    env = dict(os.environ, **extra)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    return env


# ---- the fault spec and the injector -----------------------------------

def test_parse_fault_spec_grammar():
    rules = parse_fault_spec("load:0.1,exec:oom@2,write:once,compile:err,"
                             "peek:perm@3,execute:hang@1,intake:err@2,"
                             "sched:0.5")
    by = {(r.site, r.kind): r for r in rules}
    assert by[("load", "err")].prob == pytest.approx(0.1)
    assert by[("execute", "oom")].at == 2
    assert by[("write", "err")].at == 1
    assert by[("compile", "err")].at == 0
    assert by[("peek", "perm")].at == 3
    assert by[("execute", "hang")].at == 1
    assert by[("intake", "err")].at == 2
    assert by[("sched", "err")].prob == pytest.approx(0.5)
    assert parse_fault_spec("") == ()
    assert parse_fault_spec(" , ") == ()


@pytest.mark.parametrize("bad", [
    "load", "load:", "bogus:err", "load:maybe", "load:2.0", "load:0",
    "load:err@0", "load:err@x", "load:0.5@2",
])
def test_parse_fault_spec_rejects(bad):
    with pytest.raises(FaultSpecError):
        parse_fault_spec(bad)


def test_injector_at_n_fires_exactly_once():
    inj = FaultInjector("load:err@3", seed=0)
    inj.fire("load")
    inj.fire("load")
    with pytest.raises(InjectedFault):
        inj.fire("load")
    inj.fire("load")
    assert inj.calls["load"] == 4 and inj.injected["load"] == 1


def test_injector_kinds_and_counters():
    reg = MetricsRegistry()
    inj = FaultInjector("load:oom@1,write:perm@1,peek:hang@1",
                        seed=0, hang_s=0.01, registry=reg)
    with pytest.raises(SyntheticResourceExhausted) as ei:
        inj.fire("load")
    assert "RESOURCE_EXHAUSTED" in str(ei.value)
    assert classify_error(ei.value) == OOM
    with pytest.raises(InjectedPermanentFault):
        inj.fire("write")
    t0 = time.perf_counter()
    inj.fire("peek")
    assert time.perf_counter() - t0 >= 0.01
    assert reg.counters["fault_injected"] == 3


def test_injector_probability_draws_are_functional():
    """Same (seed, site, kind, call) -> same verdict, in either package:
    a drill replays the reference's faults exactly."""
    def verdicts(cls, seed):
        inj = cls("load:0.5", seed=seed)
        out = []
        for _ in range(64):
            try:
                inj.fire("load")
                out.append(False)
            except Exception:
                out.append(True)
        return out

    a = verdicts(FaultInjector, 7)
    assert a == verdicts(FaultInjector, 7) == verdicts(RefInjector, 7)
    assert any(a) and not all(a)
    assert verdicts(FaultInjector, 8) != a


def test_injector_from_env(monkeypatch):
    monkeypatch.delenv("ICLEAN_FAULTS", raising=False)
    assert FaultInjector.from_env() is None
    monkeypatch.setenv("ICLEAN_FAULTS", "load:err@1")
    monkeypatch.setenv("ICLEAN_FAULT_SEED", "9")
    inj = FaultInjector.from_env()
    assert inj is not None and inj.seed == 9
    assert ResiliencePlan.from_env(CFG).faults is not None


# ---- classification and retries -----------------------------------------

class _FakeOOM(torch.OutOfMemoryError):
    """A ``torch.OutOfMemoryError`` whose message does not name memory:
    the type alone must decide."""


@pytest.mark.parametrize("exc,kind", [
    (SyntheticResourceExhausted("RESOURCE_EXHAUSTED: injected"), OOM),
    (RuntimeError("RESOURCE_EXHAUSTED: Out of memory"), OOM),
    (RuntimeError("device out of memory"), OOM),
    (torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 "
                            "GiB"), OOM),
    (_FakeOOM("allocator refused"), OOM),
    # a kernel wrapper's failed allocation (_check_rc's message)
    (RuntimeError("cell_diagnostics_disp: CUDA error 2 (out of memory)"),
     OOM),
    # a broken context: a retry (or a halving) on it only fails again
    (RuntimeError("combine_zap: CUDA error 700 (an illegal memory access "
                  "was encountered)"), PERMANENT),
    (RuntimeError("CUDA error: unspecified launch failure"), PERMANENT),
    (RuntimeError("CUDA error: misaligned address"), PERMANENT),
    (RuntimeError("CUDA error: device-side assert triggered"), PERMANENT),
    (StageTimeout("t"), TIMEOUT),
    (ValueError("corrupt"), PERMANENT),
    (InjectedPermanentFault("x"), PERMANENT),
    (OSError("flaky fs"), TRANSIENT),
    (InjectedFault("x"), TRANSIENT),
])
def test_classify_error(exc, kind):
    assert classify_error(exc) == kind


@pytest.mark.parametrize("exc", [
    SyntheticResourceExhausted("RESOURCE_EXHAUSTED: x"),
    RuntimeError("device out of memory"), ValueError("corrupt"),
    OSError("flaky fs"), InjectedFault("x")])
def test_classify_error_agrees_with_the_reference(exc):
    """Where the reference classifies by message, the port agrees."""
    from iterative_cleaner_tpu.resilience import StageTimeout as RefTimeout

    assert classify_error(exc) == ref_classify(exc)
    assert classify_error(StageTimeout("t")) == ref_classify(RefTimeout("t"))


def test_retry_policy_backoff_bounded():
    pol = RetryPolicy(max_retries=5, backoff_base_s=0.05,
                      backoff_factor=2.0, backoff_cap_s=0.15)
    assert [pol.backoff(k) for k in range(4)] == \
        pytest.approx([0.05, 0.10, 0.15, 0.15])
    with pytest.raises(ValueError):
        RetryPolicy(max_retries=-1)
    with pytest.raises(ValueError):
        RetryPolicy(backoff_factor=0.5)


def test_run_with_retries_absorbs_transients():
    reg = MetricsRegistry()
    slept, calls = [], {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise OSError("transient")
        return "ok"

    out = run_with_retries(flaky, stage="load", policy=FAST, registry=reg,
                           sleep=slept.append)
    assert out == "ok" and calls["n"] == 3
    assert reg.counters["fleet_retries"] == 2
    assert slept == pytest.approx([FAST.backoff(0), FAST.backoff(1)])


@pytest.mark.parametrize("exc", [
    ValueError("corrupt"), SyntheticResourceExhausted("RESOURCE_EXHAUSTED"),
    torch.OutOfMemoryError("CUDA out of memory"),
    RuntimeError("CUDA error 700 (an illegal memory access was "
                 "encountered)")])
def test_run_with_retries_permanent_and_oom_propagate(exc):
    calls = {"n": 0}

    def once():
        calls["n"] += 1
        raise exc

    with pytest.raises(type(exc)):
        run_with_retries(once, stage="load", policy=FAST,
                         sleep=lambda s: None)
    assert calls["n"] == 1


def test_run_with_retries_budget_exhausts():
    calls = {"n": 0}

    def always():
        calls["n"] += 1
        raise OSError("transient")

    with pytest.raises(OSError):
        run_with_retries(always, stage="load",
                         policy=RetryPolicy(max_retries=2,
                                            backoff_base_s=0.0),
                         sleep=lambda s: None)
    assert calls["n"] == 3


def test_call_with_deadline():
    assert call_with_deadline(lambda: 5, None, "x") == 5
    assert call_with_deadline(lambda: 5, 0, "x") == 5
    reg = MetricsRegistry()
    with pytest.raises(StageTimeout):
        call_with_deadline(lambda: time.sleep(2.0), 0.05, "execute",
                           registry=reg)
    assert reg.counters["fleet_watchdog_trips"] == 1
    with pytest.raises(KeyError):
        call_with_deadline(lambda: {}[1], 1.0, "x")


def test_resolve_env_mirrors(monkeypatch):
    monkeypatch.delenv("ICLEAN_RETRIES", raising=False)
    monkeypatch.delenv("ICLEAN_STAGE_TIMEOUT", raising=False)
    assert resolve_retries() == 2 and resolve_retries(5) == 5
    assert resolve_stage_timeout() is None
    assert resolve_stage_timeout(0) is None
    assert resolve_stage_timeout(1.5) == 1.5
    monkeypatch.setenv("ICLEAN_RETRIES", "7")
    monkeypatch.setenv("ICLEAN_STAGE_TIMEOUT", "2.5")
    assert resolve_retries() == 7 and resolve_stage_timeout() == 2.5
    assert resolve_retries(1) == 1
    with pytest.raises(ValueError):
        resolve_retries(-1)
    with pytest.raises(ValueError):
        resolve_stage_timeout(-1.0)


# ---- the journal ---------------------------------------------------------

def test_journal_roundtrip_and_staleness(tmp_path):
    paths = _write_fleet(tmp_path, [(6, 16, 32), (8, 16, 32)])
    out = str(tmp_path / "out.npz")
    save_archive(load_archive(paths[0]), out)
    j = FleetJournal(str(tmp_path / "j.jsonl"))
    h = config_hash(CFG)
    j.record_done(paths[0], config_hash=h, out_path=out)
    j.record_done(paths[1], config_hash=h)
    done = j.completed(h)
    assert set(done) == {os.path.abspath(p) for p in paths}
    assert all(entry_is_current(e) for e in done.values())
    assert j.completed("feedbeef") == {}
    ar, _ = make_synthetic_archive(nsub=6, nchan=16, nbin=32, seed=99)
    save_archive(ar, paths[0])
    assert not entry_is_current(j.completed(h)[os.path.abspath(paths[0])])
    j.record_done(paths[0], config_hash=h, out_path=out)
    os.remove(out)
    assert not entry_is_current(j.completed(h)[os.path.abspath(paths[0])])


def test_journal_skips_torn_tail(tmp_path):
    paths = _write_fleet(tmp_path, [(6, 16, 32)])
    j = FleetJournal(str(tmp_path / "j.jsonl"))
    h = config_hash(CFG)
    j.record_done(paths[0], config_hash=h)
    with open(j.path, "a") as f:
        f.write('{"schema": "icln-fleet-journal/1", "event": "done", "pa')
    assert set(j.completed(h)) == {os.path.abspath(paths[0])}
    # the identity leaves the ladder's and the hosts' knobs out
    assert config_hash(dataclasses.replace(
        CFG, fleet_retries=9, stage_timeout_s=1.0, fleet_hosts=2,
        fleet_host_id=1, fleet_claim_ttl_s=3.0)) == h


def test_atomic_output_never_leaves_partials(tmp_path):
    path = str(tmp_path / "out.bin")
    with open(path, "wb") as f:
        f.write(b"old")
    with pytest.raises(RuntimeError):
        with atomic_output(path) as tmp:
            with open(tmp, "wb") as f:
                f.write(b"partial")
            raise RuntimeError("crash mid-write")
    assert open(path, "rb").read() == b"old"
    with atomic_output(path) as tmp:
        with open(tmp, "wb") as f:
            f.write(b"new")
    assert open(path, "rb").read() == b"new"
    assert glob.glob(str(tmp_path / "*.tmp")) == []
    ar, _ = make_synthetic_archive(nsub=4, nchan=8, nbin=16, seed=1)
    for ext in (".npz", ".icar", ".sf"):
        save_archive(ar, str(tmp_path / ("a" + ext)))
    assert glob.glob(str(tmp_path / "*.tmp")) == []


# ---- the ladder in the fleet ---------------------------------------------

def test_on_error_callback_exception_is_swallowed(tmp_path):
    paths = _write_fleet(tmp_path, [(6, 16, 32), (8, 16, 32)])
    reg = MetricsRegistry()

    def bad_callback(path, exc, stage):
        raise RuntimeError("broken telemetry hook")

    rep = clean_fleet(paths + [str(tmp_path / "missing.npz")], CFG,
                      registry=reg, io_workers=1, on_error=bad_callback,
                      resilience=ResiliencePlan(retry=FAST))
    assert len(rep.results) == 2 and len(rep.failures) == 1
    assert reg.counters["fleet_callback_errors"] == 1


def test_fault_soak_bit_equal_and_exactly_once(tmp_path):
    """12 mixed-geometry archives under faults at every site: the run
    ends inside a deadline, recovers every archive, accounts each path
    once, and every mask is bit-equal to the fault-free serve."""
    geoms = [(6 + 2 * (i % 3), 16, 32) for i in range(12)]
    paths = _write_fleet(tmp_path, geoms)
    base = clean_fleet(paths, CFG, io_workers=1, group_size=2)
    assert base.ok
    inj = FaultInjector(
        "peek:err@3,load:err@2,load:err@7,compile:err@1,"
        "execute:err@2,execute:oom@4,write:err@3", seed=0)
    reg = MetricsRegistry()
    plan = ResiliencePlan(faults=inj, retry=FAST,
                          journal=FleetJournal(str(tmp_path / "soak.jsonl")))
    wrote, lock = [], threading.Lock()

    def write_fn(path, ar, result):
        with lock:
            wrote.append(path)

    rep = call_with_deadline(
        lambda: clean_fleet(paths, CFG, registry=reg, io_workers=1,
                            group_size=2, resilience=plan,
                            write_fn=write_fn), 60.0, "soak")
    assert rep.ok, rep.failures
    assert sorted(rep.results) == sorted(paths)
    assert rep.skipped == [] and sorted(wrote) == sorted(paths)
    assert len(plan.journal.completed(config_hash(CFG))) == len(paths)
    assert reg.counters["fault_injected"] >= 6
    assert rep.n_retries >= 4 and rep.n_oom_splits >= 1
    # the compile fault sent one bucket inline
    assert reg.counters["fleet_precompile_misses"] >= 1
    for p in paths:
        np.testing.assert_array_equal(base.results[p].final_weights,
                                      rep.results[p].final_weights)


def test_oom_degrades_to_the_numpy_oracle_bit_equal(tmp_path):
    """Every execute OOMs: the ladder splits to singletons, the singleton
    still OOMs, and each archive fails in the clean stage with its OOM
    error — the fleet never cleans it on the host by itself (the
    reference's degrade rung).  Through the CLI the session exits 1 and
    names the rerun; the explicit ``--backend numpy`` rerun writes the
    float64 oracle's clean, bit for bit."""
    from iterative_cleaner_torch import backends

    paths = _write_fleet(tmp_path, [(6, 16, 32), (8, 16, 32), (6, 16, 32)])
    reg = MetricsRegistry()
    real = backends.clean_archive
    rep = clean_fleet(paths, CFG, registry=reg, io_workers=1, group_size=2,
                      resilience=ResiliencePlan(
                          faults=FaultInjector("execute:oom", seed=0),
                          retry=FAST))
    assert backends.clean_archive is real
    assert rep.results == {} and rep.n_oom_splits >= 1
    assert sorted(p for p, _s, _e in rep.failures) == sorted(paths)
    assert all(s == "clean" and isinstance(e, SyntheticResourceExhausted)
               for _p, s, e in rep.failures)
    assert reg.counters["fleet_failures"] == len(paths)
    name = os.path.basename(paths[0])
    r = _cli(["--fleet", "--rotation", "roll", "--max_iter", "3", "-q",
              "-l", "--faults", "execute:oom", name], tmp_path)
    assert r.returncode == 1
    assert "--backend numpy" in r.stderr, r.stderr[-2000:]
    assert not os.path.exists(paths[0] + "_cleaned.npz")
    r = _cli(["--backend", "numpy", "--rotation", "roll", "--max_iter", "3",
              "-q", "-l", name], tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    want = clean_archive(load_archive(paths[0]),
                         dataclasses.replace(CFG, backend="numpy"))
    np.testing.assert_array_equal(
        load_archive(paths[0] + "_cleaned.npz").weights, want.final_weights)


@pytest.mark.parametrize("error", [
    torch.OutOfMemoryError("CUDA out of memory (simulated)"),
    RuntimeError("scaled_sides: CUDA error 2 (out of memory)"),
], ids=["torch", "wrapper"])
def test_singleton_oom_fails_its_archive_alone(tmp_path, monkeypatch,
                                               error):
    """An OOM of every batch holding one particular archive: the group
    halves down to it, it fails in the clean stage with that error, and
    the others are cleaned bit-equal to their single cleans."""
    paths = _write_fleet(tmp_path, [(8, 16, 32)] * 4)
    heavy = load_archive(paths[2]).data
    real = batch_mod.clean_batch_share

    def capped(archives, *a, **kw):
        if any(np.array_equal(ar.data, heavy) for ar in archives):
            raise error
        return real(archives, *a, **kw)

    monkeypatch.setattr(batch_mod, "clean_batch_share", capped)
    reg = MetricsRegistry()
    rep = clean_fleet(paths, CFG, registry=reg, group_size=4)
    assert [(p, s) for p, s, _e in rep.failures] == [(paths[2], "clean")]
    assert rep.failures[0][2] is error
    assert reg.counters["fleet_oom_splits"] == 2     # 4 -> 2 + 2 -> 1 + 1
    for p in paths[:2] + paths[3:]:
        np.testing.assert_array_equal(
            rep.results[p].final_weights,
            clean_archive(load_archive(p), CFG).final_weights)


def test_torch_oom_halves_the_group_to_singles(tmp_path, monkeypatch):
    """A ``torch.OutOfMemoryError`` (the type the caching allocator
    raises) from any batch of more than two archives halves the group
    until it fits; results bit-equal to the single cleans, no degrade."""
    paths = _write_fleet(tmp_path, [(8, 16, 32)] * 6)
    real = batch_mod.clean_batch_share

    def capped(archives, *a, **kw):
        if len(archives) > 2:
            raise torch.OutOfMemoryError("CUDA out of memory (simulated)")
        return real(archives, *a, **kw)

    monkeypatch.setattr(batch_mod, "clean_batch_share", capped)
    reg = MetricsRegistry()
    rep = clean_fleet(paths, CFG, registry=reg, group_size=6)
    assert rep.ok
    assert reg.counters["fleet_oom_splits"] == 3     # 6 -> 3 + 3 -> 1+2 x2
    for p in paths:
        np.testing.assert_array_equal(
            rep.results[p].final_weights,
            clean_archive(load_archive(p), CFG).final_weights)


def test_broken_context_fails_without_retry_or_split(tmp_path, monkeypatch):
    """An illegal address leaves the CUDA context broken: the group's
    archives fail at once — no retry, no halving."""
    paths = _write_fleet(tmp_path, [(8, 16, 32)] * 4)
    calls = {"n": 0}

    def broken(archives, *a, **kw):
        calls["n"] += 1
        raise RuntimeError("combine_zap: CUDA error 700 (an illegal memory "
                           "access was encountered)")

    monkeypatch.setattr(batch_mod, "clean_batch_share", broken)
    reg = MetricsRegistry()
    rep = clean_fleet(paths, CFG, registry=reg, group_size=4,
                      resilience=ResiliencePlan(retry=FAST))
    assert calls["n"] == 1
    assert sorted(p for p, s, _e in rep.failures) == sorted(paths)
    assert all(s == "clean" for _p, s, _e in rep.failures)
    for k in ("fleet_retries", "fleet_oom_splits"):
        assert reg.counters.get(k, 0) == 0


def test_watchdog_fails_hung_execute(tmp_path):
    paths = _write_fleet(tmp_path, [(6, 16, 32), (6, 16, 32)])
    reg = MetricsRegistry()
    rep = clean_fleet(paths, CFG, registry=reg, io_workers=1, group_size=2,
                      resilience=ResiliencePlan(
                          faults=FaultInjector("execute:hang@1", seed=0,
                                               hang_s=1.5),
                          retry=FAST, stage_timeout_s=0.2))
    assert rep.n_watchdog_trips >= 1
    assert reg.counters["fleet_watchdog_trips"] >= 1
    assert {p for p, _s, _e in rep.failures} == set(paths)
    assert all(s == "clean" for _p, s, _e in rep.failures)
    assert isinstance(rep.failures[0][2], StageTimeout)


def test_write_failure_keeps_result_and_failure(tmp_path):
    paths = _write_fleet(tmp_path, [(6, 16, 32)])

    def write_fn(path, ar, result):
        raise InjectedPermanentFault("disk full")

    rep = clean_fleet(paths, CFG, io_workers=1,
                      resilience=ResiliencePlan(retry=FAST),
                      write_fn=write_fn)
    assert paths[0] in rep.results
    assert [(p, s) for p, s, _e in rep.failures] == [(paths[0], "write")]


def test_resume_skips_journaled_and_recleans_modified(tmp_path):
    paths = _write_fleet(tmp_path, [(6, 16, 32), (8, 16, 32), (6, 16, 32)])
    jpath = str(tmp_path / "j.jsonl")

    def out_path(p):
        return p + "_cleaned.npz"

    def write_fn(p, ar, result):
        save_archive(dataclasses.replace(
            ar, weights=np.asarray(result.final_weights,
                                   dtype=ar.weights.dtype)), out_path(p))

    def run(cfg=CFG, resume=True, registry=None):
        return clean_fleet(paths, cfg, registry=registry, io_workers=1,
                           group_size=2, resilience=ResiliencePlan(
                               retry=FAST, journal=FleetJournal(jpath),
                               resume=resume),
                           write_fn=write_fn, out_path_fn=out_path)

    rep1 = run(resume=False)
    assert rep1.ok and len(rep1.results) == 3
    reg = MetricsRegistry()
    rep2 = run(registry=reg)
    assert rep2.ok and rep2.results == {}
    assert sorted(rep2.skipped) == sorted(paths)
    assert reg.counters["fleet_resumed_skips"] == 3
    ar, _ = make_synthetic_archive(nsub=6, nchan=16, nbin=32, seed=77)
    save_archive(ar, paths[1])
    rep3 = run()
    assert rep3.ok and list(rep3.results) == [paths[1]]
    assert sorted(rep3.skipped) == sorted([paths[0], paths[2]])
    assert run(cfg=dataclasses.replace(CFG, max_iter=2)).skipped == []


# ---- the CLI and the kill -9 ----------------------------------------------

@pytest.mark.parametrize("argv", [
    ["--resume", "x.npz"], ["--retries", "3", "x.npz"],
    ["--stage-timeout", "5", "x.npz"], ["--faults", "load:once", "x.npz"],
    ["--journal", "j.jsonl", "x.npz"],
    ["--fleet", "--faults", "bogus:xyz", "x.npz"],
    ["--fleet", "--retries", "-1", "x.npz"],
    ["--fleet", "--stage-timeout", "-1", "x.npz"],
    ["--fleet", "--resume", "x.npz"],
])
def test_cli_resilience_flags_require_fleet(argv):
    from iterative_cleaner_torch.cli import main

    with pytest.raises(SystemExit) as ei:
        main(["--device", "cpu", *argv])
    assert ei.value.code == 2


def _cli(args, cwd, **env):
    return subprocess.run(
        [sys.executable, "-m", "iterative_cleaner_torch", "--device", "cpu",
         *args], env=_env(**env), cwd=str(cwd), capture_output=True,
        text=True, timeout=CLI_TIMEOUT_S)


def test_kill9_then_resume_no_duplicate_cleans(tmp_path):
    """Through the real CLI: wedge a journaled fleet with a hang fault,
    ``kill -9`` it, rerun with ``--resume``: each archive cleaned exactly
    once across the two runs, outputs byte-identical to an uninterrupted
    serve (``.icar`` holds no timestamps)."""
    geoms = [(6, 16, 32)] * 8
    ref_dir = tmp_path / "ref"
    ref_dir.mkdir()
    paths = _write_fleet(tmp_path, geoms, ext=".icar")
    ref_paths = _write_fleet(ref_dir, geoms, ext=".icar")
    base = ["--fleet", "--batch", "2", "--io-workers", "1", "--rotation",
            "roll", "--max_iter", "3", "-q", "-l"]
    r = _cli(base + [os.path.basename(p) for p in ref_paths], ref_dir)
    assert r.returncode == 0, r.stderr[-2000:]
    proc = subprocess.Popen(
        [sys.executable, "-m", "iterative_cleaner_torch", "--device", "cpu",
         *base, "--journal", "j.jsonl", "--faults", "load:hang@5",
         *[os.path.basename(p) for p in paths]],
        env=_env(ICLEAN_FAULT_HANG_S="600"), cwd=str(tmp_path),
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    jpath = tmp_path / "j.jsonl"
    deadline = time.time() + CLI_TIMEOUT_S
    try:
        while time.time() < deadline:
            text = jpath.read_text() if jpath.exists() else ""
            if text.endswith("\n") and len(text.strip().splitlines()) >= 4:
                break
            if proc.poll() is not None:
                pytest.fail("the wedged run exited early (rc %s)"
                            % proc.returncode)
            time.sleep(0.2)
        else:
            pytest.fail("the journal showed no progress before the deadline")
    finally:
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=60)
    pre = [json.loads(ln) for ln in jpath.read_text().strip().splitlines()
           if ln.strip()]
    assert len(pre) == 4
    r2 = _cli(base[:-2] + ["-l", "--journal", "j.jsonl", "--resume",
                           *[os.path.basename(p) for p in paths]], tmp_path)
    assert r2.returncode == 0, r2.stderr[-2000:]
    assert ("resumed: %d archive" % len(pre)) in r2.stdout, r2.stdout
    entries = [json.loads(ln)
               for ln in jpath.read_text().strip().splitlines() if ln.strip()]
    assert len(entries) == 8 and len({e["path"] for e in entries}) == 8
    for p, rp in zip(paths, ref_paths):
        with open(p + "_cleaned.icar", "rb") as a, \
                open(rp + "_cleaned.icar", "rb") as b:
            assert a.read() == b.read(), os.path.basename(p)
