"""The port's interleaving model checker (``iterative_cleaner_torch/
analysis/interleave.py``) over the port's own protocol code
(``resilience/journal.py``, ``serve/scheduler.py``,
``serve/membership.py``), held against the JAX package's checker over
the reference's code.

Soundness: every seeded bug — an in-memory revert of a known fix, over
both journal backends — is caught, with a minimized counterexample that
replays to the same failure.  Completeness in the small: every clean
scenario explores exhaustively and comes back green on both backends,
and the partial-order reduction prunes without losing a bug.  The
budget and ``max_schedules`` bounds hold.  Against the JAX package: the
same failure type per seeded bug, and the same schedule count per clean
scenario — the port's protocol code parks at the same step points as
the reference's (each journal append and fold, and the scenarios'
explicit steps around the scheduler and the clock), so the two
explorations walk the same tree.
"""

import threading

import pytest

from iterative_cleaner_torch.analysis.interleave import (
    BACKENDS,
    SCENARIOS,
    build_scenario,
    explore,
    render_counterexample,
    run_schedule,
    sweep,
)
from iterative_cleaner_tpu.analysis import interleave as ref

ALL_BUGS = [(name, bug, backend) for name in sorted(SCENARIOS)
            for bug in SCENARIOS[name] for backend in BACKENDS]
CLEAN = [(name, backend) for name in sorted(SCENARIOS)
         for backend in BACKENDS]


# ------------------------------------------------------------ soundness

@pytest.mark.parametrize("name,bug,backend", ALL_BUGS,
                         ids=[f"{n}--{b}--{k}" for n, b, k in ALL_BUGS])
def test_seeded_bug_is_caught_with_minimized_counterexample(name, bug,
                                                            backend):
    res = explore(build_scenario(name, bug=bug, backend=backend),
                  max_schedules=5000, budget_s=60.0)
    assert not res.ok, f"seeded bug {name}/{bug} escaped the checker"
    cx = res.counterexample
    assert cx is not None and cx.failure is not None
    # the minimized schedule must REPLAY to the same failure
    replay = run_schedule(build_scenario(name, bug=bug, backend=backend),
                          cx.choices)
    assert replay.failure is not None
    assert replay.failure["type"] == cx.failure["type"]
    # and render as a numbered, human-replayable trace
    text = render_counterexample(cx)
    assert "step" in text and "schedule=" in text
    # the JAX package's checker over the reference's code fails the same
    # way on the same seeded bug
    want = ref.explore(ref.build_scenario(name, bug=bug, backend=backend),
                       max_schedules=5000, budget_s=60.0)
    assert not want.ok
    assert want.counterexample.failure["type"] == cx.failure["type"]


@pytest.mark.parametrize("name,backend", CLEAN,
                         ids=[f"{n}--{k}" for n, k in CLEAN])
def test_clean_scenario_explores_exhaustively_green(name, backend):
    res = explore(build_scenario(name, backend=backend), max_schedules=5000,
                  budget_s=90.0)
    assert res.ok, res.render()
    assert not res.budget_exhausted, \
        f"{name} did not finish its exhaustive sweep: {res.render()}"
    assert res.schedules > 1  # a real exploration, not a single run
    # the same tree as the reference's exploration of its own code
    want = ref.explore(ref.build_scenario(name, backend=backend),
                       max_schedules=5000, budget_s=90.0)
    assert want.ok and not want.budget_exhausted
    assert res.schedules == want.schedules


def test_sweep_is_green_on_both_backends():
    results = sweep(max_schedules=5000, budget_s=120.0)
    assert len(results) == len(SCENARIOS) * len(BACKENDS)
    assert all(r.ok and not r.budget_exhausted for r in results), \
        [r.render() for r in results if not r.ok or r.budget_exhausted]
    assert {r.backend for r in results} == set(BACKENDS)


# ---------------------------------------------------------- determinism

def test_same_prefix_replays_the_same_schedule():
    scenario = build_scenario("claim-race")
    a = run_schedule(scenario, ())
    b = run_schedule(build_scenario("claim-race"), a.choices)
    assert a.choices == b.choices
    assert [d.op for d in a.decisions] == [d.op for d in b.decisions]


def test_random_mode_is_seed_deterministic():
    runs = []
    for _ in range(2):
        res = explore(build_scenario("admit-order", bug="admit-order"),
                      mode="random", seed=7, max_schedules=200,
                      budget_s=60.0)
        assert not res.ok
        runs.append(res.counterexample.choices)
    assert runs[0] == runs[1]


# -------------------------------------------------- POR: sound + smaller

@pytest.mark.parametrize("backend", BACKENDS)
def test_por_prunes_schedules_without_losing_the_race(backend):
    full = explore(build_scenario("claim-race", bug="no-readback",
                                  backend=backend),
                   por=False, max_schedules=5000, budget_s=60.0)
    pruned = explore(build_scenario("claim-race", bug="no-readback",
                                    backend=backend),
                     por=True, max_schedules=5000, budget_s=60.0)
    assert not full.ok and not pruned.ok  # both find the bug
    clean_full = explore(build_scenario("claim-race", backend=backend),
                         por=False, max_schedules=5000, budget_s=60.0)
    clean_pruned = explore(build_scenario("claim-race", backend=backend),
                           por=True, max_schedules=5000, budget_s=60.0)
    assert clean_full.ok and clean_pruned.ok
    assert clean_pruned.schedules < clean_full.schedules


# ------------------------------------------------------------- bounds

def test_budget_bounds_the_sweep():
    res = explore(build_scenario("pool-count"), max_schedules=5000,
                  budget_s=0.0)
    assert res.ok and res.budget_exhausted
    assert res.schedules <= 1


def test_max_schedules_bounds_the_sweep():
    res = explore(build_scenario("pool-count"), max_schedules=3,
                  budget_s=60.0)
    assert res.ok and res.budget_exhausted
    assert res.schedules == 3


def test_max_steps_aborts_a_runaway_schedule():
    res = run_schedule(build_scenario("eviction-edge"), max_steps=2)
    assert res.failure is not None
    assert "max_steps" in res.failure["message"]


def test_unknown_scenario_bug_and_backend_are_rejected():
    with pytest.raises(ValueError, match="unknown scenario"):
        build_scenario("nope")
    with pytest.raises(ValueError, match="no seeded bug"):
        build_scenario("claim-race", bug="admit-order")
    with pytest.raises(ValueError, match="unknown journal backend"):
        build_scenario("claim-race", backend="tape")


# ------------------------------------------------------- the CLI's gate

def test_race_sweep_cli_exits_0_and_writes_no_counterexample(tmp_path,
                                                              capsys):
    from iterative_cleaner_torch.analysis.cli import main

    out = tmp_path / "cx.txt"
    assert main(["--race-sweep", "--race-budget", "120", "--race-out",
                 str(out)]) == 0
    assert "explored exhaustively" in capsys.readouterr().out
    assert not out.exists()


def test_race_sweep_writes_the_counterexample_of_a_failure(tmp_path,
                                                           monkeypatch):
    """A failing sweep exits 1 and leaves the minimized schedule in
    ``--race-out``: the sweep is pointed at a seeded bug."""
    from iterative_cleaner_torch.analysis import cli, interleave

    def seeded_sweep(**kw):
        return [interleave.explore(
            interleave.build_scenario("admit-order", bug="admit-order"),
            max_schedules=200, budget_s=60.0)]

    monkeypatch.setattr(interleave, "sweep", seeded_sweep)
    out = tmp_path / "cx.txt"
    assert cli.run_race_sweep(out_path=str(out)) == 1
    text = out.read_text()
    assert "admit-order [bug=admit-order]: FAILED" in text
    assert "schedule=" in text


# ------------------------------------- the port's shared-state guards

def test_membership_join_stamps_throttle_under_the_lock(tmp_path):
    """join() publishes the throttle stamp atomically with _joined: an
    auto-beat thread racing join never sees a torn pair."""
    from iterative_cleaner_torch.resilience.journal import FleetJournal
    from iterative_cleaner_torch.serve.membership import PoolMembership

    j = FleetJournal(str(tmp_path / "j.jsonl"))
    m = PoolMembership(j, ttl_s=30.0, member_id="m1", host=1)
    m.join(now=100.0)
    assert m.heartbeat(now=100.0 + 30.0 / 3 - 0.01) is False  # throttled
    assert m.heartbeat(now=100.0 + 30.0 / 3 + 0.01) is True


def test_daemon_guards_its_cross_thread_maps_with_one_lock(tmp_path):
    """The HTTP handler threads and the worker loop share the daemon's
    maps; every write goes through the single leaf ``_state_lock``."""
    from iterative_cleaner_torch import CleanConfig
    from iterative_cleaner_torch.config import ServeConfig
    from iterative_cleaner_torch.serve.daemon import ServeDaemon

    cfg = ServeConfig(journal_path=str(tmp_path / "j.jsonl"),
                      http_port=0, flight_recorder="")
    d = ServeDaemon(cfg, CleanConfig(device="cpu", max_iter=2), quiet=True)
    assert isinstance(d._state_lock, type(threading.Lock()))
