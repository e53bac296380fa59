"""Deterministic interleaving model checker for the journal-lease protocol.

Unit tests exercise one interleaving — whichever the OS scheduler
happens to produce — and that is exactly how protocol races (the
admit-ordering duplicate-clean hazard, the pool-count leak) survive a
green suite.  This module runs the REAL
protocol code (``resilience/journal.py``, ``serve/membership.py``,
``serve/scheduler.py``) under a loom-style cooperative scheduler and
explores schedules systematically instead:

* Actor programs run on real threads, but every shared-state operation
  parks at an instrumented **step point** (:meth:`Env.step`;
  :class:`InstrumentedJournal` adds one automatically around every
  journal append and fold) and only proceeds when the controller
  schedules it.  Exactly one actor runs between step points, so a
  schedule — the sequence of actor choices — fully determines the
  execution, and any failing schedule replays exactly.
* :func:`explore` enumerates schedules depth-first (exhaustive for the
  2–3-actor scenarios here), with a lex-min partial-order reduction —
  two adjacent steps touching different resources (or both reading)
  commute, so only the canonical order of each commuting pair is
  explored — and a seeded bounded-random mode for depth beyond the
  exhaustive horizon.
* Invariants are machine-checked after every step and at quiescence:
  exactly one ``try_claim`` winner, fold determinism under compaction
  at any prefix, accepted-strictly-before-enqueue (via the journal
  fsck's request state machine), no terminal request pool-adoptable,
  member eviction edge-fires once per incarnation, tenant slots fully
  released.  A violation is minimized (greedy context-switch
  reduction, replayed each pass) and rendered as a numbered schedule.

Seeded-bug scenarios (:func:`build_scenario` with ``bug=...``) revert
known fixes in memory — the admit-ordering and pool-count fixes among
them — and the test suite asserts the checker catches every one;
the CI gate runs the clean variants and must come back green.

Every scenario is additionally parameterized over the journal
**backend** (``build_scenario(..., backend="segmented")`` /
``sweep(backends=...)``): the same actors, invariants and seeded bugs
run against a segmented journal directory with a few-hundred-byte seal
threshold, so schedules constantly cross seal and compaction boundaries
— the machine-checked form of the fold-equivalence contract the
segmented backend claims (resilience/segmented.py).
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import tempfile
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from iterative_cleaner_torch.resilience.journal import FleetJournal

#: journal backends every scenario can run against
BACKENDS = ("file", "segmented")

#: a few hundred bytes: segmented scenarios seal every couple of lines,
#: so every schedule crosses seal/compaction boundaries mid-protocol
_SEGMENT_MB = 0.0003

#: scenario name -> the seeded bugs build_scenario() accepts for it
SCENARIOS: Dict[str, Tuple[str, ...]] = {
    "claim-race": ("no-readback",),
    "admit-order": ("admit-order",),
    "pool-count": ("pool-count",),
    "eviction-edge": ("eviction-edge",),
    "compact-prefix": ("compact-last-claim",),
}

_STEP_TIMEOUT_S = 20.0  # watchdog: a step that parks nothing this long
#                         is a real deadlock/hang, not a slow machine


class InvariantViolation(AssertionError):
    """A protocol invariant failed under some schedule."""


class Hang(RuntimeError):
    """An actor neither parked nor finished within the watchdog — the
    schedule drove the real code into a deadlock or unbounded wait."""


class _Abort(BaseException):
    """Internal: unwind actor threads after a failure (never caught by
    scenario code — derives from BaseException on purpose)."""


@dataclasses.dataclass(frozen=True)
class Op:
    """One atomic step: what ``actor`` did between two park points."""

    actor: int
    resource: str
    kind: str          # "read" | "write"
    note: str = ""

    def render(self) -> str:
        return f"A{self.actor}  {self.resource}.{self.kind}" + (
            f"  {self.note}" if self.note else "")

    def independent(self, other: "Op") -> bool:
        """Two steps commute when they touch different resources or
        both only read — swapping them cannot change any outcome."""
        return (self.resource != other.resource
                or (self.kind == "read" and other.kind == "read"))


@dataclasses.dataclass
class Decision:
    """One scheduling decision: who ran, who else was ready, what each
    was about to do, and who was asleep (sleep-set POR bookkeeping)."""

    chosen: int
    enabled: Tuple[int, ...]
    pending: Dict[int, Op]
    sleep: Tuple[int, ...] = ()

    @property
    def op(self) -> Op:
        return self.pending[self.chosen]


class VirtualClock:
    """The scenario's time source: starts at the real ``time.time()``
    (journal compaction internally stamps with real time, so virtual
    stamps must live in the same epoch) and only moves when a scenario
    actor advances it — lease expiry becomes a deterministic, schedulable
    event instead of a sleep."""

    def __init__(self) -> None:
        self._base = time.time()
        self._offset = 0.0

    def now(self) -> float:
        return self._base + self._offset

    def advance(self, dt: float) -> None:
        self._offset += float(dt)


class Env:
    """Everything a scenario shares: the virtual clock, the journal
    (instrumented — its appends and folds are step points), a scratch
    dict for results, and :meth:`step` for explicit step points around
    in-memory operations (scheduler calls, clock advances)."""

    def __init__(self, controller: "_Controller", path: str,
                 tmpdir: str, backend: str = "file") -> None:
        self._controller = controller
        self.path = path
        self.tmpdir = tmpdir
        self.backend = backend
        #: how to build a journal over ``path`` with this backend —
        #: scenarios that substitute their own journal subclass reuse it
        self.journal_kwargs: Dict[str, object] = (
            {"backend": "segmented", "segment_mb": _SEGMENT_MB}
            if backend == "segmented" else {})
        self.clock = VirtualClock()
        self.journal = InstrumentedJournal(path, **self.journal_kwargs)
        self.journal._env = self
        self.data: Dict[str, object] = {}

    def step(self, resource: str, kind: str, note: str = "") -> None:
        self._controller.park(Op(self._controller.current_actor(),
                                 resource, kind, note))

    def plain_journal(self) -> FleetJournal:
        """An UNinstrumented journal over the same file — invariant
        checks read through this so they never generate steps."""
        return FleetJournal(self.path)


class InstrumentedJournal(FleetJournal):
    """The real journal with a step point before every append and every
    fold-producing read.  ``try_claim`` therefore decomposes into its
    true atomic parts — the flock'd append and the separate read-back —
    and the checker explores interleavings between them, which is
    exactly where the one-winner guarantee has to hold."""

    _env: Optional[Env] = None

    def _step(self, kind: str, note: str) -> None:
        if self._env is not None:
            self._env.step("journal", kind, note)

    def _append(self, entry: dict) -> None:
        note = entry.get("event", "?")
        if entry.get("event") == "req":
            note = f"req:{entry.get('state')}:{entry.get('req')}"
        elif entry.get("event") == "claim":
            note = f"claim:{entry.get('state')}:{entry.get('work')}"
        elif entry.get("event") == "member":
            note = f"member:{entry.get('state')}:{entry.get('member')}"
        self._step("write", note)
        FleetJournal._append(self, entry)

    def request_states(self):
        self._step("read", "fold:req")
        return FleetJournal.request_states(self)

    def claim_table(self, now=None):
        self._step("read", "fold:claim")
        return FleetJournal.claim_table(self, now=now)

    def member_table(self, now=None):
        self._step("read", "fold:member")
        return FleetJournal.member_table(self, now=now)

    def completed(self, config_hash):
        self._step("read", "fold:done")
        return FleetJournal.completed(self, config_hash)

    def cache_index(self):
        self._step("read", "fold:cache")
        return FleetJournal.cache_index(self)

    def compact(self):
        self._step("write", "compact")
        return FleetJournal.compact(self)


@dataclasses.dataclass
class Scenario:
    """One checkable protocol drill: ``setup`` builds the shared
    objects onto the env, each actor is a callable ``(env, actor_id)``
    run as one cooperative thread, and the invariants raise
    :class:`InvariantViolation`."""

    name: str
    actors: Sequence[Callable[[Env, int], None]]
    setup: Optional[Callable[[Env], None]] = None
    invariant_step: Optional[Callable[[Env], None]] = None
    invariant_final: Optional[Callable[[Env], None]] = None
    bug: Optional[str] = None
    backend: str = "file"


@dataclasses.dataclass
class RunResult:
    choices: Tuple[int, ...]
    decisions: List[Decision]
    failure: Optional[dict] = None   # {"type", "message", "step"}
    redundant: bool = False          # aborted: only sleeping actors left

    @property
    def ok(self) -> bool:
        return self.failure is None

    def context_switches(self) -> int:
        return sum(1 for a, b in zip(self.choices, self.choices[1:])
                   if a != b)


class _Controller:
    """Runs ONE schedule: actors park at step points, the controller
    releases exactly one at a time (replaying a choice prefix, then
    following a deterministic or seeded-random policy)."""

    def __init__(self, scenario: Scenario, *,
                 prefix: Sequence[int] = (),
                 sleep0: Sequence[int] = (),
                 rng=None, max_steps: int = 400) -> None:
        self.scenario = scenario
        self.prefix = tuple(prefix)
        self.sleep0 = frozenset(sleep0)
        self.rng = rng
        self.max_steps = max_steps
        self._lock = threading.Condition()
        self._pending: Dict[int, Op] = {}
        self._resume: Set[int] = set()
        self._finished: Set[int] = set()
        self._errors: Dict[int, BaseException] = {}
        self._abort = False
        self._local = threading.local()

    # ---------------------------------------------------- actor side
    def current_actor(self) -> int:
        return self._local.actor_id

    def park(self, op: Op) -> None:
        with self._lock:
            self._pending[op.actor] = op
            self._lock.notify_all()
            while op.actor not in self._resume and not self._abort:
                self._lock.wait(1.0)
            self._resume.discard(op.actor)
            if self._abort:
                raise _Abort()

    def _actor_main(self, aid: int,
                    fn: Callable[[Env, int], None], env: Env) -> None:
        self._local.actor_id = aid
        try:
            # every actor parks before its first instruction, so the
            # schedule controls program-start order too
            self.park(Op(aid, f"start:{aid}", "read", "start"))
            fn(env, aid)
        except _Abort:
            pass
        # icln: ignore[broad-except] -- recorded in _errors, rethrown by the controller as the schedule's failure
        except BaseException as exc:
            with self._lock:
                self._errors[aid] = exc
        finally:
            with self._lock:
                self._finished.add(aid)
                self._pending.pop(aid, None)
                self._lock.notify_all()

    # ----------------------------------------------- controller side
    def run(self, tmpdir: str) -> RunResult:
        backend = self.scenario.backend
        path = os.path.join(tmpdir, "journal.d" if backend == "segmented"
                            else "journal.jsonl")
        env = Env(self, path, tmpdir, backend=backend)
        if self.scenario.setup is not None:
            self.scenario.setup(env)
        threads = []
        n = len(self.scenario.actors)
        for aid, fn in enumerate(self.scenario.actors):
            t = threading.Thread(target=self._actor_main,
                                 args=(aid, fn, env),
                                 name=f"icln-race-a{aid}", daemon=True)
            threads.append(t)
            t.start()
        choices: List[int] = []
        decisions: List[Decision] = []
        failure: Optional[dict] = None
        redundant = False
        # sleep-set POR state: actors whose scheduling here would only
        # replay an already-explored commuting order.  Active beyond the
        # replayed prefix; an executed op WAKES every sleeper whose
        # pending op depends on it (the orders stopped commuting).
        sleep: Set[int] = set(self.sleep0)
        try:
            while True:
                with self._lock:
                    deadline = time.monotonic() + _STEP_TIMEOUT_S
                    while True:
                        live = set(range(n)) - self._finished
                        if self._errors:
                            raise next(iter(self._errors.values()))
                        if not live:
                            break
                        if live <= set(self._pending):
                            break
                        if time.monotonic() > deadline:
                            raise Hang(
                                f"actors {sorted(live - set(self._pending))} "
                                f"neither parked nor finished within "
                                f"{_STEP_TIMEOUT_S:g}s — the schedule "
                                f"{tuple(choices)} wedged the real code")
                        self._lock.wait(0.2)
                    if not live:
                        break
                    enabled = tuple(sorted(self._pending))
                    i = len(choices)
                    in_prefix = i < len(self.prefix)
                    if in_prefix:
                        chosen = self.prefix[i]
                        if chosen not in enabled:
                            raise Hang(
                                f"replay diverged: prefix chose A{chosen} "
                                f"at step {i} but enabled={enabled}")
                    else:
                        sleep &= set(enabled)
                        eligible = tuple(a for a in enabled
                                         if a not in sleep)
                        if not eligible:
                            # every enabled actor is asleep: this whole
                            # subtree re-explores commuting orders only
                            redundant = True
                            break
                        if self.rng is not None:
                            chosen = self.rng.choice(eligible)
                        else:
                            chosen = eligible[0]
                    decisions.append(Decision(
                        chosen, enabled, dict(self._pending),
                        sleep=() if in_prefix else tuple(sorted(sleep))))
                    choices.append(chosen)
                    if len(choices) > self.max_steps:
                        raise Hang(
                            f"schedule exceeded max_steps={self.max_steps} "
                            f"without quiescing")
                    if not in_prefix:
                        executed = decisions[-1].op
                        sleep = {b for b in sleep
                                 if b in self._pending and b != chosen
                                 and self._pending[b].independent(executed)}
                    self._pending.pop(chosen)
                    self._resume.add(chosen)
                    self._lock.notify_all()
                # out of the lock: let the chosen actor run to its next
                # park point, then re-check invariants on the new state
                if self.scenario.invariant_step is not None:
                    self._await_parked(chosen)
                    self.scenario.invariant_step(env)
            if not redundant and self.scenario.invariant_final is not None:
                self.scenario.invariant_final(env)
        except InvariantViolation as exc:
            failure = {"type": "invariant", "message": str(exc),
                       "step": len(choices)}
        except Hang as exc:
            failure = {"type": "hang", "message": str(exc),
                       "step": len(choices)}
        except BaseException as exc:  # noqa: BLE001 - reported as failure
            failure = {"type": type(exc).__name__, "message": str(exc),
                       "step": len(choices)}
        finally:
            with self._lock:
                self._abort = True
                self._lock.notify_all()
            for t in threads:
                t.join(timeout=2.0)
        return RunResult(tuple(choices), decisions, failure,
                         redundant=redundant)

    def _await_parked(self, aid: int) -> None:
        """Wait until ``aid`` parked again or finished, so a step
        invariant observes the state AFTER its op, not mid-flight."""
        deadline = time.monotonic() + _STEP_TIMEOUT_S
        with self._lock:
            while (aid not in self._pending
                    and aid not in self._finished):
                if self._errors.get(aid) is not None:
                    return
                if time.monotonic() > deadline:
                    raise Hang(f"A{aid} never re-parked after its step")
                self._lock.wait(0.2)


def run_schedule(scenario: Scenario, prefix: Sequence[int] = (), *,
                 sleep0: Sequence[int] = (), rng=None,
                 max_steps: int = 400) -> RunResult:
    """Execute one schedule (replay ``prefix``, then lex-min policy
    among non-sleeping actors — or seeded-random when ``rng`` is given)
    in a fresh temp journal."""
    tmpdir = tempfile.mkdtemp(prefix="icln-race-")
    try:
        return _Controller(scenario, prefix=prefix, sleep0=sleep0,
                           rng=rng, max_steps=max_steps).run(tmpdir)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)


@dataclasses.dataclass
class ExploreResult:
    scenario: str
    bug: Optional[str]
    ok: bool
    schedules: int
    elapsed_s: float
    budget_exhausted: bool = False
    counterexample: Optional[RunResult] = None
    backend: str = "file"

    def render(self) -> str:
        plural = "" if self.schedules == 1 else "s"
        head = (f"{self.scenario}"
                + (f" [bug={self.bug}]" if self.bug else "")
                + (f" [backend={self.backend}]"
                   if self.backend != "file" else "")
                + f": {'ok' if self.ok else 'FAILED'}, "
                + f"{self.schedules} schedule{plural} "
                + f"in {self.elapsed_s:.2f}s"
                + (" (budget exhausted)" if self.budget_exhausted else ""))
        if self.counterexample is None:
            return head
        return head + "\n" + render_counterexample(self.counterexample)


def render_counterexample(res: RunResult) -> str:
    """The minimized failing schedule, numbered step by step — the
    artifact CI uploads and a human replays."""
    out = [f"counterexample: {len(res.choices)} steps, "
           f"{res.context_switches()} context switches, "
           f"schedule={list(res.choices)}"]
    for i, d in enumerate(res.decisions, start=1):
        out.append(f"  step {i:3d}: {d.op.render()}")
    if res.failure is not None:
        out.append(f"  -> {res.failure['type']}: {res.failure['message']}")
    return "\n".join(out)


def minimize(scenario: Scenario, res: RunResult, *,
             max_steps: int = 400, max_passes: int = 8) -> RunResult:
    """Greedy context-switch reduction: repeatedly try extending the
    previous actor's block by one step (replaying the candidate prefix);
    keep any variant that still fails with fewer switches.  Bounded and
    deterministic — a smaller schedule is a nicer artifact, not a
    soundness requirement."""
    best = res
    for _pass in range(max_passes):
        improved = False
        for i in range(1, len(best.choices)):
            if best.choices[i] == best.choices[i - 1]:
                continue
            cand = best.choices[:i] + (best.choices[i - 1],)
            trial = run_schedule(scenario, cand, max_steps=max_steps)
            # the SAME failure must reproduce — a replay divergence or
            # an unrelated error is not a smaller counterexample
            if (trial.failure is not None
                    and trial.failure["type"] == res.failure["type"]
                    and trial.context_switches() < best.context_switches()):
                best = trial
                improved = True
                break
        if not improved:
            break
    return best


def explore(scenario: Scenario, *, mode: str = "dfs",
            max_schedules: int = 2000, max_steps: int = 400,
            seed: int = 0, budget_s: float = 60.0,
            por: bool = True) -> ExploreResult:
    """Explore schedules until a failure, exhaustion (DFS), or budget.

    DFS is stateless-model-checking style: run a schedule to the end,
    then branch on every decision point where another actor was enabled
    (minus POR-pruned branches); the prefix replays deterministically
    because the scenario code is deterministic.  ``mode="random"``
    draws ``max_schedules`` seeded-random schedules instead — the
    depth-beyond-exhaustion mode."""
    t0 = time.monotonic()
    schedules = 0
    budget_exhausted = False

    def out_of_budget() -> bool:
        return (time.monotonic() - t0) > budget_s

    if mode == "random":
        import random

        rng = random.Random(seed)
        seen: Set[Tuple[int, ...]] = set()
        while schedules < max_schedules:
            if out_of_budget():
                budget_exhausted = True
                break
            res = run_schedule(scenario, rng=rng, max_steps=max_steps)
            schedules += 1
            if res.choices in seen:
                continue
            seen.add(res.choices)
            if res.failure is not None:
                res = minimize(scenario, res, max_steps=max_steps)
                return ExploreResult(scenario.name, scenario.bug, False,
                                     schedules,
                                     time.monotonic() - t0,
                                     counterexample=res,
                                     backend=scenario.backend)
        return ExploreResult(scenario.name, scenario.bug, True, schedules,
                             time.monotonic() - t0,
                             budget_exhausted=budget_exhausted,
                             backend=scenario.backend)

    if mode != "dfs":
        raise ValueError(f"unknown mode {mode!r}")
    # stack of (choice prefix, sleep set in force after that prefix);
    # the sleep set (Godefroid-style) holds actors whose next op
    # commutes with every already-explored alternative at the branch
    # node — scheduling them would re-explore the same Mazurkiewicz
    # trace, so the run prunes the subtree (redundant abort)
    stack: List[Tuple[Tuple[int, ...], frozenset]] = [((), frozenset())]
    visited: Set[Tuple[int, ...]] = set()
    while stack and schedules < max_schedules:
        if out_of_budget():
            budget_exhausted = True
            break
        prefix, sleep0 = stack.pop()
        res = run_schedule(scenario, prefix,
                           sleep0=sleep0 if por else (),
                           max_steps=max_steps)
        schedules += 1
        if res.failure is not None:
            res = minimize(scenario, res, max_steps=max_steps)
            return ExploreResult(scenario.name, scenario.bug, False,
                                 schedules, time.monotonic() - t0,
                                 counterexample=res,
                                 backend=scenario.backend)
        for i in range(len(prefix), len(res.decisions)):
            d = res.decisions[i]
            explored = [d.chosen]
            for alt in d.enabled:
                if alt == d.chosen or (por and alt in d.sleep):
                    continue
                branch = res.choices[:i] + (alt,)
                if branch in visited:
                    explored.append(alt)
                    continue
                visited.add(branch)
                if por:
                    # siblings explored before `alt` at this node (and
                    # inherited sleepers) stay asleep in the new branch
                    # iff their op commutes with alt's — dependence
                    # means the orders genuinely differ, so they wake
                    alt_op = d.pending[alt]
                    new_sleep = frozenset(
                        b for b in set(d.sleep) | set(explored)
                        if b in d.pending
                        and d.pending[b].independent(alt_op))
                else:
                    new_sleep = frozenset()
                stack.append((branch, new_sleep))
                explored.append(alt)
    else:
        if stack:
            budget_exhausted = True
    return ExploreResult(scenario.name, scenario.bug, True, schedules,
                         time.monotonic() - t0,
                         budget_exhausted=budget_exhausted,
                         backend=scenario.backend)


# --------------------------------------------------------------------------
# scenarios: the protocol drills and their seeded bugs
# --------------------------------------------------------------------------

def _fsck_step(env: Env) -> None:
    """Every prefix of the journal must satisfy the fsck state machine
    — 'accepted' strictly precedes 'running'/'done' in FILE order, no
    line after terminal, leases monotone.  This is the live bridge
    between the model checker and ``--journal-fsck`` (which handles
    segment directories natively, manifest and shard routing included)."""
    from iterative_cleaner_torch.analysis.journal_fsck import fsck_journal

    if not os.path.exists(env.path):
        return
    report = fsck_journal(env.path)
    if report.errors:
        raise InvariantViolation(
            "journal fsck failed mid-schedule: "
            + report.errors[0].render())


def _scenario_claim_race(bug: Optional[str]) -> Scenario:
    """Two actors race ``try_claim`` for the same work item: the flock'd
    append order must yield EXACTLY one winner under every interleaving
    of the append and read-back halves."""

    def setup(env: Env) -> None:
        env.data["won"] = {}

    def contender(env: Env, aid: int) -> None:
        if bug == "no-readback":
            # seeded bug: trust the append alone — "my line landed, so
            # the work is mine" — skipping the fold read-back that
            # makes the loser notice it lost
            env.journal.record_claim("w0", host=aid, nonce=f"n{aid}",
                                     ttl_s=1000.0, now=env.clock.now())
            env.data["won"][aid] = True
        else:
            env.data["won"][aid] = env.journal.try_claim(
                "w0", host=aid, nonce=f"n{aid}", ttl_s=1000.0,
                now=env.clock.now())

    def final(env: Env) -> None:
        winners = sorted(a for a, w in env.data["won"].items() if w)
        if len(winners) != 1:
            raise InvariantViolation(
                f"exactly-one-winner violated: winners={winners} "
                f"(each actor's try_claim verdict for the same work)")
        own = env.plain_journal().claim_table(
            now=env.clock.now()).get("w0")
        if own is None or own["nonce"] != f"n{winners[0]}":
            raise InvariantViolation(
                f"fold owner {own and own['nonce']!r} disagrees with "
                f"the try_claim winner n{winners[0]}")

    return Scenario("claim-race", [contender, contender], setup=setup,
                    invariant_step=_fsck_step, invariant_final=final,
                    bug=bug)


def _scenario_admit_order(bug: Optional[str]) -> Scenario:
    """The admit-ordering fix, as a machine-checked property: the
    acceptor journals 'accepted' strictly BEFORE the request becomes
    poppable.  The seeded bug re-orders enqueue before the append —
    a fast worker (result-cache hit) then journals 'running'/'done'
    first, the fold reads the finished request as non-terminal forever,
    and a pool peer would adopt and duplicate-clean it."""
    from iterative_cleaner_torch.serve.request import ServeRequest
    from iterative_cleaner_torch.serve.scheduler import ServeScheduler

    def setup(env: Env) -> None:
        env.data["sched"] = ServeScheduler(queue_limit=8, max_inflight=4)
        env.data["executed"] = []

    def acceptor(env: Env, aid: int) -> None:
        sched: ServeScheduler = env.data["sched"]
        req = ServeRequest(request_id="r0", paths=["/x.npz"])
        env.step("sched", "write", "slot:r0")
        sched.submit(req, enqueue=False)
        if bug == "admit-order":
            # seeded bug (the fix reverted): feed the worker queue before
            # the 'accepted' line lands
            env.step("sched", "write", "enqueue:r0")
            sched.enqueue_admitted(req)
            env.journal.record_request("r0", "accepted",
                                       paths=list(req.paths))
        else:
            env.journal.record_request("r0", "accepted",
                                       paths=list(req.paths))
            env.step("sched", "write", "enqueue:r0")
            sched.enqueue_admitted(req)

    def worker(env: Env, aid: int) -> None:
        sched: ServeScheduler = env.data["sched"]
        for _ in range(4):
            env.step("sched", "read", "pop")
            req, _expired = sched.pop(timeout=0)
            if req is None:
                continue
            env.journal.record_request(req.request_id, "running")
            # the "execution" is a result-cache hit: terminal in
            # microseconds — the racy-fast path of the real hazard
            env.journal.record_request(req.request_id, "done")
            env.step("sched", "write", "mark_done")
            sched.mark_done(req)
            env.data["executed"].append(req.request_id)
            return

    def final(env: Env) -> None:
        states = env.plain_journal().request_states()
        for rid in env.data["executed"]:
            state = (states.get(rid) or {}).get("state")
            if state not in ("done", "failed"):
                raise InvariantViolation(
                    f"executed request {rid!r} folds non-terminal "
                    f"({state!r}): it reads as unfinished forever and "
                    f"a pool peer would adopt it — duplicate clean")

    return Scenario("admit-order", [acceptor, worker], setup=setup,
                    invariant_step=_fsck_step, invariant_final=final,
                    bug=bug)


def _scenario_pool_count(bug: Optional[str]) -> Scenario:
    """The pool-count fix: admission may CHECK the pool-wide
    tenant view, but the stored in-flight counter stays strictly local
    — it only ever decrements on local mark_done, so folding the pool
    count in inflates it permanently.  Two members admit+finish one
    request each for the same tenant; afterwards every slot must be
    released on both."""
    from iterative_cleaner_torch.serve.request import ServeRequest
    from iterative_cleaner_torch.serve.scheduler import ServeScheduler

    def make_sched(env: Env) -> ServeScheduler:
        plain = env.plain_journal()

        def pool_view(tenant: str) -> int:
            from iterative_cleaner_torch.resilience.journal import (
                REQUEST_TERMINAL,
            )

            states = plain.request_states()
            return sum(1 for v in states.values()
                       if v.get("state") not in REQUEST_TERMINAL
                       and (v.get("tenant") or "default") == tenant)

        sched = ServeScheduler(queue_limit=8, max_inflight=4,
                               pool_inflight=pool_view)
        if bug == "pool-count":
            # seeded bug (the fix reverted): store the pool-wide EFFECTIVE
            # count (max of local and the journal fold, plus this
            # request) into the local counter at admission — but only
            # local mark_done ever decrements it, so any pool overlap
            # at admission time leaks a slot forever
            real_submit = sched.submit

            def leaky_submit(req, already_journaled=False, enqueue=True):
                with sched._lock:
                    local = sched._inflight.get(req.tenant, 0)
                pool = int(pool_view(req.tenant))
                real_submit(req, already_journaled=already_journaled,
                            enqueue=enqueue)
                with sched._lock:
                    sched._inflight[req.tenant] = max(local, pool) + 1
            sched.submit = leaky_submit
        return sched

    def setup(env: Env) -> None:
        env.data["scheds"] = {}

    def member(env: Env, aid: int) -> None:
        sched = make_sched(env)
        env.data["scheds"][aid] = sched
        rid = f"r{aid}"
        req = ServeRequest(request_id=rid, paths=[f"/{rid}.npz"],
                           tenant="t")
        # the daemon's admission order: slot (checking the pool fold),
        # then the 'accepted' line, then the worker queue.  Each member
        # owns a PRIVATE scheduler (resource "sched:<aid>") — only the
        # journal is shared, and POR knows it
        env.step("journal", "read", "fold:req")
        env.step(f"sched:{aid}", "write", f"slot:{rid}")
        sched.submit(req, enqueue=False)
        env.journal.record_request(rid, "accepted", tenant="t",
                                   paths=list(req.paths))
        sched.enqueue_admitted(req)
        got, _expired = sched.pop(timeout=0)
        if got is not None:
            env.journal.record_request(got.request_id, "running")
            env.journal.record_request(got.request_id, "done")
            env.step(f"sched:{aid}", "write", "mark_done")
            sched.mark_done(got)

    def final(env: Env) -> None:
        for aid, sched in sorted(env.data["scheds"].items()):
            with sched._lock:
                leaked = dict(sched._inflight)
            if leaked:
                raise InvariantViolation(
                    f"member {aid}: tenant in-flight slots leaked after "
                    f"every local mark_done: {leaked} — admission will "
                    f"throw spurious tenant_limit 429s forever")

    return Scenario("pool-count", [member, member], setup=setup,
                    invariant_step=_fsck_step, invariant_final=final,
                    bug=bug)


def _scenario_eviction_edge(bug: Optional[str]) -> Scenario:
    """Member eviction must edge-fire once per incarnation: the watcher
    counts a lapsed member the FIRST time it observes the lapse, and
    repeat scans stay silent.  The seeded bug reverts the edge detector
    (every scan re-reports, inflating ``serve_members_evicted`` and
    re-triggering steal logic)."""
    from iterative_cleaner_torch.serve.membership import PoolMembership

    ttl = 30.0

    def make_membership(env: Env, member_id: str) -> PoolMembership:
        m = PoolMembership(env.journal, ttl_s=ttl, member_id=member_id,
                           host=1)
        if bug == "eviction-edge":
            # seeded bug: forget the edge — report every lapsed member
            # on every scan
            def lapse_scan(now=None):
                now = env.clock.now() if now is None else now
                table = m.members(now=now)
                return [mid for mid, lease in table.items()
                        if mid != m.member_id and not lease["live"]]
            m.evict_lapsed = lapse_scan
        return m

    def setup(env: Env) -> None:
        env.data["evictions"] = []

    def mortal(env: Env, aid: int) -> None:
        peer = PoolMembership(env.journal, ttl_s=ttl, member_id="mB",
                              host=2)
        peer.join(now=env.clock.now())
        peer.heartbeat(now=env.clock.now() + ttl / 2)
        # ...and dies: no leave line, the lease just stops being fed

    def watcher(env: Env, aid: int) -> None:
        w = make_membership(env, "mA")
        w.join(now=env.clock.now())
        for i in range(4):
            if i == 1:
                env.step("clock", "write", f"advance:{ttl * 2:g}")
                env.clock.advance(ttl * 2)
            env.step("member", "read", "evict-scan")
            got = w.evict_lapsed(now=env.clock.now())
            env.data["evictions"].extend(got)

    def final(env: Env) -> None:
        fired = [m for m in env.data["evictions"] if m == "mB"]
        if len(fired) > 1:
            raise InvariantViolation(
                f"eviction edge fired {len(fired)} times for one "
                f"incarnation of mB — steal/alert logic would re-run "
                f"per scan instead of once")
        # liveness must be bounded by the lease: far enough past the
        # last possible beat, mB folds dead under EVERY schedule (the
        # clock may have advanced before mB joined, so "now" alone is
        # not necessarily past its lease)
        horizon = env.clock.now() + 3.0 * ttl
        roster = env.plain_journal().member_table(now=horizon)
        if roster.get("mB", {}).get("live"):
            raise InvariantViolation("mB still folds live 3 ttls past "
                                     "the last possible heartbeat")

    return Scenario("eviction-edge", [mortal, watcher], setup=setup,
                    invariant_step=_fsck_step, invariant_final=final,
                    bug=bug)


def _scenario_compact_prefix(bug: Optional[str]) -> Scenario:
    """Fold determinism under compaction at any prefix: compacting the
    journal between ANY two steps must leave every fold (requests,
    claims, members) exactly as the uncompacted text folds it.  The
    seeded bug compacts claims down to their last line — a lease whose
    surviving line is a lone 'hb' folds to UNOWNED, so a compaction
    running behind a heartbeat silently un-grants the lease."""

    class _MirroredJournal(InstrumentedJournal):
        """Every append also lands in an append-only MIRROR file that
        compaction never touches — the ground truth the folds of the
        (possibly compacted) real journal are compared against."""

        _mirror: str = ""

        def _append(self, entry: dict) -> None:
            InstrumentedJournal._append(self, entry)
            # icln: ignore[flock-discipline] -- scratch mirror: the cooperative scheduler admits exactly one writer at a time
            with open(self._mirror, "a", encoding="utf-8") as f:
                f.write(json.dumps(entry, sort_keys=True) + "\n")

        def live_lines(self, text, now=None):
            lines = InstrumentedJournal.live_lines(self, text, now=now)
            if bug != "compact-last-claim":
                return lines
            # seeded bug: keep only the LAST claim line per work — a
            # surviving lone 'hb' folds to unowned
            last_claim: Dict[str, str] = {}
            out: List[str] = []
            for ln in lines:
                entry = json.loads(ln)
                if entry.get("event") == "claim":
                    last_claim[entry["work"]] = ln
                else:
                    out.append(ln)
            return out + list(last_claim.values())

    def setup(env: Env) -> None:
        journal = _MirroredJournal(env.path, **env.journal_kwargs)
        journal._mirror = os.path.join(env.tmpdir, "mirror.jsonl")
        journal._env = env
        env.journal = journal

    def worker(env: Env, aid: int) -> None:
        nowf = env.clock.now
        env.journal.record_request("r0", "accepted", tenant="t",
                                   paths=["/a.npz"])
        env.journal.try_claim("req:r0", host=1, nonce="n1",
                              ttl_s=1000.0, now=nowf())
        env.journal.heartbeat("req:r0", host=1, nonce="n1",
                              ttl_s=1000.0, now=nowf() + 1.0)
        env.journal.record_request("r0", "running")

    def compactor(env: Env, aid: int) -> None:
        for _ in range(2):
            env.journal.compact()

    def check_folds(env: Env) -> None:
        _fsck_step(env)
        mirror = getattr(env.journal, "_mirror", "")
        if not mirror or not os.path.exists(mirror):
            return
        # ground truth: fold the append-only mirror (never compacted);
        # the real journal — compacted at whatever prefix the schedule
        # chose — must fold IDENTICALLY
        now = env.clock.now() + 2.0
        truth = FleetJournal(mirror)
        real = env.plain_journal()
        checks = (
            ("request fold", lambda j: j.request_states()),
            ("claim fold", lambda j: j.claim_table(now=now)),
            ("member fold", lambda j: j.member_table(now=now)),
        )
        for name, fold in checks:
            want, got = fold(truth), fold(real)
            if want != got:
                raise InvariantViolation(
                    f"compaction changed the {name}: expected {want!r} "
                    f"from the full history, journal folds {got!r} — "
                    f"a compact must never change what readers see")

    return Scenario("compact-prefix", [worker, compactor], setup=setup,
                    invariant_step=check_folds, invariant_final=check_folds,
                    bug=bug)


_BUILDERS = {
    "claim-race": _scenario_claim_race,
    "admit-order": _scenario_admit_order,
    "pool-count": _scenario_pool_count,
    "eviction-edge": _scenario_eviction_edge,
    "compact-prefix": _scenario_compact_prefix,
}


def build_scenario(name: str, bug: Optional[str] = None,
                   backend: str = "file") -> Scenario:
    """A scenario by name; ``bug`` seeds the named in-memory revert
    (must be one of ``SCENARIOS[name]``); ``backend`` picks the journal
    storage the drill runs against (one of ``BACKENDS``)."""
    if name not in _BUILDERS:
        raise ValueError(
            f"unknown scenario {name!r} (known: {', '.join(sorted(_BUILDERS))})")
    if bug is not None and bug not in SCENARIOS[name]:
        raise ValueError(
            f"scenario {name!r} has no seeded bug {bug!r} "
            f"(known: {', '.join(SCENARIOS[name])})")
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown journal backend {backend!r} "
            f"(known: {', '.join(BACKENDS)})")
    scenario = _BUILDERS[name](bug)
    scenario.backend = backend
    return scenario


def sweep(*, max_schedules: int = 2000, max_steps: int = 400,
          budget_s: float = 60.0, seed: int = 0,
          backends: Sequence[str] = BACKENDS,
          stream=None) -> List[ExploreResult]:
    """The CI gate: exhaustively explore every CLEAN scenario against
    every journal backend (plus a short seeded-random tail for depth)
    within one shared budget.  All results must be ok; any
    counterexample is the caller's artifact."""
    t0 = time.monotonic()
    results: List[ExploreResult] = []
    for name in sorted(SCENARIOS):
        for backend in backends:
            remaining = max(budget_s - (time.monotonic() - t0), 1.0)
            res = explore(build_scenario(name, backend=backend),
                          mode="dfs",
                          max_schedules=max_schedules,
                          max_steps=max_steps,
                          budget_s=remaining, seed=seed)
            if res.ok and not res.budget_exhausted:
                remaining = max(budget_s - (time.monotonic() - t0), 1.0)
                tail = explore(build_scenario(name, backend=backend),
                               mode="random",
                               max_schedules=25, max_steps=max_steps,
                               budget_s=min(remaining, budget_s / 10.0),
                               seed=seed + 1)
                if not tail.ok:
                    res = tail
            results.append(res)
            if stream is not None:
                print(res.render(), file=stream)
    return results
