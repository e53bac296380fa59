"""Deterministic fault injection for the fleet pipeline.

Every recovery path in :mod:`iterative_cleaner_torch.parallel.fleet` —
staged retries, watchdog deadlines, OOM batch-halving, journaled resume
— must be drillable in CI without hardware and without monkeypatching
library internals.  This module is the drill rig: a
seed+spec driven injector that raises (or stalls) at named pipeline
sites, wired through ``--faults`` / ``ICLEAN_FAULTS``.

Spec grammar (comma-separated ``site:action`` entries)::

    load:0.1          transient fault on each load call with probability 0.1
    exec:oom@2        synthetic RESOURCE_EXHAUSTED on the 2nd execute call
    write:once        transient fault on the first write call (= err@1)
    compile:err       transient fault on EVERY background compile
    load:perm@3       permanent (non-retryable) fault on the 3rd load call
    exec:hang@1       stall the 1st execute call for ``hang_s`` seconds
                      (what a watchdog deadline must catch)

Sites are ``peek``, ``load``, ``compile``, ``execute`` (alias ``exec``),
``write``, and the serve daemon's layer: ``intake`` (spool/HTTP request
parsing and admission) and ``sched`` (the scheduler's dispatch path) —
so a soak can prove the daemon survives a faulty intake or scheduler
without wedging.  Kinds are ``err`` (transient), ``oom`` (synthetic
``RESOURCE_EXHAUSTED`` — classified exactly like a real device OOM),
``perm`` (permanent) and ``hang`` (a sleep, never an exception).
Probability draws are keyed functionally on ``(seed, site, kind, call
index)`` — deterministic across runs and thread interleavings, not a
shared RNG stream whose order racing workers could perturb.
"""

from __future__ import annotations

import dataclasses
import os
import random
import threading
import time
from typing import Dict, List, Optional, Tuple

SITES = ("peek", "load", "compile", "execute", "write", "intake", "sched")
_SITE_ALIASES = {"exec": "execute"}
KINDS = ("err", "oom", "perm", "hang")

ENV_SPEC = "ICLEAN_FAULTS"
ENV_SEED = "ICLEAN_FAULT_SEED"
ENV_HANG_S = "ICLEAN_FAULT_HANG_S"


class FaultSpecError(ValueError):
    """A ``--faults`` / ``ICLEAN_FAULTS`` spec that does not parse."""


class InjectedFault(RuntimeError):
    """A transient injected failure: the retry ladder should absorb it."""


class InjectedPermanentFault(ValueError):
    """A permanent injected failure: retrying must NOT absorb it (the
    classifier treats ValueError as permanent, like a corrupt archive)."""


class SyntheticResourceExhausted(InjectedFault):
    """Synthetic device OOM.  The message carries ``RESOURCE_EXHAUSTED``
    (and "out of memory") so :func:`iterative_cleaner_torch.resilience.
    retry.classify_error` routes it exactly like a real
    ``torch.OutOfMemoryError`` — the OOM ladder cannot tell them apart, by
    design."""


@dataclasses.dataclass(frozen=True)
class FaultRule:
    site: str
    kind: str        # err | oom | perm | hang
    prob: float = 0.0  # > 0: fire each call with this probability
    at: int = 0        # > 0: fire exactly on this 1-based call; 0 = every


def _parse_entry(entry: str) -> FaultRule:
    site, sep, action = entry.partition(":")
    site = _SITE_ALIASES.get(site.strip(), site.strip())
    action = action.strip()
    if not sep or not action:
        raise FaultSpecError(
            f"fault entry {entry!r} must be 'site:action' "
            f"(e.g. 'load:0.1', 'exec:oom@2', 'write:once')")
    if site not in SITES:
        raise FaultSpecError(
            f"unknown fault site {site!r} in {entry!r}; sites: "
            f"{', '.join(SITES)} (alias exec=execute)")
    if action == "once":
        return FaultRule(site=site, kind="err", at=1)
    kind, sep, at = action.partition("@")
    if kind not in KINDS:
        try:
            prob = float(action)
        except ValueError:
            raise FaultSpecError(
                f"unknown fault action {action!r} in {entry!r}; expected a "
                f"probability, 'once', or kind[@N] with kind in "
                f"{', '.join(KINDS)}") from None
        if sep or not 0.0 < prob <= 1.0:
            raise FaultSpecError(
                f"fault probability in {entry!r} must be in (0, 1]")
        return FaultRule(site=site, kind="err", prob=prob)
    if sep:
        try:
            n = int(at)
        except ValueError:
            n = 0
        if n < 1:
            raise FaultSpecError(
                f"fault call index in {entry!r} must be a positive integer")
        return FaultRule(site=site, kind=kind, at=n)
    return FaultRule(site=site, kind=kind)


def parse_fault_spec(spec: str) -> Tuple[FaultRule, ...]:
    """Parse a spec string into rules; raises :class:`FaultSpecError` on
    any malformed entry (the CLI surfaces this as an argparse error)."""
    rules = []
    for entry in spec.split(","):
        entry = entry.strip()
        if entry:
            rules.append(_parse_entry(entry))
    return tuple(rules)


class FaultInjector:
    """Seeded, thread-safe fault scheduler over the named pipeline sites.

    ``fire(site)`` increments that site's call counter and applies every
    matching rule: ``hang`` rules sleep ``hang_s`` seconds and return
    (the caller's watchdog deadline is what should interrupt the wait —
    from the pipeline's point of view the stage just stopped making
    progress); the raising kinds throw their exception class.  Each
    injection counts into the bound registry as ``fault_injected``.
    """

    def __init__(self, spec: str, seed: int = 0, *,
                 hang_s: Optional[float] = None, registry=None) -> None:
        self.rules: Dict[str, List[FaultRule]] = {}
        for rule in parse_fault_spec(spec):
            self.rules.setdefault(rule.site, []).append(rule)
        self.seed = int(seed)
        if hang_s is None:
            hang_s = float(os.environ.get(ENV_HANG_S, "") or 30.0)
        self.hang_s = float(hang_s)
        self.registry = registry
        self.calls: Dict[str, int] = {}
        self.injected: Dict[str, int] = {}
        self._lock = threading.Lock()

    @classmethod
    def from_env(cls, registry=None) -> Optional["FaultInjector"]:
        """The ``ICLEAN_FAULTS`` entry point (CI smoke, env-driven drills);
        None when the env var is unset/empty — the zero-overhead default."""
        spec = os.environ.get(ENV_SPEC, "")
        if not spec:
            return None
        seed = int(os.environ.get(ENV_SEED, "") or 0)
        return cls(spec, seed=seed, registry=registry)

    def bind(self, registry) -> None:
        """Late registry attach (the fleet binds its own registry when the
        injector was built before one existed); first binding wins."""
        if self.registry is None:
            self.registry = registry

    def _triggers(self, rule: FaultRule, n: int) -> bool:
        if rule.prob > 0.0:
            # functional draw: same (seed, site, kind, call) -> same verdict
            # whatever order racing workers reach their calls in
            key = f"{self.seed}:{rule.site}:{rule.kind}:{n}"
            return random.Random(key).random() < rule.prob
        return rule.at == 0 or n == rule.at

    def fire(self, site: str, detail: str = "") -> None:
        """Apply this site's rules to its next call; raises or stalls when
        one triggers, returns silently otherwise."""
        site = _SITE_ALIASES.get(site, site)
        rules = self.rules.get(site)
        with self._lock:
            n = self.calls[site] = self.calls.get(site, 0) + 1
        if not rules:
            return
        for rule in rules:
            if not self._triggers(rule, n):
                continue
            with self._lock:
                self.injected[site] = self.injected.get(site, 0) + 1
            if self.registry is not None:
                self.registry.counter_inc("fault_injected")
            where = f"{site} call {n}" + (f" ({detail})" if detail else "")
            if rule.kind == "hang":
                time.sleep(self.hang_s)
                return
            if rule.kind == "oom":
                raise SyntheticResourceExhausted(
                    f"RESOURCE_EXHAUSTED: injected synthetic device OOM "
                    f"(out of memory) at {where}")
            if rule.kind == "perm":
                raise InjectedPermanentFault(
                    f"injected permanent fault at {where}")
            raise InjectedFault(f"injected transient fault at {where}")
