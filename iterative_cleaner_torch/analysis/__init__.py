"""icln-lint-torch: the port's project-invariant analyzer and its card
contracts.

* An AST lint engine (:mod:`.core`) with project-specific rules
  (:mod:`.rules_io`, :mod:`.rules_project`, :mod:`.rules_threads`) that
  turn the codebase's conventions — atomic writes through
  ``io/atomic.py``, flock'd appends through ``utils/logging.py``,
  registry-counted exception handling, config-identity exhaustiveness,
  env/flag/doc drift, thread-shared state, journal claims — into
  machine-checked invariants.
* The journal fsck (:mod:`.journal_fsck`) and the interleaving model
  checker over the real protocol code (:mod:`.interleave`).
* Card contracts (:mod:`.card_contracts`) that run the registered hot
  programs on a device and hold what they do: no host sync inside the
  loop, no float64 on a float32 route, a pinned dispatch count, one
  cube read per kernel launch, no cube-sized copy.

Entry points: the ``icln-lint-torch`` console script,
``python -m iterative_cleaner_torch.analysis`` and
``python -m iterative_cleaner_torch --selfcheck`` (:mod:`.cli`).
"""

from iterative_cleaner_torch.analysis.core import (  # noqa: F401
    Finding,
    LintReport,
    Rule,
    RepoRule,
    default_rules,
    lint_paths,
    lint_source,
    record_findings,
)
