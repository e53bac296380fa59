"""Repo-wide invariants: exception accounting, config identity, drift.

These rules diff the code against its own contracts: every broad
exception handler must leave a trace (log line or registry counter),
every ``CleanConfig`` field must be deliberately classified for the
checkpoint identity hash, and the three user surfaces (``ICLEAN_*`` env
mirrors, ``--flags``, MIGRATION/README docs) must not drift apart.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterable, Optional, Set, Tuple

from iterative_cleaner_torch.analysis.core import (
    FileContext,
    RepoContext,
    RepoRule,
    Rule,
)

#: env knobs the port reads that deliberately have no CLI flag mirror
#: (internal tuning or test-harness toggles); each still needs a
#: documented row (MIGRATION.md, or the README's port section)
ENV_ONLY = frozenset({
    "ICLEAN_SERVE_QUEUE",       # daemon queue depth (ServeConfig.from_env)
    "ICLEAN_STREAM_IDLE_S",     # online-mode idle shutdown
    "ICLEAN_FAULT_HANG_S",      # fault-injection hang duration
    "ICLEAN_RACE_BUDGET_S",     # model-checker sweep wall-clock budget
})

_ENV_RE = re.compile(r"\bICLEAN_[A-Z0-9_]+\b")


class BroadExceptRule(Rule):
    """``except Exception:`` must log-or-count, not swallow."""

    id = "broad-except"
    severity = "warning"
    description = ("a broad handler whose body neither raises nor calls "
                   "anything swallows the error invisibly; count it via "
                   "the registry or log it (or suppress with a reason)")

    BROAD = {"Exception", "BaseException"}

    def check(self, ctx: FileContext) -> Iterable[Tuple[int, str]]:
        for node in ctx.nodes:
            if not isinstance(node, ast.ExceptHandler):
                continue
            t = node.type
            broad = (t is None
                     or (isinstance(t, ast.Name) and t.id in self.BROAD)
                     or (isinstance(t, ast.Attribute)
                         and t.attr in self.BROAD))
            if not broad:
                continue
            acts = any(isinstance(n, (ast.Raise, ast.Call))
                       for b in node.body for n in ast.walk(b))
            if not acts:
                yield (node.lineno,
                       "broad except swallows the error with no log "
                       "line or registry counter: count it "
                       "(*_errors counter), log it, or suppress with "
                       "a reason")


def _set_literal_names(node: ast.AST) -> Optional[Set[str]]:
    """String elements of a set/frozenset literal, or None."""
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
            and node.func.id == "frozenset" and node.args:
        node = node.args[0]
    if isinstance(node, ast.Set):
        out = set()
        for el in node.elts:
            if isinstance(el, ast.Constant) and isinstance(el.value, str):
                out.add(el.value)
            else:
                return None
        return out
    return None


class ConfigIdentityRule(RepoRule):
    """Every CleanConfig field is classified identity or excluded.

    The checkpoint identity hash (utils/checkpoint.py) decides when a
    resumed run may reuse prior results; a field that silently joins the
    dataclass without a classification either invalidates every
    checkpoint (over-keying) or lets a behaviour-changing option reuse
    stale results (under-keying).  ``_IDENTITY_FIELDS`` and
    ``_IDENTITY_EXCLUDE`` in utils/checkpoint.py must partition the
    dataclass exactly."""

    id = "config-identity"
    severity = "error"
    description = ("CleanConfig fields must appear in exactly one of "
                   "utils/checkpoint.py's _IDENTITY_FIELDS / "
                   "_IDENTITY_EXCLUDE")

    def check_repo(self, repo: RepoContext):
        cfg = repo.file("iterative_cleaner_torch/config.py")
        chk = repo.file("iterative_cleaner_torch/utils/checkpoint.py")
        if cfg is None or chk is None or cfg.tree is None \
                or chk.tree is None:
            return
        fields: Dict[str, int] = {}
        for node in cfg.nodes:
            if isinstance(node, ast.ClassDef) and node.name == "CleanConfig":
                for stmt in node.body:
                    if isinstance(stmt, ast.AnnAssign) \
                            and isinstance(stmt.target, ast.Name):
                        fields[stmt.target.id] = stmt.lineno
        include: Optional[Set[str]] = None
        exclude: Optional[Set[str]] = None
        inc_line = exc_line = 1
        for node in chk.nodes:
            if not isinstance(node, ast.Assign):
                continue
            for t in node.targets:
                if not isinstance(t, ast.Name):
                    continue
                if t.id == "_IDENTITY_FIELDS":
                    include = _set_literal_names(node.value)
                    inc_line = node.lineno
                elif t.id == "_IDENTITY_EXCLUDE":
                    exclude = _set_literal_names(node.value)
                    exc_line = node.lineno
        if exclude is None:
            yield (chk, 1, "utils/checkpoint.py must define "
                   "_IDENTITY_EXCLUDE as a literal set of field names")
            return
        if include is None:
            yield (chk, exc_line, "utils/checkpoint.py must define "
                   "_IDENTITY_FIELDS: the explicit identity half of the "
                   "CleanConfig partition (new fields then fail loudly "
                   "here instead of silently joining the hash)")
            return
        for name, line in fields.items():
            in_i, in_e = name in include, name in exclude
            if in_i and in_e:
                yield (chk, inc_line,
                       f"CleanConfig.{name} is in both _IDENTITY_FIELDS "
                       "and _IDENTITY_EXCLUDE")
            elif not in_i and not in_e:
                yield (cfg, line,
                       f"CleanConfig.{name} is classified neither "
                       "checkpoint-identity (_IDENTITY_FIELDS) nor "
                       "excluded (_IDENTITY_EXCLUDE) in "
                       "utils/checkpoint.py")
        for name in sorted((include | exclude) - set(fields)):
            yield (chk, inc_line if name in include else exc_line,
                   f"{name!r} is classified in utils/checkpoint.py but "
                   "is not a CleanConfig field (stale entry)")


class EnvDriftRule(RepoRule):
    """Every ``ICLEAN_*`` env read is documented and flag-mirrored."""

    id = "env-drift"
    severity = "error"
    description = ("each ICLEAN_* env var needs a MIGRATION.md or "
                   "README.md row and "
                   "a --flag mirror (or an entry in the analyzer's "
                   "ENV_ONLY allowlist)")

    def check_repo(self, repo: RepoContext):
        # the port's own knobs are documented in the README's port
        # section (MIGRATION.md is the reference's migration guide)
        if "MIGRATION.md" not in repo.docs and "README.md" not in repo.docs:
            return
        migration = "\n".join(repo.docs.get(n, "")
                              for n in ("MIGRATION.md", "README.md"))
        flags = _cli_flags(repo)
        seen: Dict[str, Tuple[FileContext, int]] = {}
        for ctx in repo.files:
            for lineno, text in enumerate(ctx.lines, start=1):
                for m in _ENV_RE.finditer(text):
                    seen.setdefault(m.group(0), (ctx, lineno))
        for name in sorted(seen):
            ctx, line = seen[name]
            if name not in migration:
                yield (ctx, line,
                       f"{name} has no MIGRATION.md or README.md row: "
                       "document the knob where users look for it")
            mirror = "--" + name[len("ICLEAN_"):].lower().replace("_", "-")
            if name in ENV_ONLY:
                continue
            if mirror not in flags:
                yield (ctx, line,
                       f"{name} has no CLI mirror ({mirror}): add the "
                       "flag, or allowlist it in the analyzer's "
                       "ENV_ONLY with a why-comment")


class FlagDocsRule(RepoRule):
    """Every ``--flag`` the parser accepts is documented."""

    id = "flag-docs"
    severity = "warning"
    description = ("each cli.py --flag must appear in README.md or "
                   "MIGRATION.md (dash/underscore spellings count as "
                   "one flag)")

    def check_repo(self, repo: RepoContext):
        docs = "\n".join(repo.docs.get(n, "")
                         for n in ("README.md", "MIGRATION.md"))
        if not docs.strip():
            return
        cli = repo.file("iterative_cleaner_torch/cli.py")
        if cli is None or cli.tree is None:
            return
        norm_docs = docs.replace("_", "-")
        for flag, line in sorted(_flag_lines(cli).items()):
            if flag.replace("_", "-") not in norm_docs:
                yield (cli, line,
                       f"{flag} is not mentioned in README.md or "
                       "MIGRATION.md: every user-facing flag needs a "
                       "documented home")


def _flag_lines(cli: FileContext) -> Dict[str, int]:
    """--flag -> add_argument line, dash/underscore twins collapsed."""
    out: Dict[str, int] = {}
    for node in cli.nodes:
        if not isinstance(node, ast.Call):
            continue
        if not (isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"):
            continue
        for arg in node.args:
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str) \
                    and arg.value.startswith("--"):
                key = arg.value.replace("_", "-")
                if key not in out:
                    out[key] = node.lineno
    return out


def _cli_flags(repo: RepoContext) -> Set[str]:
    cli = repo.file("iterative_cleaner_torch/cli.py")
    if cli is None or cli.tree is None:
        return set()
    return set(_flag_lines(cli))
