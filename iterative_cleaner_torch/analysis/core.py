"""Rule framework for the port's analyzer (``icln-lint-torch``).

A :class:`Rule` inspects one parsed file and yields findings; a
:class:`RepoRule` sees the whole repository at once (cross-file
invariants like env/flag drift).  Findings carry a stable rule id and a
severity, and any finding can be silenced in place with::

    something_flagged()  # icln: ignore[rule-id] -- short reason

on the finding's line or the line directly above it (comma-separate ids
to silence several rules at one site).  Suppressed findings stay in the
report — they are counted separately (``lint_suppressed{rule=...}``)
so a suppression creep shows up on /metrics — but they do not fail the
``--selfcheck`` gate.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

SEVERITIES = ("error", "warning")

#: package subtree the default lint pass covers
PACKAGE_NAME = "iterative_cleaner_torch"

_SUPPRESS_RE = re.compile(
    r"#\s*icln:\s*ignore\[([A-Za-z0-9_\-,\s]+)\]"
    r"(?:\s*--\s*(?P<reason>.*))?")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One lint finding, suppressed or not."""

    rule: str
    severity: str
    path: str          # repo-relative, posix separators
    line: int
    message: str
    suppressed: bool = False
    reason: str = ""   # the suppression's ``-- reason`` text, if any

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        if not self.suppressed:
            del d["reason"]
        return d

    def render(self) -> str:
        mark = " (suppressed)" if self.suppressed else ""
        return (f"{self.path}:{self.line}: {self.severity} "
                f"[{self.rule}] {self.message}{mark}")


def parse_suppressions(source: str) -> Dict[int, Tuple[set, str]]:
    """Map line number -> (rule ids silenced there, reason text)."""
    out: Dict[int, Tuple[set, str]] = {}
    for lineno, text in enumerate(source.splitlines(), start=1):
        m = _SUPPRESS_RE.search(text)
        if not m:
            continue
        rules = {tok.strip() for tok in m.group(1).split(",") if tok.strip()}
        out[lineno] = (rules, (m.group("reason") or "").strip())
    return out


class FileContext:
    """One source file: path, text, parsed tree (with parent links)."""

    def __init__(self, path: str, rel: str, source: str):
        self.path = path
        self.rel = rel.replace(os.sep, "/")
        self.source = source
        self.lines = source.splitlines()
        self.suppressions = parse_suppressions(source)
        self.parse_error: Optional[str] = None
        try:
            self.tree: Optional[ast.AST] = ast.parse(source, filename=rel)
        except SyntaxError as exc:
            self.tree = None
            self.parse_error = str(exc)
        #: every node of the tree in ``ast.walk`` order, walked once for
        #: all the rules
        self.nodes: List[ast.AST] = []
        if self.tree is not None:
            self.nodes = list(ast.walk(self.tree))
            for node in self.nodes:
                for child in ast.iter_child_nodes(node):
                    child._icln_parent = node  # type: ignore[attr-defined]

    def parents(self, node: ast.AST) -> Iterator[ast.AST]:
        cur = getattr(node, "_icln_parent", None)
        while cur is not None:
            yield cur
            cur = getattr(cur, "_icln_parent", None)

    def enclosing_function(self, node: ast.AST):
        for p in self.parents(node):
            if isinstance(p, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
                return p
        return None


class RepoContext:
    """The whole checkout: every package FileContext plus the doc files
    cross-file rules diff against (absent docs disable those rules —
    an installed wheel has no README to drift from)."""

    def __init__(self, root: str, files: Sequence[FileContext]):
        self.root = root
        self.files = list(files)
        self.docs: Dict[str, str] = {}
        for name in ("README.md", "MIGRATION.md", "ARCHITECTURE.md"):
            p = os.path.join(root, name)
            if os.path.isfile(p):
                with open(p, encoding="utf-8", errors="replace") as f:
                    self.docs[name] = f.read()

    def file(self, rel: str) -> Optional[FileContext]:
        rel = rel.replace(os.sep, "/")
        for ctx in self.files:
            if ctx.rel == rel or ctx.rel.endswith("/" + rel):
                return ctx
        return None


class Rule:
    """Per-file rule: subclass and implement :meth:`check`."""

    id: str = ""
    severity: str = "error"
    description: str = ""

    def check(self, ctx: FileContext) -> Iterable[Tuple[int, str]]:
        raise NotImplementedError

    def findings(self, ctx: FileContext) -> Iterator[Finding]:
        for line, message in self.check(ctx):
            yield _resolve(self, ctx, line, message)


class RepoRule(Rule):
    """Cross-file rule: sees the whole :class:`RepoContext`."""

    def check_repo(self, repo: RepoContext) \
            -> Iterable[Tuple[FileContext, int, str]]:
        raise NotImplementedError

    def check(self, ctx: FileContext) -> Iterable[Tuple[int, str]]:
        return ()

    def repo_findings(self, repo: RepoContext) -> Iterator[Finding]:
        for ctx, line, message in self.check_repo(repo):
            yield _resolve(self, ctx, line, message)


def _resolve(rule: Rule, ctx: FileContext, line: int, message: str) -> Finding:
    """Apply the file's suppression comments to one raw finding."""
    for probe in (line, line - 1):
        entry = ctx.suppressions.get(probe)
        if entry and rule.id in entry[0]:
            return Finding(rule.id, rule.severity, ctx.rel, line, message,
                           suppressed=True, reason=entry[1])
    return Finding(rule.id, rule.severity, ctx.rel, line, message)


@dataclasses.dataclass
class LintReport:
    findings: List[Finding]
    files_scanned: int
    parse_errors: List[Tuple[str, str]] = dataclasses.field(
        default_factory=list)

    @property
    def unsuppressed(self) -> List[Finding]:
        return [f for f in self.findings if not f.suppressed]

    @property
    def suppressed(self) -> List[Finding]:
        return [f for f in self.findings if f.suppressed]

    @property
    def ok(self) -> bool:
        return not self.unsuppressed and not self.parse_errors

    def to_dict(self) -> dict:
        return {
            "ok": self.ok,
            "files_scanned": self.files_scanned,
            "findings": [f.to_dict() for f in self.unsuppressed],
            "suppressed": [f.to_dict() for f in self.suppressed],
            "parse_errors": [{"path": p, "error": e}
                             for p, e in self.parse_errors],
        }

    def render_text(self, *, show_suppressed: bool = False) -> str:
        out = []
        for f in sorted(self.findings, key=lambda f: (f.path, f.line)):
            if f.suppressed and not show_suppressed:
                continue
            out.append(f.render())
        for path, err in self.parse_errors:
            out.append(f"{path}:0: error [parse] {err}")
        out.append("%d file%s scanned: %d finding%s, %d suppressed"
                   % (self.files_scanned,
                      "" if self.files_scanned == 1 else "s",
                      len(self.unsuppressed),
                      "" if len(self.unsuppressed) == 1 else "s",
                      len(self.suppressed)))
        return "\n".join(out)


def default_rules() -> List[Rule]:
    """The rules of the default pass.  The reference's traced-body rules
    (``jit-purity``, ``static-hashable``, ``donation-safety``) have no
    counterpart: the port traces no program, and their intent (a pure
    hot path with no hidden copies) is carried by the card contracts
    (:mod:`.card_contracts`)."""
    from iterative_cleaner_torch.analysis import (
        rules_io,
        rules_project,
        rules_threads,
    )

    return [
        rules_io.AtomicWriteRule(),
        rules_io.FlockDisciplineRule(),
        rules_io.LockOrderRule(),
        rules_project.BroadExceptRule(),
        rules_project.ConfigIdentityRule(),
        rules_project.EnvDriftRule(),
        rules_project.FlagDocsRule(),
        rules_threads.ThreadSharedStateRule(),
        rules_threads.ThreadLockOrderRule(),
        rules_threads.JournalClaimRule(),
    ]


def find_repo_root(start: Optional[str] = None) -> str:
    """The directory that holds the ``iterative_cleaner_torch`` package."""
    here = start or os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))
    if os.path.basename(here) == PACKAGE_NAME:
        return os.path.dirname(here)
    return here


def iter_python_files(root: str) -> Iterator[str]:
    pkg = os.path.join(root, PACKAGE_NAME)
    base = pkg if os.path.isdir(pkg) else root
    for dirpath, dirnames, filenames in os.walk(base):
        dirnames[:] = sorted(d for d in dirnames
                             if d not in ("__pycache__", ".git"))
        for name in sorted(filenames):
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)


def _load(path: str, root: str) -> FileContext:
    rel = os.path.relpath(path, root)
    with open(path, encoding="utf-8", errors="replace") as f:
        return FileContext(path, rel, f.read())


def lint_paths(paths: Optional[Sequence[str]] = None,
               root: Optional[str] = None,
               rules: Optional[Sequence[Rule]] = None) -> LintReport:
    """Lint files (default: the whole package) and return a report."""
    root = os.path.abspath(root or find_repo_root())
    if paths:
        targets: List[str] = []
        for p in paths:
            p = os.path.abspath(p)
            if os.path.isdir(p):
                for dirpath, dirnames, filenames in os.walk(p):
                    dirnames[:] = sorted(d for d in dirnames
                                         if d not in ("__pycache__", ".git"))
                    targets.extend(os.path.join(dirpath, n)
                                   for n in sorted(filenames)
                                   if n.endswith(".py"))
            else:
                targets.append(p)
    else:
        targets = list(iter_python_files(root))
    files = [_load(p, root) for p in targets]
    return lint_files(files, root, rules)


def lint_files(files: Sequence[FileContext], root: str,
               rules: Optional[Sequence[Rule]] = None) -> LintReport:
    rules = list(rules) if rules is not None else default_rules()
    findings: List[Finding] = []
    parse_errors = [(ctx.rel, ctx.parse_error) for ctx in files
                    if ctx.parse_error]
    for rule in rules:
        if isinstance(rule, RepoRule):
            continue
        for ctx in files:
            if ctx.tree is None:
                continue
            findings.extend(rule.findings(ctx))
    repo = RepoContext(root, files)
    for rule in rules:
        if isinstance(rule, RepoRule):
            findings.extend(rule.repo_findings(repo))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return LintReport(findings, files_scanned=len(files),
                      parse_errors=parse_errors)


def lint_source(source: str, *, rel: str = "snippet.py",
                rules: Optional[Sequence[Rule]] = None,
                root: Optional[str] = None) -> LintReport:
    """Lint one in-memory snippet (the unit-test entry point).  Repo
    rules are skipped unless an explicit ``root`` provides the docs and
    sibling files they diff against."""
    ctx = FileContext(rel, rel, source)
    use = [r for r in (rules if rules is not None else default_rules())
           if root is not None or not isinstance(r, RepoRule)]
    return lint_files([ctx], root or os.getcwd(), use)


def record_findings(registry, report: LintReport) -> None:
    """Publish a report into a MetricsRegistry: ``lint_findings{rule=r}``
    per unsuppressed finding, ``lint_suppressed{rule=r}`` per suppressed
    one, plus ``lint_files_scanned`` — the counters serve's /metrics and
    the --prom-textfile/--metrics-json exporters pick up."""
    from iterative_cleaner_torch.telemetry.registry import labeled

    registry.gauge_set("lint_files_scanned", report.files_scanned)
    registry.gauge_set("lint_ok", 1 if report.ok else 0)
    for f in report.findings:
        name = "lint_suppressed" if f.suppressed else "lint_findings"
        registry.counter_inc(labeled(name, rule=f.rule))


def report_json(report: LintReport, extra: Optional[dict] = None) -> str:
    d = report.to_dict()
    if extra:
        d.update(extra)
    return json.dumps(d, indent=2, sort_keys=True)
