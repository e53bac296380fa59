"""Concurrency-discipline rules: shared state, lock order, claim coverage.

The system's correctness rests on a concurrent protocol —
flock'd journal folds, claim/membership leases, heartbeat threads, an
HTTP intake running on per-request threads against a single worker
loop.  Interleaving races are exactly the bug class unit tests miss,
so these rules make the thread structure itself a linted artifact:

* :class:`ThreadSharedStateRule` inventories thread entrypoints —
  ``threading.Thread(target=...)``, executor ``submit`` targets,
  methods handed out by reference as callbacks, and daemon methods the
  ``BaseHTTPRequestHandler`` subclasses invoke from per-request
  threads — propagates those entrypoint labels through each class's
  ``self.``-call graph, and flags instance state written from two or
  more distinct entrypoints without one common lock.
* :class:`ThreadLockOrderRule` extends ``lock-order`` across
  lock TYPES: the sanctioned nesting is threading-lock OUTER, file
  flock INNER (``stream_ingest`` holds the stream lock while its
  journal append takes the flock).  If any code path ever acquires a
  threading lock while holding the flock, both directions exist and
  every participating site is flagged — the classic two-lock deadlock
  needs both orders, so the rule stays silent until someone writes the
  inversion.
* :class:`JournalClaimRule` (``journal-append-without-claim``): in a
  file that participates in the claim-lease protocol, execution
  lifecycle lines ('running'/'done'/'failed' request states, archive
  'done' lines) may only be appended from code reachable from a claim
  acquisition — an unclaimed writer is exactly the duplicate-clean
  hazard the lease exists to prevent.  Raw ``journal._append`` calls
  outside ``resilience/journal.py`` bypass the grammar and are always
  flagged.

All three silence the usual way: ``# icln: ignore[rule-id] -- reason``.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, Iterator, List, Optional, Set, Tuple

from iterative_cleaner_torch.analysis.core import (
    FileContext,
    RepoContext,
    RepoRule,
    Rule,
)
from iterative_cleaner_torch.analysis.rules_io import LOCK_HELPERS, _attr_chain

#: journal mutators whose lines carry execution-lifecycle meaning
CLAIM_ACQUIRERS = frozenset({"try_claim", "_claim_for_execute"})

#: journal calls that take the per-file flock internally (any of these
#: inside a held threading lock is a T->F nesting site)
JOURNAL_MUTATORS = frozenset({
    "record_done", "record_request", "record_claim", "record_member",
    "record_cache", "record_host_stats", "try_claim", "heartbeat",
    "release", "compact", "compact_shard", "seal",
})

#: request states only the execution-claim holder may journal
EXECUTION_STATES = ("running", "done", "failed")


def _is_lockish(chain: str) -> bool:
    """Does a with-context chain look like a threading lock?  The
    project's locks all carry 'lock' in the attribute name (``_lock``,
    ``st.lock``, ``_state_lock``), which keeps this a naming convention
    the lint both relies on and enforces by construction."""
    leaf = chain.split(".")[-1].lower()
    return "lock" in leaf


def _with_locks(ctx: FileContext, node: ast.AST) -> Set[str]:
    """The threading-lock context chains held at ``node`` (lexically)."""
    held: Set[str] = set()
    for p in ctx.parents(node):
        if not isinstance(p, (ast.With, ast.AsyncWith)):
            continue
        for item in p.items:
            expr = item.context_expr
            if isinstance(expr, ast.Call):
                chain = _attr_chain(expr.func) + "()"
            else:
                chain = _attr_chain(expr)
            if chain and _is_lockish(chain):
                held.add(chain)
    return held


def _walk_unit(root: ast.AST, skip: Set[ast.AST]) -> Iterator[ast.AST]:
    """Walk ``root`` without descending into other analysis units: a
    nested function that runs on its own thread executes NONE of its
    body when the enclosing method runs."""
    stack = [root]
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if child in skip and child is not root:
                continue
            stack.append(child)


#: instance-attribute method calls that mutate their receiver
_MUTATORS = frozenset({
    "append", "extend", "add", "discard", "remove", "pop", "popitem",
    "clear", "update", "setdefault", "insert",
})


class _Unit:
    """One analysis unit: a method or a nested function used as a thread
    entrypoint.  Carries the self-call edges, the instance-attribute
    write sites and the entrypoint labels propagated onto it."""

    def __init__(self, name: str, node: ast.AST) -> None:
        self.name = name
        self.node = node
        self.calls: Set[str] = set()       # leaf names of self.M() calls
        self.local_calls: Set[str] = set()  # bare-name calls to units
        # attr -> [(line, locks held)]
        self.writes: Dict[str, List[Tuple[int, Set[str]]]] = {}
        self.labels: Set[str] = set()

    def add_write(self, attr: str, line: int, locks: Set[str]) -> None:
        self.writes.setdefault(attr, []).append((line, locks))


def _target_name(node: ast.AST) -> Tuple[str, str]:
    """Resolve a callable reference: returns ('method', M) for
    ``self.M``, ('name', N) for a bare name, ('', '') otherwise."""
    chain = _attr_chain(node)
    if chain.startswith("self.") and chain.count(".") == 1:
        return "method", chain.split(".", 1)[1]
    if isinstance(node, ast.Name):
        return "name", node.id
    return "", ""


class _ScopeAnalysis:
    """Shared-state analysis of one class (or of the module top level,
    where 'self.' attrs give way to ``global``-declared names)."""

    def __init__(self, ctx: FileContext, body: List[ast.stmt],
                 http_names: Set[str], *, is_module: bool) -> None:
        self.ctx = ctx
        self.is_module = is_module
        self.units: Dict[str, _Unit] = {}
        self.unit_nodes: Set[ast.AST] = set()
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._register(stmt)
        # second pass: nested defs become units too (thread targets and
        # inline helpers both), now that the full set is known
        for stmt in list(self.units.values()):
            for node in ast.walk(stmt.node):
                if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)) \
                        and node not in self.unit_nodes:
                    self._register(node)
        for unit in self.units.values():
            self._scan_unit(unit)
        self._label_roots(http_names)
        self._propagate()

    def _register(self, node) -> None:
        # leaf-name keyed; a duplicate name keeps the first definition
        # (good enough for labeling — both would get the same labels)
        self.unit_nodes.add(node)
        self.units.setdefault(node.name, _Unit(node.name, node))

    # ------------------------------------------------------------ scanning
    def _scan_unit(self, unit: _Unit) -> None:
        if unit.name == "__init__":
            return  # construction precedes every thread
        globals_here: Set[str] = set()
        for node in _walk_unit(unit.node, self.unit_nodes):
            if isinstance(node, ast.Global):
                globals_here.update(node.names)
        for node in _walk_unit(unit.node, self.unit_nodes):
            if isinstance(node, ast.Call):
                kind, name = _target_name(node.func)
                if kind == "method" and name in self.units:
                    unit.calls.add(name)
                elif kind == "name" and name in self.units:
                    unit.local_calls.add(name)
                chain = _attr_chain(node.func)
                parts = chain.split(".")
                if (len(parts) == 3 and parts[0] == "self"
                        and parts[2] in _MUTATORS):
                    unit.add_write(parts[1], node.lineno,
                                   _with_locks(self.ctx, node))
            targets: List[ast.AST] = []
            if isinstance(node, ast.Assign):
                targets = list(node.targets)
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                targets = [node.target]
            for t in targets:
                base = t
                while isinstance(base, ast.Subscript):
                    base = base.value
                chain = _attr_chain(base)
                if chain.startswith("self.") and chain.count(".") == 1:
                    unit.add_write(chain.split(".", 1)[1], t.lineno,
                                   _with_locks(self.ctx, t))
                elif (self.is_module and isinstance(base, ast.Name)
                        and base.id in globals_here):
                    unit.add_write(base.id, t.lineno,
                                   _with_locks(self.ctx, t))

    # ------------------------------------------------------------ labeling
    def _label_roots(self, http_names: Set[str]) -> None:
        consumed: Set[ast.AST] = set()
        for unit in self.units.values():
            for node in _walk_unit(unit.node, self.unit_nodes):
                if not isinstance(node, ast.Call):
                    continue
                leaf = _attr_chain(node.func).split(".")[-1]
                if leaf == "Thread":
                    for kw in node.keywords:
                        if kw.arg == "target":
                            self._mark(kw.value, "thread")
                            consumed.add(kw.value)
                elif leaf == "submit" and node.args:
                    self._mark(node.args[0], "pool")
                    consumed.add(node.args[0])
        # a method handed out by REFERENCE (not called) becomes someone
        # else's entrypoint: scheduler callbacks, hooks — wherever the
        # reference escapes to, it may run on that something's thread
        for unit in self.units.values():
            for node in _walk_unit(unit.node, self.unit_nodes):
                if not isinstance(node, ast.Attribute) or node in consumed:
                    continue
                kind, name = _target_name(node)
                if kind != "method" or name not in self.units:
                    continue
                parent = getattr(node, "_icln_parent", None)
                if isinstance(parent, ast.Call) and parent.func is node:
                    continue  # being called, not handed out
                self.units[name].labels.add(f"callback:{name}")
        for name, unit in self.units.items():
            if name in http_names:
                unit.labels.add("http")
            if not name.startswith("_") and not self.is_module:
                # public surface: callable from the process's own
                # (main/worker) context
                unit.labels.add("main")
            if self.is_module and not name.startswith("_"):
                unit.labels.add("main")

    def _mark(self, value: ast.AST, what: str) -> None:
        kind, name = _target_name(value)
        if name in self.units:
            self.units[name].labels.add(f"{what}:{name}")

    def _propagate(self) -> None:
        changed = True
        while changed:
            changed = False
            for unit in self.units.values():
                for callee in unit.calls | unit.local_calls:
                    tgt = self.units.get(callee)
                    if tgt is not None and not unit.labels <= tgt.labels:
                        tgt.labels |= unit.labels
                        changed = True

    # ------------------------------------------------------------ verdicts
    def findings(self) -> Iterator[Tuple[int, str]]:
        # attr -> [(line, locks, labels, unit name)]
        sites: Dict[str, List[Tuple[int, Set[str], Set[str], str]]] = {}
        for unit in self.units.values():
            if not unit.labels:
                continue  # unreachable from any entrypoint
            for attr, writes in unit.writes.items():
                for line, locks in writes:
                    sites.setdefault(attr, []).append(
                        (line, locks, unit.labels, unit.name))
        for attr, rows in sorted(sites.items()):
            labels: Set[str] = set()
            for _line, _locks, ls, _u in rows:
                labels |= ls
            if len(labels) < 2:
                continue
            common = set(rows[0][1])
            for _line, locks, _ls, _u in rows[1:]:
                common &= locks
            if common:
                continue
            unlocked = [r for r in rows if not r[1]]
            line = (min(r[0] for r in unlocked) if unlocked
                    else min(r[0] for r in rows))
            where = ", ".join(
                "%s:%d%s" % (u, ln, "" if lk else " (unlocked)")
                for ln, lk, _ls, u in sorted(rows))
            yield (line,
                   f"{'global' if self.is_module else 'attribute'} "
                   f"{attr!r} is written from {len(labels)} thread "
                   f"entrypoints ({', '.join(sorted(labels))}) without "
                   f"one common lock — writes at {where}; guard every "
                   f"write with the same lock or confine the state to "
                   f"one thread")


def _http_called_names(repo: RepoContext) -> Set[str]:
    """Method names the HTTP handler classes invoke on the daemon —
    each runs on a per-request thread (``ThreadingHTTPServer``)."""
    out: Set[str] = set()
    for ctx in repo.files:
        if ctx.tree is None:
            continue
        for cls in ctx.nodes:
            if not isinstance(cls, ast.ClassDef):
                continue
            if not any("BaseHTTPRequestHandler" in _attr_chain(b)
                       for b in cls.bases):
                continue
            for node in ast.walk(cls):
                if not isinstance(node, ast.Call):
                    continue
                chain = _attr_chain(node.func)
                parts = chain.split(".")
                if len(parts) >= 2 and "daemon" in parts[:-1]:
                    out.add(parts[-1])
    return out


class ThreadSharedStateRule(RepoRule):
    """Instance/module state written from ≥2 thread entrypoints must
    share one lock."""

    id = "thread-shared-state"
    severity = "error"
    description = ("state written from two thread entrypoints without a "
                   "common lock is a data race; guard every write with "
                   "the same lock or confine the state to one thread")

    def check_repo(self, repo: RepoContext) \
            -> Iterable[Tuple[FileContext, int, str]]:
        http_names = _http_called_names(repo)
        for ctx in repo.files:
            if ctx.tree is None:
                continue
            if ctx.rel.endswith("serve/http.py"):
                # the handler class IS the thread boundary; its state is
                # per-request by construction
                continue
            for cls in ctx.nodes:
                if not isinstance(cls, ast.ClassDef):
                    continue
                scope = _ScopeAnalysis(ctx, cls.body, http_names,
                                       is_module=False)
                for line, msg in scope.findings():
                    yield ctx, line, f"{cls.name}.{msg}"
            module_scope = _ScopeAnalysis(
                ctx, [s for s in ctx.tree.body], set(), is_module=True)
            for line, msg in module_scope.findings():
                yield ctx, line, msg


class ThreadLockOrderRule(RepoRule):
    """Threading locks nest OUTSIDE the file flock, never inside.

    The repo's one sanctioned direction is T->F: ``stream_ingest`` holds
    the per-stream threading lock while its journal append takes the
    flock.  The moment any code path acquires a threading lock while
    holding the flock (F->T), both orders exist in one process and two
    threads can deadlock across the pair — so this rule collects both
    kinds of site repo-wide and flags ALL of them only when both
    directions are present, naming the opposite site."""

    id = "thread-lock-order"
    severity = "error"
    description = ("acquiring a threading lock under the file flock "
                   "inverts the sanctioned T->F order and can deadlock "
                   "against any locked journal append")

    def check_repo(self, repo: RepoContext) \
            -> Iterable[Tuple[FileContext, int, str]]:
        t_to_f: List[Tuple[FileContext, int, str]] = []
        f_to_t: List[Tuple[FileContext, int, str]] = []
        for ctx in repo.files:
            if ctx.tree is None or ctx.rel.endswith("utils/logging.py"):
                continue
            for node in ctx.nodes:
                if not isinstance(node, ast.Call):
                    continue
                chain = _attr_chain(node.func)
                leaf = chain.split(".")[-1]
                if leaf in LOCK_HELPERS or leaf in JOURNAL_MUTATORS:
                    held = _with_locks(ctx, node)
                    if held:
                        t_to_f.append(
                            (ctx, node.lineno,
                             f"{leaf}() under threading lock "
                             f"{sorted(held)[0]!r}"))
                if leaf == "flock" or leaf == "compact_under_lock":
                    fn = ctx.enclosing_function(node)
                    if fn is None:
                        continue
                    for inner in ast.walk(fn):
                        acquires = None
                        if isinstance(inner, (ast.With, ast.AsyncWith)):
                            for item in inner.items:
                                c = _attr_chain(item.context_expr)
                                if c and _is_lockish(c):
                                    acquires = (item.context_expr.lineno,
                                                c)
                        elif isinstance(inner, ast.Call):
                            c = _attr_chain(inner.func)
                            if (c.endswith(".acquire")
                                    and _is_lockish(c[:-8])):
                                acquires = (inner.lineno, c)
                        if acquires and acquires[0] > node.lineno:
                            f_to_t.append(
                                (ctx, acquires[0],
                                 f"threading lock {acquires[1]!r} "
                                 f"acquired after {leaf}() in "
                                 f"{fn.name}()"))
        if not (t_to_f and f_to_t):
            return
        other_f = f"{f_to_t[0][0].rel}:{f_to_t[0][1]}"
        other_t = f"{t_to_f[0][0].rel}:{t_to_f[0][1]}"
        for ctx, line, what in t_to_f:
            yield (ctx, line,
                   f"{what}: the flock nests inside a threading lock "
                   f"here while {other_f} nests a threading lock inside "
                   f"the flock — both orders in one process deadlock")
        for ctx, line, what in f_to_t:
            yield (ctx, line,
                   f"{what}: inverts the sanctioned T->F order "
                   f"(e.g. {other_t}) — both orders in one process "
                   f"deadlock")


def _state_const(call: ast.Call) -> Optional[str]:
    """The literal request state of a ``record_request`` call."""
    cand: Optional[ast.AST] = None
    if len(call.args) >= 2:
        cand = call.args[1]
    for kw in call.keywords:
        if kw.arg == "state":
            cand = kw.value
    if isinstance(cand, ast.Constant) and isinstance(cand.value, str):
        return cand.value
    return None


class JournalClaimRule(Rule):
    """Execution-lifecycle journal lines require the execution claim."""

    id = "journal-append-without-claim"
    severity = "error"
    description = ("'running'/'done'/'failed' journal lines outside the "
                   "claim-lease discipline are the duplicate-clean "
                   "hazard the lease exists to prevent")

    def check(self, ctx: FileContext) -> Iterable[Tuple[int, str]]:
        if ctx.rel.endswith("resilience/journal.py") \
                or ctx.rel.endswith("resilience/segmented.py") \
                or "/analysis/" in ctx.rel:
            return
        # grammar bypass: raw _append anywhere outside the journal impl
        for node in ctx.nodes:
            if isinstance(node, ast.Call):
                chain = _attr_chain(node.func)
                if chain.split(".")[-1] == "_append" and "." in chain:
                    yield (node.lineno,
                           "raw journal._append bypasses the line "
                           "grammar (and fsck); use the record_* "
                           "methods")
        funcs: Dict[str, List[ast.AST]] = {}
        for node in ctx.nodes:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                funcs.setdefault(node.name, []).append(node)
        claimful = False
        holders: Set[str] = set()
        calls: Dict[str, Set[str]] = {name: set() for name in funcs}

        def owner(node: ast.AST):
            fn = ctx.enclosing_function(node)
            while isinstance(fn, ast.Lambda):
                fn = ctx.enclosing_function(fn)
            return fn

        for node in ctx.nodes:
            if not isinstance(node, ast.Call):
                continue
            leaf = _attr_chain(node.func).split(".")[-1]
            fn = owner(node)
            if leaf in CLAIM_ACQUIRERS:
                claimful = True
                if fn is not None:
                    holders.add(fn.name)
            if fn is not None and leaf in funcs:
                calls[fn.name].add(leaf)
        if not claimful:
            return
        covered = set(holders)
        frontier = list(holders)
        while frontier:
            for callee in calls.get(frontier.pop(), ()):
                if callee not in covered:
                    covered.add(callee)
                    frontier.append(callee)
        for node in ctx.nodes:
            if not isinstance(node, ast.Call):
                continue
            leaf = _attr_chain(node.func).split(".")[-1]
            state = None
            if leaf == "record_request":
                state = _state_const(node)
                if state not in EXECUTION_STATES:
                    continue
            elif leaf != "record_done":
                continue
            fn = owner(node)
            if fn is not None and fn.name in covered:
                continue
            what = (f"record_request(state={state!r})" if state
                    else "record_done()")
            name = fn.name if fn is not None else "<module>"
            yield (node.lineno,
                   f"{what} in {name}() is not reachable from any "
                   f"claim acquisition ({'/'.join(sorted(CLAIM_ACQUIRERS))})"
                   f" in this file: an unclaimed writer of execution "
                   f"lifecycle lines can duplicate another member's "
                   f"work")
