"""Filesystem-discipline rules: atomic writes, flock'd appends, lock order.

The project's durability story rests on two chokepoints:

* every output file lands via ``io/atomic.py``'s :func:`atomic_output`
  (same-directory temp + ``os.replace``), so a kill -9 never leaves a
  torn file where a consumer expects a whole one;
* every shared append (journal, spool ledger, clean log) goes through
  ``utils/logging.py``'s ``locked_append``/``compact_under_lock``
  (flock + inode-swap recheck), so concurrent hosts never interleave
  partial records.

These rules make bypassing either chokepoint a lint error.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Tuple

from iterative_cleaner_torch.analysis.core import FileContext, Rule

#: the sanctioned implementation sites (repo-relative suffixes)
ATOMIC_IMPL = ("io/atomic.py",)
FLOCK_IMPL = ("utils/logging.py",)

#: helpers that take the per-file flock internally
LOCK_HELPERS = frozenset({
    "locked_append", "compact_under_lock", "seal_log", "trim_log",
    "rotate_log", "append_clean_log",
})


def _is_impl(ctx: FileContext, suffixes) -> bool:
    return any(ctx.rel.endswith(s) for s in suffixes)


def _attr_chain(node: ast.AST) -> str:
    """Dotted name of an Attribute/Name chain ('' when not a plain chain)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _open_mode(call: ast.Call) -> str:
    """The literal mode string of an ``open()`` call, or '' if unknown."""
    mode = None
    if len(call.args) >= 2:
        mode = call.args[1]
    for kw in call.keywords:
        if kw.arg == "mode":
            mode = kw.value
    if mode is None:
        return "r"
    if isinstance(mode, ast.Constant) and isinstance(mode.value, str):
        return mode.value
    return ""


def _atomic_output_names(ctx: FileContext) -> List[Tuple[str, int, int]]:
    """(name, first_line, last_line) for every ``with atomic_output(...)
    as NAME`` block — writes to NAME inside the block are sanctioned."""
    spans = []
    for node in ctx.nodes:
        if not isinstance(node, (ast.With, ast.AsyncWith)):
            continue
        for item in node.items:
            call = item.context_expr
            if not isinstance(call, ast.Call):
                continue
            chain = _attr_chain(call.func)
            if chain.split(".")[-1] != "atomic_output":
                continue
            if isinstance(item.optional_vars, ast.Name):
                end = getattr(node, "end_lineno", node.lineno)
                spans.append((item.optional_vars.id, node.lineno, end))
    return spans


class AtomicWriteRule(Rule):
    """Output files must be written through ``io/atomic.py``."""

    id = "atomic-write"
    severity = "error"
    description = ("os.replace and write-mode open() belong in "
                   "io/atomic.py; write outputs inside "
                   "`with atomic_output(path) as tmp:`")

    def check(self, ctx: FileContext) -> Iterable[Tuple[int, str]]:
        if _is_impl(ctx, ATOMIC_IMPL) or _is_impl(ctx, FLOCK_IMPL):
            return
        sanctioned = _atomic_output_names(ctx)
        for node in ctx.nodes:
            if not isinstance(node, ast.Call):
                continue
            chain = _attr_chain(node.func)
            if chain == "os.replace":
                yield (node.lineno,
                       "direct os.replace bypasses io/atomic.py: write "
                       "through `with atomic_output(path) as tmp:` (or "
                       "suppress if this is a rename between existing "
                       "files, not a publish)")
                continue
            if chain not in ("open", "io.open"):
                continue
            mode = _open_mode(node)
            if not any(c in mode for c in "wx+"):
                continue
            target = node.args[0] if node.args else None
            if isinstance(target, ast.Name) and any(
                    target.id == name and lo <= node.lineno <= hi
                    for name, lo, hi in sanctioned):
                continue
            yield (node.lineno,
                   f"open(..., {mode!r}) outside an atomic_output block: "
                   "a crash mid-write leaves a torn file; route through "
                   "io/atomic.py")


class FlockDisciplineRule(Rule):
    """Shared appends and flock use belong in ``utils/logging.py``."""

    id = "flock-discipline"
    severity = "error"
    description = ("fcntl locking and append-mode open() belong in "
                   "utils/logging.py (locked_append / "
                   "compact_under_lock)")

    def check(self, ctx: FileContext) -> Iterable[Tuple[int, str]]:
        if _is_impl(ctx, FLOCK_IMPL):
            return
        for node in ctx.nodes:
            if isinstance(node, ast.Import):
                if any(a.name == "fcntl" for a in node.names):
                    yield (node.lineno,
                           "direct fcntl use outside utils/logging.py: "
                           "take file locks through locked_append/"
                           "compact_under_lock so lock ordering stays "
                           "auditable")
            elif isinstance(node, ast.ImportFrom):
                if node.module == "fcntl":
                    yield (node.lineno,
                           "direct fcntl use outside utils/logging.py: "
                           "take file locks through locked_append/"
                           "compact_under_lock so lock ordering stays "
                           "auditable")
            elif isinstance(node, ast.Call):
                chain = _attr_chain(node.func)
                if chain not in ("open", "io.open"):
                    continue
                if "a" in _open_mode(node):
                    yield (node.lineno,
                           "append-mode open() outside utils/logging.py: "
                           "concurrent writers interleave partial "
                           "records; use locked_append")


class LockOrderRule(Rule):
    """No nested acquisition of the per-file flock.

    Two shapes deadlock (flock is not re-entrant across fds on some
    filesystems, and a second EX acquisition under the first self-blocks
    with LOCK_NB disabled): a function that calls ``fcntl.flock`` AND one
    of the lock-taking helpers, and a rewrite callback handed to
    ``compact_under_lock`` that itself calls a lock-taking helper (the
    callback runs under the compact lock)."""

    id = "lock-order"
    severity = "error"
    description = ("never call a lock-taking helper while already "
                   "holding the file flock")

    def check(self, ctx: FileContext) -> Iterable[Tuple[int, str]]:
        for fn in ctx.nodes:
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            flock_line = None
            helper = None
            local_defs = {}
            for node in ast.walk(fn):
                if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)) and node is not fn:
                    local_defs[node.name] = node
                if not isinstance(node, ast.Call):
                    continue
                chain = _attr_chain(node.func)
                leaf = chain.split(".")[-1]
                if leaf == "flock":
                    flock_line = flock_line or node.lineno
                elif leaf in LOCK_HELPERS:
                    helper = helper or (node.lineno, leaf)
                if leaf == "compact_under_lock" and node.args:
                    for arg in node.args:
                        if isinstance(arg, ast.Name) \
                                and arg.id in local_defs:
                            cb = local_defs[arg.id]
                            for inner in ast.walk(cb):
                                if isinstance(inner, ast.Call):
                                    ileaf = _attr_chain(
                                        inner.func).split(".")[-1]
                                    if ileaf in LOCK_HELPERS \
                                            or ileaf == "flock":
                                        yield (inner.lineno,
                                               f"rewrite callback "
                                               f"{arg.id!r} runs under "
                                               f"the compact lock but "
                                               f"calls {ileaf}(): nested "
                                               f"flock self-deadlocks")
            if flock_line is not None and helper is not None:
                yield (helper[0],
                       f"{fn.name}() holds a raw flock and calls "
                       f"{helper[1]}(), which takes the same lock again: "
                       "nested flock self-deadlocks")
