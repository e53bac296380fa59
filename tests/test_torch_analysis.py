"""The port's analyzer (``iterative_cleaner_torch/analysis/``) on the CPU.

* Each source snippet of the reference's ``tests/test_analysis.py`` for a
  rule the port keeps runs through both analyzers (the JAX package's
  ``lint_source`` and the port's), which must give the same
  ``(rule, line, severity, suppressed)`` set: the port's rules are copies
  of the reference's, so any difference is a port fault.
* Suppression parsing, the report, the repo-wide rules on mini-repos laid
  out as the port's package, the registry exports, the analyzer's CLI
  (``--no-contracts``/``--contracts``, ``--device``, exit codes) and the
  port's ``--selfcheck`` wiring.
* The port's own package lints clean, every suppression with a reason.
* The card contracts on ``device="cpu"``: every registered program holds
  the contracts the CPU decides, and each seeded violation is caught with
  its contract id (an ``.item()`` inside a step, a ``.double()`` on a
  float32 route, an extra op past a pin, a cube-sized ``clone()``, a
  program that raises).  On the card the same programs run in
  ``tests/test_torch_cuda.py``.
"""

import dataclasses
import io
import json
import textwrap

import pytest
import torch

from iterative_cleaner_torch.analysis import card_contracts as cc
from iterative_cleaner_torch.analysis import cli as analysis_cli
from iterative_cleaner_torch.analysis import lint_paths, lint_source
from iterative_cleaner_torch.analysis import rules_threads
from iterative_cleaner_torch.analysis.core import (
    default_rules,
    parse_suppressions,
    record_findings,
)
from iterative_cleaner_torch.telemetry.registry import MetricsRegistry
from iterative_cleaner_tpu.analysis import core as ref_core
from iterative_cleaner_tpu.analysis import rules_threads as ref_threads

PORT_RULES = {r.id for r in default_rules()}


def _port_findings(src, rel, rules=None, root=None):
    return lint_source(textwrap.dedent(src), rel=rel, rules=rules,
                       root=root).findings


def _ref_findings(src, rel, rules=None, root=None):
    if rules is None:
        rules = [r for r in ref_core.default_rules() if r.id in PORT_RULES]
    return ref_core.lint_source(textwrap.dedent(src), rel=rel, rules=rules,
                                root=root).findings


def _shape(findings):
    return sorted((f.rule, f.line, f.severity, f.suppressed)
                  for f in findings)


# --------------------------------------------- snippets, both analyzers

LOCK_NEST = """\
    import fcntl
    from iterative_cleaner_torch.utils.logging import locked_append

    def bad(path, f):
        fcntl.flock(f, fcntl.LOCK_EX)
        locked_append(path, "entry")
    """

JOURNAL_UNCLAIMED = """\
    def finish(j):
        j.record_request("r", "running")

    def acquire(j):
        if j.try_claim("w", host=1, nonce="n", ttl_s=5.0):
            pass
    """

# (id, source, rel, rule, expected: flagged | clean | suppressed)
SNIPPETS = [
    ("suppress-line-above", """\
        import os
        # icln: ignore[atomic-write] -- rename between existing files
        os.replace("a", "b")
        """, "snippet.py", "atomic-write", "suppressed"),
    ("suppress-other-rule", """\
        import os
        os.replace("a", "b")  # icln: ignore[broad-except]
        """, "snippet.py", "atomic-write", "flagged"),
    ("atomic-os-replace", "import os\nos.replace('a', 'b')\n", "snippet.py",
     "atomic-write", "flagged"),
    ("atomic-open-w", "f = open('out.txt', 'w')\n", "snippet.py",
     "atomic-write", "flagged"),
    ("atomic-output-block", """\
        from iterative_cleaner_torch.io.atomic import atomic_output

        def dump(path, data):
            with atomic_output(path) as tmp:
                with open(tmp, "w") as f:
                    f.write(data)
        """, "snippet.py", "atomic-write", "clean"),
    ("atomic-impl-file", "import os\nos.replace('a', 'b')\n",
     "iterative_cleaner_torch/io/atomic.py", "atomic-write", "clean"),
    ("atomic-suppressed",
     "import os\n"
     "os.replace('a', 'b')  # icln: ignore[atomic-write] -- state rename\n",
     "snippet.py", "atomic-write", "suppressed"),
    ("flock-import", "import fcntl\n", "snippet.py", "flock-discipline",
     "flagged"),
    ("flock-from-import", "from fcntl import flock\n", "snippet.py",
     "flock-discipline", "flagged"),
    ("flock-append-open", "f = open('log.txt', 'a')\n", "snippet.py",
     "flock-discipline", "flagged"),
    ("flock-read-open", "f = open('log.txt')\n", "snippet.py",
     "flock-discipline", "clean"),
    ("flock-impl-file", "import fcntl\n",
     "iterative_cleaner_torch/utils/logging.py", "flock-discipline",
     "clean"),
    ("flock-suppressed",
     "import fcntl  # icln: ignore[flock-discipline] -- test harness\n",
     "snippet.py", "flock-discipline", "suppressed"),
    ("lock-order-nested", LOCK_NEST, "snippet.py", "lock-order", "flagged"),
    ("lock-order-callback", """\
        from iterative_cleaner_torch.utils.logging import (
            compact_under_lock, locked_append)

        def compact(path):
            def rewrite(lines):
                locked_append(path, "x")
                return lines
            compact_under_lock(path, rewrite)
        """, "snippet.py", "lock-order", "flagged"),
    ("lock-order-plain", """\
        from iterative_cleaner_torch.utils.logging import locked_append

        def good(path):
            locked_append(path, "entry")
        """, "snippet.py", "lock-order", "clean"),
    ("lock-order-suppressed", LOCK_NEST.replace(
        "import fcntl",
        "import fcntl  # icln: ignore[flock-discipline] -- fixture"
    ).replace(
        'locked_append(path, "entry")',
        'locked_append(path, "entry")  '
        '# icln: ignore[lock-order] -- different file'),
     "snippet.py", "lock-order", "suppressed"),
    ("broad-except-swallow", """\
        def f():
            try:
                risky()
            except Exception:
                pass
        """, "snippet.py", "broad-except", "flagged"),
    ("broad-except-counted", """\
        def f(registry):
            try:
                risky()
            except Exception:
                registry.counter_inc("f_errors")
            try:
                risky()
            except Exception:
                raise
        """, "snippet.py", "broad-except", "clean"),
    ("broad-except-suppressed", """\
        def f():
            try:
                risky()
            except Exception:  # icln: ignore[broad-except] -- crash path must not raise
                pass
        """, "snippet.py", "broad-except", "suppressed"),
    ("journal-unclaimed", JOURNAL_UNCLAIMED, "snippet.py",
     "journal-append-without-claim", "flagged"),
    ("journal-claimed", JOURNAL_UNCLAIMED.replace("pass", "finish(j)"),
     "snippet.py", "journal-append-without-claim", "clean"),
    ("journal-admission", JOURNAL_UNCLAIMED.replace('"running"',
                                                    '"accepted"'),
     "snippet.py", "journal-append-without-claim", "clean"),
    ("journal-claimless-file",
     'def finish(j):\n    j.record_request("r", "done")\n', "snippet.py",
     "journal-append-without-claim", "clean"),
    ("journal-raw-append", 'def log(j):\n    j._append({"event": "req"})\n',
     "snippet.py", "journal-append-without-claim", "flagged"),
    ("journal-suppressed", JOURNAL_UNCLAIMED.replace(
        '        j.record_request("r", "running")',
        '        # icln: ignore[journal-append-without-claim] -- fixture\n'
        '        j.record_request("r", "running")'),
     "snippet.py", "journal-append-without-claim", "suppressed"),
    ("journal-impl-file", 'def log(j):\n    j._append({"event": "req"})\n',
     "iterative_cleaner_torch/resilience/journal.py",
     "journal-append-without-claim", "clean"),
]


@pytest.mark.parametrize("src,rel,rule,expect",
                         [s[1:] for s in SNIPPETS],
                         ids=[s[0] for s in SNIPPETS])
def test_snippet_findings_match_the_reference(src, rel, rule, expect):
    got = _port_findings(src, rel)
    # the reference reads its own package's paths
    ref_rel = rel.replace("iterative_cleaner_torch", "iterative_cleaner_tpu")
    want = _ref_findings(src.replace("iterative_cleaner_torch",
                                     "iterative_cleaner_tpu"), ref_rel)
    assert _shape(got) == _shape(want)
    mine = [f for f in got if f.rule == rule]
    if expect == "clean":
        assert mine == []
    elif expect == "flagged":
        assert mine and not any(f.suppressed for f in mine)
    else:
        assert mine and all(f.suppressed for f in mine)
        assert lint_source(textwrap.dedent(src), rel=rel).ok


THREAD_SHARED = """\
    import threading

    class Daemon:
        def __init__(self):
            self.count = 0
            self._lock = threading.Lock()

        def start(self):
            t = threading.Thread(target=self._worker)
            t.start()

        def bump(self):
            self.count += 1

        def _worker(self):
            self.count += 1
    """

LOCK_BOTH_DIRS = """\
    import fcntl
    import threading

    class S:
        def __init__(self):
            self._lock = threading.Lock()

        def t_then_f(self, j):
            with self._lock:
                j.record_claim("w", host=1, nonce="n", ttl_s=1.0)

        def f_then_t(self, f):
            fcntl.flock(f, fcntl.LOCK_EX)
            with self._lock:
                pass
    """

THREAD_SNIPPETS = [
    ("shared-unlocked", THREAD_SHARED, "ThreadSharedStateRule", "flagged",
     "thread:_worker"),
    ("shared-locked", THREAD_SHARED.replace(
        "            self.count += 1",
        "            with self._lock:\n"
        "                self.count += 1"), "ThreadSharedStateRule",
     "clean", ""),
    ("shared-confined", THREAD_SHARED.replace(
        "        def bump(self):\n            self.count += 1\n", ""),
     "ThreadSharedStateRule", "clean", ""),
    ("shared-callback", """\
        class Sched:
            def wire(self, hooks):
                hooks["tick"] = self._on_tick

            def _on_tick(self):
                self.n = 1

            def poke(self):
                self.n = 2
        """, "ThreadSharedStateRule", "flagged", "callback:_on_tick"),
    ("shared-suppressed", THREAD_SHARED.replace(
        "        def bump(self):\n            self.count += 1",
        "        def bump(self):\n"
        "            # icln: ignore[thread-shared-state] -- fixture\n"
        "            self.count += 1"), "ThreadSharedStateRule",
     "suppressed", ""),
    ("lock-order-both", LOCK_BOTH_DIRS, "ThreadLockOrderRule", "flagged",
     "inverts the sanctioned T->F order"),
    ("lock-order-one-way", LOCK_BOTH_DIRS.replace(
        "            fcntl.flock(f, fcntl.LOCK_EX)\n"
        "            with self._lock:\n"
        "                pass\n",
        "            fcntl.flock(f, fcntl.LOCK_EX)\n"), "ThreadLockOrderRule",
     "clean", ""),
    ("lock-order-suppressed", LOCK_BOTH_DIRS.replace(
        '                j.record_claim("w", host=1, nonce="n", '
        'ttl_s=1.0)',
        "                # icln: ignore[thread-lock-order] -- fixture\n"
        '                j.record_claim("w", host=1, nonce="n", '
        'ttl_s=1.0)'
    ).replace(
        "            with self._lock:\n                pass",
        "            # icln: ignore[thread-lock-order] -- fixture\n"
        "            with self._lock:\n                pass"),
     "ThreadLockOrderRule", "suppressed", ""),
]


@pytest.mark.parametrize("src,rule,expect,needle",
                         [s[1:] for s in THREAD_SNIPPETS],
                         ids=[s[0] for s in THREAD_SNIPPETS])
def test_thread_rule_findings_match_the_reference(src, rule, expect,
                                                  needle):
    """The repo-wide thread rules need a root: each runs alone on the
    snippet, as the reference's tests run them."""
    got = _port_findings(src, "serve/mod.py",
                         rules=[getattr(rules_threads, rule)()], root=".")
    want = _ref_findings(src, "serve/mod.py",
                         rules=[getattr(ref_threads, rule)()], root=".")
    assert _shape(got) == _shape(want)
    assert [f.message for f in got] == [f.message for f in want]
    if expect == "clean":
        assert got == []
    elif expect == "flagged":
        assert got and not any(f.suppressed for f in got)
        assert any(needle in f.message for f in got)
    else:
        assert got and all(f.suppressed for f in got)


def test_port_rules_are_the_reference_rules_less_the_traced_ones():
    ref_ids = {r.id for r in ref_core.default_rules()}
    assert ref_ids - PORT_RULES == {"jit-purity", "static-hashable",
                                    "donation-safety"}
    assert PORT_RULES <= ref_ids


# ---------------------------------------------------------------- engine

def test_parse_suppressions_rules_and_reason():
    text = ("x = 1  # icln: ignore[foo, bar] -- because reasons\n"
            "y = 2\n"
            "z = 3  # icln: ignore[baz]\n")
    sup = parse_suppressions(text)
    assert sup == ref_core.parse_suppressions(text)
    assert sup[1][0] == {"foo", "bar"}
    assert sup[1][1] == "because reasons"
    assert 2 not in sup
    assert sup[3][0] == {"baz"}


def test_suppression_reason_reaches_the_finding():
    found = [f for f in _port_findings(
        "import os\n"
        "os.replace('a', 'b')  # icln: ignore[atomic-write] -- state rename\n",
        "snippet.py") if f.rule == "atomic-write"]
    assert found[0].suppressed and found[0].reason == "state rename"


def test_syntax_error_fails_report():
    report = lint_source("def broken(:\n")
    assert report.parse_errors
    assert not report.ok


def test_report_render_text_summary_line():
    report = lint_source("import os\nos.replace('a', 'b')\n")
    text = report.render_text()
    assert "1 file scanned" in text
    assert "atomic-write" in text


# ------------------------------------------------------- repo-wide rules

CONFIG_SRC = """\
class CleanConfig:
    a: int = 1
    b: float = 2.0
{extra}
"""

CHECKPOINT_SRC = """\
_IDENTITY_FIELDS = frozenset({include})
_IDENTITY_EXCLUDE = frozenset({exclude})
"""


def make_repo(tmp_path, *, config=None, checkpoint=None, cli_src="",
              migration="", readme="", extra_module=""):
    """A mini-repo laid out as the port's package."""
    pkg = tmp_path / "iterative_cleaner_torch"
    (pkg / "utils").mkdir(parents=True)
    (pkg / "config.py").write_text(
        config if config is not None else CONFIG_SRC.format(extra=""))
    (pkg / "utils" / "checkpoint.py").write_text(
        checkpoint if checkpoint is not None
        else CHECKPOINT_SRC.format(include="{'a'}", exclude="{'b'}"))
    (pkg / "cli.py").write_text(cli_src)
    if extra_module:
        (pkg / "extra.py").write_text(extra_module)
    (tmp_path / "MIGRATION.md").write_text(migration)
    (tmp_path / "README.md").write_text(readme)
    return pkg


def repo_rule_findings(tmp_path, rule_id, **kwargs):
    pkg = make_repo(tmp_path, **kwargs)
    report = lint_paths([str(pkg)], root=str(tmp_path))
    return [f for f in report.findings if f.rule == rule_id]


def test_config_identity_partition_complete(tmp_path):
    assert repo_rule_findings(tmp_path, "config-identity") == []


@pytest.mark.parametrize("kwargs,needle", [
    (dict(config=CONFIG_SRC.format(extra="    c: str = 'x'")),
     "CleanConfig.c"),
    (dict(checkpoint=CHECKPOINT_SRC.format(include="{'a', 'zombie'}",
                                           exclude="{'b'}")), "zombie"),
    (dict(checkpoint=CHECKPOINT_SRC.format(include="{'a', 'b'}",
                                           exclude="{'b'}")), "both"),
], ids=["unclassified", "stale", "double"])
def test_config_identity_flags(tmp_path, kwargs, needle):
    found = repo_rule_findings(tmp_path, "config-identity", **kwargs)
    assert found and needle in found[0].message


def test_config_identity_reads_the_ports_checkpoint_module():
    """The rule partitions the port's CleanConfig against the port's
    ``utils/checkpoint.py`` (``_IDENTITY_EXCLUDE``), not the reference's:
    the port's package lints clean, and the rule names the port's
    files."""
    from iterative_cleaner_torch.analysis.rules_project import (
        ConfigIdentityRule,
    )

    report = lint_paths(rules=[ConfigIdentityRule()])
    assert report.findings == []
    assert "utils/checkpoint.py" in ConfigIdentityRule.description


def test_env_drift_flags_undocumented_env(tmp_path):
    found = repo_rule_findings(
        tmp_path, "env-drift",
        extra_module="import os\nv = os.environ.get('ICLEAN_ZAP')\n",
        migration="nothing here\n")
    messages = " ".join(f.message for f in found)
    assert "ICLEAN_ZAP" in messages and "MIGRATION.md" in messages


@pytest.mark.parametrize("doc", ["migration", "readme"])
def test_env_drift_satisfied_by_doc_row_and_mirror_flag(tmp_path, doc):
    """A port-only knob's row lives in the README's port section."""
    assert repo_rule_findings(
        tmp_path, "env-drift",
        extra_module="import os\nv = os.environ.get('ICLEAN_ZAP')\n",
        cli_src="p.add_argument('--zap')\n",
        **{doc: "| ICLEAN_ZAP | --zap | zaps |\n"}) == []


def test_env_drift_env_only_allowlist_needs_no_mirror(tmp_path):
    assert repo_rule_findings(
        tmp_path, "env-drift",
        extra_module="import os\nv = os.environ.get('ICLEAN_STREAM_IDLE_S')\n",
        migration="ICLEAN_STREAM_IDLE_S closes an idle stream\n") == []


def test_env_only_lists_only_knobs_the_port_reads():
    """No TPU-only knob of the reference's allowlist stays in the port's:
    each entry is read somewhere in the port's package."""
    from iterative_cleaner_torch.analysis.rules_project import ENV_ONLY

    text = "\n".join(ctx.source for ctx in _package_files()
                     if not ctx.rel.endswith("analysis/rules_project.py"))
    for name in ENV_ONLY:
        assert name in text, name
    assert not {"ICLEAN_DFT_PRECISION", "ICLEAN_SWEEP_DMA",
                "ICLEAN_SCALER_VMEM_MB", "ICLEAN_PLATFORM"} & ENV_ONLY


def _package_files():
    from iterative_cleaner_torch.analysis.core import (
        _load,
        find_repo_root,
        iter_python_files,
    )

    root = find_repo_root()
    return [_load(p, root) for p in iter_python_files(root)]


def test_flag_docs_flags_undocumented_flag(tmp_path):
    found = repo_rule_findings(
        tmp_path, "flag-docs",
        cli_src="p.add_argument('--zap')\n",
        readme="usage\n", migration="notes\n")
    assert found and "--zap" in found[0].message


def test_flag_docs_satisfied_by_readme_mention(tmp_path):
    assert repo_rule_findings(
        tmp_path, "flag-docs",
        cli_src="p.add_argument('--zap')\n",
        readme="pass `--zap` to zap\n") == []


def test_flag_docs_skips_when_docs_absent(tmp_path):
    assert repo_rule_findings(
        tmp_path, "flag-docs",
        cli_src="p.add_argument('--zap')\n") == []


# --------------------------------------------------------- metrics wiring

def test_record_findings_exports_labeled_counters():
    report = lint_source("import os\nos.replace('a', 'b')\n")
    reg = MetricsRegistry()
    record_findings(reg, report)
    snap = reg.snapshot()
    assert snap["counters"]["lint_findings{rule=atomic-write}"] == 1
    assert snap["gauges"]["lint_files_scanned"] == 1
    assert snap["gauges"]["lint_ok"] == 0


def test_record_package_lint_populates_registry():
    reg = MetricsRegistry()
    report = analysis_cli.record_package_lint(reg)
    assert report is not None
    snap = reg.snapshot()
    assert snap["gauges"]["lint_files_scanned"] > 50
    assert snap["gauges"]["lint_ok"] == 1
    assert any(k.startswith("lint_suppressed{rule=")
               for k in snap["counters"])
    assert not any(k.startswith("lint_findings{") for k in snap["counters"])


def test_record_package_lint_never_raises(monkeypatch):
    def boom(*a, **k):
        raise OSError("unreadable")

    monkeypatch.setattr(analysis_cli, "lint_paths", boom)
    reg = MetricsRegistry()
    assert analysis_cli.record_package_lint(reg) is None
    assert reg.snapshot()["counters"]["lint_run_errors"] == 1


def test_run_selfcheck_records_findings_and_fails(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import os\nos.replace('a', 'b')\n")
    reg = MetricsRegistry()
    out = io.StringIO()
    rc = analysis_cli.run_selfcheck(paths=[str(bad)], contracts=False,
                                    registry=reg, stream=out)
    assert rc == 1
    assert reg.snapshot()["counters"]["lint_findings{rule=atomic-write}"] == 1
    assert "atomic-write" in out.getvalue()


# ------------------------------------------------------------- lint CLI

def test_lint_cli_exit_codes(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import os\nos.replace('a', 'b')\n")
    good = tmp_path / "good.py"
    good.write_text("x = 1\n")
    assert analysis_cli.main([str(bad)]) == 1
    assert analysis_cli.main([str(good)]) == 0
    assert analysis_cli.main([str(tmp_path / "missing.py")]) == 2


def test_lint_cli_json_output(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text("import fcntl\n")
    rc = analysis_cli.main([str(bad), "--format", "json"])
    doc = json.loads(capsys.readouterr().out)
    assert rc == 1
    assert doc["ok"] is False
    assert doc["findings"][0]["rule"] == "flock-discipline"
    assert doc["contracts"] == []


@pytest.mark.parametrize("argv,want", [
    ([], True),                          # the package: contracts on
    (["--no-contracts"], False),
    (["x.py"], False),                   # explicit paths: lint only
    (["x.py", "--contracts"], True),     # ...unless forced
    (["--contracts"], True),
])
def test_contracts_flag_logic(argv, want):
    args = analysis_cli.build_arg_parser().parse_args(argv)
    assert analysis_cli.contracts_enabled(args) is want
    assert args.device == "cuda"


def test_contracts_flags_conflict_is_a_usage_error():
    args = analysis_cli.build_arg_parser().parse_args(
        ["--contracts", "--no-contracts"])
    with pytest.raises(SystemExit) as ei:
        analysis_cli.contracts_enabled(args)
    assert ei.value.code == 2


def test_explicit_paths_with_contracts_run_them_on_the_device(tmp_path,
                                                              capsys):
    good = tmp_path / "good.py"
    good.write_text("x = 1\n")
    rc = analysis_cli.main([str(good), "--contracts", "--device", "cpu",
                            "--format", "json"])
    doc = json.loads(capsys.readouterr().out)
    assert rc == 0 and doc["ok"]
    assert {c["program"] for c in doc["contracts"]} == {
        p.name for p in cc.HOT_PROGRAMS}
    assert all(c["device"] == "cpu" for c in doc["contracts"])


def test_no_card_exits_2_naming_device_cpu(monkeypatch, capsys):
    """Without a card the contracts never move to the CPU by themselves:
    exit 2, the message naming ``--device cpu``, nothing linted."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert analysis_cli.run_selfcheck(device="cuda") == 2
    assert "--device cpu" in capsys.readouterr().err
    assert analysis_cli.main(["--device", "cuda"]) == 2
    with pytest.raises(RuntimeError, match="--device cpu"):
        cc.verify_hot_programs("cuda")
    # lint alone needs no device
    assert analysis_cli.main(["--no-contracts"]) == 0


def test_cli_journal_fsck_gate(tmp_path, capsys):
    from iterative_cleaner_torch.resilience.journal import FleetJournal

    j = FleetJournal(str(tmp_path / "good.jsonl"))
    j.record_request("r", "accepted")
    j.record_request("r", "done")
    assert analysis_cli.main(["--journal-fsck", j.path]) == 0
    assert "ok" in capsys.readouterr().out

    bad = tmp_path / "bad.jsonl"
    bad.write_text(
        json.dumps({"schema": "icln-fleet-journal/1", "event": "req",
                    "req": "r", "state": "done"}) + "\n"
        + json.dumps({"schema": "icln-fleet-journal/1", "event": "req",
                      "req": "r", "state": "running"}) + "\n")
    assert analysis_cli.main(["--journal-fsck", str(bad)]) == 1
    assert "after terminal" in capsys.readouterr().out


def test_cli_concurrency_gates_reject_lint_paths(tmp_path):
    with pytest.raises(SystemExit):
        analysis_cli.main(["--journal-fsck", "j.jsonl", str(tmp_path)])
    with pytest.raises(SystemExit):
        analysis_cli.main(["--race-sweep", str(tmp_path)])


# ---------------------------------------------------- the port's wiring

def test_port_selfcheck_device_cpu_exits_0(tmp_path, monkeypatch, capsys):
    """``python -m iterative_cleaner_torch --selfcheck --device cpu``: zero
    unsuppressed findings and every contract the CPU decides ok; the
    journal fsck rides along and counts toward the exit status."""
    from iterative_cleaner_torch.cli import main
    from iterative_cleaner_torch.resilience.journal import FleetJournal

    monkeypatch.chdir(tmp_path)
    j = FleetJournal("j.jsonl")
    j.record_request("r", "accepted")
    assert main(["--selfcheck", "--device", "cpu", "--format", "json",
                 "--journal-fsck", "j.jsonl"]) == 0
    out = capsys.readouterr().out
    doc = json.loads(out[out.index("{\n"):])
    assert doc["ok"] and doc["findings"] == []
    assert all(c["ok"] for c in doc["contracts"])
    with open("j.jsonl", "a") as f:
        f.write(json.dumps({"schema": "icln-fleet-journal/1",
                            "event": "wat"}) + "\n")
    assert main(["--selfcheck", "--device", "cpu", "--journal-fsck",
                 "j.jsonl"]) == 1


def test_port_selfcheck_without_a_card_exits_nonzero(monkeypatch, capsys):
    from iterative_cleaner_torch.cli import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(["--selfcheck"]) == 2
    assert "--device cpu" in capsys.readouterr().err


@pytest.mark.parametrize("argv", [
    ["--selfcheck", "obs.npz"],
    ["--selfcheck", "--fleet"],
    ["--selfcheck", "--serve", "--spool", "s"],
    ["--selfcheck", "--stream", "4"],
    ["--format", "json", "obs.npz"],
    ["--selfcheck-format", "text", "obs.npz"],
    ["--journal-fsck", "j.jsonl", "obs.npz"],
])
def test_port_selfcheck_parser_errors(argv, tmp_path, monkeypatch):
    from iterative_cleaner_torch.cli import main

    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as ei:
        main(["--device", "cpu", *argv])
    assert ei.value.code == 2


def test_precompile_session_exports_the_lint_verdict(tmp_path,
                                                     monkeypatch):
    from iterative_cleaner_torch.cli import main

    monkeypatch.chdir(tmp_path)
    assert main(["--device", "cpu", "-q", "--precompile", "--compile-cache",
                 "cc", "--metrics-json", "run.json", "8x16x32"]) == 0
    with open("run.json") as f:
        doc = json.load(f)
    assert doc["gauges"]["lint_ok"] == 1
    assert doc["gauges"]["lint_files_scanned"] > 50


# ------------------------------------------------------ repo-wide gate

def test_port_package_lints_clean_with_reasons():
    report = lint_paths()
    assert report.unsuppressed == [], \
        "\n".join(f.render() for f in report.unsuppressed)
    assert not report.parse_errors
    assert report.files_scanned > 50
    assert all(f.reason for f in report.suppressed), \
        [f.render() for f in report.suppressed if not f.reason]


# ------------------------------------------------------ card contracts

@pytest.mark.parametrize("name", [p.name for p in cc.HOT_PROGRAMS])
def test_card_contracts_hold_on_the_cpu(name):
    report = cc.verify_program(cc.program_named(name), "cpu")
    assert report.ok, [v.render() for v in report.violations]
    assert report.decided == cc.DECIDES["cpu"]
    assert report.iterations >= 1 and report.ops > 0
    # the plain versions read nothing back: the CPU's count is the card's
    assert report.host_reads == cc.program_named(name).host_reads \
        * report.iterations


def _toy(device):
    """A program of two plane ops beside a resident cube, for the
    contracts the CPU does not decide (the plain kernel versions make
    cube-sized tensors of their own)."""
    cube = torch.randn(cc.NSUB, cc.NCHAN, cc.NBIN, device=device)
    w = torch.ones(cc.NSUB, cc.NCHAN, device=device)
    return cc.HotRun(call=lambda: (w * 2.0).sum(dim=1), cubes=(cube,),
                     cube_bytes=cube.numel() * cube.element_size(),
                     kernels={}, probe=w)


TOY = cc.HotProgram("toy", _toy, host_reads=0, max_ops=2)


def test_toy_program_holds_every_contract():
    report = cc.verify_program(TOY, "cpu", decide=cc.CONTRACTS)
    assert report.ok, [v.render() for v in report.violations]
    assert report.ops == 2


@pytest.mark.parametrize("seed,program", [
    ("host-sync", "online_step"),     # an .item() inside a step
    ("f64", "online_step"),           # a .double() on a float32 route
    ("f64", "clean_loop"),
    ("host-sync", "sweep"),
    ("raise", "clean_loop"),          # a program that raises
])
def test_seeded_violation_is_caught_on_the_cpu(seed, program):
    report = cc.verify_program(cc.seeded(cc.program_named(program), seed),
                               "cpu")
    assert not report.ok
    assert cc.SEEDS[seed] in {v.contract for v in report.violations}
    if seed == "host-sync":
        assert report.host_reads == report.iterations * (
            cc.program_named(program).host_reads + 1)


@pytest.mark.parametrize("seed", ["extra-op", "cube-copy"])
def test_seeded_card_contract_is_caught_by_the_checker(seed):
    """An extra op past a pin, a cube-sized ``clone()``: the contracts
    the card decides, held here on a program of plane ops (forced with
    ``decide``)."""
    report = cc.verify_program(cc.seeded(TOY, seed), "cpu",
                               decide=cc.CONTRACTS)
    contracts = {v.contract for v in report.violations}
    assert cc.SEEDS[seed] in contracts
    if seed == "cube-copy":
        # the clone also reads the cube outside its kernels
        assert "single-cube-read" in contracts


def test_extra_op_past_the_cpu_count_of_a_real_step():
    """Pinned at the step's own count, one extra op per step fails the
    dispatch bound and the clean step passes it."""
    program = cc.program_named("online_step")
    clean = cc.verify_program(program, "cpu")
    pinned = dataclasses.replace(program,
                                 max_ops=clean.ops + clean.launches)
    assert cc.verify_program(pinned, "cpu", decide=("dispatch-bound",)).ok
    bad = cc.verify_program(cc.seeded(pinned, "extra-op"), "cpu",
                            decide=("dispatch-bound",))
    assert [v.contract for v in bad.violations] == ["dispatch-bound"]


def test_unknown_seed_and_program_are_rejected():
    with pytest.raises(ValueError, match="unknown seed"):
        cc.seeded(TOY, "nope")
    with pytest.raises(KeyError):
        cc.program_named("nope")


def test_report_renders_and_serialises():
    report = cc.verify_program(cc.program_named("online_step"), "cpu")
    d = report.to_dict()
    assert d["ok"] and d["host_reads_per_iter"] == 0
    assert d["peak_delta_bytes"] is None and d["sync_warnings_per_iter"] is None
    assert "contracts online_step on cpu: ok" in report.render()
