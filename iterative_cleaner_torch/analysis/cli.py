"""`icln-lint-torch` console entry point and the --selfcheck driver.

Besides the AST rules and the card contracts (:mod:`.card_contracts`,
run on ``--device``, ``cuda`` unless ``--device cpu`` is given: with no
card they exit 2 naming ``--device cpu``, never falling back to the
CPU by themselves), two concurrency gates live here: ``--journal-fsck PATH`` validates an on-disk fleet
journal against the protocol state machine
(:mod:`~iterative_cleaner_torch.analysis.journal_fsck`), and
``--race-sweep`` runs the deterministic interleaving model checker
(:mod:`~iterative_cleaner_torch.analysis.interleave`) over every protocol
scenario — a failing schedule is minimized and written to
``--race-out`` as the CI artifact.

Exit codes: 0 clean (suppressed findings allowed), 1 unsuppressed
findings, contract violations, fsck errors or a race counterexample,
2 usage/internal error — so CI can gate on the bare exit status.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional, Sequence

from iterative_cleaner_torch.analysis.core import (
    lint_paths,
    record_findings,
    report_json,
)


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="icln-lint-torch",
        description="Project-invariant static analyzer for "
                    "iterative_cleaner_torch (AST rules + card contracts "
                    "on the hot programs). Zero unsuppressed findings = "
                    "exit 0.")
    p.add_argument("paths", nargs="*",
                   help="files or directories to lint (default: the "
                        "installed iterative_cleaner_torch package)")
    p.add_argument("--format", choices=("text", "json"), default="text",
                   help="finding output format (default: text)")
    p.add_argument("--no-contracts", action="store_true",
                   help="skip the card contracts (AST rules only; the "
                        "default when explicit paths are given)")
    p.add_argument("--contracts", action="store_true",
                   help="force the card contracts even with explicit "
                        "paths")
    p.add_argument("--device", default="cuda",
                   help="the device the card contracts run on (default: "
                        "cuda; cpu decides no-host-sync and no-f64 "
                        "only). There is no fallback: cuda with no card "
                        "exits 2")
    p.add_argument("--show-suppressed", action="store_true",
                   help="include suppressed findings in text output")
    p.add_argument("--journal-fsck", action="append", default=[],
                   metavar="JOURNAL",
                   help="validate a fleet journal — a file, or a "
                        "segmented journal directory (manifest grammar "
                        "+ every segment + shard routing) — against "
                        "the protocol state machine (grammar, request "
                        "lifecycle, lease monotonicity, torn tail); "
                        "repeatable; standalone — skips the lint pass")
    p.add_argument("--race-sweep", action="store_true",
                   help="run the deterministic interleaving model "
                        "checker over every journal-lease protocol "
                        "scenario (exhaustive DFS + seeded random "
                        "tail); standalone — skips the lint pass")
    p.add_argument("--race-schedules", type=int, default=5000,
                   help="max schedules explored per scenario "
                        "(default: 5000)")
    p.add_argument("--race-budget", type=float, default=None,
                   help="wall-clock budget in seconds for the whole "
                        "sweep (default: $ICLEAN_RACE_BUDGET_S or 120)")
    p.add_argument("--race-seed", type=int, default=0,
                   help="seed for the bounded-random tail (default: 0)")
    p.add_argument("--race-out", metavar="PATH", default=None,
                   help="write the minimized counterexample schedule "
                        "here when the sweep fails (the CI artifact)")
    return p


def contracts_enabled(args) -> bool:
    """Whether the card contracts run: on by default, off with
    ``--no-contracts``; explicit lint paths mean lint only unless
    ``--contracts`` forces them.  Both flags at once are a usage error."""
    if args.contracts and args.no_contracts:
        build_arg_parser().error("--contracts and --no-contracts conflict")
    return not args.no_contracts if not args.paths else args.contracts


def _device_ready(device: str) -> bool:
    """The contracts' device is there: a CUDA device needs a card (the
    message names ``--device cpu``); anything but cpu or cuda is refused."""
    import torch

    try:
        kind = torch.device(device).type
    except RuntimeError:
        kind = str(device)
    if kind == "cuda" and not torch.cuda.is_available():
        print("icln-lint-torch: error: the card contracts run on the card "
              "and no CUDA device is present; pass --device cpu to hold "
              "the contracts the CPU decides (no-host-sync, no-f64)",
              file=sys.stderr)
        return False
    if kind not in ("cpu", "cuda"):
        print(f"icln-lint-torch: error: unsupported --device {device!r} "
              f"(cpu or cuda)", file=sys.stderr)
        return False
    return True


def run_journal_fsck(paths: Sequence[str], *, fmt: str = "text",
                     stream=None, registry=None) -> int:
    """Fsck each journal; exit 0 only when every one is error-free."""
    out = stream if stream is not None else sys.stdout
    from iterative_cleaner_torch.analysis.journal_fsck import (
        fsck_journal,
        record_fsck,
    )

    ok = True
    reports = []
    for path in paths:
        report = fsck_journal(path)
        reports.append(report)
        ok = ok and report.ok
        if registry is not None:
            record_fsck(registry, report)
        if fmt != "json":
            print(report.render_text(), file=out)
    if fmt == "json":
        import json

        print(json.dumps({"ok": ok,
                          "journals": [r.to_dict() for r in reports]},
                         indent=2, sort_keys=True), file=out)
    return 0 if ok else 1


def run_race_sweep(*, max_schedules: int = 5000,
                   budget_s: Optional[float] = None, seed: int = 0,
                   out_path: Optional[str] = None, stream=None) -> int:
    """Model-check every clean protocol scenario; on failure, write the
    minimized counterexample schedule to ``out_path``."""
    out = stream if stream is not None else sys.stdout
    if budget_s is None:
        budget_s = float(os.environ.get("ICLEAN_RACE_BUDGET_S", "120"))
    from iterative_cleaner_torch.analysis.interleave import sweep

    results = sweep(max_schedules=max_schedules, budget_s=budget_s,
                    seed=seed, stream=out)
    failed = [r for r in results if not r.ok]
    if failed and out_path:
        from iterative_cleaner_torch.io.atomic import atomic_output

        with atomic_output(out_path) as tmp:
            with open(tmp, "w", encoding="utf-8") as f:
                for r in failed:
                    f.write(r.render() + "\n")
        print(f"race-sweep: counterexample written to {out_path}",
              file=out)
    if not failed and all(not r.budget_exhausted for r in results):
        print("race-sweep: all scenarios explored exhaustively",
              file=out)
    return 0 if not failed else 1


def run_selfcheck(*, paths: Optional[Sequence[str]] = None,
                  fmt: str = "text", contracts: bool = True,
                  device: str = "cuda",
                  show_suppressed: bool = False,
                  journal_fsck: Sequence[str] = (),
                  registry=None, stream=None) -> int:
    """Lint + (optionally) hold the card contracts on ``device``; render
    a report.  With ``contracts`` on ``cuda`` and no card it returns 2
    at once, naming ``--device cpu``: the contracts never move to the
    CPU by themselves.

    ``journal_fsck`` paths are additionally validated against the
    journal state machine and count toward the exit status.
    ``registry`` receives ``lint_findings{rule=...}`` counters when
    given, so the serve daemon and the --precompile session export
    analyzer results alongside their run metrics."""
    out = stream if stream is not None else sys.stdout
    if contracts and not _device_ready(device):
        return 2
    fsck_rc = 0
    if journal_fsck:
        fsck_rc = run_journal_fsck(journal_fsck, fmt="text", stream=out,
                                   registry=registry)
    report = lint_paths(paths)
    program_reports = []
    if contracts:
        from iterative_cleaner_torch.analysis.card_contracts import (
            verify_hot_programs,
        )

        program_reports = verify_hot_programs(device)
    violations = [v for r in program_reports for v in r.violations]
    if registry is not None:
        record_findings(registry, report)
        from iterative_cleaner_torch.telemetry.registry import labeled

        for v in violations:
            registry.counter_inc(labeled("lint_findings",
                                         rule="contract-" + v.contract))
        if contracts:
            registry.gauge_set("card_contract_violations",
                               len(violations))
    ok = report.ok and not violations and fsck_rc == 0
    if fmt == "json":
        print(report_json(report, {
            "contracts": [r.to_dict() for r in program_reports],
            "ok": ok,
        }), file=out)
    else:
        text = report.render_text(show_suppressed=show_suppressed)
        if text:
            print(text, file=out)
        for r in program_reports:
            print(r.render(), file=out)
            for v in r.violations:
                print("  " + v.render(), file=out)
    return 0 if ok else 1


def record_package_lint(registry, *, quiet: bool = True):
    """AST-lint the installed package straight into a registry — no card
    contracts, so it costs about a second at daemon/precompile startup.  Serve's
    live ``/metrics`` and the --precompile session's exporters then carry
    ``lint_findings{rule=...}`` / ``lint_ok`` for the build that is
    actually running.  Never raises: an analyzer crash must not take the
    daemon down (it is counted as ``lint_run_errors``)."""
    try:
        report = lint_paths()
        record_findings(registry, report)
        if not report.ok and not quiet:
            print("WARNING: icln-lint-torch: %d unsuppressed finding(s) in "
                  "the running build; run --selfcheck for details"
                  % len(report.unsuppressed), file=sys.stderr)
        return report
    except Exception as exc:  # icln: ignore[broad-except] -- startup analyzer pass is advisory: counted, warned, never fatal to the daemon
        registry.counter_inc("lint_run_errors")
        if not quiet:
            print(f"WARNING: icln-lint-torch startup pass failed: "
                  f"{type(exc).__name__}: {exc}", file=sys.stderr)
        return None


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_arg_parser().parse_args(argv)
    contracts = contracts_enabled(args)
    if (args.journal_fsck or args.race_sweep) and args.paths:
        build_arg_parser().error(
            "--journal-fsck/--race-sweep are standalone gates and take "
            "no lint paths")
    try:
        if args.journal_fsck or args.race_sweep:
            rc = 0
            if args.journal_fsck:
                rc = max(rc, run_journal_fsck(args.journal_fsck,
                                              fmt=args.format))
            if args.race_sweep:
                rc = max(rc, run_race_sweep(
                    max_schedules=args.race_schedules,
                    budget_s=args.race_budget, seed=args.race_seed,
                    out_path=args.race_out))
            return rc
        return run_selfcheck(paths=args.paths or None, fmt=args.format,
                             contracts=contracts, device=args.device,
                             show_suppressed=args.show_suppressed)
    except (OSError, SyntaxError) as exc:
        print(f"icln-lint-torch: error: {exc}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
