"""The port's journal fsck (``iterative_cleaner_torch/analysis/
journal_fsck.py``) held against the JAX package's.

Every case of the reference's ``tests/test_journal_fsck.py`` runs through
both ``fsck_journal``/``fsck_text`` functions: the same ``ok`` and the
same error and warning kinds on the same lines.  Journals written by the
port itself — the fleet's (``clean_fleet`` with a journal, a single file
and a segmented directory, two hosts over one journal, the CLI's
``--fleet --journal``) and the serve daemon's — are clean under both
checkers, and a torn tail is a warning, not an error.
"""

import json
import os
import signal
import threading
import time

import pytest

from iterative_cleaner_torch.analysis import journal_fsck as port_fsck
from iterative_cleaner_torch.resilience.journal import SCHEMA, FleetJournal
from iterative_cleaner_torch.telemetry.registry import MetricsRegistry
from iterative_cleaner_tpu.analysis import journal_fsck as ref_fsck


def _line(**fields) -> str:
    entry = {"schema": SCHEMA}
    entry.update(fields)
    return json.dumps(entry) + "\n"


def _shape(issues):
    return sorted((i.line, i.kind, i.severity) for i in issues)


def _kinds(issues):
    return sorted({i.kind for i in issues})


def fsck_both(path, **kw):
    """The port's report of ``path``, after requiring the reference's to
    agree on ``ok``, the issues' (line, kind, severity), the counts and
    the line and segment tallies."""
    got = port_fsck.fsck_journal(path, **kw)
    want = ref_fsck.fsck_journal(path, **kw)
    assert got.ok == want.ok
    assert _shape(got.issues) == _shape(want.issues), (
        [i.render() for i in got.issues], [i.render() for i in want.issues])
    assert got.counts == want.counts
    assert (got.n_lines, got.n_segments) == (want.n_lines, want.n_segments)
    return got


def text_both(text, **kw):
    """``fsck_text`` of both packages, required equal; the port's."""
    got = port_fsck.fsck_text(text, **kw)
    want = ref_fsck.fsck_text(text, **kw)
    assert _shape(got[0]) == _shape(want[0])
    assert [i.message for i in got[0]] == [i.message for i in want[0]]
    assert got[1:] == want[1:]
    return got


# ------------------------------------------------------ API-produced text

def _real_journal(tmp_path) -> FleetJournal:
    j = FleetJournal(str(tmp_path / "j.jsonl"))
    j.record_request("r1", "accepted", paths=["/a.npz"], tenant="t")
    j.record_request("r1", "running")
    j.try_claim("req:r1", host=1, nonce="n1", ttl_s=30.0)
    j.heartbeat("req:r1", host=1, nonce="n1", ttl_s=30.0)
    j.record_member("mA", "join", host=1, ttl_s=30.0)
    j.record_member("mA", "hb", host=1, ttl_s=30.0)
    j.record_request("r1", "done")
    j.release("req:r1", host=1, nonce="n1")
    j.record_host_stats(1, {"cleaned": 3})
    return j


def test_api_produced_journal_fscks_clean(tmp_path):
    j = _real_journal(tmp_path)
    report = fsck_both(j.path)
    assert report.ok and not report.issues
    assert report.counts["req"] == 3
    assert report.counts["claim"] == 3
    assert report.counts["member"] == 2
    assert report.counts["stats"] == 1


def test_compacted_journal_still_fscks_clean(tmp_path):
    j = _real_journal(tmp_path)
    j.compact()
    report = fsck_both(j.path)
    assert report.ok, [i.render() for i in report.issues]


def test_torn_tail_is_a_warning_not_an_error(tmp_path):
    j = _real_journal(tmp_path)
    with open(j.path, "a") as f:
        f.write('{"schema": "icln-fleet-journal/1", "event": "mem')
    report = fsck_both(j.path)
    assert report.ok  # warnings never fail the gate
    assert [i.kind for i in report.warnings] == ["torn-line"]
    assert "torn tail" in report.warnings[0].message
    # the next append heals it; a healed mid-file torn line still warns
    j.record_member("mB", "join", host=2, ttl_s=30.0)
    report = fsck_both(j.path)
    assert report.ok
    assert "healed" in report.warnings[0].message


def test_missing_journal_is_an_error(tmp_path):
    report = fsck_both(str(tmp_path / "never-written.jsonl"))
    assert not report.ok


# ------------------------------------------------- request state machine

def test_state_after_terminal_is_flagged():
    text = (_line(event="req", req="x", state="done")
            + _line(event="req", req="x", state="accepted"))
    issues, _, _ = text_both(text)
    assert _kinds(issues) == ["state-machine"]
    assert "after terminal" in issues[0].message


def test_duplicate_terminal_is_flagged():
    text = (_line(event="req", req="x", state="failed")
            + _line(event="req", req="x", state="failed"))
    issues, _, _ = text_both(text)
    assert "duplicate terminal" in issues[0].message


def test_rank_regression_names_the_admit_ordering_hazard():
    text = (_line(event="req", req="x", state="running")
            + _line(event="req", req="x", state="accepted"))
    issues, _, _ = text_both(text)
    assert _kinds(issues) == ["state-machine"]
    assert "admit-ordering" in issues[0].message


def test_normal_lifecycle_and_idempotent_running_are_clean():
    text = (_line(event="req", req="x", state="accepted")
            + _line(event="req", req="x", state="running")
            + _line(event="req", req="x", state="running")  # re-poll
            + _line(event="req", req="x", state="done"))
    issues, _, _ = text_both(text)
    assert issues == []


# ------------------------------------------------------------- grammar

@pytest.mark.parametrize("text,expect", [
    ('["not", "an", "object"]\n', "not an object"),
    (_line(event="req", req="x", state="accepted").replace(
        SCHEMA, "someone-elses/9"), "foreign or missing schema"),
    (_line(event="wat"), "unknown event"),
    (_line(event="req", req="x", state="paused"), "not one of"),
    (_line(event="claim", work="w", host="one", nonce="n",
           state="claim", t=1.0, ttl=1.0), "host"),
    (_line(event="claim", work="w", host=1, nonce="n", state="claim",
           t=1.0, ttl=-2.0), "negative"),
    (_line(event="done", path="/a", sig="s", config="c", out="/o"),
        "out_sig"),
    (_line(event="stats", host=1, counters={"n": True}), "not numeric"),
    (_line(event="cache", key="wrong", path="/a", sig="s", config="c",
           out="/o", out_sig="os"), "mis-keyed"),
])
def test_grammar_violations_are_errors(text, expect):
    issues, _, _ = text_both(text)
    errors = [i for i in issues if i.severity == "error"]
    assert errors, f"expected an error mentioning {expect!r}"
    assert any(expect in i.message for i in errors)


def test_blank_lines_are_ignored():
    text = ("\n\n" + _line(event="req", req="x", state="accepted") + "\n")
    issues, counts, _ = text_both(text)
    assert issues == [] and counts["req"] == 1


# ----------------------------------------------------- lease monotonicity

def test_backwards_lease_stamp_is_flagged():
    text = (_line(event="claim", work="w", host=1, nonce="a",
                  state="claim", t=100.0, ttl=30.0)
            + _line(event="claim", work="w", host=2, nonce="b",
                    state="claim", t=90.0, ttl=30.0))
    issues, _, _ = text_both(text)
    assert _kinds(issues) == ["lease-monotonicity"]


def test_skew_tolerance_allows_small_backwards_stamps():
    text = (_line(event="member", member="m", host=1, state="join",
                  t=100.0, ttl=30.0)
            + _line(event="member", member="m", host=1, state="hb",
                    t=99.5, ttl=30.0))
    issues, _, _ = text_both(text, skew_s=1.0)
    assert issues == []
    issues, _, _ = text_both(text)
    assert _kinds(issues) == ["lease-monotonicity"]


# --------------------------------------------------------------- surfaces

def test_report_render_and_dict_roundtrip(tmp_path):
    j = _real_journal(tmp_path)
    report = fsck_both(j.path)
    assert "ok" in report.render_text()
    assert report.render_text() == ref_fsck.fsck_journal(j.path).render_text()
    d = report.to_dict()
    assert d["ok"] and d["n_lines"] == report.n_lines


def test_record_fsck_publishes_metrics(tmp_path):
    j = _real_journal(tmp_path)
    with open(j.path, "a") as f:
        f.write('{"schema": "icln-fleet-journal/1", "event": "mem')
    reg = MetricsRegistry()
    port_fsck.record_fsck(reg, fsck_both(j.path))
    assert reg.gauges["journal_fsck_ok"] == 1
    assert reg.gauges["journal_fsck_lines"] > 0
    assert reg.counters["journal_fsck_warnings{kind=torn-line}"] == 1

    bad = port_fsck.FsckReport(path="x")
    bad.issues, bad.counts, bad.n_lines = text_both(
        _line(event="req", req="x", state="done")
        + _line(event="req", req="x", state="running"))
    port_fsck.record_fsck(reg, bad)
    assert reg.gauges["journal_fsck_ok"] == 0
    assert reg.counters["journal_fsck_errors{kind=state-machine}"] == 1


# ------------------------------------------------ segmented directories

def _segmented(tmp_path) -> FleetJournal:
    j = FleetJournal(str(tmp_path / "j.d") + os.sep, backend="segmented",
                     segment_mb=0.0003)
    for i in range(6):
        j.record_request(f"r{i}", "accepted", paths=[f"/{i}.npz"])
        j.try_claim(f"req:r{i}", host=1, nonce=f"n{i}", ttl_s=30.0)
        j.record_request(f"r{i}", "running")
        j.record_request(f"r{i}", "done")
    return j


def test_segmented_journal_fscks_clean_under_both(tmp_path):
    j = _segmented(tmp_path)
    report = fsck_both(j.path)
    assert report.ok and report.n_segments > j.n_shards()
    j.compact()
    assert fsck_both(j.path).ok


def test_segmented_misrouted_line_and_broken_manifest(tmp_path):
    from iterative_cleaner_torch.parallel.distributed import stable_shard
    from iterative_cleaner_torch.resilience.segmented import (
        MANIFEST_NAME,
        active_name,
    )

    j = _segmented(tmp_path)
    # a line appended to a shard its key does not route to
    n = j.n_shards()
    wrong = (stable_shard("req:zz", n) + 1) % n
    with open(os.path.join(j.path, active_name(wrong)), "a") as f:
        f.write(_line(event="req", req="zz", state="accepted"))
    report = fsck_both(j.path)
    assert "shard-routing" in _kinds(report.errors)
    with open(os.path.join(j.path, MANIFEST_NAME), "w") as f:
        f.write("{not json")
    report = fsck_both(j.path)
    assert _kinds(report.errors) == ["manifest"]


# ------------------------------------------------ journals the port writes

def _archives(tmp_path, shapes):
    from iterative_cleaner_torch.io import make_synthetic_archive, save_archive

    paths = []
    for i, (nsub, nchan, nbin) in enumerate(shapes):
        ar, _ = make_synthetic_archive(nsub=nsub, nchan=nchan, nbin=nbin,
                                       seed=i)
        paths.append(str(tmp_path / f"a{i}.npz"))
        save_archive(ar, paths[-1])
    return paths


@pytest.mark.parametrize("journal", ["j.jsonl", "j.d" + os.sep])
def test_port_fleet_journal_is_clean_under_both(tmp_path, journal):
    """``clean_fleet`` with a journal (a fault drill's retries included),
    a resume over it and two hosts sharing another: every line passes
    both checkers."""
    from iterative_cleaner_torch import CleanConfig
    from iterative_cleaner_torch.parallel import fleet
    from iterative_cleaner_torch.parallel.distributed import HostTopology
    from iterative_cleaner_torch.resilience import (
        FaultInjector,
        ResiliencePlan,
    )

    paths = _archives(tmp_path, [(6, 8, 16), (6, 8, 16), (4, 8, 16)])
    cfg = CleanConfig(device="cpu", max_iter=2)
    path = str(tmp_path / journal)

    def write(_path, _ar, _result):  # the done lines need a write stage
        pass

    rep = fleet.clean_fleet(paths, cfg, write_fn=write,
                            resilience=ResiliencePlan(
                                faults=FaultInjector("load:err@1,exec:oom@2",
                                                     seed=0),
                                journal=FleetJournal(path)))
    assert rep.ok
    fleet.clean_fleet(paths, cfg, write_fn=write, resilience=ResiliencePlan(
        journal=FleetJournal(path), resume=True))
    report = fsck_both(path)
    assert report.ok and report.counts["done"] >= len(paths)
    shared = str(tmp_path / ("h" + journal))
    for host in (0, 1):
        fleet.clean_fleet(paths, cfg, hosts=HostTopology(host, 2),
                          write_fn=write, resilience=ResiliencePlan(
                              journal=FleetJournal(shared)))
    report = fsck_both(shared)
    assert report.ok and report.counts["claim"] > 0


def test_port_cli_fleet_journal_and_selfcheck_fsck(tmp_path, monkeypatch,
                                                  capsys):
    """``--fleet --journal`` writes a journal both checkers pass, and
    ``icln-lint-torch --journal-fsck`` says so (exit 0; a corrupted
    copy exits 1)."""
    from iterative_cleaner_torch.analysis.cli import main as lint_main
    from iterative_cleaner_torch.cli import main

    monkeypatch.chdir(tmp_path)
    paths = _archives(tmp_path, [(6, 8, 16), (4, 8, 16)])
    assert main(["--device", "cpu", "-q", "--max_iter", "2", "--fleet",
                 "--journal", "c.jsonl", *paths]) == 0
    assert fsck_both("c.jsonl").ok
    assert lint_main(["--journal-fsck", "c.jsonl", "--format",
                      "json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["ok"] and doc["journals"][0]["counts"]["done"] == 2
    with open("c.jsonl") as f:
        text = f.read()
    with open("bad.jsonl", "w") as f:
        f.write(text + _line(event="req", req="x", state="done")
                + _line(event="req", req="x", state="running"))
    assert lint_main(["--journal-fsck", "bad.jsonl"]) == 1
    assert not fsck_both("bad.jsonl").ok


def test_port_serve_daemon_journal_is_clean_under_both(tmp_path,
                                                        monkeypatch):
    """A daemon's journal (two archive requests by the spool: their
    acceptance, claims, runs and completions; then the drain's
    compaction) passes both checkers, and so does its torn tail after a
    writer dies mid-line."""
    from iterative_cleaner_torch import CleanConfig
    from iterative_cleaner_torch.config import ServeConfig
    from iterative_cleaner_torch.serve import ServeDaemon

    monkeypatch.chdir(tmp_path)
    (path,) = _archives(tmp_path, [(4, 8, 16)])
    os.makedirs("spool")
    d = ServeDaemon(ServeConfig(spool_dir="spool", poll_s=0.02,
                                journal_path="serve.jsonl",
                                flight_recorder=""),
                    CleanConfig(device="cpu", max_iter=2), quiet=True)
    t = threading.Thread(target=d.run, daemon=True)
    t.start()
    for rid in ("r1", "r2"):
        with open(os.path.join("spool", f".{rid}.tmp"), "w") as f:
            json.dump({"id": rid, "paths": [path]}, f)
        os.replace(os.path.join("spool", f".{rid}.tmp"),
                   os.path.join("spool", f"{rid}.json"))
    deadline = time.time() + 120
    while time.time() < deadline:
        states = FleetJournal("serve.jsonl").request_states()
        if all(states.get(r, {}).get("state") == "done"
               for r in ("r1", "r2")):
            break
        time.sleep(0.05)
    report = fsck_both("serve.jsonl")
    assert report.ok and report.counts["req"] >= 6, report.render_text()
    d._on_signal(signal.SIGTERM, None)
    t.join(60)
    # the drain compacts the journal to each request's last line
    report = fsck_both("serve.jsonl")
    assert report.ok and report.counts["req"] == 2, report.render_text()
    with open("serve.jsonl", "a") as f:
        f.write('{"schema": "icln-fleet-journal/1", "event": "re')
    report = fsck_both("serve.jsonl")
    assert report.ok and [i.kind for i in report.warnings] == ["torn-line"]
