"""The port's CLI session and telemetry against the reference package's.

The same inputs through both packages:

- the registry, the exporters, the event log and ``clean.log``: the
  same text for the same records (timestamps pinned);
- ``iter_metrics_dict``, ``iter_quality_series`` and ``observe_result``:
  equal values;
- the CLI (``--metrics-json --prom-textfile --log-format json``, the
  port with ``--device cpu``) on a 16 x 32 x 128 synthetic archive
  saved as ``.npz`` and as ``.sf``: equal masks; equal counters, gauges
  and histograms of ``record_archive`` and equal ``quality`` entries;
  ``zap_count``/``mask_churn`` equal and ``residual_std``/
  ``template_peak`` within rtol 1e-4 (the diagnostics' float32 sums are
  reassociated, as tests/test_torch_routes.py states); the same
  Prometheus sample names; the same event kinds in the same order;
- ``--keep_going``: an unreadable archive is recorded, the others are
  cleaned, and the exit code is 1.
"""

import argparse
import datetime
import json
import os
import shutil
import threading

import numpy as np
import pytest

from iterative_cleaner_tpu import cli as ref_cli
from iterative_cleaner_tpu import telemetry as ref_tel
from iterative_cleaner_tpu.backends.base import CleanResult as RefCleanResult
from iterative_cleaner_tpu.engine.loop import (
    iter_quality_series as ref_iter_quality_series,
)
from iterative_cleaner_tpu.io import load_archive as ref_load_archive
from iterative_cleaner_tpu.io import save_archive as ref_save_archive
from iterative_cleaner_tpu.io.synthetic import (
    make_synthetic_archive as ref_make_synthetic_archive,
)
from iterative_cleaner_tpu.telemetry.events import (
    RunEventLog as RefRunEventLog,
)
from iterative_cleaner_tpu.telemetry.events import read_events
from iterative_cleaner_tpu.telemetry.registry import (
    split_labels as ref_split_labels,
)
from iterative_cleaner_tpu.utils.logging import (
    append_clean_log as ref_append_clean_log,
)
from iterative_cleaner_torch import cli
from iterative_cleaner_torch import telemetry as tel
from iterative_cleaner_torch.backends.base import CleanResult
from iterative_cleaner_torch.engine.loop import iter_quality_series
from iterative_cleaner_torch.io import load_archive
from iterative_cleaner_torch.telemetry.events import RunEventLog
from iterative_cleaner_torch.telemetry.registry import split_labels
from iterative_cleaner_torch.utils.logging import (
    append_clean_log,
    locked_append,
)

# what RunTelemetry.record_archive sets, in both packages
RECORDED_COUNTERS = ("archives_cleaned", "archives_converged",
                     "iterations_total", "cells_total", "cells_zapped")
RECORDED_HISTOGRAMS = ("loops_per_archive", "quality_iter_churn",
                       "quality_chan_occupancy", "quality_subint_occupancy")
CLI_FLAGS = ["--metrics-json", "run.json", "--prom-textfile", "run.prom",
             "--log-format", "json"]


def _fill(reg):
    """The same records into either package's registry."""
    reg.counter_inc("archives_cleaned", 3)
    reg.counter_inc("cells_zapped", 120)
    reg.counter_inc(tel.labeled("fleet_cleaned", host="a b\"c"), 2)
    reg.gauge_set("last_rfi_fraction", 0.25)
    reg.gauge_set(tel.labeled("quality_zap_frac_final", stream="s1"), 0.5)
    for v in (1, 2, 2, 7, 250):
        reg.histogram_observe("loops_per_archive", v)
    for v in (0.001, 0.3, 1.0):
        reg.histogram_observe("occ", v, buckets=(0.01, 0.5, 1.0))
    reg.timer.seconds.update({"write": 0.5, "clean": 2.25, "load": 0.125})
    return reg


def test_exports_equal_reference(tmp_path):
    mine = _fill(tel.MetricsRegistry()).snapshot()
    theirs = _fill(ref_tel.MetricsRegistry()).snapshot()
    assert mine == theirs
    assert tel.metrics_to_json(mine, {"schema": tel.METRICS_SCHEMA}) == \
        ref_tel.metrics_to_json(theirs, {"schema": ref_tel.METRICS_SCHEMA})
    text = tel.metrics_to_prometheus(mine)
    assert text == ref_tel.metrics_to_prometheus(theirs)
    assert tel.parse_prometheus_text(text) == \
        ref_tel.parse_prometheus_text(text)
    path = str(tmp_path / "m.prom")
    tel.write_prometheus_textfile(path, mine)
    with open(path) as f:
        assert f.read() == text
    tel.write_metrics_json(str(tmp_path / "m.json"), mine)
    with open(tmp_path / "m.json") as f:
        assert json.load(f)["counters"] == mine["counters"]
    assert not [p for p in os.listdir(tmp_path) if p.endswith(".tmp")]
    assert tel.PhaseTimer().report() == ref_tel.PhaseTimer().report()
    t, rt = tel.PhaseTimer(), ref_tel.PhaseTimer()
    t.seconds.update(clean=1.5, load=0.25)
    rt.seconds.update(clean=1.5, load=0.25)
    assert t.report() == rt.report() == \
        "Timing: clean 1.500s, load 0.250s (total 1.750s)"


@pytest.mark.parametrize("name", ["plain", "a{k=v}", "a{z=1,b=2}",
                                  "broken{k=v", "odd{novalue}"])
def test_labels_equal_reference(name):
    assert split_labels(name) == ref_split_labels(name)
    assert tel.labeled("x", b=1, a="q") == ref_tel.labeled("x", b=1, a="q")


def test_counter_rejects_negative():
    with pytest.raises(ValueError):
        tel.MetricsRegistry().counter_inc("x", -1)


def test_phase_timer_calls_back():
    seen = []
    reg = tel.MetricsRegistry(on_phase=lambda n, s: seen.append(n))
    with reg.timer.phase("load"):
        pass
    with pytest.raises(KeyError):
        with reg.timer.phase("clean"):
            raise KeyError("x")
    assert seen == ["load", "clean"]
    assert set(reg.snapshot()["phases_s"]) == {"load", "clean"}


def test_logs_byte_equal_reference(tmp_path):
    ts = datetime.datetime(2026, 8, 5, 12, 0, 1, 500000)
    mine, theirs = str(tmp_path / "a.log"), str(tmp_path / "b.log")
    append_clean_log("obs.sf", "Namespace(x=1)", 4, mine, timestamp=ts)
    ref_append_clean_log("obs.sf", "Namespace(x=1)", 4, log_path=theirs,
                         timestamp=ts)
    RunEventLog(mine).emit("iteration", iteration=0, zap_count=5,
                           ts="2026-08-05T00:00:00")
    RefRunEventLog(theirs).emit("iteration", iteration=0, zap_count=5,
                                ts="2026-08-05T00:00:00")
    with open(mine, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()


def test_locked_append_concurrent_lines_intact(tmp_path):
    path = str(tmp_path / "shared.log")
    n_threads, n_lines = 8, 40

    def writer(i):
        for j in range(n_lines):
            locked_append(path, f"t{i}:{j}:{'x' * 64}\n")

    threads = [threading.Thread(target=writer, args=(i,))
               for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    with open(path) as f:
        lines = f.read().splitlines()
    assert len(lines) == n_threads * n_lines
    assert all(line.endswith("x" * 64) for line in lines)


def _iter_metrics(loops, seed):
    rng = np.random.default_rng(seed)
    im = rng.uniform(0, 3, (loops, 4)).astype(np.float32)
    im[:, :2] = np.round(im[:, :2] * 100)
    return im


def _results(seed=0):
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.5, 2.0, (12, 20))
    w[rng.random(w.shape) < 0.2] = 0
    w[3] = 0
    kw = dict(final_weights=w, scores=rng.random(w.shape), loops=3,
              converged=True, iter_metrics=_iter_metrics(3, seed))
    return CleanResult(**kw), RefCleanResult(**kw)


def test_iteration_series_equal_reference():
    im = _iter_metrics(4, 1)
    assert tel.iter_metrics_dict(im) == ref_tel.iter_metrics_dict(im)
    assert tel.iter_metrics_dict(None) == {}
    assert list(tel.iter_metrics_dict(im)) == list(tel.ITER_METRIC_FIELDS)
    assert iter_quality_series(im, 240) == ref_iter_quality_series(im, 240)
    with pytest.raises(ValueError):
        iter_quality_series(im[:, :3], 240)


def test_observe_result_equal_reference():
    mine, theirs = _results(2)
    reg, ref_reg = tel.MetricsRegistry(), ref_tel.MetricsRegistry()
    assert tel.observe_result(mine, reg) == \
        ref_tel.observe_result(theirs, ref_reg)
    assert reg.snapshot() == ref_reg.snapshot()
    assert tel.observe_mask(mine.final_weights, None) == \
        ref_tel.observe_mask(theirs.final_weights, None)


def _strip_ts(events):
    return [{k: v for k, v in e.items() if k not in ("ts", "seconds")}
            for e in events]


def test_run_telemetry_equal_reference(tmp_path):
    docs, events = [], []
    for pkg, result in zip((tel, ref_tel), _results(3)):
        d = tmp_path / pkg.__name__.split(".")[0]
        d.mkdir()
        t = pkg.RunTelemetry(metrics_json=str(d / "r.json"),
                             prom_textfile=str(d / "r.prom"),
                             events=pkg.RunEventLog(str(d / "e.jsonl")))
        with t.registry.timer.phase("load"):
            pass
        t.record_archive("a.sf", result)
        t.record_failure("bad.sf", RuntimeError("boom"))
        t.finalize()
        with open(d / "r.json") as f:
            doc = json.load(f)
        doc.pop("phases_s")
        docs.append(doc)
        events.append(_strip_ts(read_events(str(d / "e.jsonl"))))
    assert docs[0] == docs[1]
    assert events[0] == events[1]
    assert [e["event"] for e in events[0]] == [
        "phase", "iteration", "iteration", "iteration", "archive", "error",
        "run_end"]


def test_from_args_empty_strings_configure_nothing():
    ns = argparse.Namespace(metrics_json="", prom_textfile="",
                            event_log="", log_format="text")
    t = tel.RunTelemetry.from_args(ns)
    assert (t.metrics_json, t.prom_textfile, t.events) == (None, None, None)
    ns.log_format = "json"
    assert tel.RunTelemetry.from_args(ns).events.path == "clean.events.jsonl"
    ns.event_log = "e.jsonl"
    assert tel.RunTelemetry.from_args(ns).events.path == "e.jsonl"


# ---------------------------------------------------------------------------
# the CLI session against the reference CLI
# ---------------------------------------------------------------------------

def _archive_file(directory, ext, seed=7):
    ar, _ = ref_make_synthetic_archive(nsub=16, nchan=32, nbin=128,
                                       n_prezapped=5, seed=seed)
    path = os.path.join(directory, "obs" + ext)
    ref_save_archive(ar, path)
    return path


def _run_both(tmp_path, monkeypatch, ext, flags):
    """The reference CLI and the port's (``--device cpu``) with the same
    flags, each in its own directory; returns their directories."""
    src = _archive_file(str(tmp_path), ext)
    dirs = {}
    for name, main, extra in (("ref", ref_cli.main, []),
                              ("port", cli.main, ["--device", "cpu"])):
        d = tmp_path / name
        d.mkdir()
        shutil.copy(src, d / os.path.basename(src))
        monkeypatch.chdir(d)
        assert main(extra + flags + [os.path.basename(src)]) == 0
        dirs[name] = d
    return dirs


@pytest.mark.parametrize("ext", [".npz", ".sf"])
def test_cli_session_matches_reference(tmp_path, monkeypatch, ext):
    dirs = _run_both(tmp_path, monkeypatch, ext, CLI_FLAGS)
    out = "obs%s_cleaned%s" % (ext, ext)
    mine = load_archive(str(dirs["port"] / out))
    theirs = ref_load_archive(str(dirs["ref"] / out))
    np.testing.assert_array_equal(mine.weights == 0, theirs.weights == 0)
    np.testing.assert_array_equal(mine.data, theirs.data)

    doc, ref_doc = (json.load(open(d / "run.json"))
                    for d in (dirs["port"], dirs["ref"]))
    assert doc["schema"] == ref_doc["schema"] == tel.METRICS_SCHEMA
    for k in RECORDED_COUNTERS:
        assert doc["counters"][k] == ref_doc["counters"][k], k
    assert doc["gauges"] == ref_doc["gauges"]
    for k in RECORDED_HISTOGRAMS:
        assert doc["histograms"][k] == ref_doc["histograms"][k], k
    (arch,), (ref_arch,) = doc["archives"], ref_doc["archives"]
    assert arch["quality"] == ref_arch["quality"]
    for k in ("loops", "converged", "cells_zapped", "rfi_fraction"):
        assert arch[k] == ref_arch[k], k
    hist, ref_hist = arch["iter_history"], ref_arch["iter_history"]
    assert list(hist) == list(ref_hist)
    for k in ("zap_count", "mask_churn"):
        assert hist[k] == ref_hist[k], k
    for k in ("residual_std", "template_peak"):
        np.testing.assert_allclose(hist[k], ref_hist[k], rtol=1e-4)
    assert hist["zap_count"][-1] == int(np.sum(mine.weights == 0))

    prom, ref_prom = (tel.parse_prometheus_text(open(d / "run.prom").read())
                      for d in (dirs["port"], dirs["ref"]))
    assert set(prom) == set(ref_prom)
    assert prom["icln_archives_cleaned_total"] == 1.0
    kinds, ref_kinds = ([e["event"] for e in read_events(
        str(d / "clean.events.jsonl"))] for d in (dirs["port"], dirs["ref"]))
    assert kinds == ref_kinds
    assert kinds == ["run_start", "phase", "phase", "phase"] + \
        ["iteration"] * arch["loops"] + ["archive", "run_end"]


def test_cli_quiet_no_log_pscrunch_timing_match_reference(
        tmp_path, monkeypatch, capsys):
    """``-q -l -p --timing``: no progress lines and no clean.log; the
    pscrunched output equal to the reference's; one Timing line."""
    ar, _ = ref_make_synthetic_archive(nsub=8, nchan=16, nbin=64, npol=4,
                                       seed=3)
    ar.pol_state = "Coherence"
    outs = {}
    for name, main, extra in (("ref", ref_cli.main, []),
                              ("port", cli.main, ["--device", "cpu"])):
        d = tmp_path / name
        d.mkdir()
        ref_save_archive(ar, str(d / "obs.sf"))
        monkeypatch.chdir(d)
        capsys.readouterr()
        assert main(extra + ["-q", "-l", "-p", "--timing", "obs.sf"]) == 0
        lines = capsys.readouterr().out.splitlines()
        assert len(lines) == 1 and lines[0].startswith("Timing: clean "), \
            lines
        assert not (d / "clean.log").exists()
        outs[name] = str(d / "obs.sf_cleaned.sf")
    mine, theirs = load_archive(outs["port"]), ref_load_archive(outs["ref"])
    assert mine.npol == theirs.npol == 1
    assert mine.pol_state == theirs.pol_state == "Intensity"
    np.testing.assert_array_equal(mine.data, theirs.data)
    np.testing.assert_array_equal(mine.weights == 0, theirs.weights == 0)


def test_cli_keep_going_records_the_failure(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    os.rename(_archive_file(str(tmp_path), ".sf", seed=1), tmp_path / "a.sf")
    _archive_file(str(tmp_path), ".npz", seed=2)
    with open(tmp_path / "broken.sf", "wb") as f:
        f.write(b"\0" * 5760)
    rc = cli.main(["--device", "cpu", "-q", "--keep_going"] + CLI_FLAGS
                  + ["a.sf", "broken.sf", "obs.npz"])
    assert rc == 1
    err = capsys.readouterr().err
    assert "ERROR cleaning broken.sf: ValueError" in err
    assert "Failed 1/3 archives: broken.sf" in err
    assert os.path.exists("a.sf_cleaned.sf")
    assert os.path.exists("obs.npz_cleaned.npz")
    doc = json.load(open("run.json"))
    assert doc["counters"]["archives_failed"] == 1
    assert doc["counters"]["archives_cleaned"] == 2
    assert [a["path"] for a in doc["archives"]] == ["a.sf", "obs.npz"]
    events = read_events("clean.events.jsonl")
    assert [e["event"] for e in events if e["event"] in (
        "archive", "error")] == ["archive", "error", "archive"]
    assert events[-1]["event"] == "run_end"
    assert (events[-1]["ok"], events[-1]["failed"]) == (2, 1)


def test_cli_failure_without_keep_going_ends_the_session(tmp_path,
                                                          monkeypatch):
    """Without ``--keep_going`` the failure raises, and the session still
    writes its report and its ``run_end``."""
    monkeypatch.chdir(tmp_path)
    with open(tmp_path / "broken.sf", "wb") as f:
        f.write(b"\0" * 5760)
    _archive_file(str(tmp_path), ".npz")
    with pytest.raises(ValueError, match="not a FITS"):
        cli.main(["--device", "cpu", "-q"] + CLI_FLAGS
                 + ["broken.sf", "obs.npz"])
    assert not os.path.exists("obs.npz_cleaned.npz")
    doc = json.load(open("run.json"))
    assert doc["archives"] == [] and "archives_failed" not in doc["counters"]
    assert [e["event"] for e in read_events("clean.events.jsonl")] == [
        "run_start", "phase", "run_end"]


def test_cli_mesh_cell_one_rank_reports(tmp_path, monkeypatch):
    """``--mesh cell`` without torchrun is a job of one rank: rank 0
    records and writes the same report as the run without a mesh."""
    monkeypatch.chdir(tmp_path)
    _archive_file(str(tmp_path), ".sf")
    docs = []
    for extra in ([], ["--mesh", "cell"]):
        assert cli.main(["--device", "cpu", "-q"] + extra + CLI_FLAGS
                        + ["obs.sf"]) == 0
        doc = json.load(open("run.json"))
        docs.append((doc["counters"], doc["archives"][0]["iter_history"]))
    assert docs[0] == docs[1]


def test_cli_underscore_flag_aliases():
    args = cli.build_parser().parse_args(
        ["--metrics_json", "a.json", "--prom_textfile", "b.prom",
         "--log_format", "json", "--event_log", "e.jsonl", "x.sf"])
    assert (args.metrics_json, args.prom_textfile, args.log_format,
            args.event_log) == ("a.json", "b.prom", "json", "e.jsonl")
