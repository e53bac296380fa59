"""The CLI session's ``--prefetch`` loader and ``-z`` zap plot.

``--prefetch N`` loads up to N archives ahead on ``--io-workers``
threads while the current one cleans: the outputs, the run report and
the event sequence equal a sequential session's, a corrupt archive in
the middle fails alone under ``--keep_going`` and ends the session at
its turn without it, and the loads run on the loader's threads.  ``-z``
writes the plot the reference CLI writes, and names matplotlib where it
is missing.
"""

import json
import os
import sys
import threading

import numpy as np
import pytest

from iterative_cleaner_tpu import cli as ref_cli
from iterative_cleaner_tpu.io import save_archive as ref_save_archive
from iterative_cleaner_tpu.io.synthetic import (
    make_synthetic_archive as ref_make_synthetic_archive,
)
from iterative_cleaner_torch import cli
from iterative_cleaner_torch.io import load_archive
from iterative_cleaner_torch.telemetry.events import read_events

NAMES = ("a.npz", "b.sf", "c.icar")
FLAGS = ["--device", "cpu", "-q", "--metrics-json", "run.json",
         "--log-format", "json"]


def _write_archives(directory, names=NAMES):
    for i, name in enumerate(names):
        ar, _ = ref_make_synthetic_archive(nsub=8, nchan=16, nbin=32,
                                           n_prezapped=3, seed=20 + i)
        ref_save_archive(ar, os.path.join(directory, name))


def _session(tmp_path, monkeypatch, label, extra):
    d = tmp_path / label
    d.mkdir()
    _write_archives(str(d))
    monkeypatch.chdir(d)
    assert cli.main(FLAGS + extra + list(NAMES)) == 0
    doc = json.load(open(d / "run.json"))
    doc.pop("phases_s")
    kinds = [e["event"] for e in read_events(str(d / "clean.events.jsonl"))]
    return d, doc, kinds


@pytest.mark.parametrize("extra", [["--prefetch", "2"],
                                   ["--prefetch", "1", "--io-workers", "1"],
                                   ["--prefetch", "2", "--mesh", "cell"]])
def test_prefetch_session_equals_sequential(tmp_path, monkeypatch, extra):
    seq_dir, seq_doc, seq_kinds = _session(tmp_path, monkeypatch, "seq", [])
    pre_dir, pre_doc, pre_kinds = _session(tmp_path, monkeypatch, "pre",
                                           extra)
    assert pre_doc == seq_doc
    assert pre_kinds == seq_kinds
    assert [a["path"] for a in pre_doc["archives"]] == list(NAMES)
    for name in NAMES:
        out = name + "_cleaned" + os.path.splitext(name)[1]
        got, want = (load_archive(str(d / out)) for d in (pre_dir, seq_dir))
        np.testing.assert_array_equal(got.weights, want.weights)
        np.testing.assert_array_equal(got.data, want.data)
    assert (open(pre_dir / "clean.log").read().count("\n")
            == open(seq_dir / "clean.log").read().count("\n") == 3)


def _corrupt_middle(directory):
    with open(os.path.join(directory, "b.sf"), "wb") as f:
        f.write(b"\0" * 5760)


def test_prefetch_corrupt_middle_fails_alone(tmp_path, monkeypatch, capsys):
    docs = {}
    for label, extra in (("seq", []), ("pre", ["--prefetch", "2"])):
        d = tmp_path / label
        d.mkdir()
        _write_archives(str(d))
        _corrupt_middle(str(d))
        monkeypatch.chdir(d)
        capsys.readouterr()
        assert cli.main(FLAGS + ["--keep_going"] + extra + list(NAMES)) == 1
        err = capsys.readouterr().err
        assert "ERROR cleaning b.sf: ValueError" in err
        assert "Failed 1/3 archives: b.sf" in err
        assert os.path.exists("a.npz_cleaned.npz")
        assert os.path.exists("c.icar_cleaned.icar")
        doc = json.load(open("run.json"))
        doc.pop("phases_s")
        docs[label] = doc
        assert [e["event"] for e in read_events("clean.events.jsonl")
                if e["event"] in ("archive", "error")] == [
            "archive", "error", "archive"]
    assert docs["pre"] == docs["seq"]
    assert docs["pre"]["counters"]["archives_failed"] == 1


def test_prefetch_load_error_raises_at_its_turn(tmp_path, monkeypatch):
    """Without ``--keep_going`` the corrupt archive ends the session when
    its turn comes: the first archive is written, the third never is."""
    monkeypatch.chdir(tmp_path)
    _write_archives(str(tmp_path))
    _corrupt_middle(str(tmp_path))
    with pytest.raises(ValueError, match="not a FITS"):
        cli.main(FLAGS + ["--prefetch", "2"] + list(NAMES))
    assert os.path.exists("a.npz_cleaned.npz")
    assert not os.path.exists("c.icar_cleaned.icar")
    doc = json.load(open("run.json"))
    assert [a["path"] for a in doc["archives"]] == ["a.npz"]


def test_prefetch_loads_run_on_the_loader_threads(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    _write_archives(str(tmp_path))
    threads = []
    real_load = cli.load_archive

    def load(path):
        threads.append((path, threading.current_thread().name))
        return real_load(path)

    monkeypatch.setattr(cli, "load_archive", load)
    assert cli.main(["--device", "cpu", "-q", "-l", "--prefetch", "2"]
                    + list(NAMES)) == 0
    assert sorted(p for p, _ in threads) == sorted(NAMES)
    main = threading.main_thread().name
    assert all(name != main for _, name in threads), threads
    threads.clear()
    assert cli.main(["--device", "cpu", "-q", "-l"] + list(NAMES)) == 0
    assert [p for p, _ in threads] == list(NAMES)
    assert all(name == threading.main_thread().name for _, name in threads)


def test_iter_archives_stays_n_ahead(monkeypatch):
    """``prefetch`` loads ahead of the one being consumed, no more, on at
    most ``prefetch`` threads; the archives come in their order."""
    started, lock = [], threading.Lock()
    gate = threading.Event()

    def fake_load(path):
        with lock:
            started.append(path)
        gate.wait(10)
        return path

    monkeypatch.setattr(cli, "load_archive", fake_load)
    paths = [f"p{i}" for i in range(6)]
    it = cli.iter_archives(paths, prefetch=2, workers=4)
    first, fut = next(it)
    for _ in range(100):
        if len(started) == 2:
            break
        threading.Event().wait(0.01)
    assert first == "p0" and sorted(started) == ["p0", "p1"]
    gate.set()
    assert fut.result(10) == "p0"
    seen = [first] + [p for p, f in it if f.result(10) == p]
    assert seen == paths and sorted(started) == paths
    assert list(cli.iter_archives(["x"], 2)) == [("x", None)]
    assert list(cli.iter_archives(paths[:2], 0)) == [("p0", None),
                                                     ("p1", None)]


def test_io_workers(monkeypatch):
    monkeypatch.delenv("ICLEAN_IO_WORKERS", raising=False)
    assert cli.resolve_io_workers() == 2
    assert cli.resolve_io_workers(3) == 3
    monkeypatch.setenv("ICLEAN_IO_WORKERS", "5")
    assert cli.resolve_io_workers() == 5
    with pytest.raises(ValueError):
        cli.resolve_io_workers(0)
    with pytest.raises(SystemExit):
        cli.main(["--device", "cpu", "--io-workers", "0", "x.npz"])
    args = cli.build_parser().parse_args(["--io_workers", "4", "--prefetch",
                                          "1", "x.npz"])
    assert (args.io_workers, args.prefetch) == (4, 1)


def test_print_zap_writes_the_reference_plot(tmp_path, monkeypatch):
    pytest.importorskip("matplotlib")
    for label, main, extra in (("ref", ref_cli.main, ["--backend", "numpy"]),
                               ("port", cli.main, ["--device", "cpu"])):
        d = tmp_path / label
        d.mkdir()
        _write_archives(str(d), ("obs.npz",))
        monkeypatch.chdir(d)
        assert main(extra + ["-z", "-q", "-l", "-c", "4", "obs.npz"]) == 0
        assert sorted(n for n in os.listdir(d) if n.endswith(".png")) == [
            "obs.npz_4.0_5.png"]
    with open(tmp_path / "port" / "obs.npz_4.0_5.png", "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_print_zap_names_matplotlib_where_missing(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.chdir(tmp_path)
    _write_archives(str(tmp_path), ("obs.npz",))
    with pytest.raises(ImportError, match="matplotlib"):
        cli.main(["--device", "cpu", "-z", "-q", "-l", "obs.npz"])
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".png")]
