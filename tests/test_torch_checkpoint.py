"""The port's checkpoints (``utils/checkpoint.py``) and ``--checkpoint``
against the reference package's.

- Each case of the reference's ``tests/test_checkpoint.py`` on the port:
  the weight history, the round trip and staleness, the path scheme, a
  run asking for more than the checkpoint holds, the diffs, the
  file-signature fast path, old checkpoints without one, the CLI resume.
- The reference's two contention tests (``tests/test_concurrency.py``):
  two processes sharing one checkpoint directory, four threads saving one
  path.
- Across the packages: the fingerprint's hex is the reference's; each
  package's ``load_clean_checkpoint`` reads the other's checkpoints and
  their ``tools diff`` reports 0 cells changed and ``same_input``; a
  reference checkpoint is never resumed by the port (the identities
  differ), in the library or the CLI; the CLI's refusals are the
  reference parser's.
- A resumed archive is written, logged and recorded in the run report as
  the cleaned one was.

The cell mesh's resume (rank 0 decides for every rank) is in
``tests/test_torch_cli_mesh.py``.
"""

import dataclasses
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from iterative_cleaner_tpu import cli as ref_cli
from iterative_cleaner_tpu import tools as ref_tools
from iterative_cleaner_tpu.backends import clean_archive as ref_clean_archive
from iterative_cleaner_tpu.config import CleanConfig as RefConfig
from iterative_cleaner_tpu.io import save_archive as ref_save_archive
from iterative_cleaner_tpu.io.synthetic import (
    make_synthetic_archive as ref_make_synthetic_archive,
)
from iterative_cleaner_tpu.utils import checkpoint as ref_ckpt
from iterative_cleaner_torch import CleanConfig, cli, tools
from iterative_cleaner_torch.backends import clean_archive
from iterative_cleaner_torch.config import CleanConfig as PortConfig
from iterative_cleaner_torch.convert import archive_from_reference
from iterative_cleaner_torch.io import load_archive, save_archive
from iterative_cleaner_torch.io.synthetic import make_synthetic_archive
from iterative_cleaner_torch.utils import checkpoint as ckpt

from .conftest import repo_subprocess_env

CPU = dict(device="cpu")


@pytest.fixture()
def archive():
    ar, _ = make_synthetic_archive(nsub=10, nchan=16, nbin=64, seed=7)
    return ar


# ---------------------------------------------------------------------------
# the reference's tests/test_checkpoint.py, on the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_history_recorded_both_backends(archive, backend):
    cfg = CleanConfig(backend=backend, max_iter=3, record_history=True, **CPU)
    res = clean_archive(archive, cfg)
    h = res.weight_history
    assert h is not None
    assert h.shape[0] == res.loops + 1      # the seed and one per loop
    np.testing.assert_array_equal(h[0], archive.weights)
    np.testing.assert_array_equal(h[-1], res.final_weights)


def test_history_off_by_default(archive):
    res = clean_archive(archive, CleanConfig(backend="numpy", max_iter=2))
    assert res.weight_history is None


def test_roundtrip_and_staleness(archive, tmp_path):
    cfg = CleanConfig(backend="numpy", max_iter=3, record_history=True)
    res = clean_archive(archive, cfg)
    fp = ckpt.fingerprint_archive(archive)
    path = ckpt.checkpoint_path(str(tmp_path), "a")
    ckpt.save_clean_checkpoint(path, res, cfg, fp)

    back, fp2, cfg_id = ckpt.load_clean_checkpoint(path)
    assert fp2 == fp and cfg_id == ckpt.config_identity(cfg)
    np.testing.assert_array_equal(back.final_weights, res.final_weights)
    np.testing.assert_array_equal(back.weight_history, res.weight_history)
    assert back.loops == res.loops and back.converged == res.converged

    assert ckpt.load_matching_checkpoint(str(tmp_path), "a", archive,
                                         cfg) is not None
    # stale when the config or the data changes
    other_cfg = dataclasses.replace(cfg, max_iter=4)
    assert ckpt.load_matching_checkpoint(str(tmp_path), "a", archive,
                                         other_cfg) is None
    mutated = dataclasses.replace(
        archive, weights=np.where(archive.weights == 0, 0.0,
                                  archive.weights * 2))
    assert ckpt.load_matching_checkpoint(str(tmp_path), "a", mutated,
                                         cfg) is None
    # output-only flags are outside the identity: asking for less matches
    less_cfg = dataclasses.replace(cfg, record_history=False)
    assert ckpt.load_matching_checkpoint(str(tmp_path), "a", archive,
                                         less_cfg) is not None


def test_checkpoint_path_distinguishes_directories(tmp_path):
    a = ckpt.checkpoint_path(str(tmp_path), "x/obs.npz")
    b = ckpt.checkpoint_path(str(tmp_path), "y/obs.npz")
    assert a != b
    assert ckpt.checkpoint_path(str(tmp_path), "x/obs.npz") == a
    # the reference's scheme: either package finds the other's file
    assert a == ref_ckpt.checkpoint_path(str(tmp_path), "x/obs.npz")


def test_resume_recleans_when_outputs_missing(archive, tmp_path):
    """A checkpoint saved without residual/history must not satisfy a
    later run that asks for them."""
    cfg = CleanConfig(backend="numpy", max_iter=2)
    res = clean_archive(archive, cfg)
    path = ckpt.checkpoint_path(str(tmp_path), "a")
    ckpt.save_clean_checkpoint(path, res, cfg,
                               ckpt.fingerprint_archive(archive))
    assert ckpt.load_matching_checkpoint(str(tmp_path), "a", archive,
                                         cfg) is not None
    for more in (dict(unload_res=True), dict(record_history=True)):
        assert ckpt.load_matching_checkpoint(
            str(tmp_path), "a", archive,
            dataclasses.replace(cfg, **more)) is None


def test_diff_masks_and_checkpoints(archive, tmp_path):
    cfg = CleanConfig(backend="numpy", max_iter=3, record_history=True)
    res = clean_archive(archive, cfg)
    fp = ckpt.fingerprint_archive(archive)
    pa, pb = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    ckpt.save_clean_checkpoint(pa, res, cfg, fp)
    altered = dataclasses.replace(
        res, final_weights=np.where(res.final_weights == 0, 1.0,
                                    res.final_weights))
    ckpt.save_clean_checkpoint(pb, altered, cfg, fp)

    d = ckpt.diff_checkpoints(pa, pb)
    n_zap = int((res.final_weights == 0).sum())
    assert d["changed"] == n_zap and d["unzapped"] == n_zap
    assert d["newly_zapped"] == 0
    assert d["same_input"] is True
    assert d["per_iteration_changed"] == [0] * (res.loops + 1)
    assert d == ref_ckpt.diff_checkpoints(pa, pb)


def test_file_signature_fast_path(archive, tmp_path, monkeypatch):
    """An unchanged input resumes by its (size, mtime, header hash)
    signature without the whole-cube hash; a touched file falls back to
    the content fingerprint; a changed file stays stale."""
    cfg = CleanConfig(backend="numpy", max_iter=2)
    res = clean_archive(archive, cfg)
    in_path = str(tmp_path / "obs.npz")
    save_archive(archive, in_path)
    path = ckpt.checkpoint_path(str(tmp_path), in_path)
    ckpt.save_clean_checkpoint(path, res, cfg,
                               ckpt.fingerprint_archive(archive),
                               file_sig=ckpt.file_signature(in_path))

    def boom(ar):
        raise AssertionError("content hash ran on the fast path")

    monkeypatch.setattr(ckpt, "fingerprint_archive", boom)
    assert ckpt.load_matching_checkpoint(str(tmp_path), in_path, archive,
                                         cfg) is not None
    monkeypatch.undo()

    st = os.stat(in_path)
    os.utime(in_path, ns=(st.st_atime_ns, st.st_mtime_ns + 10 ** 9))
    assert ckpt.load_matching_checkpoint(str(tmp_path), in_path, archive,
                                         cfg) is not None

    mutated = dataclasses.replace(
        archive, weights=np.where(archive.weights == 0, 0.0,
                                  archive.weights * 2))
    save_archive(mutated, in_path)
    assert ckpt.load_matching_checkpoint(str(tmp_path), in_path, mutated,
                                         cfg) is None


def test_checkpoint_without_sig_still_resumes(archive, tmp_path):
    cfg = CleanConfig(backend="numpy", max_iter=2)
    res = clean_archive(archive, cfg)
    in_path = str(tmp_path / "obs.npz")
    save_archive(archive, in_path)
    path = ckpt.checkpoint_path(str(tmp_path), in_path)
    ckpt.save_clean_checkpoint(path, res, cfg,
                               ckpt.fingerprint_archive(archive))
    assert ckpt.load_matching_checkpoint(str(tmp_path), in_path, archive,
                                         cfg) is not None


def test_cli_checkpoint_resume(archive, tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    save_archive(archive, "obs.npz")
    args = ["--device", "cpu", "-l", "--checkpoint", "ckpts", "obs.npz"]
    assert cli.main(args) == 0
    assert "Resumed" not in capsys.readouterr().out
    assert cli.main(args) == 0
    assert "Resumed from checkpoint: %s" % ckpt.checkpoint_path(
        "ckpts", "obs.npz") in capsys.readouterr().out
    assert (load_archive("obs.npz_cleaned.npz").weights == 0).any()


# ---------------------------------------------------------------------------
# the reference's contention tests (tests/test_concurrency.py)
# ---------------------------------------------------------------------------

def _write_archives(tmp_path, n, prefix):
    paths = []
    for i in range(n):
        ar, _ = make_synthetic_archive(nsub=6, nchan=10, nbin=32, seed=i,
                                       n_rfi_cells=3)
        p = str(tmp_path / f"{prefix}{i}.npz")
        save_archive(ar, p)
        paths.append(p)
    return paths


def test_checkpoint_dir_contention_across_processes(tmp_path):
    """Two processes cleaning one archive list into one --checkpoint
    directory at once both finish, and the checkpoints left behind read
    and hold the clean's mask (no torn file)."""
    paths = _write_archives(tmp_path, 3, "ck")
    ckdir = str(tmp_path / "ckpts")
    code = ("import sys\n"
            "from iterative_cleaner_torch.cli import main\n"
            "sys.exit(main(['-q', '-l', '--device', 'cpu', '--checkpoint',"
            " sys.argv[1], '-o', sys.argv[2]] + sys.argv[3:]))\n")
    procs = []
    for tag in ("a", "b"):
        outdir = tmp_path / f"out_{tag}"
        outdir.mkdir()
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code, ckdir, "std", *paths],
            env=repo_subprocess_env(), cwd=str(outdir),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err.decode()[-2000:]
    for p in paths:
        result, _, _ = ckpt.load_clean_checkpoint(
            ckpt.checkpoint_path(ckdir, p))
        want = clean_archive(load_archive(p), CleanConfig(**CPU))
        np.testing.assert_array_equal(result.final_weights,
                                      want.final_weights)


def test_checkpoint_same_path_thread_contention(tmp_path):
    """Threads of one process saving one checkpoint path at once: every
    published state reads whole, and no temp file is left."""
    ar, _ = make_synthetic_archive(nsub=6, nchan=10, nbin=32, seed=3,
                                   n_rfi_cells=3)
    cfg = CleanConfig(backend="numpy")
    res = clean_archive(ar, cfg)
    fp = ckpt.fingerprint_archive(ar)
    path = ckpt.checkpoint_path(str(tmp_path), "shared")
    start = threading.Barrier(4)
    errors = []

    def writer():
        try:
            start.wait(timeout=30)
            for _ in range(25):
                ckpt.save_clean_checkpoint(path, res, cfg, fp)
                back, fp2, _ = ckpt.load_clean_checkpoint(path)
                assert fp2 == fp
                np.testing.assert_array_equal(back.final_weights,
                                              res.final_weights)
        except Exception as e:  # surfaced below; a dead thread would hang
            errors.append(e)

    threads = [threading.Thread(target=writer) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads), "writer deadlocked"
    assert not errors, errors
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------

FINGERPRINT_CASES = {
    "float64": dict(nsub=10, nchan=16, nbin=64, seed=7),
    "float32-npol4": dict(nsub=5, nchan=8, nbin=32, seed=2, npol=4,
                          dtype=np.float32),
    "prezapped": dict(nsub=7, nchan=12, nbin=48, seed=4, n_prezapped=6),
}


@pytest.mark.parametrize("case", sorted(FINGERPRINT_CASES))
def test_fingerprint_is_the_references(case, monkeypatch):
    ref, _ = ref_make_synthetic_archive(**FINGERPRINT_CASES[case])
    ar = archive_from_reference(ref)
    want = ref_ckpt.fingerprint_archive(ref)
    assert ckpt.fingerprint_archive(ar) == want
    # hashed a few subints at a time: the same hex as one piece
    monkeypatch.setattr(ckpt, "_FINGERPRINT_CHUNK_BYTES", 1)
    assert ckpt.fingerprint_archive(ar) == want


def test_identity_partition_covers_the_ports_fields():
    fields = {f.name for f in dataclasses.fields(PortConfig)}
    assert ckpt._IDENTITY_FIELDS | ckpt._IDENTITY_EXCLUDE == fields
    assert "device" in ckpt._IDENTITY_FIELDS
    scheduling = {"fleet_bucket_pad", "fleet_group_size",
                  "compile_cache_dir"}
    assert {"unload_res", "record_history", "compute_dtype",
            "fleet_retries", "stage_timeout_s", "fleet_hosts",
            "fleet_host_id", "fleet_claim_ttl_s", "quality_window",
            "quality_drift"} | scheduling \
        == set(ckpt._IDENTITY_EXCLUDE)
    # every field the packages share is classified as the reference does,
    # but the fleet's bucket grid, group size and build directory: the
    # reference pads its buckets, so they may change its masks; the port
    # pads nothing, so they cannot change its
    shared = fields & {f.name for f in dataclasses.fields(RefConfig)}
    for name in shared - scheduling:
        assert (name in ckpt._IDENTITY_FIELDS) \
            == (name in ref_ckpt._IDENTITY_FIELDS), name


@pytest.mark.parametrize("knob,value,same", [
    ("device", "cuda", False), ("chanthresh", 4.0, False),
    ("compute_dtype", "bfloat16", True), ("record_history", True, True),
    ("unload_res", True, True), ("stream_hbm_mb", 0.0, False),
    ("fleet_retries", 5, True), ("stage_timeout_s", 3.0, True),
    ("fleet_claim_ttl_s", 9.0, True), ("fleet_group_size", 4, True),
    ("fleet_bucket_pad", (0, 32), True), ("compile_cache_dir", "kc", True),
])
def test_config_hash_follows_the_identity(knob, value, same):
    base = CleanConfig(**CPU)
    other = dataclasses.replace(base, **{knob: value})
    assert (ckpt.config_hash(other) == ckpt.config_hash(base)) is same
    assert len(ckpt.config_hash(base)) == 16
    int(ckpt.config_hash(base), 16)


def _ref_and_port_checkpoints(tmp_path):
    """One archive cleaned by each package's numpy oracle (bit-equal)
    and saved as each package's checkpoint."""
    ref, _ = ref_make_synthetic_archive(nsub=10, nchan=16, nbin=64, seed=7,
                                        n_prezapped=3)
    ar = archive_from_reference(ref)
    ref_cfg = RefConfig(backend="numpy", record_history=True)
    cfg = CleanConfig(backend="numpy", record_history=True)
    paths = {"ref": str(tmp_path / "ref.ckpt.npz"),
             "port": str(tmp_path / "port.ckpt.npz")}
    ref_ckpt.save_clean_checkpoint(paths["ref"],
                                   ref_clean_archive(ref, ref_cfg), ref_cfg,
                                   ref_ckpt.fingerprint_archive(ref))
    ckpt.save_clean_checkpoint(paths["port"], clean_archive(ar, cfg), cfg,
                               ckpt.fingerprint_archive(ar))
    return ref, ar, paths


def test_each_package_reads_the_others_checkpoints(tmp_path):
    _, _, paths = _ref_and_port_checkpoints(tmp_path)
    with np.load(paths["ref"]) as a, np.load(paths["port"]) as b:
        assert sorted(a.files) == sorted(b.files)
    port_on_ref = ckpt.load_clean_checkpoint(paths["ref"])
    ref_on_port = ref_ckpt.load_clean_checkpoint(paths["port"])
    for got, want in ((port_on_ref, ref_ckpt.load_clean_checkpoint(
            paths["ref"])), (ref_on_port, ckpt.load_clean_checkpoint(
            paths["port"]))):
        assert got[1] == want[1] and got[2] == want[2]
        for name in ("final_weights", "scores", "loop_diffs",
                     "loop_rfi_frac", "weight_history", "iter_metrics"):
            np.testing.assert_array_equal(getattr(got[0], name),
                                          getattr(want[0], name))
        assert (got[0].loops, got[0].converged) == (want[0].loops,
                                                    want[0].converged)


def test_tools_diff_across_packages_reports_no_change(tmp_path, capsys):
    _, _, paths = _ref_and_port_checkpoints(tmp_path)
    assert tools.main(["diff", paths["ref"], paths["port"]]) == 0
    mine = json.loads(capsys.readouterr().out)
    assert ref_tools.main(["diff", paths["ref"], paths["port"]]) == 0
    theirs = json.loads(capsys.readouterr().out)
    assert mine == theirs
    assert mine["changed"] == 0 and mine["same_input"] is True
    assert mine["per_iteration_changed"] == [0] * (mine["loops"][0] + 1)


def test_a_reference_checkpoint_is_never_resumed(tmp_path, capsys,
                                                 monkeypatch):
    """The reference's checkpoint of the same archive, at the path the
    port looks for, reads as stale: the identities differ, so the port
    cleans again (and saves its own)."""
    monkeypatch.chdir(tmp_path)
    ref, _ = ref_make_synthetic_archive(nsub=8, nchan=12, nbin=32, seed=5)
    ref_save_archive(ref, "obs.npz")
    assert ref_cli.main(["-q", "-l", "--backend", "numpy", "--checkpoint",
                         "ck", "obs.npz"]) == 0
    path = ckpt.checkpoint_path("ck", "obs.npz")
    assert os.path.exists(path)
    argv = ["-l", "--backend", "numpy", "--checkpoint", "ck", "obs.npz"]
    ar = load_archive("obs.npz")
    cfg = cli.config_of(cli.build_parser().parse_args(argv))
    assert ckpt.load_clean_checkpoint(path)[1] == ckpt.fingerprint_archive(ar)
    assert ckpt.load_matching_checkpoint("ck", "obs.npz", ar, cfg) is None
    capsys.readouterr()
    assert cli.main(argv) == 0
    assert "Resumed" not in capsys.readouterr().out
    assert ckpt.load_clean_checkpoint(path)[2] == ckpt.config_identity(cfg)
    assert cli.main(argv) == 0
    assert "Resumed from checkpoint" in capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    ["--batch", "2", "--checkpoint", "ck"],
    ["--stream", "8", "--checkpoint", "ck"],
    ["--model", "quicklook", "--checkpoint", "ck"],
])
def test_checkpoint_refusals_are_the_reference_parsers(argv, tmp_path):
    for main in (cli.main, ref_cli.main):
        with pytest.raises(SystemExit) as ei:
            main(argv + [str(tmp_path / "x.npz")])
        assert ei.value.code == 2


def test_cli_checkpoint_matches_the_reference_cli(tmp_path, monkeypatch):
    """Both CLIs on one archive with --backend numpy --record_history
    --checkpoint: equal outputs, and checkpoints of equal keys, masks,
    histories and fingerprints."""
    monkeypatch.chdir(tmp_path)
    ref, _ = ref_make_synthetic_archive(nsub=10, nchan=16, nbin=64, seed=9,
                                        n_prezapped=3)
    ref_save_archive(ref, "obs.npz")
    common = ["-q", "-l", "--backend", "numpy", "--record_history"]
    assert ref_cli.main(common + ["--checkpoint", "ref", "-o", "ref.npz",
                                  "obs.npz"]) == 0
    assert cli.main(common + ["--checkpoint", "port", "-o", "port.npz",
                              "obs.npz"]) == 0
    np.testing.assert_array_equal(load_archive("ref.npz").weights,
                                  load_archive("port.npz").weights)
    a = ckpt.load_clean_checkpoint(ckpt.checkpoint_path("ref", "obs.npz"))
    b = ckpt.load_clean_checkpoint(ckpt.checkpoint_path("port", "obs.npz"))
    assert a[1] == b[1]
    np.testing.assert_array_equal(a[0].final_weights, b[0].final_weights)
    np.testing.assert_array_equal(a[0].weight_history, b[0].weight_history)
    np.testing.assert_array_equal(a[0].scores, b[0].scores)


def test_resumed_archive_is_written_logged_and_recorded_alike(
        archive, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    save_archive(archive, "obs.npz")
    runs = {}
    for tag in ("cleaned", "resumed"):
        assert cli.main(["-q", "--device", "cpu", "--checkpoint", "ck",
                         "--metrics-json", f"{tag}.json", "-o",
                         f"{tag}.npz", "obs.npz"]) == 0
        with open(f"{tag}.json") as f:
            runs[tag] = json.load(f)
    np.testing.assert_array_equal(load_archive("cleaned.npz").weights,
                                  load_archive("resumed.npz").weights)
    a, b = (runs[t]["archives"][0] for t in ("cleaned", "resumed"))
    assert a == b
    for key in ("archives_cleaned", "iterations_total", "cells_zapped",
                "archives_converged"):
        assert runs["cleaned"]["counters"][key] \
            == runs["resumed"]["counters"][key]
    # one clean.log line per session, each naming the archive and its loops
    lines = [ln for ln in open("clean.log").read().splitlines() if ln]
    assert len(lines) == 2
    for ln in lines:
        assert "Cleaned obs.npz with" in ln
        assert ln.endswith("required loops=%d" % a["loops"])


def test_resume_with_history_asks_for_history(archive, tmp_path, capsys,
                                              monkeypatch):
    """A checkpoint saved without the weight history does not resume a
    run that records it; that run's checkpoint then holds it."""
    monkeypatch.chdir(tmp_path)
    save_archive(archive, "obs.npz")
    base = ["-l", "--device", "cpu", "--checkpoint", "ck", "obs.npz"]
    assert cli.main(base) == 0
    capsys.readouterr()
    assert cli.main(["--record_history"] + base) == 0
    assert "Resumed" not in capsys.readouterr().out
    result, _, _ = ckpt.load_clean_checkpoint(
        ckpt.checkpoint_path("ck", "obs.npz"))
    assert result.weight_history.shape[0] == result.loops + 1
    assert cli.main(base) == 0
    assert "Resumed from checkpoint" in capsys.readouterr().out


def test_checkpoint_keys_the_device(archive, tmp_path):
    """A CPU clean's checkpoint does not stand for a card's clean."""
    res = clean_archive(archive, CleanConfig(**CPU))
    ckpt.save_clean_checkpoint(ckpt.checkpoint_path(str(tmp_path), "a"),
                               res, CleanConfig(**CPU),
                               ckpt.fingerprint_archive(archive))
    assert ckpt.load_matching_checkpoint(
        str(tmp_path), "a", archive, CleanConfig(**CPU)) is not None
    assert ckpt.load_matching_checkpoint(
        str(tmp_path), "a", archive, CleanConfig(device="cuda")) is None


def test_a_torn_checkpoint_is_stale(archive, tmp_path):
    path = ckpt.checkpoint_path(str(tmp_path), "a")
    with open(path, "wb") as f:
        f.write(b"PK\x03\x04 torn mid-replace")
    assert ckpt.load_matching_checkpoint(str(tmp_path), "a", archive,
                                         CleanConfig(**CPU)) is None
