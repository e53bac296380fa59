"""The CLI session over the ranks of a cell mesh: ``--checkpoint``'s
resume decision and ``--trace``'s per-rank files, on two gloo ranks in
spawned processes (``run_local_ranks``, a ``file://`` store in
``tmp_path``, each rank a time limit so a hang fails the test).

- ``--mesh cell --checkpoint``: a first session cleans on both ranks and
  saves on rank 0 only; a second resumes on both ranks (rank 0 prints the
  resume line, neither cleans) and writes the same output; a checkpoint
  gone stale (another threshold) or torn mid-replace is cleaned again on
  both ranks.  Rank 0 alone reads the checkpoint: its decision reaches
  the other rank before any collective.
- ``--mesh cell --trace DIR``: each rank writes its own trace file, each
  holding the session's stage ranges.

This module imports only the port: the spawned ranks never load JAX.
"""

import contextlib
import io
import os

import numpy as np

from iterative_cleaner_torch import cli
from iterative_cleaner_torch.io import load_archive, save_archive
from iterative_cleaner_torch.io.synthetic import make_synthetic_archive
from iterative_cleaner_torch.parallel.distributed import run_local_ranks
from iterative_cleaner_torch.parallel.mesh import cell_mesh
from iterative_cleaner_torch.utils import checkpoint as ckpt
from iterative_cleaner_torch.utils.tracing import STAGES, trace_event_counts

SPAWN_TIMEOUT_S = 240


def session_rank(sessions):
    """Each of ``sessions`` (CLI argument lists) run by ``cli.run_archives``
    over this rank's cell mesh; per session, the rank's sharded cleans and
    checkpoint saves (counted by wrapping both) and its printed lines."""
    from iterative_cleaner_torch import backends

    calls = {"clean": 0, "save": 0}

    def counted(fn, key):
        def wrapper(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapper

    backends.clean_archive_sharded = counted(backends.clean_archive_sharded,
                                             "clean")
    ckpt.save_clean_checkpoint = counted(ckpt.save_clean_checkpoint, "save")
    mesh = cell_mesh()
    out = []
    for argv in sessions:
        calls.update(clean=0, save=0)
        args = cli.build_parser().parse_args(argv)
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            rc = cli.run_archives(args, mesh)
        out.append(dict(calls, rc=rc, text=text.getvalue(),
                        rank=mesh.rank))
    return out


def _archive(tmp_path):
    ar, _ = make_synthetic_archive(nsub=8, nchan=16, nbin=32, seed=4,
                                   n_prezapped=3)
    path = str(tmp_path / "obs.npz")
    save_archive(ar, path)
    return path


def test_mesh_checkpoint_resume_is_rank0s_decision(tmp_path):
    path = _archive(tmp_path)
    ck = str(tmp_path / "ck")

    def argv(out, *more):
        return ["-l", "--device", "cpu", "--mesh", "cell", "--checkpoint",
                ck, "-o", str(tmp_path / out), *more, path]

    sessions = [argv("first.npz"), argv("second.npz"),
                argv("stale.npz", "-c", "4.5")]
    ranks = run_local_ranks(session_rank, 2, (sessions,),
                            workdir=str(tmp_path), timeout_s=SPAWN_TIMEOUT_S,
                            threads=1)
    first, second, stale = zip(*ranks)
    # the first session cleans on both ranks, rank 0 alone saves
    assert [r["clean"] for r in first] == [1, 1]
    assert [r["save"] for r in first] == [1, 0]
    # the second resumes on both ranks: no clean, no save
    assert [(r["clean"], r["save"]) for r in second] == [(0, 0), (0, 0)]
    assert "Resumed from checkpoint: %s" % ckpt.checkpoint_path(
        ck, path) in second[0]["text"]
    assert second[1]["text"] == ""
    np.testing.assert_array_equal(
        load_archive(str(tmp_path / "first.npz")).weights,
        load_archive(str(tmp_path / "second.npz")).weights)
    # a stale checkpoint is cleaned again on both ranks
    assert [r["clean"] for r in stale] == [1, 1]
    assert [r["save"] for r in stale] == [1, 0]
    assert all(r["rc"] == 0 for rank in ranks for r in rank)


def test_mesh_torn_checkpoint_is_cleaned_again_on_every_rank(tmp_path):
    path = _archive(tmp_path)
    ck = str(tmp_path / "ck")
    os.makedirs(ck)
    with open(ckpt.checkpoint_path(ck, path), "wb") as f:
        f.write(b"PK\x03\x04 torn mid-replace")
    argv = ["-l", "-q", "--device", "cpu", "--mesh", "cell", "--checkpoint",
            ck, "-o", str(tmp_path / "out.npz"), path]
    ranks = run_local_ranks(session_rank, 2, ([argv],),
                            workdir=str(tmp_path), timeout_s=SPAWN_TIMEOUT_S,
                            threads=1)
    assert [(r[0]["clean"], r[0]["save"]) for r in ranks] == [(1, 1), (1, 0)]
    result, _, _ = ckpt.load_clean_checkpoint(ckpt.checkpoint_path(ck, path))
    np.testing.assert_array_equal(
        result.final_weights, load_archive(str(tmp_path / "out.npz")).weights)


def test_mesh_trace_writes_one_file_per_rank(tmp_path):
    path = _archive(tmp_path)
    tr = str(tmp_path / "tr")
    argv = ["-l", "-q", "--device", "cpu", "--mesh", "cell", "--trace", tr,
            "-o", str(tmp_path / "out.npz"), path]
    ranks = run_local_ranks(session_rank, 2, ([argv],),
                            workdir=str(tmp_path), timeout_s=SPAWN_TIMEOUT_S,
                            threads=1)
    assert [r[0]["clean"] for r in ranks] == [1, 1]
    assert sorted(os.listdir(tr)) == ["trace.rank0.json", "trace.rank1.json"]
    for r in (0, 1):
        names = trace_event_counts(os.path.join(tr, f"trace.rank{r}.json"),
                                   "user_annotation")
        loops = names["icln_template"]
        assert loops >= 1
        for stage in STAGES + ("icln_iter_metrics",):
            assert names[stage] == loops, (r, stage, names)
        assert names["icln:clean"] == 1
