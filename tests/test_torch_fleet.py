"""The port's fleet scheduler (``parallel/fleet.py``) on the CPU: the
planner against the JAX package's, the fleet bit for bit against the
port's sequential cleans (a trailing partial group and a singleton bucket
included), against the JAX ``clean_fleet`` on the same mixed fleet,
``fleet_bucket_pad`` (accepted, and changing no bucket: the port pads no
cell), the load lookahead, failure isolation at every stage and the CLI
(as ``tests/test_fleet.py``).

Tolerances: against the port's own sequential cleans everything is
bit-equal (a batch is bit-equal to its single cleans).  Against the JAX
``clean_fleet``: masks, loops and per-loop diffs equal, scores rtol 1e-4
with a 1e-4 floor — the port's DFT spectra against the reference's
kernel route (ROADMAP §3), as ``tests/test_torch_batch.py`` holds the
batched clean."""

import json
import os
import threading
import time

import numpy as np
import pytest

from iterative_cleaner_tpu.config import CleanConfig as RefConfig
from iterative_cleaner_tpu.io import save_archive as ref_save_archive
from iterative_cleaner_tpu.io.synthetic import (
    make_synthetic_archive as ref_make_synthetic_archive,
)
from iterative_cleaner_tpu.parallel.fleet import (
    clean_fleet as ref_clean_fleet,
    plan_fleet as ref_plan_fleet,
)
from iterative_cleaner_torch import CleanConfig
from iterative_cleaner_torch.backends import clean_archive
from iterative_cleaner_torch.convert import config_from_reference
from iterative_cleaner_torch.io import (
    load_archive,
    make_synthetic_archive,
    save_archive,
)
from iterative_cleaner_torch.parallel.fleet import (
    clean_fleet,
    plan_fleet,
    resolve_io_workers,
)
from iterative_cleaner_torch.telemetry.registry import MetricsRegistry

CFG = CleanConfig(device="cpu", rotation="roll", max_iter=3)


def _write_fleet(tmp_path, geometries, seed0=40):
    """One archive per (nsub, nchan, nbin) entry, saved as .npz."""
    paths = []
    for i, (nsub, nchan, nbin) in enumerate(geometries):
        ar, _ = make_synthetic_archive(nsub=nsub, nchan=nchan, nbin=nbin,
                                       seed=seed0 + i)
        p = str(tmp_path / ("fleet_%02d.npz" % i))
        save_archive(ar, p)
        paths.append(p)
    return paths


def _same(got, want):
    np.testing.assert_array_equal(got.final_weights, want.final_weights)
    np.testing.assert_array_equal(got.scores, want.scores)
    assert (got.loops, got.converged) == (want.loops, want.converged)
    np.testing.assert_array_equal(got.loop_diffs, want.loop_diffs)
    np.testing.assert_array_equal(got.iter_metrics, want.iter_metrics)


# ---- planner -------------------------------------------------------------

@pytest.mark.parametrize("group", [8, 2, 3])
def test_plan_fleet_equals_the_reference_plan(group):
    """The same entries plan into the same buckets, keys, items and
    batch dimensions in both packages (sorted keys, input order), the
    reference bucketing by exact shape as the port does."""
    rng = np.random.default_rng(3)
    entries = [("p%d" % i, (int(rng.integers(6, 20)),
                            int(rng.integers(10, 40)),
                            int(rng.choice([32, 64])), bool(i % 5 == 0)))
               for i in range(30)]
    got = plan_fleet(entries, group)
    want = ref_plan_fleet(entries, (0, 0), group)
    assert [(b.key, b.batch_dim, [it.path for it in b.items])
            for b in got.buckets] == \
        [(b.key, b.batch_dim, [it.path for it in b.items])
         for b in want.buckets]
    assert got.n_groups == want.n_groups


def test_plan_fleet_bucket_order_deterministic():
    entries = [("p%d" % i, (8 * (1 + i % 3), 16, 32, True))
               for i in range(9)]
    keys = [b.key for b in plan_fleet(entries).buckets]
    shuffled = [entries[i] for i in (5, 2, 8, 0, 7, 1, 4, 6, 3)]
    assert [b.key for b in plan_fleet(shuffled).buckets] == keys
    assert keys == sorted(keys)


def test_plan_fleet_group_chunking_and_batch_multiple():
    entries = [("p%d" % i, (8, 16, 32, True)) for i in range(5)]
    plan = plan_fleet(entries, group_size=2)
    (bucket,) = plan.buckets
    assert bucket.batch_dim == 2
    assert [len(g) for g in bucket.groups()] == [2, 2, 1]
    assert plan.n_groups == 3
    assert plan_fleet(entries, group_size=6,
                      batch_multiple=4).buckets[0].batch_dim == 8
    with pytest.raises(ValueError):
        plan_fleet(entries, group_size=0)


def test_resolve_io_workers(monkeypatch):
    monkeypatch.delenv("ICLEAN_IO_WORKERS", raising=False)
    assert resolve_io_workers() == 2
    assert resolve_io_workers(5) == 5
    monkeypatch.setenv("ICLEAN_IO_WORKERS", "3")
    assert resolve_io_workers() == 3
    with pytest.raises(ValueError):
        resolve_io_workers(0)


# ---- serving pipeline ----------------------------------------------------

def test_fleet_matches_sequential_bit_parity(tmp_path):
    """A mixed fleet with a trailing partial group (5 archives, groups of
    2) and a singleton bucket: every result bit-equal to the sequential
    clean of the archive."""
    paths = _write_fleet(tmp_path, [(8, 16, 32)] * 5 + [(6, 12, 32)])
    seq = {p: clean_archive(load_archive(p), CFG) for p in paths}
    reg = MetricsRegistry()
    rep = clean_fleet(paths, CFG, registry=reg, group_size=2, io_workers=2)
    assert rep.ok and set(rep.results) == set(paths)
    assert rep.n_buckets == 2 and rep.n_groups == 4
    for p in paths:
        _same(rep.results[p], seq[p])
    assert reg.counters["fleet_cleaned"] == len(paths)
    assert reg.gauges["fleet_buckets"] == 2
    # the trailing group launched at its own size: no pad lane ran
    assert reg.counters["batch_archives"] == len(paths)


def test_fleet_matches_jax_clean_fleet(tmp_path):
    """The port's fleet against the JAX ``clean_fleet`` on one mixed
    fleet (the same files): masks, loops and diffs equal, scores within
    rtol 1e-4."""
    ref_cfg = RefConfig(dtype="float32", median_impl="pallas",
                        stats_impl="fused", fused_sweep="on", fft_mode="dft",
                        max_iter=3)
    paths = []
    for i, (nsub, nchan, nbin) in enumerate([(8, 16, 32)] * 3
                                            + [(6, 12, 32)]):
        ar, _ = ref_make_synthetic_archive(nsub=nsub, nchan=nchan,
                                           nbin=nbin, seed=60 + i)
        paths.append(str(tmp_path / ("mix_%02d.npz" % i)))
        ref_save_archive(ar, paths[-1])
    want = ref_clean_fleet(paths, ref_cfg, group_size=2, io_workers=1)
    got = clean_fleet(paths, config_from_reference(ref_cfg, "cpu"),
                      group_size=2, io_workers=1)
    assert got.ok and want.ok
    assert (got.n_buckets, got.n_groups) == (want.n_buckets, want.n_groups)
    for p in paths:
        g, w = got.results[p], want.results[p]
        np.testing.assert_array_equal(g.final_weights, w.final_weights)
        assert (g.loops, g.converged) == (w.loops, w.converged)
        np.testing.assert_array_equal(g.loop_diffs, w.loop_diffs)
        np.testing.assert_allclose(g.scores, w.scores, rtol=1e-4, atol=1e-4)


def test_fleet_quantized_bucket_parity(tmp_path):
    """``fleet_bucket_pad`` changes no bucket: the port pads no cell, so
    near-miss geometries stay buckets of their own, and every result is
    bit-equal to the sequential clean."""
    paths = _write_fleet(tmp_path, [(8, 12, 32), (8, 16, 32), (8, 10, 32),
                                    (8, 12, 32)])
    seq = {p: clean_archive(load_archive(p), CFG) for p in paths}
    reg = MetricsRegistry()
    padded = CleanConfig(device="cpu", rotation="roll", max_iter=3,
                         fleet_bucket_pad=(0, 16))
    rep = clean_fleet(paths, padded, registry=reg, group_size=4)
    assert rep.ok and (rep.n_buckets, rep.n_groups) == (3, 3)
    assert reg.counters["batch_archives"] == len(paths)
    for p in paths:
        assert rep.results[p].final_weights.shape == seq[p].final_weights.shape
        _same(rep.results[p], seq[p])


def test_fleet_pipeline_loads_ahead(tmp_path):
    """The load pool stays one group ahead: the second group's loads start
    before the first group's last load is done."""
    paths = _write_fleet(tmp_path, [(8, 16, 32)] * 4)
    events = []
    lock = threading.Lock()

    def slow_load(path):
        with lock:
            events.append(("start", path))
        time.sleep(0.05)
        ar = load_archive(path)
        with lock:
            events.append(("done", path))
        return ar

    written = []
    rep = clean_fleet(paths, CFG, group_size=2, io_workers=2,
                      load_fn=slow_load,
                      write_fn=lambda p, ar, res: written.append(p))
    assert rep.ok and set(written) == set(paths)
    first_g1_start = events.index(("start", paths[2]))
    last_done = max(i for i, (k, _p) in enumerate(events) if k == "done")
    assert first_g1_start < last_done


def test_fleet_write_failures_are_nonfatal(tmp_path):
    paths = _write_fleet(tmp_path, [(8, 16, 32)] * 3)
    written, seen = [], []

    def write_fn(path, ar, res):
        if path == paths[1]:
            raise IOError("disk full")
        written.append(path)

    reg = MetricsRegistry()
    rep = clean_fleet(paths, CFG, registry=reg, group_size=4,
                      write_fn=write_fn,
                      on_error=lambda p, exc, stage: seen.append((p, stage)))
    assert set(rep.results) == set(paths) and not rep.ok
    assert [(p, s) for p, s, _e in rep.failures] == [(paths[1], "write")]
    assert seen == [(paths[1], "write")]
    assert set(written) == {paths[0], paths[2]}
    assert reg.counters["fleet_write_failures"] == 1


def test_fleet_peek_and_load_failures_are_isolated(tmp_path):
    paths = _write_fleet(tmp_path, [(8, 16, 32)] * 2)
    bogus = str(tmp_path / "missing.npz")
    corrupt = str(tmp_path / "corrupt.npz")
    save_archive(load_archive(paths[0]), corrupt)

    def load_fn(path):
        if path == corrupt:
            raise ValueError("truncated cube")
        return load_archive(path)

    rep = clean_fleet([paths[0], bogus, corrupt, paths[1]], CFG,
                      group_size=4, load_fn=load_fn)
    assert set(rep.results) == set(paths)
    assert {p: s for p, s, _e in rep.failures} == {bogus: "peek",
                                                   corrupt: "load"}


def test_fleet_empty_and_all_failed(tmp_path):
    rep = clean_fleet([], CFG)
    assert rep.ok and rep.results == {} and rep.n_buckets == 0
    rep = clean_fleet([str(tmp_path / "nope.npz")], CFG)
    assert not rep.ok and rep.results == {}


def test_fleet_refuses_a_mesh(tmp_path):
    with pytest.raises(NotImplementedError, match="item 3b"):
        clean_fleet([], CFG, mesh=object())


# ---- CLI -----------------------------------------------------------------

def test_cli_fleet_end_to_end(tmp_path, monkeypatch):
    """``--fleet`` writes each archive's output as the sequential session
    does (masks equal), with the run report listing every archive."""
    import json

    from iterative_cleaner_torch.cli import main

    monkeypatch.chdir(tmp_path)
    paths = _write_fleet(tmp_path, [(8, 16, 32), (8, 16, 32), (6, 12, 32)])
    rc = main(["--device", "cpu", "-q", "--fleet", "--rotation", "roll",
               "--max_iter", "3", "--io-workers", "2", "--metrics-json",
               "run.json", *paths])
    assert rc == 0
    doc = json.load(open("run.json"))
    assert sorted(e["path"] for e in doc["archives"]) == sorted(paths)
    assert doc["counters"]["fleet_cleaned"] == 3
    for p in paths:
        out = load_archive(p + "_cleaned.npz")
        assert out.data.shape == load_archive(p).data.shape
        np.testing.assert_array_equal(
            out.weights == 0,
            clean_archive(load_archive(p), CFG).final_weights == 0)


@pytest.mark.parametrize("argv,needle", [
    (["--bucket-pad", "8,16"], "--fleet"),
    (["--fleet", "--stream", "4"], "--fleet"),
    (["--fleet", "--io-workers", "0"], "--io-workers"),
    (["--fleet", "-u"], "--fleet"),
    (["--fleet", "--checkpoint", "ck"], "--fleet"),
    (["--fleet", "--record_history"], "--fleet"),
    (["--fleet", "--backend", "numpy"], "--fleet"),
    (["--fleet", "--model", "quicklook"], "--fleet"),
    (["--fleet", "--mesh", "cell"], "--fleet"),
    (["--fleet", "--bucket-pad", "8"], "NSUB,NCHAN"),
    (["--compile-cache", "c", "--backend", "numpy"], "--compile-cache"),
])
def test_cli_fleet_flag_validation(tmp_path, monkeypatch, capsys, argv,
                                   needle):
    """What the reference parser refuses is a parser error (exit 2)."""
    from iterative_cleaner_torch.cli import main

    monkeypatch.chdir(tmp_path)
    (path,) = _write_fleet(tmp_path, [(8, 16, 32)])
    with pytest.raises(SystemExit) as ei:
        main(["--device", "cpu", "-q", *argv, path])
    assert ei.value.code == 2
    assert needle in capsys.readouterr().err


@pytest.mark.parametrize("argv,item", [
    (["--fleet", "--coordinator", "localhost:1234"], "item 3b"),
    (["--fleet", "--mesh", "batch"], "item 3b"),
])
def test_cli_flags_left_out_raise_with_their_item(tmp_path, monkeypatch,
                                                   argv, item):
    from iterative_cleaner_torch.cli import main

    monkeypatch.chdir(tmp_path)
    with pytest.raises(NotImplementedError, match=item):
        main(["--device", "cpu", "-q", *argv, "x.npz"])


@pytest.mark.parametrize("argv,rc", [
    (["--selfcheck"], 0),
    (["--selfcheck", "--format", "json"], 0),
    (["--fleet", "--journal-fsck", "j.jsonl", "x.npz"], 2),
    (["--journal-fsck", "j.jsonl", "x.npz"], 2),
])
def test_cli_selfcheck_runs_and_fsck_needs_it(tmp_path, monkeypatch,
                                              capsys, argv, rc):
    """``--selfcheck`` runs the port's analyzer (exit 0 on this tree:
    the lint is clean and the contracts the CPU decides hold);
    ``--journal-fsck`` without ``--selfcheck`` is a parser error."""
    from iterative_cleaner_torch.cli import main

    monkeypatch.chdir(tmp_path)
    if rc == 2:
        with pytest.raises(SystemExit) as ei:
            main(["--device", "cpu", "-q", *argv])
        assert ei.value.code == 2
        assert "--journal-fsck only applies to --selfcheck" \
            in capsys.readouterr().err
        return
    assert main(["--device", "cpu", "-q", *argv]) == 0
    out = capsys.readouterr().out
    if "json" in argv:
        assert json.loads(out[out.index("{\n"):])["ok"] is True
    else:
        assert "0 findings" in out


def test_cli_fleet_write_failure_exit_nonzero(tmp_path, monkeypatch):
    """A write-back failure does not abort the fleet (the other outputs
    land) but the exit status reports it."""
    import iterative_cleaner_torch.cli as cli

    monkeypatch.chdir(tmp_path)
    paths = _write_fleet(tmp_path, [(8, 16, 32)] * 3)
    real_clean_one = cli.clean_one

    def flaky_clean_one(path, args, *a, **kw):
        if path == paths[1]:
            raise IOError("disk full")
        return real_clean_one(path, args, *a, **kw)

    monkeypatch.setattr(cli, "clean_one", flaky_clean_one)
    rc = cli.main(["--device", "cpu", "-q", "--fleet", "--retries", "0",
                   "--rotation", "roll", *paths])
    assert rc == 1
    assert os.path.exists(paths[0] + "_cleaned.npz")
    assert os.path.exists(paths[2] + "_cleaned.npz")
    assert not os.path.exists(paths[1] + "_cleaned.npz")
