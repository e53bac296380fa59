"""The port's streaming over a cell mesh (the reference's streamed shard
route: ``clean_streaming(ar, chunk, cfg, mesh, mode=...)``) against the
JAX package's ``clean_streaming`` over ``cell_mesh(4)`` and against the
port's own single-card stream; its refusals and ``--mesh cell --stream
N`` under ``torch.distributed.run``.

Ranks are spawned processes (``run_local_ranks``, gloo through a
``file://`` store, one torch thread each; tests/torch_shard_ranks.py),
one spawn per rank count streaming every case.

Tolerances: masks, loops, ``loop_diffs`` and ``iter_metrics[:, :2]``
exact.  Scores within rtol 1e-4 and a 1e-4 floor, as
tests/test_torch_streaming.py holds the single-card stream to the JAX
package: the template's cross-rank sums are regrouped, and the
reference's own streamed shard route is not score bit-equal to its
single-device stream either.  The online mode's padded final tile is
the exception: 3 real subints of 8, its zero-weight pad subints inside
the unmasked rFFT scaler, so its scores rest on medians and MADs of
three values, where float32 reassociation is amplified.  There the
port's single-card online stream already differs from the JAX
package's by up to 1.4e-3 relative (before any mesh; the reference's
own single-device and mesh streams by up to 3.4e-4), so that tile's
scores are held to rtol 2e-3.  One rank is bit-equal to the single-card
stream in every field.
"""

import os
import subprocess
import sys
import types

import numpy as np
import pytest

from iterative_cleaner_torch import CleanConfig
from iterative_cleaner_torch.config import check_mesh
from iterative_cleaner_torch.io import load_archive, save_archive
from iterative_cleaner_torch.io.synthetic import make_synthetic_archive
from iterative_cleaner_torch.parallel import (
    StreamingCleaner,
    clean_streaming,
    clean_streaming_exact,
)
from iterative_cleaner_torch.parallel.distributed import run_local_ranks
from iterative_cleaner_tpu.config import CleanConfig as JaxConfig
from iterative_cleaner_tpu.parallel import mesh as jax_mesh
from iterative_cleaner_tpu.parallel.streaming import (
    clean_streaming as jax_clean_streaming,
)
from tests.torch_shard_ranks import jobs_rank

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAWN_TIMEOUT_S = 240
CHUNK = 8

# the roll rotation (XLA:CPU's FFT rejects sharded layouts), three
# iterations, as tests/test_torch_shard.py
E2E = dict(rotation="roll", max_iter=3)
# archives by name: nsub (32: four whole tiles of 8; 27: a final tile of
# 3 subints, padded to the 'sub' axis on the port's mesh, to the tile by
# the reference)
GEOMS = {"whole": 32, "partial": 27}
ROUTES = {"default": {}, "profile": dict(baseline_mode="profile"),
          "dedispersed": dict(stats_frame="dedispersed")}
# (geometry, mode, route) of the four-rank streams
CASES = [("partial", "exact", "default"), ("partial", "exact", "profile"),
         ("partial", "exact", "dedispersed"), ("whole", "exact", "default"),
         ("whole", "online", "default"), ("partial", "online", "default")]
# of the one-rank streams, held bit for bit to the single-card stream
ONE_RANK = [("partial", "exact", "default"), ("partial", "exact", "profile"),
            ("partial", "online", "default")]


def _config(route, **kw):
    return CleanConfig(device="cpu", **E2E, **ROUTES[route], **kw)


@pytest.fixture(scope="module")
def archives(tmp_path_factory):
    root = tmp_path_factory.mktemp("shard_stream")
    out = {}
    for name, nsub in GEOMS.items():
        ar, _ = make_synthetic_archive(nsub=nsub, nchan=32, nbin=64, seed=4,
                                       n_prezapped=8, n_rfi_cells=10)
        path = str(root / f"{name}.npz")
        save_archive(ar, path)
        out[name] = load_archive(path), path
    return out


@pytest.fixture(scope="module")
def streamed(archives, tmp_path_factory):
    """Rank 0's result of each stream over the mesh, by (ranks, case)."""
    results = {}
    for n, cases in ((1, ONE_RANK), (4, CASES)):
        jobs = [(archives[geom][1], CHUNK, mode, dict(E2E, **ROUTES[route]))
                for geom, mode, route in cases]
        ranks = run_local_ranks(
            jobs_rank, n, (jobs,),
            workdir=str(tmp_path_factory.mktemp("ranks")),
            timeout_s=SPAWN_TIMEOUT_S, threads=1)
        assert all(r is None for r in ranks[1:])
        for case, res in zip(cases, ranks[0]):
            results[(n,) + case] = res
    return results


def _jax_streamed(ar, mode, route):
    cfg = JaxConfig(backend="jax", dtype="float32", stats_impl="fused",
                    fft_mode="dft", median_impl="pallas", **E2E,
                    **ROUTES[route])
    return jax_clean_streaming(ar, CHUNK, cfg, jax_mesh.cell_mesh(4),
                               mode=mode)


def _assert_scores(got, want, nsub, mode):
    """rtol 1e-4 with a 1e-4 floor; rtol 2e-3 on the online mode's padded
    final tile (see the module docstring)."""
    padded = mode == "online" and nsub % CHUNK
    rows = nsub - nsub % CHUNK if padded else nsub
    np.testing.assert_allclose(got.scores[:rows], want.scores[:rows],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.scores[rows:], want.scores[rows:],
                               rtol=2e-3, atol=1e-4)


@pytest.mark.parametrize("geom,mode,route", CASES)
def test_four_ranks_match_jax_and_single_card(archives, streamed, geom, mode,
                                              route):
    ar = archives[geom][0]
    got = streamed[(4, geom, mode, route)]
    jax = _jax_streamed(ar, mode, route)
    single = clean_streaming(ar, CHUNK, _config(route), mode=mode)
    for want in (jax, single):
        np.testing.assert_array_equal(got.final_weights, want.final_weights)
        assert (got.loops, got.converged) == (want.loops, want.converged)
        if mode == "exact":
            np.testing.assert_array_equal(got.loop_diffs, want.loop_diffs)
        np.testing.assert_array_equal(got.iter_metrics[:, :2],
                                      want.iter_metrics[:, :2])
        _assert_scores(got, want, ar.nsub, mode)


@pytest.mark.parametrize("geom,mode,route", ONE_RANK)
def test_one_rank_bit_equal_to_single_card(archives, streamed, geom, mode,
                                           route):
    got = streamed[(1, geom, mode, route)]
    want = clean_streaming(archives[geom][0], CHUNK, _config(route),
                           mode=mode)
    for field in ("final_weights", "scores", "loop_diffs", "loop_rfi_frac",
                  "iter_metrics"):
        g, w = getattr(got, field), getattr(want, field)
        if w is None:
            assert g is None, field
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, field
        np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8),
                                      err_msg=field)
    assert (got.loops, got.converged) == (want.loops, want.converged)


# ------------------------------------------------------------ refusals

def test_refusals(archives):
    """Refused before any collective or device work: a tile grid the
    mesh does not divide (``ValueError``, the reference's message), the
    outputs that are not gathered (``unload_res``, ``record_history``),
    on the batch mesh too (which itself no longer refuses: the batched
    clean is ported)."""
    ar = archives["partial"][0]
    mesh = types.SimpleNamespace(shape=(2, 2), rank=0, coords=(0, 0))
    cfg = _config("default")
    for call in (lambda: clean_streaming_exact(ar, 7, cfg, mesh=mesh),
                 lambda: clean_streaming(ar, 7, cfg, mesh),
                 lambda: clean_streaming(ar, 7, cfg, mesh, mode="online"),
                 lambda: StreamingCleaner(8, cfg, ar.freqs_mhz[:31], ar.dm,
                                          ar.centre_freq_mhz, ar.period_s,
                                          mesh=mesh)):
        with pytest.raises(ValueError, match="must divide the tile grid"):
            call()
    for kw in (dict(unload_res=True), dict(record_history=True)):
        with pytest.raises(ValueError, match="unload_res/record_history"):
            clean_streaming(ar, 8, _config("default", **kw), mesh,
                            mode="online")
        with pytest.raises(ValueError, match="unload_res/record_history"):
            check_mesh("cell", _config("default", **kw))
    with pytest.raises(ValueError, match="unload_res"):
        clean_streaming(ar, 8, _config("default", unload_res=True), mesh)
    check_mesh("batch", cfg)
    with pytest.raises(ValueError, match="unload_res/record_history"):
        check_mesh("batch", _config("default", unload_res=True))


# ------------------------------------------------------------------ CLI

def test_cli_stream_under_torchrun_writes_one_output(archives, tmp_path):
    """``torch.distributed.run --nproc_per_node 2 -m iterative_cleaner_torch
    --mesh cell --stream 8 --device cpu``: rank 0 alone writes the output
    and the clean.log line; the mask equals the port's single-card exact
    stream."""
    ar, src = archives["partial"]
    path = tmp_path / "obs.npz"
    path.write_bytes(open(src, "rb").read())
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "iterative_cleaner_torch",
         "--mesh", "cell", "--stream", str(CHUNK), "--device", "cpu",
         "obs.npz"],
        cwd=tmp_path, env=env, capture_output=True, text=True,
        timeout=SPAWN_TIMEOUT_S)
    assert out.returncode == 0, out.stderr[-3000:]
    assert sorted(os.listdir(tmp_path)) == ["clean.log", "obs.npz",
                                            "obs.npz_cleaned.npz"]
    log = open(tmp_path / "clean.log").read()
    assert log.count("Cleaned obs.npz") == 1 and "stream='8'" in log
    assert out.stdout.count("Cleaned archive: obs.npz_cleaned.npz") == 1
    want = clean_streaming(ar, CHUNK, CleanConfig(device="cpu"))
    got = load_archive(str(tmp_path / "obs.npz_cleaned.npz"))
    np.testing.assert_array_equal(got.weights == 0, want.final_weights == 0)
