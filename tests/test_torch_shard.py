"""The port's cell-sharded clean (``iterative_cleaner_torch.parallel``:
``mesh``, ``distributed``, ``shard_stats``, ``sharding``) against the
JAX package's (``clean_cube_sharded`` over a ``cell_mesh(n)`` of the
suite's virtual CPU devices) and against the port's own single-device
clean.

Ranks are spawned processes (``run_local_ranks``) joined by gloo through
a ``file://`` store in ``tmp_path``; they import only the port
(tests/torch_shard_ranks.py) and run one torch thread each.  Every spawn
has its own timeout, and a rank that dies fails the test.

Tolerances: the distributed selects are bit-equal to the whole planes'
(integer merges); masks, loops and per-loop counts equal the JAX sharded
clean's and the port's whole clean's; scores within rtol 1e-4 (atol
1e-6): the template's cross-rank sums are regrouped (rank-order adds
here, XLA's partitioned sums in the reference).  One rank is bit-equal
to ``clean_archive``.  On a padded grid the zero-weight pad cells enter
the rFFT diagnostic's unmasked medians as the reference's do, so scores
follow the JAX sharded clean's and only the masks the whole clean's.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import jax.numpy as jnp

from iterative_cleaner_torch import CleanConfig
from iterative_cleaner_torch.backends import (
    clean_archive,
    clean_archive_sharded,
)
from iterative_cleaner_torch.io import load_archive, save_archive
from iterative_cleaner_torch.io.synthetic import make_synthetic_archive
from iterative_cleaner_torch.parallel.distributed import run_local_ranks
from iterative_cleaner_torch.parallel.mesh import factor_2d
from iterative_cleaner_torch.stats import kernels as tk
from iterative_cleaner_tpu.config import CleanConfig as JaxConfig
from iterative_cleaner_tpu.parallel import mesh as jax_mesh
from iterative_cleaner_tpu.parallel.sharding import clean_cube_sharded
from iterative_cleaner_tpu.stats import pallas_kernels as pk
from tests.test_torch_kernels import (
    _assert_diags_close,
    _bits_equal,
    _cell_inputs,
    _diag_planes,
    _t,
)
from tests.torch_shard_ranks import (
    clean_rank,
    die_rank,
    mesh_rank,
    scaler_rank,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAWN_TIMEOUT_S = 240

# tests/test_shard_sweep.py's engine configuration: the roll rotation
# (XLA:CPU's FFT rejects sharded layouts), three iterations
E2E = dict(rotation="roll", max_iter=3)
FRAMES = ("dispersed", "dedispersed")
SHAPES = {"even": (16, 32, 64), "padded": (15, 30, 64)}
RUNS = [(1, "even"), (2, "even"), (4, "even"), (4, "padded")]


def _spawn(target, n, args, tmp_path):
    return run_local_ranks(target, n, args, workdir=str(tmp_path),
                           timeout_s=SPAWN_TIMEOUT_S, threads=1)


# ------------------------------------------------------------- the grid

@pytest.mark.parametrize("n", range(1, 9))
def test_grid_matches_jax_cell_mesh(n):
    """factor_2d and the rank layout r = i * b + j equal the reference's
    cell_mesh(n): device (i, j) of its mesh is device i * b + j."""
    a, b = factor_2d(n)
    assert (a, b) == jax_mesh.factor_2d(n)
    ids = np.vectorize(lambda d: d.id)(jax_mesh.cell_mesh(n).devices)
    assert ids.shape == (a, b)
    for r in range(n):
        assert ids[divmod(r, b)] == r


@pytest.mark.parametrize("n", [4, 6])
def test_cell_mesh_groups(n, tmp_path):
    """Each rank's coordinates and subgroups: 'sub' its column, 'chan'
    its row."""
    a, b = factor_2d(n)
    for r, (shape, coords, sub, chan) in enumerate(
            _spawn(mesh_rank, n, (), tmp_path)):
        i, j = divmod(r, b)
        assert (tuple(shape), tuple(coords)) == ((a, b), (i, j))
        assert sub == [ii * b + j for ii in range(a)]
        assert chan == [i * b + jj for jj in range(b)]


# ------------------------------------------------- the distributed select

@pytest.mark.parametrize("n,shape", [(4, (16, 32)), (3, (21, 36))])
def test_tree_scalers_bit_equal(n, shape, tmp_path):
    """tree_scaled_sides (both orientations) and tree_combine_zap on
    column and row shards, bit-equal to the port's scaled_sides_plain and
    combine on the whole planes and to the reference's
    scaled_sides_pallas (interpret mode): masked cells, empty and
    zero-MAD lines, ties, signed zeros, NaN and inf on the rFFT plane."""
    d, mask = _diag_planes(*shape, seed=3)
    rng = np.random.default_rng(5)
    worig = np.where(mask, 0.0, rng.uniform(0.5, 2.0, mask.shape)
                     ).astype(np.float32)
    thresh = (5.0, 3.7)
    got_sides = [[np.empty(shape, np.float32) for _ in range(4)]
                 for _ in range(2)]
    got_w, got_s = np.empty(shape, np.float32), np.empty(shape, np.float32)
    for (s0, c0), sides, new_w, scores in _spawn(
            scaler_rank, n, (d, mask, worig, *thresh), tmp_path):
        cut = (slice(s0, s0 + new_w.shape[0]), slice(c0, c0 + new_w.shape[1]))
        for axis in (0, 1):
            for k in range(4):
                got_sides[axis][k][cut] = sides[axis][k]
        got_w[cut], got_s[cut] = new_w, scores
    planes = [_t(p) for p in d]
    for axis in (0, 1):
        plain = tk.scaled_sides_plain(planes, _t(mask), axis, thresh[axis])
        jax = pk.scaled_sides_pallas([jnp.asarray(p) for p in d],
                                     jnp.asarray(mask), axis, thresh[axis])
        for g, p, j in zip(got_sides[axis], plain, jax):
            _bits_equal(g, p.numpy())
            _bits_equal(g, j)
    want_w, want_s = tk.fused_combine_plain(planes, _t(mask), _t(worig),
                                            *thresh)
    _bits_equal(got_s, want_s.numpy())
    _bits_equal(got_w, want_w.numpy())


# ------------------------------------------------------------ K10's values

@pytest.mark.parametrize("frame", FRAMES)
def test_k10_plain_on_shard_vs_sweep_shard_diags(frame):
    """K10's plain version on one shard of a 2 x 2 grid against the
    reference's sweep_shard_diags_disp/_dedisp (interpret, the DMA
    route) on the same shard: rtol 1e-4 of each plane's scale, masked
    cells exact."""
    x = _cell_inputs(16, 32, 64, "fourier", seed=8)
    cut = (slice(8, 16), slice(16, 32))
    cube, w, m = x["disp"][cut], x["weights"][cut], x["mask"][cut]
    rows, nyq = x["rot_t"][16:32], x["nyq"][16:32]
    t = x["template"]
    if frame == "dispersed":
        got = tk.shard_diagnostics_disp(_t(cube), _t(rows), _t(nyq), _t(t),
                                        _t(w), _t(m))
        want = pk.sweep_shard_diags_disp(
            jnp.asarray(cube), jnp.asarray(rows), jnp.asarray(nyq),
            jnp.asarray(t), jnp.asarray(w), jnp.asarray(m), dma=True)
    else:
        window = (np.arange(64) < 40).astype(np.float32) * 0.5 + 0.5
        got = tk.shard_diagnostics_dedisp(_t(cube), _t(t), _t(window),
                                          _t(w), _t(m))
        want = pk.sweep_shard_diags_dedisp(
            jnp.asarray(cube), jnp.asarray(t), jnp.asarray(window),
            jnp.asarray(w), jnp.asarray(m), dma=True)
    _assert_diags_close(got, want, m)


# -------------------------------------------------------- whole cleans

@pytest.fixture(scope="module")
def archives(tmp_path_factory):
    """The test archives and their files, by shape name."""
    out = {}
    for name, (nsub, nchan, nbin) in SHAPES.items():
        ar, _ = make_synthetic_archive(nsub=nsub, nchan=nchan, nbin=nbin,
                                       seed=3, n_prezapped=5)
        path = str(tmp_path_factory.mktemp("shard") / f"{name}.npz")
        save_archive(ar, path)
        out[name] = load_archive(path), path
    return out


@pytest.fixture(scope="module")
def sharded(archives, tmp_path_factory):
    """Rank 0's result of each sharded clean, by (ranks, shape, frame):
    one spawn per (ranks, shape), cleaning both frames."""
    results = {}
    for n, shape in RUNS:
        kwargs = [dict(E2E, stats_frame=f) for f in FRAMES]
        ranks = run_local_ranks(
            clean_rank, n, (archives[shape][1], kwargs),
            workdir=str(tmp_path_factory.mktemp("ranks")),
            timeout_s=SPAWN_TIMEOUT_S, threads=1)
        assert all(r is None for r in ranks[1:])
        for frame, res in zip(FRAMES, ranks[0]):
            results[n, shape, frame] = res
    return results


def _jax_sharded(ar, frame, n):
    cfg = JaxConfig(backend="jax", dtype="float32", stats_impl="fused",
                    fft_mode="dft", median_impl="pallas", fused_sweep="on",
                    stats_frame=frame, **E2E)
    return clean_cube_sharded(ar.total_intensity(), ar.weights,
                              ar.freqs_mhz, ar.dm, ar.centre_freq_mhz,
                              ar.period_s, cfg, jax_mesh.cell_mesh(n))


@pytest.mark.parametrize("n,shape,frame",
                         [(2, "even", f) for f in FRAMES]
                         + [(4, "even", f) for f in FRAMES]
                         + [(4, "padded", "dispersed")])
def test_sharded_clean_matches_jax_and_whole(archives, sharded, n, shape,
                                             frame):
    ar = archives[shape][0]
    got = sharded[n, shape, frame]
    jax = _jax_sharded(ar, frame, n)
    whole = clean_archive(ar, CleanConfig(device="cpu", stats_frame=frame,
                                          **E2E))
    for want in (jax, whole):
        np.testing.assert_array_equal(got.final_weights == 0,
                                      want.final_weights == 0)
        assert (got.loops, got.converged) == (want.loops, want.converged)
        np.testing.assert_array_equal(got.loop_diffs, want.loop_diffs)
        np.testing.assert_allclose(got.loop_rfi_frac, want.loop_rfi_frac,
                                   rtol=1e-6)
        np.testing.assert_array_equal(got.iter_metrics[:, :2],
                                      want.iter_metrics[:, :2])
    np.testing.assert_allclose(got.scores, jax.scores, rtol=1e-4, atol=1e-6)
    if shape == "even":
        np.testing.assert_allclose(got.scores, whole.scores, rtol=1e-4,
                                   atol=1e-6)
        np.testing.assert_allclose(got.iter_metrics[:, 2:],
                                   whole.iter_metrics[:, 2:], rtol=1e-4)


@pytest.mark.parametrize("frame", FRAMES)
def test_one_rank_bit_equal_to_clean_archive(archives, sharded, frame):
    got = sharded[1, "even", frame]
    want = clean_archive(archives["even"][0],
                         CleanConfig(device="cpu", stats_frame=frame, **E2E))
    for field in ("final_weights", "scores", "loop_diffs", "loop_rfi_frac",
                  "iter_metrics"):
        g, w = getattr(got, field), getattr(want, field)
        assert g.dtype == w.dtype and g.shape == w.shape, field
        np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8),
                                      err_msg=field)
    assert (got.loops, got.converged) == (want.loops, want.converged)


def test_dead_rank_fails_the_run(tmp_path):
    """A rank that dies while the other waits for it in a collective
    fails the call at once: the waiting rank is stopped, nothing hangs."""
    with pytest.raises(RuntimeError, match=r"rank processes failed.*\(1, 1\)"):
        _spawn(die_rank, 2, (), tmp_path)


# ------------------------------------------------------------ refusals

def test_cuda_rank_without_a_card_raises():
    """A rank asked for a CUDA device raises where there is no card: the
    sharded clean never falls back to the CPU on its own."""
    import torch

    from iterative_cleaner_torch.parallel import distributed

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for call in (lambda: distributed.rank_device("cuda", 0),
                 lambda: distributed.initialize(device="cuda")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert distributed.context() is None


def test_cell_mesh_needs_initialize():
    """cell_mesh takes its device from initialize's context and raises
    without one, rather than choosing a device itself."""
    from iterative_cleaner_torch.parallel import distributed, mesh

    assert distributed.context() is None
    with pytest.raises(RuntimeError, match="initialize"):
        mesh.cell_mesh()


@pytest.mark.parametrize("kwargs,dedispersed,streaming", [
    (dict(baseline_mode="profile"), False, False),
    (dict(pulse_region=(0.2, 3, 9)), False, False),
    ({}, True, False),
    ({}, False, True),
])
def test_mesh_refusals_name_their_item(kwargs, dedispersed, streaming):
    """What ROADMAP item 7 refused until the sharded two_read route and
    the streamed shard route were ported (the profile baseline, a pulse
    window, a DEDISP=1 input, ``--stream``) passes ``check_mesh`` and
    cleans on a one-rank mesh with the mask of the clean without one;
    ``--mesh batch``, which named item 3 until the batched clean was
    ported, passes too, and refuses the residual as the cell mesh does."""
    from iterative_cleaner_torch.config import check_mesh
    from iterative_cleaner_torch.parallel import clean_streaming, distributed
    from iterative_cleaner_torch.parallel.mesh import cell_mesh

    cfg = CleanConfig(device="cpu", rotation="roll", **kwargs)
    check_mesh("cell", cfg)
    check_mesh("batch", CleanConfig(device="cpu"))
    with pytest.raises(ValueError, match="unload_res/record_history"):
        check_mesh("batch", CleanConfig(device="cpu", unload_res=True))
    ar, _ = make_synthetic_archive(nsub=8, nchan=8, nbin=32, seed=2,
                                   n_prezapped=3, disperse=not dedispersed)
    ar.dedispersed = dedispersed
    distributed.initialize(device="cpu")
    try:
        mesh = cell_mesh()
        got = clean_streaming(ar, 4, cfg, mesh) if streaming \
            else clean_archive_sharded(ar, cfg, mesh)
    finally:
        distributed.shutdown()
    want = clean_streaming(ar, 4, cfg) if streaming \
        else clean_archive(ar, cfg)
    np.testing.assert_array_equal(got.final_weights, want.final_weights)
    assert got.loops == want.loops


# ------------------------------------------------------------------ CLI

def test_cli_under_torchrun_writes_one_output(archives, tmp_path):
    """``torch.distributed.run --nproc_per_node 2 -m iterative_cleaner_torch
    --mesh cell --device cpu``: rank 0 alone writes the output and the
    clean.log line; the mask equals the clean without a mesh."""
    ar, src = archives["even"]
    path = tmp_path / "obs.npz"
    path.write_bytes(open(src, "rb").read())
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "iterative_cleaner_torch",
         "--mesh", "cell", "--device", "cpu", "obs.npz"],
        cwd=tmp_path, env=env, capture_output=True, text=True,
        timeout=SPAWN_TIMEOUT_S)
    assert out.returncode == 0, out.stderr[-3000:]
    assert sorted(os.listdir(tmp_path)) == ["clean.log", "obs.npz",
                                            "obs.npz_cleaned.npz"]
    assert open(tmp_path / "clean.log").read().count("Cleaned obs.npz") == 1
    assert out.stdout.count("Cleaned archive: obs.npz_cleaned.npz") == 1
    want = clean_archive(ar, CleanConfig(device="cpu"))
    got = load_archive(str(tmp_path / "obs.npz_cleaned.npz"))
    np.testing.assert_array_equal(got.weights == 0, want.final_weights == 0)
