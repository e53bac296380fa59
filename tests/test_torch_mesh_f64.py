"""The port in float64 on the meshes and in a batch (``CleanConfig(dtype=
"float64")``), on the CPU against the reference package.

- The cell-sharded clean in float64 on 4 gloo ranks (a 2 x 2 mesh) against
  the reference's float64 ``clean_cube_sharded`` over ``cell_mesh(4)``
  (``fft_mode="dft"``, the roll rotation: XLA:CPU's FFT rejects sharded
  layouts): masks, loops and per-loop diffs equal, scores within rtol
  1e-9 and atol 1e-9 (``tests/test_torch_float64.py``'s tolerance; the
  measured worst is about 3e-13, the rank-order sums of the template
  stage against the whole clean's).  The same against the port's whole
  float64 clean; on a padded grid masks against both, scores against the
  reference (its pad cells sit in the plain diagnostic's lines); one rank
  bit-equal to the whole clean; exact and online streaming over the mesh
  in float64 against the port's single-card float64 streams.
- The tree-reduced selects with 64-bit keys: a hypothesis test of
  ``tree_masked_median_lanes`` over simulated shards (the reducers sum
  and take the minimum across a stacked shard axis) bit-equal to the
  single-device float64 select on the concatenated shards, with NaN,
  +-inf, -0/+0, ties and values whose keys differ only in their low 32
  bits; and ``tree_scaled_sides``/``tree_combine_zap`` on 4 gloo ranks in
  float64, bit-equal to K3's and the combine's plain float64 versions on
  the whole planes.
- The batch in float64: ``clean_archives_batched`` bit-equal to the port's
  single float64 cleans and mask-equal to the reference's float64
  ``clean_archives_batched``, alone and split over a ('batch',) mesh of
  two gloo ranks.

Every spawn of rank processes has its own timeout.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from iterative_cleaner_torch import CleanConfig
from iterative_cleaner_torch.backends import clean_archive
from iterative_cleaner_torch.io import load_archive, save_archive
from iterative_cleaner_torch.io.synthetic import make_synthetic_archive
from iterative_cleaner_torch.parallel import clean_archives_batched
from iterative_cleaner_torch.parallel import clean_streaming
from iterative_cleaner_torch.parallel.distributed import run_local_ranks
from iterative_cleaner_torch.parallel.shard_stats import (
    tree_masked_median_lanes,
)
from iterative_cleaner_torch.stats import kernels as tk
from iterative_cleaner_tpu.config import CleanConfig as JaxConfig
from iterative_cleaner_tpu.parallel import mesh as jax_mesh
from iterative_cleaner_tpu.parallel.batch import (
    clean_archives_batched as jax_clean_archives_batched,
)
from iterative_cleaner_tpu.parallel.sharding import clean_cube_sharded
from tests.test_torch_kernels import _diag_planes
from tests.torch_shard_ranks import batch_rank, jobs_rank, scaler_rank

SPAWN_TIMEOUT_S = 240
E2E = dict(rotation="roll", max_iter=3, dtype="float64")
FRAMES = ("dispersed", "dedispersed")
SHAPES = {"even": (16, 32, 64), "padded": (15, 30, 64)}
RTOL = ATOL = 1e-9


def _spawn(target, n, args, tmp_path):
    return run_local_ranks(target, n, args, workdir=str(tmp_path),
                           timeout_s=SPAWN_TIMEOUT_S, threads=1)


@pytest.fixture(scope="module")
def archives(tmp_path_factory):
    d = tmp_path_factory.mktemp("f64_archives")
    out = {}
    for name, (nsub, nchan, nbin) in SHAPES.items():
        ar, _ = make_synthetic_archive(nsub=nsub, nchan=nchan, nbin=nbin,
                                       n_prezapped=5, seed=3)
        path = str(d / f"{name}.npz")
        save_archive(ar, path)
        out[name] = load_archive(path), path
    return out


@pytest.fixture(scope="module")
def mesh_runs(archives, tmp_path_factory):
    """Rank 0's results of each float64 mesh job, by key: the whole
    sharded clean on 1 and 4 ranks (both frames, the even grid) and on the
    padded grid, and the exact and online streams over 4 ranks."""
    jobs = {
        1: [(("whole", f), (archives["even"][1], 0, "exact",
                            dict(E2E, stats_frame=f))) for f in FRAMES],
        4: [(("whole", f), (archives["even"][1], 0, "exact",
                            dict(E2E, stats_frame=f))) for f in FRAMES]
        + [(("padded", "dispersed"), (archives["padded"][1], 0, "exact",
                                      E2E)),
           (("stream", "exact"), (archives["even"][1], 8, "exact", E2E)),
           (("stream", "online"), (archives["even"][1], 8, "online", E2E))],
    }
    out = {}
    for n, named in jobs.items():
        res = run_local_ranks(
            jobs_rank, n, ([job for _key, job in named],),
            workdir=str(tmp_path_factory.mktemp("f64_ranks")),
            timeout_s=SPAWN_TIMEOUT_S, threads=1)
        assert all(r is None for r in res[1:])
        for (key, _job), r in zip(named, res[0]):
            out[(n,) + key] = r
    return out


def _same_masks(got, want):
    np.testing.assert_array_equal(got.final_weights == 0,
                                  want.final_weights == 0)
    assert (got.loops, got.converged) == (want.loops, want.converged)
    np.testing.assert_array_equal(got.loop_diffs, want.loop_diffs)


@pytest.mark.parametrize("frame", FRAMES)
def test_float64_cell_mesh_matches_jax_and_whole(archives, mesh_runs, frame):
    ar = archives["even"][0]
    got = mesh_runs[4, "whole", frame]
    assert got.final_weights.dtype == np.float64
    cfg = JaxConfig(backend="jax", fft_mode="dft", stats_frame=frame, **E2E)
    jax = clean_cube_sharded(ar.total_intensity(), ar.weights, ar.freqs_mhz,
                             ar.dm, ar.centre_freq_mhz, ar.period_s, cfg,
                             jax_mesh.cell_mesh(4))
    whole = clean_archive(ar, CleanConfig(device="cpu", stats_frame=frame,
                                          **E2E))
    for want in (jax, whole):
        _same_masks(got, want)
        np.testing.assert_allclose(got.scores, want.scores, rtol=RTOL,
                                   atol=ATOL)


def test_float64_cell_mesh_padded_grid(archives, mesh_runs):
    """A grid the mesh does not divide, padded with zero-weight cells as
    the reference pads it: masks equal to the reference's and the whole
    clean's, scores to the reference's (the pad cells sit in the plain
    diagnostic's lines, so the whole clean's scores differ, as the
    reference's do)."""
    ar = archives["padded"][0]
    got = mesh_runs[4, "padded", "dispersed"]
    jax = clean_cube_sharded(ar.total_intensity(), ar.weights, ar.freqs_mhz,
                             ar.dm, ar.centre_freq_mhz, ar.period_s,
                             JaxConfig(backend="jax", fft_mode="dft", **E2E),
                             jax_mesh.cell_mesh(4))
    _same_masks(got, jax)
    np.testing.assert_allclose(got.scores, jax.scores, rtol=RTOL, atol=ATOL)
    _same_masks(got, clean_archive(ar, CleanConfig(device="cpu", **E2E)))


@pytest.mark.parametrize("frame", FRAMES)
def test_float64_one_rank_bit_equal_to_whole(archives, mesh_runs, frame):
    got = mesh_runs[1, "whole", frame]
    want = clean_archive(archives["even"][0],
                         CleanConfig(device="cpu", stats_frame=frame, **E2E))
    for field in ("final_weights", "scores", "loop_diffs", "loop_rfi_frac",
                  "iter_metrics"):
        g, w = getattr(got, field), getattr(want, field)
        assert g.dtype == w.dtype and g.shape == w.shape, field
        np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8),
                                      err_msg=field)
    assert (got.loops, got.converged) == (want.loops, want.converged)


@pytest.mark.parametrize("mode", ["exact", "online"])
def test_float64_mesh_streams(archives, mesh_runs, mode):
    """Streaming over the mesh in float64: the exact stream's mask equals
    the whole float64 clean's, each mode's the single-card float64
    stream's."""
    ar = archives["even"][0]
    got = mesh_runs[4, "stream", mode]
    cfg = CleanConfig(device="cpu", **E2E)
    single = clean_streaming(ar, 8, cfg, mode=mode)
    np.testing.assert_array_equal(got.final_weights == 0,
                                  single.final_weights == 0)
    if mode == "exact":
        _same_masks(got, clean_archive(ar, cfg))


# ---------------------------------------------------- the 64-bit tree select

_SPECIAL = [0.0, -0.0, np.inf, -np.inf, np.nan, 1.0, -1.0, 2.5, 1e300,
            -1e-300, 5e-324]
# keys that differ only in their low 32 bits: neighbours of 1.0 and -3.0
_LOW_BITS = [float(np.float64(v) + k * np.spacing(np.float64(v)))
             for v in (1.0, -3.0) for k in (1, 2, 3, 2 ** 20, 2 ** 31 + 7)]


def _stacked_reducers():
    """Reducers over a leading shard axis of stacked per-shard tensors:
    what the rank group's all-reduces compute, each shard's row
    receiving the total."""
    def reduce_sum(x):
        return x.sum(0, keepdim=True).to(x.dtype).expand_as(x)

    def reduce_min(x):
        return x.amin(0, keepdim=True).expand_as(x)

    def reduce_any(x):
        return x.any(0, keepdim=True).expand_as(x)

    return reduce_sum, reduce_min, reduce_any


def _f64_bits_equal(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    nan_g, nan_w = np.isnan(got), np.isnan(want)
    np.testing.assert_array_equal(nan_g, nan_w)
    np.testing.assert_array_equal(got[~nan_g].view(np.int64),
                                  want[~nan_w].view(np.int64))


@settings(max_examples=60, deadline=None)
@given(data=st.data(), shards=st.integers(1, 4), rows=st.integers(1, 7),
       lanes=st.integers(1, 3))
def test_tree_select_64bit_bit_equal(data, shards, rows, lanes):
    n = shards * rows
    value = st.one_of(st.sampled_from(_SPECIAL + _LOW_BITS),
                      st.floats(width=64, allow_nan=True,
                                allow_infinity=True))
    vals = np.array(data.draw(st.lists(value, min_size=n * lanes,
                                       max_size=n * lanes)),
                    dtype=np.float64).reshape(n, lanes)
    mask = np.array(data.draw(st.lists(st.booleans(), min_size=n * lanes,
                                       max_size=n * lanes))).reshape(n, lanes)
    # the select's lines hold no NaN (the scalers patch NaN lines apart);
    # a NaN here is an entry the mask hides
    mask |= np.isnan(vals)
    v, m = torch.from_numpy(vals), torch.from_numpy(mask)
    want, want_n = tk.masked_median_keys(v, m, 0)
    got, got_n = tree_masked_median_lanes(v.reshape(shards, rows, lanes),
                                          m.reshape(shards, rows, lanes), 1,
                                          _stacked_reducers())
    for r in range(shards):
        _f64_bits_equal(got[r].numpy(), want.numpy())
        np.testing.assert_array_equal(got_n[r].numpy(), want_n.numpy())


def test_tree_select_key_bisection_is_64_steps():
    """A float64 line's keys differ only in their low bits: a 32-step
    bisection over the high word could not separate them."""
    base = np.float64(1.0)
    vals = np.array([base + k * np.spacing(base) for k in (5, 1, 3, 2, 4)])
    v = torch.from_numpy(vals).reshape(5, 1)
    m = torch.zeros_like(v, dtype=torch.bool)
    got, n = tree_masked_median_lanes(v.reshape(1, 5, 1), m.reshape(1, 5, 1),
                                      1, _stacked_reducers())
    assert int(n[0, 0, 0]) == 5
    assert float(got[0, 0, 0]) == float(base + 3 * np.spacing(base))


def _f64_planes():
    d, mask = _diag_planes(16, 32, seed=3)
    d = [p.astype(np.float64) for p in d]
    rng = np.random.default_rng(9)
    for p in d[:3]:
        # neighbours in the last bits of one value: 64-bit keys apart only
        # in their low word
        p[11, 4:12] = 0.75 + np.arange(8) * np.spacing(0.75)
        p[12, :] += rng.standard_normal(32) * 1e-12
    return d, mask


def test_tree_scalers_float64_bit_equal(tmp_path):
    """tree_scaled_sides (both orientations) and tree_combine_zap on a
    2 x 2 mesh of float64 shards, bit-equal to scaled_sides_plain and the
    combine's plain version on the whole float64 planes."""
    d, mask = _f64_planes()
    shape = mask.shape
    rng = np.random.default_rng(5)
    worig = np.where(mask, 0.0, rng.uniform(0.5, 2.0, shape))
    thresh = (5.0, 3.7)
    got_sides = [[np.empty(shape) for _ in range(4)] for _ in range(2)]
    got_w, got_s = np.empty(shape), np.empty(shape)
    for (s0, c0), sides, new_w, scores in _spawn(
            scaler_rank, 4, (d, mask, worig, *thresh), tmp_path):
        cut = (slice(s0, s0 + new_w.shape[0]), slice(c0, c0 + new_w.shape[1]))
        assert new_w.dtype == np.float64
        for axis in (0, 1):
            for k in range(4):
                got_sides[axis][k][cut] = sides[axis][k]
        got_w[cut], got_s[cut] = new_w, scores
    planes = [torch.from_numpy(p) for p in d]
    m = torch.from_numpy(mask)
    for axis in (0, 1):
        plain = tk.scaled_sides_plain(planes, m, axis, thresh[axis])
        for g, p in zip(got_sides[axis], plain):
            _f64_bits_equal(g, p.numpy())
    want_w, want_s = tk.fused_combine_plain(planes, m,
                                            torch.from_numpy(worig), *thresh)
    _f64_bits_equal(got_s, want_s.numpy())
    _f64_bits_equal(got_w, want_w.numpy())


# ------------------------------------------------------------- the batch

BATCH_CFG = dict(rotation="roll", max_iter=3, dtype="float64")


@pytest.fixture(scope="module")
def batch_archives(tmp_path_factory):
    d = tmp_path_factory.mktemp("f64_batch")
    out = []
    for s in range(3):
        ar, _ = make_synthetic_archive(nsub=8, nchan=16, nbin=32, seed=s,
                                       n_prezapped=3)
        path = str(d / f"b{s}.npz")
        save_archive(ar, path)
        out.append((load_archive(path), path))
    return out


def _bit_equal_results(got, want):
    for field in ("final_weights", "scores", "loop_diffs", "loop_rfi_frac",
                  "iter_metrics"):
        g, w = getattr(got, field), getattr(want, field)
        assert g.dtype == w.dtype, field
        np.testing.assert_array_equal(g, w, err_msg=field)
    assert (got.loops, got.converged) == (want.loops, want.converged)


def test_float64_batch_matches_singles_and_jax(batch_archives):
    ars = [a for a, _p in batch_archives]
    cfg = CleanConfig(device="cpu", **BATCH_CFG)
    got = clean_archives_batched(ars, cfg)
    jax = jax_clean_archives_batched(
        ars, JaxConfig(backend="jax", fft_mode="dft", **BATCH_CFG))
    for ar, g, j in zip(ars, got, jax):
        assert g.final_weights.dtype == np.float64
        _bit_equal_results(g, clean_archive(ar, cfg))
        _same_masks(g, j)
        np.testing.assert_allclose(g.scores, j.scores, rtol=RTOL, atol=ATOL)


def test_float64_batch_mesh_two_ranks(batch_archives, tmp_path):
    """The float64 batch split over a ('batch',) mesh of two gloo ranks
    (one pad slot): rank 0 gets every archive's result, bit-equal to its
    single float64 clean."""
    ranks = _spawn(batch_rank, 2, ([p for _a, p in batch_archives],
                                   BATCH_CFG), tmp_path)
    assert ranks[1] is None
    cfg = CleanConfig(device="cpu", **BATCH_CFG)
    for (ar, _p), got in zip(batch_archives, ranks[0]):
        _bit_equal_results(got, clean_archive(ar, cfg))
