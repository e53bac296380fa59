"""The port's cell-sharded two_read route (the dispersed frame under the
profile baseline, a pulse window or a DEDISP=1 input: K7 on each rank's
block, then the gathered scaler ``sharded_scale_and_combine``) against
the JAX package's ``clean_cube_sharded`` over ``cell_mesh(n)`` (its
``sharded_cell_diagnostics_fused`` and ``sharded_scale_and_combine``)
and against the port's own whole clean.

Ranks are spawned processes (``run_local_ranks``, gloo through a
``file://`` store, one torch thread each; the rank functions in
tests/torch_shard_ranks.py import only the port), one spawn per (ranks,
shape) cleaning every configuration.

Tolerances: masks, loops, ``loop_diffs`` and ``iter_metrics[:, :2]``
exact; scores within rtol 1e-4, atol 1e-6 of the port's whole clean
(the template's cross-rank sums are regrouped), and within rtol 1e-4
with the 1e-4 floor of tests/test_torch_routes.py of the JAX package's
(the reference's own one- and two-device sharded cleans of the DEDISP=1
input here differ by up to 3.4e-4 relative); one rank bit-equal to
``clean_archive`` in every field.  On the padded grid the pad cells are
masked, but their ``d_fft`` enters the rFFT scaler's unmasked medians
as in the reference, so its scores are held to the JAX package's
sharded clean on the same padded grid and only its masks to the whole
clean.  The
gathered scaler alone is bit-equal to K3 and the combine on the whole
(padded) planes.
"""

import numpy as np
import pytest

from iterative_cleaner_torch import CleanConfig
from iterative_cleaner_torch.backends import clean_archive
from iterative_cleaner_torch.io import load_archive, save_archive
from iterative_cleaner_torch.io.synthetic import make_synthetic_archive
from iterative_cleaner_torch.parallel.distributed import run_local_ranks
from iterative_cleaner_torch.stats import kernels as tk
from iterative_cleaner_tpu.config import CleanConfig as JaxConfig
from iterative_cleaner_tpu.parallel import mesh as jax_mesh
from iterative_cleaner_tpu.parallel.sharding import clean_cube_sharded
from tests.test_torch_kernels import _bits_equal, _diag_planes, _t
from tests.torch_shard_ranks import gathered_scaler_rank, jobs_rank

SPAWN_TIMEOUT_S = 240

# tests/test_torch_shard.py's engine configuration: the roll rotation
# (XLA:CPU's FFT rejects sharded layouts), three iterations
E2E = dict(rotation="roll", max_iter=3)
# the two_read configurations, by name: (archive kind, config fields)
CASES = {
    "profile": ("dispersed", dict(baseline_mode="profile")),
    "pulse": ("dispersed", dict(pulse_region=(0.2, 20, 40))),
    "dedisp_input": ("dedisp", {}),
}
SHAPES = {"even": (16, 32, 64), "padded": (15, 30, 64)}
RUNS = [(1, "even"), (2, "even"), (4, "even"), (4, "padded")]


@pytest.fixture(scope="module")
def archives(tmp_path_factory):
    """The test archives and their files, by (shape, kind): a dispersed
    archive and a DEDISP=1 one."""
    out = {}
    root = tmp_path_factory.mktemp("two_read")
    for shape, (nsub, nchan, nbin) in SHAPES.items():
        for kind in ("dispersed", "dedisp"):
            ar, _ = make_synthetic_archive(
                nsub=nsub, nchan=nchan, nbin=nbin, seed=3, n_prezapped=5,
                disperse=kind == "dispersed")
            ar.dedispersed = kind == "dedisp"
            path = str(root / f"{shape}_{kind}.npz")
            save_archive(ar, path)
            out[shape, kind] = load_archive(path), path
    return out


@pytest.fixture(scope="module")
def sharded(archives, tmp_path_factory):
    """Rank 0's result of each sharded clean, by (ranks, shape, case):
    one spawn per (ranks, shape), cleaning every case."""
    results = {}
    for n, shape in RUNS:
        jobs = [(archives[shape, kind][1], 0, None, dict(E2E, **kw))
                for kind, kw in CASES.values()]
        ranks = run_local_ranks(
            jobs_rank, n, (jobs,),
            workdir=str(tmp_path_factory.mktemp("ranks")),
            timeout_s=SPAWN_TIMEOUT_S, threads=1)
        assert all(r is None for r in ranks[1:])
        for case, res in zip(CASES, ranks[0]):
            results[n, shape, case] = res
    return results


def _port_config(case):
    return CleanConfig(device="cpu", **E2E, **CASES[case][1])


def _jax_sharded(ar, case, n):
    cfg = JaxConfig(backend="jax", dtype="float32", stats_impl="fused",
                    fft_mode="dft", median_impl="pallas", **E2E,
                    **CASES[case][1])
    return clean_cube_sharded(ar.total_intensity(), ar.weights,
                              ar.freqs_mhz, ar.dm, ar.centre_freq_mhz,
                              ar.period_s, cfg, jax_mesh.cell_mesh(n),
                              dedispersed=ar.dedispersed)


def _assert_same_masks(got, want):
    np.testing.assert_array_equal(got.final_weights == 0,
                                  want.final_weights == 0)
    assert (got.loops, got.converged) == (want.loops, want.converged)
    np.testing.assert_array_equal(got.loop_diffs, want.loop_diffs)
    np.testing.assert_array_equal(got.iter_metrics[:, :2],
                                  want.iter_metrics[:, :2])


@pytest.mark.parametrize("n,shape", [(2, "even"), (4, "even"),
                                     (4, "padded")])
@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_two_read_matches_jax_and_whole(archives, sharded, n, shape,
                                                case):
    ar = archives[shape, CASES[case][0]][0]
    got = sharded[n, shape, case]
    jax = _jax_sharded(ar, case, n)
    whole = clean_archive(ar, _port_config(case))
    for want in (jax, whole):
        _assert_same_masks(got, want)
    np.testing.assert_allclose(got.scores, jax.scores, rtol=1e-4, atol=1e-4)
    if shape == "even":
        np.testing.assert_allclose(got.scores, whole.scores, rtol=1e-4,
                                   atol=1e-6)
        np.testing.assert_allclose(got.iter_metrics[:, 2:],
                                   whole.iter_metrics[:, 2:], rtol=1e-4)


@pytest.mark.parametrize("case", sorted(CASES))
def test_one_rank_bit_equal_to_clean_archive(archives, sharded, case):
    got = sharded[1, "even", case]
    want = clean_archive(archives["even", CASES[case][0]][0],
                         _port_config(case))
    for field in ("final_weights", "scores", "loop_diffs", "loop_rfi_frac",
                  "iter_metrics"):
        g, w = getattr(got, field), getattr(want, field)
        assert g.dtype == w.dtype and g.shape == w.shape, field
        np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8),
                                      err_msg=field)
    assert (got.loops, got.converged) == (want.loops, want.converged)


@pytest.mark.parametrize("shape", [(16, 32), (21, 36)])
def test_gathered_scaler_bit_equal(shape, tmp_path):
    """sharded_scale_and_combine on the blocks of a 2 x 2 mesh: every
    rank's block of the new weights and scores, and the whole d_std and
    mask it returns, bit-equal to K3 (both orientations) and the combine
    on the whole planes.  21 x 36 is padded to 22 x 36 first, as the
    sharded clean pads its grid: the pad row is zero-weight (masked) and
    zero in the diagnostics, and the whole planes are the padded ones."""
    d, mask = _diag_planes(*shape, seed=7)
    rng = np.random.default_rng(9)
    worig = np.where(mask, 0.0, rng.uniform(0.5, 2.0, mask.shape)
                     ).astype(np.float32)
    pad = (-shape[0]) % 2, (-shape[1]) % 2
    d = [np.pad(p, ((0, pad[0]), (0, pad[1]))) for p in d]
    worig = np.pad(worig, ((0, pad[0]), (0, pad[1])))
    thresh = (5.0, 3.7)
    ranks = run_local_ranks(gathered_scaler_rank, 4, (d, worig, *thresh),
                            workdir=str(tmp_path),
                            timeout_s=SPAWN_TIMEOUT_S, threads=1)
    wmask = worig == 0
    want_w, want_s = tk.fused_combine_plain([_t(p) for p in d], _t(wmask),
                                            _t(worig), *thresh)
    got_w, got_s = np.empty_like(worig), np.empty_like(worig)
    for (s0, c0), new_w, scores, d_std, m in ranks:
        cut = (slice(s0, s0 + new_w.shape[0]), slice(c0, c0 + new_w.shape[1]))
        got_w[cut], got_s[cut] = new_w, scores
        _bits_equal(d_std, d[0])
        np.testing.assert_array_equal(m, wmask)
    _bits_equal(got_s, want_s.numpy())
    _bits_equal(got_w, want_w.numpy())
