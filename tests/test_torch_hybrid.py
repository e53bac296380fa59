"""The hybrid batch-cell mesh and this host's batch mesh on the CPU, as
``tests/test_distributed.py`` holds the reference's.

- ``hybrid_layout``: the reference's ``hybrid_batch_cell_mesh`` shapes
  over 8 ranks (batch 2 -> 2 x 2 cells, 4 -> 1 x 2, 1 -> 2 x 4) and its
  refusal of a batch that does not divide the ranks (``ValueError``);
  ``hybrid_batch_cell_mesh`` on 4 gloo ranks: the slots' contiguous ranks
  and each slot's cell coordinates.
- ``clean_archives_hybrid`` on 4 gloo ranks (batch 2 x a 1 x 2 cell mesh)
  with 3 archives (one pad slot), in float32 and float64: masks and
  loops equal to the reference's ``clean_archives_hybrid`` on the
  conftest's 8 host devices (batch 2 x 2 x 2) and to the port's single
  cleans; rank 0 alone gets the results.
- ``local_batch_mesh`` over 4 ranks as 2 hosts of 2: each host's group
  holds its own ranks, and a collective over it stays within the host.

Every spawn of rank processes has its own timeout.
"""

import numpy as np
import pytest

from iterative_cleaner_torch import CleanConfig
from iterative_cleaner_torch.backends import clean_archive
from iterative_cleaner_torch.io import load_archive, save_archive
from iterative_cleaner_torch.io.synthetic import make_synthetic_archive
from iterative_cleaner_torch.parallel.distributed import (
    hybrid_layout,
    run_local_ranks,
)
from iterative_cleaner_tpu.config import CleanConfig as JaxConfig
from iterative_cleaner_tpu.parallel import distributed as jax_distributed
from tests.torch_shard_ranks import hybrid_rank, local_mesh_rank

SPAWN_TIMEOUT_S = 240
E2E = dict(rotation="roll", max_iter=3)


@pytest.mark.parametrize("batch,shape", [(2, (2, 2)), (4, (1, 2)),
                                         (1, (2, 4))])
def test_hybrid_layout_shapes(batch, shape):
    assert hybrid_layout(8, batch) == (batch, *shape)
    ref = jax_distributed.hybrid_batch_cell_mesh(batch=batch)
    assert (ref.shape["batch"], ref.shape["sub"], ref.shape["chan"]) == \
        hybrid_layout(8, batch)


@pytest.mark.parametrize("world,batch", [(8, 3), (4, 3), (6, 4), (4, 0)])
def test_hybrid_layout_rejects_nondivisible(world, batch):
    with pytest.raises(ValueError, match="do not divide"):
        hybrid_layout(world, batch)


@pytest.fixture(scope="module")
def hybrid_archives(tmp_path_factory):
    d = tmp_path_factory.mktemp("hybrid")
    out = []
    for s in (0, 1, 2):
        ar, _ = make_synthetic_archive(nsub=8, nchan=16, nbin=32, seed=s)
        path = str(d / f"h{s}.npz")
        save_archive(ar, path)
        out.append((load_archive(path), path))
    return out


@pytest.fixture(scope="module")
def hybrid_runs(hybrid_archives, tmp_path_factory):
    kwargs = [E2E, dict(E2E, dtype="float64")]
    return run_local_ranks(
        hybrid_rank, 4, ([p for _a, p in hybrid_archives], kwargs, 2),
        workdir=str(tmp_path_factory.mktemp("hybrid_ranks")),
        timeout_s=SPAWN_TIMEOUT_S, threads=1)


def test_hybrid_mesh_ranks(hybrid_runs):
    """Slot k holds ranks [2k, 2k + 2), each slot a 1 x 2 cell mesh."""
    got = [(shape, slot, coords) for shape, slot, coords, _r in hybrid_runs]
    assert got == [((2, 1, 2), 0, (0, 0)), ((2, 1, 2), 0, (0, 1)),
                   ((2, 1, 2), 1, (0, 0)), ((2, 1, 2), 1, (0, 1))]
    assert all(r is None for *_x, r in hybrid_runs[1:])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_hybrid_clean_matches_jax_and_single(hybrid_archives, hybrid_runs,
                                             dtype):
    ars = [a for a, _p in hybrid_archives]
    got = hybrid_runs[0][3][["float32", "float64"].index(dtype)]
    assert len(got) == len(ars)
    jax_cfg = JaxConfig(backend="jax", fft_mode="dft", dtype=dtype, **E2E)
    jax = jax_distributed.clean_archives_hybrid(
        ars, jax_cfg, jax_distributed.hybrid_batch_cell_mesh(batch=2))
    for ar, g, j in zip(ars, got, jax):
        assert g.final_weights.dtype == np.dtype(dtype)
        single = clean_archive(ar, CleanConfig(device="cpu", dtype=dtype,
                                               **E2E))
        for want in (j, single):
            np.testing.assert_array_equal(g.final_weights == 0,
                                          want.final_weights == 0)
            assert g.loops == want.loops
        np.testing.assert_array_equal(g.final_weights, single.final_weights)


def test_local_batch_mesh_hosts(tmp_path):
    ranks = run_local_ranks(local_mesh_rank, 4, (2,), workdir=str(tmp_path),
                            timeout_s=SPAWN_TIMEOUT_S, threads=1)
    assert ranks == [(2, 0, [0, 1], 1), (2, 1, [0, 1], 1),
                     (2, 0, [2, 3], 5), (2, 1, [2, 3], 5)]
