"""Rank functions of the cell-sharded tests (tests/test_torch_shard.py),
run in spawned rank processes by
``iterative_cleaner_torch.parallel.distributed.run_local_ranks``.  This
module imports only the port, so the ranks never load JAX."""

import numpy as np
import torch
import torch.distributed as dist

from iterative_cleaner_torch import CleanConfig
from iterative_cleaner_torch.backends import clean_archive_sharded
from iterative_cleaner_torch.io import load_archive
from iterative_cleaner_torch.parallel.mesh import cell_mesh
from iterative_cleaner_torch.parallel.shard_stats import (
    tree_combine_zap,
    tree_scaled_sides,
)
from iterative_cleaner_torch.parallel.sharding import shard_layout


def mesh_rank():
    """This rank's grid, coordinates and subgroups' ranks."""
    mesh = cell_mesh()
    return (mesh.shape, mesh.coords,
            dist.get_process_group_ranks(mesh.sub_group),
            dist.get_process_group_ranks(mesh.chan_group))


def clean_rank(path, config_kwargs):
    """The sharded cleans of the archive at ``path``, one per entry of
    ``config_kwargs``: rank 0's results, None on the other ranks."""
    ar = load_archive(path)
    results = [clean_archive_sharded(ar, CleanConfig(device="cpu", **kw))
               for kw in config_kwargs]
    return None if results[0] is None else results


def die_rank():
    """Rank 1 raises while the others wait for it in a collective."""
    mesh = cell_mesh()
    if mesh.rank == 1:
        raise RuntimeError("rank 1 dies")
    mesh.reduce_int(torch.ones(1, dtype=torch.int32))


def scaler_rank(planes, mask, weights, chanthresh, subintthresh):
    """This rank's block of both orientations' tree-reduced scaled sides
    and of tree_combine_zap, with its block's corner."""
    mesh = cell_mesh()
    lay = shard_layout(mesh, *mask.shape)
    cut = (slice(lay.s0, lay.s1), slice(lay.c0, lay.c1))
    diags = tuple(torch.from_numpy(np.ascontiguousarray(p[cut]))
                  for p in planes)
    m = torch.from_numpy(np.ascontiguousarray(mask[cut]))
    w = torch.from_numpy(np.ascontiguousarray(weights[cut]))
    sides = [tree_scaled_sides(diags, m, axis, t, mesh)
             for axis, t in ((0, chanthresh), (1, subintthresh))]
    new_w, scores = tree_combine_zap(diags, m, w, chanthresh, subintthresh,
                                     mesh)
    return ((lay.s0, lay.c0),
            [[s.numpy() for s in side] for side in sides],
            new_w.numpy(), scores.numpy())
