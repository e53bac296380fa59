"""Rank functions of the cell-sharded tests (tests/test_torch_shard.py,
tests/test_torch_shard_two_read.py, tests/test_torch_shard_stream.py) and
of the batch mesh (tests/test_torch_batch.py), run in spawned rank
processes by
``iterative_cleaner_torch.parallel.distributed.run_local_ranks``.  This
module imports only the port, so the ranks never load JAX."""

import numpy as np
import torch
import torch.distributed as dist

from iterative_cleaner_torch import CleanConfig
from iterative_cleaner_torch.backends import clean_archive_sharded
from iterative_cleaner_torch.io import load_archive
from iterative_cleaner_torch.parallel import clean_streaming
from iterative_cleaner_torch.parallel.batch import clean_archives_batched
from iterative_cleaner_torch.parallel.mesh import batch_mesh, cell_mesh
from iterative_cleaner_torch.parallel.shard_stats import (
    sharded_scale_and_combine,
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


def batch_rank(paths, config_kwargs):
    """The batched clean of the archives at ``paths`` over the
    ('batch',) mesh of every rank: rank 0's results, None on the
    others."""
    return clean_archives_batched([load_archive(p) for p in paths],
                                  CleanConfig(device="cpu", **config_kwargs),
                                  batch_mesh())


def jobs_rank(jobs):
    """Each job of ``jobs``, ``(path, chunk, mode, config_kwargs)``: the
    sharded clean of the archive at ``path`` (``chunk`` 0) or its
    stream in ``chunk``-subint tiles over the mesh in ``mode``.  Rank
    0's results, None on the other ranks."""
    mesh = cell_mesh()
    results = []
    for path, chunk, mode, kw in jobs:
        ar, cfg = load_archive(path), CleanConfig(device="cpu", **kw)
        results.append(clean_archive_sharded(ar, cfg, mesh) if chunk == 0
                       else clean_streaming(ar, chunk, cfg, mesh, mode=mode))
    return None if mesh.rank else results


def gathered_scaler_rank(planes, weights, chanthresh, subintthresh):
    """This rank's block of sharded_scale_and_combine over whole planes
    the mesh divides, with its block's corner and the whole d_std and
    mask it returns."""
    mesh = cell_mesh()
    lay = shard_layout(mesh, *weights.shape)
    cut = (slice(lay.s0, lay.s1), slice(lay.c0, lay.c1))
    diags = tuple(torch.from_numpy(np.ascontiguousarray(p[cut]))
                  for p in planes)
    w = torch.from_numpy(np.ascontiguousarray(weights[cut]))
    new_w, scores, d_std, mask = sharded_scale_and_combine(
        mesh, diags, w, chanthresh, subintthresh)
    return ((lay.s0, lay.c0), new_w.numpy(), scores.numpy(), d_std.numpy(),
            mask.numpy())


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


def hybrid_rank(paths, config_kwargs, batch):
    """The hybrid batch-cell clean of the archives at ``paths`` over
    ``hybrid_batch_cell_mesh(batch)``, once per entry of
    ``config_kwargs``: this rank's mesh shape, slot and cell coordinates,
    and rank 0's results (None on the other ranks)."""
    from iterative_cleaner_torch.parallel.distributed import (
        clean_archives_hybrid,
        hybrid_batch_cell_mesh,
    )

    mesh = hybrid_batch_cell_mesh(batch)
    ars = [load_archive(p) for p in paths]
    results = [clean_archives_hybrid(ars, CleanConfig(device="cpu", **kw),
                                     mesh) for kw in config_kwargs]
    return (mesh.shape, mesh.slot, mesh.cells.coords,
            None if results[0] is None else results)


def local_mesh_rank(local_size):
    """This rank's local_batch_mesh over hosts of ``local_size`` ranks:
    its size, rank within the host, its group's global ranks, and a sum
    over the host's ranks of the global ranks (the group's collective)."""
    from iterative_cleaner_torch.parallel.mesh import local_batch_mesh

    mesh = local_batch_mesh(local_size)
    total = torch.tensor([dist.get_rank()], dtype=torch.int32)
    if mesh.group is not None or mesh.size > 1:
        dist.all_reduce(total, group=mesh.group)
    ranks = (list(range(dist.get_world_size())) if mesh.group is None
             else dist.get_process_group_ranks(mesh.group))
    return mesh.size, mesh.rank, ranks, int(total[0])


def fleet_rank(paths, config, faults, seed, stall_s=0.0):
    """clean_fleet (``config``, a CleanConfig) over the ('batch',) mesh of
    every rank, with the seeded fault spec ``faults`` on rank 0; with
    ``stall_s``, rank 1's first load sleeps that long first (a rank that
    is slow but alive).  This rank's report as plain data (each result's
    weights and loops, each failure's path, stage and error type, the
    skipped paths)."""
    import time

    from iterative_cleaner_torch.parallel.fleet import clean_fleet
    from iterative_cleaner_torch.resilience import (
        FaultInjector,
        ResiliencePlan,
    )

    stalled = []

    def load(path):
        if stall_s and dist.get_rank() == 1 and not stalled:
            stalled.append(path)
            time.sleep(stall_s)
        return load_archive(path)

    plan = ResiliencePlan(faults=FaultInjector(faults, seed=seed)
                          if faults else None)
    report = clean_fleet(list(paths), config, mesh=batch_mesh(),
                         resilience=plan, io_workers=1, load_fn=load)
    return ({p: (r.final_weights, r.loops) for p, r in report.results.items()},
            sorted((p, st, type(e).__name__) for p, st, e in report.failures),
            sorted(report.skipped))


def aggregate_rank(store, counters_by_rank):
    """aggregate_metrics_across_processes over a coordinator group of
    every rank (joined again at the ``file://`` ``store``): each rank's
    counters from ``counters_by_rank``, the sums it gets back."""
    from iterative_cleaner_torch.parallel import distributed
    from iterative_cleaner_torch.telemetry.registry import MetricsRegistry

    rank, world = dist.get_rank(), dist.get_world_size()
    distributed.shutdown()
    distributed.initialize(device="cpu", coordinator=f"file://{store}",
                           rank=rank, world_size=world)
    reg = MetricsRegistry()
    return (distributed.coordinated_processes(),
            distributed.aggregate_metrics_across_processes(
                counters_by_rank[rank], registry=reg),
            reg.snapshot()["counters"].get("telemetry_degraded", 0))


def stall_build(device, mesh, layout, shape):
    """A padded-mesh program's build that never returns (the contract
    run's rank timeout)."""
    import time

    time.sleep(600)
