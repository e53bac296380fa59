"""The ('sub', 'chan') rank grid of the cell-sharded clean, and the 1-D
('batch',) rank axis of the batched clean.

The port's counterpart of ``iterative_cleaner_tpu/parallel/mesh.py``
``cell_mesh``: where the reference lays its devices out as a 2-D
``jax.sharding.Mesh``, the port lays the ranks of an initialised
``torch.distributed`` process group out as the same grid.  Rank
``r = i * b + j`` of a ``(a, b) = factor_2d(world)`` grid holds subint
block ``i`` and channel block ``j`` of the (padded) cell grid, as device
``(i, j)`` of the reference's mesh does.  Its ``'sub'`` subgroup is the
ranks of its column (they hold the other subint blocks of its channels:
the channel scaler and the channel profiles reduce over it), its
``'chan'`` subgroup the ranks of its row.

:func:`batch_mesh` lays the same ranks out as the reference's
``batch_mesh``: a 1-D axis over which a batch of archives is split in
contiguous shares (``parallel/batch.py``); archives are independent, so
no collective crosses them and only the results travel, to rank 0.

Either mesh may lay out a subgroup of the job's ranks instead of all of
them (``ranks=``): its ranks are counted within it (``rank``, ``coords``),
and its collectives run over it.  :func:`local_batch_mesh` is a
:class:`BatchMesh` over this host's ranks (the multi-host fleet's
per-host mesh), and ``distributed.hybrid_batch_cell_mesh`` a
:class:`CellMesh` for each contiguous batch slot of ranks.  Groups are
made with ``dist.new_group``, which every rank of the job must call in
the same order, for the groups it is not in too.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import os
from typing import Optional

import torch
import torch.distributed as dist

from iterative_cleaner_torch.parallel import distributed as _dist


def factor_2d(n: int) -> tuple[int, int]:
    """Factor n devices into the most-square (a, b) grid with a*b == n."""
    for a in range(int(math.isqrt(n)), 0, -1):
        if n % a == 0:
            return a, n // a
    return 1, n


@dataclasses.dataclass(frozen=True, eq=False)
class CellMesh:
    """This rank's place in the (a, b) rank grid, its device and its two
    subgroups, with the collectives the sharded clean runs over them:
    float partials added in rank order (``total``), int32 and int64
    all-reduces (``reduce_int``), blocks tiled into whole planes
    (``gather_cells``).  ``rank`` counts within the mesh's ranks
    (``all_group``, None for the whole job)."""

    shape: tuple            # (a, b): 'sub' and 'chan' axis sizes
    rank: int
    coords: tuple           # (i, j): this rank's subint and channel block
    device: torch.device
    sub_group: object       # the ranks of column j
    chan_group: object      # the ranks of row i
    all_group: object = None   # the mesh's ranks; None: every rank of the job

    def group(self, axis: str):
        """The process group of ``axis``: 'sub', 'chan' or 'all'."""
        return {"sub": self.sub_group, "chan": self.chan_group,
                "all": self.all_group}[axis]

    def total(self, x, axis: str):
        """The float ``x`` summed over ``axis``'s ranks in rank order
        (:func:`~iterative_cleaner_torch.parallel.distributed.
        gather_in_rank_order`): the same bits on every rank."""
        return _dist.gather_in_rank_order(x, self.group(axis))

    def reduce_int(self, x, op: str = "sum", axis: str = "all"):
        """An int32 or int64 tensor all-reduced over ``axis``."""
        return _dist.all_reduce_int(x, op, self.group(axis))

    def gather_cells(self, x):
        """This rank's (..., s, c) block of a cell plane tiled with every
        other rank's into the whole (..., a * s, b * c) plane, the same
        on every rank (:func:`~iterative_cleaner_torch.parallel.
        distributed.gather_cells`)."""
        return _dist.gather_cells(x, self.shape, self.all_group)

    def fetch(self, x):
        """Every mesh rank's ``x`` gathered to the mesh's rank 0 as host
        tensors, in mesh-rank order; None on the other ranks."""
        return _dist.host_fetch(x, self.all_group)


def _context():
    ctx = _dist.context()
    if ctx is None or not dist.is_initialized():
        raise RuntimeError("a mesh needs the process group of "
                           "parallel.distributed.initialize")
    return ctx


def _subgroups(ranks):
    """Each list of global ranks in ``ranks`` as a process group, made in
    that order on every rank (``dist.new_group`` is collective over the
    whole job); a list that is the whole job gives None, the default
    group."""
    world = dist.get_world_size()
    return [None if list(r) == list(range(world)) else dist.new_group(list(r))
            for r in ranks]


def cell_mesh(ranks=None) -> Optional[CellMesh]:
    """The :class:`CellMesh` of this rank over the process group that
    :func:`~iterative_cleaner_torch.parallel.distributed.initialize`
    started (or over the global ``ranks`` of it; None on a rank not among
    them), on the device it chose.  Every rank of the job must call it, in
    the same order as its other group creations: the subgroups are made
    with ``dist.new_group`` in one order on every rank."""
    ctx = _context()
    ranks = list(range(dist.get_world_size())) if ranks is None \
        else list(ranks)
    a, b = factor_2d(len(ranks))
    columns = [[ranks[ii * b + jj] for ii in range(a)] for jj in range(b)]
    rows = [[ranks[ii * b + jj] for jj in range(b)] for ii in range(a)]
    all_group, *groups = _subgroups([ranks] + columns + rows)
    if dist.get_rank() not in ranks:
        return None
    rank = ranks.index(dist.get_rank())
    i, j = divmod(rank, b)
    return CellMesh((a, b), rank, (i, j), ctx.device, groups[j],
                    groups[b + i], all_group)


@dataclasses.dataclass(frozen=True)
class BatchMesh:
    """This rank's place on the ('batch',) axis: ``size`` ranks, each
    cleaning the ``rank``-th contiguous share of a batch on ``device``.
    ``group`` holds the axis's ranks (None: every rank of the job), and
    ``rank`` counts within it; ``side_group`` is a gloo group over the
    same ranks, over which the fleet agrees on its decisions and
    exchanges results: ``group`` itself on a gloo job, else a gloo group
    beside it (None: the default group; unused on a mesh of one rank).
    Its collectives raise after the job's timeout."""

    size: int
    rank: int
    device: torch.device
    group: object = None
    side_group: object = None

    def fetch(self, x):
        """Every axis rank's ``x`` gathered to the axis's rank 0 as host
        tensors, in rank order; None on the other ranks."""
        return _dist.host_fetch(x, self.group)

    def share(self, n: int) -> tuple[int, int, int]:
        """``(pad, start, stop)`` of a batch of ``n`` archives: zero-weight
        pad slots up to a multiple of the axis (as the reference pads),
        and this rank's slots [start, stop) of the padded batch."""
        pad = (-n) % self.size
        per = (n + pad) // self.size
        return pad, self.rank * per, (self.rank + 1) * per


def batch_mesh() -> BatchMesh:
    """The :class:`BatchMesh` of this rank over the process group that
    :func:`~iterative_cleaner_torch.parallel.distributed.initialize`
    started, on the device it chose; its side group is the job's
    :func:`~iterative_cleaner_torch.parallel.distributed.object_group`."""
    ctx = _context()
    return BatchMesh(dist.get_world_size(), dist.get_rank(), ctx.device,
                     None, _dist.object_group())


def local_batch_mesh(local_size=None) -> BatchMesh:
    """A :class:`BatchMesh` over this host's ranks only: the multi-host
    fleet's per-host mesh (the reference's ``local_batch_mesh``).  The job's
    ranks are taken as hosts of ``local_size`` consecutive ranks (default:
    torchrun's ``LOCAL_WORLD_SIZE``, else 1: one rank a host, as the
    ``--coordinator`` form starts them); each host's group is made on every
    rank, in host order.  A host serves whole archives on its own cards:
    no collective of the mesh crosses hosts, so a dead host cannot hang
    another's groups."""
    ctx = _context()
    if local_size is None:
        local_size = int(os.environ.get("LOCAL_WORLD_SIZE", "") or 1)
    world, rank = dist.get_world_size(), dist.get_rank()
    if local_size < 1 or world % local_size:
        raise ValueError(f"{world} ranks do not divide into hosts of "
                         f"{local_size}")
    hosts = [range(h * local_size, (h + 1) * local_size)
             for h in range(world // local_size)]
    groups = _subgroups(hosts)
    sides = groups
    if ctx.backend != "gloo":
        # beside NCCL, a gloo group over each host's ranks, in host order
        timeout = datetime.timedelta(seconds=ctx.timeout_s)
        sides = [dist.new_group(list(r), backend="gloo", timeout=timeout)
                 for r in hosts]
    host = rank // local_size
    return BatchMesh(local_size, rank - host * local_size, ctx.device,
                     groups[host], sides[host])
