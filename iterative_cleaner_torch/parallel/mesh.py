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
"""

from __future__ import annotations

import dataclasses
import math

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
    float partials added in rank order (``total``), int32 all-reduces
    (``reduce_int``), blocks tiled into whole planes
    (``gather_cells``)."""

    shape: tuple            # (a, b): 'sub' and 'chan' axis sizes
    rank: int
    coords: tuple           # (i, j): this rank's subint and channel block
    device: torch.device
    sub_group: object       # the ranks of column j
    chan_group: object      # the ranks of row i

    def group(self, axis: str):
        """The process group of ``axis``: 'sub', 'chan' or 'all'."""
        return {"sub": self.sub_group, "chan": self.chan_group,
                "all": None}[axis]

    def total(self, x, axis: str):
        """The float ``x`` summed over ``axis``'s ranks in rank order
        (:func:`~iterative_cleaner_torch.parallel.distributed.
        gather_in_rank_order`): the same bits on every rank."""
        return _dist.gather_in_rank_order(x, self.group(axis))

    def reduce_int(self, x, op: str = "sum", axis: str = "all"):
        """An int32 tensor all-reduced over ``axis``."""
        return _dist.all_reduce_int(x, op, self.group(axis))

    def gather_cells(self, x):
        """This rank's (..., s, c) block of a cell plane tiled with every
        other rank's into the whole (..., a * s, b * c) plane, the same
        on every rank (:func:`~iterative_cleaner_torch.parallel.
        distributed.gather_cells`)."""
        return _dist.gather_cells(x, self.shape)


def cell_mesh() -> CellMesh:
    """The :class:`CellMesh` of this rank over the process group that
    :func:`~iterative_cleaner_torch.parallel.distributed.initialize`
    started, on the device it chose.  Every rank must call it, in the
    same order as its other group creations: the subgroups are made with
    ``dist.new_group`` in one order on every rank."""
    ctx = _dist.context()
    if ctx is None or not dist.is_initialized():
        raise RuntimeError("cell_mesh needs the process group of "
                           "parallel.distributed.initialize")
    world, rank = dist.get_world_size(), dist.get_rank()
    a, b = factor_2d(world)
    i, j = divmod(rank, b)
    columns = [dist.new_group([ii * b + jj for ii in range(a)])
               for jj in range(b)]
    rows = [dist.new_group([ii * b + jj for jj in range(b)])
            for ii in range(a)]
    return CellMesh((a, b), rank, (i, j), ctx.device, columns[j], rows[i])


@dataclasses.dataclass(frozen=True)
class BatchMesh:
    """This rank's place on the ('batch',) axis: ``size`` ranks, each
    cleaning the ``rank``-th contiguous share of a batch on ``device``."""

    size: int
    rank: int
    device: torch.device

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
    started, on the device it chose."""
    ctx = _dist.context()
    if ctx is None or not dist.is_initialized():
        raise RuntimeError("batch_mesh needs the process group of "
                           "parallel.distributed.initialize")
    return BatchMesh(dist.get_world_size(), dist.get_rank(), ctx.device)
