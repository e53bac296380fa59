"""The cell-sharded clean: one archive over the ranks of a
``torch.distributed`` process group, each rank holding one (subint,
channel) block of the cell grid on its device.

The port's counterpart of ``iterative_cleaner_tpu/parallel/sharding.py``
(``clean_cube_sharded``, ``clean_archive_sharded``), with one process
per rank where the reference shards one program over a device mesh:

- the cell grid is padded up to the grid's divisibility with zero-weight
  subints and channels, the frequencies edge-padded (a padded channel's
  dispersion shift stays finite), as the reference pads;
- each rank converts and uploads only its block of the cube, in the
  engine's dtype (float32, or float64 under ``dtype='float64'``: K10's
  float64 build, 64-bit keys in the tree-reduced selects, the partial
  sums added in rank order, so every rank holds the same bits);
- :func:`~iterative_cleaner_torch.engine.loop.prepare` and
  :func:`~iterative_cleaner_torch.engine.loop.clean_loop` run on the
  block (stored bf16 after the preamble under ``compute_dtype=
  'bfloat16'``, resolved with ``stage='mesh'``: K10, K1 and K7 read the
  bf16 block) with the rank's :class:`~iterative_cleaner_torch.parallel.mesh.
  CellMesh` (the sums, selects and cycle check that cross blocks);
- the final weights and scores are gathered to rank 0, cropped, the pad
  cells taken out of the zap telemetry, and the whole-line sweep
  (``apply_bad_parts``) run on the gathered result.

Rank 0 returns the :class:`CleanResult`; the other ranks return None.
Every rank must call with the same archive and configuration.  The
weight history and the residual cube are not gathered: ``record_history``
and ``unload_res`` are refused, as in the reference
(:func:`~iterative_cleaner_torch.config.check_mesh`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from iterative_cleaner_torch.backends import base
from iterative_cleaner_torch.backends.base import CleanResult
from iterative_cleaner_torch.backends.torch_backend import (
    clean_device,
    config_compute_dtype,
    engine_dtype,
    upload_meta,
)
from iterative_cleaner_torch.config import CleanConfig, check_mesh
from iterative_cleaner_torch.engine.loop import clean_loop, prepare_stored
from iterative_cleaner_torch.parallel.mesh import CellMesh, cell_mesh


class ShardLayout(NamedTuple):
    """The padded cell grid and this rank's block of it."""

    nsub: int        # the archive's grid
    nchan: int
    pad_s: int       # zero-weight subints and channels added at the end
    pad_c: int
    s0: int          # this rank's block: subints [s0, s1), channels [c0, c1)
    s1: int
    c0: int
    c1: int

    @property
    def pad_cells(self) -> int:
        return ((self.nsub + self.pad_s) * (self.nchan + self.pad_c)
                - self.nsub * self.nchan)


def shard_layout(mesh: CellMesh, nsub: int, nchan: int) -> ShardLayout:
    """The grid padded up to ``mesh``'s divisibility and the block of
    ``mesh``'s rank."""
    a, b = mesh.shape
    pad_s, pad_c = (-nsub) % a, (-nchan) % b
    s_loc, c_loc = (nsub + pad_s) // a, (nchan + pad_c) // b
    i, j = mesh.coords
    return ShardLayout(nsub, nchan, pad_s, pad_c, i * s_loc, (i + 1) * s_loc,
                       j * c_loc, (j + 1) * c_loc)


def check_tile_grid(mesh: CellMesh, tile_nsub: int, nchan: int) -> None:
    """The streamed shard route's layout rule (the reference's
    ``shard_divisible`` check): each mesh axis divides the tile's
    (subint, channel) grid exactly, else ``ValueError``.  A streamed
    tile is not padded up to the mesh, as in the reference."""
    a, b = mesh.shape
    if tile_nsub % a or nchan % b:
        raise ValueError(
            f"each mesh axis must divide the tile grid exactly: tile "
            f"{tile_nsub}x{nchan} vs mesh {{'sub': {a}, 'chan': {b}}}; "
            f"adjust chunk_nsub or the mesh")


def _block(a, layout: ShardLayout, dtype=np.float32) -> np.ndarray:
    """This rank's block of the host (nsub, nchan, ...) array ``a`` as
    ``dtype`` (float32 or float64), zero where the block covers padding.
    Only the block is read and converted."""
    out = np.zeros((layout.s1 - layout.s0, layout.c1 - layout.c0)
                   + tuple(a.shape[2:]), dtype=dtype)
    rs = max(0, min(layout.s1, layout.nsub) - layout.s0)
    rc = max(0, min(layout.c1, layout.nchan) - layout.c0)
    out[:rs, :rc] = a[layout.s0:layout.s0 + rs, layout.c0:layout.c0 + rc]
    return out


def shard_host(cube, weights, freqs_mhz, layout: ShardLayout,
               dtype=np.float32):
    """This rank's block of the cube and the weights as host arrays of
    ``dtype`` (float32 or float64), and its channels' frequencies (a
    padded channel takes the last real channel's)."""
    chans = np.minimum(np.arange(layout.c0, layout.c1), layout.nchan - 1)
    return (_block(cube, layout, dtype), _block(weights, layout, dtype),
            np.asarray(freqs_mhz)[chans])


def upload_shard(cube, weights, freqs_mhz, layout: ShardLayout, device,
                 dtype=np.float32):
    """:func:`shard_host`'s block and weights as tensors of ``dtype``
    on ``device``, and the frequencies."""
    c, w, f = shard_host(cube, weights, freqs_mhz, layout, dtype)
    return torch.from_numpy(c).to(device), torch.from_numpy(w).to(device), f


def clean_cube_sharded(cube, weights, freqs_mhz, dm, centre_freq_mhz,
                       period_s, config: CleanConfig, mesh: CellMesh, *,
                       apply_bad_parts: bool = True,
                       dedispersed: bool = False
                       ) -> Optional[CleanResult]:
    """Clean one total-intensity (nsub, nchan, nbin) host cube over the
    ranks of ``mesh``.  ``config.device`` names the device type; the
    rank's device is ``mesh.device``.  Returns the result on rank 0 and
    None on the other ranks.  ``apply_bad_parts=False`` skips the
    whole-line sweep (the online stream's tiles: the sweep belongs to
    the reassembled archive, whose zero-weight padding would dominate a
    tile's fractions)."""
    check_mesh("cell", config)
    if clean_device(config).type != mesh.device.type:
        raise ValueError(f"config.device {config.device!r} and the rank's "
                         f"device {mesh.device} differ in type")
    nsub, nchan = int(cube.shape[0]), int(cube.shape[1])
    layout = shard_layout(mesh, nsub, nchan)
    compute_dtype = config_compute_dtype(config, "mesh", mesh.device)
    real = engine_dtype(config)
    block, w_host, freqs = shard_host(
        cube, weights, freqs_mhz, layout,
        np.float64 if real == torch.float64 else np.float32)
    w_t = torch.from_numpy(w_host).to(mesh.device)
    # each upload of the block is consumed by the preamble
    prep = prepare_stored(
        lambda sl: torch.from_numpy(block[sl]).to(mesh.device), block.shape,
        w_t, *upload_meta(freqs, dm, centre_freq_mhz, period_s, mesh.device,
                          real),
        config, dedispersed=dedispersed, compute_dtype=compute_dtype,
        mesh=mesh)
    del block
    outs = clean_loop(
        prep, w_t, max_iter=config.max_iter, chanthresh=config.chanthresh,
        subintthresh=config.subintthresh, rotation=config.rotation,
        baseline_duty=config.baseline_duty, mesh=mesh)
    parts = mesh.fetch(torch.stack([outs.final_weights, outs.scores]))
    if parts is None:
        return None
    a, b = mesh.shape
    s_loc, c_loc = layout.s1 - layout.s0, layout.c1 - layout.c0
    full = np.empty((2, a * s_loc, b * c_loc), dtype=parts[0].numpy().dtype)
    for r, part in enumerate(parts):
        i, j = divmod(r, b)
        full[:, i * s_loc:(i + 1) * s_loc, j * c_loc:(j + 1) * c_loc] = \
            part.numpy()
    loops = outs.loops
    fr = outs.loop_rfi_frac[:loops].cpu().numpy()
    im = outs.iter_metrics[:loops].cpu().numpy()
    if layout.pad_cells:
        # the pad cells are zero-weight, so zap_count counts them; the
        # reference's correction (iterative_cleaner_tpu/parallel/sharding.py)
        im = im.copy()
        im[:, 0] -= layout.pad_cells
        fr = (im[:, 0] / float(nsub * nchan)).astype(fr.dtype)
    result = CleanResult(
        final_weights=full[0, :nsub, :nchan].copy(),
        scores=full[1, :nsub, :nchan].copy(),
        loops=loops,
        converged=outs.converged,
        loop_diffs=outs.loop_diffs[:loops].cpu().numpy(),
        loop_rfi_frac=fr,
        iter_metrics=im,
    )
    return base.apply_bad_parts(result, config) if apply_bad_parts \
        else result


def clean_archive_sharded(archive, config: CleanConfig,
                          mesh: Optional[CellMesh] = None
                          ) -> Optional[CleanResult]:
    """Clean one (large) archive over the ranks of ``mesh`` (default:
    :func:`~iterative_cleaner_torch.parallel.mesh.cell_mesh` of the
    initialised process group).  Every rank calls it; rank 0 gets the
    result, the others None."""
    if mesh is None:
        mesh = cell_mesh()
    return clean_cube_sharded(
        archive.total_intensity(), archive.weights, archive.freqs_mhz,
        archive.dm, archive.centre_freq_mhz, archive.period_s, config, mesh,
        dedispersed=archive.dedispersed)
