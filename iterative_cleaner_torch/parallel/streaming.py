"""Subint-chunked cleaning: the online mode, and ``clean_streaming``.

``mode="exact"`` (the default) is :func:`~iterative_cleaner_torch.
parallel.streaming_exact.clean_streaming_exact`: whole-archive masks at
two passes over the tiles per iteration.  ``mode="online"`` cleans each
fixed-size tile on its own as it fills (:class:`StreamingCleaner`), in
one device footprint of a tile, through the ``clean_cube`` of
``config.backend`` (:func:`~iterative_cleaner_torch.backends.
get_backend`: the torch engine, or the numpy oracle on the host).  A
final partial tile is padded with zero-weight subints.

An online tile differs from the whole clean in one way: the scalers'
median populations are the tile's subints, not the archive's.  Zero
weight keeps the padding out of the masked statistics but not out of the
plain (unmasked) rFFT scaler, where padding rows behave like prezapped
subints.  The reference measured about 0.01-0.02% of cells changing at
1024 subints in 256-subint tiles and holds the mode to under 0.1%
(``iterative_cleaner_tpu/parallel/streaming.py``).  The reassembled
result's ``loops``/``converged`` are the tiles' max/all.

With a cell ``mesh`` both modes shard each tile's work over the ranks
(the reference's streamed shard route): exact as the module above
describes, online each tile through :func:`~iterative_cleaner_torch.
parallel.sharding.clean_cube_sharded` without its bad-parts sweep.
Each mesh axis must divide the tile grid; ``unload_res`` and
``record_history`` are refused, when the session is made.  Every rank
calls; rank 0 gets the results, the other ranks None.  The live
session over a directory of subint files is ROADMAP.md item 5.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional

import numpy as np

from iterative_cleaner_torch.backends.base import CleanResult, apply_bad_parts
from iterative_cleaner_torch.config import CleanConfig, check_mesh


@dataclasses.dataclass
class StreamTileResult:
    """Cleaning result for one subint tile."""

    start_subint: int
    n_valid: int              # valid (non-padding) subints in this tile
    result: Optional[CleanResult]   # None on a mesh's ranks other than 0

    @property
    def weights(self) -> np.ndarray:
        return self.result.final_weights[: self.n_valid]


class StreamingCleaner:
    """Accumulates subints and cleans in fixed-size tiles.

    >>> sc = StreamingCleaner(chunk_nsub=256, config=cfg, freqs_mhz=f,
    ...                       dm=d, centre_freq_mhz=cf, period_s=p)
    >>> for block in observation:           # (k, nchan, nbin) pieces
    ...     for tile in sc.push(block):
    ...         use(tile.weights)
    >>> for tile in sc.finish():            # flush the padded final tile
    ...     use(tile.weights)
    """

    def __init__(self, chunk_nsub: int, config: CleanConfig, freqs_mhz,
                 dm: float, centre_freq_mhz: float, period_s: float,
                 mesh=None, dedispersed: bool = False):
        if int(chunk_nsub) <= 0:
            raise ValueError(f"chunk_nsub must be positive, got {chunk_nsub}")
        if mesh is not None:
            # refuse at construction, not when the first tile fills
            from iterative_cleaner_torch.parallel.sharding import (
                check_tile_grid,
            )

            check_mesh("cell", config)
            check_tile_grid(mesh, int(chunk_nsub), len(freqs_mhz))
        self.mesh = mesh
        self.chunk_nsub = int(chunk_nsub)
        self.config = config
        self.freqs_mhz = np.asarray(freqs_mhz)
        self.dm = float(dm)
        self.centre_freq_mhz = float(centre_freq_mhz)
        self.period_s = float(period_s)
        self.dedispersed = bool(dedispersed)
        self._buf: List[np.ndarray] = []       # pending (k, nchan, nbin)
        self._wbuf: List[np.ndarray] = []      # pending (k, nchan)
        self._pending = 0
        self._emitted = 0

    def push(self, data: np.ndarray,
             weights: Optional[np.ndarray] = None
             ) -> Iterator[StreamTileResult]:
        """Feed (k, nchan, nbin) subints; yields results for each tile that
        fills."""
        data = np.asarray(data)
        if data.ndim != 3:
            raise ValueError("push expects (k, nchan, nbin) subint blocks")
        if weights is None:
            weights = np.ones(data.shape[:2], dtype=data.dtype)
        self._buf.append(data)
        self._wbuf.append(np.asarray(weights))
        self._pending += data.shape[0]
        while self._pending >= self.chunk_nsub:
            yield self._clean_tile(self._take(self.chunk_nsub))

    def finish(self) -> Iterator[StreamTileResult]:
        """Flush the remaining subints as a zero-weight-padded tile."""
        if self._pending:
            yield self._clean_tile(self._take(self._pending))

    # -- internals -----------------------------------------------------------
    def _take(self, k: int):
        # one pending block is sliced, not copied: a whole archive pushed
        # at once would otherwise be copied again for every tile
        data = self._buf[0] if len(self._buf) == 1 \
            else np.concatenate(self._buf, axis=0)
        weights = self._wbuf[0] if len(self._wbuf) == 1 \
            else np.concatenate(self._wbuf, axis=0)
        out = (data[:k], weights[:k])
        rest_d, rest_w = data[k:], weights[k:]
        self._buf = [rest_d] if rest_d.size else []
        self._wbuf = [rest_w] if rest_w.size else []
        self._pending -= k
        return out

    def _clean_tile(self, taken) -> StreamTileResult:
        from iterative_cleaner_torch.backends import get_backend

        data, weights = taken
        n_valid = data.shape[0]
        if n_valid < self.chunk_nsub:  # pad the final partial tile
            pad = self.chunk_nsub - n_valid
            data = np.concatenate(
                [data, np.zeros((pad,) + data.shape[1:], data.dtype)], axis=0)
            weights = np.concatenate(
                [weights, np.zeros((pad,) + weights.shape[1:],
                                   weights.dtype)], axis=0)
        # no bad-parts sweep per tile (padding rows would dominate the
        # fractions): clean_streaming sweeps the reassembled archive once
        if self.mesh is not None:
            from iterative_cleaner_torch.parallel.sharding import (
                clean_cube_sharded,
            )

            result = clean_cube_sharded(
                data, weights, self.freqs_mhz, self.dm, self.centre_freq_mhz,
                self.period_s, self.config, self.mesh, apply_bad_parts=False,
                dedispersed=self.dedispersed)
        else:
            result = get_backend(self.config.backend).clean_cube(
                data, weights, self.freqs_mhz, self.dm, self.centre_freq_mhz,
                self.period_s, self.config, dedispersed=self.dedispersed)
        tile = StreamTileResult(start_subint=self._emitted, n_valid=n_valid,
                                result=result)
        self._emitted += n_valid
        return tile


def combine_tile_iter_metrics(tiles: List[StreamTileResult], nchan: int,
                              chunk_nsub: int) -> Optional[np.ndarray]:
    """Archive-level per-iteration telemetry from the tiles' matrices.

    Row i aggregates every tile's i-th iteration: zap counts and mask
    churn sum (the padding rows of a partial final tile are all zapped, a
    constant ``pad * nchan`` per row, subtracted out), the residual std
    averages weighted by valid subints, the template peak takes the max.
    A tile that converged earlier holds its final zap and residual values
    (churn 0) for the remaining rows."""
    mats = [t.result.iter_metrics for t in tiles]
    if not mats or any(m is None or len(m) == 0 for m in mats):
        return None
    max_loops = max(m.shape[0] for m in mats)
    cols = {0: [], 1: [], 2: [], 3: []}
    weights = []
    for t, m in zip(tiles, mats):
        tail = max_loops - m.shape[0]
        pad_cells = (chunk_nsub - t.n_valid) * nchan
        cols[0].append(np.concatenate(
            [m[:, 0], np.repeat(m[-1, 0], tail)]) - pad_cells)
        cols[1].append(np.concatenate([m[:, 1], np.zeros(tail)]))
        cols[2].append(np.concatenate([m[:, 2], np.repeat(m[-1, 2], tail)]))
        cols[3].append(np.concatenate([m[:, 3], np.repeat(m[-1, 3], tail)]))
        weights.append(t.n_valid)
    w = np.asarray(weights, dtype=np.float64)[:, None]
    out = np.empty((max_loops, 4), dtype=np.float32)
    out[:, 0] = np.sum(cols[0], axis=0)
    out[:, 1] = np.sum(cols[1], axis=0)
    out[:, 2] = np.sum(np.stack(cols[2]) * w, axis=0) / np.sum(w)
    out[:, 3] = np.max(cols[3], axis=0)
    return out


def clean_streaming(archive, chunk_nsub: int, config: CleanConfig,
                    mesh=None, mode: str = "exact",
                    registry=None) -> Optional[CleanResult]:
    """Clean a whole archive through the streaming path and reassemble a
    whole-archive :class:`CleanResult`.  ``mode="exact"`` (the default,
    as the CLI's ``--stream_mode``): whole-archive masks, the tiles held
    in host memory (``registry`` receives its transfer counters).
    ``mode="online"``: each tile cleaned on its own as it fills (with
    ``unload_res``, the tiles' residuals reassembled).  The bad-parts
    sweep runs once, over the reassembled archive.  ``mesh``: each
    tile's work sharded over a cell mesh's ranks (the module
    docstring); rank 0 gets the result, the other ranks None."""
    if mode == "exact":
        from iterative_cleaner_torch.parallel.streaming_exact import (
            clean_streaming_exact,
        )

        return clean_streaming_exact(archive, chunk_nsub, config, mesh=mesh,
                                     registry=registry)
    if mode != "online":
        raise ValueError(f"unknown streaming mode {mode!r}")
    sc = StreamingCleaner(chunk_nsub, config, archive.freqs_mhz, archive.dm,
                          archive.centre_freq_mhz, archive.period_s,
                          mesh=mesh, dedispersed=archive.dedispersed)
    tiles: List[StreamTileResult] = []
    tiles.extend(sc.push(archive.total_intensity(), archive.weights))
    tiles.extend(sc.finish())
    if mesh is not None and mesh.rank != 0:
        return None
    result = CleanResult(
        final_weights=np.concatenate([t.weights for t in tiles], axis=0),
        scores=np.concatenate([t.result.scores[: t.n_valid] for t in tiles],
                              axis=0),
        loops=max(t.result.loops for t in tiles),
        converged=all(t.result.converged for t in tiles),
        iter_metrics=combine_tile_iter_metrics(tiles, archive.nchan,
                                               sc.chunk_nsub),
        residual=np.concatenate(
            [t.result.residual[: t.n_valid] for t in tiles], axis=0)
        if config.unload_res else None,
    )
    return apply_bad_parts(result, config)
