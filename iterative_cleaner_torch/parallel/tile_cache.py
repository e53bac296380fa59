"""Device tile residency of exact streaming, and its uploads.

Exact streaming (:mod:`iterative_cleaner_torch.parallel.streaming_exact`)
re-reads its prepared tiles twice per iteration.  :class:`TileCache`
keeps as many of them on the device as a byte budget allows; the rest
stream from host memory on every pass.

- **Budget** (:func:`resolve_budget_bytes`): ``CleanConfig.stream_hbm_mb``
  (``--stream_hbm_mb``), else a fraction of the card's memory; 512 MiB
  for a clean on the CPU.  ``0`` pins nothing: the regime of an archive
  larger than the card.
- **Hits are live device tensors**: no copy, no transfer, so the masks
  cannot depend on the budget.
- **Planned admission**: the engine knows every constant tile and its size
  up front and calls :meth:`TileCache.plan` once; only planned keys are
  pinned, so nothing is ever evicted, and the rest stream as transient
  uploads.
- **Measured transfers**: every upload is counted (bytes and calls, cube
  tiles apart) in the ``registry`` (anything with ``counter_inc(name,
  value=1)`` and ``gauge_set(name, value)``; a :class:`DictRegistry` of
  its own when none is given): ``stream_h2d_bytes`` and the rest.

The cache is policy only: the transfer is an injected ``upload``
(:class:`CopyStream` on the card), so the policy is tested without a
device.  :class:`CopyStream` is the Hopper part: pinned host memory
copied on a dedicated stream, which the compute stream waits for by an
event per upload.

The reference's counterpart is ``iterative_cleaner_tpu/parallel/
tile_cache.py``; its ``mark_sync`` marked a host fetch, here it waits
for the drained tile's CUDA event.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Tuple

import torch

# Fraction of the card's memory the default budget claims: under half,
# since the per-tile work, the full planes and the allocator's slack need
# the rest.
DEFAULT_BUDGET_FRACTION = 0.4

# Budget of a clean on the CPU, whose "device" memory is host memory.
FALLBACK_BUDGET_BYTES = 512 * 2 ** 20


class DictRegistry:
    """The smallest ``registry``: counters and gauges in two dicts."""

    def __init__(self):
        self.counters, self.gauges = {}, {}

    def counter_inc(self, name, value=1):
        # icln: ignore[thread-shared-state] -- one TileCache's own registry, written by the one thread that streams its tiles; the http label is the daemon's MetricsRegistry.counter_inc, a method of the same name
        self.counters[name] = self.counters.get(name, 0) + value

    def gauge_set(self, name, value):
        self.gauges[name] = value


def resolve_budget_bytes(config_mb: Optional[float] = None,
                         device="cpu") -> int:
    """Byte budget of the tile cache: ``config_mb``
    (``CleanConfig.stream_hbm_mb``), else :data:`DEFAULT_BUDGET_FRACTION`
    of a CUDA ``device``'s total memory (``torch.cuda.mem_get_info``),
    else :data:`FALLBACK_BUDGET_BYTES` for the CPU.  ``0`` pins
    nothing."""
    if config_mb is not None:
        if config_mb < 0:
            raise ValueError(
                f"stream HBM budget must be >= 0 MiB, got {config_mb}")
        return int(float(config_mb) * 2 ** 20)
    device = torch.device(device)
    if device.type == "cuda":
        _free, total = torch.cuda.mem_get_info(device)
        return int(total * DEFAULT_BUDGET_FRACTION)
    if device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return FALLBACK_BUDGET_BYTES


class CopyStream:
    """Uploads of pinned host tensors on a dedicated CUDA stream.

    Each upload allocates its device tensor on the copy stream, copies
    with ``non_blocking=True``, records an event the caller's (compute)
    stream waits on, and ``record_stream``s the tensor onto the compute
    stream, so the caching allocator hands its block to no later upload
    before the compute stream is done reading it.  Each upload's copy
    time is kept (CUDA events on the copy stream) for :meth:`transfer`."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.stream = torch.cuda.Stream(device=self.device)
        self._timed = []          # (start, done, nbytes) per upload

    def __call__(self, host: torch.Tensor) -> torch.Tensor:
        compute = torch.cuda.current_stream(self.device)
        start = torch.cuda.Event(enable_timing=True)
        done = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(self.stream):
            dev = torch.empty(host.shape, dtype=host.dtype,
                              device=self.device)
            start.record(self.stream)
            dev.copy_(host, non_blocking=True)
            done.record(self.stream)
        compute.wait_event(done)
        dev.record_stream(compute)
        self._timed.append((start, done, host.nbytes))
        return dev

    def transfer(self) -> Tuple[int, float]:
        """``(bytes, ms)`` of every upload so far: the bytes copied and
        the copy stream's event time of the copies (synchronises the copy
        stream)."""
        self.stream.synchronize()
        return (sum(n for _s, _d, n in self._timed),
                sum(s.elapsed_time(d) for s, d, _n in self._timed))


def host_copy(host: torch.Tensor) -> torch.Tensor:
    """The CPU clean's "upload": a copy, so work on the device tensor
    (the preamble subtracts in place) never touches the host store."""
    return host.clone()


class TileCache:
    """Planned device residency for host-backed streaming tiles.

    ``upload(host_tensor) -> device_tensor`` is the transfer
    (:class:`CopyStream` on the card, :func:`host_copy` on the CPU, a
    fake in the tests).  ``registry`` receives every count under
    ``stream_*`` names.
    """

    def __init__(self, budget_bytes: int, upload: Callable,
                 registry=None) -> None:
        if budget_bytes < 0:
            raise ValueError(f"budget must be >= 0, got {budget_bytes}")
        self.budget = int(budget_bytes)
        self.registry = DictRegistry() if registry is None else registry
        self._upload = upload
        self._entries: Dict[Tuple, object] = {}   # pinned key -> handle
        self._plan: Dict[Tuple, int] = {}          # admissible key -> bytes
        self._resident = 0        # bytes pinned in _entries
        self._transient = 0       # unpinned uploads not yet synced
        self._peak = 0
        self.registry.gauge_set("stream_cache_budget_bytes", self.budget)

    def plan(self, sizes: Iterable[Tuple[Tuple, int]]) -> bool:
        """Reserve the budget for a known set of constant tiles.

        ``sizes`` is ``[(key, nbytes), ...]`` in priority order; keys are
        admitted first-fit while the budget holds them.  Keys left out are
        never pinned.  Returns True when EVERY key fits: iterations >= 2
        then upload no constant tile, and the sweep may dispatch a whole
        pass before draining."""
        self._plan, reserved, all_fit = {}, 0, True
        for key, nbytes in sizes:
            if nbytes <= self.budget - reserved:
                self._plan[key] = int(nbytes)
                reserved += int(nbytes)
            else:
                all_fit = False
        return all_fit

    def get(self, key: Optional[Tuple], host, cube: bool = False):
        """Device tensor of the host tensor ``host``, keyed by ``key``.

        A hit returns the pinned live tensor (no transfer).  A miss
        uploads, counts the bytes, and pins the entry when the plan
        admitted the key.  ``key=None`` is an always-transient upload.
        ``cube=True`` counts the bytes as cube-sized too."""
        if key is not None:
            handle = self._entries.get(key)
            if handle is not None:
                self.registry.counter_inc("stream_cache_hits")
                self.registry.counter_inc("stream_cache_hit_bytes",
                                          self._plan[key])
                return handle
            self.registry.counter_inc("stream_cache_misses")
        handle = self._upload(host)
        nbytes = int(host.nbytes)
        self.count_h2d(nbytes, cube)
        if not self._pin(key, handle, nbytes):
            self._transient += nbytes
        self._note_peak()
        return handle

    def holds(self, key: Tuple) -> bool:
        """True when ``key`` is pinned."""
        return key in self._entries

    def adopt(self, key: Tuple, handle, nbytes: int) -> bool:
        """Pin a tensor that is already on the device (a preamble's
        output): no H2D.  Returns True when pinned; False when the plan
        did not admit the key (the caller lets the tensor go)."""
        if not self._pin(key, handle, int(nbytes)):
            return False
        self.registry.counter_inc("stream_cache_adopted_bytes", int(nbytes))
        self._note_peak()
        return True

    def mark_sync(self, event=None) -> None:
        """A sync point: wait for ``event`` (a CUDA event recorded after
        the drained tile's work; None on the CPU), after which everything
        dispatched before it has completed and the transient uploads are
        reclaimable."""
        if event is not None:
            event.synchronize()
        self._transient = 0

    def count_h2d(self, nbytes: int, cube: bool = False) -> None:
        """Record host-to-device bytes (every :meth:`get` miss, and the
        engine's own uploads of small planes)."""
        self.registry.counter_inc("stream_h2d_bytes", int(nbytes))
        self.registry.counter_inc("stream_h2d_uploads")
        if cube:
            self.registry.counter_inc("stream_h2d_cube_bytes", int(nbytes))

    def count_d2h(self, nbytes: int) -> None:
        """Record device-to-host bytes."""
        self.registry.counter_inc("stream_d2h_bytes", int(nbytes))

    def flush_stats(self) -> None:
        """The residency gauges into the registry, once per clean."""
        self.registry.gauge_set("stream_cache_resident_bytes", self._resident)
        self.registry.gauge_set("stream_cache_peak_bytes", self._peak)
        self.registry.gauge_set("stream_cache_resident_tiles",
                                len(self._entries))

    def _pin(self, key: Optional[Tuple], handle, nbytes: int) -> bool:
        if key not in self._plan or key in self._entries:
            return False
        self._entries[key] = handle
        self._resident += nbytes
        return True

    def _note_peak(self) -> None:
        self._peak = max(self._peak, self._resident + self._transient)


def pipelined_sweep(n_tiles: int, put, run, drain, depth: int = 1) -> None:
    """The exact-streaming tile scheduler.

    ``put(i)`` stages tile *i*'s device inputs (uploads on the copy
    stream or cache hits, so an upload overlaps the previous tile's
    compute), ``run(i, inputs)`` enqueues the tile's kernels, ``drain(i,
    out)`` takes its result in (and waits for the tile's event).  At
    ``depth=1`` each tile is drained before the tile after next runs,
    which bounds the device residency to a few tiles.  When every input
    is resident the caller raises ``depth`` to ``n_tiles``: nothing is
    uploaded, so the whole pass is enqueued before the first drain.
    Results drain in tile order at every depth, so the caller's
    accumulation order, and the masks, do not depend on the depth."""
    depth = max(1, int(depth))
    pending = []  # (index, out) in dispatch order
    if n_tiles <= 0:
        return

    nxt = put(0)
    for i in range(n_tiles):
        out = run(i, nxt)
        if i + 1 < n_tiles:
            nxt = put(i + 1)
        pending.append((i, out))
        while len(pending) > depth:
            drain(*pending.pop(0))
    while pending:
        drain(*pending.pop(0))
