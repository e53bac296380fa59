"""``torch.distributed`` for the cell-sharded clean: start-up, the
collectives the shards exchange, and rank processes on one host.

- :func:`initialize` starts the process group of one rank: from
  torchrun's ``RANK``/``WORLD_SIZE``/``LOCAL_RANK`` (``init_method``
  ``env://``), or from explicit arguments and an ``init_method`` (a
  ``file://`` store, a ``tcp://localhost:<port>`` address).  NCCL when
  every rank has its own card, gloo on the CPU; a caller that puts
  several ranks on one card passes ``backend="gloo"`` itself (NCCL
  refuses two ranks on one GPU).  Nothing switches the backend silently.
  A timeout makes a collective that waits for a dead rank raise instead
  of hanging.
- The collectives (the reference's ``jax.lax.psum``/``pmin``/``pmax``
  and ``host_fetch``, ``iterative_cleaner_tpu/parallel/distributed.py``
  and ``parallel/shard_stats.py``): int32 all-reduces for the select's
  counts and keys, :func:`gather_in_rank_order` for float partials —
  gathered and added in group-rank order, so every rank adds the same
  floats in the same order and holds the same bits; no float sum crosses
  ranks through an all-reduce, whose order the backend picks —,
  :func:`gather_cells`, which tiles every rank's block of a cell plane
  into the whole plane on every rank, and :func:`host_fetch`, which
  gathers result planes to rank 0.
- gloo does not take CUDA tensors in every collective (its ``gather`` is
  CPU-only), so on gloo every CUDA operand is staged through host memory
  explicitly; the kernels still run on the card.
- :func:`run_local_ranks` runs a function in N spawned rank processes on
  this host and fails if any rank dies or outlives its timeout.
- The multi-host fleet's topology (:class:`HostTopology`,
  :func:`resolve_host_topology`, :func:`stable_shard`) is pure host code:
  no process group and no collective; the hosts coordinate through the
  fleet's shared journal alone.
"""

from __future__ import annotations

import dataclasses
import datetime
import hashlib
import os
import pickle
import time
from typing import Optional

import torch
import torch.distributed as dist

# Seconds a collective waits for the other ranks before it raises.
DEFAULT_TIMEOUT_S = 600.0
# After a rank of run_local_ranks fails, how long the others may take to
# exit before they are stopped and the failed ranks reported.
FAILURE_GRACE_S = 5.0

_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
        "max": dist.ReduceOp.MAX}

ENV_HOSTS = "ICLEAN_HOSTS"
ENV_HOST_ID = "ICLEAN_HOST_ID"


@dataclasses.dataclass(frozen=True)
class HostTopology:
    """This process's slot in a multi-host fleet: which host it is and
    how many hosts share the work.  Purely logical — N cooperating
    processes over one shared journal, on one machine or many."""

    host_id: int = 0
    n_hosts: int = 1

    def __post_init__(self) -> None:
        if self.n_hosts < 1:
            raise ValueError(f"n_hosts must be >= 1, got {self.n_hosts}")
        if not 0 <= self.host_id < self.n_hosts:
            raise ValueError(
                f"host_id must be in [0, {self.n_hosts}), got "
                f"{self.host_id}")

    @property
    def is_multi(self) -> bool:
        return self.n_hosts > 1


def resolve_host_topology(hosts: Optional[int] = None,
                          host_id: Optional[int] = None) -> HostTopology:
    """The fleet's host topology: explicit values, else the
    ``ICLEAN_HOSTS``/``ICLEAN_HOST_ID`` environment variables, else one
    host.  A half-specified topology is an error, not a guess."""
    if hosts is None:
        env = os.environ.get(ENV_HOSTS, "")
        hosts = int(env) if env else None
    if host_id is None:
        env = os.environ.get(ENV_HOST_ID, "")
        host_id = int(env) if env else None
    if hosts is None and host_id is None:
        return HostTopology()
    if hosts is None or (host_id is None and hosts > 1):
        raise ValueError(
            "half-specified host topology: pass both hosts and host_id "
            "(or both ICLEAN_HOSTS and ICLEAN_HOST_ID) — guessing the "
            "missing half would serve the wrong bucket set")
    return HostTopology(host_id=int(host_id or 0), n_hosts=int(hosts))


def stable_shard(key: str, n_shards: int) -> int:
    """Deterministic, process-independent shard of ``key``: a blake2b of
    the key string modulo ``n_shards`` (Python's ``hash`` is salted per
    process, so two hosts would disagree).  The reference's function:
    both packages route journal segments and fleet buckets alike."""
    n = max(1, int(n_shards))
    digest = hashlib.blake2b(str(key).encode(), digest_size=8).digest()
    return int.from_bytes(digest, "big") % n


def shard_owner(key: str, members) -> Optional[str]:
    """Deterministic key -> member affinity over a changing member set
    (the serve pool's counterpart of ``bucket_host`` over a fixed host
    count): every process sorting the same live member ids picks the same
    owner, so pool members adopting journaled work agree on who goes
    first without talking; the others still take the work once the owner
    is gone.  None for an empty set."""
    members = sorted(str(m) for m in members)
    if not members:
        return None
    return members[stable_shard(key, len(members))]


@dataclasses.dataclass(frozen=True)
class RankContext:
    """This process's place in the process group."""

    rank: int
    world_size: int
    device: torch.device
    backend: str


# The context :func:`initialize` started, mirroring torch's own
# process-wide default group; None before it (or after :func:`shutdown`).
_CONTEXT: Optional[RankContext] = None


def rank_device(device: str, local_rank: int) -> torch.device:
    """The device of a rank: ``device`` as named, ``cuda`` without an
    index meaning ``cuda:<local_rank>``.  A CUDA device without a card
    raises."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but no CUDA device is present; "
                f"pass device='cpu' to run the plain PyTorch versions")
        if dev.index is None:
            dev = torch.device("cuda", local_rank)
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev


def initialize(backend: Optional[str] = None,
               init_method: Optional[str] = None, *, device: str = "cuda",
               rank: Optional[int] = None,
               world_size: Optional[int] = None) -> RankContext:
    """Start this rank's process group and return its context.  ``rank``
    and ``world_size`` default to torchrun's ``RANK``/``WORLD_SIZE``,
    ``init_method`` to ``env://``; a process that torchrun did not start
    and that names neither is a job of one rank.  ``backend`` None is
    NCCL on a CUDA device and gloo on the CPU."""
    global _CONTEXT
    store = None
    if init_method is None and rank is None and "RANK" not in os.environ:
        store, rank, world_size = dist.HashStore(), 0, 1
    if rank is None:
        rank = int(os.environ["RANK"])
    if world_size is None:
        world_size = int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    dev = rank_device(device, local_rank)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unsupported backend {backend!r}")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the NCCL backend needs a CUDA device per rank")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=None if store else init_method or "env://",
        store=store, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=DEFAULT_TIMEOUT_S))
    _CONTEXT = RankContext(rank, world_size, dev, backend)
    return _CONTEXT


def context() -> Optional[RankContext]:
    """The context :func:`initialize` started, or None."""
    return _CONTEXT


def shutdown() -> None:
    """Destroy the default process group started by :func:`initialize`."""
    global _CONTEXT
    if dist.is_initialized():
        dist.destroy_process_group()
    _CONTEXT = None


def _staged(x, group):
    """``x`` as a contiguous tensor the group's backend takes: on gloo a
    CUDA tensor is copied to host memory (see the module docstring)."""
    if x.is_cuda and dist.get_backend(group) == "gloo":
        return x.detach().to("cpu").contiguous()
    return x.detach().contiguous().clone()


def all_reduce_int(x, op: str = "sum", group=None):
    """An int32 tensor all-reduced (``op``: sum, min or max) over
    ``group``: a new tensor on ``x``'s device, the same on every rank.
    Integer adds and extrema are exact in any order."""
    if x.dtype != torch.int32:
        raise TypeError(f"all_reduce_int takes int32, got {x.dtype}")
    y = _staged(x, group)
    dist.all_reduce(y, op=_OPS[op], group=group)
    return y.to(x.device)


def _all_gather(x, group):
    """Every group member's ``x``, in group-rank order, on ``x``'s
    device."""
    src = _staged(x, group).reshape(-1)
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return [p.reshape(x.shape).to(x.device) for p in parts]


def gather_cells(x, grid, group=None):
    """The (..., s, c) blocks ``x`` of the ranks of an (a, b) rank grid
    (rank ``i * b + j`` holding block (i, j)) tiled into the whole
    (..., a * s, b * c) plane on every rank: the 'sub' blocks down the
    rows, the 'chan' blocks across the columns, in rank order (the
    reference's two tiled ``all_gather``s).  One all-gather over
    ``group``, which must hold exactly the grid's ranks."""
    a, b = grid
    parts = _all_gather(x, group)
    if len(parts) != a * b:
        raise ValueError(f"{len(parts)} ranks gathered for an {a} x {b} "
                         f"grid")
    rows = [torch.cat(parts[i * b:(i + 1) * b], dim=-1) for i in range(a)]
    return torch.cat(rows, dim=-2)


def gather_in_rank_order(x, group=None):
    """The sum of the group members' float ``x``, added in group-rank
    order on every rank, so that every rank holds the same bits (a group
    of one returns ``x``'s value unchanged)."""
    parts = _all_gather(x, group)
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def host_fetch(x, group=None):
    """Every rank's ``x`` gathered to rank 0 as host tensors, in rank
    order; None on the other ranks."""
    src = _staged(x, group)
    rank = dist.get_rank()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))] \
        if rank == 0 else None
    dist.gather(src, gather_list=parts, dst=0, group=group)
    return None if parts is None else [p.cpu() for p in parts]


def _rank_main(target, args, rank, world_size, init_method, backend, device,
               out_path, threads):
    if threads:
        torch.set_num_threads(threads)
    initialize(backend, init_method, device=device, rank=rank,
               world_size=world_size)
    try:
        result = target(*args)
        with open(out_path, "wb") as f:
            pickle.dump(result, f)
    finally:
        shutdown()


def run_local_ranks(target, world_size: int, args=(), *, workdir: str,
                    device: str = "cpu", backend: Optional[str] = None,
                    timeout_s: float = DEFAULT_TIMEOUT_S,
                    threads: Optional[int] = None) -> list:
    """Run ``target(*args)`` in ``world_size`` spawned rank processes on
    this host, joined through a ``file://`` store in ``workdir``, and
    return each rank's result in rank order.  ``target`` must be
    importable by name from a spawned process.  A rank that exits with an
    error or is still running after ``timeout_s`` fails the call: every
    rank is then stopped and RuntimeError (or TimeoutError) raised.
    ``threads`` sets each rank's torch thread count."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    store = os.path.join(workdir, "rank_store")
    outs = [os.path.join(workdir, f"rank{r}.pkl") for r in range(world_size)]
    procs = [ctx.Process(target=_rank_main, args=(
        target, args, r, world_size, f"file://{store}", backend, device,
        outs[r], threads)) for r in range(world_size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    try:
        while True:
            codes = [p.exitcode for p in procs]
            failed = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
            if failed:
                # a rank's death fails the peers waiting on it, and a peer
                # can exit first: wait a moment for the others, so the
                # report names every rank that failed
                grace = time.monotonic() + FAILURE_GRACE_S
                while any(p.exitcode is None for p in procs) \
                        and time.monotonic() < grace:
                    time.sleep(0.05)
                failed = [(r, p.exitcode) for r, p in enumerate(procs)
                          if p.exitcode not in (None, 0)]
                raise RuntimeError(f"rank processes failed (rank, exit "
                                   f"code): {failed}")
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                raise TimeoutError(f"rank processes still running after "
                                   f"{timeout_s} s: ranks "
                                   f"{[r for r, c in enumerate(codes) if c is None]}")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=30)
    results = []
    for path in outs:
        with open(path, "rb") as f:
            results.append(pickle.load(f))
    return results
