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
  counts, int32 or int64 (float64 planes) for its keys, :func:`gather_in_rank_order` for float partials —
  gathered and added in group-rank order, so every rank adds the same
  floats in the same order and holds the same bits; no float sum crosses
  ranks through an all-reduce, whose order the backend picks —,
  :func:`gather_cells`, which tiles every rank's block of a cell plane
  into the whole plane on every rank, and :func:`host_fetch`, which
  gathers result planes to rank 0.
- gloo does not take CUDA tensors in every collective (its ``gather`` is
  CPU-only), so on gloo every CUDA operand is staged through host memory
  explicitly; the kernels still run on the card.  Each collective, its
  staging included, runs inside :data:`COLLECTIVE_LISTENER`'s context
  where one is set.
- :func:`run_local_ranks` runs a function in N spawned rank processes on
  this host and fails if any rank dies or outlives its timeout.
- The multi-host fleet's topology (:class:`HostTopology`,
  :func:`resolve_host_topology`, :func:`stable_shard`) is pure host code:
  no process group and no collective; the hosts coordinate through the
  fleet's shared journal.  ``--coordinator HOST:PORT`` adds a process
  group of the hosts (:func:`initialize`'s ``coordinator`` form:
  ``tcp://HOST:PORT``, one process a host, or under torchrun each host's
  ``LOCAL_WORLD_SIZE`` ranks) whose one collective over the hosts' first
  ranks, :func:`aggregate_metrics_across_processes`, sums the run's
  counters at export; it degrades to the local counters when the
  collective fails (a dead host), counted and logged.
- :func:`object_group` is a gloo group over every rank of an NCCL job,
  made at its first use, for the host-side collectives (the fleet's
  decisions over a ('batch',) mesh, the results of
  :func:`clean_archives_hybrid`); under gloo they run over the default
  group.
- :func:`hybrid_batch_cell_mesh` lays the ranks out as the reference's
  ('batch', 'sub', 'chan') mesh: contiguous batch slots of ranks, each a
  cell mesh; :func:`clean_archives_hybrid` cleans a batch of archives
  over it, each slot its share, each archive through the sharded clean.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import hashlib
import os
import pickle
import time
import sys
from typing import Optional

import torch
import torch.distributed as dist

from iterative_cleaner_torch.io.atomic import atomic_output

# Seconds a collective waits for the other ranks before it raises.
DEFAULT_TIMEOUT_S = 600.0
# After a rank of run_local_ranks fails, how long the others may take to
# exit before they are stopped and the failed ranks reported.
FAILURE_GRACE_S = 5.0

# A callable returning a context manager that every collective of this
# module enters, its staging through host memory included
# (``analysis.card_contracts`` counts a gloo collective's host copies apart
# from the program's own host reads); None outside a contract run.
COLLECTIVE_LISTENER = None

_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
        "max": dist.ReduceOp.MAX}

ENV_HOSTS = "ICLEAN_HOSTS"
ENV_HOST_ID = "ICLEAN_HOST_ID"
ENV_COORDINATOR = "ICLEAN_COORDINATOR"


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
    """This process's place in the process group, and the seconds its
    groups' collectives wait before they raise."""

    rank: int
    world_size: int
    device: torch.device
    backend: str
    timeout_s: float = DEFAULT_TIMEOUT_S


# The context :func:`initialize` started, mirroring torch's own
# process-wide default group; None before it (or after :func:`shutdown`).
_CONTEXT: Optional[RankContext] = None
# The job's gloo group over every rank once object_group made it (None:
# the default group, which is gloo already); _UNMADE before.
_UNMADE = object()
_OBJECT_GROUP = _UNMADE
# On the first rank of each host of a --coordinator job: (the hosts' group,
# the host count); None on every other process.
_HOSTS: Optional[tuple] = None


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


def coordinator_address(address: str) -> str:
    """The ``init_method`` of a ``--coordinator`` address: ``HOST:PORT``
    as ``tcp://HOST:PORT`` (an address with a scheme is kept)."""
    address = str(address).strip()
    if "://" in address:
        return address
    host, sep, port = address.rpartition(":")
    if not sep or not host or not port.isdigit():
        raise ValueError(f"coordinator address must be HOST:PORT, got "
                         f"{address!r}")
    return f"tcp://{address}"


def initialize(backend: Optional[str] = None,
               init_method: Optional[str] = None, *, device: str = "cuda",
               rank: Optional[int] = None,
               world_size: Optional[int] = None,
               coordinator: Optional[str] = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> RankContext:
    """Start this rank's process group and return its context.  ``rank``
    and ``world_size`` default to torchrun's ``RANK``/``WORLD_SIZE``,
    ``init_method`` to ``env://``; a process that torchrun did not start
    and that names neither is a job of one rank.  ``backend`` None is
    NCCL on a CUDA device and gloo on the CPU.

    ``coordinator`` (``HOST:PORT``; the CLI's ``--coordinator`` or
    ``ICLEAN_COORDINATOR``) is the multi-host fleet's form, the
    reference's ``jax.distributed.initialize(coordinator_address=...)``:
    the hosts joined at ``tcp://HOST:PORT``, ``world_size`` the host
    count and ``rank`` the host's index (both required), gloo unless
    ``backend`` says otherwise (its collectives are host-side).  A host
    is one process on its first card, or, under torchrun, its
    ``LOCAL_WORLD_SIZE`` ranks, local rank ``l`` of host ``h`` being
    rank ``h * LOCAL_WORLD_SIZE + l`` on card ``l``.  Every collective
    of the job's groups raises after ``timeout_s``: a dead rank or host
    never hangs the others."""
    global _CONTEXT, _OBJECT_GROUP, _HOSTS
    store, per_host, local_rank = None, 1, None
    timeout = datetime.timedelta(seconds=timeout_s)
    if coordinator:
        if rank is None or world_size is None:
            raise ValueError("a coordinator needs the host count and this "
                             "host's index (world_size and rank)")
        init_method = coordinator_address(coordinator)
        backend = backend or "gloo"
        per_host = int(os.environ.get("LOCAL_WORLD_SIZE", "") or 1)
        local_rank = int(os.environ.get("LOCAL_RANK", "") or 0)
        n_hosts = world_size
        rank, world_size = rank * per_host + local_rank, n_hosts * per_host
        if init_method.startswith("tcp://"):
            # the store is made here: under torchrun a tcp:// init_method
            # would join the launcher's own store instead of rank 0's
            host, port = init_method[len("tcp://"):].rsplit(":", 1)
            store = dist.TCPStore(host, int(port), world_size, rank == 0,
                                  timeout=timeout)
    elif init_method is None and rank is None and "RANK" not in os.environ:
        store, rank, world_size = dist.HashStore(), 0, 1
    if rank is None:
        rank = int(os.environ["RANK"])
    if world_size is None:
        world_size = int(os.environ["WORLD_SIZE"])
    if local_rank is None:
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
        store=store, rank=rank, world_size=world_size, timeout=timeout)
    _OBJECT_GROUP, _HOSTS = _UNMADE, None
    if coordinator:
        # the hosts' first ranks, over which the counters are summed; the
        # group is made on every rank, as dist.new_group requires
        firsts = list(range(0, world_size, per_host))
        group = (None if per_host == 1 and backend == "gloo"
                 else dist.new_group(firsts, backend="gloo",
                                     timeout=timeout))
        if local_rank == 0:
            _HOSTS = (group, len(firsts))
    _CONTEXT = RankContext(rank, world_size, dev, backend, float(timeout_s))
    return _CONTEXT


def context() -> Optional[RankContext]:
    """The context :func:`initialize` started, or None."""
    return _CONTEXT


def object_group():
    """The job's gloo group over every rank, for host-side collectives
    beside an NCCL job; None (the default group) when the job is gloo
    itself or one rank.  Made at its first call, which every rank must
    reach in the same order as its other group creations (``dist.
    new_group`` is collective over the job), with the job's timeout."""
    global _OBJECT_GROUP
    if _OBJECT_GROUP is _UNMADE:
        if _CONTEXT is None or not dist.is_initialized():
            raise RuntimeError("object_group needs the process group of "
                               "parallel.distributed.initialize")
        _OBJECT_GROUP = (
            None if _CONTEXT.backend == "gloo" or _CONTEXT.world_size == 1
            else dist.new_group(backend="gloo", timeout=datetime.timedelta(
                seconds=_CONTEXT.timeout_s)))
    return _OBJECT_GROUP


def shutdown() -> None:
    """Destroy the default process group started by :func:`initialize`."""
    global _CONTEXT, _OBJECT_GROUP, _HOSTS
    if dist.is_initialized():
        dist.destroy_process_group()
    _CONTEXT, _OBJECT_GROUP, _HOSTS = None, _UNMADE, None


def coordinated_processes() -> int:
    """How many hosts the ``--coordinator`` group joins, on a host's first
    rank; 1 on any other rank and when this process started none."""
    if _HOSTS is None or not dist.is_initialized():
        return 1
    return _HOSTS[1]


def aggregate_metrics_across_processes(counters: dict, registry=None,
                                       events=None) -> dict:
    """The ``{name: value}`` counters summed over the processes of the
    ``--coordinator`` group (the reference's function): each host cleans
    its own share, so the run's totals need one reduction before the
    export.  A single process returns a copy unchanged, with no
    collective.  Every process must call it with the same key set at the
    same point; the values are summed as float64 in sorted key order,
    host by host in rank order, over the gloo group of the hosts' first
    ranks.

    A finished run's telemetry never fails it: when the collective fails
    (a host died; the group's timeout turns the wait into an error), the
    local counters are returned, ``telemetry_degraded`` is counted on
    ``registry`` and a ``telemetry_degraded`` event emitted on ``events``
    (a ``RunEventLog``), and only when neither sink is given is a note
    printed on stderr."""
    if coordinated_processes() == 1:
        return dict(counters)
    names = sorted(counters)
    local = torch.tensor([float(counters[k]) for k in names],
                         dtype=torch.float64)
    group = _HOSTS[0] if _HOSTS is not None else None
    try:
        parts = _all_gather(local, group)
    except Exception as exc:  # noqa: BLE001 -- the reference's rule: a failed reduction exports the local counters, counted and logged
        detail = "%s: %s" % (type(exc).__name__, str(exc)[:200])
        if registry is not None:
            registry.counter_inc("telemetry_degraded")
        if events is not None:
            events.emit("telemetry_degraded", stage="metric_reduction",
                        error=detail, scope="local_counters_only")
        if registry is None and events is None:
            print("WARNING: cross-process metric reduction unavailable "
                  f"({type(exc).__name__}); exporting this process's "
                  "local counters", file=sys.stderr)
        return dict(counters)
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return {k: float(v) for k, v in zip(names, total.tolist())}


def _collective():
    """The context one collective runs in: :data:`COLLECTIVE_LISTENER`'s,
    else none."""
    if COLLECTIVE_LISTENER is not None:
        return COLLECTIVE_LISTENER()
    return contextlib.nullcontext()


def _staged(x, group):
    """``x`` as a contiguous tensor the group's backend takes: on gloo a
    CUDA tensor is copied to host memory (see the module docstring)."""
    if x.is_cuda and dist.get_backend(group) == "gloo":
        return x.detach().to("cpu").contiguous()
    return x.detach().contiguous().clone()


def all_reduce_int(x, op: str = "sum", group=None):
    """An int32 or int64 tensor all-reduced (``op``: sum, min or max)
    over ``group``: a new tensor on ``x``'s device, the same on every
    rank.  Integer adds and extrema are exact in any order."""
    if x.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"all_reduce_int takes int32 or int64, got "
                        f"{x.dtype}")
    with _collective():
        y = _staged(x, group)
        dist.all_reduce(y, op=_OPS[op], group=group)
        return y.to(x.device)


def _all_gather(x, group):
    """Every group member's ``x``, in group-rank order, on ``x``'s
    device."""
    with _collective():
        src = _staged(x, group).reshape(-1)
        parts = [torch.empty_like(src)
                 for _ in range(dist.get_world_size(group))]
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
    """Every group member's ``x`` gathered to the group's rank 0 as host
    tensors, in group-rank order; None on the other members."""
    lead = dist.get_rank(group) == 0
    with _collective():
        src = _staged(x, group)
        parts = [torch.empty_like(src)
                 for _ in range(dist.get_world_size(group))] if lead else None
        dst = 0 if group is None else dist.get_global_rank(group, 0)
        dist.gather(src, gather_list=parts, dst=dst, group=group)
    # the fetch to the host is the caller's own read, on any backend
    return None if parts is None else [p.cpu() for p in parts]


def _rank_main(target, args, rank, world_size, init_method, backend, device,
               out_path, threads, group_timeout_s):
    if threads:
        torch.set_num_threads(threads)
    initialize(backend, init_method, device=device, rank=rank,
               world_size=world_size, timeout_s=group_timeout_s)
    try:
        result = target(*args)
        with atomic_output(out_path) as tmp:
            with open(tmp, "wb") as f:
                pickle.dump(result, f)
    finally:
        shutdown()


def run_local_ranks(target, world_size: int, args=(), *, workdir: str,
                    device: str = "cpu", backend: Optional[str] = None,
                    timeout_s: float = DEFAULT_TIMEOUT_S,
                    threads: Optional[int] = None,
                    group_timeout_s: float = DEFAULT_TIMEOUT_S) -> list:
    """Run ``target(*args)`` in ``world_size`` spawned rank processes on
    this host, joined through a ``file://`` store in ``workdir``, and
    return each rank's result in rank order.  ``target`` must be
    importable by name from a spawned process.  A rank that exits with an
    error or is still running after ``timeout_s`` fails the call: every
    rank is then stopped and RuntimeError (or TimeoutError) raised.
    ``threads`` sets each rank's torch thread count, ``group_timeout_s``
    the seconds each collective of the job waits (:func:`initialize`)."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    store = os.path.join(workdir, "rank_store")
    outs = [os.path.join(workdir, f"rank{r}.pkl") for r in range(world_size)]
    procs = [ctx.Process(target=_rank_main, args=(
        target, args, r, world_size, f"file://{store}", backend, device,
        outs[r], threads, group_timeout_s)) for r in range(world_size)]
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


def hybrid_layout(world: int, batch: int) -> tuple:
    """The ('batch', 'sub', 'chan') shape of ``world`` ranks with a batch
    axis of ``batch``: each slot's ranks in the most-square cell grid.
    ``ValueError`` when ``batch`` does not divide ``world``."""
    from iterative_cleaner_torch.parallel.mesh import factor_2d

    if batch < 1 or world % batch:
        raise ValueError(f"{world} ranks do not divide into a batch axis "
                         f"of {batch}")
    return (batch, *factor_2d(world // batch))


@dataclasses.dataclass(frozen=True, eq=False)
class HybridMesh:
    """This rank's place in a ('batch', 'sub', 'chan') rank layout: batch
    slot ``slot`` of ``batch``, whose ranks form the cell mesh
    ``cells``."""

    batch: int
    slot: int
    cells: object       # parallel.mesh.CellMesh of the slot's ranks

    @property
    def shape(self) -> tuple:
        return (self.batch, *self.cells.shape)

    @property
    def device(self) -> torch.device:
        return self.cells.device


def hybrid_batch_cell_mesh(batch: Optional[int] = None) -> HybridMesh:
    """The reference's ``hybrid_batch_cell_mesh`` over the ranks of the
    process group :func:`initialize` started: archives split over a
    'batch' axis of ``batch`` slots (default the number of hosts: the
    ranks over torchrun's ``LOCAL_WORLD_SIZE``, one a rank without it),
    each slot's cell grid over its ranks.  Slot ``k`` holds the
    contiguous ranks ``[k * per, (k + 1) * per)``, ``per = world //
    batch``, as a :func:`~iterative_cleaner_torch.parallel.mesh.cell_mesh`;
    every slot's groups are made on every rank, in slot order.  A world
    that ``batch`` does not divide raises ``ValueError``."""
    from iterative_cleaner_torch.parallel.mesh import cell_mesh

    if _CONTEXT is None or not dist.is_initialized():
        raise RuntimeError("hybrid_batch_cell_mesh needs the process group "
                           "of parallel.distributed.initialize")
    world, rank = dist.get_world_size(), dist.get_rank()
    if batch is None:
        local = int(os.environ.get("LOCAL_WORLD_SIZE", "") or 1)
        batch = max(1, world // local)
    hybrid_layout(world, batch)
    per = world // batch
    # every slot's groups on every rank (dist.new_group is collective over
    # the whole job); cell_mesh gives None for a slot this rank is not in.
    # The results travel over the object group: made here too
    meshes = [cell_mesh(range(k * per, (k + 1) * per)) for k in range(batch)]
    object_group()
    return HybridMesh(batch, rank // per, meshes[rank // per])


def clean_archives_hybrid(archives, config, mesh: HybridMesh):
    """Clean equal-shaped archives over a :class:`HybridMesh` (the
    reference's ``clean_archives_hybrid``): the batch is padded with
    zero-weight archives to a multiple of the batch axis, each slot
    takes its contiguous share of the padded batch and cleans its
    archives one after another through the sharded clean over its cell
    mesh (K1, K10, the tree-reduced selects and the combine on each
    rank's block), and global rank 0 gathers the results in archive
    order over the job's gloo group (:func:`object_group`).  A pad slot
    holds nothing to clean (a zero-weight archive's result is dropped),
    so it is not run.  Every rank passes the same archives; rank 0 gets
    the list of :class:`CleanResult`, the other ranks None."""
    from iterative_cleaner_torch.parallel.batch import check_equal_shapes
    from iterative_cleaner_torch.parallel.sharding import (
        clean_archive_sharded,
    )

    archives = list(archives)
    if archives:
        check_equal_shapes(archives)
    n = len(archives)
    per = (n + (-n) % mesh.batch) // mesh.batch
    share = archives[mesh.slot * per:(mesh.slot + 1) * per]
    mine = [clean_archive_sharded(ar, config, mesh.cells) for ar in share]
    lead = mesh.cells.rank == 0
    parts = [None] * dist.get_world_size() if dist.get_rank() == 0 else None
    dist.gather_object(mine if lead else None, parts, dst=0,
                       group=object_group())
    if parts is None:
        return None
    results = [r for part in parts if part is not None for r in part]
    if len(results) != n:
        raise RuntimeError(f"{len(results)} hybrid results gathered for "
                           f"{n} archives")
    return results
