"""Card contracts: what the port's hot programs are, held on the device
that runs them.

The parity suites prove the programs compute the right masks; these
checks pin what the programs *do* on the way, so a later rewrite of a
kernel wrapper or of the loop inherits an executable spec.  Each
registered program (:data:`HOT_PROGRAMS`) is built on an explicit device
at a small geometry (:func:`geometry`), runs once to warm up (the kernel
library's build, the launch plans), then one steady call runs under a
``TorchDispatchMode`` that records every aten op: its name, its stage
(``utils/tracing.stage``), its output dtypes, the bytes of any storage it
allocates and whether an input is the resident cube.  On the card the
same call runs under ``torch.cuda.set_sync_debug_mode("warn")`` with the
warnings counted, and the kernel wrappers' launch counters
(``stats.kernels.launch_counts``) are read around it: the kernels launch
through ctypes, so the dispatch mode sees their output allocations but
not the launches.

The contracts, and the devices that decide them (:data:`DECIDES`):

* **no-host-sync** (both): the host reads of one iteration (or step) are
  at most the program's pin — the loop's ``bool(repeat)`` in
  ``clean_loop``, none inside a step or a sweep.  Counted as
  :data:`HOST_READ_OPS` and copies between the card and the host that
  block; on the card the sync debug mode's warnings must give the same
  count.
* **no-f64** (both): on a float32 or bf16 route no op produces a float64
  or complex128 tensor.
* **dispatch-bound** (card): the aten ops plus kernel launches of one
  iteration stay under the program's pinned ceiling, pinned at the count
  the card gives, so that one added op or launch per iteration shows.
* **single-cube-read** (card): in one iteration the resident cube is read
  only by the route's cube kernels, each counter advancing by exactly one
  (every other kernel of the program by its pinned count, no other cube
  kernel at all), and no aten op takes the cube's storage as an input.
* **no-cube-copy** (card): no op of the iteration allocates a tensor of
  the cube's bytes or more, and ``torch.cuda.max_memory_allocated`` over
  the call, less its start, stays under one cube.

An online step has no resident cube: its tile arrives with the call, and
its preamble (the per-subint dedispersion) and EW template read and make
tensors of the tile's bytes, as the reference's step does.  Its cube
contracts therefore hold from its sweep on (``cube_from``): from the
first ``icln_residual_stats`` range, no op takes or allocates a tensor of
the tile's bytes or more, and the peak is measured from there.

A program that raises gives a ``verifier-error`` violation, never a skip.

One program runs over ranks (:class:`MeshProgram`): ``mesh_padded_sweep``,
the reference's padded-mesh rung.  Its cell grid is one subint and one
channel past :func:`geometry` (257 x 1025 x 256 on the card, 5 x 9 x 32
on the CPU), which no mesh axis above 1 divides; four spawned gloo ranks
(``parallel.distributed.run_local_ranks``, the spawn context: no rank
inherits the parent's CUDA context, and the parent makes no process
group) form a 2 x 2 ``cell_mesh`` on ``cuda:0`` (on the CPU in tests),
each cutting its block of the padded grid with the calls
``clean_cube_sharded`` makes (``shard_layout``, ``upload_shard``), and
each records one steady ``engine.loop._sharded_sweep`` as above.  The
parent merges the four reports: ok only if every rank's is, each
violation naming its rank.  Of the reference's two program checks,
**pad-geometry** is this program's own (the mesh pads nothing on an
axis, or the padded grid does not divide: the program would no longer
test padding); **mesh-eligible** (padding keeps the one-launch mesh
sweep) has no route gate to check in the port, and its counterpart is
single-cube-read's kernel check: ``shard_diagnostics_disp`` (K10) and
``combine_zap`` once an iteration on every rank, no other cube kernel.

Four ranks share one card, and NCCL refuses two ranks on one GPU, so the
ranks run gloo, which stages every CUDA operand of a collective through
host memory and blocks the host in it.  For this program alone
(``HotRun.transport``) the host reads and sync warnings raised inside a
collective of ``parallel.distributed`` (``COLLECTIVE_LISTENER``) are the
transport's: counted apart (``transport_reads``, ``transport_syncs``),
as are the collectives (``c10d.*`` ops), and not against the pin.  Any
host read or sync warning outside a collective stays a violation.  The
seven other programs count every host read as before.  What the
transport itself costs on the card is for the four-card NCCL run to
decide (ROADMAP item 7).
"""

from __future__ import annotations

import contextlib
import dataclasses
import tempfile
import threading
import time
import warnings
from typing import Callable, Dict, List, Optional, Sequence, Tuple

#: the contracts, in report order
CONTRACTS = ("no-host-sync", "no-f64", "dispatch-bound", "single-cube-read",
             "no-cube-copy")

#: which device decides which contract: the CPU runs the kernels' plain
#: versions, whose own ops and allocations say nothing of the card's, and
#: it has no launch counters or allocator peaks
DECIDES = {"cpu": ("no-host-sync", "no-f64"), "cuda": CONTRACTS}

#: aten ops that read a value back to the host (each one a synchronisation
#: on the card)
HOST_READ_OPS = frozenset({
    "aten._local_scalar_dense", "aten.is_nonzero", "aten.item",
    "aten.nonzero", "aten.masked_select", "aten.equal",
})

#: copy ops whose card <-> host direction is a transfer
_COPY_OPS = frozenset({"aten._to_copy", "aten.copy_"})

#: the CPU geometry, the reference's: nothing degenerates to scalars and
#: every kernel of every route launches
NSUB, NCHAN, NBIN, BATCH = 4, 8, 32, 2

#: the card's geometry.  At 4 x 8 x 32 the cube (4 KiB) is no larger than
#: K1's partial sums (nsb x nchan x nbin with nsb = nsub wherever nsub is
#: below 4 x SMs / tiles), a (nchan, nbin) row of the template stage or
#: K2's DFT tables, so no-cube-copy could not tell a copy of the cube from
#: the iteration's own rows.  Here K1's partials are an eighth of the
#: cube (16 of 256 subints), a (nchan, nbin) row a 256th and the planes
#: (nsub, nchan) float32 a 64th; a bf16 cube is 128 MiB.
CARD_GEOMETRY = (256, 1024, 256)

WIDE_DTYPES = ("torch.float64", "torch.complex128")

#: the text of the sync debug mode's warning (``c10/cuda``
#: ``warn_or_error_on_sync``); other warnings of the call are not counted
SYNC_WARNING = "called a synchronizing CUDA operation"

_SWEEP_STAGE = "icln_residual_stats"


def geometry(device) -> Tuple[int, int, int]:
    """``(nsub, nchan, nbin)`` of the contract runs on ``device``."""
    import torch

    return CARD_GEOMETRY if torch.device(device).type == "cuda" \
        else (NSUB, NCHAN, NBIN)


def padded_geometry(device) -> Tuple[int, int, int]:
    """The padded-mesh program's grid on ``device``: one subint and one
    channel past :func:`geometry`, indivisible on every mesh axis above
    1 (257 x 1025 x 256 on the card, 5 x 9 x 32 on the CPU)."""
    nsub, nchan, nbin = geometry(device)
    return nsub + 1, nchan + 1, nbin


@dataclasses.dataclass(frozen=True)
class ContractViolation:
    program: str
    contract: str
    detail: str

    def render(self) -> str:
        return f"{self.program}: {self.contract}: {self.detail}"


@dataclasses.dataclass
class ProgramReport:
    """One program's recorded call and the contracts' verdicts.  The
    per-iteration numbers are the call's totals over ``iterations``."""

    program: str
    device: str
    decided: Tuple[str, ...] = ()
    iterations: int = 0
    host_reads: int = 0
    sync_warnings: Optional[int] = None     # card only
    #: where each counted sync warning was raised (``file:line``)
    sync_sites: List[str] = dataclasses.field(default_factory=list)
    ops: int = 0
    launches: int = 0
    #: the collectives (``c10d.*`` ops) among ``ops``, and on a transport
    #: run the host reads and sync warnings inside them, not in
    #: ``host_reads`` / ``sync_warnings``
    collectives: int = 0
    transport_reads: int = 0
    transport_syncs: Optional[int] = None   # card only
    peak_delta_bytes: Optional[int] = None  # card only
    cube_bytes: int = 0
    kernel_launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    #: the recorded ops by stage (``-``: outside every stage) and by name
    stage_ops: Dict[str, int] = dataclasses.field(default_factory=dict)
    op_counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    seconds: float = 0.0
    violations: List[ContractViolation] = dataclasses.field(
        default_factory=list)
    #: a program over ranks: the rank grid, the pad subints and channels,
    #: this rank's block ``(s0, s1, c0, c1)`` of the padded grid, and in
    #: the merged report each rank's own report (:meth:`to_dict`); the
    #: merged counts are the largest rank's
    mesh: Optional[Tuple[int, int]] = None
    pads: Optional[Tuple[int, int]] = None
    block: Optional[Tuple[int, int, int, int]] = None
    ranks: List[dict] = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.violations

    def per_iteration(self, total: Optional[float]) -> Optional[float]:
        if total is None:
            return None
        return total / max(1, self.iterations)

    def to_dict(self) -> dict:
        def opt(x):
            return None if x is None else list(x)

        return {
            "program": self.program,
            "device": self.device,
            "ok": self.ok,
            "decided": list(self.decided),
            "iterations": self.iterations,
            "host_reads_per_iter": self.per_iteration(self.host_reads),
            "sync_warnings_per_iter": self.per_iteration(self.sync_warnings),
            "sync_sites": list(self.sync_sites),
            "ops_per_iter": self.per_iteration(self.ops),
            "launches_per_iter": self.per_iteration(self.launches),
            "collectives_per_iter": self.per_iteration(self.collectives),
            "transport_reads_per_iter": self.per_iteration(
                self.transport_reads),
            "transport_syncs_per_iter": self.per_iteration(
                self.transport_syncs),
            "mesh": opt(self.mesh),
            "pads": opt(self.pads),
            "block": opt(self.block),
            "ranks": [dict(r) for r in self.ranks],
            "peak_delta_bytes": self.peak_delta_bytes,
            "cube_bytes": self.cube_bytes,
            "kernel_launches": dict(self.kernel_launches),
            "stage_ops": dict(self.stage_ops),
            "op_counts": dict(self.op_counts),
            "seconds": self.seconds,
            "violations": [dataclasses.asdict(v) for v in self.violations],
        }

    def render(self) -> str:
        def num(x):
            return "-" if x is None else f"{x:g}"

        def peak(d):
            p, cube = d["peak_delta_bytes"], d["cube_bytes"]
            return "-" if p is None else f"{p / cube:.3f} cube" if cube \
                else str(p)

        def counts(d):
            extra = ""
            if d["collectives_per_iter"]:
                extra = f", {num(d['collectives_per_iter'])} collectives"
            if d["mesh"] is not None:
                extra += (f" ({num(d['transport_reads_per_iter'])} host "
                          f"reads, {num(d['transport_syncs_per_iter'])} "
                          f"sync warnings inside them)")
            return (f"{num(d['host_reads_per_iter'])} host reads, "
                    f"{num(d['sync_warnings_per_iter'])} sync warnings, "
                    f"{num(d['ops_per_iter'])} ops, "
                    f"{num(d['launches_per_iter'])} launches{extra}; peak "
                    f"{peak(d)}")

        d = self.to_dict()
        where = "" if self.mesh is None else (
            f" over a {self.mesh[0]} x {self.mesh[1]} mesh of "
            f"{len(self.ranks)} ranks, pads {num(self.pads and self.pads[0])}"
            f" x {num(self.pads and self.pads[1])}")
        lines = [f"contracts {self.program} on {self.device}{where}: "
                 f"{'ok' if self.ok else 'FAIL'} ({self.iterations} "
                 f"iteration{'' if self.iterations == 1 else 's'}; per "
                 f"iteration {counts(d)}; {self.seconds:.2f} s)"]
        for r, rd in enumerate(self.ranks):
            lines.append(f"  rank {r} block {rd['block']}: "
                         f"{'ok' if rd['ok'] else 'FAIL'}; per iteration "
                         f"{counts(rd)}; kernels {rd['kernel_launches']}")
        return "\n".join(lines)


@dataclasses.dataclass
class HotRun:
    """A built program, ready to record.

    ``call`` runs it once and returns its result; ``iterations(result)``
    says how many iterations (or steps) that was, read after the record.
    ``prepare`` runs before every call, outside the record (a step's
    fresh tile: its preamble consumes it).  ``cubes`` are the resident
    cubes (storage identity); ``cube_bytes`` the bytes a cube-sized
    tensor has; ``cube_from`` the stage from which the cube contracts
    hold (None: the whole call).  ``kernels`` maps each kernel the
    program launches to its launches per iteration (a cube kernel once;
    any cube kernel not listed must not launch).  ``probe`` is a small
    tensor of the program's device that seeded violations use;
    ``close`` tears down what the build started.  ``transport``: the
    host reads and sync warnings inside a collective are the gloo
    transport's, counted apart (the padded-mesh program only)."""

    call: Callable[[], object]
    cube_bytes: int
    kernels: Dict[str, int]
    probe: object
    cubes: tuple = ()
    iterations: Callable[[object], int] = lambda _result: 1
    prepare: Optional[Callable[[], None]] = None
    cube_from: Optional[str] = None
    close: Optional[Callable[[], None]] = None
    transport: bool = False


@dataclasses.dataclass(frozen=True)
class HotProgram:
    """A registered program: its builder and its pins.  ``host_reads``
    is the code's own claim (the CPU's plain versions read nothing more
    back, so both devices hold it); ``max_ops`` the card's dispatch
    ceiling per iteration (aten ops plus launches)."""

    name: str
    build: Callable[[object], HotRun]
    host_reads: int
    max_ops: Optional[float]


#: a program over ranks: its ranks (a 2 x 2 ``cell_mesh``), each rank's
#: timeout (inside the 300 s that ``chip_smoke.py`` gives the whole
#: --selfcheck) and the seconds one of its collectives waits for a peer
MESH_RANKS = 4
RANK_TIMEOUT_S = 180.0
RANK_GROUP_TIMEOUT_S = 120.0


@dataclasses.dataclass(frozen=True)
class MeshProgram(HotProgram):
    """A registered program that runs on :data:`MESH_RANKS` spawned gloo
    rank processes sharing the device, its pins each rank's.  On every rank
    ``build(device, mesh, layout, shape)`` makes the rank's :class:`HotRun`
    from its ``cell_mesh`` and that mesh's ``shard_layout`` of the
    ``shape`` grid (None: :func:`padded_geometry`).  ``seed`` seeds one
    of :data:`SEEDS` into rank ``seed_rank``'s program alone
    (:func:`seeded`).  Picklable: it travels to the spawned ranks."""

    shape: Optional[Tuple[int, int, int]] = None
    seed: Optional[str] = None
    seed_rank: int = 0


# --------------------------------------------------------------------------
# the recorder
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class OpRecord:
    name: str
    stage: Optional[str]
    out_dtypes: Tuple[str, ...]
    alloc_bytes: int        # the largest storage the op allocated
    in_bytes: int           # the largest input storage
    reads_cube: bool
    host_read: bool
    in_window: bool         # at or after the program's cube_from stage
    in_collective: bool     # inside a collective of parallel.distributed


def _storage(t):
    try:
        st = t.untyped_storage()
        return st.data_ptr(), st.nbytes()
    except (RuntimeError, NotImplementedError):
        return None, 0


def _is_host_read(name, func_args, kwargs, ins, outs) -> bool:
    """A read back to the host: one of :data:`HOST_READ_OPS`, or a copy
    between the card and the host that blocks (card to host always;
    host to card unless ``non_blocking``)."""
    if name in HOST_READ_OPS:
        return True
    if name not in _COPY_OPS:
        return False
    devs_in = {t.device.type for t in ins}
    if name == "aten.copy_" and func_args:
        dst = func_args[0]
        src = func_args[1] if len(func_args) > 1 else None
        devs_out = {dst.device.type}
        devs_in = {src.device.type} if src is not None else devs_in
        non_blocking = bool(func_args[2]) if len(func_args) > 2 \
            else bool(kwargs.get("non_blocking", False))
    else:
        devs_out = {t.device.type for t in outs}
        non_blocking = bool(kwargs.get("non_blocking", False))
    if "cuda" in devs_in and "cpu" in devs_out:
        return True
    return "cpu" in devs_in and "cuda" in devs_out and not non_blocking


class _CollectiveTracker:
    """The ``parallel.distributed.COLLECTIVE_LISTENER`` of a record:
    whether a collective is open, and which of the body's warnings
    (indices into ``caught``, the live list of the sync debug mode's
    warnings; None off the card) were raised inside one."""

    def __init__(self):
        self.depth = 0
        self.caught: Optional[list] = None
        self.spans: List[Tuple[int, int]] = []

    @contextlib.contextmanager
    def _span(self):
        start = len(self.caught) if self.caught is not None else 0
        self.depth += 1
        try:
            yield
        finally:
            self.depth -= 1
            if self.caught is not None:
                self.spans.append((start, len(self.caught)))

    def __call__(self):
        return self._span()

    def inside(self, i: int) -> bool:
        return any(a <= i < b for a, b in self.spans)


class _StageTracker:
    """The ``utils/tracing.STAGE_LISTENER`` of a record: a stack of open
    stage names, and the first entry of the program's ``cube_from``
    stage (where the peak is re-based)."""

    def __init__(self, cube_from, on_window):
        self.stack: List[str] = []
        self.cube_from = cube_from
        self.window = cube_from is None
        self._on_window = on_window

    @contextlib.contextmanager
    def _range(self, name):
        if not self.window and name == self.cube_from:
            self.window = True
            self._on_window()
        self.stack.append(name)
        try:
            yield
        finally:
            self.stack.pop()

    def __call__(self, name):
        return self._range(name)

    @property
    def current(self) -> Optional[str]:
        return self.stack[-1] if self.stack else None


def _recorder_class():
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class OpRecorder(TorchDispatchMode):
        """Records every aten op dispatched on the recording thread."""

        def __init__(self, cube_ptrs, cube_bytes, by_size, tracker,
                     collectives=None):
            super().__init__()
            self.records: List[OpRecord] = []
            self.cube_ptrs = set(cube_ptrs)
            self.cube_bytes = cube_bytes
            self.by_size = by_size
            self.tracker = tracker
            self.collectives = collectives
            self.thread = threading.get_ident()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            import torch

            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            if threading.get_ident() != self.thread:
                return out
            ins = [t for t in tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)]
            outs = [t for t in tree_leaves(out)
                    if isinstance(t, torch.Tensor)]
            in_st = [_storage(t) for t in ins]
            in_ptrs = {p for p, _ in in_st if p}
            alloc = 0
            for t in outs:
                ptr, nbytes = _storage(t)
                if ptr and ptr not in in_ptrs:
                    alloc = max(alloc, nbytes)
            in_bytes = max((n for _, n in in_st), default=0)
            reads_cube = any(p in self.cube_ptrs for p, _ in in_st if p) \
                or (self.by_size and self.cube_bytes > 0
                    and in_bytes >= self.cube_bytes)
            name = str(func.overloadpacket)
            self.records.append(OpRecord(
                name, self.tracker.current,
                tuple(str(t.dtype) for t in outs), alloc, in_bytes,
                reads_cube, _is_host_read(name, args, kwargs, ins, outs),
                self.tracker.window,
                self.collectives is not None and self.collectives.depth > 0))
            return out

    return OpRecorder


@contextlib.contextmanager
def _stage_listener(tracker):
    from iterative_cleaner_torch.utils import tracing

    prev = tracing.STAGE_LISTENER
    tracing.STAGE_LISTENER = tracker
    try:
        yield
    finally:
        tracing.STAGE_LISTENER = prev


@contextlib.contextmanager
def _collective_listener(tracker):
    from iterative_cleaner_torch.parallel import distributed

    prev = distributed.COLLECTIVE_LISTENER
    distributed.COLLECTIVE_LISTENER = tracker
    try:
        yield
    finally:
        distributed.COLLECTIVE_LISTENER = prev


@contextlib.contextmanager
def _sync_warnings(enabled: bool):
    """The body's warnings under the card's sync debug mode
    (``torch.cuda.set_sync_debug_mode("warn")``), yielded as the list
    they are appended to while they are raised (None when not
    ``enabled``); :func:`_sync_sites` picks the synchronisations."""
    if not enabled:
        yield None
        return
    import torch

    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield caught
        finally:
            torch.cuda.set_sync_debug_mode(prev)


def _sync_sites(caught, keep=lambda _i: True) -> List[str]:
    """``file:line`` of each synchronisation warning in ``caught`` whose
    index ``keep`` accepts."""
    return [f"{w.filename}:{w.lineno}" for i, w in enumerate(caught or ())
            if SYNC_WARNING in str(w.message) and keep(i)]


_PRIMED = set()


def _prime(dev) -> None:
    """Run the record's machinery once on ``dev`` over a trivial op: what
    it initialises on its first use in a process (the dispatch mode, the
    sync debug mode) is then not counted against the first program."""
    import torch

    if str(dev) in _PRIMED:
        return
    tracker = _StageTracker(None, lambda: None)
    with _stage_listener(tracker), \
            _sync_warnings(dev.type == "cuda"), \
            _recorder_class()([], 0, False, tracker):
        torch.ones(4, device=dev).add_(1.0)
    _PRIMED.add(str(dev))


def record(program: HotProgram, run: HotRun, device,
           decide: Optional[Sequence[str]] = None) -> ProgramReport:
    """Record one steady call of a built program and decide the
    contracts (``decide``: the device's own, :data:`DECIDES`, unless
    given)."""
    import torch

    from iterative_cleaner_torch.stats import kernels as K

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    decided = tuple(decide) if decide is not None \
        else DECIDES["cuda" if on_card else "cpu"]
    report = ProgramReport(program.name, str(dev), decided,
                           cube_bytes=run.cube_bytes)
    _prime(dev)
    if run.prepare is not None:
        run.prepare()
    peak_base = [0]

    def on_window():
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
            peak_base[0] = torch.cuda.memory_allocated(dev)

    tracker = _StageTracker(run.cube_from, on_window)
    collectives = _CollectiveTracker()
    recorder = _recorder_class()(
        [_storage(c)[0] for c in run.cubes], run.cube_bytes,
        not run.cubes, tracker, collectives)
    if on_card:
        torch.cuda.synchronize(dev)
    if run.cube_from is None:
        on_window()
    before = K.launch_counts()
    with _stage_listener(tracker), _collective_listener(collectives), \
            _sync_warnings(on_card) as caught:
        collectives.caught = caught
        with recorder:
            result = run.call()
    if on_card:
        torch.cuda.synchronize(dev)
        report.peak_delta_bytes = int(
            torch.cuda.max_memory_allocated(dev) - peak_base[0])
        if run.transport:
            report.sync_sites = _sync_sites(
                caught, lambda i: not collectives.inside(i))
            report.transport_syncs = len(_sync_sites(
                caught, collectives.inside))
        else:
            report.sync_sites = _sync_sites(caught)
        report.sync_warnings = len(report.sync_sites)
    after = K.launch_counts()
    report.kernel_launches = {k: after[k] - before.get(k, 0) for k in after
                              if after[k] != before.get(k, 0)}
    report.iterations = int(run.iterations(result))
    records = recorder.records
    report.transport_reads = sum(1 for r in records if r.host_read
                                 and run.transport and r.in_collective)
    report.host_reads = sum(1 for r in records if r.host_read) \
        - report.transport_reads
    report.collectives = sum(1 for r in records
                             if r.name.startswith("c10d."))
    report.ops = len(records)
    for r in records:
        st = r.stage or "-"
        report.stage_ops[st] = report.stage_ops.get(st, 0) + 1
        report.op_counts[r.name] = report.op_counts.get(r.name, 0) + 1
    report.launches = sum(report.kernel_launches.values())
    report.violations = _decide(program, run, report, records, decided,
                                on_card)
    return report


def _decide(program, run, report, records, decided, on_card):
    out: List[ContractViolation] = []
    name, n = program.name, max(1, report.iterations)

    def add(contract, detail):
        if contract in decided:
            out.append(ContractViolation(name, contract, detail))

    pin = program.host_reads
    if report.host_reads > pin * n:
        where = sorted({f"{r.name}@{r.stage or '-'}" for r in records
                        if r.host_read
                        and not (run.transport and r.in_collective)})
        add("no-host-sync",
            f"{report.host_reads} host reads in {n} iteration(s), pinned "
            f"at {pin} per iteration: {', '.join(where)}")
    if on_card and report.sync_warnings is not None \
            and report.sync_warnings != report.host_reads:
        add("no-host-sync",
            f"the sync debug mode warned {report.sync_warnings} times (at "
            f"{', '.join(sorted(set(report.sync_sites)))}), the dispatch "
            f"count says {report.host_reads} host reads: a synchronisation "
            f"the count does not see (or the reverse)")
    wide = sorted({f"{r.name} -> {d.replace('torch.', '')}" for r in records
                   for d in r.out_dtypes if d in WIDE_DTYPES})
    if wide:
        add("no-f64", "float64/complex128 on a float32 route: "
            + ", ".join(wide))
    if program.max_ops is not None \
            and report.ops + report.launches > program.max_ops * n:
        add("dispatch-bound",
            f"{report.ops} aten ops + {report.launches} launches in {n} "
            f"iteration(s) = {(report.ops + report.launches) / n:g} per "
            f"iteration, over the pinned ceiling {program.max_ops:g}: an "
            f"op or a launch was added per iteration; re-pin deliberately "
            f"if intended")
    elif program.max_ops is None:
        add("dispatch-bound", "no ceiling pinned for this program")
    got = report.kernel_launches
    wrong = {k: got.get(k, 0) for k, per in run.kernels.items()
             if got.get(k, 0) != per * n}
    if wrong:
        want = {k: per * n for k, per in run.kernels.items()}
        add("single-cube-read",
            f"kernel launches {wrong} in {n} iteration(s), expected "
            f"{want}")
    from iterative_cleaner_torch.engine.loop import CUBE_KERNELS

    stray = {k: v for k, v in got.items()
             if k.split("_bf16")[0].split("_f64")[0] in CUBE_KERNELS
             and k not in run.kernels}
    if stray:
        add("single-cube-read",
            f"cube kernels outside the route launched: {stray}")
    readers = sorted({f"{r.name}@{r.stage or '-'}" for r in records
                      if r.reads_cube and r.in_window})
    if readers:
        add("single-cube-read",
            "aten ops read the cube: " + ", ".join(readers))
    big = sorted({f"{r.name}@{r.stage or '-'} ({r.alloc_bytes} B)"
                  for r in records if r.in_window
                  and run.cube_bytes and r.alloc_bytes >= run.cube_bytes})
    if big:
        add("no-cube-copy",
            f"allocations of the cube's {run.cube_bytes} bytes or more: "
            + ", ".join(big))
    if report.peak_delta_bytes is not None and run.cube_bytes \
            and report.peak_delta_bytes >= run.cube_bytes:
        add("no-cube-copy",
            f"peak allocation over the call {report.peak_delta_bytes} B "
            f">= one cube ({run.cube_bytes} B)")
    return out


# --------------------------------------------------------------------------
# the programs
# --------------------------------------------------------------------------

def _synthetic_inputs(device, shape, batch: Optional[int] = None,
                     seed: int = 0):
    """A seeded total-intensity cube made on ``device`` with its weights
    and dispersion metadata: noise, a pulse in every cell, a strong
    ripple in every 7th cell (the RFI the loop zaps) and every 11th cell
    pre-zapped.  Returns ``(cube, weights, (freqs, dm, ref, period))``,
    each with a leading ``batch`` dimension where given."""
    import torch

    nsub, nchan, nbin = shape
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    lead = () if batch is None else (batch,)
    cube = torch.randn(lead + (nsub, nchan, nbin), generator=g,
                       device=device)
    b = torch.arange(nbin, device=device, dtype=torch.float32)
    cube += 10.0 * torch.exp(-0.5 * ((b - nbin / 2) / (nbin / 32.0)) ** 2)
    cube.view(-1, nbin)[::7] += 30.0 * torch.sin(0.7 * b)
    weights = torch.ones(lead + (nsub, nchan), device=device)
    weights.view(-1)[::11] = 0.0
    freqs = torch.linspace(1200.0, 1600.0, nchan, device=device)

    def scalar(v):
        return torch.full(lead, v, device=device)

    if batch is not None:
        freqs = freqs.expand(batch, nchan).contiguous()
    return cube, weights, (freqs, scalar(30.0), scalar(1400.0),
                           scalar(0.05))


def _loop_kwargs(cfg):
    return dict(chanthresh=cfg.chanthresh, subintthresh=cfg.subintthresh,
                rotation=cfg.rotation, baseline_duty=cfg.baseline_duty)


_SHARED = {"scaled_sides_axis0": 1, "scaled_sides_axis1": 1,
           "combine_zap": 1}


def _cube_nbytes(t) -> int:
    return t.numel() * t.element_size()


def _clean_loop(device) -> HotRun:
    from iterative_cleaner_torch.config import CleanConfig
    from iterative_cleaner_torch.engine.loop import clean_loop, prepare

    cfg = CleanConfig(device=str(device))
    cube, w, meta = _synthetic_inputs(device, geometry(device))
    prep = prepare(cube, w, *meta, cfg, dedispersed=False)
    kw = _loop_kwargs(cfg)
    return HotRun(
        call=lambda: clean_loop(prep, w, max_iter=cfg.max_iter, **kw),
        iterations=lambda out: out.loops,
        cubes=(prep.disp_clean,), cube_bytes=_cube_nbytes(prep.disp_clean),
        kernels={"weighted_marginals": 1, "cell_diagnostics_disp": 1,
                 "masked_median": 1, **_SHARED},
        probe=w)


def _clean_loop_batch(device) -> HotRun:
    from iterative_cleaner_torch.config import CleanConfig
    from iterative_cleaner_torch.engine.loop import (
        clean_loop_batch,
        prepare_batch,
    )

    cfg = CleanConfig(device=str(device))
    cube, w, meta = _synthetic_inputs(device, geometry(device), batch=BATCH)
    prep = prepare_batch(cube, w, *meta, cfg, dedispersed=False)
    kw = _loop_kwargs(cfg)
    return HotRun(
        call=lambda: clean_loop_batch(prep, w, max_iter=cfg.max_iter, **kw),
        iterations=lambda out: int(out.loops.max()),
        cubes=(prep.disp_clean,), cube_bytes=_cube_nbytes(prep.disp_clean),
        kernels={"weighted_marginals": 1, "cell_diagnostics_disp": 1,
                 "masked_median": 1, **_SHARED},
        probe=w)


def _step_run(device, lanes: Optional[int]) -> HotRun:
    """The online step, solo (``lanes`` None) or over a mux's lanes,
    warmed by a first step so that the recorded one updates a seeded EW
    template."""
    import torch

    from iterative_cleaner_torch.config import CleanConfig
    from iterative_cleaner_torch.online.step import build_subint_step

    _nsub, nchan, nbin = geometry(device)
    cfg = CleanConfig(device=str(device))
    step, _dev, dtype = build_subint_step(cfg, nchan, nbin, False, 0.1)
    cube, w, meta = _synthetic_inputs(device, (1, nchan, nbin), batch=lanes)
    state = {"template": torch.zeros(
        ((lanes,) if lanes else ()) + (nbin,), dtype=dtype, device=device),
        "count": torch.zeros((lanes,) if lanes else (), dtype=torch.int32,
                             device=device)}
    tile = {}

    def fresh():
        tile["t"] = cube.clone()   # the preamble consumes its tile

    def call():
        out = step(tile["t"], w, *meta, state["template"], state["count"])
        state["template"] = out[2]
        state["count"] = state["count"] + out[3].to(torch.int32)
        return out

    return HotRun(call=call, prepare=fresh, cube_bytes=_cube_nbytes(cube),
                  cube_from=_SWEEP_STAGE,
                  kernels={"cell_diagnostics_dedisp": 1, **_SHARED}, probe=w)


def _online_step(device) -> HotRun:
    return _step_run(device, None)


def _mux_step(device) -> HotRun:
    return _step_run(device, BATCH)


def _sweep(device) -> HotRun:
    """The post-template sequence on the default (K2) and dedispersed
    (K6) routes, one call each, against templates built before."""
    from iterative_cleaner_torch.config import CleanConfig
    from iterative_cleaner_torch.engine.loop import (
        build_template,
        prepare,
        route_diagnostics,
        scores_and_zap,
    )

    cfg = CleanConfig(device=str(device))
    cfg_ded = CleanConfig(device=str(device), stats_frame="dedispersed")
    kw = _loop_kwargs(cfg)
    runs = []
    for c, seed in ((cfg, 0), (cfg_ded, 1)):
        cube, w, meta = _synthetic_inputs(device, geometry(device), seed=seed)
        prep = prepare(cube, w, *meta, c, dedispersed=False)
        template = build_template(prep, w, rotation=kw["rotation"],
                                  baseline_duty=kw["baseline_duty"])
        runs.append((prep, template, w, w == 0))
    assert [p.route for p, *_ in runs] == ["default", "dedispersed"]

    def call():
        out = []
        for prep, template, w, mask in runs:
            diags = route_diagnostics(prep, template, w, mask,
                                      rotation=kw["rotation"])
            out.append(scores_and_zap(diags, mask, w, kw["chanthresh"],
                                      kw["subintthresh"]))
        return out

    cubes = tuple(t for prep, *_ in runs
                  for t in (prep.disp_clean, prep.ded) if t is not None)
    return HotRun(
        call=call, cubes=cubes, cube_bytes=_cube_nbytes(cubes[0]),
        kernels={"cell_diagnostics_disp": 1, "cell_diagnostics_dedisp": 1,
                 **{k: 2 * v for k, v in _SHARED.items()}},
        probe=runs[0][2])


def _sweep_bf16(device) -> HotRun:
    """One iteration of the default route on a bf16-stored cube: K1 and
    K2 in their bf16 builds, K3 x 2, the combine and K9."""
    from iterative_cleaner_torch.config import CleanConfig
    from iterative_cleaner_torch.engine.loop import (
        iteration_step,
        prepare,
        store_prepared,
    )

    cfg = CleanConfig(device=str(device), compute_dtype="bfloat16")
    cube, w, meta = _synthetic_inputs(device, geometry(device))
    prep = store_prepared(prepare(cube, w, *meta, cfg, dedispersed=False),
                          "bfloat16")
    mask = w == 0
    return HotRun(
        call=lambda: iteration_step(prep, w, w, mask, **_loop_kwargs(cfg)),
        cubes=(prep.disp_clean,), cube_bytes=_cube_nbytes(prep.disp_clean),
        kernels={"weighted_marginals_bf16": 1,
                 "cell_diagnostics_disp_bf16": 1, "masked_median": 1,
                 **_SHARED},
        probe=w)


def _sharded_run(device, mesh, cube, w, meta, **run) -> HotRun:
    """``engine.loop._sharded_sweep`` on the default route of this
    rank's block ``cube`` over ``mesh``, after ``prepare`` and
    ``build_template`` on the block: K10 on the block, the tree-reduced
    scalers and median, the combine.  ``run``: further :class:`HotRun`
    fields."""
    from iterative_cleaner_torch.config import CleanConfig
    from iterative_cleaner_torch.engine.loop import (
        _sharded_sweep,
        build_template,
        prepare,
    )

    cfg = CleanConfig(device=str(device))
    kw = _loop_kwargs(cfg)
    prep = prepare(cube, w, *meta, cfg, dedispersed=False, mesh=mesh)
    template = build_template(prep, w, rotation=kw["rotation"],
                              baseline_duty=kw["baseline_duty"], mesh=mesh)
    mask = w == 0
    return HotRun(
        call=lambda: _sharded_sweep(prep, template, w, mask, mesh,
                                    chanthresh=kw["chanthresh"],
                                    subintthresh=kw["subintthresh"],
                                    rotation=kw["rotation"]),
        cubes=(prep.disp_clean,), cube_bytes=_cube_nbytes(prep.disp_clean),
        kernels={"shard_diagnostics_disp": 1, "combine_zap": 1}, probe=w,
        **run)


def _sharded_sweep(device) -> HotRun:
    """The sharded sweep over a one-rank process group (gloo on the
    CPU, NCCL on the card), where nothing pads."""
    import torch.distributed as dist

    from iterative_cleaner_torch.parallel import distributed
    from iterative_cleaner_torch.parallel.mesh import cell_mesh

    own = not dist.is_initialized()
    if own:
        distributed.initialize(device=str(device))
    elif dist.get_world_size() != 1:
        raise RuntimeError("the sharded_sweep contract runs on a one-rank "
                           "process group; this process has "
                           f"{dist.get_world_size()} ranks")
    try:
        cube, w, meta = _synthetic_inputs(device, geometry(device))
        return _sharded_run(device, cell_mesh(), cube, w, meta,
                            close=distributed.shutdown if own else None)
    except BaseException:
        if own:
            distributed.shutdown()
        raise


def mesh_inputs(shape):
    """The padded-mesh program's whole archive as host arrays, the same
    on every rank: :func:`_synthetic_inputs`'s seeded construction on
    the CPU, ``(cube, weights, freqs_mhz, dm, centre_freq_mhz,
    period_s)``."""
    cube, w, (freqs, dm, ref, period) = _synthetic_inputs("cpu", shape)
    return (cube.numpy(), w.numpy(), freqs.numpy(), float(dm), float(ref),
            float(period))


def padded_block(device, layout, shape):
    """This rank's block of :func:`mesh_inputs` under ``layout``, as
    ``clean_cube_sharded`` cuts and uploads it: the block and its
    weights by ``upload_shard`` (zero past the archive's grid), the
    block's frequencies (a pad channel takes the last real one's) and
    the dispersion metadata by ``upload_meta``."""
    from iterative_cleaner_torch.backends.torch_backend import upload_meta
    from iterative_cleaner_torch.parallel.sharding import upload_shard

    cube, w, freqs, dm, ref, period = mesh_inputs(shape)
    block, w_t, f = upload_shard(cube, w, freqs, layout, device)
    return block, w_t, upload_meta(f, dm, ref, period, device)


def _padded_sweep(device, mesh, layout, shape) -> HotRun:
    block, w, meta = padded_block(device, layout, shape)
    return _sharded_run(device, mesh, block, w, meta, transport=True)


def _pad_violations(name, mesh_shape, layout) -> List[ContractViolation]:
    """The padded-mesh program's pad-geometry check: its grid pads on
    both axes of ``mesh_shape`` and divides once padded."""
    a, b = mesh_shape
    ps, pc = layout.nsub + layout.pad_s, layout.nchan + layout.pad_c
    if layout.pad_s and layout.pad_c and not ps % a and not pc % b:
        return []
    return [ContractViolation(
        name, "pad-geometry",
        f"the {layout.nsub} x {layout.nchan} grid pads by {layout.pad_s} x "
        f"{layout.pad_c} to {ps} x {pc} on the {a} x {b} mesh: the program "
        f"must pad on both axes and divide once padded")]


def _mesh_rank(program: MeshProgram, device: str,
               decide: Optional[Sequence[str]]) -> ProgramReport:
    """One rank of a :class:`MeshProgram` (run by ``run_local_ranks`` in
    a spawned process, its process group started): the rank's report."""
    from iterative_cleaner_torch.parallel.mesh import cell_mesh
    from iterative_cleaner_torch.parallel.sharding import shard_layout

    mesh = cell_mesh()
    shape = program.shape or padded_geometry(device)
    layout = shard_layout(mesh, shape[0], shape[1])
    bad = _pad_violations(program.name, mesh.shape, layout)
    if bad:
        report = ProgramReport(program.name, device, violations=bad)
    else:
        local = HotProgram(
            program.name,
            lambda dev: program.build(dev, mesh, layout, shape),
            program.host_reads, program.max_ops)
        if program.seed is not None and mesh.rank == program.seed_rank:
            local = dataclasses.replace(seeded(local, program.seed),
                                        name=program.name)
        report = verify_program(local, device, decide)
    report.mesh = tuple(mesh.shape)
    report.pads = (layout.pad_s, layout.pad_c)
    report.block = (layout.s0, layout.s1, layout.c0, layout.c1)
    return report


def _verify_mesh_program(program: MeshProgram, dev,
                         decide: Optional[Sequence[str]]) -> ProgramReport:
    """Run ``program`` on its spawned gloo ranks (``cuda:0`` shared on
    the card, the CPU with one thread a rank) and merge their reports.
    A rank that dies or outlives :data:`RANK_TIMEOUT_S` fails the whole
    run with one ``verifier-error``; nothing falls back to fewer
    ranks."""
    from iterative_cleaner_torch.parallel.distributed import run_local_ranks

    on_card = dev.type == "cuda"
    device = f"cuda:{dev.index or 0}" if on_card else "cpu"
    name = program.name
    with tempfile.TemporaryDirectory(prefix="icln_contract_ranks_") as work:
        try:
            ranks = run_local_ranks(
                _mesh_rank, MESH_RANKS, (program, device, decide),
                workdir=work, device=device, backend="gloo",
                timeout_s=RANK_TIMEOUT_S, threads=2 if on_card else 1,
                group_timeout_s=RANK_GROUP_TIMEOUT_S)
        except (RuntimeError, TimeoutError) as exc:
            return ProgramReport(name, device, violations=[ContractViolation(
                name, "verifier-error", f"{type(exc).__name__}: {exc}")])
    first = ranks[0]
    merged = ProgramReport(name, device, first.decided,
                           cube_bytes=first.cube_bytes, mesh=first.mesh,
                           pads=first.pads)
    for r, rep in enumerate(ranks):
        merged.violations += [ContractViolation(name, v.contract,
                                                f"rank {r}: {v.detail}")
                              for v in rep.violations]
        merged.ranks.append(rep.to_dict())
        for k, v in rep.kernel_launches.items():
            merged.kernel_launches[k] = max(v, merged.kernel_launches.get(
                k, 0))
    for field in ("iterations", "host_reads", "ops", "launches",
                  "collectives", "transport_reads", "sync_warnings",
                  "transport_syncs", "peak_delta_bytes"):
        vals = [getattr(rep, field) for rep in ranks
                if getattr(rep, field) is not None]
        if vals:
            setattr(merged, field, max(vals))
    return merged


#: the registered hot programs, the counterparts of the reference's list.
#: ``host_reads``: the loop's one ``bool(repeat)`` (``active.any()`` for a
#: batch) per iteration, none inside a step or a sweep.  ``max_ops``: the
#: aten ops plus launches of one iteration at :data:`CARD_GEOMETRY` (the
#: padded mesh program's, a rank's at :func:`padded_geometry`), pinned at
#: the count an NVIDIA H100 80GB HBM3 (700 W) gave, so that one
#: more op or launch per iteration fails; a loop's count holds its setup
#: over its iterations.  Re-pin from the card's report, deliberately.
HOT_PROGRAMS: Tuple[HotProgram, ...] = (
    # template 84 (K1's wrapper, the channel profiles' rotation, the
    # correction), the cell stage 69 (K2's DFT tables rebuilt every
    # launch, tt_info, the rotated template rows), the scalers 8, the
    # combine 2, K9 6, the loop's cycle check and telemetry rows 34;
    # 6 launches
    HotProgram("clean_loop", _clean_loop, host_reads=1, max_ops=209),
    # the template stage each archive apart (135), the batched cell
    # stage 92, the loop's selects between the frozen and live carries;
    # 6 launches for the whole batch
    HotProgram("clean_loop_batch", _clean_loop_batch, host_reads=1,
               max_ops=303.5),
    # the preamble's per-subint baseline and dedispersion 83, the EW
    # template 19, K6's wrapper 12, the scalers 8, the combine 2;
    # 4 launches
    HotProgram("online_step", _online_step, host_reads=0, max_ops=128),
    # each lane's preamble and template apart (182 + 38), one sweep for
    # both lanes (26); 4 launches
    HotProgram("mux_step", _mux_step, host_reads=0, max_ops=250),
    # K2's and K6's wrappers and the default route's rotated rows 81,
    # the scalers 16, the combines 4; 8 launches
    HotProgram("sweep", _sweep, host_reads=0, max_ops=109),
    # clean_loop's iteration without the loop's own ops, on the bf16
    # builds; 6 launches
    HotProgram("sweep_bf16", _sweep_bf16, host_reads=0, max_ops=175),
    # the tree-reduced scalers 2440 and telemetry median 568 (a bisection
    # of torch ops, ROADMAP section 2 redesign 2), K10's wrapper 69, the
    # combine 2; 2 launches
    HotProgram("sharded_sweep", _sharded_sweep, host_reads=0,
               max_ops=3081),
    # per rank of four gloo ranks on one card (a 2 x 2 mesh, 129 x 513 x
    # 256 blocks of the padded 258 x 1026 grid): the tree-reduced scalers
    # 2560 and telemetry median 598, K10's wrapper 69, the combine 2;
    # 2 launches.  sharded_sweep's sequence, but each of its 175
    # collectives (c10d.allreduce_) stages its operand through host
    # memory and back, two copies where NCCL clones once: 175 more ops
    MeshProgram("mesh_padded_sweep", _padded_sweep, host_reads=0,
                max_ops=3231),
)

#: seeded violations (:func:`seeded`), each with the contract that must
#: catch it
SEEDS = {
    "host-sync": "no-host-sync",
    "f64": "no-f64",
    "extra-op": "dispatch-bound",
    "cube-copy": "no-cube-copy",
    "raise": "verifier-error",
}


def seeded(program: HotProgram, seed: str,
           rank: Optional[int] = None) -> HotProgram:
    """``program`` with a violation seeded into every call (one iteration
    per call for the step and sweep programs): an ``.item()``
    (``host-sync``), a ``.double()`` (``f64``), one extra op
    (``extra-op``), a ``clone()`` of the resident cube (``cube-copy``) or
    an exception at the build (``raise``).  On a :class:`MeshProgram`,
    into rank ``rank`` (default 0) alone."""
    if seed not in SEEDS:
        raise ValueError(f"unknown seed {seed!r} (known: "
                         f"{', '.join(sorted(SEEDS))})")
    if isinstance(program, MeshProgram):
        return dataclasses.replace(program, name=f"{program.name}+{seed}",
                                   seed=seed, seed_rank=rank or 0)
    if rank is not None:
        raise ValueError(f"{program.name} runs on one process: no rank "
                         f"to seed")

    def build(device):
        if seed == "raise":
            raise RuntimeError("seeded failure in the program's build")
        run = program.build(device)
        inner = run.call

        def call():
            result = inner()
            if seed == "host-sync":
                run.probe.sum().item()
            elif seed == "f64":
                run.probe.double()
            elif seed == "extra-op":
                run.probe.neg()
            elif seed == "cube-copy":
                run.cubes[0].clone()
            return result

        return dataclasses.replace(run, call=call)

    return dataclasses.replace(program, name=f"{program.name}+{seed}",
                               build=build)


def verify_program(program: HotProgram, device,
                   decide: Optional[Sequence[str]] = None) -> ProgramReport:
    """Build ``program`` on ``device``, warm it up, record one steady
    call and decide the contracts; a program that raises gives one
    ``verifier-error`` violation.  A :class:`MeshProgram` does this on
    each of its spawned ranks, its reports merged."""
    import torch

    dev = torch.device(device)
    t0 = time.perf_counter()
    if isinstance(program, MeshProgram):
        report = _verify_mesh_program(program, dev, decide)
        report.seconds = time.perf_counter() - t0
        return report
    run = None
    try:
        run = program.build(dev)
        if run.prepare is not None:
            run.prepare()
        run.call()                       # warm-up: builds, plans, caches
        report = record(program, run, dev, decide)
    except Exception as exc:  # the program's verifier-error violation
        report = ProgramReport(program.name, str(dev), violations=[
            ContractViolation(program.name, "verifier-error",
                              f"{type(exc).__name__}: {exc}")])
    finally:
        if run is not None and run.close is not None:
            run.close()
    report.seconds = time.perf_counter() - t0
    return report


def verify_hot_programs(device="cuda",
                        names: Optional[Sequence[str]] = None
                        ) -> List[ProgramReport]:
    """Every registered program's report on ``device`` (``names``: a
    subset).  ``device="cuda"`` on a machine with no card raises: the
    card contracts never fall back to the CPU."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the card contracts need a CUDA device and none is present; "
            "run them on the card, or pass --device cpu for the contracts "
            "the CPU decides")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device!r}")
    reports = []
    for program in HOT_PROGRAMS:
        if names and program.name not in names:
            continue
        reports.append(verify_program(program, dev))
    return reports


def program_named(name: str) -> HotProgram:
    for program in HOT_PROGRAMS:
        if program.name == name:
            return program
    raise KeyError(f"no hot program {name!r} (known: "
                   f"{', '.join(p.name for p in HOT_PROGRAMS)})")
