"""Roofline attribution of the port's hot programs on the card, and
on-demand ``torch.profiler`` captures.

The reference reads each compiled program's FLOPs and bytes from XLA's
cost analysis.  The port compiles no programs: its hot paths are
sequences of hand-written kernels, so a program's cost is the
bytes-and-operations model of its kernels at its shapes
(:func:`kernel_costs`, the model of the kernel table's bounds; the
``chip_smoke.py`` bounds read it from here) and its peak bytes are
``torch.cuda.max_memory_allocated`` over its first call.  Measured warm
walltimes then pair with those costs (:func:`record_walltime`) into
achieved-throughput and roofline-fraction gauges of the ordinary metrics
registry:

    prof_flops{program=}          modelled operations per invocation
    prof_bytes{program=}          modelled device bytes per invocation
    prof_peak_bytes{program=}     device peak over its first call
    prof_step_s{program=}         last measured warm walltime
    prof_flops_util{program=}     achieved operations/s over the peak
    prof_hbm_gbps{program=}       achieved device GB/s
    prof_hbm_util{program=}       achieved bandwidth over the peak
    prof_roofline_frac{program=}  achieved operations/s over the roofline
                                  bound min(peak_ops, intensity * peak_bw)

The programs: a fleet bucket's batch iteration (``parallel/batch.
warm_bucket`` captures it, the fleet times it), the online step
(``online_step``) and the mux's dispatch (``mux_step``).  The peaks are
the H100 SXM data sheet's (:data:`DEVICE_PEAKS`, keyed on
``torch.cuda.get_device_name()``); anywhere else the gauges use
:data:`NOMINAL_PEAKS` and ``prof_peak_nominal`` says so.  Cleaning
results never depend on any of this.

:func:`trace_capture` records a ``torch.profiler`` trace (CPU and, on the
card, CUDA activities) of a region into a private temp directory that is
renamed into place after the trace and ``profile_manifest.json`` land:
the CLI's ``--profile-dir`` / ``ICLEAN_PROFILE_DIR`` and, through
:func:`capture_for`, the serve daemon's ``POST /profile?seconds=N``.  One
capture runs at a time; one that cannot start raises.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import sys
import threading
import time
from typing import Dict, Iterator, Optional, Sequence, Tuple

# H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit): HBM3
# bandwidth and the float32 rate outside the tensor cores (the routes run
# no TF32; the selects' integer compares are counted at this rate too).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
# The float64 rate outside the tensor cores (the same data sheet): the
# float64 builds' DFT is DFMA chains, their selects 8 radix passes.
PEAK_F64_PER_S = 34e12

# (float32 operations/s, float64 operations/s, bytes/s) by a substring of
# the lower-cased torch.cuda.get_device_name()
DEVICE_PEAKS = {
    "h100": (PEAK_F32_PER_S, PEAK_F64_PER_S, PEAK_BYTES_PER_S),
}

# Anywhere else (the CPU, another card) the fraction gauges stay defined
# against a nominal host (order of magnitude, clearly not a roofline: the
# prof_peak_nominal gauge says so), the reference's figures.
NOMINAL_PEAKS = (5e10, 2e10)


def device_kind() -> str:
    """The card's name (``torch.cuda.get_device_name``), or ``"cpu"``
    where torch is not loaded or sees no card."""
    torch = sys.modules.get("torch")
    if torch is None:
        return "cpu"
    try:
        if not torch.cuda.is_available():
            return "cpu"
        return str(torch.cuda.get_device_name(torch.cuda.current_device()))
    except Exception:  # noqa: BLE001  # icln: ignore[broad-except] -- an unconfigured runtime degrades the gauges to the nominal peaks, it never fails a clean
        return "cpu"


def device_peaks(kind: Optional[str] = None,
                 dtype: str = "float32") -> Tuple[float, float, bool]:
    """``(peak_ops, peak_bytes_per_s, nominal)`` for ``kind`` (default:
    the current device) and the arithmetic ``dtype`` (float64 counts at
    the FP64 rate); ``nominal`` flags the off-card figures."""
    k = (device_kind() if kind is None else kind).lower()
    for key, (f32, f64, bw) in DEVICE_PEAKS.items():
        if key in k:
            return (f64 if dtype == "float64" else f32), bw, False
    return NOMINAL_PEAKS[0], NOMINAL_PEAKS[1], True


# ------------------------------------------------------ the kernel model

def bound_ms(nbytes: float, nops: float,
             f64: bool = False) -> Tuple[float, str]:
    """The least time of ``nbytes`` moved and ``nops`` done on the H100:
    the larger of the two over their peaks, ``(ms, "bytes" or
    "operations")``."""
    tb = nbytes / PEAK_BYTES_PER_S * 1e3
    to = nops / (PEAK_F64_PER_S if f64 else PEAK_F32_PER_S) * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def kernel_costs(S: int, C: int, B: int,
                 cube_bytes: int = 4) -> Dict[str, Tuple[float, float]]:
    """Each kernel's least work on one S x C x B archive, ``(bytes,
    operations)``: each input read once, each output written once, and
    the fewest operations its function needs.  A batch of N such
    archives costs N times it.  ``cube_bytes``: the bytes of a cube
    element (2 for the bf16 storage mode, every other operand float32; 8
    for float64, whose every operand is float64 and whose selects take 8
    radix passes)."""
    cells, nk = S * C, B // 2 + 1
    cb = cube_bytes
    rb = 8 if cube_bytes == 8 else 4     # a plane element's bytes
    passes = 8 if cube_bytes == 8 else 4
    # The cell diagnostics' least work per cell: the residual, the fit and
    # the moments (about 12 operations a bin), and max_k |rfft(row)|,
    # whose least count is an FFT's: 2.5 B log2 B for a real row (half of
    # a complex FFT's 5 N log2 N) and 4 per k for |X_k|^2 and the max.
    # The kernels' DFT against tables does about 4 B (B/2 + 1) instead.
    diag_ops = cells * (2.5 * B * math.log2(max(B, 2)) + 4 * nk + 12 * B)
    # the weights, the mask and the four output planes
    diag_io = rb * (cells + 4 * cells) + cells
    # the select: `passes` counting passes per median (the radix digits;
    # the upper middle comes from the last pass), 2 medians per diagnostic
    sel_ops = passes * 2 * 4 * cells
    sides = (cells * (4 * rb + 1 + 4 * rb), sel_ops)
    # K4 and K5 are one launch on the TPU: the cube and the template rows
    # in, the weights and mask in, new weights, scores and d_std out
    sweep_io = rb * cells + cells + 3 * rb * cells
    sweep_ops = diag_ops + 2 * sel_ops + 16 * cells
    return {
        "weighted_marginals": (cb * cells * B
                               + rb * (cells + C * B + S * B),
                               3 * cells * B),
        "cell_diagnostics_disp": (cb * cells * B + rb * (2 * C * B + B)
                                  + diag_io, diag_ops),
        "cell_diagnostics_two_read": (cb * 2 * cells * B
                                      + rb * (C * B + B) + diag_io,
                                      diag_ops),
        "cell_diagnostics_dedisp": (cb * cells * B + rb * 2 * B + diag_io,
                                    diag_ops),
        "scaled_sides_axis0": sides,
        "scaled_sides_axis1": sides,
        # the cluster kernel computes K3's function on longer lines
        "scaled_sides_cluster_axis0": sides,
        "scaled_sides_cluster_axis1": sides,
        "combine_zap": (cells * (9 * rb + 2 * rb), 16 * cells),
        # K8: four planes, the mask and the weights in, new weights and
        # scores out; both orientations' selects and the combine
        "fused_combine": (cells * (4 * rb + 1 + rb + 2 * rb),
                          2 * sel_ops + 16 * cells),
        # K9 on the telemetry's line: the values and the mask read once,
        # one value out; `passes` passes of a few integer ops an entry
        "masked_median": ((rb + 1) * cells + rb, passes * 8 * cells),
        "fused_sweep": (cb * cells * B + rb * (2 * C * B + B) + sweep_io,
                        sweep_ops),
        "fused_sweep_dedisp": (cb * cells * B + rb * 2 * B + sweep_io,
                               sweep_ops),
    }


def kernel_bounds(S: int, C: int, B: int,
                  cube_bytes: int = 4) -> Dict[str, Tuple[float, str]]:
    """:func:`kernel_costs` as least times, ``(ms, "bytes" or
    "operations")`` (float64's operations at :data:`PEAK_F64_PER_S`)."""
    f64 = cube_bytes == 8
    return {name: bound_ms(nb, ops, f64)
            for name, (nb, ops) in kernel_costs(S, C, B, cube_bytes).items()}


def program_costs(kernels: Sequence[str], S: int, C: int, B: int, *,
                  cube_bytes: int = 4, batch: int = 1
                  ) -> Tuple[float, float]:
    """``(operations, bytes)`` of one launch of each of ``kernels`` (the
    launch-counter names; a ``_bf16``/``_f64`` suffix names a build of
    the same kernel) on ``batch`` archives of S x C x B."""
    costs = kernel_costs(S, C, B, cube_bytes)
    ops = nbytes = 0.0
    for k in kernels:
        base = k
        for suffix in ("_bf16", "_f64"):
            if base.endswith(suffix):
                base = base[:-len(suffix)]
        nb, n_ops = costs[base]
        ops += batch * n_ops
        nbytes += batch * nb
    return ops, nbytes


# ------------------------------------------------------- program costs

@dataclasses.dataclass(frozen=True)
class ProgramCost:
    """One hot program's modelled cost."""

    program: str
    flops: float           # modelled operations per invocation
    bytes_accessed: float  # modelled device bytes per invocation
    peak_bytes: int        # device peak over its first call (0 if absent)
    alias_bytes: int       # always 0: no buffer is donated on the card
    compile_s: float       # the warm-up's seconds (a library build, if any)
    device_kind: str
    dtype: str = "float32"  # the arithmetic whose peak applies


# Process-global cost table: one warm-up serves many calls (and many
# registries) in a long-lived server.
_COSTS: Dict[str, ProgramCost] = {}
_COSTS_LOCK = threading.Lock()
# an explicit enable (the CLI's --profile-dir, the daemon's profile_dir);
# None defers to ICLEAN_PROFILE_DIR
_ENABLED: Optional[bool] = None


def clear_costs() -> None:
    """Drop every captured program cost (test isolation)."""
    with _COSTS_LOCK:
        _COSTS.clear()


def costs_snapshot() -> Dict[str, dict]:
    """Plain-dict view of the captured costs (``/debug/vars``, capture
    manifests)."""
    with _COSTS_LOCK:
        return {k: dataclasses.asdict(v) for k, v in sorted(_COSTS.items())}


def capture_compiled(program: str, model, registry=None,
                     compile_s: float = 0.0, *, peak_bytes: int = 0,
                     dtype: str = "float32") -> Optional[ProgramCost]:
    """Record one program's modelled cost and publish its static gauges.
    ``model`` is its ``(operations, bytes)`` (:func:`program_costs`), or
    None when it could not be modelled (counted as
    ``prof_capture_errors{program=}``; the gauges stay absent)."""
    from iterative_cleaner_torch.telemetry.registry import labeled

    if model is None:
        if registry is not None:
            registry.counter_inc(
                labeled("prof_capture_errors", program=program))
        return None
    flops, nbytes = (float(v) for v in model)
    cost = ProgramCost(program=program, flops=flops, bytes_accessed=nbytes,
                       peak_bytes=int(peak_bytes), alias_bytes=0,
                       compile_s=float(compile_s),
                       device_kind=device_kind(), dtype=dtype)
    with _COSTS_LOCK:
        _COSTS[program] = cost
    if registry is not None:
        registry.counter_inc(labeled("prof_captures", program=program))
        registry.gauge_set(labeled("prof_flops", program=program), flops)
        registry.gauge_set(labeled("prof_bytes", program=program), nbytes)
        registry.gauge_set(labeled("prof_peak_bytes", program=program),
                           int(peak_bytes))
        if compile_s:
            registry.gauge_set(labeled("prof_compile_s", program=program),
                               float(compile_s))
    return cost


def has_cost(program: str) -> bool:
    """Whether ``program`` has a captured cost."""
    with _COSTS_LOCK:
        return program in _COSTS


def needs_peak(program: str) -> bool:
    """Whether ``program`` is captured but its first call's peak is not
    recorded yet (and profiling is on: measuring it resets the device's
    peak-memory statistics)."""
    with _COSTS_LOCK:
        cost = _COSTS.get(program)
    return cost is not None and not cost.peak_bytes and profiling_enabled()


def record_peak(program: str, peak_bytes: int, registry=None) -> None:
    """Set a captured program's peak bytes (its first call's
    ``torch.cuda.max_memory_allocated``, the statistics reset before)."""
    from iterative_cleaner_torch.telemetry.registry import labeled

    with _COSTS_LOCK:
        cost = _COSTS.get(program)
        if cost is None:
            return
        _COSTS[program] = dataclasses.replace(cost,
                                              peak_bytes=int(peak_bytes))
    if registry is not None:
        registry.gauge_set(labeled("prof_peak_bytes", program=program),
                           int(peak_bytes))


@contextlib.contextmanager
def first_call_peak(program: str, device, registry=None) -> Iterator[None]:
    """Around a program's call: on its first call on the card with
    profiling on, reset the peak-memory statistics before and record
    ``max_memory_allocated`` after (:func:`record_peak`); else nothing."""
    measure = (getattr(device, "type", str(device)) == "cuda"
               and needs_peak(program))
    if measure:
        import torch

        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    yield
    if measure:
        import torch

        torch.cuda.synchronize(device)
        record_peak(program, torch.cuda.max_memory_allocated(device),
                    registry=registry)


def roofline(cost: ProgramCost, seconds: float) -> dict:
    """Achieved throughput and roofline fractions of one measured warm
    walltime of a captured program."""
    fl_peak, bw_peak, nominal = device_peaks(cost.device_kind,
                                             getattr(cost, "dtype",
                                                     "float32"))
    s = max(float(seconds), 1e-9)
    achieved_flops = cost.flops / s
    achieved_bw = cost.bytes_accessed / s
    intensity = cost.flops / max(cost.bytes_accessed, 1.0)
    attainable = min(fl_peak, intensity * bw_peak)
    return {
        "step_s": s,
        "flops_util": achieved_flops / fl_peak,
        "hbm_gbps": achieved_bw / 1e9,
        "hbm_util": achieved_bw / bw_peak,
        "roofline_frac": achieved_flops / max(attainable, 1.0),
        "intensity": intensity,
        "nominal_peaks": nominal,
    }


def record_walltime(program: str, seconds: float,
                    registry=None) -> Optional[dict]:
    """Pair one measured warm walltime with the program's captured cost
    and publish the achieved-throughput and roofline gauges.  None (and
    nothing published) for a program never captured."""
    with _COSTS_LOCK:
        cost = _COSTS.get(program)
    if cost is None:
        return None
    frac = roofline(cost, seconds)
    if registry is not None:
        from iterative_cleaner_torch.telemetry.registry import labeled

        for key in ("step_s", "flops_util", "hbm_gbps", "hbm_util",
                    "roofline_frac"):
            registry.gauge_set(labeled("prof_" + key, program=program),
                               frac[key])
        registry.gauge_set("prof_peak_nominal", float(frac["nominal_peaks"]))
    return frac


def set_enabled(flag: Optional[bool]) -> None:
    """Turn profiling's measurements on or off for this process (None:
    defer to ``ICLEAN_PROFILE_DIR``)."""
    global _ENABLED
    _ENABLED = flag


def profiling_enabled(explicit: Optional[bool] = None) -> bool:
    """Whether the opt-in measurements (a first call's peak, which resets
    the device's peak statistics) run: an explicit caller decision wins,
    then :func:`set_enabled`, else ``ICLEAN_PROFILE_DIR`` being set."""
    if explicit is not None:
        return bool(explicit)
    if _ENABLED is not None:
        return _ENABLED
    return bool(os.environ.get("ICLEAN_PROFILE_DIR"))


# --------------------------------------------------------- trace capture
TRACE_FILE = "trace.json"
MANIFEST = "profile_manifest.json"
_CAPTURE_SEQ = 0
_CAPTURE_SEQ_LOCK = threading.Lock()
# one torch.profiler capture at a time in a process
_CAPTURE_LOCK = threading.Lock()


class CaptureBusy(RuntimeError):
    """A capture is already running in this process."""


_PREPARED = False


def prepare() -> None:
    """Start and stop one empty ``torch.profiler`` trace on this thread,
    once a process: the profiler's tracer is set up on the thread that
    first starts it, and one set up on a thread other than torch's
    importing (main) thread records no CUDA activity (on an H100, a
    first capture started from a side thread held no kernel event, one
    after this held them all).  The serve daemon calls it from its main
    thread at start, since its ``POST /profile`` captures run on HTTP
    handler threads."""
    global _PREPARED
    import torch
    from torch.profiler import ProfilerActivity, profile

    with _CAPTURE_LOCK:
        if _PREPARED:
            return
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
        prof.stop()
        _PREPARED = True


def _next_capture_dir(profile_dir: str) -> str:
    global _CAPTURE_SEQ
    with _CAPTURE_SEQ_LOCK:
        _CAPTURE_SEQ += 1
        n = _CAPTURE_SEQ
    stamp = time.strftime("%Y%m%dT%H%M%S")
    return os.path.join(profile_dir,
                        "capture-%s-%d-%03d" % (stamp, os.getpid(), n))


@contextlib.contextmanager
def trace_capture(profile_dir: str, registry=None,
                  label: str = "capture") -> Iterator[str]:
    """Record a ``torch.profiler`` trace of the wrapped region (CPU
    activities, and CUDA's where a card is present) into a fresh
    subdirectory of ``profile_dir``: ``trace.json`` (Chrome/Perfetto
    trace events) and ``profile_manifest.json`` (the label, seconds, the
    device and the captured program costs) land in a private temp
    directory that one ``os.replace`` publishes.  Yields the final
    (absolute) path.
    Raises :class:`CaptureBusy` while another capture runs, and the
    profiler's own error when it cannot start."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from iterative_cleaner_torch.io.atomic import (
        atomic_output,
        atomic_output_dir,
    )

    if not _CAPTURE_LOCK.acquire(blocking=False):
        raise CaptureBusy("a profile capture is already running")
    try:
        profile_dir = os.path.abspath(profile_dir)
        final = _next_capture_dir(profile_dir)
        os.makedirs(profile_dir, exist_ok=True)
        cuda = torch.cuda.is_available()
        activities = [ProfilerActivity.CPU]
        if cuda:
            activities.append(ProfilerActivity.CUDA)
        with atomic_output_dir(final) as tmp:
            prof = profile(activities=activities)
            prof.start()
            t0 = time.perf_counter()
            try:
                yield final
            finally:
                if cuda:
                    torch.cuda.synchronize()
                prof.stop()
                dt = time.perf_counter() - t0
                prof.export_chrome_trace(os.path.join(tmp, TRACE_FILE))
                manifest = {
                    "label": label,
                    "seconds": round(dt, 6),
                    "device_kind": device_kind(),
                    "trace": TRACE_FILE,
                    "programs": costs_snapshot(),
                }
                with atomic_output(os.path.join(tmp, MANIFEST)) as mtmp:
                    with open(mtmp, "w") as f:
                        json.dump(manifest, f, sort_keys=True, indent=2)
                        f.write("\n")
    finally:
        _CAPTURE_LOCK.release()
    if registry is not None:
        registry.counter_inc("prof_trace_captures")
        registry.gauge_set("prof_trace_capture_s", dt)


def capture_for(profile_dir: str, seconds: float, registry=None,
                label: str = "on-demand") -> str:
    """Blocking on-demand capture: trace ``seconds`` of wall clock
    (whatever the process does meanwhile, on any thread) and return the
    published capture's path: the serve daemon's ``POST /profile``."""
    with trace_capture(profile_dir, registry=registry, label=label) as path:
        time.sleep(float(seconds))
    return path
