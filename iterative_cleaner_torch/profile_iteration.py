"""Where the time of one full-size clean goes, on the card.

    python -m iterative_cleaner_torch.profile_iteration [--reps 5]
        [--report PATH] [--baseline_mode profile]
        [--stats_frame dedispersed] [-r FACTOR START END]
        [--stream N [--stream_hbm_mb MB]]

Rebuilds the full-size golden archive (``make_fullsize_archive``, as
``chip_smoke.py`` does), cleans it under ``CleanConfig`` (the default,
or the route the options select) and times two whole
``clean_archive`` calls in a row (the first pays the process's one-time
CUDA set-up, the second is warm).  Then it times the phases of
``clean_cube`` one by one: the host's float32 conversion of the cube,
the upload, the preamble, the first iteration, steady iterations (CUDA
events), and the download, all warm.  Then it traces
``--reps`` steady iterations with ``torch.profiler`` and prints the
device time per iteration of every kernel (K9, the residual-std
telemetry's median, as its ``icln_mm_*`` launches), and the device's
busy share of the iteration's wall time.

With ``--stream N`` it profiles exact streaming in N-subint tiles
instead (``clean_streaming``, budget ``--stream_hbm_mb``, default the
card-sized one): two whole streaming cleans (cold, warm) with the
engine's times and transfers (per-pass spans of the compute stream, H2D
bytes and the copy stream's time), then a third under
``torch.profiler``: device time by kernel and copy within the
iterations, and the device's busy share of the iterations' wall time
(the union of kernel and copy intervals over the
``icln_stream_iteration`` ranges; the profiler's device-side copy of
such a range is an annotation, not work, and is left out).

Needs a CUDA device; prints the card's name and power limit beside
every number.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from iterative_cleaner_torch.backends import clean_archive
from iterative_cleaner_torch.config import CleanConfig
from iterative_cleaner_torch.engine.loop import (
    iteration_step,
    prepare,
    select_route,
)
from iterative_cleaner_torch.io.synthetic import make_fullsize_archive
from iterative_cleaner_torch.parallel.streaming_exact import STREAM_ITERATION
from iterative_cleaner_torch.stats import kernels as K


def _events_ms(fn) -> float:
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop)


def stream_line(gauges) -> str:
    """An exact stream's times and transfers on the card, from the
    engine's registry gauges (``clean_streaming_exact``)."""
    g = gauges
    passes = np.asarray(g["stream_pass_ms_by_iteration"])
    template, diagnostics, combine = passes.mean(axis=0)
    by_iter = np.round(passes, 2).tolist()
    rate = g["stream_h2d_copy_bytes"] / g["stream_h2d_copy_ms"] / 1e6
    return (f"host store {g['stream_host_store_alloc_ms']:.1f} ms, preamble "
            f"{g['stream_prep_ms']:.1f} ms, {g['stream_iteration_ms']:.1f} "
            f"ms per iteration (compute stream, mean: template pass "
            f"{template:.2f}, diagnostics pass {diagnostics:.2f}, combine "
            f"{combine:.2f} ms; by iteration {by_iter}), H2D "
            f"{g['stream_h2d_copy_bytes']} bytes in "
            f"{g['stream_h2d_copy_ms']:.1f} ms of the copy stream "
            f"({rate:.2f} GB/s)")


def _device_work(prof):
    """The kernels and copies of a ``torch.profiler`` trace: its CUDA
    events less the device-side copies of ``record_function`` ranges,
    which span the work they annotate."""
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA \
                or getattr(e, "is_user_annotation", False) \
                or e.name == STREAM_ITERATION:
            continue
        yield e


def device_ops(fn) -> dict:
    """The device operations (kernels, memsets, copies) that one call of
    ``fn`` makes, counted by name in a ``torch.profiler`` trace of it
    (after one untraced call, which builds and loads what it needs)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops = {}
    for e in _device_work(prof):
        ops[e.name] = ops.get(e.name, 0) + 1
    return ops


def _union_ms(intervals) -> float:
    """Length of the union of (start, end) intervals, in ms of us."""
    total, end = 0.0, -float("inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total / 1e3


def profile_stream(ar, cfg, args, card, tag) -> dict:
    """Exact streaming's time on the card: see the module docstring."""
    from torch.profiler import ProfilerActivity, profile

    from iterative_cleaner_torch.parallel import clean_streaming
    from iterative_cleaner_torch.parallel.tile_cache import DictRegistry

    cfg = dataclasses.replace(cfg, stream_hbm_mb=args.stream_hbm_mb)
    runs = {}
    for key in ("cold", "warm"):
        reg = DictRegistry()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        result = clean_streaming(ar, args.stream, cfg, registry=reg)
        torch.cuda.synchronize()
        runs[key] = {"clean_ms": (time.perf_counter() - t0) * 1e3,
                     "loops": result.loops,
                     "peak_mem_gib": torch.cuda.max_memory_allocated()
                     / 2 ** 30, "gauges": reg.gauges,
                     "counters": reg.counters}
        print(f"stream {key}: whole clean {runs[key]['clean_ms']:.1f} ms, "
              f"{result.loops} loops, {stream_line(reg.gauges)}, cube "
              f"uploads {reg.counters['stream_h2d_cube_bytes']} bytes, peak "
              f"device memory {runs[key]['peak_mem_gib']:.2f} GiB {tag}",
              flush=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        clean_streaming(ar, args.stream, cfg)
        torch.cuda.synchronize()
    windows = [(e.time_range.start, e.time_range.end) for e in prof.events()
               if e.name == STREAM_ITERATION
               and e.device_type == torch.autograd.DeviceType.CPU]
    wall = sum(b - a for a, b in windows) / 1e3
    device, per_name = [], {}
    for e in _device_work(prof):
        a, b = e.time_range.start, e.time_range.end
        for w0, w1 in windows:
            lo, hi = max(a, w0), min(b, w1)
            if hi > lo:
                device.append((lo, hi))
                per_name[e.name] = per_name.get(e.name, 0.0) \
                    + (hi - lo) / 1e3
    busy = _union_ms(device)
    n = max(1, len(windows))
    share = 100 * busy / wall if wall else 0.0
    print(f"stream profile: {len(windows)} iterations, wall "
          f"{wall / n:.3f} ms per iteration, device busy (kernels and "
          f"copies, union) {busy / n:.3f} ms ({share:.1f}%) {tag}",
          flush=True)
    rows = sorted(per_name.items(), key=lambda kv: -kv[1])
    for name, ms in rows[:12]:
        print(f"  {ms / n:9.4f} ms/iter  {name[:90]}")
    return {"card": card, "stream_chunk": args.stream,
            "stream_hbm_mb": args.stream_hbm_mb, "runs": runs,
            "profile_wall_ms_per_iter": wall / n,
            "profile_busy_ms_per_iter": busy / n,
            "device_ms_per_iter": {k: v / n for k, v in rows}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--report", default="")
    ap.add_argument("--baseline_mode", default="integration",
                    choices=("integration", "profile"))
    ap.add_argument("--stats_frame", default="auto",
                    choices=("auto", "dispersed", "dedispersed"))
    ap.add_argument("-r", "--pulse_region", nargs=3, type=float,
                    default=[0.0, 0.0, 1.0],
                    help="pulse window as the CLI takes it: factor, start, "
                         "end")
    ap.add_argument("--stream", type=int, default=0,
                    help="profile exact streaming in N-subint tiles")
    ap.add_argument("--stream_hbm_mb", type=float, default=None,
                    help="the tile cache's budget with --stream (MiB)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_iteration: needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    tag = f"[{card}]"
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    K.load_library()

    ar = make_fullsize_archive()
    cfg = CleanConfig(baseline_mode=args.baseline_mode,
                      stats_frame=args.stats_frame,
                      pulse_region=tuple(args.pulse_region))
    route = select_route(cfg, ar.dedispersed)
    print(f"route: {route} {tag}", flush=True)
    if args.stream > 0:
        report = profile_stream(ar, cfg, args, card, tag)
        if args.report:
            with open(args.report, "w") as f:
                json.dump(report, f, indent=1)
        return 0
    phases = {}
    # whole cleans first, so that the first one pays the process's
    # one-time CUDA set-up as a user's first archive does
    for key in ("clean_first_ms", "clean_second_ms"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        clean_archive(ar, cfg)
        torch.cuda.synchronize()
        phases[key] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    host = np.ascontiguousarray(ar.total_intensity(), dtype=np.float32)
    phases["host_convert_ms"] = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cube = torch.from_numpy(host).to(dev)
    weights = torch.from_numpy(
        np.ascontiguousarray(ar.weights, dtype=np.float32)).to(dev)
    torch.cuda.synchronize()
    phases["upload_ms"] = (time.perf_counter() - t0) * 1e3
    f32 = torch.float32
    out = {}

    def preamble():
        out["p"] = prepare(
            cube, weights, torch.tensor(ar.freqs_mhz, dtype=f32, device=dev),
            torch.tensor(ar.dm, dtype=f32, device=dev),
            torch.tensor(ar.centre_freq_mhz, dtype=f32, device=dev),
            torch.tensor(ar.period_s, dtype=f32, device=dev),
            cfg, dedispersed=ar.dedispersed)

    phases["preamble_ms"] = _events_ms(preamble)
    prep = out["p"]
    mask = weights == 0

    def step():
        out["s"] = iteration_step(prep, weights, weights, mask,
                                  chanthresh=cfg.chanthresh,
                                  subintthresh=cfg.subintthresh,
                                  rotation=cfg.rotation,
                                  baseline_duty=cfg.baseline_duty)

    phases["first_iteration_ms"] = _events_ms(step)
    steady = [_events_ms(step) for _ in range(args.reps)]
    phases["iteration_ms_median"] = statistics.median(steady)
    phases["iteration_ms_all"] = steady
    t0 = time.perf_counter()
    out["s"][0].cpu().numpy()
    out["s"][1].cpu().numpy()
    phases["download_ms"] = (time.perf_counter() - t0) * 1e3
    torch.cuda.reset_peak_memory_stats()
    step()
    torch.cuda.synchronize()
    phases["iteration_peak_mem_gib"] = \
        torch.cuda.max_memory_allocated() / 2 ** 30
    for k, v in phases.items():
        if not isinstance(v, list):
            print(f"phase {k}: {v:.3f} {tag}", flush=True)

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = sum(_events_ms(step) for _ in range(args.reps))
    per_kernel = {}
    for e in _device_work(prof):
        us = e.time_range.elapsed_us()
        per_kernel[e.name] = per_kernel.get(e.name, 0.0) + us / 1e3
    busy = sum(per_kernel.values())
    rows = sorted(per_kernel.items(), key=lambda kv: -kv[1])
    print(f"profile: {args.reps} iterations, wall {wall / args.reps:.3f} ms "
          f"per iteration, device busy {busy / args.reps:.3f} ms "
          f"({100 * busy / wall if wall else 0:.1f}%) {tag}", flush=True)
    for name, ms in rows[:12]:
        print(f"  {ms / args.reps:9.4f} ms/iter {100 * ms / busy:5.1f}%  "
              f"{name[:90]}")
    report = {"card": card, "route": route, "phases": phases,
              "profile_wall_ms_per_iter": wall / args.reps,
              "profile_busy_ms_per_iter": busy / args.reps,
              "kernels_ms_per_iter": {n: ms / args.reps for n, ms in rows}}
    if args.report:
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
