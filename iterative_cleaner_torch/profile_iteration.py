"""Where the time of one full-size clean goes, on the card.

    python -m iterative_cleaner_torch.profile_iteration [--reps 5]
        [--report PATH]

Rebuilds the full-size golden archive (``make_fullsize_archive``, as
``chip_smoke.py`` does), cleans it under the default ``CleanConfig``
and times two whole
``clean_archive`` calls in a row (the first pays the process's one-time
CUDA set-up, the second is warm).  Then it times the phases of
``clean_cube`` one by one: the host's float32 conversion of the cube,
the upload, the preamble, the first iteration, steady iterations (CUDA
events), and the download, all warm.  Then it traces
``--reps`` steady iterations with ``torch.profiler`` and prints the
device time per iteration of every kernel, and the device's busy share
of the iteration's wall time.  Needs a CUDA device; prints the card's
name and power limit beside every number.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from iterative_cleaner_torch.backends import clean_archive
from iterative_cleaner_torch.config import CleanConfig
from iterative_cleaner_torch.engine.loop import iteration_step
from iterative_cleaner_torch.io.synthetic import make_fullsize_archive
from iterative_cleaner_torch.ops.dsp import prepare_cube_integration
from iterative_cleaner_torch.stats import kernels as K


def _events_ms(fn) -> float:
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--report", default="")
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
    cfg = CleanConfig()
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
        out["p"] = prepare_cube_integration(
            cube, weights, torch.tensor(ar.freqs_mhz, dtype=f32, device=dev),
            torch.tensor(ar.dm, dtype=f32, device=dev),
            torch.tensor(ar.centre_freq_mhz, dtype=f32, device=dev),
            torch.tensor(ar.period_s, dtype=f32, device=dev),
            baseline_duty=cfg.baseline_duty)

    phases["preamble_ms"] = _events_ms(preamble)
    disp, shifts, offsets = out["p"]
    mask = weights == 0

    def step():
        out["s"] = iteration_step(disp, weights, weights, mask, shifts,
                                  offsets, chanthresh=cfg.chanthresh,
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
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
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
    report = {"card": card, "phases": phases,
              "profile_wall_ms_per_iter": wall / args.reps,
              "profile_busy_ms_per_iter": busy / args.reps,
              "kernels_ms_per_iter": {n: ms / args.reps for n, ms in rows}}
    if args.report:
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
