"""Time the FFT build of the cell diagnostics (``cell_fft.cu``, K2f) on
the card under every launch plan: each (blocks a cell, threads a block)
whose slices fit a block's shared memory, K2's residual with the Nyquist
term (``cell_fft_disp``), each held to the plain version within 1e-4 of
each plane's scale (1e-12 in float64), beside ``torch.fft.rfft`` alone
on the cube's rows and the plan ``cell_fft_plan`` picks.

    python tools/time_cell_fft.py [--cells NSUB NCHAN] [--nbin N ...]
        [--reps N]

Seeded operands made on the card (seed 0: normal noise, a Gaussian
pulse, 15% of the weights zero), float32 at each ``--nbin`` (default
32768 and 65536) and float64 at the first; CUDA-event means over
``--reps`` back-to-back calls after a warm-up.  Prints one line a plan
and one JSON line, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess

import torch


def _ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _operands(nsub, nchan, nbin, dtype, dev):
    g = torch.Generator(device=dev).manual_seed(0)
    ph = torch.arange(nbin, device=dev, dtype=dtype)
    t = torch.exp(-0.5 * ((ph - nbin / 3) / (nbin / 64)) ** 2)
    cube = torch.randn((nsub, nchan, nbin), generator=g, device=dev,
                       dtype=dtype) + 3.0 * t
    rot = torch.stack([torch.roll(t, 5 * c) for c in range(nchan)])
    nyq = torch.randn((nchan, nbin), generator=g, device=dev,
                      dtype=dtype) * 1e-3
    w = torch.rand((nsub, nchan), generator=g, device=dev, dtype=dtype)
    w = torch.where(w < 0.15, torch.zeros_like(w), w)
    return cube, rot, nyq, t, w, w == 0


def _err(got, want, mask):
    """The largest |got - want| over (|want| + each plane's scale)."""
    return max(float(((g - w).abs() / (w.abs() + w[~mask].abs().max()))
                     .max()) for g, w in zip(got, want))


def main() -> None:
    from iterative_cleaner_torch.stats import kernels as K

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", type=int, nargs=2, default=(8, 256))
    ap.add_argument("--nbin", type=int, nargs="+", default=(32768, 65536))
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    K.load_library()
    chosen_plan = K.cell_fft_plan
    report = []
    cases = [(torch.float32, n) for n in args.nbin]
    cases.append((torch.float64, args.nbin[0]))
    for dtype, nbin in cases:
        ops = _operands(*args.cells, nbin, dtype, dev)
        want = K.cell_diagnostics_disp_plain(*ops, "fft")
        realsize = ops[0].element_size()
        chosen = chosen_plan(nbin, realsize)
        rtol = 1e-12 if realsize == 8 else 1e-4
        most = K.FFT_THREADS_F64 if realsize == 8 else K.FFT_THREADS
        row = {"dtype": str(dtype), "shape": [*args.cells, nbin],
               "chosen": chosen._asdict(), "plans": []}
        for cluster in K.FFT_CLUSTER_SIZES:
            smem = nbin * realsize // cluster
            if smem + K.FFT_STATIC_SMEM > K._SMEM_LIMIT:
                continue
            for threads in (128, 256, 512, 1024):
                if threads > most:
                    continue
                plan = K.CellFftPlan(cluster, chosen.odd, threads, smem)
                K.cell_fft_plan = lambda n, i=4, p=plan: p
                try:
                    err = _err(K.cell_fft_disp(*ops), want, ops[5])
                    ms = _ms(lambda: K.cell_fft_disp(*ops), args.reps)
                finally:
                    K.cell_fft_plan = chosen_plan
                if not err <= rtol:
                    raise SystemExit(f"plan {plan}: error {err:.3e} over "
                                     f"{rtol:g}")
                mark = " (chosen)" if plan == chosen else ""
                print(f"{dtype} {args.cells[0]}x{args.cells[1]}x{nbin} "
                      f"{cluster} block(s) a cell x {threads} threads: "
                      f"{ms:.4f} ms, error {err:.2e}{mark} [{card}]",
                      flush=True)
                row["plans"].append({"cluster": cluster, "threads": threads,
                                     "ms": ms, "err": err})
        row["rfft_ms"] = _ms(lambda: torch.fft.rfft(ops[0], dim=-1),
                             args.reps)
        print(f"{dtype} torch.fft.rfft on the {math.prod(args.cells)} rows "
              f"of {nbin}: {row['rfft_ms']:.4f} ms [{card}]", flush=True)
        report.append(row)
        del ops, want
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "cell_fft": report}))


if __name__ == "__main__":
    main()
