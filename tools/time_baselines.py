"""Time the cleaning preamble's baselines on the card.

    python tools/time_baselines.py [--shape NSUB NCHAN NBIN] [--reps N]
        [--label NAME]

At ``--shape`` (default the long-profile archive's 32 x 256 x 65536) in
float32: the profile baseline's offsets (``ops.dsp.baseline_offsets``)
and the integration baseline's (``ops.psrchive_baseline.
baseline_offsets_integration``) alone, then the whole preamble of the
profile-baseline route and of the default route (``engine.loop.prepare``:
the baseline, its removal and the dedispersion rotation), each on a fresh
copy of the cube (the preamble consumes it; the copy is not timed).  It
calls only the package's functions, so the same script times another
tree of the package (``PYTHONPATH=<tree>``; ``--label`` names it in the
output): parent and change in one call, in turns.

Seeded operands made on the card (seed 0: normal noise and a Gaussian
pulse, random weights, 1200-1500 MHz at DM 30, a 3.75 s period);
CUDA-event means over ``--reps`` calls after a warm-up, each call's
events recorded around it alone.  Prints one line a case and one JSON
line, with the card's name and power limit.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch


def _card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _ms(fn, reps, setup=None):
    """The mean of ``reps`` calls' CUDA-event times, ``setup()`` (untimed)
    before each; one untimed call first."""
    fn(setup() if setup else None)
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        arg = setup() if setup else None
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(arg)
        stop.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(stop)
        del arg
    return total / reps


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shape", type=int, nargs=3, default=(32, 256, 65536))
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--label", default="tree")
    args = ap.parse_args()
    card = _card()
    print(card, flush=True)

    from iterative_cleaner_torch.config import CleanConfig
    from iterative_cleaner_torch.engine.loop import prepare
    from iterative_cleaner_torch.ops.dsp import baseline_offsets
    from iterative_cleaner_torch.ops.psrchive_baseline import (
        baseline_offsets_integration,
    )

    nsub, nchan, nbin = args.shape
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    ph = torch.arange(nbin, device=dev, dtype=torch.float32)
    pulse = torch.exp(-0.5 * ((ph - nbin / 3) / (nbin / 64)) ** 2)
    cube = torch.randn((nsub, nchan, nbin), generator=g, device=dev) \
        + 3.0 * pulse
    weights = torch.rand((nsub, nchan), generator=g, device=dev)
    freqs = torch.linspace(1500.0, 1200.0, nchan, device=dev)
    dm, ref, period = (torch.tensor(v, device=dev)
                       for v in (30.0, 1500.0, 3.75))
    cases = {
        "profile baseline offsets":
            (lambda _: baseline_offsets(cube, 0.15), None),
        "integration baseline offsets":
            (lambda _: baseline_offsets_integration(cube, weights, 0.15),
             None),
    }
    for mode, route in (("profile", "two_read (profile baseline)"),
                        ("integration", "default")):
        cfg = CleanConfig(device="cuda", baseline_mode=mode)
        cases[f"preamble, {route} route"] = (
            lambda c, cfg=cfg: prepare(c, weights, freqs, dm, ref, period,
                                       cfg, dedispersed=False),
            cube.clone)
    rows = []
    for name, (fn, setup) in cases.items():
        ms = _ms(fn, args.reps, setup)
        rows.append({"case": name, "ms": ms})
        print(f"{args.label} {name} {nsub}x{nchan}x{nbin}: {ms:.4f} ms "
              f"[{card}]", flush=True)
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "label": args.label,
                      "shape": [nsub, nchan, nbin], "rows": rows}))


if __name__ == "__main__":
    main()
