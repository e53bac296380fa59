"""Time the FFT build of the cell diagnostics (``cell_fft.cu``, K2f) on
the card.

    python tools/time_cell_fft.py [--label NAME] [--reps N]
    python tools/time_cell_fft.py --plans [--cells NSUB NCHAN]
        [--nbin N ...] [--reps N]
    python tools/time_cell_fft.py --stages [--cells NSUB NCHAN]
        [--nbin N] [--reps N]

Default: every entry form through its routed wrapper (the plan
``cell_fft_plan`` picks) — K2's residual with the Nyquist term
(``disp``), K6's (``dedisp``) and K7's (``two_read``) — at the shapes
``chip_smoke.py`` (L1) and (L3) run them (the fewest blocks a cell, a
cluster of 8, the radix-3 stage, a batch of two, and 32 x 256 x 65536)
and at the full-width radix-3 shape 32 x 256 x 24576, in float32, bf16
storage and float64, each held to its plain version within 1e-4 of
each plane's scale (1e-12 in float64), beside ``torch.fft.rfft`` alone
on the cube's rows.  It calls only the wrappers, so the same script
times another tree of the package (``PYTHONPATH=<tree>``; ``--label``
names it in the output): parent and change in one call, in turns.

``--stages``: the (L3) shape (``--cells`` x the first ``--nbin``) in
float32 and float64 with one stage of the kernel switched off at a time:
each variant is a copy of the package in a temporary directory whose
``cell_fft.cu`` has one stage's calls patched out (STAGES; the package
itself is never patched, and a variant's planes are wrong: only its time
is read), built with the FFT sources alone and timed in a process of
its own, in turns with the kernel as built.

``--plans``: every launch plan (blocks a cell, 128 or 256 threads a
block) whose slices fit a block's shared memory, K2's residual with the
Nyquist term
(``cell_fft_disp``), at ``--cells`` x each ``--nbin`` (default 8 x 256 x
32768 and 65536) in float32 and float64, beside the plan
``cell_fft_plan`` picks.

Seeded operands made on the card (seed 0: normal noise, a Gaussian
pulse, 15% of the weights zero); CUDA-event means over ``--reps``
back-to-back calls after a warm-up.  Prints one line a case and one JSON
line, with the card's name and power limit.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile

import torch

# --stages: (old, new) text patches of cell_fft.cu, each switching one
# stage's work off (or, for the last two, another order of the launch's
# cells); every old text must be in the source
_PASSES = tuple((f"if (lr == {r}) icln_fft_pass", f"if (lr == -{r}) "
                 f"icln_fft_pass") for r in (1, 2, 3))
STAGES = {
    "as built": (),
    "no split": ((
        "R best = icln_fft_split<R>(grp, z, lo, hi, a.lt, P, lq, lm, rank);",
        "R best = z[tid].x;"),),
    "no cross-cluster step": tuple(
        (f"if (lc == {c}) icln_fft_cross", f"if (lc == -{c}) icln_fft_cross")
        for c in (1, 2, 3)),
    "no local passes": _PASSES,
    "no twiddle reads": ((
        "return icln_cmul(hi[icln_swz<S>(e >> lt)], "
        "lo[icln_swz<S>(e & ((1 << lt) - 1))]);", "return lo[e & 1];"),),
    "no residual (the row as read)": (
        ("zc.x = res.atv(v0, b);", "zc.x = v0;"),
        ("zc.y = res.atv(v1, b + 1);", "zc.y = v1;")),
    "no cube reads": (("v0 = icln_ldr(x + b);", "v0 = R(b);"),
                      ("v1 = icln_ldr(x + b + 1);", "v1 = R(c);")),
    "no L2 prefetch of the next cell": ((
        'asm volatile("prefetch.global.L2 [%0];" ::"l"(nx + o));', ";"),),
    "cells in the other dtype's order": (
        ("#define ICLN_FFT_CHAN_BLOCK_F32 1",
         "#define ICLN_FFT_CHAN_BLOCK_F32 8"),
        ("#define ICLN_FFT_CHAN_BLOCK_F64 8",
         "#define ICLN_FFT_CHAN_BLOCK_F64 1")),
    "cells in (subint, channel) order": (
        ("#define ICLN_FFT_CHAN_BLOCK_F32 1",
         "#define ICLN_FFT_CHAN_BLOCK_F32 (1 << 30)"),
        ("#define ICLN_FFT_CHAN_BLOCK_F64 8",
         "#define ICLN_FFT_CHAN_BLOCK_F64 (1 << 30)")),
}

# (batch or 0, nsub, nchan, nbin) by storage: chip_smoke.py's L1_SHAPES,
# then the (L3) archive's shape and the full-width radix-3 shape
SHAPES = {
    "float32": ((0, 16, 64, 32768), (0, 8, 32, 65536), (0, 8, 32, 24576),
                (2, 4, 32, 65536), (0, 32, 256, 65536), (0, 32, 256, 24576)),
    "bfloat16": ((0, 16, 64, 32768), (0, 8, 32, 65536), (0, 8, 32, 24576),
                 (2, 4, 32, 65536), (0, 32, 256, 24576)),
    "float64": ((0, 16, 64, 16384), (0, 8, 32, 32768), (0, 8, 32, 24576),
                (2, 4, 32, 32768), (0, 32, 256, 65536), (0, 32, 256, 24576)),
}


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


def _operands(lead, nsub, nchan, nbin, storage, dev):
    real = torch.float64 if storage == torch.float64 else torch.float32
    g = torch.Generator(device=dev).manual_seed(0)
    ph = torch.arange(nbin, device=dev, dtype=real)
    t = torch.exp(-0.5 * ((ph - nbin / 3) / (nbin / 64)) ** 2)
    cube = (torch.randn(lead + (nsub, nchan, nbin), generator=g, device=dev,
                        dtype=real) + 3.0 * t).to(storage)
    rot = torch.stack([torch.roll(t, 5 * c) for c in range(nchan)])
    rot = rot.expand(lead + rot.shape).contiguous()
    nyq = torch.randn(lead + (nchan, nbin), generator=g, device=dev,
                      dtype=real) * 1e-3
    w = torch.rand(lead + (nsub, nchan), generator=g, device=dev, dtype=real)
    w = torch.where(w < 0.15, torch.zeros_like(w), w)
    win = torch.ones(nbin, device=dev, dtype=real)
    win[nbin // 4: nbin // 3] = 0.5
    return dict(cube=cube, base=(cube.to(real) * 0.5).to(storage), rot=rot,
                nyq=nyq, tmpl=t.expand(lead + (nbin,)).contiguous(), w=w,
                mask=w == 0, win=win)


def _err(got, want, mask):
    """The largest |got - want| over (|want| + each plane's scale)."""
    return max(float(((g - w).abs() / (w.abs() + w[~mask].abs().max()))
                     .max()) for g, w in zip(got, want))


def _card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_forms(reps, label, card):
    """The routed wrappers at SHAPES against their plain versions, and
    ``torch.fft.rfft`` on the rows."""
    from iterative_cleaner_torch.stats import kernels as K

    dev = torch.device("cuda")
    rows = []
    for name, shapes in SHAPES.items():
        storage = getattr(torch, name)
        rtol = 1e-12 if storage == torch.float64 else 1e-4
        for nb, nsub, nchan, nbin in shapes:
            o = _operands((nb,) if nb else (), nsub, nchan, nbin, storage, dev)
            c, b, r, n, t, w, m, win = (o[k] for k in (
                "cube", "base", "rot", "nyq", "tmpl", "w", "mask", "win"))
            forms = {
                "disp": (lambda: K.cell_diagnostics_disp(c, r, n, t, w, m),
                         lambda: K.cell_diagnostics_disp_plain(
                             c, r, n, t, w, m)),
                "dedisp": (lambda: K.cell_diagnostics_dedisp(c, t, win, w, m),
                           lambda: K.cell_diagnostics_dedisp_plain(
                               c, t, win, w, m)),
                "two_read": (lambda: K.cell_diagnostics_two_read(
                    c, b, r, t, w, m),
                    lambda: K.cell_diagnostics_two_read_plain(
                        c, b, r, t, w, m)),
            }
            shape = [nb or 1, nsub, nchan, nbin]
            for form, (kfn, pfn) in forms.items():
                err = _err(kfn(), pfn(), m)
                if not err <= rtol:
                    raise SystemExit(f"{form} {name} {shape}: error "
                                     f"{err:.3e} over {rtol:g}")
                ms = _ms(kfn, reps)
                rows.append({"form": form, "storage": name, "shape": shape,
                             "ms": ms, "err": err})
                print(f"{label} {form} {name} {shape}: {ms:.4f} ms, error "
                      f"{err:.2e} [{card}]", flush=True)
            rfft_ms = _ms(lambda: torch.fft.rfft(c.to(w.dtype), dim=-1), reps)
            rows.append({"form": "rfft", "storage": name, "shape": shape,
                         "ms": rfft_ms})
            print(f"{label} torch.fft.rfft {name} {shape}: {rfft_ms:.4f} ms "
                  f"[{card}]", flush=True)
            del o, forms
            torch.cuda.empty_cache()
    return rows


def time_plans(cells, nbins, reps, card):
    """Every plan of K2's FFT build at ``cells`` x each of ``nbins``."""
    from iterative_cleaner_torch.stats import kernels as K

    dev = torch.device("cuda")
    chosen_plan = K.cell_fft_plan
    report = []
    cases = [(dt, n) for dt in (torch.float32, torch.float64)
             for n in nbins]
    for dtype, nbin in cases:
        o = _operands((), *cells, nbin, dtype, dev)
        ops = tuple(o[k] for k in ("cube", "rot", "nyq", "tmpl", "w", "mask"))
        want = K.cell_diagnostics_disp_plain(*ops, "fft")
        realsize = ops[0].element_size()
        chosen = chosen_plan(nbin, realsize)
        rtol = 1e-12 if realsize == 8 else 1e-4
        row = {"dtype": str(dtype), "shape": [*cells, nbin],
               "chosen": chosen._asdict(), "plans": []}
        for cluster in K.FFT_CLUSTER_SIZES:
            smem = K._fft_smem(nbin, cluster, realsize)
            if not K._fft_fits(nbin, cluster, realsize):
                continue
            for threads in (128, 256):
                plan = K.CellFftPlan(cluster, chosen.odd, threads, smem)
                K.cell_fft_plan = lambda n, i=4, p=plan: p
                try:
                    err = _err(K.cell_fft_disp(*ops), want, ops[5])
                    ms = _ms(lambda: K.cell_fft_disp(*ops), reps)
                finally:
                    K.cell_fft_plan = chosen_plan
                if not err <= rtol:
                    raise SystemExit(f"plan {plan}: error {err:.3e} over "
                                     f"{rtol:g}")
                mark = " (chosen)" if plan == chosen else ""
                print(f"{dtype} {cells[0]}x{cells[1]}x{nbin} "
                      f"{cluster} block(s) a cell x {threads} threads: "
                      f"{ms:.4f} ms, error {err:.2e}{mark} [{card}]",
                      flush=True)
                row["plans"].append({"cluster": cluster, "threads": threads,
                                     "ms": ms, "err": err})
        row["rfft_ms"] = _ms(lambda: torch.fft.rfft(ops[0], dim=-1), reps)
        print(f"{dtype} torch.fft.rfft on the {math.prod(cells)} rows "
              f"of {nbin}: {row['rfft_ms']:.4f} ms [{card}]", flush=True)
        report.append(row)
        del o, ops, want
        torch.cuda.empty_cache()
    return report


def _variant(root, patches):
    """A copy of the package under ``root`` with ``patches`` applied to
    its cell_fft.cu; returns the directory to put on PYTHONPATH."""
    import iterative_cleaner_torch

    src = os.path.dirname(iterative_cleaner_torch.__file__)
    dst = os.path.join(root, "iterative_cleaner_torch")
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns(
        "_build", "__pycache__"))
    path = os.path.join(dst, "stats", "csrc", "cell_fft.cu")
    with open(path) as f:
        text = f.read()
    for old, new in patches:
        if old not in text:
            raise SystemExit(f"--stages: {old!r} is not in cell_fft.cu")
        text = text.replace(old, new)
    with open(path, "w") as f:
        f.write(text)
    return root


def stage_worker(cells, nbin, reps, build_only):
    """In a variant's process: build the FFT sources alone, then time
    K2's FFT build at ``cells`` x ``nbin`` in float32 and float64."""
    from iterative_cleaner_torch.stats import kernels as K

    K.SOURCES = ("marginals.cu", "cell_fft.cu")
    K._SIGNATURES = {k: v for k, v in K._SIGNATURES.items()
                     if "_fft_" in k}
    K.load_library()
    if build_only:
        return
    dev = torch.device("cuda")
    out = {}
    for storage in (torch.float32, torch.float64):
        o = _operands((), *cells, nbin, storage, dev)
        ops = tuple(o[k] for k in ("cube", "rot", "nyq", "tmpl", "w", "mask"))
        out[str(storage)] = _ms(lambda: K.cell_fft_disp(*ops), reps)
        del o, ops
        torch.cuda.empty_cache()
    print(json.dumps(out))


def time_stages(cells, nbin, reps, card):
    """Every STAGES variant, built in parallel, timed one process at a
    time, in turns: the order, then the order reversed."""
    argv = [sys.executable, os.path.abspath(__file__), "--stage-worker",
            "--cells", *map(str, cells), "--nbin", str(nbin), "--reps",
            str(reps)]
    with tempfile.TemporaryDirectory() as tmp:
        roots = {name: _variant(os.path.join(tmp, f"v{i}"), patches)
                 for i, (name, patches) in enumerate(STAGES.items())}
        env = lambda r: {**os.environ, "PYTHONPATH": r}  # noqa: E731
        builds = [subprocess.Popen(argv + ["--build-only"], env=env(r))
                  for r in roots.values()]
        if any(b.wait() for b in builds):
            raise SystemExit("--stages: a variant failed to build")
        times = {name: [] for name in roots}
        for name in list(roots) + list(roots)[::-1]:
            run = subprocess.run(argv, env=env(roots[name]),
                                 capture_output=True, text=True, check=True)
            times[name].append(json.loads(run.stdout.strip().splitlines()[-1]))
    report = {}
    for name, runs in times.items():
        report[name] = {k: [r[k] for r in runs] for k in runs[0]}
        print(f"{name}: " + ", ".join(
            f"{k.replace('torch.', '')} " + " / ".join(f"{v:.4f}" for v in vs)
            + " ms" for k, vs in report[name].items())
            + f" at {cells[0]} x {cells[1]} x {nbin} [{card}]", flush=True)
    return report


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--plans", action="store_true")
    ap.add_argument("--stages", action="store_true")
    ap.add_argument("--stage-worker", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--build-only", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--cells", type=int, nargs=2, default=(8, 256))
    ap.add_argument("--nbin", type=int, nargs="+", default=(32768, 65536))
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--label", default="tree")
    args = ap.parse_args()
    if args.stage_worker:
        stage_worker(tuple(args.cells), args.nbin[0], args.reps,
                     args.build_only)
        return
    card = _card()
    print(card, flush=True)
    if args.stages:
        print(json.dumps({"card": card, "stages": time_stages(
            tuple(args.cells), args.nbin[0], args.reps, card)}))
        return
    from iterative_cleaner_torch.stats import kernels as K

    K.load_library()
    if args.plans:
        out = {"plans": time_plans(tuple(args.cells), tuple(args.nbin),
                                   args.reps, card)}
    else:
        out = {"forms": time_forms(args.reps, args.label, card)}
    print(json.dumps({"card": card, "label": args.label,
                      "package": K.__file__, **out}))


if __name__ == "__main__":
    main()
