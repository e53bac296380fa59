"""Time the FFT build of the cell diagnostics (``cell_fft.cu``, K2f) on
the card.

    python tools/time_cell_fft.py [--label NAME] [--nbin N ...] [--reps N]
    python tools/time_cell_fft.py --plans [--cells NSUB NCHAN]
        [--nbin N ...] [--reps N]
    python tools/time_cell_fft.py --builds [--cells NSUB NCHAN]
        [--nbin N ...] [--reps N]
    python tools/time_cell_fft.py --stages [--cells NSUB NCHAN]
        [--nbin N] [--reps N]
    python tools/time_cell_fft.py --fftg-stages [--label NAME] [--reps N]
    python tools/time_cell_fft.py --fftg-sweep [--reps N]
    python tools/time_cell_fft.py --fftg-cluster-stages [--reps N]

Default: every entry form through its routed wrapper (the plan
``cell_fft_plan`` picks) — K2's residual with the Nyquist term
(``disp``), K6's (``dedisp``) and K7's (``two_read``) — at the shapes
``chip_smoke.py`` (L1) and (L3) run them (the fewest blocks a cell, a
cluster of 8, the radix-3 stage, a batch of two, and 32 x 256 x 65536)
and at the full-width radix-3 and radix-5 shapes 32 x 256 x 24576 and
20480, in float32, bf16 storage and float64 (``--nbin``: those of these
shapes alone), each held to its plain version within 1e-4 of each
plane's scale (1e-12 in float64), beside ``torch.fft.rfft`` alone on the
cube's rows.  It calls only the wrappers, so the same script times
another tree of the package (``PYTHONPATH=<tree>``; ``--label`` names it
in the output): parent and change in one call, in turns.

``--builds``: K2's residual with the Nyquist term through each FFT
build that can run the row, the cluster build K2f (``cell_fft.cu``, at
any odd part 3^a 5^b that fits, past the route's FFT_ODD_STAGES too) and
the device-memory build K2g (``cell_fft_global.cu``, any row), at ``--cells`` x each ``--nbin``
(default 32 x 256 x 24576, 20480, 20000, 46080, 60000 and 65536) in
float32 and float64, each held to its plain version, timed in turns (K2f,
K2g, K2g, K2f), beside ``torch.fft.rfft``: where the route's choice
between the two builds stands.

``--stages``: the (L3) shape (``--cells`` x the first ``--nbin``) in
float32 and float64 with one stage of the kernel switched off at a time:
each variant is a copy of the package in a temporary directory whose
``cell_fft.cu`` has one stage's calls patched out (STAGES; the package
itself is never patched, and a variant's planes are wrong: only its time
is read), built with the FFT sources alone and timed in a process of
its own, in turns with the kernel as built.

``--fftg-stages``: one launch of the device-memory build K2g
(``cell_fft_global.cu``, K2's residual with the Nyquist term) captured
with ``torch.profiler`` at FFTG_STAGE_SHAPES (chip_smoke.py's (L5b),
(L5c) and (L5a) archives' shapes in float32, (L5b) in float64), after a
warm-up: each device kernel of the capture with its launches, its time,
the bytes it moves by the plan (FFTG_BYTES: the cube's reads, the
scratch rows' reads and writes, the tables and the planes) and the GB/s
that follow; beside the launch's CUDA-event time over ``--reps`` calls
and ``torch.fft.rfft``'s on the same rows.  Like the default it calls
only the wrappers and the plan, so it captures another tree of the
package too (``PYTHONPATH=<tree>``).

``--fftg-sweep``: K2g's launch constants, K2's residual with the
Nyquist term timed in turns (the configurations, then reversed), each
held to its plain version first: the passes' tile bytes
(FFTG_TILE_BYTES: 16, 32 and 64 KB, two a block in flight) and threads
a block (FFTG_PASS_THREADS: 128, 256 and 512) at FFTG_SWEEP_SHAPES (the
split rows of (L5c) and (L5a), (L5c) in float64), and the cluster
mode's threads a block (FFTG_CLUSTER_THREADS: 128, 256 and 512) at (L5b)
in float32 and float64; a configuration that gives the same plan as one
before it is timed once.

``--fftg-cluster-stages``: as ``--stages``, for K2g's cluster mode at
(L5b)'s shape (32 x 256 x 65521, float32 and float64): each
FFTG_CLUSTER_STAGES variant patches ``fftg_cluster_impl.cuh`` and
``fft_cluster.cuh`` in a copy of the package, built with K2g's sources
alone and timed through the routed wrapper in a process of its own, in
turns with the kernel as built.

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

# --fftg-cluster-stages: (old, new) text patches of K2g's cluster mode
# (fftg_cluster_impl.cuh, fft_cluster.cuh), each switching one stage's work
# off; the shape, (L5b)'s
FFTG_CLUSTER_STAGES = {
    "as built": (),
    "no cross-cluster steps": tuple(
        (f"if (lc == {c})\n      icln_fft_cross<{c}, R, IclnFftGroup, false>",
         f"if (lc == -{c})\n      icln_fft_cross<{c}, R, IclnFftGroup, false>")
        for c in (1, 2, 3)) + tuple(
        (f"if (lc == {c}) best = icln_fft_cross_inv_max",
         f"if (lc == -{c}) best = icln_fft_cross_inv_max") for c in (1, 2, 3)),
    "no register passes": (
        ("icln_fft_passes<LR, R>(z, lo, hi, a.lt, P, lq, lm);", ";"),
        ("icln_fft_passes_inv<LR, R>(z, lo, hi, a.lt, P, lq, lm);", ";")),
    "no odd stage, B^ and its inverse": (
        ("if (P == 3) icln_fft_odd_mul_inv<3, R>",
         "if (P == -3) icln_fft_odd_mul_inv<3, R>"),),
    "no B^ reads": (("y[t] = icln_cmul(acc, __ldg(bh + base + t));",
                     "y[t] = acc;"),),
    "no chirp reads": (("const C2 w = __ldg(a.chirp + b);",
                        "C2 w;\n        w.x = R(1);\n        w.y = R(0);"),),
    "no residual (the bins as read)": (
        ("res.fitv(v, b, tp, q);\n      if constexpr (kKeep)",
         "tp += v;\n      if constexpr (kKeep)"),
        ("const R r = res.atv(v, b);\n      z[sb].x = r;",
         "const R r = v;\n      z[sb].x = r;")),
    "no cube reads": (("if constexpr (Res::kStaged) v = icln_ldr(x + b);\n"
                       "      res.fitv",
                       "v = R(b);\n      res.fitv"),),
}
FFTG_CLUSTER_STAGE_SHAPE = (32, 256, 65521)

# (batch or 0, nsub, nchan, nbin) by storage: chip_smoke.py's L1_SHAPES,
# then the (L3) archive's shape and the full-width radix-3 and radix-5
# shapes
SHAPES = {
    "float32": ((0, 16, 64, 32768), (0, 8, 32, 65536), (0, 8, 32, 24576),
                (2, 4, 32, 65536), (0, 32, 256, 65536), (0, 32, 256, 24576),
                (0, 32, 256, 20480)),
    "bfloat16": ((0, 16, 64, 32768), (0, 8, 32, 65536), (0, 8, 32, 24576),
                 (2, 4, 32, 65536), (0, 32, 256, 24576), (0, 32, 256, 20480)),
    "float64": ((0, 16, 64, 16384), (0, 8, 32, 32768), (0, 8, 32, 24576),
                (2, 4, 32, 32768), (0, 32, 256, 65536), (0, 32, 256, 24576),
                (0, 32, 256, 20480)),
}
# --builds: the rows' lengths (odd parts 3, 5, 625, 45, 1875 and 1)
BUILD_NBINS = (24576, 20480, 20000, 46080, 60000, 65536)
# --fftg-stages: (label, storage, nsub, nchan, nbin)
FFTG_STAGE_SHAPES = (("L5b", "float32", 32, 256, 65521),
                     ("L5c", "float32", 16, 64, 524288),
                     ("L5a", "float32", 32, 256, 60000),
                     ("L5b", "float64", 32, 256, 65521))
# --fftg-sweep: the passes' shapes (split rows) and the cluster mode's
FFTG_SWEEP_SHAPES = (("L5c", "float32", 16, 64, 524288),
                     ("L5a", "float32", 32, 256, 60000),
                     ("L5c", "float64", 16, 64, 524288))
FFTG_CLUSTER_SHAPES = (("L5b", "float32", 32, 256, 65521),
                       ("L5b", "float64", 32, 256, 65521))
# --fftg-stages: what each K2g kernel moves by the plan, from the
# kernel's name (the first key found in it)
FFTG_BYTES = """
residual: the cube row read three times (the fit; the sum, max and min;
  the centred row), the scratch row written once, the chirp (Bluestein);
pass: each pass's launch reads and writes the chunk's scratch rows once
  (the fused Bluestein pass too, and B^ once);
max: the scratch row read (Bluestein: its first N/2 + 1 values), the
  planes written;
cluster: the cube row read once (twice from bf16 storage), the chirp and
  B^ once (every cell reads them again through L2), the planes written.
"""


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


def time_forms(reps, label, card, nbins=None):
    """The routed wrappers at SHAPES (those of ``nbins`` bins where given)
    against their plain versions, and ``torch.fft.rfft`` on the rows."""
    from iterative_cleaner_torch.stats import kernels as K

    dev = torch.device("cuda")
    rows = []
    for name, shapes in SHAPES.items():
        storage = getattr(torch, name)
        rtol = 1e-12 if storage == torch.float64 else 1e-4
        for nb, nsub, nchan, nbin in shapes:
            if nbins and nbin not in nbins:
                continue
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


def time_builds(cells, nbins, reps, card):
    """K2's residual through K2f (where it can run the row) and K2g at
    ``cells`` x each of ``nbins``, in float32 and float64."""
    from iterative_cleaner_torch.stats import kernels as K

    stages = K.FFT_ODD_STAGES
    routes = {(d, n): K.cell_stats_route(n, d.itemsize)
              for d in (torch.float32, torch.float64) for n in nbins}
    K.FFT_ODD_STAGES = {4: 64, 8: 64}
    K.cell_fft_plan.cache_clear()
    try:
        return _time_builds(cells, nbins, reps, card, routes)
    finally:
        K.FFT_ODD_STAGES = stages
        K.cell_fft_plan.cache_clear()
        K.cell_fft_global_plan.cache_clear()


def _time_builds(cells, nbins, reps, card, routes):
    from iterative_cleaner_torch.stats import kernels as K

    dev = torch.device("cuda")
    report = []
    for dtype in (torch.float32, torch.float64):
        rtol = 1e-12 if dtype == torch.float64 else 1e-4
        for nbin in nbins:
            o = _operands((), *cells, nbin, dtype, dev)
            ops = tuple(o[k] for k in ("cube", "rot", "nyq", "tmpl", "w",
                                       "mask"))
            want = K.cell_diagnostics_disp_plain(*ops, "fft")
            size = ops[0].element_size()
            builds = ["fft_global"]
            if K._cell_fft_takes(nbin, size)[0] is not None:
                builds.insert(0, "fft")
            fns = {b: (lambda b=b: K._counted(
                K.cell_diagnostics_disp, ops[0], "icln_cell_stats_disp", b,
                *K._disp_args(*ops, None))) for b in builds}
            row = {"dtype": str(dtype), "shape": [*cells, nbin],
                   "route": routes[(dtype, nbin)], "ms": {}, "err": {}}
            for b, fn in fns.items():
                row["err"][b] = _err(fn(), want, ops[5])
                if not row["err"][b] <= rtol:
                    raise SystemExit(f"{b} {dtype} {nbin}: error "
                                     f"{row['err'][b]:.3e} over {rtol:g}")
                row["ms"][b] = []
            for b in builds + builds[::-1]:
                row["ms"][b].append(_ms(fns[b], reps))
            row["rfft_ms"] = _ms(lambda: torch.fft.rfft(ops[0], dim=-1), reps)
            print(f"{dtype} {cells[0]}x{cells[1]}x{nbin} (odd part "
                  f"{K._odd_part(nbin)}, routed to {row['route']}): "
                  + ", ".join(f"{'K2f' if b == 'fft' else 'K2g'} "
                              + " / ".join(f"{v:.4f}" for v in row["ms"][b])
                              + " ms" for b in builds)
                  + f", torch.fft.rfft {row['rfft_ms']:.4f} ms [{card}]",
                  flush=True)
            report.append(row)
            del o, ops, want, fns
            torch.cuda.empty_cache()
    return report


def _fftg_kernel_bytes(plan, kind, ncells, nbin, itemsize, realsize):
    """The bytes a K2g kernel of ``kind`` (FFTG_BYTES) moves in a launch
    at ``plan``, all its launches together."""
    cz = 2 * realsize
    cube = ncells * nbin * itemsize
    rows = 3 * nbin * realsize          # the template, rotation, Nyquist
    planes = 4 * ncells * realsize
    mode = plan.mode
    if kind == "cluster":
        reads = 1 if itemsize == realsize else 2
        return reads * cube + rows + (nbin + plan.n) * cz + planes
    chirp = nbin * cz if mode == "bluestein" else 0
    scratch = ncells * plan.n * cz
    if kind == "residual":
        return 3 * cube + rows + scratch + chirp + 3 * ncells * realsize
    if kind == "pass":
        k = len(plan.passes)
        launches = 2 * k - 1 if mode == "bluestein" else k
        chunks = -(-ncells // plan.chunk)
        return launches * 2 * scratch + (
            chunks * plan.n * cz if mode == "bluestein" else 0)
    if kind == "max":
        read = ncells * (nbin // 2 + 1) * cz if mode == "bluestein" \
            else scratch
        return read + ncells * realsize
    return 0


def _kernel_kind(name):
    for kind in ("residual", "pass", "max", "cluster", "bluestein"):
        if kind in name:
            return "cluster" if kind == "bluestein" else kind
    return None


def fftg_stages(reps, label, card):
    """One K2g launch at each FFTG_STAGE_SHAPES shape under
    ``torch.profiler``: its device kernels with time, bytes and GB/s."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from iterative_cleaner_torch.stats import kernels as K

    dev = torch.device("cuda")
    report = []
    for arch, name, nsub, nchan, nbin in FFTG_STAGE_SHAPES:
        storage = getattr(torch, name)
        o = _operands((), nsub, nchan, nbin, storage, dev)
        ops = tuple(o[k] for k in ("cube", "rot", "nyq", "tmpl", "w", "mask"))
        itemsize = ops[0].element_size()
        realsize = 8 if storage == torch.float64 else 4
        if K.cell_stats_route(nbin, itemsize) != "fft_global":
            raise SystemExit(f"{arch} {name}: not K2g's route")
        plan = K.cell_fft_global_plan(nbin, itemsize)

        def run():
            return K.cell_diagnostics_disp(*ops)

        run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        kernels = {}
        for e in prof.events():
            if e.device_type != DeviceType.CUDA:
                continue
            k = kernels.setdefault(e.name, {"launches": 0, "us": 0.0})
            k["launches"] += 1
            k["us"] += e.time_range.elapsed_us()
        ncells = nsub * nchan
        shape = [nsub, nchan, nbin]
        rows = []
        for kname, k in sorted(kernels.items(), key=lambda kv: -kv[1]["us"]):
            kind = _kernel_kind(kname)
            nbytes = _fftg_kernel_bytes(plan, kind, ncells, nbin,
                                        itemsize, realsize) if kind else 0
            ms = k["us"] / 1e3
            gbs = nbytes / (ms * 1e6) if nbytes and ms else None
            rows.append({"kernel": kname, "kind": kind, "ms": ms,
                         "launches": k["launches"], "bytes": nbytes,
                         "gb_s": gbs})
            print(f"{label} {arch} {name} {shape} ({plan.mode}, n "
                  f"{plan.n}): {kname[:90]} x {k['launches']}: {ms:.4f} ms, "
                  + (f"{nbytes / 1e9:.3f} GB by the plan, {gbs:.1f} GB/s"
                     if gbs else "bytes not modelled")
                  + f" [{card}]", flush=True)
        ms = _ms(run, reps)
        rfft_ms = _ms(lambda: torch.fft.rfft(ops[0].to(ops[4].dtype),
                                             dim=-1), reps)
        total = sum(r["ms"] for r in rows)
        print(f"{label} {arch} {name} {shape}: the launch {ms:.4f} ms "
              f"(CUDA events, {reps} calls), its kernels {total:.4f} ms in "
              f"the capture, torch.fft.rfft on the rows {rfft_ms:.4f} ms "
              f"[{card}]", flush=True)
        report.append({"archive": arch, "storage": name, "shape": shape,
                       "plan": plan._asdict(), "ms": ms, "rfft_ms": rfft_ms,
                       "capture_ms": total, "kernels": rows})
        del o, ops
        torch.cuda.empty_cache()
    return report


def fftg_sweep(reps, card):
    """K2g's passes' tile bytes and threads at FFTG_SWEEP_SHAPES, and the
    cluster mode's clusters, passes and threads at FFTG_CLUSTER_SHAPES,
    in turns."""
    from iterative_cleaner_torch.stats import kernels as K

    dev = torch.device("cuda")
    names = ("FFTG_TILE_BYTES", "FFTG_PASS_THREADS", "FFTG_CLUSTER_THREADS")
    saved = {n: getattr(K, n) for n in names}

    def use(cfg):
        for n in names:
            setattr(K, n, cfg.get(n, saved[n]))
        K.cell_fft_global_plan.cache_clear()

    passes = [dict(FFTG_TILE_BYTES=t, FFTG_PASS_THREADS=th)
              for t in (16384, 32768, 65536) for th in (128, 256, 512)]
    cluster = [dict(FFTG_CLUSTER_THREADS={4: th, 8: th})
               for th in (128, 256, 512)]
    report = []
    try:
        for shapes, configs in ((FFTG_SWEEP_SHAPES, passes),
                                (FFTG_CLUSTER_SHAPES, cluster)):
            for arch, name, nsub, nchan, nbin in shapes:
                storage = getattr(torch, name)
                rtol = 1e-12 if storage == torch.float64 else 1e-4
                o = _operands((), nsub, nchan, nbin, storage, dev)
                ops = tuple(o[k] for k in ("cube", "rot", "nyq", "tmpl", "w",
                                           "mask"))
                want = K.cell_diagnostics_disp_plain(*ops)
                runs = []
                for i, cfg in enumerate(configs):
                    use(cfg)
                    plan = K.cell_fft_global_plan(nbin, ops[0].element_size())
                    if any(plan == r["plan"] for r in runs):
                        continue      # the same launch as a config before
                    err = _err(K.cell_diagnostics_disp(*ops), want, ops[5])
                    if not err <= rtol:
                        raise SystemExit(f"{arch} {name} {cfg}: error "
                                         f"{err:.3e} over {rtol:g}")
                    runs.append({"cfg": cfg, "plan": plan, "ms": []})
                for r in runs + runs[::-1]:
                    use(r["cfg"])
                    r["ms"].append(_ms(lambda: K.cell_diagnostics_disp(*ops),
                                       reps))
                for r in runs:
                    p = r["plan"]
                    what = (f"{p.cluster} blocks a cell" if p.mode ==
                            "cluster" else f"tiles of {p.tile} B")
                    print(f"{arch} {name} {[nsub, nchan, nbin]} ({p.mode}): "
                          f"{what}, {p.threads} threads a block: "
                          + " / ".join(f"{v:.4f}" for v in r["ms"])
                          + f" ms [{card}]", flush=True)
                    report.append({"archive": arch, "storage": name,
                                   "shape": [nsub, nchan, nbin],
                                   "plan": p._asdict(), "ms": r["ms"]})
                del o, ops, want
                torch.cuda.empty_cache()
    finally:
        use(saved)
    return report


K2F_SOURCES = ("cell_fft.cu", "fft_cluster.cuh")
K2G_SOURCES = ("fftg_cluster_impl.cuh", "fft_cluster.cuh")


def _variant(root, patches, sources=K2F_SOURCES):
    """A copy of the package under ``root`` with ``patches`` applied to
    ``sources`` (K2f's, ``cell_fft.cu`` and the transform it shares with
    K2g, ``fft_cluster.cuh``, or K2g's: each patch where its text is);
    returns the directory to put on PYTHONPATH."""
    import iterative_cleaner_torch

    src = os.path.dirname(iterative_cleaner_torch.__file__)
    dst = os.path.join(root, "iterative_cleaner_torch")
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns(
        "_build", "__pycache__"))
    csrc = os.path.join(dst, "stats", "csrc")
    texts = {}
    for name in sources:
        with open(os.path.join(csrc, name)) as f:
            texts[name] = f.read()
    for old, new in patches:
        where = [n for n, t in texts.items() if old in t]
        if not where:
            raise SystemExit(f"--stages: {old!r} is not in {sources}")
        for n in where:
            texts[n] = texts[n].replace(old, new)
    for name, text in texts.items():
        with open(os.path.join(csrc, name), "w") as f:
            f.write(text)
    return root


def stage_worker(cells, nbin, reps, build_only, fftg=False):
    """In a variant's process: build the FFT sources alone (``fftg``:
    K2g's), then time K2's FFT build at ``cells`` x ``nbin`` in float32
    and float64 (``fftg``: through the routed wrapper, K2g's)."""
    from iterative_cleaner_torch.stats import kernels as K

    K.SOURCES = ("marginals.cu",) + (
        ("cell_fft_global.cu", "cell_fftg_cluster_f32.cu",
         "cell_fftg_cluster_bf16.cu", "cell_fftg_cluster_f64.cu") if fftg
        else ("cell_fft.cu",))
    K._SIGNATURES = {k: v for k, v in K._SIGNATURES.items()
                     if ("fftg" if fftg else "_fft_") in k}
    K.load_library()
    if build_only:
        return
    dev = torch.device("cuda")
    out = {}
    for storage in (torch.float32, torch.float64):
        o = _operands((), *cells, nbin, storage, dev)
        ops = tuple(o[k] for k in ("cube", "rot", "nyq", "tmpl", "w", "mask"))
        fn = K.cell_diagnostics_disp if fftg else K.cell_fft_disp
        out[str(storage)] = _ms(lambda: fn(*ops), reps)
        del o, ops
        torch.cuda.empty_cache()
    print(json.dumps(out))


def time_stages(cells, nbin, reps, card, fftg=False):
    """Every STAGES variant (``fftg``: FFTG_CLUSTER_STAGES), built in
    parallel, timed one process at a time, in turns: the order, then the
    order reversed."""
    argv = [sys.executable, os.path.abspath(__file__), "--stage-worker",
            "--cells", *map(str, cells), "--nbin", str(nbin), "--reps",
            str(reps)] + (["--fftg-cluster-stages"] if fftg else [])
    stages = FFTG_CLUSTER_STAGES if fftg else STAGES
    with tempfile.TemporaryDirectory() as tmp:
        roots = {name: _variant(os.path.join(tmp, f"v{i}"), patches,
                                K2G_SOURCES if fftg else K2F_SOURCES)
                 for i, (name, patches) in enumerate(stages.items())}
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
    ap.add_argument("--builds", action="store_true")
    ap.add_argument("--stages", action="store_true")
    ap.add_argument("--fftg-stages", action="store_true")
    ap.add_argument("--fftg-sweep", action="store_true")
    ap.add_argument("--fftg-cluster-stages", action="store_true")
    ap.add_argument("--stage-worker", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--build-only", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--cells", type=int, nargs=2)
    ap.add_argument("--nbin", type=int, nargs="+")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--label", default="tree")
    args = ap.parse_args()
    cells = tuple(args.cells or ((32, 256) if args.builds else (8, 256)))
    first = (args.nbin or (32768,))[0]
    if args.fftg_cluster_stages and not args.stage_worker:
        cells, first = FFTG_CLUSTER_STAGE_SHAPE[:2], \
            FFTG_CLUSTER_STAGE_SHAPE[2]
    if args.stage_worker:
        stage_worker(cells, first, args.reps, args.build_only,
                     args.fftg_cluster_stages)
        return
    card = _card()
    print(card, flush=True)
    if args.stages or args.fftg_cluster_stages:
        print(json.dumps({"card": card, "stages": time_stages(
            cells, first, args.reps, card, args.fftg_cluster_stages)}))
        return
    from iterative_cleaner_torch.stats import kernels as K

    K.load_library()
    if args.plans:
        out = {"plans": time_plans(cells, tuple(args.nbin or (32768, 65536)),
                                   args.reps, card)}
    elif args.fftg_sweep:
        out = {"fftg_sweep": fftg_sweep(args.reps, card)}
    elif args.fftg_stages:
        out = {"fftg_stages": fftg_stages(args.reps, args.label, card)}
    elif args.builds:
        out = {"builds": time_builds(cells, tuple(args.nbin or BUILD_NBINS),
                                     args.reps, card)}
    else:
        out = {"forms": time_forms(args.reps, args.label, card, args.nbin)}
    print(json.dumps({"card": card, "label": args.label,
                      "package": K.__file__, **out}))


if __name__ == "__main__":
    main()
