"""Time the cube kernels on the card: K1, K2, K6, K7 and, where the
package has them, K10 and the cell-sharded clean's tree-reduced selects
on one NCCL rank; then the selects on K2's planes: K3 along both axes,
K8 and K9 (the residual-std telemetry's one line, and along both axes of
the d_std plane); and fingerprint what they compute.

    python tools/time_cell_stats.py [--shape S C B] [--reps N] [--no-selects]
        [--k3-plans W:D ...]

Random inputs of the given shape (default the full-size golden's,
1024 x 4096 x 128), made on the card from seed 0, CUDA-event means over
``--reps`` back-to-back launches after a warm-up, and the SHA-256 of
each kernel's output planes on those inputs.  ``--k3-plans W:D ...``
also times K3 along axis 0 launched straight through the kernel library
at W columns a block and D diagnostics at once, plans the package's
``scaled_sides_geometry`` may not pick (``ms_k3_plans``).  Run it by path
with ``PYTHONPATH`` naming the checkout whose ``iterative_cleaner_torch`` to
time: the same script then times two trees in turns (parent, change,
change, parent) in one call on one card, and equal digests show their
kernels' planes equal bit for bit.  Prints one JSON line, with the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import hashlib
import json
import os
import subprocess
import tempfile

import numpy as np
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


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--shape", type=int, nargs=3, default=(1024, 4096, 128))
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--no-selects", action="store_true",
                   help="skip the sharded selects on one NCCL rank")
    p.add_argument("--k3-plans", nargs="*", default=[], metavar="W:D",
                   help="also time K3 along axis 0 under these plans")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_cell_stats: no CUDA device present")
    import iterative_cleaner_torch
    from iterative_cleaner_torch.engine.loop import nyq_correction_row
    from iterative_cleaner_torch.ops.dsp import rotate_bins
    from iterative_cleaner_torch.stats import kernels as K

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    nsub, nchan, nbin = args.shape
    g = torch.Generator(device=dev).manual_seed(0)
    cube = torch.randn(nsub, nchan, nbin, generator=g, device=dev)
    base = torch.randn(nsub, nchan, nbin, generator=g, device=dev)
    w = (torch.rand(nsub, nchan, generator=g, device=dev) > 0.05).float()
    mask = w == 0
    phase = (torch.arange(nbin, device=dev) + 0.5) / nbin
    t = 1e4 * torch.exp(-0.5 * ((phase - 0.3) / 0.03) ** 2)
    shifts = torch.rand(nchan, generator=g, device=dev) * nbin / 1.5 \
        - nbin / 3
    rot_t = rotate_bins(t.expand(nchan, nbin), shifts,
                        method="fourier").contiguous()
    nyq = nyq_correction_row(shifts, nbin, "fourier", torch.float32)
    window = torch.ones(nbin, device=dev)
    calls = {
        "weighted_marginals": lambda: K.weighted_marginals(cube, w),
        "cell_diagnostics_disp": lambda: K.cell_diagnostics_disp(
            cube, rot_t, nyq, t, w, mask),
        "cell_diagnostics_dedisp": lambda: K.cell_diagnostics_dedisp(
            cube, t, window, w, mask),
        "cell_diagnostics_two_read": lambda: K.cell_diagnostics_two_read(
            cube, base, rot_t, t, w, mask),
    }
    if hasattr(K, "shard_diagnostics_disp"):
        calls["shard_diagnostics_disp"] = lambda: K.shard_diagnostics_disp(
            cube, rot_t, nyq, t, w, mask)
        calls["shard_diagnostics_dedisp"] = \
            lambda: K.shard_diagnostics_dedisp(cube, t, window, w, mask)
    diags = K.cell_diagnostics_disp(cube, rot_t, nyq, t, w, mask)
    line_v, line_m = diags[0].reshape(1, -1), mask.reshape(1, -1)
    selects = {
        "scaled_sides_axis0": lambda: K.scaled_sides(diags, mask, 0, 5.0),
        "scaled_sides_axis1": lambda: K.scaled_sides(diags, mask, 1, 5.0),
        "fused_combine": lambda: K.fused_combine(diags, mask, w, 5.0, 5.0),
        "masked_median_line": lambda: (K.masked_median(line_v, line_m, 1),),
        "masked_median_dim0": lambda: (K.masked_median(diags[0], mask, 0),),
        "masked_median_dim1": lambda: (K.masked_median(diags[0], mask, 1),),
    }
    out = {"card": card, "package": os.path.dirname(
        iterative_cleaner_torch.__file__), "shape": [nsub, nchan, nbin],
        "reps": args.reps,
        "ms": {name: _ms(fn, args.reps) for name, fn in calls.items()},
        "sha256": {name: _digest(fn()) for name, fn in calls.items()}}
    out["ms"].update({name: _ms(fn, 4 * args.reps)
                      for name, fn in selects.items()})
    out["sha256"].update({name: _digest(fn()) for name, fn in selects.items()})
    if args.k3_plans:
        out["ms_k3_plans"], out["sha256_k3_plans"] = {}, {}
        for spec in args.k3_plans:
            fn = functools.partial(_k3_axis0_under, K, diags, mask,
                                   *map(int, spec.split(":")))
            out["ms_k3_plans"][spec] = _ms(fn, 4 * args.reps)
            out["sha256_k3_plans"][spec] = _digest(fn())
    if hasattr(K, "shard_diagnostics_disp") and not args.no_selects:
        out["one_nccl_rank_ms"] = _selects(K.cell_diagnostics_disp(
            cube, rot_t, nyq, t, w, mask), mask, w, args.reps)
    print(json.dumps(out))
    return 0


def _digest(planes):
    """SHA-256 of the output planes' bytes, in order."""
    torch.cuda.synchronize()
    h = hashlib.sha256()
    for t in planes:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def _k3_axis0_under(K, diags, mask, lines, nd):
    """K3 along axis 0 (threshold 5) at ``lines`` columns a block and
    ``nd`` diagnostics at once, launched through the kernel library."""
    n, nchan = mask.shape
    smem = K.scaled_sides_smem(n, nd, lines)
    if smem + K.SELECT_STATIC_SMEM > K._SMEM_LIMIT:
        raise SystemExit(f"K3 plan {lines}:{nd} does not fit a block at "
                         f"{n} subints")
    outs = [torch.empty_like(diags[0]) for _ in range(4)]
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    rc = K.load_library().icln_scaled_sides(
        *map(ptr, diags), ptr(mask), *map(ptr, outs), n, nchan, 1, nchan,
        float(np.float32(1) / np.float32(5.0)), lines, nd,
        K._select_threads(lines * n), smem,
        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise SystemExit(f"K3 plan {lines}:{nd}: CUDA error {rc}")
    return outs


def _selects(diags, mask, w, reps):
    """The sharded clean's post-K10 work on one NCCL rank: each scaler
    orientation's tree-reduced select, the combine, the telemetry
    median."""
    from iterative_cleaner_torch.engine.loop import residual_std
    from iterative_cleaner_torch.parallel import distributed
    from iterative_cleaner_torch.parallel.mesh import cell_mesh
    from iterative_cleaner_torch.parallel.shard_stats import (
        tree_combine_zap,
        tree_scaled_sides,
    )

    with tempfile.TemporaryDirectory() as store:
        distributed.initialize("nccl", f"file://{store}/store",
                               device="cuda:0", rank=0, world_size=1)
        try:
            mesh = cell_mesh()
            return {
                "tree_scaled_sides_axis0": _ms(lambda: tree_scaled_sides(
                    diags, mask, 0, 5.0, mesh), reps),
                "tree_scaled_sides_axis1": _ms(lambda: tree_scaled_sides(
                    diags, mask, 1, 5.0, mesh), reps),
                "tree_combine_zap": _ms(lambda: tree_combine_zap(
                    diags, mask, w, 5.0, 5.0, mesh), reps),
                "residual_std": _ms(lambda: residual_std(
                    diags[0], mask, mesh), reps),
                "all_reduce_int_4x4096": _ms(lambda: mesh.reduce_int(
                    torch.ones(4, 1, 4096, dtype=torch.int32,
                               device="cuda")), 100),
            }
        finally:
            distributed.shutdown()


if __name__ == "__main__":
    raise SystemExit(main())
