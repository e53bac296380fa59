"""Time K3's function on scaler lines longer than one block holds, on the
card: the cluster kernel (``sides_cluster.cu``, one thread-block cluster
a line), the long-line composition (``scaled_sides_long``: K9's grid
route for each median and MAD, and the tail kernels ``side_centre`` and
``side_scale``), each tail kernel alone and the plain version; each
beside its bound, and each held bit for bit to the plain version.

    python tools/time_long_sides.py [--shape NSUB NCHAN] [--axis A]
        [--reps N] [--plans C:W:D ...]

Seeded planes of ``--shape`` (default (65536, 128), the single-pulse
archive's channel planes: 128 lines of 65,536 entries along axis 0),
made on the card from seed 0 (20% of the cells masked, NaN and +-inf in
the rFFT diagnostic), in float32 and float64.  CUDA-event means over
``--reps`` back-to-back launches after a warm-up; the bounds are
``telemetry.profiling.kernel_costs``' (K3's ``sides``) and, for the tail
kernels, their own bytes (13 and 9 an entry in float32, 25 and 17 in
float64) over the H100's 3.35 TB/s.  ``--plans C:W:D ...`` also times the
cluster kernel under these plans (C blocks a line, W lines a cluster, D
diagnostics at once; "does not fit" where a block's shared memory cannot
hold the plan), launched through the kernel library, with the planes'
SHA-256 beside the chosen plan's.  Prints one JSON line, with the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
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


def _digest(planes):
    torch.cuda.synchronize()
    h = hashlib.sha256()
    for t in planes:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def _bits_off(got, want):
    """Cells whose bits differ (NaN by position)."""
    kdt = torch.int64 if got.dtype == torch.float64 else torch.int32
    both_nan = torch.isnan(got) & torch.isnan(want)
    return int(((got.view(kdt) != want.view(kdt)) & ~both_nan).sum())


def planes(shape, dtype, dev, seed=0):
    """Four diagnostic planes and a cell mask of ``shape``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    d = [torch.randn(shape, generator=g, device=dev, dtype=dtype) * s
         for s in (1.0, 0.3, 5.0, 2.0)]
    mask = torch.rand(shape, generator=g, device=dev) < 0.2
    d[0][mask] = 0.0
    d[2][mask] = 1e20
    flat = d[3].view(-1)
    flat[[21, 40]] = float("nan")
    flat[22] = float("inf")
    flat[23] = -float("inf")
    return d, mask


def under_plan(K, d, mask, axis, cluster, lines, diags):
    """The cluster kernel at ``cluster`` blocks a line, ``lines`` lines a
    cluster and ``diags`` diagnostics at once (threshold 5), launched
    through the kernel library; None where the plan does not fit."""
    nsub, nchan = mask.shape
    n, nlines, line_stride, elem_stride, lpa, astride = K._sides_lines(
        1, nsub, nchan, axis)
    kb = K._key_bytes(d[0].dtype)
    sl = K._cluster_slice(n, cluster)
    smem = K.scaled_sides_smem(sl, diags, lines, kb)
    if smem + K.sides_cluster_static_smem(kb) > K._SMEM_LIMIT:
        return None
    outs = [torch.empty_like(d[0]) for _ in range(4)]
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())   # noqa: E731
    rc = K.load_library().icln_sides_cluster(
        *map(ptr, d), ptr(mask), *map(ptr, outs), n, sl, nlines,
        line_stride, elem_stride, lpa, astride,
        K._inv_thresh(5.0, d[0].dtype), cluster, lines, diags,
        K._select_threads(lines * sl), smem, int(kb == 8),
        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise SystemExit(f"plan {cluster}:{lines}:{diags}: CUDA error {rc}")
    return outs


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--shape", type=int, nargs=2, default=(65536, 128))
    p.add_argument("--axis", type=int, default=0, choices=(0, 1))
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--plans", nargs="*", default=[], metavar="C:W:D")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_long_sides: no CUDA device present")
    from iterative_cleaner_torch.profile_iteration import device_ops
    from iterative_cleaner_torch.stats import kernels as K
    from iterative_cleaner_torch.telemetry import profiling

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    nsub, nchan = args.shape
    axis = args.axis
    n = nsub if axis == 0 else nchan
    out = {"card": card, "shape": [nsub, nchan], "axis": axis,
           "reps": args.reps}
    for dtype in (torch.float32, torch.float64):
        tag = "f64" if dtype == torch.float64 else "f32"
        rb = 8 if dtype == torch.float64 else 4
        d, mask = planes((nsub, nchan), dtype, dev)
        cells = nsub * nchan
        sides_bound = profiling.bound_ms(
            *profiling.kernel_costs(nsub, nchan, 2, rb)["scaled_sides_axis0"],
            rb == 8)
        plain = K.scaled_sides_plain(d, mask, axis, 5.0)
        calls = {"long": lambda: K.scaled_sides_long(d, mask, axis, 5.0)}
        route = K.scaled_sides_route(n, dtype)
        if route == "cluster":
            calls["cluster"] = lambda: K.scaled_sides_cluster(d, mask, axis,
                                                              5.0)
        res = {"route": route, "bound_ms": sides_bound[0],
               "bound_by": sides_bound[1],
               "plan": (K.scaled_sides_cluster_geometry(n, axis, rb)._asdict()
                        if route == "cluster" else None)}
        for name, fn in calls.items():
            got = fn()
            res[name] = {
                "ms": _ms(fn, args.reps),
                "bits_off": sum(_bits_off(a, b) for a, b in zip(got, plain)),
                "device_ops": sum(device_ops(fn).values()),
                "sha256": _digest(got)}
        res["plain_ms"] = _ms(
            lambda: K.scaled_sides_plain(d, mask, axis, 5.0), 2)
        # the tail kernels on d0 and its K9 median and MAD
        med = K.masked_median(d[0], mask, axis)
        centred, absc, _ = K.side_centre(d[0], mask, med, axis, True)
        mad = K.masked_median(absc, mask, axis)
        for name, fn, nbytes in (
                ("side_centre",
                 lambda: K.side_centre(d[0], mask, med, axis, True),
                 (3 * rb + 1) * cells),
                ("side_scale",
                 lambda: K.side_scale(centred, mask, mad, None, axis, 5.0,
                                      True), (2 * rb + 1) * cells)):
            res[name] = {"ms": _ms(fn, 5 * args.reps),
                         "bound_ms": profiling.bound_ms(nbytes, 0)[0]}
        if args.plans and route == "cluster":
            res["plans"] = {}
            for spec in args.plans:
                c, w, nd = map(int, spec.split(":"))
                fn = lambda c=c, w=w, nd=nd: under_plan(   # noqa: E731
                    K, d, mask, axis, c, w, nd)
                res["plans"][spec] = "does not fit" if fn() is None else {
                    "ms": _ms(fn, args.reps), "sha256": _digest(fn())}
        out[tag] = res
        del d, mask, plain, centred, absc
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
