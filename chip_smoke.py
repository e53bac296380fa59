"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout:

    python3 chip_smoke.py

In order, it: prints the card; builds the CUDA kernels from the sources
in the checkout; rebuilds the full-size (1024 x 4096 x 128, seed 0,
integration baseline) golden archive with the port's synthetic generator
and cleans it through ``clean_archive`` on the card with every kernel
launch count set to 0 just before and read just after (each kernel of
the route must have launched); holds the mask against
``tests/goldens/fullsize_mask.npz`` under the golden's flip rule; holds
every kernel against its plain PyTorch version on the card at the shapes
that clean gives it; times each kernel, its plain version and the
library yardstick beside the least time the card could take; prints one
JSON line with the kernels and, last, ``{"ok": true, "device": ...}``.

It exits non-zero, printing no result, when no CUDA device is present
or when the port's package is not beside it.  It imports nothing of JAX
or of the reference package.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDENS = os.path.join(HERE, "tests", "goldens")

# The golden's flip rule (the reference harness benchmarks/fullsize_golden.py):
# a float32 run may flip only cells the float64 oracle scored within the
# borderline band, each within FLIP_NOISE_ENV of the threshold, at most
# MAX_BORDERLINE_FLIPS of them, with the oracle's loop count.
MAX_BORDERLINE_FLIPS = 10
FLIP_NOISE_ENV = 0.01

# H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit): HBM3
# bandwidth and the float32 rate outside the tensor cores (TF32 is off on
# this route; the selects' integer compares are counted at this rate too).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12

# Tolerances of the kernel checks (see tests/test_torch_kernels.py):
K1_RTOL = 1e-5   # of sum |w * disp|: float32 sums in another order
K2_RTOL = 1e-4   # of each plane's scale: float32 reassociation; masked exact


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def flip_verdict(flips, golden) -> dict:
    """Classify mask flips against the golden's borderline band."""
    border = {(i, c): s for i, c, s in golden["borderline"]}
    rogue, wide = [], []
    for i, c in flips:
        key = (int(i), int(c))
        if key not in border:
            rogue.append(key)
        elif abs(border[key] - 1.0) > FLIP_NOISE_ENV:
            wide.append(key)
    over_cap = len(flips) > MAX_BORDERLINE_FLIPS
    return {"rogue": rogue, "wide": wide, "over_cap": over_cap,
            "ok": not rogue and not wide and not over_cap}


def cuda_ms(fn, reps: int, torch) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls, by
    CUDA events, after one warm-up call."""
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


def bits_mismatch(got, want, torch) -> int:
    """Cells whose float32 bits differ, NaN matching NaN."""
    nan_g, nan_w = torch.isnan(got), torch.isnan(want)
    same = (got.view(torch.int32) == want.view(torch.int32)) | (nan_g & nan_w)
    return int((~same).sum())


def max_abs_diff(got, want, torch) -> float:
    """Largest |got - want| over cells, equal values (inf included) and
    NaN against NaN counting 0, NaN against a number counting inf."""
    same = (got == want) | (torch.isnan(got) & torch.isnan(want))
    diff = torch.nan_to_num((got - want).abs(), nan=float("inf"))
    return float(torch.where(same, torch.zeros_like(diff), diff).max())


def main() -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args()

    if not os.path.isdir(os.path.join(HERE, "iterative_cleaner_torch")):
        fail("the iterative_cleaner_torch package is not beside this script")
    if not os.path.isdir(GOLDENS):
        fail("tests/goldens is not beside this script")
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device present")
    sys.path.insert(0, HERE)
    from iterative_cleaner_torch import CleanConfig
    from iterative_cleaner_torch.backends import clean_archive
    from iterative_cleaner_torch.engine.loop import (
        build_template,
        iteration_step,
        nyq_correction_row,
    )
    from iterative_cleaner_torch.io.synthetic import (
        FULLSIZE_SHAPE,
        make_fullsize_archive,
    )
    from iterative_cleaner_torch.ops.dsp import (
        prepare_cube_integration,
        rotate_bins,
        weighted_marginal_totals,
    )
    from iterative_cleaner_torch.stats import kernels as K

    t_start = time.perf_counter()
    card = card_line()
    tag = f"[{card}]"
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)",
          flush=True)

    # ---- 1. build the kernels from source ----
    t0 = time.perf_counter()
    lib_path = K.build_library()
    K.load_library()
    build_s = time.perf_counter() - t0
    print(f"build: {os.path.relpath(lib_path, HERE)} in {build_s:.1f} s",
          flush=True)
    log_path = os.path.join(K.BUILD_DIR, "build.log")
    if os.path.exists(log_path):
        for line in open(log_path):
            if "registers" in line or "spill" in line or line.startswith("=="):
                print("  " + line.strip())

    # ---- 2. the main path, counted: full-size archive through clean_archive
    NSUB, NCHAN, NBIN = FULLSIZE_SHAPE
    t0 = time.perf_counter()
    ar = make_fullsize_archive()
    print(f"archive: {NSUB}x{NCHAN}x{NBIN} rebuilt in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    cfg = CleanConfig()  # the default configuration, on the card
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    result = clean_archive(ar, cfg)
    torch.cuda.synchronize()
    clean_ms = (time.perf_counter() - t0) * 1e3
    counts = K.launch_counts()
    print("kernels: " + json.dumps(counts), flush=True)
    not_launched = [k for k, v in counts.items() if v < 1]
    if not_launched:
        fail(f"kernels of the main path never launched: {not_launched}")

    # ---- 3. what came out is right: the full-size golden ----
    with open(os.path.join(GOLDENS, "fullsize_mask_golden.json")) as f:
        golden = json.load(f)
    with np.load(os.path.join(GOLDENS, "fullsize_mask.npz")) as z:
        want_zap = np.unpackbits(z["zap"])[: NSUB * NCHAN].reshape(
            NSUB, NCHAN).astype(bool)
    fw = result.final_weights
    if fw.shape != (NSUB, NCHAN) or not np.all(np.isfinite(fw)):
        fail(f"final weights malformed: shape {fw.shape}")
    got_zap = fw == 0
    flips = np.argwhere(want_zap != got_zap)
    verdict = flip_verdict(flips, golden)
    golden_ok = (verdict["ok"] and result.loops == golden["loops"]
                 and result.converged == golden["converged"])
    print(f"golden: loops {result.loops} (want {golden['loops']}), converged "
          f"{result.converged}, zapped {int(got_zap.sum())} (want "
          f"{golden['zap_cells']}), flips {len(flips)} (cap "
          f"{MAX_BORDERLINE_FLIPS}), rogue {verdict['rogue'][:5]}, wide "
          f"{verdict['wide'][:5]}", flush=True)
    if not golden_ok:
        fail("full-size mask outside the golden's flip rule")

    # ---- 4. each kernel against its plain version, at the main path's
    # shapes: the first iteration's inputs of the same archive ----
    def upload(a):
        return torch.from_numpy(
            np.ascontiguousarray(a, dtype=np.float32)).to(dev, copy=True)

    weights = upload(ar.weights)
    mask = weights == 0
    f32 = torch.float32
    disp, shifts, offsets = prepare_cube_integration(
        upload(ar.total_intensity()), weights, upload(ar.freqs_mhz),
        torch.tensor(ar.dm, dtype=f32, device=dev),
        torch.tensor(ar.centre_freq_mhz, dtype=f32, device=dev),
        torch.tensor(ar.period_s, dtype=f32, device=dev),
        baseline_duty=cfg.baseline_duty)
    template = build_template(disp, weights, shifts, offsets,
                              rotation=cfg.rotation,
                              baseline_duty=cfg.baseline_duty)
    rot_t = rotate_bins(template.expand(NCHAN, NBIN), shifts,
                        method=cfg.rotation).contiguous()
    nyq = nyq_correction_row(shifts, NBIN, cfg.rotation, f32)
    torch.cuda.synchronize()

    # K1
    a, t1 = K.weighted_marginals(disp, weights)
    pa, pt1 = weighted_marginal_totals(disp, weights)
    sa, st1 = weighted_marginal_totals(disp.abs(), weights.abs())
    err1 = max(float((a - pa).abs().max()), float((t1 - pt1).abs().max()))
    ok1 = bool(((a - pa).abs() <= K1_RTOL * sa).all()
               and ((t1 - pt1).abs() <= K1_RTOL * st1).all())
    print(f"check K1 weighted_marginals: max abs {err1:.3e}, tolerance "
          f"{K1_RTOL:g} * sum|w*disp|: {'ok' if ok1 else 'FAIL'}")
    del pa, pt1, sa, st1

    # K2
    diags = K.cell_diagnostics_disp(disp, rot_t, nyq, template, weights, mask)
    plain = K.cell_diagnostics_disp_plain(
        disp, rot_t, nyq, template, weights, mask)
    err2, ok2 = 0.0, True
    for name, g, w in zip(("std", "mean", "ptp", "fft"), diags, plain):
        scale = float(w[~mask].abs().max())
        diff = (g - w).abs()
        err2 = max(err2, float(diff.max()))
        ok2 &= bool((diff <= K2_RTOL * (w.abs() + scale)).all())
        ok2 &= bits_mismatch(g[mask], w[mask], torch) == 0
    print(f"check K2 cell_diagnostics_disp: max abs {err2:.3e}, tolerance "
          f"rtol {K2_RTOL:g} of each plane's scale, masked cells exact: "
          f"{'ok' if ok2 else 'FAIL'}")
    del plain

    # K3, both orientations, and the combine: bit-equal on identical inputs
    sides, ok3, err3 = {}, {}, {}
    for axis, thresh in ((0, cfg.chanthresh), (1, cfg.subintthresh)):
        got = K.scaled_sides(diags, mask, axis, thresh)
        want = K.scaled_sides_plain(diags, mask, axis, thresh)
        bad = sum(bits_mismatch(g, w, torch) for g, w in zip(got, want))
        err3[axis] = max(max_abs_diff(g, w, torch) for g, w in zip(got, want))
        sides[axis] = got
        ok3[axis] = bad == 0
        print(f"check K3 scaled_sides axis {axis}: {bad} cells differ in "
              f"bits, max abs {err3[axis]:.3e} (tolerance: bit-equal, NaN "
              f"included): {'ok' if bad == 0 else 'FAIL'}")
    new_w, scores = K.combine_zap(sides[0], sides[1], weights)
    pw, ps = K.combine_zap_plain(sides[0], sides[1], weights)
    bad_c = bits_mismatch(scores, ps, torch) + bits_mismatch(new_w, pw, torch)
    errc = max(max_abs_diff(scores, ps, torch), max_abs_diff(new_w, pw, torch))
    okc = bad_c == 0
    print(f"check combine_zap: {bad_c} cells differ in bits, max abs "
          f"{errc:.3e} (tolerance: bit-equal, NaN included): "
          f"{'ok' if okc else 'FAIL'}", flush=True)
    if not (ok1 and ok2 and ok3[0] and ok3[1] and okc):
        fail("a kernel disagrees with its plain version")

    # ---- 5. times: kernel, plain version, library yardstick, bound ----
    S, C, B = NSUB, NCHAN, NBIN
    cells = S * C
    nk = B // 2 + 1

    def bound(nbytes, nops):
        tb, to = nbytes / PEAK_BYTES_PER_S * 1e3, nops / PEAK_F32_PER_S * 1e3
        return (tb, "bytes") if tb >= to else (to, "operations")

    b1 = bound(4 * (cells * B + cells + C * B + S * B), 3 * cells * B)
    b2 = bound(4 * (cells * B + 2 * C * B + cells + 2 * B * nk + 4 * cells)
               + cells, cells * (4 * B * nk + 12 * B))
    # the select: 34 counting passes per median, 2 medians per diagnostic
    b3 = bound(cells * (4 * 4 + 1 + 4 * 4), 4 * 2 * 34 * cells)
    bc = bound(cells * (9 * 4 + 2 * 4), 16 * cells)
    entries = [
        ("weighted_marginals", "marginals.cu", "_marginals_kernel :633",
         counts["weighted_marginals"], err1,
         lambda: K.weighted_marginals(disp, weights),
         lambda: weighted_marginal_totals(disp, weights),
         lambda: (torch.einsum("sc,scb->cb", weights, disp),
                  torch.einsum("sc,scb->sb", weights, disp)), b1, 20),
        ("cell_diagnostics_disp", "cell_stats.cu",
         "_cell_stats_disp_kernel :909", counts["cell_diagnostics_disp"],
         err2, lambda: K.cell_diagnostics_disp(disp, rot_t, nyq, template,
                                               weights, mask),
         lambda: K.cell_diagnostics_disp_plain(
             disp, rot_t, nyq, template, weights, mask), None, b2, 5),
        ("scaled_sides_axis0", "scaled_sides.cu",
         "_scaled_sides_kernel :281", counts["scaled_sides_axis0"], err3[0],
         lambda: K.scaled_sides(diags, mask, 0, cfg.chanthresh),
         lambda: K.scaled_sides_plain(diags, mask, 0, cfg.chanthresh), None,
         b3, 10),
        ("scaled_sides_axis1", "scaled_sides.cu",
         "_scaled_sides_t_kernel :289", counts["scaled_sides_axis1"], err3[1],
         lambda: K.scaled_sides(diags, mask, 1, cfg.subintthresh),
         lambda: K.scaled_sides_plain(diags, mask, 1, cfg.subintthresh), None,
         b3, 10),
        ("combine_zap", "combine.cu", "_combine_zap :1555",
         counts["combine_zap"], errc,
         lambda: K.combine_zap(sides[0], sides[1], weights),
         lambda: K.combine_zap_plain(sides[0], sides[1], weights), None,
         bc, 50),
    ]
    kernels = []
    for (name, src, replaces, launches, err, kfn, pfn, lfn, (bms, bby),
         reps) in entries:
        ms = cuda_ms(kfn, reps, torch)
        pms = cuda_ms(pfn, max(2, reps // 5), torch)
        lms = cuda_ms(lfn, max(2, reps // 5), torch) if lfn else None
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"iterative_cleaner_torch/stats/csrc/{src}",
            "replaces": f"iterative_cleaner_tpu/stats/pallas_kernels.py:"
                        f"{replaces.split(':')[1]}",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": pms, "bound_ms": bms, "bound_by": bby,
            "library_ms": lms})
        lib = "null" if lms is None else f"{lms:.4f}"
        print(f"time {name}: {ms:.4f} ms, bound {bms:.4f} ms ({bby}), plain "
              f"{pms:.4f} ms, library {lib} ms, {launches} launches on the "
              f"main path {tag}", flush=True)
    iter_ms = cuda_ms(lambda: iteration_step(
        disp, weights, weights, mask, shifts, offsets,
        chanthresh=cfg.chanthresh, subintthresh=cfg.subintthresh,
        rotation=cfg.rotation, baseline_duty=cfg.baseline_duty), 5, torch)
    print(f"clean: {result.loops} loops, whole clean {clean_ms:.1f} ms "
          f"(upload, preamble, loop, download), {iter_ms:.3f} ms per "
          f"iteration (device, resident cube) {tag}", flush=True)

    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all, the "
          f"build included", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
