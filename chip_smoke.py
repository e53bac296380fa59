"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout:

    python3 chip_smoke.py

In order, it: prints the card; builds the CUDA kernels from the sources
in the checkout; rebuilds the full-size (1024 x 4096 x 128, seed 0)
golden archive once with the port's synthetic generator and cleans it
through ``clean_archive`` on the card four times, covering every route
of the engine — the default configuration (K1, K2), ``baseline_mode=
'profile'`` (the two-read route, K7), ``stats_frame='dedispersed'``
(K6; K3 and the combine on all) and a pulse window with ``-u`` (the
two-read route with three resident cubes, and the residual unloaded) —
with every kernel launch count set to 0 just before each clean and read
just after (the route's kernels must have launched, the others not);
holds the default and profile masks against
``tests/goldens/fullsize_mask*.npz`` under the goldens' flip rule and
the other two against the default one under the frames' contract;
streams the same archive four times through ``clean_streaming`` —
exact in 128-subint tiles with nothing pinned (an archive larger than
the card; K1, K2 per tile, K8 per iteration), exact with every tile
pinned (bit-equal to the first), exact on the profile route (K7 per
tile) and online in 256-subint tiles — with the launch counts, the tile
cache's transfers, the H2D rate and the peak memory of each, holding
them to the goldens, the whole default clean and the expected uploads;
cleans it through ``clean_archive_sharded`` (the cell-sharded clean,
K10) on one rank under NCCL — the default route and the dedispersed
frame, each held to the whole clean's mask and scores — and on four
gloo ranks sharing the card as a 2 x 2 mesh, each rank mapping the
cube from one file and uploading its quarter, held to the whole clean
and the golden, with each rank's launch counts, peak memory and
iteration time; holds every kernel against its plain PyTorch version on
the card at the shapes its route gives it (K10 also against K2 and K6,
bit for bit, on the whole cube and on one 2 x 2 shard; K9, the masked
median of every single-card route's residual-std telemetry, bit for bit
on the telemetry's line of 4,194,304 cells, along both axes of the
plane and on hand-made edge lines, and the default clean's first
telemetry value against K9's plain version on K2's first plane; its
device operations a call counted in a torch.profiler trace, at most 5
on the telemetry line and 1 along an axis of the plane); runs
the CLI session a user runs on the same archive written as PSRFITS
(``--metrics-json --prom-textfile --log-format json --timing``) and
holds its output mask, run report, Prometheus file and event log to
the in-process clean; cleans a 16 x 32 x 8192 archive (long profiles:
the DFT tables streamed in chunks) on the default, profile-baseline and
dedispersed routes with each mask held to the port's CPU clean and each
kernel to its plain version there; holds K3 and K8 bit for bit to their
plain versions on scaler lines of 50,000 entries (longer than a block
holds: K9 and the two tail kernels of ``sides_tail.cu`` in place of K3)
and streams a 48,000 x 4 x 32 archive exactly at budget 0, its mask
held to the whole clean's; times each kernel, its plain version and the
library yardstick beside the least time the card could take, and each
route's iteration; prints one JSON line with the kernels and, last,
``{"ok": true, "device": ...}``.

It exits non-zero, printing no result, when no CUDA device is present
or when the port's package is not beside it.  It imports nothing of JAX
or of the reference package.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDENS = os.path.join(HERE, "tests", "goldens")

# The goldens' flip rule (the reference harness benchmarks/fullsize_golden.py):
# a float32 run may flip only cells the float64 oracle scored within the
# borderline band, each within FLIP_NOISE_ENV of the threshold, at most
# MAX_BORDERLINE_FLIPS of them, with the oracle's loop count.
MAX_BORDERLINE_FLIPS = 10
FLIP_NOISE_ENV = 0.01

# Routes whose mask has no golden are held against the default route's
# mask (the reference package's tests/test_stats_frame.py, made
# symmetric): no disagreement on a cell that both runs scored outside
# [0.8, 1.3], and at most so many disagreeing cells in all and on cells
# the default run alone scored outside the band.  The reference's
# one-sided form does not hold for the reference itself at the golden's
# RFI density (tests/test_torch_routes.py
# test_frames_contract_at_bench_density).  The limits are about three
# times what the card gave on this archive: 132 cells in all and 14 one-
# sided for the dedispersed frame, 338 and 98 for the pulse window.
DECIDED_BELOW, DECIDED_ABOVE = 0.8, 1.3
CONTRACT_LIMITS = {   # route: (cells disagreeing, of them one-sided)
    "dedispersed": (400, 40),
    "pulse_unload": (1000, 300),
}

# H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit): HBM3
# bandwidth and the float32 rate outside the tensor cores (TF32 is off on
# this route; the selects' integer compares are counted at this rate too).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12

# Exact streaming against the whole default clean of the same run: the
# cross-tile template sum may flip a cell the whole run scored this close
# to the threshold, at most so many of them.
STREAM_FLIP_BAND = 1e-3
STREAM_MAX_FLIPS = 10
# The online mode's scalers see only a tile's subints: the reference
# bounds its disagreement with the whole clean (iterative_cleaner_tpu/
# parallel/streaming.py).
ONLINE_MAX_FRACTION = 1e-3
# The four gloo ranks of phase 3d: a rank that is not done by then fails
# the script.
GLOO_RANKS, GLOO_TIMEOUT_S = 4, 600

# The CLI phase writes the archive as PSRFITS (nbits 32) and the CLI
# writes its cleaned copy beside it: room for both and a margin.
CLI_DISK_FACTOR = 2.5

# Tolerances of the kernel checks (see tests/test_torch_kernels.py):
K1_RTOL = 1e-5   # of sum |w * disp|: float32 sums in another order
K2_RTOL = 1e-4   # of each plane's scale (K2, K6, K7): float32
#                  reassociation; masked cells exact


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


def diags_check(got, want, mask, torch):
    """K2/K6/K7 against their plain versions: rtol of each plane's scale,
    masked cells bit-equal.  Returns (max abs error, ok)."""
    err, ok = 0.0, True
    for g, w in zip(got, want):
        scale = float(w[~mask].abs().max())
        diff = (g - w).abs()
        err = max(err, float(diff.max()))
        ok &= bool((diff <= K2_RTOL * (w.abs() + scale)).all())
        ok &= bits_mismatch(g[mask], w[mask], torch) == 0
    return err, ok


def golden_check(label, result, suffix, shape) -> None:
    """Hold ``result``'s mask to ``fullsize_mask{suffix}.npz`` under the
    goldens' flip rule, with the golden's loops and convergence."""
    golden, want_zap = golden_mask(suffix, shape)
    fw = result.final_weights
    if fw.shape != shape or not np.all(np.isfinite(fw)):
        fail(f"{label}: final weights malformed: shape {fw.shape}")
    got_zap = fw == 0
    flips = np.argwhere(want_zap != got_zap)
    verdict = flip_verdict(flips, golden)
    print(f"golden fullsize_mask{suffix} ({label}): loops {result.loops} "
          f"(want {golden['loops']}), converged {result.converged}, zapped "
          f"{int(got_zap.sum())} (want {golden['zap_cells']}), flips "
          f"{len(flips)} (cap {MAX_BORDERLINE_FLIPS}), rogue "
          f"{verdict['rogue'][:5]}, wide {verdict['wide'][:5]}",
          flush=True)
    if not (verdict["ok"] and result.loops == golden["loops"]
            and result.converged == golden["converged"]):
        fail(f"{label}: full-size mask outside the golden's flip rule")


def whole_contract(label, result, whole) -> None:
    """Hold ``result``'s mask to the whole default clean's: at most
    STREAM_MAX_FLIPS cells, each scored within STREAM_FLIP_BAND of 1 by
    the whole run (a cross-tile or cross-rank template sum may move a
    score by an ulp)."""
    flips = (result.final_weights == 0) != (whole.final_weights == 0)
    near = np.abs(whole.scores - 1.0) <= STREAM_FLIP_BAND
    print(f"{label} against the whole default clean: {int(flips.sum())} "
          f"cells differ (limit {STREAM_MAX_FLIPS}, each scored within "
          f"{STREAM_FLIP_BAND:g} of 1 by the whole run), "
          f"{int((flips & ~near).sum())} outside that band", flush=True)
    if flips.sum() > STREAM_MAX_FLIPS or (flips & ~near).any():
        fail(f"{label}: mask outside its contract with the whole clean")


def gloo_shard_rank(shard_dir):
    """One of the GLOO_RANKS ranks of phase 3d, started by
    ``run_local_ranks`` with gloo on cuda:0: the cell-sharded clean of
    the cube in ``shard_dir`` (mapped, not read: the rank converts and
    uploads only its block), then three timed iterations on its prepared
    block.  Returns its counts, times, peak memory and (rank 0) the
    result."""
    import torch
    import torch.distributed as dist

    from iterative_cleaner_torch import Archive, CleanConfig
    from iterative_cleaner_torch.backends import clean_archive_sharded
    from iterative_cleaner_torch.backends.torch_backend import upload_meta
    from iterative_cleaner_torch.engine.loop import iteration_step, prepare
    from iterative_cleaner_torch.parallel.mesh import cell_mesh
    from iterative_cleaner_torch.parallel.sharding import (
        shard_layout,
        upload_shard,
    )
    from iterative_cleaner_torch.stats import kernels as K

    cube = np.load(os.path.join(shard_dir, "cube.npy"), mmap_mode="r")
    with np.load(os.path.join(shard_dir, "meta.npz")) as z:
        meta = {k: z[k] for k in z.files}
    ar = Archive(data=cube[:, None], weights=meta["weights"],
                 freqs_mhz=meta["freqs_mhz"], period_s=float(meta["period_s"]),
                 dm=float(meta["dm"]),
                 centre_freq_mhz=float(meta["centre_freq_mhz"]))
    cfg = CleanConfig(device="cuda:0")
    mesh = cell_mesh()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    result = clean_archive_sharded(ar, cfg, mesh)
    torch.cuda.synchronize()
    clean_ms = (time.perf_counter() - t0) * 1e3
    counts = K.launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    layout = shard_layout(mesh, ar.nsub, ar.nchan)
    c, w, f = upload_shard(cube, ar.weights, ar.freqs_mhz, layout,
                           mesh.device)
    prep = prepare(c, w, *upload_meta(f, ar.dm, ar.centre_freq_mhz,
                                      ar.period_s, mesh.device),
                   cfg, dedispersed=False, mesh=mesh)
    step = dict(chanthresh=cfg.chanthresh, subintthresh=cfg.subintthresh,
                rotation=cfg.rotation, baseline_duty=cfg.baseline_duty,
                mesh=mesh)
    iteration_step(prep, w, w, w == 0, **step)
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(3):
        iteration_step(prep, w, w, w == 0, **step)
    torch.cuda.synchronize()
    dist.barrier()
    iter_ms = (time.perf_counter() - t0) / 3 * 1e3
    return {"rank": mesh.rank, "coords": mesh.coords, "counts": counts,
            "clean_ms": clean_ms, "iter_ms": iter_ms, "peak_gib": peak_gib,
            "block": (layout.s0, layout.s1, layout.c0, layout.c1),
            "result": result}


def cli_phase(ar, whole, want_counts, tag):
    """The CLI session on the archive written as PSRFITS (nbits 32: its
    float32 cube is the in-memory archive's cast), in a temporary
    directory removed afterwards.  Holds the output mask to the
    in-process clean ``whole`` (bit for bit) and the golden, the run
    report's iteration history to ``whole.iter_metrics`` (exactly), the
    Prometheus file to its parser, the event log's sequence, and the
    launch counts to ``want_counts``.  Returns the phase's times."""
    import torch

    from iterative_cleaner_torch import cli
    from iterative_cleaner_torch.io import load_archive
    from iterative_cleaner_torch.io.psrfits import save_psrfits
    from iterative_cleaner_torch.stats import kernels as K
    from iterative_cleaner_torch.telemetry import (
        iter_metrics_dict,
        parse_prometheus_text,
    )
    from iterative_cleaner_torch.telemetry.events import read_events

    shape = whole.final_weights.shape
    work = tempfile.mkdtemp(prefix="icln_chip_smoke_cli_")
    cwd = os.getcwd()
    try:
        need = CLI_DISK_FACTOR * ar.data.size * 4
        free = shutil.disk_usage(work).free
        print(f"cli: {free / 2 ** 30:.1f} GiB free in the temporary "
              f"directory, {need / 2 ** 30:.1f} GiB wanted", flush=True)
        if free < need:
            fail("cli: not enough disk for the full-size PSRFITS pair")
        path = os.path.join(work, "golden.sf")
        t0 = time.perf_counter()
        save_psrfits(ar, path, nbits=32)
        write_in_s = time.perf_counter() - t0
        size_gb = os.path.getsize(path) / 1e9
        os.chdir(work)
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        rc = cli.main(["--metrics-json", "run.json", "--prom-textfile",
                       "run.prom", "--log-format", "json", "--timing",
                       "golden.sf"])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        counts = K.launch_counts()
        if rc != 0:
            fail(f"cli: exit code {rc}")
        if counts != want_counts:
            fail(f"cli: launch counts {counts}, want {want_counts}")
        out = load_archive("golden.sf_cleaned.sf")
        if out.weights.shape != shape or out.data.shape != ar.data.shape:
            fail(f"cli: output malformed: {out.weights.shape}")
        n_mask = int(((out.weights == 0) != (whole.final_weights == 0)).sum())
        with open("run.json") as f:
            doc = json.load(f)
        arch = doc["archives"][0]
        hist_ok = arch["iter_history"] == iter_metrics_dict(
            whole.iter_metrics)
        with open("run.prom") as f:
            prom = parse_prometheus_text(f.read())
        kinds = [e["event"] for e in read_events("clean.events.jsonl")]
        seq = [k for k in kinds if k != "phase"]
        want_seq = ["run_start"] + ["iteration"] * whole.loops + [
            "archive", "run_end"]
        phases = doc["phases_s"]
        print(f"cli: golden.sf ({size_gb:.2f} GB, written in {write_in_s:.1f} "
              f"s) cleaned by cli.main in {cli_s:.1f} s: load "
              f"{phases['load']:.1f} s, clean {phases['clean']:.1f} s, "
              f"write {phases['write']:.1f} s, the rest (report, Prometheus "
              f"file, event log, clean.log, prints) "
              f"{cli_s - sum(phases.values()):.3f} s; kernels "
              f"{json.dumps(counts)}; output mask against the in-process "
              f"clean: {n_mask} cells differ (tolerance 0); iter_history "
              f"equal to iter_metrics: {hist_ok}; Prometheus samples "
              f"{len(prom)}; events {seq} {tag}", flush=True)
        if n_mask:
            fail("cli: output mask differs from the in-process clean")
        golden_check("cli", dataclasses.replace(
            whole, final_weights=out.weights), "", shape)
        if not hist_ok or arch["loops"] != whole.loops:
            fail(f"cli: run report's iter_history {arch['iter_history']} "
                 f"differs from the clean's iter_metrics")
        if prom.get("icln_archives_cleaned_total") != 1.0:
            fail("cli: the Prometheus file lacks the cleaned archive")
        if seq != want_seq or kinds.count("phase") != 3:
            fail(f"cli: event sequence {kinds}")
        return {"psrfits_gb": size_gb, "write_in_s": write_in_s,
                "cli_s": cli_s, **{f"{k}_s": v for k, v in phases.items()}}
    finally:
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)


def golden_mask(name, shape):
    with open(os.path.join(GOLDENS, f"fullsize_mask_golden{name}.json")) as f:
        golden = json.load(f)
    with np.load(os.path.join(GOLDENS, f"fullsize_mask{name}.npz")) as z:
        zap = np.unpackbits(z["zap"])[: shape[0] * shape[1]].reshape(
            shape).astype(bool)
    return golden, zap


def contract(route, base, other) -> None:
    """Hold ``other``'s mask against the default route's ``base`` under
    CONTRACT_LIMITS; print the counts."""
    max_all, max_one = CONTRACT_LIMITS[route]
    if not np.all(np.isfinite(other.final_weights)):
        fail(f"route {route}: final weights not finite")
    disagree = (base.final_weights == 0) != (other.final_weights == 0)
    decided = [(r.scores < DECIDED_BELOW) | (r.scores > DECIDED_ABOVE)
               for r in (base, other)]
    n_all = int(disagree.sum())
    n_one = int((disagree & decided[0]).sum())
    n_both = int((disagree & decided[0] & decided[1]).sum())
    cells = [(int(i), int(c), round(float(base.scores[i, c]), 4),
              round(float(other.scores[i, c]), 4))
             for i, c in np.argwhere(disagree & decided[0])[:20]]
    print(f"contract {route} vs default: {n_all} cells disagree (limit "
          f"{max_all}); outside the band [{DECIDED_BELOW}, {DECIDED_ABOVE}] "
          f"in the default run {n_one} (limit {max_one}), in both runs "
          f"{n_both} (limit 0); {other.loops} loops, converged "
          f"{other.converged}; (subint, chan, default "
          f"score, {route} score) of the first: {cells}", flush=True)
    if n_both or n_all > max_all or n_one > max_one:
        fail(f"route {route}: mask outside its contract with the default")


def route_inputs(ar, cube32, configs, dev):
    """The first iteration's kernel inputs of each configuration's route
    on ``ar`` (``cube32`` its float32 total intensity): the prepared
    cubes, templates, rotated template rows and Nyquist rows that K1, K2,
    K6 and K7 take on the card."""
    import torch

    from iterative_cleaner_torch.engine.loop import (
        build_template,
        nyq_correction_row,
        prepare,
    )
    from iterative_cleaner_torch.ops.dsp import rotate_bins

    f32 = torch.float32
    nchan, nbin = cube32.shape[1:]
    weights = torch.from_numpy(
        np.ascontiguousarray(ar.weights, dtype=np.float32)).to(dev)
    meta = [torch.from_numpy(np.ascontiguousarray(ar.freqs_mhz,
                                                  dtype=np.float32)).to(dev)]
    meta += [torch.tensor(v, dtype=f32, device=dev)
             for v in (ar.dm, ar.centre_freq_mhz, ar.period_s)]
    cfg = configs["default"]
    preps = {r: prepare(torch.from_numpy(cube32).to(dev), weights, *meta, c,
                        dedispersed=ar.dedispersed)
             for r, c in configs.items()}
    templates = {r: build_template(p, weights, rotation=cfg.rotation,
                                   baseline_duty=cfg.baseline_duty)
                 for r, p in preps.items()}

    def rotated_template(route):
        """The (nchan, nbin) rotated template rows of K2 and K7: the
        template times the pulse window, rotated to each channel."""
        p, t = preps[route], templates[route]
        t = t if p.window is None else t * p.window
        return rotate_bins(t.expand(nchan, nbin), p.back_shifts,
                           method=cfg.rotation).contiguous()

    out = {"weights": weights, "mask": weights == 0, "preps": preps,
           "disp": preps["default"].disp_base,
           "template": templates["default"],
           "rot_t": rotated_template("default"),
           "nyq": nyq_correction_row(preps["default"].back_shifts, nbin,
                                     cfg.rotation, f32),
           "pd": preps["dedispersed"], "t_d": templates["dedispersed"]}
    for key, route in (("p", "profile"), ("w", "pulse_unload")):
        out[key] = preps[route]
        out["t_" + key] = templates[route]
        out["rot_t_" + key] = rotated_template(route)
    return out


def check_k1(disp, weights, what):
    """K1 against its plain version, within K1_RTOL of sum|w*disp|."""
    from iterative_cleaner_torch.ops.dsp import weighted_marginal_totals
    from iterative_cleaner_torch.stats import kernels as K

    a, t1 = K.weighted_marginals(disp, weights)
    pa, pt1 = weighted_marginal_totals(disp, weights)
    sa, st1 = weighted_marginal_totals(disp.abs(), weights.abs())
    err = max(float((a - pa).abs().max()), float((t1 - pt1).abs().max()))
    ok = bool(((a - pa).abs() <= K1_RTOL * sa).all()
              and ((t1 - pt1).abs() <= K1_RTOL * st1).all())
    print(f"check K1 weighted_marginals{what}: max abs {err:.3e}, tolerance "
          f"{K1_RTOL:g} * sum|w*disp|: {'ok' if ok else 'FAIL'}", flush=True)
    return err, ok


def diag_calls_for(ri):
    """(kernel, plain version) pairs of K2, K7 (without and with the
    pulse window: its fit takes the unwindowed template, its residual the
    windowed one) and K6 on ``route_inputs``' tensors."""
    from iterative_cleaner_torch.stats import kernels as K

    disp, rot_t, nyq, template, weights, mask = (
        ri[k] for k in ("disp", "rot_t", "nyq", "template", "weights",
                        "mask"))
    pp, t_p, rot_t_p = ri["p"], ri["t_p"], ri["rot_t_p"]
    pw, t_w, rot_t_w = ri["w"], ri["t_w"], ri["rot_t_w"]
    pd, t_d = ri["pd"], ri["t_d"]
    return {
        "cell_diagnostics_disp": [(
            lambda: K.cell_diagnostics_disp(disp, rot_t, nyq, template,
                                            weights, mask),
            lambda: K.cell_diagnostics_disp_plain(disp, rot_t, nyq, template,
                                                  weights, mask))],
        "cell_diagnostics_two_read": [(
            lambda: K.cell_diagnostics_two_read(pp.ded, pp.disp_base,
                                                rot_t_p, t_p, weights, mask),
            lambda: K.cell_diagnostics_two_read_plain(
                pp.ded, pp.disp_base, rot_t_p, t_p, weights, mask)), (
            lambda: K.cell_diagnostics_two_read(pw.ded, pw.disp_base,
                                                rot_t_w, t_w, weights, mask),
            lambda: K.cell_diagnostics_two_read_plain(
                pw.ded, pw.disp_base, rot_t_w, t_w, weights, mask))],
        "cell_diagnostics_dedisp": [(
            lambda: K.cell_diagnostics_dedisp(pd.ded, t_d, pd.window,
                                              weights, mask),
            lambda: K.cell_diagnostics_dedisp_plain(pd.ded, t_d, pd.window,
                                                    weights, mask))],
    }


def check_diags(diag_calls, mask, what):
    """Each cell-diagnostics kernel against its plain version (K2_RTOL of
    each plane's scale, masked cells exact).  Returns the errors, the
    verdicts and K2's planes."""
    import torch

    diag_err, diag_ok, diags = {}, {}, None
    for name, pairs in diag_calls.items():
        diag_err[name], diag_ok[name] = 0.0, True
        for n, (kfn, pfn) in enumerate(pairs):
            got = kfn()
            err, ok = diags_check(got, pfn(), mask, torch)
            diag_err[name] = max(diag_err[name], err)
            diag_ok[name] &= ok
            if name == "cell_diagnostics_disp":
                diags = got
            window = " (pulse window)" if n else ""
            print(f"check {name}{window}{what}: max abs {err:.3e}, tolerance "
                  f"rtol {K2_RTOL:g} of each plane's scale, masked cells "
                  f"exact: {'ok' if ok else 'FAIL'}", flush=True)
    return diag_err, diag_ok, diags


def long_phase(configs, dev, tag):
    """Phase 3f: a 16 x 32 x 8192 archive cleaned on the card on the
    default, profile-baseline and dedispersed routes, each route's kernels
    launched, masks equal to the port's CPU clean; then K1 and the
    cell-diagnostics kernels against their plain versions on its first
    iteration's inputs."""
    import torch

    from iterative_cleaner_torch.backends import clean_archive
    from iterative_cleaner_torch.engine.loop import ROUTE_KERNELS, select_route
    from iterative_cleaner_torch.io.synthetic import make_synthetic_archive
    from iterative_cleaner_torch.stats import kernels as K

    ar, _ = make_synthetic_archive(nsub=16, nchan=32, nbin=8192,
                                   n_prezapped=5, seed=8)
    what = f" (nbin {ar.nbin})"
    for route in ("default", "profile", "dedispersed"):
        cfg = configs[route]
        K.reset_launch_counts()
        t0 = time.perf_counter()
        got = clean_archive(ar, cfg)
        torch.cuda.synchronize()
        card_ms = (time.perf_counter() - t0) * 1e3
        got_counts = K.launch_counts()
        want = clean_archive(ar, dataclasses.replace(cfg, device="cpu"))
        own = ROUTE_KERNELS[select_route(cfg, ar.dedispersed)]
        missing = [k for k in own if got_counts[k] < 1]
        n_mask = int(((got.final_weights == 0)
                      != (want.final_weights == 0)).sum())
        print(f"long profiles{what}, route {route}: kernels "
              f"{json.dumps(got_counts)}, {got.loops} loops (CPU "
              f"{want.loops}), {card_ms:.1f} ms on the card; against the "
              f"port's CPU clean {n_mask} mask cells differ (tolerance 0) "
              f"{tag}", flush=True)
        if missing or n_mask or got.loops != want.loops:
            fail(f"long profiles, route {route}: kernels never launched "
                 f"{missing}, or the mask or loops differ from the CPU clean")
    cube32 = np.ascontiguousarray(ar.total_intensity(), dtype=np.float32)
    ri = route_inputs(ar, cube32, configs, dev)
    _, ok1 = check_k1(ri["disp"], ri["weights"], what)
    _, diag_ok, _ = check_diags(diag_calls_for(ri), ri["mask"], what)
    k10 = [getattr(K, name)(*args) for name, args in (
        ("shard_diagnostics_disp", (ri["disp"], ri["rot_t"], ri["nyq"],
                                    ri["template"], ri["weights"],
                                    ri["mask"])),)]
    twin = K.cell_diagnostics_disp(ri["disp"], ri["rot_t"], ri["nyq"],
                                   ri["template"], ri["weights"], ri["mask"])
    bits = sum(bits_mismatch(g, w, torch) for g, w in zip(k10[0], twin))
    print(f"check K10 shard_diagnostics_disp{what}: {bits} cells differ in "
          f"bits from cell_diagnostics_disp (tolerance: bit-equal)",
          flush=True)
    if not (ok1 and all(diag_ok.values()) and bits == 0):
        fail("long profiles: a kernel disagrees with its plain version")


def long_line_phase(dev, counts, clean_ms, tag):
    """Phase 3g: K3 and K8 on 50,000-entry lines along both axes, bit-equal
    to their plain versions; an exact stream at budget 0 of a 48,000 x 4
    x 32 archive (its channel lines 48,000 long) against the whole clean;
    the tail kernels timed on the stream's planes.  Returns the tail
    kernels' entries for the kernels line."""
    import torch

    from iterative_cleaner_torch import CleanConfig, clean_streaming
    from iterative_cleaner_torch.backends import clean_archive
    from iterative_cleaner_torch.io.synthetic import make_synthetic_archive
    from iterative_cleaner_torch.stats import kernels as K

    g = torch.Generator(device=dev).manual_seed(11)
    ok = True
    for axis in (0, 1):
        shape = (50000, 4) if axis == 0 else (4, 50000)
        d = [torch.randn(shape, generator=g, device=dev) * s
             for s in (1.0, 0.3, 5.0, 2.0)]
        mask = torch.rand(shape, generator=g, device=dev) < 0.2
        d[0][mask] = 0.0
        d[2][mask] = 1e20
        d[3].view(-1)[[21, 40]] = float("nan")
        d[3].view(-1)[22] = float("inf")
        K.reset_launch_counts()
        got = K.scaled_sides(d, mask, axis, 5.0)
        used = K.launch_counts()
        bad = sum(bits_mismatch(a, b, torch) for a, b in
                  zip(got, K.scaled_sides_plain(d, mask, axis, 5.0)))
        worig = (~mask).float()
        fw, fs = K.fused_combine(d, mask, worig, 5.0, 4.0)
        pw, ps = K.fused_combine_plain(d, mask, worig, 5.0, 4.0)
        bad8 = bits_mismatch(fs, ps, torch) + bits_mismatch(fw, pw, torch)
        print(f"check K3 scaled_sides axis {axis} on {shape} (lines of "
              f"50,000): {bad} cells differ in bits, K8 fused_combine "
              f"{bad8} (tolerance: bit-equal, NaN included); launches "
              f"{json.dumps(used)}", flush=True)
        ok &= bad == 0 and bad8 == 0 and used["side_centre"] == 4 \
            and used[f"scaled_sides_axis{axis}"] == 0
    if not ok:
        fail("long lines: K3 or K8 disagrees with its plain version")

    ar, _ = make_synthetic_archive(nsub=48000, nchan=4, nbin=32,
                                   n_prezapped=50, seed=12)
    whole = clean_archive(ar, CleanConfig())
    K.reset_launch_counts()
    t0 = time.perf_counter()
    r = clean_streaming(ar, 6000, CleanConfig(stream_hbm_mb=0))
    torch.cuda.synchronize()
    key = "stream (long lines)"
    clean_ms[key] = (time.perf_counter() - t0) * 1e3
    counts[key] = K.launch_counts()
    n_mask = int(((r.final_weights == 0) != (whole.final_weights == 0)).sum())
    print(f"{key}: exact, 8 tiles of 6000 subints of 48000 x 4 x 32, "
          f"budget 0: kernels {json.dumps(counts[key])}, {r.loops} loops "
          f"(whole {whole.loops}), {clean_ms[key]:.1f} ms; against the whole "
          f"clean {n_mask} mask cells differ (tolerance 0) {tag}", flush=True)
    if n_mask or r.loops != whole.loops or counts[key]["side_centre"] < 1 \
            or counts[key]["scaled_sides_axis0"]:
        fail(f"{key}: mask, loops or launches off")

    # the tail kernels at the stream's shapes: one diagnostic plane of
    # 48,000 x 4 along axis 0
    plane = torch.from_numpy(np.ascontiguousarray(r.scores,
                                                  dtype=np.float32)).to(dev)
    pmask = torch.from_numpy(r.final_weights == 0).to(dev)
    med = K.masked_median(plane, pmask, 0)
    centred, absc, _ = K.side_centre(plane, pmask, med, 0, True)
    mad = K.masked_median(absc, pmask, 0)
    n = plane.numel()
    entries = []
    for name, kfn, pfn, nbytes in (
            ("side_centre",
             lambda: K.side_centre(plane, pmask, med, 0, True),
             lambda: K.side_centre_plain(plane, pmask, med, 0, True), 13 * n),
            ("side_scale",
             lambda: K.side_scale(centred, pmask, mad, None, 0, 5.0, True),
             lambda: K.side_scale_plain(centred, pmask, mad, None, 0, 5.0,
                                        True), 9 * n)):
        got, want = kfn(), pfn()
        got = got if isinstance(got, torch.Tensor) else got[0]
        want = want if isinstance(want, torch.Tensor) else want[0]
        err = max_abs_diff(got, want, torch)
        bad = bits_mismatch(got, want, torch)
        if bad:
            fail(f"{name}: {bad} cells differ from its plain version")
        entries.append({
            "name": name, "route": "cuda",
            "source": "iterative_cleaner_torch/stats/csrc/sides_tail.cu",
            "replaces": "iterative_cleaner_tpu/stats/pallas_kernels.py:433",
            "launches": counts[key][name], "max_abs_err": err,
            "ms": cuda_ms(kfn, 50, torch), "plain_ms": cuda_ms(pfn, 10, torch),
            "bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": None, "launches_route": key})
        print(f"time {name}: {entries[-1]['ms']:.4f} ms, bound "
              f"{entries[-1]['bound_ms']:.4f} ms (bytes), plain "
              f"{entries[-1]['plain_ms']:.4f} ms, {entries[-1]['launches']} "
              f"launches in {key}; bit-equal to its plain version {tag}",
              flush=True)
    return entries


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
    from iterative_cleaner_torch import CleanConfig, clean_streaming
    from iterative_cleaner_torch.backends import (
        clean_archive,
        clean_archive_sharded,
    )
    from iterative_cleaner_torch.engine.loop import (
        ROUTE_KERNELS,
        SHARD_KERNELS,
        STREAM_KERNELS,
        iteration_step,
        select_route,
    )
    from iterative_cleaner_torch.io.synthetic import (
        FULLSIZE_SHAPE,
        make_fullsize_archive,
    )
    from iterative_cleaner_torch.ops.dsp import weighted_marginal_totals
    from iterative_cleaner_torch.parallel import distributed
    from iterative_cleaner_torch.parallel.mesh import cell_mesh
    from iterative_cleaner_torch.parallel.tile_cache import DictRegistry
    from iterative_cleaner_torch.profile_iteration import (
        device_ops,
        stream_line,
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

    # ---- 2. each route, counted: the full-size archive through
    # clean_archive, launch counts set to 0 just before and read just after
    NSUB, NCHAN, NBIN = FULLSIZE_SHAPE
    t0 = time.perf_counter()
    ar = make_fullsize_archive()
    print(f"archive: {NSUB}x{NCHAN}x{NBIN} rebuilt in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    # "route" below names a configuration; its engine route is
    # select_route's (pulse_unload: the integration two-read route, three
    # resident cubes, and the residual unloaded after the loop)
    configs = {"default": CleanConfig(),
               "profile": CleanConfig(baseline_mode="profile"),
               "dedispersed": CleanConfig(stats_frame="dedispersed"),
               "pulse_unload": CleanConfig(pulse_region=(0.2, 30, 60),
                                           unload_res=True)}
    results, counts, clean_ms, peak_gib = {}, {}, {}, {}
    for route, cfg in configs.items():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        results[route] = clean_archive(ar, cfg)
        torch.cuda.synchronize()
        clean_ms[route] = (time.perf_counter() - t0) * 1e3
        counts[route] = K.launch_counts()
        peak_gib[route] = torch.cuda.max_memory_allocated() / 2 ** 30
        engine_route = select_route(cfg, ar.dedispersed)
        print(f"route {route} ({engine_route}): kernels "
              f"{json.dumps(counts[route])}, {results[route].loops} loops, "
              f"whole clean {clean_ms[route]:.1f} ms, peak device memory "
              f"{peak_gib[route]:.2f} GiB {tag}", flush=True)
        own = ROUTE_KERNELS[engine_route]
        missing = [k for k in own if counts[route][k] < 1]
        stray = [k for k, v in counts[route].items() if k not in own and v]
        if missing or stray:
            fail(f"route {route}: kernels of the route never launched "
                 f"{missing}, kernels of other routes launched {stray}")
        if counts[route]["masked_median"] != results[route].loops:
            fail(f"route {route}: K9 launched "
                 f"{counts[route]['masked_median']} times in "
                 f"{results[route].loops} loops")

    # ---- 3. what came out is right: the goldens and the frames' contract
    for route, suffix in (("default", ""), ("profile", "_profile")):
        golden_check(f"route {route}", results[route], suffix, (NSUB, NCHAN))
    for route in CONTRACT_LIMITS:
        contract(route, results["default"], results[route])
    res = results["pulse_unload"].residual
    if res is None or res.shape != (NSUB, NCHAN, NBIN) \
            or not np.all(np.isfinite(res)):
        fail(f"route pulse_unload: residual malformed: "
             f"{None if res is None else res.shape}")
    print(f"residual of pulse_unload: {res.shape} {res.dtype}, finite",
          flush=True)
    results["pulse_unload"].residual = res = None   # 2 GB of host memory

    # ---- 3b. streaming, counted like the whole cleans: (a) exact with
    # nothing pinned, the regime of an archive larger than the card; (b)
    # exact with every tile pinned; (c) exact on the profile route; (d)
    # online, four tiles cleaned on their own
    streams = {
        "a": (128, CleanConfig(stream_hbm_mb=0), "exact"),
        "b": (128, CleanConfig(), "exact"),
        "c": (128, CleanConfig(baseline_mode="profile", stream_hbm_mb=0),
              "exact"),
        "d": (256, CleanConfig(), "online"),
    }
    cube_bytes = NSUB * NCHAN * NBIN * 4
    whole = results["default"]
    stream_regs = {}
    for run, (chunk, cfg_s, mode) in streams.items():
        key = f"stream ({run})"
        reg = stream_regs[run] = DictRegistry()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        results[key] = r = clean_streaming(ar, chunk, cfg_s, mode=mode,
                                           registry=reg)
        torch.cuda.synchronize()
        clean_ms[key] = (time.perf_counter() - t0) * 1e3
        counts[key] = K.launch_counts()
        peak_gib[key] = torch.cuda.max_memory_allocated() / 2 ** 30
        n_tiles = -(-NSUB // chunk)
        engine_route = select_route(cfg_s, ar.dedispersed)
        g, c = reg.gauges, reg.counters
        if mode == "exact":
            want = {k: 0 for k in counts[key]}
            for k in STREAM_KERNELS[engine_route]:
                want[k] = r.loops * (n_tiles if k in (
                    "weighted_marginals", "cell_diagnostics_disp",
                    "cell_diagnostics_two_read",
                    "cell_diagnostics_dedisp") else 1)
            print(f"stream ({run}) exact, {n_tiles} tiles of {chunk}, "
                  f"budget {g['stream_cache_budget_bytes']} bytes, route "
                  f"{engine_route}: kernels {json.dumps(counts[key])}, "
                  f"{r.loops} loops, converged {r.converged}, whole clean "
                  f"{clean_ms[key]:.1f} ms; {stream_line(g)}; peak device "
                  f"memory {peak_gib[key]:.2f} GiB {tag}", flush=True)
            cache_gauges = {k: v for k, v in g.items() if "cache" in k}
            print(f"stream ({run}) cache: {json.dumps(c)} "
                  f"{json.dumps(cache_gauges)}", flush=True)
            if counts[key] != want:
                fail(f"stream ({run}): launch counts {counts[key]}, want "
                     f"{want}")
        else:
            print(f"stream ({run}) online, {n_tiles} tiles of {chunk}: "
                  f"kernels {json.dumps(counts[key])}, {r.loops} loops "
                  f"(most of a tile), converged {r.converged}, whole clean "
                  f"{clean_ms[key]:.1f} ms, ms per iteration not measured "
                  f"(tiles iterate apart), peak device memory "
                  f"{peak_gib[key]:.2f} GiB {tag}", flush=True)
            own = ROUTE_KERNELS[engine_route]
            # K9 once per tile iteration, as K3 axis 0
            if any(counts[key][k] < n_tiles for k in own) or any(
                    v for k, v in counts[key].items() if k not in own) \
                    or counts[key]["masked_median"] \
                    != counts[key]["scaled_sides_axis0"]:
                fail(f"stream ({run}): launch counts {counts[key]}")
        if r.final_weights.shape != (NSUB, NCHAN) \
                or not np.all(np.isfinite(r.final_weights)):
            fail(f"stream ({run}): final weights malformed")
    ra, rb = results["stream (a)"], results["stream (b)"]
    golden_check("stream (a)", ra, "", (NSUB, NCHAN))
    golden_check("stream (c)", results["stream (c)"], "_profile",
                 (NSUB, NCHAN))
    whole_contract("stream (a)", ra, whole)
    print(f"stream (a): peak device memory {peak_gib['stream (a)']:.2f} GiB "
          f"against the whole clean's {peak_gib['default']:.2f} GiB {tag}",
          flush=True)
    if peak_gib["stream (a)"] > 0.5 * peak_gib["default"]:
        fail("stream (a): peak device memory above half the whole clean's")
    bad_b = bits_mismatch(torch.from_numpy(rb.final_weights),
                          torch.from_numpy(ra.final_weights), torch) \
        + bits_mismatch(torch.from_numpy(rb.scores),
                        torch.from_numpy(ra.scores), torch)
    print(f"stream (b) against stream (a): {bad_b} cells differ in bits "
          f"(weights and scores; tolerance: bit-equal)", flush=True)
    if bad_b or (rb.loops, rb.converged) != (ra.loops, ra.converged):
        fail("stream (b): differs from stream (a)")
    for run, cubes in (("a", 1 + 2 * ra.loops), ("b", 1)):
        got = stream_regs[run].counters["stream_h2d_cube_bytes"]
        print(f"stream ({run}) uploaded {got} cube bytes (want {cubes} x "
              f"{cube_bytes})", flush=True)
        if got != cubes * cube_bytes:
            fail(f"stream ({run}): cube uploads off")
    online = results["stream (d)"]
    frac = float(np.mean((online.final_weights == 0)
                         != (whole.final_weights == 0)))
    print(f"stream (d) online against the whole default clean: {frac:.3e} "
          f"of the cells differ (limit {ONLINE_MAX_FRACTION:g})", flush=True)
    if frac >= ONLINE_MAX_FRACTION:
        fail("stream (d): online mask drifted past its bound")

    # ---- 3c. the cell-sharded clean on one rank under NCCL: K10 on the
    # whole cube, the scalers' selects as real NCCL all-reduces over one
    # rank; counted like the whole cleans, held to their masks and scores
    store_dir = tempfile.mkdtemp(prefix="icln_chip_smoke_")
    distributed.initialize("nccl", f"file://{store_dir}/store",
                           device="cuda:0", rank=0, world_size=1)
    mesh1 = cell_mesh()
    for route in SHARD_KERNELS:
        key = f"sharded 1 ({route})"
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        results[key] = r = clean_archive_sharded(ar, configs[route], mesh1)
        torch.cuda.synchronize()
        clean_ms[key] = (time.perf_counter() - t0) * 1e3
        counts[key] = K.launch_counts()
        peak_gib[key] = torch.cuda.max_memory_allocated() / 2 ** 30
        want = {k: (r.loops if k in SHARD_KERNELS[route] else 0)
                for k in counts[key]}
        base = results[route]
        n_mask = int(((r.final_weights == 0)
                      != (base.final_weights == 0)).sum())
        n_bits = bits_mismatch(torch.from_numpy(r.scores),
                               torch.from_numpy(base.scores), torch)
        print(f"sharded 1 ({route}), one NCCL rank: kernels "
              f"{json.dumps(counts[key])}, {r.loops} loops, whole clean "
              f"{clean_ms[key]:.1f} ms, peak device memory "
              f"{peak_gib[key]:.2f} GiB; against the whole {route} clean: "
              f"{n_mask} mask cells and {n_bits} scores differ in bits "
              f"(tolerance: 0 and 0) {tag}", flush=True)
        if counts[key] != want:
            fail(f"{key}: launch counts {counts[key]}, want {want}")
        if n_mask or n_bits or (r.loops, r.converged) != (base.loops,
                                                          base.converged):
            fail(f"{key}: mask, scores or loops differ from the whole clean")
    golden_check("sharded 1 (default)", results["sharded 1 (default)"], "",
                 (NSUB, NCHAN))

    # ---- 3d. four gloo ranks sharing the card (NCCL refuses two ranks
    # on one GPU): the 2 x 2 mesh cell_mesh(4) builds, every cross-rank
    # merge exercised on the card; the ranks map the float32 cube from
    # one file and each uploads its quarter
    cube32 = np.ascontiguousarray(ar.total_intensity(), dtype=np.float32)
    shard_dir = tempfile.mkdtemp(prefix="icln_chip_smoke_ranks_")
    try:
        np.save(os.path.join(shard_dir, "cube.npy"), cube32)
        np.savez(os.path.join(shard_dir, "meta.npz"), weights=ar.weights,
                 freqs_mhz=ar.freqs_mhz, period_s=ar.period_s, dm=ar.dm,
                 centre_freq_mhz=ar.centre_freq_mhz)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        try:
            ranks = distributed.run_local_ranks(
                gloo_shard_rank, GLOO_RANKS, (shard_dir,), workdir=shard_dir,
                device="cuda:0", backend="gloo", timeout_s=GLOO_TIMEOUT_S)
        except (RuntimeError, TimeoutError) as exc:
            fail(f"sharded 4 (gloo): {exc}")
        gloo_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(shard_dir, ignore_errors=True)
    r4 = results["sharded 4 (gloo)"] = ranks[0]["result"]
    for rk in ranks:
        want = {k: (r4.loops if k in SHARD_KERNELS["default"] else 0)
                for k in rk["counts"]}
        print(f"sharded 4 (gloo) rank {rk['rank']} {tuple(rk['coords'])}, "
              f"block {rk['block']}: kernels {json.dumps(rk['counts'])}, "
              f"whole clean {rk['clean_ms']:.1f} ms, "
              f"{rk['iter_ms']:.1f} ms per iteration (host, 3 iterations "
              f"between barriers), peak device memory "
              f"{rk['peak_gib']:.2f} GiB {tag}", flush=True)
        if rk["counts"] != want:
            fail(f"sharded 4 (gloo) rank {rk['rank']}: launch counts "
                 f"{rk['counts']}, want {want}")
    print(f"sharded 4 (gloo): {GLOO_RANKS} rank processes in {gloo_s:.1f} s "
          f"(start-up, mapping, cleans, timing), {r4.loops} loops {tag}",
          flush=True)
    whole_contract("sharded 4 (gloo)", r4, whole)
    golden_check("sharded 4 (gloo)", r4, "", (NSUB, NCHAN))

    # ---- 3e. the CLI session a user runs, on the archive as PSRFITS,
    # counted like the default whole clean and held to it
    cli_phase(ar, whole, counts["default"], tag)

    # ---- 3f. long profiles: an archive of 8192 bins (the DFT tables
    # streamed in chunks, two cells a group) on the default,
    # profile-baseline and dedispersed routes, masks held to the port's
    # CPU clean, each kernel to its plain version
    long_phase(configs, dev, tag)

    # ---- 3g. scaler lines longer than a block holds: K3 and K8 on
    # 50,000-entry lines (K9 and the tail kernels in place of K3), and an
    # exact stream at budget 0 of an archive of 48,000 subints, its mask
    # held to the whole clean's
    tail_entries = long_line_phase(dev, counts, clean_ms, tag)

    # ---- 4. each kernel against its plain version, at its route's
    # shapes: the first iteration's inputs of the same archive ----
    cfg = configs["default"]
    common = dict(chanthresh=cfg.chanthresh, subintthresh=cfg.subintthresh,
                  rotation=cfg.rotation, baseline_duty=cfg.baseline_duty)
    ri = route_inputs(ar, cube32, configs, dev)
    weights, mask, preps = ri["weights"], ri["mask"], ri["preps"]
    disp, template, rot_t, nyq = (ri[k] for k in ("disp", "template",
                                                  "rot_t", "nyq"))
    pd, t_d = ri["pd"], ri["t_d"]
    torch.cuda.synchronize()
    err1, ok1 = check_k1(disp, weights, "")
    diag_calls = diag_calls_for(ri)
    diag_err, diag_ok, diags = check_diags(diag_calls, mask, "")

    # K10 on the whole cube (a one-rank mesh's shard) and on one 2 x 2
    # shard: bit-equal to K2 and K6 on the same cells, and within K2's
    # tolerance of the plain version
    q = (slice(0, NSUB // 2), slice(0, NCHAN // 2))
    k10_in = {
        "shard_diagnostics_disp": {
            "whole cube": (disp, rot_t, nyq, template, weights, mask),
            "2x2 shard": (disp[q].contiguous(), rot_t[q[1]].contiguous(),
                          nyq[q[1]].contiguous(), template,
                          weights[q].contiguous(), mask[q].contiguous())},
        "shard_diagnostics_dedisp": {
            "whole cube": (pd.ded, t_d, pd.window, weights, mask),
            "2x2 shard": (pd.ded[q].contiguous(), t_d, pd.window,
                          weights[q].contiguous(), mask[q].contiguous())},
    }
    k10_twin = {
        "shard_diagnostics_disp": (K.cell_diagnostics_disp,
                                   K.cell_diagnostics_disp_plain),
        "shard_diagnostics_dedisp": (K.cell_diagnostics_dedisp,
                                     K.cell_diagnostics_dedisp_plain)}
    k10_err, k10_ok = {}, {}
    for name, ins in k10_in.items():
        twin, plain = k10_twin[name]
        k10_err[name], k10_ok[name] = 0.0, True
        for where, args in ins.items():
            got = getattr(K, name)(*args)
            bits = sum(bits_mismatch(g, w, torch)
                       for g, w in zip(got, twin(*args)))
            err, ok = diags_check(got, plain(*args), args[-1], torch)
            k10_err[name] = max(k10_err[name], err)
            k10_ok[name] &= ok and bits == 0
            print(f"check K10 {name} ({where}, {tuple(args[0].shape)}): "
                  f"{bits} cells differ in bits from {twin.__name__} "
                  f"(tolerance: bit-equal); against the plain version max "
                  f"abs {err:.3e}, tolerance rtol {K2_RTOL:g} of each "
                  f"plane's scale, masked cells exact: "
                  f"{'ok' if ok and bits == 0 else 'FAIL'}", flush=True)

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
    # K3 on the hand-made edge lines as rows and as columns of all four
    # diagnostics, 8 and 11 lines (11: a ragged last block of 8 columns)
    from tests.torch_median_edges import median_edge_lines, sides_edge_planes

    for axis in (0, 1):
        for nlines in (8, 11):
            ed, emk = sides_edge_planes(axis, nlines)
            ed, emk = [p.to(dev) for p in ed], emk.to(dev)
            bad = sum(bits_mismatch(g, w, torch) for g, w in zip(
                K.scaled_sides(ed, emk, axis, 5.0),
                K.scaled_sides_plain(ed, emk, axis, 5.0)))
            ok3[axis] &= bad == 0
            print(f"check K3 scaled_sides axis {axis} on the edge lines "
                  f"({nlines} lines of 7): {bad} cells differ in bits "
                  f"(tolerance: bit-equal, NaN included): "
                  f"{'ok' if bad == 0 else 'FAIL'}", flush=True)
    new_w, scores = K.combine_zap(sides[0], sides[1], weights)
    pw, ps = K.combine_zap_plain(sides[0], sides[1], weights)
    bad_c = bits_mismatch(scores, ps, torch) + bits_mismatch(new_w, pw, torch)
    errc = max(max_abs_diff(scores, ps, torch), max_abs_diff(new_w, pw, torch))
    okc = bad_c == 0
    print(f"check combine_zap: {bad_c} cells differ in bits, max abs "
          f"{errc:.3e} (tolerance: bit-equal, NaN included): "
          f"{'ok' if okc else 'FAIL'}", flush=True)
    thresholds = (cfg.chanthresh, cfg.subintthresh)
    fw, fs = K.fused_combine(diags, mask, weights, *thresholds)
    pfw, pfs = K.fused_combine_plain(diags, mask, weights, *thresholds)
    bad8 = bits_mismatch(fs, pfs, torch) + bits_mismatch(fw, pfw, torch)
    err8 = max(max_abs_diff(fs, pfs, torch), max_abs_diff(fw, pfw, torch))
    ok8 = bad8 == 0
    print(f"check K8 fused_combine: {bad8} cells differ in bits, max abs "
          f"{err8:.3e} (tolerance: bit-equal, NaN included): "
          f"{'ok' if ok8 else 'FAIL'}", flush=True)
    del fw, fs, pfw, pfs

    # K9 on the first iteration's d_std plane (K2's own output) and cell
    # mask: as the telemetry's one line, along both axes, and on the
    # hand-made edge lines; bit-equal, NaN by position
    from iterative_cleaner_torch.stats.masked_torch import (
        masked_median as sort_route_median,
    )

    d_std = diags[0]
    line_v, line_m = d_std.reshape(1, -1), mask.reshape(1, -1)
    ev, em = (t.to(dev) for t in median_edge_lines())
    k9_cases = {
        "telemetry line": (line_v, line_m, 1),
        "plane dim 0": (d_std, mask, 0),
        "plane dim 1": (d_std, mask, 1),
        "edge lines dim 1": (ev, em, 1),
        "edge lines dim 0": (ev.t().contiguous(), em.t().contiguous(), 0),
    }
    # the edge lines repeated into lines over 4096 entries: the grid route
    for reps in (600, 601):
        gv, gm = ev.repeat(1, reps), em.repeat(1, reps)
        k9_cases[f"edge lines x{reps} dim 1"] = (gv, gm, 1)
        k9_cases[f"edge lines x{reps} dim 0"] = (gv.t().contiguous(),
                                                  gm.t().contiguous(), 0)
    ok9, err9 = True, 0.0
    for where, (v, m, dim) in k9_cases.items():
        got = K.masked_median(v, m, dim)
        want = K.masked_median_keys(v, m, dim)[0]
        bad = bits_mismatch(got, want, torch) if got.shape == want.shape \
            else got.numel()
        err = max_abs_diff(got, want, torch) if where.startswith(
            ("telemetry", "plane")) else 0.0
        err9 = max(err9, err)
        ok9 &= bad == 0
        k9_route = K.masked_median_geometry(v.shape[dim], dim).route
        print(f"check K9 masked_median ({where}, {tuple(v.shape)} along dim "
              f"{dim}, {k9_route} route): {bad} of {got.numel()} medians "
              f"differ in bits, max "
              f"abs {err:.3e} (tolerance: bit-equal, NaN by position): "
              f"{'ok' if bad == 0 else 'FAIL'}", flush=True)
    # K9's device operations a call, counted in a torch.profiler trace:
    # at most 5 on the grid route (the scratch's memset and four passes),
    # 1 on the block route
    k9_ops = {}
    for where, limit in (("telemetry line", 5), ("plane dim 0", 1),
                         ("plane dim 1", 1)):
        v, m, dim = k9_cases[where]
        ops = device_ops(lambda: K.masked_median(v, m, dim))
        k9_ops[where] = sum(ops.values())
        good = 0 < k9_ops[where] <= limit
        ok9 &= good
        print(f"check K9 masked_median ({where}): {k9_ops[where]} device "
              f"operations a call in a torch.profiler trace "
              f"{json.dumps(ops)} (limit {limit}): "
              f"{'ok' if good else 'FAIL'}", flush=True)
    first = K.masked_median_keys(line_v, line_m, 1)[0].reshape(1)
    rstd0 = np.array([results["default"].iter_metrics[0, 2]], np.float32)
    same = int(rstd0.view(np.int32)[0]) == int(
        first.cpu().numpy().view(np.int32)[0])
    print(f"check the default clean's first residual_std "
          f"{float(rstd0[0])!r} against K9's plain version on K2's first "
          f"d_std plane {float(first[0])!r}: "
          f"{'bit-equal' if same else 'FAIL'}", flush=True)
    ok9 &= same
    if not (ok1 and all(diag_ok.values()) and all(k10_ok.values())
            and ok3[0] and ok3[1] and okc and ok8 and ok9):
        fail("a kernel disagrees with its plain version")

    # ---- 5. times: kernel, plain version, library yardstick, bound ----
    S, C, B = NSUB, NCHAN, NBIN
    cells = S * C
    nk = B // 2 + 1

    def bound(nbytes, nops):
        tb, to = nbytes / PEAK_BYTES_PER_S * 1e3, nops / PEAK_F32_PER_S * 1e3
        return (tb, "bytes") if tb >= to else (to, "operations")

    # The cell diagnostics' least work per cell: the residual, the fit and
    # the moments (about 12 operations a bin), and max_k |rfft(row)|,
    # whose least count is an FFT's: 2.5 B log2 B for a real row (half of
    # a complex FFT's 5 N log2 N) and 4 per k for |X_k|^2 and the max.
    # The kernels' DFT against tables does about 4 B (B/2 + 1) instead.
    diag_ops = cells * (2.5 * B * math.log2(B) + 4 * nk + 12 * B)
    # the weights, the mask and the four output planes
    diag_io = 4 * (cells + 4 * cells) + cells
    b1 = bound(4 * (cells * B + cells + C * B + S * B), 3 * cells * B)
    b2 = bound(4 * (cells * B + 2 * C * B + B) + diag_io, diag_ops)
    b7 = bound(4 * (2 * cells * B + C * B + B) + diag_io, diag_ops)
    b6 = bound(4 * (cells * B + 2 * B) + diag_io, diag_ops)
    # the select: 4 counting passes per median (the radix digits; the
    # upper middle comes from the last pass), 2 medians per diagnostic
    sel_ops = 4 * 2 * 4 * cells
    b3 = bound(cells * (4 * 4 + 1 + 4 * 4), sel_ops)
    bc = bound(cells * (9 * 4 + 2 * 4), 16 * cells)
    # K4 and K5 are one launch on the TPU: the cube and the template rows
    # in, the weights and mask in, new weights, scores and d_std out
    sweep_io = 4 * cells + cells + 3 * 4 * cells
    sweep_ops = diag_ops + 2 * sel_ops + 16 * cells
    b4 = bound(4 * (cells * B + 2 * C * B + B) + sweep_io, sweep_ops)
    b5 = bound(4 * (cells * B + 2 * B) + sweep_io, sweep_ops)
    # K8: four planes, the mask and the weights in, new weights and scores
    # out (29 bytes a cell); both orientations' selects and the combine
    b8 = bound(cells * (4 * 4 + 1 + 4 + 2 * 4), 2 * sel_ops + 16 * cells)
    # K10 on a 2 x 2 shard: K2's and K6's bounds at a quarter of the cells
    # and half of the channel rows
    b2q = bound(4 * (cells // 4 * B + C * B + B) + diag_io // 4,
                diag_ops / 4)
    b6q = bound(4 * (cells // 4 * B + 2 * B) + diag_io // 4, diag_ops / 4)
    # K9 on the telemetry's line: the values and the mask read once, one
    # float out; four passes of a few integer ops an entry
    n9 = line_v.numel()
    b9 = bound(5 * n9 + 4, 4 * 8 * n9)
    entries = [
        ("weighted_marginals", "marginals.cu", "_marginals_kernel :633",
         "default", err1,
         lambda: K.weighted_marginals(disp, weights),
         lambda: weighted_marginal_totals(disp, weights),
         lambda: (torch.einsum("sc,scb->cb", weights, disp),
                  torch.einsum("sc,scb->sb", weights, disp)), b1, 20),
        ("cell_diagnostics_disp", "cell_stats.cu",
         "_cell_stats_disp_kernel :909", "default",
         diag_err["cell_diagnostics_disp"],
         *diag_calls["cell_diagnostics_disp"][0], None, b2, 5),
        ("cell_diagnostics_two_read", "cell_stats.cu",
         "_cell_stats_kernel :852", "profile",
         diag_err["cell_diagnostics_two_read"],
         *diag_calls["cell_diagnostics_two_read"][0], None, b7, 5),
        ("cell_diagnostics_dedisp", "cell_stats.cu",
         "_cell_stats_dedisp_kernel :934", "dedispersed",
         diag_err["cell_diagnostics_dedisp"],
         *diag_calls["cell_diagnostics_dedisp"][0], None, b6, 5),
        ("scaled_sides_axis0", "scaled_sides.cu",
         "_scaled_sides_kernel :281", "default", err3[0],
         lambda: K.scaled_sides(diags, mask, 0, cfg.chanthresh),
         lambda: K.scaled_sides_plain(diags, mask, 0, cfg.chanthresh), None,
         b3, 10),
        ("scaled_sides_axis1", "scaled_sides.cu",
         "_scaled_sides_t_kernel :289", "default", err3[1],
         lambda: K.scaled_sides(diags, mask, 1, cfg.subintthresh),
         lambda: K.scaled_sides_plain(diags, mask, 1, cfg.subintthresh), None,
         b3, 10),
        ("combine_zap", "combine.cu", "_combine_zap :1555", "default", errc,
         lambda: K.combine_zap(sides[0], sides[1], weights),
         lambda: K.combine_zap_plain(sides[0], sides[1], weights), None,
         bc, 50),
        ("fused_combine", "scaled_sides.cu", "fused_combine_pallas :1836",
         "stream (a)", err8,
         lambda: K.fused_combine(diags, mask, weights, *thresholds),
         lambda: K.fused_combine_plain(diags, mask, weights, *thresholds),
         None, b8, 10),
        ("shard_diagnostics_disp", "shard_stats.cu",
         "sweep_shard_diags_disp :1469", "sharded 1 (default)",
         k10_err["shard_diagnostics_disp"],
         lambda: K.shard_diagnostics_disp(
             *k10_in["shard_diagnostics_disp"]["whole cube"]),
         lambda: K.cell_diagnostics_disp_plain(
             *k10_in["shard_diagnostics_disp"]["whole cube"]), None, b2, 5),
        ("shard_diagnostics_dedisp", "shard_stats.cu",
         "sweep_shard_diags_dedisp :1492", "sharded 1 (dedispersed)",
         k10_err["shard_diagnostics_dedisp"],
         lambda: K.shard_diagnostics_dedisp(
             *k10_in["shard_diagnostics_dedisp"]["whole cube"]),
         lambda: K.cell_diagnostics_dedisp_plain(
             *k10_in["shard_diagnostics_dedisp"]["whole cube"]), None, b6,
         5),
        ("masked_median", "masked_median.cu", "masked_median_pallas :1882",
         "default", err9, lambda: K.masked_median(line_v, line_m, 1),
         lambda: K.masked_median_keys(line_v, line_m, 1), None, b9, 50),
    ]
    k10_shard_bound = {"shard_diagnostics_disp": b2q,
                       "shard_diagnostics_dedisp": b6q}
    # K8 is a sequence: K3 per orientation (scaled_sides.cu), then the
    # combine kernel (combine.cu).  Its counter counts sequences; its
    # "launches" are those of its parts in the same run.
    k8_sources = ["iterative_cleaner_torch/stats/csrc/scaled_sides.cu",
                  "iterative_cleaner_torch/stats/csrc/combine.cu"]
    k8_parts = ["scaled_sides_axis0", "scaled_sides_axis1", "combine_zap"]
    kernels = []
    for (name, src, replaces, route, err, kfn, pfn, lfn, (bms, bby),
         reps) in entries:
        launches = counts[route][name]
        if name == "fused_combine":
            sequences = launches
            launches = sum(counts[route][k] for k in k8_parts)
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
        what = f"{launches} launches"
        if name in k10_in:
            # K10 on one 2 x 2 shard too, the shape each of four ranks
            # gives it
            args = k10_in[name]["2x2 shard"]
            sms = cuda_ms(lambda: getattr(K, name)(*args), reps * 2, torch)
            sbms, sbby = k10_shard_bound[name]
            kernels[-1].update(shard_shape=list(args[0].shape), shard_ms=sms,
                               shard_bound_ms=sbms, shard_bound_by=sbby)
            what += (f"; on a 2x2 shard {tuple(args[0].shape)}: {sms:.4f} "
                     f"ms, bound {sbms:.4f} ms ({sbby})")
        if name == "fused_combine":
            kernels[-1].update(sources=k8_sources, sequences=sequences,
                               parts=k8_parts)
            what += f" ({sequences} sequences of {', '.join(k8_parts)})"
        if name == "masked_median":
            # K9 along both axes of the plane, the sort route it replaced
            # on the telemetry's line, and its launches on every route
            d0 = cuda_ms(lambda: K.masked_median(d_std, mask, 0), reps, torch)
            d1 = cuda_ms(lambda: K.masked_median(d_std, mask, 1), reps, torch)
            sort_ms = cuda_ms(lambda: sort_route_median(line_v, line_m, 1),
                              10, torch)
            by_route = {r: c["masked_median"] for r, c in counts.items()}
            kernels[-1].update(dim0_ms=d0, dim1_ms=d1, sort_route_ms=sort_ms,
                               launches_by_route=by_route,
                               device_ops_per_call=k9_ops)
            what += (f"; device operations a call {json.dumps(k9_ops)}; "
                     f"along dim 0 of the plane {d0:.4f} ms, dim 1 "
                     f"{d1:.4f} ms; the sort route it replaced "
                     f"{sort_ms:.4f} ms; launches by route "
                     f"{json.dumps(by_route)}")
        lib = "null" if lms is None else f"{lms:.4f}"
        print(f"time {name}: {ms:.4f} ms, bound {bms:.4f} ms ({bby}), plain "
              f"{pms:.4f} ms, library {lib} ms, {what} on the {route} route "
              f"{tag}", flush=True)
    kernels.extend(tail_entries)
    ms_of = {k["name"]: k["ms"] for k in kernels}
    tail = (ms_of["scaled_sides_axis0"] + ms_of["scaled_sides_axis1"]
            + ms_of["combine_zap"])
    for seq, diag, (bms, bby) in (("K4", "cell_diagnostics_disp", b4),
                                  ("K5", "cell_diagnostics_dedisp", b5)):
        print(f"time {seq} as {diag} + scaled_sides x2 + combine_zap: "
              f"{ms_of[diag] + tail:.4f} ms, bound of the one-launch sweep "
              f"{bms:.4f} ms ({bby}) {tag}", flush=True)
    for route, prep in preps.items():
        iter_ms = cuda_ms(lambda: iteration_step(prep, weights, weights, mask,
                                                 **common), 5, torch)
        print(f"clean {route}: {results[route].loops} loops, whole clean "
              f"{clean_ms[route]:.1f} ms (upload, preamble, loop, download), "
              f"{iter_ms:.3f} ms per iteration (device, resident cubes), "
              f"peak device memory of the clean {peak_gib[route]:.2f} GiB "
              f"{tag}", flush=True)

    for route in SHARD_KERNELS:
        key = f"sharded 1 ({route})"
        iter_ms = cuda_ms(lambda: iteration_step(
            preps[route], weights, weights, mask, mesh=mesh1, **common), 5,
            torch)
        print(f"clean {key}: {results[key].loops} loops, whole clean "
              f"{clean_ms[key]:.1f} ms, {iter_ms:.3f} ms per iteration "
              f"(device, resident shard, one NCCL rank), peak device memory "
              f"of the clean {peak_gib[key]:.2f} GiB {tag}", flush=True)
    distributed.shutdown()
    shutil.rmtree(store_dir, ignore_errors=True)

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
