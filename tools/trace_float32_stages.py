"""Trace where a float32 clean on the card parts from the float32 clean
on the CPU: the first iteration's stages (dispersion shifts, the
integration baseline's offsets, the prepared cube, K1's marginals, the
template, the rotated template rows, the four diagnostic planes, the
scores), each as its largest distance from the float64 CPU clean's over
that stage's float64 scale, on the card and on the CPU; then the card's
cell diagnostics on the CPU's float32 inputs; then the whole cleans'
scores against the float64 clean's.

    python tools/trace_float32_stages.py [--shape NSUB NCHAN NBIN]
        [--seed S]

A synthetic archive of ``--shape`` (default 4 x 8 x 32768, the long-
profile card tests' archive) from ``--seed`` (default 41), on the
default, dedispersed and profile-baseline routes.  Scores are compared
as the tests compare them: the largest |got - want| / (|want| + 1e-3).
Prints the card's name and power limit, one line a stage and one JSON
line.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch


def _first_iteration(ar, cfg, dev):
    """The first iteration's stages of ``cfg``'s route on ``ar`` on
    ``dev`` in ``cfg.dtype`` (the cube copied, so the in-place baseline
    subtraction leaves ``ar`` as it is); returns the stages on the CPU in
    float64, and the prepared operands."""
    import iterative_cleaner_torch.engine.loop as loop
    from iterative_cleaner_torch.stats import kernels as K

    npd = np.float64 if cfg.dtype == "float64" else np.float32
    real = torch.float64 if cfg.dtype == "float64" else torch.float32
    w = torch.from_numpy(np.array(ar.weights, dtype=npd)).to(dev)
    meta = [torch.from_numpy(np.array(ar.freqs_mhz, dtype=npd)).to(dev)]
    meta += [torch.tensor(v, dtype=real, device=dev)
             for v in (ar.dm, ar.centre_freq_mhz, ar.period_s)]
    cube = torch.from_numpy(np.array(ar.total_intensity(), dtype=npd)).to(dev)
    prep = loop.prepare(cube, w, *meta, cfg, dedispersed=ar.dedispersed)
    t = loop.build_template(prep, w, rotation=cfg.rotation,
                            baseline_duty=cfg.baseline_duty)
    st = {"shifts": prep.back_shifts, "offsets": prep.base_offsets}
    if prep.route == "default":
        st["disp_base"] = prep.disp_base
        st["K1 A"], st["K1 t1"] = K.weighted_marginals(prep.disp_base, w)
        st["rot_t"] = loop._dispersed_rows(prep, t, cfg.rotation)[0]
    else:
        st["ded"] = prep.ded
    st["template"] = t
    diags = loop.route_diagnostics(prep, t, w, w == 0, rotation=cfg.rotation)
    st.update(zip(("d_std", "d_mean", "d_ptp", "d_fft"), diags))
    st["scores"] = loop.scores_and_zap(diags, w == 0, w, cfg.chanthresh,
                                       cfg.subintthresh)[1]
    return ({k: v.cpu().double() for k, v in st.items() if v is not None},
            (prep, t, w))


def _rel(x, ref):
    """The largest |x - ref| over the finite cells, over max |ref| there
    (the masked cells' 1e20 fill left out)."""
    m = torch.isfinite(ref) & (ref.abs() < 1e19)
    scale = float(ref[m].abs().max())
    return float((x - ref)[m].abs().max()) / scale if scale else 0.0


def _score_err(got, want):
    return float(np.max(np.abs(got - want) / (np.abs(want) + 1e-3)))


def main() -> None:
    import iterative_cleaner_torch.engine.loop as loop
    from iterative_cleaner_torch import CleanConfig
    from iterative_cleaner_torch.backends import clean_archive
    from iterative_cleaner_torch.io.synthetic import make_synthetic_archive

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shape", type=int, nargs=3, default=(4, 8, 32768))
    ap.add_argument("--seed", type=int, default=41)
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    nsub, nchan, nbin = args.shape
    ar, _ = make_synthetic_archive(nsub=nsub, nchan=nchan, nbin=nbin,
                                   n_prezapped=2, seed=args.seed)
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    report = {"card": card, "shape": list(args.shape), "seed": args.seed,
              "routes": {}}
    for name, kw in (("default", {}),
                     ("dedispersed", dict(stats_frame="dedispersed")),
                     ("profile", dict(baseline_mode="profile"))):
        cfg = CleanConfig(**kw)
        card32, _ = _first_iteration(ar, cfg, cuda)
        cpu32, (prep, t, w) = _first_iteration(ar, cfg, cpu)
        cpu64, _ = _first_iteration(ar, CleanConfig(dtype="float64", **kw),
                                    cpu)
        row = {"stages": {}, "card_on_cpu_inputs": {}}
        for k in cpu64:
            d = row["stages"][k] = {"card": _rel(card32[k], cpu64[k]),
                                    "cpu": _rel(cpu32[k], cpu64[k])}
            print(f"{name} {k}: card {d['card']:.3e}, cpu {d['cpu']:.3e} of "
                  f"the float64 scale [{card}]", flush=True)
        # the card's cell diagnostics on the CPU's float32 operands
        on = loop.Prepared(*(x.to(cuda) if isinstance(x, torch.Tensor)
                             else x for x in prep))
        wc = w.to(cuda)
        diags = loop.route_diagnostics(on, t.to(cuda), wc, wc == 0,
                                       rotation=cfg.rotation)
        for k, x in zip(("d_std", "d_mean", "d_ptp", "d_fft"), diags):
            e = row["card_on_cpu_inputs"][k] = _rel(x.cpu().double(),
                                                    cpu32[k])
            print(f"{name} {k} on the card from the CPU's float32 operands: "
                  f"{e:.3e} of the CPU's scale [{card}]", flush=True)
        on_card = clean_archive(ar, cfg)
        on_cpu = clean_archive(ar, CleanConfig(device="cpu", **kw))
        f64 = clean_archive(ar, CleanConfig(device="cpu", dtype="float64",
                                            **kw))
        row["scores"] = {"card": _score_err(on_card.scores, f64.scores),
                         "cpu": _score_err(on_cpu.scores, f64.scores),
                         "masks_equal": bool(np.array_equal(
                             on_card.final_weights == 0,
                             on_cpu.final_weights == 0)),
                         "loops": [on_card.loops, on_cpu.loops, f64.loops]}
        print(f"{name} whole clean, scores against the float64 clean's: card "
              f"{row['scores']['card']:.4f}, cpu {row['scores']['cpu']:.4f}; "
              f"masks equal {row['scores']['masks_equal']}, loops "
              f"{row['scores']['loops']} [{card}]", flush=True)
        report["routes"][name] = row
    print(json.dumps(report))


if __name__ == "__main__":
    main()
