"""Operator utilities: ``python -m iterative_cleaner_torch.tools <cmd>``.

- ``info PATH``: an archive's metadata and zapped fraction as one JSON
  object, from its header and weights only (``.icar``, PSRFITS or
  ``.npz``); the data cube is never read.
- ``convert SRC DST``: between the containers, each by its extension
  (``.npz``, ``.icar``, PSRFITS ``.sf``/``.rf``/``.fits``/``.ar``;
  TIMER-format ``.ar`` through the psrchive bridge).

- ``selftest [--device D]``: the installation check.  Cleans a synthetic
  archive with known RFI on the float64 numpy oracle and on the torch
  engine in float64 on ``--device`` (default ``cuda``, the card's float64
  kernel builds; ``cpu`` their plain versions), and exits 0 only when the
  two masks are bit-identical and the injected RFI is flagged.  Without
  a card it exits 1 unless ``--device cpu`` is given: it never falls back
  to the CPU.

- ``diff A B``: the mask regression diff of two checkpoints
  (``--checkpoint``, either package's), two cleaned archives or one of
  each, as one JSON object; exit 1 when the masks differ.  Only the
  weights are read (``.icar`` by header offset, PSRFITS by its header
  and weights column, ``.npz`` member by member), never the cube.
- ``sweep PATH``: the archive loaded once and cleaned across a
  ``-c`` x ``-s`` threshold grid, one JSON line per point (zap fractions,
  loops, convergence), with ``--model`` (the flagship or quicklook),
  ``--backend torch|numpy`` and ``--device`` (default ``cuda``).
- ``borderline PATH``: one clean, then every decision whose score lies
  within ``--eps`` of the threshold, one JSON line per cell and a
  summary: the cells whose zap a float32 clean may decide differently
  from the float64 oracle (``--backend numpy``, the default) or under
  other thresholds.  ``--backend torch`` cleans on ``--device``.

Every command that cleans on the torch backend runs on ``--device``
(default ``cuda``) and raises where no card is present unless
``--device cpu`` is given: none falls back to the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import zipfile

import numpy as np


def _is_checkpoint(path: str) -> bool:
    """Whether ``path`` is an ``.npz`` checkpoint (any unreadable or
    foreign file is not one: an archive)."""
    try:
        with np.load(path, allow_pickle=False) as z:
            return "version" in z.files and "final_weights" in z.files
    except (OSError, ValueError, EOFError, zipfile.BadZipFile):
        return False


def _load_weights(path: str):
    """The (nsub, nchan) weights of a checkpoint or an archive, never its
    cube."""
    from iterative_cleaner_torch.io import native, psrfits

    if path.endswith(".icar"):
        return native.read_icar_weights(path)
    if psrfits.is_fits(path):
        return psrfits.read_psrfits_info(path)[1]
    with np.load(path, allow_pickle=False) as z:
        return z["final_weights" if "final_weights" in z.files
                 else "weights"]


def cmd_diff(args) -> int:
    from iterative_cleaner_torch.utils import checkpoint as ckpt

    if _is_checkpoint(args.a) and _is_checkpoint(args.b):
        out = ckpt.diff_checkpoints(args.a, args.b)
    else:
        out = ckpt.diff_masks(_load_weights(args.a), _load_weights(args.b))
    print(json.dumps(out))
    return 1 if out["changed"] else 0


def _clean_config(args, **thresholds):
    from iterative_cleaner_torch.config import CleanConfig

    return CleanConfig(backend=args.backend, max_iter=args.max_iter,
                       device=args.device, **thresholds)


def cmd_sweep(args) -> int:
    """The reference's rows: thresholds, the final and the newly zapped
    fractions (rounded to 6 places), loops and convergence."""
    from iterative_cleaner_torch.io import load_archive
    from iterative_cleaner_torch.models import get_model

    ar = load_archive(args.path)
    prezap = np.asarray(ar.weights) == 0
    clean_fn = get_model(args.model)
    for c in args.chanthresh:
        for s in args.subintthresh:
            res = clean_fn(ar, _clean_config(args, chanthresh=float(c),
                                             subintthresh=float(s)))
            new = res.zap_mask() & ~prezap
            print(json.dumps({
                "chanthresh": float(c), "subintthresh": float(s),
                "rfi_frac": round(res.rfi_fraction, 6),
                "new_zap_frac": round(float(new.mean()), 6),
                "loops": int(res.loops),
                "converged": bool(res.converged),
            }), flush=True)
    return 0


def cmd_borderline(args) -> int:
    """The cells whose final score is within ``--eps`` of 1, pre-zapped
    cells left out (they stay zapped whatever their score: not
    decisions), then the reference's summary line."""
    from iterative_cleaner_torch.io import load_archive
    from iterative_cleaner_torch.models import get_model

    ar = load_archive(args.path)
    prezap = np.asarray(ar.weights) == 0
    res = get_model(args.model)(ar, _clean_config(
        args, chanthresh=args.chanthresh, subintthresh=args.subintthresh))
    s = np.asarray(res.scores, dtype=np.float64)
    zapped = res.zap_mask()
    band = np.isfinite(s) & (np.abs(s - 1.0) < args.eps) & ~prezap
    for isub, ichan in np.argwhere(band):
        print(json.dumps({
            "isub": int(isub), "ichan": int(ichan),
            "score": round(float(s[isub, ichan]), 6),
            "zapped": bool(zapped[isub, ichan]),
        }), flush=True)
    print(json.dumps({
        "total_cells": int(s.size),
        "borderline": int(band.sum()),
        "zapped_borderline": int((band & zapped).sum()),
        "eps": args.eps, "loops": int(res.loops),
    }), flush=True)
    return 0


def cmd_convert(args) -> int:
    from iterative_cleaner_torch.io import load_archive, save_archive

    save_archive(load_archive(args.src), args.dst)
    return 0


def _npz_info(path: str):
    """(meta, weights) of an ``.npz`` archive: its members decompress
    one by one, and the cube's dims come from the ``data.npy`` member's
    header."""
    with np.load(path, allow_pickle=False) as z, \
            zipfile.ZipFile(path) as zf:
        with zf.open("data.npy") as f:
            version = np.lib.format.read_magic(f)
            if version >= (2, 0):
                shape, _, _ = np.lib.format.read_array_header_2_0(f)
            else:
                shape, _, _ = np.lib.format.read_array_header_1_0(f)
        meta = {
            "source": str(z["source"]),
            "nsub": int(shape[0]), "npol": int(shape[1]),
            "nchan": int(shape[2]), "nbin": int(shape[3]),
            "dm": float(z["dm"]), "period_s": float(z["period_s"]),
            "centre_freq_mhz": float(z["centre_freq_mhz"]),
            "mjd_start": float(z["mjd_start"]),
            "mjd_end": float(z["mjd_end"]),
            "pol_state": str(z["pol_state"]),
        }
        return meta, z["weights"]


_INFO_KEYS = ("source", "nsub", "npol", "nchan", "nbin", "dm", "period_s",
              "centre_freq_mhz", "mjd_start", "mjd_end", "pol_state")


def cmd_info(args) -> int:
    from iterative_cleaner_torch.io import native, psrfits

    if args.path.endswith(".icar"):
        meta = native.read_icar_header(args.path)
        weights = native.read_icar_weights(args.path)
    elif psrfits.is_fits(args.path):
        meta, weights = psrfits.read_psrfits_info(args.path)
    else:
        meta, weights = _npz_info(args.path)
    info = {k: meta[k] for k in _INFO_KEYS}
    info["rfi_frac"] = float((np.asarray(weights) == 0).mean())
    print(json.dumps(info))
    return 0


def cmd_selftest(args) -> int:
    """Clean the reference selftest's synthetic archive (16 x 32 x 128,
    seed 0, 5 prezapped cells, RFI at 60 sigma) on both backends at
    float64; fail unless the masks are bit-identical and at least 60% of
    the injected-RFI cells are flagged (the reference's bound)."""
    import torch

    from iterative_cleaner_torch.backends import clean_archive
    from iterative_cleaner_torch.config import CleanConfig
    from iterative_cleaner_torch.io.synthetic import make_synthetic_archive

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print(f"FAIL: device {args.device!r} requested but no CUDA device "
              f"is present; pass --device cpu to check the plain versions")
        return 1
    ar, truth = make_synthetic_archive(nsub=16, nchan=32, nbin=128, seed=0,
                                       n_prezapped=5, rfi_strength=60.0)
    results = {}
    for backend in ("numpy", "torch"):
        results[backend] = clean_archive(
            ar.clone(), CleanConfig(backend=backend, dtype="float64",
                            device=args.device))
        where = "host" if backend == "numpy" else (
            torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
        print(f"{backend:5s} [{where}]: loops={results[backend].loops} "
              f"rfi_frac={results[backend].rfi_fraction:.4f}")
    a = results["numpy"].final_weights == 0
    b = results["torch"].final_weights == 0
    if not np.array_equal(a, b):
        print(f"FAIL: backend masks differ on "
              f"{int((a != b).sum())}/{a.size} cells")
        return 1
    expected = truth.expected_zap(ar.nsub, ar.nchan)
    caught = (b & expected).sum()
    if caught < 0.6 * expected.sum():
        print(f"FAIL: only {caught}/{int(expected.sum())} injected-RFI "
              "cells flagged")
        return 1
    print(f"OK: masks bit-identical across backends; "
          f"{caught}/{int(expected.sum())} injected-RFI cells flagged")
    return 0


def _clean_options(p, default_backend: str) -> None:
    """The options of a command that cleans: ``-m``, ``--backend``,
    ``--model`` and ``--device``."""
    p.add_argument("-m", "--max_iter", type=int, default=5)
    p.add_argument("--backend", choices=("torch", "numpy"),
                   default=default_backend)
    p.add_argument("--model", choices=("surgical_scrub", "quicklook"),
                   default="surgical_scrub")
    p.add_argument("--device", default="cuda",
                   help="torch device of --backend torch (default cuda; "
                        "cpu runs the kernels' plain versions)")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m iterative_cleaner_torch.tools",
        description="Checkpoint/regression and container utilities of the "
                    "port")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("diff", help="mask diff of two checkpoints/archives "
                                    "(exit 1 if masks differ)")
    p.add_argument("a")
    p.add_argument("b")
    p.set_defaults(fn=cmd_diff)

    p = sub.add_parser("convert", help="convert between archive containers")
    p.add_argument("src")
    p.add_argument("dst")
    p.set_defaults(fn=cmd_convert)

    p = sub.add_parser("info", help="print archive metadata as JSON")
    p.add_argument("path")
    p.set_defaults(fn=cmd_info)

    p = sub.add_parser("sweep",
                       help="clean one archive across a chanthresh x "
                            "subintthresh grid; one JSON line per point "
                            "(zap fractions, loops)")
    p.add_argument("path")
    p.add_argument("-c", "--chanthresh", type=float, nargs="+",
                   default=[3.0, 4.0, 5.0, 6.0, 8.0])
    p.add_argument("-s", "--subintthresh", type=float, nargs="+",
                   default=[3.0, 4.0, 5.0, 6.0, 8.0])
    _clean_options(p, default_backend="torch")
    p.set_defaults(fn=cmd_sweep)

    p = sub.add_parser("borderline",
                       help="list zap decisions within --eps of the "
                            "threshold (precision/convention-sensitive "
                            "cells); one JSON line per cell + a summary")
    p.add_argument("path")
    p.add_argument("--eps", type=float, default=0.05)
    p.add_argument("-c", "--chanthresh", type=float, default=5.0)
    p.add_argument("-s", "--subintthresh", type=float, default=5.0)
    _clean_options(p, default_backend="numpy")
    p.set_defaults(fn=cmd_borderline)

    p = sub.add_parser("selftest",
                       help="end-to-end installation check: clean a "
                            "synthetic archive on the numpy oracle and "
                            "the torch engine at float64, assert "
                            "bit-identical masks + RFI catch (exit 0 = ok)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the engine's clean (default "
                        "cuda; cpu runs the kernels' plain versions)")
    p.set_defaults(fn=cmd_selftest)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
