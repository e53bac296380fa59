"""Operator utilities: ``python -m iterative_cleaner_torch.tools <cmd>``.

- ``info PATH``: an archive's metadata and zapped fraction as one JSON
  object, from its header and weights only (``.icar``, PSRFITS or
  ``.npz``); the data cube is never read.
- ``convert SRC DST``: between the containers, each by its extension
  (``.npz``, ``.icar``, PSRFITS ``.sf``/``.rf``/``.fits``/``.ar``;
  TIMER-format ``.ar`` through the psrchive bridge).

``diff``, ``sweep``, ``borderline`` and ``selftest`` are parsed as the
reference package's tools parse them and raise ``NotImplementedError``:
ROADMAP.md 'Modules still to port' item 2c (checkpoints and models).
"""

from __future__ import annotations

import argparse
import json
import sys
import zipfile

import numpy as np

_NOT_PORTED = ("is not ported yet (ROADMAP.md 'Modules still to port' item "
               "2c: checkpoints and models)")


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


def _not_ported(args) -> int:
    raise NotImplementedError(f"tools {args.cmd} {_NOT_PORTED}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m iterative_cleaner_torch.tools",
        description="Container utilities of the port")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("diff", help="mask diff of two checkpoints/archives "
                                    "(not ported yet)")
    p.add_argument("a")
    p.add_argument("b")
    p.set_defaults(fn=_not_ported)

    p = sub.add_parser("convert", help="convert between archive containers")
    p.add_argument("src")
    p.add_argument("dst")
    p.set_defaults(fn=cmd_convert)

    p = sub.add_parser("info", help="print archive metadata as JSON")
    p.add_argument("path")
    p.set_defaults(fn=cmd_info)

    p = sub.add_parser("sweep", help="threshold sweep (not ported yet)")
    p.add_argument("path")
    p.add_argument("-c", "--chanthresh", type=float, nargs="+",
                   default=[3.0, 4.0, 5.0, 6.0, 8.0])
    p.add_argument("-s", "--subintthresh", type=float, nargs="+",
                   default=[3.0, 4.0, 5.0, 6.0, 8.0])
    p.add_argument("-m", "--max_iter", type=int, default=5)
    p.add_argument("--backend", choices=("jax", "numpy"), default="jax")
    p.add_argument("--model", choices=("surgical_scrub", "quicklook"),
                   default="surgical_scrub")
    p.set_defaults(fn=_not_ported)

    p = sub.add_parser("borderline",
                       help="zap decisions near the threshold (not ported "
                            "yet)")
    p.add_argument("path")
    p.add_argument("--eps", type=float, default=0.05)
    p.add_argument("-c", "--chanthresh", type=float, default=5.0)
    p.add_argument("-s", "--subintthresh", type=float, default=5.0)
    p.add_argument("-m", "--max_iter", type=int, default=5)
    p.add_argument("--backend", choices=("jax", "numpy"), default="numpy")
    p.add_argument("--model", choices=("surgical_scrub", "quicklook"),
                   default="surgical_scrub")
    p.set_defaults(fn=_not_ported)

    p = sub.add_parser("selftest", help="installation check (not ported "
                                        "yet)")
    p.set_defaults(fn=_not_ported)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
