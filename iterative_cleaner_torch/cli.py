"""Command line of the port: the reference CLI's single-archive path.

``python -m iterative_cleaner_torch [-c] [-s] [-m] [-o] [--bad_chan]
[--bad_subint] [--device] obs.npz`` cleans each archive, writes
``obs.npz_cleaned.npz`` (the input's data with the cleaned weights) and
appends the reference-format line to ``clean.log`` beside the output.
The rest of the reference's flag surface is not ported yet (ROADMAP.md
'Modules still to port' item 2).
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import os
import sys

from iterative_cleaner_torch.config import CleanConfig
from iterative_cleaner_torch.io import load_archive, save_archive


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m iterative_cleaner_torch",
        description="Iterative RFI cleaner (PyTorch/CUDA port)")
    p.add_argument("archive", nargs="+", help="The chosen archives (.npz)")
    p.add_argument("-c", "--chanthresh", type=float, default=5,
                   metavar="channel_threshold",
                   help="Sigma threshold for a profile to stand out "
                        "against the rest of its channel.")
    p.add_argument("-s", "--subintthresh", type=float, default=5,
                   metavar="subint_threshold",
                   help="Sigma threshold for a profile to stand out "
                        "against the rest of its subint.")
    p.add_argument("-m", "--max_iter", type=int, default=5,
                   metavar="maximum_iterations",
                   help="Maximum number of cleaning iterations.")
    p.add_argument("-o", "--output", type=str, default="",
                   metavar="output_filename",
                   help="Output filename. 'std' uses the pattern "
                        "NAME.FREQ.MJD.<ext>.")
    p.add_argument("--bad_chan", type=float, default=1,
                   help="Fraction of removed subints above which the "
                        "whole channel is removed.")
    p.add_argument("--bad_subint", type=float, default=1,
                   help="Fraction of removed channels above which the "
                        "whole subint is removed.")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to clean on (default cuda; 'cpu' "
                        "runs the kernels' plain PyTorch versions).")
    return p


def output_name(ar, args, in_path: str) -> str:
    """Reference naming rules; the output keeps the input's extension."""
    ext = os.path.splitext(in_path)[1] or ".npz"
    if args.output == "":
        return in_path + "_cleaned" + ext
    if args.output == "std":
        return "%s.%.3f.%f%s" % (ar.source, ar.centre_freq_mhz, ar.mjd_mid,
                                 ext)
    return args.output


def append_clean_log(ar_name, args, loops, log_path) -> None:
    """The reference's clean.log line: timestamp, archive name, the
    argument namespace and the loop count."""
    with open(log_path, "a") as f:
        f.write("\n %s: Cleaned %s with %s, required loops=%s"
                % (datetime.datetime.now(), ar_name, args, loops))


def clean_one(in_path: str, args) -> str:
    from iterative_cleaner_torch.backends import clean_archive

    ar = load_archive(in_path)
    cfg = CleanConfig(chanthresh=args.chanthresh,
                      subintthresh=args.subintthresh,
                      max_iter=args.max_iter, bad_chan=args.bad_chan,
                      bad_subint=args.bad_subint, device=args.device)
    print("Total number of profiles: %s" % ar.weights.size)
    result = clean_archive(ar, cfg)
    for i, (d, f) in enumerate(zip(result.loop_diffs, result.loop_rfi_frac),
                               start=1):
        print("Loop: %s" % i)
        print("Differences to previous weights: %s  RFI fraction: %s"
              % (int(d), float(f)))
    if result.converged:
        print("RFI removal stops after %s loops." % result.loops)
    else:
        print("Cleaning was interrupted after the maximum amount of loops "
              "(%s)" % cfg.max_iter)
    if result.n_bad_subints + result.n_bad_channels:
        print("Removed %s bad subintegrations and %s bad channels."
              % (result.n_bad_subints, result.n_bad_channels))
    out = dataclasses.replace(
        ar, weights=result.final_weights.astype(ar.weights.dtype))
    o_name = output_name(ar, args, in_path)
    save_archive(out, o_name)
    append_clean_log(ar.display_name() or os.path.basename(in_path), args,
                     result.loops,
                     os.path.join(os.path.dirname(o_name) or ".",
                                  "clean.log"))
    print("Cleaned archive: %s" % o_name)
    return o_name


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    for path in args.archive:
        clean_one(path, args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
