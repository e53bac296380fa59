"""Command line of the port: the reference CLI's single-archive path.

``python -m iterative_cleaner_torch [-c] [-s] [-m] [-r] [-u] [-o]
[--bad_chan] [--bad_subint] [--baseline_mode] [--stats_frame] [--device]
[--stream N [--stream_mode exact|online] [--stream_hbm_mb MB]]
[--mesh off|cell] obs.npz``
cleans each archive, writes ``obs.npz_cleaned.npz`` (the input's data
with the cleaned weights), with ``-u`` also the single-pol residual
archive ``obs.npz_residual_<loops>.npz`` in the working directory, and
appends the reference-format line to ``clean.log`` beside the output.
``--stream N`` cleans in N-subint tiles (``parallel/streaming.py``).
``--mesh cell`` cleans each archive over the ranks of a
``torch.distributed`` job (``parallel/sharding.py``), started as
``torchrun --nproc_per_node N -m iterative_cleaner_torch --mesh cell
obs.npz``: one rank per card (NCCL), or gloo ranks with ``--device
cpu``; every rank reads the archive and keeps its block, and rank 0
alone prints, writes the output and ``clean.log``.  The rest of the
reference's flag surface is not ported yet (ROADMAP.md 'Modules still to
port' item 2; the live ``--stream DIR`` session, item 5; ``--mesh
batch``, item 3).
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import os
import sys

from iterative_cleaner_torch.config import MESH_MODES, CleanConfig, check_mesh
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
    p.add_argument("-u", "--unload_res", action="store_true",
                   help="Also write the pulse-free residual archive.")
    p.add_argument("-r", "--pulse_region", nargs=3, type=float,
                   default=[0, 0, 1],
                   metavar=("pulse_start", "pulse_end", "scaling_factor"),
                   help="Pulse window and suppression factor. NOTE: "
                        "consumed as (factor, start, end), matching the "
                        "reference implementation's behaviour.")
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
    p.add_argument("--stats_frame",
                   choices=("auto", "dispersed", "dedispersed"),
                   default="auto",
                   help="Frame the detection statistics run in: "
                        "'dispersed' (= auto) re-rotates the residual "
                        "exactly like the reference; 'dedispersed' skips "
                        "that rotation (one cube read per iteration; with "
                        "the fourier rotation borderline cells can zap "
                        "differently).")
    p.add_argument("--baseline_mode", choices=("integration", "profile"),
                   default="integration",
                   help="Baseline estimator: 'integration' (default) places "
                        "one window per subintegration at the weighted "
                        "total profile's smoothed minimum; 'profile' takes "
                        "each profile's own min-mean window.")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to clean on (default cuda; 'cpu' "
                        "runs the kernels' plain PyTorch versions).")
    p.add_argument("--stream", type=str, default="0", metavar="CHUNK",
                   help="An integer CHUNK > 0 cleans each archive in "
                        "CHUNK-subint tiles (--stream_mode) instead of "
                        "one device footprint: for archives larger than "
                        "the card. 0 (default) disables.")
    p.add_argument("--stream_mode", choices=("exact", "online"),
                   default="exact",
                   help="exact (default): masks equal to the whole "
                        "clean's, two passes over the tiles per "
                        "iteration, the tiles held in host memory. "
                        "online: each tile cleaned on its own; its "
                        "scalers see only the tile's subints.")
    p.add_argument("--stream_hbm_mb", type=float, default=None,
                   metavar="MB",
                   help="Device byte budget (MiB) of the exact mode's "
                        "tile cache: tiles that fit stay on the card. "
                        "Default: 40%% of the card's memory. 0 pins "
                        "nothing.")
    p.add_argument("--mesh", choices=MESH_MODES, default="off",
                   help="Multi-GPU execution: 'cell' shards each archive's "
                        "(subint x channel) grid over the ranks of a "
                        "torchrun job, one rank per card (or gloo ranks "
                        "on the CPU with --device cpu); uneven grids are "
                        "zero-weight padded and cropped back. 'batch' is "
                        "not ported yet.")
    return p


def stream_chunk(value: str) -> int:
    """``--stream``'s tile size; 0 disables streaming.  A directory (the
    reference's live online session) is not ported."""
    try:
        chunk = int(value)
    except ValueError:
        raise NotImplementedError(
            f"--stream {value!r}: the live online session over a "
            f"directory is not ported yet: ROADMAP.md 'Modules still to "
            f"port' item 5 (online)") from None
    if chunk < 0:
        raise ValueError(f"--stream must be >= 0, got {chunk}")
    return chunk


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


def config_of(args) -> CleanConfig:
    return CleanConfig(chanthresh=args.chanthresh,
                       subintthresh=args.subintthresh,
                       max_iter=args.max_iter,
                       pulse_region=tuple(args.pulse_region),
                       bad_chan=args.bad_chan, bad_subint=args.bad_subint,
                       stats_frame=args.stats_frame,
                       baseline_mode=args.baseline_mode,
                       unload_res=args.unload_res, device=args.device,
                       stream_hbm_mb=args.stream_hbm_mb)


def clean_one(in_path: str, args, mesh=None):
    """Clean one archive and write its output; returns the output's name.
    Under ``mesh`` (``--mesh cell``) every rank cleans its block and only
    rank 0 reports and writes (the others return None)."""
    from iterative_cleaner_torch.backends import (
        clean_archive,
        clean_archive_sharded,
    )
    from iterative_cleaner_torch.parallel import clean_streaming

    ar = load_archive(in_path)
    cfg = config_of(args)
    if mesh is None or mesh.rank == 0:
        print("Total number of profiles: %s" % ar.weights.size)
    chunk = stream_chunk(args.stream)
    if mesh is not None:
        result = clean_archive_sharded(ar, cfg, mesh)
        if result is None:
            return None
    elif chunk > 0:
        result = clean_streaming(ar, chunk, cfg, mode=args.stream_mode)
    else:
        result = clean_archive(ar, cfg)
    if result.loop_diffs is not None:   # the online mode has none
        for i, (d, f) in enumerate(zip(result.loop_diffs,
                                       result.loop_rfi_frac), start=1):
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
    ar_name = ar.display_name() or os.path.basename(in_path)
    if args.unload_res:
        # the residual is total intensity, so the archive is single-pol
        res_ar = dataclasses.replace(
            ar, data=result.residual[:, None, :, :].astype(ar.data.dtype),
            pol_state="Intensity", filename="")
        save_archive(res_ar, "%s_residual_%s%s" % (
            ar_name, result.loops, os.path.splitext(o_name)[1]))
    append_clean_log(ar_name, args, result.loops,
                     os.path.join(os.path.dirname(o_name) or ".",
                                  "clean.log"))
    print("Cleaned archive: %s" % o_name)
    return o_name


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    # refuse a directory, and what the mesh does not run, before any clean
    streaming = stream_chunk(args.stream) > 0
    check_mesh(args.mesh, config_of(args), streaming=streaming)
    if args.mesh == "off":
        for path in args.archive:
            clean_one(path, args)
        return 0
    from iterative_cleaner_torch.parallel import distributed
    from iterative_cleaner_torch.parallel.mesh import cell_mesh

    distributed.initialize(device=args.device)
    try:
        mesh = cell_mesh()
        for path in args.archive:
            clean_one(path, args, mesh)
    finally:
        distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
