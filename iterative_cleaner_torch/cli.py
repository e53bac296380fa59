"""Command line of the port: the reference CLI's session over archives.

``python -m iterative_cleaner_torch [-c] [-s] [-m] [-u] [-p] [-q] [-l]
[-r] [-o] [--bad_chan] [--bad_subint] [--baseline_mode] [--stats_frame]
[--device] [--stream N [--stream_mode exact|online] [--stream_hbm_mb MB]]
[--mesh off|cell] [--metrics-json PATH] [--prom-textfile PATH]
[--event-log PATH] [--log-format text|json] [--timing] [--keep_going]
obs.sf ...``
cleans each archive (``.npz``, or fold-mode PSRFITS: ``.sf``, ``.rf``,
``.fits``, ``.psrfits`` and ``.ar`` files with the FITS magic), writes
``obs.sf_cleaned.sf`` (the input's data with the cleaned weights; ``-p``
pscrunched), with ``-u`` also the single-pol residual archive
``obs.sf_residual_<loops>.sf`` in the working directory, and appends the
reference-format line to ``clean.log`` beside the output (not with
``-l``).  One session spans all the archives: ``--metrics-json`` writes
the run report (counters, phase times, each archive's iteration history,
whose ``residual_std`` kernel K9 computes), ``--prom-textfile`` the same
metrics in Prometheus text, ``--log-format json`` (or ``--event-log
PATH``) a JSON-lines event log (``clean.events.jsonl``), and ``--timing``
one ``Timing:`` line of the load, clean and write seconds at the end.
An archive that fails ends the session with its exception; with
``--keep_going`` it is recorded, printed to stderr, the others are
cleaned, and the exit code is 1.
``--stream N`` cleans in N-subint tiles (``parallel/streaming.py``).
``--mesh cell`` cleans each archive over the ranks of a
``torch.distributed`` job (``parallel/sharding.py``), started as
``torchrun --nproc_per_node N -m iterative_cleaner_torch --mesh cell
obs.sf``: one rank per card (NCCL), or gloo ranks with ``--device
cpu``; every rank reads the archive and keeps its block, and rank 0
alone prints, records the telemetry, writes the output and the logs.
Not ported yet: ``-z``, ``--prefetch`` and ``--checkpoint`` (ROADMAP.md
'Modules still to port' item 2), the live ``--stream DIR`` session (item
5), ``--mesh batch`` (item 3).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import sys

from iterative_cleaner_torch.config import MESH_MODES, CleanConfig, check_mesh
from iterative_cleaner_torch.io import load_archive, save_archive
from iterative_cleaner_torch.telemetry import RunTelemetry
from iterative_cleaner_torch.utils.logging import append_clean_log


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m iterative_cleaner_torch",
        description="Iterative RFI cleaner (PyTorch/CUDA port)")
    p.add_argument("archive", nargs="+",
                   help="The chosen archives (.npz, or PSRFITS: .sf, .rf, "
                        ".fits, .psrfits, .ar)")
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
    p.add_argument("-p", "--pscrunch", action="store_true",
                   help="Pscrunch the output archive.")
    p.add_argument("-q", "--quiet", action="store_true",
                   help="Do not print cleaning information.")
    p.add_argument("-l", "--no_log", action="store_true",
                   help="Do not append to the cleaning log.")
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
    p.add_argument("--metrics-json", "--metrics_json", type=str, default="",
                   dest="metrics_json", metavar="PATH",
                   help="Write a JSON run report (counters, phase "
                        "timings, per-archive iteration histories) to "
                        "PATH at session end.")
    p.add_argument("--prom-textfile", "--prom_textfile", type=str,
                   default="", dest="prom_textfile", metavar="PATH",
                   help="Write the run metrics in Prometheus text "
                        "exposition format to PATH at session end "
                        "(atomic write).")
    p.add_argument("--log-format", "--log_format", choices=("text", "json"),
                   default="text", dest="log_format",
                   help="'json' also writes a JSON-lines run-event log "
                        "(one event per archive, iteration and phase) to "
                        "clean.events.jsonl; clean.log is unaffected.")
    p.add_argument("--event-log", "--event_log", type=str, default="",
                   dest="event_log", metavar="PATH",
                   help="Path of the JSON-lines event log (writes it "
                        "without --log-format json too).")
    p.add_argument("--timing", action="store_true",
                   help="Print the session's load/clean/write wall-clock "
                        "at its end.")
    p.add_argument("--keep_going", action="store_true",
                   help="Report a failed archive and go on with the rest "
                        "instead of ending the session (exit code 1 if "
                        "any failed).")
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


def clean_one(in_path: str, args, telemetry: RunTelemetry, mesh=None):
    """Load, clean and write one archive, its phases timed into the
    session's registry and its result recorded in ``telemetry``; returns
    the output's name.  Under ``mesh`` (``--mesh cell``) every rank
    cleans its block and only rank 0 reports, writes and records (the
    others return None)."""
    from iterative_cleaner_torch.backends import (
        clean_archive,
        clean_archive_sharded,
    )
    from iterative_cleaner_torch.parallel import clean_streaming

    timer = telemetry.registry.timer
    say = (mesh is None or mesh.rank == 0) and not args.quiet
    with timer.phase("load"):
        ar = load_archive(in_path)
    cfg = config_of(args)
    if say:
        print("Total number of profiles: %s" % ar.weights.size)
    chunk = stream_chunk(args.stream)
    with timer.phase("clean"):
        if mesh is not None:
            result = clean_archive_sharded(ar, cfg, mesh)
        elif chunk > 0:
            result = clean_streaming(ar, chunk, cfg, mode=args.stream_mode)
        else:
            result = clean_archive(ar, cfg)
    if result is None:
        return None
    if say:
        if result.loop_diffs is not None:   # the online mode has none
            for i, (d, f) in enumerate(zip(result.loop_diffs,
                                           result.loop_rfi_frac), start=1):
                print("Loop: %s" % i)
                print("Differences to previous weights: %s  RFI fraction: "
                      "%s" % (int(d), float(f)))
        if result.converged:
            print("RFI removal stops after %s loops." % result.loops)
        else:
            print("Cleaning was interrupted after the maximum amount of "
                  "loops (%s)" % cfg.max_iter)
        if result.n_bad_subints + result.n_bad_channels:
            print("Removed %s bad subintegrations and %s bad channels."
                  % (result.n_bad_subints, result.n_bad_channels))
    out = dataclasses.replace(
        ar, weights=result.final_weights.astype(ar.weights.dtype))
    if args.pscrunch:
        out.pscrunch()
    o_name = output_name(ar, args, in_path)
    with timer.phase("write"):
        save_archive(out, o_name)
    ar_name = ar.display_name() or os.path.basename(in_path)
    if args.unload_res:
        # the residual is total intensity, so the archive is single-pol
        res_ar = dataclasses.replace(
            ar, data=result.residual[:, None, :, :].astype(ar.data.dtype),
            pol_state="Intensity", filename="")
        save_archive(res_ar, "%s_residual_%s%s" % (
            ar_name, result.loops, os.path.splitext(o_name)[1]))
    if not args.no_log:
        append_clean_log(ar_name, args, result.loops,
                         os.path.join(os.path.dirname(o_name) or ".",
                                      "clean.log"))
    telemetry.record_archive(in_path, result)
    if say:
        print("Cleaned archive: %s" % o_name)
    return o_name


@contextlib.contextmanager
def run_session(args, lead: bool = True):
    """One CLI session: yields its :class:`RunTelemetry` (``run_start``
    emitted), and at its end, however it ends, writes the metric exports
    and ``run_end`` and prints the one ``--timing`` report.  A rank other
    than the ``lead`` (rank 0 of ``--mesh cell``) gets a telemetry with
    nothing configured and prints nothing."""
    telemetry = RunTelemetry.from_args(args) if lead else RunTelemetry()
    if telemetry.events is not None:
        telemetry.events.emit("run_start", n_archives=len(args.archive))
    try:
        yield telemetry
    finally:
        telemetry.finalize()
        if args.timing and lead:
            print(telemetry.registry.timer.report())


def run_archives(args, mesh=None) -> int:
    """Clean every archive of ``args`` in one session; 1 if any failed
    under ``--keep_going``, else 0 (without it a failure raises)."""
    lead = mesh is None or mesh.rank == 0
    failed = []
    with run_session(args, lead) as telemetry:
        for path in args.archive:
            try:
                clean_one(path, args, telemetry, mesh)
            except Exception as exc:  # per-archive isolation
                if not args.keep_going:
                    raise
                failed.append(path)
                telemetry.record_failure(path, exc)
                if lead:
                    print("ERROR cleaning %s: %s: %s"
                          % (path, type(exc).__name__, exc), file=sys.stderr)
    if failed:
        if lead:
            print("Failed %d/%d archives: %s"
                  % (len(failed), len(args.archive), ", ".join(failed)),
                  file=sys.stderr)
        return 1
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    # refuse a directory, and what the mesh does not run, before any clean
    streaming = stream_chunk(args.stream) > 0
    check_mesh(args.mesh, config_of(args), streaming=streaming)
    if args.mesh == "off":
        return run_archives(args)
    from iterative_cleaner_torch.parallel import distributed
    from iterative_cleaner_torch.parallel.mesh import cell_mesh

    distributed.initialize(device=args.device)
    try:
        return run_archives(args, cell_mesh())
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    sys.exit(main())
