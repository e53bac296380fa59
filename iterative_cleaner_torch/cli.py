"""Command line of the port: the reference CLI's session over archives.

``python -m iterative_cleaner_torch [-c] [-s] [-m] [-z] [-u] [-p] [-q]
[-l] [-r] [-o] [--memory] [--bad_chan] [--bad_subint] [--backend
torch|numpy] [--rotation fourier|roll] [--baseline_mode] [--stats_frame]
[--compute-dtype float32|bfloat16] [--record_history] [--device]
[--model surgical_scrub|quicklook|online_ewt] [--checkpoint DIR]
[--trace DIR] [--stream N [--stream_mode exact|online]
[--stream_hbm_mb MB]] [--stream DIR | --mux DIR...
[--stream-reconcile-every K] [--stream-ew-alpha A] [--quality-window K]
[--quality-drift F] [--mux-max-wait-ms MS] [--mux-max-batch B]]
[--batch B] [--mesh off|cell|batch] [--prefetch N] [--io-workers N]
[--fleet [--bucket-pad NSUB,NCHAN] [--retries N] [--stage-timeout S]
[--faults SPEC [--fault-seed SEED]] [--journal PATH [--journal-segment-mb MB] [--resume]] [--hosts N --host-id I
[--claim-ttl S]] [--trace-out PATH] [--flight-recorder PATH]]
[--precompile] [--compile-cache DIR] [--profile-dir DIR] [--no-donate]
[--metrics-json PATH] [--prom-textfile PATH] [--event-log PATH]
[--log-format text|json] [--timing] [--keep_going] obs.sf ...``
and ``python -m iterative_cleaner_torch --serve [--spool DIR] [--http-port
PORT] [--max-inflight N] [--journal PATH] [--join [--member-ttl S]]
[--result-cache] [--mux] [--trace-out PATH] [--flight-recorder PATH]
[--profile-dir DIR] [--faults SPEC] ...``
cleans each archive (``.npz``, ``.icar``, fold-mode PSRFITS: ``.sf``,
``.rf``, ``.fits``, ``.psrfits`` and ``.ar`` files with the FITS magic,
and TIMER-format ``.ar`` through the psrchive bindings), writes
``obs.sf_cleaned.sf`` (the input's data with the cleaned weights; ``-p``
pscrunched), with ``-u`` also the single-pol residual archive
``obs.sf_residual_<loops>.sf`` in the working directory, with ``-z`` the
zap plot ``<name>_<c>_<s>.png`` (matplotlib), and appends the
reference-format line to ``clean.log`` beside the output (not with
``-l``).  ``--prefetch N`` loads up to N archives ahead on
``--io-workers`` threads while the current one cleans; ``--timing``'s
load phase then measures the wait for the load, not the load.  One
session spans all the archives: ``--metrics-json`` writes the run
report (counters, phase times, each archive's iteration history,
whose ``residual_std`` kernel K9 computes), ``--prom-textfile`` the same
metrics in Prometheus text, ``--log-format json`` (or ``--event-log
PATH``) a JSON-lines event log (``clean.events.jsonl``), and ``--timing``
one ``Timing:`` line of the load, clean and write seconds at the end.
An archive that fails ends the session with its exception; with
``--keep_going`` it is recorded, printed to stderr, the others are
cleaned, and the exit code is 1.
``--compute-dtype bfloat16`` (or ``ICLEAN_COMPUTE_DTYPE=bfloat16``) stores
the cube in bf16 on the card while every stage computes in float32; a
stage the parity probe finds ineligible stays float32 with a notice and a
``compute_dtype_ineligible{stage=,reason=}`` counter in the run report.
``--backend numpy`` cleans on the float64 numpy oracle on the host (the
reference's ``--backend numpy``; ``--device`` then means nothing), whole
or with ``--stream N`` in both modes; with ``--batch B > 1`` or a mesh it
is a parser error, as in the reference.
``--memory`` is accepted and does nothing (the reference's compatibility
flag: the input is never mutated); ``--record_history`` keeps every
iteration's weights in the clean's result (and its checkpoint), as the
reference does.
``--checkpoint DIR`` saves each archive's cleaning state in DIR
(``utils/checkpoint.py``) after a fresh clean, and an archive whose
content and config still match its checkpoint is not cleaned again: it
prints ``Resumed from checkpoint: PATH`` and is written, logged and
recorded in the run report as a cleaned one.  On ``--mesh cell`` rank 0
takes the resume decision and broadcasts it before any collective, and
rank 0 alone saves.
``--model quicklook`` cleans with the single-pass template-free
quicklook (``models/quicklook.py``: K6, K3 twice and the combine on the
card); ``--model online_ewt`` writes the online mode's provisional mask
(``online/model.py``: the archive streamed subint by subint through the
per-subint step).  ``--checkpoint`` and a model other than the flagship
each refuse what the reference's parser refuses (exit 2).
``--trace DIR`` captures a ``torch.profiler`` trace of the whole session
into ``DIR/trace.rank<r>.json`` (``utils/tracing.py``: the host phases
``icln:load``/``icln:clean``/``icln:write``, each iteration's
``icln_template``, ``icln_residual_stats``, ``icln_scores`` and
``icln_zap`` ranges, and on a card its kernels); every rank of a mesh
writes its own file.
``--stream N`` cleans in N-subint tiles (``parallel/streaming.py``).
``--stream DIR`` is the online mode (``online/``): it tails DIR for
chunk files (bare ``.npy`` tiles with a ``stream.json`` header, or
archive containers) in sorted-name order, cleans each subint as it lands
(:class:`~iterative_cleaner_torch.online.OnlineSession`: the provisional
zap, a reconcile every ``--stream-reconcile-every`` subints) and ends on a
``stream.close`` sentinel, or after ``ICLEAN_STREAM_IDLE_S`` seconds
(default 30) with no new chunk; it writes ``DIR/stream_cleaned.npz`` (or
``-o``), whose mask is the batch clean's of the same subints.  ``--mux
DIR...`` tails several such directories through one
:class:`~iterative_cleaner_torch.online.StreamMux` (one batched step a
tick, ``--mux-max-wait-ms``, ``--mux-max-batch``), each stream closing on
its own sentinel and writing its ``DIR/stream_cleaned.npz``.  Both take
no archive arguments and need ``--backend torch``.
``--mesh cell`` cleans each archive over the ranks of a
``torch.distributed`` job (``parallel/sharding.py``; with ``--stream N``
each tile over the ranks, ``parallel/streaming.py``), started as
``torchrun --nproc_per_node N -m iterative_cleaner_torch --mesh cell
[--stream N] obs.sf``: one rank per card (NCCL), or gloo ranks with
``--device cpu``; every rank reads the archive and keeps its block, and
rank 0 alone prints, records the telemetry, writes the output and the
logs.
``--batch B`` cleans runs of up to B consecutive equal-shaped archives
as one batch on the card (``parallel/batch.py``): a header prepass puts
archives of one (nsub, nchan, nbin, DEDISP) key next to each other, and
each group is loaded, cleaned in one batched clean and written archive
by archive, with the sequential path's outputs, console lines and logs.
With ``--keep_going`` an archive that fails to load, or a group that
fails to clean, is reported and the rest go on; a failed write is
reported per archive and never stops the session.  ``--prefetch`` is
ignored with B > 1.  ``--mesh batch`` splits each group over the ranks
of a ``torchrun`` job (``torchrun --nproc_per_node N -m
iterative_cleaner_torch --batch B --mesh batch ...``): each rank cleans
its share, rank 0 writes.
``--fleet`` serves the archive list through the shape-bucketed fleet
scheduler (``parallel/fleet.py``): archives group by (nsub, nchan, nbin,
DEDISP) (``--bucket-pad`` is accepted and changes nothing: the port pads
no cell), each group of up to ``--batch B`` (default 8)
is one batched clean, loads stay one group ahead on ``--io-workers``
threads and writes drain behind; outputs, console lines and logs are
:func:`clean_one`'s, written under one lock, in bucket order.  Failures
stay with their archive (exit 1 if any failed) and go through the
resilience ladder: ``--retries``, ``--stage-timeout``, the fault drill
``--faults``/``--fault-seed``, OOM halving down to single archives (one
that does not fit the card alone fails: clean it without ``--fleet``,
e.g. with ``--backend numpy``), and ``--journal PATH`` (a file, or a directory for the segmented
journal) with ``--resume``, which prints ``resumed: N archives already
complete in PATH``.  ``--hosts N --host-id I`` serves one host's share
of a fleet that N processes split through one shared ``--journal``.
``--compile-cache DIR`` is the directory the CUDA kernel library is
built into and loaded from (a warm restart builds nothing);
``--precompile --compile-cache DIR`` plans the buckets of the given
archives or ``NSUBxNCHANxNBIN`` geometries, warms each and exits.
``--trace-out PATH`` (or ``ICLEAN_TRACE_OUT``) records the fleet's spans
(``telemetry/tracing.py``) and renders them as a Chrome/Perfetto file at
PATH; ``--flight-recorder PATH`` (or ``ICLEAN_FLIGHT_RECORDER``) keeps the
black box a watchdog trip dumps there (``telemetry/recorder.py``).
``--profile-dir DIR`` (or ``ICLEAN_PROFILE_DIR``) records a
``torch.profiler`` capture of the session into a fresh ``DIR/capture-*``
directory with its manifest (``telemetry/profiling.py``; ``--trace`` wins
where both are given) and turns on the profiler's program measurements.
``--serve`` runs the long-lived cleaning daemon (``serve/``): requests
from a ``--spool`` directory and/or the ``--http-port`` endpoint, each
archive request cleaned through the fleet and each ``kind: "stream"``
request through an online session (bare ``--mux``: one shared
``StreamMux``), journaled in ``--journal`` (default
``serve.journal.jsonl``), with ``--join`` pools, ``--result-cache`` and
``POST /profile`` captures into ``--profile-dir``; SIGTERM drains it (exit
0).  ``--no-donate`` is accepted and changes nothing (the port donates no
buffer).  The reference's route knobs (``--fused-sweep``, ``--stats_impl``,
``--median_impl``, ``--fft_mode``) are a parser error: the port has one
route.
``--selfcheck`` runs the port's analyzer (``analysis/``: the lint rules,
the card contracts on ``--device``, ``cuda`` unless ``--device cpu`` is
given) and exits 0 or 1; ``--journal-fsck JOURNAL`` with it validates
journals too.  The daemon and the ``--precompile`` session publish the
lint verdict (``lint_findings{rule=...}``, ``lint_ok``) in their metrics.
Not ported yet: ``--coordinator`` and ``--fleet --mesh batch`` (ROADMAP.md
'Modules still to port' item 3b), each raising ``NotImplementedError``
naming its item.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import sys

from iterative_cleaner_torch.analysis.cli import record_package_lint
from iterative_cleaner_torch.config import (
    BACKENDS,
    MESH_MODES,
    ROADMAP_FLEET_3B,
    CleanConfig,
    check_mesh,
)
from iterative_cleaner_torch.io import load_archive, peek_shape, save_archive
from iterative_cleaner_torch.models import (
    ONLINE_EWT,
    QUICKLOOK,
    SURGICAL_SCRUB,
    get_model,
)
from iterative_cleaner_torch.parallel.fleet import resolve_io_workers
from iterative_cleaner_torch.telemetry import RunTelemetry
from iterative_cleaner_torch.utils import checkpoint as ckpt
from iterative_cleaner_torch.utils.logging import append_clean_log
from iterative_cleaner_torch.utils.tracing import device_trace

MODELS = (SURGICAL_SCRUB, QUICKLOOK, ONLINE_EWT)


def _parse_bucket_pad(text: str):
    """argparse type for --bucket-pad: 'NSUB,NCHAN' non-negative ints."""
    try:
        parts = tuple(int(v) for v in text.split(","))
        if len(parts) != 2 or any(v < 0 for v in parts):
            raise ValueError
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"expected two non-negative grid steps 'NSUB,NCHAN' "
            f"(e.g. 0,64; 0 disables that axis), got {text!r}") from None
    return parts


def _env_int(name: str):
    value = os.environ.get(name, "")
    return int(value) if value else None


# The reference's TPU route knobs: the port has one route.
ROUTE_FLAGS = ("--fused-sweep", "--stats_impl", "--median_impl",
               "--fft_mode")


class _NoRouteKnob(argparse.Action):
    """A reference route flag: a parser error (exit 2) saying the port
    has one route and no such knob."""

    def __call__(self, parser, namespace, values, option_string=None):
        parser.error(f"{option_string}: the port has one route (the card's "
                     f"hand-written kernels) and no such knob")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m iterative_cleaner_torch",
        description="Iterative RFI cleaner (PyTorch/CUDA port)")
    p.add_argument("archive", nargs="*",
                   help="The chosen archives (.npz, or PSRFITS: .sf, .rf, "
                        ".fits, .psrfits, .ar); none with --stream DIR or "
                        "--mux DIR...")
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
    p.add_argument("-z", "--print_zap", action="store_true",
                   help="Save a plot of which profiles get zapped.")
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
    p.add_argument("--memory", action="store_true",
                   help="Keep the archive full-pol in memory instead of "
                        "pscrunching (reference compatibility flag; the "
                        "input is never mutated, so it changes nothing).")
    p.add_argument("--bad_chan", type=float, default=1,
                   help="Fraction of removed subints above which the "
                        "whole channel is removed.")
    p.add_argument("--bad_subint", type=float, default=1,
                   help="Fraction of removed channels above which the "
                        "whole subint is removed.")
    p.add_argument("--backend", choices=BACKENDS, default="torch",
                   help="Compute backend: the PyTorch/CUDA engine on "
                        "--device, or the float64 numpy oracle on the "
                        "host.")
    p.add_argument("--rotation", choices=("fourier", "roll"),
                   default="fourier",
                   help="Dedispersion rotation: exact fractional-bin "
                        "Fourier phase ramp, or nearest-bin roll.")
    p.add_argument("--compute-dtype", "--compute_dtype",
                   choices=("float32", "bfloat16"), default=None,
                   dest="compute_dtype",
                   help="'bfloat16' stores the cube in bf16 on the card "
                        "(half the cube bytes each kernel reads and each "
                        "streamed tile uploads) while every stage "
                        "computes in float32; masks are bit-equal to "
                        "float32 on bf16-exact cubes, and a stage whose "
                        "parity probe disagrees stays float32 with a "
                        "notice. Default: the ICLEAN_COMPUTE_DTYPE "
                        "environment variable, else float32.")
    p.add_argument("--record_history", action="store_true",
                   help="Keep every iteration's weight matrix in the "
                        "result/checkpoint (regression diffing).")
    p.add_argument("--checkpoint", type=str, default="", metavar="DIR",
                   help="Checkpoint directory: each archive's cleaning "
                        "state is saved there, and re-runs reuse "
                        "checkpoints whose input content and config "
                        "still match (batch resume).")
    p.add_argument("--trace", type=str, default="", metavar="DIR",
                   help="Capture a torch.profiler trace of the whole run "
                        "into DIR (Chrome/Perfetto JSON, one file per "
                        "rank). Engine stages appear as icln_template / "
                        "icln_residual_stats / icln_scores / icln_zap "
                        "ranges; host phases as icln:load etc.")
    p.add_argument("--model", choices=MODELS, default="surgical_scrub",
                   help="Cleaning strategy: the flagship iterative "
                        "surgical scrub (reference algorithm); the "
                        "single-pass template-free quicklook triage "
                        "cleaner (models/quicklook.py; no template stage, "
                        "so --max_iter, -r/--pulse_region and "
                        "--stats_frame do not apply); or online_ewt, the "
                        "online mode's provisional mask (online/model.py: "
                        "each subint cleaned as it would arrive, no "
                        "reconcile).")
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
    p.add_argument("--stream", type=str, default="0", metavar="CHUNK|DIR",
                   help="An integer CHUNK > 0 cleans each archive in "
                        "CHUNK-subint tiles (--stream_mode) instead of "
                        "one device footprint: for archives larger than "
                        "the card. 0 (default) disables. A directory "
                        "instead runs the ONLINE mode (online/): tail DIR "
                        "for per-subint chunk files (.npy with a "
                        "stream.json header, or archive containers; "
                        "sorted name order), clean each as it lands, and "
                        "finish on a 'stream.close' sentinel file (or "
                        "ICLEAN_STREAM_IDLE_S seconds idle, default 30); "
                        "the output's mask is the batch clean's of the "
                        "same subints.")
    p.add_argument("--stream-reconcile-every", "--stream_reconcile_every",
                   type=int, default=None, dest="stream_reconcile_every",
                   metavar="K",
                   help="Online mode: re-clean the accumulated subints "
                        "through the batch pipeline every K subints, "
                        "repairing provisional-mask drift (default: "
                        "ICLEAN_STREAM_RECONCILE_EVERY, else 8; 0 "
                        "reconciles only at close, so the final mask is "
                        "unaffected).")
    p.add_argument("--stream-ew-alpha", "--stream_ew_alpha", type=float,
                   default=None, dest="stream_ew_alpha", metavar="A",
                   help="Online mode: the weight of the newest subint's "
                        "profile in the running template, 0 < A <= 1 "
                        "(default: ICLEAN_STREAM_EW_ALPHA, else 0.2). Only "
                        "the provisional zap sees the template.")
    p.add_argument("--quality-window", "--quality_window", type=int,
                   default=None, dest="quality_window", metavar="K",
                   help="Online mode: the trailing window (subints) of the "
                        "zap-fraction drift detector behind "
                        "quality_drift_alerts (telemetry/quality.py; it "
                        "never changes a mask). Default: "
                        "ICLEAN_QUALITY_WINDOW, else 16.")
    p.add_argument("--quality-drift", "--quality_drift", type=float,
                   default=None, dest="quality_drift", metavar="F",
                   help="Online mode: the zap-fraction departure from the "
                        "window's median that raises quality_drift_alerts "
                        "(default: ICLEAN_QUALITY_DRIFT, else 0.15).")
    p.add_argument("--mux", nargs="*", default=None, metavar="DIR",
                   help="Multiplex live streams through one batched step "
                        "(online/mux.py): with one or more DIRs, tail each "
                        "chunk directory as a stream of its own (as "
                        "--stream DIR does) until every stream closes; "
                        "pending subints of streams of one geometry run "
                        "as one (B, 1, nchan, nbin) step a tick, each "
                        "stream's masks bit-equal to its solo session's. "
                        "Bare --mux belongs to the --serve daemon (not "
                        "ported).")
    p.add_argument("--mux-max-wait-ms", "--mux_max_wait_ms", type=float,
                   default=None, dest="mux_max_wait_ms", metavar="MS",
                   help="Mux deadline: a pending subint never waits longer "
                        "than MS before its bucket dispatches partly full "
                        "(default: ICLEAN_MUX_MAX_WAIT_MS, else 5). 0 "
                        "dispatches every pending subint at once.")
    p.add_argument("--mux-max-batch", "--mux_max_batch", type=int,
                   default=None, dest="mux_max_batch", metavar="B",
                   help="Largest multiplexed dispatch, in streams "
                        "(default: ICLEAN_MUX_MAX_BATCH, else 64). A "
                        "dispatch runs exactly its lanes: nothing is "
                        "padded.")
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
                        "zero-weight padded and cropped back. With "
                        "--stream N each tile is sharded (each mesh axis "
                        "must divide the tile grid). 'batch' splits each "
                        "--batch group over the ranks (zero-weight "
                        "padded to a multiple of them).")
    p.add_argument("--batch", type=int, default=0, metavar="B",
                   help="Clean runs of up to B consecutive equal-shaped "
                        "archives as one batch on the card (one launch of "
                        "each kernel per iteration for the whole batch; "
                        "for many small archives). Incompatible with "
                        "--unload_res and --stream. With --fleet, B sets "
                        "the fleet group size instead.")
    p.add_argument("--prefetch", type=int, default=0, metavar="N",
                   help="Load up to N archives ahead on background "
                        "threads while the card cleans the current one "
                        "(costs N archives of host memory; 0 = "
                        "sequential; ignored when --batch B > 1, whose "
                        "groups are loaded up front).")
    p.add_argument("--io-workers", "--io_workers", type=int, default=None,
                   dest="io_workers", metavar="N",
                   help="Threads of the --prefetch loader (default: the "
                        "ICLEAN_IO_WORKERS environment variable, else 2).")
    p.add_argument("--fleet", action="store_true",
                   help="Serve the archive list through the shape-bucketed "
                        "fleet scheduler (parallel/fleet.py): archives "
                        "group by (nsub, nchan, nbin, DEDISP), each group "
                        "of up to --batch B (default 8) cleans as one "
                        "batch on the card, and host load/write overlap "
                        "the clean through the --io-workers pools. Handles "
                        "mixed-shape fleets; per-archive failures "
                        "(including write-back) never abort the fleet "
                        "(exit code 1 if any failed).")
    p.add_argument("--bucket-pad", "--bucket_pad", type=_parse_bucket_pad,
                   default=(0, 0), dest="bucket_pad", metavar="NSUB,NCHAN",
                   help="The reference's fleet geometry quantization "
                        "grid, accepted with --fleet for its CLI's sake. "
                        "The port pads nothing and buckets by exact shape, "
                        "so it changes no bucket, group or launch.")
    p.add_argument("--retries", type=int, default=None, metavar="N",
                   help="Fleet resilience: retry a transiently failing "
                        "peek/load/execute/write stage up to N times with "
                        "bounded deterministic backoff before failing that "
                        "archive (default: ICLEAN_RETRIES env var, else 2; "
                        "0 disables retries).")
    p.add_argument("--stage-timeout", "--stage_timeout", type=float,
                   default=None, dest="stage_timeout", metavar="S",
                   help="Fleet resilience: per-stage watchdog deadline in "
                        "seconds — a hung load/compile/execute/write "
                        "attempt fails its archive(s) after S seconds "
                        "instead of wedging the whole run (default: "
                        "ICLEAN_STAGE_TIMEOUT env var, else off; 0 "
                        "disables).")
    p.add_argument("--faults", type=str, default="", metavar="SPEC",
                   help="Fleet fault-injection drill: deterministic "
                        "'site:action' spec, comma-separated — sites "
                        "peek/load/compile/execute/write (intake/sched "
                        "parse for the serve daemon); actions a "
                        "probability ('load:0.1'), 'once', a kind "
                        "(err|oom|perm|hang) or 'kind@N' for the Nth call "
                        "('exec:oom@2'). Mirrors ICLEAN_FAULTS; seeded by "
                        "--fault-seed, so a failing soak replays exactly.")
    p.add_argument("--fault-seed", "--fault_seed", type=int, default=0,
                   dest="fault_seed", metavar="SEED",
                   help="Seed for --faults probability draws (default 0; "
                        "mirrors ICLEAN_FAULT_SEED).")
    p.add_argument("--journal", type=str, default="", metavar="PATH",
                   help="Fleet crash-safety: append one JSON line per "
                        "completed archive (after its atomic output write) "
                        "to PATH, keyed by input signature and config "
                        "hash; a later --resume run skips journaled work. "
                        "A DIRECTORY (or a path ending in a separator) "
                        "selects the segmented backend.")
    p.add_argument("--journal-segment-mb", "--journal_segment_mb",
                   type=float, default=None, dest="journal_segment_mb",
                   metavar="MB",
                   help="Segmented journal only: seal a shard's active "
                        "segment once it exceeds MB megabytes (default 4); "
                        "ignored for single-file journals.")
    p.add_argument("--resume", action="store_true",
                   help="Skip archives the --journal records as complete "
                        "under the same config, after re-verifying the "
                        "input file signature and the recorded output — a "
                        "killed fleet run picks up where it stopped with "
                        "zero duplicated cleans. Requires --journal PATH.")
    p.add_argument("--hosts", type=int, default=None, metavar="N",
                   help="Multi-host fleet sharding: serve this --fleet as "
                        "one of N cooperating processes. Geometry buckets "
                        "partition across hosts by a deterministic hash; "
                        "hosts coordinate through the shared --journal "
                        "(claim leases + work stealing), so a host that "
                        "finishes early or dies has its buckets re-served "
                        "exactly once. Requires --journal on storage all "
                        "hosts share. Mirrors ICLEAN_HOSTS.")
    p.add_argument("--host-id", "--host_id", type=int, default=None,
                   dest="host_id", metavar="I",
                   help="This process's host index in [0, --hosts). "
                        "Mirrors ICLEAN_HOST_ID.")
    p.add_argument("--claim-ttl", "--claim_ttl", type=float, default=None,
                   dest="claim_ttl", metavar="S",
                   help="Multi-host claim-lease duration in seconds: a "
                        "serving host heartbeats its bucket's lease at "
                        "S/3; a dead host's buckets become stealable after "
                        "at most S. Default: ICLEAN_CLAIM_TTL env var, "
                        "else 60.")
    p.add_argument("--coordinator", type=str, default="",
                   metavar="HOST:PORT",
                   help="Not ported (ROADMAP item 3b): the journal alone "
                        "coordinates a multi-host fleet.")
    p.add_argument("--compile-cache", "--compile_cache", type=str,
                   default="", dest="compile_cache", metavar="DIR",
                   help="Directory the CUDA kernel library is built into "
                        "and loaded from: a warm restart (or any later "
                        "process) over the same sources finds it there "
                        "and runs no nvcc. Also settable as "
                        "ICLEAN_COMPILE_CACHE. Default: the package's "
                        "_build/ directory.")
    p.add_argument("--precompile", action="store_true",
                   help="Warm the --compile-cache for the given "
                        "archives/geometries and exit without cleaning: "
                        "each argument is an archive path (shape read from "
                        "its header) or a bare NSUBxNCHANxNBIN geometry; "
                        "every resulting fleet bucket is warmed (the "
                        "kernel library built). Honours --batch.")
    p.add_argument("--serve", action="store_true",
                   help="Run as a long-lived cleaning service instead of a "
                        "batch run: keep the process (the kernel library, "
                        "the bucket warm-ups) warm and take requests from "
                        "a --spool directory and/or an --http-port JSON "
                        "endpoint, with admission control, priorities, "
                        "deadlines and a crash-safe request journal. "
                        "SIGTERM drains gracefully (exit 0). Takes no "
                        "archive arguments.")
    p.add_argument("--spool", type=str, default="", metavar="DIR",
                   help="--serve intake: watch DIR for request .json files "
                        "(write-then-rename into place; claimed files are "
                        "renamed .accepted/.rejected). Mirrors "
                        "ICLEAN_SPOOL.")
    p.add_argument("--http-port", "--http_port", type=int, default=None,
                   dest="http_port", metavar="PORT",
                   help="--serve intake: HTTP/JSON endpoint on "
                        "127.0.0.1:PORT (POST /submit, GET /healthz, GET "
                        "/metrics, GET /requests/<id>, POST /profile ...); "
                        "0 binds an ephemeral port (printed at startup). "
                        "Mirrors ICLEAN_HTTP_PORT.")
    p.add_argument("--max-inflight", "--max_inflight", type=int,
                   default=None, dest="max_inflight", metavar="N",
                   help="--serve admission control: max requests one tenant "
                        "may have admitted but unfinished before new "
                        "submissions draw 429/REJECTED (default 8; mirrors "
                        "ICLEAN_MAX_INFLIGHT; the global queue bound is "
                        "ICLEAN_SERVE_QUEUE, default 64).")
    p.add_argument("--join", action="store_true",
                   help="--serve: join the elastic pool sharing this "
                        "daemon's --journal (journaled membership leases, "
                        "adoption of any member's accepted requests, a "
                        "dead member's requests stolen after "
                        "--member-ttl). Mirrors ICLEAN_JOIN.")
    p.add_argument("--member-ttl", "--member_ttl", type=float, default=None,
                   dest="member_ttl", metavar="S",
                   help="--join membership and request lease in seconds "
                        "(default 15; mirrors ICLEAN_MEMBER_TTL).")
    p.add_argument("--result-cache", "--result_cache", action="store_true",
                   dest="result_cache",
                   help="--serve: answer a resubmission of the same "
                        "archives under the same config from the "
                        "journal's verified output index, with no device "
                        "work. Mirrors ICLEAN_RESULT_CACHE.")
    p.add_argument("--trace-out", "--trace_out", type=str, default="",
                   dest="trace_out", metavar="PATH",
                   help="Export the run's spans (request -> queue -> fleet "
                        "-> group -> load/execute/write) as a Chrome/"
                        "Perfetto trace_events JSON at PATH; spans spool "
                        "to PATH.spans.jsonl, so hosts sharing PATH render "
                        "one file. With --fleet or --serve. Mirrors "
                        "ICLEAN_TRACE_OUT.")
    p.add_argument("--flight-recorder", "--flight_recorder", type=str,
                   default=None, dest="flight_recorder", metavar="PATH",
                   help="Crash flight recorder: a bounded ring of recent "
                        "spans and events per subsystem, dumped with every "
                        "thread's stack to PATH on watchdog trips, "
                        "unhandled daemon exceptions, SIGQUIT and a "
                        "second-signal force exit. --serve defaults to "
                        "serve.flight.json; '' disables. With --fleet or "
                        "--serve. Mirrors ICLEAN_FLIGHT_RECORDER.")
    p.add_argument("--profile-dir", "--profile_dir", type=str, default="",
                   dest="profile_dir", metavar="DIR",
                   help="Record a torch.profiler capture of the session "
                        "(CPU and CUDA activities) into a fresh "
                        "DIR/capture-* directory with its manifest, and "
                        "measure the bucket, online and mux programs' "
                        "device peaks (prof_* gauges). Under --serve, DIR "
                        "arms POST /profile captures instead. Default: "
                        "ICLEAN_PROFILE_DIR, else off.")
    p.add_argument("--selfcheck", action="store_true",
                   help="Run the port's analyzer and exit: the lint rules "
                        "over iterative_cleaner_torch/ and the card "
                        "contracts of the hot programs on --device (cuda "
                        "unless --device cpu; no fallback). Exit 0 clean, "
                        "1 findings or violations, 2 no card or a usage "
                        "error. Takes no archives or run modes.")
    p.add_argument("--selfcheck-format", "--format",
                   choices=("text", "json"), default=None,
                   dest="selfcheck_format",
                   help="--selfcheck's output format (default text).")
    p.add_argument("--journal-fsck", action="append", default=[],
                   dest="journal_fsck", metavar="JOURNAL",
                   help="With --selfcheck: also validate a fleet journal "
                        "(a file or a segmented directory) against the "
                        "protocol state machine; repeatable. The "
                        "icln-lint-torch script runs it alone.")
    p.add_argument("--no-donate", "--no_donate", action="store_true",
                   dest="no_donate",
                   help="Accepted for the reference CLI's sake and changes "
                        "nothing: the port donates no buffer.")
    for flag in ROUTE_FLAGS:
        p.add_argument(flag, action=_NoRouteKnob, metavar="MODE",
                       help=argparse.SUPPRESS)
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


def split_stream_arg(args) -> None:
    """Split ``--stream`` the reference's way: an integer is the tile
    size (``args.stream``), anything else the online mode's chunk
    directory (``args.stream_dir``, the tile size then 0); and ``--mux``:
    its directories (``args.mux_dirs``) and whether it was given at all
    (``args.mux_on``; bare, it belongs to the serve daemon)."""
    raw = str(args.stream)
    if raw.lstrip("-").isdigit():
        args.stream_dir = ""
    else:
        args.stream_dir, args.stream = raw, "0"
    args.mux_dirs = list(args.mux) if args.mux else []
    args.mux_on = args.mux is not None


def stream_chunk(value: str) -> int:
    """``--stream``'s tile size; 0 disables tiled streaming."""
    chunk = int(value)
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
                       rotation=args.rotation,
                       stats_frame=args.stats_frame,
                       baseline_mode=args.baseline_mode,
                       backend=args.backend,
                       compute_dtype=args.compute_dtype,
                       record_history=args.record_history,
                       unload_res=args.unload_res, device=args.device,
                       stream_hbm_mb=args.stream_hbm_mb,
                       fleet_bucket_pad=tuple(args.bucket_pad),
                       # --fleet reuses --batch B as its group size
                       fleet_group_size=(args.batch if args.batch > 1
                                         else CleanConfig.fleet_group_size),
                       fleet_retries=args.retries,
                       stage_timeout_s=args.stage_timeout,
                       fleet_hosts=(args.hosts if args.hosts is not None
                                    else _env_int("ICLEAN_HOSTS")),
                       fleet_host_id=(args.host_id
                                      if args.host_id is not None
                                      else _env_int("ICLEAN_HOST_ID")),
                       fleet_claim_ttl_s=args.claim_ttl,
                       compile_cache_dir=args.compile_cache or None,
                       stream_reconcile_every=args.stream_reconcile_every,
                       stream_ew_alpha=args.stream_ew_alpha,
                       quality_window=args.quality_window,
                       quality_drift=args.quality_drift)


def notice_compute_dtype_downgrade(cfg: CleanConfig, telemetry) -> str:
    """The mixed-precision rung of the session: resolve an explicit
    ``--compute-dtype bfloat16`` (or ``ICLEAN_COMPUTE_DTYPE``) once with
    the session's registry, so that a downgraded stage's
    ``compute_dtype_ineligible{stage=,reason=}`` counter lands in the
    run report (the resolve prints the notice and never raises).
    Returns the resolved dtype."""
    knob = cfg.compute_dtype or os.environ.get("ICLEAN_COMPUTE_DTYPE", "")
    if knob != "bfloat16" or cfg.backend != "torch":
        return "float32"
    from iterative_cleaner_torch.backends.torch_backend import (
        clean_device,
        config_compute_dtype,
    )

    return config_compute_dtype(cfg, "engine", clean_device(cfg),
                                telemetry.registry)


def iter_archives(paths, prefetch: int, workers: int = 1):
    """Yield (path, load future or None) pairs; with ``prefetch`` > 0 a
    pool of up to ``workers`` threads stays up to that many loads ahead
    of the consumer, so host I/O overlaps the clean on the card (the
    native readers release the GIL).  A load error raises when the
    consumer reads that archive's future, at its turn in the session."""
    if prefetch <= 0 or len(paths) < 2:
        for p in paths:
            yield p, None
        return
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=max(1, min(workers, prefetch))) \
            as pool:
        pending = [(p, pool.submit(load_archive, p))
                   for p in paths[: prefetch + 1]]
        next_i = len(pending)
        while pending:
            yield pending.pop(0)
            if next_i < len(paths):
                pending.append((paths[next_i],
                                pool.submit(load_archive, paths[next_i])))
                next_i += 1


def resume_checkpoint(directory: str, in_path: str, ar, cfg: CleanConfig,
                      mesh=None):
    """``(resumed, result)``: whether the checkpoint of ``in_path`` in
    ``directory`` still matches the archive and ``cfg``, and its result.
    On a cell ``mesh`` rank 0 alone reads the checkpoint, and its decision
    reaches every rank (an int32 all-reduce) before any collective of the
    clean: a rank that read a file caught mid-replace while another
    resumed would leave the job waiting.  The other ranks get
    ``(resumed, None)``."""
    lead = mesh is None or mesh.rank == 0
    result = ckpt.load_matching_checkpoint(directory, in_path, ar, cfg) \
        if lead else None
    resumed = result is not None
    if mesh is not None:
        import torch

        flag = torch.tensor([int(resumed)], dtype=torch.int32,
                            device=mesh.device)
        resumed = bool(mesh.reduce_int(flag, "max")[0])
    return resumed, result


def clean_one(in_path: str, args, telemetry: RunTelemetry, mesh=None,
              preloaded=None, result=None):
    """Load, clean and write one archive, its phases timed into the
    session's registry and its result recorded in ``telemetry``; returns
    the output's name.  ``preloaded`` is the ``--prefetch`` loader's
    future, read inside the load phase (which then times the wait), or
    the loaded archive itself; ``result`` a clean already computed (the
    ``--batch`` path), which skips the clean.  With ``--checkpoint`` a
    matching checkpoint stands for the clean (:func:`resume_checkpoint`),
    and a fresh clean's result is saved.  Under ``mesh`` (``--mesh
    cell``) every rank cleans its block and only rank 0 reports, writes,
    saves and records (the others return None)."""
    from iterative_cleaner_torch.backends import clean_archive_sharded
    from iterative_cleaner_torch.parallel import clean_streaming

    timer = telemetry.registry.timer
    say = (mesh is None or mesh.rank == 0) and not args.quiet
    with timer.phase("load"):
        if preloaded is None:
            ar = load_archive(in_path)
        elif hasattr(preloaded, "result"):
            ar = preloaded.result()
        else:
            ar = preloaded
    cfg = config_of(args)
    if say:
        print("Total number of profiles: %s" % ar.weights.size)
    chunk = stream_chunk(args.stream)
    resumed = False
    if result is None and args.checkpoint:
        resumed, result = resume_checkpoint(args.checkpoint, in_path, ar,
                                            cfg, mesh)
        if resumed and say:
            print("Resumed from checkpoint: %s"
                  % ckpt.checkpoint_path(args.checkpoint, in_path))
    if result is None and not resumed:
        with timer.phase("clean"):
            notice_compute_dtype_downgrade(cfg, telemetry)
            if chunk > 0:
                result = clean_streaming(ar, chunk, cfg, mesh,
                                         mode=args.stream_mode)
            elif mesh is not None:
                result = clean_archive_sharded(ar, cfg, mesh)
            else:
                result = get_model(args.model)(ar, cfg)
    if result is None:
        return None
    if args.checkpoint and not resumed:
        os.makedirs(args.checkpoint, exist_ok=True)
        ckpt.save_clean_checkpoint(
            ckpt.checkpoint_path(args.checkpoint, in_path), result, cfg,
            ckpt.fingerprint_archive(ar),
            file_sig=ckpt.file_signature(in_path))
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
    if args.print_zap:
        from iterative_cleaner_torch.utils.plotting import save_zap_plot

        save_zap_plot(result.scores, ar_name, args.chanthresh,
                      args.subintthresh)
    if not args.no_log:
        append_clean_log(ar_name, args, result.loops,
                         os.path.join(os.path.dirname(o_name) or ".",
                                      "clean.log"))
    telemetry.record_archive(in_path, result)
    if say:
        print("Cleaned archive: %s" % o_name)
    return o_name


@contextlib.contextmanager
def run_session(args, lead: bool = True, rank: int = 0):
    """One CLI session: yields its :class:`RunTelemetry` (``run_start``
    emitted), and at its end, however it ends, writes the metric exports
    and ``run_end`` and prints the one ``--timing`` report.  A rank other
    than the ``lead`` (rank 0 of ``--mesh cell``) gets a telemetry with
    nothing configured and prints nothing.  With ``--trace DIR`` the
    session runs under :func:`~iterative_cleaner_torch.utils.tracing.
    device_trace`, which writes this ``rank``'s trace file."""
    telemetry = RunTelemetry.from_args(args) if lead else RunTelemetry()
    if telemetry.events is not None:
        telemetry.events.emit("run_start", n_archives=len(args.archive))
    # --profile-dir (or ICLEAN_PROFILE_DIR): the session in a published
    # torch.profiler capture.  --trace holds the one profiler slot, so with
    # both --trace wins and the directory only turns on the program
    # measurements; under --serve it arms POST /profile instead
    from iterative_cleaner_torch.telemetry import profiling

    prof_dir = args.profile_dir or os.environ.get("ICLEAN_PROFILE_DIR", "")
    capture = contextlib.nullcontext()
    if prof_dir and lead:
        profiling.set_enabled(True)
        if not args.trace and not args.serve:
            capture = profiling.trace_capture(
                prof_dir, registry=telemetry.registry, label="run")
    try:
        with capture, device_trace(args.trace, rank):
            yield telemetry
    finally:
        if prof_dir and lead:
            profiling.set_enabled(None)
        telemetry.finalize()
        if args.timing and lead:
            print(telemetry.registry.timer.report())


def bucket_by_shape(paths: list) -> list:
    """The archives reordered so that each (nsub, nchan, nbin, DEDISP)
    key's archives are consecutive (a batch cleans one key only): the keys
    in order of first appearance, each key's archives in input order.  The
    keys come from header peeks (:func:`~iterative_cleaner_torch.io.npz.
    peek_shape`, no cube read); an archive whose header cannot be read (or
    a TIMER ``.ar``, which has no header-only peek) keeps its place among
    the others at the end, where the group loop's load reports it."""
    buckets, tail = {}, []
    for p in paths:
        try:
            key = peek_shape(p, cheap_only=True)
        except Exception:  # reported by the group loop's load
            tail.append(p)
            continue
        buckets.setdefault(key, []).append(p)
    return [p for group in buckets.values() for p in group] + tail


def run_batched(args, telemetry: RunTelemetry, mesh=None) -> list:
    """The ``--batch B`` session: the archives bucketed by shape, then
    groups of up to B consecutive equal-shaped archives loaded, cleaned in
    one :func:`~iterative_cleaner_torch.parallel.batch.
    clean_archives_batched` (over the ranks of a ``--mesh batch``) and
    written archive by archive through :func:`clean_one`, whose outputs,
    console lines and logs are the sequential session's.  A load or a
    group's clean that fails raises, or with ``--keep_going`` is recorded
    and the rest go on; a write that fails is recorded and reported per
    archive and never stops the session.  Returns the failed paths."""
    from iterative_cleaner_torch.parallel.batch import clean_archives_batched

    lead = mesh is None or mesh.rank == 0
    # the batch keeps no weight history, and the session writes none
    # (only a checkpoint would, and --batch refuses --checkpoint)
    cfg = dataclasses.replace(config_of(args), record_history=False)
    phase = telemetry.registry.timer.phase
    paths = bucket_by_shape(list(args.archive))
    failed = []

    def record_failure(bad, exc, what="cleaning"):
        failed.extend(bad)
        for p in bad:
            telemetry.record_failure(p, exc)
        if lead:
            print("ERROR %s %s: %s: %s" % (what, ", ".join(bad),
                                           type(exc).__name__, exc),
                  file=sys.stderr)

    i, carried = 0, None   # (path, archive) that ended the previous group
    while i < len(paths) or carried:
        group, ars = ([carried[0]], [carried[1]]) if carried else ([], [])
        carried = None
        while i < len(paths) and len(group) < args.batch:
            p = paths[i]
            i += 1
            try:
                with phase("load"):
                    ar = load_archive(p)
            except Exception as exc:
                if not args.keep_going:
                    raise
                record_failure([p], exc)
                continue
            if ars and (ar.nsub, ar.nchan, ar.nbin, ar.dedispersed) != (
                    ars[0].nsub, ars[0].nchan, ars[0].nbin,
                    ars[0].dedispersed):
                carried = (p, ar)   # seeds the next group, not reloaded
                break
            group.append(p)
            ars.append(ar)
        if not group:
            continue
        try:
            with phase("clean"):
                results = clean_archives_batched(ars, cfg, mesh,
                                                 registry=telemetry.registry)
        except Exception as exc:
            if not args.keep_going:
                raise
            record_failure(group, exc)
            continue
        if not lead:
            continue
        for p, ar, res in zip(group, ars, results):
            try:
                clean_one(p, args, telemetry, preloaded=ar, result=res)
            except Exception as exc:  # the group's cleans are done
                record_failure([p], exc, "writing")
    return failed


def run_fleet(args, telemetry: RunTelemetry) -> list:
    """The ``--fleet`` session: the whole (possibly mixed-shape) archive
    list through :func:`~iterative_cleaner_torch.parallel.fleet.
    clean_fleet`, each archive's output, console lines and logs written by
    :func:`clean_one` under one lock (stdout, the zap plot and
    ``clean.log`` are not thread-safe), in the buckets' order.  Returns the
    failed paths."""
    import threading

    from iterative_cleaner_torch.parallel.distributed import (
        resolve_host_topology,
    )
    from iterative_cleaner_torch.parallel.fleet import clean_fleet
    from iterative_cleaner_torch.resilience import (
        OOM,
        FaultInjector,
        FleetJournal,
        ResiliencePlan,
        RetryPolicy,
        classify_error,
        resolve_retries,
        resolve_stage_timeout,
    )

    cfg = config_of(args)
    topo = resolve_host_topology(cfg.fleet_hosts, cfg.fleet_host_id)
    failed: list = []
    write_lock = threading.Lock()

    def write_one(path, ar, result):
        with write_lock:
            clean_one(path, args, telemetry, preloaded=ar, result=result)

    def on_error(path, exc, stage):
        failed.append(path)
        telemetry.record_failure(path, exc)
        hint = ""
        if stage == "clean" and classify_error(exc) == OOM:
            hint = (" (it does not fit the device even alone; clean it "
                    "without --fleet, e.g. with --backend numpy)")
        print("ERROR %s %s: %s: %s%s"
              % ("writing" if stage == "write" else "cleaning", path,
                 type(exc).__name__, exc, hint), file=sys.stderr)

    journal_path = args.journal
    plan = ResiliencePlan(
        faults=(FaultInjector(args.faults, seed=args.fault_seed)
                if args.faults else FaultInjector.from_env()),
        retry=RetryPolicy(max_retries=resolve_retries(cfg.fleet_retries)),
        stage_timeout_s=resolve_stage_timeout(cfg.stage_timeout_s),
        journal=(FleetJournal(journal_path,
                              segment_mb=args.journal_segment_mb,
                              registry=telemetry.registry)
                 if journal_path else None),
        resume=args.resume)

    def default_out_path(p):
        return p + "_cleaned" + (os.path.splitext(p)[1] or ".npz")

    # opt-in spans and flight recorder (the serve daemon builds its own
    # from its ServeConfig)
    trace_out = args.trace_out or os.environ.get("ICLEAN_TRACE_OUT", "")
    flight = (args.flight_recorder if args.flight_recorder is not None
              else os.environ.get("ICLEAN_FLIGHT_RECORDER", ""))
    recorder = tracer = None
    if flight:
        from iterative_cleaner_torch.telemetry.recorder import (
            FlightRecorder,
            set_active,
        )

        recorder = FlightRecorder(path=flight)
        set_active(recorder)
    if trace_out:
        from iterative_cleaner_torch.telemetry.tracing import (
            Tracer,
            spool_path_for,
        )

        tracer = Tracer(host="h%d" % topo.host_id,
                        spool_path=spool_path_for(trace_out),
                        events=telemetry.events, recorder=recorder)
    try:
        report = clean_fleet(
            list(args.archive), cfg, registry=telemetry.registry,
            events=telemetry.events, io_workers=args.io_workers,
            write_fn=write_one, on_error=on_error, resilience=plan,
            # a journal line records the output's path and signature so a
            # resume can re-verify it; only the default naming is a
            # function of the input path alone (-o std needs the archive)
            out_path_fn=default_out_path if args.output == "" else None,
            hosts=topo, tracer=tracer)
    finally:
        if tracer is not None:
            try:
                tracer.flush_perfetto(trace_out)
            except OSError as exc:
                print("WARNING: could not write trace file %s: %s"
                      % (trace_out, exc), file=sys.stderr)
        if recorder is not None:
            from iterative_cleaner_torch.telemetry.recorder import (
                get_active,
                set_active,
            )

            # the process-global black box, released if still ours
            if get_active() is recorder:
                set_active(None)
    if report.skipped and not args.quiet:
        print("resumed: %d archive%s already complete in %s"
              % (len(report.skipped),
                 "" if len(report.skipped) == 1 else "s", journal_path))
    if topo.is_multi and not args.quiet:
        print("host %d/%d: %d cleaned, %d bucket%s owned, %d stolen"
              % (topo.host_id, topo.n_hosts, len(report.results),
                 report.n_buckets_owned,
                 "" if report.n_buckets_owned == 1 else "s",
                 report.n_stolen))
    return failed


def run_serve(args, telemetry: RunTelemetry) -> int:
    """The ``--serve`` session: the daemon's :class:`~iterative_cleaner_
    torch.config.ServeConfig` from the flags over their ``ICLEAN_*``
    mirrors, run until drained.  The session's registry is the daemon's,
    so ``--metrics-json``/``--prom-textfile`` hold its lifetime counters
    when the drain completes."""
    from iterative_cleaner_torch.config import ServeConfig
    from iterative_cleaner_torch.resilience import FaultInjector
    from iterative_cleaner_torch.serve import run_serve as serve

    cfg = config_of(args)
    try:
        serve_cfg = ServeConfig.from_env(
            spool_dir=args.spool or None,
            http_port=args.http_port,
            max_inflight=args.max_inflight,
            journal_path=args.journal or None,
            journal_segment_mb=args.journal_segment_mb,
            trace_out=args.trace_out or None,
            # store_true flags: absent defers to the env mirror
            join=args.join or None,
            member_ttl_s=args.member_ttl,
            result_cache=args.result_cache or None,
            # None: not passed (env or default); '' disables
            flight_recorder=args.flight_recorder,
            profile_dir=args.profile_dir or None,
            # bare --mux multiplexes the daemon's streams; absent defers
            # to ICLEAN_MUX
            mux=(True if args.mux_on else None),
            mux_max_wait_ms=args.mux_max_wait_ms,
            mux_max_batch=args.mux_max_batch,
        )
    except ValueError as exc:
        build_parser().error(f"--serve: {exc}")
    faults = (FaultInjector(args.faults, seed=args.fault_seed)
              if args.faults else FaultInjector.from_env())
    # the daemon's live /metrics carries the analyzer's verdict for the
    # build it runs (lint_findings{rule=...}, lint_ok)
    record_package_lint(telemetry.registry, quiet=args.quiet)
    return serve(serve_cfg, cfg, registry=telemetry.registry, faults=faults,
                 io_workers=args.io_workers, quiet=args.quiet,
                 events=telemetry.events)


def _parse_geometry_spec(spec: str):
    """'NSUBxNCHANxNBIN' -> (nsub, nchan, nbin) for --precompile arguments
    that are not paths; None when the string does not look like one."""
    parts = spec.lower().split("x")
    if len(parts) != 3:
        return None
    try:
        dims = tuple(int(v) for v in parts)
    except ValueError:
        return None
    return dims if all(v > 0 for v in dims) else None


def run_precompile(args) -> int:
    """The ``--precompile`` session: each argument resolved to a shape (a
    header peek for a path, else a parsed NSUBxNCHANxNBIN), the fleet's
    buckets planned as ``--fleet`` would, and each bucket warmed
    (:func:`~iterative_cleaner_torch.parallel.batch.warm_bucket`: the
    kernel library built into ``--compile-cache``) — then exit.  A later serving process over the same
    directory builds nothing."""
    import time

    from iterative_cleaner_torch.parallel.batch import warm_bucket
    from iterative_cleaner_torch.parallel.fleet import (
        _default_shape_fn,
        plan_fleet,
    )

    cfg = config_of(args)
    entries = []
    for spec in args.archive:
        if os.path.exists(spec):
            entries.append((spec, _default_shape_fn(spec)))
            continue
        dims = _parse_geometry_spec(spec)
        if dims is None:
            print("ERROR: --precompile argument %r is neither an existing "
                  "archive nor a NSUBxNCHANxNBIN geometry" % spec,
                  file=sys.stderr)
            return 2
        entries.append((spec, (*dims, False)))
    plan = plan_fleet(entries, group_size=cfg.fleet_group_size)
    for bucket in plan.buckets:
        nsub, nchan, nbin, ded = bucket.key
        t0 = time.perf_counter()
        warm_bucket(cfg, nsub, nchan, nbin, ded, bucket.batch_dim)
        if not args.quiet:
            print("precompiled %dx%dx%d%s batch=%d (%d archive%s) in %.2fs"
                  % (nsub, nchan, nbin, " dedispersed" if ded else "",
                     bucket.batch_dim, len(bucket.items),
                     "" if len(bucket.items) == 1 else "s",
                     time.perf_counter() - t0))
    if not args.quiet:
        from iterative_cleaner_torch.stats.kernels import build_dir

        print("compile cache warmed: %d bucket%s -> %s"
              % (len(plan.buckets), "" if len(plan.buckets) == 1 else "s",
                 build_dir()))
    return 0


def _stream_idle_s() -> float:
    return float(os.environ.get("ICLEAN_STREAM_IDLE_S", "30"))


def run_stream(args, telemetry: RunTelemetry) -> int:
    """The ``--stream DIR`` session: one live stream on this host.  Tails
    DIR for chunk files in sorted-name order, ingests each through an
    :class:`~iterative_cleaner_torch.online.OnlineSession` (the per-subint
    step on the card, the provisional zap, periodic reconciles), and ends
    on a ``stream.close`` sentinel, or after ``ICLEAN_STREAM_IDLE_S``
    seconds (default 30) with no new chunk, so an interrupted producer
    still gets its archive.  The close makes the output's mask the batch
    clean's of the same subints.  Returns the exit code."""
    import time

    from iterative_cleaner_torch.online import (
        CLOSE_SENTINEL,
        OnlineSession,
        is_chunk_name,
        load_chunk,
        load_stream_meta,
    )

    cfg = config_of(args)
    d = os.path.abspath(args.stream_dir)
    if not os.path.isdir(d):
        print("ERROR: --stream directory %s does not exist" % d,
              file=sys.stderr)
        return 2
    idle_s = _stream_idle_s()
    meta = load_stream_meta(d)   # None until an archive-container chunk
    session = None
    seen: set = set()
    last_new = time.monotonic()
    closed_by = "idle"
    while True:
        try:
            names = sorted(os.listdir(d))
        except OSError as exc:
            print("ERROR: cannot list %s: %s" % (d, exc), file=sys.stderr)
            return 1
        progressed = False
        for name in names:
            if name in seen or not is_chunk_name(name):
                continue
            path = os.path.join(d, name)
            seen.add(name)   # never spin on a chunk, good or bad
            try:
                data, weights, meta = load_chunk(path, meta)
            except (OSError, ValueError) as exc:
                print("ERROR reading chunk %s: %s" % (name, exc),
                      file=sys.stderr)
                continue
            if session is None:
                session = OnlineSession(
                    meta, cfg, registry=telemetry.registry,
                    stream_id=os.path.basename(d) or "stream")
            n = session.ingest(data, weights, label=name)
            progressed = True
            if not args.quiet:
                print("stream: subint %d <- %s (%.1f ms)"
                      % (n, name, session.latencies_s[-1] * 1e3),
                      flush=True)
        if progressed:
            last_new = time.monotonic()
            continue   # drain what is present before the close checks
        if CLOSE_SENTINEL in names:
            closed_by = "sentinel"
            break
        if time.monotonic() - last_new >= idle_s:
            break
        time.sleep(0.05)
    if session is None:
        print("ERROR: stream %s closed (%s) with no chunks ingested"
              % (d, closed_by), file=sys.stderr)
        return 1
    result = session.close()
    out = (args.output if args.output not in ("", "std")
           else os.path.join(d, "stream_cleaned.npz"))
    save_archive(result.archive, out)
    if not args.quiet:
        print("stream: closed (%s) after %d subints — p99 %.1f ms, "
              "%d warm-up compile%s, %d steady recompiles (kernel-library "
              "builds), %d reconciles, drift %d mid + %d final"
              % (closed_by, result.n_subints, result.p99_ms(),
                 result.warmup_compiles,
                 "" if result.warmup_compiles == 1 else "s",
                 result.recompiles_steady, result.reconciles,
                 result.mask_drift, result.final_drift))
        print("Cleaned archive: %s" % out)
    return 0


def run_mux(args, telemetry: RunTelemetry) -> int:
    """The ``--mux DIR...`` session: several live streams on this host.
    Tails every DIR for chunk files in sorted-name order and feeds them
    all through one :class:`~iterative_cleaner_torch.online.StreamMux`,
    whose dispatcher thread runs the pending subints of streams of one
    bucket as one batched step a tick (a bounded ring, a deadline).  Each
    stream closes on its own ``stream.close`` sentinel, or after
    ``ICLEAN_STREAM_IDLE_S`` seconds with no new chunk anywhere, and
    writes ``DIR/stream_cleaned.npz``, bit-equal to a ``--stream DIR``
    run of the same chunks.  Returns the exit code."""
    import time

    from iterative_cleaner_torch.online import (
        CLOSE_SENTINEL,
        StreamMux,
        is_chunk_name,
        load_chunk,
        load_stream_meta,
    )

    cfg = config_of(args)
    dirs, keys = [], {}
    for raw in args.mux_dirs:
        d = os.path.abspath(raw)
        if not os.path.isdir(d):
            print("ERROR: --mux directory %s does not exist" % d,
                  file=sys.stderr)
            return 2
        if d in keys.values():
            continue   # the same directory twice is one stream
        key = os.path.basename(d) or "stream"
        if key in keys:
            # stream ids label the telemetry and the summary: unique even
            # where two directories share a base name
            key = "%s-%d" % (key, len(keys))
        keys[key] = d
        dirs.append((key, d))
    idle_s = _stream_idle_s()
    mux = StreamMux(max_batch=args.mux_max_batch,
                    max_wait_ms=args.mux_max_wait_ms,
                    registry=telemetry.registry)
    mux.start()
    # each stream's tail state; a stream leaves open_dirs when its close
    # sentinel appears or the whole tail goes idle
    state = {key: {"seen": set(), "meta": load_stream_meta(d),
                   "opened": False} for key, d in dirs}
    open_dirs = dict(dirs)
    results, failed = {}, []
    last_new = time.monotonic()
    try:
        while open_dirs:
            progressed = False
            for key in list(open_dirs):
                d, st = open_dirs[key], state[key]
                try:
                    names = sorted(os.listdir(d))
                except OSError as exc:
                    print("ERROR: cannot list %s: %s" % (d, exc),
                          file=sys.stderr)
                    failed.append(key)
                    del open_dirs[key]
                    if st["opened"]:
                        mux.abandon_stream(key)
                    continue
                for name in names:
                    if name in st["seen"] or not is_chunk_name(name):
                        continue
                    st["seen"].add(name)   # never spin on a bad chunk
                    try:
                        data, weights, st["meta"] = load_chunk(
                            os.path.join(d, name), st["meta"])
                    except (OSError, ValueError) as exc:
                        print("ERROR reading chunk %s/%s: %s"
                              % (key, name, exc), file=sys.stderr)
                        continue
                    if not st["opened"]:
                        mux.open(key, st["meta"], cfg)
                        st["opened"] = True
                    # block: a full ring holds the tail back (the
                    # dispatcher thread drains it), never drops a chunk
                    mux.ingest(key, data, weights, label=name, block=True)
                    progressed = True
                    if not args.quiet:
                        n = mux.session(key).n_subints + mux.pending(key)
                        print("mux: %s subint %d <- %s" % (key, n, name),
                              flush=True)
                if CLOSE_SENTINEL in names and not progressed:
                    del open_dirs[key]
                    if not st["opened"]:
                        print("ERROR: stream %s closed (sentinel) with no "
                              "chunks ingested" % key, file=sys.stderr)
                        failed.append(key)
                        continue
                    results[key] = mux.close_stream(key)
            if progressed:
                last_new = time.monotonic()
                continue   # drain what is present before the idle check
            if open_dirs and time.monotonic() - last_new >= idle_s:
                # an interrupted producer still gets its archives
                for key in list(open_dirs):
                    del open_dirs[key]
                    if not state[key]["opened"]:
                        print("ERROR: stream %s closed (idle) with no "
                              "chunks ingested" % key, file=sys.stderr)
                        failed.append(key)
                        continue
                    results[key] = mux.close_stream(key)
                break
            if open_dirs:
                time.sleep(0.05)
    finally:
        mux.stop()
    for key, result in results.items():
        out = os.path.join(keys[key], "stream_cleaned.npz")
        save_archive(result.archive, out)
        if not args.quiet:
            print("mux: %s closed after %d subints — p99 %.1f ms, %d "
                  "reconciles, drift %d mid + %d final -> %s"
                  % (key, result.n_subints, result.p99_ms(),
                     result.reconciles, result.mask_drift,
                     result.final_drift, out))
    if not args.quiet and results:
        print("mux: %d stream%s, %d subints in %d dispatches (occupancy "
              "%.2f), %d warm-up compile%s, %d steady recompiles "
              "(kernel-library builds)"
              % (len(results), "" if len(results) == 1 else "s",
                 mux.subints, mux.dispatches, mux.occupancy_mean(),
                 mux.warmup_compiles,
                 "" if mux.warmup_compiles == 1 else "s",
                 mux.recompiles_steady))
    return 1 if failed or not results else 0


def run_archives(args, mesh=None) -> int:
    """Clean every archive of ``args`` in one session; 1 if any failed
    under ``--keep_going`` (or a ``--batch`` write failed), else 0
    (without it a failure raises)."""
    lead = mesh is None or mesh.rank == 0
    failed = []
    with run_session(args, lead, 0 if mesh is None else mesh.rank) \
            as telemetry:
        if args.fleet:
            failed = run_fleet(args, telemetry)
        elif args.batch > 1:
            failed = run_batched(args, telemetry, mesh)
        else:
            for path, preloaded in iter_archives(
                    list(args.archive), args.prefetch,
                    resolve_io_workers(args.io_workers)):
                try:
                    clean_one(path, args, telemetry, mesh, preloaded)
                except Exception as exc:  # per-archive isolation
                    if not args.keep_going:
                        raise
                    failed.append(path)
                    telemetry.record_failure(path, exc)
                    if lead:
                        print("ERROR cleaning %s: %s: %s"
                              % (path, type(exc).__name__, exc),
                              file=sys.stderr)
    if failed:
        if lead:
            print("Failed %d/%d archives: %s"
                  % (len(failed), len(args.archive), ", ".join(failed)),
                  file=sys.stderr)
        return 1
    return 0


def check_serve_args(parser, args, chunk: int) -> None:
    """The reference parser's refusals of the daemon's flags (exit 2):
    ``--serve`` takes no archives, none of the batch-run flags, and at
    least one intake; ``--join`` needs ``--journal``; the intake knobs,
    ``--trace-out`` and ``--flight-recorder`` need the mode they
    configure.  The daemon cleans on ``--backend torch`` (the reference
    says jax)."""
    if args.serve:
        if args.archive:
            parser.error("--serve takes no archive arguments: the daemon's "
                         "requests arrive via --spool/--http-port (drop the "
                         "paths, or drop --serve for a batch run)")
        if (args.fleet or args.precompile or args.resume or args.checkpoint
                or chunk > 0 or args.stream_dir or args.unload_res
                or args.batch > 1 or args.prefetch > 0 or args.output
                or args.model != SURGICAL_SCRUB or args.mesh != "off"):
            parser.error(
                "--serve is incompatible with the batch-run flags "
                "--fleet/--precompile/--resume/--checkpoint/--stream/"
                "--unload_res/--batch/--prefetch/-o/--model quicklook/"
                "--mesh (requests carry their own per-request overrides; "
                "live streams arrive as kind: \"stream\" requests; the "
                "daemon cleans on one card)")
        if args.backend != "torch":
            parser.error("--serve requires --backend torch (the daemon "
                         "cleans on the card; a request may not move to "
                         "the host)")
        if not (args.spool or args.http_port is not None
                or os.environ.get("ICLEAN_SPOOL")
                or os.environ.get("ICLEAN_HTTP_PORT")):
            parser.error("--serve needs at least one intake: --spool DIR "
                         "and/or --http-port PORT (or their ICLEAN_SPOOL/"
                         "ICLEAN_HTTP_PORT mirrors)")
        if args.join and not args.journal:
            parser.error("--join needs an explicit --journal PATH on "
                         "storage every pool member shares: the journal IS "
                         "the pool (an implicit per-cwd default would give "
                         "each member a private pool of one)")
        if args.member_ttl is not None and not args.join \
                and not os.environ.get("ICLEAN_JOIN"):
            parser.error("--member-ttl tunes the --join membership lease; "
                         "pass --join")
        if args.mux_dirs:
            parser.error("--serve runs --mux bare (daemon streams arrive as "
                         "kind: \"stream\" requests); the DIR form is the "
                         "standalone multiplexed mode — drop --serve or the "
                         "directories")
    elif (args.spool or args.http_port is not None
          or args.max_inflight is not None or args.join
          or args.member_ttl is not None or args.result_cache):
        parser.error("--spool/--http-port/--max-inflight/--join/"
                     "--member-ttl/--result-cache configure the --serve "
                     "daemon; pass --serve")
    if args.trace_out and not (args.fleet or args.serve):
        parser.error("--trace-out records the --fleet/--serve pipeline "
                     "spans; pass --fleet or --serve")
    if args.flight_recorder is not None and not (args.fleet or args.serve):
        parser.error("--flight-recorder instruments the --fleet/--serve "
                     "pipelines; pass --fleet or --serve")


def check_fleet_args(parser, args, chunk: int) -> None:
    """The reference parser's refusals of the fleet's flags (exit 2), and
    the flags whose modules are not ported (``NotImplementedError``
    naming the item)."""
    if args.coordinator or os.environ.get("ICLEAN_COORDINATOR"):
        raise NotImplementedError(f"--coordinator: {ROADMAP_FLEET_3B}")
    if args.resume and not args.journal:
        parser.error("--resume needs an explicit --journal PATH: resuming "
                     "against an implicit default journal risks skipping "
                     "work recorded by a different run")
    if args.fleet and (args.unload_res or args.checkpoint
                       or args.record_history or chunk > 0
                       or args.backend != "torch"
                       or args.model != SURGICAL_SCRUB
                       or args.mesh == "cell"):
        parser.error(
            "--fleet requires --backend torch and is incompatible with "
            "--unload_res/--checkpoint/--record_history/--stream/"
            "--model quicklook/--mesh cell (the batched clean gathers no "
            "residuals or histories; checkpoints are keyed to "
            "whole-archive cleaning)")
    if tuple(args.bucket_pad) != (0, 0) and not (args.fleet
                                                 or args.precompile):
        parser.error("--bucket-pad is a --fleet flag (accepted there for "
                     "the reference CLI's sake; the port pads nothing); "
                     "pass --fleet")
    if ((args.retries is not None or args.stage_timeout is not None
         or args.faults or args.journal or args.resume)
            and not (args.fleet or args.serve)):
        parser.error("--retries/--stage-timeout/--faults/--journal/--resume "
                     "configure the --fleet/--serve resilience ladder; pass "
                     "--fleet or --serve")
    if ((args.hosts is not None or args.host_id is not None
         or args.claim_ttl is not None) and not args.fleet):
        parser.error("--hosts/--host-id/--claim-ttl configure the --fleet "
                     "multi-host scheduler; pass --fleet")
    if args.hosts is not None and args.hosts < 1:
        parser.error(f"--hosts must be >= 1, got {args.hosts}")
    if args.host_id is not None and args.host_id < 0:
        parser.error(f"--host-id must be >= 0, got {args.host_id}")
    if args.claim_ttl is not None and args.claim_ttl <= 0:
        parser.error(f"--claim-ttl must be > 0, got {args.claim_ttl}")
    if args.host_id is not None and args.hosts is None \
            and not os.environ.get("ICLEAN_HOSTS"):
        parser.error("--host-id needs the host count: pass --hosts N (or "
                     "set ICLEAN_HOSTS)")
    eff_hosts = (args.hosts if args.hosts is not None
                 else _env_int("ICLEAN_HOSTS"))
    if eff_hosts is not None and eff_hosts > 1 and not args.journal:
        parser.error("--hosts N > 1 coordinates through the shared journal "
                     "(claim leases, work stealing, exactly-once "
                     "accounting); pass --journal PATH on storage every "
                     "host shares")
    if args.retries is not None and args.retries < 0:
        parser.error(f"--retries must be >= 0, got {args.retries}")
    if args.stage_timeout is not None and args.stage_timeout < 0:
        parser.error(f"--stage-timeout must be >= 0 (0 disables the "
                     f"watchdog), got {args.stage_timeout}")
    if args.faults:
        from iterative_cleaner_torch.resilience import (
            FaultSpecError,
            parse_fault_spec,
        )

        try:
            parse_fault_spec(args.faults)
        except FaultSpecError as exc:
            parser.error(f"--faults: {exc}")
    if args.compile_cache and args.backend != "torch":
        parser.error("--compile-cache requires --backend torch (the numpy "
                     "oracle builds no kernels)")
    if args.precompile:
        if args.backend != "torch":
            parser.error("--precompile requires --backend torch")
        if not (args.compile_cache
                or os.environ.get("ICLEAN_COMPILE_CACHE")):
            parser.error("--precompile warms the kernel build directory; "
                         "pass --compile-cache DIR (or set "
                         "ICLEAN_COMPILE_CACHE)")
        if args.mesh != "off" or chunk > 0 or args.unload_res \
                or args.checkpoint or args.model != SURGICAL_SCRUB:
            parser.error("--precompile warms the --fleet buckets and is "
                         "incompatible with --mesh/--stream/--unload_res/"
                         "--checkpoint/--model quicklook")
    if args.fleet and args.mesh == "batch":
        raise NotImplementedError(f"--fleet --mesh batch: {ROADMAP_FLEET_3B}")


def check_online_args(parser, args, chunk: int) -> None:
    """The reference parser's refusals of the online mode's flags (exit
    2): ``--stream DIR`` and ``--mux DIR...`` take no archives, run one
    mode at a time with the flagship on the torch backend, and their
    knobs refuse to run without them; bare ``--mux`` belongs to the serve
    daemon."""
    if not args.archive and not args.stream_dir and not args.mux_dirs \
            and not args.serve:
        if args.mux_on:
            parser.error("bare --mux multiplexes the --serve daemon's live "
                         "streams; pass --serve with it, or give --mux the "
                         "chunk directories to drive standalone")
        parser.error("at least one archive path is required (or pass "
                     "--serve, --stream DIR for the online mode, or --mux "
                     "DIR... for multiplexed streams)")
    if args.stream_dir:
        if args.archive:
            parser.error("--stream DIR (online mode) takes no archive "
                         "arguments: the chunks in DIR are the input")
        if (args.fleet or args.precompile or args.batch > 1
                or args.prefetch > 0 or args.mesh != "off"
                or args.unload_res or args.checkpoint
                or args.record_history or args.model != SURGICAL_SCRUB):
            parser.error(
                "--stream DIR (online mode) is incompatible with "
                "--fleet/--precompile/--batch/--prefetch/--mesh/"
                "--unload_res/--checkpoint/--record_history/--model "
                "(one live stream, cleaned with the flagship strategy)")
        if args.backend != "torch":
            parser.error("--stream DIR (online mode) requires --backend "
                         "torch (the per-subint step runs on the torch "
                         "engine)")
    if ((args.stream_reconcile_every is not None
         or args.stream_ew_alpha is not None)
            and not (args.stream_dir or args.mux_dirs or args.serve
                     or args.model == ONLINE_EWT)):
        parser.error("--stream-reconcile-every/--stream-ew-alpha configure "
                     "the online mode; pass --stream DIR, --mux DIR..., "
                     "--model online_ewt, or --serve (whose stream requests "
                     "inherit them)")
    if args.mux_dirs:
        if args.archive:
            parser.error("--mux DIR... (multiplexed online mode) takes no "
                         "archive arguments: the chunks in each DIR are the "
                         "input")
        if args.stream_dir:
            parser.error("--stream DIR drives ONE live stream; --mux DIR... "
                         "multiplexes many — pass one mode, not both")
        if (args.fleet or args.precompile or args.batch > 1
                or args.prefetch > 0 or args.mesh != "off"
                or args.unload_res or args.checkpoint
                or args.record_history or chunk > 0
                or args.output or args.model != SURGICAL_SCRUB):
            parser.error(
                "--mux DIR... (multiplexed online mode) is incompatible "
                "with --fleet/--precompile/--batch/--prefetch/--mesh/"
                "--unload_res/--checkpoint/--record_history/--stream/"
                "-o/--model (live streams, cleaned with the flagship "
                "strategy; each stream writes DIR/stream_cleaned.npz)")
        if args.backend != "torch":
            parser.error("--mux (multiplexed online mode) requires "
                         "--backend torch (the shared batched per-subint "
                         "step runs on the torch engine)")
    elif args.mux_on and not args.serve:
        parser.error("bare --mux multiplexes the --serve daemon's live "
                     "streams; pass --serve with it, or give --mux the "
                     "chunk directories to drive standalone")
    if ((args.mux_max_wait_ms is not None or args.mux_max_batch is not None)
            and not args.mux_on and not os.environ.get("ICLEAN_MUX")):
        parser.error("--mux-max-wait-ms/--mux-max-batch tune the stream "
                     "multiplexer; pass --mux (bare under --serve, or with "
                     "the chunk directories)")
    if args.mux_max_wait_ms is not None and args.mux_max_wait_ms < 0:
        parser.error(f"--mux-max-wait-ms must be >= 0 (0 dispatches "
                     f"immediately), got {args.mux_max_wait_ms}")
    if args.mux_max_batch is not None and args.mux_max_batch < 1:
        parser.error(f"--mux-max-batch must be >= 1, got "
                     f"{args.mux_max_batch}")


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.io_workers is not None and args.io_workers < 1:
        parser.error(f"--io-workers must be >= 1, got {args.io_workers}")
    split_stream_arg(args)
    # --selfcheck runs the analyzer and exits: no archives, no session
    if args.selfcheck:
        if (args.archive or args.serve or args.fleet or args.stream_dir
                or args.precompile or str(args.stream) != "0"
                or args.mux_on):
            parser.error("--selfcheck analyzes the installed package and "
                         "takes no archives or run modes")
        from iterative_cleaner_torch.analysis.cli import run_selfcheck

        return run_selfcheck(fmt=args.selfcheck_format or "text",
                             device=args.device,
                             journal_fsck=args.journal_fsck)
    if args.selfcheck_format is not None:
        parser.error("--format/--selfcheck-format only applies to "
                     "--selfcheck; pass --selfcheck")
    if args.journal_fsck:
        parser.error("--journal-fsck only applies to --selfcheck; pass "
                     "--selfcheck (or use the icln-lint-torch console "
                     "script)")
    # what is not ported, then what the reference's parser refuses,
    # before any clean
    chunk = stream_chunk(args.stream)
    check_fleet_args(parser, args, chunk)
    check_serve_args(parser, args, chunk)
    check_online_args(parser, args, chunk)
    if args.batch > 1 and (args.unload_res or chunk > 0 or args.checkpoint
                           or args.mesh == "cell"):
        parser.error("--batch is incompatible with --unload_res, --stream, "
                     "--checkpoint and --mesh cell")
    if args.model != SURGICAL_SCRUB and (args.batch > 1 or args.unload_res
                                         or args.checkpoint
                                         or args.record_history
                                         or args.mesh != "off"):
        parser.error(
            "--model %s is incompatible with --batch/--unload_res/"
            "--checkpoint/--record_history/--mesh (single-pass: no "
            "residual, no weight history; checkpoints are keyed to the "
            "flagship strategy)" % args.model)
    if chunk > 0 and (args.checkpoint or args.model != SURGICAL_SCRUB):
        parser.error("--stream is incompatible with --checkpoint and "
                     "--model quicklook (checkpoints are keyed to "
                     "whole-archive cleaning)")
    from iterative_cleaner_torch.utils import configure_compilation_cache

    configure_compilation_cache(args.compile_cache)
    if args.precompile:
        with run_session(args) as telemetry:
            # the analyzer's verdict rides the warm-up: a fleet warmed
            # from a lint-dirty build says so in the exported metrics
            record_package_lint(telemetry.registry, quiet=args.quiet)
            return run_precompile(args)
    if args.serve:
        with run_session(args) as telemetry:
            return run_serve(args, telemetry)
    if args.stream_dir or args.mux_dirs:
        with run_session(args) as telemetry:
            return (run_stream if args.stream_dir else run_mux)(args,
                                                                telemetry)
    if args.mesh == "batch" and args.batch <= 1:
        parser.error("--mesh batch splits the --batch groups over the "
                     "ranks; pass --batch B (B > 1)")
    if args.backend != "torch" and (args.batch > 1 or args.mesh != "off"):
        parser.error("--batch B > 1 and --mesh cell|batch require "
                     "--backend torch")
    check_mesh(args.mesh, config_of(args))
    if args.mesh == "off":
        return run_archives(args)
    from iterative_cleaner_torch.parallel import distributed
    from iterative_cleaner_torch.parallel.mesh import batch_mesh, cell_mesh

    distributed.initialize(device=args.device)
    try:
        return run_archives(
            args, batch_mesh() if args.mesh == "batch" else cell_mesh())
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    sys.exit(main())
