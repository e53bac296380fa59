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
cleans it through ``clean_archive_sharded`` (the cell-sharded clean)
on one rank under NCCL — the default route and the dedispersed frame
(K10, the tree-reduced selects) and the profile baseline and the pulse
window (the two_read route: K7 on the block, then K3, the combine and
K9 on the planes gathered whole), each held bit for bit to the whole
clean's mask, scores and telemetry — and on four gloo ranks sharing the
card as a 2 x 2 mesh, each rank mapping the cube from one file and
uploading its quarter, on the default and profile routes, held to the
whole cleans and the goldens, with each rank's launch counts, peak
memory and iteration time; streams it over the one NCCL rank
(``clean_streaming(..., mesh)``: exact at budget 0 on the default and
profile routes, online), each bit-equal to its single-card stream, and
a 256 x 1024 x 128 archive over the four gloo ranks, mask-equal to the
single-card exact stream; holds every kernel against its plain PyTorch version on
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
the in-process clean, its load to the native PSRFITS reader (held bit
for bit to the pure-Python reader on the same file, both timed); writes
the archive as ``.icar`` and runs one session over it and the PSRFITS
file with ``--prefetch 1``, both output masks held to the in-process
clean and the ``.icar`` output's cube to its input's, each archive's
load seconds printed (the second the wait for its prefetched load);
cleans a 16 x 32 x 8192 archive (long profiles:
the DFT tables streamed in chunks) on the default, profile-baseline and
dedispersed routes with each mask held to the port's CPU clean and each
kernel to its plain version there; holds K3 and K8 bit for bit to their
plain versions on scaler lines of 50,000 entries (longer than a block
holds: the thread-block-cluster kernel of ``sides_cluster.cu`` in place
of K3, one launch) and streams a 48,000 x 4 x 32 archive exactly at
budget 0, its mask held to the whole clean's; on lines past the
cluster's capacity (4 x 1,000,000 in float32 and float64) holds K9 and
the two tail kernels of ``sides_tail.cu`` to the plain version; cleans
the single-pulse archive (65,536 x 128 x 64, the golden's sample count,
built on a worker process from the start) through ``clean_archive(ar,
CleanConfig())``: one cluster launch and one K3 axis-1 launch an
iteration and K9 only for the telemetry, the first iteration's four
planes through the cluster kernel bit-equal to ``scaled_sides_plain`` and
to ``scaled_sides_long`` in float32 and float64, the whole clean's
weights, scores and loops bit-equal to the same clean with
``engine.loop.scaled_sides`` swapped in this process for the old
composition, the cluster kernel, the old composition and the tail
kernels timed at its planes beside their bounds, ms per iteration, the
scalers' share and peak memory; times each kernel, its plain version and the
library yardstick beside the least time the card could take, and each
route's iteration; prints one JSON line with the kernels and, last,
``{"ok": true, "device": ...}``.

The batch phases (``parallel/batch.py``): (a) 32 archives of 64 x 128 x
512 (seeds 100-131, their RFI density stepped so that their loop counts
differ) cleaned as one batch on the default route through
``clean_archives_batched``, each archive held to its single clean on the
card bit for bit (masks, loops, convergence, per-loop diffs, scores and
telemetry rows; the template stage's products and sums run at one
archive's shapes, held to the single archive's op by op on identical
inputs and timed against its archives one by one), each kernel of the
route launched once per batch iteration (the
launch counts, and one batch iteration's trace on a process of its
own); (b) the same on the
profile, dedispersed and pulse-window routes; (c) four 1024 x 4096 x 128
archives (the golden's, seed 0, held to the golden, and seeds 1-3 made
as it is, built on worker processes while the earlier phases run) as
one batch; the batched K1, K2, K6, K7, K3 (both axes), combine and K9
each against its plain version and timed against B launches on one
archive, at both sizes; (d) ``--batch 8`` over 16 PSRFITS files of two
interleaved shapes against a sequential CLI session (the prepass's
grouping, masks and report entries); (e) ``--mesh batch`` on the one
NCCL rank (bit-equal to the plain batch) and on four gloo ranks sharing
the card over 10 archives padded to 12 (mask-equal).

The bf16 storage mode (``compute_dtype='bfloat16'``; its parity probe run
once before the counted runs): the golden archive on the default route
(K1 and K2 read the bf16 cube; held to the golden's band, at most
BF16_MAX_BORDERLINE_FLIPS flips); a full-size bf16-exact
archive (the reference's construction, the roll rotation) on the default,
profile and dedispersed routes, each bf16 mask bit-equal to its float32
clean's, both runs' ms per iteration; stream (a) in bf16, its cube
uploads exactly half of (a)'s bytes a loop, held to the whole bf16 clean
of the raw cube rounded as the stream rounds it (its flips against the
golden, an unrounded input's, printed); batch
(a) in bf16, bit-equal to its single bf16 cleans; the one-rank NCCL
sharded clean in bf16 (default and dedispersed routes, K10 on the bf16
block), bit-equal to the whole bf16 cleans.  Each phase prints its
launch counts (the bf16 builds counted under ``<name>_bf16``), ms per
iteration, peak memory and the ``compute_dtype_ineligible`` counters,
which must stay empty.  The bf16 builds are held bit for bit to their
float32 launches on the upcast cubes and to their plain versions at the
route's shapes, and listed in the kernels line beside the float32 ones.

float64 (``dtype='float64'``, the oracle-parity mode the goldens were made
in): the golden archive on the default, profile, dedispersed and
pulse-window routes, every kernel launched its float64 build and nothing
else, the default and profile masks held to the goldens with no flip at
all and the golden's loops (the reference harness's float64 rule), the
other two to the float64 default under the frames' contract; stream (a)
in float64 at budget 0, 0 cells off the whole float64 clean, its cube
uploads exactly twice (a)'s a pass; ``tools selftest`` on the card as a
subprocess and ``--backend numpy`` (the float64 numpy oracle) through the
CLI on a 64 x 128 x 128 archive, equal to the float64 card clean's mask;
the float64 builds of K1, K2, K6, K7, K3, the combine, K8 and K9 against
their plain float64 versions at full size (K1 within 1e-12 of
sum|w*disp|, the cell planes within 1e-12 of each plane's scale, the
rest bit-equal), each timed beside its bound (bytes at 8 a sample,
operations at PEAK_F64_PER_S) and listed in the kernels line; a
48,000 x 4 x 32 archive streamed in float64 (K9 and the tail kernels'
float64 builds), held to its whole float64 clean.  Each float64 phase
prints its seconds.

The rest of the CLI surface: ``--model quicklook`` on the golden archive
in float32 and float64 (K6 with a zero template and a window of ones, K3
twice and the combine once each, and no other launch; the float32 mask
held to the float64 one under the goldens' flip rule; the whole-clean ms
and the peak beside the default clean's; K6's zero-template planes
against its plain version and d_mean's sign flipped back giving
bit-equal scores; the float64 quicklook bit-equal to the numpy twin on a
64 x 128 x 128 archive), each run's launches in the kernels line's
``launches_by_route`` (``quicklook``, ``quicklook f64``); ``tools sweep
--device cuda`` over a 3 x 3 grid on a 64 x 128 x 128 archive for both
models, each row held to an in-process clean; then on the CLI phase's
``golden.sf``: ``--checkpoint`` (a first session saving, its output the
in-process clean's mask; a second printing the resume line, launching no
kernel and writing a byte-identical output; ``tools diff`` of its
checkpoint and one saved from the in-process clean exiting 0; ``-c 4.9``
cleaning again; the seconds of the checkpoint write, the fast-path
resume and the whole-cube fingerprint), ``tools borderline --backend
torch --device cuda`` listing every cell where the float32 clean differs
from the golden, and ``--trace DIR`` on a spawned process (the session's
seconds without and with it; the trace's five stage ranges once per loop
and each of the port's kernels as often as the launch counters say, a
disagreeing trace printed and taken again up to TRACE_ATTEMPTS times).

The fleet phases (after batch (d), on PSRFITS files in a temporary
directory): (f1) 24 archives of three shapes interleaved (16 of 64 x 128
x 512, 4 of 64 x 120 x 512, 4 of 256 x 1024 x 128) through ``--fleet
--batch 8 --bucket-pad 0,32`` (the grid is accepted and changes no
bucket: the port pads nothing), ``--batch 8`` and the sequential
session, in two rounds of opposite order: every output mask and
run-report entry of each fleet session equal to the first sequential
session's, each batch's kernels launched once per batch iteration, the
six sessions' seconds in the order they ran; (f2) the injected ladder (``--faults
load:err@2,write:once,exec:oom@1,exec:hang@3 --stage-timeout``) on a
spawned session: exit 1 with the hung archive alone failed, one watchdog
trip, an OOM split, the others' masks equal; (f3) a real
``torch.OutOfMemoryError`` on a spawned process under
``set_per_process_memory_fraction`` set from the batch's measured peaks:
a group of 8 halved until it fits, masks bit-equal to the single cleans,
then an archive that does not fit at all failed in the clean stage with
its OOM error (the port cleans nothing off the card by itself); (f4) a ``--journal`` fleet killed with
SIGKILL after its second journaled group, then ``--resume``: each archive
journaled once, the outputs the sequential ones; (f5) two sessions over
one fresh ``--compile-cache`` (the first runs ``nvcc`` once, on its
warm-up, while its first loads go on; the second builds nothing and hits
every bucket);
(f6) two ``--hosts 2`` processes over one journal: each archive cleaned
once, the masks the sequential ones, each host's owned and stolen
buckets printed.

The online mode (``online/``): (o1) the first 64 subints of the golden
archive (4096 x 128) streamed through an ``OnlineSession`` with a
reconcile every 16 subints, each subint's launches read (K6, K3 along
each axis and the combine once each), each reconcile's mask and scores
bit-equal to the batch clean of its prefix and the close to
``clean_archive`` of the 64 subints, no kernel-library build after the
warm-up, the per-subint p50 and p99 latency and the reconcile and close
seconds printed; (o2) 16 streams of 8 subints each (the golden's next
slices) through 16 solo sessions and through one ``StreamMux``
(max_batch 16, fed round-robin): every lane's provisional mask, scores
and EW template bit-equal to its solo session's, one launch of each of
the step's kernels a dispatch, the subints a second of both; (o3) K6, K3
along each axis and the combine at (1, 1, 4096, 128) and (16, 1, 4096,
128) in float32, bf16 storage (K6) and float64 against their plain
versions, each timed beside its bound (the ``online`` entry of its row in
the kernels line); (o4) ``--stream DIR`` on (o1)'s subints and ``--mux D1
D2 D3`` on three of (o2)'s streams, written as ``.npy`` chunks with a
``stream.json``, on spawned processes, their ``stream_cleaned.npz`` masks
equal to (o1)'s and (o2)'s closes; (o5) ``--model online_ewt`` on (o1)'s
archive, its provisional mask and scores equal to (o1)'s before its first
reconcile.

The serve daemon (``serve/``, ``--serve``), after the ``--trace`` phase in
the CLI phase's directory, each daemon a spawned ``python -m
iterative_cleaner_torch --serve`` process on the card with ``--journal``,
``--trace-out``, ``--result-cache`` and the default flight recorder: (s1)
``golden.sf`` through ``POST /submit``, 8 PSRFITS files of 64 x 128 x 512
dropped in the spool as one request and a ``baseline_mode="profile"``
override, each output bit-equal to the in-process ``clean_archive``, the
golden under the goldens' flip rule, each request's launches (the
daemon's ``/debug/vars`` counts before and after it) its fleet batches'
kernels once per batch iteration; (s2) the golden's first 32 subints as
one ``kind: "stream"`` request over ``POST /stream/<id>/subint``, its
close bit-equal to ``clean_archive`` of the prefix, the per-subint
latency p50/p99; (s3) ``POST /profile?seconds=1`` during the spool
request: the capture published whole, its manifest naming the card, its
trace holding each kernel the counters counted (taken again up to
TRACE_ATTEMPTS times), the ``prof_hbm_util``/``prof_roofline_frac``
gauges in (0, 1.05]; (s4) the spool request again answered from the
result cache with no launch, SIGTERM (exit 0), the journal's one done
line per request and the span export's request, execute, load and write
spans under each request's trace id, then a request killed with SIGKILL
mid-fleet and a restart on the same journal: each archive journaled done
once, the outputs (s1)'s.  The kernels line's K1, K2, K3, K7, K9, K6 and
combine rows gain a ``serve`` entry with their launches in (s1) and (s2).

The control plane (``analysis/``), after the fleet and serve phases: (c1)
``python -m iterative_cleaner_torch --selfcheck --format json`` on a
spawned process on the card, its ``ok`` held: zero unsuppressed lint
findings over the package and every registered hot program's card
contracts (no host sync inside a step, one per loop iteration, no
float64, the pinned dispatch count, the cube read by its kernels alone,
no cube-sized allocation), each program's host reads, ops, launches and
peak per iteration printed with the seconds it took; (c2)
``--journal-fsck`` over the journals the fleet phases (f4) (a SIGKILL'd
run and its resume) and (f6) (two hosts) and the serve daemon leave
behind, each required ok, a torn tail passing as a warning; (c3) an
``.item()`` seeded into the online step, caught on the card by the
dispatch count and by the sync debug mode.

Long profiles past the DFT tables (``csrc/cell_fft.cu``, the FFT build
of the cell diagnostics), after phase 3p: (L1) every entry of the FFT
build (K2 with and without the Nyquist term, K7, K6, K10's two) against
its plain version on the card in float32, bf16 and float64, a cluster of
4 blocks a cell (8 x 32 x 32768; float64 16,384, a cluster of 2), a
cluster of 8 (8 x 32 x 65536; float64 32,768, a cluster of 4), the
radix-3 stage (8 x 32 x 24576) and a batch of two, within 1e-4 of each
plane's scale (1e-12 in float64), K10's
bit-equal to K2's and K6's on a 2 x 2 shard and the batch to its
archives' own launches, each entry timed at the cluster shape; (L2) K2
(the DFT route) and the FFT build called as a function on the same
inputs at 8192 and 16,384 bins, each against the float64 plain version
and the two against each other, both timed (where the crossover lies);
(L3) a 32 x 256 x 65536 archive (a 3.75 s pulsar folded at 57 us, built
on a worker process from the start) through ``clean_archive`` on the
default route in float32, the dedispersed frame and float64 (the
slice's main path), then the profile baseline and the one-rank sharded
default and dedispersed cleans, each counted (the route's FFT build once
an iteration, no DFT launch), the float32 mask held to the float64 one
by the goldens' flip rule, the dedispersed one to the default by the
frames' contract, the sharded cleans bit-equal to the whole ones; the
main path's FFT builds timed at full width beside their bounds, their
plain versions and ``torch.fft.rfft`` alone on the centred rows, with ms
an iteration and peak memory; (L4) the long-profile card tests' archive
(4 x 8 x 32768, seed 41): the integration and profile baselines'
float32 offsets on the card within 3.4e-7 of the float64 offsets' scale
(and whether they are the CPU's bits), and the float32 cleans on the default,
dedispersed and profile routes, their scores no farther from the
float64 clean's than the CPU's float32 scores by more than 1e-3.

Every profile length the reference cleans (K2f's mixed radix-3/5 stages,
K2g, ``csrc/cell_fft_global.cu``, the FFT build through device memory),
after (L4) and (L3): (L5e) every K2g entry (Bluestein rows in a
thread-block cluster, K2g's cluster mode, at 16,411, 28,672 and 65,521
bins; Bluestein's passes on the shorter convolution at a prime past the
cluster, 136,537 bins, float64 69,127; split rows at 524,288, float64
262,144, and at 20,000 (float32, bf16) and 60,000) and K2f at odd
parts 45 (float32,
bf16) and 625 (float64) against their plain versions in float32, bf16
and float64, within 1e-4 of each plane's scale (1e-12 in float64), the
moments' masked cells bit-equal (K2g's d_fft by the tolerance on every
cell: torch.fft on the card does not take an odd-length zero row to
zero), K10 bit-equal to K2 and K6, a batch of two and ``out=`` tiles
bit-equal, bf16 bit-equal to float32 on the upcast cube, each K2g entry
timed; (L5) three archives, each made when its turn comes (its noise
and dispersion on the card):
(L5a) 32 x 256 x 60000 (a 3.42 s pulsar at 57 us; odd part 1875, five
odd stages: K2g's split row in both dtypes, the faster build),
(L5b) 32 x 256 x 65521 (a prime, K2g's cluster mode: no scratch), (L5c)
16 x 64 x 524288 (PSR J0901-4046's 75.9 s at 145 us, 2^29 samples; past the
cluster's capacity, K2g's split route), each through ``clean_archive``
on the default route in float32 and float64, (L5b) and (L5c) also the
dedispersed frame and the profile baseline (float32 and float64), (L5c)
the one-rank sharded default clean: each counted (its route's FFT build
once an iteration, no other spectrum launch), the float32 masks held to
the float64 ones by the goldens' flip rule, the dedispersed one by the
frames' contract, the sharded clean bit-equal; every clean's FFT build
held to its plain version at full width and timed beside its bound, its
plain version and ``torch.fft.rfft`` alone, with ms an iteration and the
launch's and the clean's peak memory.

It exits non-zero, printing no result, when no CUDA device is present
or when the port's package is not beside it.  It imports nothing of JAX
or of the reference package.
"""

from __future__ import annotations

import argparse
import atexit
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor, wait

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

# The H100 SXM peaks and the kernels' bytes-and-operations model the
# bounds come from live in the port's profiler (telemetry/profiling.py:
# PEAK_BYTES_PER_S, PEAK_F32_PER_S, PEAK_F64_PER_S, kernel_bounds,
# bound_ms), which the serve daemon's roofline gauges read too.
try:
    from iterative_cleaner_torch.telemetry import profiling
except ImportError:     # the package is not beside this script: main fails
    profiling = None

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

# The streamed shard phase's four gloo ranks: an exact stream of this
# archive, cut from the full size to a quarter of the subints and of the
# channels (four ranks time-share one card and stage every gather through
# host memory), in tiles of 64 subints.
SHARD_STREAM_ARCHIVE = dict(nsub=256, nchan=1024, nbin=128, seed=11,
                            n_prezapped=200, n_rfi_cells=400,
                            n_rfi_channels=8, n_rfi_subints=4)
SHARD_STREAM_CHUNK = 64

# The CLI phases write the archive as PSRFITS (nbits 32) and as .icar,
# and the CLI writes a cleaned copy beside each: room for the four (about
# 4.1 float32 cubes) and a margin.
CLI_DISK_FACTOR = 4.5

# Tolerances of the kernel checks (see tests/test_torch_kernels.py):
K1_RTOL = 1e-5   # of sum |w * disp|: float32 sums in another order
K2_RTOL = 1e-4   # of each plane's scale (K2, K6, K7): float32
#                  reassociation; masked cells exact


# The control-plane phase: the spawned --selfcheck's time limit, and the
# journals the fleet and serve phases leave, copied aside (name -> path)
# for its --journal-fsck: the serve phase's directory goes with the CLI
# phase's, the fleet's at exit
CONTROL_TIMEOUT_S = 300
KEPT_JOURNALS = {}
_KEEP_LOCK = threading.Lock()
_KEEP_DIR = None


def keep_journal(path: str, name: str) -> None:
    """Copy journal ``path`` (a file) aside for the control-plane phase
    as ``name``; the fleet phases call it from their threads."""
    global _KEEP_DIR
    with _KEEP_LOCK:
        if _KEEP_DIR is None:
            _KEEP_DIR = tempfile.mkdtemp(prefix="icln_chip_smoke_journals_")
            atexit.register(shutil.rmtree, _KEEP_DIR, True)
        dst = os.path.join(_KEEP_DIR, name)
        shutil.copyfile(path, dst)
        KEPT_JOURNALS[name] = dst


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


def flip_verdict(flips, golden, cap=MAX_BORDERLINE_FLIPS) -> dict:
    """Classify mask flips against the golden's borderline band."""
    border = {(i, c): s for i, c, s in golden["borderline"]}
    rogue, wide = [], []
    for i, c in flips:
        key = (int(i), int(c))
        if key not in border:
            rogue.append(key)
        elif abs(border[key] - 1.0) > FLIP_NOISE_ENV:
            wide.append(key)
    over_cap = len(flips) > cap
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
    """Cells whose float32 (float64) bits differ, NaN matching NaN."""
    nan_g, nan_w = torch.isnan(got), torch.isnan(want)
    bits = torch.int64 if got.dtype == torch.float64 else torch.int32
    same = (got.view(bits) == want.view(bits)) | (nan_g & nan_w)
    return int((~same).sum())


def max_abs_diff(got, want, torch) -> float:
    """Largest |got - want| over cells, equal values (inf included) and
    NaN against NaN counting 0, NaN against a number counting inf."""
    same = (got == want) | (torch.isnan(got) & torch.isnan(want))
    diff = torch.nan_to_num((got - want).abs(), nan=float("inf"))
    return float(torch.where(same, torch.zeros_like(diff), diff).max())


def diags_check(got, want, mask, torch, rtol=K2_RTOL):
    """K2/K6/K7 against their plain versions: ``rtol`` of each plane's
    scale, masked cells bit-equal.  Returns (max abs error, ok)."""
    err, ok = 0.0, True
    for g, w in zip(got, want):
        scale = float(w[~mask].abs().max())
        diff = (g - w).abs()
        err = max(err, float(diff.max()))
        ok &= bool((diff <= rtol * (w.abs() + scale)).all())
        ok &= bits_mismatch(g[mask], w[mask], torch) == 0
    return err, ok


def golden_check(label, result, suffix, shape,
                 cap=MAX_BORDERLINE_FLIPS) -> None:
    """Hold ``result``'s mask to ``fullsize_mask{suffix}.npz`` under the
    goldens' flip rule (at most ``cap`` flips), with the golden's loops
    and convergence."""
    golden, want_zap = golden_mask(suffix, shape)
    fw = result.final_weights
    if fw.shape != shape or not np.all(np.isfinite(fw)):
        fail(f"{label}: final weights malformed: shape {fw.shape}")
    got_zap = fw == 0
    flips = np.argwhere(want_zap != got_zap)
    verdict = flip_verdict(flips, golden, cap)
    border = {(i, c): s for i, c, s in golden["borderline"]}
    band = sorted(abs(border[(int(i), int(c))] - 1.0) for i, c in flips
                  if (int(i), int(c)) in border)
    print(f"golden fullsize_mask{suffix} ({label}): loops {result.loops} "
          f"(want {golden['loops']}), converged {result.converged}, zapped "
          f"{int(got_zap.sum())} (want {golden['zap_cells']}), flips "
          f"{len(flips)} (cap {cap}; the oracle's |score - 1| of each "
          f"{[round(x, 5) for x in band]}), rogue "
          f"{verdict['rogue'][:5]}, wide {verdict['wide'][:5]}",
          flush=True)
    if not (verdict["ok"] and result.loops == golden["loops"]
            and result.converged == golden["converged"]):
        fail(f"{label}: full-size mask outside the golden's flip rule")


def whole_contract(label, result, whole, what="default") -> None:
    """Hold ``result``'s mask to the whole clean's (of the ``what``
    configuration): at most STREAM_MAX_FLIPS cells, each scored within
    STREAM_FLIP_BAND of 1 by the whole run (a cross-tile or cross-rank
    template sum may move a score by an ulp)."""
    flips = (result.final_weights == 0) != (whole.final_weights == 0)
    near = np.abs(whole.scores - 1.0) <= STREAM_FLIP_BAND
    print(f"{label} against the whole {what} clean: {int(flips.sum())} "
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
    block, then the same clean on the two_read route (the profile
    baseline: K7 on the block, the gathered scaler).  Returns its counts,
    times, peak memory and (rank 0) the results."""
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
    del prep, c, w
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    profile = clean_archive_sharded(
        ar, CleanConfig(device="cuda:0", baseline_mode="profile"), mesh)
    torch.cuda.synchronize()
    return {"rank": mesh.rank, "coords": mesh.coords, "counts": counts,
            "clean_ms": clean_ms, "iter_ms": iter_ms, "peak_gib": peak_gib,
            "block": (layout.s0, layout.s1, layout.c0, layout.c1),
            "result": result, "profile_counts": K.launch_counts(),
            "profile_clean_ms": (time.perf_counter() - t0) * 1e3,
            "profile_peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "profile_result": profile}


def gloo_stream_rank():
    """One of the GLOO_RANKS ranks of the streamed shard phase, started
    by ``run_local_ranks`` with gloo on cuda:0: the exact stream at
    budget 0 of the SHARD_STREAM_ARCHIVE in SHARD_STREAM_CHUNK-subint
    tiles over the 2 x 2 mesh (each rank its block of every tile, K8 on
    the gathered whole planes).  Returns its counts, the stream's gauges
    and counters, peak memory and (rank 0) the result."""
    import torch

    from iterative_cleaner_torch import CleanConfig, clean_streaming
    from iterative_cleaner_torch.io.synthetic import make_synthetic_archive
    from iterative_cleaner_torch.parallel.mesh import cell_mesh
    from iterative_cleaner_torch.parallel.tile_cache import DictRegistry
    from iterative_cleaner_torch.stats import kernels as K

    ar, _ = make_synthetic_archive(**SHARD_STREAM_ARCHIVE)
    mesh = cell_mesh()
    reg = DictRegistry()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    result = clean_streaming(ar, SHARD_STREAM_CHUNK,
                             CleanConfig(device="cuda:0", stream_hbm_mb=0),
                             mesh, registry=reg)
    torch.cuda.synchronize()
    return {"rank": mesh.rank, "coords": mesh.coords,
            "counts": K.launch_counts(), "gauges": reg.gauges,
            "counters": reg.counters,
            "clean_ms": (time.perf_counter() - t0) * 1e3,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "result": result}


# The batch phases: BATCH_SEEDS archives of BATCH_SHAPE (BASELINE.md
# config 1's shape, config 4's count), their RFI density varied so that
# their loop counts differ; four full-size archives (the golden's, seed 0,
# and FULLSIZE_BATCH_SEEDS, made as it is made, built on worker processes
# while the earlier phases run); the CLI's --batch over BATCH_CLI_FILES
# PSRFITS files of two shapes; --mesh batch over BATCH_MESH_ARCHIVES of
# the small archives on the four gloo ranks (padded to a multiple of 4).
BATCH_SHAPE = (64, 128, 512)
BATCH_SEEDS = range(100, 132)
FULLSIZE_BATCH_SEEDS = (1, 2, 3)
BATCH_CLI_SHAPES = ((64, 128, 512), (32, 256, 256))
BATCH_CLI_FILES, BATCH_CLI_GROUP = 16, 8
BATCH_MESH_ARCHIVES = 10
TRACE_ATTEMPTS = 3          # batch (a)'s torch.profiler traces at most
BATCH_ROUTES = {"default": {}, "profile": dict(baseline_mode="profile"),
                "dedispersed": dict(stats_frame="dedispersed"),
                "pulse": dict(pulse_region=(0.2, 30, 60))}


def batch_small_archive(seed, shape=BATCH_SHAPE):
    """One archive of the batch phases: ``shape``, its RFI density and
    strength stepping with ``seed % 4``."""
    from iterative_cleaner_torch.io.synthetic import make_synthetic_archive

    k = seed % 4
    nsub, nchan, nbin = shape
    ar, _ = make_synthetic_archive(
        nsub=nsub, nchan=nchan, nbin=nbin, seed=seed,
        n_rfi_cells=4 + 40 * k, n_rfi_channels=k % 3,
        n_rfi_subints=(k + 1) % 2, rfi_strength=6.0 + 12.0 * k,
        n_prezapped=3 * k)
    return ar


def build_fullsize_seed(seed, out_dir):
    """A full-size archive made as the golden's is (``bench_rfi_density``,
    float64, dispersed) at ``seed``, its cube saved to ``out_dir`` as a
    ``.npy`` (run on a worker process); returns the other fields."""
    import dataclasses as dc

    from iterative_cleaner_torch.io.synthetic import (
        FULLSIZE_SHAPE,
        bench_rfi_density,
        make_synthetic_archive,
    )

    nsub, nchan, nbin = FULLSIZE_SHAPE
    ar, _ = make_synthetic_archive(nsub=nsub, nchan=nchan, nbin=nbin,
                                   **bench_rfi_density(nsub, nchan),
                                   seed=seed, dtype=np.float64, disperse=True)
    path = os.path.join(out_dir, f"seed{seed}.npy")
    np.save(path, ar.data)
    return path, {f.name: getattr(ar, f.name) for f in dc.fields(ar)
                  if f.name != "data"}


# The single-pulse archive (one subint a rotation: 65,536 pulses, 4.6 h of
# a 0.253 s pulsar): the golden's sample count, its channel lines 65,536
# subints long, so the channel scaler takes the cluster kernel.
SINGLE_PULSE_SHAPE = (65536, 128, 64)


def build_single_pulse(out_dir):
    """The single-pulse archive (``SINGLE_PULSE_SHAPE``, seed 17, the
    golden's RFI density rules, float64, dispersed), its cube saved to
    ``out_dir`` as a ``.npy`` (run on a worker process); returns the
    path and the other fields."""
    import dataclasses as dc

    from iterative_cleaner_torch.io.synthetic import (
        bench_rfi_density,
        make_synthetic_archive,
    )

    nsub, nchan, nbin = SINGLE_PULSE_SHAPE
    ar, _ = make_synthetic_archive(nsub=nsub, nchan=nchan, nbin=nbin,
                                   **bench_rfi_density(nsub, nchan),
                                   n_prezapped=2000, seed=17,
                                   dtype=np.float64, disperse=True)
    path = os.path.join(out_dir, "single_pulse.npy")
    np.save(path, ar.data)
    return path, {f.name: getattr(ar, f.name) for f in dc.fields(ar)
                  if f.name != "data"}


def gloo_batch_rank(seeds):
    """One of the GLOO_RANKS ranks of batch (e), started by
    ``run_local_ranks`` with gloo on cuda:0: the batch of the small
    archives of ``seeds`` over the ('batch',) mesh (each rank its share of
    the padded batch).  Returns its counts, peak memory, clean ms and
    (rank 0) the results."""
    import torch

    from iterative_cleaner_torch import CleanConfig
    from iterative_cleaner_torch.parallel.batch import clean_archives_batched
    from iterative_cleaner_torch.parallel.mesh import batch_mesh
    from iterative_cleaner_torch.stats import kernels as K

    ars = [batch_small_archive(s) for s in seeds]
    mesh = batch_mesh()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    results = clean_archives_batched(ars, CleanConfig(device="cuda:0"), mesh)
    torch.cuda.synchronize()
    return {"rank": mesh.rank, "share": mesh.share(len(ars)),
            "counts": K.launch_counts(),
            "clean_ms": (time.perf_counter() - t0) * 1e3,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "results": results}


def batch_vs_single(label, got, want, tag):
    """Hold each archive of a batch to its single clean bit for bit:
    weights, scores, telemetry rows, loops, convergence and per-loop
    diffs.  Returns the cells and rows that differ in bits."""
    import torch

    bad, n_bits = [], 0
    for i, (g, w) in enumerate(zip(got, want)):
        n = sum(bits_mismatch(torch.from_numpy(np.ascontiguousarray(a)),
                              torch.from_numpy(np.ascontiguousarray(b)),
                              torch)
                for a, b in ((g.final_weights, w.final_weights),
                             (g.scores, w.scores),
                             (g.iter_metrics, w.iter_metrics)))
        n_bits += n
        if n or (g.loops, g.converged) != (w.loops, w.converged) \
                or not np.array_equal(g.loop_diffs, w.loop_diffs):
            bad.append(i)
    print(f"{label} against the single cleans: {len(got)} archives, loops "
          f"{sorted({g.loops for g in got})}, archives differing "
          f"{sorted(bad)}, cells and telemetry values differing in bits "
          f"{n_bits} (weights, scores, telemetry, loops, diffs; tolerance: "
          f"bit-equal) {tag}", flush=True)
    if bad:
        fail(f"{label}: archives {sorted(bad)} differ from their single "
             f"cleans")
    return n_bits


BATCH_TRACE_NAMES = ("icln_marginals_kernel", "icln_sum_parts",
                     "icln_cell_stats_kernel", "icln_scaled_sides_kernel",
                     "icln_combine_zap_kernel", "icln_mm_")
BATCH_TRACE_WANT = {"icln_marginals_kernel": 1, "icln_sum_parts": 2,
                    "icln_cell_stats_kernel": 1,
                    "icln_scaled_sides_kernel": 2,
                    "icln_combine_zap_kernel": 1}


def batch_trace_worker(seeds):
    """Batch (a)'s trace, in a process of its own (``batch_trace_phase``):
    the batch of the small archives of ``seeds`` prepared on the card, then
    up to TRACE_ATTEMPTS times one batch iteration on the default route
    (``iteration_step`` over the whole batch) through ``device_ops``, the
    launch counters set to 0 before each.  Returns each attempt's device
    operations by name and launch counts; stops at the first trace in
    which each of BATCH_TRACE_NAMES shows as ``batch_trace_ok`` wants."""
    import torch

    from iterative_cleaner_torch import CleanConfig
    from iterative_cleaner_torch.engine.loop import iteration_step
    from iterative_cleaner_torch.profile_iteration import device_ops
    from iterative_cleaner_torch.stats import kernels as K

    K.load_library()
    cfg = CleanConfig()
    prep, w, m = batch_prep([batch_small_archive(s) for s in seeds], cfg,
                            torch.device("cuda"))
    attempts = []
    for _ in range(TRACE_ATTEMPTS):
        torch.cuda.synchronize()
        K.reset_launch_counts()
        ops = device_ops(lambda: iteration_step(
            prep, w, w, m, chanthresh=cfg.chanthresh,
            subintthresh=cfg.subintthresh, rotation=cfg.rotation,
            baseline_duty=cfg.baseline_duty))
        torch.cuda.synchronize()
        attempts.append((ops, K.launch_counts()))
        if batch_trace_ok(ops)[0]:
            break
    return attempts


def batch_trace_ok(ops):
    """Whether a trace's device operations ``ops`` show each of the port's
    kernels of the default route once (K1's two partial sums twice, K3
    twice, K9 1 to 4 passes), and those counts by kernel name."""
    by_kernel = {n: sum(v for k, v in ops.items() if n in k)
                 for n in BATCH_TRACE_NAMES}
    k9_ops = by_kernel.pop("icln_mm_")
    return (by_kernel == BATCH_TRACE_WANT and 1 <= k9_ops <= 4,
            by_kernel, k9_ops)


def batch_trace_phase(tag):
    """Batch (a)'s launches in a trace: the device operations of one batch
    iteration of the BATCH_SEEDS small archives in a torch.profiler trace,
    each of the port's kernels of the route counted by its kernel name:
    once for the whole batch.

    It runs on a spawned process of its own, where the trace is the
    process's first: a trace taken after other torch.profiler traces in
    one process can come back short of device records.  The launch
    counters, read over the same calls, must show each of the route's
    wrappers once a call; they decide the launches.  A trace that
    disagrees with them is the profiler's loss or surplus of records, not
    a launch: it is printed in full and taken again, up to TRACE_ATTEMPTS
    times, and the phase fails unless one trace shows each kernel once."""
    import multiprocessing

    from iterative_cleaner_torch.engine.loop import ROUTE_KERNELS

    with ProcessPoolExecutor(
            max_workers=1,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        attempts = pool.submit(batch_trace_worker, list(BATCH_SEEDS)).result()
    # device_ops calls the step twice: once untraced, once traced
    want_counts = None
    for attempt, (ops, counted) in enumerate(attempts, 1):
        if want_counts is None:
            want_counts = {k: 2 if k in ROUTE_KERNELS["default"] else 0
                           for k in counted}
        ok, by_kernel, k9_ops = batch_trace_ok(ops)
        print(f"batch (a): one batch iteration's device operations in a "
              f"torch.profiler trace (attempt {attempt}, on a process of its "
              f"own): the port's kernels {json.dumps(by_kernel)} and K9's "
              f"{k9_ops} (want {json.dumps(BATCH_TRACE_WANT)}, K9 1 to 4: "
              f"each once for the {len(BATCH_SEEDS)} archives); "
              f"{sum(ops.values())} device operations in all; launch "
              f"counters over the untraced and the traced call "
              f"{json.dumps(counted)} (want each of the route's 2) {tag}",
              flush=True)
        if counted != want_counts:
            fail("batch (a): a kernel launched other than once per batch "
                 "iteration (launch counters)")
        if ok:
            return
        print("batch (a): the trace disagrees with the launch counters; "
              "its port kernels: " + json.dumps(
                  {k: v for k, v in ops.items() if "icln" in k}), flush=True)
    fail(f"batch (a): no one of {len(attempts)} torch.profiler traces "
         f"showed each kernel once per batch iteration")


def stack_inputs(ars, dev):
    """The stacked float32 upload of ``ars`` on ``dev``
    (``stack_archive_batch``), and its weights and mask."""
    from iterative_cleaner_torch.parallel.batch import stack_archive_batch

    ins, _ = stack_archive_batch(ars, 0, dev)
    return ins, ins[1], ins[1] == 0


def batch_prep(ars, cfg, dev):
    """:func:`prepare_batch` of ``ars`` under ``cfg`` on ``dev``."""
    from iterative_cleaner_torch.engine.loop import prepare_batch

    ins, weights, mask = stack_inputs(ars, dev)
    return prepare_batch(*ins, cfg, dedispersed=False), weights, mask


def stream_counts(route_kernels, names, loops, n_tiles) -> dict:
    """The launch counts of an exact stream (a rank's, over a mesh) of
    ``loops`` iterations in ``n_tiles`` tiles: the route's template and
    cell-diagnostics kernels once a tile, its other kernels once an
    iteration, every other kernel of ``names`` never."""
    per_tile = ("weighted_marginals", "cell_diagnostics_disp",
                "cell_diagnostics_two_read", "cell_diagnostics_dedisp")
    return {k: (loops * (n_tiles if k.removesuffix("_bf16").removesuffix(
                    "_f64") in per_tile else 1)
                if k in route_kernels else 0) for k in names}


def same_archive(a, b) -> list:
    """The fields in which two loads of one file differ (arrays bit for
    bit)."""
    diff = [k for k in ("data", "weights", "freqs_mhz")
            if not np.array_equal(getattr(a, k), getattr(b, k))]
    return diff + [k for k in ("period_s", "dm", "centre_freq_mhz", "source",
                               "mjd_start", "mjd_end", "pol_state",
                               "dedispersed", "psrfits_nbits")
                   if getattr(a, k) != getattr(b, k)]


def cli_phase(ar, whole, want_counts, tag):
    """The CLI session on the archive written as PSRFITS (nbits 32: its
    float32 cube is the in-memory archive's cast), in a temporary
    directory removed afterwards.  First loads the file once through the
    native reader and once through the pure-Python one and holds the
    two bit for bit.  Holds the session's output mask to the in-process
    clean ``whole`` (bit for bit) and the golden, the run report's
    iteration history to ``whole.iter_metrics`` (exactly), the
    Prometheus file to its parser, the event log's sequence, the launch
    counts to ``want_counts``, and its load to the native reader.  Then
    phase 3h (:func:`prefetch_phase`) in the same directory.  Returns
    the phases' times."""
    import torch

    from iterative_cleaner_torch import cli
    from iterative_cleaner_torch.io import load_archive, native
    from iterative_cleaner_torch.io.psrfits import (
        _load_psrfits_native,
        load_psrfits,
        save_psrfits,
    )
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
        t0 = time.perf_counter()
        nat = _load_psrfits_native(path)
        native_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        pure = load_psrfits(path, prefer_native=False)
        pure_s = time.perf_counter() - t0
        differ = ["native reader declined"] if nat is None \
            else same_archive(nat, pure)
        print(f"cli: golden.sf loaded by the native reader in {native_s:.3f} "
              f"s, by the pure-Python reader in {pure_s:.3f} s; fields that "
              f"differ (arrays bit for bit): {differ} {tag}", flush=True)
        if differ:
            fail(f"cli: the native and pure-Python loads differ in {differ}")
        nat = pure = None
        os.chdir(work)
        torch.cuda.synchronize()
        K.reset_launch_counts()
        native.reset_load_counts()
        t0 = time.perf_counter()
        rc = cli.main(["--metrics-json", "run.json", "--prom-textfile",
                       "run.prom", "--log-format", "json", "--timing",
                       "golden.sf"])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        counts = K.launch_counts()
        loads = native.load_counts()
        if rc != 0:
            fail(f"cli: exit code {rc}")
        if counts != want_counts:
            fail(f"cli: launch counts {counts}, want {want_counts}")
        if loads != {"psrfits": 1, "icar": 0}:
            fail(f"cli: native loads {loads}, want one PSRFITS load")
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
              f"{len(prom)}; events {seq}; native loads {loads} {tag}",
              flush=True)
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
        times = {"psrfits_gb": size_gb, "write_in_s": write_in_s,
                 "native_load_s": native_s, "pure_load_s": pure_s,
                 "cli_s": cli_s, **{f"{k}_s": v for k, v in phases.items()}}
        times.update(prefetch_phase(ar, whole, want_counts, tag))
        # 3n. --checkpoint and its resume, tools borderline and --trace on
        # the same golden.sf
        times.update(checkpoint_phase(ar, whole, want_counts, tag))
        times.update(borderline_phase(whole, tag))
        times.update(trace_phase(work, want_counts, tag))
        # the serve daemon on the same golden.sf
        times.update(serve_phases(work, ar, whole, want_counts, tag))
        return times
    finally:
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)


# ---- the serve phases (serve/, --serve): s1-s4 -------------------------
# (s1) SERVE_SMALL_N PSRFITS files of BATCH_SHAPE dropped in the spool as
# one request, beside golden.sf through /submit and a baseline_mode
# override; (s2) the golden's first SERVE_STREAM_NSUB subints as one
# stream request; (s3) a SERVE_PROFILE_S capture during (s1)'s spool
# request; (s4) the spool request again under --result-cache, then a
# request of SERVE_KILL_N small archives (two shapes) wedged by a load
# hang, its daemon killed with SIGKILL and restarted on the same journal
SERVE_SMALL_N = 8
# the kernels line's rows that get a "serve" entry (K1, K2, K3, K7, K9,
# K6, the combine)
SERVE_KERNELS = ("weighted_marginals", "cell_diagnostics_disp",
                 "scaled_sides_axis0", "scaled_sides_axis1",
                 "cell_diagnostics_two_read", "masked_median",
                 "cell_diagnostics_dedisp", "combine_zap")
SERVE_STREAM_NSUB = 32
SERVE_PROFILE_S = 1.0
SERVE_KILL_N = 4
SERVE_TIMEOUT_S = 300
# each counter of the default route and the kernel symbol it launches
SERVE_TRACE_NAMES = {"weighted_marginals": "icln_marginals_kernel",
                     "cell_diagnostics_disp": "icln_cell_stats_kernel",
                     "scaled_sides_axis0": "icln_scaled_sides_kernel",
                     "scaled_sides_axis1": "icln_scaled_sides_kernel",
                     "combine_zap": "icln_combine_zap_kernel",
                     "masked_median": "icln_mm_"}


class ServeDaemonProc:
    """One ``python -m iterative_cleaner_torch --serve`` process in ``d``
    (journal, spool and span export there, the result cache on, the
    default flight recorder), its HTTP port read from its first lines by
    :meth:`ready` (the caller works meanwhile: a start takes seconds)."""

    def __init__(self, d, extra=(), **env):
        e = dict(os.environ, **env)
        e["PYTHONPATH"] = os.pathsep.join(
            [HERE] + ([e["PYTHONPATH"]] if e.get("PYTHONPATH") else []))
        n = len([f for f in os.listdir(d) if f.startswith("daemon.")])
        self.out_path = os.path.join(d, f"daemon.{n}.out")
        self.t0 = time.perf_counter()
        with open(self.out_path, "w") as out:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "iterative_cleaner_torch", "--serve",
                 "--http-port", "0", "--spool", "spool", "--journal",
                 "serve.journal.jsonl", "--trace-out", "serve.trace.json",
                 "--result-cache", *extra],
                cwd=d, env=e, stdout=out, stderr=subprocess.STDOUT)
        # a phase that fails leaves no daemon running
        atexit.register(self.stop)

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=SERVE_TIMEOUT_S)

    def ready(self):
        """Wait for the port; returns the seconds since the spawn."""
        needle = "serve: http listening on 127.0.0.1:"
        deadline = time.time() + SERVE_TIMEOUT_S
        while time.time() < deadline:
            for line in open(self.out_path).read().splitlines():
                if line.startswith(needle):
                    self.url = "http://127.0.0.1:" + line[len(needle):]
                    return time.perf_counter() - self.t0
            if self.proc.poll() is not None:
                break
            time.sleep(0.05)
        self.proc.kill()
        fail(f"serve: the daemon never listened:\n{self.tail()}")

    def tail(self, n=3000):
        return open(self.out_path).read()[-n:]

    def get(self, path):
        import urllib.request

        with urllib.request.urlopen(self.url + path,
                                    timeout=SERVE_TIMEOUT_S) as r:
            return r.read()

    def post(self, path, doc):
        import urllib.request

        req = urllib.request.Request(self.url + path,
                                     data=json.dumps(doc).encode())
        with urllib.request.urlopen(req, timeout=SERVE_TIMEOUT_S) as r:
            return json.loads(r.read())

    def launches(self):
        return json.loads(self.get("/debug/vars"))["kernel_launches"]

    def wait(self, rid):
        import urllib.error

        deadline = time.time() + SERVE_TIMEOUT_S
        while time.time() < deadline:
            try:
                state = json.loads(self.get("/requests/" + rid))
            except urllib.error.HTTPError as exc:
                if exc.code != 404:      # 404: not admitted yet (spool)
                    raise
                state = {"state": None}
            if state["state"] in ("done", "failed"):
                return state
            if self.proc.poll() is not None:
                break
            time.sleep(0.02)
        fail(f"serve: request {rid} never finished:\n{self.tail()}")

    def drain(self):
        self.proc.send_signal(__import__("signal").SIGTERM)
        rc = self.proc.wait(timeout=SERVE_TIMEOUT_S)
        return rc, time.perf_counter() - self.t0


def launch_delta(after, before):
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v - before.get(k, 0)}


def serve_request(daemon, rid, doc, spool=None):
    """One request through ``/submit`` (or dropped in ``spool``), waited
    for: ``(state, launches it caused, client seconds)``."""
    before = daemon.launches()
    t0 = time.perf_counter()
    if spool is None:
        daemon.post("/submit", dict(doc, id=rid))
    else:
        tmp = os.path.join(spool, f".{rid}.tmp")
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, os.path.join(spool, rid + ".json"))
    state = daemon.wait(rid)
    seconds = time.perf_counter() - t0
    if state["state"] != "done":
        fail(f"serve: request {rid} failed: {state}\n{daemon.tail()}")
    return state, launch_delta(daemon.launches(), before), seconds


def weights_off(path, want) -> int:
    """Cells of the output beside ``path`` whose weight is not ``want``'s
    (the in-process clean's final weights, cast as the output stores
    them), bit for bit."""
    from iterative_cleaner_torch.io import load_archive

    got = load_archive(path).weights
    return int(np.sum(got != np.asarray(want).astype(got.dtype)))


def serve_capture_ok(cap_dir, kind):
    """A published profile capture: its trace's kernel families (by the
    default route's counters) and whether its manifest names ``kind``."""
    from iterative_cleaner_torch.utils.tracing import trace_event_counts

    with open(os.path.join(cap_dir, "profile_manifest.json")) as f:
        manifest = json.load(f)
    kernels = trace_event_counts(os.path.join(cap_dir, "trace.json"),
                                 "kernel")
    fams = {c: sum(v for k, v in kernels.items() if sym in k)
            for c, sym in SERVE_TRACE_NAMES.items()}
    return fams, manifest["device_kind"] == kind


def serve_phases(work, ar, whole, want_counts, tag):
    """The serve phases in ``work`` (``golden.sf`` there), each daemon a
    spawned ``--serve`` process on the card (journal, span export, profile
    directory, result cache; the default flight recorder): (s1) golden.sf
    through ``/submit``, SERVE_SMALL_N PSRFITS files of BATCH_SHAPE as one
    spool request and a ``baseline_mode="profile"`` override, each output
    bit-equal to the in-process ``clean_archive`` on the card, the golden
    under the goldens' flip rule, each request's kernels those of its
    fleet batches once per batch iteration; (s2) the golden's first
    SERVE_STREAM_NSUB subints as one stream request over ``POST
    /stream/<id>/subint``, its close bit-equal to ``clean_archive`` of the
    prefix; (s3) ``POST /profile`` during the spool request: the capture
    published whole, its manifest naming the card, its trace holding each
    kernel the counters counted (retried under TRACE_ATTEMPTS), the
    ``prof_*`` gauges in (0, 1.05]; (s4) the spool request again,
    answered from the result cache with no launch; SIGTERM drains (exit
    0), the journal holds each request done once and the span export
    each archive request's request, execute, load and write spans under
    its trace id; then a request of small archives in two shapes wedged
    by a load hang, its daemon killed with SIGKILL after the first bucket
    journaled and restarted on the same journal: each archive journaled
    done once, the outputs (s1)'s and the in-process cleans'.  Returns
    the phases' seconds and the kernels' launches in (s1) and (s2)."""
    import threading

    import torch

    from iterative_cleaner_torch import CleanConfig
    from iterative_cleaner_torch.backends import clean_archive
    from iterative_cleaner_torch.engine.loop import ROUTE_KERNELS
    from iterative_cleaner_torch.io import load_archive, save_archive
    from iterative_cleaner_torch.online import StreamMeta
    from iterative_cleaner_torch.online.chunks import assemble_archive
    from iterative_cleaner_torch.online.session import percentile_ms
    from iterative_cleaner_torch.resilience import FleetJournal
    from iterative_cleaner_torch.telemetry import parse_prometheus_text
    from iterative_cleaner_torch.utils.tracing import trace_event_counts

    t_all = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    d = os.path.join(work, "serve")
    os.makedirs(os.path.join(d, "spool"))
    # the daemon starts while the inputs and the in-process references
    # below are made
    daemon = ServeDaemonProc(d, ["--profile-dir", "prof"])
    golden = os.path.join(d, "golden.sf")
    os.symlink(os.path.join(work, "golden.sf"), golden)
    small = []
    for i in range(SERVE_SMALL_N):
        small.append(os.path.join(d, f"small{i}.sf"))
        save_archive(batch_small_archive(400 + i), small[-1])
    prof_path = os.path.join(d, "profile.sf")
    save_archive(batch_small_archive(400), prof_path)
    prof_cfg = CleanConfig(baseline_mode="profile")
    want = {p: clean_archive(load_archive(p), CleanConfig()) for p in small}
    want[prof_path] = clean_archive(load_archive(prof_path), prof_cfg)
    small_loops = max(want[p].loops for p in small)
    # (s2)'s chunks and the prefix's clean
    meta = StreamMeta.from_archive(ar)
    cube = np.ascontiguousarray(ar.total_intensity()[:SERVE_STREAM_NSUB])
    sdir = os.path.join(d, "stream")
    os.makedirs(sdir)
    chunks = []
    for i in range(SERVE_STREAM_NSUB):
        chunks.append(os.path.join(sdir, "%06d.npy" % i))
        np.save(chunks[-1], cube[i])
    prefix = clean_archive(assemble_archive(
        meta, cube, np.ones((SERVE_STREAM_NSUB, meta.nchan))), CleanConfig())
    # (s4)'s request: SERVE_KILL_N links to (s1)'s small archives and as
    # many of another shape (a second bucket)
    kdir = os.path.join(d, "kill")
    links = linked(small[:SERVE_KILL_N], kdir)
    other = []
    for i in range(SERVE_KILL_N):
        other.append(os.path.join(kdir, f"other{i}.sf"))
        save_archive(batch_small_archive(500 + i, (64, 120, 512)),
                     other[-1])
    want_other = {p: clean_archive(load_archive(p), CleanConfig())
                  for p in other}
    kill_paths = links + other

    serve_launches = {}
    times = {}
    start_s = daemon.ready()
    # (s1) golden.sf through /submit
    st, golden_k, golden_s = serve_request(daemon, "golden",
                                           {"paths": [golden]})
    n_golden = weights_off(golden + "_cleaned.sf", whole.final_weights)
    golden_check("serve (s1)", dataclasses.replace(
        whole, final_weights=load_archive(golden + "_cleaned.sf").weights),
        "", whole.final_weights.shape)
    want_golden = {k: whole.loops for k in ROUTE_KERNELS["default"]}
    # (s1) + (s3): the spool request with a capture running over it
    spool = os.path.join(d, "spool")
    caps, cap_ok, small_k, small_s = [], False, None, None
    for attempt in range(TRACE_ATTEMPTS):
        links = small
        rid = "small" if attempt == 0 else f"small-retry{attempt}"
        if attempt:
            links = linked(small, os.path.join(d, rid))
        got = {}
        cap = threading.Thread(target=lambda: got.setdefault(
            "r", daemon.post(f"/profile?seconds={SERVE_PROFILE_S}", {})))
        cap.start()
        time.sleep(0.1)
        st, k, s = serve_request(daemon, rid, {"paths": links}, spool=spool)
        cap.join(SERVE_TIMEOUT_S)
        if attempt == 0:
            small_k, small_s = k, s
        cap_dir = got["r"]["profile_dir"]
        fams, names_card = serve_capture_ok(cap_dir, kind)
        whole_dir = sorted(os.listdir(cap_dir)) == ["profile_manifest.json",
                                                    "trace.json"]
        missing = [c for c, v in k.items()
                   if c in SERVE_TRACE_NAMES and not fams[c]]
        caps.append({"attempt": attempt + 1, "kernels": fams,
                     "missing": missing, "manifest_names_card": names_card,
                     "whole": whole_dir})
        if whole_dir and names_card and not missing \
                and set(k) <= set(SERVE_TRACE_NAMES):
            cap_ok = True
            break
    want_small = {k: small_loops for k in ROUTE_KERNELS["default"]}
    n_small = sum(weights_off(p + "_cleaned.sf", want[p].final_weights)
                  for p in small)
    # (s1) the profile-baseline override
    st, prof_k, prof_s = serve_request(
        daemon, "profile", {"paths": [prof_path],
                            "overrides": {"baseline_mode": "profile"}})
    n_prof = weights_off(prof_path + "_cleaned.sf",
                         want[prof_path].final_weights)
    want_prof = {k: want[prof_path].loops for k in ROUTE_KERNELS["two_read"]}
    metrics = parse_prometheus_text(daemon.get("/metrics").decode())
    prof_gauges = {k: v for k, v in metrics.items()
                   if k.startswith(("icln_prof_hbm_util",
                                    "icln_prof_roofline_frac"))}
    gauges_ok = (len(prof_gauges) >= 4
                 and all(0 < v <= 1.05 for v in prof_gauges.values())
                 and metrics.get("icln_prof_peak_nominal") == 0.0)
    print(f"serve (s1): daemon listening {start_s:.1f} s after its spawn (the "
          f"inputs and the in-process references made meanwhile); golden.sf "
          f"through /submit {golden_s:.2f} s, kernels "
          f"{json.dumps(golden_k)} (want {json.dumps(want_golden)}), output "
          f"weights against the in-process clean: {n_golden} cells differ "
          f"(tolerance 0); {SERVE_SMALL_N} x {BATCH_SHAPE} from the spool "
          f"{small_s:.2f} s, kernels {json.dumps(small_k)} (want "
          f"{json.dumps(want_small)}: one batch), {n_small} cells differ; "
          f"baseline_mode=profile override {prof_s:.2f} s, kernels "
          f"{json.dumps(prof_k)} (want {json.dumps(want_prof)}), {n_prof} "
          f"cells differ {tag}", flush=True)
    print(f"serve (s3): POST /profile?seconds={SERVE_PROFILE_S} during the "
          f"spool request: {json.dumps(caps)}; prof gauges "
          f"{json.dumps(prof_gauges)}, nominal peaks "
          f"{metrics.get('icln_prof_peak_nominal')} {tag}", flush=True)
    if len(caps) > 1:
        print(f"serve (s3): {len(caps) - 1} retries (fault (c): a trace "
              f"short of what the counters say)", flush=True)
    if n_golden or n_small or n_prof or golden_k != want_golden \
            or small_k != want_small or prof_k != want_prof:
        fail("serve (s1): an output or a request's launches differ")
    if not cap_ok or not gauges_ok:
        fail("serve (s3): the capture or the prof gauges are off")
    # (s2) the golden's first subints as one stream request
    before = daemon.launches()
    daemon.post("/submit", {"id": "live", "kind": "stream",
                            "meta": meta.to_dict()})
    lat = []
    for i, c in enumerate(chunks):
        t0 = time.perf_counter()
        if not daemon.post("/stream/live/subint",
                           {"path": c, "seq": i}).get("ingested"):
            fail(f"serve (s2): subint {i} not ingested")
        lat.append(time.perf_counter() - t0)
    dup = daemon.post("/stream/live/subint", {"path": chunks[0], "seq": 0})
    t0 = time.perf_counter()
    daemon.post("/stream/live/close", {})
    live = daemon.wait("live")
    close_s = time.perf_counter() - t0
    stream_k = launch_delta(daemon.launches(), before)
    n_live = weights_off(live["out"], prefix.final_weights)
    print(f"serve (s2): stream of {SERVE_STREAM_NSUB} subints of "
          f"{meta.nchan} x {meta.nbin}: per-subint POST latency p50 "
          f"{percentile_ms(lat, 50):.3f} ms, p99 {percentile_ms(lat, 99):.3f}"
          f" ms (the daemon's p99 {live.get('subint_p99_ms')} ms), close and "
          f"write {close_s:.2f} s, {live.get('reconciles')} reconciles, "
          f"{live.get('recompiles_steady')} steady builds; a repeated seq "
          f"answered duplicate: {bool(dup.get('duplicate'))}; kernels "
          f"{json.dumps(stream_k)}; the close against clean_archive of the "
          f"prefix: {n_live} cells differ (tolerance 0) {tag}", flush=True)
    if n_live or not dup.get("duplicate") or live.get("recompiles_steady") \
            or stream_k.get("cell_diagnostics_dedisp", 0) < SERVE_STREAM_NSUB:
        fail("serve (s2): the stream's close or its launches are off")
    for part in (golden_k, small_k, prof_k, stream_k):
        for k, v in part.items():
            serve_launches[k] = serve_launches.get(k, 0) + v
    # (s4) the spool request again: the result cache, no launch
    st, cached_k, cached_s = serve_request(daemon, "small-again",
                                           {"paths": small})
    # (s4)'s first daemon on the same journal starts while this one
    # drains (every request above is journaled done).  io-workers 1: the
    # first bucket's loads, then the second's, the first of which hangs;
    # the first bucket cleans and journals
    t_kill = time.perf_counter()
    victim = ServeDaemonProc(d, ["--faults",
                                 f"load:hang@{SERVE_KILL_N + 1}",
                                 "--io-workers", "1"],
                             ICLEAN_FAULT_HANG_S="600")
    rc, session_s = daemon.drain()
    jpath = os.path.join(d, "serve.journal.jsonl")
    lines = [json.loads(ln) for ln in open(jpath) if ln.strip()]
    done_lines = {}
    for ln in lines:
        if ln.get("event") == "req" and ln.get("state") == "done":
            done_lines[ln["req"]] = done_lines.get(ln["req"], 0) + 1
    states = FleetJournal(jpath).request_states()
    with open(os.path.join(d, "serve.trace.json")) as f:
        spans = [e for e in json.load(f)["traceEvents"] if e["ph"] == "X"]
    span_ok = {}
    for rid in ("golden", "small", "profile"):
        names = {e["name"] for e in spans
                 if e["args"].get("trace_id") == states[rid]["trace_id"]}
        span_ok[rid] = {"request", "execute", "load", "write"} <= names
    print(f"serve (s4): the spool request again under --result-cache "
          f"{cached_s:.3f} s, {st.get('n_cached')} cached, kernels "
          f"{json.dumps(cached_k)} (want none); SIGTERM: exit {rc}, the "
          f"daemon's session {session_s:.1f} s; done lines per request "
          f"{json.dumps(done_lines, sort_keys=True)}; request, execute, load "
          f"and write spans under each trace id {json.dumps(span_ok)} {tag}",
          flush=True)
    if cached_k or st.get("n_cached") != SERVE_SMALL_N or rc != 0 \
            or any(v != 1 for v in done_lines.values()) \
            or not all(span_ok.values()):
        fail("serve (s4): the cache, the drain, the journal or the spans "
             "are off")
    # (s4) kill -9 mid-request and a restart on the same journal
    def done_in_kill():
        out = []
        for ln in open(jpath):
            try:
                e = json.loads(ln)
            except ValueError:
                continue
            if e.get("event") == "done" and \
                    os.path.dirname(e.get("path", "")) == kdir:
                out.append(e["path"])
        return out

    daemon = victim
    daemon.ready()
    daemon.post("/submit", {"id": "kill", "paths": kill_paths})
    deadline = time.time() + SERVE_TIMEOUT_S
    while len(done_in_kill()) < SERVE_KILL_N:
        if time.time() > deadline or daemon.proc.poll() is not None:
            daemon.proc.kill()
            fail(f"serve (s4): no bucket journaled before the kill:\n"
                 f"{daemon.tail()}")
        time.sleep(0.05)
    daemon.proc.kill()
    daemon.proc.wait(timeout=SERVE_TIMEOUT_S)
    before_restart = len(done_in_kill())
    daemon = ServeDaemonProc(d)
    daemon.ready()
    kstate = daemon.wait("kill")
    rc2, _ = daemon.drain()
    kill_s = time.perf_counter() - t_kill
    done = done_in_kill()
    n_kill = sum(weights_off(p + "_cleaned.sf",
                             load_archive(s + "_cleaned.sf").weights)
                 for p, s in zip(links, small))
    n_kill += sum(weights_off(p + "_cleaned.sf", want_other[p].final_weights)
                  for p in other)
    recovered = "serve: recovered 1 journaled request" in daemon.tail(20000)
    print(f"serve (s4): kill -9 after {before_restart} of "
          f"{len(kill_paths)} archives journaled, restart on the same "
          f"journal: recovered {recovered}, request {kstate['state']} "
          f"({kstate.get('n_skipped')} resumed, {kstate.get('n_cleaned')} "
          f"cleaned), done lines {len(done)} for {len(set(done))} archives, "
          f"outputs against (s1)'s and the in-process cleans: {n_kill} cells "
          f"differ (tolerance 0); SIGTERM exit {rc2}; {kill_s:.1f} s {tag}",
          flush=True)
    if kstate["state"] != "done" or len(done) != len(kill_paths) \
            or len(set(done)) != len(kill_paths) or n_kill or rc2 != 0 \
            or not recovered or kstate.get("n_skipped") != before_restart:
        fail("serve (s4): the restart cleaned an archive twice or differs")
    keep_journal(jpath, "serve.journal.jsonl")
    times.update(serve_golden_s=golden_s, serve_small_s=small_s,
                 serve_profile_s=prof_s, serve_session_s=session_s,
                 serve_stream_p50_ms=percentile_ms(lat, 50),
                 serve_stream_p99_ms=percentile_ms(lat, 99),
                 serve_kill_s=kill_s, serve_launches=serve_launches)
    print(f"serve phases: {time.perf_counter() - t_all:.1f} s in all {tag}",
          flush=True)
    shutil.rmtree(d, ignore_errors=True)
    return times


def prefetch_phase(ar, whole, want_counts, tag):
    """Phase 3h, in the working directory of phase 3e (``golden.sf`` is
    there): the archive written as ``golden.icar``, then one CLI session
    over ``golden.icar`` and ``golden.sf`` with ``--prefetch 1``, so
    golden.sf loads on the loader's thread while golden.icar cleans.
    Holds both output masks to ``whole`` bit for bit, the ``.icar``
    output's cube to its input's bit for bit, the launch counts to twice
    ``want_counts`` and the loads to the native readers.  Prints each
    archive's load seconds: the second is the wait for the prefetched
    load.  Returns the times."""
    import torch

    from iterative_cleaner_torch import cli
    from iterative_cleaner_torch.io import load_archive, native
    from iterative_cleaner_torch.stats import kernels as K
    from iterative_cleaner_torch.telemetry.events import read_events

    t0 = time.perf_counter()
    native.save_icar(ar, "golden.icar")
    icar_write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    native.load_icar("golden.icar")
    icar_load_s = time.perf_counter() - t0
    icar_gb = os.path.getsize("golden.icar") / 1e9
    torch.cuda.synchronize()
    K.reset_launch_counts()
    native.reset_load_counts()
    t0 = time.perf_counter()
    rc = cli.main(["--prefetch", "1", "--timing", "--metrics-json",
                   "run2.json", "--event-log", "run2.events.jsonl",
                   "golden.icar", "golden.sf"])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    counts = K.launch_counts()
    loads = native.load_counts()
    if rc != 0:
        fail(f"prefetch: exit code {rc}")
    want = {k: 2 * v for k, v in want_counts.items()}
    if counts != want:
        fail(f"prefetch: launch counts {counts}, want {want}")
    if loads != {"psrfits": 1, "icar": 1}:
        fail(f"prefetch: native loads {loads}, want one of each")
    load_s = [e["seconds"] for e in read_events("run2.events.jsonl")
              if e["event"] == "phase" and e["phase"] == "load"]
    with open("run2.json") as f:
        phases = json.load(f)["phases_s"]
    n_mask = {}
    for name in ("golden.icar_cleaned.icar", "golden.sf_cleaned.sf"):
        w = load_archive(name).weights
        n_mask[name] = -1 if w.shape != whole.final_weights.shape else int(
            ((w == 0) != (whole.final_weights == 0)).sum())
    header = native._HEADER.size + ar.nchan * 8 + ar.nsub * ar.nchan * 4
    cubes = [np.memmap(name, dtype="<f4", mode="r", offset=header,
                       shape=ar.data.shape)
             for name in ("golden.icar", "golden.icar_cleaned.icar")]
    cube_equal = bool(np.array_equal(cubes[0], cubes[1]))
    cubes = None
    print(f"prefetch: golden.icar ({icar_gb:.2f} GB) written by save_icar in "
          f"{icar_write_s:.3f} s, loaded by load_icar in {icar_load_s:.3f} s; "
          f"cli.main --prefetch 1 over golden.icar and golden.sf in "
          f"{cli_s:.1f} s: load {load_s[0]:.3f} s (golden.icar) and "
          f"{load_s[1]:.3f} s (golden.sf, the wait for its prefetched load), "
          f"clean {phases['clean']:.1f} s, write {phases['write']:.1f} s; "
          f"kernels {json.dumps(counts)}; native loads {loads}; output masks "
          f"against the in-process clean: {n_mask} cells differ (tolerance "
          f"0); .icar output cube bit-equal to its input's: {cube_equal} "
          f"{tag}", flush=True)
    if any(n_mask.values()) or not cube_equal or len(load_s) != 2:
        fail("prefetch: an output differs from the in-process clean or "
             "its input")
    return {"icar_gb": icar_gb, "icar_write_s": icar_write_s,
            "icar_load_s": icar_load_s, "prefetch_cli_s": cli_s,
            "prefetch_load_s": load_s}


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
    on ``ar`` (``cube32`` its float32 total intensity, or its float64 one
    for the float64 builds' inputs, every tensor then float64): the
    prepared cubes, templates, rotated template rows and Nyquist rows that
    K1, K2, K6 and K7 take on the card."""
    import torch

    from iterative_cleaner_torch.engine.loop import (
        build_template,
        nyq_correction_row,
        prepare,
    )
    from iterative_cleaner_torch.ops.dsp import rotate_bins

    f32 = torch.float64 if cube32.dtype == np.float64 else torch.float32
    nchan, nbin = cube32.shape[1:]
    weights = torch.from_numpy(
        np.ascontiguousarray(ar.weights, dtype=cube32.dtype)).to(dev)
    meta = [torch.from_numpy(np.ascontiguousarray(ar.freqs_mhz,
                                                  dtype=cube32.dtype)).to(dev)]
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


def check_k1(disp, weights, what, rtol=K1_RTOL):
    """K1 against its plain version, within ``rtol`` of sum|w*disp| (a
    batch's cube and weights too)."""
    from iterative_cleaner_torch.stats import kernels as K

    a, t1 = K.weighted_marginals(disp, weights)
    pa, pt1 = K.weighted_marginals_plain(disp, weights)
    sa, st1 = K.weighted_marginals_plain(disp.abs(), weights.abs())
    err = max(float((a - pa).abs().max()), float((t1 - pt1).abs().max()))
    ok = bool(((a - pa).abs() <= rtol * sa).all()
              and ((t1 - pt1).abs() <= rtol * st1).all())
    print(f"check K1 weighted_marginals{what}: max abs {err:.3e}, tolerance "
          f"{rtol:g} * sum|w*disp|: {'ok' if ok else 'FAIL'}", flush=True)
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


def check_diags(diag_calls, mask, what, rtol=K2_RTOL):
    """Each cell-diagnostics kernel against its plain version (``rtol``
    of each plane's scale, masked cells exact).  Returns the errors, the
    verdicts and K2's planes."""
    import torch

    diag_err, diag_ok, diags = {}, {}, None
    for name, pairs in diag_calls.items():
        diag_err[name], diag_ok[name] = 0.0, True
        for n, (kfn, pfn) in enumerate(pairs):
            got = kfn()
            err, ok = diags_check(got, pfn(), mask, torch, rtol)
            diag_err[name] = max(diag_err[name], err)
            diag_ok[name] &= ok
            if name == "cell_diagnostics_disp":
                diags = got
            window = " (pulse window)" if n else ""
            print(f"check {name}{window}{what}: max abs {err:.3e}, tolerance "
                  f"rtol {rtol:g} of each plane's scale, masked cells "
                  f"exact: {'ok' if ok else 'FAIL'}", flush=True)
    return diag_err, diag_ok, diags


def batch_diags_check(got, want, mask):
    """:func:`diags_check` archive by archive of a batch's planes."""
    import torch

    err, ok = 0.0, True
    for b in range(mask.shape[0]):
        e, o = diags_check([g[b] for g in got], [w[b] for w in want],
                           mask[b], torch)
        err, ok = max(err, e), ok and o
    return err, ok


def batch_kernels(prep, weights, mask, cfg, label, times, tag, reps=5):
    """The batched kernels of ``prep``'s route on its first iteration's
    inputs: each against its plain version (K1 K1_RTOL, the cell kernels
    K2_RTOL archive by archive, K3 both axes, the combine and K9 on the
    batch's lines bit-equal), and each timed batched against B times its
    launch on archive 0 alone, beside the batch's bound.  Records into
    ``times[name][label]``; returns whether every check held."""
    import torch

    from iterative_cleaner_torch.engine.loop import (
        _dispersed_rows,
        build_template,
    )
    from iterative_cleaner_torch.stats import kernels as K

    nb, nsub, nchan = weights.shape
    template = build_template(prep, weights, rotation=cfg.rotation,
                              baseline_duty=cfg.baseline_duty)
    ok_all = True
    calls = {}
    if prep.route == "dedispersed":
        args = (prep.ded, template, prep.window, weights, mask)
        calls["cell_diagnostics_dedisp"] = (
            K.cell_diagnostics_dedisp, K.cell_diagnostics_dedisp_plain,
            args, lambda a: (a[0][0], a[1][0], a[2], a[3][0], a[4][0]))
    else:
        rot_t, nyq = _dispersed_rows(prep, template, cfg.rotation)
        if prep.route == "two_read":
            args = (prep.ded, prep.disp_base, rot_t, template, weights, mask)
            calls["cell_diagnostics_two_read"] = (
                K.cell_diagnostics_two_read,
                K.cell_diagnostics_two_read_plain, args,
                lambda a: tuple(x[0] for x in a))
        else:
            err, ok = check_k1(prep.disp_base, weights, f" ({label})")
            ok_all &= ok
            calls["weighted_marginals"] = (
                K.weighted_marginals, None, (prep.disp_base, weights),
                lambda a: tuple(x[0] for x in a))
            args = (prep.disp_base, rot_t, nyq, template, weights, mask)
            calls["cell_diagnostics_disp"] = (
                K.cell_diagnostics_disp, K.cell_diagnostics_disp_plain,
                args, lambda a: tuple(None if x is None else x[0]
                                      for x in a))
    diags = None
    for name, (kfn, pfn, args, first) in calls.items():
        if pfn is not None:
            diags = kfn(*args)
            err, ok = batch_diags_check(diags, pfn(*args), mask)
            ok_all &= ok
            print(f"check {name} ({label}, {nb} archives in one launch): max "
                  f"abs {err:.3e}, tolerance rtol {K2_RTOL:g} of each "
                  f"archive's plane scale, masked cells exact: "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
        one = first(args)
        times.setdefault(name, {})[label] = (
            cuda_ms(lambda: kfn(*args), reps, torch),
            nb * cuda_ms(lambda: kfn(*one), reps, torch))
    cases = {"scaled_sides_axis0": (0, cfg.chanthresh),
             "scaled_sides_axis1": (1, cfg.subintthresh)}
    sides = {}
    for name, (axis, thresh) in cases.items():
        sides[axis] = got = K.scaled_sides(diags, mask, axis, thresh)
        bad = sum(bits_mismatch(g, w, torch) for g, w in zip(
            got, K.scaled_sides_plain(diags, mask, axis, thresh)))
        ok_all &= bad == 0
        print(f"check K3 {name} ({label}, {nb} archives in one launch): "
              f"{bad} cells differ in bits (tolerance: bit-equal): "
              f"{'ok' if bad == 0 else 'FAIL'}", flush=True)
        one = [d[0] for d in diags]
        times.setdefault(name, {})[label] = (
            cuda_ms(lambda: K.scaled_sides(diags, mask, axis, thresh), reps,
                    torch),
            nb * cuda_ms(lambda: K.scaled_sides(one, mask[0], axis, thresh),
                         reps, torch))
    new_w, scores = K.combine_zap(sides[0], sides[1], weights)
    pw, ps = K.combine_zap_plain(sides[0], sides[1], weights)
    bad = bits_mismatch(scores, ps, torch) + bits_mismatch(new_w, pw, torch)
    lines = (diags[0].reshape(nb, -1), mask.reshape(nb, -1))
    bad9 = bits_mismatch(K.masked_median(*lines, 1),
                         K.masked_median_keys(*lines, 1)[0], torch)
    ok_all &= bad == 0 and bad9 == 0
    print(f"check combine_zap and K9 on the {nb} archives' lines ({label}): "
          f"{bad} and {bad9} cells differ in bits (tolerance: bit-equal): "
          f"{'ok' if bad == 0 and bad9 == 0 else 'FAIL'}", flush=True)
    times.setdefault("combine_zap", {})[label] = (
        cuda_ms(lambda: K.combine_zap(sides[0], sides[1], weights), reps,
                torch),
        nb * cuda_ms(lambda: K.combine_zap([p[0] for p in sides[0]],
                                           [p[0] for p in sides[1]],
                                           weights[0]), reps, torch))
    one_line = (diags[0][0].reshape(1, -1), mask[0].reshape(1, -1))
    times.setdefault("masked_median", {})[label] = (
        cuda_ms(lambda: K.masked_median(*lines, 1), reps, torch),
        nb * cuda_ms(lambda: K.masked_median(*one_line, 1), reps, torch))
    for name in [*calls, *cases, "combine_zap", "masked_median"]:
        ms, singles = times[name][label]
        print(f"time {name} batched ({label}): {ms:.4f} ms in one launch "
              f"against {nb} x its launch on one archive {singles:.4f} ms "
              f"{tag}", flush=True)
    return ok_all


def template_stage_ops(ars, dev, tag):
    """The template stage of a batch of ``ars`` against each archive's
    own (one archive's preamble and weights, as a clean of it alone runs
    it), op by op on identical inputs: the values differing in bits in
    the template, the dispersed-frame rows and ``tt_info`` (each must be
    0: the stage's products and sums run at one archive's shapes); and
    the default route's stage time for the batch against its B archives
    one after the other.  Returns ``{op: cells}`` and ``{form: ms}``."""
    import torch

    from iterative_cleaner_torch import CleanConfig
    from iterative_cleaner_torch.engine.loop import (
        Prepared,
        _dispersed_rows,
        build_template,
    )
    from iterative_cleaner_torch.stats import kernels as K

    diff, ms = {}, {}

    def archive_of(prep, b):
        """Archive ``b`` of a batch's prepared cubes (views)."""
        return Prepared(prep.route, *(None if t is None else t[b]
                                      for t in prep[1:6]), prep.window)

    def count(op, batched, one):
        n = sum(bits_mismatch(batched[b].reshape(-1), one(b).reshape(-1),
                              torch) for b in range(len(ars)))
        diff[op] = diff.get(op, 0) + n

    def stage(prep, w, rot, duty):
        t = build_template(prep, w, rotation=rot, baseline_duty=duty)
        return t, *_dispersed_rows(prep, t, rot), K.tt_info(t)

    for cfg in (CleanConfig(), CleanConfig(baseline_mode="profile")):
        prep, w, _ = batch_prep(ars, cfg, dev)
        singles = [archive_of(prep, b) for b in range(len(ars))]
        rot, duty = cfg.rotation, cfg.baseline_duty
        template = build_template(prep, w, rotation=rot, baseline_duty=duty)
        count(f"build_template ({prep.route} route)", template,
              lambda b: build_template(singles[b], w[b], rotation=rot,
                                       baseline_duty=duty))
        count("_dispersed_rows (rotate_bins row matmuls of the template)",
              _dispersed_rows(prep, template, rot)[0],
              lambda b: _dispersed_rows(singles[b], template[b], rot)[0])
        count("tt_info (sum over bins)", K.tt_info(template),
              lambda b: K.tt_info(template[b]))
        if prep.route == "default":
            ms["batch"] = cuda_ms(lambda: stage(prep, w, rot, duty), 10,
                                  torch)
            ms["single archives"] = cuda_ms(lambda: [
                stage(one, w[b], rot, duty)
                for b, one in enumerate(singles)], 10, torch)
        del prep, singles
    print(f"batch (a) template stage, batch of {len(ars)} against each "
          f"archive alone on identical inputs, values differing in bits by "
          f"op: {json.dumps(diff)} (tolerance: 0); the default route's "
          f"template stage (K1, the template, the rows, tt_info) "
          f"{ms['batch']:.3f} ms per batch iteration, "
          f"{ms['single archives']:.3f} ms for its archives one by one "
          f"(CUDA events) {tag}", flush=True)
    if any(diff.values()):
        fail("batch (a): the template stage differs from the single "
             "archives'")
    return diff, ms


def batch_phases(ar0, whole, counts, clean_ms, peak_gib, dev, tag,
                 fullsize):
    """Batch phases (a)-(c): see the module docstring.  ``ar0`` is the
    seed-0 full-size archive and ``whole`` its single default clean,
    ``fullsize`` the worker futures of the other full-size archives.
    Returns the batched kernels' times (``{name: {label: (batched ms, B x
    single ms)}}``), the batches' shapes and the small archives."""
    import torch

    from iterative_cleaner_torch import CleanConfig
    from iterative_cleaner_torch.archive import Archive
    from iterative_cleaner_torch.backends import clean_archive
    from iterative_cleaner_torch.engine.loop import (
        ROUTE_KERNELS,
        iteration_step,
        select_route,
    )
    from iterative_cleaner_torch.io.synthetic import FULLSIZE_SHAPE
    from iterative_cleaner_torch.parallel.batch import clean_archives_batched
    from iterative_cleaner_torch.stats import kernels as K

    times, ok = {}, True

    def counted(key, fn):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        clean_ms[key] = (time.perf_counter() - t0) * 1e3
        counts[key] = K.launch_counts()
        peak_gib[key] = torch.cuda.max_memory_allocated() / 2 ** 30
        return out

    # (a) and (b): BATCH_SEEDS small archives on every route
    t0 = time.perf_counter()
    ars = [batch_small_archive(s) for s in BATCH_SEEDS]
    nb = len(ars)
    print(f"batch: {nb} archives of {BATCH_SHAPE} made in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, kw in BATCH_ROUTES.items():
        cfg = CleanConfig(**kw)
        run = "a" if name == "default" else "b"
        key = "batch" if name == "default" else f"batch ({name})"
        got = counted(key, lambda: clean_archives_batched(ars, cfg))
        torch.cuda.empty_cache()   # the singles start as cold as the batch
        t0 = time.perf_counter()
        want = [clean_archive(a, cfg) for a in ars]
        torch.cuda.synchronize()
        single_ms = (time.perf_counter() - t0) * 1e3
        route = select_route(cfg, False)
        iters = max(g.loops for g in got)
        want_counts = {k: (iters if k in ROUTE_KERNELS[route] else 0)
                       for k in counts[key]}
        common = dict(chanthresh=cfg.chanthresh,
                      subintthresh=cfg.subintthresh, rotation=cfg.rotation,
                      baseline_duty=cfg.baseline_duty)
        prep, w, m = batch_prep(ars, cfg, dev)
        iter_ms = cuda_ms(lambda: iteration_step(prep, w, w, m, **common), 5,
                          torch)
        print(f"batch ({run}) {name}, route {route}: {nb} archives of "
              f"{BATCH_SHAPE}, kernels {json.dumps(counts[key])} (want each "
              f"of the route's once per batch iteration, {iters}), loops "
              f"{[g.loops for g in got]}; whole batch clean "
              f"{clean_ms[key]:.1f} ms against {single_ms:.1f} ms for the "
              f"{nb} single cleans (host clock); {iter_ms:.3f} ms per batch "
              f"iteration (CUDA events); peak device memory "
              f"{peak_gib[key]:.2f} GiB {tag}", flush=True)
        if counts[key] != want_counts:
            fail(f"batch ({run}) {name}: launch counts {counts[key]}, want "
                 f"{want_counts}")
        if run == "a" and len({g.loops for g in got}) < 2:
            fail("batch (a): the archives' loop counts do not differ")
        batch_vs_single(f"batch ({run}) {name}", got, want, tag)
        clean_ms[key + " singles"] = single_ms
        clean_ms[key + " iteration"] = iter_ms
        if run == "a":
            times["template_stage_bits"], stage_ms = template_stage_ops(
                ars, dev, tag)
            clean_ms["batch template stage"] = stage_ms["batch"]
            clean_ms["batch template stage, archives one by one"] = \
                stage_ms["single archives"]
        if name != "pulse":   # its kernels are the profile route's
            ok &= batch_kernels(prep, w, m, cfg, f"{nb} x {BATCH_SHAPE}",
                                times, tag)
        del prep, w, m

    # (c) four full-size archives on the default route
    t0 = time.perf_counter()
    big = [ar0]
    for fut in fullsize:
        path, fields = fut.result()
        big.append(Archive(data=np.load(path), **fields))
        os.remove(path)
    print(f"batch (c): {len(big)} archives of {FULLSIZE_SHAPE} ready in "
          f"{time.perf_counter() - t0:.1f} s more (seeds 1-3 built on "
          f"worker processes meanwhile)", flush=True)
    cfg = CleanConfig()
    got = counted("batch (c)", lambda: clean_archives_batched(big, cfg))
    want = [whole]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    want += [clean_archive(a, cfg) for a in big[1:]]
    torch.cuda.synchronize()
    print(f"batch (c): {len(big)} full-size archives in one batch, kernels "
          f"{json.dumps(counts['batch (c)'])}, loops "
          f"{[g.loops for g in got]}, whole batch clean "
          f"{clean_ms['batch (c)']:.1f} ms against the single cleans' "
          f"{clean_ms['default'] + (time.perf_counter() - t0) * 1e3:.1f} ms "
          f"(host clock); peak device memory {peak_gib['batch (c)']:.2f} GiB "
          f"{tag}", flush=True)
    golden_check("batch (c) seed 0", got[0], "", FULLSIZE_SHAPE[:2])
    batch_vs_single("batch (c)", got, want, tag)
    prep, w, m = batch_prep(big, cfg, dev)
    clean_ms["batch (c) iteration"] = cuda_ms(lambda: iteration_step(
        prep, w, w, m, chanthresh=cfg.chanthresh,
        subintthresh=cfg.subintthresh, rotation=cfg.rotation,
        baseline_duty=cfg.baseline_duty), 3, torch)
    print(f"batch (c): {clean_ms['batch (c) iteration']:.3f} ms per batch "
          f"iteration (CUDA events) {tag}", flush=True)
    ok &= batch_kernels(prep, w, m, cfg, f"{len(big)} x {FULLSIZE_SHAPE}",
                        times, tag, reps=3)
    del prep, w, m, big
    if not ok:
        fail("a batched kernel disagrees with its plain version")
    return times, {f"{nb} x {BATCH_SHAPE}": (nb, BATCH_SHAPE),
                   f"{len(want)} x {FULLSIZE_SHAPE}": (len(want),
                                                       FULLSIZE_SHAPE)}, ars


def batch_cli_phase(tag):
    """Batch (d): ``--batch BATCH_CLI_GROUP --timing --metrics-json`` over
    BATCH_CLI_FILES PSRFITS files of the two BATCH_CLI_SHAPES interleaved,
    against a sequential session over the same files (links to them in a
    directory of each run): the prepass groups the shapes (the report
    lists each shape's archives together), and each output mask and
    report entry equals the sequential session's."""
    from iterative_cleaner_torch.cli import bucket_by_shape
    from iterative_cleaner_torch.cli import main as cli_main
    from iterative_cleaner_torch.io import load_archive, save_archive

    work = tempfile.mkdtemp(prefix="icln_chip_smoke_batch_cli_")
    cwd = os.getcwd()
    try:
        files = []
        for i in range(BATCH_CLI_FILES):
            ar = batch_small_archive(200 + i, BATCH_CLI_SHAPES[i % 2])
            files.append(os.path.join(work, f"obs{i:02d}.sf"))
            save_archive(ar, files[-1])
        runs = {}
        for run, extra in (("sequential", []),
                           ("batch", ["--batch", str(BATCH_CLI_GROUP)])):
            d = os.path.join(work, run)
            os.mkdir(d)
            links = []
            for f in files:
                links.append(os.path.join(d, os.path.basename(f)))
                os.symlink(f, links[-1])
            os.chdir(d)
            t0 = time.perf_counter()
            rc = cli_main(["-q", "--timing", "--metrics-json", "run.json",
                           *extra, *links])
            secs = time.perf_counter() - t0
            os.chdir(cwd)
            if rc != 0:
                fail(f"batch (d): the {run} session exited {rc}")
            with open(os.path.join(d, "run.json")) as fh:
                doc = json.load(fh)
            masks = {os.path.basename(p): load_archive(
                p + "_cleaned.sf").weights == 0 for p in links}
            runs[run] = (links, doc, masks, secs)
        links, doc, masks, secs = runs["batch"]
        want_order = links[0::2] + links[1::2]
        grouped = (bucket_by_shape(links) == want_order
                   and [e["path"] for e in doc["archives"]] == want_order)
        seq = {os.path.basename(e["path"]): e
               for e in runs["sequential"][1]["archives"]}
        n_mask = sum(int((m != runs["sequential"][2][k]).sum())
                     for k, m in masks.items())
        # every field of every report entry equal, the telemetry's
        # residual_std and template_peak too
        n_entry = sum({**e, "path": seq[os.path.basename(e["path"])]["path"]}
                      != seq[os.path.basename(e["path"])]
                      for e in doc["archives"])
        print(f"batch (d): --batch {BATCH_CLI_GROUP} over {len(files)} "
              f"PSRFITS files of {BATCH_CLI_SHAPES} interleaved: prepass "
              f"grouped by shape {grouped}; against the sequential session "
              f"{n_mask} mask cells and {n_entry} report entries differ "
              f"(tolerance: 0 and 0, the telemetry's floats included); "
              f"counters batch_archives "
              f"{doc['counters'].get('batch_archives')}, batch_h2d_bytes "
              f"{doc['counters'].get('batch_h2d_bytes')}; session "
              f"{secs:.2f} s against {runs['sequential'][3]:.2f} s "
              f"sequential (host clock) {tag}", flush=True)
        if not grouped or n_mask or n_entry \
                or doc["counters"].get("batch_archives") != len(files):
            fail("batch (d): the --batch session differs from the "
                 "sequential one")
    finally:
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)


def batch_mesh_phase(ars, counts, tag):
    """Batch (e), with the one-rank NCCL group of phase 3c up: the small
    batch ``ars`` over the ('batch',) mesh of that rank, bit-equal to the plain
    batch; then BATCH_MESH_ARCHIVES of them over GLOO_RANKS gloo rank
    processes sharing the card (padded to a multiple of the ranks),
    mask-equal to the plain batch of the same archives."""
    import torch

    from iterative_cleaner_torch import CleanConfig
    from iterative_cleaner_torch.parallel import distributed
    from iterative_cleaner_torch.parallel.batch import clean_archives_batched
    from iterative_cleaner_torch.parallel.mesh import batch_mesh
    from iterative_cleaner_torch.stats import kernels as K

    plain = clean_archives_batched(ars, CleanConfig())
    K.reset_launch_counts()
    got = clean_archives_batched(ars, CleanConfig(), batch_mesh())
    counts["batch mesh 1"] = K.launch_counts()
    n_bits = sum(bits_mismatch(torch.from_numpy(g.final_weights),
                               torch.from_numpy(w.final_weights), torch)
                 + bits_mismatch(torch.from_numpy(g.scores),
                                 torch.from_numpy(w.scores), torch)
                 + int(not np.array_equal(g.iter_metrics, w.iter_metrics))
                 + int((g.loops, g.converged) != (w.loops, w.converged))
                 for g, w in zip(got, plain))
    print(f"batch (e) --mesh batch on one NCCL rank, {len(ars)} archives: "
          f"kernels {json.dumps(counts['batch mesh 1'])}; against the plain "
          f"batch {n_bits} cells or rows differ in bits (weights, scores, "
          f"telemetry, loops; tolerance: bit-equal) {tag}", flush=True)
    if n_bits:
        fail("batch (e): the one-rank batch mesh differs from the plain "
             "batch")
    seeds = list(BATCH_SEEDS)[:BATCH_MESH_ARCHIVES]
    plain = clean_archives_batched(ars[:BATCH_MESH_ARCHIVES], CleanConfig())
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="icln_chip_smoke_ranks_") as wd:
        try:
            ranks = distributed.run_local_ranks(
                gloo_batch_rank, GLOO_RANKS, (seeds,), workdir=wd,
                device="cuda:0", backend="gloo", timeout_s=GLOO_TIMEOUT_S)
        except (RuntimeError, TimeoutError) as exc:
            fail(f"batch (e) gloo: {exc}")
    for rk in ranks:
        print(f"batch (e) gloo rank {rk['rank']}: share (pad, start, stop) "
              f"{rk['share']}, kernels {json.dumps(rk['counts'])}, clean "
              f"{rk['clean_ms']:.1f} ms, peak device memory "
              f"{rk['peak_gib']:.2f} GiB {tag}", flush=True)
    got = ranks[0]["results"]
    n_mask = sum(int(((g.final_weights == 0) != (w.final_weights == 0)).sum())
                 + int(g.loops != w.loops) for g, w in zip(got, plain))
    print(f"batch (e) --mesh batch on {GLOO_RANKS} gloo ranks: "
          f"{len(seeds)} archives padded to "
          f"{len(seeds) + ranks[0]['share'][0]}, {len(got)} results on rank "
          f"0 in {time.perf_counter() - t0:.1f} s; against the plain batch "
          f"{n_mask} mask cells or loop counts differ (tolerance: 0) {tag}",
          flush=True)
    if len(got) != len(seeds) or n_mask or any(
            rk["results"] is not None for rk in ranks[1:]):
        fail("batch (e): the gloo batch mesh differs from the plain batch")


# The bf16 storage mode's phases (compute_dtype="bfloat16"): the
# archive of phase 2 made bf16-exact as the reference's tests make it
# (samples on the bf16 grid, DM 0, the baseline window exactly 0), cleaned
# with the roll rotation, whose masks must equal the float32 cleans'.
BF16_EXACT_SEED = 0
BF16 = "bfloat16"
# The golden archive cleaned in bf16 storage is held to the goldens' flip
# rule with this cap: every flip a cell the float64 oracle scored within
# FLIP_NOISE_ENV of the threshold, the oracle's loops, at most this many
# flips.  bf16 rounds every prepared sample to 2**-9 relative, coarser
# than the float32 runs MAX_BORDERLINE_FLIPS was set for: the card flipped
# 11 of the golden's 53 cells within the band (measured on one H100;
# float32: 2), and the cap is three times that, as CONTRACT_LIMITS are.
BF16_MAX_BORDERLINE_FLIPS = 33


def bf16_phases(ar, results, counts, clean_ms, peak_gib, stream_regs, mesh1,
                batch_ars, dev, tag):
    """The bf16 phases, each counted like the float32 ones and printing
    its ms per iteration, peak memory and the compute_dtype_ineligible
    counters (which must stay empty): (1) the golden archive under
    compute_dtype='bfloat16' on the default route, held to the golden's
    band with BF16_MAX_BORDERLINE_FLIPS;
    (2) a full-size bf16-exact archive on the default, profile and
    dedispersed routes, bf16 masks bit-equal to float32 (ms per iteration
    of both on its resident cubes); (3) stream (a) in bf16: the cube
    bytes uploaded exactly half of stream (a)'s a loop, its peak at most
    half the whole bf16 clean's, its mask held to the whole bf16 clean of
    the same quantized input (the stream rounds the raw tiles to bf16
    before the preamble, as the reference's stream does, where the whole
    clean rounds the prepared cube: at the golden's baseline of 100 counts
    a raw sample keeps 2**-9 of 100, the noise's 0.14 sigma, so the
    golden, made from unrounded samples, is another input's; its flips
    are printed, not held); (4) batch
    (a) in bf16, bit-equal to its single bf16 cleans; (5) the one-rank
    NCCL sharded clean in bf16 on the default and dedispersed routes,
    bit-equal to the whole bf16 cleans."""
    import torch

    from iterative_cleaner_torch import CleanConfig, clean_streaming
    from iterative_cleaner_torch.backends import (
        clean_archive,
        clean_archive_sharded,
    )
    from iterative_cleaner_torch.backends import torch_backend as tb
    from iterative_cleaner_torch.engine.loop import (
        ROUTE_KERNELS,
        SHARD_KERNELS,
        STREAM_KERNELS,
        iteration_step,
        prepare,
        prepare_batch,
        select_route,
        storage_kernels,
        store_prepared,
    )
    from iterative_cleaner_torch.io.synthetic import make_bf16_exact_archive
    from iterative_cleaner_torch.parallel.batch import clean_archives_batched
    from iterative_cleaner_torch.parallel.tile_cache import DictRegistry
    from iterative_cleaner_torch.profile_iteration import stream_line
    from iterative_cleaner_torch.stats import kernels as K

    nsub, nchan, nbin = ar.nsub, ar.nchan, ar.nbin
    # the parity probe runs once per process, before any counted run
    t0 = time.perf_counter()
    if tb.resolve_compute_dtype(BF16, device=dev) != BF16:
        fail("bf16: the parity probe failed on the card")
    print(f"bf16: the parity probe (4 x 8 x 32, every route, float32 "
          f"against bf16 storage) passed in "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms", flush=True)

    def ineligible(label):
        got = tb.compute_dtype_ineligible_counts()
        print(f"{label}: compute_dtype_ineligible counters "
              f"{json.dumps(got)} (must be empty)", flush=True)
        if got:
            fail(f"{label}: a stage was downgraded to float32")

    def counted(key, fn):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        clean_ms[key] = (time.perf_counter() - t0) * 1e3
        counts[key] = K.launch_counts()
        peak_gib[key] = torch.cuda.max_memory_allocated() / 2 ** 30
        return out

    def want_counts(kernels, loops, names):
        return {k: (loops if k in kernels else 0) for k in names}

    def iteration_ms(archive, cfg, compute_dtype, mesh=None):
        """CUDA-event ms of one iteration on ``archive``'s resident cubes
        prepared under ``cfg`` and stored at ``compute_dtype``."""
        cube = torch.from_numpy(np.ascontiguousarray(
            archive.total_intensity(), dtype=np.float32)).to(dev)
        w = torch.from_numpy(np.ascontiguousarray(
            archive.weights, dtype=np.float32)).to(dev)
        meta = [torch.from_numpy(np.ascontiguousarray(
            archive.freqs_mhz, dtype=np.float32)).to(dev)] + [
            torch.tensor(v, dtype=torch.float32, device=dev)
            for v in (archive.dm, archive.centre_freq_mhz, archive.period_s)]
        prep = store_prepared(prepare(cube, w, *meta, cfg,
                                      dedispersed=archive.dedispersed),
                              compute_dtype)
        del cube
        return cuda_ms(lambda: iteration_step(
            prep, w, w, w == 0, chanthresh=cfg.chanthresh,
            subintthresh=cfg.subintthresh, rotation=cfg.rotation,
            baseline_duty=cfg.baseline_duty, mesh=mesh), 5, torch)

    # (1) the golden archive, default route, bf16
    cfg16 = CleanConfig(compute_dtype=BF16)
    key = "bf16 default"
    r16 = results[key] = counted(key, lambda: clean_archive(ar, cfg16))
    want = want_counts(storage_kernels(ROUTE_KERNELS["default"], BF16),
                       r16.loops, counts[key])
    it16 = iteration_ms(ar, cfg16, BF16)
    it32 = iteration_ms(ar, CleanConfig(), "float32")
    flips = int(((r16.final_weights == 0)
                 != (results["default"].final_weights == 0)).sum())
    print(f"bf16 (1) golden archive, default route: kernels "
          f"{json.dumps(counts[key])}, {r16.loops} loops, whole clean "
          f"{clean_ms[key]:.1f} ms (float32 {clean_ms['default']:.1f}), "
          f"{it16:.3f} ms per iteration (float32 {it32:.3f}, same call; "
          f"CUDA events, resident cubes), peak device memory "
          f"{peak_gib[key]:.2f} GiB (float32 {peak_gib['default']:.2f}); "
          f"{flips} mask cells differ from the float32 clean {tag}",
          flush=True)
    if counts[key] != want:
        fail(f"{key}: launch counts {counts[key]}, want {want}")
    golden_check("bf16 (1) default", r16, "", (nsub, nchan),
                 cap=BF16_MAX_BORDERLINE_FLIPS)
    ineligible("bf16 (1)")
    clean_ms["bf16 default iteration"] = it16
    clean_ms["default iteration (bf16 call)"] = it32

    # (2) a full-size bf16-exact archive on three routes, bf16 = float32
    t0 = time.perf_counter()
    ex = make_bf16_exact_archive(nsub, nchan, nbin, seed=BF16_EXACT_SEED)
    print(f"bf16 (2): the bf16-exact {nsub}x{nchan}x{nbin} archive made in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    routes = {"default": {}, "profile": dict(baseline_mode="profile"),
              "dedispersed": dict(stats_frame="dedispersed")}
    for name, kw in routes.items():
        got = {}
        for cd in ("float32", BF16):
            cfg = CleanConfig(rotation="roll", compute_dtype=cd, **kw)
            key = f"bf16 exact {name}" + ("" if cd == BF16 else " float32")
            got[cd] = counted(key, lambda: clean_archive(ex, cfg))
            route = select_route(cfg, ex.dedispersed)
            want = want_counts(storage_kernels(ROUTE_KERNELS[route], cd),
                               got[cd].loops, counts[key])
            if counts[key] != want:
                fail(f"{key}: launch counts {counts[key]}, want {want}")
        g16, g32 = got[BF16], got["float32"]
        n_mask = int(((g16.final_weights == 0)
                      != (g32.final_weights == 0)).sum())
        n_bits = bits_mismatch(torch.from_numpy(g16.scores),
                               torch.from_numpy(g32.scores), torch)
        ms = {cd: iteration_ms(ex, CleanConfig(rotation="roll", **kw), cd)
              for cd in ("float32", BF16)}
        key = f"bf16 exact {name}"
        print(f"bf16 (2) exact archive, {name} route: bf16 kernels "
              f"{json.dumps({k: v for k, v in counts[key].items() if v})}, "
              f"loops {g16.loops} (float32 {g32.loops}), zapped "
              f"{int((g16.final_weights == 0).sum())}; against float32 "
              f"{n_mask} mask cells differ (tolerance: 0), {n_bits} scores "
              f"differ in bits; ms per iteration bf16 {ms[BF16]:.3f}, "
              f"float32 {ms['float32']:.3f}; whole clean "
              f"{clean_ms[key]:.1f} ms (float32 "
              f"{clean_ms[key + ' float32']:.1f}), peak device memory "
              f"{peak_gib[key]:.2f} GiB (float32 "
              f"{peak_gib[key + ' float32']:.2f}) {tag}", flush=True)
        if n_mask or (g16.loops, g16.converged) != (g32.loops,
                                                    g32.converged):
            fail(f"bf16 (2) {name}: the bf16 mask differs from float32 on a "
                 f"bf16-exact archive")
        clean_ms[f"bf16 exact {name} iteration"] = ms[BF16]
        clean_ms[f"bf16 exact {name} iteration float32"] = ms["float32"]
    del ex
    ineligible("bf16 (2)")

    # (3) stream (a) in bf16
    key, chunk = "bf16 stream (a)", 128
    reg = stream_regs[key] = DictRegistry()
    r = results[key] = counted(key, lambda: clean_streaming(
        ar, chunk, CleanConfig(stream_hbm_mb=0, compute_dtype=BF16),
        registry=reg))
    n_tiles = -(-nsub // chunk)
    want = stream_counts(storage_kernels(STREAM_KERNELS["default"], BF16),
                         counts[key], r.loops, n_tiles)
    cube16 = (1 + 2 * r.loops) * nsub * nchan * nbin * 2
    got16 = reg.counters["stream_h2d_cube_bytes"]
    a32 = stream_regs["a"]
    print(f"bf16 (3) stream (a) bf16, {n_tiles} tiles of {chunk}, budget 0: "
          f"kernels {json.dumps(counts[key])}, {r.loops} loops, whole clean "
          f"{clean_ms[key]:.1f} ms (float32 {clean_ms['stream (a)']:.1f}), "
          f"{reg.gauges['stream_iteration_ms']:.1f} ms per iteration "
          f"(float32 {a32.gauges['stream_iteration_ms']:.1f}; host clock); "
          f"{stream_line(reg.gauges)}; cube bytes uploaded {got16} (want "
          f"{cube16}: half of {2 * cube16}; the float32 stream "
          f"{a32.counters['stream_h2d_cube_bytes']} in "
          f"{results['stream (a)'].loops} loops); peak device memory "
          f"{peak_gib[key]:.2f} GiB (float32 "
          f"{peak_gib['stream (a)']:.2f}) {tag}", flush=True)
    if counts[key] != want:
        fail(f"{key}: launch counts {counts[key]}, want {want}")
    if got16 != cube16:
        fail(f"{key}: the cube bytes uploaded are not half the float32 "
             f"stream's")
    # the whole bf16 clean of the same quantized input: the raw cube
    # rounded to bf16 through float32, as the stream's host store rounds it
    raw16 = torch.from_numpy(np.ascontiguousarray(
        ar.data, dtype=np.float32)).to(torch.bfloat16).double().numpy()
    whole_q = clean_archive(dataclasses.replace(ar, data=raw16), cfg16)
    del raw16
    whole_contract(key, r, whole_q, "bf16 (raw rounded to bf16)")
    print(f"{key}: peak device memory {peak_gib[key]:.2f} GiB against the "
          f"whole bf16 clean's {peak_gib['bf16 default']:.2f} GiB (limit: "
          f"half) {tag}", flush=True)
    if peak_gib[key] > 0.5 * peak_gib["bf16 default"]:
        fail(f"{key}: peak device memory above half the whole bf16 clean's")
    golden, want_zap = golden_mask("", (nsub, nchan))
    flips = np.argwhere(want_zap != (r.final_weights == 0))
    verdict = flip_verdict(flips, golden)
    print(f"{key} against the golden (made from unrounded samples; not "
          f"held): {len(flips)} flips, {len(verdict['rogue'])} outside the "
          f"golden's borderline list, {len(verdict['wide'])} in it but "
          f"beyond {FLIP_NOISE_ENV:g} of the threshold, loops {r.loops} "
          f"(golden {golden['loops']}), zapped "
          f"{int((r.final_weights == 0).sum())} (golden "
          f"{golden['zap_cells']}) {tag}", flush=True)
    ineligible("bf16 (3)")

    # (4) batch (a) in bf16
    key = "bf16 batch (a)"
    got = counted(key, lambda: clean_archives_batched(batch_ars, cfg16))
    singles = [clean_archive(a, cfg16) for a in batch_ars]
    iters = max(g.loops for g in got)
    want = want_counts(storage_kernels(ROUTE_KERNELS["default"], BF16),
                       iters, counts[key])
    cube32s, bw, bm = stack_inputs(batch_ars, dev)
    bprep = prepare_batch(*cube32s, cfg16, dedispersed=False,
                          compute_dtype=BF16)
    del cube32s
    bms = cuda_ms(lambda: iteration_step(
        bprep, bw, bw, bm, chanthresh=cfg16.chanthresh,
        subintthresh=cfg16.subintthresh, rotation=cfg16.rotation,
        baseline_duty=cfg16.baseline_duty), 5, torch)
    del bprep
    print(f"bf16 (4) batch (a) bf16, {len(batch_ars)} archives: kernels "
          f"{json.dumps(counts[key])}, loops {[g.loops for g in got]}, whole "
          f"batch clean {clean_ms[key]:.1f} ms (float32 "
          f"{clean_ms['batch']:.1f}), {bms:.3f} ms per batch iteration "
          f"(float32 {clean_ms['batch iteration']:.3f}), peak device memory "
          f"{peak_gib[key]:.2f} GiB (float32 {peak_gib['batch']:.2f}) {tag}",
          flush=True)
    if counts[key] != want:
        fail(f"{key}: launch counts {counts[key]}, want {want}")
    batch_vs_single(key, got, singles, tag)
    clean_ms["bf16 batch iteration"] = bms
    ineligible("bf16 (4)")

    # (5) the one-rank NCCL sharded clean in bf16
    for name, kw, base in (("default", {}, r16),
                           ("dedispersed", dict(stats_frame="dedispersed"),
                            None)):
        cfg = CleanConfig(compute_dtype=BF16, **kw)
        key = f"bf16 sharded 1 ({name})"
        rs = results[key] = counted(key, lambda: clean_archive_sharded(
            ar, cfg, mesh1))
        if base is None:
            base = clean_archive(ar, cfg)
        route = select_route(cfg, ar.dedispersed)
        want = want_counts(storage_kernels(SHARD_KERNELS[route], BF16),
                           rs.loops, counts[key])
        n_bits = sum(bits_mismatch(torch.from_numpy(a), torch.from_numpy(b),
                                   torch)
                     for a, b in ((rs.final_weights, base.final_weights),
                                  (rs.scores, base.scores)))
        sms = iteration_ms(ar, cfg, BF16, mesh=mesh1)
        print(f"bf16 (5) {key}, route {route}: kernels "
              f"{json.dumps(counts[key])}, {rs.loops} loops, whole clean "
              f"{clean_ms[key]:.1f} ms, {sms:.3f} ms per iteration (device, "
              f"resident shard), peak device memory {peak_gib[key]:.2f} GiB; "
              f"against the whole bf16 clean {n_bits} cells differ in bits "
              f"(weights and scores; tolerance: bit-equal) {tag}",
              flush=True)
        if counts[key] != want:
            fail(f"{key}: launch counts {counts[key]}, want {want}")
        if n_bits or (rs.loops, rs.converged) != (base.loops,
                                                  base.converged) \
                or not np.array_equal(rs.iter_metrics, base.iter_metrics):
            fail(f"{key}: differs from the whole bf16 clean")
        clean_ms[key + " iteration"] = sms
    ineligible("bf16 (5)")


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
    """Phase 3g: K3 and K8 on 50,000-entry lines along both axes (the
    cluster kernel in place of K3), bit-equal to their plain versions; an
    exact stream at budget 0 of a 48,000 x 4 x 32 archive (its channel
    lines 48,000 long) against the whole clean."""
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
        ok &= bad == 0 and bad8 == 0 and used["side_centre"] == 0 \
            and used[f"scaled_sides_cluster_axis{axis}"] == 1 \
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
    if n_mask or r.loops != whole.loops \
            or counts[key]["scaled_sides_cluster_axis0"] < 1 \
            or counts[key]["side_centre"] or counts[key]["scaled_sides_axis0"]:
        fail(f"{key}: mask, loops or launches off")


def past_capacity_phase(dev, counts, tag):
    """Lines past the cluster kernel's capacity (4 columns of 1,000,000
    subints, masked, NaN and +-inf entries, in float32 and float64): K9
    and the tail kernels, bit-equal to the plain version, counted under
    ``counts["past capacity"]``."""
    import torch

    from iterative_cleaner_torch.stats import kernels as K

    key = "past capacity"
    K.reset_launch_counts()
    for dtype in (torch.float32, torch.float64):
        n = 1000000
        g = torch.Generator(device=dev).manual_seed(13)
        shape = (n, 4)
        d = [torch.randn(shape, generator=g, device=dev, dtype=dtype) * s
             for s in (1.0, 0.3, 5.0, 2.0)]
        mask = torch.rand(shape, generator=g, device=dev) < 0.2
        mask[:, 1] = True
        d[0][mask] = 0.0
        d[2][mask] = 1e20
        d[3].view(-1)[[21, 40]] = float("nan")
        d[3].view(-1)[22] = float("inf")
        route = K.scaled_sides_route(n, dtype)
        bad = sum(bits_mismatch(a, b, torch) for a, b in zip(
            K.scaled_sides(d, mask, 0, 5.0),
            K.scaled_sides_plain(d, mask, 0, 5.0)))
        cap = K.scaled_sides_cluster_capacity(K._key_bytes(dtype))
        print(f"check K3's function past the cluster's capacity ({cap} "
              f"entries; {shape} along axis 0, {dtype}): route {route}, "
              f"{bad} cells differ in bits from the plain version "
              f"(tolerance: bit-equal, NaN included) {tag}", flush=True)
        if route != "long" or bad:
            fail(f"past the cluster's capacity ({dtype}): route {route}, "
                 f"{bad} cells off")
    counts[key] = K.launch_counts()
    used = {k: v for k, v in counts[key].items() if v}
    print(f"{key}: launches {json.dumps(used)}", flush=True)
    want = {"side_centre": 4, "side_scale": 4, "masked_median": 8}
    for sfx in ("", "_f64"):
        if any(counts[key][k + sfx] != v for k, v in want.items()) \
                or counts[key]["scaled_sides_cluster_axis0" + sfx]:
            fail(f"{key}: the long route's launches are off: {used}")


# The float64 phases (dtype="float64", the reference's oracle-parity
# mode): the goldens are the float64 oracle's masks, and the reference
# harness holds a float64 run to them with no flip at all.
F64_K1_RTOL = 1e-12   # of sum |w * disp|: float64 sums in another order
F64_PLANE_RTOL = 1e-12   # of each plane's scale (K2, K6, K7): float64
#                          reassociation; masked cells exact
F64_LONG_ARCHIVE = dict(nsub=48000, nchan=4, nbin=32, n_prezapped=50,
                        seed=12)
F64_CLI_ARCHIVE = dict(nsub=64, nchan=128, nbin=128, n_prezapped=20,
                       seed=21)


def single_pulse_phase(sp_fut, dev, counts, clean_ms, peak_gib, tag):
    """Phase 3p: the single-pulse archive (``SINGLE_PULSE_SHAPE``, built on
    a worker process) through ``clean_archive(ar, CleanConfig())``,
    counted (one cluster launch and one K3 axis-1 launch an iteration, K9
    the telemetry's once, no tail launch), its first iteration's four
    planes captured; the cluster kernel on them bit-equal to the plain
    version and to the long-line composition, in float32 and float64; the
    whole clean bit-equal (weights, scores, loops) to the same clean with
    the scaler's cluster lines through ``scaled_sides_long`` (substituted
    in this process only); ms per iteration, the cluster kernel, the old
    composition and the tail kernels at this shape beside their bounds,
    peak memory.  Returns the kernels line's entries of the cluster
    kernel and the tail kernels (their launches: ``counts["past
    capacity"]``)."""
    import torch

    import iterative_cleaner_torch.engine.loop as loop
    from iterative_cleaner_torch import CleanConfig
    from iterative_cleaner_torch.archive import Archive
    from iterative_cleaner_torch.backends import clean_archive
    from iterative_cleaner_torch.stats import kernels as K

    t_phase = time.perf_counter()
    path, fields = sp_fut.result()
    ar = Archive(data=np.load(path), **fields)
    os.remove(path)
    S, C, B = SINGLE_PULSE_SHAPE
    cfg = CleanConfig()
    key = "single pulse"
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    got = clean_archive(ar, cfg)
    torch.cuda.synchronize()
    clean_ms[key] = (time.perf_counter() - t0) * 1e3
    counts[key] = K.launch_counts()
    peak_gib[key] = torch.cuda.max_memory_allocated() / 2 ** 30
    used = {k: v for k, v in counts[key].items() if v}
    want = {k: got.loops for k in (
        "weighted_marginals", "cell_diagnostics_disp",
        "scaled_sides_cluster_axis0", "scaled_sides_axis1", "combine_zap",
        "masked_median")}
    print(f"{key}: {S}x{C}x{B} through clean_archive(ar, CleanConfig()): "
          f"kernels {json.dumps(used)}, {got.loops} loops, whole clean "
          f"{clean_ms[key]:.1f} ms, peak device memory {peak_gib[key]:.2f} "
          f"GiB {tag}", flush=True)
    if used != want:
        fail(f"{key}: launches {used}, want one cluster launch, one K3 "
             f"axis-1 launch and K9 once an iteration: {want}")
    if not np.all(np.isfinite(got.scores[got.final_weights != 0])) \
            or got.final_weights.shape != (S, C):
        fail(f"{key}: scores or weights malformed")

    # the same clean with the scaler's cluster lines through the old
    # composition, its first iteration's four planes captured
    real = loop.scaled_sides
    first = {}

    def via_long(diags, mask, axis, thresh):
        if not first:
            first.update(planes=[d.clone() for d in diags],
                         mask=mask.clone(), thresh=thresh)
        n = mask.shape[-2] if axis == 0 else mask.shape[-1]
        if K.scaled_sides_route(n, diags[0].dtype) == "cluster":
            return K.scaled_sides_long(diags, mask, axis, thresh)
        return real(diags, mask, axis, thresh)

    loop.scaled_sides = via_long
    try:
        K.reset_launch_counts()
        old = clean_archive(ar, cfg)
        torch.cuda.synchronize()
        old_counts = {k: v for k, v in K.launch_counts().items() if v}
    finally:
        loop.scaled_sides = real
    n_bits = sum(bits_mismatch(torch.from_numpy(np.ascontiguousarray(a)),
                               torch.from_numpy(np.ascontiguousarray(b)),
                               torch)
                 for a, b in ((got.final_weights, old.final_weights),
                              (got.scores, old.scores),
                              (got.iter_metrics, old.iter_metrics)))
    print(f"{key}: the clean through scaled_sides_long (launches "
          f"{json.dumps(old_counts)}): {n_bits} weights, scores and "
          f"telemetry values differ in bits (tolerance: bit-equal), loops "
          f"{old.loops} against {got.loops} {tag}", flush=True)
    if n_bits or old.loops != got.loops:
        fail(f"{key}: the cluster kernel's clean differs from the clean "
             f"through scaled_sides_long")
    del old

    # the first iteration's four planes: the cluster kernel against the
    # plain version and the old composition, float32 and float64
    planes, mask, thresh = first["planes"], first["mask"], first["thresh"]
    entries = []
    bound = profiling.kernel_bounds(S, C, B)["scaled_sides_cluster_axis0"]
    bound64 = profiling.kernel_bounds(S, C, B, cube_bytes=8)[
        "scaled_sides_cluster_axis0"]
    for sfx, ps, (bms, bby) in (("", planes, bound),
                                ("_f64", [p.double() for p in planes],
                                 bound64)):
        plan = K.scaled_sides_cluster_geometry(S, 0, 8 if sfx else 4)
        cl = K.scaled_sides_cluster(ps, mask, 0, thresh)
        pl = K.scaled_sides_plain(ps, mask, 0, thresh)
        lo = K.scaled_sides_long(ps, mask, 0, thresh)
        bad_p = sum(bits_mismatch(a, b, torch) for a, b in zip(cl, pl))
        bad_l = sum(bits_mismatch(a, b, torch) for a, b in zip(cl, lo))
        err = max(max_abs_diff(a, b, torch) for a, b in zip(cl, pl))
        print(f"check the cluster kernel{sfx} on the first iteration's four "
              f"planes ({S} x {C} along axis 0, {plan.cluster} blocks a "
              f"line, {plan.lines} lines a cluster, {plan.diags} "
              f"diagnostics at once): {bad_p} cells differ in bits from "
              f"scaled_sides_plain, {bad_l} from scaled_sides_long "
              f"(tolerance: bit-equal, NaN included) {tag}", flush=True)
        if bad_p or bad_l:
            fail(f"{key}: the cluster kernel{sfx} disagrees")
        ms = cuda_ms(lambda: K.scaled_sides_cluster(ps, mask, 0, thresh), 20,
                     torch)
        long_ms = cuda_ms(lambda: K.scaled_sides_long(ps, mask, 0, thresh),
                          5, torch)
        plain_ms = cuda_ms(lambda: K.scaled_sides_plain(ps, mask, 0, thresh),
                           2, torch)
        name = "scaled_sides_cluster_axis0" + sfx
        # the float64 build's launches: the float64 long-lines stream's
        run = "f64 stream (long lines)" if sfx else key
        launches = counts[run][name]
        entries.append({
            "name": name, "route": "cuda",
            "source": "iterative_cleaner_torch/stats/csrc/sides_cluster.cu",
            "replaces": "iterative_cleaner_tpu/stats/pallas_kernels.py:433",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": bby,
            "library_ms": None, "long_composition_ms": long_ms,
            "shape": [S, C], "plan": plan._asdict(),
            "launches_by_route": {r: c[name] for r, c in counts.items()
                                  if c.get(name)}})
        print(f"time {name}: {ms:.4f} ms, bound {bms:.4f} ms ({bby}), plain "
              f"{plain_ms:.4f} ms, the old composition (scaled_sides_long, "
              f"K9 x 8 + side_centre x 4 + side_scale x 4) {long_ms:.4f} ms, "
              f"at {S} x {C} along axis 0; {launches} launches in the "
              f"{run} run {tag}", flush=True)
        # the tail kernels on the first plane at this shape
        d0 = ps[0]
        entries += tail_entries(d0, mask, counts["past capacity"],
                                "past capacity", sfx, tag)
        del cl, pl, lo

    # ms per iteration on the resident cube, the scalers' share
    weights = torch.from_numpy(np.ascontiguousarray(
        ar.weights, dtype=np.float32)).to(dev)
    meta = [torch.from_numpy(np.ascontiguousarray(
        ar.freqs_mhz, dtype=np.float32)).to(dev)]
    meta += [torch.tensor(v, dtype=torch.float32, device=dev)
             for v in (ar.dm, ar.centre_freq_mhz, ar.period_s)]
    cube32 = torch.from_numpy(np.ascontiguousarray(
        ar.total_intensity(), dtype=np.float32)).to(dev)
    dedispersed = ar.dedispersed
    del ar
    prep = loop.prepare(cube32, weights, *meta, cfg, dedispersed=dedispersed)
    del cube32
    common = dict(chanthresh=cfg.chanthresh, subintthresh=cfg.subintthresh,
                  rotation=cfg.rotation, baseline_duty=cfg.baseline_duty)
    wmask = weights == 0
    it_ms = cuda_ms(lambda: loop.iteration_step(prep, weights, weights,
                                                wmask, **common), 5, torch)
    ax1_ms = cuda_ms(lambda: K.scaled_sides(planes, mask, 1,
                                            cfg.subintthresh), 20, torch)
    sides_ms = entries[0]["ms"] + ax1_ms
    print(f"clean {key}: {got.loops} loops, whole clean {clean_ms[key]:.1f} "
          f"ms, {it_ms:.3f} ms per iteration (device, resident cube), the "
          f"scalers {sides_ms:.4f} ms of it ({100 * sides_ms / it_ms:.1f}%: "
          f"cluster axis 0 {entries[0]['ms']:.4f}, K3 axis 1 {ax1_ms:.4f}), "
          f"through the old composition "
          f"{entries[0]['long_composition_ms'] + ax1_ms:.4f} ms; peak device "
          f"memory of the clean {peak_gib[key]:.2f} GiB {tag}", flush=True)
    del prep, planes, mask, first
    torch.cuda.empty_cache()
    print(f"phase 3p, the single-pulse archive: "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return entries


def tail_entries(plane, pmask, launches, route, suffix, tag):
    """The tail kernels (``sides_tail.cu``) on one diagnostic plane along
    axis 0 against their plain versions (bit-equal), timed, as kernels-line
    entries named ``side_centre{suffix}`` and ``side_scale{suffix}``:
    ``launches`` the run ``route``'s counts."""
    import torch

    from iterative_cleaner_torch.stats import kernels as K

    rb = plane.element_size()
    med = K.masked_median(plane, pmask, 0)
    centred, absc, _ = K.side_centre(plane, pmask, med, 0, True)
    mad = K.masked_median(absc, pmask, 0)
    n = plane.numel()
    entries = []
    for name, kfn, pfn, nbytes in (
            ("side_centre",
             lambda: K.side_centre(plane, pmask, med, 0, True),
             lambda: K.side_centre_plain(plane, pmask, med, 0, True),
             (3 * rb + 1) * n),
            ("side_scale",
             lambda: K.side_scale(centred, pmask, mad, None, 0, 5.0, True),
             lambda: K.side_scale_plain(centred, pmask, mad, None, 0, 5.0,
                                        True), (2 * rb + 1) * n)):
        got, want = kfn(), pfn()
        got = got if isinstance(got, torch.Tensor) else got[0]
        want = want if isinstance(want, torch.Tensor) else want[0]
        err = max_abs_diff(got, want, torch)
        bad = bits_mismatch(got, want, torch)
        if bad:
            fail(f"{name}{suffix}: {bad} cells differ from its plain version")
        entries.append({
            "name": name + suffix, "route": "cuda",
            "source": "iterative_cleaner_torch/stats/csrc/sides_tail.cu",
            "replaces": "iterative_cleaner_tpu/stats/pallas_kernels.py:433",
            "launches": launches[name + suffix], "max_abs_err": err,
            "ms": cuda_ms(kfn, 50, torch), "plain_ms": cuda_ms(pfn, 10, torch),
            "bound_ms": profiling.bound_ms(nbytes, 0)[0], "bound_by": "bytes",
            "library_ms": None, "launches_route": route})
        print(f"time {name}{suffix}: {entries[-1]['ms']:.4f} ms, bound "
              f"{entries[-1]['bound_ms']:.4f} ms (bytes), plain "
              f"{entries[-1]['plain_ms']:.4f} ms, {entries[-1]['launches']} "
              f"launches in {route}; bit-equal to its plain version {tag}",
              flush=True)
    return entries


def float64_phases(ar, configs, results, counts, clean_ms, peak_gib,
                   stream_regs, mesh1, dev, tag):
    """The float64 phases, each printing its seconds: (1) the golden
    archive on the default, profile, dedispersed and pulse-window routes
    in float64, counted (every kernel of the route its float64 build,
    nothing else), the default and profile masks held to the goldens with
    0 flips and the golden's loops and convergence, the other two to the
    float64 default mask under the frames' contract; (m1) the golden
    archive through ``clean_archive_sharded`` on the one NCCL rank
    ``mesh1``, default route and dedispersed frame, in float64 (K10's
    float64 build, 64-bit keys in the tree-reduced selects), each
    bit-equal to its whole float64 clean, the default with 0 golden flips,
    every launch a float64 build of the sharded route's kernels; (2) stream
    (a) in float64 at budget 0, held to the whole float64 clean with 0 cells off,
    its cube uploads exactly twice stream (a)'s bytes a loop; (3)
    ``tools selftest`` on the card as a subprocess, and ``--backend
    numpy`` through the CLI on a small archive, equal to the float64 card
    clean's mask; (4) each float64 build against its plain float64 version
    at full size on the routes' first-iteration inputs (K1 within
    F64_K1_RTOL, K2, K6 and K7 within F64_PLANE_RTOL, masked cells exact;
    K3, the combine, K8 and K9 bit-equal), timed beside its bound (bytes
    at 8 a sample, operations at PEAK_F64_PER_S), its plain version and a
    library call, and K10's float64 build on the whole cube and on one
    2 x 2 shard within F64_PLANE_RTOL of its plain version and bit-equal to
    K2's and K6's float64 builds; (5) a 48,000 x 4 x 32 archive streamed
    exactly at budget
    0 in float64 (K9 and the tail kernels' float64 builds in place of K3),
    held to its whole float64 clean.  Returns the float64 builds'
    kernels-line entries."""
    import torch

    from iterative_cleaner_torch import CleanConfig, clean_streaming, cli
    from iterative_cleaner_torch.backends import (
        clean_archive,
        clean_archive_sharded,
    )
    from iterative_cleaner_torch.engine.loop import (
        LONG_LINE_KERNELS,
        ROUTE_KERNELS,
        SHARD_KERNELS,
        STREAM_KERNELS,
        iteration_step,
        select_route,
        storage_kernels,
    )
    from iterative_cleaner_torch.io import load_archive, save_archive
    from iterative_cleaner_torch.io.synthetic import make_synthetic_archive
    from iterative_cleaner_torch.parallel.tile_cache import DictRegistry
    from iterative_cleaner_torch.profile_iteration import stream_line
    from iterative_cleaner_torch.stats import kernels as K

    NSUB, NCHAN, NBIN = ar.nsub, ar.nchan, ar.nbin
    shape = (NSUB, NCHAN)
    f64 = lambda ks: storage_kernels(ks, "float32", "float64")  # noqa: E731

    # ---- (1) the golden archive on every route, counted
    t_phase = time.perf_counter()
    runs = {"default": CleanConfig(dtype="float64"),
            "profile": CleanConfig(dtype="float64", baseline_mode="profile"),
            "dedispersed": CleanConfig(dtype="float64",
                                       stats_frame="dedispersed"),
            "pulse window": CleanConfig(dtype="float64",
                                        pulse_region=(0.2, 30, 60))}
    for name, cfg in runs.items():
        key = f"f64 {name}"
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        results[key] = r = clean_archive(ar, cfg)
        torch.cuda.synchronize()
        clean_ms[key] = (time.perf_counter() - t0) * 1e3
        counts[key] = K.launch_counts()
        peak_gib[key] = torch.cuda.max_memory_allocated() / 2 ** 30
        route = select_route(cfg, ar.dedispersed)
        own = f64(ROUTE_KERNELS[route])
        print(f"float64 route {name} ({route}): kernels "
              f"{json.dumps({k: v for k, v in counts[key].items() if v})}, "
              f"{r.loops} loops, converged {r.converged}, whole clean "
              f"{clean_ms[key]:.1f} ms, peak device memory "
              f"{peak_gib[key]:.2f} GiB {tag}", flush=True)
        missing = [k for k in own if counts[key][k] < 1]
        stray = [k for k, v in counts[key].items() if k not in own and v]
        if missing or stray or counts[key]["masked_median_f64"] != r.loops:
            fail(f"float64 route {name}: float64 builds never launched "
                 f"{missing}, other launches {stray}")
        if r.scores.dtype != np.float64:
            fail(f"float64 route {name}: scores are {r.scores.dtype}")
    base = results["f64 default"]
    golden_check("float64 default", base, "", shape, cap=0)
    golden_check("float64 profile", results["f64 profile"], "_profile",
                 shape, cap=0)
    contract("dedispersed", base, results["f64 dedispersed"])
    contract("pulse_unload", base, results["f64 pulse window"])
    print(f"float64 phase (1), the golden archive on four routes: "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)

    # ---- (m1) the golden archive sharded over the one NCCL rank
    t_phase = time.perf_counter()
    for name in ("default", "dedispersed"):
        key = f"f64 sharded 1 ({name})"
        cfg = runs[name]
        route = select_route(cfg, ar.dedispersed)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        results[key] = r = clean_archive_sharded(ar, cfg, mesh1)
        torch.cuda.synchronize()
        clean_ms[key] = (time.perf_counter() - t0) * 1e3
        counts[key] = K.launch_counts()
        peak_gib[key] = torch.cuda.max_memory_allocated() / 2 ** 30
        want = {k: (r.loops if k in f64(SHARD_KERNELS[route]) else 0)
                for k in counts[key]}
        whole = results[f"f64 {name}"]
        n_bits = sum(bits_mismatch(torch.from_numpy(getattr(r, f)),
                                   torch.from_numpy(getattr(whole, f)), torch)
                     for f in ("final_weights", "scores"))
        print(f"float64 (m1) {key}, one NCCL rank, route {route}: kernels "
              f"{json.dumps({k: v for k, v in counts[key].items() if v})}, "
              f"{r.loops} loops, whole clean {clean_ms[key]:.1f} ms (the "
              f"whole float64 clean {clean_ms[f'f64 {name}']:.1f} ms), peak "
              f"device memory {peak_gib[key]:.2f} GiB; against the whole "
              f"float64 clean {n_bits} weights and scores differ in bits "
              f"(tolerance: bit-equal) {tag}", flush=True)
        if counts[key] != want:
            fail(f"float64 (m1) {key}: launch counts {counts[key]}, want "
                 f"{want}")
        if r.scores.dtype != np.float64 or n_bits \
                or (r.loops, r.converged) != (whole.loops, whole.converged) \
                or not np.array_equal(r.iter_metrics, whole.iter_metrics):
            fail(f"float64 (m1) {key}: differs from the whole float64 clean")
    golden_check("float64 (m1) sharded 1 (default)",
                 results["f64 sharded 1 (default)"], "", shape, cap=0)
    print(f"float64 phase (m1), the golden archive sharded over one NCCL "
          f"rank: {time.perf_counter() - t_phase:.1f} s", flush=True)

    # ---- (2) stream (a) in float64: budget 0, 128-subint tiles
    t_phase = time.perf_counter()
    key = "f64 stream (a)"
    reg = stream_regs[key] = DictRegistry()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    results[key] = r = clean_streaming(
        ar, 128, CleanConfig(dtype="float64", stream_hbm_mb=0), registry=reg)
    torch.cuda.synchronize()
    clean_ms[key] = (time.perf_counter() - t0) * 1e3
    counts[key] = K.launch_counts()
    peak_gib[key] = torch.cuda.max_memory_allocated() / 2 ** 30
    n_tiles = -(-NSUB // 128)
    want = stream_counts(f64(STREAM_KERNELS["default"]), counts[key],
                         r.loops, n_tiles)
    cube_bytes = NSUB * NCHAN * NBIN * 8
    got_cube = reg.counters["stream_h2d_cube_bytes"]
    ra = results["stream (a)"]
    f32_cube = stream_regs["a"].counters["stream_h2d_cube_bytes"]
    per_loop, per_loop32 = got_cube / (1 + 2 * r.loops), \
        f32_cube / (1 + 2 * ra.loops)
    n_off = int(((r.final_weights == 0) != (base.final_weights == 0)).sum())
    print(f"{key}: exact, {n_tiles} tiles of 128, budget 0: kernels "
          f"{json.dumps({k: v for k, v in counts[key].items() if v})}, "
          f"{r.loops} loops, whole clean {clean_ms[key]:.1f} ms; "
          f"{stream_line(reg.gauges)}; H2D {reg.counters['stream_h2d_bytes']} "
          f"bytes, cube {got_cube} (want {(1 + 2 * r.loops) * cube_bytes}), "
          f"{per_loop:.0f} a cube pass against stream (a)'s {per_loop32:.0f} "
          f"(ratio {per_loop / per_loop32:.6f}, want 2); peak device memory "
          f"{peak_gib[key]:.2f} GiB; against the whole float64 clean "
          f"{n_off} cells differ (tolerance 0) {tag}", flush=True)
    if counts[key] != want:
        fail(f"{key}: launch counts {counts[key]}, want {want}")
    if got_cube != (1 + 2 * r.loops) * cube_bytes \
            or got_cube * (1 + 2 * ra.loops) != 2 * f32_cube * (
                1 + 2 * r.loops):
        fail(f"{key}: cube uploads off")
    if n_off or (r.loops, r.converged) != (base.loops, base.converged):
        fail(f"{key}: differs from the whole float64 clean")
    print(f"float64 phase (2), stream (a): "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)

    # ---- (3) tools selftest on the card; --backend numpy through the CLI
    t_phase = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "iterative_cleaner_torch.tools", "selftest"],
        cwd=HERE, capture_output=True, text=True, timeout=600)
    for line in out.stdout.strip().splitlines():
        print(f"selftest: {line}", flush=True)
    if out.returncode != 0:
        fail(f"tools selftest exited {out.returncode}: "
             f"{out.stderr.strip()[-400:]}")
    small, _ = make_synthetic_archive(**F64_CLI_ARCHIVE)
    card_mask = clean_archive(small, CleanConfig(dtype="float64")
                              ).final_weights == 0
    with tempfile.TemporaryDirectory(prefix="icln_chip_smoke_np_") as wd:
        src, dst = os.path.join(wd, "obs.npz"), os.path.join(wd, "np.npz")
        save_archive(small, src)
        t0 = time.perf_counter()
        rc = cli.main(["-q", "-l", "--backend", "numpy", "-o", dst, src])
        np_s = time.perf_counter() - t0
        oracle_mask = load_archive(dst).weights == 0
    n_off = int((oracle_mask != card_mask).sum())
    print(f"--backend numpy through the CLI on "
          f"{tuple(F64_CLI_ARCHIVE[k] for k in ('nsub', 'nchan', 'nbin'))}: "
          f"exit {rc}, {np_s:.1f} s on the host; against the float64 card "
          f"clean {n_off} mask cells differ (tolerance 0), "
          f"{int(card_mask.sum())} zapped {tag}", flush=True)
    if rc != 0 or n_off:
        fail("--backend numpy: the oracle's mask differs from the float64 "
             "card clean's")
    print(f"float64 phase (3), selftest and the oracle: "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)

    # ---- (4) each float64 build against its plain version, timed
    t_phase = time.perf_counter()
    cube64 = np.ascontiguousarray(ar.total_intensity(), dtype=np.float64)
    ri = route_inputs(ar, cube64, configs, dev)
    del cube64
    weights, mask = ri["weights"], ri["mask"]
    disp, template, rot_t, nyq = (ri[k] for k in ("disp", "template",
                                                  "rot_t", "nyq"))
    err1, ok = check_k1(disp, weights, " (float64)", F64_K1_RTOL)
    diag_calls = diag_calls_for(ri)
    diag_err, diag_ok, diags = check_diags(diag_calls, mask, " (float64)",
                                           F64_PLANE_RTOL)
    ok &= all(diag_ok.values())
    sides, errs = {}, {}
    for axis, thresh in ((0, 5.0), (1, 5.0)):
        got = K.scaled_sides(diags, mask, axis, thresh)
        want = K.scaled_sides_plain(diags, mask, axis, thresh)
        bad = sum(bits_mismatch(g, w, torch) for g, w in zip(got, want))
        errs[f"scaled_sides_axis{axis}"] = max(
            max_abs_diff(g, w, torch) for g, w in zip(got, want))
        sides[axis] = got
        ok &= bad == 0
        print(f"check K3 scaled_sides axis {axis} (float64): {bad} cells "
              f"differ in bits (tolerance: bit-equal, NaN included)",
              flush=True)
    new_w, scores = K.combine_zap(sides[0], sides[1], weights)
    pw, ps = K.combine_zap_plain(sides[0], sides[1], weights)
    bad = bits_mismatch(scores, ps, torch) + bits_mismatch(new_w, pw, torch)
    errs["combine_zap"] = max_abs_diff(scores, ps, torch)
    fw, fs = K.fused_combine(diags, mask, weights, 5.0, 5.0)
    pfw, pfs = K.fused_combine_plain(diags, mask, weights, 5.0, 5.0)
    bad8 = bits_mismatch(fs, pfs, torch) + bits_mismatch(fw, pfw, torch)
    errs["fused_combine"] = max_abs_diff(fs, pfs, torch)
    line_v, line_m = diags[0].reshape(1, -1), mask.reshape(1, -1)
    bad9 = 0
    for v, m, dim in ((line_v, line_m, 1), (diags[0], mask, 0),
                      (diags[0], mask, 1)):
        bad9 += bits_mismatch(K.masked_median(v, m, dim),
                              K.masked_median_keys(v, m, dim)[0], torch)
    errs["masked_median"] = 0.0
    print(f"check combine_zap, K8 fused_combine and K9 masked_median "
          f"(float64; K9 on the telemetry line and along both axes): "
          f"{bad}, {bad8} and {bad9} values differ in bits (tolerance: "
          f"bit-equal, NaN included)", flush=True)
    # K10's float64 build on the whole cube (the one-rank mesh's shard)
    # and on one 2 x 2 shard: within F64_PLANE_RTOL of its plain version,
    # bit-equal to K2's and K6's float64 builds on the same cells
    pd = ri["pd"]
    q = (slice(0, NSUB // 2), slice(0, NCHAN // 2))
    k10_in = {
        "shard_diagnostics_disp": {
            "whole cube": (disp, rot_t, nyq, template, weights, mask),
            "2x2 shard": (disp[q].contiguous(), rot_t[q[1]].contiguous(),
                          nyq[q[1]].contiguous(), template,
                          weights[q].contiguous(), mask[q].contiguous())},
        "shard_diagnostics_dedisp": {
            "whole cube": (pd.ded, ri["t_d"], pd.window, weights, mask),
            "2x2 shard": (pd.ded[q].contiguous(), ri["t_d"], pd.window,
                          weights[q].contiguous(), mask[q].contiguous())},
    }
    k10_twin = {
        "shard_diagnostics_disp": (K.cell_diagnostics_disp,
                                   K.cell_diagnostics_disp_plain),
        "shard_diagnostics_dedisp": (K.cell_diagnostics_dedisp,
                                     K.cell_diagnostics_dedisp_plain)}
    for name, ins in k10_in.items():
        twin, plain = k10_twin[name]
        errs[name] = 0.0
        for where, args in ins.items():
            K.reset_launch_counts()
            got = getattr(K, name)(*args)
            launched = K.launch_counts()[name + "_f64"]
            bits = sum(bits_mismatch(g, w, torch)
                       for g, w in zip(got, twin(*args)))
            err, good = diags_check(got, plain(*args), args[-1], torch,
                                    F64_PLANE_RTOL)
            errs[name] = max(errs[name], err)
            good &= bits == 0 and launched == 1 and got[0].dtype == \
                torch.float64
            ok &= good
            print(f"check K10 {name} float64 build ({where}, "
                  f"{tuple(args[0].shape)}): {launched} {name}_f64 launch, "
                  f"{bits} cells differ in bits from {twin.__name__}'s "
                  f"float64 build (tolerance: bit-equal); against the plain "
                  f"version max abs {err:.3e}, tolerance rtol "
                  f"{F64_PLANE_RTOL:g} of each plane's scale, masked cells "
                  f"exact: {'ok' if good else 'FAIL'}", flush=True)
            del got
    if not (ok and bad == 0 and bad8 == 0 and bad9 == 0):
        fail("a float64 build disagrees with its plain version")
    kb = profiling.kernel_bounds(NSUB, NCHAN, NBIN, cube_bytes=8)
    kb["shard_diagnostics_disp"] = kb["cell_diagnostics_disp"]
    kb["shard_diagnostics_dedisp"] = kb["cell_diagnostics_dedisp"]
    kbq = profiling.kernel_bounds(NSUB // 2, NCHAN // 2, NBIN, cube_bytes=8)
    k10_shard_bound = {"shard_diagnostics_disp": kbq["cell_diagnostics_disp"],
                       "shard_diagnostics_dedisp":
                       kbq["cell_diagnostics_dedisp"]}
    pp = ri["p"]
    entries = [
        ("weighted_marginals", "marginals.cu", ":633", "default", err1,
         lambda: K.weighted_marginals(disp, weights),
         lambda: K.weighted_marginals_plain(disp, weights),
         lambda: (torch.einsum("sc,scb->cb", weights, disp),
                  torch.einsum("sc,scb->sb", weights, disp)), 10),
        ("cell_diagnostics_disp", "cell_stats.cu", ":909", "default",
         diag_err["cell_diagnostics_disp"],
         *diag_calls["cell_diagnostics_disp"][0], None, 3),
        ("cell_diagnostics_two_read", "cell_stats.cu", ":852", "profile",
         diag_err["cell_diagnostics_two_read"],
         *diag_calls["cell_diagnostics_two_read"][0], None, 3),
        ("cell_diagnostics_dedisp", "cell_stats.cu", ":934", "dedispersed",
         diag_err["cell_diagnostics_dedisp"],
         *diag_calls["cell_diagnostics_dedisp"][0], None, 3),
        ("scaled_sides_axis0", "scaled_sides.cu", ":281", "default",
         errs["scaled_sides_axis0"],
         lambda: K.scaled_sides(diags, mask, 0, 5.0),
         lambda: K.scaled_sides_plain(diags, mask, 0, 5.0), None, 10),
        ("scaled_sides_axis1", "scaled_sides.cu", ":289", "default",
         errs["scaled_sides_axis1"],
         lambda: K.scaled_sides(diags, mask, 1, 5.0),
         lambda: K.scaled_sides_plain(diags, mask, 1, 5.0), None, 10),
        ("combine_zap", "combine.cu", ":1555", "default", errs["combine_zap"],
         lambda: K.combine_zap(sides[0], sides[1], weights),
         lambda: K.combine_zap_plain(sides[0], sides[1], weights), None, 20),
        ("fused_combine", "scaled_sides.cu", ":1836", "stream (a)",
         errs["fused_combine"],
         lambda: K.fused_combine(diags, mask, weights, 5.0, 5.0),
         lambda: K.fused_combine_plain(diags, mask, weights, 5.0, 5.0), None,
         5),
        ("masked_median", "masked_median.cu", ":1882", "default",
         errs["masked_median"], lambda: K.masked_median(line_v, line_m, 1),
         lambda: K.masked_median_keys(line_v, line_m, 1), None, 20),
        ("shard_diagnostics_disp", "shard_stats.cu", ":1469",
         "sharded 1 (default)", errs["shard_diagnostics_disp"],
         lambda: K.shard_diagnostics_disp(
             *k10_in["shard_diagnostics_disp"]["whole cube"]),
         lambda: K.cell_diagnostics_disp_plain(
             *k10_in["shard_diagnostics_disp"]["whole cube"]), None, 3),
        ("shard_diagnostics_dedisp", "shard_stats.cu", ":1492",
         "sharded 1 (dedispersed)", errs["shard_diagnostics_dedisp"],
         lambda: K.shard_diagnostics_dedisp(
             *k10_in["shard_diagnostics_dedisp"]["whole cube"]),
         lambda: K.cell_diagnostics_dedisp_plain(
             *k10_in["shard_diagnostics_dedisp"]["whole cube"]), None, 3),
    ]
    k8_parts = ["scaled_sides_axis0_f64", "scaled_sides_axis1_f64",
                "combine_zap_f64"]
    kernels = []
    for (name, src, line, route, err, kfn, pfn, lfn, reps) in entries:
        run = "f64 stream (a)" if route == "stream (a)" else f"f64 {route}"
        launches = counts[run][name + "_f64"]
        extra = {}
        if name == "fused_combine":
            extra = dict(sequences=launches, parts=k8_parts, sources=[
                "iterative_cleaner_torch/stats/csrc/scaled_sides.cu",
                "iterative_cleaner_torch/stats/csrc/combine.cu"])
            launches = sum(counts[run][k] for k in k8_parts)
        bms, bby = kb[name]
        ms = cuda_ms(kfn, reps, torch)
        pms = cuda_ms(pfn, 2, torch)
        lms = cuda_ms(lfn, 2, torch) if lfn else None
        kernels.append({
            "name": name + "_f64", "route": "cuda",
            "source": f"iterative_cleaner_torch/stats/csrc/{src}",
            "replaces": f"iterative_cleaner_tpu/stats/pallas_kernels.py"
                        f"{line}",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": pms, "bound_ms": bms, "bound_by": bby,
            "library_ms": lms, "launches_route": run,
            # the build's launches in every counted run that launched it
            "launches_by_route": {r: c[name + "_f64"]
                                  for r, c in counts.items()
                                  if c.get(name + "_f64")}, **extra})
        what = ""
        if name in k10_in:
            # on one 2 x 2 shard too, the shape each of four ranks gives it
            args = k10_in[name]["2x2 shard"]
            sms = cuda_ms(lambda: getattr(K, name)(*args), reps * 2, torch)
            sbms, sbby = k10_shard_bound[name]
            kernels[-1].update(shard_shape=list(args[0].shape), shard_ms=sms,
                               shard_bound_ms=sbms, shard_bound_by=sbby)
            what = (f"; on a 2x2 shard {tuple(args[0].shape)}: {sms:.4f} ms, "
                    f"bound {sbms:.4f} ms ({sbby})")
        lib = "null" if lms is None else f"{lms:.4f}"
        print(f"time {name}_f64: {ms:.4f} ms, bound {bms:.4f} ms ({bby}), "
              f"plain {pms:.4f} ms, library {lib} ms, {launches} launches "
              f"in the {run} run{what} {tag}", flush=True)
    common = dict(chanthresh=5.0, subintthresh=5.0, rotation="fourier",
                  baseline_duty=0.15)
    for route, prep in ri["preps"].items():
        it_ms = cuda_ms(lambda: iteration_step(prep, weights, weights, mask,
                                               **common), 3, torch)
        key = f"f64 {route}" if route != "pulse_unload" \
            else "f64 pulse window"
        print(f"clean float64 {route}: {results[key].loops} loops, whole "
              f"clean {clean_ms[key]:.1f} ms, {it_ms:.3f} ms per iteration "
              f"(device, resident cubes), peak device memory of the clean "
              f"{peak_gib[key]:.2f} GiB {tag}", flush=True)
    del ri, diags, sides, fw, fs, pfw, pfs, new_w, scores, pw, ps, k10_in
    torch.cuda.empty_cache()
    print(f"float64 phase (4), the float64 builds at full size: "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)

    # ---- (5) long scaler lines in float64: an exact stream of 48,000
    # subints at budget 0 (the cluster kernel in place of K3)
    t_phase = time.perf_counter()
    lar, _ = make_synthetic_archive(**F64_LONG_ARCHIVE)
    whole = clean_archive(lar, CleanConfig(dtype="float64"))
    K.reset_launch_counts()
    key = "f64 stream (long lines)"
    t0 = time.perf_counter()
    r = clean_streaming(lar, 6000, CleanConfig(dtype="float64",
                                               stream_hbm_mb=0))
    torch.cuda.synchronize()
    clean_ms[key] = (time.perf_counter() - t0) * 1e3
    counts[key] = K.launch_counts()
    n_mask = int(((r.final_weights == 0) != (whole.final_weights == 0)).sum())
    long_own = set(f64(STREAM_KERNELS["default"] + LONG_LINE_KERNELS))
    stray = [k for k, v in counts[key].items() if v and k not in long_own]
    print(f"{key}: exact, 8 tiles of 6000 subints of 48000 x 4 x 32, "
          f"budget 0: kernels "
          f"{json.dumps({k: v for k, v in counts[key].items() if v})}, "
          f"{r.loops} loops (whole {whole.loops}), {clean_ms[key]:.1f} ms; "
          f"against the whole float64 clean {n_mask} mask cells differ "
          f"(tolerance 0) {tag}", flush=True)
    if n_mask or r.loops != whole.loops or stray \
            or counts[key]["scaled_sides_cluster_axis0_f64"] < 1 \
            or counts[key]["side_centre_f64"] \
            or counts[key]["scaled_sides_axis0_f64"]:
        fail(f"{key}: mask, loops or launches off")
    print(f"float64 phase (5), long lines: "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return kernels


# The quicklook phase's small archive (the numpy twin runs on the host)
# and the sweep phase's archive and grid.
QUICKLOOK_TWIN_ARCHIVE = dict(nsub=64, nchan=128, nbin=128, seed=21,
                              n_prezapped=40, n_rfi_cells=30)
SWEEP_ARCHIVE = dict(nsub=64, nchan=128, nbin=128, seed=22, n_prezapped=40,
                     n_rfi_cells=30)
SWEEP_GRID = ("4", "5", "6")
# Stage ranges every iteration of the default route's session shows in
# its --trace file, and the kernels' names in it against their launch
# counters: K1 as its kernel and its two partial sums, K9 as 1 to 4 device
# operations a call.
TRACE_RANGES = ("icln_template", "icln_residual_stats", "icln_scores",
                "icln_zap", "icln_iter_metrics")
TRACE_KERNELS = {"icln_marginals_kernel": ("weighted_marginals", 1),
                 "icln_sum_parts": ("weighted_marginals", 2),
                 "icln_cell_stats_kernel": ("cell_diagnostics_disp", 1),
                 "icln_scaled_sides_kernel": ("scaled_sides_axis0", 2),
                 "icln_combine_zap_kernel": ("combine_zap", 1)}


def captured(fn, *args):
    """``fn(*args)``'s return value and what it printed."""
    import contextlib
    import io

    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        rc = fn(*args)
    return rc, text.getvalue()


def checkpoint_phase(ar, whole, want_counts, tag):
    """``--checkpoint`` on ``golden.sf``, in the working directory of
    phase 3e: a first session cleans (``want_counts``), saves, and writes
    the in-process clean's mask; a second prints the resume line, launches
    no kernel and writes a byte-identical output; ``tools diff`` of its
    checkpoint and one saved from the in-process clean exits 0; a session
    with ``-c 4.9`` finds the checkpoint stale and cleans again.  Prints
    the seconds of the checkpoint write, the fast-path resume and the
    whole-cube fingerprint of the float64 archive.  Returns the times."""
    import filecmp

    import torch

    from iterative_cleaner_torch import cli, tools
    from iterative_cleaner_torch.engine.loop import ROUTE_KERNELS
    from iterative_cleaner_torch.io import psrfits
    from iterative_cleaner_torch.stats import kernels as K
    from iterative_cleaner_torch.utils import checkpoint as ckpt

    for name in ("golden.icar", "golden.icar_cleaned.icar",
                 "golden.sf_cleaned.sf"):   # room for two more outputs
        if os.path.exists(name):
            os.remove(name)

    def session(out, *more):
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        rc, text = captured(cli.main, ["-l", "--checkpoint", "ck", "-o", out,
                                       *more, "golden.sf"])
        torch.cuda.synchronize()
        if rc != 0:
            fail(f"checkpoint: session {more} exit code {rc}")
        return time.perf_counter() - t0, K.launch_counts(), text

    path = ckpt.checkpoint_path("ck", "golden.sf")
    first_s, first, text1 = session("ck1.sf")
    w1 = psrfits.read_psrfits_info("ck1.sf")[1]
    n_mask = int(((w1 == 0) != (whole.final_weights == 0)).sum())
    second_s, second, text2 = session("ck2.sf")
    same_bytes = filecmp.cmp("ck1.sf", "ck2.sf", shallow=False)
    os.remove("ck2.sf")
    resumed = f"Resumed from checkpoint: {path}" in text2
    cfg = cli.config_of(cli.build_parser().parse_args(
        ["--checkpoint", "ck", "golden.sf"]))
    t0 = time.perf_counter()
    hit = ckpt.load_matching_checkpoint("ck", "golden.sf", ar, cfg)
    fast_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fp = ckpt.fingerprint_archive(ar)
    fp_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ckpt.save_clean_checkpoint("inproc.ckpt.npz", whole, cfg, fp)
    write_s = time.perf_counter() - t0
    rc_d, text_d = captured(tools.main, ["diff", path, "inproc.ckpt.npz"])
    diff = json.loads(text_d)
    stale_s, stale, text3 = session("ck3.sf", "-c", "4.9")
    os.remove("ck3.sf")
    os.remove("ck1.sf")
    def ran(c):
        return json.dumps({k: v for k, v in c.items() if v})

    print(f"checkpoint: first session {first_s:.1f} s (kernels "
          f"{ran(first)}; output mask against the in-process clean "
          f"{n_mask} cells differ, tolerance 0; resume line printed "
          f"{'Resumed' in text1}); second session {second_s:.1f} s, resume "
          f"line printed {resumed}, kernels {ran(second)}, output "
          f"byte-identical {same_bytes}; the fast-path resume "
          f"(load_matching_checkpoint) {fast_s:.3f} s, the whole-cube "
          f"fingerprint of the {ar.data.dtype} archive ({ar.data.nbytes / 1e9:.2f} "
          f"GB) {fp_s:.3f} s, the checkpoint write {write_s:.3f} s "
          f"({os.path.getsize('inproc.ckpt.npz') / 1e6:.1f} MB); tools diff "
          f"against the in-process clean's checkpoint: exit {rc_d}, "
          f"{diff['changed']} cells changed, same_input "
          f"{diff['same_input']}; -c 4.9 session {stale_s:.1f} s, resume "
          f"line printed {'Resumed' in text3}, kernels {ran(stale)} "
          f"{tag}", flush=True)
    if first != want_counts or "Resumed" in text1 or n_mask:
        fail("checkpoint: the first session differs from the CLI phase's")
    if not resumed or any(second.values()) or not same_bytes:
        fail("checkpoint: the resumed session cleaned or wrote another file")
    if hit is None or rc_d != 0 or diff["changed"]:
        fail("checkpoint: the fast path missed, or the diff found changes")
    if "Resumed" in text3 or any(stale[k] < 1
                                 for k in ROUTE_KERNELS["default"]):
        fail("checkpoint: the stale checkpoint was resumed")
    return {"checkpoint_first_s": first_s, "checkpoint_resume_s": second_s,
            "checkpoint_fast_path_s": fast_s, "fingerprint_s": fp_s,
            "checkpoint_write_s": write_s}


def borderline_phase(whole, tag):
    """``tools borderline --backend torch --device cuda`` on ``golden.sf``
    (phase 3e's directory): every cell where the float32 clean ``whole``
    differs from ``fullsize_mask.npz`` is in its list, with that clean's
    decision."""
    from iterative_cleaner_torch import tools

    shape = whole.final_weights.shape
    _, want_zap = golden_mask("", shape)
    flips = {(int(i), int(c)) for i, c in
             np.argwhere(want_zap != (whole.final_weights == 0))}
    t0 = time.perf_counter()
    rc, text = captured(tools.main, ["borderline", "golden.sf", "--backend",
                                     "torch", "--device", "cuda"])
    seconds = time.perf_counter() - t0
    lines = [json.loads(ln) for ln in text.splitlines()]
    rows, summary = lines[:-1], lines[-1]
    listed = {(r["isub"], r["ichan"]): r["zapped"] for r in rows}
    missing = sorted(flips - set(listed))
    wrong = sorted(k for k in flips & set(listed)
                   if listed[k] != bool(whole.final_weights[k] == 0))
    print(f"borderline: tools borderline --backend torch --device cuda on "
          f"golden.sf in {seconds:.1f} s: {summary['borderline']} cells "
          f"within {summary['eps']} of the threshold "
          f"({summary['zapped_borderline']} zapped), {summary['loops']} "
          f"loops; the float32 clean's {len(flips)} flips against the "
          f"golden {sorted(flips)}: {len(missing)} not listed, {len(wrong)} "
          f"listed with another decision {tag}", flush=True)
    if rc != 0 or missing or wrong or summary["loops"] != whole.loops:
        fail("borderline: a golden flip is not among the borderline cells")
    return {"borderline_s": seconds, "borderline_cells": len(rows)}


def trace_worker(workdir, attempts):
    """The ``--trace`` phase's process: in ``workdir`` (``golden.sf``
    there), one session without ``--trace`` and then up to ``attempts``
    with it, each timed, each traced one's launch counters and trace
    (its stage ranges and the port's kernels by name) returned; stops at
    the first trace that agrees with its counters (``trace_agrees``)."""
    import torch

    from iterative_cleaner_torch import cli
    from iterative_cleaner_torch.stats import kernels as K
    from iterative_cleaner_torch.utils.tracing import (
        trace_event_counts,
        trace_path,
    )

    os.chdir(workdir)
    K.load_library()
    runs = []
    for attempt in range(attempts + 1):
        trace = [] if attempt == 0 else ["--trace", f"tr{attempt}"]
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        rc = cli.main(["-q", "-l", *trace, "--metrics-json", "trace.json",
                       "-o", "traced.sf", "golden.sf"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        with open("trace.json") as f:
            phases = json.load(f)["phases_s"]
        run = {"rc": rc, "s": seconds, "counts": K.launch_counts(),
               "phases": phases}
        if trace:
            path = trace_path(f"tr{attempt}")
            run["ranges"] = trace_event_counts(path, "user_annotation")
            kernels = trace_event_counts(path, "kernel")
            run["kernels"] = {n: sum(v for k, v in kernels.items() if n in k)
                              for n in (*TRACE_KERNELS, "icln_mm_")}
            run["mb"] = os.path.getsize(path) / 1e6
            shutil.rmtree(f"tr{attempt}")
        runs.append(run)
        if trace and trace_agrees(run)[0]:
            break
    os.remove("traced.sf")
    os.remove("trace.json")
    return runs


def trace_agrees(run):
    """Whether a traced session's file holds each stage range once per
    loop and each of the port's kernels as often as its launch counters
    say (K9: 1 to 4 device operations a launch), and what disagrees."""
    c = run["counts"]
    loops = c["masked_median"]
    bad = {r: run["ranges"].get(r, 0) for r in TRACE_RANGES
           if run["ranges"].get(r, 0) != loops}
    for name, (counter, per) in TRACE_KERNELS.items():
        want = per * c[counter] if counter != "scaled_sides_axis0" else (
            c["scaled_sides_axis0"] + c["scaled_sides_axis1"])
        if run["kernels"][name] != want:
            bad[name] = (run["kernels"][name], want)
    if not loops <= run["kernels"]["icln_mm_"] <= 4 * loops:
        bad["icln_mm_"] = (run["kernels"]["icln_mm_"], loops)
    return not bad and loops > 0, bad


def phase_line(run) -> str:
    """A session's phase seconds, as its run report gives them."""
    return ", ".join(f"{k} {v:.2f} s" for k, v in sorted(
        run["phases"].items()))


def trace_phase(workdir, want_counts, tag):
    """``--trace DIR`` on ``golden.sf``, in a spawned process (a trace
    that is its process's first: see ``batch_trace_phase``): the
    session's seconds without the trace and with it, and the trace's
    stage ranges and kernels against the launch counters.  A trace that
    disagrees with its counters is printed and taken again, up to
    TRACE_ATTEMPTS times (each retry is fault (c) of ROADMAP.md showing);
    the phase fails unless one agrees."""
    import multiprocessing

    with ProcessPoolExecutor(
            max_workers=1,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        runs = pool.submit(trace_worker, workdir, TRACE_ATTEMPTS).result()
    plain = runs[0]
    if plain["rc"] != 0 or plain["counts"] != want_counts:
        fail(f"trace: the untraced session's launch counts "
             f"{plain['counts']}, want {want_counts}")
    for attempt, run in enumerate(runs[1:], 1):
        ok, bad = trace_agrees(run)
        print(f"trace: session with --trace (attempt {attempt}) "
              f"{run['s']:.1f} s against {plain['s']:.1f} s without (phases "
              f"{phase_line(run)} against {phase_line(plain)}; the rest, "
              f"the profiler's start, stop and export among it, "
              f"{run['s'] - sum(run['phases'].values()):.2f} s against "
              f"{plain['s'] - sum(plain['phases'].values()):.2f} s); trace "
              f"file {run['mb']:.1f} MB; ranges "
              f"{json.dumps({r: run['ranges'].get(r, 0) for r in TRACE_RANGES})}"
              f"; kernels in the trace {json.dumps(run['kernels'])} against "
              f"the launch counters {json.dumps({k: v for k, v in run['counts'].items() if v})}; "
              f"disagreeing {json.dumps(bad)} {tag}", flush=True)
        if run["rc"] != 0 or run["counts"] != want_counts:
            fail("trace: the traced session launched other kernels")
        if ok:
            if attempt > 1:
                print(f"trace: {attempt - 1} retries (fault (c): a trace "
                      f"short of what the counters say)", flush=True)
            return {"trace_s": run["s"], "untraced_s": plain["s"],
                    "trace_phases_s": run["phases"],
                    "untraced_phases_s": plain["phases"],
                    "trace_retries": attempt - 1}
    fail(f"trace: no one of {len(runs) - 1} traces agreed with its launch "
         f"counters")


def quicklook_phase(ar, counts, clean_ms, peak_gib, dev, tag):
    """``--model quicklook`` on the golden archive on the card: float32
    and float64, each launching exactly K6, K3 twice and the combine once
    (their float64 builds in float64), the float32 mask held to the
    float64 one under the goldens' flip rule (the float64 scores
    standing in for the oracle's), the whole-clean ms and the peak beside
    the default clean's; K6's zero-template planes against its plain
    version (and d_mean's sign flipped back giving bit-equal scores); the
    float64 quicklook bit-equal to the numpy twin on a 64 x 128 x 128
    archive.  Adds the runs' launch counts to ``counts``."""
    import torch

    from iterative_cleaner_torch import CleanConfig
    from iterative_cleaner_torch.backends.torch_backend import (
        upload,
        upload_meta,
    )
    from iterative_cleaner_torch.engine.loop import scores_and_zap
    from iterative_cleaner_torch.io.synthetic import make_synthetic_archive
    from iterative_cleaner_torch.models import QUICKLOOK, get_model
    from iterative_cleaner_torch.models.quicklook import (
        QUICKLOOK_KERNELS,
        quicklook_prepare,
    )
    from iterative_cleaner_torch.stats import kernels as K

    quicklook = get_model(QUICKLOOK)
    res = {}
    for key, dtype, suffix in (("quicklook", "float32", ""),
                               ("quicklook f64", "float64", "_f64")):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        res[key] = r = quicklook(ar, CleanConfig(dtype=dtype))
        torch.cuda.synchronize()
        clean_ms[key] = (time.perf_counter() - t0) * 1e3
        counts[key] = c = K.launch_counts()
        peak_gib[key] = torch.cuda.max_memory_allocated() / 2 ** 30
        want = dict.fromkeys(c, 0)
        want.update({k + suffix: 1 for k in QUICKLOOK_KERNELS})
        print(f"{key}: kernels {json.dumps({k: v for k, v in c.items() if v})}"
              f", whole clean {clean_ms[key]:.1f} ms (the default clean "
              f"{clean_ms['default']:.1f} ms), peak device memory "
              f"{peak_gib[key]:.2f} GiB (the default clean "
              f"{peak_gib['default']:.2f} GiB), zapped "
              f"{int((r.final_weights == 0).sum())} {tag}", flush=True)
        if c != want or (r.loops, r.converged) != (1, True) \
                or not np.all(np.isfinite(r.final_weights)):
            fail(f"{key}: launches {c}, want K6, K3 x 2 and the combine once")
    s64 = res["quicklook f64"].scores
    flips = np.argwhere((res["quicklook"].final_weights == 0)
                        != (res["quicklook f64"].final_weights == 0))
    near = [abs(float(s64[i, c]) - 1.0) for i, c in flips]
    print(f"quicklook: float32 against float64 on the card: {len(flips)} "
          f"flips (cap {MAX_BORDERLINE_FLIPS}), the float64 |score - 1| of "
          f"each {[round(x, 5) for x in near]} (limit {FLIP_NOISE_ENV})",
          flush=True)
    if len(flips) > MAX_BORDERLINE_FLIPS or any(x > FLIP_NOISE_ENV
                                                for x in near):
        fail("quicklook: float32 mask outside the flip rule of float64's")

    cfg = CleanConfig()
    w = upload(ar.weights, dev)
    mask = w == 0
    ded = quicklook_prepare(upload(ar.total_intensity(), dev), w,
                            *upload_meta(ar.freqs_mhz, ar.dm,
                                         ar.centre_freq_mhz, ar.period_s,
                                         dev), cfg, dedispersed=False)
    nbin = ded.shape[-1]
    zero = torch.zeros(nbin, device=dev)
    ones = torch.ones(nbin, device=dev)
    diags = K.cell_diagnostics_dedisp(ded, zero, ones, w, mask)
    plain = K.cell_diagnostics_dedisp_plain(ded, zero, ones, w, mask)
    err, ok = diags_check(diags, plain, mask, torch)
    _, scores = scores_and_zap(diags, mask, w, 5.0, 5.0)
    _, s_flip = scores_and_zap((diags[0], -diags[1], diags[2], diags[3]),
                               mask, w, 5.0, 5.0)
    n_sign = bits_mismatch(s_flip, scores, torch)
    n_run = bits_mismatch(scores.cpu(), torch.from_numpy(
        res["quicklook"].scores), torch)
    k6_ms = cuda_ms(lambda: K.cell_diagnostics_dedisp(ded, zero, ones, w,
                                                      mask), 5, torch)
    print(f"quicklook: K6 with a zero template and a ones window against "
          f"its plain version: max abs error {err:.3e} (rtol {K2_RTOL:g} of "
          f"each plane's scale, masked cells bit-equal): {ok}; scores with "
          f"d_mean's sign flipped back: {n_sign} cells differ in bits; "
          f"against the quicklook run's scores {n_run}; K6 {k6_ms:.4f} ms "
          f"{tag}", flush=True)
    if not ok or n_sign or n_run:
        fail("quicklook: K6's zero-template planes or scores disagree")
    del ded, diags, plain, scores, s_flip

    small, _ = make_synthetic_archive(**QUICKLOOK_TWIN_ARCHIVE)
    t0 = time.perf_counter()
    twin = quicklook(small, CleanConfig(backend="numpy"))
    twin_s = time.perf_counter() - t0
    card = quicklook(small, CleanConfig(dtype="float64"))
    n_bits = int((twin.final_weights != card.final_weights).sum())
    print(f"quicklook: float64 on the card against the numpy twin on "
          f"{tuple(QUICKLOOK_TWIN_ARCHIVE[k] for k in ('nsub', 'nchan', 'nbin'))}"
          f": {n_bits} weights differ (tolerance 0), "
          f"{int((twin.final_weights == 0).sum())} zapped, the twin "
          f"{twin_s:.2f} s on the host, max |score difference| "
          f"{float(np.nanmax(np.abs(twin.scores - card.scores))):.3e} {tag}",
          flush=True)
    if n_bits:
        fail("quicklook: the float64 card mask differs from the numpy twin")


def sweep_phase(tag):
    """``tools sweep --device cuda`` over a SWEEP_GRID x SWEEP_GRID grid of
    thresholds on a 64 x 128 x 128 archive, for both models, each row
    held to an in-process clean on the card; prints the seconds."""
    from iterative_cleaner_torch import CleanConfig, tools
    from iterative_cleaner_torch.io import save_archive
    from iterative_cleaner_torch.io.synthetic import make_synthetic_archive
    from iterative_cleaner_torch.models import get_model

    ar, _ = make_synthetic_archive(**SWEEP_ARCHIVE)
    with tempfile.TemporaryDirectory(prefix="icln_chip_smoke_sweep_") as wd:
        path = os.path.join(wd, "sweep.npz")
        save_archive(ar, path)
        for model in ("surgical_scrub", "quicklook"):
            t0 = time.perf_counter()
            rc, text = captured(tools.main, [
                "sweep", path, "--device", "cuda", "--model", model,
                "-c", *SWEEP_GRID, "-s", *SWEEP_GRID])
            seconds = time.perf_counter() - t0
            rows = [json.loads(ln) for ln in text.splitlines()]
            bad = [r for r in rows if r["rfi_frac"] != round(get_model(model)(
                ar, CleanConfig(chanthresh=r["chanthresh"],
                                subintthresh=r["subintthresh"])
            ).rfi_fraction, 6)]
            print(f"sweep: tools sweep --model {model} --device cuda, "
                  f"{len(rows)} points in {seconds:.2f} s, zap fractions "
                  f"{[r['rfi_frac'] for r in rows]}, {len(bad)} rows off "
                  f"the in-process cleans {tag}", flush=True)
            if rc != 0 or len(rows) != len(SWEEP_GRID) ** 2 or bad:
                fail(f"sweep: --model {model} rows differ from in-process "
                     f"cleans")


# ---- the online phases (online/, --stream DIR, --mux, online_ewt): o1-o5 --
# (o1) one solo stream: the first ONLINE_SOLO_NSUB subints of the full-size
# archive (4096 x 128, float32), a reconcile every ONLINE_RECONCILE_EVERY;
# (o2) a mux of ONLINE_MUX_STREAMS streams of ONLINE_MUX_NSUB subints each
# (the next slices of the full-size archive), max_batch ONLINE_MUX_STREAMS,
# fed round-robin, against as many solo sessions; (o3) the step's kernels
# held to their plain versions at (1, 1, C, B) and (L, 1, C, B), timed;
# (o4) --stream DIR and --mux D1 D2 D3 on spawned processes; (o5) --model
# online_ewt on (o1)'s archive.
ONLINE_SOLO_NSUB = 64
ONLINE_RECONCILE_EVERY = 16
ONLINE_MUX_STREAMS = 16
ONLINE_MUX_NSUB = 8
ONLINE_CLI_MUX_STREAMS = 3
ONLINE_SUB_TIMEOUT_S = 300


def online_chunk_dir(d, meta, cube):
    """The directory protocol: ``stream.json``, one ``.npy`` chunk a
    subint, the close sentinel."""
    from iterative_cleaner_torch.online import (
        CLOSE_SENTINEL,
        save_stream_meta,
    )

    os.makedirs(d)
    save_stream_meta(d, meta)
    for i in range(cube.shape[0]):
        np.save(os.path.join(d, "%06d.npy" % i), cube[i])
    open(os.path.join(d, CLOSE_SENTINEL), "w").close()


def online_solo(ar, counts, dev, tag):
    """(o1): one stream through an OnlineSession, each subint's launches
    read (the step's four kernels once each; on a reconcile's subint the
    default route's kernels too), each reconcile's mask held to the batch
    clean of its prefix and the close to ``clean_archive`` of the
    64-subint archive, bit for bit; no kernel-library build after the
    warm-up.  Returns ``(meta, cube, session result, provisional weights
    and scores before the first reconcile, the step's planes for (o3))``."""
    import torch

    from iterative_cleaner_torch import CleanConfig
    from iterative_cleaner_torch.backends import clean_archive
    from iterative_cleaner_torch.engine.loop import ROUTE_KERNELS
    from iterative_cleaner_torch.online import OnlineSession, StreamMeta
    from iterative_cleaner_torch.online.session import percentile_ms
    from iterative_cleaner_torch.online.step import STEP_KERNELS
    from iterative_cleaner_torch.stats import kernels as K
    from iterative_cleaner_torch.telemetry import MetricsRegistry

    meta = StreamMeta.from_archive(ar)
    cube = np.ascontiguousarray(ar.total_intensity()[:ONLINE_SOLO_NSUB])
    weights = np.asarray(ar.weights[:ONLINE_SOLO_NSUB], np.float64)
    cfg = CleanConfig(stream_reconcile_every=ONLINE_RECONCILE_EVERY,
                      device=str(dev))
    reg = MetricsRegistry()
    s = OnlineSession(meta, cfg, registry=reg, stream_id="o1")
    recon_s, held = [], []
    reconcile = s.reconcile

    def timed_reconcile():
        t0 = time.perf_counter()
        drift = reconcile()
        recon_s.append(time.perf_counter() - t0)
        return drift

    s.reconcile = timed_reconcile
    total = dict.fromkeys(K.launch_counts(), 0)
    step_ok, before = True, None
    torch.cuda.synchronize()
    t_all = time.perf_counter()
    for i in range(ONLINE_SOLO_NSUB):
        K.reset_launch_counts()
        s.ingest(cube[i], weights[i])
        c = K.launch_counts()
        for k, v in c.items():
            total[k] += v
        stepped = {k: v for k, v in c.items() if v}
        if (i + 1) % ONLINE_RECONCILE_EVERY:
            step_ok &= stepped == dict.fromkeys(STEP_KERNELS, 1)
        else:
            step_ok &= all(c[k] >= 1 for k in ROUTE_KERNELS["default"])
            step_ok &= all(c[k] >= 1 for k in STEP_KERNELS)
            # the reconcile's mask: the batch clean of the prefix
            prefix = clean_archive(s.assembled(), cfg)
            bits = int(np.sum(s.provisional_weights
                              != prefix.final_weights)) + int(np.sum(
                ~((s.provisional_scores == prefix.scores)
                  | (np.isnan(s.provisional_scores)
                     & np.isnan(prefix.scores)))))
            held.append(bits)
        if i == ONLINE_RECONCILE_EVERY - 2:
            before = (s.provisional_weights, s.provisional_scores)
    ingest_s = time.perf_counter() - t_all
    t0 = time.perf_counter()
    res = s.close()
    close_s = time.perf_counter() - t0
    counts["online (o1)"] = total
    whole = clean_archive(s.assembled(), cfg)
    close_bits = int(np.sum(res.archive.weights != whole.final_weights))
    parts = online_subint_parts(meta, cube, weights, cfg, s.alpha, dev)
    parts_text = ", ".join(f"{k} {np.median(v):.3f} ms"
                           for k, v in parts.items())
    lat = res.latencies_s
    steady = [v for i, v in enumerate(lat) if i]
    print(f"online (o1) solo stream, {ONLINE_SOLO_NSUB} subints of "
          f"{meta.nchan} x {meta.nbin}, a reconcile every "
          f"{ONLINE_RECONCILE_EVERY}: per-subint latency p50 "
          f"{percentile_ms(lat, 50):.3f} ms, p99 {percentile_ms(lat, 99):.3f}"
          f" ms (first subint {lat[0] * 1e3:.3f} ms; after it p50 "
          f"{percentile_ms(steady, 50):.3f}, p99 "
          f"{percentile_ms(steady, 99):.3f}, max {max(steady) * 1e3:.3f} "
          f"ms; a subint's parts, medians of {len(parts['step'])}: "
          f"{parts_text}); reconciles {json.dumps([round(v, 4) for v in recon_s])} s,"
          f" close {close_s:.3f} s, {ONLINE_SOLO_NSUB} ingests "
          f"{ingest_s:.3f} s in all; launches a subint (no reconcile): "
          f"K6 1, K3 1 + 1, combine 1: {'ok' if step_ok else 'FAIL'}; "
          f"kernels {json.dumps({k: v for k, v in total.items() if v})}; "
          f"reconcile masks and scores against the prefix's batch clean: "
          f"{held} cells differ in bits (tolerance: 0); the close against "
          f"clean_archive: {close_bits} (tolerance: 0); drift "
          f"{res.mask_drift} mid + {res.final_drift} final; "
          f"{res.warmup_compiles} warm-up and {res.recompiles_steady} steady"
          f" kernel-library builds {tag}", flush=True)
    if not step_ok or any(held) or close_bits or res.recompiles_steady \
            or len(held) != ONLINE_SOLO_NSUB // ONLINE_RECONCILE_EVERY \
            or res.reconciles != len(held):
        fail("online (o1): launches, reconciles or the close off")
    if not np.all(np.isfinite(res.archive.weights)) \
            or res.archive.weights.shape != (ONLINE_SOLO_NSUB, meta.nchan):
        fail("online (o1): the closed archive's weights are malformed")
    return meta, cube, res, before


def online_subint_parts(meta, cube, weights, cfg, alpha, dev, n=16):
    """A subint's time in its parts, each on the host clock after a
    synchronise, over ``n`` subints: the float64 tile's conversion and
    upload, the step (the preamble, the EW update and the four kernels)
    and the one download.  ``{part: [ms, ...]}``."""
    import torch

    from iterative_cleaner_torch.backends.torch_backend import (
        upload,
        upload_meta,
    )
    from iterative_cleaner_torch.online.session import download_rows
    from iterative_cleaner_torch.online.step import build_subint_step

    step, _, dtype = build_subint_step(cfg, meta.nchan, meta.nbin,
                                       meta.dedispersed, alpha)
    args = upload_meta(np.asarray(meta.freqs_mhz), meta.dm,
                       meta.centre_freq_mhz, meta.period_s, dev, dtype)
    template = torch.zeros((meta.nbin,), dtype=dtype, device=dev)
    count = torch.zeros((), dtype=torch.int32, device=dev)
    parts = {"upload": [], "step": [], "download": []}
    for i in range(min(n, cube.shape[0])):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tile = upload(cube[i][None], dev, dtype)
        w_row = upload(weights[i][None], dev, dtype)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        new_w, scores, template, updated = step(tile, w_row, *args,
                                                template, count)
        count = count + updated.to(torch.int32)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        download_rows(new_w, scores)
        t3 = time.perf_counter()
        for k, a, b in (("upload", t0, t1), ("step", t1, t2),
                        ("download", t2, t3)):
            parts[k].append((b - a) * 1e3)
    return parts


def online_mux(ar, meta, counts, dev, tag):
    """(o2): ONLINE_MUX_STREAMS streams, each ONLINE_MUX_NSUB subints of
    the full-size archive after (o1)'s, through ONLINE_MUX_STREAMS solo
    sessions and then one StreamMux (max_batch ONLINE_MUX_STREAMS, fed
    round-robin): every lane's provisional mask, scores and EW template
    bit-equal to its solo session's, the closes equal, each dispatch one
    launch of each of the step's kernels.  Returns ``(streams, solo
    sessions' close weights, the step inputs of the lanes' first subints
    for (o3))``."""
    import torch

    from iterative_cleaner_torch import CleanConfig
    from iterative_cleaner_torch.online import OnlineSession, StreamMux
    from iterative_cleaner_torch.online.step import STEP_KERNELS
    from iterative_cleaner_torch.stats import kernels as K
    from iterative_cleaner_torch.telemetry import MetricsRegistry

    cfg = CleanConfig(stream_reconcile_every=0, device=str(dev))
    n, m = ONLINE_MUX_STREAMS, ONLINE_MUX_NSUB
    full = ar.total_intensity()
    streams = [np.ascontiguousarray(
        full[ONLINE_SOLO_NSUB + k * m:ONLINE_SOLO_NSUB + (k + 1) * m])
        for k in range(n)]
    # each session with a registry, as the mux's (its quality monitor)
    solos = [OnlineSession(meta, cfg, registry=MetricsRegistry(),
                           stream_id=f"s{k}") for k in range(n)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rounds = []
    for i in range(m):
        t1 = time.perf_counter()
        for s, cube in zip(solos, streams):
            s.ingest(cube[i])
        rounds.append((time.perf_counter() - t1) * 1e3)
    solo_s = time.perf_counter() - t0
    reg = MetricsRegistry()
    mux = StreamMux(max_batch=n, max_wait_ms=60_000.0, registry=reg)
    for k in range(n):
        mux.open(f"s{k}", meta, cfg)
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ticks = []
    for i in range(m):
        t1 = time.perf_counter()
        for k, cube in enumerate(streams):
            mux.ingest(f"s{k}", cube[i])
        mux.pump()
        ticks.append((time.perf_counter() - t1) * 1e3)
    mux_s = time.perf_counter() - t0
    counts["online (o2)"] = c = K.launch_counts()
    step_h = reg.snapshot()["histograms"]["mux_dispatch_s"]
    launched = {k: v for k, v in c.items() if v}
    bad = 0
    for k, solo in enumerate(solos):
        lane = mux.session(f"s{k}")
        bad += int(np.sum(lane.provisional_weights
                          != solo.provisional_weights))
        bad += int(np.sum(~((lane.provisional_scores
                             == solo.provisional_scores)
                            | (np.isnan(lane.provisional_scores)
                               & np.isnan(solo.provisional_scores)))))
        bad += int(np.sum(lane.template() != solo.template()))
    closes = [s.close().archive.weights for s in solos]
    close_bad = sum(int(np.sum(mux.close_stream(f"s{k}").archive.weights
                               != closes[k])) for k in range(n))
    lat = [v for s in solos for v in s.latencies_s]
    print(f"online (o2) mux, {n} streams x {m} subints of {meta.nchan} x "
          f"{meta.nbin}, max_batch {n}, round-robin: {mux.dispatches} "
          f"dispatches, occupancy {mux.occupancy_mean():.3f}, "
          f"{mux.partial_dispatches} partial; {n * m} subints in "
          f"{mux_s:.3f} s ({n * m / mux_s:.1f} subints/s) against "
          f"{solo_s:.3f} s ({n * m / solo_s:.1f} subints/s) for {n} solo "
          f"sessions (their per-subint p50 "
          f"{np.percentile(np.asarray(lat) * 1e3, 50):.3f} ms); a round of "
          f"{n} subints, ingest and dispatch, ms: mux "
          f"{json.dumps([round(v, 2) for v in ticks])}, solo "
          f"{json.dumps([round(v, 2) for v in rounds])}; of the mux's "
          f"rounds, the step and its download (mux_dispatch_s) "
          f"{step_h['sum'] / step_h['count'] * 1e3:.2f} ms a dispatch, "
          f"the rest ingest, staging and commits; launches "
          f"{json.dumps(launched)} ({mux.dispatches} dispatches: one K6, "
          f"one K3 per axis, one combine each); lanes against the solo "
          f"sessions: {bad} masks, scores and template values differ in "
          f"bits, the closes {close_bad} cells (tolerance: 0 and 0); "
          f"{mux.warmup_compiles} warm-up and {mux.recompiles_steady} steady"
          f" kernel-library builds {tag}", flush=True)
    if bad or close_bad or launched != dict.fromkeys(STEP_KERNELS,
                                                     mux.dispatches) \
            or mux.dispatches != m or mux.recompiles_steady:
        fail("online (o2): the mux's lanes, closes or launches off")
    return streams, closes, solos


def online_kernels(meta, streams, solos, dev, tag):
    """(o3): K6, K3 along each axis and the combine at the step's shapes,
    (1, 1, C, B) solo and (L, 1, C, B) lane-batched, in float32, bf16
    storage (K6) and float64, on the preamble of (o2)'s streams' first
    subints with their solo sessions' EW templates: each against its
    plain version (K6 within its tolerance, the rest bit-equal, NaN by
    position) and timed by CUDA events beside its bound.  Returns
    ``{kernel name: {shape label: numbers}}`` for the kernels line."""
    import torch

    from iterative_cleaner_torch.backends.torch_backend import (
        upload,
        upload_meta,
    )
    from iterative_cleaner_torch.engine.loop import scores_and_zap
    from iterative_cleaner_torch.ops.dsp import prepare_cube_with_correction
    from iterative_cleaner_torch.stats import kernels as K

    C, B = meta.nchan, meta.nbin
    L = len(streams)
    out = {}

    def planes(dtype, nb):
        teds, tts = [], []
        for k in range(nb):
            ded = prepare_cube_with_correction(
                upload(streams[k][:1], dev, dtype),
                torch.ones((1, C), dtype=dtype, device=dev),
                *upload_meta(np.asarray(meta.freqs_mhz), meta.dm,
                             meta.centre_freq_mhz, meta.period_s, dev, dtype),
                baseline_duty=0.15, rotation="fourier",
                dedispersed=False, baseline_mode="profile")[0]
            teds.append(ded)
            tts.append(torch.from_numpy(solos[k].template()).to(dev, dtype))
        ded, t = torch.stack(teds), torch.stack(tts)
        w = torch.ones((nb, 1, C), dtype=dtype, device=dev)
        w[:, :, 7::97] = 0.0           # a few upstream-flagged channels
        return ded, t, w, w == 0

    ok = True
    for label, dtype, store, nb in (
            ("solo", torch.float32, None, 1),
            (f"lanes{L}", torch.float32, None, L),
            ("solo bf16", torch.float32, torch.bfloat16, 1),
            (f"lanes{L} bf16", torch.float32, torch.bfloat16, L),
            ("solo f64", torch.float64, None, 1),
            (f"lanes{L} f64", torch.float64, None, L)):
        ded, t, w, mask = planes(dtype, nb)
        if nb == 1:
            ded, t, w, mask = ded[0], t[0], w[0], mask[0]
        if store is not None:
            ded = ded.to(store)
        win = torch.ones((B,), dtype=dtype, device=dev)
        f64 = dtype == torch.float64
        sfx = "_f64" if f64 else ("_bf16" if store is not None else "")
        kb = profiling.kernel_bounds(1, C, B, cube_bytes=8 if f64 else (
            2 if store is not None else 4))
        diags = K.cell_diagnostics_dedisp(ded, t, win, w, mask)
        plain = K.cell_diagnostics_dedisp_plain(ded, t, win, w, mask)
        err6, ok6 = diags_check(diags, plain, mask, torch,
                                rtol=1e-12 if f64 else K2_RTOL)
        sides = [K.scaled_sides(diags, mask, a, 5.0) for a in (0, 1)]
        errs, ok3 = [], True
        for a in (0, 1):
            want = K.scaled_sides_plain(diags, mask, a, 5.0)
            ok3 &= all(bits_mismatch(g, p, torch) == 0
                       for g, p in zip(sides[a], want))
            errs.append(max(max_abs_diff(g, p, torch)
                            for g, p in zip(sides[a], want)))
        new_w, scores = K.combine_zap(sides[0], sides[1], w)
        pw, ps = K.combine_zap_plain(sides[0], sides[1], w)
        okc = bits_mismatch(scores, ps, torch) \
            + bits_mismatch(new_w, pw, torch) == 0
        errc = max_abs_diff(scores, ps, torch)
        nw2, sc2 = scores_and_zap(diags, mask, w, 5.0, 5.0)
        okc &= bits_mismatch(sc2, scores, torch) == 0
        ok &= ok6 and ok3 and okc
        calls = {
            "cell_diagnostics_dedisp": (
                err6, lambda: K.cell_diagnostics_dedisp(ded, t, win, w, mask),
                lambda: K.cell_diagnostics_dedisp_plain(ded, t, win, w,
                                                        mask)),
            "scaled_sides_axis0": (
                errs[0], lambda: K.scaled_sides(diags, mask, 0, 5.0),
                lambda: K.scaled_sides_plain(diags, mask, 0, 5.0)),
            "scaled_sides_axis1": (
                errs[1], lambda: K.scaled_sides(diags, mask, 1, 5.0),
                lambda: K.scaled_sides_plain(diags, mask, 1, 5.0)),
            "combine_zap": (
                errc, lambda: K.combine_zap(sides[0], sides[1], w),
                lambda: K.combine_zap_plain(sides[0], sides[1], w)),
        }
        for name, (err, kfn, pfn) in calls.items():
            if store is not None and name != "cell_diagnostics_dedisp":
                continue     # the planes are float32: the float32 rows
            ms = cuda_ms(kfn, 50, torch)
            pms = cuda_ms(pfn, 3, torch)
            bms, bby = kb[name]
            key = name + sfx
            out.setdefault(key, {})[label.split(" ")[0]] = {
                "shape": [nb, 1, C, B], "ms": ms, "plain_ms": pms,
                "bound_ms": nb * bms, "bound_by": bby, "max_abs_err": err}
            print(f"online (o3) {key} at ({nb}, 1, {C}, {B}): {ms:.4f} ms, "
                  f"bound {nb * bms:.4f} ms ({bby}), plain {pms:.4f} ms, "
                  f"max abs err {err:.3e} {tag}", flush=True)
        print(f"online (o3) check {label}: K6 against its plain version "
              f"{'ok' if ok6 else 'FAIL'} (max abs {err6:.3e}), K3 axis 0 "
              f"and 1 bit-equal {'ok' if ok3 else 'FAIL'}, the combine "
              f"bit-equal {'ok' if okc else 'FAIL'} (NaN by position) {tag}",
              flush=True)
    if not ok:
        fail("online (o3): a step kernel disagrees with its plain version")
    return out


def online_cli(meta, cube, solo_res, streams, closes, dev, tag):
    """(o4): ``--stream DIR`` on (o1)'s subints and ``--mux D1 D2 D3`` on
    three of (o2)'s streams, written as ``.npy`` chunks with a
    ``stream.json``, each a spawned process: their ``stream_cleaned.npz``
    masks equal (o1)'s close and (o2)'s closes."""
    from iterative_cleaner_torch.io import load_archive

    with tempfile.TemporaryDirectory(prefix="icln_chip_smoke_online_") as wd:
        solo_dir = os.path.join(wd, "solo")
        online_chunk_dir(solo_dir, meta, cube)
        mux_dirs = [os.path.join(wd, f"m{k}")
                    for k in range(ONLINE_CLI_MUX_STREAMS)]
        for d, s in zip(mux_dirs, streams):
            online_chunk_dir(d, meta, s)
        env = dict(os.environ, ICLEAN_STREAM_IDLE_S="60")
        runs = {
            "--stream": [sys.executable, "-m", "iterative_cleaner_torch",
                         "-q", "--device", str(dev), "--stream", solo_dir,
                         "--stream-reconcile-every",
                         str(ONLINE_RECONCILE_EVERY)],
            "--mux": [sys.executable, "-m", "iterative_cleaner_torch",
                      "--device", str(dev), "--mux", *mux_dirs,
                      "--stream-reconcile-every", "0",
                      "--mux-max-batch", str(ONLINE_CLI_MUX_STREAMS)]}
        procs = {k: subprocess.Popen(v, cwd=HERE, env=env, text=True,
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE)
                 for k, v in runs.items()}
        t0 = time.perf_counter()
        for name, p in procs.items():
            try:
                out, err = p.communicate(timeout=ONLINE_SUB_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                p.kill()
                p.communicate()
                fail(f"online (o4) {name}: timed out")
            if p.returncode != 0:
                fail(f"online (o4) {name}: exit {p.returncode}: "
                     f"{err[-2000:]}")
            print(f"  {name} exited 0 after {time.perf_counter() - t0:.1f} s"
                  + (f": {out.strip().splitlines()[-1]}" if out.strip()
                     else ""), flush=True)
        off = int(np.sum(load_archive(os.path.join(
            solo_dir, "stream_cleaned.npz")).weights
            != solo_res.archive.weights))
        moff = sum(int(np.sum(load_archive(os.path.join(
            d, "stream_cleaned.npz")).weights != closes[k]))
            for k, d in enumerate(mux_dirs))
    print(f"online (o4) CLI: --stream DIR ({cube.shape[0]} chunks) against "
          f"(o1)'s close: {off} cells differ; --mux over "
          f"{ONLINE_CLI_MUX_STREAMS} directories against (o2)'s closes: "
          f"{moff} cells differ (tolerance: 0 and 0) {tag}", flush=True)
    if off or moff:
        fail("online (o4): the CLI's masks differ from the in-process runs")


def online_model(ar, before, dev, tag):
    """(o5): ``--model online_ewt`` through ``cli.main`` on (o1)'s
    archive: its provisional mask (and scores, NaN by position) equal to
    (o1)'s before its first reconcile."""
    import dataclasses

    from iterative_cleaner_torch import cli
    from iterative_cleaner_torch import CleanConfig
    from iterative_cleaner_torch.io import load_archive, save_archive
    from iterative_cleaner_torch.models import ONLINE_EWT, get_model

    sub = dataclasses.replace(
        ar, data=np.ascontiguousarray(ar.data[:ONLINE_SOLO_NSUB]),
        weights=np.ascontiguousarray(ar.weights[:ONLINE_SOLO_NSUB]))
    n = before[0].shape[0]
    with tempfile.TemporaryDirectory(prefix="icln_chip_smoke_ewt_") as wd:
        path = os.path.join(wd, "o1.icar")
        save_archive(sub, path)
        t0 = time.perf_counter()
        rc, _ = captured(cli.main, ["-q", "-l", "--device", str(dev),
                                    "--model", ONLINE_EWT, path])
        seconds = time.perf_counter() - t0
        got = load_archive(path + "_cleaned.icar").weights
    scores = get_model(ONLINE_EWT)(sub, CleanConfig(device=str(dev))).scores
    off = int(np.sum(got[:n] != before[0])) + int(np.sum(~(
        (scores[:n] == before[1]) | (np.isnan(scores[:n])
                                     & np.isnan(before[1])))))
    print(f"online (o5) --model online_ewt on (o1)'s {ONLINE_SOLO_NSUB} "
          f"subints in {seconds:.2f} s: against (o1)'s provisional mask and "
          f"scores before its first reconcile ({n} subints): {off} values "
          f"differ in bits (tolerance: 0); {int(np.sum(got == 0))} cells "
          f"zapped {tag}", flush=True)
    if rc != 0 or off:
        fail("online (o5): --model online_ewt differs from (o1)")


def online_phases(ar, counts, dev, tag):
    """The online phases (o1)-(o5); returns (o3)'s kernel numbers for the
    kernels line.  Prints their seconds."""
    t_all = time.perf_counter()
    meta, cube, solo_res, before = online_solo(ar, counts, dev, tag)
    streams, closes, solos = online_mux(ar, meta, counts, dev, tag)
    times = online_kernels(meta, streams, solos, dev, tag)
    online_cli(meta, cube, solo_res, streams[:ONLINE_CLI_MUX_STREAMS],
               closes, dev, tag)
    online_model(ar, before, dev, tag)
    print(f"online phases: {time.perf_counter() - t_all:.1f} s in all {tag}",
          flush=True)
    return times


# ---- the fleet phases (parallel/fleet.py, --fleet): f1-f6 ----------------
# (f1) the mixed fleet: FLEET_MIX archives of each shape, interleaved,
# under --bucket-pad 0,32 (accepted; the port pads nothing, so the 64 x 120
# archives stay a bucket of their own); FLEET_ORDERS, the sessions' order
# in each round (each session warm in one round and cold-ish in the other)
FLEET_MIX = (((64, 128, 512), 16), ((64, 120, 512), 4),
             ((256, 1024, 128), 4))
FLEET_GROUP, FLEET_PAD = 8, "0,32"
FLEET_ORDERS = (("sequential", "batch", "fleet"),
                ("fleet", "batch", "sequential"))
# (f2) the ladder's drill: over the first FLEET_DRILL_N 64 x 128 archives
# in groups of 2, a transient load fault, a transient write, an OOM on the
# first clean (its halves are the second and third) and a hang on the third
FLEET_DRILL = "load:err@2,write:once,exec:oom@1,exec:hang@3"
FLEET_DRILL_N, FLEET_STAGE_TIMEOUT_S = 6, 6.0
# (f3) the real OOM: a group of FLEET_OOM_N 256 x 1024 x 128 archives (the
# (f1) files, each linked under several names)
FLEET_OOM_N = 8
# (f5) the warm start: two archives of each shape, two fleet sessions over
# one fresh --compile-cache; the first builds the kernel library there
FLEET_WARM_SHAPES = ((64, 128, 512), (64, 120, 512), (32, 64, 128))
# (f4) the kill: a --journal fleet over the first FLEET_KILL_N small
# archives in groups of 2 on one IO thread, wedged by a hang on load 5
FLEET_KILL_N = 8
# spawned sessions: start-up (torch, the library load) and work
FLEET_SUB_TIMEOUT_S = 300
# (f1)'s sequential session's run-report entries by file name, which
# (m5) holds its entries to
SEQ_ENTRIES = {}


def fleet_files(work):
    """The fleet phases' PSRFITS files in ``work``: FLEET_MIX interleaved
    (one of each shape in turn while each lasts), seeds 300 up.  Returns
    the paths in that order and each path's shape."""
    from iterative_cleaner_torch.io import save_archive

    queues = [[shape] * n for shape, n in FLEET_MIX]
    order = []
    while any(queues):
        for q in queues:
            if q:
                order.append(q.pop())
    paths, shapes = [], {}
    for i, shape in enumerate(order):
        p = os.path.join(work, f"fleet{i:02d}.sf")
        save_archive(batch_small_archive(300 + i, shape), p)
        paths.append(p)
        shapes[p] = shape
    return paths, shapes


def linked(paths, d):
    """Symlinks to ``paths`` in a new directory ``d`` (each session writes
    its outputs beside its inputs)."""
    os.makedirs(d)
    out = []
    for p in paths:
        out.append(os.path.join(d, os.path.basename(p)))
        os.symlink(p, out[-1])
    return out


def cli_session(links, d, extra):
    """One in-process CLI session in ``d``: ``(rc, run report, seconds,
    launch counts)``."""
    from iterative_cleaner_torch.cli import main as cli_main
    from iterative_cleaner_torch.stats import kernels as K

    import torch

    cwd = os.getcwd()
    os.chdir(d)
    try:
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        rc = cli_main(["-q", "--timing", "--metrics-json", "run.json",
                       *extra, *links])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = K.launch_counts()
    finally:
        os.chdir(cwd)
    with open(os.path.join(d, "run.json")) as fh:
        doc = json.load(fh)
    return rc, doc, secs, counts


def fleet_sub(args, cwd, timeout=FLEET_SUB_TIMEOUT_S, **env):
    """A CLI session on a spawned process (a fault that hangs a thread
    must not outlive its session in this one): ``(rc, stdout, stderr,
    seconds)``."""
    e = dict(os.environ, **env)
    e["PYTHONPATH"] = os.pathsep.join(
        [HERE] + ([e["PYTHONPATH"]] if e.get("PYTHONPATH") else []))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "iterative_cleaner_torch",
                          *args], cwd=cwd, env=e, capture_output=True,
                         text=True, timeout=timeout)
    return out.returncode, out.stdout, out.stderr, time.perf_counter() - t0


def out_mask(link):
    from iterative_cleaner_torch.io import load_archive

    return load_archive(link + "_cleaned.sf").weights == 0


def masks_off(links, seq_masks) -> int:
    """Mask cells of the outputs beside ``links`` that differ from the
    sequential session's (by file name); a missing output counts all."""
    n = 0
    for p in links:
        want = seq_masks[os.path.basename(p)]
        if not os.path.exists(p + "_cleaned.sf"):
            n += int(want.size)
            continue
        n += int((out_mask(p) != want).sum())
    return n


def entry_diff(got, want, rtol):
    """Fields of two run-report entries that differ: exactly for
    integers, bools and strings, within ``rtol`` for floats (0: exact)."""
    bad = []

    def walk(a, b, where):
        if isinstance(a, dict) and isinstance(b, dict):
            if set(a) != set(b):
                bad.append(where + ":keys")
            for k in set(a) & set(b):
                walk(a[k], b[k], f"{where}.{k}")
        elif isinstance(a, list) and isinstance(b, list):
            if len(a) != len(b):
                bad.append(where + ":len")
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, f"{where}[{i}]")
        elif isinstance(a, float) or isinstance(b, float):
            x, y = float(a), float(b)
            if not (x == y or (math.isnan(x) and math.isnan(y))
                    or abs(x - y) <= rtol * max(abs(x), abs(y))):
                bad.append(where)
        elif a != b:
            bad.append(where)

    walk({k: v for k, v in got.items() if k != "path"},
         {k: v for k, v in want.items() if k != "path"}, "entry")
    return bad


def fleet_f1(paths, work, tag):
    """(f1): the mixed fleet through the sequential session, ``--batch
    FLEET_GROUP`` and ``--fleet --batch FLEET_GROUP --bucket-pad
    FLEET_PAD``, in the rounds of FLEET_ORDERS (the sessions share one
    process, its page cache and its allocator, so each session runs early
    in one round and late in the other); every fleet session's output
    masks and report entries held to the first sequential session's, each
    group's launches to its batch iterations.  Returns the sequential
    masks by file name."""
    from iterative_cleaner_torch.engine.loop import ROUTE_KERNELS
    from iterative_cleaner_torch.io import peek_shape
    from iterative_cleaner_torch.parallel.fleet import plan_fleet

    extras = {"sequential": [],
              "batch": ["--batch", str(FLEET_GROUP)],
              "fleet": ["--fleet", "--batch", str(FLEET_GROUP),
                        "--bucket-pad", FLEET_PAD]}
    runs = []          # (round, session, links, doc, seconds, counts)
    for rnd, order in enumerate(FLEET_ORDERS):
        for run in order:
            d = os.path.join(work, f"{run}{rnd}")
            links = linked(paths, d)
            rc, doc, secs, counts = cli_session(links, d, extras[run])
            if rc != 0:
                fail(f"fleet (f1): the {run} session of round {rnd} exited "
                     f"{rc}")
            runs.append((rnd, run, links, doc, secs, counts))
    _, _, seq_links, seq_doc, _, _ = next(r for r in runs
                                          if r[1] == "sequential")
    seq_masks = {os.path.basename(p): out_mask(p) for p in seq_links}
    SEQ_ENTRIES.update((os.path.basename(en["path"]), en)
                       for en in seq_doc["archives"])
    seq_entries = {os.path.basename(e["path"]): e
                   for e in seq_doc["archives"]}
    # each batch's launches: once per batch iteration, the iterations of
    # its slowest archive; a group is one raw geometry (the port pads no
    # cell, parallel/fleet.py item 4)
    plan = plan_fleet([(p, peek_shape(p)) for p in paths],
                      group_size=FLEET_GROUP)
    bad = []
    for rnd, run, links, doc, secs, counts in runs:
        if run != "fleet":
            continue
        n_mask = masks_off(links, seq_masks)
        n_entry = sum(bool(entry_diff(e, seq_entries[os.path.basename(
            e["path"])], 0.0)) for e in doc["archives"])
        loops = {os.path.basename(e["path"]): e["loops"]
                 for e in doc["archives"]}
        iters = sum(max(loops[os.path.basename(it.path)] for it in g)
                    for b in plan.buckets for g in b.groups())
        want = {k: (iters if k in ROUTE_KERNELS["default"] else 0)
                for k in counts}
        c = doc["counters"]
        stall = doc["histograms"].get("fleet_load_stall_s", {}).get(
            "sum", 0.0)
        print(f"fleet (f1) round {rnd}: --fleet --batch {FLEET_GROUP} "
              f"--bucket-pad {FLEET_PAD} over {len(paths)} PSRFITS files "
              f"({', '.join(f'{n} of {s}' for s, n in FLEET_MIX)}, "
              f"interleaved): {plan.n_groups} groups in "
              f"{len(plan.buckets)} buckets; against the first sequential "
              f"session {n_mask} mask cells and {n_entry} report entries "
              f"differ (tolerance 0 and 0); kernels {json.dumps(counts)} "
              f"for {iters} batch iterations; fleet_load_stall_s "
              f"{stall:.4f}, fleet_precompile_hits "
              f"{c.get('fleet_precompile_hits', 0):g}, misses "
              f"{c.get('fleet_precompile_misses', 0):g} {tag}", flush=True)
        if n_mask or n_entry or counts != want \
                or c.get("fleet_cleaned") != len(paths):
            bad.append(f"round {rnd}: launches {counts}, want {want}, "
                       f"{n_mask} mask cells, {n_entry} entries")
    print("fleet (f1) seconds (host clock, one process, in the order they "
          "ran): " + "; ".join(
              f"round {rnd} " + ", ".join(f"{run} {secs:.3f} s"
                                          for r2, run, _, _, secs, _ in runs
                                          if r2 == rnd)
              for rnd in range(len(FLEET_ORDERS))) + f" {tag}", flush=True)
    if bad:
        fail(f"fleet (f1): the fleet session differs from the sequential "
             f"one: {bad}")
    return seq_masks


def fleet_f2(small, seq_masks, work, tag):
    """(f2): the ladder by the injector, on a spawned process (the hung
    attempt's thread must not outlive its session in this one)."""
    small = small[:FLEET_DRILL_N]
    d = os.path.join(work, "drill")
    links = linked(small, d)
    rc, out, err, secs = fleet_sub(
        ["-q", "-l", "--fleet", "--batch", "2", "--faults", FLEET_DRILL,
         "--stage-timeout", str(FLEET_STAGE_TIMEOUT_S), "--io-workers", "1",
         "--metrics-json", "run.json", *links], d,
        ICLEAN_FAULT_HANG_S="3600")
    doc = json.load(open(os.path.join(d, "run.json")))
    c = doc["counters"]
    failed = [os.path.basename(p) for p in links
              if not os.path.exists(p + "_cleaned.sf")]
    done = [p for p in links if os.path.exists(p + "_cleaned.sf")]
    n_mask = masks_off(done, seq_masks)
    print(f"fleet (f2): --faults {FLEET_DRILL} --stage-timeout "
          f"{FLEET_STAGE_TIMEOUT_S:g} over {len(links)} archives in groups "
          f"of 2: exit {rc}, failed {failed}; fleet_retries "
          f"{c.get('fleet_retries', 0):g}, fleet_oom_splits "
          f"{c.get('fleet_oom_splits', 0):g}, fleet_watchdog_trips "
          f"{c.get('fleet_watchdog_trips', 0):g}, fault_injected "
          f"{c.get('fault_injected', 0):g}; {len(done)} outputs, {n_mask} "
          f"mask cells off the sequential session's (tolerance 0); "
          f"{secs:.1f} s with start-up {tag}", flush=True)
    if rc != 1 or len(failed) != 1 or n_mask \
            or c.get("fleet_watchdog_trips") != 1 \
            or c.get("fleet_oom_splits", 0) < 1 \
            or c.get("fleet_retries", 0) < 2:
        fail(f"fleet (f2): the drill did not take the ladder: {err[-3000:]}")


def fleet_oom_worker(paths, small):
    """(f3) on a spawned process: ``paths`` (FLEET_OOM_N 256 x 1024 x 128
    archives) cleaned one by one, then their batch's reserved peaks at 2
    and at FLEET_OOM_N measured; the card capped (set_per_process_memory_
    fraction) between them and the fleet run at FLEET_OOM_N a group; then
    capped below one ``small`` archive's peak and ``small`` run alone,
    which must fail with its OOM error.  Returns what the parent
    checks."""
    import torch

    sys.path.insert(0, HERE)
    from iterative_cleaner_torch import CleanConfig
    from iterative_cleaner_torch.backends import clean_archive
    from iterative_cleaner_torch.io import load_archive
    from iterative_cleaner_torch.parallel.batch import clean_archives_batched
    from iterative_cleaner_torch.parallel.fleet import clean_fleet
    from iterative_cleaner_torch.resilience import OOM, classify_error
    from iterative_cleaner_torch.telemetry.registry import MetricsRegistry

    cfg = CleanConfig()
    ars = [load_archive(p) for p in paths]
    singles = [clean_archive(a, cfg).final_weights == 0 for a in ars]

    def reserved_peak(fn):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        return torch.cuda.max_memory_reserved()

    p2 = reserved_peak(lambda: clean_archives_batched(ars[:2], cfg))
    p8 = reserved_peak(lambda: clean_archives_batched(ars, cfg))
    total = torch.cuda.get_device_properties(0).total_memory
    cap = p2 + 0.15 * (p8 - p2)
    torch.cuda.empty_cache()
    torch.cuda.set_per_process_memory_fraction(cap / total)
    reg = MetricsRegistry()
    rep = clean_fleet(paths, dataclasses.replace(
        cfg, fleet_group_size=FLEET_OOM_N), registry=reg)
    got = [rep.results[p].final_weights == 0 if p in rep.results else None
           for p in paths]
    off = [None if g is None else int((g != s).sum())
           for g, s in zip(got, singles)]
    # one archive that does not fit: its peak, then a cap below it
    torch.cuda.set_per_process_memory_fraction(1.0)
    ar_s = load_archive(small)
    p1 = reserved_peak(lambda: clean_archives_batched([ar_s], cfg))
    torch.cuda.empty_cache()
    torch.cuda.set_per_process_memory_fraction(0.5 * p1 / total)
    reg1 = MetricsRegistry()
    rep1 = clean_fleet([small], cfg, registry=reg1)
    torch.cuda.set_per_process_memory_fraction(1.0)
    return {"p2": p2, "p8": p8, "cap": cap, "p1": p1, "total": total,
            "failures": [(p, s, repr(e)) for p, s, e in rep.failures],
            "off": off, "counters": dict(reg.counters),
            "failures1": [(p, s, type(e).__name__, classify_error(e) == OOM)
                          for p, s, e in rep1.failures],
            "results1": len(rep1.results),
            "counters1": dict(reg1.counters)}


def fleet_f3(work, large, small, tag):
    """(f3): a real device OOM halving a group, then failing one archive
    that does not fit alone, on a spawned process (the cap must not leak).
    The group is FLEET_OOM_N links to the ``large`` files, each file under
    several names (distinct archives to the fleet)."""
    import multiprocessing

    d = os.path.join(work, "oom")
    os.makedirs(d)
    paths = []
    for i in range(FLEET_OOM_N):
        paths.append(os.path.join(d, f"oom{i:02d}.sf"))
        os.symlink(large[i % len(large)], paths[-1])
    t0 = time.perf_counter()
    with ProcessPoolExecutor(
            max_workers=1,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        r = pool.submit(fleet_oom_worker, paths, small).result(
            timeout=FLEET_SUB_TIMEOUT_S)
    secs = time.perf_counter() - t0
    c, c1 = r["counters"], r["counters1"]
    gib = 2 ** 30
    print(f"fleet (f3): reserved peak of a batch of 2 "
          f"{r['p2'] / gib:.2f} GiB, of {FLEET_OOM_N} {r['p8'] / gib:.2f} "
          f"GiB; capped at {r['cap'] / gib:.2f} GiB of "
          f"{r['total'] / gib:.1f}: fleet_oom_splits "
          f"{c.get('fleet_oom_splits', 0):g}, failures {r['failures']}, "
          f"mask cells off the single cleans {r['off']} (tolerance 0 "
          f"each); one 64 x 128 x 512 archive (peak {r['p1'] / gib:.3f} "
          f"GiB) capped at half of it: failures (path, stage, error, "
          f"classified OOM) {r['failures1']}, {r['results1']} results; "
          f"{secs:.1f} s with start-up {tag}", flush=True)
    if r["failures"] or any(o != 0 for o in r["off"]) \
            or c.get("fleet_oom_splits", 0) < 1 \
            or c.get("fault_injected", 0):
        fail("fleet (f3): a real OOM did not halve the group to bit-equal "
             "masks")
    if r["results1"] or [(f[1], f[3]) for f in r["failures1"]] != [
            ("clean", True)] or c1.get("fleet_oom_splits", 0):
        fail(f"fleet (f3): the archive that does not fit did not fail "
             f"with its OOM error: {r['failures1']}")


def fleet_f4(small, seq_masks, work, tag):
    """(f4): a --journal fleet killed with SIGKILL after its second
    journaled group, then --resume; no archive cleaned twice."""
    import signal

    small = small[:FLEET_KILL_N]
    d = os.path.join(work, "kill")
    links = linked(small, d)
    base = ["-q", "-l", "--fleet", "--batch", "2", "--io-workers", "1",
            "--journal", "j.jsonl"]
    e = dict(os.environ, ICLEAN_FAULT_HANG_S="3600")
    e["PYTHONPATH"] = os.pathsep.join(
        [HERE] + ([e["PYTHONPATH"]] if e.get("PYTHONPATH") else []))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "iterative_cleaner_torch", *base,
         "--faults", "load:hang@5", *links], cwd=d, env=e,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    jpath = os.path.join(d, "j.jsonl")
    deadline = time.time() + FLEET_SUB_TIMEOUT_S
    while time.time() < deadline:
        text = open(jpath).read() if os.path.exists(jpath) else ""
        if text.endswith("\n") and len(text.strip().splitlines()) >= 4:
            break
        if proc.poll() is not None:
            fail(f"fleet (f4): the journaled run exited early "
                 f"(rc {proc.returncode})")
        time.sleep(0.2)
    else:
        proc.kill()
        fail("fleet (f4): the journal showed no progress")
    os.kill(proc.pid, signal.SIGKILL)
    proc.wait(timeout=60)
    pre = len(open(jpath).read().strip().splitlines())
    rc, out, err, secs = fleet_sub(
        ["--fleet", "--batch", "2", "--io-workers", "1", "--journal",
         "j.jsonl", "--resume", "-l", *links], d)
    entries = [json.loads(ln) for ln in open(jpath).read().splitlines()
               if ln.strip()]
    done = [en["path"] for en in entries if en.get("event") == "done"]
    once = sorted(done) == sorted(os.path.abspath(p) for p in links)
    n_mask = masks_off(links, seq_masks)
    resumed = [ln for ln in out.splitlines() if ln.startswith("resumed:")]
    print(f"fleet (f4): SIGKILL after {pre} journaled archives, then "
          f"--resume: exit {rc}, {resumed}; done lines {len(done)} for "
          f"{len(links)} archives (each once: {once}); {n_mask} mask cells "
          f"off the sequential session's (tolerance 0); "
          f"{time.perf_counter() - t0:.1f} s with two start-ups {tag}",
          flush=True)
    if rc != 0 or not once or n_mask or not resumed \
            or f"resumed: {pre} archive" not in resumed[0]:
        fail(f"fleet (f4): kill and resume: {err[-3000:]}")
    keep_journal(jpath, "fleet_f4.jsonl")


def fleet_f5(work, tag):
    """(f5): FLEET_WARM_SHAPES' archives written to ``work``, then two
    --fleet sessions over them, each on a process of its own, with one
    fresh --compile-cache: the first builds the kernel library there
    (``nvcc`` once, on its warm-up, while its first loads go on), the
    second builds nothing, every bucket a precompile hit, the masks the
    first session's."""
    from iterative_cleaner_torch.io import save_archive

    cache = os.path.join(work, "kcache")
    links, secs, docs = [], [], []
    for n, name in enumerate(("warm_cold", "warm_warm")):
        d = os.path.join(work, name)
        if n == 0:
            os.makedirs(d)
            for i, shape in enumerate(FLEET_WARM_SHAPES * 2):
                links.append(os.path.join(d, f"warm{i:02d}.sf"))
                save_archive(batch_small_archive(500 + i, shape), links[-1])
            here = links
        else:
            here = linked(links, d)
        rc, out, err, t = fleet_sub(
            ["-q", "-l", "--fleet", "--batch", str(FLEET_GROUP),
             "--compile-cache", cache, "--metrics-json", "run.json", *here],
            d)
        if rc != 0:
            fail(f"fleet (f5): the {name} session exited {rc}: "
                 f"{err[-3000:]}")
        secs.append(t)
        docs.append(json.load(open(os.path.join(d, "run.json"))))
        if n:
            n_mask = sum(int((out_mask(a) != out_mask(b)).sum())
                         for a, b in zip(links, here))
    (c0, h0), c1 = (docs[0]["counters"], docs[0]["histograms"]), \
        docs[1]["counters"]
    warm_up = h0.get("batch_precompile_s", {}).get("sum", 0.0)
    stall = h0.get("fleet_load_stall_s", {}).get("sum", 0.0)
    n_buckets = len(FLEET_WARM_SHAPES)
    print(f"fleet (f5): --compile-cache over {len(links)} archives in "
          f"{n_buckets} buckets: cold kernel_library_builds "
          f"{c0.get('kernel_library_builds', 0):g} (on the warm-up "
          f"{c0.get('fleet_precompile_builds', 0):g}), warm-up "
          f"{warm_up:.2f} s, the serve loop's load waits after it "
          f"{stall:.4f} s; warm kernel_library_builds "
          f"{c1.get('kernel_library_builds', 0):g}, fleet_precompile_hits "
          f"{c1.get('fleet_precompile_hits', 0):g}, {n_mask} mask cells off "
          f"the cold session's (tolerance 0); sessions {secs[0]:.1f} s and "
          f"{secs[1]:.1f} s with start-up {tag}", flush=True)
    if c0.get("kernel_library_builds") != 1 \
            or c0.get("fleet_precompile_builds") != 1 \
            or c1.get("kernel_library_builds", 0) != 0 \
            or c1.get("fleet_precompile_hits") != n_buckets or n_mask:
        fail("fleet (f5): the warm restart built the library or missed a "
             "bucket")


def fleet_f6(paths, seq_masks, work, tag):
    """(f6): two host processes sharing one journal on this card."""
    d = os.path.join(work, "hosts")
    links = linked(paths, d)
    e = dict(os.environ)
    e["PYTHONPATH"] = os.pathsep.join(
        [HERE] + ([e["PYTHONPATH"]] if e.get("PYTHONPATH") else []))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "iterative_cleaner_torch", "--fleet",
         "--batch", str(FLEET_GROUP), "--hosts", "2", "--host-id", str(h),
         "--journal", "shared.jsonl", "--claim-ttl", "30", "-l",
         "--metrics-json", f"run{h}.json", *links], cwd=d, env=e,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for h in (0, 1)]
    outs = [p.communicate(timeout=FLEET_SUB_TIMEOUT_S) for p in procs]
    secs = time.perf_counter() - t0
    rcs = [p.returncode for p in procs]
    lines = [next((ln for ln in o.splitlines() if ln.startswith("host ")),
                  "") for o, _ in outs]
    cleaned = [json.load(open(os.path.join(d, f"run{h}.json")))["counters"]
               .get("fleet_cleaned", 0) for h in (0, 1)]
    entries = [json.loads(ln) for ln in
               open(os.path.join(d, "shared.jsonl")).read().splitlines()
               if ln.strip()]
    done = [en["path"] for en in entries if en.get("event") == "done"]
    once = sorted(done) == sorted(os.path.abspath(p) for p in links)
    n_mask = masks_off(links, seq_masks)
    print(f"fleet (f6): two hosts over one journal: exits {rcs}; {lines}; "
          f"fleet_cleaned {cleaned} (sum {sum(cleaned):g} of "
          f"{len(links)}); done lines {len(done)}, each archive once: "
          f"{once}; {n_mask} mask cells off the sequential session's "
          f"(tolerance 0); {secs:.1f} s for both processes {tag}",
          flush=True)
    if rcs != [0, 0] or not once or sum(cleaned) != len(links) or n_mask:
        fail(f"fleet (f6): two hosts: {[err[-2000:] for _, err in outs]}")
    keep_journal(os.path.join(d, "shared.jsonl"), "fleet_f6.jsonl")


def fleet_phases(work, files, tag):
    """The fleet phases (f1)-(f6) in ``work``: ``files`` is the future of
    :func:`fleet_files` (written on a worker process while the earlier
    phases ran).  (f1) first, alone; then (f2), (f3), (f4) and (f6), each
    on processes of its own over its own links, at once, and (f5), the
    mesh fleet (m5) and the coordinator hosts (m6) once (f2) is done.
    Prints their seconds."""
    t_all = time.perf_counter()
    paths, shapes = files.result(timeout=FLEET_SUB_TIMEOUT_S)
    timings = {}
    t0 = time.perf_counter()
    seq_masks = fleet_f1(paths, work, tag)
    timings["f1"] = time.perf_counter() - t0
    small = [p for p in paths if shapes[p] == (64, 128, 512)]
    large = [p for p in paths if shapes[p] == (256, 1024, 128)]

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        fn(*args)
        return name, time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=7) as pool:
        f2 = pool.submit(timed, "f2", fleet_f2, small, seq_masks, work, tag)

        def after_f2(name, fn, *args):
            # (f5)'s nvcc build and the multi-process fleets of (m5) and
            # (m6) load every core: they start once (f2)'s watchdog drill
            # is over, so its executes stay inside its stage timeout
            wait([f2])
            return timed(name, fn, *args)

        futs = [f2,
                pool.submit(timed, "f3", fleet_f3, work, large, small[0],
                            tag),
                pool.submit(timed, "f4", fleet_f4, small, seq_masks, work,
                            tag),
                pool.submit(after_f2, "f5", fleet_f5, work, tag),
                pool.submit(timed, "f6", fleet_f6, paths, seq_masks, work,
                            tag),
                pool.submit(after_f2, "m5", fleet_m5, small, seq_masks,
                            SEQ_ENTRIES, work, tag),
                pool.submit(after_f2, "m6", fleet_m6,
                            small + [p for p in paths
                                     if shapes[p] == (64, 120, 512)],
                            work, tag)]
        # a phase's fail() raises SystemExit on its thread: result()
        # raises it here
        timings.update(f.result() for f in futs)
    print(f"fleet phases: {time.perf_counter() - t_all:.1f} s in all ("
          + ", ".join(f"{k} {v:.1f} s" for k, v in sorted(timings.items()))
          + f"; f2, f3, f4 and f6 at once, f5, m5 and m6 after f2) {tag}",
          flush=True)


# ---- the multi-process and float64-mesh phases: m2-m6 -------------------
# (m2) four gloo ranks on the card (2 x 2) cleaning a float64 archive of
# the streamed shard phase's shape whole and streamed at budget 0; (m3)
# batch (a)'s archives in float64; (m4) the hybrid batch-cell mesh on four
# gloo ranks (batch 2 x a 1 x 2 cell mesh) over HYBRID_ARCHIVES archives of
# BATCH_SHAPE (one pad slot), float32 and float64; (m5) --fleet --mesh
# batch as two gloo-backed ranks on the card over (f1)'s small archives
# with one seeded load fault; (m6) two --coordinator hosts over one
# journal, one process a host, then two torchrun ranks a host on the card.
HYBRID_ARCHIVES, HYBRID_BATCH = 3, 2
FLEET_MESH_RANKS, FLEET_MESH_FAULT = 2, "load:perm@3"
MESH_PHASE_TIMEOUT_S = 300


def gloo_f64_rank():
    """One of the GLOO_RANKS ranks of (m2), started by ``run_local_ranks``
    with gloo on cuda:0: the SHARD_STREAM_ARCHIVE in float64 through
    ``clean_archive_sharded`` and through the exact stream at budget 0 in
    SHARD_STREAM_CHUNK-subint tiles, over the 2 x 2 mesh.  Returns its
    counts, times and (rank 0) the results."""
    import torch

    from iterative_cleaner_torch import CleanConfig, clean_streaming
    from iterative_cleaner_torch.backends import clean_archive_sharded
    from iterative_cleaner_torch.io.synthetic import make_synthetic_archive
    from iterative_cleaner_torch.parallel.mesh import cell_mesh
    from iterative_cleaner_torch.stats import kernels as K

    ar, _ = make_synthetic_archive(**SHARD_STREAM_ARCHIVE)
    mesh = cell_mesh()
    out = {"rank": mesh.rank, "coords": mesh.coords}
    for run, fn in (
            ("whole", lambda: clean_archive_sharded(
                ar, CleanConfig(device="cuda:0", dtype="float64"), mesh)),
            ("stream", lambda: clean_streaming(
                ar, SHARD_STREAM_CHUNK,
                CleanConfig(device="cuda:0", dtype="float64",
                            stream_hbm_mb=0), mesh))):
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        out[run] = fn()
        torch.cuda.synchronize()
        out[run + "_ms"] = (time.perf_counter() - t0) * 1e3
        out[run + "_counts"] = {k: v for k, v in K.launch_counts().items()
                                if v}
    return out


def gloo_hybrid_rank(seeds):
    """One of the four ranks of (m4), started by ``run_local_ranks`` with
    gloo on cuda:0: the small archives of ``seeds`` through
    ``clean_archives_hybrid`` over ``hybrid_batch_cell_mesh(HYBRID_BATCH)``
    in float32 and float64.  Returns its slot, cell coordinates, counts
    and (rank 0) the results."""
    import torch

    from iterative_cleaner_torch import CleanConfig
    from iterative_cleaner_torch.parallel import (
        clean_archives_hybrid,
        hybrid_batch_cell_mesh,
    )
    from iterative_cleaner_torch.stats import kernels as K

    ars = [batch_small_archive(sd) for sd in seeds]
    mesh = hybrid_batch_cell_mesh(HYBRID_BATCH)
    out = {"shape": mesh.shape, "slot": mesh.slot,
           "coords": mesh.cells.coords}
    for dtype in ("float32", "float64"):
        K.reset_launch_counts()
        t0 = time.perf_counter()
        out[dtype] = clean_archives_hybrid(
            ars, CleanConfig(device="cuda:0", dtype=dtype), mesh)
        torch.cuda.synchronize()
        out[dtype + "_ms"] = (time.perf_counter() - t0) * 1e3
        out[dtype + "_counts"] = {k: v for k, v in K.launch_counts().items()
                                  if v}
    return out


def gloo_fleet_rank(paths, faults):
    """One of the FLEET_MESH_RANKS ranks of (m5), started by
    ``run_local_ranks`` with gloo on cuda:0: ``clean_fleet`` over the
    ('batch',) mesh of the ranks, the seeded ``faults`` on rank 0, groups
    of FLEET_GROUP.  Returns its report as plain data: each result's
    mask, each failure's path, stage and error type."""
    from iterative_cleaner_torch import CleanConfig
    from iterative_cleaner_torch.parallel.fleet import clean_fleet
    from iterative_cleaner_torch.parallel.mesh import batch_mesh
    from iterative_cleaner_torch.resilience import (
        FaultInjector,
        ResiliencePlan,
    )

    mesh = batch_mesh()
    report = clean_fleet(
        paths, CleanConfig(device="cuda:0", fleet_group_size=FLEET_GROUP),
        mesh=mesh, io_workers=1,
        resilience=ResiliencePlan(faults=FaultInjector(faults, seed=0)))
    return {"rank": mesh.rank,
            "masks": {os.path.basename(p): r.final_weights == 0
                      for p, r in report.results.items()},
            "failures": sorted((os.path.basename(p), st, type(e).__name__)
                               for p, st, e in report.failures)}


def multiprocess_phases(batch_ars, counts, clean_ms, tag):
    """(m2)-(m4): the float64 cell mesh on four gloo ranks, batch (a) in
    float64, the hybrid batch-cell mesh; see the comment above
    HYBRID_ARCHIVES.  Prints each phase's seconds."""
    import torch

    from iterative_cleaner_torch import CleanConfig, clean_streaming
    from iterative_cleaner_torch.backends import clean_archive
    from iterative_cleaner_torch.engine.loop import (
        ROUTE_KERNELS,
        SHARD_KERNELS,
        STREAM_KERNELS,
        storage_kernels,
    )
    from iterative_cleaner_torch.io.synthetic import make_synthetic_archive
    from iterative_cleaner_torch.parallel import distributed
    from iterative_cleaner_torch.parallel.batch import clean_archives_batched
    from iterative_cleaner_torch.stats import kernels as K

    f64 = lambda ks: storage_kernels(ks, "float32", "float64")  # noqa: E731

    # ---- (m2) four gloo ranks, float64, whole and streamed
    t_phase = time.perf_counter()
    ar_s, _ = make_synthetic_archive(**SHARD_STREAM_ARCHIVE)
    single = clean_archive(ar_s, CleanConfig(dtype="float64"))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="icln_chip_smoke_ranks_") as wd:
        try:
            ranks = distributed.run_local_ranks(
                gloo_f64_rank, GLOO_RANKS, (), workdir=wd, device="cuda:0",
                backend="gloo", timeout_s=GLOO_TIMEOUT_S)
        except (RuntimeError, TimeoutError) as exc:
            fail(f"float64 (m2) gloo: {exc}")
    n_tiles = -(-ar_s.nsub // SHARD_STREAM_CHUNK)
    shape_s = tuple(SHARD_STREAM_ARCHIVE[k] for k in ("nsub", "nchan",
                                                      "nbin"))
    bad = []
    for run in ("whole", "stream"):
        r = ranks[0][run]
        if run == "whole":
            want = {k: r.loops for k in f64(SHARD_KERNELS["default"])}
        else:
            full = {k: 0 for k in K.launch_counts()}
            full.update(ranks[0]["stream_counts"])
            want = {k: v for k, v in stream_counts(
                f64(STREAM_KERNELS["default"]), full, r.loops,
                n_tiles).items() if v}
        for rk in ranks:
            print(f"float64 (m2) {run} rank {rk['rank']} "
                  f"{tuple(rk['coords'])}: kernels "
                  f"{json.dumps(rk[run + '_counts'])}, "
                  f"{rk[run + '_ms']:.1f} ms {tag}", flush=True)
            if rk[run + "_counts"] != want:
                bad.append(f"{run} rank {rk['rank']} launches "
                           f"{rk[run + '_counts']}, want {want}")
        n_mask = int(((r.final_weights == 0)
                      != (single.final_weights == 0)).sum())
        print(f"float64 (m2) {run} over {GLOO_RANKS} gloo ranks, {shape_s}"
              f"{'' if run == 'whole' else f' in tiles of {SHARD_STREAM_CHUNK} at budget 0'}"
              f": {r.loops} loops (single {single.loops}); against the "
              f"single-card float64 clean {n_mask} mask cells differ "
              f"(tolerance: 0), {int((single.final_weights == 0).sum())} "
              f"zapped {tag}", flush=True)
        if n_mask or r.loops != single.loops \
                or r.final_weights.dtype != np.float64:
            bad.append(f"{run}: {n_mask} mask cells, loops {r.loops}")
    if bad or any(rk["whole"] is not None for rk in ranks[1:]):
        fail(f"float64 (m2): {bad}")
    print(f"float64 phase (m2), four gloo ranks: "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)

    # ---- (m3) batch (a) in float64
    t_phase = time.perf_counter()
    cfg = CleanConfig(dtype="float64")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    got = clean_archives_batched(batch_ars, cfg)
    torch.cuda.synchronize()
    clean_ms["f64 batch"] = (time.perf_counter() - t0) * 1e3
    counts["f64 batch"] = K.launch_counts()
    t0 = time.perf_counter()
    want = [clean_archive(a, cfg) for a in batch_ars]
    torch.cuda.synchronize()
    single_ms = (time.perf_counter() - t0) * 1e3
    iters = max(g.loops for g in got)
    want_counts = {k: (iters if k in f64(ROUTE_KERNELS["default"]) else 0)
                   for k in counts["f64 batch"]}
    print(f"float64 (m3) batch (a): {len(batch_ars)} archives of "
          f"{BATCH_SHAPE} in float64, kernels "
          f"{json.dumps({k: v for k, v in counts['f64 batch'].items() if v})}"
          f" (want each float64 build once per batch iteration, {iters}); "
          f"whole batch clean {clean_ms['f64 batch']:.1f} ms against "
          f"{single_ms:.1f} ms for the single float64 cleans (host clock) "
          f"{tag}", flush=True)
    if counts["f64 batch"] != want_counts:
        fail(f"float64 (m3): launch counts {counts['f64 batch']}, want "
             f"{want_counts}")
    if any(g.scores.dtype != np.float64 for g in got):
        fail("float64 (m3): the batch's scores are not float64")
    batch_vs_single("float64 (m3) batch (a)", got, want, tag)
    print(f"float64 phase (m3), batch (a) in float64: "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)

    # ---- (m4) the hybrid batch-cell mesh on four gloo ranks
    t_phase = time.perf_counter()
    seeds = list(BATCH_SEEDS)[:HYBRID_ARCHIVES]
    with tempfile.TemporaryDirectory(prefix="icln_chip_smoke_ranks_") as wd:
        try:
            ranks = distributed.run_local_ranks(
                gloo_hybrid_rank, GLOO_RANKS, (seeds,), workdir=wd,
                device="cuda:0", backend="gloo", timeout_s=GLOO_TIMEOUT_S)
        except (RuntimeError, TimeoutError) as exc:
            fail(f"hybrid (m4): {exc}")
    bad = []
    for dtype in ("float32", "float64"):
        singles = [clean_archive(batch_ars[i], CleanConfig(dtype=dtype))
                   for i in range(HYBRID_ARCHIVES)]
        res = ranks[0][dtype]
        n_mask = sum(int(((g.final_weights == 0)
                          != (w.final_weights == 0)).sum())
                     + int(g.loops != w.loops) for g, w in zip(res, singles))
        for rk in ranks:
            print(f"hybrid (m4) {dtype} rank slot {rk['slot']} cells "
                  f"{tuple(rk['coords'])}: kernels "
                  f"{json.dumps(rk[dtype + '_counts'])}, "
                  f"{rk[dtype + '_ms']:.1f} ms {tag}", flush=True)
        print(f"hybrid (m4) {dtype}: mesh {ranks[0]['shape']}, "
              f"{HYBRID_ARCHIVES} archives of {BATCH_SHAPE} (one pad slot), "
              f"{len(res)} results on rank 0, loops "
              f"{[g.loops for g in res]}; against the single {dtype} cleans "
              f"{n_mask} mask cells or loop counts differ (tolerance: 0) "
              f"{tag}", flush=True)
        if len(res) != HYBRID_ARCHIVES or n_mask \
                or any(g.final_weights.dtype != np.dtype(dtype) for g in res):
            bad.append(dtype)
    if bad or [rk["shape"] for rk in ranks] != [(2, 1, 2)] * 4 \
            or any(rk["float32"] is not None for rk in ranks[1:]):
        fail(f"hybrid (m4): {bad}")
    print(f"phase (m4), the hybrid mesh: {time.perf_counter() - t_phase:.1f} "
          f"s", flush=True)


def fleet_m5(paths, seq_masks, seq_entries, work, tag):
    """(m5): ``--fleet --mesh batch`` over (f1)'s small archives with one
    seeded load fault, as FLEET_MESH_RANKS ranks on the card under
    ``torch.distributed.run`` (rank 0 writes; masks and report entries
    held to the sequential session's), then ``clean_fleet`` over as many
    gloo ranks, every rank's report the same."""
    from iterative_cleaner_torch.parallel import distributed

    d = os.path.join(work, "mesh")
    links = linked(paths, d)
    e = dict(os.environ)
    e["PYTHONPATH"] = os.pathsep.join(
        [HERE] + ([e["PYTHONPATH"]] if e.get("PYTHONPATH") else []))
    t0 = time.perf_counter()
    try:
        out = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", str(FLEET_MESH_RANKS), "-m",
             "iterative_cleaner_torch", "--device", "cuda:0", "--fleet",
             "--mesh", "batch", "--batch", str(FLEET_GROUP),
             "--io-workers", "1", "--faults", FLEET_MESH_FAULT, "-l",
             "--metrics-json", "run.json", *links], cwd=d, env=e,
            capture_output=True, text=True, timeout=MESH_PHASE_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        fail(f"fleet (m5): --fleet --mesh batch ran past "
             f"{MESH_PHASE_TIMEOUT_S} s")
    cli_s = time.perf_counter() - t0
    doc = json.load(open(os.path.join(d, "run.json")))
    missing = [p for p in links if not os.path.exists(p + "_cleaned.sf")]
    n_mask = sum(int((out_mask(p) != seq_masks[os.path.basename(p)]).sum())
                 for p in links if p not in missing)
    n_entry = sum(bool(entry_diff(en, seq_entries[os.path.basename(
        en["path"])], 0.0)) for en in doc["archives"])
    errors = [ln for ln in out.stderr.splitlines() if ln.startswith("ERROR")]
    print(f"fleet (m5) --fleet --mesh batch --batch {FLEET_GROUP} on "
          f"{FLEET_MESH_RANKS} ranks (gloo side groups), {len(links)} "
          f"archives, --faults {FLEET_MESH_FAULT}: exit {out.returncode}, "
          f"{len(missing)} archive without output, {len(errors)} error "
          f"line(s) {errors}; against the sequential session {n_mask} mask "
          f"cells and {n_entry} report entries differ (tolerance 0 and 0); "
          f"fleet_cleaned {doc['counters'].get('fleet_cleaned', 0):g}, "
          f"archives_failed {doc['counters'].get('archives_failed', 0):g}; "
          f"{cli_s:.1f} s {tag}", flush=True)
    if out.returncode != 1 or len(missing) != 1 or len(errors) != 1 \
            or n_mask or n_entry \
            or len(doc["archives"]) != len(links) - 1:
        fail(f"fleet (m5): the CLI mesh fleet differs: "
             f"{out.stderr[-3000:]}")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="icln_chip_smoke_ranks_") as wd:
        try:
            ranks = distributed.run_local_ranks(
                gloo_fleet_rank, FLEET_MESH_RANKS, (links, FLEET_MESH_FAULT),
                workdir=wd, device="cuda:0", backend="gloo",
                timeout_s=MESH_PHASE_TIMEOUT_S)
        except (RuntimeError, TimeoutError) as exc:
            fail(f"fleet (m5) gloo ranks: {exc}")
    n_mask = sum(int((m != seq_masks[name]).sum())
                 for rk in ranks for name, m in rk["masks"].items())
    print(f"fleet (m5) clean_fleet over {FLEET_MESH_RANKS} gloo ranks: "
          f"failures by rank {[rk['failures'] for rk in ranks]}, results by "
          f"rank {[len(rk['masks']) for rk in ranks]}; {n_mask} mask cells "
          f"off the sequential session's (tolerance 0); "
          f"{time.perf_counter() - t0:.1f} s {tag}", flush=True)
    fails = [rk["failures"] for rk in ranks]
    if n_mask or len(fails[0]) != 1 or any(f != fails[0] for f in fails) \
            or fails[0][0][0] != os.path.basename(missing[0]) \
            or any(set(rk["masks"]) != set(ranks[0]["masks"])
                   for rk in ranks):
        fail("fleet (m5): the ranks' reports differ")


def fleet_m6(paths, work, tag):
    """(m6): two ``--hosts 2 --coordinator`` hosts over one journal, first
    one process a host, then two ``torch.distributed.run`` ranks a host on
    the card (``--mesh batch``: each host's groups split over its ranks);
    every counter the coordinator's reduction sums equal in both reports
    to the hosts' sum (the fleet counters as the journal's per-host stats
    fold them, the archive counters from the hosts' event logs and the
    outputs)."""
    import socket

    from iterative_cleaner_torch.io import load_archive
    from iterative_cleaner_torch.resilience import FleetJournal
    from iterative_cleaner_torch.telemetry.run import _AGGREGATED_COUNTERS

    e = dict(os.environ)
    e["PYTHONPATH"] = os.pathsep.join(
        [HERE] + ([e["PYTHONPATH"]] if e.get("PYTHONPATH") else []))
    torchrun = [sys.executable, "-m", "torch.distributed.run",
                "--standalone", "--nproc_per_node", "2"]
    forms = [("one process a host", "coordinator", [sys.executable], []),
             ("two ranks a host", "coordinator_mesh", torchrun,
              ["--mesh", "batch", "--device", "cuda:0", "--io-workers",
               "1"])]
    for form, sub, launch, extra in forms:
        d = os.path.join(work, sub)
        links = linked(paths, d)
        with socket.socket() as sk:
            sk.bind(("127.0.0.1", 0))
            port = sk.getsockname()[1]
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            launch + ["-m", "iterative_cleaner_torch", "--fleet",
                      "--batch", str(FLEET_GROUP), "--hosts", "2",
                      "--host-id", str(h), "--coordinator",
                      f"127.0.0.1:{port}", "--journal", "shared.jsonl",
                      "--claim-ttl", "30", "-l", "-q", "--metrics-json",
                      f"run{h}.json", "--event-log", f"events{h}.jsonl",
                      *extra, *links], cwd=d, env=e,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for h in (0, 1)]
        try:
            outs = [p.communicate(timeout=MESH_PHASE_TIMEOUT_S)
                    for p in procs]
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            fail(f"fleet (m6) {form}: the coordinator hosts ran past "
                 f"{MESH_PHASE_TIMEOUT_S} s")
        secs = time.perf_counter() - t0
        rcs = [p.returncode for p in procs]
        if rcs != [0, 0]:
            fail(f"fleet (m6) {form}: exits {rcs}: "
                 f"{[err[-2000:] for _, err in outs]}")
        fold = FleetJournal(os.path.join(d, "shared.jsonl")).host_stats()
        share = {k: sum(float(fold[h].get(k, 0.0)) for h in fold)
                 for k in _AGGREGATED_COUNTERS if k.startswith("fleet_")}
        arch = [json.loads(ln) for h in (0, 1)
                for ln in open(os.path.join(d, f"events{h}.jsonl"))]
        arch = [a for a in arch if a.get("event") == "archive"]
        share.update(
            archives_cleaned=float(len(arch)),
            archives_converged=float(sum(a["converged"] for a in arch)),
            archives_failed=share["fleet_failures"],
            iterations_total=float(sum(a["loops"] for a in arch)),
            cells_zapped=float(sum(a["cells_zapped"] for a in arch)),
            cells_total=float(sum(load_archive(p).weights.size
                                  for p in links)))
        bad = []
        for h in (0, 1):
            c = json.load(open(os.path.join(d, f"run{h}.json")))["counters"]
            for k in _AGGREGATED_COUNTERS:
                if c.get(k, 0.0) != share[k]:
                    bad.append((h, k, c.get(k, 0.0), share[k]))
            if c.get("telemetry_degraded"):
                bad.append((h, "telemetry_degraded"))
        print(f"fleet (m6) two --coordinator hosts over one journal, "
              f"{form}, {len(links)} archives: exits {rcs}; the hosts' sums "
              f"{json.dumps(share)}; counters off the sums in the two "
              f"reports {bad} (tolerance: none); journal hosts "
              f"{sorted(fold)}; {secs:.1f} s {tag}", flush=True)
        if bad or sorted(fold) != [0, 1] \
                or share["archives_cleaned"] != len(links):
            fail(f"fleet (m6) {form}: the coordinator's counters are not "
                 f"the hosts' sums: {bad}")


def control_plane_phase(dev, tag):
    """(c1) ``--selfcheck --format json`` on a spawned process on the
    card; (c2) ``--journal-fsck`` over the kept fleet and serve journals;
    (c3) a host sync seeded into the online step, caught on the card."""
    from iterative_cleaner_torch.analysis import card_contracts as cc

    t_all = time.perf_counter()
    e = dict(os.environ)
    e["PYTHONPATH"] = os.pathsep.join(
        [HERE] + ([e["PYTHONPATH"]] if e.get("PYTHONPATH") else []))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "iterative_cleaner_torch", "--selfcheck",
         "--format", "json"], cwd=HERE, env=e, capture_output=True,
        text=True, timeout=CONTROL_TIMEOUT_S)
    secs = time.perf_counter() - t0
    try:
        doc = json.loads(proc.stdout)
    except ValueError:
        fail(f"control (c1): --selfcheck printed no report (rc "
             f"{proc.returncode}):\n{proc.stdout[-3000:]}"
             f"{proc.stderr[-3000:]}")
    def num(x):
        return "-" if x is None else f"{x:g}"

    for c in doc["contracts"]:
        peak = c["peak_delta_bytes"] or 0
        print(f"control (c1) {c['program']}: {'ok' if c['ok'] else 'FAIL'}; "
              f"{c['iterations']} iteration(s); per iteration "
              f"{num(c['host_reads_per_iter'])} host reads "
              f"({num(c['sync_warnings_per_iter'])} sync warnings), "
              f"{num(c['ops_per_iter'])} aten ops, "
              f"{num(c['launches_per_iter'])} launches; peak {peak} B = "
              f"{peak / max(1, c['cube_bytes']):.3f} of the "
              f"{c['cube_bytes']} B cube; kernels "
              f"{json.dumps(c['kernel_launches'], sort_keys=True)} {tag}",
              flush=True)
        for v in c["violations"]:
            print(f"  {v['contract']}: {v['detail']}", flush=True)
    print(f"control (c1): --selfcheck on the card: exit "
          f"{proc.returncode}, ok {doc['ok']}, {doc['files_scanned']} files "
          f"linted, {len(doc['findings'])} findings, "
          f"{len(doc['suppressed'])} suppressed, {len(doc['contracts'])} "
          f"programs; {secs:.1f} s with the process start {tag}",
          flush=True)
    if proc.returncode != 0 or not doc["ok"] or doc["findings"] \
            or len(doc["contracts"]) != len(cc.HOT_PROGRAMS):
        fail(f"control (c1): --selfcheck: {proc.stderr[-3000:]}")
    # (c2) every journal the fleet (f4, f6) and serve phases left
    names = sorted(KEPT_JOURNALS)
    if names != ["fleet_f4.jsonl", "fleet_f6.jsonl", "serve.journal.jsonl"]:
        fail(f"control (c2): journals kept {names}")
    t0 = time.perf_counter()
    fsck = subprocess.run(
        [sys.executable, "-m", "iterative_cleaner_torch.analysis",
         "--format", "json"]
        + [a for n in names for a in ("--journal-fsck", KEPT_JOURNALS[n])],
        cwd=HERE, env=e, capture_output=True, text=True,
        timeout=CONTROL_TIMEOUT_S)
    fsck_s = time.perf_counter() - t0
    try:
        fdoc = json.loads(fsck.stdout)
    except ValueError:
        fail(f"control (c2): --journal-fsck printed no report (rc "
             f"{fsck.returncode}):\n{fsck.stdout[-3000:]}"
             f"{fsck.stderr[-3000:]}")
    for n, j in zip(names, fdoc["journals"]):
        print(f"control (c2) --journal-fsck {n}: ok {j['ok']}, "
              f"{j['n_lines']} lines {json.dumps(j['counts'], sort_keys=True)}"
              f", {len(j['errors'])} errors, warnings "
              f"{[w['kind'] for w in j['warnings']]} {tag}", flush=True)
        for err in j["errors"]:
            print(f"  line {err['line']}: {err['kind']}: {err['message']}",
                  flush=True)
    print(f"control (c2): exit {fsck.returncode}, {fsck_s:.1f} s with the "
          f"process start {tag}", flush=True)
    if fsck.returncode != 0 or not fdoc["ok"] \
            or any(w["kind"] != "torn-line" for j in fdoc["journals"]
                   for w in j["warnings"]):
        fail("control (c2): a fleet or serve journal failed its fsck")
    # (c3) the seeded host sync, in this process
    t0 = time.perf_counter()
    seeded = cc.verify_program(
        cc.seeded(cc.program_named("online_step"), "host-sync"), dev)
    caught = {v.contract for v in seeded.violations}
    print(f"control (c3): an .item() seeded into the online step: "
          f"violations {sorted(caught)}, {seeded.host_reads} host reads "
          f"counted, {seeded.sync_warnings} sync warnings; "
          f"{time.perf_counter() - t0:.1f} s {tag}", flush=True)
    if "no-host-sync" not in caught or seeded.host_reads != 1 \
            or seeded.sync_warnings != 1:
        fail("control (c3): the seeded host sync was not caught")
    print(f"control phases: {time.perf_counter() - t_all:.1f} s in all "
          f"{tag}", flush=True)


# ---- the long-profile phases (csrc/cell_fft.cu, the FFT build of the cell
# diagnostics past the DFT tables): L1-L3 ------------------------------

# The long-profile archive: a 3.75 s pulsar folded at 57 us a bin (65,536
# bins) in 32 subints of a minute over 256 channels, the golden's sample
# count; its cell diagnostics take the FFT build's cluster form.
LONG_PROFILE_SHAPE = (32, 256, 65536)
LONG_PROFILE_PERIOD_S = 3.75
# L1's shapes: (batch or 0, nsub, nchan, nbin) by storage; the fewest
# blocks a cell, the shape the entries are timed at, the radix-3 stage, a
# batch of two
# (cut to 8 x 32 cells where it had 16 x 64 when (L5) came: the same
# lengths and clusters, a quarter of the depth)
L1_SHAPES = {
    "float32": ((0, 8, 32, 32768), (0, 8, 32, 65536), (0, 8, 32, 24576),
                (2, 4, 32, 65536)),
    "bfloat16": ((0, 8, 32, 32768), (0, 8, 32, 65536), (0, 8, 32, 24576),
                 (2, 4, 32, 65536)),
    "float64": ((0, 8, 32, 16384), (0, 8, 32, 32768), (0, 8, 32, 24576),
                (2, 4, 32, 32768)),
}
# L2: the DFT route and the FFT build on the same inputs at these lengths
# (8 x 32 cells since (L5) came; 16 x 64 before)
L2_NBINS = (8192, 16384)
L2_CELLS = (8, 32)


def build_long_profile(out_dir):
    """The long-profile archive (``LONG_PROFILE_SHAPE``, seed 19, the
    golden's RFI density rules, float64, dispersed), its cube saved to
    ``out_dir`` as a ``.npy`` (run on a worker process); returns the path
    and the other fields."""
    import dataclasses as dc

    from iterative_cleaner_torch.io.synthetic import (
        bench_rfi_density,
        make_synthetic_archive,
    )

    nsub, nchan, nbin = LONG_PROFILE_SHAPE
    ar, _ = make_synthetic_archive(nsub=nsub, nchan=nchan, nbin=nbin,
                                   **bench_rfi_density(nsub, nchan),
                                   period_s=LONG_PROFILE_PERIOD_S, seed=19,
                                   dtype=np.float64, disperse=True)
    path = os.path.join(out_dir, "long_profile.npy")
    np.save(path, ar.data)
    return path, {f.name: getattr(ar, f.name) for f in dc.fields(ar)
                  if f.name != "data"}


def fft_operands(nb, nsub, nchan, nbin, storage, seed, dev):
    """Random FFT-build operands made with numpy: a cube with a pulse and
    a spike in ``storage`` (float32, bfloat16 or float64), template rows,
    Nyquist rows, a window, weights with zeros and their mask, the other
    operands in the arithmetic dtype; a batch of ``nb`` (0: one
    archive)."""
    import torch

    rng = np.random.default_rng(seed)
    real = torch.float64 if storage == "float64" else torch.float32
    lead = (nb,) if nb else ()
    ph = np.arange(nbin)
    t = np.exp(-0.5 * ((ph - nbin / 3) / (nbin / 64)) ** 2)
    cube = rng.standard_normal(lead + (nsub, nchan, nbin)) + 3.0 * t
    cube[..., nsub - 1, nchan - 1, 100] = 60.0
    rot = np.stack([np.roll(t, 5 * c) for c in range(nchan)])
    nyq = rng.standard_normal((nchan, nbin)) * 1e-3
    w = rng.random(lead + (nsub, nchan))
    w[w < 0.15] = 0.0
    win = np.ones(nbin)
    win[nbin // 4: nbin // 3] = 0.5

    def up(a, shape=None):
        a = np.array(np.broadcast_to(a, shape)) if shape else a
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, real)

    wt = up(w)
    cube_t = up(cube).to(getattr(torch, storage))
    return dict(cube=cube_t, base=(up(cube) * 0.5).to(cube_t.dtype),
                rot=up(rot, lead + rot.shape), nyq=up(nyq, lead + nyq.shape),
                tmpl=up(t, lead + t.shape), w=wt, mask=wt == 0, win=up(win))


def fft_forms(o):
    """(form, the routed wrapper, its plain version) of every entry on the
    operands ``o`` of :func:`fft_operands`, at lengths past the DFT tables
    (the FFT build's route): K2 with and without the Nyquist term, K7, K6
    and K10's two entries."""
    from iterative_cleaner_torch.stats import kernels as K

    c, b, r, n, t, w, m, win = (o[k] for k in ("cube", "base", "rot", "nyq",
                                              "tmpl", "w", "mask", "win"))
    assert K.cell_stats_route(c.shape[-1], c.element_size()) in (
        "fft", "fft_global")
    return [
        ("disp", lambda: K.cell_diagnostics_disp(c, r, n, t, w, m),
         lambda: K.cell_diagnostics_disp_plain(c, r, n, t, w, m)),
        ("disp (no Nyquist term)",
         lambda: K.cell_diagnostics_disp(c, r, None, t, w, m),
         lambda: K.cell_diagnostics_disp_plain(c, r, None, t, w, m)),
        ("two_read", lambda: K.cell_diagnostics_two_read(c, b, r, t, w, m),
         lambda: K.cell_diagnostics_two_read_plain(c, b, r, t, w, m)),
        ("dedisp", lambda: K.cell_diagnostics_dedisp(c, t, win, w, m),
         lambda: K.cell_diagnostics_dedisp_plain(c, t, win, w, m)),
        ("shard disp", lambda: K.shard_diagnostics_disp(c, r, n, t, w, m),
         lambda: K.cell_diagnostics_disp_plain(c, r, n, t, w, m)),
        ("shard dedisp",
         lambda: K.shard_diagnostics_dedisp(c, t, win, w, m),
         lambda: K.cell_diagnostics_dedisp_plain(c, t, win, w, m)),
    ]


def plane_err(got, want, mask, rtol, torch, fft_masked_exact=True):
    """The largest |got - want| over (|want| + each plane's scale) and
    whether it is within ``rtol`` with the masked cells bit-equal (a
    batch's planes archive by archive).  ``fft_masked_exact`` False holds
    d_fft's masked cells by the tolerance too: d_fft is not patched by
    the mask (rule 5), and the plain version's torch.fft on the card
    takes a masked cell's zero row of odd length to about 3e-5, not to
    the zero K2g gives (measured at 16,411 bins)."""
    if mask.dim() == 3:
        errs = [plane_err([g[i] for g in got], [w[i] for w in want], mask[i],
                          rtol, torch, fft_masked_exact)
                for i in range(mask.shape[0])]
        return max(e for e, _ in errs), all(ok for _, ok in errs)
    err, ok = 0.0, True
    for k, (g, w) in enumerate(zip(got, want)):
        scale = float(w[~mask].abs().max())
        rel = float(((g - w).abs() / (w.abs() + scale)).max())
        err = max(err, rel)
        exact = fft_masked_exact or k < 3
        ok &= rel <= rtol and (
            not exact or bits_mismatch(g[mask], w[mask], torch) == 0)
    return err, ok


def l1_phase(dev, tag):
    """(L1) Every FFT-build entry against its plain version on the card in
    float32, bf16 and float64, at L1_SHAPES (clusters of 2, 4 and 8 blocks
    a cell, the radix-3 stage, a batch of two) under the plan
    ``cell_fft_plan`` picks: within 1e-4 of each plane's scale (1e-12 in
    float64),
    masked cells bit-equal; K10's entries bit-equal to K2's and K6's on
    one 2 x 2 shard; each archive of the batch bit-equal to its own
    launch.  Each entry timed at the 65,536-bin cluster shape.  Returns
    ``{name: {max_abs_err, ms, plain_ms, bound_ms, bound_by, shape}}``."""
    import torch

    from iterative_cleaner_torch.stats import kernels as K

    t0 = time.perf_counter()
    names = {"disp": "cell_diagnostics_disp",
             "two_read": "cell_diagnostics_two_read",
             "dedisp": "cell_diagnostics_dedisp",
             "shard disp": "shard_diagnostics_disp",
             "shard dedisp": "shard_diagnostics_dedisp"}
    out, ok_all = {}, True
    for storage, shapes in L1_SHAPES.items():
        rtol = F64_PLANE_RTOL if storage == "float64" else K2_RTOL
        sfx = {"float32": "", "bfloat16": "_bf16", "float64": "_f64"}[storage]
        for nb, nsub, nchan, nbin in shapes:
            o = fft_operands(nb, nsub, nchan, nbin, storage, nbin % 101, dev)
            plan = K.cell_fft_plan(nbin, o["cube"].element_size())
            errs = []
            for form, kfn, pfn in fft_forms(o):
                got, want = kfn(), pfn()
                err, ok = plane_err(got, want, o["mask"], rtol, torch)
                ok_all &= ok
                errs.append(f"{form} {err:.2e}{'' if ok else ' FAIL'}")
                name = names.get(form)
                if name:
                    key = f"{name}_fft{sfx}"
                    out.setdefault(key, {"max_abs_err": 0.0})
                    out[key]["max_abs_err"] = max(
                        out[key]["max_abs_err"],
                        max_abs_diff_planes(got, want, torch))
                    if (nb, nsub, nchan, nbin) == shapes[1]:
                        out[key].update(time_fft_entry(
                            name, kfn, pfn, nsub, nchan, nbin, storage))
            if nb:
                whole = K.cell_diagnostics_disp(o["cube"], o["rot"], o["nyq"],
                                                o["tmpl"], o["w"], o["mask"])
                bad = sum(bits_mismatch(g[i], s, torch)
                          for i in range(nb)
                          for g, s in zip(whole, K.cell_diagnostics_disp(
                              *(o[k][i].contiguous() for k in (
                                  "cube", "rot", "nyq", "tmpl", "w",
                                  "mask")))))
                what = f"batch of {nb}: {bad} cells differ in bits from each " \
                       f"archive's own launch"
            else:
                hs, hc = nsub // 2, nchan // 2
                cells = {k: o[k][:hs, :hc].contiguous()
                         for k in ("cube", "w", "mask")}
                args = (cells["cube"], o["rot"][:hc].contiguous(),
                        o["nyq"][:hc].contiguous(), o["tmpl"], cells["w"],
                        cells["mask"])
                dargs = (cells["cube"], o["tmpl"], o["win"], cells["w"],
                         cells["mask"])
                bad = sum(bits_mismatch(a, b, torch) for a, b in zip(
                    K.shard_diagnostics_disp(*args)
                    + K.shard_diagnostics_dedisp(*dargs),
                    K.cell_diagnostics_disp(*args)
                    + K.cell_diagnostics_dedisp(*dargs)))
                what = f"K10 on a 2 x 2 shard: {bad} cells differ in bits " \
                       f"from K2's and K6's FFT builds"
            ok_all &= bad == 0
            print(f"L1 FFT build {storage} {(nb or 1, nsub, nchan, nbin)} "
                  f"({plan.cluster} block(s) a cell, odd part {plan.odd}): "
                  f"largest error over (|plain| + plane scale) "
                  f"{', '.join(errs)} (tolerance {rtol:g}); {what} "
                  f"(tolerance: bit-equal) {tag}", flush=True)
            del o
    torch.cuda.empty_cache()
    print(f"phase L1: {time.perf_counter() - t0:.1f} s", flush=True)
    if not ok_all:
        fail("L1: an FFT-build entry disagrees with its plain version, K10 "
             "with K2/K6, or a batch with its archives")
    return out


def max_abs_diff_planes(got, want, torch) -> float:
    return max(max_abs_diff(g, w, torch) for g, w in zip(got, want))


def time_fft_entry(name, kfn, pfn, nsub, nchan, nbin, storage,
                   build="_fft"):
    """An FFT build's ms, its plain version's, and its bound at the
    operands' shape (``build`` ``"_fft"``, K2f, or ``"_fftg"``, K2g: the
    same bound)."""
    import torch

    cb = {"float32": 4, "bfloat16": 2, "float64": 8}[storage]
    bms, bby = profiling.kernel_bounds(nsub, nchan, nbin,
                                       cube_bytes=cb)[name + build]
    return {"ms": cuda_ms(kfn, 10, torch), "plain_ms": cuda_ms(pfn, 2, torch),
            "bound_ms": bms, "bound_by": bby, "shape": [nsub, nchan, nbin]}


def l2_phase(dev, tag):
    """(L2) The DFT route (K2) and the FFT build (``cell_fft_disp``, called
    as a function, no knob) on the same inputs at L2_NBINS bins, each
    against the float64 plain version on the card and against each other;
    both timed.  The FFT build within 1e-4 of each plane's scale of the
    float64 planes; the two builds within 1e-4 of each other on the
    moments' planes and on d_fft within 1e-4 beyond K2's own error there
    (the DFT's float32 angle tables: 1.3e-4 and 4.1e-4 of the plane's
    scale at 8192 and 16,384 bins on the CPU).  Returns the times."""
    import torch

    from iterative_cleaner_torch.stats import kernels as K

    t0 = time.perf_counter()
    times, ok = {}, True
    for nbin in L2_NBINS:
        o = fft_operands(0, *L2_CELLS, nbin, "float32", 7, dev)
        args = (o["cube"], o["rot"], o["nyq"], o["tmpl"], o["w"], o["mask"])
        o64 = {k: (v.double() if v.is_floating_point() else v)
               for k, v in o.items()}
        ref = K.cell_diagnostics_disp_plain(
            *(o64[k] for k in ("cube", "rot", "nyq", "tmpl", "w", "mask")),
            "fft")
        ref = [r.float() for r in ref]
        assert K.cell_stats_route(nbin) == "dft"
        dft, fft = K.cell_diagnostics_disp(*args), K.cell_fft_disp(*args)
        e_fft = [plane_err([g], [r], o["mask"], 1.0, torch)[0]
                 for g, r in zip(fft, ref)]
        e_dft = [plane_err([g], [r], o["mask"], 1.0, torch)[0]
                 for g, r in zip(dft, ref)]
        e_pair = [plane_err([g], [r], o["mask"], 1.0, torch)[0]
                  for g, r in zip(fft, dft)]
        here = (all(e <= K2_RTOL for e in e_fft)
                and all(e <= K2_RTOL for e in e_pair[:3])
                and e_pair[3] <= max(K2_RTOL, e_dft[3] + K2_RTOL))
        ok &= here
        ms_dft = cuda_ms(lambda: K.cell_diagnostics_disp(*args), 5, torch)
        ms_fft = cuda_ms(lambda: K.cell_fft_disp(*args), 10, torch)
        times[nbin] = {"dft_ms": ms_dft, "fft_ms": ms_fft,
                       "shape": [*L2_CELLS, nbin]}
        fmt = lambda es: "/".join(f"{e:.1e}" for e in es)  # noqa: E731
        print(f"L2 at {L2_CELLS[0]} x {L2_CELLS[1]} x {nbin}: K2 (DFT route) "
              f"{ms_dft:.4f} ms, FFT build {ms_fft:.4f} ms; errors over "
              f"(|ref| + plane scale), d_std/d_mean/d_ptp/d_fft, against "
              f"the float64 plain version: FFT build {fmt(e_fft)}, K2 "
              f"{fmt(e_dft)}; FFT build against K2 {fmt(e_pair)}: "
              f"{'ok' if here else 'FAIL'} {tag}", flush=True)
        del o, o64
    print(f"phase L2: {time.perf_counter() - t0:.1f} s", flush=True)
    if not ok:
        fail("L2: the FFT build and K2 disagree past their tolerance")
    return times


# (L4): the long-profile card tests' archive, and its bounds: the
# baselines' float32 offsets within twice the CPU's old distance from
# float64 (1.681e-7 of the offsets' scale, the integration contraction on
# the CPU); the whole float32 cleans' scores no farther from the float64
# clean than the CPU's float32 scores, by more than 1e-3 (relative, with
# a 1e-3 floor)
L4_ARCHIVE = dict(nsub=4, nchan=8, nbin=32768, n_prezapped=2, seed=41)
L4_OFFSET_BOUND = 3.4e-7
L4_SCORE_MARGIN = 1e-3


def l4_phase(dev, tag):
    """(L4) Float32 against float64 on long profiles (ROADMAP section 3
    (f)): on the L4_ARCHIVE archive, the integration baseline's and the
    profile baseline's offsets on the card and on the CPU against the
    float64 offsets (the card's within L4_OFFSET_BOUND of their scale;
    whether they are the CPU's bits is printed: the window sums are, the
    integration window's placement comes from a library contraction),
    then the whole clean on the default,
    dedispersed and profile routes on the card in float32, on the CPU in
    float32 and float64: the card's scores no farther from float64 than
    the CPU's by more than L4_SCORE_MARGIN, its mask the CPU's.  Returns
    the distances."""
    import torch

    from iterative_cleaner_torch import CleanConfig
    from iterative_cleaner_torch.backends import clean_archive
    from iterative_cleaner_torch.io.synthetic import make_synthetic_archive
    from iterative_cleaner_torch.ops import dsp
    from iterative_cleaner_torch.ops.psrchive_baseline import (
        baseline_offsets_integration,
    )

    t0 = time.perf_counter()
    ar, _ = make_synthetic_archive(**L4_ARCHIVE)
    duty = CleanConfig().baseline_duty
    cube = np.array(ar.total_intensity(), dtype=np.float64)
    w = np.array(ar.weights, dtype=np.float64)
    out, ok = {"offsets": {}, "scores": {}}, True
    for name, fn in (
            ("integration", lambda c, x: baseline_offsets_integration(
                c, x, duty)),
            ("profile", lambda c, x: dsp.baseline_offsets(c, duty))):
        want = fn(torch.from_numpy(cube), torch.from_numpy(w))
        c32, w32 = (torch.from_numpy(a.astype(np.float32)) for a in (cube, w))
        cpu = fn(c32, w32)
        card = fn(c32.to(dev), w32.to(dev)).cpu()
        scale = float(want.abs().max())
        e_card = float((card.double() - want).abs().max()) / scale
        e_cpu = float((cpu.double() - want).abs().max()) / scale
        same = torch.equal(card, cpu)
        here = e_card <= L4_OFFSET_BOUND
        ok &= here
        out["offsets"][name] = {"card": e_card, "cpu": e_cpu,
                                "bit_equal": same}
        print(f"L4 {name} baseline offsets of the {L4_ARCHIVE['nsub']} x "
              f"{L4_ARCHIVE['nchan']} x {L4_ARCHIVE['nbin']} archive (seed "
              f"{L4_ARCHIVE['seed']}), float32 from float64 over their scale: "
              f"card {e_card:.3e}, CPU {e_cpu:.3e}, card bit-equal to the CPU "
              f"{same} (bound {L4_OFFSET_BOUND:g}): "
              f"{'ok' if here else 'FAIL'} {tag}", flush=True)
    for route, kw in (("default", {}),
                      ("dedispersed", dict(stats_frame="dedispersed")),
                      ("profile", dict(baseline_mode="profile"))):
        card = clean_archive(ar, CleanConfig(**kw))
        cpu = clean_archive(ar, CleanConfig(device="cpu", **kw))
        f64 = clean_archive(ar, CleanConfig(device="cpu", dtype="float64",
                                            **kw))
        e_card = score_err(card.scores, f64.scores)
        e_cpu = score_err(cpu.scores, f64.scores)
        masks = bool(np.array_equal(card.final_weights == 0,
                                    cpu.final_weights == 0))
        here = e_card <= e_cpu + L4_SCORE_MARGIN and masks \
            and card.loops == cpu.loops
        ok &= here
        out["scores"][route] = {"card": e_card, "cpu": e_cpu,
                                "masks_equal": masks}
        print(f"L4 {route} route, whole float32 clean's scores from the "
              f"float64 clean's (largest |d| / (|s64| + 1e-3)): card "
              f"{e_card:.4f}, CPU {e_cpu:.4f} (bound: the CPU's + "
              f"{L4_SCORE_MARGIN:g}); mask equal to the CPU's {masks}, loops "
              f"{card.loops} and {cpu.loops}: {'ok' if here else 'FAIL'} "
              f"{tag}", flush=True)
    print(f"phase L4: {time.perf_counter() - t0:.1f} s", flush=True)
    if not ok:
        fail("L4: the card's float32 baselines or scores lie farther from "
             "float64 than their bound (ROADMAP section 3 (f))")
    return out


def score_err(got, want) -> float:
    """Largest |got - want| / (|want| + 1e-3) over cells."""
    return float(np.max(np.abs(got - want) / (np.abs(want) + 1e-3)))


def l3_operands(ar, cfg, dev, shard=False):
    """The first iteration's operands of ``cfg``'s route on ``ar`` in the
    configuration's dtype: the prepared cubes and template, the route's
    FFT build with its plain version and its residual, and the plain
    version on the operands upcast to float64.  ``shard``: K10's entry
    in place of K2's or K6's (one rank's shard is the whole cube)."""
    import torch

    import iterative_cleaner_torch.engine.loop as loop
    from iterative_cleaner_torch.stats import kernels as K

    real = torch.float64 if cfg.dtype == "float64" else torch.float32
    npd = np.float64 if cfg.dtype == "float64" else np.float32
    weights = torch.from_numpy(np.ascontiguousarray(ar.weights,
                                                    dtype=npd)).to(dev)
    meta = [torch.from_numpy(np.ascontiguousarray(ar.freqs_mhz,
                                                  dtype=npd)).to(dev)]
    meta += [torch.tensor(v, dtype=real, device=dev)
             for v in (ar.dm, ar.centre_freq_mhz, ar.period_s)]
    cube = torch.from_numpy(np.ascontiguousarray(ar.total_intensity(),
                                                 dtype=npd)).to(dev)
    prep = loop.prepare(cube, weights, *meta, cfg, dedispersed=ar.dedispersed)
    del cube
    template = loop.build_template(prep, weights, rotation=cfg.rotation,
                                   baseline_duty=cfg.baseline_duty)
    mask = weights == 0
    if prep.route == "dedispersed":
        args = (prep.ded, template, prep.window, weights, mask)
        name = "shard_diagnostics_dedisp" if shard \
            else "cell_diagnostics_dedisp"
        p64 = K.cell_diagnostics_dedisp_plain
        wfn = lambda: K.wres_dedisp(*args[:4])  # noqa: E731
    elif prep.route == "two_read":
        rot_t, _ = loop._dispersed_rows(prep, template, cfg.rotation)
        args = (prep.ded, prep.disp_base, rot_t, template, weights, mask)
        name = "cell_diagnostics_two_read"
        p64 = K.cell_diagnostics_two_read_plain
        wfn = lambda: K.wres_two_read(*args[:5])  # noqa: E731
    else:
        rot_t, nyq = loop._dispersed_rows(prep, template, cfg.rotation)
        args = (prep.disp_base, rot_t, nyq, template, weights, mask)
        name = "shard_diagnostics_disp" if shard else "cell_diagnostics_disp"
        p64 = K.cell_diagnostics_disp_plain
        wfn = lambda: K.wres_disp(*args[:5])  # noqa: E731
    kfn = lambda: getattr(K, name)(*args)  # noqa: E731
    pfn = lambda: p64(*args)  # noqa: E731

    def pfn64():
        return p64(*(a.double() if a is not None and a.is_floating_point()
                     else a for a in args))

    return prep, weights, mask, name, kfn, pfn, wfn, pfn64


def l3_phase(lp_fut, mesh1, counts, clean_ms, peak_gib, dev, tag):
    """(L3) The long-profile archive (``LONG_PROFILE_SHAPE``, built on a
    worker process) through ``clean_archive`` on the card: the default
    route in float32, the dedispersed frame, the default route in float64
    (the main path), then the profile baseline (K7's FFT build) and the
    one-rank sharded default and dedispersed cleans (K10's FFT build),
    each counted: its route's FFT build once an iteration and no DFT
    launch.  The float32 mask against the float64
    one by the goldens' flip rule (at most MAX_BORDERLINE_FLIPS flips,
    each with |score64 - 1| <= FLIP_NOISE_ENV, equal loops); the
    dedispersed mask against the default one by the frames' contract; the
    sharded cleans' masks and scores bit-equal to the whole cleans'.  On
    the first iteration's operands of the default (float32 and float64)
    and dedispersed cleans: the FFT build, K1 (default route), K3 x 2, the
    combine and K9 held to their plain versions (:func:`l3_kernel_checks`);
    timed: ms an iteration, the FFT build against its bound, its plain
    version, ``torch.fft.rfft`` alone on the centred rows; peak memory.
    Returns the kernels line's entries of the main path's FFT builds and
    the other kernels' checks by name."""
    import torch

    import iterative_cleaner_torch.engine.loop as loop
    from iterative_cleaner_torch import CleanConfig
    from iterative_cleaner_torch.archive import Archive
    from iterative_cleaner_torch.backends import (
        clean_archive,
        clean_archive_sharded,
    )
    from iterative_cleaner_torch.engine.loop import (
        ROUTE_KERNELS,
        SHARD_KERNELS,
        select_route,
        spectrum_kernels,
        storage_kernels,
    )
    from iterative_cleaner_torch.stats import kernels as K

    t_phase = time.perf_counter()
    path, fields = lp_fut.result()
    ar = Archive(data=np.load(path), **fields)
    os.remove(path)
    S, C, B = LONG_PROFILE_SHAPE
    runs = {
        "long default": (CleanConfig(), None),
        "long dedispersed": (CleanConfig(stats_frame="dedispersed"), None),
        "long f64": (CleanConfig(dtype="float64"), None),
        "long profile": (CleanConfig(baseline_mode="profile"), None),
        "long sharded 1": (CleanConfig(), mesh1),
        "long sharded 1 (dedispersed)":
            (CleanConfig(stats_frame="dedispersed"), mesh1),
    }
    res = {}
    for key, (cfg, mesh) in runs.items():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        r = res[key] = (clean_archive(ar, cfg) if mesh is None
                        else clean_archive_sharded(ar, cfg, mesh))
        torch.cuda.synchronize()
        clean_ms[key] = (time.perf_counter() - t0) * 1e3
        counts[key] = K.launch_counts()
        peak_gib[key] = torch.cuda.max_memory_allocated() / 2 ** 30
        route = select_route(cfg, ar.dedispersed)
        table = SHARD_KERNELS if mesh is not None else ROUTE_KERNELS
        own = storage_kernels(spectrum_kernels(table[route], B, cfg.dtype),
                              cfg.compute_dtype, cfg.dtype)
        want = {k: (r.loops if k in own else 0) for k in counts[key]}
        used = {k: v for k, v in counts[key].items() if v}
        print(f"{key}: {S}x{C}x{B} ({route} route{', one NCCL rank' if mesh else ''}"
              f", {cfg.dtype}, {cfg.compute_dtype} storage): kernels "
              f"{json.dumps(used)}, {r.loops} loops, whole clean "
              f"{clean_ms[key]:.1f} ms, peak device memory "
              f"{peak_gib[key]:.2f} GiB {tag}", flush=True)
        if counts[key] != want:
            fail(f"{key}: launches {used}, want each of the route's kernels "
                 f"(its FFT build in place of the DFT one) once an "
                 f"iteration: {want}")
        if r.final_weights.shape != (S, C) \
                or not np.all(np.isfinite(r.scores[r.final_weights != 0])):
            fail(f"{key}: weights or scores malformed")
    base, r64 = res["long default"], res["long f64"]
    flips = np.argwhere((base.final_weights == 0) != (r64.final_weights == 0))
    wide = [(int(i), int(c)) for i, c in flips
            if abs(float(r64.scores[i, c]) - 1.0) > FLIP_NOISE_ENV]
    print(f"long default against long f64: {len(flips)} mask flips (limit "
          f"{MAX_BORDERLINE_FLIPS}), {len(wide)} of them with |score64 - 1| "
          f"> {FLIP_NOISE_ENV}; loops {base.loops} and {r64.loops} "
          f"{tag}", flush=True)
    if len(flips) > MAX_BORDERLINE_FLIPS or wide or base.loops != r64.loops:
        fail("long profiles: the float32 mask breaks the flip rule against "
             "the float64 one")
    contract("dedispersed", base, res["long dedispersed"])
    for key, whole in (("long sharded 1", "long default"),
                       ("long sharded 1 (dedispersed)", "long dedispersed")):
        got, want = res[key], res[whole]
        n = int(((got.final_weights == 0) != (want.final_weights == 0)).sum())
        n_bits = bits_mismatch(torch.from_numpy(got.scores),
                               torch.from_numpy(want.scores), torch)
        print(f"{key} against {whole}: {n} mask cells and {n_bits} scores "
              f"differ in bits (tolerance: 0 and 0); loops {got.loops} and "
              f"{want.loops} {tag}", flush=True)
        if n or n_bits or got.loops != want.loops:
            fail(f"{key}: differs from the whole clean (K10's FFT build is "
                 f"K2's and K6's)")
    del res

    # the main path's FFT builds timed on the first iteration's operands,
    # and its other kernels held there to their plain versions
    entries, checks = [], {}
    common = dict(chanthresh=CleanConfig().chanthresh,
                  subintthresh=CleanConfig().subintthresh)
    for key, sfx in (("long default", ""), ("long dedispersed", ""),
                     ("long f64", "_f64")):
        cfg = runs[key][0]
        prep, weights, mask, name, kfn, pfn, wfn, _ = l3_operands(ar, cfg,
                                                                  dev)
        name_fft = f"{name}_fft{sfx}"
        got, want = kfn(), pfn()
        err = max_abs_diff_planes(got, want, torch)
        rel, ok = plane_err(got, want, mask,
                            F64_PLANE_RTOL if sfx else K2_RTOL, torch)
        del want
        # the path's other kernels on this iteration's operands: K1 on
        # the default route's cube, K3 x 2, the combine and K9 on the FFT
        # build's planes
        checks_ok = l3_kernel_checks(key, prep, weights, mask, got, cfg,
                                     sfx, checks, tag)
        del got
        wres = wfn()
        centred = wres - torch.where(mask, torch.zeros_like(wres[..., 0]),
                                     wres.mean(dim=-1))[..., None]
        del wres
        rfft_ms = cuda_ms(lambda: torch.fft.rfft(centred, dim=-1), 3, torch)
        del centred
        ms = cuda_ms(kfn, 10, torch)
        plain_ms = cuda_ms(pfn, 2, torch)
        it_ms = cuda_ms(lambda: loop.iteration_step(
            prep, weights, weights, mask, rotation=cfg.rotation,
            baseline_duty=cfg.baseline_duty, **common), 5, torch)
        bms, bby = profiling.kernel_bounds(
            S, C, B, cube_bytes=8 if sfx else 4)[name_fft.replace("_f64", "")]
        entries.append({
            "name": name_fft, "route": "cuda",
            "source": "iterative_cleaner_torch/stats/csrc/cell_fft.cu",
            "replaces": "iterative_cleaner_tpu/stats/masked_jax.py:155",
            "launches": counts[key][name_fft], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": bby,
            "library_ms": None, "rfft_ms": rfft_ms, "iteration_ms": it_ms,
            "shape": [S, C, B], "plan": K.cell_fft_plan(
                B, 8 if sfx else 4)._asdict(),
            "launches_by_route": {r: c[name_fft] for r, c in counts.items()
                                  if c.get(name_fft)}})
        print(f"time {name_fft} ({key}, {S} x {C} x {B}): {ms:.4f} ms, bound "
              f"{bms:.4f} ms ({bby}), plain {plain_ms:.4f} ms, torch.fft.rfft "
              f"alone on the centred rows {rfft_ms:.4f} ms; {it_ms:.3f} ms "
              f"per iteration (device, resident cube); against its plain "
              f"version {rel:.2e} of each plane's scale: "
              f"{'ok' if ok else 'FAIL'}; whole clean {clean_ms[key]:.1f} ms, "
              f"peak device memory {peak_gib[key]:.2f} GiB {tag}", flush=True)
        if not ok:
            fail(f"{key}: the FFT build disagrees with its plain version at "
                 f"full width")
        if not checks_ok:
            fail(f"{key}: K1, K3, the combine or K9 disagrees with its plain "
                 f"version on the first iteration's operands at full width")
        del prep, weights, mask, kfn, pfn, wfn
        torch.cuda.empty_cache()
    del ar
    print(f"phase L3, the long-profile archive: "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return entries, checks


def l3_kernel_checks(key, prep, weights, mask, diags, cfg, sfx, checks,
                     tag):
    """K1 (default route: its plain version within K1_RTOL, F64_K1_RTOL in
    float64, of sum|w*disp|), K3 along both axes, the combine and K9 (on
    the telemetry's line, as ``residual_std`` takes it) on the
    first iteration's operands of the long-profile run ``key``, each
    bit-equal to its plain version.  Records each kernel's largest error
    in ``checks`` (by its counter name) and returns whether all held."""
    import torch

    from iterative_cleaner_torch.stats import kernels as K

    shape = list(weights.shape)
    results = {}
    if prep.route == "default":
        err, ok = check_k1(prep.disp_base, weights,
                           f" ({key}, {tuple(prep.disp_base.shape)})",
                           F64_K1_RTOL if sfx else K1_RTOL)
        results["weighted_marginals"] = (err, ok, list(prep.disp_base.shape))
    sides = {}
    for axis, thresh in ((0, cfg.chanthresh), (1, cfg.subintthresh)):
        got = sides[axis] = K.scaled_sides(diags, mask, axis, thresh)
        want = K.scaled_sides_plain(diags, mask, axis, thresh)
        bad = sum(bits_mismatch(g, w, torch) for g, w in zip(got, want))
        results[f"scaled_sides_axis{axis}"] = (
            max(max_abs_diff(g, w, torch) for g, w in zip(got, want)),
            bad == 0, shape)
    new_w, scores = K.combine_zap(sides[0], sides[1], weights)
    pw, ps = K.combine_zap_plain(sides[0], sides[1], weights)
    bad = bits_mismatch(scores, ps, torch) + bits_mismatch(new_w, pw, torch)
    results["combine_zap"] = (max_abs_diff(scores, ps, torch), bad == 0,
                              shape)
    line_v, line_m = diags[0].reshape(1, -1), mask.reshape(1, -1)
    bad9 = bits_mismatch(K.masked_median(line_v, line_m, 1),
                         K.masked_median_keys(line_v, line_m, 1)[0], torch)
    results["masked_median"] = (0.0 if bad9 == 0 else float("inf"),
                                bad9 == 0, list(line_v.shape))
    all_ok = True
    for name, (err, ok, at) in results.items():
        all_ok &= ok
        rec = checks.setdefault(name + sfx, {"max_abs_err": 0.0, "runs": {}})
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        rec["runs"][key] = {"shape": at, "max_abs_err": err, "ok": ok}
    print(f"L3 {key}: the path's kernels against their plain versions on "
          f"the first iteration's operands "
          + ", ".join(f"{n} {e:.3e} {'ok' if ok else 'FAIL'}"
                      for n, (e, ok, _) in results.items())
          + f" (tolerance: K1 {F64_K1_RTOL if sfx else K1_RTOL:g} of "
          f"sum|w*disp|, the others bit-equal) {tag}", flush=True)
    return all_ok


def long_profile_entries(l1, l3, counts):
    """The kernels line's rows of the FFT builds: the main path's (L3,
    timed at full width) and the others' (timed at L1's cluster shape),
    each with its launches on the long-profile runs."""
    rows = {e["name"]: e for e in l3}
    for name, r in l1.items():
        if name in rows:
            rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"],
                                            r["max_abs_err"])
            continue
        launches = sum(c.get(name, 0) for k, c in counts.items()
                       if k.startswith("long "))
        if not launches or "ms" not in r:
            continue
        rows[name] = {
            "name": name, "route": "cuda",
            "source": "iterative_cleaner_torch/stats/csrc/cell_fft.cu",
            "replaces": "iterative_cleaner_tpu/stats/masked_jax.py:155",
            "launches": launches, "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None, "shape": r["shape"],
            "launches_by_route": {k: c[name] for k, c in counts.items()
                                  if c.get(name)}}
    return list(rows.values())


# ---- (L5): every profile length the reference cleans (K2f's mixed
# radix-3/5 stages, K2g through device memory) ------------------------

# The (L5) archives: (shape, period in s, seed), made in the (L5) phase
# (:func:`make_l5_archive`).  (L5a) a 3.42 s pulsar at
# 57 us a bin: 60,000 = 2^5 x 1875 bins, odd part 3 x 5^4, K2g's split
# row (the faster build past three odd stages in float32 and four in
# float64, kernels.FFT_ODD_STAGES);
# (L5b) a 3.73 s pulsar at 57 us: 65,521 bins,
# a prime, K2g's cluster mode (Bluestein on M = 98,304 points in one
# cluster a cell, no scratch); (L5c) PSR J0901-4046 (P =
# 75.9 s) at 145 us: 524,288 bins in 16 subints over 64 channels (2^29
# samples, the golden's count), past the cluster's capacity, K2g's split
# route
L5_ARCHIVES = {
    "L5a": ((32, 256, 60000), 3.42, 51),
    "L5b": ((32, 256, 65521), 3.73, 52),
    "L5c": ((16, 64, 524288), 75.9, 53),
}
# each archive's cleans: (run, configuration, sharded on one NCCL rank)
_L5_PROFILE = (("profile", dict(baseline_mode="profile"), False),
               ("profile f64", dict(baseline_mode="profile",
                                    dtype="float64"), False))
L5_RUNS = {
    "L5a": (("default", {}, False), ("f64", dict(dtype="float64"), False)),
    "L5b": (("default", {}, False), ("f64", dict(dtype="float64"), False),
            ("dedispersed", dict(stats_frame="dedispersed"), False))
    + _L5_PROFILE,
    "L5c": (("default", {}, False), ("f64", dict(dtype="float64"), False),
            ("dedispersed", dict(stats_frame="dedispersed"), False))
    + _L5_PROFILE + (("sharded 1", {}, True),),
}
# the float32 cleans held to a float64 one by the goldens' flip rule
L5_FLIP_PAIRS = (("default", "f64"), ("profile", "profile f64"))
# the cleans whose first iteration's operands time the FFT build: every
# entry the (L5) cleans launch, at full width
L5_TIMED_RUNS = ("default", "dedispersed", "f64", "profile", "profile f64",
                 "sharded 1")
# (L5e): every K2g entry, and K2f's mixed odd stages, against its plain
# version at small width, (batch or 0, nsub, nchan, nbin) by storage; the
# first shape of each list times the entries.  65,521, 16,411 and 28,672
# bins take K2g's cluster mode; 136,537 (float64 69,127), a prime past
# the cluster, Bluestein's passes on the shorter convolution
L5_ENTRY_SHAPES = {
    "float32": ((0, 4, 16, 65521), (0, 4, 16, 16411), (0, 4, 16, 28672),
                (0, 2, 8, 524288), (2, 2, 8, 16411), (0, 4, 16, 60000),
                (0, 4, 16, 20000), (0, 4, 16, 46080), (0, 2, 8, 136537)),
    "bfloat16": ((0, 4, 16, 65521), (0, 4, 16, 16411), (0, 4, 16, 28672),
                 (0, 2, 8, 524288), (0, 4, 16, 60000), (0, 4, 16, 46080),
                 (0, 2, 8, 136537)),
    "float64": ((0, 4, 16, 65521), (0, 4, 16, 16411), (0, 2, 8, 262144),
                (2, 2, 8, 28672), (0, 4, 16, 60000), (0, 2, 8, 69127),
                (0, 4, 16, 20000)),
}
K2G_SOURCE = "iterative_cleaner_torch/stats/csrc/cell_fft_global.cu"
FFT_REPLACES = "iterative_cleaner_tpu/stats/masked_jax.py:155"


def build_fft_name(nbin, storage):
    """The launch-count suffix of the FFT build that takes ``nbin`` bins
    of ``storage``: ``_fft`` (K2f) or ``_fftg`` (K2g)."""
    from iterative_cleaner_torch.stats import kernels as K

    itemsize = {"float32": 4, "bfloat16": 2, "float64": 8}[storage]
    return "_fft" if K.cell_stats_route(nbin, itemsize) == "fft" else "_fftg"


def l5_entries_phase(dev, tag):
    """(L5e) Every K2g entry (K2 with and without the Nyquist term, K7,
    K6, K10's two) and K2f's mixed odd stages against their plain versions
    on the card in float32, bf16 and float64 at L5_ENTRY_SHAPES: within
    1e-4 of each plane's scale (1e-12 in float64), the moments' masked
    cells bit-equal (:func:`plane_err`; K2g's d_fft held by the tolerance
    on every cell); bf16 bit-equal to float32 on the upcast cube; K10's
    entries bit-equal to K2's and K6's; a batch of two bit-equal to its
    archives' own launches; ``out=`` tiles of two subint halves bit-equal
    to the whole.  Each K2g entry timed at the first shape of its dtype.
    Returns ``{name: {max_abs_err, ms, plain_ms, bound_ms, bound_by,
    shape}}``."""
    import torch

    from iterative_cleaner_torch.stats import kernels as K

    t0 = time.perf_counter()
    names = {"disp": "cell_diagnostics_disp",
             "two_read": "cell_diagnostics_two_read",
             "dedisp": "cell_diagnostics_dedisp",
             "shard disp": "shard_diagnostics_disp",
             "shard dedisp": "shard_diagnostics_dedisp"}
    out, ok_all = {}, True
    for storage, shapes in L5_ENTRY_SHAPES.items():
        rtol = F64_PLANE_RTOL if storage == "float64" else K2_RTOL
        sfx = {"float32": "", "bfloat16": "_bf16", "float64": "_f64"}[storage]
        for nb, nsub, nchan, nbin in shapes:
            o = fft_operands(nb, nsub, nchan, nbin, storage, nbin % 103, dev)
            build = build_fft_name(nbin, storage)
            errs = []
            for form, kfn, pfn in fft_forms(o):
                got, want = kfn(), pfn()
                err, ok = plane_err(got, want, o["mask"], rtol, torch,
                                    fft_masked_exact=build == "_fft")
                ok_all &= ok
                errs.append(f"{form} {err:.2e}{'' if ok else ' FAIL'}")
                name = names.get(form)
                if name:
                    key = f"{name}{build}{sfx}"
                    out.setdefault(key, {"max_abs_err": 0.0})
                    out[key]["max_abs_err"] = max(
                        out[key]["max_abs_err"],
                        max_abs_diff_planes(got, want, torch))
                    if build == "_fftg" and (nb, nsub, nchan, nbin) \
                            == shapes[0]:
                        out[key].update(time_fft_entry(
                            name, kfn, pfn, nsub, nchan, nbin, storage,
                            build))
            c, r, n, t, w, m, win = (o[k] for k in (
                "cube", "rot", "nyq", "tmpl", "w", "mask", "win"))
            what = []
            if nb:
                whole = K.cell_diagnostics_disp(c, r, n, t, w, m)
                bad = sum(bits_mismatch(g[i], s, torch)
                          for i in range(nb)
                          for g, s in zip(whole, K.cell_diagnostics_disp(
                              c[i], r[i], n[i], t[i], w[i], m[i])))
                what.append(f"batch of {nb}: {bad} cells differ from each "
                            f"archive's own launch")
            else:
                bad = sum(bits_mismatch(a, b, torch) for a, b in zip(
                    K.shard_diagnostics_disp(c, r, n, t, w, m)
                    + K.shard_diagnostics_dedisp(c, t, win, w, m),
                    K.cell_diagnostics_disp(c, r, n, t, w, m)
                    + K.cell_diagnostics_dedisp(c, t, win, w, m)))
                whole = K.cell_diagnostics_dedisp(c, t, win, w, m)
                full = [torch.full_like(x, -1.0) for x in whole]
                h = nsub // 2
                for lo, hi in ((0, h), (h, nsub)):
                    K.cell_diagnostics_dedisp(
                        c[lo:hi], t, win, w[lo:hi].contiguous(),
                        m[lo:hi].contiguous(), out=[f[lo:hi] for f in full])
                tiles = sum(bits_mismatch(a, b, torch)
                            for a, b in zip(full, whole))
                what.append(f"K10: {bad} cells differ from K2's and K6's; "
                            f"out= tiles of two subint halves: {tiles} "
                            f"cells differ from the whole")
                bad += tiles
                if storage == "bfloat16":
                    up = dict(o, cube=c.float(), base=o["base"].float())
                    b16 = sum(bits_mismatch(x, y, torch)
                              for (_, k16, _), (_, k32, _) in zip(
                                  fft_forms(o), fft_forms(up))
                              for x, y in zip(k16(), k32()))
                    what.append(f"bf16 against float32 on the upcast cube: "
                                f"{b16} cells differ")
                    bad += b16
            ok_all &= bad == 0
            if build == "_fft":
                p = K.cell_fft_plan(nbin, c.element_size())
                how = f"K2f, {p.cluster} blocks a cell, odd part {p.odd}"
            else:
                p = K.cell_fft_global_plan(nbin, c.element_size())
                how = (f"K2g cluster mode, {p.n} points, {p.cluster} blocks "
                       f"a cell, odd part {p.odd}" if p.mode == "cluster"
                       else f"K2g {p.mode}, {p.n} points in passes of "
                       f"{' x '.join(map(str, p.passes))}")
            print(f"L5e {storage} {(nb or 1, nsub, nchan, nbin)} ({how}): "
                  f"largest error over (|plain| + plane scale) "
                  f"{', '.join(errs)} (tolerance {rtol:g}); "
                  f"{'; '.join(what)} (tolerance: bit-equal) {tag}",
                  flush=True)
            del o
    torch.cuda.empty_cache()
    print(f"phase L5e: {time.perf_counter() - t0:.1f} s", flush=True)
    if not ok_all:
        fail("L5e: a K2g entry or K2f's mixed odd stages disagree with the "
             "plain version, K10 with K2/K6, a batch, a tile or bf16")
    return out


def make_l5_archive(label, dev):
    """The (L5) archive ``label`` of L5_ARCHIVES: the golden's pulse, RFI
    density rules and fields, float64, its noise drawn and its dispersion
    run on the card (``make_synthetic_archive(..., device=dev)``): numpy
    takes 55.5, 205.8 and 71.6 s an archive on a worker of the card's
    host, and three such builds on the archive pool slowed fleet (f2)'s
    execute stage past its 6 s watchdog (PERF.md §6)."""
    from iterative_cleaner_torch.io.synthetic import (
        bench_rfi_density,
        make_synthetic_archive,
    )

    (nsub, nchan, nbin), period_s, seed = L5_ARCHIVES[label]
    ar, _ = make_synthetic_archive(nsub=nsub, nchan=nchan, nbin=nbin,
                                   **bench_rfi_density(nsub, nchan),
                                   period_s=period_s, seed=seed,
                                   dtype=np.float64, disperse=True,
                                   device=dev)
    return ar


def l5_phase(mesh1, counts, clean_ms, peak_gib, dev, tag):
    """(L5) Each L5_ARCHIVES archive (:func:`make_l5_archive`) through
    ``clean_archive`` on the card under L5_RUNS, each clean counted: its
    route's FFT build (K2g: the split row at L5a and L5c, the cluster
    mode at L5b) once an iteration and no other spectrum launch (no DFT,
    no ``torch.fft``).  The float32 masks against the float64 ones
    (L5_FLIP_PAIRS) by the goldens' flip rule; the dedispersed mask
    against the default by the frames' contract; the sharded clean
    bit-equal to the whole.  On the first iteration's operands of
    L5_TIMED_RUNS: the FFT build held to its plain version at full width
    (K2g's d_fft on every cell by the tolerance), the path's
    other kernels too (:func:`l3_kernel_checks`), the float32 build also
    within 1e-4 of the float64 plain version on the upcast operands (the
    float32 Bluestein's error); timed: the build against its bound, its
    plain version, ``torch.fft.rfft`` alone on the centred rows, ms an
    iteration, the launch's own peak memory (K2g's scratch) and the
    clean's.  Returns the timed builds by counter name and
    archive, and the other kernels' checks."""
    import torch

    import iterative_cleaner_torch.engine.loop as loop
    from iterative_cleaner_torch import CleanConfig
    from iterative_cleaner_torch.backends import (
        clean_archive,
        clean_archive_sharded,
    )
    from iterative_cleaner_torch.engine.loop import (
        ROUTE_KERNELS,
        SHARD_KERNELS,
        select_route,
        spectrum_kernels,
        storage_kernels,
    )
    from iterative_cleaner_torch.stats import kernels as K

    timed, checks = {}, {}
    common = dict(chanthresh=CleanConfig().chanthresh,
                  subintthresh=CleanConfig().subintthresh)
    for label in L5_ARCHIVES:
        t_arch = time.perf_counter()
        ar = make_l5_archive(label, dev)
        torch.cuda.empty_cache()
        S, C, B = ar.data.shape[0], ar.data.shape[2], ar.data.shape[3]
        print(f"{label}: {S}x{C}x{B} archive made in "
              f"{time.perf_counter() - t_arch:.1f} s", flush=True)
        res, cfgs = {}, {}
        for run, kw, sharded in L5_RUNS[label]:
            key = f"{label} {run}"
            cfg = cfgs[run] = CleanConfig(**kw)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            K.reset_launch_counts()
            t0 = time.perf_counter()
            r = res[run] = (clean_archive_sharded(ar, cfg, mesh1) if sharded
                            else clean_archive(ar, cfg))
            torch.cuda.synchronize()
            clean_ms[key] = (time.perf_counter() - t0) * 1e3
            counts[key] = K.launch_counts()
            peak_gib[key] = torch.cuda.max_memory_allocated() / 2 ** 30
            route = select_route(cfg, ar.dedispersed)
            table = SHARD_KERNELS if sharded else ROUTE_KERNELS
            own = storage_kernels(spectrum_kernels(table[route], B, cfg.dtype),
                                  cfg.compute_dtype, cfg.dtype)
            want = {k: (r.loops if k in own else 0) for k in counts[key]}
            used = {k: v for k, v in counts[key].items() if v}
            print(f"{key}: {S}x{C}x{B} ({route} route"
                  f"{', one NCCL rank' if sharded else ''}, {cfg.dtype}): "
                  f"kernels {json.dumps(used)}, {r.loops} loops, whole clean "
                  f"{clean_ms[key]:.1f} ms, peak device memory "
                  f"{peak_gib[key]:.2f} GiB {tag}", flush=True)
            if counts[key] != want:
                fail(f"{key}: launches {used}, want each of the route's "
                     f"kernels (its FFT build in place of the DFT one) once "
                     f"an iteration: {want}")
            if r.final_weights.shape != (S, C) or not np.all(
                    np.isfinite(r.scores[r.final_weights != 0])):
                fail(f"{key}: weights or scores malformed")
        for run32, run64 in L5_FLIP_PAIRS:
            if run32 not in res:
                continue
            r32, r64 = res[run32], res[run64]
            flips = np.argwhere((r32.final_weights == 0)
                                != (r64.final_weights == 0))
            wide = [(int(i), int(c)) for i, c in flips
                    if abs(float(r64.scores[i, c]) - 1.0) > FLIP_NOISE_ENV]
            print(f"{label} {run32} against {run64}: {len(flips)} mask flips "
                  f"(limit {MAX_BORDERLINE_FLIPS}), {len(wide)} of them with "
                  f"|score64 - 1| > {FLIP_NOISE_ENV}; loops {r32.loops} and "
                  f"{r64.loops} {tag}", flush=True)
            if len(flips) > MAX_BORDERLINE_FLIPS or wide \
                    or r32.loops != r64.loops:
                fail(f"{label}: the {run32} clean's float32 mask breaks the "
                     f"flip rule against the float64 one")
        base = res["default"]
        if "dedispersed" in res:
            contract("dedispersed", base, res["dedispersed"])
        if "sharded 1" in res:
            got = res["sharded 1"]
            n = int(((got.final_weights == 0) != (base.final_weights == 0))
                    .sum())
            n_bits = bits_mismatch(torch.from_numpy(got.scores),
                                   torch.from_numpy(base.scores), torch)
            print(f"{label} sharded 1 against {label} default: {n} mask "
                  f"cells and {n_bits} scores differ in bits (tolerance: 0 "
                  f"and 0); loops {got.loops} and {base.loops} {tag}",
                  flush=True)
            if n or n_bits or got.loops != base.loops:
                fail(f"{label}: the sharded clean differs from the whole")
        del res, base, r32, r64

        for run in L5_TIMED_RUNS:
            if run not in cfgs:
                continue
            key, cfg = f"{label} {run}", cfgs[run]
            sfx = "_f64" if cfg.dtype == "float64" else ""
            prep, weights, mask, name, kfn, pfn, wfn, pfn64 = l3_operands(
                ar, cfg, dev, shard=run.startswith("sharded"))
            build = build_fft_name(B, cfg.dtype)
            name_fft = f"{name}{build}{sfx}"
            got, want = kfn(), pfn()
            err = max_abs_diff_planes(got, want, torch)
            rel, ok = plane_err(got, want, mask,
                                F64_PLANE_RTOL if sfx else K2_RTOL, torch,
                                fft_masked_exact=build == "_fft")
            del want
            rel64 = None
            if not sfx:
                # the float32 build against the float64 plain version on
                # the same operands (Bluestein's float32 error)
                want64 = pfn64()
                rel64, ok64 = plane_err([g.double() for g in got], want64,
                                        mask, K2_RTOL, torch,
                                        fft_masked_exact=False)
                ok &= ok64
                del want64
            checks_ok = l3_kernel_checks(key, prep, weights, mask, got, cfg,
                                         sfx, checks, tag)
            del got
            wres = wfn()
            centred = wres - torch.where(
                mask, torch.zeros_like(wres[..., 0]),
                wres.mean(dim=-1))[..., None]
            del wres
            rfft_ms = cuda_ms(lambda: torch.fft.rfft(centred, dim=-1), 3,
                              torch)
            del centred
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base_mem = torch.cuda.memory_allocated()
            ms = cuda_ms(kfn, 5, torch)
            own_peak = (torch.cuda.max_memory_allocated() - base_mem) \
                / 2 ** 30
            plain_ms = cuda_ms(pfn, 2, torch)
            it_ms = cuda_ms(lambda: loop.iteration_step(
                prep, weights, weights, mask, rotation=cfg.rotation,
                baseline_duty=cfg.baseline_duty, **common), 3, torch)
            bms, bby = profiling.kernel_bounds(
                S, C, B, cube_bytes=8 if sfx else 4)[
                    name_fft.replace("_f64", "")]
            plan = (K.cell_fft_plan if build == "_fft"
                    else K.cell_fft_global_plan)(B, 8 if sfx else 4)
            if label == "L5b" and getattr(plan, "mode", None) != "cluster":
                fail(f"{key}: (L5b) did not take K2g's cluster mode")
            if getattr(plan, "mode", None) == "cluster":
                # no scratch: the launch allocates its planes and the
                # template row, under one row of the passes' scratch
                row = plan.n * 2 * (8 if sfx else 4) / 2 ** 30
                if not own_peak < row:
                    fail(f"{key}: K2g's cluster mode allocated "
                         f"{own_peak:.4f} GiB, a row of scratch or more")
            timed.setdefault(name_fft, {})[label] = {
                "launches": counts[key][name_fft], "max_abs_err": err,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                "bound_by": bby, "rfft_ms": rfft_ms, "iteration_ms": it_ms,
                "launch_peak_gib": own_peak, "clean_peak_gib": peak_gib[key],
                "f64_plain_err": rel64, "shape": [S, C, B],
                "plan": plan._asdict()}
            mode = getattr(plan, "mode", "K2f")
            print(f"time {name_fft} ({key}, {S} x {C} x {B}, {mode}): "
                  f"{ms:.4f} ms, "
                  f"bound {bms:.4f} ms ({bby}), plain {plain_ms:.4f} ms, "
                  f"torch.fft.rfft alone on the centred rows {rfft_ms:.4f} "
                  f"ms; {it_ms:.3f} ms per iteration (device, resident "
                  f"cube); the launch's own peak memory (its outputs and "
                  f"scratch) {own_peak:.3f} GiB; against its plain version "
                  f"{rel:.2e} of each plane's scale"
                  + ("" if rel64 is None else
                     f", against the float64 plain version {rel64:.2e}")
                  + f": {'ok' if ok else 'FAIL'}; whole clean "
                  f"{clean_ms[key]:.1f} ms, peak device memory "
                  f"{peak_gib[key]:.2f} GiB {tag}", flush=True)
            if not ok:
                fail(f"{key}: the FFT build disagrees with its plain version "
                     f"at full width")
            if not checks_ok:
                fail(f"{key}: K1, K3, the combine or K9 disagrees with its "
                     f"plain version on the first iteration's operands at "
                     f"full width")
            del prep, weights, mask, kfn, pfn, wfn, pfn64
            torch.cuda.empty_cache()
        del ar
        print(f"phase {label}, {S} x {C} x {B}: "
              f"{time.perf_counter() - t_arch:.1f} s", flush=True)
    return timed, checks


def l5_entries(timed, small, counts):
    """The kernels line's rows of K2g: each counter name launched in an
    (L5) clean, timed at full width where the main path ran it (its first
    archive's numbers on the row, every archive's under ``full_width``),
    else at L5e's small width; its launches on the (L5) cleans."""
    rows = []
    launched = {name for key, c in counts.items() if key.startswith("L5")
                for name, v in c.items() if v and "_fftg" in name}
    for name in sorted(launched):
        by_route = {k: c[name] for k, c in counts.items() if c.get(name)}
        if name in timed:
            first = next(iter(timed[name].values()))
            row = {k: first[k] for k in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "shape", "launches")}
            row["max_abs_err"] = max(
                [t["max_abs_err"] for t in timed[name].values()]
                + [small.get(name, {}).get("max_abs_err", 0.0)])
            row["full_width"] = timed[name]
        elif "ms" in small.get(name, {}):
            s = small[name]
            row = {k: s[k] for k in ("ms", "plain_ms", "bound_ms",
                                     "bound_by", "shape", "max_abs_err")}
            row["launches"] = sum(by_route.values())
        else:
            fail(f"L5: {name} was launched on the main path but not timed")
        rows.append({"name": name, "route": "cuda", "source": K2G_SOURCE,
                     "replaces": FFT_REPLACES, **row, "library_ms": None,
                     "launches_by_route": by_route})
    return rows


def main() -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args()

    if not os.path.isdir(os.path.join(HERE, "iterative_cleaner_torch")) \
            or profiling is None:
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
    from iterative_cleaner_torch.io import native as host_io
    from iterative_cleaner_torch.io.synthetic import (
        FULLSIZE_SHAPE,
        make_fullsize_archive,
        make_synthetic_archive,
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

    # ---- 1. build the kernels from source, and beside them the host
    # I/O library (g++) the CLI phases read and write archives through
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=1) as pool:
        host_build = pool.submit(host_io.build_library)
        lib_path = K.build_library()
        host_path = host_build.result()
    K.load_library()
    host_io.load_library()
    build_s = time.perf_counter() - t0
    print(f"build: {os.path.relpath(lib_path, HERE)} and "
          f"{os.path.relpath(host_path, HERE)} in {build_s:.1f} s",
          flush=True)
    log_path = os.path.join(K.build_dir(), "build.log")
    if os.path.exists(log_path):
        for line in open(log_path):
            if "registers" in line or "spill" in line or line.startswith("=="):
                print("  " + line.strip())
    fleet_work = tempfile.mkdtemp(prefix="icln_chip_smoke_fleet_")
    atexit.register(shutil.rmtree, fleet_work, True)
    # the batch phase's other full-size archives, built on worker
    # processes while the phases before it run
    import multiprocessing

    batch_dir = tempfile.mkdtemp(prefix="icln_chip_smoke_batch_")
    atexit.register(shutil.rmtree, batch_dir, True)
    archive_pool = ProcessPoolExecutor(
        max_workers=len(FULLSIZE_BATCH_SEEDS),
        mp_context=multiprocessing.get_context("spawn"))
    fullsize_futs = [archive_pool.submit(build_fullsize_seed, s, batch_dir)
                     for s in FULLSIZE_BATCH_SEEDS]
    # and the single-pulse archive of phase 3p, after them
    sp_dir = tempfile.mkdtemp(prefix="icln_chip_smoke_single_pulse_")
    atexit.register(shutil.rmtree, sp_dir, True)
    sp_fut = archive_pool.submit(build_single_pulse, sp_dir)
    # and the long-profile archive of phase L3, after it
    lp_dir = tempfile.mkdtemp(prefix="icln_chip_smoke_long_profile_")
    atexit.register(shutil.rmtree, lp_dir, True)
    lp_fut = archive_pool.submit(build_long_profile, lp_dir)
    # and the fleet phases' PSRFITS files, on a worker of their own
    fleet_pool = ProcessPoolExecutor(
        max_workers=1, mp_context=multiprocessing.get_context("spawn"))
    fleet_files_fut = fleet_pool.submit(fleet_files, fleet_work)

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

    # ---- 3m. --model quicklook on the card: K6 (zero template), K3 x 2
    # and the combine, float32 and float64; tools sweep on both models
    quicklook_phase(ar, counts, clean_ms, peak_gib, dev, tag)
    sweep_phase(tag)
    # ---- 3o. the online mode: (o1) a solo stream, (o2) a mux of 16
    # streams, (o3) the step's kernels at nsub = 1 and in lanes, (o4)
    # --stream DIR and --mux DIR..., (o5) --model online_ewt
    online_times = online_phases(ar, counts, dev, tag)

    # ---- 3j. batches of equal-shaped archives (parallel/batch.py), each
    # kernel launched once per batch iteration: (a) BATCH_SEEDS small
    # archives on the default route, (b) on the other routes, each held
    # to its single cleans; (c) four full-size archives, the golden's
    # among them; (d) the CLI's --batch against a sequential session
    batch_times, batch_shapes, batch_ars = batch_phases(
        ar, results["default"], counts, clean_ms, peak_gib, dev, tag,
        fullsize_futs)
    # the single-pulse archive may still be building: its worker is
    # reaped after phase 3p
    archive_pool.shutdown(wait=False)
    shutil.rmtree(batch_dir, ignore_errors=True)
    batch_cli_phase(tag)
    # ---- 3n. the fleet (--fleet): (f1) a mixed fleet against --batch and
    # the sequential session, (f2) the injected ladder, (f3) a real OOM,
    # (f4) kill -9 and --resume, (f5) a cold then a warm --compile-cache
    # session, (f6) two hosts over one journal
    fleet_phases(fleet_work, fleet_files_fut, tag)
    fleet_pool.shutdown()

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
            want = stream_counts(STREAM_KERNELS[engine_route], counts[key],
                                 r.loops, n_tiles)
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

    # ---- 3c. the cell-sharded clean on one rank under NCCL, counted like
    # the whole cleans, held to their masks and scores bit for bit: the
    # default route and the dedispersed frame (K10 on the whole cube, the
    # scalers' selects as real NCCL all-reduces over one rank), and the
    # two_read route under the profile baseline and a pulse window (K7 on
    # the block, the gathered scaler and K9 through a real NCCL gather)
    store_dir = tempfile.mkdtemp(prefix="icln_chip_smoke_")
    distributed.initialize("nccl", f"file://{store_dir}/store",
                           device="cuda:0", rank=0, world_size=1)
    mesh1 = cell_mesh()
    # run name: (its configuration, the whole clean it is held to)
    shard_runs = {
        "default": (configs["default"], "default"),
        "dedispersed": (configs["dedispersed"], "dedispersed"),
        "profile": (configs["profile"], "profile"),
        "pulse window": (CleanConfig(pulse_region=(0.2, 30, 60)),
                         "pulse_unload"),
    }
    for name, (cfg_s, base_name) in shard_runs.items():
        key = f"sharded 1 ({name})"
        engine_route = select_route(cfg_s, ar.dedispersed)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        results[key] = r = clean_archive_sharded(ar, cfg_s, mesh1)
        torch.cuda.synchronize()
        clean_ms[key] = (time.perf_counter() - t0) * 1e3
        counts[key] = K.launch_counts()
        peak_gib[key] = torch.cuda.max_memory_allocated() / 2 ** 30
        want = {k: (r.loops if k in SHARD_KERNELS[engine_route] else 0)
                for k in counts[key]}
        base = results[base_name]
        n_mask = int(((r.final_weights == 0)
                      != (base.final_weights == 0)).sum())
        n_bits = bits_mismatch(torch.from_numpy(r.scores),
                               torch.from_numpy(base.scores), torch)
        print(f"{key}, one NCCL rank, route {engine_route}: kernels "
              f"{json.dumps(counts[key])}, {r.loops} loops, whole clean "
              f"{clean_ms[key]:.1f} ms, peak device memory "
              f"{peak_gib[key]:.2f} GiB; against the whole {base_name} "
              f"clean: {n_mask} mask cells and {n_bits} scores differ in "
              f"bits (tolerance: 0 and 0) {tag}", flush=True)
        if counts[key] != want:
            fail(f"{key}: launch counts {counts[key]}, want {want}")
        if n_mask or n_bits or (r.loops, r.converged) != (base.loops,
                                                          base.converged) \
                or not np.array_equal(r.iter_metrics, base.iter_metrics):
            fail(f"{key}: mask, scores, loops or telemetry differ from the "
                 f"whole clean")
    golden_check("sharded 1 (default)", results["sharded 1 (default)"], "",
                 (NSUB, NCHAN))
    golden_check("sharded 1 (profile)", results["sharded 1 (profile)"],
                 "_profile", (NSUB, NCHAN))

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
    r4p = results["sharded 4 (gloo, profile)"] = ranks[0]["profile_result"]
    for rk in ranks:
        for route, res, pre in (("default", r4, ""),
                                ("two_read", r4p, "profile_")):
            got = rk[pre + "counts"]
            want = {k: (res.loops if k in SHARD_KERNELS[route] else 0)
                    for k in got}
            print(f"sharded 4 (gloo{', profile' if pre else ''}) rank "
                  f"{rk['rank']} {tuple(rk['coords'])}, block {rk['block']}:"
                  f" kernels {json.dumps(got)}, whole clean "
                  f"{rk[pre + 'clean_ms']:.1f} ms, "
                  + ("" if pre else f"{rk['iter_ms']:.1f} ms per iteration "
                     f"(host, 3 iterations between barriers), ")
                  + f"peak device memory {rk[pre + 'peak_gib']:.2f} GiB "
                  f"{tag}", flush=True)
            if got != want:
                fail(f"sharded 4 (gloo) rank {rk['rank']} ({route}): launch "
                     f"counts {got}, want {want}")
    print(f"sharded 4 (gloo): {GLOO_RANKS} rank processes in {gloo_s:.1f} s "
          f"(start-up, mapping, cleans of both routes, timing), {r4.loops} "
          f"and {r4p.loops} loops {tag}", flush=True)
    whole_contract("sharded 4 (gloo)", r4, whole)
    golden_check("sharded 4 (gloo)", r4, "", (NSUB, NCHAN))
    whole_contract("sharded 4 (gloo, profile)", r4p, results["profile"],
                   "profile")
    golden_check("sharded 4 (gloo, profile)", r4p, "_profile", (NSUB, NCHAN))

    # ---- 3i. streaming over a cell mesh: on the one NCCL rank at full
    # size, (a), (c) and (d) again, each bit-equal to its single-card
    # stream with the same launch counts (exact) or a one-rank sharded
    # clean per tile (online); then four gloo ranks streaming a cut
    # archive, mask-equal to the single-card exact stream
    shard_streams = {"a": "stream (a)", "c": "stream (c)", "d": "stream (d)"}
    for run, base_key in shard_streams.items():
        chunk, cfg_s, mode = streams[run]
        key = f"shard stream ({run})"
        reg = stream_regs[key] = DictRegistry()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        results[key] = r = clean_streaming(ar, chunk, cfg_s, mesh1,
                                           mode=mode, registry=reg)
        torch.cuda.synchronize()
        clean_ms[key] = (time.perf_counter() - t0) * 1e3
        counts[key] = K.launch_counts()
        peak_gib[key] = torch.cuda.max_memory_allocated() / 2 ** 30
        base = results[base_key]
        n_bits = bits_mismatch(torch.from_numpy(r.final_weights),
                               torch.from_numpy(base.final_weights), torch) \
            + bits_mismatch(torch.from_numpy(r.scores),
                            torch.from_numpy(base.scores), torch)
        if mode == "exact":
            want = stream_counts(
                STREAM_KERNELS[select_route(cfg_s, ar.dedispersed)],
                counts[key], r.loops, -(-NSUB // chunk))
            h2d = reg.counters["stream_h2d_bytes"]
            # the preamble uploads the cube and the weights once; each
            # iteration uploads the rest
            per_iter = (h2d - cube_bytes - NSUB * NCHAN * 4) / r.loops
            what = (f"{stream_line(reg.gauges)}; H2D {h2d} bytes (the "
                    f"single-card stream "
                    f"{stream_regs[run].counters['stream_h2d_bytes']}), "
                    f"{per_iter:.0f} an iteration after the preamble")
        else:
            n_it = counts[key]["combine_zap"]
            want = {k: (n_it if k in SHARD_KERNELS["default"] else 0)
                    for k in counts[key]}
            what = f"{n_it} tile iterations, each a one-rank sharded clean's"
        print(f"{key} {mode} over one NCCL rank, {-(-NSUB // chunk)} tiles "
              f"of {chunk}: kernels {json.dumps(counts[key])}, {r.loops} "
              f"loops, whole clean {clean_ms[key]:.1f} ms; {what}; peak "
              f"device memory {peak_gib[key]:.2f} GiB; against {base_key}: "
              f"{n_bits} cells differ in bits (weights and scores; "
              f"tolerance: bit-equal) {tag}", flush=True)
        if counts[key] != want:
            fail(f"{key}: launch counts {counts[key]}, want {want}")
        if n_bits or (r.loops, r.converged) != (base.loops, base.converged):
            fail(f"{key}: differs from {base_key}")
    golden_check("shard stream (c)", results["shard stream (c)"], "_profile",
                 (NSUB, NCHAN))
    # ---- 3k. the bf16 storage mode (compute_dtype='bfloat16') on the
    # golden archive, a bf16-exact archive, stream (a), batch (a) and the
    # one NCCL rank
    bf16_phases(ar, results, counts, clean_ms, peak_gib, stream_regs, mesh1,
                batch_ars, dev, tag)
    # ---- 3l. float64 (dtype='float64'): the golden archive on every route
    # held to the goldens with no flip, stream (a), selftest and the numpy
    # oracle, the float64 builds against their plain versions, long lines
    f64_kernels = float64_phases(ar, configs, results, counts, clean_ms,
                                 peak_gib, stream_regs, mesh1, dev, tag)
    # ---- batch (e): --mesh batch over the one NCCL rank and over four
    # gloo ranks sharing the card
    batch_mesh_phase(batch_ars, counts, tag)
    ar_s, _ = make_synthetic_archive(**SHARD_STREAM_ARCHIVE)
    single = clean_streaming(ar_s, SHARD_STREAM_CHUNK,
                             CleanConfig(stream_hbm_mb=0))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="icln_chip_smoke_ranks_") as wd:
        try:
            ranks = distributed.run_local_ranks(
                gloo_stream_rank, GLOO_RANKS, (), workdir=wd,
                device="cuda:0", backend="gloo", timeout_s=GLOO_TIMEOUT_S)
        except (RuntimeError, TimeoutError) as exc:
            fail(f"shard stream 4 (gloo): {exc}")
    gloo_s = time.perf_counter() - t0
    r4s = results["shard stream 4 (gloo)"] = ranks[0]["result"]
    shape_s = tuple(SHARD_STREAM_ARCHIVE[k] for k in ("nsub", "nchan",
                                                      "nbin"))
    want = stream_counts(STREAM_KERNELS["default"], ranks[0]["counts"],
                         r4s.loops, -(-ar_s.nsub // SHARD_STREAM_CHUNK))
    for rk in ranks:
        g, c = rk["gauges"], rk["counters"]
        print(f"shard stream 4 (gloo) rank {rk['rank']} "
              f"{tuple(rk['coords'])}, exact, {shape_s} in tiles of "
              f"{SHARD_STREAM_CHUNK}: kernels {json.dumps(rk['counts'])}, "
              f"whole clean {rk['clean_ms']:.1f} ms; {stream_line(g)}; H2D "
              f"{c['stream_h2d_bytes']} bytes; peak device memory "
              f"{rk['peak_gib']:.2f} GiB {tag}", flush=True)
        if rk["counts"] != want:
            fail(f"shard stream 4 (gloo) rank {rk['rank']}: launch counts "
                 f"{rk['counts']}, want {want}")
    n_mask = int(((r4s.final_weights == 0)
                  != (single.final_weights == 0)).sum())
    print(f"shard stream 4 (gloo): {GLOO_RANKS} rank processes in "
          f"{gloo_s:.1f} s (start-up, archive, stream), {r4s.loops} loops; "
          f"against the single-card exact stream: {n_mask} mask cells "
          f"differ (tolerance: 0), {int((single.final_weights == 0).sum())} "
          f"zapped {tag}", flush=True)
    if n_mask or (r4s.loops, r4s.converged) != (single.loops,
                                                single.converged):
        fail("shard stream 4 (gloo): mask or loops differ from the "
             "single-card exact stream")

    # ---- (m2)-(m4): the float64 cell mesh on four gloo ranks, batch (a)
    # in float64, the hybrid batch-cell mesh
    multiprocess_phases(batch_ars, counts, clean_ms, tag)

    # ---- 3e. the CLI session a user runs, on the archive as PSRFITS,
    # counted like the default whole clean and held to it, its load
    # through the native reader (held bit for bit to the pure-Python
    # one); 3h. the same archive as .icar and as PSRFITS in one session
    # with --prefetch 1
    serve_launches = cli_phase(ar, whole, counts["default"],
                               tag)["serve_launches"]
    # ---- 3q. the control plane, after the fleet and serve phases: the
    # --selfcheck (lint and card contracts) on a spawned process, the
    # journals' fsck, a seeded host sync caught
    control_plane_phase(dev, tag)

    # ---- 3f. long profiles: an archive of 8192 bins (the DFT tables
    # streamed in chunks, two cells a group) on the default,
    # profile-baseline and dedispersed routes, masks held to the port's
    # CPU clean, each kernel to its plain version
    long_phase(configs, dev, tag)

    # ---- 3g. scaler lines longer than a block holds: K3 and K8 on
    # 50,000-entry lines (the cluster kernel in place of K3), and an exact
    # stream at budget 0 of an archive of 48,000 subints, its mask held to
    # the whole clean's; lines past the cluster's capacity (K9 and the
    # tail kernels)
    long_line_phase(dev, counts, clean_ms, tag)
    past_capacity_phase(dev, counts, tag)
    # ---- 3p. the single-pulse archive (65,536 x 128 x 64) through
    # clean_archive: the channel scaler one cluster launch an iteration,
    # held to the clean through scaled_sides_long; the cluster kernel and
    # the tail kernels timed at its planes
    long_entries = single_pulse_phase(sp_fut, dev, counts, clean_ms,
                                      peak_gib, tag)
    # ---- 3r. long profiles past the DFT tables (csrc/cell_fft.cu, the FFT
    # build): (L1) every entry against its plain version in three dtypes,
    # clusters and one block a cell, a batch; (L2) the DFT route and the
    # FFT build on the same inputs at 8192 and 16,384 bins; (L3) the
    # 32 x 256 x 65536 archive through clean_archive (default, dedispersed,
    # float64; profile, sharded), counted, held to the flip rule, every
    # kernel of the path held to its plain version at that width, timed
    fft_l1 = l1_phase(dev, tag)
    fft_l2 = l2_phase(dev, tag)
    l4_phase(dev, tag)
    fft_l3, l3_checks = l3_phase(lp_fut, mesh1, counts, clean_ms, peak_gib,
                                 dev, tag)
    # ---- 3s. every profile length the reference cleans: (L5e) K2g's
    # entries and K2f's mixed odd stages against their plain versions in
    # three dtypes; (L5) the 32 x 256 x 60000, 32 x 256 x 65521 and 16 x 64
    # x 524288 archives through clean_archive, counted, held to the flip
    # rule, timed
    fft_l5e = l5_entries_phase(dev, tag)
    fft_l5, l5_checks = l5_phase(mesh1, counts, clean_ms, peak_gib, dev,
                                 tag)
    archive_pool.shutdown()

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

    # the bf16 builds of K1, K2, K7, K6 and K10 on the same inputs, the
    # cubes narrowed as a bf16 clean stores them: bit-equal to the
    # float32 launch on the upcast cubes, and within the float32
    # tolerances of the plain version (which upcasts on read)
    n16 = lambda t: t.to(torch.bfloat16)   # noqa: E731
    pp = ri["p"]
    disp16, ded16 = n16(disp), n16(pd.ded)
    bf16_in = {
        "weighted_marginals": ((disp16,), (weights,)),
        "cell_diagnostics_disp": ((disp16,),
                                  (rot_t, nyq, template, weights, mask)),
        "cell_diagnostics_two_read": ((n16(pp.ded), n16(pp.disp_base)),
                                      (ri["rot_t_p"], ri["t_p"], weights,
                                       mask)),
        "cell_diagnostics_dedisp": ((ded16,), (t_d, pd.window, weights,
                                               mask)),
        "shard_diagnostics_disp": ((disp16,),
                                   (rot_t, nyq, template, weights, mask)),
        "shard_diagnostics_dedisp": ((ded16,), (t_d, pd.window, weights,
                                                mask)),
    }
    bf16_plain = {
        "weighted_marginals": K.weighted_marginals_plain,
        "cell_diagnostics_disp": K.cell_diagnostics_disp_plain,
        "cell_diagnostics_two_read": K.cell_diagnostics_two_read_plain,
        "cell_diagnostics_dedisp": K.cell_diagnostics_dedisp_plain,
        "shard_diagnostics_disp": K.cell_diagnostics_disp_plain,
        "shard_diagnostics_dedisp": K.cell_diagnostics_dedisp_plain}
    bf16_err, ok16 = {}, True
    for name, (cubes, rest) in bf16_in.items():
        fn = getattr(K, name)
        got = fn(*cubes, *rest)
        bits = sum(bits_mismatch(g, w, torch) for g, w in zip(
            got, fn(*(c.float() for c in cubes), *rest)))
        if name == "weighted_marginals":
            err, ok = check_k1(cubes[0], weights, " (bf16 cube)")
        else:
            err, ok = diags_check(got, bf16_plain[name](*cubes, *rest), mask,
                                  torch)
        bf16_err[name] = err
        ok16 &= ok and bits == 0
        print(f"check {name} (bf16 cube {tuple(cubes[0].shape)}): {bits} "
              f"values differ in bits from the float32 launch on the upcast "
              f"cube (tolerance: bit-equal); against the plain version max "
              f"abs {err:.3e}: {'ok' if ok and bits == 0 else 'FAIL'}",
              flush=True)
        del got

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
    # batch (a)'s one batch iteration in a trace, on a process of its own
    batch_trace_phase(tag)
    if not (ok1 and all(diag_ok.values()) and all(k10_ok.values())
            and ok16 and ok3[0] and ok3[1] and okc and ok8 and ok9):
        fail("a kernel disagrees with its plain version")

    # ---- 5. times: kernel, plain version, library yardstick, bound ----
    S, C, B = NSUB, NCHAN, NBIN
    kb = profiling.kernel_bounds(S, C, B)
    b1, b2, b7, b6, b3, bc, b9 = (kb[k] for k in (
        "weighted_marginals", "cell_diagnostics_disp",
        "cell_diagnostics_two_read", "cell_diagnostics_dedisp",
        "scaled_sides_axis0", "combine_zap", "masked_median"))
    # K4 and K5 are one launch on the TPU
    b4, b5 = kb["fused_sweep"], kb["fused_sweep_dedisp"]
    b8 = kb["fused_combine"]
    # K10 on a 2 x 2 shard: K2's and K6's bounds at half of each axis
    kbq = profiling.kernel_bounds(S // 2, C // 2, B)
    b2q, b6q = kbq["cell_diagnostics_disp"], kbq["cell_diagnostics_dedisp"]
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
    # the bf16 builds: their cube bytes at 2 a sample, their launches in
    # the bf16 phases' runs of their routes, no library call computing the
    # same function (a bf16 einsum rounds its output to bf16)
    kb16 = profiling.kernel_bounds(S, C, B, cube_bytes=2)
    kb16["shard_diagnostics_disp"] = kb16["cell_diagnostics_disp"]
    kb16["shard_diagnostics_dedisp"] = kb16["cell_diagnostics_dedisp"]
    bf16_route = {"weighted_marginals": "bf16 default",
                  "cell_diagnostics_disp": "bf16 default",
                  "cell_diagnostics_two_read": "bf16 exact profile",
                  "cell_diagnostics_dedisp": "bf16 exact dedispersed",
                  "shard_diagnostics_disp": "bf16 sharded 1 (default)",
                  "shard_diagnostics_dedisp": "bf16 sharded 1 (dedispersed)"}
    for name, (src, replaces) in {
            e[0]: (e[1], e[2]) for e in entries
            if e[0] in bf16_in}.items():
        cubes, rest = bf16_in[name]
        entries.append((
            name + "_bf16", src, replaces, bf16_route[name], bf16_err[name],
            lambda fn=getattr(K, name), a=cubes + rest: fn(*a),
            lambda fn=bf16_plain[name], a=cubes + rest: fn(*a), None,
            kb16[name], 20 if name == "weighted_marginals" else 5))
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
            "library_ms": lms,
            # the kernel's launches in every counted run that launched it
            "launches_by_route": {r: c[name] for r, c in counts.items()
                                  if c.get(name)}})
        what = f"{launches} launches"
        if name in batch_times:
            # one launch for a whole batch, against B launches on one
            # archive, beside the batch's bound
            kernels[-1]["batch"] = {}
            for label, (bms_b, singles) in batch_times[name].items():
                nb_b, (bs, bc_, bb_) = batch_shapes[label]
                bound_b, by_b = profiling.kernel_bounds(bs, bc_, bb_)[name]
                kernels[-1]["batch"][label] = {
                    "ms": bms_b, "b_x_single_ms": singles,
                    "bound_ms": nb_b * bound_b, "bound_by": by_b}
                what += (f"; batch {label}: {bms_b:.4f} ms against "
                         f"{singles:.4f} ms for {nb_b} single launches, "
                         f"bound {nb_b * bound_b:.4f} ms ({by_b})")
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
    kernels.extend(long_entries)
    kernels.extend(f64_kernels)
    fft_rows = long_profile_entries(fft_l1, fft_l3, counts)
    fft_rows[0]["crossover"] = fft_l2
    for row in fft_rows:
        # K2f's mixed odd stages at (L5e)'s small width
        if row["name"] in fft_l5:
            row["l5"] = fft_l5[row["name"]]
        if row["name"] in fft_l5e:
            row["l5e_max_abs_err"] = fft_l5e[row["name"]]["max_abs_err"]
    kernels.extend(fft_rows)
    kernels.extend(l5_entries(fft_l5, fft_l5e, counts))
    for k in kernels:
        # the path's kernels held to their plain versions on the
        # long-profile archive's first iteration, (L3)
        if k["name"] in l3_checks:
            k["long_profile"] = l3_checks[k["name"]]
            k["max_abs_err"] = max(k["max_abs_err"],
                                   l3_checks[k["name"]]["max_abs_err"])
        # and on the (L5) archives' first iterations
        if k["name"] in l5_checks:
            k["l5"] = l5_checks[k["name"]]
            k["max_abs_err"] = max(k["max_abs_err"],
                                   l5_checks[k["name"]]["max_abs_err"])
        # the online step's kernels at its shapes, (o3)
        if k["name"] in online_times:
            k["online"] = online_times[k["name"]]
        # the serve daemon's launches in (s1) and (s2), on its process
        if k["name"] in SERVE_KERNELS:
            k["serve"] = {"launches": serve_launches.get(k["name"], 0)}
    ms_of = {k["name"]: k["ms"] for k in kernels}
    tail = (ms_of["scaled_sides_axis0"] + ms_of["scaled_sides_axis1"]
            + ms_of["combine_zap"])
    for seq, diag, (bms, bby) in (("K4", "cell_diagnostics_disp", b4),
                                  ("K5", "cell_diagnostics_dedisp", b5)):
        print(f"time {seq} as {diag} + scaled_sides x2 + combine_zap: "
              f"{ms_of[diag] + tail:.4f} ms, bound of the one-launch sweep "
              f"{bms:.4f} ms ({bby}) {tag}", flush=True)
    whole_iter_ms = {}
    for route, prep in preps.items():
        whole_iter_ms[route] = iter_ms = cuda_ms(
            lambda: iteration_step(prep, weights, weights, mask, **common), 5,
            torch)
        print(f"clean {route}: {results[route].loops} loops, whole clean "
              f"{clean_ms[route]:.1f} ms (upload, preamble, loop, download), "
              f"{iter_ms:.3f} ms per iteration (device, resident cubes), "
              f"peak device memory of the clean {peak_gib[route]:.2f} GiB "
              f"{tag}", flush=True)

    # the gathered scaler's gather: four diagnostic planes and the weights
    # stacked and gathered over the one NCCL rank
    gather_ms = cuda_ms(lambda: mesh1.gather_cells(
        torch.stack([*diags, weights])), 10, torch)
    for name, (_, base_name) in shard_runs.items():
        key = f"sharded 1 ({name})"
        prep = preps[base_name]
        iter_ms = cuda_ms(lambda: iteration_step(
            prep, weights, weights, mask, mesh=mesh1, **common), 5, torch)
        what = ""
        if prep.route == "two_read":
            what = (f"; the gather {gather_ms:.3f} ms of it "
                    f"({100 * gather_ms / iter_ms:.1f}%), the whole "
                    f"{base_name} clean's iteration "
                    f"{whole_iter_ms[base_name]:.3f} ms")
        print(f"clean {key}: {results[key].loops} loops, whole clean "
              f"{clean_ms[key]:.1f} ms, {iter_ms:.3f} ms per iteration "
              f"(device, resident shard, one NCCL rank){what}, peak device "
              f"memory of the clean {peak_gib[key]:.2f} GiB {tag}",
              flush=True)
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
