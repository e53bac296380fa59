"""iterative_cleaner_torch — the PyTorch/CUDA port of the iterative RFI
cleaner, for NVIDIA Hopper (H100).

The JAX package ``iterative_cleaner_tpu`` is the reference this package
is held against; nothing here imports it (or ``jax``).  The port runs
every whole-archive route of the reference engine: the default
configuration (integration baseline, dispersed stats frame, no pulse
window, a non-DEDISP input — the reference's ``disp_iteration``), the
two-read route (the pulse window ``-r``, ``baseline_mode='profile'``,
DEDISP=1 inputs) and the dedispersed stats frame, each with ``-u``; and
the same routes in subint tiles (:func:`clean_streaming`): exactly, with
the tiles held in host memory for archives larger than the card, or
online, each tile on its own; and the default route and the dedispersed
frame over the ranks of a ``torch.distributed`` process group, each rank
holding one (subint, channel) block on its own card
(:func:`clean_archive_sharded`); and equal-shaped archives cleaned as one
batch, each kernel launched once per iteration for the whole batch,
optionally split over the ranks (:func:`clean_archives_batched`, the
CLI's ``--batch B`` and ``--mesh batch``).  Its CLI runs the reference's session
over archives: ``.npz``, ``.icar``, fold-mode PSRFITS and TIMER ``.ar``
in and out, ``--prefetch``, the run report (``--metrics-json``), the
Prometheus textfile, the JSON-lines event log and ``--timing``.  Every TPU kernel of the reference has a hand-written
CUDA counterpart in :mod:`iterative_cleaner_torch.stats.kernels` (K9,
the masked median, computes every iteration's residual-std telemetry).
Every route also runs in the reference's mixed-precision mode
(``CleanConfig(compute_dtype="bfloat16")``: the cube stored in bf16,
every stage computing in float32), and in float64
(``CleanConfig(dtype="float64")``, the reference's oracle-parity mode:
the kernels' float64 builds on the card) on every single-card route and
in both streaming modes; ``CleanConfig(backend="numpy")`` (the CLI's
``--backend numpy``) cleans on the port's own float64 numpy oracle on
the host, which ``python -m iterative_cleaner_torch.tools selftest``
holds the card's float64 masks to.  The CLI also resumes a batch from
its checkpoints (``--checkpoint``, :mod:`iterative_cleaner_torch.utils.
checkpoint`, the reference's file format), cleans with the single-pass
quicklook (``--model quicklook``, :mod:`iterative_cleaner_torch.models`:
K6, K3 and the combine on the card) and captures a ``torch.profiler``
trace of a session (``--trace``, :mod:`iterative_cleaner_torch.utils.
tracing`); the tools diff checkpoints and archives, sweep thresholds and
list borderline decisions.  The online mode (:mod:`iterative_cleaner_torch.
online`) cleans a live stream subint by subint on the card (``--stream
DIR``; the per-subint step is K6, K3 and the combine at nsub = 1, with
periodic reconciles through the batch clean), many streams through one
batched step a tick (``--mux DIR...``), and gives the ``online_ewt`` model.

Entry points run on the card (``CleanConfig.device`` defaults to
``"cuda"``); ``device="cpu"`` runs every kernel's plain PyTorch version
instead, which is how the CPU tests hold the port against the reference.

Layout, host boundary first:

- :mod:`~iterative_cleaner_torch.archive`, :mod:`~iterative_cleaner_torch.config`
- :mod:`~iterative_cleaner_torch.io` — ``.npz``, ``.icar``, PSRFITS and
  TIMER ``.ar`` load/save (the host I/O library, built with ``g++``),
  synthetic archives
- :mod:`~iterative_cleaner_torch.ops` — dispersion, rotation, baselines
- :mod:`~iterative_cleaner_torch.stats` — detection statistics and the kernels
- :mod:`~iterative_cleaner_torch.engine` — the iteration loop
- :mod:`~iterative_cleaner_torch.backends` — ``clean_archive`` (the
  torch engine or the numpy oracle)
- :mod:`~iterative_cleaner_torch.models` — the cleaning strategies by
  name: the flagship ``surgical_scrub``, ``quicklook`` and ``online_ewt``
- :mod:`~iterative_cleaner_torch.parallel` — ``clean_streaming``,
  ``clean_archive_sharded``, ``clean_archives_batched``
- :mod:`~iterative_cleaner_torch.online` — ``OnlineSession``, ``StreamMux``
- :mod:`~iterative_cleaner_torch.telemetry`,
  :mod:`~iterative_cleaner_torch.utils` — the CLI session's run report,
  metrics, event log and ``clean.log``, the checkpoints and the trace
- :mod:`~iterative_cleaner_torch.cli` — ``python -m iterative_cleaner_torch``;
  :mod:`~iterative_cleaner_torch.tools` — ``info``, ``convert``,
  ``selftest``, ``diff``, ``sweep`` and ``borderline``
"""

__version__ = "0.1.0"

from iterative_cleaner_torch.archive import Archive  # noqa: F401
from iterative_cleaner_torch.config import CleanConfig  # noqa: F401
from iterative_cleaner_torch.parallel import (  # noqa: F401
    StreamingCleaner,
    clean_archive_sharded,
    clean_archives_batched,
    clean_streaming,
    clean_streaming_exact,
)
