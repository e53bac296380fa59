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
(:func:`clean_archive_sharded`).  Its CLI runs the reference's session
over archives: ``.npz`` and fold-mode PSRFITS in and out, the run report
(``--metrics-json``), the Prometheus textfile, the JSON-lines event log
and ``--timing``.  Every TPU kernel of the reference has a hand-written
CUDA counterpart in :mod:`iterative_cleaner_torch.stats.kernels` (K9,
the masked median, computes every iteration's residual-std telemetry).
float64 and bf16 storage are not ported yet.

Entry points run on the card (``CleanConfig.device`` defaults to
``"cuda"``); ``device="cpu"`` runs every kernel's plain PyTorch version
instead, which is how the CPU tests hold the port against the reference.

Layout, host boundary first:

- :mod:`~iterative_cleaner_torch.archive`, :mod:`~iterative_cleaner_torch.config`
- :mod:`~iterative_cleaner_torch.io` — ``.npz`` and PSRFITS load/save,
  synthetic archives
- :mod:`~iterative_cleaner_torch.ops` — dispersion, rotation, baselines
- :mod:`~iterative_cleaner_torch.stats` — detection statistics and the kernels
- :mod:`~iterative_cleaner_torch.engine` — the iteration loop
- :mod:`~iterative_cleaner_torch.backends` — ``clean_archive``
- :mod:`~iterative_cleaner_torch.parallel` — ``clean_streaming``,
  ``clean_archive_sharded``
- :mod:`~iterative_cleaner_torch.telemetry`,
  :mod:`~iterative_cleaner_torch.utils` — the CLI session's run report,
  metrics, event log and ``clean.log``
- :mod:`~iterative_cleaner_torch.cli` — ``python -m iterative_cleaner_torch``
"""

__version__ = "0.1.0"

from iterative_cleaner_torch.archive import Archive  # noqa: F401
from iterative_cleaner_torch.config import CleanConfig  # noqa: F401
from iterative_cleaner_torch.parallel import (  # noqa: F401
    StreamingCleaner,
    clean_archive_sharded,
    clean_streaming,
    clean_streaming_exact,
)
