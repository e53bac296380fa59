"""iterative_cleaner_torch — the PyTorch/CUDA port of the iterative RFI
cleaner, for NVIDIA Hopper (H100).

The JAX package ``iterative_cleaner_tpu`` is the reference this package
is held against; nothing here imports it (or ``jax``).  The port runs the
default configuration end to end: integration baseline, dispersed stats
frame, fourier rotation, no pulse window, a non-DEDISP input — the
reference's ``disp_iteration`` route.  Every kernel that route launches
on the TPU has a hand-written CUDA counterpart in
:mod:`iterative_cleaner_torch.stats.kernels`.

Entry points run on the card (``CleanConfig.device`` defaults to
``"cuda"``); ``device="cpu"`` runs every kernel's plain PyTorch version
instead, which is how the CPU tests hold the port against the reference.

Layout, host boundary first:

- :mod:`~iterative_cleaner_torch.archive`, :mod:`~iterative_cleaner_torch.config`
- :mod:`~iterative_cleaner_torch.io` — ``.npz`` load/save, synthetic archives
- :mod:`~iterative_cleaner_torch.ops` — dispersion, rotation, baselines
- :mod:`~iterative_cleaner_torch.stats` — detection statistics and the kernels
- :mod:`~iterative_cleaner_torch.engine` — the iteration loop
- :mod:`~iterative_cleaner_torch.backends` — ``clean_archive``
- :mod:`~iterative_cleaner_torch.cli` — ``python -m iterative_cleaner_torch``
"""

__version__ = "0.1.0"

from iterative_cleaner_torch.archive import Archive  # noqa: F401
from iterative_cleaner_torch.config import CleanConfig  # noqa: F401
