"""Archive I/O at the host boundary: ``.npz``, ``.icar``, fold-mode
PSRFITS and TIMER ``.ar`` load/save, dispatched by extension (the
``.icar`` container and the native PSRFITS reader through the host
library of :mod:`~iterative_cleaner_torch.io.native`), and synthetic
archives with ground-truth RFI."""

from iterative_cleaner_torch.io.npz import load_archive, save_archive  # noqa: F401
from iterative_cleaner_torch.io.synthetic import make_synthetic_archive  # noqa: F401
