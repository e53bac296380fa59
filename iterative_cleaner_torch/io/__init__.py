"""Archive I/O at the host boundary: ``.npz`` and fold-mode PSRFITS
load/save, dispatched by extension, and synthetic archives with
ground-truth RFI."""

from iterative_cleaner_torch.io.npz import load_archive, save_archive  # noqa: F401
from iterative_cleaner_torch.io.synthetic import make_synthetic_archive  # noqa: F401
