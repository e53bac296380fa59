"""Archive I/O at the host boundary: ``.npz``, ``.icar``, fold-mode
PSRFITS and TIMER ``.ar`` load/save, dispatched by extension (the
``.icar`` container and the native PSRFITS reader through the host
library of :mod:`~iterative_cleaner_torch.io.native`), and synthetic
archives with ground-truth RFI; ``peek_shape`` reads an archive's
(nsub, nchan, nbin, dedispersed) from its header."""

from iterative_cleaner_torch.io.npz import (  # noqa: F401
    load_archive,
    peek_shape,
    save_archive,
)
from iterative_cleaner_torch.io.synthetic import make_synthetic_archive  # noqa: F401
