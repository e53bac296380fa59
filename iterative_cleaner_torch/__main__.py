"""``python -m iterative_cleaner_torch archive...`` — the port's CLI."""

import sys

from iterative_cleaner_torch.cli import main

sys.exit(main())
