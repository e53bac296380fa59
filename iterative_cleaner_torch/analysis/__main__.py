"""``python -m iterative_cleaner_torch.analysis``: the analyzer's CLI."""

import sys

from iterative_cleaner_torch.analysis.cli import main

sys.exit(main())
