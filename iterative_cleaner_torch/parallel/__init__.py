"""Streaming (archives cleaned in subint tiles, exactly or online) and
the cell-sharded clean (one archive over the ranks of a
``torch.distributed`` process group)."""

from iterative_cleaner_torch.parallel.sharding import (  # noqa: F401
    clean_archive_sharded,
)
from iterative_cleaner_torch.parallel.streaming import (  # noqa: F401
    StreamingCleaner,
    clean_streaming,
)
from iterative_cleaner_torch.parallel.streaming_exact import (  # noqa: F401
    clean_streaming_exact,
)
