"""Streaming: archives cleaned in subint tiles, exactly (whole-archive
masks, the tiles held in host memory) or online (each tile on its
own)."""

from iterative_cleaner_torch.parallel.streaming import (  # noqa: F401
    StreamingCleaner,
    clean_streaming,
)
from iterative_cleaner_torch.parallel.streaming_exact import (  # noqa: F401
    clean_streaming_exact,
)
