"""Streaming (archives cleaned in subint tiles, exactly or online), the
cell-sharded clean (one archive over the ranks of a ``torch.distributed``
process group), the batched clean (equal-shaped archives as one batch,
optionally split over the ranks), the hybrid batch-cell clean (a batch
split over slots of ranks, each archive sharded over its slot) and the
multi-host pieces (the coordinator's counter reduction, this host's
batch mesh)."""

from iterative_cleaner_torch.parallel.batch import (  # noqa: F401
    clean_archives_batched,
)
from iterative_cleaner_torch.parallel.distributed import (  # noqa: F401
    HybridMesh,
    aggregate_metrics_across_processes,
    clean_archives_hybrid,
    hybrid_batch_cell_mesh,
)
from iterative_cleaner_torch.parallel.mesh import (  # noqa: F401
    batch_mesh,
    cell_mesh,
    local_batch_mesh,
)

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
