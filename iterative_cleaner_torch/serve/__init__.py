"""Long-lived cleaning service: crash-safe queue, admission control,
deadlines, backpressure, graceful drain (``--serve``).

The daemon keeps the process — and with it the loaded kernel library, the
bucket warm-up memo and the DFT tables — alive across requests, so
repeat-geometry requests serve warm, on the card.  See
:mod:`iterative_cleaner_torch.serve.daemon` for the request lifecycle.
"""

from iterative_cleaner_torch.serve.daemon import (  # noqa: F401
    ServeDaemon,
    default_out_path,
    run_serve,
)
from iterative_cleaner_torch.serve.membership import (  # noqa: F401
    PoolMembership,
)
from iterative_cleaner_torch.serve.request import (  # noqa: F401
    OVERRIDABLE,
    RequestError,
    ServeRequest,
    parse_request,
    request_key,
    request_work_key,
)
from iterative_cleaner_torch.serve.result_cache import (  # noqa: F401
    ResultCache,
)
from iterative_cleaner_torch.serve.scheduler import (  # noqa: F401
    Rejection,
    ServeScheduler,
)
from iterative_cleaner_torch.serve.spool import (  # noqa: F401
    ACCEPTED_SUFFIX,
    REJECTED_SUFFIX,
    SpoolWatcher,
)
