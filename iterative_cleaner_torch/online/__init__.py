"""Online low-latency cleaning of live streams, on the card.

The batch entry points assume a whole archive on disk before cleaning
starts; a live pipeline needs each subint cleaned as it arrives, with a
bounded latency.  This package is that mode:

``chunks``     per-subint chunk files (bare ``.npy`` tiles with a
               ``stream.json`` header, or any archive container the io
               layer loads) and the assembled-archive round trip.
``ewt``        the exponentially weighted running template, updated per
               subint on the device instead of refit over the archive.
``step``       the per-subint step (the preamble, the EW update, K6, K3
               along each axis and the combine), solo or lane-batched.
``session``    :class:`OnlineSession`: one stream's host ring, its
               device-resident EW state, the provisional mask and the
               latency and build accounting.
``reconcile``  the periodic re-clean of the live rows through the batch
               pipeline, repairing provisional-mask drift; the close
               gives the batch clean's mask.
``model``      ``online_ewt``, the registry model of the provisional
               mask (the triage answer before any reconcile).
``mux``        :class:`StreamMux`: many streams through one batched step
               a tick, bucketed by exact geometry and step key, with a
               bounded ring and a latency deadline (``--mux``).

The CLI runs ``--stream DIR`` (one stream tailed from a chunk directory)
and ``--mux DIR...`` (several, through one mux).
"""

from iterative_cleaner_torch.online.chunks import (  # noqa: F401
    CLOSE_SENTINEL,
    STREAM_META_NAME,
    StreamMeta,
    assemble_archive,
    is_chunk_name,
    load_chunk,
    load_stream_meta,
    save_stream_meta,
)
from iterative_cleaner_torch.online.mux import (  # noqa: F401
    DEFAULT_MUX_MAX_BATCH,
    DEFAULT_MUX_MAX_WAIT_MS,
    MuxRingFull,
    StreamMux,
    resolve_mux_max_batch,
    resolve_mux_max_wait_ms,
)
from iterative_cleaner_torch.online.session import (  # noqa: F401
    DEFAULT_EW_ALPHA,
    DEFAULT_NSUB_STEP,
    DEFAULT_RECONCILE_EVERY,
    OnlineResult,
    OnlineSession,
    PendingSubint,
    resolve_ew_alpha,
    resolve_reconcile_every,
)
