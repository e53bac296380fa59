"""The model registry: the cleaning strategies by name.

``SURGICAL_SCRUB`` is the flagship, the reference algorithm
(:func:`iterative_cleaner_torch.backends.clean_archive`); ``QUICKLOOK``
(:mod:`iterative_cleaner_torch.models.quicklook`) the single-pass,
template-free triage cleaner; ``ONLINE_EWT``
(:mod:`iterative_cleaner_torch.online.model`) the online mode's
provisional mask, the archive streamed subint by subint through the
exponentially weighted template step.  Each strategy is a
``callable(archive, config) -> CleanResult``.
"""

from iterative_cleaner_torch.backends import CleanResult, clean_archive  # noqa: F401
from iterative_cleaner_torch.config import CleanConfig  # noqa: F401

SURGICAL_SCRUB = "surgical_scrub"
QUICKLOOK = "quicklook"
ONLINE_EWT = "online_ewt"


def _quicklook(archive, config):
    from iterative_cleaner_torch.models.quicklook import (
        clean_archive_quicklook,
    )

    return clean_archive_quicklook(archive, config)


def _online_ewt(archive, config):
    from iterative_cleaner_torch.online.model import (
        clean_archive_online_ewt,
    )

    return clean_archive_online_ewt(archive, config)


# name -> callable(archive, config) -> CleanResult
REGISTRY = {
    SURGICAL_SCRUB: clean_archive,
    QUICKLOOK: _quicklook,
    ONLINE_EWT: _online_ewt,
}


def get_model(name: str = SURGICAL_SCRUB):
    """The cleaning strategy ``name``; ``ValueError`` for an unknown
    one."""
    try:
        return REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown cleaning model {name!r}; available: "
            f"{sorted(REGISTRY)}") from None
