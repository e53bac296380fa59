"""``clean_archive``: one archive through the backend ``config.backend``
names — the PyTorch/CUDA engine (``"torch"``) or the float64 numpy
oracle (``"numpy"``); ``clean_archive_sharded``: one archive over the
ranks of a process group; ``clean_archives_batched``: equal-shaped
archives as one batch."""

from iterative_cleaner_torch.backends.base import (  # noqa: F401
    CleanResult,
    apply_bad_parts,
    sweep_bad_lines,
)


def get_backend(name: str):
    """The backend module of ``name`` (``"torch"`` or ``"numpy"``); each
    has ``clean_cube`` with one signature."""
    if name == "numpy":
        from iterative_cleaner_torch.backends import numpy_backend

        return numpy_backend
    if name == "torch":
        from iterative_cleaner_torch.backends import torch_backend

        return torch_backend
    raise ValueError(f"unknown backend {name!r}")


def clean_archive(archive, config):
    """Clean one archive: extract the total-intensity cube, run the
    iteration loop of ``config.backend`` (the torch engine on
    ``config.device``, or the numpy oracle on the host), then the
    optional whole-line sweep (gated as the reference gates it)."""
    result = get_backend(config.backend).clean_cube(
        archive.total_intensity(), archive.weights, archive.freqs_mhz,
        archive.dm, archive.centre_freq_mhz, archive.period_s, config,
        dedispersed=archive.dedispersed)
    return apply_bad_parts(result, config)


def clean_archive_sharded(archive, config, mesh=None):
    """Clean one archive over the ranks of a ``torch.distributed``
    process group: :func:`iterative_cleaner_torch.parallel.sharding.
    clean_archive_sharded` (rank 0 gets the result, the others None)."""
    from iterative_cleaner_torch.parallel.sharding import (
        clean_archive_sharded as sharded,
    )

    return sharded(archive, config, mesh)


def clean_archives_batched(archives, config, mesh=None, registry=None):
    """Clean equal-shaped archives as one batch on the card
    (:func:`iterative_cleaner_torch.parallel.batch.clean_archives_batched`;
    over a ``mesh`` of ranks rank 0 gets the results, the others
    None)."""
    from iterative_cleaner_torch.parallel.batch import (
        clean_archives_batched as batched,
    )

    return batched(archives, config, mesh, registry)
