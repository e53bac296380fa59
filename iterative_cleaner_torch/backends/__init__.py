"""``clean_archive``: one archive through the PyTorch/CUDA backend."""

from iterative_cleaner_torch.backends.base import (  # noqa: F401
    CleanResult,
    apply_bad_parts,
    sweep_bad_lines,
)


def clean_archive(archive, config):
    """Clean one archive: extract the total-intensity cube, run the
    iteration loop on ``config.device``, then the optional whole-line
    sweep (gated as the reference gates it)."""
    from iterative_cleaner_torch.backends.torch_backend import clean_cube

    result = clean_cube(
        archive.total_intensity(), archive.weights, archive.freqs_mhz,
        archive.dm, archive.centre_freq_mhz, archive.period_s, config,
        dedispersed=archive.dedispersed)
    return apply_bad_parts(result, config)
