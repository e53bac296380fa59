"""Host-side helpers of the port's CLI session: ``clean.log``, the zap
plot, the checkpoints (``--checkpoint``), the trace (``--trace``) and the
kernel build directory (``--compile-cache``)."""


def configure_compilation_cache(directory) -> None:
    """The port's form of the reference's persistent compilation cache:
    point :mod:`iterative_cleaner_torch.stats.kernels`' library build at
    ``directory`` (``CleanConfig.compile_cache_dir``, ``--compile-cache
    DIR``), so a warm process restart over the same sources finds the
    built library there and runs no ``nvcc``.  No-op when falsy; it must
    act before the first build of the process (``RuntimeError`` if the
    library is already loaded from another directory)."""
    if not directory:
        return
    from iterative_cleaner_torch.stats.kernels import configure_build_dir

    configure_build_dir(directory)
