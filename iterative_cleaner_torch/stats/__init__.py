"""Detection statistics of the port: the sort-route functions
(:mod:`~iterative_cleaner_torch.stats.masked_torch`) and the CUDA
kernels with their plain versions
(:mod:`~iterative_cleaner_torch.stats.kernels`, sources in ``csrc/``)."""
