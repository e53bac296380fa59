"""The hand-made edge lines K9 (the masked median) and K3 (the scaled
sides) are held to, shared by the CPU parity tests, the card tests and
chip_smoke.py.  Imports only torch."""

import torch


def median_edge_lines():
    """(8, 7) values and mask, one line per row, for K9: an odd count;
    duplicates straddling the middle (the masked entry a NaN); a NaN
    among the valid entries; +-0; +-inf; a fully masked line; one valid
    entry; an even count with NaN above the middle, where a masked
    entry's +inf key is the upper middle.  chip_smoke.py,
    tests/test_torch_kernels.py and tests/test_torch_cuda.py hold K9 to
    these lines."""
    nan, inf = float("nan"), float("inf")
    v = torch.tensor([
        [1, 2, 3, 4, 5, 6, 7],
        [3, 1, 2, 2, 2, 9, nan],
        [nan, 1, 2, 3, 4, 5, 6],
        [-0.0, 0.0, -0.0, 0.0, 1, -1, 5],
        [inf, -inf, inf, 1, 2, -inf, 3],
        [5, 4, 3, 2, 1, 0, nan],
        [7, 8, 9, 10, 11, 12, 13],
        [nan, nan, nan, 3, 1, 2, nan],
    ], dtype=torch.float32)
    m = torch.zeros(v.shape, dtype=torch.bool)
    m[1, 6] = True
    m[3, 5:] = True
    m[5, :] = True
    m[6, 1:] = True
    m[7, 6] = True
    return v, m


def sides_edge_planes(axis, nlines):
    """The edge lines of :func:`median_edge_lines` as ``nlines`` lines
    (tiled) of all four scaler diagnostics along ``axis``: NaN only in the
    rFFT diagnostic d3, the masked diagnostics d0-d2 holding finite
    stand-ins where it stood.  Returns the four planes and the mask.
    chip_smoke.py and tests/test_torch_cuda.py hold K3 to them."""
    v, m = median_edge_lines()
    reps = -(-nlines // v.shape[0])
    v, m = v.repeat(reps, 1)[:nlines], m.repeat(reps, 1)[:nlines]
    nan = torch.isnan(v)
    d = [torch.where(nan, torch.full_like(v, s), v * f)
         for s, f in ((7.5, 1.0), (-3.0, 0.5), (0.0, -2.0))] + [v]
    if axis == 0:
        d, m = [p.t().contiguous() for p in d], m.t().contiguous()
    return d, m
