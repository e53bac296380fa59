"""The baselines' window sums on long float32 profiles (``ops.dsp.
fixed_order_windows``: float32 past 1024 bins): fixed trees of
elementwise adds in place of a float32 sum over the row in the
library's order.

- At 4 x 8 x 32768 (the long-profile card tests' archive, seed 41) the
  integration baseline's offsets (``ops.psrchive_baseline.
  baseline_offsets_integration``) and the profile baseline's
  (``ops.dsp.baseline_offsets``) lie within 3e-7 of the float64 offsets'
  scale (measured: 9.0e-8 and 7.8e-8; the integration contraction on the
  card had lain 1.1e-5 away, the CPU's 1.7e-7).
- The sums depend on the window alone: the offsets of subint tiles, of a
  cell block (its window centres from the whole row's total, as a cell
  mesh gives them) and of a batch's archives are bit-equal to the whole
  archive's; ``tree_sum`` of a stack of rows bit-equal to each row's.
- The window sums themselves against float64, every window length the
  baselines take at 32,768 and 4,096 bins, centred or not; the profile
  offsets' blocked sums (``ops.dsp._block_windows``) at lengths whose
  blocks (the largest power of two dividing n, at most 16 and w / 4) are
  1, 2, 4, 8 and 16 bins.
- At 1024 bins and below, and in float64, the library's sums are kept
  (the reference's forms; the CPU parity tests against the JAX package
  hold those).
"""

import numpy as np
import pytest
import torch

from iterative_cleaner_torch.io.synthetic import make_synthetic_archive
from iterative_cleaner_torch.ops import dsp
from iterative_cleaner_torch.ops.psrchive_baseline import (
    baseline_offsets_integration,
    integration_window_centres,
    window_width,
)


def _cube(nbin=32768, seed=41):
    ar, _ = make_synthetic_archive(nsub=4, nchan=8, nbin=nbin,
                                   n_prezapped=2, seed=seed)
    return (np.array(ar.total_intensity(), dtype=np.float64),
            np.array(ar.weights, dtype=np.float64))


def _offsets(route, cube, w):
    if route == "integration":
        return baseline_offsets_integration(cube, w, 0.15)
    return dsp.baseline_offsets(cube, 0.15)


@pytest.mark.parametrize("route", ["integration", "profile"])
def test_float32_offsets_near_float64(route):
    cube, w = _cube()
    want = _offsets(route, torch.from_numpy(cube), torch.from_numpy(w))
    got = _offsets(route, torch.from_numpy(cube.astype(np.float32)),
                   torch.from_numpy(w.astype(np.float32)))
    assert dsp.fixed_order_windows(torch.zeros(1, 32768))
    scale = float(want.abs().max())
    assert float((got.double() - want).abs().max()) <= 3e-7 * scale


@pytest.mark.parametrize("route", ["integration", "profile"])
def test_tiles_and_blocks_bit_equal_to_whole(route):
    cube, w = _cube()
    c32 = torch.from_numpy(cube.astype(np.float32))
    w32 = torch.from_numpy(w.astype(np.float32))
    whole = _offsets(route, c32, w32)
    tiles = torch.cat([_offsets(route, c32[i:i + 1], w32[i:i + 1])
                       for i in range(4)])
    assert torch.equal(tiles, whole)
    total = torch.einsum("sc,scb->sb", w32, c32)

    class Row:
        """A cell mesh's row: the window centres from the whole row's
        weighted total, as the sharded clean sums it across ranks."""

        def total(self, x, axis):
            assert axis == "chan"
            return total[1:3]

    block = c32[1:3, 2:6].contiguous()
    got = (baseline_offsets_integration(block, w32[1:3, 2:6], 0.15, Row())
           if route == "integration" else _offsets(route, block, None))
    assert torch.equal(got, whole[1:3, 2:6])


def test_batch_bit_equal_to_its_archives():
    a, _ = _cube(seed=41)
    b, _ = _cube(seed=42)
    stack = torch.from_numpy(np.stack([a, b]).astype(np.float32))
    both = dsp.baseline_offsets(stack)
    for i in range(2):
        assert torch.equal(both[i], dsp.baseline_offsets(stack[i]))


def test_tree_sum_is_per_row():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((6, 5, 4915)).astype(np.float32)
                         + 100.0)
    whole = dsp.tree_sum(x)
    for i in range(6):
        for j in range(5):
            assert torch.equal(dsp.tree_sum(x[i, j]), whole[i, j])
    exact = x.double().sum(-1)
    assert float(((whole.double() - exact) / exact).abs().max()) < 2e-7


@pytest.mark.parametrize("nbin", [4096, 32768])
@pytest.mark.parametrize("centred", [False, True])
def test_window_sums_near_float64(nbin, centred):
    cube, w = _cube(nbin)
    prof = cube[:, :3]
    for duty in (0.01, 0.15, 0.5):
        wd = window_width(nbin, duty)
        want = dsp.circular_window_sums(torch.from_numpy(prof), wd, centred)
        got = dsp.circular_window_sums(torch.from_numpy(prof.astype(
            np.float32)), wd, centred)
        assert float(((got.double() - want).abs()).max()) \
            <= 3e-7 * float(want.abs().max())


@pytest.mark.parametrize("nbin", [1025, 1030, 1100, 1032, 1040])
def test_block_windows_every_block_size(nbin):
    rng = np.random.default_rng(nbin)
    x = rng.standard_normal((2, 3, nbin)) + 4.0
    for w in (1, 15, 16, 17, window_width(nbin, 0.15), nbin - 1, nbin):
        ext = np.concatenate([x, x[..., :w - 1]], axis=-1)
        cs = np.concatenate([np.zeros(x.shape[:-1] + (1,)),
                             np.cumsum(ext, axis=-1)], axis=-1)
        want = cs[..., w: w + nbin] - cs[..., :nbin]
        rows = torch.from_numpy(x).float()
        got = torch.stack(dsp._block_windows(rows, w), dim=-1) \
            .reshape(rows.shape)
        assert float(np.abs(got.double().numpy() - want).max()) \
            <= 3e-7 * float(np.abs(want).max())


def test_centres_from_the_fixed_order_sums():
    """The integration window's centre of each subint (the argmin of the
    smoothed total) is the float64 one on this archive."""
    cube, w = _cube()
    t64 = torch.einsum("sc,scb->sb", torch.from_numpy(w),
                       torch.from_numpy(cube))
    assert torch.equal(integration_window_centres(t64.float(), 0.15),
                       integration_window_centres(t64, 0.15))


def test_short_and_float64_profiles_keep_the_library_sums():
    assert not dsp.fixed_order_windows(torch.zeros(2, 1024))
    assert not dsp.fixed_order_windows(torch.zeros(2, 32768,
                                                   dtype=torch.float64))
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (3, 512)).astype(np.float32))
    j = torch.arange(512)
    box = (torch.remainder(j[:, None] - j[None, :], 512) < 77).float()
    assert torch.equal(dsp.circular_window_sums(x, 77), x @ box)
