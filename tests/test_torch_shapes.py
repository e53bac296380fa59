"""Shapes the port's kernels plan for, on the CPU: long profiles (nbin up
to ``MAX_NBIN``, 16384) and scaler lines longer than one block holds
(over 46,486 entries), against the JAX package.

- The launch plans of K1 (``marginals_tiles``) and of the
  cell-diagnostics kernels (``cell_stats_geometry``) cover every element
  and every DFT column once and fit a Hopper block's 232,448 bytes of
  shared memory; K3's route switches to the cluster kernel past 46,486
  entries; past ``MAX_NBIN`` K1 still plans and the cell diagnostics
  take the FFT build, and a length neither build takes raises
  NotImplementedError naming its ROADMAP item.
- A 4 x 8 x 8192 archive cleaned by the port (plain versions) and by the
  JAX package on its route above 4096 bins (``stats_impl='xla'``):
  masks equal, loops equal, scores within rtol 1e-3 with a 1e-3 floor.
  tests/test_torch_slice.py holds 128-bin rows to 1e-4; the fit, the
  moments and the spectra here sum 64 times as many bins in float32, in
  another order than the JAX package's (its spectra by FFT, the port's
  by DFT), and the scores of 4 of the 32 cells move by up to 7e-4.
- The scaler on 50,000-entry lines (masked, NaN and +-inf entries):
  ``scaled_sides_plain`` bit-equal to the JAX package's sort-route
  scaler, and the long-line composition (K9, side_centre, side_scale
  through their plain versions) bit-equal to ``scaled_sides_plain``.
- The scaler on lines of the cluster route (2 lines of 70,000 entries:
  masked, NaN, +-inf and a fully masked line), one archive and a batch
  of two: ``scaled_sides`` (its plain version on the CPU) bit-equal,
  archive by archive, to the JAX package's masked and plain scalers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iterative_cleaner_tpu.backends import clean_archive as ref_clean_archive
from iterative_cleaner_tpu.config import CleanConfig as RefConfig
from iterative_cleaner_tpu.io.synthetic import (
    make_synthetic_archive as ref_make_synthetic_archive,
)
from iterative_cleaner_tpu.stats import masked_jax
from iterative_cleaner_torch.backends import clean_archive
from iterative_cleaner_torch.convert import (
    archive_from_reference,
    config_from_reference,
)
from iterative_cleaner_torch.stats import kernels as tk

NBINS = [64, 127, 128, 1000, 4096, 8192, 16384]


def _partition(starts_sizes, total):
    """True when the (start, size) intervals cover [0, total) once."""
    pos = 0
    for start, size in sorted(starts_sizes):
        if start != pos or size < 1:
            return False
        pos += size
    return pos == total


@pytest.mark.parametrize("nbin", NBINS)
def test_k1_plan_covers_every_element_once_and_fits(nbin):
    nsub, nchan = 37, 300
    plan = tk.marginals_tiles(nsub, nchan, nbin)
    assert plan.smem <= tk._SMEM_LIMIT
    assert plan.bb <= plan.lanes <= tk.MARGINALS_THREADS
    groups = tk.MARGINALS_THREADS // plan.lanes
    assert plan.cb == groups * tk.MARGINALS_CHANNELS_PER_THREAD
    # the tiles partition the channels, bins and subints ...
    for n, step in ((nchan, plan.cb), (nbin, plan.bb), (nsub, plan.sb)):
        assert _partition([(i, min(step, n - i)) for i in range(0, n, step)],
                          n)
    # ... and a tile's threads own each (channel, bin) of it once:
    # channel j * groups + g, bin lane < bb
    owned = sorted(j * groups + g
                   for j in range(tk.MARGINALS_CHANNELS_PER_THREAD)
                   for g in range(groups))
    assert owned == list(range(plan.cb))
    assert plan.lanes * groups == tk.MARGINALS_THREADS


@pytest.mark.parametrize("nbin", NBINS)
def test_cell_stats_plan_fits_and_covers_every_column(nbin):
    plan = tk.cell_stats_geometry(nbin)
    nk = nbin // 2 + 1
    assert plan.smem <= tk._SMEM_LIMIT
    assert plan.smem == tk.cell_stats_smem(nbin, plan.group, plan.kchunk,
                                           plan.bchunk)
    assert plan.nkp % 4 == 0 and nk <= plan.nkp < nk + 4
    assert plan.kchunk % 4 == 0 and plan.group % plan.ctile == 0
    consumers = plan.threads - 32 * plan.producers
    assert plan.producers >= 1 and consumers >= plan.group
    # every column tile of the padded table in exactly one chunk, each
    # chunk's tiles held one a consumer thread
    per, ktiles = plan.kchunk // 4, plan.nkp // 4
    chunks = [(k, min(per, ktiles - k)) for k in range(0, ktiles, per)]
    assert _partition(chunks, ktiles)
    assert all((plan.group // plan.ctile) * mc <= consumers
               for _, mc in chunks)
    rows = [(b, min(plan.bchunk, nbin - b))
            for b in range(0, nbin, plan.bchunk)]
    assert _partition(rows, nbin)


def test_k3_route_switches_past_one_block():
    assert tk.scaled_sides_route(46486) == "block"
    assert tk.scaled_sides_route(46487) == "cluster"
    assert 5 * 46486 + 16 <= tk._SMEM_LIMIT < 5 * 46487 + 16


@pytest.mark.parametrize("plan", ["marginals", "cell_stats"])
def test_nbin_above_max_refused_naming_roadmap_item(plan):
    """Past ``MAX_NBIN`` K1 plans as below it (it tiles the bins) and the
    cell diagnostics leave the DFT route (whose plan still refuses such
    rows naming ROADMAP item 9) for an FFT build: 32,768 bins the cluster
    build, 16,385 (odd part 16,385, a prime factor over 5) the
    build K2g, by Bluestein's chirp convolution (in a thread-block
    cluster: K2g's cluster mode)."""
    nbin = tk.MAX_NBIN + 1
    if plan == "marginals":
        for n in (nbin, 4 * tk.MAX_NBIN):
            assert tk.marginals_tiles(4, 8, n).smem \
                == tk.marginals_tiles(4, 8, tk.MAX_NBIN).smem
    else:
        assert tk.cell_stats_route(tk.MAX_NBIN) == "dft"
        assert tk.cell_stats_route(2 * tk.MAX_NBIN) == "fft"
        with pytest.raises(NotImplementedError, match="ROADMAP item 9"):
            tk.cell_stats_geometry(nbin)
        assert tk.cell_stats_route(nbin) == "fft_global"
        assert tk.cell_fft_global_plan(nbin).mode == "cluster"


@pytest.mark.parametrize("baseline_mode", ["integration", "profile"])
def test_long_profile_clean_matches_reference(baseline_mode):
    ar, _ = ref_make_synthetic_archive(nsub=4, nchan=8, nbin=8192,
                                       n_prezapped=2, seed=4)
    ref_cfg = RefConfig(baseline_mode=baseline_mode, stats_impl="xla")
    want = ref_clean_archive(ar, ref_cfg)
    got = clean_archive(archive_from_reference(ar),
                        config_from_reference(ref_cfg, device="cpu"))
    np.testing.assert_array_equal(got.final_weights == 0,
                                  want.final_weights == 0)
    assert (got.loops, got.converged) == (want.loops, want.converged)
    np.testing.assert_allclose(got.scores, want.scores, rtol=1e-3, atol=1e-3)


def _long_planes(n, axis, seed):
    """Four diagnostic planes of 3 lines of ``n`` entries along ``axis``
    with masked entries (a fully masked line), NaN and +-inf."""
    rng = np.random.default_rng(seed)
    shape = (n, 3) if axis == 0 else (3, n)
    d = [rng.standard_normal(shape).astype(np.float32) * s
         for s in (1.0, 0.3, 5.0, 2.0)]
    mask = rng.random(shape) < 0.2
    line = (slice(None), 2) if axis == 0 else (2, slice(None))
    mask[line] = True
    d[0][mask] = 0.0
    d[2][mask] = np.float32(1e20)
    flat3 = d[3].reshape(-1)
    flat3[[21, 40]] = np.nan
    flat3[[22, 50]] = np.inf
    flat3[23] = -np.inf
    d[1].reshape(-1)[301] = np.nan
    return d, mask


def _bits_equal(got, want):
    got = np.asarray(got, dtype=np.float32)
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape
    nan_g, nan_w = np.isnan(got), np.isnan(want)
    np.testing.assert_array_equal(nan_g, nan_w)
    np.testing.assert_array_equal(got[~nan_g].view(np.int32),
                                  want[~nan_w].view(np.int32))


@pytest.mark.parametrize("axis", [0, 1])
def test_scaled_sides_on_long_lines_bit_equal(axis):
    d, mask = _long_planes(50000, axis, seed=5)
    planes = [torch.from_numpy(p) for p in d]
    m = torch.from_numpy(mask)
    thresh = 5.0 if axis == 0 else 3.7
    got = tk.scaled_sides_plain(planes, m, axis, thresh)
    ref = jax.jit(lambda ds, mm: [
        masked_jax.scale_lines_masked(x, mm, axis, thresh) for x in ds[:3]]
        + [masked_jax.scale_lines_plain(ds[3], axis, thresh)])(
        [jnp.asarray(p) for p in d], jnp.asarray(mask))
    for g, r in zip(got, ref):
        _bits_equal(g.numpy(), r)
    for g, r in zip(tk.scaled_sides_long(planes, m, axis, thresh), got):
        _bits_equal(g.numpy(), r.numpy())


def _jax_sides(d, mask, axis, thresh):
    """The JAX package's scaler on one archive's planes (numpy)."""
    return jax.jit(lambda ds, mm: [
        masked_jax.scale_lines_masked(x, mm, axis, thresh) for x in ds[:3]]
        + [masked_jax.scale_lines_plain(ds[3], axis, thresh)])(
        [jnp.asarray(p) for p in d], jnp.asarray(mask))


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("nb", [1, 2])
def test_scaled_sides_on_cluster_lines_bit_equal_to_jax(axis, nb):
    n = 70000
    assert tk.scaled_sides_route(n) == "cluster"
    archives = []
    for b in range(nb):
        d, mask = _long_planes(n, axis, seed=30 + b)
        cut = (slice(None), slice(0, 2)) if axis == 0 else slice(0, 2)
        archives.append(([np.ascontiguousarray(p[cut]) for p in d],
                         np.ascontiguousarray(mask[cut])))
    # the second line fully masked in the first archive, unmasked in the
    # second
    line = (slice(None), 1) if axis == 0 else (1, slice(None))
    archives[0][1][line] = True
    if nb == 2:
        archives[1][1][line] = False
    thresh = 5.0 if axis == 0 else 3.7
    if nb == 1:
        planes = [torch.from_numpy(p) for p in archives[0][0]]
        m = torch.from_numpy(archives[0][1])
    else:
        planes = [torch.from_numpy(np.stack([a[0][i] for a in archives]))
                  for i in range(4)]
        m = torch.from_numpy(np.stack([a[1] for a in archives]))
    got = tk.scaled_sides(planes, m, axis, thresh)
    for b, (d, mask) in enumerate(archives):
        for g, r in zip(got, _jax_sides(d, mask, axis, thresh)):
            _bits_equal((g if nb == 1 else g[b]).numpy(), r)
