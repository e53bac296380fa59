"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``cuda``: they skip where no CUDA device is present, and
run on a GPU machine with

    python -m pytest -m cuda --noconftest tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest sets up JAX, which this file
does not use and a GPU machine need not have).

Tolerances as in tests/test_torch_kernels.py: K1 1e-5 of sum|w*disp|,
K2, K6 and K7 rtol 1e-4 of each plane's scale with masked cells exact,
K3, the combine and K8 bit-equal (NaN included), and every route's mask
equal to the CPU run's.  Exact streaming on every route: masks equal to
the whole clean on the card, budget 0 and the default budget (every
tile pinned) bit-equal.  K10 bit-equal to K2 and K6 on the same cells,
its rows 16-byte aligned or not; the cell-sharded clean on one rank under
NCCL bit-equal to the whole clean.  K9 bit-equal to its plain version
(NaN by position) on the residual-std telemetry's line of 4,194,304
cells, along both axes of a 1024 x 4096 plane and on hand-made edge
lines.  Long profiles (nbin 8192) and ragged shapes (odd nbin, nbin/2 + 1
not a multiple of the DFT tile, a short last group, a cube not 16-byte
aligned) within the same tolerances, K1 bit-equal from run to run, and
K3 and K8 bit-equal on scaler lines of 50,000 and 100,000 entries (K9
and the tail kernels in place of K3).  K3 bit-equal along both axes on
the edge lines and on tie-heavy lines (three distinct values, zero-MAD,
fully masked and one-valid lines, NaN and +inf) at 1 to 46,486 entries,
both sides of the plan's change from four diagnostics at once to two,
under every plan of 8, 4, 2 and 1 lines a block, with a line count that is not a multiple of 8; K9 on the edge lines by
both routes (one block a line, and lines spread over blocks) and on
tie-heavy lines, one counted launch a call, and its device operations a
call in a torch.profiler trace (1 on the block route, at most 5 on the
grid route).
"""

import numpy as np
import pytest
import torch

from iterative_cleaner_torch import CleanConfig, clean_streaming
from iterative_cleaner_torch.backends import clean_archive
from iterative_cleaner_torch.backends import clean_archive_sharded
from iterative_cleaner_torch.engine.loop import (
    ROUTE_KERNELS,
    SHARD_KERNELS,
    STREAM_KERNELS,
    dispersed_residual_base,
    nyq_correction_row,
    pulse_window,
    select_route,
)
from iterative_cleaner_torch.io.synthetic import make_synthetic_archive
from iterative_cleaner_torch.ops.dsp import (
    rotate_bins,
    weighted_marginal_totals,
)
from iterative_cleaner_torch.parallel import distributed
from iterative_cleaner_torch.parallel.mesh import cell_mesh
from iterative_cleaner_torch.stats import kernels as tk
from tests.torch_median_edges import median_edge_lines, sides_edge_planes

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _bits_mismatch(got, want):
    nan_g, nan_w = torch.isnan(got), torch.isnan(want)
    same = (got.view(torch.int32) == want.view(torch.int32)) | (nan_g & nan_w)
    return int((~same).sum())


def _inputs(nsub, nchan, nbin, rotation, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    disp = (torch.randn(nsub, nchan, nbin, generator=g) * 3 + 1).to(dev)
    w = (torch.rand(nsub, nchan, generator=g) > 0.1).float().to(dev)
    w[:, 1] = 0
    phase = (torch.arange(nbin) + 0.5) / nbin
    template = (1e4 * torch.exp(-0.5 * ((phase - 0.3) / 0.03) ** 2)).to(dev)
    shifts = (torch.rand(nchan, generator=g) * nbin / 1.5 - nbin / 3).to(dev)
    rot_t = rotate_bins(template.expand(nchan, nbin), shifts,
                        method=rotation).contiguous()
    nyq = nyq_correction_row(shifts, nbin, rotation, torch.float32)
    return disp, w, w == 0, template, rot_t, nyq


GEOMS = [(20, 40, 128, "fourier"), (16, 32, 63, "roll"),
         (7, 300, 1024, "fourier")]


@pytest.mark.parametrize("nsub,nchan,nbin,rotation", GEOMS)
def test_kernels_match_plain_on_card(card, nsub, nchan, nbin, rotation):
    disp, w, mask, template, rot_t, nyq = _inputs(nsub, nchan, nbin,
                                                  rotation, card)
    a, t1 = tk.weighted_marginals(disp, w)
    pa, pt1 = weighted_marginal_totals(disp, w)
    sa, st1 = weighted_marginal_totals(disp.abs(), w)
    assert bool(((a - pa).abs() <= 1e-5 * sa).all())
    assert bool(((t1 - pt1).abs() <= 1e-5 * st1).all())
    diags = tk.cell_diagnostics_disp(disp, rot_t, nyq, template, w, mask)
    plain = tk.cell_diagnostics_disp_plain(disp, rot_t, nyq, template, w,
                                           mask)
    for g, p in zip(diags, plain):
        scale = float(p[~mask].abs().max())
        assert bool(((g - p).abs() <= 1e-4 * (p.abs() + scale)).all())
        assert _bits_mismatch(g[mask], p[mask]) == 0
    sides = []
    for axis in (0, 1):
        got = tk.scaled_sides(diags, mask, axis, 5.0)
        want = tk.scaled_sides_plain(diags, mask, axis, 5.0)
        assert [_bits_mismatch(g, p) for g, p in zip(got, want)] == [0] * 4
        sides.append(got)
    new_w, scores = tk.combine_zap(sides[0], sides[1], w)
    pw, ps = tk.combine_zap_plain(sides[0], sides[1], w)
    assert _bits_mismatch(scores, ps) == 0
    assert _bits_mismatch(new_w, pw) == 0
    fw, fs = tk.fused_combine(diags, mask, w, 5.0, 5.0)
    pw, ps = tk.fused_combine_plain(diags, mask, w, 5.0, 5.0)
    assert _bits_mismatch(fs, ps) == 0
    assert _bits_mismatch(fw, pw) == 0


def _assert_diags_match(diags, plain, mask):
    for g, p in zip(diags, plain):
        scale = float(p[~mask].abs().max())
        assert bool(((g - p).abs() <= 1e-4 * (p.abs() + scale)).all())
        assert _bits_mismatch(g[mask], p[mask]) == 0


@pytest.mark.parametrize("window_on", [False, True])
@pytest.mark.parametrize("nsub,nchan,nbin,rotation", GEOMS)
def test_k6_k7_match_plain_on_card(card, nsub, nchan, nbin, rotation,
                                   window_on):
    ded, w, mask, template, _, _ = _inputs(nsub, nchan, nbin, rotation,
                                           card, seed=1)
    g = torch.Generator().manual_seed(2)
    shifts = (torch.rand(nchan, generator=g) * nbin / 1.5 - nbin / 3).to(card)
    win = pulse_window(nbin, (nbin // 4, nbin // 2), 0.2, window_on,
                       torch.float32, card)
    disp_base = dispersed_residual_base(ded, shifts, window=win,
                                        rotation=rotation)
    t_w = template if win is None else template * win
    rot_t = rotate_bins(t_w.expand(nchan, nbin), shifts,
                        method=rotation).contiguous()
    _assert_diags_match(
        tk.cell_diagnostics_two_read(ded, disp_base, rot_t, template, w,
                                     mask),
        tk.cell_diagnostics_two_read_plain(ded, disp_base, rot_t, template,
                                           w, mask), mask)
    window = torch.ones(nbin, device=card) if win is None else win
    _assert_diags_match(
        tk.cell_diagnostics_dedisp(ded, template, window, w, mask),
        tk.cell_diagnostics_dedisp_plain(ded, template, window, w, mask),
        mask)


ROUTE_CONFIGS = {
    "two_read": dict(pulse_region=(0.2, 30, 60), unload_res=True),
    "profile": dict(baseline_mode="profile"),
    "dedispersed": dict(stats_frame="dedispersed"),
}


@pytest.mark.parametrize("name", sorted(ROUTE_CONFIGS))
def test_routes_on_card_match_cpu(card, name):
    ar, _ = make_synthetic_archive(nsub=64, nchan=256, nbin=128,
                                   n_prezapped=30, seed=1)
    kwargs = ROUTE_CONFIGS[name]
    tk.reset_launch_counts()
    on_card = clean_archive(ar, CleanConfig(**kwargs))
    counts = tk.launch_counts()
    on_cpu = clean_archive(ar, CleanConfig(device="cpu", **kwargs))
    diag = ("cell_diagnostics_dedisp" if name == "dedispersed"
            else "cell_diagnostics_two_read")
    for k, v in counts.items():
        ran = k == diag or k.startswith(("scaled_sides", "combine")) \
            or k == "masked_median"
        assert v == (on_card.loops if ran else 0), counts
    np.testing.assert_array_equal(on_card.final_weights, on_cpu.final_weights)
    assert (on_card.loops, on_card.converged) == (on_cpu.loops,
                                                  on_cpu.converged)
    np.testing.assert_allclose(on_card.scores, on_cpu.scores, rtol=1e-4,
                               atol=1e-4)
    if on_cpu.residual is not None:
        np.testing.assert_allclose(
            on_card.residual, on_cpu.residual, rtol=0,
            atol=1e-4 * np.abs(on_cpu.residual).max())


def test_slice_on_card_matches_cpu(card):
    ar, _ = make_synthetic_archive(nsub=64, nchan=256, nbin=128,
                                   n_prezapped=30, seed=1)
    tk.reset_launch_counts()
    on_card = clean_archive(ar, CleanConfig())
    counts = tk.launch_counts()
    on_cpu = clean_archive(ar, CleanConfig(device="cpu"))
    for k, v in counts.items():
        ran = k in ROUTE_KERNELS["default"]
        assert v == (on_card.loops if ran else 0), counts
    np.testing.assert_array_equal(on_card.final_weights, on_cpu.final_weights)
    assert (on_card.loops, on_card.converged) == (on_cpu.loops,
                                                  on_cpu.converged)
    np.testing.assert_allclose(on_card.scores, on_cpu.scores, rtol=1e-4,
                               atol=1e-4)


STREAM_CONFIGS = {
    "default": dict(),
    "profile": dict(baseline_mode="profile"),
    "dedispersed": dict(stats_frame="dedispersed"),
    # the integration two-read route: the raw tiles kept and uploaded too
    "pulse": dict(pulse_region=(0.2, 30, 60)),
}


@pytest.mark.parametrize("name", sorted(STREAM_CONFIGS))
def test_exact_streaming_on_card(card, name):
    """64 x 256 x 128 in four 16-subint tiles, nothing pinned and every
    tile pinned (the default budget): masks equal to the whole clean on
    the card, the two budgets bit-equal, each tile's kernels launched
    once per pass, and at budget 0 a peak under the whole clean's."""
    ar, _ = make_synthetic_archive(nsub=64, nchan=256, nbin=128,
                                   n_prezapped=30, seed=1)
    kwargs = STREAM_CONFIGS[name]
    route = select_route(CleanConfig(**kwargs), ar.dedispersed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    whole = clean_archive(ar, CleanConfig(**kwargs))
    peak_whole = torch.cuda.max_memory_allocated()
    runs = {}
    for mb in (0, None):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        tk.reset_launch_counts()
        res = clean_streaming(ar, 16, CleanConfig(stream_hbm_mb=mb, **kwargs))
        runs[mb] = (res, tk.launch_counts(), torch.cuda.max_memory_allocated())
        np.testing.assert_array_equal(res.final_weights, whole.final_weights)
        assert (res.loops, res.converged) == (whole.loops, whole.converged)
        per_tile = ("weighted_marginals", "cell_diagnostics_disp",
                    "cell_diagnostics_two_read", "cell_diagnostics_dedisp")
        for k, v in runs[mb][1].items():
            want = 0
            if k in STREAM_KERNELS[route]:
                want = res.loops * (4 if k in per_tile else 1)
            assert v == want, (k, runs[mb][1])
    (zero, _, peak_zero), (pinned, _, _) = runs[0], runs[None]
    assert _bits_mismatch(torch.from_numpy(zero.final_weights),
                          torch.from_numpy(pinned.final_weights)) == 0
    assert _bits_mismatch(torch.from_numpy(zero.scores),
                          torch.from_numpy(pinned.scores)) == 0
    if route == "default":
        assert peak_zero < peak_whole, (peak_zero, peak_whole)


def _misaligned(x):
    """A contiguous copy of ``x`` whose data starts 4 bytes past a
    16-byte boundary: K10 then stages its rows with 4-byte copies."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    assert out.data_ptr() % 16 != 0
    return out


@pytest.mark.parametrize("nsub,nchan,nbin,rotation",
                         GEOMS + [(64, 256, 128, "fourier")])
def test_k10_bit_equal_to_k2_k6_on_card(card, nsub, nchan, nbin, rotation):
    disp, w, mask, template, rot_t, nyq = _inputs(nsub, nchan, nbin,
                                                  rotation, card, seed=3)
    window = pulse_window(nbin, (nbin // 4, nbin // 2), 0.2, True,
                          torch.float32, card)
    for cube in (disp, _misaligned(disp)):
        tk.reset_launch_counts()
        got = tk.shard_diagnostics_disp(cube, rot_t, nyq, template, w, mask)
        want = tk.cell_diagnostics_disp(disp, rot_t, nyq, template, w, mask)
        assert [_bits_mismatch(g, p) for g, p in zip(got, want)] == [0] * 4
        got = tk.shard_diagnostics_dedisp(cube, template, window, w, mask)
        want = tk.cell_diagnostics_dedisp(disp, template, window, w, mask)
        assert [_bits_mismatch(g, p) for g, p in zip(got, want)] == [0] * 4
        counts = tk.launch_counts()
        assert counts["shard_diagnostics_disp"] == 1
        assert counts["shard_diagnostics_dedisp"] == 1
    _assert_diags_match(
        tk.shard_diagnostics_disp(disp, rot_t, nyq, template, w, mask),
        tk.cell_diagnostics_disp_plain(disp, rot_t, nyq, template, w, mask),
        mask)


@pytest.mark.parametrize("frame", ["dispersed", "dedispersed"])
def test_sharded_clean_one_rank_nccl_on_card(card, frame, tmp_path):
    """clean_archive_sharded on one NCCL rank: bit-equal to the whole
    clean (K10 = K2/K6 on the whole cube, the tree-reduced selects = K3),
    K10, K1 and the combine launched once per loop, K2, K6 and K3 not."""
    ar, _ = make_synthetic_archive(nsub=64, nchan=256, nbin=128,
                                   n_prezapped=30, seed=1)
    cfg = CleanConfig(stats_frame=frame)
    route = select_route(cfg, ar.dedispersed)
    distributed.initialize("nccl", f"file://{tmp_path}/store",
                           device="cuda:0", rank=0, world_size=1)
    try:
        tk.reset_launch_counts()
        got = clean_archive_sharded(ar, cfg, cell_mesh())
        counts = tk.launch_counts()
    finally:
        distributed.shutdown()
    want = clean_archive(ar, cfg)
    for k, v in counts.items():
        assert v == (got.loops if k in SHARD_KERNELS[route] else 0), counts
    assert (got.loops, got.converged) == (want.loops, want.converged)
    for field in ("final_weights", "scores"):
        assert _bits_mismatch(torch.from_numpy(getattr(got, field)),
                              torch.from_numpy(getattr(want, field))) == 0
    np.testing.assert_array_equal(got.loop_diffs, want.loop_diffs)
    np.testing.assert_array_equal(got.iter_metrics, want.iter_metrics)


def _median_plane(shape, seed):
    """A d_std-like plane (positive, duplicated values) with a mask of
    about one cell in ten and a fully masked column and row."""
    rng = np.random.default_rng(seed)
    v = rng.gamma(2.0, 1.5, shape).astype(np.float32)
    v = np.where(rng.random(shape) < 0.2, np.round(v), v)
    m = rng.random(shape) < 0.1
    m[:, 0] = True
    m[0, :] = True
    return torch.from_numpy(v), torch.from_numpy(m)


@pytest.mark.parametrize("case", ["line", "dim0", "dim1", "edge0", "edge1"])
def test_k9_masked_median_bit_equal_on_card(card, case):
    if case.startswith("edge"):
        v, m = median_edge_lines()
    else:
        v, m = _median_plane((1024, 4096), seed=3)
    if case == "line":
        v, m = v.reshape(1, -1), m.reshape(1, -1)
    dim = 0 if case in ("dim0", "edge0") else 1
    v, m = v.to(card), m.to(card)
    before = tk.masked_median.launches
    got = tk.masked_median(v, m, dim)
    torch.cuda.synchronize()
    assert tk.masked_median.launches == before + 1
    want, _ = tk.masked_median_keys(v, m, dim)
    assert got.shape == want.shape
    assert _bits_mismatch(got, want) == 0


def test_k9_masked_median_refuses_on_card(card):
    v, m = median_edge_lines()
    with pytest.raises(TypeError, match="float32"):
        tk.masked_median(v.double().to(card), m.to(card), 1)
    with pytest.raises(ValueError, match="dim"):
        tk.masked_median(v.to(card), m.to(card), 2)


# Long profiles and ragged shapes: nbin 8192 (table streamed in chunks,
# two cells a group), odd nbin (rows not 16-byte aligned: read from device
# memory), nbin 64 (nbin/2 + 1 = 33 columns, padded to 36), a last group
# shorter than the rest, and a cube whose start is 4 bytes past a 16-byte
# boundary (K1's and the cell kernels' copies fall back to plain loads).
RAGGED = [(16, 32, 8192, "fourier", False), (7, 37, 63, "roll", False),
          (9, 29, 64, "fourier", False), (7, 37, 128, "fourier", True),
          (3, 11, 1000, "fourier", True)]


@pytest.mark.parametrize("nsub,nchan,nbin,rotation,shifted", RAGGED)
def test_kernels_match_plain_at_long_and_ragged_shapes(card, nsub, nchan, nbin,
                                                       rotation, shifted):
    disp, w, mask, template, rot_t, nyq = _inputs(nsub, nchan, nbin,
                                                  rotation, card, seed=4)
    cube = _misaligned(disp) if shifted else disp
    a, t1 = tk.weighted_marginals(cube, w)
    pa, pt1 = weighted_marginal_totals(disp, w)
    sa, st1 = weighted_marginal_totals(disp.abs(), w)
    assert bool(((a - pa).abs() <= 1e-5 * sa).all())
    assert bool(((t1 - pt1).abs() <= 1e-5 * st1).all())
    window = pulse_window(nbin, (nbin // 4, nbin // 2), 0.2, True,
                          torch.float32, card)
    pairs = [
        (tk.cell_diagnostics_disp(cube, rot_t, nyq, template, w, mask),
         tk.cell_diagnostics_disp_plain(disp, rot_t, nyq, template, w, mask)),
        (tk.shard_diagnostics_disp(cube, rot_t, nyq, template, w, mask),
         tk.cell_diagnostics_disp_plain(disp, rot_t, nyq, template, w, mask)),
        (tk.cell_diagnostics_dedisp(cube, template, window, w, mask),
         tk.cell_diagnostics_dedisp_plain(disp, template, window, w, mask)),
        (tk.shard_diagnostics_dedisp(cube, template, window, w, mask),
         tk.cell_diagnostics_dedisp_plain(disp, template, window, w, mask)),
        (tk.cell_diagnostics_two_read(cube, disp * 0.5, rot_t, template, w,
                                      mask),
         tk.cell_diagnostics_two_read_plain(disp, disp * 0.5, rot_t,
                                            template, w, mask)),
    ]
    for got, want in pairs:
        _assert_diags_match(got, want, mask)


@pytest.mark.parametrize("shifted", [False, True])
def test_k1_twice_bit_equal_on_card(card, shifted):
    disp, w, _, _, _, _ = _inputs(64, 512, 128, "fourier", card, seed=5)
    cube = _misaligned(disp) if shifted else disp
    first = tk.weighted_marginals(cube, w)
    second = tk.weighted_marginals(cube, w)
    for f, s in zip(first, second):
        assert _bits_mismatch(f, s) == 0


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("n", [50000, 100000])
def test_k3_k8_long_lines_bit_equal_on_card(card, n, axis):
    """Lines over 46,486 entries take K9 and the two tail kernels in
    place of K3: the sides and K8's weights and scores bit-equal to the
    plain versions, NaN and +-inf included."""
    g = torch.Generator().manual_seed(6)
    shape = (n, 3) if axis == 0 else (3, n)
    d = [torch.randn(shape, generator=g) * s for s in (1.0, 0.3, 5.0, 2.0)]
    mask = torch.rand(shape, generator=g) < 0.2
    mask[(slice(None), 2) if axis == 0 else (2, slice(None))] = True
    d[0][mask] = 0.0
    d[2][mask] = 1e20
    d[3].view(-1)[[21, 40]] = float("nan")
    d[3].view(-1)[[22, 23]] = torch.tensor([float("inf"), -float("inf")])
    d[1].view(-1)[301] = float("nan")
    d = [p.to(card) for p in d]
    mask = mask.to(card)
    tk.reset_launch_counts()
    got = tk.scaled_sides(d, mask, axis, 5.0)
    counts = tk.launch_counts()
    assert counts["scaled_sides_axis%d" % axis] == 0
    assert counts["side_centre"] == 4 and counts["side_scale"] == 4
    assert counts["masked_median"] == 8
    want = tk.scaled_sides_plain(d, mask, axis, 5.0)
    assert [_bits_mismatch(a, b) for a, b in zip(got, want)] == [0] * 4
    worig = (~mask).float()
    fw, fs = tk.fused_combine(d, mask, worig, 5.0, 4.0)
    pw, ps = tk.fused_combine_plain(d, mask, worig, 5.0, 4.0)
    assert _bits_mismatch(fs, ps) == 0
    assert _bits_mismatch(fw, pw) == 0


# K3's and K9's block radix select (common.cuh): the edge lines, tie-heavy
# lines, zero-MAD, fully masked and one-valid lines, at the line lengths
# where the launch plan changes (scaled_sides_geometry) and with a line
# count that is not a multiple of the 8 lines a block along axis 0.

def _d_boundary(axis):
    """The longest line K3 selects four diagnostics of at once."""
    n = 1
    while tk.scaled_sides_geometry(n + 1, axis).diags == 4:
        n += 1
    return n


def _tie_sides_planes(n, nlines, axis, seed):
    """Four planes of ``nlines`` lines of ``n`` entries along ``axis``
    drawn from 3 distinct values (duplicates straddle every middle), with
    a fully masked line, a one-valid line, a constant (zero-MAD) line, an
    unmasked line, a line of even and one of odd valid count, and NaN and
    +inf in d3."""
    rng = np.random.default_rng(seed)
    pick = lambda vals: rng.choice(np.float32(vals), size=(nlines, n))
    d = [pick([1.0, 2.0, 3.0]), pick([-0.5, 0.0, 0.5]),
         pick([0.25, 4.0, 1e20]), pick([-1.0, 0.0, 2.0])]
    mask = rng.random((nlines, n)) < 0.3
    mask[0] = True
    mask[1] = True
    mask[1, n // 2] = False
    for p in d:
        p[2] = p[2, 0]
    mask[3] = False
    mask[4] = False
    mask[4, : 1 + (n % 2 == 0)] = True
    mask[5] = False
    mask[5, :1] = True
    d[3][6, n // 3] = np.nan
    d[3][7, n // 2] = np.inf
    d[0][8, :] = np.float32(2.0)
    d = [torch.from_numpy(p) for p in d]
    mask = torch.from_numpy(mask)
    if axis == 0:
        d, mask = [p.t().contiguous() for p in d], mask.t().contiguous()
    return d, mask


def _sides_bit_equal(d, mask, axis, card):
    d = [p.to(card) for p in d]
    mask = mask.to(card)
    before = list(tk.scaled_sides.launches)
    got = tk.scaled_sides(d, mask, axis, 5.0)
    torch.cuda.synchronize()
    assert tk.scaled_sides.launches[axis] == before[axis] + 1
    want = tk.scaled_sides_plain(d, mask, axis, 5.0)
    assert [_bits_mismatch(a, b) for a, b in zip(got, want)] == [0] * 4


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("nlines", [8, 11])
def test_k3_edge_lines_bit_equal_on_card(card, axis, nlines):
    _sides_bit_equal(*sides_edge_planes(axis, nlines), axis, card)


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("n", [1, 2, 31, 32, 33, 1023, 1024, 4096, "d4",
                               "d4+1", 7000, 14080, 20000, 46486])
def test_k3_tie_heavy_lines_bit_equal_on_card(card, axis, n):
    if isinstance(n, str):
        n = _d_boundary(axis) + (1 if n.endswith("+1") else 0)
    assert tk.scaled_sides_route(n) == "block"
    nlines = 11 if n < 20000 else 9
    _sides_bit_equal(*_tie_sides_planes(n, nlines, axis, seed=n), axis,
                     card)


@pytest.mark.parametrize("dim", [0, 1])
@pytest.mark.parametrize("reps", [1, 600, 601])
def test_k9_edge_lines_both_routes_on_card(card, dim, reps):
    """The edge lines as they are (the block route) and each repeated
    600 or 601 times into lines over 4096 entries (the grid route, even
    and odd counts): one counted launch a call, bit-equal to the plain
    version."""
    v, m = median_edge_lines()
    v, m = v.repeat(1, reps), m.repeat(1, reps)
    if dim == 0:
        v, m = v.t().contiguous(), m.t().contiguous()
    route = tk.masked_median_geometry(v.shape[dim], dim).route
    assert route == ("block" if reps == 1 else "grid")
    v, m = v.to(card), m.to(card)
    before = tk.masked_median.launches
    got = tk.masked_median(v, m, dim)
    torch.cuda.synchronize()
    assert tk.masked_median.launches == before + 1
    want, _ = tk.masked_median_keys(v, m, dim)
    assert _bits_mismatch(got, want) == 0


def _tie_median_lines(seed):
    """Lines of 1 to 1000 entries, by length, about 30% masked: drawn from
    three distinct values (duplicates straddle every middle; -0 beside +0;
    +inf; NaN), a normal line, a constant line and a fully masked one."""
    rng = np.random.default_rng(seed)
    lines = {}
    for n in (1, 2, 3, 4, 7, 8, 33, 64, 257, 1000):
        rows = [rng.choice(np.float32(vals), n)
                for vals in ([1.0, 2.0, 3.0], [-0.0, 0.0, 1.0],
                             [np.inf, -1.0, 5.0], [np.nan, 1.0, 1.0])]
        rows += [rng.standard_normal(n).astype(np.float32),
                 np.full(n, 2.5, np.float32), np.full(n, 2.5, np.float32)]
        mask = rng.random((len(rows), n)) < 0.3
        mask[-2] = False
        mask[-1] = True
        lines[n] = (torch.from_numpy(np.stack(rows)), torch.from_numpy(mask))
    return lines


@pytest.mark.parametrize("dim", [0, 1])
@pytest.mark.parametrize("route", ["block", "grid"])
def test_k9_tie_heavy_lines_both_routes_on_card(card, dim, route):
    """Tie-heavy lines as they are (the block route) and repeated into
    lines over 4096 entries (the grid route): bit-equal to the plain
    version."""
    for n, (v, m) in _tie_median_lines(seed=dim).items():
        reps = 1 if route == "block" else -(-(tk.MEDIAN_BLOCK_ENTRIES + 1)
                                            // n)
        v, m = v.repeat(1, reps), m.repeat(1, reps)
        if dim == 0:
            v, m = v.t().contiguous(), m.t().contiguous()
        assert tk.masked_median_geometry(v.shape[dim], dim).route == route
        v, m = v.to(card), m.to(card)
        got = tk.masked_median(v, m, dim)
        want, _ = tk.masked_median_keys(v, m, dim)
        assert _bits_mismatch(got, want) == 0, n


@pytest.mark.parametrize("dim", [0, 1])
@pytest.mark.parametrize("n,limit", [(1024, 1), (4096, 1), (4097, 5),
                                     (4194304, 5)])
def test_k9_device_ops_a_call_on_card(card, dim, n, limit):
    """K9's device operations a call, counted in a torch.profiler trace:
    one kernel on the block route; the scratch's memset and four passes on
    the grid route."""
    from iterative_cleaner_torch.profile_iteration import device_ops

    g = torch.Generator(device=card).manual_seed(n)
    shape = (n, 8) if dim == 0 else (8, n)
    v = torch.randn(shape, generator=g, device=card)
    m = torch.rand(shape, generator=g, device=card) < 0.1
    ops = device_ops(lambda: tk.masked_median(v, m, dim))
    assert 0 < sum(ops.values()) <= limit, ops
    assert all("icln_mm_" in name or "memset" in name.lower()
               for name in ops), ops
