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
NCCL bit-equal to the whole clean, on the default, dedispersed and
two_read routes, and streaming over a one-rank NCCL mesh (exact and
online) bit-equal to the single-card stream.  K9 bit-equal to its plain version
(NaN by position) on the residual-std telemetry's line of 4,194,304
cells, along both axes of a 1024 x 4096 plane and on hand-made edge
lines.  Long profiles (nbin 8192) and ragged shapes (odd nbin, nbin/2 + 1
not a multiple of the DFT tile, a short last group, a cube not 16-byte
aligned) within the same tolerances, K1 bit-equal from run to run, and
K3 and K8 bit-equal on scaler lines of 50,000 and 100,000 entries (the
cluster kernel in place of K3).  The cluster kernel (one thread-block
cluster a line) bit-equal to the plain version at 46,487 (28,225 in
float64), 65,536, 131,072 entries and its capacity, along both axes, in
float32 and float64, one launch and no other; a batch in one launch
bit-equal archive by archive to single launches; a refused cluster
launch raising; one entry past the capacity K9 and the tail kernels,
bit-equal.  K3 bit-equal along both axes on
the edge lines and on tie-heavy lines (three distinct values, zero-MAD,
fully masked and one-valid lines, NaN and +inf) at 1 to 46,486 entries,
both sides of the plan's change from four diagnostics at once to two,
under every plan of 8, 4, 2 and 1 lines a block, with a line count that is not a multiple of 8; K9 on the edge lines by
both routes (one block a line, and lines spread over blocks) and on
tie-heavy lines, one counted launch a call, and its device operations a
call in a torch.profiler trace (1 on the block route, at most 5 on the
grid route).  Archives read through the host library (``.icar`` and the
native PSRFITS reader, int16 and float32 DATA) clean on the card to the
CPU clean's mask.  A batch's clean is bit-equal to its single cleans on
the card (masks, loops, scores, telemetry rows).

The bf16 storage mode (``compute_dtype='bfloat16'``): K1, K2, K6, K7 and
K10 on a bf16 cube bit-equal to the same kernel's float32 launch on the
upcast cube (batched too, at nbin 36 and 132, whose rows are whole
16-byte words in float32 but not in bf16, so the bf16 launch reads them
unstaged, and at nbin 4096 and 8192, two cells and one cell a group)
and within the plain version's tolerance, each counted under
its bf16 name; on a bf16-exact archive the whole clean on every route,
exact streaming (the cube uploads halved), the batch and the one-rank
NCCL sharded clean bit-equal to their float32 runs, with no
``compute_dtype_ineligible`` count.

float64 (``dtype='float64'``): the float64 builds of K1, K2, K6, K7, K3,
the combine, K8, K9 and the tail kernels against their plain float64
versions at the float32 cases' shapes and at odd nbin (K1, K2, K6 and K7
within 1e-12 of each plane's scale, masked cells exact; the selects,
the combine and K9 bit-equal, NaN by position), K3 on lines either side
of ``LONGEST_BLOCK_LINE_F64`` (the long side through the cluster
kernel), each counted under its ``_f64`` name; the whole clean on
every route and the exact stream at budget 0 (8 bytes a sample
uploaded) against the CPU's float64 clean (masks, loops; scores within
1e-9); K10's float64 build within 1e-12 of its plain version and
bit-equal to K2's and K6's float64 builds on the same shard; and the
float32
builds' planes SHA-256-equal to the ones the tree before the float64
builds computed (``F32_PLANE_DIGESTS``).

The rest of the CLI surface: K6 with a zero template and a window of
ones (quicklook's diagnostics) against its plain version in float32 and
float64, K3 and the combine on its planes bit-equal, and ``d_mean``'s
sign flipped back giving bit-equal scores; quicklook on the card against
the CPU's (masks equal, scores within 1e-4, 1e-9 in float64), launching
K6, K3 twice and the combine once each and nothing else; a CLI session
resumed from its checkpoint launching no kernel; ``tools sweep --device
cuda`` mask-equal point for point to in-process cleans.
The online mode: K6, K3 along each axis and the combine at nsub = 1,
solo and in 1, 3 and 16 lanes, at 4096 x 128, 300 x 63 and 40 x 1024, in
float32 and float64, against their plain versions (K3 and the combine
bit-equal, NaN by position) and each lane bit-equal to its solo launch;
K6 on a bf16 one-subint tile bit-equal to its float32 launch; a session
on the card against the same session on the CPU (float32, float64, bf16
storage, the pulse window): the step's four kernels once a subint, each
reconcile the batch clean of its prefix; a StreamMux's lanes bit-equal
to solo sessions at max_batch 2 and 8.
The fleet: ``--compile-cache DIR``'s library built into DIR once, a
second process over DIR building nothing; a real ``torch.OutOfMemoryError``
under a memory fraction classified as OOM; a mixed fleet's results
bit-equal to the single cleans, each batch's kernels once per iteration.
The serve daemon: an archive request's outputs on the card equal to
``clean_archive``'s (its kernels once per batch iteration), a stream
request's close bit-equal to a solo session, the bucket program's
roofline gauges against the H100's peaks; a ``torch.profiler`` capture
holding the route's kernels as often as the launch counters say.
The card contracts (``analysis/card_contracts.py``): every registered
hot program holds all five on the card; a seeded host sync inside a step
caught by the dispatch count and by the sync debug mode alike; a seeded
float64 upcast, extra op and cube copy caught; the single-cube-read
launch counters equal to each route's kernels, once an iteration; the
padded mesh program's four gloo ranks on the card, each holding them,
and a host sync seeded on one rank caught on that rank.
The FFT build of the cell diagnostics past the DFT tables (K2f,
``cell_fft.cu``): every entry (K2 with and without the Nyquist term, K7,
K6, K10's two) in float32, bf16 and float64, thread-block clusters of
2, 4 and 8 and the radix-3 stage, within 1e-4 of each plane's
scale (1e-12 in float64), masked cells exact, one launch under its
``_fft`` counter; K10's bit-equal to K2's and K6's, a batch bit-equal to
single launches, bf16 bit-equal to float32 on the upcast cube; long-
profile cleans on every route, in float32 and float64, a batch and an
exact stream, on the card against the CPU's.  K2f's mixed radix-3/5
stages (odd parts 9 and 45 in float32 and bf16, 45 and 625 in
float64) held the same way; K2g, the FFT build
through device memory (``cell_fft_global.cu``: Bluestein rows, odd rows,
split rows past the cluster's capacity), every entry in three dtypes
under its ``_fftg`` counter (d_fft's masked cells by the tolerance),
K10, a batch and ``out=`` tiles bit-equal, bf16 bit-equal to float32, its
passes against ``torch.fft.fft`` and B^ against the chirp's spectrum,
and long-profile cleans at 16,411, 20,000, 20,001 and 28,672 bins.
"""

import numpy as np
import pytest
import torch

from iterative_cleaner_torch import CleanConfig, clean_streaming
from iterative_cleaner_torch.backends import clean_archive
from iterative_cleaner_torch.backends import clean_archive_sharded
from iterative_cleaner_torch.backends import torch_backend as tb
from iterative_cleaner_torch.engine.loop import (
    ROUTE_KERNELS,
    SHARD_KERNELS,
    STREAM_KERNELS,
    dispersed_residual_base,
    nyq_correction_row,
    pulse_window,
    select_route,
    spectrum_kernels,
    storage_kernels,
)
from iterative_cleaner_torch.io.synthetic import (
    make_bf16_exact_archive,
    make_synthetic_archive,
)
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
        ran = k == diag or k in ("scaled_sides_axis0", "scaled_sides_axis1",
                                 "combine_zap", "masked_median")
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


TWO_READ_CASES = {
    "profile": (True, dict(baseline_mode="profile")),
    "pulse": (True, dict(pulse_region=(0.2, 30, 60))),
    "dedisp_input": (False, {}),
}


def _nccl_one_rank(tmp_path, fn):
    """``fn(mesh)`` on a one-rank NCCL mesh, with the launch counts of
    the call."""
    distributed.initialize("nccl", f"file://{tmp_path}/store",
                           device="cuda:0", rank=0, world_size=1)
    try:
        tk.reset_launch_counts()
        got = fn(cell_mesh())
        return got, tk.launch_counts()
    finally:
        distributed.shutdown()


def _assert_bit_equal(got, want):
    assert (got.loops, got.converged) == (want.loops, want.converged)
    for field in ("final_weights", "scores"):
        assert _bits_mismatch(torch.from_numpy(getattr(got, field)),
                              torch.from_numpy(getattr(want, field))) == 0
    if want.loop_diffs is not None:
        np.testing.assert_array_equal(got.loop_diffs, want.loop_diffs)
    np.testing.assert_array_equal(got.iter_metrics, want.iter_metrics)


@pytest.mark.parametrize("case", sorted(TWO_READ_CASES))
def test_sharded_two_read_one_rank_nccl_on_card(card, case, tmp_path):
    """The sharded two_read route on one NCCL rank (K7 on the block, the
    gathered scaler: K3 twice, the combine and K9 on the gathered
    planes), each once per loop, bit-equal to the whole clean."""
    disperse, kw = TWO_READ_CASES[case]
    ar, _ = make_synthetic_archive(nsub=64, nchan=256, nbin=128,
                                   n_prezapped=30, seed=1, disperse=disperse)
    ar.dedispersed = not disperse
    cfg = CleanConfig(**kw)
    assert select_route(cfg, ar.dedispersed) == "two_read"
    got, counts = _nccl_one_rank(
        tmp_path, lambda mesh: clean_archive_sharded(ar, cfg, mesh))
    for k, v in counts.items():
        assert v == (got.loops if k in SHARD_KERNELS["two_read"] else 0), \
            counts
    _assert_bit_equal(got, clean_archive(ar, cfg))


@pytest.mark.parametrize("mode,kw", [
    ("exact", dict(stream_hbm_mb=0)),
    ("exact", dict(baseline_mode="profile", stream_hbm_mb=0)),
    ("online", {}),
])
def test_streamed_shard_one_rank_nccl_on_card(card, mode, kw, tmp_path):
    """Streaming over a one-rank NCCL mesh, bit-equal to the single-card
    stream: exact (the route's kernels per tile block, K8 on the
    gathered whole planes) and online (each tile a one-rank sharded
    clean)."""
    ar, _ = make_synthetic_archive(nsub=96, nchan=128, nbin=64,
                                   n_prezapped=30, seed=5)
    cfg = CleanConfig(**kw)
    got, counts = _nccl_one_rank(
        tmp_path, lambda mesh: clean_streaming(ar, 32, cfg, mesh, mode=mode))
    tk.reset_launch_counts()
    want = clean_streaming(ar, 32, cfg, mode=mode)
    if mode == "exact":
        assert counts == tk.launch_counts()
    else:
        assert counts["combine_zap"] > 0 and counts["scaled_sides_axis0"] == 0
    _assert_bit_equal(got, want)


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
    # float32 and float64 (its float64 build) are taken; half is not
    with pytest.raises(TypeError, match="float32"):
        tk.masked_median(v.half().to(card), m.to(card), 1)
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
    """Lines over 46,486 entries take the cluster kernel in place of K3
    (one launch, no K9 or tail launch): the sides and K8's weights and
    scores bit-equal to the plain versions, NaN and +-inf included."""
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
    assert counts["scaled_sides_cluster_axis%d" % axis] == 1
    assert counts["side_centre"] == 0 and counts["side_scale"] == 0
    assert counts["masked_median"] == 0
    want = tk.scaled_sides_plain(d, mask, axis, 5.0)
    assert [_bits_mismatch(a, b) for a, b in zip(got, want)] == [0] * 4
    worig = (~mask).float()
    fw, fs = tk.fused_combine(d, mask, worig, 5.0, 4.0)
    pw, ps = tk.fused_combine_plain(d, mask, worig, 5.0, 4.0)
    assert _bits_mismatch(fs, ps) == 0
    assert _bits_mismatch(fw, pw) == 0


# The cluster kernel (sides_cluster.cu): K3's function on lines over one
# block, at the block line + 1, the single-pulse archive's 65,536, 131,072
# and the cluster's capacity, along both axes, in float32 and float64.

CLUSTER_DTYPES = {"f32": (torch.float32, tk.LONGEST_BLOCK_LINE, 4, ""),
                  "f64": (torch.float64, tk.LONGEST_BLOCK_LINE_F64, 8,
                          "_f64")}


def _cluster_planes(n, nlines, axis, dtype, seed):
    """Four planes of ``nlines`` lines of ``n`` entries along ``axis``: 20%
    masked, a fully masked line, an unmasked line, a constant (zero-MAD)
    d1 line, NaN and +-inf in d3."""
    g = torch.Generator().manual_seed(seed)
    shape = (n, nlines) if axis == 0 else (nlines, n)
    d = [torch.randn(shape, generator=g, dtype=dtype) * s
         for s in (1.0, 0.3, 5.0, 2.0)]
    mask = torch.rand(shape, generator=g) < 0.2
    def line(i):
        return (slice(None), i) if axis == 0 else (i, slice(None))

    mask[line(1)] = True
    mask[line(2)] = False
    d[1][line(3)] = 0.25
    d[0][mask] = 0.0
    d[2][mask] = 1e20
    d[3].view(-1)[[21, 40]] = float("nan")
    d[3].view(-1)[[22, 23]] = torch.tensor([float("inf"), -float("inf")],
                                           dtype=dtype)
    return d, mask


def _any_bits_mismatch(got, want):
    return (_f64_bits_mismatch if got.dtype == torch.float64
            else _bits_mismatch)(got, want)


@pytest.mark.parametrize("name", sorted(CLUSTER_DTYPES))
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("where", ["block+1", "65536", "131072",
                                   "capacity"])
def test_cluster_kernel_bit_equal_on_card(card, name, axis, where):
    dtype, block, kb, sfx = CLUSTER_DTYPES[name]
    cap = tk.scaled_sides_cluster_capacity(kb)
    n = {"block+1": block + 1, "65536": 65536, "131072": 131072,
         "capacity": cap}[where]
    assert tk.scaled_sides_route(n, dtype) == "cluster"
    d, mask = _cluster_planes(n, 5, axis, dtype, seed=n + axis)
    want = tk.scaled_sides_plain(d, mask, axis, 5.0)
    d, mask = [p.to(card) for p in d], mask.to(card)
    tk.reset_launch_counts()
    got = tk.scaled_sides(d, mask, axis, 5.0)
    counts = tk.launch_counts()
    assert {k: v for k, v in counts.items() if v} == {
        f"scaled_sides_cluster_axis{axis}{sfx}": 1}
    assert [_any_bits_mismatch(x.cpu(), y) for x, y in zip(got, want)] \
        == [0] * 4


@pytest.mark.parametrize("name", sorted(CLUSTER_DTYPES))
@pytest.mark.parametrize("axis", [0, 1])
def test_cluster_kernel_batch_per_archive_on_card(card, name, axis):
    """Three archives' planes in one cluster launch (5 lines each: along
    axis 0 a cluster's columns straddle two archives): each archive's
    sides bit-equal to a launch on it alone."""
    dtype, _, _, sfx = CLUSTER_DTYPES[name]
    parts = [_cluster_planes(65536, 5, axis, dtype, seed=40 + b)
             for b in range(3)]
    planes = [torch.stack([p[0][i] for p in parts]).to(card)
              for i in range(4)]
    mask = torch.stack([p[1] for p in parts]).to(card)
    tk.reset_launch_counts()
    got = tk.scaled_sides(planes, mask, axis, 5.0)
    assert tk.launch_counts()[f"scaled_sides_cluster_axis{axis}{sfx}"] == 1
    for b in range(3):
        one = tk.scaled_sides([p[b] for p in planes], mask[b], axis, 5.0)
        assert [_any_bits_mismatch(x[b], y) for x, y in zip(got, one)] \
            == [0] * 4


@pytest.mark.parametrize("name", sorted(CLUSTER_DTYPES))
def test_lines_past_a_cluster_take_the_long_route_on_card(card, name):
    """One entry past the cluster's capacity: K9 and the tail kernels,
    bit-equal to the plain version, and no cluster launch."""
    dtype, _, kb, sfx = CLUSTER_DTYPES[name]
    n = tk.scaled_sides_cluster_capacity(kb) + 1
    assert tk.scaled_sides_route(n, dtype) == "long"
    d, mask = _cluster_planes(n, 4, 0, dtype, seed=9)
    want = tk.scaled_sides_plain(d, mask, 0, 5.0)
    d, mask = [p.to(card) for p in d], mask.to(card)
    tk.reset_launch_counts()
    got = tk.scaled_sides(d, mask, 0, 5.0)
    counts = tk.launch_counts()
    assert counts["side_centre" + sfx] == counts["side_scale" + sfx] == 4
    assert counts["scaled_sides_cluster_axis0" + sfx] == 0
    assert [_any_bits_mismatch(x.cpu(), y) for x, y in zip(got, want)] \
        == [0] * 4


def test_cluster_launch_refusal_raises_on_card(card, monkeypatch):
    """A cluster launch the card refuses (here: more shared memory than a
    block may have) raises; nothing falls back to another route."""
    d, mask = _cluster_planes(65536, 5, 0, torch.float32, seed=1)
    d, mask = [p.to(card) for p in d], mask.to(card)
    plan = tk.scaled_sides_cluster_geometry(65536, 0)
    monkeypatch.setattr(tk, "scaled_sides_cluster_geometry",
                        lambda *a: plan._replace(smem=tk._SMEM_LIMIT + 16))
    tk.reset_launch_counts()
    with pytest.raises(RuntimeError, match="scaled_sides_cluster"):
        tk.scaled_sides(d, mask, 0, 5.0)
    counts = tk.launch_counts()
    assert counts["side_centre"] == counts["masked_median"] == 0
    assert counts["scaled_sides_axis0"] == 0
    # the refusal leaves no error behind for the next launch
    monkeypatch.undo()
    got = tk.scaled_sides(d, mask, 0, 5.0)
    want = tk.scaled_sides_plain(d, mask, 0, 5.0)
    assert [_bits_mismatch(a, b) for a, b in zip(got, want)] == [0] * 4


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


@pytest.mark.parametrize("ext,nbits", [(".icar", None), (".sf", 16),
                                       (".sf", 32)])
def test_clean_from_native_load_on_card(card, tmp_path, ext, nbits):
    """An archive read through the host library (the ``.icar`` mmap, the
    native PSRFITS reader) and cleaned on the card: the mask equal to the
    CPU clean of the same file, the load counted as native."""
    from iterative_cleaner_torch.io import load_archive, native, save_archive

    ar, _ = make_synthetic_archive(nsub=64, nchan=256, nbin=128,
                                   n_prezapped=30, seed=4)
    if nbits:
        ar.psrfits_nbits = nbits
    path = str(tmp_path / ("obs" + ext))
    save_archive(ar, path)
    native.reset_load_counts()
    loaded = load_archive(path)
    assert native.load_counts()["icar" if ext == ".icar" else "psrfits"] == 1
    on_card = clean_archive(loaded, CleanConfig())
    on_cpu = clean_archive(load_archive(path), CleanConfig(device="cpu"))
    np.testing.assert_array_equal(on_card.final_weights, on_cpu.final_weights)
    assert (on_card.loops, on_card.converged) == (on_cpu.loops,
                                                  on_cpu.converged)


# ---- batched cleaning: the batch folded into K1, K2, K6, K7 and K3 ----

BATCH_GEOMS = [(3, 20, 40, 128, "fourier"), (4, 16, 30, 63, "roll"),
               (2, 7, 300, 1024, "fourier")]


def _batch_inputs(nb, nsub, nchan, nbin, rotation, dev):
    """``nb`` archives' kernel inputs (as :func:`_inputs`, seeds 0..nb-1),
    stacked along a leading batch dimension."""
    per = [_inputs(nsub, nchan, nbin, rotation, dev, seed=s)
           for s in range(nb)]
    return [None if parts[0] is None else torch.stack(parts)
            for parts in zip(*per)]


def _each_bit_equal(batched, singles):
    """Bits differing between archive b of each batched plane and the
    single launch's plane, over every archive and plane."""
    return sum(_bits_mismatch(batched[i][b], s)
               for b, single in enumerate(singles)
               for i, s in enumerate(single))


@pytest.mark.parametrize("nb,nsub,nchan,nbin,rotation", BATCH_GEOMS)
def test_batched_kernels_bit_equal_to_single_launches_on_card(
        card, nb, nsub, nchan, nbin, rotation):
    """One launch of K1, K2, K6, K7 and K3 (both axes) over a batch:
    each archive's outputs bit-equal to the kernel launched on it alone,
    each batched wrapper counted once, and within the plain version's
    tolerance (K3 bit-equal)."""
    disp, w, mask, template, rot_t, nyq = _batch_inputs(
        nb, nsub, nchan, nbin, rotation, card)
    window = pulse_window(nbin, (nbin // 4, nbin // 2), 0.2, True,
                          torch.float32, card)
    ded = disp.flip(-1).contiguous()
    calls = {
        "weighted_marginals": (tk.weighted_marginals, (disp, w), None),
        "cell_diagnostics_disp": (tk.cell_diagnostics_disp,
                                  (disp, rot_t, nyq, template, w, mask),
                                  tk.cell_diagnostics_disp_plain),
        "cell_diagnostics_two_read": (
            tk.cell_diagnostics_two_read,
            (ded, disp, rot_t, template, w, mask),
            tk.cell_diagnostics_two_read_plain),
        "cell_diagnostics_dedisp": (
            tk.cell_diagnostics_dedisp, (ded, template, window, w, mask),
            tk.cell_diagnostics_dedisp_plain),
    }
    shared = {"cell_diagnostics_dedisp": 2}   # the window's position
    planes = None
    for name, (fn, args, plain) in calls.items():
        tk.reset_launch_counts()
        got = fn(*args)
        assert tk.launch_counts()[name] == 1
        singles = [fn(*(a if i == shared.get(name) or a is None else a[b]
                        for i, a in enumerate(args))) for b in range(nb)]
        assert _each_bit_equal(got, singles) == 0, name
        if plain is not None:
            for g, p in zip(got, plain(*args)):
                _assert_diags_match([g.reshape(-1, nchan)],
                                    [p.reshape(-1, nchan)],
                                    mask.reshape(-1, nchan))
        if name == "cell_diagnostics_disp":
            planes = got
    for axis in (0, 1):
        tk.reset_launch_counts()
        got = tk.scaled_sides(planes, mask, axis, 5.0)
        assert tk.launch_counts()[f"scaled_sides_axis{axis}"] == 1
        singles = [tk.scaled_sides([p[b] for p in planes], mask[b], axis,
                                   5.0) for b in range(nb)]
        assert _each_bit_equal(got, singles) == 0
        want = tk.scaled_sides_plain(planes, mask, axis, 5.0)
        assert [_bits_mismatch(g, p) for g, p in zip(got, want)] == [0] * 4
    a, t1 = tk.weighted_marginals(disp, w)
    pa, pt1 = tk.weighted_marginals_plain(disp, w)
    sa, st1 = tk.weighted_marginals_plain(disp.abs(), w)
    assert bool(((a - pa).abs() <= 1e-5 * sa).all())
    assert bool(((t1 - pt1).abs() <= 1e-5 * st1).all())


def test_batched_k3_long_lines_per_archive_on_card(card):
    """Scaler lines over 46,486 entries in a batch take the cluster
    kernel, the batch in one launch: bit-equal to the plain version."""
    g = torch.Generator().manual_seed(3)
    planes = [torch.randn(2, 50000, 4, generator=g).to(card)
              for _ in range(4)]
    mask = (torch.rand(2, 50000, 4, generator=g) < 0.05).to(card)
    got = tk.scaled_sides(planes, mask, 0, 5.0)
    want = tk.scaled_sides_plain(planes, mask, 0, 5.0)
    assert [_bits_mismatch(a, b) for a, b in zip(got, want)] == [0] * 4


BATCH_ROUTES = {"default": {}, "profile": dict(baseline_mode="profile"),
                "dedispersed": dict(stats_frame="dedispersed"),
                "pulse": dict(pulse_region=(0.2, 30, 60))}


@pytest.mark.parametrize("name", sorted(BATCH_ROUTES))
def test_batched_clean_matches_single_cleans_on_card(card, name):
    """``clean_archives_batched`` on the card: each archive's mask,
    loops, convergence, per-loop diffs, scores and telemetry rows
    bit-equal to its single clean on the card (the template stage runs
    each archive's tensor ops at one archive's shapes), each of the
    route's kernels launched once per batch iteration."""
    from iterative_cleaner_torch.parallel.batch import clean_archives_batched

    ars = [make_synthetic_archive(nsub=32, nchan=64, nbin=128, seed=s,
                                  n_rfi_cells=4 + 20 * (s % 3),
                                  n_prezapped=3)[0] for s in range(5)]
    cfg = CleanConfig(**BATCH_ROUTES[name])
    tk.reset_launch_counts()
    got = clean_archives_batched(ars, cfg)
    counts = tk.launch_counts()
    route = select_route(cfg, False)
    iters = max(r.loops for r in got)
    assert {k: v for k, v in counts.items() if v} == {
        k: iters for k in ROUTE_KERNELS[route]}
    for ar, g in zip(ars, got):
        want = clean_archive(ar, cfg)
        np.testing.assert_array_equal(g.final_weights, want.final_weights)
        assert (g.loops, g.converged) == (want.loops, want.converged)
        np.testing.assert_array_equal(g.loop_diffs, want.loop_diffs)
        _assert_bit_equal(g, want)


# --------------------------------------------- bf16 cube storage

@pytest.fixture
def bf16_card(card):
    """The card, its bf16 parity probe run already (its launches are not
    a test's), and the process's downgrade counts as they stand."""
    assert tb.resolve_compute_dtype("bfloat16", device=card) == "bfloat16"
    return card, tb.compute_dtype_ineligible_counts()


def _bf16_misaligned(x):
    """A contiguous bf16 copy of ``x`` starting 2 bytes past a 16-byte
    boundary (every bf16 run read unstaged)."""
    buf = torch.empty(x.numel() + 1, dtype=torch.bfloat16, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    assert out.data_ptr() % 16 != 0
    return out


BF16_GEOMS = [(20, 40, 128, "fourier"), (16, 32, 63, "roll"),
              (12, 40, 36, "fourier"), (10, 24, 132, "fourier"),
              (7, 300, 1024, "fourier"), (3, 11, 4096, "fourier"),
              (4, 16, 8192, "fourier")]


def _kernel_calls(disp, w, mask, template, rot_t, nyq, window):
    """(name, wrapper, args with the cube operands first) of every cube
    kernel, on the cube ``disp`` (``ded``, ``disp_base`` derived)."""
    ded = disp.flip(-1).contiguous()
    return [
        ("weighted_marginals", tk.weighted_marginals, (disp,), (w,)),
        ("cell_diagnostics_disp", tk.cell_diagnostics_disp, (disp,),
         (rot_t, nyq, template, w, mask)),
        ("cell_diagnostics_two_read", tk.cell_diagnostics_two_read,
         (ded, disp), (rot_t, template, w, mask)),
        ("cell_diagnostics_dedisp", tk.cell_diagnostics_dedisp, (ded,),
         (template, window, w, mask)),
        ("shard_diagnostics_disp", tk.shard_diagnostics_disp, (disp,),
         (rot_t, nyq, template, w, mask)),
        ("shard_diagnostics_dedisp", tk.shard_diagnostics_dedisp, (ded,),
         (template, window, w, mask)),
    ]


@pytest.mark.parametrize("nsub,nchan,nbin,rotation", BF16_GEOMS)
def test_bf16_kernels_bit_equal_to_float32_on_card(bf16_card, nsub, nchan,
                                                   nbin, rotation):
    """Each cube kernel on a bf16 cube: bit-equal to its float32 launch
    on the upcast cube and to the bf16 launch on a misaligned copy,
    counted once under its bf16 name, and within the plain version's
    tolerance."""
    card, _ = bf16_card
    disp, w, mask, template, rot_t, nyq = _inputs(nsub, nchan, nbin,
                                                  rotation, card, seed=4)
    window = pulse_window(nbin, (nbin // 4, nbin // 2), 0.2, True,
                          torch.float32, card)
    d16 = disp.to(torch.bfloat16)
    calls16 = _kernel_calls(d16, w, mask, template, rot_t, nyq, window)
    calls32 = _kernel_calls(d16.float(), w, mask, template, rot_t, nyq,
                            window)
    for (name, fn, cubes, rest), (_, _, cubes32, _) in zip(calls16, calls32):
        tk.reset_launch_counts()
        got = fn(*cubes, *rest)
        counts = tk.launch_counts()
        assert counts[name + "_bf16"] == 1 and counts[name] == 0, name
        want = fn(*cubes32, *rest)
        assert [_bits_mismatch(g, p) for g, p in zip(got, want)] == \
            [0] * len(got), name
        odd = fn(*(_bf16_misaligned(c) for c in cubes), *rest)
        assert [_bits_mismatch(g, p) for g, p in zip(odd, got)] == \
            [0] * len(got), name
        plain = {"weighted_marginals": tk.weighted_marginals_plain,
                 "cell_diagnostics_disp": tk.cell_diagnostics_disp_plain,
                 "shard_diagnostics_disp": tk.cell_diagnostics_disp_plain,
                 "cell_diagnostics_two_read":
                     tk.cell_diagnostics_two_read_plain,
                 "cell_diagnostics_dedisp": tk.cell_diagnostics_dedisp_plain,
                 "shard_diagnostics_dedisp":
                     tk.cell_diagnostics_dedisp_plain}[name](*cubes, *rest)
        if name == "weighted_marginals":
            sa, st1 = tk.weighted_marginals_plain(cubes[0].float().abs(), w)
            assert bool(((got[0] - plain[0]).abs() <= 1e-5 * sa).all())
            assert bool(((got[1] - plain[1]).abs() <= 1e-5 * st1).all())
        else:
            _assert_diags_match(got, plain, mask)


@pytest.mark.parametrize("nb,nsub,nchan,nbin,rotation",
                         BATCH_GEOMS + [(3, 12, 40, 36, "fourier")])
def test_bf16_batched_kernels_on_card(bf16_card, nb, nsub, nchan, nbin,
                                      rotation):
    """A batch's bf16 launch: each archive bit-equal to the bf16 launch
    on it alone and to the batched float32 launch on the upcast cubes."""
    card, _ = bf16_card
    disp, w, mask, template, rot_t, nyq = _batch_inputs(
        nb, nsub, nchan, nbin, rotation, card)
    window = pulse_window(nbin, (nbin // 4, nbin // 2), 0.2, True,
                          torch.float32, card)
    d16 = disp.to(torch.bfloat16)
    calls16 = _kernel_calls(d16, w, mask, template, rot_t, nyq, window)[:4]
    calls32 = _kernel_calls(d16.float(), w, mask, template, rot_t, nyq,
                            window)[:4]
    for (name, fn, cubes, rest), (_, _, cubes32, _) in zip(calls16, calls32):
        tk.reset_launch_counts()
        got = fn(*cubes, *rest)
        assert tk.launch_counts()[name + "_bf16"] == 1, name
        want = fn(*cubes32, *rest)
        assert [_bits_mismatch(g, p) for g, p in zip(got, want)] == \
            [0] * len(got), name
        singles = [fn(*(c[b] for c in cubes),
                      *(a if a is window or a is None else a[b]
                        for a in rest)) for b in range(nb)]
        assert _each_bit_equal(got, singles) == 0, name


BF16_ROUTES = {"default": {}, "profile": dict(baseline_mode="profile"),
               "dedispersed": dict(stats_frame="dedispersed")}


def _bf16_archive():
    return make_bf16_exact_archive(64, 256, 128, seed=2)


@pytest.mark.parametrize("name", sorted(BF16_ROUTES))
def test_bf16_clean_bit_equal_to_float32_on_card(bf16_card, name):
    """A bf16-exact archive (roll rotation): the bf16 clean on the card
    bit-equal to the float32 clean, through the route's bf16 kernels,
    with no downgrade counted."""
    card, counts0 = bf16_card
    ar = _bf16_archive()
    kw = dict(rotation="roll", **BF16_ROUTES[name])
    cfg = CleanConfig(compute_dtype="bfloat16", **kw)
    route = select_route(cfg, ar.dedispersed)
    tk.reset_launch_counts()
    got = clean_archive(ar, cfg)
    counts = tk.launch_counts()
    want = clean_archive(ar, CleanConfig(**kw))
    for k, v in counts.items():
        ran = k in storage_kernels(ROUTE_KERNELS[route], "bfloat16")
        assert v == (got.loops if ran else 0), counts
    _assert_bit_equal(got, want)
    assert int((got.final_weights == 0).sum()) > 0
    assert tb.compute_dtype_ineligible_counts() == counts0


def test_bf16_exact_stream_batch_and_shard_on_card(bf16_card, tmp_path):
    """The bf16-exact archive streamed at budget 0 (every tile uploaded
    each pass: the cube bytes uploaded halve), a batch of three and a
    one-rank NCCL sharded clean: each bit-equal to its float32 run."""
    from iterative_cleaner_torch.parallel.batch import clean_archives_batched
    from iterative_cleaner_torch.parallel.tile_cache import DictRegistry

    card, counts0 = bf16_card
    ar = _bf16_archive()
    kw = dict(rotation="roll")
    h2d, res = {}, {}
    for cd in ("float32", "bfloat16"):
        reg = DictRegistry()
        res[cd] = clean_streaming(ar, 16, CleanConfig(
            compute_dtype=cd, stream_hbm_mb=0, **kw), registry=reg)
        h2d[cd] = reg.counters["stream_h2d_cube_bytes"]
    _assert_bit_equal(res["bfloat16"], res["float32"])
    assert 2 * h2d["bfloat16"] == h2d["float32"]
    ars = [make_bf16_exact_archive(32, 64, 128, seed=s) for s in range(3)]
    b16 = clean_archives_batched(ars, CleanConfig(compute_dtype="bfloat16",
                                                  **kw))
    b32 = clean_archives_batched(ars, CleanConfig(**kw))
    for g, want in zip(b16, b32):
        _assert_bit_equal(g, want)
    cfg = CleanConfig(compute_dtype="bfloat16", **kw)
    got, counts = _nccl_one_rank(
        tmp_path, lambda mesh: clean_archive_sharded(ar, cfg, mesh))
    assert counts["shard_diagnostics_disp_bf16"] == got.loops
    assert counts["shard_diagnostics_disp"] == 0
    _assert_bit_equal(got, clean_archive(ar, cfg))
    assert tb.compute_dtype_ineligible_counts() == counts0


# --------------------------------------------------------------------------
# float64 (dtype="float64"): the float64 builds
# --------------------------------------------------------------------------

F64_GEOMS = GEOMS + [(9, 50, 37, "fourier"), (12, 20, 8, "fourier")]


def _f64_inputs(nsub, nchan, nbin, rotation, dev, seed=0):
    disp, w, mask, template, rot_t, _ = _inputs(nsub, nchan, nbin, rotation,
                                                "cpu", seed)
    g = torch.Generator().manual_seed(seed + 7)
    shifts = (torch.rand(nchan, generator=g, dtype=torch.float64) * nbin
              / 1.5 - nbin / 3)
    d = torch.float64
    nyq = nyq_correction_row(shifts, nbin, rotation, d)
    return (disp.to(dev, d), w.to(dev, d), mask.to(dev), template.to(dev, d),
            rot_t.to(dev, d), None if nyq is None else nyq.to(dev))


def _f64_bits_mismatch(got, want):
    nan_g, nan_w = torch.isnan(got), torch.isnan(want)
    same = (got.view(torch.int64) == want.view(torch.int64)) \
        | (nan_g & nan_w)
    return int((~same).sum())


def _f64_planes_close(got, want, mask=None):
    for g, p in zip(got, want):
        assert g.dtype == torch.float64
        fin = torch.isfinite(p)
        scale = float(p[fin].abs().max()) if bool(fin.any()) else 1.0
        assert bool(((g - p).abs() <= 1e-12 * scale)[fin].all())
        assert torch.equal(torch.isfinite(g), fin)
        if mask is not None:
            assert _f64_bits_mismatch(g[mask], p[mask]) == 0


@pytest.mark.parametrize("nsub,nchan,nbin,rotation", F64_GEOMS)
def test_f64_kernels_match_plain_on_card(card, nsub, nchan, nbin, rotation):
    disp, w, mask, template, rot_t, nyq = _f64_inputs(nsub, nchan, nbin,
                                                      rotation, card)
    tk.reset_launch_counts()
    _f64_planes_close(tk.weighted_marginals(disp, w),
                      tk.weighted_marginals_plain(disp, w))
    diags = tk.cell_diagnostics_disp(disp, rot_t, nyq, template, w, mask)
    _f64_planes_close(diags, tk.cell_diagnostics_disp_plain(
        disp, rot_t, nyq, template, w, mask), mask)
    base = disp * 0.5 + 1.0
    _f64_planes_close(
        tk.cell_diagnostics_two_read(disp, base, rot_t, template, w, mask),
        tk.cell_diagnostics_two_read_plain(disp, base, rot_t, template, w,
                                           mask), mask)
    window = torch.ones(nbin, dtype=torch.float64, device=card)
    window[nbin // 4: nbin // 2] = 0.2
    _f64_planes_close(
        tk.cell_diagnostics_dedisp(disp, template, window, w, mask),
        tk.cell_diagnostics_dedisp_plain(disp, template, window, w, mask),
        mask)
    sides = []
    for axis in (0, 1):
        got = tk.scaled_sides(diags, mask, axis, 5.0)
        want = tk.scaled_sides_plain(diags, mask, axis, 5.0)
        assert [_f64_bits_mismatch(g, p) for g, p in zip(got, want)] \
            == [0] * 4
        sides.append(got)
    new_w, scores = tk.combine_zap(sides[0], sides[1], w)
    pw, ps = tk.combine_zap_plain(sides[0], sides[1], w)
    assert scores.dtype == torch.float64
    assert _f64_bits_mismatch(scores, ps) + _f64_bits_mismatch(new_w, pw) == 0
    fw, fs = tk.fused_combine(diags, mask, w, 5.0, 5.0)
    pw, ps = tk.fused_combine_plain(diags, mask, w, 5.0, 5.0)
    assert _f64_bits_mismatch(fs, ps) + _f64_bits_mismatch(fw, pw) == 0
    lines = [(diags[0], mask, 0), (diags[0], mask, 1),
             (diags[0].reshape(1, -1), mask.reshape(1, -1), 1)]
    for v, m, dim in lines:
        assert _f64_bits_mismatch(tk.masked_median(v, m, dim),
                                  tk.masked_median_keys(v, m, dim)[0]) == 0
    counts = tk.launch_counts()
    for name in ("weighted_marginals", "cell_diagnostics_disp",
                 "cell_diagnostics_two_read", "cell_diagnostics_dedisp",
                 "scaled_sides_axis0", "scaled_sides_axis1", "combine_zap",
                 "fused_combine", "masked_median"):
        assert counts[name + "_f64"] >= 1, counts
        assert counts[name] == 0, counts


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("offset", [-1, 0, 1])
def test_f64_k3_either_side_of_its_block_line_on_card(card, axis, offset):
    n = tk.LONGEST_BLOCK_LINE_F64 + offset
    g = torch.Generator().manual_seed(n + axis)
    shape = (n, 5) if axis == 0 else (5, n)
    d = [torch.randn(*shape, generator=g, dtype=torch.float64)
         for _ in range(4)]
    d[1][:, 2 if axis == 0 else 0] = 3.0      # a zero-MAD line
    d[3].view(-1)[17] = float("nan")
    m = torch.rand(*shape, generator=g) < 0.05
    want = tk.scaled_sides_plain(d, m, axis, 5.0)
    d, m = [x.to(card) for x in d], m.to(card)
    tk.reset_launch_counts()
    got = tk.scaled_sides(d, m, axis, 5.0)
    assert [_f64_bits_mismatch(x.cpu(), y) for x, y in zip(got, want)] \
        == [0] * 4
    counts = tk.launch_counts()
    cluster = offset > 0
    assert counts["side_centre_f64"] == 0, counts
    assert (counts[f"scaled_sides_cluster_axis{axis}_f64"] == 1) == cluster
    assert (counts[f"scaled_sides_axis{axis}_f64"] == 1) == (not cluster)


@pytest.mark.parametrize("dim", [0, 1])
@pytest.mark.parametrize("reps", [1, 601])
def test_f64_k9_edge_lines_on_card(card, dim, reps):
    v, m = median_edge_lines()
    v, m = v.double().repeat(1, reps), m.repeat(1, reps)
    if dim == 0:
        v, m = v.t().contiguous(), m.t().contiguous()
    want = tk.masked_median_keys(v, m, dim)[0]
    got = tk.masked_median(v.to(card), m.to(card), dim).cpu()
    assert _f64_bits_mismatch(got, want) == 0


F64_ROUTES = {"default": dict(), "profile": dict(baseline_mode="profile"),
              "dedispersed": dict(stats_frame="dedispersed"),
              "pulse": dict(pulse_region=(0.2, 30, 60), unload_res=True),
              "dedisp1": dict()}


@pytest.mark.parametrize("name", sorted(F64_ROUTES))
def test_f64_routes_on_card_match_cpu(card, name):
    ar, _ = make_synthetic_archive(nsub=64, nchan=256, nbin=128,
                                   n_prezapped=30, seed=1,
                                   disperse=name != "dedisp1")
    ar.dedispersed = name == "dedisp1"
    kwargs = F64_ROUTES[name]
    route = select_route(CleanConfig(**kwargs), ar.dedispersed)
    tk.reset_launch_counts()
    on_card = clean_archive(ar, CleanConfig(dtype="float64", **kwargs))
    counts = tk.launch_counts()
    on_cpu = clean_archive(ar, CleanConfig(dtype="float64", device="cpu",
                                           **kwargs))
    own = storage_kernels(ROUTE_KERNELS[route], "float32", "float64")
    for k, v in counts.items():
        assert (v >= 1) == (k in own), counts
    np.testing.assert_array_equal(on_card.final_weights, on_cpu.final_weights)
    assert (on_card.loops, on_card.converged) == (on_cpu.loops,
                                                  on_cpu.converged)
    assert on_card.scores.dtype == np.float64
    np.testing.assert_allclose(on_card.scores, on_cpu.scores, rtol=1e-9,
                               atol=1e-9)
    if on_cpu.residual is not None:
        np.testing.assert_allclose(
            on_card.residual, on_cpu.residual, rtol=0,
            atol=1e-9 * np.abs(on_cpu.residual).max())


def test_f64_exact_stream_on_card(card):
    from iterative_cleaner_torch.parallel.tile_cache import DictRegistry

    ar, _ = make_synthetic_archive(nsub=64, nchan=256, nbin=128,
                                   n_prezapped=30, seed=1)
    whole = clean_archive(ar, CleanConfig(dtype="float64"))
    reg = DictRegistry()
    tk.reset_launch_counts()
    got = clean_streaming(ar, 16, CleanConfig(dtype="float64",
                                              stream_hbm_mb=0), registry=reg)
    counts = tk.launch_counts()
    np.testing.assert_array_equal(got.final_weights, whole.final_weights)
    assert (got.loops, got.converged) == (whole.loops, whole.converged)
    cube_bytes = 64 * 256 * 128 * 8
    assert reg.counters["stream_h2d_cube_bytes"] \
        == (1 + 2 * got.loops) * cube_bytes
    own = storage_kernels(STREAM_KERNELS["default"], "float32", "float64")
    assert all(counts[k] >= 1 for k in own), counts
    assert not any(v for k, v in counts.items() if k not in own), counts


# SHA-256 (first 16 hex digits) of the float32 planes of K1, K2, K6, K7,
# K3 (both axes), the combine and K9 on _f32_plane_inputs, as the float32
# builds of the port's PR 11 tree (58923b8) computed them on an NVIDIA H100
# 80GB HBM3: the float64 builds must leave every float32 launch's bits as
# they were.
F32_PLANE_DIGESTS = {
    "K1": "ef3ed6fd605e5824", "K2": "5276b207f3e0f10a",
    "K6": "3c3e1957288ffe33", "K7": "ead09ae6198ebc7d",
    "K3_axis0": "807486c285a5b07f", "K3_axis1": "4f52b89671286439",
    "combine": "d693650f87a5dd4a", "K9": "3ca52f474a9d852c",
}


def _f32_plane_digests(dev):
    """The digests of :data:`F32_PLANE_DIGESTS` from this tree's kernels,
    on inputs made with numpy (seed 12; no library product on the card)."""
    import hashlib

    rng = np.random.default_rng(12)
    nsub, nchan, nbin = 64, 256, 128

    def card(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    disp = card(rng.normal(1.0, 3.0, (nsub, nchan, nbin)))
    base = card(rng.normal(0.0, 1.0, (nsub, nchan, nbin)))
    w = card(rng.random((nsub, nchan)) > 0.1)
    mask = w == 0
    template = card(np.abs(rng.normal(0.0, 1.0, nbin)) * 1e4)
    rot_t = card(rng.normal(0.0, 1e4, (nchan, nbin)))
    nyq = card(rng.normal(0.0, 1e-3, (nchan, nbin)))
    window = card(np.where((np.arange(nbin) >= 30) & (np.arange(nbin) < 60),
                           0.2, 1.0))
    diags = tk.cell_diagnostics_disp(disp, rot_t, nyq, template, w, mask)
    sides = [tk.scaled_sides(diags, mask, axis, 5.0) for axis in (0, 1)]
    planes = {
        "K1": tk.weighted_marginals(disp, w),
        "K2": diags,
        "K6": tk.cell_diagnostics_dedisp(disp, template, window, w, mask),
        "K7": tk.cell_diagnostics_two_read(disp, base, rot_t, template, w,
                                           mask),
        "K3_axis0": sides[0], "K3_axis1": sides[1],
        "combine": tk.combine_zap(sides[0], sides[1], w),
        "K9": (tk.masked_median(diags[0].reshape(1, -1),
                                mask.reshape(1, -1), 1),),
    }
    out = {}
    for name, ts in planes.items():
        h = hashlib.sha256()
        for t in ts:
            h.update(t.contiguous().cpu().numpy().tobytes())
        out[name] = h.hexdigest()[:16]
    return out


def test_f32_planes_bit_equal_to_before_on_card(card):
    assert _f32_plane_digests(card) == F32_PLANE_DIGESTS


@pytest.mark.parametrize("nsub,nchan,nbin,rotation", F64_GEOMS)
def test_k10_float64_build_on_card(card, nsub, nchan, nbin, rotation):
    """K10's float64 build: within 1e-12 of each plane's scale of its
    plain version (masked cells exact), bit-equal to K2's and K6's float64
    builds on the same shard, counted as ``<name>_f64``."""
    disp, w, mask, template, rot_t, nyq = _f64_inputs(nsub, nchan, nbin,
                                                      rotation, card)
    g = torch.Generator().manual_seed(11)
    window = (0.5 + torch.rand(nbin, generator=g, dtype=torch.float64)
              ).to(card)
    tk.reset_launch_counts()
    got_d = tk.shard_diagnostics_disp(disp, rot_t, nyq, template, w, mask)
    got_x = tk.shard_diagnostics_dedisp(disp, template, window, w, mask)
    counts = tk.launch_counts()
    assert counts["shard_diagnostics_disp_f64"] == 1
    assert counts["shard_diagnostics_dedisp_f64"] == 1
    assert counts["shard_diagnostics_disp"] == 0
    plain_d = tk.cell_diagnostics_disp_plain(
        disp.cpu(), rot_t.cpu(), None if nyq is None else nyq.cpu(),
        template.cpu(), w.cpu(), mask.cpu())
    plain_x = tk.cell_diagnostics_dedisp_plain(
        disp.cpu(), template.cpu(), window.cpu(), w.cpu(), mask.cpu())
    _f64_planes_close([p.cpu() for p in got_d], plain_d, mask.cpu())
    _f64_planes_close([p.cpu() for p in got_x], plain_x, mask.cpu())
    for got, want in ((got_d, tk.cell_diagnostics_disp(
            disp, rot_t, nyq, template, w, mask)),
                      (got_x, tk.cell_diagnostics_dedisp(
            disp, template, window, w, mask))):
        for a, b in zip(got, want):
            assert _f64_bits_mismatch(a, b) == 0


# ---------------------------------------------------------------------------
# the rest of the CLI surface: quicklook on K6 + K3 + combine, the CLI's
# resume, tools sweep on the card
# ---------------------------------------------------------------------------

QUICKLOOK_GEOMS = [(20, 40, 128), (16, 32, 63), (7, 300, 1024)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nsub,nchan,nbin", QUICKLOOK_GEOMS)
def test_k6_zero_template_matches_plain_on_card(card, nsub, nchan, nbin,
                                                dtype):
    """K6 with an all-zero template and a window of ones (quicklook's
    diagnostics of -(w * ded)) against its plain version; K3 and the
    combine on its planes bit-equal to theirs; d_mean's sign flipped back
    gives bit-equal scores (every scaler side takes |d - median|)."""
    ded, w, mask, _, _, _ = _inputs(nsub, nchan, nbin, "fourier", "cpu",
                                    seed=3)
    ded, w, mask = ded.to(card, dtype), w.to(card, dtype), mask.to(card)
    zero = torch.zeros(nbin, dtype=dtype, device=card)
    ones = torch.ones(nbin, dtype=dtype, device=card)
    tk.reset_launch_counts()
    diags = tk.cell_diagnostics_dedisp(ded, zero, ones, w, mask)
    suffix = "_f64" if dtype == torch.float64 else ""
    assert tk.launch_counts()["cell_diagnostics_dedisp" + suffix] == 1
    plain = tk.cell_diagnostics_dedisp_plain(ded, zero, ones, w, mask)
    if dtype == torch.float64:
        _f64_planes_close(diags, plain, mask)
        bits = _f64_bits_mismatch
    else:
        _assert_diags_match(diags, plain, mask)
        bits = _bits_mismatch
    from iterative_cleaner_torch.engine.loop import scores_and_zap

    new_w, scores = scores_and_zap(diags, mask, w, 5.0, 5.0)
    pw, ps = tk.combine_zap_plain(
        *(tk.scaled_sides_plain(diags, mask, axis, 5.0) for axis in (0, 1)),
        w)
    assert bits(scores, ps) == 0 and bits(new_w, pw) == 0
    flipped = (diags[0], -diags[1], diags[2], diags[3])
    _, s_flip = scores_and_zap(flipped, mask, w, 5.0, 5.0)
    assert bits(s_flip, scores) == 0


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("kwargs", [{}, dict(baseline_mode="profile")])
def test_quicklook_on_card_matches_cpu(card, dtype, kwargs):
    from iterative_cleaner_torch.models import QUICKLOOK, get_model
    from iterative_cleaner_torch.models.quicklook import QUICKLOOK_KERNELS

    ar, _ = make_synthetic_archive(nsub=64, nchan=256, nbin=128,
                                   n_prezapped=30, seed=1)
    tk.reset_launch_counts()
    on_card = get_model(QUICKLOOK)(ar, CleanConfig(dtype=dtype, **kwargs))
    counts = tk.launch_counts()
    on_cpu = get_model(QUICKLOOK)(ar, CleanConfig(device="cpu", dtype=dtype,
                                                  **kwargs))
    suffix = "_f64" if dtype == "float64" else ""
    want = dict.fromkeys(counts, 0)
    want.update({k + suffix: 1 for k in QUICKLOOK_KERNELS})
    assert counts == want
    np.testing.assert_array_equal(on_card.final_weights, on_cpu.final_weights)
    tol = 1e-4 if dtype == "float32" else 1e-9
    np.testing.assert_allclose(on_card.scores, on_cpu.scores, rtol=tol,
                               atol=tol)
    assert on_card.scores.dtype == np.dtype(dtype)


def test_cli_resume_launches_no_kernel_on_card(card, tmp_path, monkeypatch,
                                               capsys):
    from iterative_cleaner_torch import cli
    from iterative_cleaner_torch.io import load_archive, save_archive

    monkeypatch.chdir(tmp_path)
    ar, _ = make_synthetic_archive(nsub=64, nchan=256, nbin=128,
                                   n_prezapped=30, seed=2)
    save_archive(ar, "obs.npz")
    counts = []
    for out in ("first.npz", "second.npz"):
        tk.reset_launch_counts()
        assert cli.main(["-l", "--checkpoint", "ck", "-o", out,
                         "obs.npz"]) == 0
        torch.cuda.synchronize()
        counts.append(tk.launch_counts())
    assert all(counts[0][k] > 0 for k in ROUTE_KERNELS["default"])
    assert not any(counts[1].values()), counts[1]
    assert "Resumed from checkpoint" in capsys.readouterr().out
    np.testing.assert_array_equal(load_archive("first.npz").weights,
                                  load_archive("second.npz").weights)


@pytest.mark.parametrize("model", ["surgical_scrub", "quicklook"])
def test_tools_sweep_on_card_matches_in_process_cleans(card, model,
                                                       tmp_path, monkeypatch,
                                                       capsys):
    """tools sweep --device cuda: each grid point's mask equal to an
    in-process clean's on the card, and its row their fractions."""
    import json

    from iterative_cleaner_torch import models, tools
    from iterative_cleaner_torch.io import save_archive

    monkeypatch.chdir(tmp_path)
    ar, _ = make_synthetic_archive(nsub=32, nchan=64, nbin=128,
                                   n_prezapped=20, seed=4)
    save_archive(ar, "o.npz")
    seen = []
    real = models.get_model

    def spy(name):
        fn = real(name)

        def run(a, cfg):
            seen.append((cfg, fn(a, cfg)))
            return seen[-1][1]
        return run

    monkeypatch.setattr(models, "get_model", spy)
    assert tools.main(["sweep", "o.npz", "--device", "cuda", "--model",
                       model, "-c", "4", "5", "6", "-s", "4", "6"]) == 0
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert len(rows) == len(seen) == 6
    for row, (cfg, res) in zip(rows, seen):
        assert cfg.device == "cuda"
        want = real(model)(ar, CleanConfig(chanthresh=row["chanthresh"],
                                           subintthresh=row["subintthresh"]))
        np.testing.assert_array_equal(res.final_weights == 0,
                                      want.final_weights == 0)
        assert row["rfi_frac"] == round(want.rfi_fraction, 6)


# --------------------------------------------- the fleet

def test_warm_bucket_builds_into_a_given_directory_once(card, tmp_path):
    """In a fresh process, ``--compile-cache DIR``'s build lands in DIR
    (one ``nvcc`` run, on the warm-up), and a second process over the same
    DIR builds nothing and finds the library there."""
    import json
    import subprocess
    import sys

    code = """
import json, sys
from iterative_cleaner_torch import CleanConfig
from iterative_cleaner_torch.parallel.batch import warm_bucket
from iterative_cleaner_torch.stats import kernels as K
from iterative_cleaner_torch.utils import configure_compilation_cache
configure_compilation_cache(sys.argv[1])
s = {}
warm_bucket(CleanConfig(), 16, 32, 128, False, 4, stats_out=s)
print(json.dumps({"builds": K.library_builds(), "dir": str(K.build_dir()),
                  "warm_builds": s["library_builds"], "fresh": s["fresh"]}))
"""
    runs = []
    for _ in range(2):
        out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                             capture_output=True, text=True, timeout=600)
        assert out.returncode == 0, out.stderr[-3000:]
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
    assert runs[0]["builds"] == 1 and runs[1]["builds"] == 0
    assert runs[0]["dir"] == str(tmp_path.resolve())
    assert [r["warm_builds"] for r in runs] == [1, 0]
    assert all(r["fresh"] for r in runs)
    assert [p.name for p in tmp_path.glob("libicln_kernels_*.so")]


def test_real_oom_under_a_memory_fraction_is_classified_oom(card):
    """A real ``torch.OutOfMemoryError`` under a per-process memory
    fraction is classified as OOM, and the card works after
    ``empty_cache``."""
    from iterative_cleaner_torch.resilience import OOM, classify_error

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    total = torch.cuda.get_device_properties(0).total_memory
    try:
        torch.cuda.set_per_process_memory_fraction(2 ** 30 / total)
        with pytest.raises(torch.OutOfMemoryError) as ei:
            torch.empty(2 * 2 ** 30, dtype=torch.uint8, device=card)
        assert classify_error(ei.value) == OOM
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0)
        torch.cuda.empty_cache()
    assert float(torch.ones(4, device=card).sum()) == 4.0


def test_fleet_batches_are_the_single_cleans_on_card(card, tmp_path):
    """A mixed fleet on the card: each archive's result bit-equal to its
    single clean, each batch's kernels launched once per batch iteration
    (a group of one raw geometry: the port pads no cell)."""
    from iterative_cleaner_torch.io import save_archive
    from iterative_cleaner_torch.parallel.fleet import clean_fleet

    shapes = [(32, 64, 128)] * 5 + [(32, 60, 128)] * 2 + [(16, 64, 64)]
    paths = []
    for i, (s, c, b) in enumerate(shapes):
        ar, _ = make_synthetic_archive(nsub=s, nchan=c, nbin=b, seed=70 + i,
                                       n_rfi_cells=4 + 20 * (i % 3),
                                       n_prezapped=3)
        paths.append(str(tmp_path / ("f%02d.npz" % i)))
        save_archive(ar, paths[-1])
    cfg = CleanConfig(fleet_group_size=4)
    tk.reset_launch_counts()
    rep = clean_fleet(paths, cfg)
    counts = tk.launch_counts()
    assert rep.ok and (rep.n_buckets, rep.n_groups) == (3, 4)
    # groups: 5 x 32x64 -> (4) and (1), the 2 of 32x60 and the 16x64x64
    # singleton: one raw geometry each
    loops = {p: rep.results[p].loops for p in paths}
    batches = [paths[0:4], paths[4:5], paths[5:7], paths[7:8]]
    iters = sum(max(loops[p] for p in b) for b in batches)
    assert {k: v for k, v in counts.items() if v} == {
        k: iters for k in ROUTE_KERNELS["default"]}
    from iterative_cleaner_torch.io import load_archive

    for p in paths:
        want = clean_archive(load_archive(p), CleanConfig())
        g = rep.results[p]
        np.testing.assert_array_equal(g.final_weights, want.final_weights)
        assert (g.loops, g.converged) == (want.loops, want.converged)
        _assert_bit_equal(g, want)


# ---------------------------------------------------------------------------
# the online mode: K6, K3 x 2 and the combine at nsub = 1, lane-batched
# ---------------------------------------------------------------------------

ONLINE_GEOMS = [(4096, 128), (300, 63), (40, 1024)]


def _online_planes(nb, nchan, nbin, dtype, dev, seed=0):
    """``nb`` lanes of one-subint K6 inputs (``nb`` None: one solo
    plane): a dedispersed tile, weights with a dead channel, the mask and
    a template per lane, in ``dtype``."""
    lanes = [_inputs(1, nchan, nbin, "fourier", "cpu", seed=seed + s)
             for s in range(1 if nb is None else nb)]
    ded, w, mask, template = (torch.stack([lane[i] for lane in lanes])
                              for i in range(4))
    if nb is None:
        ded, w, mask, template = ded[0], w[0], mask[0], template[0]
    return (ded.to(dev, dtype), w.to(dev, dtype), mask.to(dev),
            template.to(dev, dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nb", [None, 1, 3, 16])
@pytest.mark.parametrize("nchan,nbin", ONLINE_GEOMS)
def test_online_step_kernels_at_nsub_1_on_card(card, nchan, nbin, nb, dtype):
    """The per-subint step's kernels on one-subint planes, solo and as a
    lane batch: K6 within its plain version's tolerance; K3 along axis 0
    (lines of one entry) and axis 1, and the combine, bit-equal to their
    plain versions (NaN by position); a batch's lanes bit-equal to each
    lane launched alone; each kernel counted once a call."""
    from iterative_cleaner_torch.engine.loop import scores_and_zap

    ded, w, mask, template = _online_planes(nb, nchan, nbin, dtype, card)
    window = pulse_window(nbin, (nbin // 4, nbin // 2), 0.3, True, dtype,
                          card)
    bits = _f64_bits_mismatch if dtype == torch.float64 else _bits_mismatch
    tk.reset_launch_counts()
    diags = tk.cell_diagnostics_dedisp(ded, template, window, w, mask)
    new_w, scores = scores_and_zap(diags, mask, w, 5.0, 5.0)
    sfx = "_f64" if dtype == torch.float64 else ""
    counts = tk.launch_counts()
    for name in ("cell_diagnostics_dedisp", "scaled_sides_axis0",
                 "scaled_sides_axis1", "combine_zap"):
        assert counts[name + sfx] == 1, name
    plain = tk.cell_diagnostics_dedisp_plain(ded, template, window, w, mask)
    if dtype == torch.float64:
        _f64_planes_close(diags, plain, mask)
    else:
        _assert_diags_match(diags, plain, mask)
    sides = [tk.scaled_sides(diags, mask, axis, 5.0) for axis in (0, 1)]
    for axis in (0, 1):
        want = tk.scaled_sides_plain(diags, mask, axis, 5.0)
        assert sum(bits(g, p) for g, p in zip(sides[axis], want)) == 0
    pw, ps = tk.combine_zap_plain(sides[0], sides[1], w)
    assert bits(scores, ps) == 0 and bits(new_w, pw) == 0
    if nb is not None:
        for b in range(nb):
            d1 = tk.cell_diagnostics_dedisp(ded[b], template[b], window,
                                            w[b], mask[b])
            assert sum(bits(g[b], s) for g, s in zip(diags, d1)) == 0
            w1, s1 = scores_and_zap(d1, mask[b], w[b], 5.0, 5.0)
            assert bits(scores[b], s1) == 0 and bits(new_w[b], w1) == 0


@pytest.mark.parametrize("nb", [None, 16])
def test_online_k6_bf16_tile_on_card(card, nb):
    """K6 on a bf16-stored one-subint tile (solo and lane-batched):
    bit-equal to its float32 launch on the upcast tile."""
    ded, w, mask, template = _online_planes(nb, 4096, 128, torch.float32,
                                            card, seed=3)
    ones = torch.ones(128, device=card)
    d16 = ded.to(torch.bfloat16)
    tk.reset_launch_counts()
    got = tk.cell_diagnostics_dedisp(d16, template, ones, w, mask)
    assert tk.launch_counts()["cell_diagnostics_dedisp_bf16"] == 1
    want = tk.cell_diagnostics_dedisp(d16.float(), template, ones, w, mask)
    assert sum(_bits_mismatch(g, p) for g, p in zip(got, want)) == 0


def _online_stream(nsub, nchan, nbin, seed):
    ar, _ = make_synthetic_archive(nsub=nsub, nchan=nchan, nbin=nbin,
                                   seed=seed, n_prezapped=3)
    return ar


@pytest.mark.parametrize("kw", [{}, dict(dtype="float64"),
                                dict(compute_dtype="bfloat16"),
                                dict(pulse_region=(0.3, 20, 50))])
def test_online_session_on_card_matches_cpu(card, kw):
    """A session on the card against the same session on the CPU: the
    provisional masks equal (NaN scores by position), every reconcile's
    mask the card's batch clean of its prefix, the close the card's
    clean_archive; the step's four kernels launched once a subint and no
    kernel-library build after the warm-up."""
    from iterative_cleaner_torch.online import OnlineSession, StreamMeta
    from iterative_cleaner_torch.online.step import STEP_KERNELS

    ar = _online_stream(12, 64, 128, seed=31)
    meta = StreamMeta.from_archive(ar)
    cube = ar.total_intensity()
    sessions = {dev: OnlineSession(meta, CleanConfig(device=dev, max_iter=3,
                                                     **kw),
                                   reconcile_every=4)
                for dev in ("cuda", "cpu")}
    sfx = "_f64" if kw.get("dtype") == "float64" else ""
    for i in range(12):
        tk.reset_launch_counts()
        sessions["cuda"].ingest(cube[i], ar.weights[i])
        counts = tk.launch_counts()
        # the first subint also runs the bf16 parity probe's cleans
        if i and (i + 1) % 4:
            for name in STEP_KERNELS:
                if name == "cell_diagnostics_dedisp" \
                        and kw.get("compute_dtype"):
                    name += "_bf16"
                assert counts[name + sfx] == 1, name
        sessions["cpu"].ingest(cube[i], ar.weights[i])
        if (i + 1) % 4 == 0:
            s = sessions["cuda"]
            prefix = clean_archive(s.assembled(), s.config)
            np.testing.assert_array_equal(s.provisional_weights,
                                          prefix.final_weights)
    got, want = sessions["cuda"], sessions["cpu"]
    assert np.array_equal(np.isnan(got.provisional_scores),
                          np.isnan(want.provisional_scores))
    res = got.close()
    assert res.recompiles_steady == 0 and res.reconciles == 3
    np.testing.assert_array_equal(
        res.archive.weights,
        clean_archive(got.assembled(), got.config).final_weights)


def test_online_mux_lanes_bit_equal_to_solo_sessions_on_card(card):
    """Five streams through a StreamMux on the card (max_batch 2 and 8):
    every lane's provisional mask, scores and EW template bit-equal to a
    solo session's, each dispatch one launch of the step's kernels."""
    from iterative_cleaner_torch.online import (
        OnlineSession,
        StreamMeta,
        StreamMux,
    )

    cfg = CleanConfig(max_iter=3, stream_reconcile_every=0)
    ars = [_online_stream(6, 256, 128, seed=50 + k) for k in range(5)]
    metas = [StreamMeta.from_archive(ar) for ar in ars]
    solos = []
    for meta, ar in zip(metas, ars):
        s = OnlineSession(meta, cfg)
        s.ingest(ar.total_intensity(), ar.weights)
        solos.append(s)
    for max_batch in (2, 8):
        mux = StreamMux(max_batch=max_batch, max_wait_ms=0.0)
        for k, meta in enumerate(metas):
            mux.open(f"s{k}", meta, cfg)
        tk.reset_launch_counts()
        for i in range(6):
            for k, ar in enumerate(ars):
                mux.ingest(f"s{k}", ar.total_intensity()[i], ar.weights[i])
            mux.pump(force=True)
        counts = tk.launch_counts()
        assert counts["cell_diagnostics_dedisp"] == mux.dispatches \
            == 6 * -(-5 // max_batch)
        assert counts["combine_zap"] == mux.dispatches
        for k, solo in enumerate(solos):
            lane = mux.session(f"s{k}")
            np.testing.assert_array_equal(lane.provisional_weights,
                                          solo.provisional_weights)
            assert np.array_equal(lane.provisional_scores,
                                  solo.provisional_scores, equal_nan=True)
            np.testing.assert_array_equal(lane.template(), solo.template())


# ---------------------------------------------------------------------------
# the serve daemon (serve/) and the profiler on the card
# ---------------------------------------------------------------------------

def _serve_get(url):
    import json
    import urllib.request

    return json.loads(urllib.request.urlopen(url, timeout=120).read())


def _serve_post(url, doc):
    import json
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(doc).encode())
    return json.loads(urllib.request.urlopen(req, timeout=120).read())


def _serve_done(url, rid):
    import time

    deadline = time.time() + 300
    while time.time() < deadline:
        state = _serve_get(url + "/requests/" + rid)
        if state["state"] in ("done", "failed"):
            return state
        time.sleep(0.05)
    pytest.fail(f"request {rid} never finished")


def test_serve_daemon_on_card_bit_equal_to_clean_archive(card, tmp_path):
    """An in-process daemon on the card: an archive request's outputs
    bit-equal to ``clean_archive`` on the card, its kernels launched once
    per batch iteration; a stream request's close bit-equal to a solo
    ``OnlineSession`` on the card; the bucket program's roofline gauges
    against the H100's (not nominal) peaks, in (0, 1.05]."""
    import signal
    import threading
    import time

    from iterative_cleaner_torch.config import ServeConfig
    from iterative_cleaner_torch.io import load_archive, save_archive
    from iterative_cleaner_torch.online import OnlineSession, StreamMeta
    from iterative_cleaner_torch.serve import ServeDaemon
    from iterative_cleaner_torch.telemetry import labeled, profiling

    cfg = CleanConfig(max_iter=3)
    paths = []
    for i in range(3):
        ar, _ = make_synthetic_archive(nsub=32, nchan=64, nbin=128,
                                       seed=90 + i, n_rfi_cells=10 * i + 4)
        paths.append(str(tmp_path / ("s%d.sf" % i)))
        save_archive(ar, paths[-1])
    d = ServeDaemon(ServeConfig(
        http_port=0, poll_s=0.02, journal_path=str(tmp_path / "j.jsonl"),
        flight_recorder=str(tmp_path / "f.json"),
        profile_dir=str(tmp_path / "prof")), cfg, quiet=True)
    t = threading.Thread(target=d.run, daemon=True)
    t.start()
    while d._httpd is None:
        time.sleep(0.01)
    url = "http://127.0.0.1:%d" % d._httpd.server_address[1]
    try:
        tk.reset_launch_counts()
        _serve_post(url + "/submit", {"paths": paths, "id": "a"})
        assert _serve_done(url, "a")["state"] == "done"
        counts = tk.launch_counts()
        ar, _ = make_synthetic_archive(nsub=6, nchan=256, nbin=128, seed=5)
        meta = StreamMeta.from_archive(ar)
        cube = ar.total_intensity()
        chunks = []
        for i in range(ar.nsub):
            chunks.append(str(tmp_path / ("%03d.npy" % i)))
            np.save(chunks[-1], cube[i])
        _serve_post(url + "/submit", {"id": "live", "kind": "stream",
                                      "meta": meta.to_dict()})
        for i, c in enumerate(chunks):
            _serve_post(url + "/stream/live/subint", {"path": c, "seq": i})
        _serve_post(url + "/stream/live/close", {})
        live = _serve_done(url, "live")
        gauges = dict(d.registry.gauges)
    finally:
        d._on_signal(signal.SIGTERM, None)
        t.join(120)
    wants = {p: clean_archive(load_archive(p), cfg) for p in paths}
    iters = max(w.loops for w in wants.values())
    assert {k: v for k, v in counts.items() if v} == {
        k: iters for k in ROUTE_KERNELS["default"]}
    for p, want in wants.items():
        got = load_archive(p + "_cleaned.sf").weights
        np.testing.assert_array_equal(got == 0, want.final_weights == 0)
    solo = OnlineSession(meta, cfg)
    for tile in cube:
        solo.ingest(tile)
    np.testing.assert_array_equal(load_archive(live["out"]).weights,
                                  solo.close().archive.weights)
    name = "fleet_bucket/default/32x64x128x3"
    assert gauges["prof_peak_nominal"] == 0.0
    assert 0 < gauges[labeled("prof_hbm_util", program=name)] <= 1.05
    assert 0 < gauges[labeled("prof_roofline_frac", program=name)] <= 1.05
    assert gauges[labeled("prof_peak_bytes", program=name)] > 0
    assert not profiling.profiling_enabled()


def test_profile_capture_holds_the_cards_kernels(card, tmp_path):
    """A ``torch.profiler`` capture around a clean on the card: its trace
    holds the route's kernels as often as the launch counters say, and
    its manifest names the card."""
    import json
    import os

    from iterative_cleaner_torch.telemetry import profiling
    from iterative_cleaner_torch.utils.tracing import trace_event_counts

    ar, _ = make_synthetic_archive(nsub=32, nchan=64, nbin=128, seed=4)
    clean_archive(ar, CleanConfig(max_iter=2))        # warm
    tk.reset_launch_counts()
    with profiling.trace_capture(str(tmp_path)) as final:
        res = clean_archive(ar, CleanConfig(max_iter=2))
    counts = tk.launch_counts()
    kernels = trace_event_counts(os.path.join(final, "trace.json"),
                                 "kernel")
    got = sum(v for k, v in kernels.items() if "icln_cell_stats_kernel" in k)
    assert got == counts["cell_diagnostics_disp"] == res.loops
    with open(os.path.join(final, "profile_manifest.json")) as f:
        assert json.load(f)["device_kind"] == torch.cuda.get_device_name()


# ------------------------------------------------------- card contracts

def _contracts():
    from iterative_cleaner_torch.analysis import card_contracts as cc

    return cc


@pytest.mark.parametrize("name", ["clean_loop", "clean_loop_batch",
                                  "online_step", "mux_step", "sweep",
                                  "sweep_bf16", "sharded_sweep",
                                  "mesh_padded_sweep"])
def test_card_contracts_hold_on_card(card, name):
    """Every registered program holds all five contracts on the card: at
    most its pinned host reads an iteration (the sync debug mode giving
    the same count), no float64, its pinned dispatch count, the cube
    read by its kernels alone, no cube-sized allocation."""
    cc = _contracts()
    program = cc.program_named(name)
    report = cc.verify_program(program, card)
    assert report.ok, [v.render() for v in report.violations]
    assert report.decided == cc.CONTRACTS
    assert report.sync_warnings == report.host_reads \
        == program.host_reads * report.iterations
    assert 0 < report.peak_delta_bytes < report.cube_bytes
    assert report.ops + report.launches <= program.max_ops \
        * report.iterations


def test_seeded_host_sync_caught_by_count_and_sync_mode_on_card(card):
    """An ``.item()`` inside the online step: one host read by the
    dispatch count and one warning of the sync debug mode."""
    cc = _contracts()
    report = cc.verify_program(
        cc.seeded(cc.program_named("online_step"), "host-sync"), card)
    assert "no-host-sync" in {v.contract for v in report.violations}
    assert report.host_reads == 1 and report.sync_warnings == 1


@pytest.mark.parametrize("seed,contract", [("f64", "no-f64"),
                                           ("extra-op", "dispatch-bound"),
                                           ("cube-copy", "no-cube-copy")])
def test_seeded_violations_caught_on_card(card, seed, contract):
    cc = _contracts()
    report = cc.verify_program(cc.seeded(cc.program_named("sweep"), seed),
                               card)
    assert contract in {v.contract for v in report.violations}
    if seed == "cube-copy":
        assert "single-cube-read" in {v.contract for v in report.violations}


@pytest.mark.parametrize("name,kernels", [
    ("clean_loop", ROUTE_KERNELS["default"]),
    ("clean_loop_batch", ROUTE_KERNELS["default"]),
    ("online_step", ("cell_diagnostics_dedisp", "scaled_sides_axis0",
                     "scaled_sides_axis1", "combine_zap")),
    ("mux_step", ("cell_diagnostics_dedisp", "scaled_sides_axis0",
                  "scaled_sides_axis1", "combine_zap")),
    ("sweep_bf16", storage_kernels(ROUTE_KERNELS["default"], "bfloat16")),
    ("sharded_sweep", SHARD_KERNELS["default"][1:]),
])
def test_single_cube_read_counters_match_the_route_kernels(card, name,
                                                           kernels):
    """The launch counters of ``single-cube-read``: each of the route's
    kernels once an iteration (the batch's and the lanes' folded into one
    launch; the sharded sweep's template, K1, is built before it), and
    nothing else."""
    cc = _contracts()
    report = cc.verify_program(cc.program_named(name), card)
    assert report.kernel_launches == {k: report.iterations for k in kernels}


def test_padded_mesh_ranks_on_card(card):
    """``mesh_padded_sweep`` on four gloo ranks sharing the card: on each
    rank K10 and the combine once, no host read or sync warning outside
    the gloo collectives, the peak under one block; then a host sync
    seeded into rank 2 alone, caught there by the dispatch count and the
    sync debug mode."""
    cc = _contracts()
    program = cc.program_named("mesh_padded_sweep")
    report = cc.verify_program(program, card)
    assert report.ok, [v.render() for v in report.violations]
    assert report.mesh == (2, 2) and report.pads == (1, 1)
    kernels = SHARD_KERNELS["default"][1:]
    for rk in report.ranks:
        assert rk["kernel_launches"] == {k: rk["iterations"] for k in kernels}
        assert rk["host_reads_per_iter"] == rk["sync_warnings_per_iter"] == 0
        assert 0 < rk["peak_delta_bytes"] < rk["cube_bytes"]
    seeded = cc.verify_program(cc.seeded(program, "host-sync", rank=2), card)
    # the .item() also adds two ops past rank 2's dispatch pin
    assert {v.contract for v in seeded.violations} \
        == {"no-host-sync", "dispatch-bound"}
    assert all(v.detail.startswith("rank 2: ") for v in seeded.violations)
    assert [(rk["host_reads_per_iter"], rk["sync_warnings_per_iter"])
            for rk in seeded.ranks] == [(0, 0), (0, 0), (1, 1), (0, 0)]


# ---- the FFT build of the cell diagnostics past the DFT tables (K2f) ----

FFT_SHAPES = {   # storage: (a cluster of 4 (float64: 2), a cluster of 8,
    #               the radix-3 stage on a cluster of 4)
    torch.float32: ((4, 16, 32768), (2, 8, 65536), (2, 8, 24576)),
    torch.bfloat16: ((4, 16, 32768), (2, 8, 65536), (2, 8, 24576)),
    torch.float64: ((4, 16, 16384), (2, 8, 65536), (2, 8, 24576)),
}


def _fft_operands(dev, lead, nsub, nchan, nbin, storage, seed):
    """Cube (with a pulse and a spike) in ``storage``, template rows,
    Nyquist rows, template, weights with zeros, mask and window, made with
    numpy; a leading batch ``lead`` (a tuple) on the per-archive ones."""
    rng = np.random.default_rng(seed)
    real = tk.real_dtype(storage)
    t = np.exp(-0.5 * ((np.arange(nbin) - nbin / 3) / (nbin / 64)) ** 2)
    cube = rng.standard_normal(lead + (nsub, nchan, nbin)) + 3.0 * t
    cube[..., nsub - 1, nchan - 1, 100] = 60.0
    rot = np.stack([np.roll(t, 5 * c) for c in range(nchan)])
    nyq = rng.standard_normal((nchan, nbin)) * 1e-3
    w = rng.random(lead + (nsub, nchan))
    w[w < 0.15] = 0.0
    win = np.ones(nbin)
    win[nbin // 4: nbin // 3] = 0.5

    def up(a, shape=None):
        a = np.array(np.broadcast_to(a, shape)) if shape else a
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, real)

    wt = up(w)
    c = up(cube)
    return (c.to(storage), (c * 0.5).to(storage), up(rot, lead + rot.shape),
            up(nyq, lead + nyq.shape), up(t, lead + t.shape), wt, wt == 0,
            up(win))


def _fft_forms(ops):
    """(counter name, the routed wrapper, its plain version) of every
    entry, at lengths past the DFT tables (the FFT build's route)."""
    c, b, r, n, t, w, m, win = ops
    assert tk.cell_stats_route(c.shape[-1], c.element_size()) in (
        "fft", "fft_global")
    return [
        ("cell_diagnostics_disp",
         lambda: tk.cell_diagnostics_disp(c, r, n, t, w, m),
         lambda: tk.cell_diagnostics_disp_plain(c, r, n, t, w, m)),
        ("cell_diagnostics_disp",
         lambda: tk.cell_diagnostics_disp(c, r, None, t, w, m),
         lambda: tk.cell_diagnostics_disp_plain(c, r, None, t, w, m)),
        ("cell_diagnostics_two_read",
         lambda: tk.cell_diagnostics_two_read(c, b, r, t, w, m),
         lambda: tk.cell_diagnostics_two_read_plain(c, b, r, t, w, m)),
        ("cell_diagnostics_dedisp",
         lambda: tk.cell_diagnostics_dedisp(c, t, win, w, m),
         lambda: tk.cell_diagnostics_dedisp_plain(c, t, win, w, m)),
        ("shard_diagnostics_disp",
         lambda: tk.shard_diagnostics_disp(c, r, n, t, w, m),
         lambda: tk.cell_diagnostics_disp_plain(c, r, n, t, w, m)),
        ("shard_diagnostics_dedisp",
         lambda: tk.shard_diagnostics_dedisp(c, t, win, w, m),
         lambda: tk.cell_diagnostics_dedisp_plain(c, t, win, w, m)),
    ]


def _fft_planes_close(got, want, mask, rtol, fft_masked_exact=True):
    """Within ``rtol`` of (|want| + each plane's scale), masked cells
    bit-equal; a batch archive by archive.  ``fft_masked_exact`` False
    holds d_fft's masked cells by the tolerance (K2g: d_fft is not
    patched by the mask, and torch.fft on the card takes an odd-length
    zero row to about 3e-5 where K2g gives 0)."""
    if mask.dim() == 3:
        for i in range(mask.shape[0]):
            _fft_planes_close([g[i] for g in got], [w[i] for w in want],
                              mask[i], rtol, fft_masked_exact)
        return
    for k, (g, w) in enumerate(zip(got, want)):
        scale = w[~mask].abs().max()
        assert bool(((g - w).abs() <= rtol * (w.abs() + scale)).all())
        if fft_masked_exact or k < 3:
            assert torch.equal(g[mask], w[mask])


@pytest.mark.parametrize("storage", list(FFT_SHAPES))
@pytest.mark.parametrize("kind", [0, 1, 2])
def test_fft_build_matches_plain_on_card(card, storage, kind):
    """Every entry of the FFT build (clusters of 2 or 4, of 8, the
    radix-3 stage) within 1e-4 of each plane's scale (1e-12 in float64),
    masked cells exact, one launch under its ``_fft`` counter."""
    nsub, nchan, nbin = FFT_SHAPES[storage][kind]
    ops = _fft_operands(card, (), nsub, nchan, nbin, storage, nbin % 89)
    plan = tk.cell_fft_plan(nbin, ops[0].element_size())
    want = (2 if storage == torch.float64 else 4, 8, 4)[kind]
    assert (plan.cluster, plan.odd) == (want, 3 if kind == 2 else 1)
    sfx = {torch.bfloat16: "_bf16", torch.float64: "_f64"}.get(storage, "")
    rtol = 1e-12 if storage == torch.float64 else 1e-4
    for name, kfn, pfn in _fft_forms(ops):
        tk.reset_launch_counts()
        got = kfn()
        torch.cuda.synchronize()
        assert {k: v for k, v in tk.launch_counts().items() if v} \
            == {f"{name}_fft{sfx}": 1}
        _fft_planes_close(got, pfn(), ops[6], rtol)


@pytest.mark.parametrize("storage", list(FFT_SHAPES))
def test_fft_build_k10_and_batch_bit_equal_on_card(card, storage):
    """K10's FFT build bit-equal to K2's and K6's on the same cells; a
    batch of two bit-equal archive by archive to single launches."""
    nsub, nchan, nbin = FFT_SHAPES[storage][1]
    c, b, r, n, t, w, m, win = _fft_operands(card, (), nsub, nchan, nbin,
                                             storage, 3)
    for x, y in zip(tk.shard_diagnostics_disp(c, r, n, t, w, m)
                    + tk.shard_diagnostics_dedisp(c, t, win, w, m),
                    tk.cell_diagnostics_disp(c, r, n, t, w, m)
                    + tk.cell_diagnostics_dedisp(c, t, win, w, m)):
        assert torch.equal(x, y)
    ops = _fft_operands(card, (2,), nsub, nchan, nbin, storage, 4)
    c, b, r, n, t, w, m, win = ops
    for batched, single in (
            (tk.cell_diagnostics_disp(c, r, n, t, w, m),
             lambda i: tk.cell_diagnostics_disp(c[i], r[i], n[i], t[i], w[i],
                                                m[i])),
            (tk.cell_diagnostics_two_read(c, b, r, t, w, m),
             lambda i: tk.cell_diagnostics_two_read(c[i], b[i], r[i], t[i],
                                                    w[i], m[i])),
            (tk.cell_diagnostics_dedisp(c, t, win, w, m),
             lambda i: tk.cell_diagnostics_dedisp(c[i], t[i], win, w[i],
                                                  m[i]))):
        for i in range(2):
            for x, y in zip(batched, single(i)):
                assert torch.equal(x[i], y)


def test_fft_build_bf16_bit_equal_to_float32_on_upcast_cube(card):
    ops = _fft_operands(card, (), 2, 8, 65536, torch.bfloat16, 5)
    up = (ops[0].float(), ops[1].float()) + ops[2:]
    for (_, k16, _), (_, k32, _) in zip(_fft_forms(ops), _fft_forms(up)):
        for x, y in zip(k16(), k32()):
            assert torch.equal(x, y)


# ---- K2f's mixed radix-3/5 stages and K2g, the FFT build through device
# memory (cell_fft_global.cu) ----

FFTG_SHAPES = {   # storage: (Bluestein in a cluster: a prime and an odd
    # length, the split row, a prime past the cluster: Bluestein's passes)
    torch.float32: ((4, 16, 65521), (4, 16, 20001), (2, 8, 524288),
                    (2, 8, 136537)),
    torch.bfloat16: ((4, 16, 16411), (4, 16, 20001), (2, 8, 524288),
                     (2, 8, 136537)),
    torch.float64: ((4, 16, 65521), (4, 16, 20001), (2, 8, 262144),
                    (2, 8, 69127)),
}
FFTG_MODES = ("cluster", "cluster", "split", "bluestein")


@pytest.mark.parametrize("storage", list(FFTG_SHAPES))
@pytest.mark.parametrize("kind", [0, 1, 2, 3])
def test_fftg_build_matches_plain_on_card(card, storage, kind):
    """Every entry of K2g (the cluster mode, the split row, Bluestein's
    passes) within 1e-4 of each plane's scale (1e-12 in float64), the
    moments' masked cells exact, one launch under its ``_fftg``
    counter."""
    nsub, nchan, nbin = FFTG_SHAPES[storage][kind]
    ops = _fft_operands(card, (), nsub, nchan, nbin, storage, nbin % 83)
    plan = tk.cell_fft_global_plan(nbin, ops[0].element_size())
    assert plan.mode == FFTG_MODES[kind]
    sfx = {torch.bfloat16: "_bf16", torch.float64: "_f64"}.get(storage, "")
    rtol = 1e-12 if storage == torch.float64 else 1e-4
    for name, kfn, pfn in _fft_forms(ops):
        tk.reset_launch_counts()
        got = kfn()
        torch.cuda.synchronize()
        assert {k: v for k, v in tk.launch_counts().items() if v} \
            == {f"{name}_fftg{sfx}": 1}
        _fft_planes_close(got, pfn(), ops[6], rtol, fft_masked_exact=False)


@pytest.mark.parametrize("storage", list(FFTG_SHAPES))
def test_fftg_k10_batch_and_tiles_bit_equal_on_card(card, storage):
    """K2g's K10 entries bit-equal to K2's and K6's; a batch of two
    bit-equal archive by archive to single launches; ``out=`` tiles of two
    subint halves bit-equal to the whole."""
    nsub, nchan, nbin = FFTG_SHAPES[storage][0]
    c, b, r, n, t, w, m, win = _fft_operands(card, (), nsub, nchan, nbin,
                                             storage, 3)
    for x, y in zip(tk.shard_diagnostics_disp(c, r, n, t, w, m)
                    + tk.shard_diagnostics_dedisp(c, t, win, w, m),
                    tk.cell_diagnostics_disp(c, r, n, t, w, m)
                    + tk.cell_diagnostics_dedisp(c, t, win, w, m)):
        assert torch.equal(x, y)
    whole = tk.cell_diagnostics_two_read(c, b, r, t, w, m)
    full = [torch.full_like(x, -1.0) for x in whole]
    h = nsub // 2
    for lo, hi in ((0, h), (h, nsub)):
        tk.cell_diagnostics_two_read(c[lo:hi], b[lo:hi], r, t,
                                     w[lo:hi].contiguous(),
                                     m[lo:hi].contiguous(),
                                     out=[f[lo:hi] for f in full])
    for x, y in zip(full, whole):
        assert torch.equal(x, y)
    c, b, r, n, t, w, m, win = _fft_operands(card, (2,), 2, 4, nbin,
                                             storage, 4)
    batched = tk.cell_diagnostics_dedisp(c, t, win, w, m)
    for i in range(2):
        for x, y in zip(batched, tk.cell_diagnostics_dedisp(
                c[i], t[i], win, w[i], m[i])):
            assert torch.equal(x[i], y)


@pytest.mark.parametrize("nbin", [16411, 524288, 136537])
def test_fftg_bf16_bit_equal_to_float32_on_upcast_cube(card, nbin):
    ops = _fft_operands(card, (), 2, 8, nbin, torch.bfloat16, 5)
    up = (ops[0].float(), ops[1].float()) + ops[2:]
    for (_, k16, _), (_, k32, _) in zip(_fft_forms(ops), _fft_forms(up)):
        for x, y in zip(k16(), k32()):
            assert torch.equal(x, y)


@pytest.mark.parametrize("nbin,real", [(136537, torch.float32),
                                       (524288, torch.float32),
                                       (69127, torch.float64)])
def test_fftg_passes_match_torch_fft_on_card(card, nbin, real):
    """K2g's forward passes leave X[f] at the passes' position of f
    (torch.fft.fft permuted), the inverse passes give n x back, and the
    chirp's spectrum B^ is the chirp row's spectrum / M in that order."""
    plan = tk.cell_fft_global_plan(nbin, 8 if real == torch.float64 else 4)
    n = plan.n
    z0 = torch.randn((2, n, 2), generator=torch.Generator().manual_seed(n),
                     dtype=torch.float64)
    z = z0.to(card, real).contiguous()
    tw = tk._fft_twiddles(plan.table, str(card), real)
    wf, perm = tk._fftg_pass_tables(plan.passes, str(card), real)
    lib = tk.load_library()

    def run(mode):
        rc = lib.icln_fftg_passes(
            tk._ptr(z), None, 2, n, *tk._fftg_pass_args(plan), tk._ptr(tw),
            tk._ptr(wf), tk._ptr(perm), tk._fft_table_lt(plan.table),
            plan.table // n, mode, plan.threads, plan.tile, tk._KIND[real],
            tk._stream(z))
        torch.cuda.synchronize()
        assert rc == 0

    s, f, pos, mult = n, np.zeros(n, dtype=np.int64), np.arange(n), 1
    for fj in plan.passes:
        s //= fj
        q = pos // s
        pos, f, mult = pos - q * s, f + q * mult, mult * fj
    zc = torch.view_as_complex(z0)
    want = torch.fft.fft(zc, dim=-1)[:, torch.from_numpy(f)]
    tol = 1e-12 if real == torch.float64 else 1e-5
    run(0)
    got = torch.view_as_complex(z.double().cpu().contiguous())
    assert float((got - want).abs().max() / want.abs().max()) <= tol
    run(1)
    back = torch.view_as_complex(z.double().cpu().contiguous()) / n
    assert float((back - zc).abs().max() / zc.abs().max()) <= tol
    if plan.mode == "bluestein":
        b = tk.fftg_chirp_row(nbin, n)
        bh = np.fft.fft(b[:, 0] + 1j * b[:, 1])[f] / n
        got = tk._fftg_bhat(nbin, str(card), torch.float64).cpu().numpy()
        got = got[:, 0] + 1j * got[:, 1]
        assert np.abs(got - bh).max() <= 1e-12 * np.abs(bh).max()


def test_fftg_cluster_mode_refusal_raises_on_card(card, monkeypatch):
    """A cluster-mode launch whose cluster does not fit (shared memory
    past a block's) raises; nothing falls back to the passes or the plain
    version."""
    ops = _fft_operands(card, (), 2, 8, 65521, torch.float32, 9)
    plan = tk.cell_fft_global_plan(65521, 4)
    assert plan.mode == "cluster"
    big = plan._replace(smem=tk._SMEM_LIMIT)
    monkeypatch.setattr(tk, "cell_fft_global_plan", lambda n, i=4: big)
    monkeypatch.setattr(tk, "cell_diagnostics_disp_plain", None)
    with pytest.raises(RuntimeError, match="fft_global build"):
        tk.cell_diagnostics_disp(ops[0], *ops[2:7])


def test_fftg_cluster_mode_allocates_no_scratch_on_card(card):
    """The cluster mode at (L5b)'s length allocates its four planes and
    the wrapper's template row (``tt_info``), under one row of the
    passes' scratch (M complex values): no scratch in device memory."""
    ops = _fft_operands(card, (), 4, 16, 65521, torch.float32, 10)
    plan = tk.cell_fft_global_plan(65521, 4)
    tk.cell_diagnostics_disp(ops[0], *ops[2:7])
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    tk.cell_diagnostics_disp(ops[0], *ops[2:7])
    torch.cuda.synchronize()
    own = torch.cuda.max_memory_allocated() - before
    planes = 4 * ops[5].numel() * 4
    assert own <= planes + 65521 * 4 + 8 * 512 < plan.n * 2 * 4


# storage: K2f's rows of several odd stages (nbin, odd part), the most
# stages the route gives it (kernels.FFT_ODD_STAGES) last
MIXED_ODD = {torch.float32: ((36864, 9), (46080, 45)),
             torch.bfloat16: ((36864, 9), (46080, 45)),
             torch.float64: ((46080, 45), (20000, 625))}


@pytest.mark.parametrize("storage", list(MIXED_ODD))
@pytest.mark.parametrize("case", [0, 1])
def test_fft_build_mixed_odd_stages_on_card(card, storage, case):
    """K2f at odd parts of two and three odd stages (float32, bf16) and
    three and four (float64) within 1e-4 of each plane's scale (1e-12 in
    float64), masked cells exact, under its ``_fft`` counter."""
    nbin, odd = MIXED_ODD[storage][case]
    ops = _fft_operands(card, (), 4, 16, nbin, storage, 6)
    assert tk.cell_stats_route(nbin, ops[0].element_size()) == "fft"
    assert tk.cell_fft_plan(nbin, ops[0].element_size()).odd == odd
    sfx = {torch.bfloat16: "_bf16", torch.float64: "_f64"}.get(storage, "")
    rtol = 1e-12 if storage == torch.float64 else 1e-4
    for name, kfn, pfn in _fft_forms(ops):
        tk.reset_launch_counts()
        got = kfn()
        torch.cuda.synchronize()
        assert {k: v for k, v in tk.launch_counts().items() if v} \
            == {f"{name}_fft{sfx}": 1}
        _fft_planes_close(got, pfn(), ops[6], rtol)


LONG_CLEANS = {   # case: (nbin, configuration)
    "default": (32768, {}),
    "dedispersed": (32768, dict(stats_frame="dedispersed")),
    "profile": (32768, dict(baseline_mode="profile")),
    "float64 16384": (16384, dict(dtype="float64")),
    "float64 default": (32768, dict(dtype="float64")),
    "float64 dedispersed": (32768, dict(stats_frame="dedispersed",
                                        dtype="float64")),
    "float64 profile": (32768, dict(baseline_mode="profile",
                                    dtype="float64")),
    "float64 odd part 3": (24576, dict(dtype="float64")),
    # K2f's mixed odd stages; K2g's Bluestein (a prime, an odd length, 7 x
    # 4096) and split rows
    "odd part 625": (20000, {}),
    "float64 odd part 625": (20000, dict(dtype="float64")),
    "prime": (16411, {}),
    "float64 prime": (16411, dict(dtype="float64")),
    "odd dedispersed": (20001, dict(stats_frame="dedispersed")),
    "profile 7 x 4096": (28672, dict(baseline_mode="profile")),
    "float64 profile 7 x 4096": (28672, dict(baseline_mode="profile",
                                             dtype="float64")),
}


def _long_archive(nbin, seed=41):
    ar, _ = make_synthetic_archive(nsub=4, nchan=8, nbin=nbin,
                                   n_prezapped=2, seed=seed)
    return ar


def _score_err(got, want):
    """Largest |got - want| / (|want| + 1e-3) over cells."""
    return float(np.max(np.abs(got - want) / (np.abs(want) + 1e-3)))


def _assert_long_clean(got, ar, kw):
    """Masks and loops equal to the CPU clean's (as chip_smoke's phase 3f
    holds long profiles), scores finite; float64 scores within 1e-9 of
    the CPU's; float32 scores no farther from the CPU's float64 clean
    than the CPU's float32 scores are, by more than 1e-3 (relative, with
    a 1e-3 floor, as tests/test_torch_long_profiles.py holds the port to
    the reference).  The baselines' window sums are fixed trees of
    elementwise adds, the same bits on both devices (ROADMAP section 3
    (f), repaired): a float32 contraction over the bins had put the
    card's scores about 10x farther (0.0165 against 0.0016)."""
    want = clean_archive(ar, CleanConfig(device="cpu", **kw))
    np.testing.assert_array_equal(got.final_weights == 0,
                                  want.final_weights == 0)
    assert got.loops == want.loops
    assert np.all(np.isfinite(got.scores[got.final_weights != 0]))
    if kw.get("dtype") == "float64":
        np.testing.assert_allclose(got.scores, want.scores, rtol=1e-9,
                                   atol=1e-9)
        return
    f64 = clean_archive(ar, CleanConfig(**{**kw, "device": "cpu",
                                           "dtype": "float64"}))
    assert _score_err(got.scores, f64.scores) \
        <= _score_err(want.scores, f64.scores) + 1e-3


@pytest.mark.parametrize("nbin", [128, 32768])
def test_baseline_offsets_on_card_bit_equal_to_cpu(card, nbin):
    """The integration and profile baselines' offsets of a float32 cube
    past 1024 bins on the card bit-equal to the CPU's (fixed trees of
    elementwise adds) and within 3e-7 of the float64 offsets' scale; at
    128 bins (the library's contraction and the circulant matmul, as the
    reference sums them) within 1e-6 of the CPU's."""
    from iterative_cleaner_torch.ops import dsp
    from iterative_cleaner_torch.ops.psrchive_baseline import (
        baseline_offsets_integration,
    )

    ar = _long_archive(nbin)
    cube = np.array(ar.total_intensity(), dtype=np.float64)
    w = np.array(ar.weights, dtype=np.float64)
    for name, fn in (("integration", lambda c, x: baseline_offsets_integration(
            c, x, 0.15)), ("profile", lambda c, x: dsp.baseline_offsets(c))):
        want64 = fn(torch.from_numpy(cube), torch.from_numpy(w))
        c32, w32 = (torch.from_numpy(a.astype(np.float32)) for a in (cube, w))
        cpu = fn(c32, w32)
        got = fn(c32.to(card), w32.to(card)).cpu()
        scale = float(want64.abs().max())
        if nbin <= 1024:
            assert float((got - cpu).abs().max()) <= 1e-6 * scale, name
            continue
        assert torch.equal(got, cpu), name
        assert float((got.double() - want64).abs().max()) <= 3e-7 * scale


@pytest.mark.parametrize("case", list(LONG_CLEANS))
def test_long_profile_clean_on_card_matches_cpu(card, case):
    """A 4 x 8 archive past the DFT tables cleaned on the card through the
    FFT build: its route's FFT build once an iteration and no DFT launch,
    held to the CPU clean by :func:`_assert_long_clean`."""
    nbin, kw = LONG_CLEANS[case]
    ar = _long_archive(nbin)
    cfg = CleanConfig(**kw)
    tk.reset_launch_counts()
    got = clean_archive(ar, cfg)
    counts = tk.launch_counts()
    route = select_route(cfg, ar.dedispersed)
    own = storage_kernels(spectrum_kernels(ROUTE_KERNELS[route], nbin,
                                           cfg.dtype), "float32", cfg.dtype)
    assert {k: v for k, v in counts.items() if v} \
        == {k: got.loops for k in own}
    _assert_long_clean(got, ar, kw)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_long_profile_batch_and_stream_on_card_match_cpu(card, dtype):
    """A batch of two 4 x 8 x 32768 archives (one launch of each kernel an
    iteration) and an exact stream in tiles of 2 on the card, each held
    to the CPU clean by :func:`_assert_long_clean`."""
    from iterative_cleaner_torch.parallel.batch import clean_archives_batched

    ars = [_long_archive(32768, s) for s in (26, 27)]
    kw = dict(dtype=dtype)
    for got, ar in zip(clean_archives_batched(ars, CleanConfig(**kw)), ars):
        _assert_long_clean(got, ar, kw)
    ar = _long_archive(32768, 28)
    _assert_long_clean(clean_streaming(ar, 2, CleanConfig(**kw)), ar, kw)
