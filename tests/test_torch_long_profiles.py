"""Long profiles on the CPU: the cell diagnostics past the DFT tables
(``stats.kernels.cell_stats_route`` "fft", over 16,384 bins or 8,192 in
float64), against the JAX package.

- The planes: the port's plain versions of every residual form (K2 with
  and without the Nyquist term, K7, K6, and K10's entries), on the FFT
  route by the shape, against the JAX package's ``cell_diagnostics_jax(
  ..., fft_mode="fft")`` (its XLA route past 4096 bins) on the port's own
  residual and mask: within 1e-4 of each plane's scale in float32 and
  1e-12 in float64, as the DFT kernels are held (masked cells included);
  the routed wrappers give the same planes on the CPU, ``out=`` tiles
  too, and ``cell_fft_disp`` (K2's FFT build at any length) too.
- The whole clean against the JAX package's default route
  (``CleanConfig()``: ``stats_impl='auto'``, its XLA route with FFT
  spectra on the CPU) at 4 x 8 x 32768 (default and profile baseline),
  4 x 8 x 24576 (odd part 3: the radix-3 stage's shape), a batch of two
  at 32,768, the dedispersed frame and an exact stream in tiles of 2,
  each in float32 and in float64, and 4 x 8 x 16384 in float64: masks
  and loops equal; float64 scores within rtol 1e-9 and atol 1e-9 (as
  tests/test_torch_float64.py holds float64 cleans).  The float32 scores are held to the reference's float64
  clean of the same archive: no farther from it than the reference's
  own float32 scores are, by more than 1e-3 (relative, with a 1e-3
  floor, as tests/test_torch_shapes.py holds 8192 bins).  A closer bound
  between the two float32 cleans does not hold at this length: their
  moments sum 32,768 float32 bins in other orders, and the scaler's MAD
  over 4 subints magnifies that; measured on these archives the
  reference's float32 scores lie up to 0.13 from its float64 ones (the
  dedispersed frame) and the port's up to 0.004; at 24,576 bins both
  lie 0.086 from them on one cell.
- The route and the FFT build's plan: the DFT route up to 16,384 bins
  (8,192 in float64), the fewest blocks a cell (a cluster of 2, 4 or 8)
  whose slices hold at most 8192 bins (2 at 8,192 and 16,384 float64
  bins; 4 at 20,480 (odd part 5), 24,576 and 32,768; 8 at 49,152, 65,536
  and 262,144), 128 threads a block; K1's plan fits at 65,536 bins in
  float32, bf16 and float64; a failed FFT launch raises (no fallback);
  the launch counters and the kernel model's entries of the FFT build
  (its 0.64 ms bound at 32 x 256 x 65536).
- Every length past the DFT tables: the cluster build K2f at odd parts
  3^a 5^b of at most three odd stages in float32 and bf16 and four in
  float64, where it is the faster build (its mixed radix-3/5 stages:
  46,080 = 2^10 x 3^2 x 5; float64 20,000 = 2^5 x 5^4); K2g
  (``cell_fft_global.cu``, route "fft_global") everywhere else: Bluestein
  at a prime factor over 5 or an odd length (16,411, 20,001, 7 x 4096,
  65,521: in a cluster; 136,537 and float64's 69,127 past one, through
  the passes), the split row past the cluster's capacity (524,288;
  262,144 in float64) and at the longer odd parts (20,000 and 60,000 in
  float32, 60,000 = 2^5 x 3 x 5^4 in float64 too).  The shapes
  refused until K2g now route to it (the same parametrised cases); its
  plans; the one limit left (a transform past 32-bit row indices) still
  names ROADMAP item 9.  The plain planes at 16,411, 28,672, 60,000 and
  524,288 bins and whole cleans at 16,411, 20,000, 20,001 (dedispersed
  frame) and 28,672 (profile baseline), each in float32 and float64,
  against the JAX package as above; K2g's launches through fakes counted
  as ``<name>_fftg``, a failed one raising (no fallback); the on-device
  synthetic archive chip_smoke.py's (L5) cleans.
"""

import contextlib
import dataclasses
import types

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
from iterative_cleaner_tpu.stats.masked_jax import cell_diagnostics_jax
from iterative_cleaner_torch import CleanConfig, clean_streaming
from iterative_cleaner_torch.backends import (
    clean_archive,
    clean_archives_batched,
)
from iterative_cleaner_torch.convert import (
    archive_from_reference,
    config_from_reference,
)
from iterative_cleaner_torch.engine.loop import (
    FFT_KERNELS,
    ROUTE_KERNELS,
    spectrum_kernels,
)
from iterative_cleaner_torch.stats import kernels as tk
from iterative_cleaner_torch.telemetry import profiling

F64_SCORES = dict(rtol=1e-9, atol=1e-9)


# ---------------------------------------------------------------- planes

def _operands(nsub, nchan, nbin, dtype, seed):
    """A cube with a pulse and a spike, template rows, Nyquist rows, a
    window and weights with zeros (the mask), made with numpy."""
    rng = np.random.default_rng(seed)
    ph = np.arange(nbin)
    t = np.exp(-0.5 * ((ph - nbin / 3) / (nbin / 64)) ** 2)
    cube = rng.standard_normal((nsub, nchan, nbin)) + 3.0 * t
    cube[nsub - 1, nchan - 1, 100] = 60.0
    rot = np.stack([np.roll(t, 5 * c) for c in range(nchan)])
    nyq = rng.standard_normal((nchan, nbin)) * 1e-3
    w = rng.random((nsub, nchan))
    w[w < 0.15] = 0.0
    win = np.ones(nbin)
    win[nbin // 4: nbin // 3] = 0.5
    f = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=dtype))  # noqa: E731
    wt = f(w)
    return f(cube), f(rot), f(nyq), f(t), wt, wt == 0, f(win)


FORMS = ["disp", "disp-no-nyquist", "two_read", "dedisp", "shard_disp",
         "shard_dedisp"]


def _form_calls(form, cube, rot, nyq, t, w, m, win):
    """(the plain version, the routed wrapper, the residual) of one
    residual form on the operands."""
    base = cube * 0.5
    if form in ("disp", "disp-no-nyquist", "shard_disp"):
        ny = None if form == "disp-no-nyquist" else nyq
        fn = tk.shard_diagnostics_disp if form == "shard_disp" \
            else tk.cell_diagnostics_disp
        return (lambda: tk.cell_diagnostics_disp_plain(cube, rot, ny, t, w, m),
                lambda: fn(cube, rot, ny, t, w, m),
                tk.wres_disp(cube, rot, ny, t, w))
    if form == "two_read":
        return (lambda: tk.cell_diagnostics_two_read_plain(cube, base, rot, t,
                                                           w, m),
                lambda: tk.cell_diagnostics_two_read(cube, base, rot, t, w, m),
                tk.wres_two_read(cube, base, rot, t, w))
    fn = tk.shard_diagnostics_dedisp if form == "shard_dedisp" \
        else tk.cell_diagnostics_dedisp
    return (lambda: tk.cell_diagnostics_dedisp_plain(cube, t, win, w, m),
            lambda: fn(cube, t, win, w, m),
            tk.wres_dedisp(cube, t, win, w))


def _assert_planes(got, want, mask, rtol):
    """Within ``rtol`` of each plane's scale (max |want| over unmasked
    cells), masked cells exact."""
    for g, wnt in zip(got, want):
        g, wnt = np.asarray(g, dtype=np.float64), np.asarray(wnt,
                                                            dtype=np.float64)
        scale = np.abs(wnt[~mask]).max()
        np.testing.assert_allclose(g, wnt, rtol=0, atol=rtol * scale)
        np.testing.assert_array_equal(g[mask], wnt[mask])


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("dtype,nbin", [(np.float32, 32768),
                                        (np.float64, 16384)])
def test_planes_match_jax_xla_route(form, dtype, nbin):
    ops = _operands(4, 8, nbin, dtype, seed=nbin % 97)
    itemsize = np.dtype(dtype).itemsize
    assert tk.cell_stats_route(nbin, itemsize) == "fft"
    plain, routed, wres = _form_calls(form, *ops)
    mask = ops[5]
    want = jax.jit(lambda x, mm: cell_diagnostics_jax(x, mm, "fft"))(
        jnp.asarray(wres.numpy()), jnp.asarray(mask.numpy()))
    rtol = 1e-12 if dtype == np.float64 else 1e-4
    got = plain()
    assert all(p.dtype == ops[0].dtype for p in got)
    _assert_planes([p.numpy() for p in got], [np.asarray(x) for x in want],
                   mask.numpy(), rtol)
    # the routed wrapper takes the plain version on the CPU
    for a, b in zip(routed(), got):
        assert torch.equal(a, b)


_JAX_DIAG = jax.jit(lambda x, mm: cell_diagnostics_jax(x, mm, "fft"))


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("nbin", [16411, 28672, 60000, 524288])
def test_planes_match_jax_past_the_cluster_build(form, dtype, nbin):
    """At lengths the DFT tables and the cluster build do not take (K2g's
    Bluestein and split rows), every residual form's plain planes on 2 x 4
    cells against the
    JAX package's XLA route: within 1e-4 of each plane's scale (1e-12 in
    float64), the routed wrappers the same planes on the CPU."""
    ops = _operands(2, 4, nbin, dtype, seed=nbin % 89)
    itemsize = np.dtype(dtype).itemsize
    assert tk.cell_stats_route(nbin, itemsize) == "fft_global"
    plain, routed, wres = _form_calls(form, *ops)
    mask = ops[5]
    want = _JAX_DIAG(jnp.asarray(wres.numpy()), jnp.asarray(mask.numpy()))
    got = plain()
    _assert_planes([p.numpy() for p in got], [np.asarray(x) for x in want],
                   mask.numpy(), 1e-12 if dtype == np.float64 else 1e-4)
    for a, b in zip(routed(), got):
        assert torch.equal(a, b)


def test_fft_wrappers_fill_out_tiles():
    cube, rot, nyq, t, w, m, win = _operands(4, 8, 32768, np.float32, 3)
    want = tk.cell_diagnostics_disp_plain(cube, rot, nyq, t, w, m)
    full = [torch.full((4, 8), -1.0) for _ in range(4)]
    for lo, hi in ((0, 2), (2, 4)):
        tk.cell_diagnostics_disp(cube[lo:hi], rot, nyq, t, w[lo:hi],
                                 m[lo:hi], out=[f[lo:hi] for f in full])
    for a, b in zip(full, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("nbin", [8192, 32768])
def test_cell_fft_disp_is_the_fft_build(nbin):
    """K2's FFT build at any length: on the CPU the plain version with
    ``torch.fft``, within 1e-4 of each plane's scale of the float64 plain
    version (where K2 takes the shape too, as chip_smoke.py's (L2) holds
    it); past the tables the routed wrapper's planes."""
    ops = _operands(4, 8, nbin, np.float32, 4)
    cube, rot, nyq, t, w, m, win = ops
    got = tk.cell_fft_disp(cube, rot, nyq, t, w, m)
    want = tk.cell_diagnostics_disp_plain(cube, rot, nyq, t, w, m, "fft")
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    ref = tk.cell_diagnostics_disp_plain(
        *(x.double() for x in ops[:5]), m, "fft")
    _assert_planes([p.numpy() for p in got], [p.float().numpy() for p in ref],
                   m.numpy(), 1e-4)
    if tk.cell_stats_route(nbin) == "fft":
        for a, b in zip(got, tk.cell_diagnostics_disp(cube, rot, nyq, t, w,
                                                      m)):
            assert torch.equal(a, b)


def test_batch_planes_are_each_archives():
    a = _operands(2, 4, 32768, np.float32, 5)
    b = _operands(2, 4, 32768, np.float32, 6)
    stacked = [torch.stack([x, y]) for x, y in zip(a[:6], b[:6])]
    got = tk.cell_diagnostics_dedisp_plain(stacked[0], stacked[3], a[6],
                                           stacked[4], stacked[5])
    for i, ops in enumerate((a, b)):
        cube, _, _, t, w, m, win = ops
        for g, s in zip(got, tk.cell_diagnostics_dedisp_plain(cube, t, win,
                                                              w, m)):
            assert torch.equal(g[i], s)


# ---------------------------------------------------------- whole cleans

def _archive(nbin, seed, **kw):
    ar, _ = ref_make_synthetic_archive(nsub=4, nchan=8, nbin=nbin,
                                       n_prezapped=2, seed=seed, **kw)
    return ar


def _score_err(got, want):
    """Largest |got - want| / (|want| + 1e-3) over cells."""
    got, want = (np.asarray(a, dtype=np.float64) for a in (got, want))
    return float(np.max(np.abs(got - want) / (np.abs(want) + 1e-3)))


def _assert_clean(got, ar, ref_cfg):
    """Masks and loops equal to the reference's clean at ``ref_cfg``;
    float64 scores within 1e-9; float32 scores no farther from the
    reference's float64 clean than its float32 ones, by more than
    1e-3."""
    want = ref_clean_archive(ar, ref_cfg)
    np.testing.assert_array_equal(got.final_weights == 0,
                                  want.final_weights == 0)
    assert (got.loops, got.converged) == (want.loops, want.converged)
    if ref_cfg.dtype == "float64":
        np.testing.assert_allclose(got.scores, want.scores, **F64_SCORES)
        return
    oracle = ref_clean_archive(ar, dataclasses.replace(ref_cfg,
                                                       dtype="float64"))
    assert _score_err(got.scores, oracle.scores) \
        <= _score_err(want.scores, oracle.scores) + 1e-3


CLEANS = {
    "default 32768": (32768, 21, {}),
    "profile 32768": (32768, 22, dict(baseline_mode="profile")),
    "odd part 3, 24576": (24576, 23, {}),
    "dedispersed frame 32768": (32768, 24, dict(stats_frame="dedispersed")),
    "float64 16384": (16384, 25, dict(dtype="float64")),
    "float64 default 32768": (32768, 21, dict(dtype="float64")),
    "float64 profile 32768": (32768, 22, dict(baseline_mode="profile",
                                               dtype="float64")),
    "float64 odd part 3, 24576": (24576, 23, dict(dtype="float64")),
    "float64 dedispersed frame 32768": (32768, 24, dict(
        stats_frame="dedispersed", dtype="float64")),
    # past the cluster build (K2g): a prime length (Bluestein), an odd
    # one, 7 x 4096 on the profile baseline; 20,000 (odd part 5^4: K2g's
    # split row in float32, K2f's four odd stages in float64)
    "prime 16411": (16411, 31, {}),
    "odd 20001, dedispersed frame": (20001, 32, dict(
        stats_frame="dedispersed")),
    "profile 28672": (28672, 33, dict(baseline_mode="profile")),
    "odd part 625, 20000": (20000, 34, {}),
    "float64 prime 16411": (16411, 31, dict(dtype="float64")),
    "float64 odd 20001, dedispersed frame": (20001, 32, dict(
        stats_frame="dedispersed", dtype="float64")),
    "float64 profile 28672": (28672, 33, dict(baseline_mode="profile",
                                               dtype="float64")),
    "float64 odd part 625, 20000": (20000, 34, dict(dtype="float64")),
}


@pytest.mark.parametrize("case", sorted(CLEANS))
def test_clean_matches_jax_default_route(case):
    nbin, seed, kw = CLEANS[case]
    ar = _archive(nbin, seed)
    ref_cfg = RefConfig(**kw)
    cfg = config_from_reference(ref_cfg, device="cpu")
    assert tk.cell_stats_route(nbin, 8 if cfg.dtype == "float64" else 4) \
        in ("fft", "fft_global")
    _assert_clean(clean_archive(archive_from_reference(ar), cfg), ar,
                  ref_cfg)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_batch_of_two_matches_jax(dtype):
    ars = [_archive(32768, s) for s in (26, 27)]
    got = clean_archives_batched([archive_from_reference(a) for a in ars],
                                 CleanConfig(device="cpu", dtype=dtype))
    for g, a in zip(got, ars):
        _assert_clean(g, a, RefConfig(dtype=dtype))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_exact_stream_matches_jax(dtype):
    ar = _archive(32768, 28)
    got = clean_streaming(archive_from_reference(ar), 2,
                          CleanConfig(device="cpu", dtype=dtype))
    _assert_clean(got, ar, RefConfig(dtype=dtype))


# ------------------------------------------------- routes, plans, model

@pytest.mark.parametrize("nbin,itemsize,route", [
    (16384, 4, "dft"), (16384, 2, "dft"), (8192, 8, "dft"),
    (20480, 4, "fft"), (16384, 8, "fft"), (32768, 2, "fft"),
    (20000, 4, "fft_global"), (60000, 4, "fft_global"),
    (60000, 8, "fft_global"),
    (20000, 8, "fft"), (46080, 4, "fft"), (60000, 2, "fft_global"),
    (16411, 4, "fft_global"), (28672, 2, "fft_global"),
    (20001, 8, "fft_global"), (524288, 4, "fft_global")])
def test_route_by_shape(nbin, itemsize, route):
    """Past the DFT tables K2f takes odd parts of at most three odd
    stages in float32 and bf16 (45 = 3^2 5), four in float64 (625 = 5^4;
    at 1875 = 3 5^4, five, K2g is the faster since its passes keep two
    tiles in flight), where it is the faster build; K2g the rest."""
    assert tk.cell_stats_route(nbin, itemsize) == route


@pytest.mark.parametrize("nbin,itemsize,cluster,odd", [
    (20480, 4, 4, 5), (32768, 4, 4, 1), (49152, 4, 8, 3),
    (65536, 4, 8, 1), (262144, 4, 8, 1), (16384, 8, 2, 1),
    (32768, 8, 4, 1), (131072, 8, 8, 1), (24576, 2, 4, 3),
    (8192, 4, 2, 1), (4096, 8, 2, 1), (12288, 4, 2, 3), (65536, 8, 8, 1),
    (24576, 8, 4, 3), (20000, 8, 4, 625), (46080, 4, 8, 45),
    (40000, 8, 8, 625), (36864, 4, 8, 9), (30720, 4, 4, 15)])
def test_fft_plan(nbin, itemsize, cluster, odd):
    plan = tk.cell_fft_plan(nbin, itemsize)
    realsize = 8 if itemsize == 8 else 4
    assert (plan.cluster, plan.odd) == (cluster, odd)
    # a block's slice of the row, padded to a whole run of the swizzle
    # (16 values in float32, 8 in float64), and the two-level twiddle
    # table, its high part padded to a whole run of 16
    slots = tk._fft_table_slots(nbin)
    assert tk._fft_table_len(nbin) <= slots < tk._fft_table_len(nbin) + 16
    run = 8 if realsize == 8 else 16
    q = -(-(nbin // (2 * cluster)) // run) * run
    assert plan.smem == -(-(2 * realsize * (q + slots)) // 16) * 16
    assert plan.smem + tk.FFT_STATIC_SMEM <= tk._SMEM_LIMIT
    # the fewest blocks whose slices hold at most 8192 bins (the largest
    # cluster where none does), 128 threads a block (the plan sweep's)
    assert plan.threads == tk.FFT_PLAN_THREADS == 128
    assert nbin // cluster <= tk.FFT_SLICE_BINS == 8192 or cluster == 8
    if cluster > 2:
        assert nbin // (cluster // 2) > tk.FFT_SLICE_BINS
    # the power of two of nbin/2 splits into 2 * cluster slices
    lpow = nbin // 2 // odd
    assert lpow & (lpow - 1) == 0 and lpow % (2 * cluster) == 0


@pytest.mark.parametrize("nbin,itemsize", [
    (16411, 4), (16411, 8), (7 * 4096, 4), (524288, 4), (262144, 8),
    (3 * 262144, 4), (60000, 4), (20000, 2)])
def test_refusals_name_roadmap_item_9(nbin, itemsize):
    """The shapes the port refused until K2g (a prime factor over 5, rows
    past the cluster build's capacity, float32 odd parts of more than
    three stages) now route to K2g: Bluestein where nbin/2 is not 2^a 3^b
    5^c (in a cluster where one takes its convolution, else through the
    passes), else the split row; none raises."""
    assert tk.cell_stats_route(nbin, itemsize) == "fft_global"
    plan = tk.cell_fft_global_plan(nbin, itemsize)
    split = nbin % 2 == 0 and tk._smooth(nbin // 2)
    if split:
        assert (plan.mode, plan.n) == ("split", nbin // 2)
    else:
        assert plan.mode in ("cluster", "bluestein")
        assert plan.n >= nbin + nbin // 2
        if plan.mode == "bluestein":
            assert plan.n == tk._next_smooth(nbin + nbin // 2)
    with pytest.raises(NotImplementedError, match="K2g takes it"):
        tk.cell_fft_plan(nbin, itemsize)


def test_only_limit_left_names_roadmap_item_9():
    """The one limit left: a row whose transform passes the kernels'
    32-bit row indices (about 2^30 bins) raises naming ROADMAP item 9
    before anything is launched."""
    with pytest.raises(NotImplementedError, match="ROADMAP item 9"):
        tk.cell_stats_route(2 ** 31 + 2)
    assert tk.cell_stats_route(2 ** 29) == "fft_global"


@pytest.mark.parametrize("nbin,itemsize,mode,n,passes", [
    (16411, 4, "cluster", 25600, ()),
    (20001, 4, "cluster", 30720, ()),
    (28672, 4, "cluster", 46080, ()),
    (65521, 4, "cluster", 98304, ()),
    (65521, 8, "cluster", 98304, ()),
    (136537, 4, "bluestein", 207360, (480, 432)),
    (69127, 8, "bluestein", 104976, (324, 324)),
    (524288, 4, "split", 262144, (512, 512)),
    (262144, 8, "split", 131072, (512, 256)),
    (3 * 262144, 4, "split", 393216, (768, 512))])
def test_fft_global_plan(nbin, itemsize, mode, n, passes):
    """K2g's plan: the mode and the transform's points (Bluestein's M >= N
    + N/2).  The cluster mode: K2f's cluster and shared memory for a row
    of 2M bins, FFTG_CLUSTER_THREADS (by the real size) a block, the
    table of W_(2M), no
    passes and no scratch.  The passes: the fewest passes of at most 1024
    points (two here); each pass's columns a tile the largest divisor of
    its stride (of the last pass, stride 1: of the row's spans) whose
    tile fits FFTG_TILE_BYTES (two tiles in Bluestein's fused last pass);
    FFTG_PASS_THREADS a block; chunks of at most 1 GiB of scratch.  A
    function of nbin and the dtype alone; the passes of n alone (B^ is
    made by the float64 passes of the same n)."""
    plan = tk.cell_fft_global_plan(nbin, itemsize)
    realsize = 8 if itemsize == 8 else 4
    assert (plan.mode, plan.n, plan.passes) == (mode, n, passes)
    if mode == "cluster":
        fplan = tk.cell_fft_plan(2 * n, realsize)
        assert (plan.cluster, plan.odd, plan.smem) \
            == (fplan.cluster, fplan.odd, fplan.smem)
        assert plan.smem + tk.FFT_STATIC_SMEM <= tk._SMEM_LIMIT
        assert (plan.table, plan.chunk, plan.groups) == (2 * n, 0, ())
        assert plan.threads == tk.FFTG_CLUSTER_THREADS[realsize]
        return
    assert plan.table == (nbin if mode == "split" else n)
    assert (plan.threads, plan.tile, plan.cluster) \
        == (tk.FFTG_PASS_THREADS, tk.FFTG_TILE_BYTES, 0)
    s = n
    for i, (f, g) in enumerate(zip(plan.passes, plan.groups)):
        s //= f
        last = i == len(plan.passes) - 1
        width = n // f if last else s
        tile = f * 2 * realsize * (2 if last and mode == "bluestein" else 1)
        assert width % g == 0 and g * tile <= tk.FFTG_TILE_BYTES
        assert all(width % h or h * tile > tk.FFTG_TILE_BYTES
                   for h in range(g + 1, width + 1))
    assert s == 1
    assert plan.chunk * n * 2 * realsize <= tk.FFTG_SCRATCH_BYTES
    assert plan.chunk >= 1
    assert tk._fftg_passes(n) == plan.passes


@pytest.mark.parametrize("itemsize", [4, 8])
def test_k2g_cluster_mode_takes_l5b(itemsize):
    """(L5b)'s prime, 65,521 bins, takes the cluster mode in float32 and
    float64: M = 98,304 = 3 x 2^15 complex points, a cluster of 8 blocks.
    In float64 that is the edge: 2M = 196,608 bins is the cluster's
    capacity at odd part 3, its slice and table within a block's shared
    memory; one bin more (65,537) takes the next float64 cluster length,
    102,400 = 2^12 x 5^2, and 69,127 no cluster."""
    plan = tk.cell_fft_global_plan(65521, itemsize)
    assert (plan.mode, plan.n, plan.cluster, plan.odd) \
        == ("cluster", 98304, 8, 3)
    if itemsize == 8:
        assert 2 * plan.n == tk.cell_fft_capacity(8, 3)
        assert plan.smem + tk.FFT_STATIC_SMEM <= tk._SMEM_LIMIT
        assert tk._cell_fft_takes(2 * 2 * plan.n, 8)[0] is None
        assert tk.cell_fft_global_plan(65537, 8)[:2] == ("cluster", 102400)
        assert tk.cell_fft_global_plan(69127, 8).mode == "bluestein"


@pytest.mark.parametrize("nbin,itemsize", [(136537, 4), (136537, 2),
                                           (69127, 8), (100003, 8)])
def test_k2g_prime_past_the_cluster_takes_shorter_passes(nbin, itemsize):
    """A prime whose convolution no cluster takes runs Bluestein through
    the passes, on the shorter M (the least 2^a 3^b 5^c >= N + N/2), with
    its scratch in chunks."""
    plan = tk.cell_fft_global_plan(nbin, itemsize)
    assert plan.mode == "bluestein" and plan.cluster == 0
    assert plan.n == tk._next_smooth(nbin + nbin // 2) < 2 * nbin - 1
    assert tk._fftg_cluster(nbin, 8 if itemsize == 8 else 4) == (None, None)


@pytest.mark.parametrize("nbin", [16411, 65521, 136537, 524288, 60000])
def test_k2g_plan_depends_on_nbin_and_dtype_alone(nbin):
    """The plan is a function of nbin and the dtype: bf16 storage takes
    float32's plan, the same arguments the same plan object (so batches,
    tiles and shards launch the same plan and stay bit-equal)."""
    assert tk.cell_fft_global_plan(nbin, 2) == tk.cell_fft_global_plan(
        nbin, 4)
    assert tk.cell_fft_global_plan(nbin, 8) is tk.cell_fft_global_plan(
        nbin, 8)


def test_capacity():
    assert [tk.cell_fft_capacity(4, o) for o in (1, 3, 5)] \
        == [262144, 393216, 327680]
    assert [tk.cell_fft_capacity(8, o) for o in (1, 3, 5)] \
        == [131072, 196608, 163840]
    for realsize in (4, 8):
        for odd in (1, 3, 5):
            cap = tk.cell_fft_capacity(realsize, odd)
            assert tk.cell_fft_plan(cap, realsize).cluster == 8
            with pytest.raises(NotImplementedError, match="capacity"):
                tk.cell_fft_plan(2 * cap, realsize)


@pytest.mark.parametrize("itemsize", [4, 2, 8])
def test_k1_plan_fits_at_65536_bins(itemsize):
    plan = tk.marginals_tiles(32, 256, 65536, 132, itemsize)
    assert plan.smem <= tk._SMEM_LIMIT
    assert plan.bb == 256 and -(-65536 // plan.bb) * plan.bb == 65536


class _NoLibrary(Exception):
    pass


def _card_fakes(monkeypatch, rc):
    """Make the wrappers take CPU tensors for card tensors and launch
    through a fake library whose entries return ``rc``; the plain
    versions raise if called."""
    launched = []

    def entry(name):
        def fn(*args):
            launched.append(name)
            return rc
        return fn

    lib = types.SimpleNamespace(icln_error_string=lambda rc: b"fake error")
    for name in ("icln_cell_fft_disp", "icln_cell_fft_two_read",
                 "icln_cell_fft_dedisp", "icln_shard_fft_disp",
                 "icln_shard_fft_dedisp", "icln_cell_stats_disp",
                 "icln_cell_fftg_disp", "icln_cell_fftg_two_read",
                 "icln_cell_fftg_dedisp", "icln_shard_fftg_disp",
                 "icln_shard_fftg_dedisp", "icln_fftg_passes"):
        setattr(lib, name, entry(name))

    def no_plain(*a, **k):
        raise AssertionError("the plain version was called on the card")

    monkeypatch.setattr(tk, "_on_card", lambda *t: True)
    monkeypatch.setattr(tk, "load_library", lambda: lib)
    monkeypatch.setattr(tk, "_stream", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    for name in ("cell_diagnostics_disp_plain",
                 "cell_diagnostics_two_read_plain",
                 "cell_diagnostics_dedisp_plain"):
        monkeypatch.setattr(tk, name, no_plain)
    return launched


@pytest.mark.parametrize("nbin", [7 * 4096, 136537])
def test_refusal_before_any_launch(monkeypatch, nbin):
    """7 x 4096 bins (the cluster mode) and a prime past the cluster (the
    passes), refused until K2g, now launch K2g on the card (the fake
    library): the passes' chirp spectrum through K2g's passes once per
    (nbin, device, dtype) (the cluster mode's is made on the host), then
    each wrapper's ``_fftg`` entry once, counted under ``<name>_fftg``;
    no plain version is called."""
    launched = _card_fakes(monkeypatch, 0)
    tk._fftg_bhat.cache_clear()
    tk.reset_launch_counts()
    cube, rot, nyq, t, w, m, win = _operands(2, 2, nbin, np.float32, 7)
    tk.cell_diagnostics_disp(cube, rot, nyq, t, w, m)
    tk.cell_diagnostics_dedisp(cube, t, win, w, m)
    passes = tk.cell_fft_global_plan(nbin).mode == "bluestein"
    assert launched == ["icln_fftg_passes"] * passes + [
        "icln_cell_fftg_disp", "icln_cell_fftg_dedisp"]
    assert {k: v for k, v in tk.launch_counts().items() if v} == {
        "cell_diagnostics_disp_fftg": 1, "cell_diagnostics_dedisp_fftg": 1}
    tk._fftg_bhat.cache_clear()
    tk.reset_launch_counts()


@pytest.mark.parametrize("nbin", [16411, 524288, 136537])
def test_failed_fftg_launch_raises_without_fallback(monkeypatch, nbin):
    """A failed K2g launch raises, the plain version never called: the
    failed chirp spectrum of a Bluestein row through the passes before
    the entry (nothing counted), a split row's or the cluster mode's
    failed entry after its count."""
    launched = _card_fakes(monkeypatch, 1)
    tk._fftg_bhat.cache_clear()
    tk.reset_launch_counts()
    cube, rot, nyq, t, w, m, win = _operands(2, 2, nbin, np.float32, 8)
    plan = tk.cell_fft_global_plan(nbin)
    with pytest.raises(RuntimeError, match="chirp|fft_global build"):
        tk.cell_diagnostics_two_read(cube, cube, rot, t, w, m)
    with pytest.raises(RuntimeError, match="chirp|fft_global build"):
        tk.shard_diagnostics_disp(cube, rot, nyq, t, w, m)
    counts = {k: v for k, v in tk.launch_counts().items() if v}
    if plan.mode == "bluestein":
        assert launched == ["icln_fftg_passes"] * 2 and counts == {}
    else:
        assert launched == ["icln_cell_fftg_two_read", "icln_shard_fftg_disp"]
        assert counts == {"cell_diagnostics_two_read_fftg": 1,
                          "shard_diagnostics_disp_fftg": 1}
    tk.reset_launch_counts()


def test_failed_fft_launch_raises_without_fallback(monkeypatch):
    launched = _card_fakes(monkeypatch, 1)
    tk.reset_launch_counts()
    cube, rot, nyq, t, w, m, win = _operands(2, 2, 32768, np.float32, 8)
    with pytest.raises(RuntimeError, match="fft build"):
        tk.cell_diagnostics_disp(cube, rot, nyq, t, w, m)
    with pytest.raises(RuntimeError, match="fft build"):
        tk.shard_diagnostics_dedisp(cube, t, win, w, m)
    assert launched == ["icln_cell_fft_disp", "icln_shard_fft_dedisp"]
    counts = tk.launch_counts()
    assert counts["cell_diagnostics_disp_fft"] == 1
    assert counts["shard_diagnostics_dedisp_fft"] == 1
    assert counts["cell_diagnostics_disp"] == 0
    tk.reset_launch_counts()


@pytest.mark.parametrize("nbin,build", [(32768, "fft"), (524288, "fftg")])
@pytest.mark.parametrize("dtype,suffix", [(torch.float32, ""),
                                          (torch.bfloat16, "_bf16"),
                                          (torch.float64, "_f64")])
def test_fft_launches_counted_apart(monkeypatch, dtype, suffix, nbin, build):
    _card_fakes(monkeypatch, 0)
    tk.reset_launch_counts()
    ops = _operands(2, 2, nbin, np.float64 if dtype == torch.float64
                    else np.float32, 9)
    cube = ops[0].to(dtype)
    tk.cell_diagnostics_two_read(cube, cube, ops[1], ops[3], ops[4], ops[5])
    counts = tk.launch_counts()
    assert counts[f"cell_diagnostics_two_read_{build}{suffix}"] == 1
    assert sum(counts.values()) == 1
    tk.reset_launch_counts()


def test_spectrum_kernels_and_model():
    kernels = ROUTE_KERNELS["default"]
    assert spectrum_kernels(kernels, 16384) == kernels
    assert spectrum_kernels(kernels, 16384, "float64") == tuple(
        FFT_KERNELS.get(k, k) for k in kernels)
    long = spectrum_kernels(kernels, 65536)
    assert "cell_diagnostics_disp_fft" in long \
        and "cell_diagnostics_disp" not in long
    assert set(FFT_KERNELS.values()) <= set(tk.launch_counts())
    bounds = profiling.kernel_bounds(32, 256, 65536)
    cells, nbin = 32 * 256, 65536
    for name in FFT_KERNELS.values():
        nbytes, ops = profiling.kernel_costs(32, 256, 65536)[name]
        assert ops == cells * (2.5 * nbin * 16 + 6 * nbin)
        assert bounds[name][1] == "bytes"
    # the cube's 2.15 GB at 3.35 TB/s; K2's rows add 0.04 ms
    assert round(bounds["cell_diagnostics_dedisp_fft"][0], 2) == 0.64
    assert 0.64 < bounds["cell_diagnostics_disp_fft"][0] < 0.69
    assert round(profiling.bound_ms(0, cells * (2.5 * nbin * 16
                                                + 6 * nbin))[0], 2) == 0.37
    ops, nbytes = profiling.program_costs(long, 32, 256, 65536)
    assert ops > 0 and nbytes > 2 * 4 * cells * nbin


@pytest.mark.parametrize("nbin", [4099, 16411])
def test_synthetic_archive_on_a_device(nbin):
    """``make_synthetic_archive(..., device=...)`` (how chip_smoke.py's
    (L5) makes its long-profile archives): its cube without noise is the
    numpy build's (the pulse, the baseline and the dispersion, within
    1e-12 of the cube's scale: another FFT's rounding), its noise of the
    asked sigma; the archive seeded (the same seed, the same archive), its
    RFI by the same rules, its fields the numpy build's."""
    from iterative_cleaner_torch.io import synthetic

    nchan, nsub = 8, 2
    freqs = 1400.0 + 200.0 * (np.arange(nchan) / nchan - 0.5)
    phase = synthetic._dispersion_phase(freqs, 26.76, 1400.0, 3.73, nbin,
                                        "cpu")
    row = np.exp(-0.5 * ((np.arange(nbin) / nbin - 0.3) / 0.02) ** 2) \
        * np.linspace(1.0, 2.0, nchan)[:, None]
    got = synthetic._noisy_cube_torch(row, nsub, 0.0, 100.0, 1, phase, "cpu")
    want = synthetic._disperse_cube(np.broadcast_to(row, (nsub, nchan, nbin))
                                    + 100.0, freqs, 26.76, 1400.0, 3.73)
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    noise = synthetic._noisy_cube_torch(np.zeros((nchan, nbin)), nsub, 1.0,
                                        0.0, 2, None, "cpu")
    assert abs(noise.std() - 1.0) < 0.02 and abs(noise.mean()) < 0.02
    kw = dict(nsub=nsub, nchan=nchan, nbin=nbin, period_s=3.73,
              seed=nbin % 7, dtype=np.float64,
              **synthetic.bench_rfi_density(nsub, nchan))
    a, ta = synthetic.make_synthetic_archive(**kw)
    c, tc = synthetic.make_synthetic_archive(**kw, device="cpu")
    d, td = synthetic.make_synthetic_archive(**kw, device="cpu")
    assert np.array_equal(c.data, d.data) and c.data.shape == a.data.shape
    assert np.array_equal(tc.rfi_cells, td.rfi_cells)
    assert len(tc.rfi_cells) == len(ta.rfi_cells)
    for f in ("weights", "freqs_mhz"):
        assert np.array_equal(getattr(a, f), getattr(c, f))
    assert (a.dm, a.period_s, a.source) == (c.dm, c.period_s, c.source)
