"""The port's batched clean (``parallel/batch.py``, ``--batch B``,
``--mesh batch``) on the CPU, against the JAX package's batched clean and
against the port's own single cleans.

Tolerances, and why:
- The batched plain kernels against the JAX functions under ``jax.vmap``
  (their ``custom_vmap`` rules; K1's is the XLA dual-dot), in interpret
  mode: as tests/test_torch_kernels.py — K1 1e-5 of sum|w*disp|; K2, K6,
  K7 rtol 1e-4 of each plane's scale, masked cells exact; K3, the combine
  and K9 bit-equal, NaN included.  Against the same plain version called
  archive by archive: bit-equal.
- ``clean_archives_batched`` against the JAX ``clean_archives_batched``
  on its kernel route: masks, loops, convergence and per-loop diffs
  equal; scores rtol 1e-4 with a 1e-4 floor, as tests/test_torch_routes.py
  (the JAX batch fold itself is not bit-stable for float planes, ROADMAP
  "Not port faults"); on the DEDISP=1 input rtol 5e-4, the bound ROADMAP
  gives that route (the reference's own one- and two-device cleans differ
  by up to 3.4e-4 relative; on this fixture the port's single clean and
  the JAX package's differ by 1.9e-4, batched or not).
- The port's batch against its single cleans: masks, loops,
  convergence, per-loop diffs, scores and the telemetry rows bit-equal
  (the batched template stage adds in the one-archive order on the CPU).
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from iterative_cleaner_tpu.config import CleanConfig as RefConfig
from iterative_cleaner_tpu.io.synthetic import (
    make_synthetic_archive as ref_make_synthetic_archive,
)
from iterative_cleaner_tpu.parallel.batch import (
    clean_archives_batched as ref_clean_archives_batched,
)
from iterative_cleaner_tpu.stats import pallas_kernels as pk
from iterative_cleaner_torch import CleanConfig
from iterative_cleaner_torch.backends import clean_archive
from iterative_cleaner_torch.cli import bucket_by_shape, main as cli_main
from iterative_cleaner_torch.convert import (
    archive_from_reference,
    config_from_reference,
)
from iterative_cleaner_torch.engine.loop import (
    clean_loop_batch,
    prepare_batch,
)
from iterative_cleaner_torch.io import load_archive, peek_shape, save_archive
from iterative_cleaner_torch.io.synthetic import make_synthetic_archive
from iterative_cleaner_torch.parallel import distributed
from iterative_cleaner_torch.parallel.batch import (
    check_equal_shapes,
    clean_archives_batched,
    stack_archive_batch,
)
from iterative_cleaner_torch.stats import kernels as tk
from tests.test_torch_kernels import (
    _assert_diags_close,
    _bits_equal,
    _cell_inputs,
    _ded_inputs,
    _diag_planes,
    _t,
)

NB = 3


def _stacked(make, seeds, *keys):
    """``make(seed)``'s dict entries ``keys`` stacked over ``seeds``
    (numpy arrays; a None entry stays None)."""
    per = [make(s) for s in seeds]
    return [None if per[0][k] is None else np.stack([p[k] for p in per])
            for k in keys]


def _same_bits(got, want):
    for g, w in zip(got, want):
        _bits_equal(g.numpy(), w.numpy())


# ---- the batched plain kernels ------------------------------------------

def test_batched_k1_against_jax_vmap_and_single():
    rng = np.random.default_rng(1)
    disp = rng.normal(5.0, 3.0, (NB, 8, 16, 32)).astype(np.float32)
    w = (rng.random((NB, 8, 16)) > 0.1).astype(np.float32)
    a, t1 = tk.weighted_marginals(_t(disp), _t(w))
    ra, rt1 = jax.vmap(pk.weighted_marginals_pallas)(jnp.asarray(disp),
                                                     jnp.asarray(w))
    absw = np.abs(disp * w[..., None])
    np.testing.assert_array_less(np.abs(a.numpy() - np.asarray(ra)),
                                 1e-5 * absw.sum(axis=1) + 1e-30)
    np.testing.assert_array_less(np.abs(t1.numpy() - np.asarray(rt1)),
                                 1e-5 * absw.sum(axis=2) + 1e-30)
    for b in range(NB):
        _same_bits((a[b], t1[b]), tk.weighted_marginals(_t(disp[b]),
                                                        _t(w[b])))


CELL_GEOMS = [(8, 16, 32, "fourier"), (8, 16, 31, "roll")]


@pytest.mark.parametrize("nsub,nchan,nbin,rotation", CELL_GEOMS)
def test_batched_k2_against_jax_vmap_and_single(nsub, nchan, nbin,
                                                rotation):
    disp, rot_t, nyq, template, w, mask = _stacked(
        lambda s: _cell_inputs(nsub, nchan, nbin, rotation, s), range(NB),
        "disp", "rot_t", "nyq", "template", "weights", "mask")
    args = [None if x is None else _t(x)
            for x in (disp, rot_t, nyq, template, w, mask)]
    got = tk.cell_diagnostics_disp(*args)
    want = jax.vmap(
        lambda d, r, n, t, ww, m: pk.cell_diagnostics_pallas_disp(
            d, r, n, t, ww, m),
        in_axes=(0, 0, None if nyq is None else 0, 0, 0, 0))(
        *(None if x is None else jnp.asarray(x)
          for x in (disp, rot_t, nyq, template, w, mask)))
    for b in range(NB):
        _assert_diags_close([g[b] for g in got], [x[b] for x in want],
                            mask[b])
        _same_bits([g[b] for g in got], tk.cell_diagnostics_disp(
            *(None if x is None else x[b] for x in args)))


@pytest.mark.parametrize("window_on", [False, True])
@pytest.mark.parametrize("nsub,nchan,nbin,rotation", CELL_GEOMS)
def test_batched_k6_k7_against_jax_vmap_and_single(nsub, nchan, nbin,
                                                   rotation, window_on):
    ded, base, rot_t, template, w, mask, window = _stacked(
        lambda s: _ded_inputs(nsub, nchan, nbin, rotation, window_on, s),
        range(NB), "ded", "disp_base", "rot_t", "template", "weights",
        "mask", "window")
    window = window[0]   # one window for the batch
    t = [_t(x) for x in (ded, base, rot_t, template, w, mask)]
    j = [jnp.asarray(x) for x in (ded, base, rot_t, template, w, mask)]
    got7 = tk.cell_diagnostics_two_read(*t)
    want7 = jax.vmap(pk.cell_diagnostics_pallas)(*j)
    got6 = tk.cell_diagnostics_dedisp(t[0], t[3], _t(window), t[4], t[5])
    want6 = jax.vmap(pk.cell_diagnostics_pallas_dedisp,
                     in_axes=(0, 0, None, 0, 0))(
        j[0], j[3], jnp.asarray(window), j[4], j[5])
    for b in range(NB):
        for got, want in ((got7, want7), (got6, want6)):
            _assert_diags_close([g[b] for g in got], [x[b] for x in want],
                                mask[b])
        _same_bits([g[b] for g in got7], tk.cell_diagnostics_two_read(
            *(x[b] for x in t)))
        _same_bits([g[b] for g in got6], tk.cell_diagnostics_dedisp(
            t[0][b], t[3][b], _t(window), t[4][b], t[5][b]))


def _batch_planes(nsub, nchan):
    per = [_diag_planes(nsub, nchan, seed=s) for s in range(NB)]
    d = [np.stack([p[0][i] for p in per]) for i in range(4)]
    return d, np.stack([p[1] for p in per])


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("nsub,nchan", [(16, 32), (21, 37)])
def test_batched_k3_against_jax_vmap_and_single(axis, nsub, nchan):
    d, mask = _batch_planes(nsub, nchan)
    thresh = 5.0 if axis == 0 else 3.7
    got = tk.scaled_sides([_t(p) for p in d], _t(mask), axis, thresh)
    want = jax.vmap(lambda a, b, c, e, m: pk.scaled_sides_pallas(
        [a, b, c, e], m, axis, thresh))(*(jnp.asarray(x) for x in d),
                                        jnp.asarray(mask))
    for g, w in zip(got, want):
        _bits_equal(g.numpy(), w)
    for b in range(NB):
        _same_bits([g[b] for g in got], tk.scaled_sides(
            [_t(p[b]) for p in d], _t(mask[b]), axis, thresh))


def test_batched_combine_against_jax_vmap():
    d, mask = _batch_planes(16, 32)
    rng = np.random.default_rng(5)
    worig = np.where(mask, 0.0, rng.uniform(0.5, 2.0, mask.shape)
                     ).astype(np.float32)
    planes = [_t(p) for p in d]
    chan = tk.scaled_sides(planes, _t(mask), 0, 5.0)
    sub = tk.scaled_sides(planes, _t(mask), 1, 4.0)
    new_w, scores = tk.combine_zap(chan, sub, _t(worig))
    want_w, want_s = jax.vmap(
        lambda a, b, c, e, m, ww: pk.fused_combine_pallas(
            [a, b, c, e], m, ww, 5.0, 4.0))(*(jnp.asarray(x) for x in d),
                                            jnp.asarray(mask),
                                            jnp.asarray(worig))
    _bits_equal(scores.numpy(), want_s)
    _bits_equal(new_w.numpy(), want_w)


def test_batched_k9_lines_against_jax_vmap():
    """The telemetry's median of a batch: each archive's plane as one line
    of K9, B lines in one call."""
    d, mask = _batch_planes(16, 32)
    v, m = d[0].reshape(NB, -1), mask.reshape(NB, -1)
    got = tk.masked_median(_t(v), _t(m), 1)
    want = jax.vmap(lambda x, y: pk.masked_median_pallas(x[None], y[None],
                                                         1)[0])(
        jnp.asarray(v), jnp.asarray(m))
    _bits_equal(got.numpy(), want)


# ---- the batched clean --------------------------------------------------

SPEC = dict(nsub=8, nchan=16, nbin=32, n_prezapped=3)
ROUTES = {
    "default": ({}, False),
    "profile": (dict(baseline_mode="profile"), False),
    "dedispersed": (dict(stats_frame="dedispersed"), False),
    "pulse-window": (dict(pulse_region=(0.2, 8, 16)), False),
    "dedisp1-input": ({}, True),
}
JAX_KERNELS = dict(dtype="float32", median_impl="pallas", stats_impl="fused",
                   fused_sweep="on", fft_mode="dft")


def _ref_archives(seeds, dedispersed=False, **rfi):
    """Reference-package archives whose RFI density varies with the seed
    (so that their loop counts differ); ``rfi`` overrides it."""
    out = []
    for s in seeds:
        ar, _ = ref_make_synthetic_archive(
            **SPEC, seed=s, disperse=not dedispersed,
            **(rfi or dict(n_rfi_cells=2 + 5 * (s % 3))))
        ar.dedispersed = dedispersed
        out.append(ar)
    return out


def _assert_same_results(got, want, scores_exact, rtol=1e-4):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.final_weights, w.final_weights)
        assert (g.loops, g.converged) == (w.loops, w.converged)
        np.testing.assert_array_equal(g.loop_diffs, w.loop_diffs)
        if scores_exact:
            _bits_equal(g.scores, w.scores)
            np.testing.assert_array_equal(g.iter_metrics, w.iter_metrics)
            np.testing.assert_array_equal(g.loop_rfi_frac, w.loop_rfi_frac)
        else:
            np.testing.assert_allclose(g.scores, w.scores, rtol=rtol,
                                       atol=1e-4)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_batched_clean_matches_jax_batched_clean(route):
    kwargs, dedispersed = ROUTES[route]
    refs = _ref_archives(range(NB), dedispersed)
    ref_cfg = RefConfig(**kwargs, **JAX_KERNELS)
    want = ref_clean_archives_batched(refs, ref_cfg)
    got = clean_archives_batched([archive_from_reference(a) for a in refs],
                                 config_from_reference(ref_cfg, "cpu"))
    _assert_same_results(got, want, scores_exact=False,
                         rtol=5e-4 if dedispersed else 1e-4)


@pytest.mark.parametrize("max_iter", [5, 1])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_batched_clean_matches_single_cleans(route, max_iter):
    """Five archives whose loops differ on every route (the carry of an
    archive that stopped is frozen while the others iterate; the fifth,
    with weaker RFI, iterates longest on the pulse-window route), and
    ``max_iter=1``."""
    kwargs, dedispersed = ROUTES[route]
    ars = [archive_from_reference(a) for a in
           _ref_archives(range(4), dedispersed)
           + _ref_archives([0], dedispersed, n_rfi_cells=2,
                           rfi_strength=10.0)]
    cfg = CleanConfig(device="cpu", max_iter=max_iter, **kwargs)
    tk.reset_launch_counts()
    got = clean_archives_batched(ars, cfg)
    batch_counts = tk.launch_counts()
    want = [clean_archive(a, cfg) for a in ars]
    _assert_same_results(got, want, scores_exact=True)
    assert max(r.loops for r in got) <= max_iter
    if max_iter == 5:
        assert len({r.loops for r in got}) > 1
    assert batch_counts == {k: 0 for k in batch_counts}   # plain versions


def test_batch_rejects_ragged_shapes_and_mixed_dedisp():
    a = make_synthetic_archive(**SPEC, seed=0)[0]
    b = make_synthetic_archive(**dict(SPEC, nbin=64), seed=1)[0]
    c = dataclasses.replace(make_synthetic_archive(**SPEC, seed=2)[0],
                            dedispersed=True)
    with pytest.raises(ValueError, match="equal-shaped"):
        check_equal_shapes([a, b])
    with pytest.raises(ValueError, match="dedispersed"):
        clean_archives_batched([a, c], CleanConfig(device="cpu"))
    with pytest.raises(ValueError, match="unload_res"):
        clean_archives_batched([a], CleanConfig(device="cpu",
                                                unload_res=True))


def test_pad_archives_clean_without_nan():
    """Zero-weight pad slots (as a mesh pads the batch) clean to finite
    all-zero weights and telemetry, and leave the real archives' results
    as without them."""
    ars = [make_synthetic_archive(**SPEC, seed=s, n_rfi_cells=3 + s)[0]
           for s in range(2)]
    cfg = CleanConfig(device="cpu")

    def run(pad):
        (cubes, w, f, d, r, p), nbytes = stack_archive_batch(ars, pad, "cpu")
        assert nbytes == sum(x.numel() * 4 for x in (cubes, w, f, d, r, p))
        prep = prepare_batch(cubes, w, f, d, r, p, cfg, dedispersed=False)
        return clean_loop_batch(prep, w, max_iter=cfg.max_iter,
                                chanthresh=cfg.chanthresh,
                                subintthresh=cfg.subintthresh,
                                rotation=cfg.rotation,
                                baseline_duty=cfg.baseline_duty)

    padded, plain = run(2), run(0)
    assert torch.all(padded.final_weights[2:] == 0)
    assert torch.isfinite(padded.iter_metrics[2:]).all()
    assert torch.isfinite(padded.loop_rfi_frac[2:]).all()
    for k in ("final_weights", "scores", "loops", "loop_diffs",
              "iter_metrics"):
        a, b = getattr(padded, k)[:2], getattr(plain, k)
        assert torch.equal(a, b), k


# ---- the CLI --------------------------------------------------------------

def _write_archives(tmp_path, specs):
    """Archives named ``a00.npz``, ``a01.sf``, ... of the given (shape
    spec, extension) pairs; returns their paths."""
    paths = []
    for i, (spec, ext) in enumerate(specs):
        ar, _ = make_synthetic_archive(**spec, seed=20 + i,
                                       n_rfi_cells=2 + 4 * (i % 3))
        path = str(tmp_path / f"a{i:02d}{ext}")
        save_archive(ar, path)
        paths.append(path)
    return paths


SMALL = dict(nsub=8, nchan=16, nbin=32, n_prezapped=2)
OTHER = dict(nsub=6, nchan=8, nbin=64, n_prezapped=1)


def _masks(paths):
    out = {}
    for p in paths:
        ext = os.path.splitext(p)[1]
        out[p] = load_archive(p + "_cleaned" + ext).weights == 0
    return out


def test_peek_shape_on_npz_icar_and_psrfits(tmp_path):
    ar = dataclasses.replace(make_synthetic_archive(**SMALL, seed=1)[0],
                             dedispersed=True)
    for ext in (".npz", ".icar", ".sf"):
        path = str(tmp_path / f"x{ext}")
        save_archive(ar, path)
        assert peek_shape(path) == (8, 16, 32, True)
        assert peek_shape(path, cheap_only=True) == (8, 16, 32, True)
    bad = tmp_path / "timer.ar"
    bad.write_bytes(b"not a FITS file")
    with pytest.raises(ValueError, match="header-only"):
        peek_shape(str(bad), cheap_only=True)


def test_cli_batch_matches_sequential_and_buckets_shapes(tmp_path,
                                                         monkeypatch):
    """Two shapes interleaved, in .npz and .sf: the prepass groups them
    (the report lists each shape's archives together), and each output
    mask and report entry equals the sequential session's."""
    specs = [(SMALL if i % 2 == 0 else OTHER, ".npz" if i % 3 else ".sf")
             for i in range(7)]
    runs = {}
    for name, extra in (("seq", []), ("batch", ["--batch", "3"])):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        paths = _write_archives(d, specs)
        assert cli_main(["--device", "cpu", "-q", "--metrics-json",
                         "run.json", *extra, *paths]) == 0
        runs[name] = (paths, _masks(paths),
                      json.loads((d / "run.json").read_text()))
    (seq_paths, seq_masks, seq_doc), (paths, masks, doc) = (runs["seq"],
                                                            runs["batch"])
    assert bucket_by_shape(paths) == paths[0::2] + paths[1::2]
    assert [e["path"] for e in doc["archives"]] == paths[0::2] + paths[1::2]
    for sp, p in zip(seq_paths, paths):
        np.testing.assert_array_equal(masks[p], seq_masks[sp])
    by_name = {os.path.basename(e["path"]): e for e in seq_doc["archives"]}
    for e in doc["archives"]:
        want = dict(by_name[os.path.basename(e["path"])])
        assert {**e, "path": want["path"]} == want
    assert doc["counters"]["batch_archives"] == 7
    assert doc["counters"]["batch_h2d_bytes"] > 0
    assert doc["counters"]["archives_cleaned"] == 7


@pytest.mark.parametrize("argv", [
    ["--batch", "2", "-u"],
    ["--batch", "2", "--mesh", "cell"],
    ["--batch", "2", "--stream", "4"],
    ["--mesh", "batch"],
    ["--mesh", "batch", "--batch", "1"],
])
def test_cli_refuses_what_the_batch_does_not_run(argv, tmp_path):
    with pytest.raises(SystemExit) as exc:
        cli_main(["--device", "cpu", *argv, str(tmp_path / "x.npz")])
    assert exc.value.code == 2


def test_cli_batch_keep_going_isolates_a_bad_archive(tmp_path, monkeypatch,
                                                     capsys):
    monkeypatch.chdir(tmp_path)
    paths = _write_archives(tmp_path, [(SMALL, ".npz")] * 3)
    bad = tmp_path / "bad.npz"
    bad.write_bytes(b"not an archive")
    argv = ["--device", "cpu", "-q", "--batch", "4", "--metrics-json",
            "run.json", paths[0], str(bad), *paths[1:]]
    with pytest.raises(Exception):
        cli_main([a for a in argv if a not in ("--metrics-json",
                                               "run.json")])
    assert cli_main(["--keep_going", *argv]) == 1
    assert "bad.npz" in capsys.readouterr().err
    doc = json.loads((tmp_path / "run.json").read_text())
    assert doc["counters"]["archives_failed"] == 1
    assert doc["counters"]["archives_cleaned"] == 3
    for p in paths:
        assert os.path.exists(p + "_cleaned.npz")


def test_cli_batch_write_failure_is_per_archive(tmp_path, monkeypatch,
                                                capsys):
    """A write that fails is reported for its archive; the group's other
    archives are still written and the session exits 1."""
    monkeypatch.chdir(tmp_path)
    paths = _write_archives(tmp_path, [(SMALL, ".npz")] * 3)
    os.mkdir(paths[1] + "_cleaned.npz")   # a directory blocks the write
    assert cli_main(["--device", "cpu", "-q", "--batch", "3", *paths]) == 1
    assert "ERROR writing" in capsys.readouterr().err
    assert os.path.isfile(paths[0] + "_cleaned.npz")
    assert os.path.isfile(paths[2] + "_cleaned.npz")


# ---- --mesh batch over gloo ranks -----------------------------------------

def test_mesh_batch_two_gloo_ranks_matches_plain_batch(tmp_path):
    """Three archives over two ranks: padded to four, each rank cleans two
    slots, rank 0 gathers; masks equal to the plain batch's."""
    from tests.torch_shard_ranks import batch_rank

    ars = [make_synthetic_archive(**SMALL, seed=30 + s,
                                  n_rfi_cells=2 + 4 * s)[0]
           for s in range(3)]
    paths = []
    for i, ar in enumerate(ars):
        paths.append(str(tmp_path / f"m{i}.npz"))
        save_archive(ar, paths[-1])
    ranks = distributed.run_local_ranks(batch_rank, 2, (paths, {}),
                                        workdir=str(tmp_path), threads=1,
                                        timeout_s=300)
    assert ranks[1] is None
    want = clean_archives_batched([load_archive(p) for p in paths],
                                  CleanConfig(device="cpu"))
    _assert_same_results(ranks[0], want, scores_exact=True)
