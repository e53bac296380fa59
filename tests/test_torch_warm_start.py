"""The port's bucket warm-up (``parallel/batch.warm_bucket``, the fleet's
``BucketPrecompiler``, ``--precompile``, ``--compile-cache``) on the CPU,
as far as ``tests/test_warm_start.py`` applies: the reference compiles a
program per bucket and keeps it in jax's persistent cache; the port
compiles no program per shape, so its warm-up is the kernel library's
``nvcc`` build (into the ``--compile-cache`` directory, once per source
digest: a warm restart builds nothing — held here with a stand-in
compiler, on the card by ``tests/test_torch_cuda.py``).  Held: the
warm-up memo's fresh and memo-hit accounting, the fleet's precompile hits
and misses cold and then warm, ``precompile=False``, ``--precompile`` and
its refusals, ``_parse_geometry_spec``, the build directory's
configuration, and the memo against the table cache's eviction (the memo
holds no table, so an eviction costs the clean a rebuilt table, never a
false hit)"""

import os
import stat

import numpy as np
import pytest
import torch

from iterative_cleaner_tpu.cli import (
    _parse_geometry_spec as ref_parse_geometry_spec,
)
from iterative_cleaner_torch import CleanConfig
from iterative_cleaner_torch.cli import _parse_geometry_spec, main as cli_main
from iterative_cleaner_torch.io import make_synthetic_archive, save_archive
from iterative_cleaner_torch.parallel.batch import (
    clear_warm_memo,
    record_builder_cache_stats,
    warm_bucket,
)
from iterative_cleaner_torch.parallel.fleet import clean_fleet
from iterative_cleaner_torch.stats import kernels as K
from iterative_cleaner_torch.telemetry.registry import MetricsRegistry
from iterative_cleaner_torch.utils import configure_compilation_cache

CFG = CleanConfig(device="cpu", rotation="roll", max_iter=3)


def _write_fleet(tmp_path, geometries, seed0=70):
    paths = []
    for i, (nsub, nchan, nbin) in enumerate(geometries):
        ar, _ = make_synthetic_archive(nsub=nsub, nchan=nchan, nbin=nbin,
                                       seed=seed0 + i)
        p = str(tmp_path / ("warm_%02d.npz" % i))
        save_archive(ar, p)
        paths.append(p)
    return paths


@pytest.fixture(autouse=True)
def _fresh_memo():
    clear_warm_memo()
    yield
    clear_warm_memo()


def test_warm_bucket_counts_once_then_hits():
    reg, stats = MetricsRegistry(), {}
    warm_bucket(CFG, 10, 16, 32, False, 3, registry=reg, stats_out=stats)
    assert stats["fresh"] and stats["library_builds"] == 0
    assert reg.counters["batch_compiles"] == 1
    reg2, stats2 = MetricsRegistry(), {}
    warm_bucket(CFG, 10, 16, 32, False, 3, registry=reg2, stats_out=stats2)
    assert not stats2["fresh"] and stats2["library_builds"] == 0
    assert reg2.counters.get("batch_compiles", 0) == 0
    # another batch, dtype or geometry is another bucket
    for other in ((CFG, 10, 16, 32, False, 2), (CFG, 10, 16, 64, False, 3),
                  (CleanConfig(device="cpu", compute_dtype="bfloat16"),
                   10, 16, 32, False, 3)):
        s = {}
        warm_bucket(*other, stats_out=s)
        assert s["fresh"]
    record_builder_cache_stats(reg)
    assert reg.gauges["bucket_warm_memo_size"] == 4
    assert reg.gauges["dft_tables_cache_maxsize"] == 8


def test_fleet_precompile_counters_cold_then_warm(tmp_path):
    paths = _write_fleet(tmp_path, [(10, 16, 32), (10, 16, 32), (14, 16, 32)])
    cold_reg = MetricsRegistry()
    cold = clean_fleet(paths, CFG, registry=cold_reg, group_size=2)
    assert not cold.failures
    n_groups = 2
    assert cold_reg.counters["fleet_compiles"] == cold.n_buckets == 2
    assert cold.n_compiles == 2
    assert (cold_reg.counters.get("fleet_precompile_hits", 0)
            + cold_reg.counters.get("fleet_precompile_misses", 0)) == n_groups
    warm_reg = MetricsRegistry()
    warm = clean_fleet(paths, CFG, registry=warm_reg, group_size=2)
    assert warm_reg.counters.get("fleet_compiles", 0) == 0
    assert warm_reg.counters["fleet_precompile_hits"] == n_groups
    for p in paths:
        np.testing.assert_array_equal(cold.results[p].final_weights,
                                      warm.results[p].final_weights)


def test_fleet_precompile_disabled_matches(tmp_path):
    paths = _write_fleet(tmp_path, [(10, 16, 32), (14, 16, 32)], seed0=80)
    reg_off = MetricsRegistry()
    off = clean_fleet(paths, CFG, registry=reg_off, group_size=2,
                      precompile=False)
    assert not off.failures
    assert reg_off.counters.get("fleet_precompile_hits", 0) == 0
    assert reg_off.counters.get("fleet_precompile_misses", 0) == 0
    assert reg_off.counters["fleet_compiles"] == 2     # warmed inline
    on = clean_fleet(paths, CFG, registry=MetricsRegistry(), group_size=2)
    for p in paths:
        np.testing.assert_array_equal(off.results[p].final_weights,
                                      on.results[p].final_weights)


def test_compile_fault_sends_the_bucket_inline(tmp_path):
    from iterative_cleaner_torch.resilience import (
        FaultInjector,
        ResiliencePlan,
    )

    paths = _write_fleet(tmp_path, [(10, 16, 32), (14, 16, 32)], seed0=85)
    reg = MetricsRegistry()
    rep = clean_fleet(paths, CFG, registry=reg, resilience=ResiliencePlan(
        faults=FaultInjector("compile:err", seed=0)))
    assert rep.ok
    assert reg.counters["fleet_precompile_misses"] == 2
    assert reg.counters["fleet_compiles"] == 2         # both inline


def test_warm_memo_against_eviction(tmp_path):
    """The memo holds no table: a warmed bucket stays a hit (and the
    library stays loaded) whatever the table cache evicts, and the clean
    makes the tables it needs again — the same result."""
    paths = _write_fleet(tmp_path, [(10, 16, 32)], seed0=90)
    first = clean_fleet(paths, CFG, group_size=2)
    K._dft_tables_padded.cache_clear()
    s = {}
    warm_bucket(CFG, 10, 16, 32, False, 1, stats_out=s)
    assert not s["fresh"]
    for nbin in range(8, 8 + 2 * K._dft_tables_padded.cache_info().maxsize):
        K._dft_tables_padded(nbin, nbin // 2 + 1, "cpu")
    reg = MetricsRegistry()
    again = clean_fleet(paths, CFG, registry=reg, group_size=2)
    assert reg.counters["fleet_precompile_hits"] == 1
    assert reg.counters.get("fleet_compiles", 0) == 0
    np.testing.assert_array_equal(first.results[paths[0]].final_weights,
                                  again.results[paths[0]].final_weights)
    np.testing.assert_array_equal(first.results[paths[0]].scores,
                                  again.results[paths[0]].scores)


# ---- the build directory -------------------------------------------------

def _fake_nvcc(tmp_path):
    """A stand-in compiler: writes an empty file at its ``-o`` argument."""
    script = tmp_path / "nvcc"
    script.write_text('#!/bin/sh\nwhile [ "$#" -gt 0 ]; do\n'
                      '  if [ "$1" = "-o" ]; then : > "$2"; fi\n'
                      '  shift\ndone\n')
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    return str(script)


def test_build_into_the_cache_dir_once(tmp_path, monkeypatch):
    """With a build directory set, the library is built there once per
    source digest; a second build (a warm restart) runs no compiler."""
    cache = tmp_path / "kcache"
    monkeypatch.setattr(K, "_nvcc", lambda: _fake_nvcc(tmp_path))
    monkeypatch.setattr(K, "_BUILD_DIR_OVERRIDE", None)
    monkeypatch.setattr(K, "_LIB", None)
    configure_compilation_cache(str(cache))
    assert K.build_dir() == cache.resolve()
    n0 = K.library_builds()
    out = K.build_library()
    assert out.parent == cache.resolve() and out.exists()
    assert (cache / "build.log").exists()
    assert K.library_builds() == n0 + 1
    assert K.build_library() == out
    assert K.library_builds() == n0 + 1


def test_configure_compilation_cache_unit(tmp_path, monkeypatch):
    monkeypatch.setattr(K, "_BUILD_DIR_OVERRIDE", None)
    monkeypatch.delenv("ICLEAN_COMPILE_CACHE", raising=False)
    configure_compilation_cache("")
    configure_compilation_cache(None)
    assert K.build_dir() == K.BUILD_DIR
    monkeypatch.setenv("ICLEAN_COMPILE_CACHE", str(tmp_path / "env"))
    assert K.build_dir() == (tmp_path / "env").resolve()
    configure_compilation_cache(str(tmp_path / "a"))
    assert K.build_dir() == (tmp_path / "a").resolve()
    # a library already loaded from another directory cannot move
    monkeypatch.setattr(K, "_LIB", object())
    monkeypatch.setattr(K, "_LIB_DIR", (tmp_path / "a").resolve())
    configure_compilation_cache(str(tmp_path / "a"))     # the same: fine
    with pytest.raises(RuntimeError, match="already loaded"):
        configure_compilation_cache(str(tmp_path / "b"))


# ---- --precompile --------------------------------------------------------

def test_precompile_cli_warms_buckets(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    (path,) = _write_fleet(tmp_path, [(8, 16, 32)])
    rc = cli_main(["--device", "cpu", "--precompile", "--compile-cache",
                   str(tmp_path / "cache"), "--batch", "4", "16x32x32",
                   path])
    assert rc == 0
    out = capsys.readouterr().out
    assert "precompiled 16x32x32 batch=1" in out
    assert "precompiled 8x16x32 batch=1" in out
    assert "compile cache warmed: 2 buckets" in out
    assert not os.path.exists(path + "_cleaned.npz")     # nothing cleaned


@pytest.mark.parametrize("argv,code", [
    (["--precompile", "16x32x32"], 2),
    (["--precompile", "--compile-cache", "c", "--backend", "numpy",
      "16x32x32"], 2),
    (["--precompile", "--compile-cache", "c", "--stream", "4", "16x32x32"],
     2),
])
def test_precompile_cli_refusals(tmp_path, monkeypatch, capsys, argv, code):
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("ICLEAN_COMPILE_CACHE", raising=False)
    with pytest.raises(SystemExit) as ei:
        cli_main(["--device", "cpu", *argv])
    assert ei.value.code == code
    assert "--" in capsys.readouterr().err


def test_precompile_cli_rejects_a_bad_spec(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert cli_main(["--device", "cpu", "--precompile", "--compile-cache",
                     "c", "not-a-geometry"]) == 2
    assert "NSUBxNCHANxNBIN" in capsys.readouterr().err


@pytest.mark.parametrize("spec", ["16x32x128", "not-a-geometry", "16x32",
                                  "0x32x64", "16X32X8", "axbxc"])
def test_parse_geometry_spec(spec):
    assert _parse_geometry_spec(spec) == ref_parse_geometry_spec(spec)
    assert _parse_geometry_spec("16x32x128") == (16, 32, 128)
    assert _parse_geometry_spec("0x32x64") is None
