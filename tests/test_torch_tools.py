"""The port's ``tools diff``, ``sweep`` and ``borderline`` against the
reference package's tools (``tests/test_cli.py``'s tool cases).

- ``diff``: a ``.npz``, its ``.icar`` and PSRFITS conversions and a
  cleaned copy, pairwise, the same JSON as the reference's tool and the
  same exit code (1 when the masks differ); two CLI checkpoints.
- ``sweep`` and ``borderline`` with ``--backend numpy`` print lines equal
  to the reference tools' lines on the same archive (the oracles are
  bit-equal), for the flagship and quicklook; with ``--backend torch
  --device cpu`` each row or cell agrees with an in-process clean.
- Without a card, ``--backend torch`` raises unless ``--device cpu`` is
  given: no fallback.
"""

import json

import numpy as np
import pytest
import torch

from iterative_cleaner_tpu import tools as ref_tools
from iterative_cleaner_tpu.io import save_archive as ref_save_archive
from iterative_cleaner_tpu.io.synthetic import (
    make_synthetic_archive as ref_make_synthetic_archive,
)
from iterative_cleaner_torch import cli, tools
from iterative_cleaner_torch.backends import clean_archive
from iterative_cleaner_torch.config import CleanConfig
from iterative_cleaner_torch.io import load_archive, save_archive
from iterative_cleaner_torch.models import get_model
from iterative_cleaner_torch.utils.checkpoint import checkpoint_path


def _lines(capsys):
    return capsys.readouterr().out.strip().splitlines()


def _save_ref(path, **kw):
    ref, _ = ref_make_synthetic_archive(**kw)
    ref_save_archive(ref, path)
    return ref


def test_info_and_convert_and_diff(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    ar, _ = ref_make_synthetic_archive(nsub=6, nchan=10, nbin=32, seed=0,
                                       dtype=np.float32)
    ref_save_archive(ar, "a.npz")
    assert tools.main(["info", "a.npz"]) == 0
    meta = json.loads(capsys.readouterr().out)
    assert (meta["nsub"], meta["nchan"], meta["nbin"]) == (6, 10, 32)
    assert tools.main(["convert", "a.npz", "a.icar"]) == 0
    np.testing.assert_array_equal(load_archive("a.icar").data, ar.data)
    assert tools.main(["diff", "a.npz", "a.icar"]) == 0
    capsys.readouterr()
    ar2 = load_archive("a.npz")
    ar2.weights[0, 0] = 0.0
    save_archive(ar2, "b.npz")
    assert tools.main(["diff", "a.npz", "b.npz"]) == 1
    d = json.loads(capsys.readouterr().out)
    assert d["changed"] == 1 and d["newly_zapped"] == 1


@pytest.mark.parametrize("pair", [("a.npz", "b.npz"), ("a.icar", "b.sf"),
                                  ("a.sf", "a.npz"), ("b.icar", "a.sf")])
def test_diff_prints_what_the_reference_prints(pair, tmp_path, monkeypatch,
                                               capsys):
    monkeypatch.chdir(tmp_path)
    ar = _save_ref("a.npz", nsub=6, nchan=10, nbin=32, seed=0,
                   dtype=np.float32, n_prezapped=3)
    ar.weights[2, 3] = 0.0
    ref_save_archive(ar, "b.npz")
    for src in ("a", "b"):
        tools.main(["convert", f"{src}.npz", f"{src}.icar"])
        tools.main(["convert", f"{src}.npz", f"{src}.sf"])
    rc = tools.main(["diff", *pair])
    mine = capsys.readouterr().out
    assert rc == ref_tools.main(["diff", *pair])
    assert mine == capsys.readouterr().out
    assert rc == (0 if pair[0][0] == pair[1][0] else 1)


def test_diff_checkpoints(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    _save_ref("o.npz", nsub=6, nchan=10, nbin=32, seed=0)
    assert cli.main(["-q", "-l", "--device", "cpu", "--checkpoint", "ck1",
                     "o.npz"]) == 0
    assert cli.main(["-q", "-l", "--device", "cpu", "-o", "out2.npz",
                     "--checkpoint", "ck2", "o.npz"]) == 0
    rc = tools.main(["diff", checkpoint_path("ck1", "o.npz"),
                     checkpoint_path("ck2", "o.npz")])
    assert rc == 0
    d = json.loads(capsys.readouterr().out)
    assert d["changed"] == 0 and d["same_input"]
    # a checkpoint against a cleaned archive: weights only
    assert tools.main(["diff", checkpoint_path("ck1", "o.npz"),
                       "out2.npz"]) == 0


@pytest.mark.parametrize("model", ["surgical_scrub", "quicklook"])
def test_sweep_numpy_prints_the_reference_lines(model, tmp_path,
                                                monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    _save_ref("o.npz", nsub=8, nchan=16, nbin=32, seed=5, n_rfi_cells=4,
              n_prezapped=6)
    argv = ["sweep", "o.npz", "--backend", "numpy", "--model", model,
            "-c", "3", "5", "8", "-s", "4", "6"]
    assert tools.main(argv) == 0
    mine = _lines(capsys)
    assert ref_tools.main(argv) == 0
    assert mine == _lines(capsys)
    assert len(mine) == 6


def test_sweep_grid(tmp_path, monkeypatch, capsys):
    """One row per grid point; the zap fraction falls as the threshold
    rises, and every row is a direct clean's."""
    monkeypatch.chdir(tmp_path)
    _save_ref("o.npz", nsub=8, nchan=16, nbin=32, seed=5, n_rfi_cells=4,
              n_prezapped=6)
    assert tools.main(["sweep", "o.npz", "--backend", "numpy", "-c", "3",
                       "8", "-s", "4"]) == 0
    rows = [json.loads(ln) for ln in _lines(capsys)]
    assert len(rows) == 2
    assert rows[0]["rfi_frac"] >= rows[1]["rfi_frac"]
    want = clean_archive(load_archive("o.npz"), CleanConfig(
        backend="numpy", chanthresh=8.0, subintthresh=4.0))
    assert rows[1]["rfi_frac"] == round(
        float((want.final_weights == 0).mean()), 6)
    assert rows[1]["loops"] == want.loops


@pytest.mark.parametrize("model", ["surgical_scrub", "quicklook"])
def test_sweep_torch_rows_are_in_process_cleans(model, tmp_path,
                                                monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    _save_ref("o.npz", nsub=8, nchan=16, nbin=32, seed=5, n_rfi_cells=4,
              n_prezapped=6)
    assert tools.main(["sweep", "o.npz", "--device", "cpu", "--model",
                       model, "-c", "4", "6", "-s", "5"]) == 0
    rows = [json.loads(ln) for ln in _lines(capsys)]
    ar = load_archive("o.npz")
    for row in rows:
        res = get_model(model)(ar, CleanConfig(
            device="cpu", chanthresh=row["chanthresh"],
            subintthresh=row["subintthresh"]))
        assert row["rfi_frac"] == round(res.rfi_fraction, 6)
        assert (row["loops"], row["converged"]) == (res.loops,
                                                    res.converged)


def _borderline_archive(path):
    return _save_ref(path, nsub=32, nchan=64, nbin=128, seed=0,
                     n_rfi_cells=20, rfi_strength=5.0, n_prezapped=40)


@pytest.mark.parametrize("model", ["surgical_scrub", "quicklook"])
def test_borderline_numpy_prints_the_reference_lines(model, tmp_path,
                                                     monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    _borderline_archive("b.npz")
    argv = ["borderline", "b.npz", "--eps", "0.05", "--model", model]
    assert tools.main(argv) == 0     # --backend numpy is the default
    mine = _lines(capsys)
    assert ref_tools.main(argv) == 0
    assert mine == _lines(capsys)


def test_tools_borderline(tmp_path, monkeypatch, capsys):
    """The per-cell rows agree with a direct clean's scores (same band,
    same zap side), and the summary's counts add up."""
    monkeypatch.chdir(tmp_path)
    ar = _borderline_archive("b.npz")
    assert tools.main(["borderline", "b.npz", "--eps", "0.05", "--backend",
                       "numpy"]) == 0
    lines = [json.loads(ln) for ln in _lines(capsys)]
    rows, summary = lines[:-1], lines[-1]
    assert summary["borderline"] == len(rows) > 0
    assert summary["zapped_borderline"] == sum(r["zapped"] for r in rows)
    res = clean_archive(load_archive("b.npz"), CleanConfig(backend="numpy"))
    s = np.asarray(res.scores)
    prezap = np.asarray(ar.weights) == 0
    want = np.argwhere(np.isfinite(s) & (np.abs(s - 1.0) < 0.05) & ~prezap)
    assert {(r["isub"], r["ichan"]) for r in rows} \
        == {(int(i), int(c)) for i, c in want}
    final_zap = np.asarray(res.final_weights) == 0
    for r in rows:
        assert abs(r["score"] - s[r["isub"], r["ichan"]]) < 1e-5
        assert r["zapped"] == bool(final_zap[r["isub"], r["ichan"]])
        assert not prezap[r["isub"], r["ichan"]]


def test_borderline_torch_cells_are_the_in_process_cleans(tmp_path,
                                                          monkeypatch,
                                                          capsys):
    monkeypatch.chdir(tmp_path)
    _borderline_archive("b.npz")
    assert tools.main(["borderline", "b.npz", "--backend", "torch",
                       "--device", "cpu", "--eps", "0.1"]) == 0
    lines = [json.loads(ln) for ln in _lines(capsys)]
    ar = load_archive("b.npz")
    res = clean_archive(ar, CleanConfig(device="cpu"))
    s = res.scores.astype(np.float64)
    band = np.isfinite(s) & (np.abs(s - 1.0) < 0.1) & (ar.weights != 0)
    assert {(r["isub"], r["ichan"]) for r in lines[:-1]} \
        == {(int(i), int(c)) for i, c in np.argwhere(band)}
    assert lines[-1]["loops"] == res.loops


@pytest.mark.parametrize("argv", [
    ["sweep", "o.npz", "-c", "5", "-s", "5"],
    ["borderline", "o.npz", "--backend", "torch"],
    ["sweep", "o.npz", "-c", "5", "-s", "5", "--model", "quicklook"],
])
def test_torch_backend_without_a_card_raises(argv, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.chdir(tmp_path)
    _save_ref("o.npz", nsub=6, nchan=10, nbin=32, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tools.main(argv)
