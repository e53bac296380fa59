"""The port's archive surface against the reference package's:
``Archive.clone`` / ``get_weights`` / ``set_weight`` on the same seeded
archive, their first caller (``tools selftest`` cleans a clone on each
backend), and ``io.psrchive_bridge.apply_weights_to_ar`` on
``tests/fake_psrchive.py``, as the reference's bridge tests drive it."""

import sys

import numpy as np
import pytest

from iterative_cleaner_tpu.io import load_archive as ref_load_archive
from iterative_cleaner_tpu.io import psrchive_bridge as ref_bridge
from iterative_cleaner_tpu.io import save_archive as ref_save_archive
from iterative_cleaner_tpu.io.synthetic import (
    make_synthetic_archive as ref_make_synthetic_archive,
)
from iterative_cleaner_torch import tools
from iterative_cleaner_torch.convert import archive_from_reference
from iterative_cleaner_torch.io import load_archive
from iterative_cleaner_torch.io import psrchive_bridge as bridge

from . import fake_psrchive

FIELDS = ("period_s", "dm", "centre_freq_mhz", "source", "mjd_start",
          "mjd_end", "filename", "pol_state", "dedispersed", "psrfits_nbits")


def _pair():
    ref, _ = ref_make_synthetic_archive(nsub=6, nchan=10, nbin=32, npol=2,
                                        seed=3, n_prezapped=4)
    ref.pol_state = "Coherence"
    ref.filename = "obs.ar"
    return ref, archive_from_reference(ref)


def _arrays(ar):
    return (np.asarray(ar.data), np.asarray(ar.weights),
            np.asarray(ar.freqs_mhz))


def test_clone_equals_the_reference_clone_and_is_independent():
    ref, ar = _pair()
    want, got = ref.clone(), ar.clone()
    assert type(got) is type(ar) and got is not ar
    for g, w in zip(_arrays(got), _arrays(want)):
        np.testing.assert_array_equal(g, w)
    for name in FIELDS:
        assert getattr(got, name) == getattr(want, name), name
    # the copies are the clone's own, in both packages
    before = [a.copy() for a in _arrays(ar)]
    for clone in (got, want):
        clone.data[0, 0, 0, :] = -7.0
        clone.weights[1, 2] = 0.5
        clone.freqs_mhz[3] = 1.0
    for src in (ar, ref):
        for a, b in zip(_arrays(src), before):
            np.testing.assert_array_equal(a, b)
    got.pscrunch()
    assert ar.npol == 2 and got.npol == 1


def test_get_weights_and_set_weight_match_the_reference():
    ref, ar = _pair()
    got, want = ar.get_weights(), ref.get_weights()
    np.testing.assert_array_equal(got, want)
    got[0, 0] = want[0, 0] = -1.0        # copies, not views
    np.testing.assert_array_equal(ar.weights, np.asarray(ref.weights))
    assert ar.weights[0, 0] != -1.0
    for isub, ichan, value in ((2, 3, 0.0), (5, 9, 0.25), (0, 0, 0.0)):
        ar.set_weight(isub, ichan, value)
        ref.set_weight(isub, ichan, value)
    np.testing.assert_array_equal(ar.weights, np.asarray(ref.weights))
    assert ar.weights[5, 9] == 0.25
    np.testing.assert_array_equal(ar.get_weights(), ref.get_weights())


def test_selftest_cleans_a_clone_and_leaves_its_archive(monkeypatch, capsys):
    """``tools selftest --device cpu`` exits 0 with its output unchanged,
    hands each backend a clone, never its own archive, and leaves that
    archive as it was made."""
    from iterative_cleaner_torch import backends
    from iterative_cleaner_torch.io import synthetic

    made, cleaned = [], []
    real_make, real_clean = synthetic.make_synthetic_archive, \
        backends.clean_archive

    def make(**kw):
        ar, truth = real_make(**kw)
        made.append((ar, [a.copy() for a in _arrays(ar)]))
        return ar, truth

    def clean(ar, config, **kw):
        cleaned.append((ar, config.backend))
        return real_clean(ar, config, **kw)

    monkeypatch.setattr(synthetic, "make_synthetic_archive", make)
    monkeypatch.setattr(backends, "clean_archive", clean)
    assert tools.main(["selftest", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "OK: masks bit-identical" in out
    (ar, before), = made
    assert [b for _, b in cleaned] == ["numpy", "torch"]
    assert all(c is not ar for c, _ in cleaned)
    assert cleaned[0][0] is not cleaned[1][0]
    for a, b in zip(_arrays(ar), before):
        np.testing.assert_array_equal(a, b)


@pytest.fixture
def fake_bindings(monkeypatch):
    monkeypatch.setitem(sys.modules, "psrchive", fake_psrchive)


def test_apply_weights_to_ar_equal_to_reference(fake_bindings, tmp_path):
    ref, _ = ref_make_synthetic_archive(nsub=6, nchan=10, nbin=32, seed=3,
                                        n_prezapped=4)
    path = str(tmp_path / "obs.npz")   # the fake reads the npz container
    ref_save_archive(ref, path)
    new_w = np.asarray(ref.weights).copy()
    new_w[2, 3] = 0.0
    new_w[5, 7] = 0.0
    outs = {}
    for name, mod in (("port", bridge), ("ref", ref_bridge)):
        outs[name] = str(tmp_path / f"{name}_out.npz")
        mod.apply_weights_to_ar(path, outs[name], new_w)
    got = load_archive(outs["port"])
    want = ref_load_archive(outs["ref"])
    np.testing.assert_array_equal(got.weights, new_w)
    np.testing.assert_array_equal(got.weights, np.asarray(want.weights))
    np.testing.assert_array_equal(got.data, np.asarray(want.data))
    np.testing.assert_array_equal(got.data, np.asarray(ref.data))


def test_apply_weights_to_ar_needs_the_bindings(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "psrchive", None)
    with pytest.raises(ImportError, match="psrchive"):
        bridge.apply_weights_to_ar(str(tmp_path / "x.ar"),
                                   str(tmp_path / "y.ar"),
                                   np.ones((2, 4)))
