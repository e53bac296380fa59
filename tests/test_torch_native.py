"""The port's host I/O library (``io/native.py`` + ``io/csrc``), its
``.icar`` container, the TIMER ``.ar`` bridge and ``tools info`` /
``convert``, against the reference package's on identical archives.

- ``.icar`` files written by the port's library, by its Python writer
  and by the reference are byte-equal; each package reads the other's;
  the port's native and Python readers give equal arrays.
- The library builds with the host compiler into a digest-named file;
  a compiler that fails, no compiler, or a library that does not load
  raise ``RuntimeError`` and nothing is read another way; processes
  racing to build one library all load a whole one.
- The bridge runs on ``tests/fake_psrchive.py``, as the reference's
  bridge tests drive it; without the bindings a TIMER ``.ar`` raises
  the reference's ``ValueError``.
- ``tools info`` prints what the reference's prints and never reads the
  cube; ``tools convert`` writes what the reference's writes.
"""

import json
import os
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest

from iterative_cleaner_tpu import tools as ref_tools
from iterative_cleaner_tpu.io import load_archive as ref_load_archive
from iterative_cleaner_tpu.io import native as ref_native
from iterative_cleaner_tpu.io import psrchive_bridge as ref_bridge
from iterative_cleaner_tpu.io import save_archive as ref_save_archive
from iterative_cleaner_tpu.io.synthetic import (
    make_synthetic_archive as ref_make_synthetic_archive,
)
from iterative_cleaner_torch import cli, tools
from iterative_cleaner_torch.convert import archive_from_reference
from iterative_cleaner_torch.io import load_archive, native, save_archive
from iterative_cleaner_torch.io import psrchive_bridge as bridge
from iterative_cleaner_torch.io import psrfits

from . import fake_psrchive
from .test_torch_psrfits import _assert_same_archive

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

def _pair(npol=1, pol_state=None, **kw):
    args = dict(nsub=6, nchan=10, nbin=32, seed=3, n_prezapped=4)
    args.update(kw)
    ref, _ = ref_make_synthetic_archive(npol=npol, **args)
    if pol_state:
        ref.pol_state = pol_state
    return ref, archive_from_reference(ref)


# ---------------------------------------------------------------------------
# .icar
# ---------------------------------------------------------------------------

ICAR_CASES = [
    dict(npol=1),
    dict(npol=4, pol_state="Stokes", dedispersed=True),
    dict(npol=2, pol_state="Coherence", nbits=32, source="J1939+2134 long"),
]


@pytest.mark.parametrize("case", ICAR_CASES, ids=["inten", "stokes", "coh"])
def test_icar_bytes_equal_across_writers(tmp_path, case):
    case = dict(case)
    nbits, source = case.pop("nbits", 16), case.pop("source", None)
    dedispersed = case.pop("dedispersed", False)
    ref, ar = _pair(**case)
    for a in (ref, ar):
        a.psrfits_nbits, a.dedispersed = nbits, dedispersed
        if source:
            a.source = source
    paths = {k: str(tmp_path / f"{k}.icar")
             for k in ("native", "python", "ref")}
    native.save_icar(ar, paths["native"])
    native._save_icar_python(ar, paths["python"])
    ref_native.save_icar(ref, paths["ref"])
    blobs = {k: open(p, "rb").read() for k, p in paths.items()}
    assert blobs["native"] == blobs["python"] == blobs["ref"]
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]


@pytest.mark.parametrize("case", ICAR_CASES, ids=["inten", "stokes", "coh"])
def test_icar_each_package_reads_the_others(tmp_path, case):
    case = dict(case)
    nbits, source = case.pop("nbits", 16), case.pop("source", None)
    dedispersed = case.pop("dedispersed", False)
    ref, ar = _pair(**case)
    for a in (ref, ar):
        a.psrfits_nbits, a.dedispersed = nbits, dedispersed
        if source:
            a.source = source
    mine, theirs = str(tmp_path / "port.icar"), str(tmp_path / "ref.icar")
    save_archive(ar, mine)
    ref_save_archive(ref, theirs)
    for path in (mine, theirs):
        want = archive_from_reference(ref_load_archive(path))
        got = load_archive(path)
        _assert_same_archive(got, want)
        _assert_same_archive(native._load_icar_python(path), got)
        assert got.filename == path
        np.testing.assert_array_equal(
            got.data, np.asarray(ar.data, np.float32).astype(np.float64))
        assert native.read_icar_header(path) == \
            ref_native.read_icar_header(path)
        np.testing.assert_array_equal(native.read_icar_weights(path),
                                      ref_native.read_icar_weights(path))


def test_icar_loads_are_counted(tmp_path):
    _, ar = _pair()
    path = str(tmp_path / "a.icar")
    save_archive(ar, path)
    native.reset_load_counts()
    load_archive(path)
    native._load_icar_python(path)
    assert native.load_counts() == {"psrfits": 0, "icar": 1}


def test_icar_corrupt_and_unwritable_raise(tmp_path):
    bad = tmp_path / "bad.icar"
    bad.write_bytes(b"NOTICAR!" + b"\x00" * 200)
    with pytest.raises(OSError):
        load_archive(str(bad))
    _, ar = _pair()
    full = tmp_path / "full.icar"
    save_archive(ar, str(full))
    trunc = tmp_path / "trunc.icar"
    trunc.write_bytes(full.read_bytes()[:200])   # header whole, arrays cut
    with pytest.raises(OSError):
        load_archive(str(trunc))
    with pytest.raises(OSError):
        save_archive(ar, str(tmp_path / "missing-dir" / "x.icar"))


# ---------------------------------------------------------------------------
# the host build
# ---------------------------------------------------------------------------

@pytest.fixture
def fresh_build(tmp_path, monkeypatch):
    """An empty build directory and no library loaded yet."""
    build = tmp_path / "_build"
    monkeypatch.setattr(native, "BUILD_DIR", build)
    monkeypatch.setattr(native, "_LIB", None)
    return build


def test_library_built_by_digest_into_build_dir(fresh_build):
    path = native.build_library()
    assert path.parent == fresh_build
    assert path.name == f"libicln_io_{native._source_digest()}.so"
    assert os.listdir(fresh_build) == [path.name]   # no temporary left
    assert native.build_library() == path            # cached
    lib = native.load_library()
    assert lib is native.load_library()
    assert "-ffp-contract=off" in native.CXX_FLAGS
    assert not any("march" in f or "fast-math" in f for f in native.CXX_FLAGS)


def test_failed_compiler_raises_and_reads_nothing(tmp_path, fresh_build,
                                                  monkeypatch):
    _, ar = _pair()
    sf, icar = str(tmp_path / "a.sf"), str(tmp_path / "a.icar")
    psrfits.save_psrfits(ar, sf)
    native._save_icar_python(ar, icar)
    monkeypatch.setattr(native, "_compiler", lambda: shutil.which("false"))
    calls = []
    monkeypatch.setattr(psrfits, "_parse_psrfits",
                        lambda *a: calls.append(a))
    native.reset_load_counts()
    for path in (sf, icar):
        with pytest.raises(RuntimeError, match="failed"):
            load_archive(path)
    with pytest.raises(RuntimeError, match="failed"):
        save_archive(ar, str(tmp_path / "b.icar"))
    assert not os.path.exists(tmp_path / "b.icar")
    assert calls == [] and native.load_counts() == {"psrfits": 0, "icar": 0}
    assert not fresh_build.exists() or os.listdir(fresh_build) == []


def test_no_compiler_raises(fresh_build, monkeypatch):
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        native.load_library()


def test_library_that_does_not_load_raises(fresh_build):
    fresh_build.mkdir()
    (fresh_build / f"libicln_io_{native._source_digest()}.so").write_bytes(
        b"not an ELF file")
    with pytest.raises(RuntimeError, match="loading the host I/O library"):
        native.load_library()


_RACER = """
import sys
from pathlib import Path
import numpy as np
from iterative_cleaner_torch.io import native
native.BUILD_DIR = Path(sys.argv[1])
ar = native._load_icar_python(sys.argv[2])
back = native.load_icar(sys.argv[2])
assert np.array_equal(back.data, ar.data)
print("OK", native.build_library().name)
"""


def test_racing_builds_each_load_a_whole_library(tmp_path):
    """Four processes reach the first build of one library at once: each
    builds in its own temporary directory and renames into place, so
    each loads a whole library and reads the file."""
    _, ar = _pair()
    icar = str(tmp_path / "a.icar")
    native._save_icar_python(ar, icar)
    build = tmp_path / "_build"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    procs = [subprocess.Popen([sys.executable, "-c", _RACER, str(build), icar],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.startswith("OK libicln_io_")
    assert len(os.listdir(build)) == 1


# ---------------------------------------------------------------------------
# the TIMER bridge
# ---------------------------------------------------------------------------

@pytest.fixture
def fake_bindings(monkeypatch):
    monkeypatch.setitem(sys.modules, "psrchive", fake_psrchive)


@pytest.fixture
def npz_source(tmp_path):
    ref, _ = ref_make_synthetic_archive(nsub=6, nchan=10, nbin=32, npol=2,
                                        seed=9, n_prezapped=4)
    ref.pol_state = "Coherence"
    path = str(tmp_path / "obs.npz")   # the fake reads the npz container
    ref_save_archive(ref, path)
    return path


def test_bridge_load_equal_to_reference(fake_bindings, npz_source):
    got = bridge.load_ar(npz_source)
    want = archive_from_reference(ref_bridge.load_ar(npz_source))
    _assert_same_archive(got, want)
    assert got.filename == npz_source
    for state, npol in (("Intensity", 1), ("Coherence", 4), ("PPQQ", 2),
                        ("Stokes", 4), ("Coherence", 1)):
        assert bridge._map_state(state, npol) == \
            ref_bridge._map_state(state, npol)


@pytest.mark.parametrize("pscrunch", [False, True])
def test_bridge_save_equal_to_reference(fake_bindings, npz_source, tmp_path,
                                        pscrunch):
    """Clone-and-set: cleaned weights, edited amplitudes, a pscrunched
    model; the port's output loads equal to the reference's."""
    outs = {}
    for name, mod in (("port", bridge), ("ref", ref_bridge)):
        model = mod.load_ar(npz_source)
        if pscrunch:
            model.pscrunch()
        model.weights[1, 2] = 0.0
        model.data[0, 0, 1, :] = 7.25
        outs[name] = str(tmp_path / f"{name}_out.npz")
        mod.save_ar(model, outs[name])
    got, want = (archive_from_reference(ref_load_archive(p))
                 for p in (outs["port"], outs["ref"]))
    _assert_same_archive(got, want)
    assert got.weights[1, 2] == 0.0 and got.npol == (1 if pscrunch else 2)


def test_bridge_save_refusals(fake_bindings, npz_source, tmp_path):
    import dataclasses

    _, ar = _pair()
    ar.filename = ""
    with pytest.raises(ValueError, match="filename"):
        bridge.save_ar(ar, str(tmp_path / "x.ar"))
    model = bridge.load_ar(npz_source)
    model = dataclasses.replace(model, data=model.data[:-1],
                                weights=model.weights[:-1])
    with pytest.raises(ValueError, match="cell grid"):
        bridge.save_ar(model, str(tmp_path / "bad.npz"))


def _timer_bindings(monkeypatch, timer_path, npz_path):
    """Bindings that read the TIMER file ``timer_path`` as the archive in
    ``npz_path`` (the fake reads npz containers only)."""
    def archive_load(path):
        src = npz_path if os.path.abspath(path) == timer_path else path
        return fake_psrchive.FakeArchive(ref_load_archive(src), path)

    monkeypatch.setitem(sys.modules, "psrchive",
                        types.SimpleNamespace(Archive_load=archive_load))


def test_timer_ar_loads_cleans_and_writes_back(tmp_path, monkeypatch,
                                               npz_source):
    """A TIMER ``.ar`` through the dispatch: loaded by the bridge, cleaned
    by the CLI, its output written back through the bridge's
    clone-and-set; the port's session equal to the reference's."""
    timer = str(tmp_path / "old.ar")
    with open(timer, "wb") as f:
        f.write(b"TIMER archive header" + b"\0" * 512)
    assert not psrfits.is_fits(timer)
    _timer_bindings(monkeypatch, timer, npz_source)
    got = load_archive(timer)
    assert got.filename == timer
    _assert_same_archive(got, archive_from_reference(
        ref_load_archive(npz_source)))
    writes = []
    real_save = bridge.save_ar
    monkeypatch.setattr(bridge, "save_ar",
                        lambda a, p: (writes.append(p), real_save(a, p)))
    monkeypatch.chdir(tmp_path)
    assert cli.main(["--device", "cpu", "-q", "-l", "old.ar"]) == 0
    assert writes == ["old.ar_cleaned.ar"]
    os.rename("old.ar_cleaned.ar", "port_cleaned.ar")
    from iterative_cleaner_tpu import cli as ref_cli

    assert ref_cli.main(["-q", "-l", "old.ar"]) == 0
    mine = load_archive("port_cleaned.ar")   # the fake unloads PSRFITS
    theirs = ref_load_archive("old.ar_cleaned.ar")
    np.testing.assert_array_equal(mine.weights == 0, theirs.weights == 0)
    np.testing.assert_array_equal(mine.data, theirs.data)


def test_timer_source_gone_warns_and_writes_psrfits(tmp_path):
    _, ar = _pair()
    ar.filename = str(tmp_path / "gone.ar")
    out = str(tmp_path / "out.ar")
    with pytest.warns(UserWarning, match="no longer on disk"):
        save_archive(ar, out)
    assert psrfits.is_fits(out)


def test_timer_ar_without_bindings_raises_reference_error(tmp_path,
                                                          monkeypatch):
    timer = str(tmp_path / "legacy.ar")
    with open(timer, "wb") as f:
        f.write(b"TIMER archive, not FITS" * 10)
    monkeypatch.setitem(sys.modules, "psrchive", None)
    with pytest.raises(ValueError) as want:
        ref_load_archive(timer)
    with pytest.raises(ValueError) as got:
        load_archive(timer)
    assert str(got.value) == str(want.value)
    assert "psrconv -o PSRFITS legacy.ar" in str(got.value)
    with pytest.raises(ImportError, match="psrchive"):
        bridge.load_ar(timer)


# ---------------------------------------------------------------------------
# tools info / convert
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ext", [".icar", ".sf", ".npz", ".ar"])
def test_tools_info_prints_what_reference_prints(tmp_path, capsys,
                                                 monkeypatch, ext):
    ref, _ = _pair(npol=2, pol_state="Coherence")
    path = str(tmp_path / ("obs" + ext))
    ref_save_archive(ref, path)
    assert ref_tools.main(["info", path]) == 0
    want = capsys.readouterr().out

    def cube_read(*_a, **_k):
        raise AssertionError("tools info read the data cube")

    for mod, name in ((native, "load_icar"), (native, "_load_icar_python"),
                      (psrfits, "_parse_psrfits"),
                      (psrfits, "_load_psrfits_native")):
        monkeypatch.setattr(mod, name, cube_read)
    assert tools.main(["info", path]) == 0
    got = capsys.readouterr().out
    assert got == want
    info = json.loads(got)
    assert (info["nsub"], info["npol"], info["nchan"]) == (6, 2, 10)
    assert info["rfi_frac"] == float((ref.weights == 0).mean())


@pytest.mark.parametrize("src_ext,dst_ext", [
    (".npz", ".icar"), (".sf", ".icar"), (".icar", ".sf"), (".icar", ".npz"),
    (".npz", ".sf"), (".sf", ".ar"),
])
def test_tools_convert_writes_what_reference_writes(tmp_path, src_ext,
                                                    dst_ext):
    ref, _ = _pair(npol=4, pol_state="Stokes")
    src = str(tmp_path / ("src" + src_ext))
    ref_save_archive(ref, src)
    mine, theirs = (str(tmp_path / (n + dst_ext)) for n in ("port", "ref"))
    assert tools.main(["convert", src, mine]) == 0
    assert ref_tools.main(["convert", src, theirs]) == 0
    if dst_ext != ".npz":   # npz members carry the time they were written
        assert open(mine, "rb").read() == open(theirs, "rb").read()
    got = load_archive(mine)
    _assert_same_archive(got, archive_from_reference(ref_load_archive(
        theirs)))


# every command of the reference's tools runs (selftest:
# tests/test_torch_oracle.py; diff, sweep, borderline in depth:
# tests/test_torch_tools.py)
@pytest.mark.parametrize("argv", [
    ["diff", "a.icar", "a.icar"], ["sweep", "a.icar", "--device", "cpu",
                                   "-c", "5", "-s", "5"],
    ["borderline", "a.icar"],
    ["sweep", "a.icar", "--backend", "numpy", "-c", "5", "-s", "5"]])
def test_tools_commands_run(argv, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    _, ar = _pair()
    save_archive(ar, "a.icar")
    assert tools.main(argv) == 0
    assert all(json.loads(ln) for ln in
               capsys.readouterr().out.strip().splitlines())


def test_cli_model_online_ewt_names_item_5(tmp_path, monkeypatch):
    """Item 5 is ported: ``--model online_ewt`` cleans an ``.icar``
    archive read through the host library."""
    monkeypatch.chdir(tmp_path)
    _, ar = _pair()
    save_archive(ar, "a.icar")
    assert cli.main(["--device", "cpu", "-q", "--model", "online_ewt",
                     "a.icar"]) == 0
    assert load_archive("a.icar_cleaned.icar").weights.shape \
        == ar.weights.shape


def test_tools_entry_point_runs(tmp_path):
    _, ar = _pair()
    path = str(tmp_path / "a.icar")
    save_archive(ar, path)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    out = subprocess.run(
        [sys.executable, "-m", "iterative_cleaner_torch.tools", "info", path],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout)["nbin"] == ar.nbin
