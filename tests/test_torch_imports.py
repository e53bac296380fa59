"""The port stands alone: importing it and running its main path never
loads ``jax`` or the reference package, and no source of the port (or
``chip_smoke.py``) imports either."""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "iterative_cleaner_torch")
FORBIDDEN = ("jax", "jaxlib", "iterative_cleaner_tpu")


def _port_sources():
    for root, _dirs, files in os.walk(PKG):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(root, name)
    yield os.path.join(REPO, "chip_smoke.py")


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(_port_sources()),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_forbidden_import_in_source(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_main_path_runs_without_jax():
    code = """
import sys
import numpy as np
import iterative_cleaner_torch
from iterative_cleaner_torch import CleanConfig
from iterative_cleaner_torch.backends import clean_archive
from iterative_cleaner_torch.io.synthetic import make_synthetic_archive
import iterative_cleaner_torch.cli, iterative_cleaner_torch.convert
ar, _ = make_synthetic_archive(nsub=8, nchan=16, nbin=32, seed=0)
res = clean_archive(ar, CleanConfig(device="cpu"))
assert res.loops >= 1
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "iterative_cleaner_tpu"))
print("LOADED", bad)
"""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout
