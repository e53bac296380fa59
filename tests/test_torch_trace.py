"""``--trace DIR`` (``utils/tracing.py``) on the CPU.

- A CLI session with ``--trace`` writes ``DIR/trace.rank0.json``, a
  Chrome trace whose host ranges hold each iteration's four stage ranges
  (``icln_template``, ``icln_residual_stats``, ``icln_scores``,
  ``icln_zap``, the reference's scope names) and the telemetry's
  ``icln_iter_metrics`` once per loop, and the session's phases once;
  quicklook's one pass holds the last three once and no template.
- A session without ``--trace`` starts no profiler (the reference's
  ``tests/test_tracing_isolation.py`` keeps ``--trace`` out of a plain
  run the same way), and its outputs equal the traced session's.
- ``device_trace`` publishes the file even when the body raises, and is a
  no-op without a directory.

The per-rank files of a mesh are in ``tests/test_torch_cli_mesh.py``; the
card's kernels in a trace are counted by ``chip_smoke.py``.
"""

import json
import os

import numpy as np
import pytest
import torch

from iterative_cleaner_torch import cli
from iterative_cleaner_torch.io import load_archive, save_archive
from iterative_cleaner_torch.io.synthetic import make_synthetic_archive
from iterative_cleaner_torch.utils import tracing
from iterative_cleaner_torch.utils.tracing import (
    STAGES,
    device_trace,
    trace_event_counts,
    trace_path,
)


@pytest.fixture()
def obs(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    ar, _ = make_synthetic_archive(nsub=8, nchan=16, nbin=32, seed=0,
                                   n_prezapped=3)
    save_archive(ar, "obs.npz")
    return "obs.npz"


@pytest.mark.parametrize("more", [[], ["--baseline_mode", "profile"],
                                  ["--stats_frame", "dedispersed"]])
def test_trace_holds_the_stage_ranges(obs, more):
    assert cli.main(["-q", "-l", "--device", "cpu", "--trace", "tr",
                     "--metrics-json", "run.json", *more, obs]) == 0
    assert os.listdir("tr") == ["trace.rank0.json"]
    names = trace_event_counts(trace_path("tr"), "user_annotation")
    with open("run.json") as f:
        loops = json.load(f)["archives"][0]["loops"]
    for stage in STAGES + ("icln_iter_metrics",):
        assert names[stage] == loops, (stage, names)
    for phase in ("icln:load", "icln:clean", "icln:write"):
        assert names[phase] == 1
    # the host's torch operations are in the trace too
    assert len(trace_event_counts(trace_path("tr"))) > len(names)


def test_quicklook_trace_holds_one_pass(obs):
    assert cli.main(["-q", "-l", "--device", "cpu", "--model", "quicklook",
                     "--trace", "tr", obs]) == 0
    names = trace_event_counts(trace_path("tr"), "user_annotation")
    assert "icln_template" not in names
    for stage in ("icln_residual_stats", "icln_scores", "icln_zap"):
        assert names[stage] == 1


def test_session_without_trace_starts_no_profiler(obs, monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("a profiler started without --trace")

    seen = []
    real = cli.get_model

    def spy(name):
        fn = real(name)

        def run(ar, cfg):
            seen.append(torch.autograd.profiler._is_profiler_enabled)
            return fn(ar, cfg)
        return run

    with monkeypatch.context() as m:
        m.setattr(torch.profiler, "profile", refuse)
        m.setattr(cli, "get_model", spy)
        assert cli.main(["-q", "-l", "--device", "cpu", "-o", "plain.npz",
                         obs]) == 0
    assert seen == [False]
    assert not os.path.exists("tr")
    assert cli.main(["-q", "-l", "--device", "cpu", "--trace", "tr", "-o",
                     "traced.npz", obs]) == 0
    np.testing.assert_array_equal(load_archive("plain.npz").weights,
                                  load_archive("traced.npz").weights)


def test_device_trace_publishes_when_the_body_raises(tmp_path):
    with pytest.raises(ValueError, match="boom"):
        with device_trace(str(tmp_path / "tr"), rank=3):
            with tracing.stage("icln_template"):
                torch.ones(4).sum()
            raise ValueError("boom")
    path = trace_path(str(tmp_path / "tr"), 3)
    assert path.endswith("trace.rank3.json")
    assert trace_event_counts(path, "user_annotation") == {
        "icln_template": 1}
    assert [f for f in os.listdir(tmp_path / "tr")] == ["trace.rank3.json"]


@pytest.mark.parametrize("trace_dir", [None, ""])
def test_device_trace_without_a_directory_is_a_no_op(trace_dir,
                                                     monkeypatch):
    monkeypatch.setattr(torch.profiler, "profile", None)
    with device_trace(trace_dir):
        assert not torch.autograd.profiler._is_profiler_enabled
