"""The padded-mesh card contract (``analysis/card_contracts.py``
``mesh_padded_sweep``, the reference's ``_mesh_padded_sweep_program``)
on four gloo CPU ranks: a 5 x 9 x 32 grid, which the 2 x 2 mesh pads by
one subint and one channel, held to the contracts the CPU decides; its
pads, ranks and blocks against ``clean_cube_sharded``'s layout; the
pad-geometry check; a host sync seeded on one rank; a rank that raises
or stalls; and the gloo transport's host reads counted apart from the
program's own, for that program alone."""

import dataclasses
import json
import types

import numpy as np
import pytest
import torch

from iterative_cleaner_torch.analysis import card_contracts as cc
from iterative_cleaner_torch.parallel import distributed
from iterative_cleaner_torch.parallel.sharding import shard_host, shard_layout

from . import torch_shard_ranks

PROGRAM = cc.program_named("mesh_padded_sweep")


@pytest.fixture(scope="module")
def padded():
    return cc.verify_program(PROGRAM, "cpu")


def test_padded_program_is_registered_eighth():
    assert [p.name for p in cc.HOT_PROGRAMS][-1] == "mesh_padded_sweep"
    assert len(cc.HOT_PROGRAMS) == 8
    assert isinstance(PROGRAM, cc.MeshProgram) and cc.MESH_RANKS == 4
    assert PROGRAM.host_reads == 0 and PROGRAM.max_ops is not None
    assert cc.padded_geometry("cpu") == (5, 9, 32)
    assert cc.padded_geometry("cuda") == (257, 1025, 256)


def test_padded_report_names_pads_and_four_ranks(padded):
    assert padded.ok, [v.render() for v in padded.violations]
    assert padded.decided == cc.DECIDES["cpu"]
    assert padded.mesh == (2, 2) and padded.pads == (1, 1)
    assert len(padded.ranks) == 4
    for r, rk in enumerate(padded.ranks):
        assert rk["ok"] and rk["mesh"] == [2, 2] and rk["pads"] == [1, 1]
        assert rk["host_reads_per_iter"] == 0 and rk["iterations"] == 1
        assert rk["collectives_per_iter"] > 0
        assert rk["transport_reads_per_iter"] == 0    # CPU operands
    # every rank sweeps the same padded grid: the same ops
    assert len({rk["ops_per_iter"] for rk in padded.ranks}) == 1
    assert padded.ops == padded.ranks[0]["ops_per_iter"]
    doc = json.loads(json.dumps(padded.to_dict()))
    assert doc["pads"] == [1, 1] and len(doc["ranks"]) == 4
    text = padded.render()
    assert "mesh_padded_sweep on cpu over a 2 x 2 mesh of 4 ranks, " \
        "pads 1 x 1: ok" in text
    assert text.count("\n  rank ") == 4


def test_padded_blocks_are_clean_cube_sharded_blocks(padded):
    """Each rank's block is the one ``shard_layout`` gives its mesh
    coordinates, and the program's upload of it is ``shard_host``'s cut
    of the same archive: the archive zero-padded (weights too) by one
    subint and one channel, the frequencies edge-padded, as the
    reference's ``clean_cube_sharded`` pads."""
    shape = cc.padded_geometry("cpu")
    cube, w, freqs, dm, ref, period = cc.mesh_inputs(shape)
    padded_cube = np.pad(cube, ((0, 1), (0, 1), (0, 0)))
    padded_w = np.pad(w, ((0, 1), (0, 1)))
    padded_f = np.pad(freqs, (0, 1), mode="edge")
    for r, rk in enumerate(padded.ranks):
        mesh = types.SimpleNamespace(shape=(2, 2), coords=divmod(r, 2))
        layout = shard_layout(mesh, shape[0], shape[1])
        assert list(rk["block"]) == [layout.s0, layout.s1, layout.c0,
                                     layout.c1]
        block, w_t, meta = cc.padded_block("cpu", layout, shape)
        want = shard_host(cube, w, freqs, layout)
        np.testing.assert_array_equal(block.numpy(), want[0])
        np.testing.assert_array_equal(w_t.numpy(), want[1])
        np.testing.assert_array_equal(meta[0].numpy(),
                                      want[2].astype(np.float32))
        cut = (slice(layout.s0, layout.s1), slice(layout.c0, layout.c1))
        np.testing.assert_array_equal(block.numpy(), padded_cube[cut])
        np.testing.assert_array_equal(w_t.numpy(), padded_w[cut])
        np.testing.assert_array_equal(
            meta[0].numpy(), padded_f[cut[1]].astype(np.float32))
        assert [float(m) for m in meta[1:]] == pytest.approx(
            [dm, ref, period])
        assert rk["cube_bytes"] == block.numel() * block.element_size()


@pytest.mark.parametrize("shape", [(4, 8, 32), (5, 8, 32)],
                         ids=["divides", "one-axis"])
def test_geometry_the_mesh_divides_gives_pad_geometry(shape):
    report = cc.verify_program(dataclasses.replace(PROGRAM, shape=shape),
                               "cpu")
    assert not report.ok
    assert {v.contract for v in report.violations} == {"pad-geometry"}
    assert sorted(v.detail.split(":")[0] for v in report.violations) == \
        [f"rank {r}" for r in range(4)]
    assert report.ops == 0       # the sweep never ran


def test_host_sync_seeded_on_one_rank_names_that_rank():
    report = cc.verify_program(cc.seeded(PROGRAM, "host-sync", rank=2),
                               "cpu")
    assert not report.ok
    assert report.program == "mesh_padded_sweep+host-sync"
    assert {v.contract for v in report.violations} == {"no-host-sync"}
    assert all(v.detail.startswith("rank 2: ") for v in report.violations)
    assert [rk["host_reads_per_iter"] for rk in report.ranks] == [0, 0, 1, 0]
    assert [rk["ok"] for rk in report.ranks] == [True, True, False, True]


def test_rank_that_raises_gives_verifier_error():
    report = cc.verify_program(cc.seeded(PROGRAM, "raise", rank=1), "cpu")
    assert not report.ok
    assert "verifier-error" in {v.contract for v in report.violations}
    assert any(v.detail.startswith("rank 1: RuntimeError: seeded failure")
               for v in report.violations)
    assert not report.ranks[1]["ok"]


def test_stalled_rank_fails_the_run_without_fallback(monkeypatch):
    monkeypatch.setattr(cc, "RANK_TIMEOUT_S", 8.0)
    program = dataclasses.replace(PROGRAM, build=torch_shard_ranks.stall_build)
    report = cc.verify_program(program, "cpu")
    assert [v.contract for v in report.violations] == ["verifier-error"]
    assert "TimeoutError" in report.violations[0].detail
    assert report.ranks == [] and report.ops == 0


def test_seeding_a_rank_of_a_one_process_program_is_refused():
    with pytest.raises(ValueError, match="no rank"):
        cc.seeded(cc.program_named("sweep"), "host-sync", rank=1)


def _transport_toy(transport, outside):
    def build(device):
        w = torch.ones(cc.NSUB, cc.NCHAN, device=device)

        def call():
            with distributed._collective():
                w.sum().item()       # a read the transport makes
            if outside:
                w.sum().item()       # one the program makes
            return (w * 2.0).sum(dim=1)

        return cc.HotRun(call=call, cube_bytes=0, kernels={}, probe=w,
                         transport=transport)

    return cc.HotProgram("toy", build, host_reads=0, max_ops=None)


@pytest.mark.parametrize("transport,outside,reads,inside", [
    (True, False, 0, 1),      # the transport's read, counted apart
    (True, True, 1, 1),       # the program's own read still counts
    (False, False, 1, 0),     # the seven programs count every read
])
def test_reads_inside_a_collective_are_the_transports_alone(
        transport, outside, reads, inside):
    report = cc.verify_program(_transport_toy(transport, outside), "cpu")
    assert report.host_reads == reads
    assert report.transport_reads == inside
    assert report.ok == (reads == 0)
    assert distributed.COLLECTIVE_LISTENER is None
