"""The launch plans of K3 and K9 and the radix select they share
(``stats/csrc/common.cuh``), on the CPU.

- ``scaled_sides_geometry``: for every block line (n up to 46,486, the
  unchanged boundary of ``scaled_sides_route``) the plan fits a Hopper
  block's shared memory beside the kernel's static state, selects four
  diagnostics at once wherever four fit, takes up to 8 columns a block
  along axis 0 and one row along axis 1, and its thread-to-entry map
  covers every (line, entry) of a block once.
- ``masked_median_geometry``: the block route up to MEDIAN_BLOCK_ENTRIES,
  the grid route above it with its chunks covering the line once.
- ``scaled_sides_route``'s three routes (block, cluster, long) either side
  of the block line and of the cluster's capacity, in float32 and
  float64; ``scaled_sides_cluster_geometry``: from the block line to the
  capacity the blocks of a cluster cover a line, each block's shared
  memory fits beside the cluster kernel's static state, the cluster is
  portable (at most 8 blocks), and its thread-to-entry map covers each
  entry of a block's slice once.

The selects themselves run only on the card: ``tests/test_torch_cuda.py``
holds them to their plain versions on edge and tie-heavy lines.
"""

import numpy as np
import pytest
import torch

from iterative_cleaner_torch.stats import kernels as tk

LONGEST_BLOCK_LINE = 46486


@pytest.mark.parametrize("axis", [0, 1])
def test_k3_geometry_fits_every_block_line(axis):
    for n in range(1, LONGEST_BLOCK_LINE + 1):
        plan = tk.scaled_sides_geometry(n, axis)
        assert plan.smem == tk.scaled_sides_smem(n, plan.diags, plan.lines)
        assert plan.smem + tk.SELECT_STATIC_SMEM <= tk._SMEM_LIMIT, n
        assert plan.threads % 32 == 0 and 64 <= plan.threads <= 1024
        assert plan.lines in ((8, 4, 2, 1) if axis == 0 else (1,))
        assert plan.threads % plan.lines == 0
        assert plan.lines * plan.diags <= 32   # ICLN_SEL_LINES
        # the most lines a block that fit, then the most diagnostics at
        # once that fit with them: four wherever four fit
        wider = [w for w in (8, 4, 2) if w > plan.lines]
        if axis == 0:
            assert not any(tk._sides_fits(n, 1, w) for w in wider), n
        four = tk._sides_fits(n, 4, plan.lines)
        assert (plan.diags == 4) == four, n
        if not four:
            assert plan.diags == (2 if tk._sides_fits(n, 2, plan.lines)
                                  else 1), n


def test_k3_geometry_at_the_main_path_shapes():
    # the full-size archive's planes: 1024 subints x 4096 channels
    assert tk.scaled_sides_geometry(1024, 0) == tk.SidesPlan(
        8, 4, 1024, tk.scaled_sides_smem(1024, 4, 8))
    assert tk.scaled_sides_geometry(4096, 1) == tk.SidesPlan(
        1, 4, 512, tk.scaled_sides_smem(4096, 4, 1))
    # the route boundary is unchanged and its longest line has a plan
    assert tk.LONGEST_BLOCK_LINE == LONGEST_BLOCK_LINE
    assert tk.scaled_sides_route(LONGEST_BLOCK_LINE) == "block"
    assert tk.scaled_sides_route(LONGEST_BLOCK_LINE + 1) == "cluster"
    assert tk.scaled_sides_geometry(LONGEST_BLOCK_LINE, 0).diags == 1


@pytest.mark.parametrize("n,lines,threads", [(1, 8, 64), (7, 8, 64),
                                             (1023, 8, 1024), (33, 2, 64),
                                             (4096, 1, 512), (100, 4, 96)])
def test_k3_tile_map_covers_each_entry_once(n, lines, threads):
    """Thread t works on line t % W, entries t // W + j * (threads // W)
    (scaled_sides.cu): every (line, entry) of a block once."""
    seen = np.zeros((lines, n), np.int64)
    for t in range(threads):
        c = t % lines
        for r in range(t // lines, n, threads // lines):
            seen[c, r] += 1
    assert (seen == 1).all()


def test_key_stride_keeps_rows_aligned_and_banks_apart():
    for n in (1, 7, 31, 32, 33, 1024, 4096, 46486):
        ls = tk._key_stride(n)
        assert ls >= n and ls % 4 == 0 and ls % 32 == 4
        # the same entry of lines c = 0..7 (line d * W + c, W = 8) on 8
        # distinct 4-bank groups: a warp's transposed writes do not collide
        assert len({(c * ls) % 32 for c in range(8)}) == 8


@pytest.mark.parametrize("dim", [0, 1])
@pytest.mark.parametrize("n", [1, 7, 1024, 4096, 4097, 8400, 50000,
                               4194304])
def test_k9_geometry_routes(n, dim):
    plan = tk.masked_median_geometry(n, dim)
    if n <= tk.MEDIAN_BLOCK_ENTRIES:
        assert plan.route == "block" and plan.bpl == 1
        assert plan.lines == (8 if dim == 0 else 1)
        assert plan.threads % 32 == 0 and plan.threads % plan.lines == 0
        assert plan.smem == 4 * plan.lines * (tk._key_stride(n) + 256)
        assert plan.smem + tk.SELECT_STATIC_SMEM <= tk._SMEM_LIMIT
    else:
        assert plan.route == "grid"
        assert plan.bpl > 1 and plan.chunk <= tk.MEDIAN_BLOCK_ENTRIES
        assert (plan.bpl - 1) * plan.chunk < n <= plan.bpl * plan.chunk


# the block line, the cluster's capacity (derived from the plan, not
# written down) and the key bytes of each plane dtype
ROUTE_DTYPES = {"float32": (torch.float32, LONGEST_BLOCK_LINE, 4),
                "float64": (torch.float64, 28224, 8)}


@pytest.mark.parametrize("name", sorted(ROUTE_DTYPES))
@pytest.mark.parametrize("where,want", [
    ("block", "block"), ("block+1", "cluster"), ("capacity", "cluster"),
    ("capacity+1", "long")])
def test_scaled_sides_route_three_ways(name, where, want):
    dtype, block, kb = ROUTE_DTYPES[name]
    cap = tk.scaled_sides_cluster_capacity(kb)
    n = {"block": block, "block+1": block + 1, "capacity": cap,
         "capacity+1": cap + 1}[where]
    assert tk.scaled_sides_route(n, dtype) == want
    # the capacity is the longest line a portable cluster's plan holds
    assert cap % (32 * tk.SIDES_CLUSTER_MAX) == 0 and cap > 4 * block
    tk.scaled_sides_cluster_geometry(cap, 1, kb)
    with pytest.raises(ValueError, match="cluster"):
        tk.scaled_sides_cluster_geometry(cap + 1, 1, kb)


def _cluster_ns(block, cap):
    """A sweep of line lengths from the block line to the capacity, with
    the ends, powers of two and lengths either side of slice steps."""
    ns = set(range(block + 1, cap + 1, 7919)) | {block + 1, cap}
    ns |= {2 ** k for k in range(16, 19) if block < 2 ** k <= cap}
    ns |= {8 * 8192 + 1, 8 * 8192 - 1, 4 * 11648 + 1}
    return sorted(n for n in ns if block < n <= cap)


@pytest.mark.parametrize("name", sorted(ROUTE_DTYPES))
@pytest.mark.parametrize("axis", [0, 1])
def test_cluster_geometry_fits_every_cluster_line(name, axis):
    _, block, kb = ROUTE_DTYPES[name]
    cap = tk.scaled_sides_cluster_capacity(kb)
    room = tk._SMEM_LIMIT - tk.sides_cluster_static_smem(kb)
    for n in _cluster_ns(block, cap):
        plan = tk.scaled_sides_cluster_geometry(n, axis, kb)
        c, sl = plan.cluster, plan.slice
        assert c in tk.SIDES_CLUSTER_SIZES and c <= 8, n   # portable
        assert sl % 32 == 0 and c * sl >= n > (c - 1) * sl, n
        assert plan.smem == tk.scaled_sides_smem(sl, plan.diags,
                                                 plan.lines, kb)
        assert plan.smem <= room, n
        assert plan.diags in (4, 2, 1)
        assert plan.lines in ((8, 4, 2, 1) if axis == 0 else (1,))
        assert plan.lines * plan.diags <= 32   # ICLN_SEL_LINES
        assert plan.threads % 32 == 0 and 64 <= plan.threads <= 1024
        assert plan.threads % plan.lines == 0
        # the fewest blocks a line whose slices fit the chosen W and D
        fewer = [f for f in tk.SIDES_CLUSTER_SIZES if f < c]
        assert not any(tk._cluster_fits(tk._cluster_slice(n, f),
                                        plan.diags, plan.lines, kb)
                       for f in fewer), n
        # every block of the cluster holds entries of each line
        assert n - (c - 1) * sl > 0


def test_cluster_geometry_at_the_single_pulse_shape():
    """The single-pulse archive's channel lines (65,536 subints): 4
    columns a cluster of 8 blocks, one diagnostic at a time, in float32;
    2 columns in float64."""
    assert tk.scaled_sides_cluster_geometry(65536, 0) == tk.SidesClusterPlan(
        8, 8192, 4, 1, 1024, tk.scaled_sides_smem(8192, 1, 4))
    assert tk.scaled_sides_cluster_geometry(65536, 0, 8) == \
        tk.SidesClusterPlan(8, 8192, 2, 1, 1024,
                            tk.scaled_sides_smem(8192, 1, 2, 8))


@pytest.mark.parametrize("n,cluster,lines,threads", [
    (46487, 8, 8, 1024), (65536, 8, 4, 1024), (100001, 8, 2, 1024),
    (46487, 4, 1, 1024)])
def test_cluster_slices_cover_each_entry_once(n, cluster, lines, threads):
    """Block r of a cluster holds entries [r * slice, (r + 1) * slice) of
    each line, and its thread t works on line t % W, slice entries t // W
    + j * (threads // W) (sides_cluster.cu): every (line, entry) once."""
    sl = tk._cluster_slice(n, cluster)
    seen = np.zeros((lines, n), np.int64)
    for r in range(cluster):
        sn = max(0, min(sl, n - r * sl))
        for t in range(threads):
            c = t % lines
            for e in range(t // lines, sn, threads // lines):
                seen[c, r * sl + e] += 1
    assert (seen == 1).all()
