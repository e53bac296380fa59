"""Statistics of the cell-sharded clean that cross ranks: the weighted
marginals of K1 per shard, the tree-reduced robust statistics and the
gathered scaler.

The port's counterpart of ``iterative_cleaner_tpu/parallel/
shard_stats.py`` (``tree_reducers``, ``tree_masked_median_lanes``,
``tree_scaled_sides``, ``tree_combine_zap``,
``sharded_weighted_marginals``, ``sharded_scale_and_combine``).  Its
``shard_divisible`` is ``parallel/sharding.py``'s ``check_tile_grid``
on the streamed routes; the sharded clean pads the grid to the rank
grid instead, as the reference's callers do before they assert it.

The scalers' medians and MADs run the reference's exact select
(``_select_kth``/``_select_adjacent``, ``stats/pallas_kernels.py``) as a
merge of per-shard counts: each bisection step counts, on this rank's
shard, the keys at or below the step's midpoint, and one int32
all-reduce over the reduction axis's subgroup sums the counts, so every
rank walks the same global bisection; then the successor's count (sum)
and minimum (min).  The keys are the plane dtype's order-preserving keys
(:func:`~iterative_cleaner_torch.stats.kernels.ordered_key`): int32 and
32 steps for float32 planes, int64 and 64 steps for float64 planes (the
reference's bisection over its plane dtype's key; the successor's
minimum then crosses ranks as int64, the counts stay int32).  The four
diagnostics' counts ride one stacked tensor per step, so a float32
orientation costs 2 x 35 collectives (the line counts with the rFFT
diagnostic's NaN presence, 32 steps, the successor pair; once for the
medians, once for the MADs), a float64 one 2 x 67.  Integer adds and
minima are exact in any order and the float epilogues run on identical
operands, so the distributed medians, MADs and scaled sides are
bit-equal to kernel K3 on the whole planes.  The steps are torch ops on
the shard, as the reference's are XLA ops outside its Pallas kernels.
"""

from __future__ import annotations

import torch

from iterative_cleaner_torch.stats.kernels import (
    _KEYS,
    combine_zap,
    key_to_float,
    ordered_key,
    scaled_sides,
    weighted_marginals,
)
from iterative_cleaner_torch.stats.masked_torch import (
    _masked_side,
    inverse_threshold,
)
from iterative_cleaner_torch.utils.tracing import stage

# key dtype: (bisection steps, smallest key, largest key)
_KEY_RANGE = {torch.int32: (32, -2 ** 31, 2 ** 31 - 1),
              torch.int64: (64, -2 ** 63, 2 ** 63 - 1)}


def _masked_keys(values, mask):
    """The ordered keys of ``values`` (int32 for float32, int64 for
    float64), a masked entry's the key of +inf (above every finite
    value, below NaN)."""
    keys = ordered_key(values)
    return torch.where(mask, torch.full_like(keys, _KEYS[values.dtype][3]),
                       keys)


def tree_reducers(mesh, axis: str):
    """(reduce_sum, reduce_min, reduce_any) of integer per-line tensors
    over ``axis`` ('sub', 'chan' or 'all'): the reference's psum, pmin and
    pmax-as-any (int32 counts and flags, int32 or int64 keys)."""
    def reduce_sum(x):
        return mesh.reduce_int(x, "sum", axis)

    def reduce_min(x):
        return mesh.reduce_int(x, "min", axis)

    def reduce_any(x):
        return mesh.reduce_int(x.to(torch.int32), "max", axis) > 0

    return reduce_sum, reduce_min, reduce_any


def _select_adjacent(keys, k_lo, k_hi, dim, reduce_sum, reduce_min):
    """The ``k_lo``-th and ``k_hi``-th smallest keys along ``dim`` of
    ``keys`` (``k_hi`` is ``k_lo`` or ``k_lo + 1``), with the counts and
    the successor merged across the shards of ``dim``.  ``k_lo``/``k_hi``
    have ``keys``' shape with ``dim`` of size 1; the bisection runs over
    the keys' dtype, 32 steps for int32 keys and 64 for int64."""
    steps, kmin, kmax = _KEY_RANGE[keys.dtype]
    lo = torch.full(k_lo.shape, kmin, dtype=keys.dtype, device=keys.device)
    hi = torch.full(k_lo.shape, kmax, dtype=keys.dtype, device=keys.device)
    for _ in range(steps):
        mid = (lo >> 1) + (hi >> 1) + (lo & hi & 1)   # floor midpoint
        cnt = reduce_sum(torch.sum(keys <= mid, dim=dim, keepdim=True,
                                   dtype=torch.int32))
        go_low = cnt >= k_lo + 1
        lo, hi = torch.where(go_low, lo, mid + 1), torch.where(go_low, mid, hi)
    cnt_le = reduce_sum(torch.sum(keys <= lo, dim=dim, keepdim=True,
                                  dtype=torch.int32))
    above = torch.where(keys > lo, keys, torch.full_like(keys, kmax))
    succ = reduce_min(torch.amin(above, dim=dim, keepdim=True))
    return lo, torch.where(cnt_le > k_hi, lo, succ)


def _median_of_keys(keys, n_valid, dim, reduce_sum, reduce_min):
    """``0.5 * (lo + hi)`` of the two middle keys, 0.0 on an empty line
    (the reference's ``_masked_median_lanes`` epilogue)."""
    k_lo = torch.clamp(n_valid - 1, min=0) // 2
    lo, hi = _select_adjacent(keys, k_lo, n_valid // 2, dim, reduce_sum,
                              reduce_min)
    med = 0.5 * (key_to_float(lo) + key_to_float(hi))
    return torch.where(n_valid == 0, torch.zeros_like(med), med)


def tree_masked_median_lanes(values, mask, dim, reducers):
    """The median of the unmasked entries of each line along ``dim``
    (keepdim), the lines' other shards on the ranks ``reducers`` merge
    over; returns ``(median, n_valid)`` with the global count.  Equal to
    the single-device select on the concatenated shards."""
    reduce_sum, reduce_min, _ = reducers
    keys = _masked_keys(values, mask)
    n_valid = reduce_sum(torch.sum(~mask, dim=dim, keepdim=True,
                                   dtype=torch.int32))
    return _median_of_keys(keys, n_valid, dim, reduce_sum, reduce_min), \
        n_valid


def tree_scaled_sides(diagnostics, cell_mask, axis, thresh, mesh):
    """The four scaled sides of one orientation (K3's values) on this
    rank's shard: ``axis=0`` scales each channel down the subints, which
    are split over the 'sub' subgroup; ``axis=1`` each subint across the
    channels, split over 'chan'."""
    reduce_sum, reduce_min, reduce_any = tree_reducers(mesh,
                                                       ("sub", "chan")[axis])
    d3 = diagnostics[3]
    masked = torch.stack(diagnostics[:3])                       # (3, s, c)
    m3 = cell_mask.expand_as(masked)
    dim = 1 + axis
    # one collective: the masked lines' valid counts, the rFFT lines'
    # length, and whether an rFFT line holds a NaN on any shard
    n_loc = torch.sum(~cell_mask, dim=axis, keepdim=True, dtype=torch.int32)
    local = torch.stack([n_loc, torch.full_like(n_loc, cell_mask.shape[axis]),
                         torch.any(torch.isnan(d3), dim=axis,
                                   keepdim=True).to(torch.int32)])
    n_valid, n_line, nan_in = reduce_sum(local)
    n_all = torch.stack([n_valid] * 3 + [n_line])               # (4, 1|s, c|1)

    def keys_of(x3, x_plain):
        return torch.cat([_masked_keys(x3, m3), ordered_key(x_plain)[None]])

    med = _median_of_keys(keys_of(masked, d3), n_all, dim, reduce_sum,
                          reduce_min)
    centred = torch.where(m3, masked, masked - med[:3])
    nan = torch.full_like(med[3], float("nan"))
    centred3 = d3 - torch.where(nan_in > 0, nan, med[3])
    absc = torch.abs(centred3)
    nan_abs = reduce_any(torch.any(torch.isnan(absc), dim=axis,
                                   keepdim=True))
    mad = _median_of_keys(keys_of(torch.abs(centred), absc), n_all, dim,
                          reduce_sum, reduce_min)
    outs = [_masked_side(centred[i], mad[i], cell_mask, n_valid, thresh)
            for i in range(3)]
    outs.append(torch.abs(centred3 / torch.where(nan_abs, nan, mad[3]))
                * inverse_threshold(thresh, centred3))
    return tuple(outs)


def tree_combine_zap(diagnostics, cell_mask, orig_weights, chanthresh,
                     subintthresh, mesh):
    """The iteration's tail on this rank's shard: both orientations'
    :func:`tree_scaled_sides`, then the combine kernel on the shard (an
    elementwise max, 4-way median and zap).  Returns ``(new_weights,
    scores)``, bit-equal to the whole planes' K3 x 2 + combine."""
    with stage("icln_scores"):
        chan = tree_scaled_sides(diagnostics, cell_mask, 0, chanthresh, mesh)
        sub = tree_scaled_sides(diagnostics, cell_mask, 1, subintthresh,
                                mesh)
    with stage("icln_zap"):
        return combine_zap(chan, sub, orig_weights)


def sharded_scale_and_combine(mesh, diagnostics, orig_weights, chanthresh,
                              subintthresh):
    """The iteration's tail of the two_read route on a cell ``mesh``,
    the reference's gather-compute-slice: the four diagnostic planes and
    the original weights of every rank gathered into the whole (padded)
    planes on every rank (one all-gather of five planes), K3 in both
    orientations and the combine kernel on the whole planes, and this
    rank's block of the new weights and scores kept.  The cell mask is
    the gathered weights' zeros, so a pad cell is masked.  With one rank
    it is K3 and the combine on the rank's own planes.  Returns
    ``(new_weights, scores, d_std, cell_mask)``, the last two the whole
    planes the residual-std telemetry reads."""
    s, c = orig_weights.shape
    with stage("icln_scores"):
        whole = mesh.gather_cells(torch.stack([*diagnostics, orig_weights]))
        diags, weights = tuple(whole[:4]), whole[4]
        cell_mask = weights == 0
        chan = scaled_sides(diags, cell_mask, 0, chanthresh)
        sub = scaled_sides(diags, cell_mask, 1, subintthresh)
    with stage("icln_zap"):
        new_w, scores = combine_zap(chan, sub, weights)
    i, j = mesh.coords
    block = (slice(i * s, (i + 1) * s), slice(j * c, (j + 1) * c))
    return (new_w[block].contiguous(), scores[block].contiguous(),
            diags[0], cell_mask)


def sharded_weighted_marginals(mesh, disp, weights):
    """K1 on this rank's shard, then the sums its marginals need: the
    channel profiles ``A`` over the 'sub' subgroup, the subint totals
    ``t1`` over 'chan'.  Returns this rank's channels' ``A`` and subints'
    ``t1``."""
    a, t1 = weighted_marginals(disp, weights)
    return mesh.total(a, "sub"), mesh.total(t1, "chan")
