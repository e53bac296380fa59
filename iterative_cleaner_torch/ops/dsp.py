"""DSP primitives in torch: dispersion shifts, per-channel rotation of
(nchan, nbin) rows and of (nsub, nchan, nbin) cubes, the two baseline
preambles, the DEDISP=1 skip rule, and the template stage's algebra.

Each function mirrors the reference package's float32 route op for op
(``iterative_cleaner_tpu/ops/dsp.py``).  Rotations:

- fourier rows: the rFFT -> phase ramp -> irFFT decomposition as three
  small matmuls against cos/sin tables;
- fourier cubes: the per-channel (nbin, nbin) rotation operator applied
  as a batched matmul while the (nchan, nbin, nbin) operator tensor stays
  under the reference's ``_ROT_MATMUL_MAX_ELEMS``; above it,
  ``torch.fft.rfft``/``irfft``;
- roll: an exact gather (the reference's one-hot matmul selects the same
  elements).

Cubes are rotated in channel chunks, so the temporaries stay a bounded
slice of the cube.  These are plain products that the reference computes
outside any Pallas kernel.  Matmuls run in full float32 (TF32 is switched
off by :func:`iterative_cleaner_torch.backends.torch_backend.clean_cube`).

The template stage's functions also take a batch of equal-shaped
archives (``parallel/batch.py``): a leading dimension B on the weights
(B, nsub, nchan), the cubes, the channel profiles and the shifts (B,
nchan), each archive's sums its own.  Their elementwise ops take the
batch whole; their products and sums, whose kernels (cuBLAS's, the
reductions') are picked by the shape they are given and so add in an
order that may follow it, run archive by archive at one archive's
shapes (:func:`each_archive`): a batch's values are then bit-equal to
its archives' single cleans' on the card too.  On one archive they run
the same ops as before the batch existed.
"""

from __future__ import annotations

import math

import torch

from iterative_cleaner_torch.archive import KDM_S

# The reference's gate for the matmul rotation of cubes: the
# (nchan, nbin, nbin) operator tensor, in elements (512 MB of float32).
_ROT_MATMUL_MAX_ELEMS = 2 ** 27
# float32 bytes of one piece of a cube-sized product over subints
# (:func:`subint_chunks`)
UPCAST_CHUNK_BYTES = 256 * 2 ** 20
# Elements of the cube one channel chunk of a cube rotation covers
# (256 MB of float32): bounds each chunk's permuted copies.
_ROTATE_CHUNK_ELEMS = 2 ** 26


def dispersion_shift_bins(freqs_mhz, dm, ref_freq_mhz, period_s, nbin):
    """Per-channel dispersion shift in fractional pulse bins (positive
    below the reference frequency: dispersed data is rotated right by
    this much).  Tensors in, tensor out, at ``freqs_mhz``'s dtype."""
    delay_s = KDM_S * dm * (freqs_mhz ** -2.0 - ref_freq_mhz ** -2.0)
    return delay_s / period_s * nbin


def _rfft_tables(nbin: int, dtype, device):
    """(nbin, nbin//2+1) cos/sin tables of the row rotation, float32 as
    the reference builds them: angle = float32(2*pi/nbin) * b * k."""
    b = torch.arange(nbin, dtype=dtype, device=device)
    kf = torch.arange(nbin // 2 + 1, dtype=dtype, device=device)
    ang = (2.0 * math.pi / nbin) * torch.outer(b, kf)
    return torch.cos(ang), torch.sin(ang)


def each_archive(fn, ndim: int, *xs):
    """``fn(*xs)`` on one archive's tensors (the first with ``ndim``
    dimensions); on a batch's (one more, leading), ``fn`` on each
    archive's slices, stacked: a product or a sum then runs at one
    archive's shapes, as in that archive's single clean."""
    if xs[0].dim() == ndim:
        return fn(*xs)
    return torch.stack([fn(*(x[b] for x in xs))
                        for b in range(xs[0].shape[0])])


def trailing_sum(x, ndim: int):
    """The sum over the last ``ndim`` dimensions: ``torch.sum(x)`` (a
    0-d tensor) where those are all of ``x``'s, one archive; one such
    sum per archive of a batch otherwise (:func:`each_archive`)."""
    return each_archive(torch.sum, ndim, x)


def subint_chunks(nsub: int, nchan: int, nbin: int):
    """Slices of the subint axis of an (nsub, nchan, nbin) cube, at most
    :data:`UPCAST_CHUNK_BYTES` of float32 each: the pieces a cube-sized
    product reads, so that a bf16-stored cube is upcast a piece at a
    time (the reference's ``_acc`` convert, which XLA fuses into the
    product, would be a whole float32 copy of the cube in torch).  The
    pieces depend on the shape only, so a float32 cube and its bf16 twin
    run the same products."""
    per = max(1, UPCAST_CHUNK_BYTES // (4 * nchan * nbin))
    return [slice(s, min(s + per, nsub)) for s in range(0, nsub, per)]


def upcast_stored(t):
    """A cube in its arithmetic dtype: a bf16-stored one upcast to
    float32, a float32 or float64 one as it is."""
    return t.float() if t.dtype == torch.bfloat16 else t


def weighted_channel_sum(weights, cube):
    """``sum_c w[s, c] * cube[s, c, :]``, (nsub, nbin) per archive (as
    the reference groups it: per-subint (1, C) x (C, B) products); (B,
    nsub, nbin) for a batch.  A bf16-stored cube is upcast to float32 a
    :func:`subint_chunks` piece at a time; the products are float32 (or
    float64 for a float64 cube)."""
    def one(w, c):
        parts = [torch.einsum("sc,scb->sb", w[sl], upcast_stored(c[sl]))
                 for sl in subint_chunks(*c.shape)]
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    return each_archive(one, 2, weights, cube)


def _irfft_weights(nbin: int, device, dtype):
    """irfft reconstruction weights over k divided by n, in ``dtype``: DC
    and (even-n) Nyquist count once, the rest twice.  The reference forms
    them in float64 and rounds; 1/n and 2/n round once to the same float32
    either way (the binary expansion of 1/n has no run of zeros long
    enough for the float64 rounding to land on a float32 tie; checked for
    every n below 70,000), so a float32 route makes no float64 tensor."""
    k = torch.arange(nbin // 2 + 1, device=device)
    return torch.where((k == 0) | ((k == nbin // 2) & (nbin % 2 == 0)),
                       1.0, 2.0).to(dtype) / nbin


def _use_matmul_rotation(nchan: int, nbin: int, ndim: int, dtype) -> bool:
    """The reference's ``_use_matmul_rotation`` for the fourier method:
    float32 only, and the operator (rows: the two tables) within
    ``_ROT_MATMUL_MAX_ELEMS``."""
    if dtype != torch.float32:
        return False
    nk = nbin // 2 + 1
    if ndim == 2:
        elems = 2 * nbin * nk
    else:
        elems = max(nchan * nbin * nbin, nk * nbin * nbin)
    return elems <= _ROT_MATMUL_MAX_ELEMS


def _rotate_fft(x, s_chan):
    """Fourier rotation through ``torch.fft`` (the reference's path above
    the matmul gate): ``irfft(rfft(x) * exp(-2j*pi*k*s/nbin))``."""
    nbin = x.shape[-1]
    # k at x's dtype: the phase ramp is then complex128 for a float64 x
    # (an integer k would make it complex64, torch's default)
    k = torch.arange(nbin // 2 + 1, device=x.device, dtype=x.dtype)
    phase = torch.exp((-2j * math.pi) * k * s_chan[:, None] / nbin)
    spec = torch.fft.rfft(x, dim=-1)
    return torch.fft.irfft(spec * phase, n=nbin, dim=-1).to(x.dtype)


def _rotate_rows(x, s_chan, group=None):
    """(nchan, nbin) rows, each rotated by its own fourier shift;
    ``group``: the rows of one archive of a batch's B * nchan rows, each
    archive's products taken apart, at one archive's shapes."""
    nchan, nbin = x.shape
    if not _use_matmul_rotation(nchan, nbin, 2, x.dtype):
        return _rotate_fft(x, s_chan)
    dtype = x.dtype
    cos_bk, sin_bk = _rfft_tables(nbin, dtype, x.device)
    kf = torch.arange(nbin // 2 + 1, device=x.device).to(dtype)

    def mm(a, b):
        if group is None or group == a.shape[0]:
            return a @ b
        return torch.cat([a[r:r + group] @ b
                          for r in range(0, a.shape[0], group)])

    xr = mm(x, cos_bk)
    xi = -mm(x, sin_bk)
    theta = (2.0 * math.pi / nbin) * torch.outer(s_chan, kf)
    pr = torch.cos(theta)
    pi_ = -torch.sin(theta)
    xr_p = xr * pr - xi * pi_
    xi_p = xr * pi_ + xi * pr
    wk = _irfft_weights(nbin, x.device, dtype)[None, :]
    return mm(xr_p * wk, cos_bk.T) - mm(xi_p * wk, sin_bk.T)


def rotation_operators(s_chan, nbin: int):
    """(nchan, nbin, nbin) per-channel fourier rotation matrices,
    ``R_c[b, i] = (1/n) sum_k w_k cos(2*pi*k*(i - b - s_c)/n)``, built as
    the reference builds them: two products of (k, b, i) cos/sin tables
    with the per-channel phases."""
    dtype, dev = s_chan.dtype, s_chan.device
    nk = nbin // 2 + 1
    kf = torch.arange(nk, device=dev).to(dtype)
    b = torch.arange(nbin, dtype=dtype, device=dev)
    alpha = (2.0 * math.pi / nbin) * kf[:, None, None] * (
        b[None, None, :] - b[None, :, None])       # (k, b, i): i - b
    wk = _irfft_weights(nbin, dev, dtype)[:, None, None]
    cos_tab = (wk * torch.cos(alpha)).reshape(nk, nbin * nbin)
    sin_tab = (wk * torch.sin(alpha)).reshape(nk, nbin * nbin)
    theta = (2.0 * math.pi / nbin) * torch.outer(s_chan, kf)
    rot = torch.cos(theta) @ cos_tab + torch.sin(theta) @ sin_tab
    return rot.reshape(-1, nbin, nbin)


def rotate_bins(x, shift_bins, method="fourier"):
    """Circularly rotate profiles right by per-channel ``shift_bins``
    along the last axis: ``out[..., c, i] == x[..., c, (i - s_c) % nbin]``
    for integer shifts.  ``x`` is (nchan, nbin) rows or a (..., nchan,
    nbin) cube; the result is a new tensor.

    ``fourier``: fractional rotation through an rFFT phase ramp (the
    Nyquist bin of a fractionally rotated profile attenuates by
    cos(pi*s)); ``roll``: nearest-integer gather, exact.

    A batch's rows, (B, nchan, nbin) with (B, nchan) shifts (each
    archive its own), are rotated as B * nchan rows, each archive's
    products taken at one archive's shapes."""
    if method not in ("fourier", "roll"):
        raise ValueError(f"unknown rotation method {method!r}")
    if x.ndim < 2:
        raise ValueError(f"rotate_bins takes (..., nchan, nbin) profiles, "
                         f"got {tuple(x.shape)}")
    nchan, nbin = x.shape[-2:]
    if shift_bins.dim() == 2:
        if x.ndim != 3 or tuple(shift_bins.shape) != tuple(x.shape[:2]):
            raise ValueError(f"per-archive shifts {tuple(shift_bins.shape)} "
                             f"take (B, nchan, nbin) rows, got "
                             f"{tuple(x.shape)}")
        rows, shifts = x.reshape(-1, nbin), shift_bins.reshape(-1)
        if method == "roll":
            return rotate_bins(rows, shifts, method).reshape(x.shape)
        return _rotate_rows(rows, shifts.to(x.dtype),
                            group=nchan).reshape(x.shape)
    s_chan = torch.broadcast_to(shift_bins.to(x.dtype), (nchan,))
    if method == "roll":
        base = torch.arange(nbin, device=x.device)
        s = torch.round(s_chan).to(torch.int64)
        idx = torch.remainder(base[None, :] - s[:, None], nbin)
        return torch.gather(x, -1, idx.expand(x.shape))
    if x.ndim == 2:
        return _rotate_rows(x, s_chan)
    matmul = _use_matmul_rotation(nchan, nbin, 3, x.dtype)
    flat = x.reshape(-1, nchan, nbin)
    out = torch.empty_like(flat)
    step = max(1, _ROTATE_CHUNK_ELEMS // max(1, flat.shape[0] * nbin))
    for c0 in range(0, nchan, step):
        sl = slice(c0, c0 + step)
        out[:, sl] = (torch.einsum("ncb,cbi->nci", flat[:, sl],
                                   rotation_operators(s_chan[sl], nbin))
                      if matmul else _rotate_fft(flat[:, sl], s_chan[sl]))
    return out.reshape(x.shape)


def tree_sum(x):
    """The sum over the last axis by a fixed binary tree of elementwise
    adds: zero-padded to a power of two, then halved (``x[:h] + x[h:]``)
    until one value is left.  Elementwise IEEE adds round alike on every
    device, and the tree depends on the axis's length alone, so the sums
    are bit-equal on the CPU and the card, whatever the other dimensions
    (a tile's, a shard's or a batch's rows give the whole archive's
    bits); pairwise, they lie within about log2(n) roundings of the exact
    sum where a running float32 sum drifts by n."""
    n = x.shape[-1]
    p = 1 << max(0, n - 1).bit_length()
    if p != n:
        x = torch.cat([x, x.new_zeros(x.shape[:-1] + (p - n,))], dim=-1)
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def _window_sums_doubling(profiles, w: int):
    """The ``[c, c + w)`` circular window sums by doubling: ``s_k[c]``,
    the sum of the ``2^k`` bins from ``c``, is ``s_(k-1)[c] + s_(k-1)[c +
    2^(k-1)]``, and each window is the sum of the ``s_k`` of ``w``'s set
    bits, lowest first, each from where the last ends (zeros where ``w``
    is 0).  Elementwise adds in an order fixed by ``w`` alone (see
    :func:`tree_sum`); no running sum whose differences cancel."""
    acc, s, off, k = None, profiles, 0, 0
    while w >> k:
        if (w >> k) & 1:
            piece = torch.roll(s, -off, dims=-1) if off else s
            acc = piece if acc is None else acc + piece
            off += 1 << k
        if w >> (k + 1):
            s = s + torch.roll(s, -(1 << k), dims=-1)
        k += 1
    return torch.zeros_like(profiles) if acc is None else acc


# Bins a block of the fixed-order window sums (:func:`_block_windows`)
_WINDOW_BLOCK = 16


def _block_windows(rows, w: int):
    """The ``[c, c + w)`` circular window sums of ``rows`` (..., n) in a
    fixed order, as B tensors (..., n / B): the r-th holds the windows at
    c = q B + r.  B is the largest power of two dividing n, at most
    _WINDOW_BLOCK and a quarter of w (a block's prefix sums, whose
    differences the windows take, then stay under a quarter of the
    window's sum; B = 1, the doubling over the bins, for the shortest
    windows).  With w = a B + b, the window at c = q B + r is the sum of
    the m whole blocks from block q (m = a, or a + 1 where r + b >= B),
    less the bins of block q before c, plus the bins of block q + m before
    c + w: each block's prefix sums by a running sum over its B bins, the
    m-block sums by :func:`_window_sums_doubling` over the block sums,
    then one subtraction and one add a window.  Elementwise adds in an
    order fixed by n and w alone (the same bits on the CPU and the card,
    whatever the other dimensions); about six passes over the rows where
    the doubling over the bins takes 2 (log2 w + popcount w): the profile
    baseline's offsets over the whole cube (:func:`baseline_offsets`) in
    28.5 ms against 90.5 ms at 32 x 256 x 65536 on an H100
    (tools/time_baselines.py, PERF.md §6)."""
    n = rows.shape[-1]
    bs = min(_WINDOW_BLOCK, n & -n, 1 << (max(1, w // 4).bit_length() - 1))
    a, b = divmod(w, bs)
    # (B, ..., n / B): bin r of every block is one contiguous plane
    xt = rows.reshape(rows.shape[:-1] + (n // bs, bs)).movedim(-1, 0) \
        .contiguous()
    pre = torch.empty_like(xt)      # each block's bins before bin r
    pre[0].zero_()
    for r in range(1, bs):
        torch.add(pre[r - 1], xt[r - 1], out=pre[r])
    blocks = pre[bs - 1] + xt[bs - 1]
    fa = _window_sums_doubling(blocks, a)
    fa1 = fa + torch.roll(blocks, -a, dims=-1)
    out = []
    for r in range(bs):
        carry = r + b >= bs
        m = a + carry
        out.append((fa1 if carry else fa) - pre[r]
                   + torch.roll(pre[r + b - bs * carry], -m, dims=-1))
    return out


def fixed_order_windows(profiles) -> bool:
    """Whether the baselines sum their windows in a fixed order of
    elementwise adds (:func:`tree_sum`, :func:`_window_sums_doubling`,
    :func:`_block_windows`): float32 profiles past 1024 bins.  There a
    float32 sum over the row in the library's order (the integration
    offsets' contraction, the profile baseline's cumulative sum, whose
    differences cancel) lay up to 1e-5 of the offsets' scale from float64
    on the card; at 1024 bins and below (the reference's circulant-matmul
    range) and in float64 the library's sums are kept, as the reference
    computes them."""
    return profiles.shape[-1] > 1024 and profiles.dtype != torch.float64


def window_means(sums, w: int, profiles):
    """``sums / w``, window sums of ``profiles``' bins: in the fixed-order
    form (:func:`fixed_order_windows`) divided by ``w`` as a tensor on the
    sums' device, a true division on every device (a CUDA kernel
    multiplies by the reciprocal of a host scalar), so the means keep the
    sums' agreement between the CPU and the card; else by the scalar, as
    the reference divides."""
    return sums / (sums.new_full((), w) if fixed_order_windows(profiles)
                   else w)


def circular_window_sums(profiles, w: int, centred=False):
    """Sliding circular window sums along the last axis.  ``centred=
    False``: the window at ``c`` covers ``[c, c+w)``; ``centred=True``:
    ``[c - w//2, c - w//2 + w)``.  float32 with nbin <= 1024: one 0/1
    circulant matmul (the reference's float32 form); float32 past that:
    :func:`_window_sums_doubling` (a total profile's or a template's rows:
    fewer launches than :func:`_block_windows`), the same bits on the CPU
    and the card; float64: the reference's cumulative-sum form."""
    nbin = profiles.shape[-1]
    shift = (w // 2) if centred else 0
    if nbin <= 1024 and profiles.dtype == torch.float32:
        j = torch.arange(nbin, device=profiles.device)
        box = (torch.remainder(j[:, None] - j[None, :] + shift, nbin)
               < w).to(profiles.dtype)
        return profiles @ box
    if fixed_order_windows(profiles):
        sums = _window_sums_doubling(profiles, w)
    else:
        ext = torch.cat([profiles, profiles[..., : w - 1]], dim=-1) \
            if w > 1 else profiles
        cs = torch.cumsum(ext, dim=-1)
        cz = torch.cat([torch.zeros_like(cs[..., :1]), cs], dim=-1)
        sums = cz[..., w: w + nbin] - cz[..., :nbin]
    return torch.roll(sums, shift, dims=-1) if shift else sums


def baseline_offsets(profiles, duty=0.15):
    """Per-profile baseline level of ``baseline_mode='profile'``: the
    mean of the ``round(duty * nbin)``-bin circular window with the
    smallest mean.  In the fixed-order form by :func:`_block_windows`, a
    piece of profiles at a time (:data:`_ROTATE_CHUNK_ELEMS` each), so
    that its temporaries stay a
    few pieces' and not a few cubes'; each profile's sums are its own,
    so the pieces change no bit."""
    from iterative_cleaner_torch.ops.psrchive_baseline import window_width

    nbin = profiles.shape[-1]
    w = window_width(nbin, duty)
    if not fixed_order_windows(profiles):
        return window_means(torch.min(circular_window_sums(profiles, w),
                                      dim=-1).values, w, profiles)
    rows = profiles.reshape(-1, nbin)
    step = max(1, _ROTATE_CHUNK_ELEMS // nbin)
    mins = []
    for r in range(0, rows.shape[0], step):
        parts = [p.amin(dim=-1) for p in _block_windows(rows[r: r + step], w)]
        mins.append(torch.stack(parts).amin(dim=0))
    return window_means(torch.cat(mins).reshape(profiles.shape[:-1]), w,
                        profiles)


def remove_baseline(profiles, duty=0.15):
    """Subtract each profile's :func:`baseline_offsets` level, IN PLACE
    (the callers hand over a freshly uploaded cube); returns it."""
    return profiles.sub_(baseline_offsets(profiles, duty)[..., None])


def prepare_cube_integration(cube, weights, freqs_mhz, dm, ref_freq_mhz,
                             period_s, *, baseline_duty, rotation,
                             dedispersed=False, with_ded=True, mesh=None):
    """Integration-baseline preamble.

    Returns ``(ded, back_shifts, disp_clean, base_offsets)``.
    ``disp_clean`` is ``cube - offsets`` in the archive's own frame,
    computed IN PLACE in ``cube`` (the caller uploads the cube for this
    purpose).  ``ded`` is its rotation into the dedispersed frame — a new
    cube — or ``disp_clean`` itself for a DEDISP=1 input (the state-aware
    dedispersion no-ops; the back-shifts stay unchanged).  ``with_ded=
    False`` skips the rotation (``ded`` is None): the default route never
    reads it.  On a cell ``mesh`` the arguments are a rank's shard and its
    channels' frequencies; only the baseline window's total profile
    crosses ranks."""
    from iterative_cleaner_torch.ops.psrchive_baseline import (
        baseline_offsets_integration,
    )

    nbin = cube.shape[-1]
    shifts = dispersion_shift_bins(freqs_mhz.to(cube.dtype), dm,
                                   ref_freq_mhz, period_s, nbin)
    offsets = baseline_offsets_integration(cube, weights.to(cube.dtype),
                                           baseline_duty, mesh)
    disp_clean = cube.sub_(offsets[..., None])
    ded = None
    if with_ded:
        ded = disp_clean if dedispersed else rotate_bins(
            disp_clean, -shifts, method=rotation)
    return ded, shifts, disp_clean, offsets


def prepare_cube_with_correction(cube, weights, freqs_mhz, dm, ref_freq_mhz,
                                 period_s, *, baseline_duty, rotation,
                                 dedispersed=False, baseline_mode="profile",
                                 mesh=None):
    """Cleaning preamble: baseline removal (in place in ``cube``), then
    the forward dedispersion, skipped for a DEDISP=1 input (the
    back-shifts stay unchanged).  Returns ``(ded_cube, back_shifts,
    baseline_corr)``, where ``baseline_corr`` is the ``(disp_clean,
    base_offsets, duty)`` triple of the integration mode's per-iteration
    template correction and None under the profile mode.  ``mesh``: as
    :func:`prepare_cube_integration` (the profile baseline is
    cell-local)."""
    if baseline_mode == "integration":
        ded, shifts, disp_clean, offsets = prepare_cube_integration(
            cube, weights, freqs_mhz, dm, ref_freq_mhz, period_s,
            baseline_duty=baseline_duty, rotation=rotation,
            dedispersed=dedispersed, mesh=mesh)
        return ded, shifts, (disp_clean, offsets, baseline_duty)
    if baseline_mode != "profile":
        raise ValueError(f"unknown baseline mode {baseline_mode!r}")
    shifts = dispersion_shift_bins(freqs_mhz.to(cube.dtype), dm,
                                   ref_freq_mhz, period_s, cube.shape[-1])
    ded = remove_baseline(cube, baseline_duty)
    if not dedispersed:
        ded = rotate_bins(ded, -shifts, method=rotation)
    return ded, shifts, None


def weighted_marginal_totals(disp, weights):
    """Both weighted marginals of the dispersed cube:
    ``A[c, b] = sum_s w[s, c] * disp[s, c, b]`` and
    ``t1[s, b] = sum_c w[s, c] * disp[s, c, b]``.

    The plain version of kernel K1
    (:func:`iterative_cleaner_torch.stats.kernels.weighted_marginals`):
    products first, then the two sums, as the TPU kernel forms them."""
    wx = disp * weights[:, :, None]
    return wx.sum(dim=0), wx.sum(dim=1)


def template_numerator_from_channel_profiles(a, back_shifts, rotation,
                                             mesh=None):
    """Template numerator ``sum_c rot_c^{-1}(A[c])``: the dedispersion
    rotation applied to the (nchan, nbin) channel profiles instead of
    the cube (rotation is linear, weighting bin-independent).  On a cell
    ``mesh``, ``a`` holds the rank's channels and the sum crosses its
    row."""
    num = each_archive(lambda r: r.sum(dim=-2), 2,
                       rotate_bins(a, -back_shifts, method=rotation))
    return num if mesh is None else mesh.total(num, "chan")


def weighted_template_numerator(cube, weights):
    """The un-normalised weighted profile sum over all (subint, channel)
    cells, grouped as the reference groups it: per-subint (1, C) x (C, B)
    products, then the sum over subints.  Exact streaming accumulates it
    per subint tile on the routes other than the default."""
    return each_archive(lambda t: t.sum(dim=-2), 2,
                        weighted_channel_sum(weights, cube))


def weighted_template(cube, weights, mesh=None):
    """Weighted mean profile over all (subint, channel) cells; an
    all-zero weight matrix gives the zero template.  On a cell ``mesh``
    both sums run over every rank's shard."""
    num = weighted_template_numerator(cube, weights)
    den = trailing_sum(weights, 2)
    if mesh is not None:
        num, den = mesh.total(num, "all"), mesh.total(den, "all")
    den = den[..., None]
    safe = torch.where(den == 0, torch.ones_like(den), den)
    return torch.where(den == 0, torch.zeros_like(num), num / safe)


def fit_template_amplitudes(cube, template):
    """Closed-form least-squares amplitude of ``template`` in every
    profile: ``<template, prof> / <template, template>``; an all-zero
    template gives 1.0 (the reference fit's initial guess)."""
    tt = torch.sum(template * template)
    tp = torch.einsum("scb,b->sc", cube, template)
    safe_tt = torch.where(tt == 0, torch.ones_like(tt), tt)
    return torch.where(tt == 0, torch.ones_like(tp), tp / safe_tt)


def fit_template_amplitudes_disp(disp, rot_t, template):
    """Closed-form template amplitudes in the dispersed frame:
    ``amp = <disp, rot_t_c> / <t, t>``; an all-zero template gives 1.0
    (the reference fit's initial guess)."""
    tt = torch.sum(template * template)
    tp = torch.einsum("scb,cb->sc", disp, rot_t)
    safe_tt = torch.where(tt == 0, torch.ones_like(tt), tt)
    return torch.where(tt == 0, torch.ones_like(tp), tp / safe_tt)


def template_residuals(cube, template, amps, pulse_slice, pulse_scale,
                       apply_pulse_region):
    """``amp * template - prof`` per cell (the reference's sign), with
    the bins ``[start, end)`` scaled by ``pulse_scale`` when the pulse
    region is active.  A new tensor."""
    resid = amps[..., None] * template - cube
    if apply_pulse_region:
        start, end = pulse_slice
        resid[..., start:end] *= pulse_scale
    return resid
