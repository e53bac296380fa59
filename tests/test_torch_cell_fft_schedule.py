"""The FFT build's schedule (``stats/csrc/cell_fft.cu``, K2f) on the CPU: a
numpy model of the kernel's index maps, run on the twiddle tables the
wrapper builds (``stats.kernels._fft_twiddles``), held to
``np.fft.rfft``.

The model follows the kernel loop by loop: the row as Q complex values a
block, value a at the swizzled slot ``a ^ ((a >> S) & (2^S - 1))``; on a
cluster the first log2 C stages as one C-point step over the blocks'
slices; the block's local passes of 8 points (and, as the schedule takes
them, of 16 and of 4), the first taking the remainder, each group's
registers loaded at stride P 2^lx, run through the in-register
butterflies and multiplied by ``W_M^(i brev(k))`` (the group's powers of
two from the two-level table, itself swizzled in shared memory with its
high part padded, the other powers their products); the radix-P stage;
and the split, a pair (k, N/2 - k) at a time, each pair's first position
and its partner's block and slot by the kernel's own bit reversals.
Every rfft bin must come out exactly once, within 1e-10 of the
spectrum's scale with the float64 table; the swizzle is a bijection on
every slice and no table index runs past the table. Run at N from 64 to
65,536 bins for odd parts 1, 3 and 5 and the kernel's clusters of 2, 4
and 8 blocks, both dtypes' swizzle runs; and once in complex64 with the float32
table at the long-profile shape, within 1e-6 of the spectrum's scale
(the float32 build's accuracy; numpy does not fuse its multiplies as the
kernel does).  Since odd parts 3^a 5^b take several radix-5 and radix-3
stages (radix 5 while the span holds a factor 5), the model runs them at
odd parts 9 to 1875 too, their digit-reversed order through the split.

K2g (``stats/csrc/cell_fft_global.cu``), the FFT build through device
memory, has a model of its own: the plan's passes (``cell_fft_global_plan``)
over (span, point, column) views of each row, each pass's DFT in the
kernel's stages of radix 5, 3, 4 and 2 with their own forms and twiddles
from the two-level table, output in natural order, so that the passes
leave X[f] at the position the passes' digits give (checked against
np.fft.fft permuted, and the inverse passes against n x); the chirp with
j^2 mod 2N in int64; B^ in the passes' order; the real split of a split
row (each rfft bin once) and Bluestein's max.  At 16,411, 20,001 (odd),
28,672, 65,521 and 524,288 bins within 1e-10 of the spectrum's scale in
float64 (measured: under 5e-16), and in complex64 on the float32 tables
within 1e-6 (measured: at most 1.3e-7).
"""

import numpy as np
import pytest
import torch

from iterative_cleaner_torch.stats import kernels as tk

# W_16^m, the in-register butterflies' constant twiddles
W16 = np.exp(-2j * np.pi * np.arange(8) / 16)


def _swz(a, s):
    return a ^ ((a >> s) & ((1 << s) - 1))


def _brev(k, bits):
    k = np.asarray(k, dtype=np.int64)
    r = np.zeros_like(k)
    for i in range(bits):
        r |= ((k >> i) & 1) << (bits - 1 - i)
    return r


def _odd(n):
    while n % 2 == 0:
        n //= 2
    return n


def _odd_radix(sp):
    """The odd stage's radix at span sp: 5 while sp holds a factor 5."""
    return 5 if sp % 5 == 0 else 3


def _odd_freq(p, t):
    """The odd stages' order: position t of a group of p holds the p-point
    DFT's output f (the digits of t in the stages' radices, reversed)."""
    t = np.asarray(t, dtype=np.int64).copy()
    f, mult, sp = np.zeros_like(t), 1, p
    while sp > 1:
        r = _odd_radix(sp)
        d = sp // r
        digit = t // d
        t = t - digit * d
        f = f + digit * mult
        mult *= r
        sp = d
    return np.asarray(f, dtype=np.int64)


def _odd_pos(p, f):
    """The inverse of :func:`_odd_freq`."""
    f = np.asarray(f, dtype=np.int64).copy()
    t, sp = np.zeros_like(f), p
    while sp > 1:
        r = _odd_radix(sp)
        d = sp // r
        t = t + (f % r) * d
        f = f // r
        sp = d
    return np.asarray(t, dtype=np.int64)


class _Table:
    """The wrapper's two-level table as the kernel holds it in shared
    memory: the low part, then the high part padded to a whole run of the
    swizzle (``_fft_table_slots``), each entry at its index's swizzled
    slot (runs of 8 for float64 entries, 16 for float32); records the
    largest index read."""

    def __init__(self, nbin, dtype):
        t = tk._fft_twiddles(nbin, "cpu", dtype).numpy()
        c = t[:, 0] + 1j * t[:, 1]
        self.lt = tk._fft_table_lt(nbin)
        self.s = 3 if dtype == torch.float64 else 4
        lo_n = 1 << self.lt
        hi_n = tk._fft_table_slots(nbin) - lo_n
        self.lo = np.full(lo_n, np.nan + 0j)
        self.hi = np.full(hi_n, np.nan + 0j)
        self.lo[_swz(np.arange(lo_n), self.s)] = c[:lo_n]
        self.hi[_swz(np.arange(len(c) - lo_n), self.s)] = c[lo_n:]
        self.c, self.top = c, -1

    def __call__(self, e):
        e = np.asarray(e, dtype=np.int64)
        hi = e >> self.lt
        self.top = max(self.top, (1 << self.lt) + int(np.max(hi, initial=0)))
        return (self.hi[_swz(hi, self.s)]
                * self.lo[_swz(e & ((1 << self.lt) - 1), self.s)])


def _powers(tw, levels, e1):
    """w[m] = W^(m e1), m < 2^levels, as a group takes them: the powers
    of two from the table, every other m the product of its highest
    power of two and the rest."""
    w = {}
    for m in range(1, 1 << levels):
        h = 1 << (m.bit_length() - 1)
        w[m] = tw(m * e1) if h == m else w[h] * w[m - h]
    return w


def _dif_regs(r):
    """The 2^r-point DIF butterflies on the last axis, in place: register
    k ends as output brev(k)."""
    n = r.shape[-1]
    h = n // 2
    while h >= 1:
        for k in range(n):
            if k & h:
                continue
            a, b = r[..., k].copy(), r[..., k + h].copy()
            r[..., k] = a + b
            r[..., k + h] = (a - b) * W16[(k & (h - 1)) * (8 // h)]
        h //= 2


def _layout(m, cluster):
    """(P, lm, lc, lq, Q) of a transform of m = P 2^lm complex points on a
    cluster of ``cluster`` blocks: Q = P 2^lq values a block."""
    p = _odd(m)
    lm = (m // p).bit_length() - 1
    lc = cluster.bit_length() - 1
    lq = lm - lc
    return p, lm, lc, lq, p << lq


def model_forward(z, cluster, s, tw, cdtype=np.complex128, lr_max=3):
    """The kernel's forward transform of the complex row ``z`` (m = P
    2^lm points; ``tw`` the table of W_(2m)) as it runs it: the
    cross-cluster step, the local passes, the odd stages; returns the
    blocks' shared memory (cluster, padded slice) in the swizzled
    layout."""
    p, lm, lc, lq, q = _layout(len(z), cluster)
    z = np.asarray(z).astype(cdtype)
    run = 1 << s        # the slice padded to a whole run of the swizzle
    qpad = -(-q // run) * run
    slots = _swz(np.arange(q), s)
    assert len(set(slots.tolist())) == q and slots.max() < qpad, "swizzle"
    mem = np.zeros((cluster, qpad), dtype=cdtype)
    for r in range(cluster):
        mem[r, slots] = z[r * q:(r + 1) * q]
    j = np.arange(q)     # the cross-cluster step
    sj = _swz(j, s)
    regs = mem[:, sj].T.copy()
    _dif_regs(regs)
    w = _powers(tw, lc, j << 1)
    for k in range(1, cluster):
        regs[:, k] *= w[int(_brev(k, lc))]
    mem[:, sj] = regs.T
    mu, lr = lq, (lq % lr_max or lr_max)
    while mu > 0:        # the local passes
        lx, sh = mu - lr, lm + 1 - mu
        lg = lq - lr
        g = np.arange(p << lg)
        v, rest = g >> lg, g & ((1 << lg) - 1)
        iu = rest & ((1 << lx) - 1)
        u0 = ((rest >> lx) << (lx + lr)) + iu
        i = iu * p + v
        at = np.stack([_swz((u0 + (k << lx)) * p + v, s)
                       for k in range(1 << lr)], axis=1)
        w = _powers(tw, lr, i << sh)
        for r in range(cluster):
            regs = mem[r][at]
            _dif_regs(regs)
            for k in range(1, 1 << lr):   # (unit twiddles where i is 0)
                regs[:, k] *= np.where(i == 0, 1, w[int(_brev(k, lr))])
            mem[r][at] = regs
        mu -= lr
        lr = lr_max
    sp = p               # the odd stages: radix 5, then 3
    while sp > 1:
        rad = _odd_radix(sp)
        d, nsp = sp // rad, (2 << lm) * (p // sp)
        w = tw(np.arange(rad) * (nsp * d))       # W_rad^v = W_N^(v N / rad)
        per = p // rad
        idx = np.arange(per << lq)
        grp, rr = idx // per, idx % per
        j = rr % d
        base = grp * p + (rr // d) * sp + j
        for r in range(cluster):
            regs = np.stack([mem[r][_swz(base + u * d, s)]
                             for u in range(rad)], 1)
            for t in range(rad):
                acc = regs[:, 0].copy()
                for u in range(1, rad):
                    acc = acc + regs[:, u] * w[(u * t) % rad]
                if t:            # W_sp^(j t) = W_N^(j t N / sp)
                    acc = acc * np.where(j != 0, tw(j * t * nsp), 1)
                mem[r][_swz(base + t * d, s)] = acc
        sp = d
    return mem


def model_rfft(x, cluster, s, tw, cdtype=np.complex128, lr_max=3):
    """The kernel's schedule on the real row ``x`` (swizzle runs of 2^s,
    local passes of 2^lr_max points): returns the rfft bins 0 .. N/2 as
    the split writes them (each checked to come once)."""
    n = len(x)
    half = n // 2
    p, lm, lc, lq, q = _layout(half, cluster)
    mem = model_forward(x[0::2] + 1j * x[1::2], cluster, s, tw, cdtype,
                        lr_max)
    out = np.full(half + 1, np.nan + 0j)
    seen = np.zeros(half + 1, dtype=int)
    even = 1 << (lq - 1)
    idx = np.arange(even + 1 if p == 1 else p << lq)
    t = np.zeros_like(idx) if p == 1 else idx >> lq
    sl = (np.where(idx < even, 2 * idx, 1) if p == 1
          else idx & ((1 << lq) - 1))
    for rank in range(cluster):  # the split, a pair (k, N/2 - k) at a time
        sg = (rank << lq) + sl
        kk = _brev(sg, lm) + (_odd_freq(p, t) << lm)
        kp = np.where(kk == 0, 0, half - kk)
        first = kk <= kp
        kk, kp, t1, s1 = kk[first], kp[first], t[first], sl[first]
        sp = _brev(kp & ((1 << lm) - 1), lm)
        a = mem[rank][_swz(s1 * p + t1, s)]
        b = mem[sp >> lq, _swz((sp & ((1 << lq) - 1)) * p
                               + _odd_pos(p, kp >> lm), s)]
        w = tw(kk)
        out[kk] = 0.5 * (a + np.conj(b)) - 0.5j * w * (a - np.conj(b))
        np.add.at(seen, kk, 1)
        two = kp != kk     # X[N/2 - k], W^(N/2 - k) = -conj W^k
        wp = -np.conj(w[two])
        bb, aa = b[two], a[two]
        out[kp[two]] = (0.5 * (bb + np.conj(aa))
                        - 0.5j * wp * (bb - np.conj(aa)))
        np.add.at(seen, kp[two], 1)
        zero = kk == 0   # X[N/2] = Re Z[0] - Im Z[0]
        if zero.any():
            out[half] = (a.real - a.imag)[zero][0]
            seen[half] += int(zero.sum())
    assert np.array_equal(seen, np.ones(half + 1)), "each bin once"
    return out


def _row(n, seed):
    rng = np.random.default_rng(seed)
    ph = np.arange(n)
    return rng.standard_normal(n) + 3.0 * np.exp(
        -0.5 * ((ph - n / 3) / (n / 64)) ** 2)


SHAPES = [(p << a) for p in (1, 3, 5) for a in range(5, 17)
          if 64 <= (p << a) <= 65536]


@pytest.mark.parametrize("cluster", tk.FFT_CLUSTER_SIZES)
@pytest.mark.parametrize("nbin", SHAPES)
def test_schedule_matches_rfft(nbin, cluster):
    x = _row(nbin, nbin % 97)
    want = np.fft.rfft(x)
    scale = np.abs(want).max()
    tw = _Table(nbin, torch.float64)
    for s in (4, 3):  # float32's and float64's swizzle runs
        got = model_rfft(x, cluster, s, tw)
        assert np.abs(got - want).max() <= 1e-10 * scale
    # passes of 16 and of 4 points too (the schedule takes any radix)
    for lr_max in (4, 2):
        got = model_rfft(x, cluster, 4, tw, lr_max=lr_max)
        assert np.abs(got - want).max() <= 1e-10 * scale
    assert tw.top < len(tw.c)


# odd parts 3^a 5^b of several stages (K2f's mixed radix-3/5 stages), at
# the lengths whose clusters the plan can take: 2^a x P with a from 3
ODD_SHAPES = [(p << a, c) for p in (9, 15, 25, 45, 75, 625, 1875)
              for a in (3, 5) for c in tk.FFT_CLUSTER_SIZES
              if (1 << (a - 1)) % (2 * c) == 0]


@pytest.mark.parametrize("nbin,cluster", ODD_SHAPES)
def test_mixed_odd_schedule_matches_rfft(nbin, cluster):
    x = _row(nbin, nbin % 89)
    want = np.fft.rfft(x)
    scale = np.abs(want).max()
    tw = _Table(nbin, torch.float64)
    for s in (4, 3):
        got = model_rfft(x, cluster, s, tw)
        assert np.abs(got - want).max() <= 1e-10 * scale
    assert tw.top < len(tw.c)


def test_odd_stage_orders_are_inverse():
    for p in (1, 3, 5, 9, 15, 25, 45, 75, 625, 1875):
        t = np.arange(p)
        f = _odd_freq(p, t)
        assert np.array_equal(np.sort(f), t)
        assert np.array_equal(_odd_pos(p, f), t)


def test_float32_schedule_accuracy():
    """The long-profile shape in complex64 on the float32 table: the
    max |X| the kernel reports within 1e-6 of its float64 value."""
    x = _row(65536, 3).astype(np.float32)
    want = np.abs(np.fft.rfft(x.astype(np.float64)))
    got = np.abs(model_rfft(x, 8, 4, _Table(65536, torch.float32),
                            np.complex64))
    assert abs(got.max() - want.max()) <= 1e-6 * want.max()
    assert np.abs(got - want).max() <= 1e-6 * want.max()


@pytest.mark.parametrize("nbin", [20480, 32768, 49152, 65536, 262144,
                                  393216])
def test_twiddle_table(nbin):
    """W_N^e = hi[e >> lt] * lo[e & (T - 1)] for every e < N, the table
    T + ceil(N / T) entries."""
    tw = _Table(nbin, torch.float64)
    assert len(tw.c) == tk._fft_table_len(nbin)
    e = np.arange(nbin)
    assert np.abs(tw(e) - np.exp(-2j * np.pi * e / nbin)).max() < 1e-14
    assert tw.top == len(tw.c) - 1


# ------------------------------------------------------------------------
# K2g (stats/csrc/cell_fft_global.cu): the passes through device memory,
# the chirp, B^ in the passes' order, the real split and the max
# ------------------------------------------------------------------------

# the constants of the kernel's radix-3 and radix-5 DFTs
_C3 = (-0.5, 0.86602540378443865)
_C5 = (0.30901699437494742, -0.80901699437494742, 0.95105651629515357,
       0.58778525229247313)


def _g_radix(sp):
    """The stages' radix at span sp: 5, then 3, then 4, then 2."""
    return 5 if sp % 5 == 0 else 3 if sp % 3 == 0 else 4 if sp % 4 == 0 \
        else 2


def _g_pos(f, q):
    """Where output q of an F-point DFT lies after the stages."""
    q, t, sp = np.asarray(q, dtype=np.int64).copy(), 0, f
    while sp > 1:
        r = _g_radix(sp)
        d = sp // r
        t = t + (q % r) * d
        q = q // r
        sp = d
    return t


def _mi(a, inv):
    """-i a, or i a where inv."""
    return 1j * a if inv else -1j * a


def _g_dft(v, inv):
    """The kernel's P-point DFT of v (a list of P arrays), P = 2, 3, 4, 5:
    its own forms, conjugate twiddles where inv."""
    p = len(v)
    if p == 2:
        return [v[0] + v[1], v[0] - v[1]]
    if p == 4:
        a, b = v[0] + v[2], v[0] - v[2]
        c, d = v[1] + v[3], _mi(v[1] - v[3], inv)
        return [a + c, b + d, a - c, b - d]
    if p == 3:
        a, b = v[1] + v[2], v[1] - v[2]
        m, q = v[0] + _C3[0] * a, _mi(_C3[1] * b, inv)
        return [v[0] + a, m + q, m - q]
    c1, c2, s1, s2 = _C5
    a1, b1, a2, b2 = v[1] + v[4], v[1] - v[4], v[2] + v[3], v[2] - v[3]
    m1, m2 = v[0] + c1 * a1 + c2 * a2, v[0] + c2 * a1 + c1 * a2
    q1, q2 = _mi(s1 * b1 + s2 * b2, inv), _mi(s2 * b1 - s1 * b2, inv)
    return [v[0] + (a1 + a2), m1 + q1, m2 + q2, m2 - q2, m1 - q1]


class _GTable:
    """K2g's two-level table of W_tab (kernels._fft_twiddles(tab)), read
    as W_n^e = W_tab^(e mul), mul = tab / n."""

    def __init__(self, tab, n, dtype):
        t = tk._fft_twiddles(tab, "cpu", dtype).numpy()
        self.c = t[:, 0] + 1j * t[:, 1]
        self.lt, self.mul, self.tab = tk._fft_table_lt(tab), tab // n, tab

    def __call__(self, e, conj=False):
        x = np.asarray(e, dtype=np.int64) * self.mul
        assert x.min(initial=0) >= 0 and x.max(initial=0) < self.tab
        w = self.c[(1 << self.lt) + (x >> self.lt)] \
            * self.c[x & ((1 << self.lt) - 1)]
        return np.conj(w) if conj else w


def _g_wf(f, cdtype):
    """The pass's table of W_f, as the wrapper builds it (float64 on the
    host, rounded to the arithmetic dtype)."""
    real = torch.float64 if cdtype == np.complex128 else torch.float32
    wf, perm = tk._fftg_pass_tables((f,), "cpu", real)
    assert np.array_equal(perm.numpy(), _g_pos(f, np.arange(f)))
    wf = wf.numpy()
    return (wf[:, 0] + 1j * wf[:, 1]).astype(cdtype)


def g_pass(z, n, f, s, tw, inv=False, mul=None):
    """One pass of f points at stride s on the rows z (..., n), in place,
    as the pass kernel runs it: the (span, m, column) view of each row,
    the stages over m (their twiddles from the pass's table of W_f),
    output q in natural order times W_(f s)^(c q) (forward), or the load
    times B^ and conj W_(f s)^(c m) (inverse)."""
    wf = _g_wf(f, z.dtype.type)
    lead = z.shape[:-1]
    t = z.reshape(lead + (n // (f * s), f, s)).copy()
    c = np.arange(s)
    m = np.arange(f)[:, None]
    ts = n // (f * s)
    if inv:
        if mul is not None:
            t = t * mul.reshape(n // (f * s), f, s)
        t = t * np.where(c * m == 0, 1, tw(c * m * ts, conj=True))
    sp = f
    while sp > 1:
        r = _g_radix(sp)
        d = sp // r
        u = t.reshape(lead + (n // (f * s), f // sp, r, d, s))
        y = _g_dft([u[..., k, :, :] for k in range(r)], inv)
        j = np.arange(d)[:, None]
        for q in range(1, r):
            w = wf[j * q * (f // sp)]
            y[q] = y[q] * np.where(j == 0, 1, np.conj(w) if inv else w)
        t = np.stack(y, axis=-3).reshape(t.shape)
        sp = d
    t = t[..., _g_pos(f, np.arange(f)), :]
    if not inv:
        t = t * np.where(c * m == 0, 1, tw(c * m * ts))
    z[...] = t.reshape(z.shape)


def g_passes(z, plan, tw, inv=False, mul=None):
    """The plan's passes on the rows z: forward 1 .. k, or inverse k .. 1
    (the first of them times ``mul``)."""
    n, strides, s = plan.n, [], plan.n
    for f in plan.passes:
        s //= f
        strides.append(s)
    order = range(len(plan.passes))
    for i, j in enumerate(reversed(order) if inv else order):
        g_pass(z, n, plan.passes[j], strides[j], tw, inv,
               mul if inv and i == 0 else None)


def g_freq(plan, pos):
    """The frequency at each position of the passes' order."""
    pos, f, mult, s = np.asarray(pos, dtype=np.int64).copy(), 0, 1, plan.n
    for fj in plan.passes:
        s //= fj
        q = pos // s
        pos = pos - q * s
        f = f + q * mult
        mult *= fj
    return f


def g_at(plan, f):
    """The position of frequency f (the inverse of :func:`g_freq`)."""
    f, pos, s = np.asarray(f, dtype=np.int64).copy(), 0, plan.n
    for fj in plan.passes:
        s //= fj
        pos = pos + (f % fj) * s
        f = f // fj
    return pos


def model_k2g(x, itemsize=8):
    """K2g's spectrum of the real centred row x as the kernels compute it
    (in complex64 on the float32 tables where itemsize is 4): |X_k|^2 for
    k = 0 .. N/2, each bin written once."""
    nbin = len(x)
    plan = tk.cell_fft_global_plan(nbin, itemsize)
    if plan.mode == "cluster":
        return model_bluestein_cluster(x, itemsize)
    real = torch.float64 if itemsize == 8 else torch.float32
    cdt = np.complex128 if itemsize == 8 else np.complex64
    tw = _GTable(plan.table, plan.n, real)
    out = np.full(nbin // 2 + 1, np.nan)
    if plan.mode == "bluestein":
        w = tk.fftg_chirp(nbin)
        w = (w[:, 0] + 1j * w[:, 1]).astype(cdt)
        z = np.zeros(plan.n, dtype=cdt)
        z[:nbin] = x * w
        g_passes(z, plan, tw)
        z = z * _g_bhat(nbin, itemsize).astype(cdt)
        g_passes(z, plan, tw, inv=True)
        out[:] = (z.real ** 2 + z.imag ** 2)[:nbin // 2 + 1]
        return out
    z = (x[0::2] + 1j * x[1::2]).astype(cdt)
    g_passes(z, plan, tw)
    n, seen = plan.n, np.zeros(nbin // 2 + 1, dtype=int)
    pos = np.arange(n)
    f = g_freq(plan, pos)
    fp = np.where(f == 0, 0, n - f)
    first = f <= fp
    pos, f, fp = pos[first], f[first], fp[first]
    a, b = z[pos], z[g_at(plan, fp)]
    wk = tw(f) if tw.mul == 1 else _GTable(plan.table, plan.table, real)(f)
    out[f] = np.abs(0.5 * (a + np.conj(b)) - 0.5j * wk * (a - np.conj(b))) ** 2
    np.add.at(seen, f, 1)
    two = fp != f
    wp = -np.conj(wk[two])
    bb, aa = b[two], a[two]
    out[fp[two]] = np.abs(0.5 * (bb + np.conj(aa))
                          - 0.5j * wp * (bb - np.conj(aa))) ** 2
    np.add.at(seen, fp[two], 1)
    out[n] = (z[0].real - z[0].imag) ** 2
    seen[n] += 1
    assert np.array_equal(seen, np.ones(nbin // 2 + 1)), "each bin once"
    return out


def _g_bhat(nbin, itemsize=8):
    """B^ as the wrapper makes it for the passes: the chirp row through
    the float64 passes (of the plan of ``itemsize``), times 1 / M."""
    plan = tk.cell_fft_global_plan(nbin, itemsize)
    b = tk.fftg_chirp_row(nbin, plan.n)
    z = b[:, 0] + 1j * b[:, 1]
    g_passes(z, plan, _GTable(plan.table, plan.n, torch.float64))
    return z * (1.0 / plan.n)


def _dit_regs(r):
    """The inverse of :func:`_dif_regs`: register k holding output
    brev(k), the stages in reverse order, each butterfly's conjugate
    twiddle before it; ends as 2^r times input k."""
    n = r.shape[-1]
    h = 1
    while h < n:
        for k in range(n):
            if k & h:
                continue
            a = r[..., k].copy()
            b = r[..., k + h] * np.conj(W16[(k & (h - 1)) * (8 // h)])
            r[..., k] = a + b
            r[..., k + h] = a - b
        h *= 2


def model_inverse(mem, m, cluster, s, tw, lr_max=3):
    """The cluster mode's inverse (decimation in time) of the forward's
    output order in ``mem`` (:func:`model_forward`): the odd stages last
    first, the local passes in reverse, the cross-cluster step last, every
    twiddle conjugated and applied before its butterfly; returns the m
    values in natural order (m times the inverse DFT)."""
    p, lm, lc, lq, q = _layout(m, cluster)
    spans, sp = [], p
    while sp > 1:
        spans.append(sp)
        sp //= _odd_radix(sp)
    for sp in reversed(spans):
        rad = _odd_radix(sp)
        d, nsp = sp // rad, (2 << lm) * (p // sp)
        w = np.conj(tw(np.arange(rad) * (nsp * d)))
        per = p // rad
        idx = np.arange(per << lq)
        grp, rr = idx // per, idx % per
        j = rr % d
        base = grp * p + (rr // d) * sp + j
        for r in range(cluster):
            y = np.stack([mem[r][_swz(base + t * d, s)]
                          for t in range(rad)], 1)
            for t in range(1, rad):
                y[:, t] = y[:, t] * np.where(j != 0,
                                             np.conj(tw(j * t * nsp)), 1)
            for u in range(rad):
                acc = y[:, 0].copy()
                for t in range(1, rad):
                    acc = acc + y[:, t] * w[(u * t) % rad]
                mem[r][_swz(base + u * d, s)] = acc
    r0 = lq % lr_max or lr_max
    lx = 0
    while lx < lq:       # the local passes, the forward's last first
        lr = r0 if lx == lq - r0 else lr_max
        sh, lg = lm + 1 - (lx + lr), lq - lr
        g = np.arange(p << lg)
        v, rest = g >> lg, g & ((1 << lg) - 1)
        iu = rest & ((1 << lx) - 1)
        u0 = ((rest >> lx) << (lx + lr)) + iu
        i = iu * p + v
        at = np.stack([_swz((u0 + (k << lx)) * p + v, s)
                       for k in range(1 << lr)], axis=1)
        w = _powers(tw, lr, i << sh)
        for r in range(cluster):
            regs = mem[r][at]
            for k in range(1, 1 << lr):
                regs[:, k] *= np.where(i == 0, 1,
                                       np.conj(w[int(_brev(k, lr))]))
            _dit_regs(regs)
            mem[r][at] = regs
        lx += lr
    j = np.arange(q)     # the cross-cluster step, last
    sj = _swz(j, s)
    regs = mem[:, sj].T.copy()
    w = _powers(tw, lc, j << 1)
    for k in range(1, cluster):
        regs[:, k] *= np.conj(w[int(_brev(k, lc))])
    _dit_regs(regs)
    return regs.T.reshape(-1)    # register k is position j + k Q


def _cluster_bhat(nbin, plan):
    """B^ as the wrapper makes it for the cluster mode: the chirp row's
    float64 spectrum / M in the forward's order."""
    b = tk.fftg_chirp_row(nbin, plan.n)
    bh = np.fft.fft(b[:, 0] + 1j * b[:, 1]) / plan.n
    return bh[tk.fft_cluster_order(plan.n, plan.odd)]


def model_bluestein_cluster(x, itemsize=8):
    """The cluster mode on the real centred row x (complex64 on the
    float32 tables where itemsize is 4): the chirped row, K2f's forward
    (on the plan's cluster, its register passes of
    2^FFTG_CLUSTER_PASS_LOG points), times B^, the inverse; |c_k|^2 for k
    = 0 .. N/2."""
    nbin = len(x)
    plan = tk.cell_fft_global_plan(nbin, itemsize)
    assert plan.mode == "cluster"
    real = torch.float64 if itemsize == 8 else torch.float32
    cdt = np.complex128 if itemsize == 8 else np.complex64
    s = 3 if itemsize == 8 else 4
    tw = _Table(plan.table, real)
    w = tk.fftg_chirp(nbin)
    w = (w[:, 0] + 1j * w[:, 1]).astype(cdt)
    z = np.zeros(plan.n, dtype=cdt)
    z[:nbin] = x.astype(cdt) * w
    lr = tk.FFTG_CLUSTER_PASS_LOG
    mem = model_forward(z, plan.cluster, s, tw, cdt, lr)
    p, lm, lc, lq, q = _layout(plan.n, plan.cluster)
    bh = _cluster_bhat(nbin, plan).astype(cdt)
    slots = _swz(np.arange(q), s)
    for r in range(plan.cluster):
        mem[r, slots] = mem[r, slots] * bh[r * q:(r + 1) * q]
    c = model_inverse(mem, plan.n, plan.cluster, s, tw, lr)
    assert tw.top < len(tw.c)
    return (c.real ** 2 + c.imag ** 2)[:nbin // 2 + 1]


K2G_LENGTHS = [16411, 20001, 28672, 65521, 524288]


@pytest.mark.parametrize("nbin", K2G_LENGTHS)
def test_k2g_schedule_matches_rfft(nbin):
    """The passes, the chirp, B^ and the split or the Bluestein max within
    1e-10 of the spectrum's scale of np.fft.rfft (float64 tables)."""
    x = _row(nbin, nbin % 83)
    x = x - x.mean()
    want = np.abs(np.fft.rfft(x)) ** 2
    got = model_k2g(x)
    scale = want.max()
    assert np.abs(np.sqrt(got) - np.sqrt(want)).max() <= 1e-10 * np.sqrt(scale)


@pytest.mark.parametrize("nbin,itemsize", [
    (16411, 8), (28672, 8), (524288, 8), (136537, 4), (69127, 8)])
def test_k2g_passes_order_and_bhat(nbin, itemsize):
    """The forward transform leaves X[f] at its position of f (np.fft.fft
    permuted: the passes' digits, or K2f's order in the cluster mode),
    the inverse (the passes', or the cluster mode's decimation in time)
    brings n x back in natural order, and B^ is the chirp row's spectrum
    / M in the forward's order."""
    plan = tk.cell_fft_global_plan(nbin, itemsize)
    n = plan.n
    rng = np.random.default_rng(nbin)
    z0 = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    if plan.mode == "cluster":
        tw = _Table(plan.table, torch.float64)
        f = tk.fft_cluster_order(n, plan.odd)
        p, lm, lc, lq, q = _layout(n, plan.cluster)
        lr = tk.FFTG_CLUSTER_PASS_LOG
        mem = model_forward(z0, plan.cluster, 3, tw, lr_max=lr)
        z = mem[:, _swz(np.arange(q), 3)].reshape(-1)
        back = model_inverse(mem, n, plan.cluster, 3, tw, lr)
        bhat = _cluster_bhat(nbin, plan)
    else:
        assert np.prod(plan.passes) == n
        assert max(plan.passes) <= tk.FFTG_PASS_MAX
        tw = _GTable(plan.table, n, torch.float64)
        z = z0.copy()
        g_passes(z, plan, tw)
        f = g_freq(plan, np.arange(n))
        assert np.array_equal(g_at(plan, f), np.arange(n))
        back = z.copy()
        g_passes(back, plan, tw, inv=True)
        bhat = _g_bhat(nbin, itemsize) if plan.mode == "bluestein" else None
    assert np.array_equal(np.sort(f), np.arange(n))
    want = np.fft.fft(z0)
    assert np.abs(z - want[f]).max() <= 1e-10 * np.abs(want).max()
    assert np.abs(back / n - z0).max() <= 1e-12 * np.abs(z0).max()
    if bhat is not None:
        b = tk.fftg_chirp_row(nbin, n)
        bh = np.fft.fft(b[:, 0] + 1j * b[:, 1]) / n
        assert np.abs(bhat - bh[f]).max() <= 1e-12 * np.abs(bh).max()


def test_k2g_chirp_reduces_in_integers():
    """w_j = exp(-i pi (j^2 mod 2N) / N): the phase reduced in int64 (j^2
    passes int32 at j = 46,341), |w| = 1; the chirp row conj w at the lags
    j < K and at M - j, zero between."""
    nbin = 65521
    w = tk.fftg_chirp(nbin)
    j = 65520
    ang = -np.pi * ((j * j) % (2 * nbin)) / nbin
    assert j * j > 2 ** 31
    assert np.allclose(w[j], [np.cos(ang), np.sin(ang)], rtol=0, atol=1e-15)
    assert np.allclose(np.hypot(w[:, 0], w[:, 1]), 1.0, rtol=0, atol=1e-15)
    m = tk.cell_fft_global_plan(nbin).n
    k = nbin // 2 + 1
    b = tk.fftg_chirp_row(nbin, m)
    assert np.array_equal(b[1:k, 0], b[m - 1:m - k:-1, 0])
    assert np.array_equal(b[m - nbin + 1:, 1][::-1], -w[1:, 1])
    assert np.array_equal(b[:k, 1], -w[:k, 1])
    assert not b[k:m - nbin + 1].any()


# (nbin, itemsize, M): the least length of the transform's form with M >=
# N + N // 2: K2f's cluster (P 2^m, P within FFT_ODD_STAGES, the row in
# the cluster) where one takes it, else 2^a 3^b 5^c for the passes
SHORT_M = [(65521, 4, 98304), (65521, 8, 98304), (16411, 4, 25600),
           (16411, 8, 25600), (35035, 4, 55296), (136537, 4, 207360),
           (69127, 8, 104976), (100003, 8, 151875)]


@pytest.mark.parametrize("nbin,itemsize,m", SHORT_M)
def test_k2g_shorter_convolution_length(nbin, itemsize, m):
    """The max reads K = N/2 + 1 outputs, so a cyclic convolution of M >=
    N + N/2 points gives them without wrap-around: M is the least such
    length of the form the transform takes (98,304 = 3 x 2^15 at 65,521
    bins, a quarter under the 131,072 of M >= 2N - 1)."""
    plan = tk.cell_fft_global_plan(nbin, itemsize)
    assert plan.n == m >= nbin + nbin // 2
    if plan.mode == "cluster":
        assert tk._cell_fft_takes(2 * m, 8 if itemsize == 8 else 4)[0] \
            is not None
        assert plan.table == 2 * m and plan.passes == () and plan.chunk == 0
    else:
        assert plan.mode == "bluestein"
        assert m == tk._next_smooth(nbin + nbin // 2)
        assert tk._fftg_cluster(nbin, 8 if itemsize == 8 else 4) \
            == (None, None)


@pytest.mark.parametrize("nbin,m", [(16411, 25600), (65521, 98304),
                                    (35035, 55296), (7, 12), (8, 12)])
def test_k2g_chirp_row_placement(nbin, m):
    """b sits at the lags 0 .. K - 1 and at M - N + 1 .. M - 1, zero in
    between, the two placements apart (M >= N + N/2); a shorter M, where
    they would overlap, is refused; and the cyclic convolution of the
    chirped row with b is the linear one at every k < K."""
    k = nbin // 2 + 1
    b = tk.fftg_chirp_row(nbin, m)
    nz = np.flatnonzero(np.hypot(b[:, 0], b[:, 1]))
    want = np.concatenate([np.arange(k), np.arange(m - nbin + 1, m)])
    assert np.array_equal(nz, want)
    assert k - 1 < m - nbin + 1
    with pytest.raises(ValueError, match="at least"):
        tk.fftg_chirp_row(nbin, nbin + nbin // 2 - 1)
    rng = np.random.default_rng(nbin)
    x = rng.standard_normal(nbin)
    w = tk.fftg_chirp(nbin)
    w = w[:, 0] + 1j * w[:, 1]
    a = np.zeros(m, dtype=complex)
    a[:nbin] = x * w
    c = np.fft.ifft(np.fft.fft(a) * np.fft.fft(b[:, 0] + 1j * b[:, 1]))
    direct = np.array([np.sum(x * w * np.conj(w[np.abs(kk - np.arange(nbin))]))
                       for kk in range(k)])
    assert np.abs(c[:k] - direct).max() <= 1e-9 * np.abs(direct).max()


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("nbin", [16411, 65521, 35035])
def test_k2g_cluster_bluestein_matches_rfft(nbin, itemsize):
    """The cluster mode's model (the chirped row through K2f's forward in
    its order, times B^, the decimation-in-time inverse back to natural
    order) held to np.fft.rfft at a prime, (L5b)'s prime and an odd
    composite with a factor 7 (5 7^2 11 13): |X_k| within 1e-12 of the
    spectrum's scale in float64, 1e-6 in complex64 on the float32 tables
    (the float32 build's accuracy; numpy does not fuse its multiplies as
    the kernel does)."""
    x = _row(nbin, nbin % 79)
    x = x - x.mean()
    if itemsize == 4:
        x = x.astype(np.float32)
    want = np.abs(np.fft.rfft(x.astype(np.float64)))
    got = np.sqrt(model_bluestein_cluster(x, itemsize))
    tol = 1e-12 if itemsize == 8 else 1e-6
    assert np.abs(got - want).max() <= tol * want.max()


@pytest.mark.parametrize("nbin", [65521, 524288])
def test_k2g_float32_schedule_accuracy(nbin):
    """complex64 passes on the float32 tables (B^ from float64, rounded),
    as the float32 build runs them: the max |X| and every bin within 1e-6
    of the float64 spectrum's scale (measured at K2G_LENGTHS: at most
    1.3e-7 over the bins, 4.5e-8 on the max)."""
    x = _row(nbin, 5)
    x = (x - x.mean()).astype(np.float32)
    want = np.abs(np.fft.rfft(x.astype(np.float64)))
    got = np.sqrt(model_k2g(x, 4))
    scale = want.max()
    assert abs(got.max() - scale) <= 1e-6 * scale
    assert np.abs(got - want).max() <= 1e-6 * scale
