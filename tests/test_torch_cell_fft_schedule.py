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
kernel does).
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


def model_rfft(x, cluster, s, tw, cdtype=np.complex128, lr_max=3):
    """The kernel's schedule on the real row ``x`` (swizzle runs of 2^s,
    local passes of 2^lr_max points): returns the rfft bins 0 .. N/2 as
    the split writes them (each checked to come once)."""
    n = len(x)
    half, p = n // 2, _odd(n)
    lm = (half // p).bit_length() - 1
    lc = cluster.bit_length() - 1
    lq = lm - lc
    q = p << lq
    z = (x[0::2] + 1j * x[1::2]).astype(cdtype)
    slots = _swz(np.arange(q), s)
    assert np.array_equal(np.sort(slots), np.arange(q)), "swizzle"
    mem = np.zeros((cluster, q), dtype=cdtype)
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
    if p > 1:            # the radix-P stage
        w = tw(np.arange(p) * (2 << lm))
        base = np.arange(1 << lq) * p
        for r in range(cluster):
            regs = np.stack([mem[r][_swz(base + u, s)] for u in range(p)], 1)
            for t in range(p):
                mem[r][_swz(base + t, s)] = sum(
                    regs[:, u] * w[(u * t) % p] for u in range(p))
    out = np.full(half + 1, np.nan + 0j)
    seen = np.zeros(half + 1, dtype=int)
    even = 1 << (lq - 1)
    idx = np.arange(even + 1 if p == 1 else p << lq)
    t = np.zeros_like(idx) if p == 1 else idx >> lq
    sl = (np.where(idx < even, 2 * idx, 1) if p == 1
          else idx & ((1 << lq) - 1))
    for rank in range(cluster):  # the split, a pair (k, N/2 - k) at a time
        sg = (rank << lq) + sl
        kk = _brev(sg, lm) + (t << lm)
        kp = np.where(kk == 0, 0, half - kk)
        first = kk <= kp
        kk, kp, t1, s1 = kk[first], kp[first], t[first], sl[first]
        sp = _brev(kp & ((1 << lm) - 1), lm)
        a = mem[rank][_swz(s1 * p + t1, s)]
        b = mem[sp >> lq, _swz((sp & ((1 << lq) - 1)) * p + (kp >> lm), s)]
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
