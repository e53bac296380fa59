"""The hand-written CUDA kernels of the default route, their plain
PyTorch versions, and the build that binds them.

One wrapper per kernel.  Each takes its plain version only for tensors
that lie on the CPU; for CUDA tensors it launches the kernel or raises —
there is no fallback.  Each carries a launch count, a plain integer
attribute (``weighted_marginals.launches``, ...; ``scaled_sides`` keeps
one per orientation), incremented where it launches and nowhere else.

=====  =================================  ==================================
port   wrapper (source)                   replaces (iterative_cleaner_tpu/
                                          stats/pallas_kernels.py)
=====  =================================  ==================================
K1     :func:`weighted_marginals`         ``weighted_marginals_pallas``
       (csrc/marginals.cu)                (body ``_marginals_kernel``)
K2     :func:`cell_diagnostics_disp`      ``cell_diagnostics_pallas_disp``
       (csrc/cell_stats.cu)               (``_wres_disp`` + ``_diag_tail``)
K3     :func:`scaled_sides`               ``scaled_sides_pallas``, both axes
       (csrc/scaled_sides.cu)             (body ``_scaled_sides_body``)
K4     K2 + K3 x 2 + :func:`combine_zap`  ``fused_sweep_pallas`` (tail
       (csrc/combine.cu)                  ``_combine_zap`` / ``_median4``)
=====  =================================  ==================================

Each source file states what bounds its kernel on the card and what its
design does about it.  The TPU sweep K4 keeps the whole cell plane in
VMEM under a 24 MiB cap; a Hopper block cannot hold an archive's planes
and its grid is not sequential, so the port has one launch sequence for
every plane size (K2, K3 per orientation, combine) — no size gate.

The sources are compiled at first use with ``nvcc`` into one shared
library under ``iterative_cleaner_torch/_build/`` (one ``nvcc`` per
source, run in parallel, then one link) and bound with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np
import torch

from iterative_cleaner_torch.ops.dsp import (
    fit_template_amplitudes_disp,
    weighted_marginal_totals,
)
from iterative_cleaner_torch.stats.masked_torch import (
    _masked_side,
    _patch_nan_lines,
    cell_diagnostics,
    dft_tables,
    inverse_threshold,
)

_PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = _PKG_DIR / "_build"
SOURCES = ("marginals.cu", "cell_stats.cu", "scaled_sides.cu", "combine.cu")
# -fmad=false: no contraction of a*b+c, so the kernels round as the
# reference does; no fast-math; sm_90a (Hopper).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-fmad=false", "-std=c++17", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

# Longest profile any kernel takes: K2's shared-memory plan (a centred
# row per cell of its group plus a k-chunk of the DFT tables) fits the
# 227 KB a Hopper block may use up to here.
MAX_NBIN = 4096
_SMEM_LIMIT = 232448

_LIB = None
_LIB_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "source at first use and need the CUDA toolkit")


def _source_digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC_DIR)):
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    return h.hexdigest()[:16]


def build_library() -> Path:
    """Compile the kernel sources into one shared library (cached by
    source digest) and return its path.  The compiler's register and
    shared-memory report is kept in ``build.log`` beside it."""
    out = BUILD_DIR / f"libicln_kernels_{_source_digest()}.so"
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for name in SOURCES:
            obj = os.path.join(tmp, name + ".o")
            procs.append((name, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(CSRC_DIR / name), "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for name, _obj, proc in procs:
            text, _ = proc.communicate()
            logs.append(f"== {name} (rc {proc.returncode})\n{text}")
            if proc.returncode != 0:
                failed.append(name)
        (BUILD_DIR / "build.log").write_text("\n".join(logs))
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        lib_tmp = os.path.join(tmp, "lib.so")
        link = subprocess.run(
            [nvcc, "-shared", "-o", lib_tmp, *(obj for _n, obj, _p in procs)],
            capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"link failed:\n{link.stdout}{link.stderr}")
        os.replace(lib_tmp, out)
    return out


_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_SIGNATURES = {
    "icln_weighted_marginals": [_P] * 6 + [_I] * 5 + [_P],
    "icln_cell_stats_disp": [_P] * 12 + [_LL] + [_I] * 6 + [_LL, _F, _P],
    "icln_scaled_sides": [_P] * 9 + [_I, _I, _LL, _LL, _F, _I, _LL, _P],
    "icln_combine_zap": [_P] * 11 + [_LL, _P],
}


def load_library():
    """The bound kernel library, built on first use."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build_library()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.icln_error_string.argtypes = [ctypes.c_int]
            lib.icln_error_string.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB


def _on_card(*tensors) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU tensors
    (the plain version); anything else, or a mix, raises."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {t.device} "
                             f"and {dev}")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA tensor given but no CUDA device is present")
    return True


def _require(t, name, dtype, shape):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_rc(rc: int, what: str) -> None:
    if rc != 0:
        msg = load_library().icln_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def _stream(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


# --------------------------------------------------------------------------
# K1: weighted marginals
# --------------------------------------------------------------------------

def marginals_tiles(nsub: int, nchan: int, nbin: int):
    """(sb, cb): K1's tile of subints x channels.  One subint's slab of
    a tile is at most 4096 floats (two of them in shared memory)."""
    return min(nsub, 64), max(1, min(nchan, 4096 // nbin))


def weighted_marginals(disp, weights):
    """``(A, t1)`` with ``A[c] = sum_s w*disp`` and ``t1[s] = sum_c
    w*disp`` — kernel K1 on the card, :func:`weighted_marginal_totals`
    on the CPU."""
    if not _on_card(disp, weights):
        return weighted_marginal_totals(disp, weights)
    nsub, nchan, nbin = disp.shape
    if nbin > MAX_NBIN:
        raise ValueError(f"nbin {nbin} > {MAX_NBIN}")
    _require(disp, "disp", torch.float32, (nsub, nchan, nbin))
    _require(weights, "weights", torch.float32, (nsub, nchan))
    sb, cb = marginals_tiles(nsub, nchan, nbin)
    nsb, ncb = -(-nsub // sb), -(-nchan // cb)
    kw = dict(dtype=torch.float32, device=disp.device)
    a_part = torch.empty((nsb, nchan, nbin), **kw)
    t1_part = torch.empty((ncb, nsub, nbin), **kw)
    a = torch.empty((nchan, nbin), **kw)
    t1 = torch.empty((nsub, nbin), **kw)
    lib = load_library()
    with torch.cuda.device(disp.device):
        rc = lib.icln_weighted_marginals(
            _ptr(disp), _ptr(weights), _ptr(a_part), _ptr(t1_part), _ptr(a),
            _ptr(t1), nsub, nchan, nbin, sb, cb, _stream(disp))
    weighted_marginals.launches += 1
    _check_rc(rc, "weighted_marginals")
    return a, t1


weighted_marginals.launches = 0


# --------------------------------------------------------------------------
# K2: dispersed-frame cell diagnostics
# --------------------------------------------------------------------------

def wres_disp(disp, rot_t, nyq_row, template, weights):
    """Dispersed-frame weighted residual (the reference's ``_wres_disp``):
    fit against the rotated template, the Nyquist round-trip term when
    ``nyq_row`` is given, weighting."""
    amp = fit_template_amplitudes_disp(disp, rot_t, template)
    base = disp
    if nyq_row is not None:
        nbin = disp.shape[-1]
        alt = (1.0 - 2.0 * (torch.arange(nbin, device=disp.device) % 2)).to(
            disp.dtype)
        nyqcoef = torch.sum(disp * alt, dim=2)
        base = disp + nyqcoef[:, :, None] * nyq_row[None]
    resid = amp[:, :, None] * rot_t[None] - base
    return resid * weights[:, :, None]


def tt_info(template):
    """``[<t,t> (1 where it is 0), 1.0 if <t,t> == 0 else 0.0]`` as a
    device tensor, so K2 reads it without a host round trip."""
    tt = torch.sum(template * template)
    return torch.stack([torch.where(tt == 0, torch.ones_like(tt), tt),
                        (tt == 0).to(template.dtype)])


def cell_stats_geometry(nbin: int, threads: int = 256):
    """(group, kchunk, smem_bytes) of K2's launch: cells per block group,
    DFT-table columns staged per chunk, dynamic shared memory."""
    nk = nbin // 2 + 1
    group = 32 if nbin <= 383 else 16 if nbin <= 767 else 8
    cen_bytes = group * (nbin + 1) * 4
    table_budget = min(96 * 1024, 200 * 1024 - cen_bytes)
    kchunk = max(1, min(nk, table_budget // (2 * nbin * 4)))
    smem = cen_bytes + 2 * nbin * kchunk * 4 + threads * 4
    if smem > _SMEM_LIMIT:
        raise ValueError(f"nbin {nbin}: K2 needs {smem} bytes of shared "
                         f"memory, over the {_SMEM_LIMIT}-byte limit")
    return group, kchunk, smem


@functools.lru_cache(maxsize=8)
def _dft_tables_cached(nbin: int, device: str):
    return tuple(t.contiguous() for t in
                 dft_tables(nbin, torch.float32, torch.device(device)))


@functools.lru_cache(maxsize=8)
def _sm_count(device: str) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def cell_diagnostics_disp_plain(disp, rot_t, nyq_row, template, weights,
                                cell_mask):
    """The plain version of K2: :func:`wres_disp`, then
    :func:`~iterative_cleaner_torch.stats.masked_torch.cell_diagnostics`
    with the DFT."""
    wres = wres_disp(disp, rot_t, nyq_row, template, weights)
    return cell_diagnostics(wres, cell_mask, "dft")


def cell_diagnostics_disp(disp, rot_t, nyq_row, template, weights,
                          cell_mask):
    """``(d_std, d_mean, d_ptp, d_fft)`` of the dispersed-frame weighted
    residual — kernel K2 on the card, :func:`cell_diagnostics_disp_plain`
    on the CPU.  ``nyq_row`` is None where the rotation round-trips
    exactly (roll, odd nbin)."""
    if not _on_card(disp, rot_t, template, weights, cell_mask):
        return cell_diagnostics_disp_plain(disp, rot_t, nyq_row, template,
                                           weights, cell_mask)
    nsub, nchan, nbin = disp.shape
    if nbin > MAX_NBIN:
        raise ValueError(f"nbin {nbin} > {MAX_NBIN}")
    _require(disp, "disp", torch.float32, (nsub, nchan, nbin))
    _require(rot_t, "rot_t", torch.float32, (nchan, nbin))
    _require(template, "template", torch.float32, (nbin,))
    if nyq_row is not None:
        _require(nyq_row, "nyq_row", torch.float32, (nchan, nbin))
    _require(weights, "weights", torch.float32, (nsub, nchan))
    _require(cell_mask, "cell_mask", torch.bool, (nsub, nchan))
    info = tt_info(template)
    threads = 256
    group, kchunk, smem = cell_stats_geometry(nbin, threads)
    cos_t, sin_t = _dft_tables_cached(nbin, str(disp.device))
    outs = [torch.empty((nsub, nchan), dtype=torch.float32,
                        device=disp.device) for _ in range(4)]
    ncells = nsub * nchan
    grid = max(1, min(-(-ncells // group), 4 * _sm_count(str(disp.device))))
    inv_n = float(np.float32(1.0 / nbin))
    lib = load_library()
    with torch.cuda.device(disp.device):
        rc = lib.icln_cell_stats_disp(
            _ptr(disp), _ptr(rot_t),
            None if nyq_row is None else _ptr(nyq_row), _ptr(weights),
            _ptr(cell_mask), _ptr(cos_t), _ptr(sin_t), _ptr(info),
            *(_ptr(o) for o in outs), ncells, nchan, nbin, group, kchunk,
            threads, grid, smem, inv_n, _stream(disp))
    cell_diagnostics_disp.launches += 1
    _check_rc(rc, "cell_diagnostics_disp")
    return tuple(outs)


cell_diagnostics_disp.launches = 0


# --------------------------------------------------------------------------
# K3: scaled sides, one orientation
# --------------------------------------------------------------------------

_KEY_MASKED = 0x7F800000


def ordered_key(x):
    """float32 -> int32 keys whose signed order is the float order (NaN
    above +inf): the reference's ``_ordered_key``."""
    b = x.contiguous().view(torch.int32)
    return b ^ ((b >> 31) & 0x7FFFFFFF)


def key_to_float(k):
    """Inverse of :func:`ordered_key` (the map is an involution)."""
    return (k ^ ((k >> 31) & 0x7FFFFFFF)).view(torch.float32)


def masked_median_keys(values, mask, dim):
    """Median of the unmasked entries along ``dim`` (keepdims) by exact
    order statistics of the ordered keys — what the kernel's bisection
    select computes: keys of masked entries are +inf's, ``k_lo =
    (n-1)//2``, ``k_hi = n//2``, ``0.5*(lo+hi)``, 0.0 on an empty line.
    Returns ``(median, n_valid)``."""
    keys = torch.where(mask, torch.full_like(ordered_key(values), _KEY_MASKED),
                       ordered_key(values))
    ordered = torch.sort(keys, dim=dim).values
    n = torch.sum(~mask, dim=dim, keepdim=True)
    k_lo = torch.clamp(n - 1, min=0) // 2
    k_hi = torch.clamp(n // 2, max=values.shape[dim] - 1)
    lo = key_to_float(torch.gather(ordered, dim, k_lo))
    hi = key_to_float(torch.gather(ordered, dim, k_hi))
    med = 0.5 * (lo + hi)
    return torch.where(n == 0, torch.zeros_like(med), med), n


def scaled_sides_plain(diagnostics, cell_mask, axis, thresh):
    """The plain version of K3 (the reference's ``_scaled_sides_body``
    along ``axis``): masked median -> centring -> MAD -> ``_masked_side``
    for the three masked diagnostics; the plain NaN-patched path for the
    rFFT one."""
    d0, d1, d2, d3 = diagnostics
    outs = []
    for d in (d0, d1, d2):
        med, n = masked_median_keys(d, cell_mask, axis)
        centred = torch.where(cell_mask, d, d - med)
        mad, _ = masked_median_keys(torch.abs(centred), cell_mask, axis)
        outs.append(_masked_side(centred, mad, cell_mask, n, thresh))
    plain = torch.zeros_like(cell_mask)
    med, _ = masked_median_keys(d3, plain, axis)
    centred = d3 - _patch_nan_lines(med, d3, axis)
    absc = torch.abs(centred)
    mad, _ = masked_median_keys(absc, plain, axis)
    outs.append(torch.abs(centred / _patch_nan_lines(mad, absc, axis))
                * inverse_threshold(thresh, centred))
    return tuple(outs)


def scaled_sides(diagnostics, cell_mask, axis, thresh):
    """All four scaled sides of one orientation: ``axis=0`` scales each
    channel down the subints (channel threshold), ``axis=1`` each subint
    across channels.  Kernel K3 on the card, :func:`scaled_sides_plain`
    on the CPU; bit-equal to the reference's ``scaled_sides_pallas``."""
    if axis not in (0, 1):
        raise ValueError("axis must be 0 or 1")
    if not _on_card(*diagnostics, cell_mask):
        return scaled_sides_plain(diagnostics, cell_mask, axis, thresh)
    nsub, nchan = cell_mask.shape
    for i, d in enumerate(diagnostics):
        _require(d, f"diagnostics[{i}]", torch.float32, (nsub, nchan))
    _require(cell_mask, "cell_mask", torch.bool, (nsub, nchan))
    if axis == 0:
        n, nlines, line_stride, elem_stride = nsub, nchan, 1, nchan
    else:
        n, nlines, line_stride, elem_stride = nchan, nsub, nchan, 1
    smem = n * 4 + n + 16
    if smem > _SMEM_LIMIT:
        raise ValueError(f"line length {n}: K3 needs {smem} bytes of shared "
                         f"memory, over the {_SMEM_LIMIT}-byte limit")
    threads = 256 if n <= 1024 else 512
    inv_t = float(np.float32(1.0) / np.float32(thresh))
    outs = [torch.empty_like(diagnostics[0]) for _ in range(4)]
    lib = load_library()
    with torch.cuda.device(cell_mask.device):
        rc = lib.icln_scaled_sides(
            *(_ptr(d) for d in diagnostics), _ptr(cell_mask),
            *(_ptr(o) for o in outs), n, nlines, line_stride, elem_stride,
            inv_t, threads, smem, _stream(cell_mask))
    scaled_sides.launches[axis] += 1
    _check_rc(rc, f"scaled_sides(axis={axis})")
    return tuple(outs)


scaled_sides.launches = [0, 0]


# --------------------------------------------------------------------------
# combine: max of sides -> 4-way median -> zap
# --------------------------------------------------------------------------

def median4_keys(a, b, c, d):
    """``np.median`` of four planes elementwise, as the reference's
    ``_median4``: min/max network on ordered keys, ``lo*0.5 + hi*0.5``,
    NaN wherever any input is NaN."""
    any_nan = torch.isnan(a) | torch.isnan(b) | torch.isnan(c) | torch.isnan(d)
    ka, kb, kc, kd = (ordered_key(v) for v in (a, b, c, d))
    x = torch.maximum(torch.minimum(ka, kb), torch.minimum(kc, kd))
    y = torch.minimum(torch.maximum(ka, kb), torch.maximum(kc, kd))
    med = (key_to_float(torch.minimum(x, y)) * 0.5
           + key_to_float(torch.maximum(x, y)) * 0.5)
    return torch.where(any_nan, torch.full_like(med, math.nan), med)


def combine_zap_plain(chan_sides, sub_sides, orig_weights):
    per = [torch.maximum(c, s) for c, s in zip(chan_sides, sub_sides)]
    scores = median4_keys(*per)
    new_w = torch.where(scores >= 1.0, torch.zeros_like(orig_weights),
                        orig_weights)
    return new_w, scores


def combine_zap(chan_sides, sub_sides, orig_weights):
    """``(new_weights, scores)`` from the two orientations' scaled sides:
    elementwise max per diagnostic, 4-way median, ``scores >= 1`` zaps
    ``orig_weights``.  The combine kernel on the card,
    :func:`combine_zap_plain` on the CPU."""
    if not _on_card(*chan_sides, *sub_sides, orig_weights):
        return combine_zap_plain(chan_sides, sub_sides, orig_weights)
    shape = tuple(orig_weights.shape)
    for i, p in enumerate((*chan_sides, *sub_sides, orig_weights)):
        _require(p, f"plane {i}", torch.float32, shape)
    new_w = torch.empty_like(orig_weights)
    scores = torch.empty_like(orig_weights)
    lib = load_library()
    with torch.cuda.device(orig_weights.device):
        rc = lib.icln_combine_zap(
            *(_ptr(p) for p in chan_sides), *(_ptr(p) for p in sub_sides),
            _ptr(orig_weights), _ptr(new_w), _ptr(scores),
            orig_weights.numel(), _stream(orig_weights))
    combine_zap.launches += 1
    _check_rc(rc, "combine_zap")
    return new_w, scores


combine_zap.launches = 0


def reset_launch_counts() -> None:
    weighted_marginals.launches = 0
    cell_diagnostics_disp.launches = 0
    scaled_sides.launches = [0, 0]
    combine_zap.launches = 0


def launch_counts() -> dict:
    return {
        "weighted_marginals": weighted_marginals.launches,
        "cell_diagnostics_disp": cell_diagnostics_disp.launches,
        "scaled_sides_axis0": scaled_sides.launches[0],
        "scaled_sides_axis1": scaled_sides.launches[1],
        "combine_zap": combine_zap.launches,
    }
