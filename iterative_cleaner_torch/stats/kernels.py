"""The hand-written CUDA kernels of the port, their plain PyTorch
versions, and the build that binds them.

One wrapper per kernel.  Each takes its plain version only for tensors
that lie on the CPU; for CUDA tensors it launches the kernel or raises —
there is no fallback.  Each carries a launch count, a plain integer
attribute (``weighted_marginals.launches``, ...; ``scaled_sides`` keeps
one per orientation), incremented where it launches and nowhere else.
K8 (:func:`fused_combine`) launches through the K3 and combine wrappers,
which count those launches; its own count is of completed sequences.

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
K5     K6 + K3 x 2 + :func:`combine_zap`  ``fused_sweep_pallas_dedisp``
K6     :func:`cell_diagnostics_dedisp`    ``cell_diagnostics_pallas_dedisp``
       (csrc/cell_stats.cu)               (``_wres_dedisp`` + ``_diag_tail``)
K7     :func:`cell_diagnostics_two_read`  ``cell_diagnostics_pallas``
       (csrc/cell_stats.cu)               (``_cell_stats_kernel``)
K8     :func:`fused_combine`: K3 x 2 +    ``fused_combine_pallas``
       :func:`combine_zap`                (exact streaming's combine)
K9     :func:`masked_median`              ``masked_median_pallas``
       (csrc/masked_median.cu)            (``_median_axis0``, body
                                          ``_median_kernel``)
K10    :func:`shard_diagnostics_disp`,    ``sweep_shard_diags_disp``,
       :func:`shard_diagnostics_dedisp`   ``sweep_shard_diags_dedisp``
       (csrc/shard_stats.cu)              (the cell-sharded clean's shard)
tail   :func:`side_centre`,               ``_scaled_sides_body``'s centring
       :func:`side_scale`                 and side on lines too long for K3
       (csrc/sides_tail.cu)               (:func:`scaled_sides_long`, with K9)
=====  =================================  ==================================

Each source file states what bounds its kernel on the card and what its
design does about it.  The TPU sweeps K4 and K5 keep the whole cell
plane in VMEM under a 24 MiB cap; a Hopper block cannot hold an
archive's planes and its grid is not sequential, so the port has one
launch sequence for every plane size (K2 or K6, K3 per orientation,
combine) — no size gate.

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
from typing import NamedTuple

import numpy as np
import torch

from iterative_cleaner_torch.ops.dsp import (
    fit_template_amplitudes,
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
SOURCES = ("marginals.cu", "cell_stats.cu", "shard_stats.cu",
           "scaled_sides.cu", "combine.cu", "masked_median.cu",
           "sides_tail.cu")
# -fmad=false: no contraction of a*b+c, so the kernels round as the
# reference does; no fast-math; sm_90a (Hopper).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-fmad=false", "-std=c++17", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

# Longest profile the cube kernels take: their DFT tables, nbin x
# (nbin/2 + 1) x 8 bytes, are 1.07 GB on the card at 16384 bins (and
# the plain version's as much on the host).  Longer profiles wait for
# the rFFT route.
MAX_NBIN = 16384
_SMEM_LIMIT = 232448    # dynamic shared memory one Hopper block may use


def _check_nbin(nbin: int) -> None:
    if nbin > MAX_NBIN:
        raise NotImplementedError(
            f"nbin {nbin} > {MAX_NBIN}: longer profiles need the rFFT "
            f"route (ROADMAP item 9, long-profile spectra)")


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
    "icln_weighted_marginals": [_P] * 6 + [_I] * 7 + [_LL, _P],
    "icln_cell_stats_disp": [_P] * 12 + [_LL] + [_I] * 10 + [_LL, _F, _P],
    "icln_cell_stats_two_read": [_P] * 13 + [_LL] + [_I] * 10
    + [_LL, _F, _P],
    "icln_cell_stats_dedisp": [_P] * 12 + [_LL] + [_I] * 10 + [_LL, _F, _P],
    "icln_shard_stats_disp": [_P] * 12 + [_LL] + [_I] * 10 + [_LL, _F, _P],
    "icln_shard_stats_dedisp": [_P] * 12 + [_LL] + [_I] * 10 + [_LL, _F, _P],
    "icln_scaled_sides": [_P] * 9 + [_I, _I, _LL, _LL, _F, _I, _I, _I, _LL,
                                     _P],
    "icln_combine_zap": [_P] * 11 + [_LL, _P],
    "icln_masked_median": [_P] * 4 + [_I, _I, _LL, _LL, _I, _I, _I, _I, _LL,
                                      _P],
    "icln_side_centre": [_P] * 6 + [_LL, _I, _I, _I, _P],
    "icln_side_scale": [_P] * 5 + [_LL, _I, _I, _I, _F, _P],
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

class MarginalsPlan(NamedTuple):
    """K1's launch: ``sb`` subints per run, tiles of ``cb`` channels x
    ``bb`` bins, ``lanes`` bin lanes per channel group (a power of two
    at least ``bb``; ``256 // lanes`` groups of 32 channels each), the
    dynamic shared memory of its three-stage ring."""
    sb: int
    cb: int
    bb: int
    lanes: int
    smem: int


MARGINALS_THREADS = 256
MARGINALS_CHANNELS_PER_THREAD = 32
MARGINALS_STAGES = 3


def marginals_tiles(nsub: int, nchan: int, nbin: int,
                    sm_count: int = 132) -> MarginalsPlan:
    """K1's tile plan (``marginals.cu``): whole rows up to 256 bins, the
    bins tiled by 256 above; subint runs sized so that the grid is about
    two waves of two blocks per SM."""
    _check_nbin(nbin)
    bb = nbin if nbin <= 256 else 256
    lanes = 1 << (bb - 1).bit_length()
    cb = MARGINALS_THREADS // lanes * MARGINALS_CHANNELS_PER_THREAD
    ntiles = -(-nchan // cb) * -(-nbin // bb)
    nsb = max(1, min(nsub, 4 * sm_count // ntiles))
    sb = -(-nsub // nsb)
    smem = 32 + 4 * (2 * MARGINALS_THREADS
                     + MARGINALS_STAGES * (cb * bb + cb))
    return MarginalsPlan(sb, cb, bb, lanes, smem)


def weighted_marginals(disp, weights):
    """``(A, t1)`` with ``A[c] = sum_s w*disp`` and ``t1[s] = sum_c
    w*disp`` — kernel K1 on the card, :func:`weighted_marginal_totals`
    on the CPU."""
    if not _on_card(disp, weights):
        return weighted_marginal_totals(disp, weights)
    nsub, nchan, nbin = disp.shape
    _require(disp, "disp", torch.float32, (nsub, nchan, nbin))
    _require(weights, "weights", torch.float32, (nsub, nchan))
    plan = marginals_tiles(nsub, nchan, nbin, _sm_count(str(disp.device)))
    nsb, ncb = -(-nsub // plan.sb), -(-nchan // plan.cb)
    kw = dict(dtype=torch.float32, device=disp.device)
    a_part = torch.empty((nsb, nchan, nbin), **kw)
    t1_part = torch.empty((ncb, nsub, nbin), **kw)
    a = torch.empty((nchan, nbin), **kw)
    t1 = torch.empty((nsub, nbin), **kw)
    lib = load_library()
    with torch.cuda.device(disp.device):
        rc = lib.icln_weighted_marginals(
            _ptr(disp), _ptr(weights), _ptr(a_part), _ptr(t1_part), _ptr(a),
            _ptr(t1), nsub, nchan, nbin, plan.sb, plan.cb, plan.bb,
            plan.lanes, plan.smem, _stream(disp))
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


class CellStatsPlan(NamedTuple):
    """The launch of the cell-diagnostics kernels (``cell_stats.cuh``):
    ``group`` cells per block group, ``ctile`` cells per thread tile (4
    or 1; each tile holds 4 DFT columns), table chunks of ``kchunk``
    columns (of ``nkp``, nbin/2 + 1 padded to a multiple of 4) by
    ``bchunk`` rows — the whole table when it fits — ``producers`` warps
    running phase 1 of the ``threads``, and the dynamic shared memory."""
    group: int
    ctile: int
    kchunk: int
    bchunk: int
    nkp: int
    producers: int
    threads: int
    smem: int


CELL_WARPS = 20     # cell_stats.cuh's ICLN_CELL_MAX_THREADS / 32


def cell_stats_smem(nbin: int, group: int, kchunk: int, bchunk: int) -> int:
    """Bytes of ``cell_stats.cuh``'s shared memory (its
    ``icln_cell_layout``): two mbarriers, the cos and sin table chunks,
    two buffers of centred rows ``[b][cell]``, two stage slots of
    ``group`` rows (none at one cell a group: phase 1 then works in the
    centred-row buffers), the per-cell maxima, two rows each of weights
    and mask bytes."""
    slot = -(-group * nbin * 4 // 16) * 16
    stages = 0 if group == 1 else 2 * slot
    return 16 + 2 * bchunk * kchunk * 4 + 2 * slot + stages + 14 * group


def cell_stats_geometry(nbin: int):
    """The :class:`CellStatsPlan` of K2, K6, K7 and K10 at ``nbin``.

    A block of ``CELL_WARPS`` warps: the consumers (phase 2) hold at
    most one tile (``ctile`` cells x 4 columns) each per table chunk and
    one cell each for the final write; the rest are producers (phase 1,
    one warp per cell).  Among the plans whose shared memory fits a
    block, the one with the least estimated time per cell: the larger of
    the consumers' DFT issue slots (chunks x rows x the 3 shared loads
    and 8 * ctile FMAs of a row, per busy warp, over at most 4
    schedulers) and the producers' latency (about 1000 clocks a cell per
    warp), a fifth of the other, and the table refills of a chunked
    plan."""
    _check_nbin(nbin)
    nk = nbin // 2 + 1
    nkp = -(-nk // 4) * 4
    ktiles = nkp // 4
    best = None
    for ctile in (4, 1):
        for group in range(ctile, 32 * (CELL_WARPS - 8) + 1, ctile):
            ct = group // ctile
            per = min(ktiles, 32 * (CELL_WARPS - 8) // ct)
            if per == 0:
                break
            nkc = -(-ktiles // per)
            per = -(-ktiles // nkc)
            consumers = -(-max(ct * per, group) // 32)
            producers = CELL_WARPS - consumers
            kchunk = 4 * per
            room = _SMEM_LIMIT - cell_stats_smem(nbin, group, kchunk, 0)
            bchunk = min(nbin, room // (8 * kchunk)) if room > 0 else 0
            if bchunk < 1:
                continue
            nbc = -(-nbin // bchunk)
            dft = (-(-ct * per // 32) * nkc * nbin * (3 + 8 * ctile)
                   / min(4, consumers))
            phase1 = -(-group // producers) * 1000
            refill = (0 if nkc == nbc == 1
                      else nkc * nbc * 2000 + 8 * nbin * nkp // (32 * consumers))
            cost = (max(dft, phase1) + min(dft, phase1) / 5 + refill) / group
            if best is None or cost < best[0]:
                smem = cell_stats_smem(nbin, group, kchunk, bchunk)
                best = (cost, CellStatsPlan(group, ctile, kchunk, bchunk, nkp,
                                            producers, 32 * CELL_WARPS, smem))
    if best is None:
        raise NotImplementedError(
            f"nbin {nbin}: no cell-diagnostics plan fits a block")
    return best[1]


@functools.lru_cache(maxsize=8)
def _dft_tables_padded(nbin: int, nkp: int, device: str):
    """The (nbin, nkp) cos/sin tables the kernels read: ``dft_tables``
    with zero columns past nbin/2 + 1 (|X|^2 = 0 there, which never wins
    the max; a row holding NaN or inf is NaN in a real column too)."""
    out = []
    for t in dft_tables(nbin, torch.float32, torch.device(device)):
        pad = torch.zeros((nbin, nkp), dtype=torch.float32, device=device)
        pad[:, : t.shape[1]] = t
        out.append(pad)
    return tuple(out)


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


def _plain_into(planes, out):
    """The plain version's planes, written into ``out`` when given (the
    kernels' ``out=``): the CPU path of a tile that fills its rows of the
    full planes."""
    if out is None:
        return planes
    for o, p in zip(out, planes):
        o.copy_(p)
    return tuple(out)


def _launch_cell_stats(entry, cube, template, weights, cell_mask, cubes,
                       chan_rows, bin_rows, ptrs, out=None):
    """Check and launch one of the cell-diagnostics kernels (K2, K6, K7
    and K10 share ``cell_stats.cuh``'s kernel and launch plan).
    ``cubes``, ``chan_rows`` and ``bin_rows`` are ``(name, tensor)``
    pairs checked as (nsub, nchan, nbin) cubes, (nchan, nbin) rows and
    (nbin,) rows; ``ptrs`` are the entry's leading pointer arguments in
    order.  ``out`` is an optional 4-tuple of contiguous (nsub, nchan)
    float32 views the kernel writes (a tile's rows of the full planes).
    Returns the entry's return code and the four (nsub, nchan) planes."""
    nsub, nchan, nbin = cube.shape
    for name, t in cubes:
        _require(t, name, torch.float32, (nsub, nchan, nbin))
    for name, t in chan_rows:
        _require(t, name, torch.float32, (nchan, nbin))
    for name, t in bin_rows:
        _require(t, name, torch.float32, (nbin,))
    _require(template, "template", torch.float32, (nbin,))
    _require(weights, "weights", torch.float32, (nsub, nchan))
    _require(cell_mask, "cell_mask", torch.bool, (nsub, nchan))
    plan = cell_stats_geometry(nbin)
    info = tt_info(template)
    cos_t, sin_t = _dft_tables_padded(nbin, plan.nkp, str(cube.device))
    if out is None:
        outs = [torch.empty((nsub, nchan), dtype=torch.float32,
                            device=cube.device) for _ in range(4)]
    else:
        outs = list(out)
        for i, o in enumerate(outs):
            if o.device != cube.device:
                raise ValueError(f"out[{i}] on {o.device}, cube on "
                                 f"{cube.device}")
            _require(o, f"out[{i}]", torch.float32, (nsub, nchan))
    ncells = nsub * nchan
    per_sm = max(1, min(2048 // plan.threads,
                        (_SMEM_LIMIT + 1024) // (plan.smem + 1024)))
    grid = max(1, min(-(-ncells // plan.group),
                      per_sm * _sm_count(str(cube.device))))
    inv_n = float(np.float32(1.0 / nbin))
    fn = getattr(load_library(), entry)
    with torch.cuda.device(cube.device):
        rc = fn(*ptrs, _ptr(cos_t), _ptr(sin_t), _ptr(info),
                *(_ptr(o) for o in outs), ncells, nchan, nbin, plan.group,
                plan.ctile, plan.kchunk, plan.bchunk, plan.nkp, plan.producers,
                plan.threads,
                grid, plan.smem, inv_n, _stream(cube))
    return rc, tuple(outs)


def cell_diagnostics_disp(disp, rot_t, nyq_row, template, weights,
                          cell_mask, out=None):
    """``(d_std, d_mean, d_ptp, d_fft)`` of the dispersed-frame weighted
    residual — kernel K2 on the card, :func:`cell_diagnostics_disp_plain`
    on the CPU.  ``nyq_row`` is None where the rotation round-trips
    exactly (roll, odd nbin); ``out`` as in :func:`_launch_cell_stats`."""
    if not _on_card(disp, rot_t, template, weights, cell_mask):
        return _plain_into(cell_diagnostics_disp_plain(
            disp, rot_t, nyq_row, template, weights, cell_mask), out)
    rows = [("rot_t", rot_t)] + ([] if nyq_row is None
                                 else [("nyq_row", nyq_row)])
    rc, outs = _launch_cell_stats(
        "icln_cell_stats_disp", disp, template, weights, cell_mask,
        [("disp", disp)], rows, [],
        [_ptr(disp), _ptr(rot_t), None if nyq_row is None else _ptr(nyq_row),
         _ptr(weights), _ptr(cell_mask)], out)
    cell_diagnostics_disp.launches += 1
    _check_rc(rc, "cell_diagnostics_disp")
    return outs


cell_diagnostics_disp.launches = 0


# --------------------------------------------------------------------------
# K7: two-read cell diagnostics (pulse window, profile baseline, DEDISP=1)
# --------------------------------------------------------------------------

def wres_two_read(ded, disp_base, rot_t, template, weights):
    """Two-read weighted residual (the reference's ``_cell_stats_kernel``
    body): the fit ``<ded, t>`` against the UNWINDOWED template, the
    residual ``amp * rot_t - disp_base`` in the dispersed frame,
    weighting."""
    amp = fit_template_amplitudes(ded, template)
    resid = amp[:, :, None] * rot_t[None] - disp_base
    return resid * weights[:, :, None]


def cell_diagnostics_two_read_plain(ded, disp_base, rot_t, template,
                                    weights, cell_mask):
    """The plain version of K7: :func:`wres_two_read`, then
    :func:`~iterative_cleaner_torch.stats.masked_torch.cell_diagnostics`
    with the DFT."""
    wres = wres_two_read(ded, disp_base, rot_t, template, weights)
    return cell_diagnostics(wres, cell_mask, "dft")


def cell_diagnostics_two_read(ded, disp_base, rot_t, template, weights,
                              cell_mask, out=None):
    """``(d_std, d_mean, d_ptp, d_fft)`` of the two-read weighted
    residual — kernel K7 on the card,
    :func:`cell_diagnostics_two_read_plain` on the CPU.  ``rot_t`` is the
    rotation of the WINDOWED template, ``template`` the unwindowed one
    the fit uses; ``out`` as in :func:`_launch_cell_stats`."""
    if not _on_card(ded, disp_base, rot_t, template, weights, cell_mask):
        return _plain_into(cell_diagnostics_two_read_plain(
            ded, disp_base, rot_t, template, weights, cell_mask), out)
    rc, outs = _launch_cell_stats(
        "icln_cell_stats_two_read", ded, template, weights, cell_mask,
        [("ded", ded), ("disp_base", disp_base)], [("rot_t", rot_t)], [],
        [_ptr(ded), _ptr(disp_base), _ptr(rot_t), _ptr(template),
         _ptr(weights), _ptr(cell_mask)], out)
    cell_diagnostics_two_read.launches += 1
    _check_rc(rc, "cell_diagnostics_two_read")
    return outs


cell_diagnostics_two_read.launches = 0


# --------------------------------------------------------------------------
# K6: dedispersed-frame cell diagnostics (K5 = K6 + K3 x 2 + combine)
# --------------------------------------------------------------------------

def wres_dedisp(ded, template, window, weights):
    """Dedispersed-frame weighted residual (the reference's
    ``_wres_dedisp``): ``(amp * t - ded) * window``, weighted."""
    amp = fit_template_amplitudes(ded, template)
    resid = (amp[:, :, None] * template - ded) * window
    return resid * weights[:, :, None]


def cell_diagnostics_dedisp_plain(ded, template, window, weights,
                                  cell_mask):
    """The plain version of K6: :func:`wres_dedisp`, then
    :func:`~iterative_cleaner_torch.stats.masked_torch.cell_diagnostics`
    with the DFT."""
    wres = wres_dedisp(ded, template, window, weights)
    return cell_diagnostics(wres, cell_mask, "dft")


def cell_diagnostics_dedisp(ded, template, window, weights, cell_mask,
                            out=None):
    """``(d_std, d_mean, d_ptp, d_fft)`` of the dedispersed-frame
    weighted residual — kernel K6 on the card,
    :func:`cell_diagnostics_dedisp_plain` on the CPU.  ``window`` is the
    (nbin,) pulse-window multiplier (all ones when the window is off);
    ``out`` as in :func:`_launch_cell_stats`."""
    if not _on_card(ded, template, window, weights, cell_mask):
        return _plain_into(cell_diagnostics_dedisp_plain(
            ded, template, window, weights, cell_mask), out)
    rc, outs = _launch_cell_stats(
        "icln_cell_stats_dedisp", ded, template, weights, cell_mask,
        [("ded", ded)], [], [("window", window)],
        [_ptr(ded), _ptr(template), _ptr(window), _ptr(weights),
         _ptr(cell_mask)], out)
    cell_diagnostics_dedisp.launches += 1
    _check_rc(rc, "cell_diagnostics_dedisp")
    return outs


cell_diagnostics_dedisp.launches = 0


# --------------------------------------------------------------------------
# K10: one rank's shard of the cell-sharded clean (K2's and K6's values)
# --------------------------------------------------------------------------

def shard_diagnostics_disp(disp, rot_t, nyq_row, template, weights,
                           cell_mask):
    """K2's four planes on one rank's (subint, channel) shard — kernel
    K10 on the card (K2's kernel under the shard's entry and launch
    count, so bit-equal to :func:`cell_diagnostics_disp` on the same
    shard), :func:`cell_diagnostics_disp_plain` on the CPU.  ``rot_t``
    and ``nyq_row`` are the shard's channel rows."""
    if not _on_card(disp, rot_t, template, weights, cell_mask):
        return cell_diagnostics_disp_plain(disp, rot_t, nyq_row, template,
                                           weights, cell_mask)
    rows = [("rot_t", rot_t)] + ([] if nyq_row is None
                                 else [("nyq_row", nyq_row)])
    rc, outs = _launch_cell_stats(
        "icln_shard_stats_disp", disp, template, weights, cell_mask,
        [("disp", disp)], rows, [],
        [_ptr(disp), _ptr(rot_t), None if nyq_row is None else _ptr(nyq_row),
         _ptr(weights), _ptr(cell_mask)])
    shard_diagnostics_disp.launches += 1
    _check_rc(rc, "shard_diagnostics_disp")
    return outs


shard_diagnostics_disp.launches = 0


def shard_diagnostics_dedisp(ded, template, window, weights, cell_mask):
    """K6's four planes on one rank's shard — kernel K10 on the card
    (bit-equal to :func:`cell_diagnostics_dedisp` on the same shard),
    :func:`cell_diagnostics_dedisp_plain` on the CPU."""
    if not _on_card(ded, template, window, weights, cell_mask):
        return cell_diagnostics_dedisp_plain(ded, template, window, weights,
                                             cell_mask)
    rc, outs = _launch_cell_stats(
        "icln_shard_stats_dedisp", ded, template, weights, cell_mask,
        [("ded", ded)], [], [("window", window)],
        [_ptr(ded), _ptr(template), _ptr(window), _ptr(weights),
         _ptr(cell_mask)])
    shard_diagnostics_dedisp.launches += 1
    _check_rc(rc, "shard_diagnostics_dedisp")
    return outs


shard_diagnostics_dedisp.launches = 0


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


# --------------------------------------------------------------------------
# K9: the masked median along one axis
# --------------------------------------------------------------------------

# Entries of a line one block of K9 takes: longer lines spread over
# blocks (the residual-std telemetry's line of 4,194,304 cells over 1024).
MEDIAN_BLOCK_ENTRIES = 4096
SELECT_MAX_THREADS = 1024   # threads of a block-select launch (K3, K9)
# Static shared memory of the block-select kernels (the select's state
# and per-line flags, under 1 KB) beside their dynamic shared memory.
SELECT_STATIC_SMEM = 1024


def _select_threads(entries: int) -> int:
    """Threads of a block select over ``entries`` keys in all: about 8
    keys a thread a pass, 64 to SELECT_MAX_THREADS, a multiple of 32."""
    return min(SELECT_MAX_THREADS, max(64, -(-entries // 8 // 32) * 32))


def _key_stride(n: int) -> int:
    """Shared-memory int32 keys a line of ``n`` takes (common.cuh's
    ``icln_key_stride``): ``n`` rounded up to 32, plus 4, so that rows stay
    16-byte aligned and adjacent lines start 4 banks apart."""
    return -(-n // 32) * 32 + 4


class MedianPlan(NamedTuple):
    """K9's launch on lines of ``n`` entries: ``route`` ``"block"`` (one
    kernel; ``lines`` lines a block of ``threads``, ``smem`` bytes of
    dynamic shared memory) or ``"grid"`` (a memset of the scratch and four
    kernels, one a pass; a line over ``bpl`` blocks of ``chunk`` entries,
    256 threads)."""
    route: str
    chunk: int
    bpl: int
    lines: int
    threads: int
    smem: int


def masked_median_geometry(n: int, dim: int = 1) -> MedianPlan:
    """K9's :class:`MedianPlan` on lines of ``n`` entries along ``dim``:
    the block route where a line has at most MEDIAN_BLOCK_ENTRIES (8
    lines a block along dim 0, whose lines are columns: a warp then reads
    32-byte row segments; 1 along dim 1), else the grid route with as few
    blocks a line as hold MEDIAN_BLOCK_ENTRIES each, the entries shared out
    evenly."""
    bpl = max(1, -(-n // MEDIAN_BLOCK_ENTRIES))
    if bpl > 1:
        return MedianPlan("grid", -(-n // bpl), bpl, 1, 256, 0)
    lines = 8 if dim == 0 else 1
    smem = 4 * lines * (_key_stride(n) + 256)
    return MedianPlan("block", n, 1, lines, _select_threads(lines * n), smem)


def masked_median(values, mask, dim):
    """``np.ma.median`` of the float32 ``values`` along ``dim`` (0 or
    1, keepdims) over the entries whose bool ``mask`` is False; 0.0 on a
    line with no valid entry.  Kernel K9 on the card,
    ``masked_median_keys(values, mask, dim)[0]`` on the CPU; bit-equal to
    the reference's ``masked_median_pallas``."""
    if values.dtype != torch.float32:
        raise TypeError(f"masked_median requires float32, got {values.dtype}")
    if dim not in (0, 1):
        raise ValueError("dim must be 0 or 1 for 2-D values")
    if values.dim() != 2:
        raise ValueError(f"values must be 2-D, got {tuple(values.shape)}")
    if not _on_card(values, mask):
        return masked_median_keys(values, mask, dim)[0]
    nrow, ncol = values.shape
    _require(values, "values", torch.float32, (nrow, ncol))
    _require(mask, "mask", torch.bool, (nrow, ncol))
    if dim == 0:
        n, nlines, line_stride, elem_stride = nrow, ncol, 1, ncol
        out = torch.empty((1, ncol), dtype=torch.float32, device=values.device)
    else:
        n, nlines, line_stride, elem_stride = ncol, nrow, ncol, 1
        out = torch.empty((nrow, 1), dtype=torch.float32, device=values.device)
    if n == 0 or nlines == 0:
        raise ValueError(f"masked_median of an empty line set "
                         f"{tuple(values.shape)} along dim {dim}")
    plan = masked_median_geometry(n, dim)
    # the grid route's 256 histogram bins and five per-line states (see
    # masked_median.cu); the block route needs none
    scratch = torch.empty((nlines * 261 if plan.route == "grid" else 1,),
                          dtype=torch.int32, device=values.device)
    lib = load_library()
    with torch.cuda.device(values.device):
        rc = lib.icln_masked_median(
            _ptr(values), _ptr(mask), _ptr(out), _ptr(scratch), n, nlines,
            line_stride, elem_stride, plan.chunk, plan.bpl, plan.lines,
            plan.threads, plan.smem, _stream(values))
    masked_median.launches += 1
    _check_rc(rc, "masked_median")
    return out


masked_median.launches = 0


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


# --------------------------------------------------------------------------
# The scaler's tail on long lines: K9 for the medians, two elementwise
# kernels for the centring and the side (csrc/sides_tail.cu)
# --------------------------------------------------------------------------

class SidesPlan(NamedTuple):
    """K3's launch (``scaled_sides.cu``): ``lines`` (W) adjacent lines a
    block, ``diags`` (D) of the four diagnostics selected at once (in
    4 / D turns), ``threads`` a block and ``smem`` bytes of dynamic shared
    memory."""
    lines: int
    diags: int
    threads: int
    smem: int


def scaled_sides_smem(n: int, diags: int, lines: int) -> int:
    """Bytes of K3's dynamic shared memory: ``lines * diags`` lines of
    int32 keys and 256 int32 bins each, and each line's mask as bits."""
    return 4 * (lines * diags * (_key_stride(n) + 256)
                + lines * -(-n // 32))


def _sides_fits(n: int, diags: int, lines: int) -> bool:
    return (scaled_sides_smem(n, diags, lines) + SELECT_STATIC_SMEM
            <= _SMEM_LIMIT)


def scaled_sides_geometry(n: int, axis: int) -> SidesPlan:
    """K3's :class:`SidesPlan` on lines of ``n`` entries along ``axis``:
    the most lines a block that fit — along axis 0 (a line is a column of
    the row-major plane) up to 8, so that a warp reads 32-byte row
    segments; along axis 1 (a line is a row) one — then the most
    diagnostics at once (4, 2 or 1) whose keys fit with them.  Along axis 0
    the wide reads are worth more than the diagnostics at once: at 2048
    subints 8 columns x 2 diagnostics take 0.49 ms against 0.59 for 4 x 4,
    at 4096 8 x 1 take 0.97 ms against 1.19 for 4 x 2 and 1.49 for 2 x 4
    (``tools/time_cell_stats.py --k3-plans``, H100 80GB HBM3 at 700 W).
    Every block line of :func:`scaled_sides_route` has a plan."""
    for lines in ((8, 4, 2, 1) if axis == 0 else (1,)):
        for diags in (4, 2, 1):
            if _sides_fits(n, diags, lines):
                return SidesPlan(lines, diags, _select_threads(lines * n),
                                 scaled_sides_smem(n, diags, lines))
    raise ValueError(f"scaled_sides: lines of {n} entries do not fit a "
                     f"block (scaled_sides_route takes them long)")


# The longest line K3 takes in one block; longer lines go through
# scaled_sides_long.  The boundary is kept where the port has always drawn
# it, so that no shape changes route.
LONGEST_BLOCK_LINE = 46486


def scaled_sides_route(n: int) -> str:
    """``"block"`` where K3 takes a line of ``n`` entries in one block
    (n up to LONGEST_BLOCK_LINE), ``"long"`` above."""
    return "block" if n <= LONGEST_BLOCK_LINE else "long"


def _line_dims(plane, axis):
    nsub, nchan = plane.shape
    return (1, nchan) if axis == 0 else (nsub, 1)


def side_centre_plain(d, mask, med, axis, masked):
    """The plain version of :func:`side_centre`."""
    centred = torch.where(mask, d, d - med) if masked else d - med
    absc = torch.abs(centred)
    if masked:
        return centred, absc, None
    flags = (torch.any(torch.isnan(d), dim=axis, keepdim=True).to(torch.int32)
             | 2 * torch.any(torch.isnan(absc), dim=axis,
                             keepdim=True).to(torch.int32))
    return centred, absc, flags


def side_centre(d, mask, med, axis, masked):
    """``(centred, |centred|, flags)`` of one diagnostic plane around its
    per-line median ``med`` (keepdims along ``axis``): masked entries
    pass through when ``masked``; on the plain path ``flags`` holds per
    line bit 1 (a NaN in ``d``) and bit 2 (a NaN magnitude), else None.
    The side_centre kernel on the card, :func:`side_centre_plain` on the
    CPU."""
    if not _on_card(d, mask, med):
        return side_centre_plain(d, mask, med, axis, masked)
    shape = tuple(d.shape)
    _require(d, "d", torch.float32, shape)
    _require(mask, "mask", torch.bool, shape)
    _require(med, "med", torch.float32, _line_dims(d, axis))
    centred, absc = torch.empty_like(d), torch.empty_like(d)
    flags = None if masked else torch.zeros(_line_dims(d, axis),
                                            dtype=torch.int32,
                                            device=d.device)
    lib = load_library()
    with torch.cuda.device(d.device):
        rc = lib.icln_side_centre(
            _ptr(d), _ptr(mask), _ptr(med), _ptr(centred), _ptr(absc),
            None if masked else _ptr(flags), d.numel(), shape[1], axis,
            int(masked), _stream(d))
    side_centre.launches += 1
    _check_rc(rc, "side_centre")
    return centred, absc, flags


side_centre.launches = 0


def side_scale_plain(centred, mask, mad, flags, axis, thresh, masked):
    """The plain version of :func:`side_scale`: ``_masked_side``, or the
    NaN-patched ``|c / mad| * float32(1/thresh)``."""
    if masked:
        n = torch.sum(~mask, dim=axis, keepdim=True)
        return _masked_side(centred, mad, mask, n, thresh)
    nan = torch.full_like(centred, math.nan)
    ce = torch.where((flags & 1) != 0, nan, centred)
    me = torch.where(flags != 0, torch.full_like(mad, math.nan), mad)
    return torch.abs(ce / me) * inverse_threshold(thresh, ce)


def side_scale(centred, mask, mad, flags, axis, thresh, masked):
    """One scaled side from :func:`side_centre`'s planes and the per-line
    MAD ``mad``: the side_scale kernel on the card,
    :func:`side_scale_plain` on the CPU."""
    if not _on_card(centred, mask, mad):
        return side_scale_plain(centred, mask, mad, flags, axis, thresh,
                                masked)
    shape = tuple(centred.shape)
    _require(centred, "centred", torch.float32, shape)
    _require(mask, "mask", torch.bool, shape)
    _require(mad, "mad", torch.float32, _line_dims(centred, axis))
    if not masked:
        _require(flags, "flags", torch.int32, _line_dims(centred, axis))
    out = torch.empty_like(centred)
    inv_t = float(np.float32(1.0) / np.float32(thresh))
    lib = load_library()
    with torch.cuda.device(centred.device):
        rc = lib.icln_side_scale(
            _ptr(centred), _ptr(mask), _ptr(mad),
            None if masked else _ptr(flags), _ptr(out), centred.numel(),
            shape[1], axis, int(masked), inv_t, _stream(centred))
    side_scale.launches += 1
    _check_rc(rc, "side_scale")
    return out


side_scale.launches = 0


def scaled_sides_long(diagnostics, cell_mask, axis, thresh):
    """K3's function on lines of any length, bit-equal to it: per masked
    diagnostic K9 for the median, :func:`side_centre`, K9 on the
    magnitudes for the MAD, :func:`side_scale`; the rFFT diagnostic the
    same with an all-False mask and the NaN-line flags.  Each step is its
    kernel on the card and its plain version on the CPU."""
    d0, d1, d2, d3 = diagnostics
    outs = []
    for d in (d0, d1, d2):
        med = masked_median(d, cell_mask, axis)
        centred, absc, _ = side_centre(d, cell_mask, med, axis, True)
        mad = masked_median(absc, cell_mask, axis)
        outs.append(side_scale(centred, cell_mask, mad, None, axis, thresh,
                               True))
    plain = torch.zeros_like(cell_mask)
    med = masked_median(d3, plain, axis)
    centred, absc, flags = side_centre(d3, plain, med, axis, False)
    mad = masked_median(absc, plain, axis)
    outs.append(side_scale(centred, plain, mad, flags, axis, thresh, False))
    return tuple(outs)


def scaled_sides(diagnostics, cell_mask, axis, thresh):
    """All four scaled sides of one orientation: ``axis=0`` scales each
    channel down the subints (channel threshold), ``axis=1`` each subint
    across channels.  Kernel K3 on the card where a line fits a block
    (:func:`scaled_sides_route`), :func:`scaled_sides_long` above;
    :func:`scaled_sides_plain` on the CPU.  Bit-equal to the reference's
    ``scaled_sides_pallas``."""
    if axis not in (0, 1):
        raise ValueError("axis must be 0 or 1")
    if not _on_card(*diagnostics, cell_mask):
        return scaled_sides_plain(diagnostics, cell_mask, axis, thresh)
    nsub, nchan = cell_mask.shape
    for i, d in enumerate(diagnostics):
        _require(d, f"diagnostics[{i}]", torch.float32, (nsub, nchan))
    _require(cell_mask, "cell_mask", torch.bool, (nsub, nchan))
    n = nsub if axis == 0 else nchan
    if scaled_sides_route(n) == "long":
        return scaled_sides_long(diagnostics, cell_mask, axis, thresh)
    plan = scaled_sides_geometry(n, axis)
    if axis == 0:
        nlines, line_stride, elem_stride = nchan, 1, nchan
    else:
        nlines, line_stride, elem_stride = nsub, nchan, 1
    inv_t = float(np.float32(1.0) / np.float32(thresh))
    outs = [torch.empty_like(diagnostics[0]) for _ in range(4)]
    lib = load_library()
    with torch.cuda.device(cell_mask.device):
        rc = lib.icln_scaled_sides(
            *(_ptr(d) for d in diagnostics), _ptr(cell_mask),
            *(_ptr(o) for o in outs), n, nlines, line_stride, elem_stride,
            inv_t, plan.lines, plan.diags, plan.threads, plan.smem,
            _stream(cell_mask))
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


# --------------------------------------------------------------------------
# K8: the combine of exact streaming on the full planes
# --------------------------------------------------------------------------

def fused_combine_plain(diagnostics, cell_mask, orig_weights, chanthresh,
                        subintthresh):
    """The plain version of K8: both orientations'
    :func:`scaled_sides_plain`, then :func:`combine_zap_plain`."""
    chan = scaled_sides_plain(diagnostics, cell_mask, 0, chanthresh)
    sub = scaled_sides_plain(diagnostics, cell_mask, 1, subintthresh)
    return combine_zap_plain(chan, sub, orig_weights)


def fused_combine(diagnostics, cell_mask, orig_weights, chanthresh,
                  subintthresh):
    """``(new_weights, scores)`` from four full (nsub, nchan) diagnostic
    planes: both scaler orientations, the 4-way median and the zap.  On
    the card the sequence K3 axis 0, K3 axis 1, combine (a Hopper block
    cannot hold four full planes, and the axis-1 pass would need a
    grid-wide barrier after the axis-0 one: the port's K4/K5 design);
    :func:`fused_combine_plain` on the CPU.  Bit-equal to the reference's
    ``fused_combine_pallas``, whose (8, 128) padding has no counterpart
    here: nothing is padded on the card."""
    if not _on_card(*diagnostics, cell_mask, orig_weights):
        return fused_combine_plain(diagnostics, cell_mask, orig_weights,
                                   chanthresh, subintthresh)
    chan = scaled_sides(diagnostics, cell_mask, 0, chanthresh)
    sub = scaled_sides(diagnostics, cell_mask, 1, subintthresh)
    out = combine_zap(chan, sub, orig_weights)
    fused_combine.launches += 1   # one sequence of the three launches above
    return out


fused_combine.launches = 0


def reset_launch_counts() -> None:
    weighted_marginals.launches = 0
    cell_diagnostics_disp.launches = 0
    cell_diagnostics_two_read.launches = 0
    cell_diagnostics_dedisp.launches = 0
    shard_diagnostics_disp.launches = 0
    shard_diagnostics_dedisp.launches = 0
    scaled_sides.launches = [0, 0]
    combine_zap.launches = 0
    fused_combine.launches = 0
    masked_median.launches = 0
    side_centre.launches = 0
    side_scale.launches = 0


def launch_counts() -> dict:
    return {
        "weighted_marginals": weighted_marginals.launches,
        "cell_diagnostics_disp": cell_diagnostics_disp.launches,
        "cell_diagnostics_two_read": cell_diagnostics_two_read.launches,
        "cell_diagnostics_dedisp": cell_diagnostics_dedisp.launches,
        "shard_diagnostics_disp": shard_diagnostics_disp.launches,
        "shard_diagnostics_dedisp": shard_diagnostics_dedisp.launches,
        "scaled_sides_axis0": scaled_sides.launches[0],
        "scaled_sides_axis1": scaled_sides.launches[1],
        "combine_zap": combine_zap.launches,
        "fused_combine": fused_combine.launches,
        "masked_median": masked_median.launches,
        "side_centre": side_centre.launches,
        "side_scale": side_scale.launches,
    }
