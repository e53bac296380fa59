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
K3c    :func:`scaled_sides_cluster`       the same, on lines over one block:
       (csrc/sides_cluster.cu)            one thread-block cluster a line
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
K2f    K2's, K6's, K7's, K10's wrappers  no Pallas kernel: the reference's
       (csrc/cell_fft.cu)                 XLA route past 4096 bins
                                          (``masked_jax.cell_diagnostics_jax``
                                          with ``jnp.fft.rfft``)
K2g    the same wrappers                  the same route, on the rows K2f
       (csrc/cell_fft_global.cu)          does not take
tail   :func:`side_centre`,               ``_scaled_sides_body``'s centring
       :func:`side_scale`                 and side on lines too long for a
       (csrc/sides_tail.cu)               cluster (:func:`scaled_sides_long`,
                                          with K9)
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
:func:`configure_build_dir` (``CleanConfig.compile_cache_dir``,
``--compile-cache DIR``, ``ICLEAN_COMPILE_CACHE``) points the build at
another directory before the first build of the process; a process that
finds its digest's library there runs no ``nvcc`` at all
(:func:`library_builds` counts the builds this process ran).

K1, K2, K6, K7 and K10 also read a bf16-stored cube (the mixed-precision
mode, ``CleanConfig.compute_dtype='bfloat16'``), as the TPU functions do:
each element is upcast to float32 where the kernel reads it, and every
other operand, every sum and every output stays float32, so a launch on
a bf16 cube is bit-equal to the float32 launch on ``cube.float()``.  Their
bf16 launches are counted apart (``launches_bf16``; ``<name>_bf16`` in
:func:`launch_counts`).  The plain versions upcast the cube on read.

A batch of B equal-shaped archives (``parallel/batch.py``) is one launch
of each kernel: K1, K2, K6 and K7 take a leading batch dimension on every
per-archive operand (a (B, nsub, nchan, nbin) cube, (B, nsub, nchan)
weights and mask, (B, nchan, nbin) template rows, (B, nbin) templates)
and K3 (B, nsub, nchan) planes; the combine kernel is elementwise and K9
takes the B archives' lines as B lines.  The batch moves only the index:
each archive's outputs are bit-equal to the same kernel launched on that
archive alone.  The plain versions take the batch too, one archive at a
time.

The cell diagnostics (K2, K6, K7 and K10) take one of three builds by
the profile's length, with no knob (:func:`cell_stats_route`): up to
``MAX_NBIN`` bins (``MAX_NBIN_F64`` in float64) the DFT kernels of
``cell_stats.cuh``; past it the FFT build K2f (``cell_fft.cu``: one
thread-block cluster a cell, the spectrum by an rFFT in shared memory,
nbin = 2^a 3^b 5^c within a cluster's capacity), counted apart under the
same wrapper (``launches_fft``, ``launches_fft_bf16``,
``launches_fft_f64``; ``<name>_fft``, ``<name>_fft_bf16`` and
``<name>_fft_f64`` in :func:`launch_counts`); every other length K2g
(``cell_fft_global.cu``: the transform in passes through a scratch
buffer in device memory, Bluestein's chirp convolution where nbin/2 is
not 2^a 3^b 5^c), counted as ``<name>_fftg`` and its bf16 and float64
siblings.  Their plain versions take the DFT or ``torch.fft`` by the
same rule.
:func:`cell_fft_disp` runs K2's FFT build at any length it takes (to
hold it against K2 where both routes take the shape).

float64 (``CleanConfig(dtype="float64")``, the reference's oracle-parity
mode) has builds of K1, K2, K6, K7, K3 (block and cluster), the combine,
K9 and the tail kernels: the same kernels with double storage and
arithmetic and 64-bit order-preserving keys in the selects
(:func:`ordered_key` of a float64 tensor).  No TPU kernel takes float64
(the reference runs it through its XLA route); each float64 build
computes what that route computes, held to its plain version in float64.
Their launches are counted apart (``launches_f64``; ``<name>_f64`` in
:func:`launch_counts`).  K10's float64 build (a float64 shard of the
cell-sharded clean) is K2's and K6's float64 instantiation under K10's
entries, so its planes are bit-equal to theirs on the same shard.
The plain versions follow their inputs' dtype (a bf16 cube is read as
float32).
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

from iterative_cleaner_torch.io.atomic import atomic_output
from iterative_cleaner_torch.ops.dsp import (
    each_archive,
    fit_template_amplitudes,
    fit_template_amplitudes_disp,
    upcast_stored,
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
           "sides_tail.cu", "sides_cluster.cu", "cell_fft.cu",
           "cell_fft_global.cu")
# -fmad=false: no contraction of a*b+c, so the kernels round as the
# reference does; no fast-math; sm_90a (Hopper).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-fmad=false", "-std=c++17", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

# Where the DFT route of the cell diagnostics ends and the FFT builds
# begin (cell_stats_route): the DFT tables, nbin x (nbin/2 + 1) x 8
# bytes, are 1.07 GB on the card at 16384 bins, and a float64 block's two
# centred rows of 16384 bins (256 KB) do not fit its shared memory, so
# float64 profiles leave the DFT route past 8192 bins (0.54 GB of
# tables).  Longer profiles take an FFT build (cell_fft.cu, else
# cell_fft_global.cu), which needs no tables; K1 tiles the bins and takes
# any length.
MAX_NBIN = 16384
MAX_NBIN_F64 = 8192
_SMEM_LIMIT = 232448    # dynamic shared memory one Hopper block may use
_ITEM9 = "ROADMAP item 9, long-profile spectra"


def _check_nbin(nbin: int, realsize: int = 4) -> None:
    """The DFT plan's refusal past its limit (the wrappers route such
    profiles to the FFT build first)."""
    limit = MAX_NBIN_F64 if realsize == 8 else MAX_NBIN
    if nbin > limit:
        what = "float64 " if realsize == 8 else ""
        raise NotImplementedError(
            f"nbin {nbin} > {limit}: past the DFT route for {what}profiles "
            f"(cell_stats_route takes them to an FFT build; {_ITEM9})")


_LIB = None
_LIB_DIR = None          # the directory _LIB was built into / loaded from
_LIB_LOCK = threading.Lock()
_BUILD_DIR_OVERRIDE = None
_LIBRARY_BUILDS = 0      # nvcc builds of the library run by this process
ENV_COMPILE_CACHE = "ICLEAN_COMPILE_CACHE"


def build_dir() -> Path:
    """Where the library is built and looked for: the directory given to
    :func:`configure_build_dir`, else ``ICLEAN_COMPILE_CACHE``, else the
    package's ``_build/``."""
    if _BUILD_DIR_OVERRIDE is not None:
        return _BUILD_DIR_OVERRIDE
    env = os.environ.get(ENV_COMPILE_CACHE, "")
    return Path(env).resolve() if env else BUILD_DIR


def configure_build_dir(directory) -> None:
    """Point the kernel library's build at ``directory`` (created at the
    build); falsy leaves the default.  It must act before the library is
    loaded: ``RuntimeError`` if this process already loaded it from
    another directory (a second copy cannot replace the bound one)."""
    global _BUILD_DIR_OVERRIDE
    if not directory:
        return
    target = Path(directory).resolve()
    with _LIB_LOCK:
        if _LIB is not None and _LIB_DIR != target:
            raise RuntimeError(
                f"the kernel library is already loaded from {_LIB_DIR}; "
                f"configure the build directory {target} before the "
                f"first build of the process")
        _BUILD_DIR_OVERRIDE = target


def library_builds() -> int:
    """How many times this process ran ``nvcc`` to build the library."""
    return _LIBRARY_BUILDS


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
    global _LIBRARY_BUILDS
    where = build_dir()
    out = where / f"libicln_kernels_{_source_digest()}.so"
    if out.exists():
        return out
    nvcc = _nvcc()
    where.mkdir(parents=True, exist_ok=True)
    _LIBRARY_BUILDS += 1
    with tempfile.TemporaryDirectory(dir=where) as tmp:
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
        (where / "build.log").write_text("\n".join(logs))
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        with atomic_output(str(out)) as lib_tmp:
            link = subprocess.run(
                [nvcc, "-shared", "-o", lib_tmp,
                 *(obj for _n, obj, _p in procs)],
                capture_output=True, text=True)
            if link.returncode != 0:
                raise RuntimeError(
                    f"link failed:\n{link.stdout}{link.stderr}")
    return out


_P, _I, _LL, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_double
_SIGNATURES = {
    "icln_weighted_marginals": [_P] * 6 + [_I] * 9 + [_LL, _P],
    "icln_cell_stats_disp": [_P] * 12 + [_LL] * 2 + [_I] * 10
    + [_LL, _D, _I, _P],
    "icln_cell_stats_two_read": [_P] * 13 + [_LL] * 2 + [_I] * 10
    + [_LL, _D, _I, _P],
    "icln_cell_stats_dedisp": [_P] * 12 + [_LL] * 2 + [_I] * 10
    + [_LL, _D, _I, _P],
    "icln_shard_stats_disp": [_P] * 12 + [_LL] * 2 + [_I] * 10
    + [_LL, _D, _I, _P],
    "icln_shard_stats_dedisp": [_P] * 12 + [_LL] * 2 + [_I] * 10
    + [_LL, _D, _I, _P],
    "icln_cell_fft_disp": [_P] * 11 + [_LL] * 2 + [_I] * 5
    + [_LL, _D, _I, _P],
    "icln_cell_fft_two_read": [_P] * 12 + [_LL] * 2 + [_I] * 5
    + [_LL, _D, _I, _P],
    "icln_cell_fft_dedisp": [_P] * 11 + [_LL] * 2 + [_I] * 5
    + [_LL, _D, _I, _P],
    "icln_shard_fft_disp": [_P] * 11 + [_LL] * 2 + [_I] * 5
    + [_LL, _D, _I, _P],
    "icln_shard_fft_dedisp": [_P] * 11 + [_LL] * 2 + [_I] * 5
    + [_LL, _D, _I, _P],
    **{name: [_P] * 16 + [_LL] * 2 + [_I] * 14 + [_D, _I, _P]
       for name in ("icln_cell_fftg_disp", "icln_cell_fftg_dedisp",
                    "icln_shard_fftg_disp", "icln_shard_fftg_dedisp")},
    "icln_cell_fftg_two_read": [_P] * 17 + [_LL] * 2 + [_I] * 14
    + [_D, _I, _P],
    "icln_fftg_passes": [_P, _P, _LL] + [_I] * 9 + [_P] * 3 + [_I] * 4
    + [_P],
    "icln_scaled_sides": [_P] * 9 + [_I, _I, _LL, _LL, _LL, _LL, _D, _I, _I,
                                     _I, _LL, _I, _P],
    "icln_combine_zap": [_P] * 11 + [_LL, _I, _P],
    "icln_masked_median": [_P] * 4 + [_I, _I, _LL, _LL, _I, _I, _I, _I, _LL,
                                      _I, _P],
    "icln_sides_cluster": [_P] * 9 + [_I, _I, _I, _LL, _LL, _LL, _LL, _D,
                                      _I, _I, _I, _I, _LL, _I, _P],
    "icln_side_centre": [_P] * 6 + [_LL, _I, _I, _I, _I, _P],
    "icln_side_scale": [_P] * 5 + [_LL, _I, _I, _I, _D, _I, _P],
}


def load_library():
    """The bound kernel library, built on first use."""
    global _LIB, _LIB_DIR
    with _LIB_LOCK:
        if _LIB is None:
            path = build_library()
            lib = ctypes.CDLL(str(path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.icln_error_string.argtypes = [ctypes.c_int]
            lib.icln_error_string.restype = ctypes.c_char_p
            _LIB, _LIB_DIR = lib, path.parent
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


# the storage dtypes of the cube operands K1, K2, K6, K7 and K10 read
CUBE_DTYPES = (torch.float32, torch.bfloat16, torch.float64)
# the arithmetic (and plane) dtypes: float64 for a float64 cube, float32
# for the others
REAL_DTYPES = (torch.float32, torch.float64)
# the kinds the cube kernels' entries take
_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}


def real_dtype(dtype):
    """The arithmetic dtype of a cube stored as ``dtype``: float64 for
    float64, float32 for float32 and bf16."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _real_of(*tensors):
    """The one real dtype of float planes (float32 or float64); a mix
    raises."""
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1 or not dtypes <= set(REAL_DTYPES):
        raise TypeError(f"expected float32 or float64 planes of one dtype, "
                        f"got {sorted(map(str, dtypes))}")
    return dtypes.pop()


def _inv_thresh(thresh, dtype) -> float:
    """The threshold's reciprocal as the kernels multiply by it:
    float32(1) / float32(thresh) for float32 planes, 1 / thresh for
    float64 (:func:`~iterative_cleaner_torch.stats.masked_torch.
    inverse_threshold`)."""
    if dtype == torch.float64:
        return float(np.float64(1.0) / np.float64(thresh))
    return float(np.float32(1.0) / np.float32(thresh))


def _require(t, name, dtype, shape):
    if t.dtype not in (dtype if isinstance(dtype, tuple) else (dtype,)):
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


_ROUTE_COUNTS = {"dft": "launches", "fft": "launches_fft",
                 "fft_global": "launches_fftg"}


def _count(fn, t, route: str = "dft") -> None:
    """One launch of kernel ``fn``, counted by the dtype of ``t`` (the
    cube, or the planes): ``fn.launches`` (float32), ``fn.launches_bf16``
    or ``fn.launches_f64``; a cell-diagnostics wrapper's FFT builds
    (``route`` ``"fft"``, ``"fft_global"``) under ``fn.launches_fft`` and
    ``fn.launches_fftg`` and their bf16 and float64 siblings."""
    name = _ROUTE_COUNTS[route]
    if t.dtype == torch.bfloat16:
        name += "_bf16"
    elif t.dtype == torch.float64:
        name += "_f64"
    setattr(fn, name, getattr(fn, name) + 1)


def _stack_each(fn, nb: int, *args):
    """The plain version of a batched kernel: ``fn`` on each archive's
    slice of ``args`` (``(tensor, batched)`` pairs; an unbatched tensor,
    or None, is passed whole), each of its outputs stacked along a new
    leading batch dimension."""
    outs = [fn(*(a[b] if batched and a is not None else a
                 for a, batched in args)) for b in range(nb)]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(parts) for parts in zip(*outs))
    return torch.stack(outs)


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
MARGINALS_STAGES = 3        # float32 and bf16 cubes
MARGINALS_STAGES_F64 = 2    # float64 cubes: each stage twice the bytes


def marginals_tiles(nsub: int, nchan: int, nbin: int,
                    sm_count: int = 132, itemsize: int = 4) -> MarginalsPlan:
    """K1's tile plan (``marginals.cu``): whole rows up to 256 bins, the
    bins tiled by 256 above; subint runs sized so that the grid is about
    two waves of two blocks per SM.  ``itemsize``: the cube's element
    bytes (2 for a bf16 cube: its slabs take half the shared memory; 8
    for a float64 one, whose weights and sums are float64 too and whose
    ring has two stages)."""
    realsize = 8 if itemsize == 8 else 4
    bb = nbin if nbin <= 256 else 256
    lanes = 1 << (bb - 1).bit_length()
    cb = MARGINALS_THREADS // lanes * MARGINALS_CHANNELS_PER_THREAD
    ntiles = -(-nchan // cb) * -(-nbin // bb)
    nsb = max(1, min(nsub, 4 * sm_count // ntiles))
    sb = -(-nsub // nsb)
    stages = MARGINALS_STAGES_F64 if itemsize == 8 else MARGINALS_STAGES
    smem = 32 + realsize * 2 * MARGINALS_THREADS \
        + stages * (cb * bb * itemsize + realsize * cb)
    return MarginalsPlan(sb, cb, bb, lanes, smem)


def weighted_marginals_plain(disp, weights):
    """The plain version of K1: :func:`weighted_marginal_totals` of the
    cube as it computes (:func:`upcast_stored`), per archive of a
    batch."""
    disp = upcast_stored(disp)
    if disp.dim() == 4:
        return _stack_each(weighted_marginal_totals, disp.shape[0],
                           (disp, True), (weights, True))
    return weighted_marginal_totals(disp, weights)


def weighted_marginals(disp, weights):
    """``(A, t1)`` with ``A[c] = sum_s w*disp`` and ``t1[s] = sum_c
    w*disp`` — kernel K1 on the card, :func:`weighted_marginals_plain`
    on the CPU.  A batch, (B, nsub, nchan, nbin) ``disp`` and (B, nsub,
    nchan) ``weights``, gives (B, nchan, nbin) and (B, nsub, nbin) in one
    launch (grid.z the archive, one archive's plan).  ``disp`` may be
    bf16-stored (the outputs stay float32) or float64 (the weights and
    the outputs float64: the float64 build)."""
    if not _on_card(disp, weights):
        return weighted_marginals_plain(disp, weights)
    batched = disp.dim() == 4
    nb = disp.shape[0] if batched else 1
    nsub, nchan, nbin = disp.shape[-3:]
    lead = (nb,) if batched else ()
    real = real_dtype(disp.dtype)
    _require(disp, "disp", CUBE_DTYPES, lead + (nsub, nchan, nbin))
    _require(weights, "weights", real, lead + (nsub, nchan))
    plan = marginals_tiles(nsub, nchan, nbin, _sm_count(str(disp.device)),
                           disp.element_size())
    nsb, ncb = -(-nsub // plan.sb), -(-nchan // plan.cb)
    kw = dict(dtype=real, device=disp.device)
    a_part = torch.empty((nb, nsb, nchan, nbin), **kw)
    t1_part = torch.empty((nb, ncb, nsub, nbin), **kw)
    a = torch.empty(lead + (nchan, nbin), **kw)
    t1 = torch.empty(lead + (nsub, nbin), **kw)
    lib = load_library()
    with torch.cuda.device(disp.device):
        rc = lib.icln_weighted_marginals(
            _ptr(disp), _ptr(weights), _ptr(a_part), _ptr(t1_part), _ptr(a),
            _ptr(t1), nb, nsub, nchan, nbin, plan.sb, plan.cb, plan.bb,
            plan.lanes, _KIND[disp.dtype], plan.smem, _stream(disp))
    _count(weighted_marginals, disp)
    _check_rc(rc, "weighted_marginals")
    return a, t1


weighted_marginals.launches = 0
weighted_marginals.launches_bf16 = 0
weighted_marginals.launches_f64 = 0


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
    device tensor, so K2 reads it without a host round trip; (B, 2) for
    a batch's (B, nbin) templates, each row taken as one archive's (the
    sum's order then does not depend on the batch)."""
    tt = each_archive(torch.sum, 1, template * template)
    return torch.stack([torch.where(tt == 0, torch.ones_like(tt), tt),
                        (tt == 0).to(template.dtype)], dim=-1)


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
CELL_WARPS_F64 = 16  # ICLN_CELL_MAX_THREADS_F64 / 32: double accumulators


def cell_stats_smem(nbin: int, group: int, kchunk: int, bchunk: int,
                    itemsize: int = 4, realsize: int = 4) -> int:
    """Bytes of ``cell_stats.cuh``'s shared memory (its
    ``icln_cell_layout``): two mbarriers, the cos and sin table chunks,
    two buffers of centred rows ``[b][cell]``, two stage slots of
    ``group`` rows of ``itemsize``-byte cube elements (none at one cell a
    group: phase 1 then works in the centred-row buffers), the per-cell
    maxima, two rows each of weights and mask bytes; the tables, rows,
    maxima and weights of the ``realsize``-byte arithmetic type (8 for a
    float64 cube)."""
    slot = -(-group * nbin * realsize // 16) * 16
    stage = -(-group * nbin * itemsize // 16) * 16
    stages = 0 if group == 1 else 2 * stage
    return (16 + 2 * bchunk * kchunk * realsize + 2 * slot + stages
            + (3 * realsize + 2) * group)


def cell_stats_plans(nbin: int, itemsize: int = 4):
    """Every :class:`CellStatsPlan` of K2, K6, K7 and K10 at ``nbin``
    whose shared memory fits a block, each with its estimated time per
    cell, as ``(cost, plan)`` in :func:`cell_stats_geometry`'s order.

    A block of ``CELL_WARPS`` warps: the consumers (phase 2) hold at
    most one tile (``ctile`` cells x 4 columns) each per table chunk and
    one cell each for the final write; the rest are producers (phase 1,
    one warp per cell).  The estimate: the larger of the consumers' DFT
    issue slots (chunks x rows x the 3 shared loads and 8 * ctile FMAs of
    a row, per busy warp, over at most 4 schedulers) and the producers'
    latency (about 1000 clocks a cell per warp), a fifth of the other,
    and the table refills of a chunked plan (2000 clocks a chunk).
    ``itemsize``: the cube's element bytes (2 for bf16, whose stage slots
    are half the size; 8 for float64, whose arithmetic, tables and rows
    are float64 too and whose block has CELL_WARPS_F64 warps).  For
    float64 a row's loads take twice the slots (two 16-byte words per
    four values) and its FMAs twice (DFMA at half the FFMA rate), and a
    refill 250 clocks: the constants that pick the fastest or a plan
    within 10% of it at nbin 64, 128, 256 and 512 among every plan timed
    on one H100 (``tools/time_cell_stats.py --f64-plans``; PERF.md)."""
    realsize = 8 if itemsize == 8 else 4
    warps = CELL_WARPS_F64 if realsize == 8 else CELL_WARPS
    wide = realsize // 4          # 2 for float64: twice the load/FMA slots
    refill_clocks = 250 if realsize == 8 else 2000
    _check_nbin(nbin, realsize)
    nk = nbin // 2 + 1
    nkp = -(-nk // 4) * 4
    ktiles = nkp // 4
    for ctile in (4, 1):
        for group in range(ctile, 32 * (warps - 8) + 1, ctile):
            ct = group // ctile
            per = min(ktiles, 32 * (warps - 8) // ct)
            if per == 0:
                break
            nkc = -(-ktiles // per)
            per = -(-ktiles // nkc)
            consumers = -(-max(ct * per, group) // 32)
            producers = warps - consumers
            kchunk = 4 * per
            room = _SMEM_LIMIT - cell_stats_smem(nbin, group, kchunk, 0,
                                                 itemsize, realsize)
            bchunk = min(nbin, room // (2 * realsize * kchunk)) \
                if room > 0 else 0
            if bchunk < 1:
                continue
            nbc = -(-nbin // bchunk)
            dft = (-(-ct * per // 32) * nkc * nbin * wide * (3 + 8 * ctile)
                   / min(4, consumers))
            phase1 = -(-group // producers) * 1000
            refill = (0 if nkc == nbc == 1
                      else nkc * nbc * refill_clocks
                      + 8 * nbin * nkp // (32 * consumers))
            cost = (max(dft, phase1) + min(dft, phase1) / 5 + refill) / group
            smem = cell_stats_smem(nbin, group, kchunk, bchunk, itemsize,
                                   realsize)
            yield cost, CellStatsPlan(group, ctile, kchunk, bchunk, nkp,
                                      producers, 32 * warps, smem)


@functools.lru_cache(maxsize=64)
def cell_stats_geometry(nbin: int, itemsize: int = 4):
    """The :class:`CellStatsPlan` of K2, K6, K7 and K10 at ``nbin``: of
    :func:`cell_stats_plans`, the first with the least estimated time
    per cell.  The planes do not depend on the plan."""
    best = None
    for cost, plan in cell_stats_plans(nbin, itemsize):
        if best is None or cost < best[0]:
            best = (cost, plan)
    if best is None:
        raise NotImplementedError(
            f"nbin {nbin}: no cell-diagnostics plan fits a block")
    return best[1]


@functools.lru_cache(maxsize=8)
def _dft_tables_padded(nbin: int, nkp: int, device: str,
                       dtype=torch.float32):
    """The (nbin, nkp) cos/sin tables the kernels read: ``dft_tables``
    at the arithmetic ``dtype`` (float64 for the float64 builds) with
    zero columns past nbin/2 + 1 (|X|^2 = 0 there, which never wins the
    max; a row holding NaN or inf is NaN in a real column too)."""
    out = []
    for t in dft_tables(nbin, dtype, torch.device(device)):
        pad = torch.zeros((nbin, nkp), dtype=dtype, device=device)
        pad[:, : t.shape[1]] = t
        out.append(pad)
    return tuple(out)


@functools.lru_cache(maxsize=8)
def _sm_count(device: str) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def cell_stats_route(nbin: int, itemsize: int = 4) -> str:
    """Which build of the cell diagnostics (K2, K6, K7, K10) takes
    profiles of ``nbin`` bins of a cube of ``itemsize``-byte elements (8:
    float64; 4 and 2, float32 and bf16, share the float32 limits):
    ``"dft"`` (``cell_stats.cuh``, the DFT tables) up to MAX_NBIN
    (MAX_NBIN_F64 in float64); above it ``"fft"`` (the cluster build K2f,
    ``cell_fft.cu``) where :func:`cell_fft_plan` takes the row (odd parts
    of at most FFT_ODD_STAGES stages, where it is the faster), else
    ``"fft_global"`` (the device-memory build K2g, ``cell_fft_global.cu``,
    :func:`cell_fft_global_plan`).  A function of the shape alone, decided
    before anything is launched."""
    limit = MAX_NBIN_F64 if itemsize == 8 else MAX_NBIN
    if nbin <= limit:
        return "dft"
    if _cell_fft_takes(nbin, 8 if itemsize == 8 else 4)[0]:
        return "fft"
    cell_fft_global_plan(nbin, itemsize)
    return "fft_global"


def _spectrum(route: str) -> str:
    """The plain versions' spectrum on a route: the DFT on ``"dft"``,
    ``torch.fft`` on both FFT builds' routes."""
    return "dft" if route == "dft" else "fft"


def _cube_itemsize(cube) -> int:
    """The element bytes the cell-diagnostics route is chosen by: 8 for
    a float64 cube, 4 for float32 and bf16 (which compute in float32)."""
    return 8 if cube.dtype == torch.float64 else 4


def cell_diagnostics_disp_plain(disp, rot_t, nyq_row, template, weights,
                                cell_mask, spectrum=None):
    """The plain version of K2: :func:`wres_disp` of the cube as it
    computes (:func:`upcast_stored`), then :func:`~iterative_cleaner_torch.
    stats.masked_torch.cell_diagnostics` (per archive of a batch), the
    spectrum by the DFT or ``torch.fft`` as :func:`cell_stats_route`
    routes the shape (``spectrum`` ``"dft"`` or ``"fft"`` fixes it; both
    FFT builds' routes take ``torch.fft``)."""
    disp = upcast_stored(disp)
    spectrum = spectrum or _spectrum(cell_stats_route(disp.shape[-1],
                                                      _cube_itemsize(disp)))
    if disp.dim() == 4:
        return _stack_each(
            lambda *a: cell_diagnostics_disp_plain(*a, spectrum=spectrum),
            disp.shape[0], (disp, True), (rot_t, True), (nyq_row, True),
            (template, True), (weights, True), (cell_mask, True))
    wres = wres_disp(disp, rot_t, nyq_row, template, weights)
    return cell_diagnostics(wres, cell_mask, spectrum)


def _plain_into(planes, out):
    """The plain version's planes, written into ``out`` when given (the
    kernels' ``out=``): the CPU path of a tile that fills its rows of the
    full planes."""
    if out is None:
        return planes
    for o, p in zip(out, planes):
        o.copy_(p)
    return tuple(out)


def _inv_n(nbin: int, real) -> float:
    """1/nbin as the kernels multiply by it: float32(1/nbin) for float32
    arithmetic, 1/nbin for float64."""
    return 1.0 / nbin if real == torch.float64 \
        else float(np.float32(1.0 / nbin))


# the FFT builds' entries beside each DFT entry (cell_fft.cu: "fft";
# cell_fft_global.cu: "fft_global")
_FFT_ENTRIES = {"icln_cell_stats_disp": "icln_cell_fft_disp",
                "icln_cell_stats_two_read": "icln_cell_fft_two_read",
                "icln_cell_stats_dedisp": "icln_cell_fft_dedisp",
                "icln_shard_stats_disp": "icln_shard_fft_disp",
                "icln_shard_stats_dedisp": "icln_shard_fft_dedisp"}
_FFTG_ENTRIES = {k: v.replace("_fft_", "_fftg_")
                 for k, v in _FFT_ENTRIES.items()}


def _launch_cell_stats(entry, cube, template, weights, cell_mask, cubes,
                       chan_rows, bin_rows, ptrs, out=None, route=None):
    """Check and launch one of the cell-diagnostics kernels (K2, K6, K7
    and K10 share ``cell_stats.cuh``'s kernel and launch plan, and past
    the DFT tables ``cell_fft.cu``'s or ``cell_fft_global.cu``'s).
    ``entry`` names the DFT entry; ``route`` (``"dft"``, ``"fft"`` or
    ``"fft_global"``, else :func:`cell_stats_route` of the shape) picks
    the build.  ``cubes``, ``chan_rows`` and ``bin_rows``
    are ``(name, tensor)`` pairs checked as (nsub, nchan, nbin) cubes,
    (nchan, nbin) rows and (nbin,) rows; ``ptrs`` are the entry's leading
    pointer arguments in order.  A batch (K2, K6, K7) has a leading
    dimension B on the cubes, the channel rows, the template, the weights
    and the mask (not on ``bin_rows``: the pulse window is shared) and is
    one launch over its B * nsub * nchan cells.  The cubes are all
    float32, all bf16-stored or all float64 (every other float operand
    float64 then, else float32).  ``out`` is an optional 4-tuple of
    contiguous planes of the weights' shape the kernel writes (a tile's
    rows of the full planes).  Returns the entry's return code, the four
    planes and the route taken."""
    batched = cube.dim() == 4
    lead = cube.shape[:1] if batched else ()
    nsub, nchan, nbin = cube.shape[-3:]
    route = route or cell_stats_route(nbin, _cube_itemsize(cube))
    for name, t in cubes:
        _require(t, name, cube.dtype if cube.dtype in CUBE_DTYPES
                 else CUBE_DTYPES, lead + (nsub, nchan, nbin))
    real = real_dtype(cube.dtype)
    for name, t in chan_rows:
        _require(t, name, real, lead + (nchan, nbin))
    for name, t in bin_rows:
        _require(t, name, real, (nbin,))
    _require(template, "template", real, lead + (nbin,))
    _require(weights, "weights", real, lead + (nsub, nchan))
    _require(cell_mask, "cell_mask", torch.bool, lead + (nsub, nchan))
    if out is None:
        outs = [torch.empty(lead + (nsub, nchan), dtype=real,
                            device=cube.device) for _ in range(4)]
    else:
        outs = list(out)
        for i, o in enumerate(outs):
            if o.device != cube.device:
                raise ValueError(f"out[{i}] on {o.device}, cube on "
                                 f"{cube.device}")
            _require(o, f"out[{i}]", real, lead + (nsub, nchan))
    info = tt_info(template)
    cpa = nsub * nchan
    ncells = weights.numel()
    if route == "fft":
        plan = cell_fft_plan(nbin, _cube_itemsize(cube))
        tw = _fft_twiddles(nbin, str(cube.device), real)
        fn = getattr(load_library(), _FFT_ENTRIES[entry])
        with torch.cuda.device(cube.device):
            rc = fn(*ptrs, _ptr(tw), _ptr(info), *(_ptr(o) for o in outs),
                    ncells, cpa, nchan, nbin, plan.cluster, plan.odd,
                    plan.threads, plan.smem, _inv_n(nbin, real),
                    _KIND[cube.dtype], _stream(cube))
        return rc, tuple(outs), route
    if route == "fft_global":
        return _launch_fftg(entry, cube, ptrs, info, outs, ncells, cpa,
                            nchan, nbin, real), tuple(outs), route
    plan = cell_stats_geometry(nbin, cube.element_size())
    cos_t, sin_t = _dft_tables_padded(nbin, plan.nkp, str(cube.device), real)
    per_sm = max(1, min(2048 // plan.threads,
                        (_SMEM_LIMIT + 1024) // (plan.smem + 1024)))
    grid = max(1, min(-(-ncells // plan.group),
                      per_sm * _sm_count(str(cube.device))))
    fn = getattr(load_library(), entry)
    with torch.cuda.device(cube.device):
        rc = fn(*ptrs, _ptr(cos_t), _ptr(sin_t), _ptr(info),
                *(_ptr(o) for o in outs), ncells, cpa, nchan, nbin,
                plan.group, plan.ctile, plan.kchunk, plan.bchunk, plan.nkp,
                plan.producers, plan.threads, grid, plan.smem,
                _inv_n(nbin, real), _KIND[cube.dtype], _stream(cube))
    return rc, tuple(outs), route


def _launch_fftg(entry, cube, ptrs, info, outs, ncells, cpa, nchan, nbin,
                 real):
    """K2g's launch (``cell_fft_global.cu``): the plan, the twiddle table
    and the passes' tables, for Bluestein the chirp and its spectrum, and
    a scratch of min(chunk, ncells) rows allocated for this launch; the
    entry runs every chunk.  Returns its return code."""
    plan = cell_fft_global_plan(nbin, _cube_itemsize(cube))
    dev = str(cube.device)
    tw = _fft_twiddles(plan.table, dev, real)
    chirp = bhat = None
    if plan.mode == "bluestein":
        chirp = _fftg_chirp(nbin, dev, real)
        bhat = _fftg_bhat(nbin, dev, real)
    wf, perm = _fftg_pass_tables(plan.passes, dev, real)
    scratch = torch.empty((min(plan.chunk, ncells), plan.n, 2), dtype=real,
                          device=cube.device)
    fn = getattr(load_library(), _FFTG_ENTRIES[entry])
    with torch.cuda.device(cube.device):
        return fn(*ptrs, _ptr(tw), _ptr(wf), _ptr(perm), _ptr(info),
                  *(_ptr(o) for o in outs),
                  _ptr(scratch), None if chirp is None else _ptr(chirp),
                  None if bhat is None else _ptr(bhat), ncells, cpa, nchan,
                  nbin, plan.n, *_fftg_pass_args(plan), plan.chunk,
                  _fft_table_lt(plan.table), plan.table // plan.n,
                  _inv_n(nbin, real), _KIND[cube.dtype],
                  _stream(cube))


def _counted(fn, cube, entry, route, *args):
    """:func:`_launch_cell_stats` of ``entry`` on ``args`` (its arguments
    after ``entry``), counted on the wrapper ``fn`` by the route taken;
    raises on a failed launch."""
    rc, outs, route = _launch_cell_stats(entry, *args, route=route)
    _count(fn, cube, route)
    _check_rc(rc, f"{fn.__name__} ({route} build)")
    return outs


def _disp_args(disp, rot_t, nyq_row, template, weights, cell_mask, out):
    """:func:`_launch_cell_stats`'s arguments for K2's residual."""
    rows = [("rot_t", rot_t)] + ([] if nyq_row is None
                                 else [("nyq_row", nyq_row)])
    return (disp, template, weights, cell_mask, [("disp", disp)], rows, [],
            [_ptr(disp), _ptr(rot_t),
             None if nyq_row is None else _ptr(nyq_row), _ptr(weights),
             _ptr(cell_mask)], out)


def cell_diagnostics_disp(disp, rot_t, nyq_row, template, weights,
                          cell_mask, out=None):
    """``(d_std, d_mean, d_ptp, d_fft)`` of the dispersed-frame weighted
    residual — kernel K2 on the card (its FFT build past the DFT tables,
    :func:`cell_stats_route`), :func:`cell_diagnostics_disp_plain` on the
    CPU.  ``nyq_row`` is None where the rotation round-trips exactly
    (roll, odd nbin); a batch and ``out`` as in
    :func:`_launch_cell_stats`."""
    if not _on_card(disp, rot_t, template, weights, cell_mask):
        return _plain_into(cell_diagnostics_disp_plain(
            disp, rot_t, nyq_row, template, weights, cell_mask), out)
    return _counted(cell_diagnostics_disp, disp, "icln_cell_stats_disp", None,
                    *_disp_args(disp, rot_t, nyq_row, template, weights,
                                cell_mask, out))


def cell_fft_disp(disp, rot_t, nyq_row, template, weights, cell_mask,
                  out=None):
    """:func:`cell_diagnostics_disp` by its FFT build at any length the
    build takes (:func:`cell_fft_plan`; counted as
    ``cell_diagnostics_disp.launches_fft``), the plain version with
    ``torch.fft`` on the CPU."""
    if not _on_card(disp, rot_t, template, weights, cell_mask):
        return _plain_into(cell_diagnostics_disp_plain(
            disp, rot_t, nyq_row, template, weights, cell_mask, "fft"), out)
    return _counted(cell_diagnostics_disp, disp, "icln_cell_stats_disp",
                    "fft", *_disp_args(disp, rot_t, nyq_row, template,
                                       weights, cell_mask, out))


cell_diagnostics_disp.launches = 0
cell_diagnostics_disp.launches_bf16 = 0
cell_diagnostics_disp.launches_f64 = 0


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
    (per archive of a batch), the cubes read as they compute
    (:func:`upcast_stored`), the spectrum by the DFT or ``torch.fft`` as
    :func:`cell_stats_route` routes the shape."""
    ded, disp_base = upcast_stored(ded), upcast_stored(disp_base)
    if ded.dim() == 4:
        return _stack_each(
            cell_diagnostics_two_read_plain, ded.shape[0], (ded, True),
            (disp_base, True), (rot_t, True), (template, True),
            (weights, True), (cell_mask, True))
    wres = wres_two_read(ded, disp_base, rot_t, template, weights)
    return cell_diagnostics(wres, cell_mask, _spectrum(cell_stats_route(
        ded.shape[-1], _cube_itemsize(ded))))


def _two_read_args(ded, disp_base, rot_t, template, weights, cell_mask,
                   out):
    """:func:`_launch_cell_stats`'s arguments for K7's residual."""
    return (ded, template, weights, cell_mask,
            [("ded", ded), ("disp_base", disp_base)], [("rot_t", rot_t)],
            [], [_ptr(ded), _ptr(disp_base), _ptr(rot_t), _ptr(template),
                 _ptr(weights), _ptr(cell_mask)], out)


def cell_diagnostics_two_read(ded, disp_base, rot_t, template, weights,
                              cell_mask, out=None):
    """``(d_std, d_mean, d_ptp, d_fft)`` of the two-read weighted
    residual — kernel K7 on the card (its FFT build past the DFT tables),
    :func:`cell_diagnostics_two_read_plain` on the CPU.  ``rot_t`` is the
    rotation of the WINDOWED template, ``template`` the unwindowed one
    the fit uses; a batch and ``out`` as in :func:`_launch_cell_stats`."""
    if not _on_card(ded, disp_base, rot_t, template, weights, cell_mask):
        return _plain_into(cell_diagnostics_two_read_plain(
            ded, disp_base, rot_t, template, weights, cell_mask), out)
    return _counted(cell_diagnostics_two_read, ded,
                    "icln_cell_stats_two_read", None,
                    *_two_read_args(ded, disp_base, rot_t, template, weights,
                                    cell_mask, out))


cell_diagnostics_two_read.launches = 0
cell_diagnostics_two_read.launches_bf16 = 0
cell_diagnostics_two_read.launches_f64 = 0


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
    (per archive of a batch; the window shared), the cube read as it
    computes (:func:`upcast_stored`), the spectrum as
    :func:`cell_diagnostics_two_read_plain` takes it."""
    ded = upcast_stored(ded)
    if ded.dim() == 4:
        return _stack_each(
            cell_diagnostics_dedisp_plain, ded.shape[0], (ded, True),
            (template, True), (window, False), (weights, True),
            (cell_mask, True))
    wres = wres_dedisp(ded, template, window, weights)
    return cell_diagnostics(wres, cell_mask, _spectrum(cell_stats_route(
        ded.shape[-1], _cube_itemsize(ded))))


def _dedisp_args(ded, template, window, weights, cell_mask, out):
    """:func:`_launch_cell_stats`'s arguments for K6's residual."""
    return (ded, template, weights, cell_mask, [("ded", ded)], [],
            [("window", window)], [_ptr(ded), _ptr(template), _ptr(window),
                                   _ptr(weights), _ptr(cell_mask)], out)


def cell_diagnostics_dedisp(ded, template, window, weights, cell_mask,
                            out=None):
    """``(d_std, d_mean, d_ptp, d_fft)`` of the dedispersed-frame
    weighted residual — kernel K6 on the card (its FFT build past the DFT
    tables), :func:`cell_diagnostics_dedisp_plain` on the CPU.
    ``window`` is the (nbin,) pulse-window multiplier (all ones when the
    window is off), shared by a batch; a batch and ``out`` as in
    :func:`_launch_cell_stats`."""
    if not _on_card(ded, template, window, weights, cell_mask):
        return _plain_into(cell_diagnostics_dedisp_plain(
            ded, template, window, weights, cell_mask), out)
    return _counted(cell_diagnostics_dedisp, ded, "icln_cell_stats_dedisp",
                    None, *_dedisp_args(ded, template, window, weights,
                                        cell_mask, out))


cell_diagnostics_dedisp.launches = 0
cell_diagnostics_dedisp.launches_bf16 = 0
cell_diagnostics_dedisp.launches_f64 = 0


# --------------------------------------------------------------------------
# K10: one rank's shard of the cell-sharded clean (K2's and K6's values)
# --------------------------------------------------------------------------

def shard_diagnostics_disp(disp, rot_t, nyq_row, template, weights,
                           cell_mask):
    """K2's four planes on one rank's (subint, channel) shard — kernel
    K10 on the card (K2's kernel under the shard's entry and launch
    count, so bit-equal to :func:`cell_diagnostics_disp` on the same
    shard; its FFT build past the DFT tables, bit-equal to K2's),
    :func:`cell_diagnostics_disp_plain` on the CPU.  ``rot_t`` and
    ``nyq_row`` are the shard's channel rows.  A float32, bf16 or float64
    block, each its own build and count."""
    if not _on_card(disp, rot_t, template, weights, cell_mask):
        return cell_diagnostics_disp_plain(disp, rot_t, nyq_row, template,
                                           weights, cell_mask)
    return _counted(shard_diagnostics_disp, disp, "icln_shard_stats_disp",
                    None, *_disp_args(disp, rot_t, nyq_row, template,
                                      weights, cell_mask, None))


shard_diagnostics_disp.launches = 0
shard_diagnostics_disp.launches_bf16 = 0
shard_diagnostics_disp.launches_f64 = 0


def shard_diagnostics_dedisp(ded, template, window, weights, cell_mask):
    """K6's four planes on one rank's shard — kernel K10 on the card
    (bit-equal to :func:`cell_diagnostics_dedisp` on the same shard, its
    FFT build too), :func:`cell_diagnostics_dedisp_plain` on the CPU."""
    if not _on_card(ded, template, window, weights, cell_mask):
        return cell_diagnostics_dedisp_plain(ded, template, window, weights,
                                             cell_mask)
    return _counted(shard_diagnostics_dedisp, ded, "icln_shard_stats_dedisp",
                    None, *_dedisp_args(ded, template, window, weights,
                                        cell_mask, None))


shard_diagnostics_dedisp.launches = 0
shard_diagnostics_dedisp.launches_bf16 = 0
shard_diagnostics_dedisp.launches_f64 = 0


# --------------------------------------------------------------------------
# K2f's launch plan: one thread-block cluster a cell (cell_fft.cu); the
# two-level twiddle table
# --------------------------------------------------------------------------

# N = 2^a x an odd part 3^b 5^c (the odd part's radix-5 and radix-3
# stages beside the radix-2 ones); a cell is a cluster of
# FFT_CLUSTER_SIZES blocks (the portable sizes), each holding its slice of
# the row in place (4 or 8 bytes a bin, padded to a whole run of the
# swizzle) and the two-level twiddle table (:func:`_fft_twiddles`) beside
# FFT_STATIC_SMEM bytes of static shared memory (the reductions'
# partials, under 2 KB).  The plan takes the
# fewest blocks a cell whose slices hold at most FFT_SLICE_BINS bins (the
# largest cluster where no size gets there), FFT_PLAN_THREADS a block,
# from tools/time_cell_fft.py's sweeps on an H100 (every cluster size, 128
# and 256 threads; PERF.md §6): the fastest plan at 8 x 256 x 65536
# in both dtypes (clusters of 8) and at 8 x 256 x 16,384 (float32) and
# 32,768 (float64), and within 7% of the fastest at 8 x 256 cells of
# 16,384 to 32,768 bins and at 32 x 256 x 24,576, in both dtypes.  At
# 256 cells of 24,576 float32 bins (a 0.2 ms launch whose plans reorder
# from run to run) it was the fastest in one sweep and 22% behind it in
# another.  An odd part 3^a 5^b runs a + b odd stages; K2f takes at
# most FFT_ODD_STAGES of them (by the real size), where it is the faster
# build: tools/time_cell_fft.py --builds at 32 x 256 cells on an H100
# (PERF.md §6), K2f against K2g in float32 7.76 / 8.96 ms at odd part 45
# (three stages), 4.54 / 3.74 at 625 (four), 15.40 / 11.95 at 1875
# (five); in float64 10.97 / 18.15, 5.71 / 7.77 and 23.45 / 23.82 (and
# past five stages nothing measured).  Every row the cluster build does
# not take goes to K2g (:func:`cell_fft_global_plan`).
FFT_ODD_RADICES = (3, 5)
FFT_ODD_STAGES = {4: 3, 8: 5}
FFT_CLUSTER_SIZES = (2, 4, 8)
FFT_SLICE_BINS = 8192
FFT_PLAN_THREADS = 128
FFT_STATIC_SMEM = 2048


class CellFftPlan(NamedTuple):
    """The FFT build's launch (``cell_fft.cu``): ``cluster`` blocks a
    cell, ``odd`` the odd part P of nbin (nbin/2 = P *
    2^m), ``threads`` a block and ``smem`` bytes of dynamic shared memory
    a block (its 1/``cluster`` of the row)."""
    cluster: int
    odd: int
    threads: int
    smem: int


def _odd_part(n: int) -> int:
    while n > 0 and n % 2 == 0:
        n //= 2
    return n


def _strip(n: int, primes) -> int:
    """``n`` without its factors in ``primes``."""
    for p in primes:
        while n > 0 and n % p == 0:
            n //= p
    return n


def _fft_table_lt(nbin: int) -> int:
    """log2 of the twiddle table's low part at ``nbin`` bins: half of
    ceil(log2 nbin) (cell_fft.cu's icln_fft_table_lt)."""
    return (nbin - 1).bit_length() // 2


def _fft_table_len(nbin: int) -> int:
    """The two-level twiddle table's entries: 2^lt low ones and
    ceil(nbin / 2^lt) high ones."""
    t = 1 << _fft_table_lt(nbin)
    return t + -(-nbin // t)


def _fft_table_slots(nbin: int) -> int:
    """The twiddle table's entries in shared memory: the high part padded
    to a whole run of 16 (the swizzle's; cell_fft.cu's
    icln_fft_table_slots)."""
    t = 1 << _fft_table_lt(nbin)
    return t + (-(-nbin // t) + 15) // 16 * 16


def _fft_smem(nbin: int, cluster: int, realsize: int) -> int:
    """A block's dynamic shared memory: its slice of the row, nbin / (2
    cluster) complex values padded to a whole run of the swizzle (16
    values in float32, 8 in float64), and the twiddle table (complex
    entries of ``realsize``-byte parts), in 16-byte words."""
    run = 8 if realsize == 8 else 16
    q = -(-(nbin // (2 * cluster)) // run) * run
    row = 2 * realsize * (q + _fft_table_slots(nbin))
    return -(-row // 16) * 16


def _fft_fits(nbin: int, cluster: int, realsize: int) -> bool:
    """Whether ``cluster`` blocks take a row of ``nbin``: the power of two
    of nbin/2 splits into 2 * cluster slices, and a slice fits a block
    beside the twiddle table."""
    lpow = nbin // 2 // _odd_part(nbin)
    return (lpow % (2 * cluster) == 0
            and _fft_smem(nbin, cluster, realsize) + FFT_STATIC_SMEM
            <= _SMEM_LIMIT)


@functools.lru_cache(maxsize=None)
def cell_fft_capacity(realsize: int = 4, odd: int = 1) -> int:
    """The longest row of odd part ``odd`` (3^a 5^b) the cluster build
    takes: 262,144 float32 bins (393,216 at odd part 3, 327,680 at 5),
    131,072 float64 bins (196,608 and 163,840); longer rows take K2g."""
    cap, n = 0, 4 * odd
    while n * realsize // FFT_CLUSTER_SIZES[-1] <= _SMEM_LIMIT:
        if _fft_fits(n, FFT_CLUSTER_SIZES[-1], realsize):
            cap = n
        n *= 2
    return cap


def _odd_stages(odd: int) -> int:
    """The odd stages of an odd part 3^a 5^b: a + b."""
    n = 0
    for p in FFT_ODD_RADICES:
        while odd % p == 0:
            odd //= p
            n += 1
    return n


def _cell_fft_takes(nbin: int, realsize: int):
    """``(plan, why)``: the cluster build's :class:`CellFftPlan` at
    ``nbin`` and None, or None and why it does not take the row: an odd
    part with a prime factor over 5, a power of two of nbin/2 under 4 (a
    cluster of 2 takes a quarter of it a block), more odd stages than
    FFT_ODD_STAGES (K2g is faster there), or a row past
    :func:`cell_fft_capacity`."""
    odd = _odd_part(nbin)
    if _strip(odd, FFT_ODD_RADICES) != 1 or nbin < 8 * odd:
        return None, (f"the cluster build takes 2^a x 3^b 5^c bins (a >= "
                      f"3); this one's odd part is {odd}")
    if _odd_stages(odd) > FFT_ODD_STAGES[realsize]:
        return None, (f"odd part {odd} takes {_odd_stages(odd)} odd stages, "
                      f"past the {FFT_ODD_STAGES[realsize]} where the cluster "
                      f"build is the faster")
    for cluster in FFT_CLUSTER_SIZES:
        if _fft_fits(nbin, cluster, realsize) and (
                nbin // cluster <= FFT_SLICE_BINS
                or cluster == FFT_CLUSTER_SIZES[-1]):
            return CellFftPlan(cluster, odd, FFT_PLAN_THREADS,
                               _fft_smem(nbin, cluster, realsize)), None
    return None, (f"past the cluster build's capacity "
                  f"({cell_fft_capacity(realsize, odd)} bins of odd part "
                  f"{odd} in {'float64' if realsize == 8 else 'float32'})")


@functools.lru_cache(maxsize=64)
def cell_fft_plan(nbin: int, itemsize: int = 4) -> CellFftPlan:
    """The FFT build's :class:`CellFftPlan` at ``nbin`` for a cube of
    ``itemsize``-byte elements (8: float64 rows and twiddles): the fewest
    blocks a cell (of FFT_CLUSTER_SIZES) whose slices of the row hold at
    most FFT_SLICE_BINS bins, else the largest cluster; FFT_PLAN_THREADS a
    block.  NotImplementedError where the cluster build does not take
    ``nbin`` (:func:`_cell_fft_takes`; :func:`cell_stats_route` sends
    such rows to K2g, :func:`cell_fft_global_plan`)."""
    plan, why = _cell_fft_takes(nbin, 8 if itemsize == 8 else 4)
    if plan is None:
        raise NotImplementedError(f"nbin {nbin}: {why} (K2g takes it)")
    return plan


# --------------------------------------------------------------------------
# K2g's plan: the FFT build through device memory (cell_fft_global.cu)
# --------------------------------------------------------------------------

# A row the cluster build does not take is transformed in a scratch buffer
# in device memory: an even N whose N/2 is 2^a 3^b 5^c as N/2 complex
# values ("split", the real split after the transform), any other N by
# Bluestein's chirp convolution of length M, the least 2^a 3^b 5^c >=
# 2N - 1 ("bluestein").  The transform of n points runs in passes of at
# most FFTG_PASS_MAX points, each a block's sub-transforms in shared
# memory (tiles of at most FFTG_TILE_BYTES; the fewest passes, the factors
# dealt largest first to the pass with the least product), over chunks of
# cells whose scratch stays within FFTG_SCRATCH_BYTES; the CUDA file sets
# its blocks' threads.
FFTG_PASS_MAX = 1024
FFTG_TILE_BYTES = 65536
FFTG_MAX_PASSES = 4
FFTG_SCRATCH_BYTES = 1 << 30
# a row's scratch indices are 32-bit in the kernels: n < 2^31
FFTG_MAX_N = (1 << 31) - 1


class CellFftGlobalPlan(NamedTuple):
    """K2g's launch (``cell_fft_global.cu``): ``mode`` ``"split"`` or
    ``"bluestein"``, ``n`` the transform's points (nbin/2 or M),
    ``passes`` their points F_1 .. F_k (the first at the largest stride),
    ``groups`` the columns G_j a block of each pass (dividing its stride,
    G_j F_j complex values within a tile), ``table`` the twiddle table's
    length (nbin for a split row, M for Bluestein), ``chunk`` the cells a
    chunk of scratch holds."""
    mode: str
    n: int
    passes: tuple
    groups: tuple
    table: int
    chunk: int


def _smooth(n: int) -> bool:
    """Whether ``n`` >= 1 is 2^a 3^b 5^c."""
    return n >= 1 and _strip(n, (2, 3, 5)) == 1


def _next_smooth(n: int) -> int:
    """The least 2^a 3^b 5^c >= ``n`` (each 3^b 5^c <= 2n with its least
    power of two that reaches ``n``)."""
    best, p5 = 2 * max(n, 1), 1
    while p5 < 2 * n:
        p35 = p5
        while p35 < 2 * n:
            m = p35
            while m < n:
                m *= 2
            best = min(best, m)
            p35 *= 3
        p5 *= 5
    return best if n > 1 else 1


def _fftg_passes(n: int) -> tuple:
    """The passes' points of an n-point transform (n 2^a 3^b 5^c): the
    fewest passes of at most FFTG_PASS_MAX points, n's prime factors
    dealt largest first, each to the pass with the least product so far
    (the first such); the passes in that order."""
    factors = []
    for p in (5, 3, 2):
        while n % p == 0:
            factors.append(p)
            n //= p
    for k in range(1, FFTG_MAX_PASSES + 1):
        prod = [1] * k
        for f in factors:
            i = prod.index(min(prod))
            prod[i] *= f
        if max(prod) <= FFTG_PASS_MAX:
            return tuple(prod)
    raise NotImplementedError(
        f"a transform of {n} points needs more than {FFTG_MAX_PASSES} "
        f"passes ({_ITEM9})")


def _fftg_groups(n: int, passes, realsize: int, fused: bool) -> tuple:
    """G_j, the columns a block of each pass: the largest divisor of the
    pass's stride (of the last pass, stride 1: of the row's n / F_k spans,
    a block taking G_k whole spans) whose tile (G_j F_j complex values;
    two tiles in the last pass where Bluestein ``fused`` its forward and
    inverse passes) fits FFTG_TILE_BYTES."""
    groups, s = [], n
    for i, f in enumerate(passes):
        s //= f
        last = i == len(passes) - 1
        width = n // f if last else s
        most = FFTG_TILE_BYTES // (f * 2 * realsize
                                   * (2 if last and fused else 1))
        groups.append(max(g for g in range(1, min(width, most) + 1)
                          if width % g == 0))
    return tuple(groups)


@functools.lru_cache(maxsize=64)
def cell_fft_global_plan(nbin: int, itemsize: int = 4) -> CellFftGlobalPlan:
    """K2g's :class:`CellFftGlobalPlan` at ``nbin`` for a cube of
    ``itemsize``-byte elements (8: float64): a function of nbin and the
    dtype alone, so batches, tiles and shards launch the same plan.
    NotImplementedError naming ROADMAP item 9 where a row's transform
    passes FFTG_MAX_N points (the kernels' 32-bit row indices)."""
    realsize = 8 if itemsize == 8 else 4
    if nbin < 2:
        raise ValueError(f"nbin {nbin}: K2g takes rows of 2 bins or more")
    if nbin % 2 == 0 and _smooth(nbin // 2):
        mode, n, table = "split", nbin // 2, nbin
    else:
        mode = "bluestein"
        n = table = _next_smooth(2 * nbin - 1)
    if n > FFTG_MAX_N:
        raise NotImplementedError(
            f"nbin {nbin}: a {n}-point transform a cell is past K2g's "
            f"32-bit row indices ({_ITEM9})")
    passes = _fftg_passes(n)
    chunk = max(1, FFTG_SCRATCH_BYTES // (n * 2 * realsize))
    return CellFftGlobalPlan(mode, n, passes,
                             _fftg_groups(n, passes, realsize,
                                          mode == "bluestein"),
                             table, chunk)


def _fftg_pass_args(plan) -> tuple:
    """The entries' f0..f3 and g0..g3: the passes' points and columns, 1
    past the last pass."""
    pad = (1,) * (FFTG_MAX_PASSES - len(plan.passes))
    return (*plan.passes, *pad, *plan.groups, *pad)


def fftg_chirp(nbin: int) -> np.ndarray:
    """Bluestein's chirp w_j = exp(-i pi j^2 / nbin), j < nbin, as (nbin,
    2) float64 (cos, sin): j^2 mod 2 nbin taken in int64 before any
    float, so the phase keeps its precision at any length."""
    j = np.arange(nbin, dtype=np.int64)
    ang = (-np.pi / nbin) * ((j * j) % (2 * nbin)).astype(np.float64)
    return np.stack([np.cos(ang), np.sin(ang)], axis=1)


@functools.lru_cache(maxsize=8)
def _fftg_chirp(nbin: int, device: str, dtype=torch.float32):
    """:func:`fftg_chirp` on ``device`` in the arithmetic ``dtype``."""
    return torch.from_numpy(fftg_chirp(nbin)).to(device=device,
                                                  dtype=dtype).contiguous()


def fftg_chirp_row(nbin: int, m: int) -> np.ndarray:
    """Bluestein's b of length ``m``: conj w_j at j and at m - j for 0 < j
    < nbin, conj w_0 at 0, zero between; (m, 2) float64."""
    w = fftg_chirp(nbin)
    b = np.zeros((m, 2))
    b[:nbin, 0], b[:nbin, 1] = w[:, 0], -w[:, 1]
    b[m - nbin + 1:] = b[1:nbin][::-1]
    return b


def fftg_stage_order(f: int) -> np.ndarray:
    """perm[q], where the stages of an f-point pass (radix 5, 3, 4, 2,
    decimation in frequency) leave the DFT's output q: the digits of q in
    the stages' radices, least significant first, as the position's most
    significant first."""
    q, t, sp = np.arange(f), np.zeros(f, dtype=np.int64), f
    while sp > 1:
        r = 5 if sp % 5 == 0 else 3 if sp % 3 == 0 else 4 if sp % 4 == 0 \
            else 2
        sp //= r
        t += (q % r) * sp
        q //= r
    return t


@functools.lru_cache(maxsize=16)
def _fftg_pass_tables(passes: tuple, device: str, dtype=torch.float32):
    """K2g's per-pass tables, pass after pass: W_F^e = (cos, sin)(-2 pi e /
    F) for e < F in float64 on the host, rounded to the arithmetic
    ``dtype`` ((sum F, 2)), and each pass's :func:`fftg_stage_order`
    (int32)."""
    wf = np.concatenate([np.stack([np.cos(-2.0 * np.pi * np.arange(f) / f),
                                   np.sin(-2.0 * np.pi * np.arange(f) / f)],
                                  axis=1) for f in passes])
    perm = np.concatenate([fftg_stage_order(f) for f in passes])
    return (torch.from_numpy(wf).to(device=device, dtype=dtype).contiguous(),
            torch.from_numpy(perm.astype(np.int32)).to(device).contiguous())


@functools.lru_cache(maxsize=8)
def _fftg_bhat(nbin: int, device: str, dtype=torch.float32):
    """The chirp's spectrum B^ in the passes' order, scaled by 1 / M:
    :func:`fftg_chirp_row` through K2g's forward passes on the card in
    float64 (its own float64 plan: the same passes), rounded to the
    arithmetic ``dtype``; made once per (nbin, device, dtype)."""
    plan = cell_fft_global_plan(nbin, 8)
    m = plan.n
    b = torch.from_numpy(fftg_chirp_row(nbin, m)).to(device).contiguous()
    tw = _fft_twiddles(m, device, torch.float64)
    wf, perm = _fftg_pass_tables(plan.passes, device, torch.float64)
    with torch.cuda.device(b.device):
        rc = load_library().icln_fftg_passes(
            _ptr(b), None, 1, m, *_fftg_pass_args(plan), _ptr(tw), _ptr(wf),
            _ptr(perm), _fft_table_lt(m), 1, 0, _KIND[torch.float64],
            _stream(b))
    _check_rc(rc, "the chirp's spectrum (K2g's passes)")
    return (b * (1.0 / m)).to(dtype).contiguous()


@functools.lru_cache(maxsize=8)
def _fft_twiddles(nbin: int, device: str, dtype=torch.float32):
    """The FFT build's two-level twiddle table, (T + ceil(N / T), 2) with
    T = 2^:func:`_fft_table_lt`: W_N^j = (cos, sin)(-2 pi j / N) for j < T,
    then W_N^(h T) for each h, so that W_N^e = W_N^(e >> lt) W_N^(e & (T -
    1)) for every e < N; computed in float64 on the host, rounded to the
    arithmetic ``dtype``."""
    t = 1 << _fft_table_lt(nbin)
    j = np.concatenate([np.arange(t), t * np.arange(-(-nbin // t))])
    ang = (-2.0 * np.pi / nbin) * j.astype(np.float64)
    tw = np.stack([np.cos(ang), np.sin(ang)], axis=1)
    return torch.from_numpy(tw).to(device=device, dtype=dtype).contiguous()


# --------------------------------------------------------------------------
# K3: scaled sides, one orientation
# --------------------------------------------------------------------------

_KEY_MASKED = 0x7F800000            # the key of +inf as a float32
_KEY64_MASKED = 0x7FF0000000000000   # the key of +inf as a float64
# value dtype: (key dtype, sign shift, magnitude mask, masked key)
_KEYS = {torch.float32: (torch.int32, 31, 0x7FFFFFFF, _KEY_MASKED),
         torch.float64: (torch.int64, 63, 0x7FFFFFFFFFFFFFFF,
                         _KEY64_MASKED)}
_VALUES = {torch.int32: torch.float32, torch.int64: torch.float64}


def ordered_key(x):
    """float32 -> int32 (float64 -> int64) keys whose signed order is the
    float order, NaN above +inf and -0 below +0: the reference's
    ``_ordered_key``, and its 64-bit counterpart for float64."""
    kdt, sh, mag, _ = _KEYS[x.dtype]
    b = x.contiguous().view(kdt)
    return b ^ ((b >> sh) & mag)


def key_to_float(k):
    """Inverse of :func:`ordered_key` (the map is an involution): int32
    keys to float32, int64 keys to float64."""
    vdt = _VALUES[k.dtype]
    _, sh, mag, _ = _KEYS[vdt]
    return (k ^ ((k >> sh) & mag)).view(vdt)


def masked_median_keys(values, mask, dim):
    """Median of the unmasked entries along ``dim`` (keepdims) by exact
    order statistics of the ordered keys — what the kernel's radix
    select computes: keys of masked entries are +inf's, ``k_lo =
    (n-1)//2``, ``k_hi = n//2``, ``0.5*(lo+hi)``, 0.0 on an empty line.
    Returns ``(median, n_valid)``."""
    keys = torch.where(mask, torch.full_like(ordered_key(values),
                                             _KEYS[values.dtype][3]),
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
    """Shared-memory keys a line of ``n`` takes (common.cuh's
    ``icln_key_stride``): ``n`` rounded up to 32, plus 4, so that rows stay
    16-byte aligned and adjacent lines start 4 (int32 keys) or 8 (int64)
    banks apart."""
    return -(-n // 32) * 32 + 4


def _key_bytes(dtype) -> int:
    """Bytes of a select's key: 4 for float32 values, 8 for float64."""
    return 8 if dtype == torch.float64 else 4


def _select_static_smem(key_bytes: int) -> int:
    """Static shared memory of a block-select kernel: SELECT_STATIC_SMEM
    for 32-bit keys; twice that for 64-bit ones (the select's state holds
    three 8-byte words a line: 1,376 bytes with K3's per-line flags)."""
    return SELECT_STATIC_SMEM * (2 if key_bytes == 8 else 1)


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


def masked_median_geometry(n: int, dim: int = 1,
                           key_bytes: int = 4) -> MedianPlan:
    """K9's :class:`MedianPlan` on lines of ``n`` entries along ``dim``:
    the block route where a line has at most MEDIAN_BLOCK_ENTRIES (8
    lines a block along dim 0, whose lines are columns: a warp then reads
    32-byte row segments; 1 along dim 1; with the 8-byte keys of float64
    values the most of 8, 4, 2 lines whose keys fit), else the grid route
    with as few blocks a line as hold MEDIAN_BLOCK_ENTRIES each, the
    entries shared out evenly."""
    bpl = max(1, -(-n // MEDIAN_BLOCK_ENTRIES))
    if bpl > 1:
        return MedianPlan("grid", -(-n // bpl), bpl, 1, 256, 0)
    room = _SMEM_LIMIT - _select_static_smem(key_bytes)
    for lines in ((8, 4, 2, 1) if dim == 0 else (1,)):
        smem = lines * (key_bytes * _key_stride(n) + 4 * 256)
        if smem <= room:
            return MedianPlan("block", n, 1, lines,
                              _select_threads(lines * n), smem)
    raise ValueError(f"masked_median: lines of {n} do not fit a block")


def _median_scratch_ints(nlines: int, key_bytes: int) -> int:
    """int32 entries of K9's grid-route scratch (the layout
    ``icln_masked_median_t`` in masked_median.cu cuts it into): 256 bins,
    the valid count, the ticket and the rank left (int32) a line, then the
    least key above the bucket and the prefix in the keys' width, 8-byte
    aligned."""
    kw = key_bytes // 4
    return -(-nlines * 259 // kw) * kw + 2 * kw * nlines


def masked_median(values, mask, dim):
    """``np.ma.median`` of the float32 (or float64) ``values`` along
    ``dim`` (0 or 1, keepdims) over the entries whose bool ``mask`` is
    False; 0.0 on a line with no valid entry.  Kernel K9 on the card (its
    float64 build on float64 values), ``masked_median_keys(values, mask,
    dim)[0]`` on the CPU; bit-equal to the reference's
    ``masked_median_pallas`` on float32 values."""
    if values.dtype not in REAL_DTYPES:
        raise TypeError(f"masked_median requires float32 or float64, got "
                        f"{values.dtype}")
    if dim not in (0, 1):
        raise ValueError("dim must be 0 or 1 for 2-D values")
    if values.dim() != 2:
        raise ValueError(f"values must be 2-D, got {tuple(values.shape)}")
    if not _on_card(values, mask):
        return masked_median_keys(values, mask, dim)[0]
    nrow, ncol = values.shape
    _require(values, "values", values.dtype, (nrow, ncol))
    _require(mask, "mask", torch.bool, (nrow, ncol))
    kw = dict(dtype=values.dtype, device=values.device)
    if dim == 0:
        n, nlines, line_stride, elem_stride = nrow, ncol, 1, ncol
        out = torch.empty((1, ncol), **kw)
    else:
        n, nlines, line_stride, elem_stride = ncol, nrow, ncol, 1
        out = torch.empty((nrow, 1), **kw)
    if n == 0 or nlines == 0:
        raise ValueError(f"masked_median of an empty line set "
                         f"{tuple(values.shape)} along dim {dim}")
    key_bytes = _key_bytes(values.dtype)
    plan = masked_median_geometry(n, dim, key_bytes)
    # the grid route's 256 histogram bins and five per-line states (see
    # masked_median.cu); the block route needs none
    scratch = torch.empty(
        (_median_scratch_ints(nlines, key_bytes) if plan.route == "grid"
         else 1,), dtype=torch.int32, device=values.device)
    lib = load_library()
    with torch.cuda.device(values.device):
        rc = lib.icln_masked_median(
            _ptr(values), _ptr(mask), _ptr(out), _ptr(scratch), n, nlines,
            line_stride, elem_stride, plan.chunk, plan.bpl, plan.lines,
            plan.threads, plan.smem, int(values.dtype == torch.float64),
            _stream(values))
    _count(masked_median, values)
    _check_rc(rc, "masked_median")
    return out


masked_median.launches = 0
masked_median.launches_f64 = 0


def scaled_sides_plain(diagnostics, cell_mask, axis, thresh):
    """The plain version of K3 (the reference's ``_scaled_sides_body``
    along ``axis``): masked median -> centring -> MAD -> ``_masked_side``
    for the three masked diagnostics; the plain NaN-patched path for the
    rFFT one.  Per archive of a batch of (B, nsub, nchan) planes; float32
    or float64 planes, in their dtype."""
    if cell_mask.dim() == 3:
        return _stack_each(
            lambda *a: scaled_sides_plain(a[:4], a[4], axis, thresh),
            cell_mask.shape[0], *((d, True) for d in diagnostics),
            (cell_mask, True))
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
# K3's launch plans: one block a line (scaled_sides.cu), one thread-block
# cluster a line (sides_cluster.cu); and the route between them and the
# long-line composition
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


def scaled_sides_smem(n: int, diags: int, lines: int,
                      key_bytes: int = 4) -> int:
    """Bytes of K3's dynamic shared memory: ``lines * diags`` lines of
    keys (int32 for float32 planes, int64 for float64) and 256 int32
    bins each, and each line's mask as bits."""
    return (key_bytes * lines * diags * _key_stride(n)
            + 4 * (lines * diags * 256 + lines * -(-n // 32)))


def _sides_fits(n: int, diags: int, lines: int, key_bytes: int = 4) -> bool:
    return (scaled_sides_smem(n, diags, lines, key_bytes)
            + _select_static_smem(key_bytes) <= _SMEM_LIMIT)


def scaled_sides_geometry(n: int, axis: int,
                          key_bytes: int = 4) -> SidesPlan:
    """K3's :class:`SidesPlan` on lines of ``n`` entries along ``axis``:
    the most lines a block that fit — along axis 0 (a line is a column of
    the row-major plane) up to 8, so that a warp reads 32-byte row
    segments; along axis 1 (a line is a row) one — then the most
    diagnostics at once (4, 2 or 1) whose keys fit with them.  Along axis 0
    the wide reads are worth more than the diagnostics at once: at 2048
    subints 8 columns x 2 diagnostics take 0.49 ms against 0.59 for 4 x 4,
    at 4096 8 x 1 take 0.97 ms against 1.19 for 4 x 2 and 1.49 for 2 x 4
    (``tools/time_cell_stats.py --k3-plans``, H100 80GB HBM3 at 700 W).
    ``key_bytes`` 8: float64 planes, whose keys take twice the room.
    Every block line of :func:`scaled_sides_route` has a plan."""
    for lines in ((8, 4, 2, 1) if axis == 0 else (1,)):
        for diags in (4, 2, 1):
            if _sides_fits(n, diags, lines, key_bytes):
                return SidesPlan(lines, diags, _select_threads(lines * n),
                                 scaled_sides_smem(n, diags, lines,
                                                   key_bytes))
    raise ValueError(f"scaled_sides: lines of {n} entries do not fit a "
                     f"block (scaled_sides_route takes them to a cluster)")


# The longest line K3 takes in one block; longer lines go to a cluster
# of blocks (sides_cluster.cu) or, past its capacity, through
# scaled_sides_long.  The boundary is kept where the port has always
# drawn it, so that no shape below it changes route.
LONGEST_BLOCK_LINE = 46486
# The same for float64 planes: the longest line whose 8-byte keys, bins,
# mask bits and the select's static state fit one block (one line, one
# diagnostic at a time).
LONGEST_BLOCK_LINE_F64 = 28224

# The cluster kernel: at most SIDES_CLUSTER_MAX blocks a line (the
# portable cluster size: the non-portable 16 is not taken), from the
# cluster sizes SIDES_CLUSTER_SIZES; its static shared memory (the
# select's state and three pairs of per-line flags) beside each block's
# dynamic shared memory.
SIDES_CLUSTER_SIZES = (2, 4, 8)
SIDES_CLUSTER_MAX = SIDES_CLUSTER_SIZES[-1]


class SidesClusterPlan(NamedTuple):
    """The cluster kernel's launch (``sides_cluster.cu``): ``cluster``
    (C) blocks a line, each holding ``slice`` entries of it (a multiple of
    32; C * slice >= n), ``lines`` (W) adjacent lines a cluster,
    ``diags`` (D) of the four diagnostics at once, ``threads`` a block and
    ``smem`` bytes of dynamic shared memory a block."""
    cluster: int
    slice: int
    lines: int
    diags: int
    threads: int
    smem: int


def sides_cluster_static_smem(key_bytes: int) -> int:
    """Static shared memory of the cluster kernel: a block select's
    (:func:`_select_static_smem`) and 1 KB for its per-line flags and
    their cluster totals (1,088 bytes in all with 32-bit keys, 1,472 with
    64-bit ones)."""
    return _select_static_smem(key_bytes) + 1024


def _cluster_slice(n: int, cluster: int) -> int:
    """Entries of a line one of ``cluster`` blocks holds: n / C rounded up
    to 32, so that every block's keys and mask words start aligned."""
    per = -(-n // cluster)
    return -(-per // 32) * 32


def _cluster_fits(slice_: int, diags: int, lines: int,
                  key_bytes: int) -> bool:
    return (scaled_sides_smem(slice_, diags, lines, key_bytes)
            + sides_cluster_static_smem(key_bytes) <= _SMEM_LIMIT)


def scaled_sides_cluster_geometry(n: int, axis: int,
                                  key_bytes: int = 4) -> SidesClusterPlan:
    """The cluster kernel's :class:`SidesClusterPlan` on lines of ``n``
    entries along ``axis``: as K3's plan, the most lines a cluster that
    fit (up to 8 columns along axis 0, one row along axis 1), then the
    most diagnostics at once (4, 2 or 1), then the fewest blocks a line of
    SIDES_CLUSTER_SIZES whose slices fit.  ``ValueError`` past
    :func:`scaled_sides_cluster_capacity`."""
    for lines in ((8, 4, 2, 1) if axis == 0 else (1,)):
        for diags in (4, 2, 1):
            for cluster in SIDES_CLUSTER_SIZES:
                sl = _cluster_slice(n, cluster)
                if _cluster_fits(sl, diags, lines, key_bytes):
                    return SidesClusterPlan(
                        cluster, sl, lines, diags,
                        _select_threads(lines * sl),
                        scaled_sides_smem(sl, diags, lines, key_bytes))
    raise ValueError(f"scaled_sides: lines of {n} entries do not fit a "
                     f"cluster of {SIDES_CLUSTER_MAX} blocks "
                     f"(scaled_sides_route takes them long)")


@functools.lru_cache(maxsize=None)
def scaled_sides_cluster_capacity(key_bytes: int = 4) -> int:
    """The longest line the cluster kernel takes: SIDES_CLUSTER_MAX
    blocks, each holding the longest slice (a multiple of 32) of one
    line and one diagnostic that fits its shared memory (444,672 entries
    for float32 planes, 224,768 for float64)."""
    sl = 32
    while _cluster_fits(sl + 32, 1, 1, key_bytes):
        sl += 32
    return SIDES_CLUSTER_MAX * sl


def scaled_sides_route(n: int, dtype=torch.float32) -> str:
    """How K3's function runs on lines of ``n`` entries: ``"block"`` (K3,
    one block a line) up to LONGEST_BLOCK_LINE (LONGEST_BLOCK_LINE_F64
    for float64 planes), ``"cluster"`` (one thread-block cluster a line)
    up to :func:`scaled_sides_cluster_capacity`, ``"long"``
    (:func:`scaled_sides_long`: K9 and the tail kernels) above."""
    key_bytes = _key_bytes(dtype)
    longest = LONGEST_BLOCK_LINE_F64 if key_bytes == 8 \
        else LONGEST_BLOCK_LINE
    if n <= longest:
        return "block"
    return "cluster" if n <= scaled_sides_cluster_capacity(key_bytes) \
        else "long"


# --------------------------------------------------------------------------
# The long-line composition past a cluster: K9 for the medians, two
# elementwise kernels for the centring and the side (csrc/sides_tail.cu)
# --------------------------------------------------------------------------

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
    real = _real_of(d, med)
    _require(d, "d", real, shape)
    _require(mask, "mask", torch.bool, shape)
    _require(med, "med", real, _line_dims(d, axis))
    centred, absc = torch.empty_like(d), torch.empty_like(d)
    flags = None if masked else torch.zeros(_line_dims(d, axis),
                                            dtype=torch.int32,
                                            device=d.device)
    lib = load_library()
    with torch.cuda.device(d.device):
        rc = lib.icln_side_centre(
            _ptr(d), _ptr(mask), _ptr(med), _ptr(centred), _ptr(absc),
            None if masked else _ptr(flags), d.numel(), shape[1], axis,
            int(masked), int(real == torch.float64), _stream(d))
    _count(side_centre, d)
    _check_rc(rc, "side_centre")
    return centred, absc, flags


side_centre.launches = 0
side_centre.launches_f64 = 0


def side_scale_plain(centred, mask, mad, flags, axis, thresh, masked):
    """The plain version of :func:`side_scale`: ``_masked_side``, or the
    NaN-patched ``|c / mad| * (1/thresh)`` (its reciprocal in the planes'
    dtype)."""
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
    real = _real_of(centred, mad)
    _require(centred, "centred", real, shape)
    _require(mask, "mask", torch.bool, shape)
    _require(mad, "mad", real, _line_dims(centred, axis))
    if not masked:
        _require(flags, "flags", torch.int32, _line_dims(centred, axis))
    out = torch.empty_like(centred)
    lib = load_library()
    with torch.cuda.device(centred.device):
        rc = lib.icln_side_scale(
            _ptr(centred), _ptr(mask), _ptr(mad),
            None if masked else _ptr(flags), _ptr(out), centred.numel(),
            shape[1], axis, int(masked), _inv_thresh(thresh, real),
            int(real == torch.float64), _stream(centred))
    _count(side_scale, centred)
    _check_rc(rc, "side_scale")
    return out


side_scale.launches = 0
side_scale.launches_f64 = 0


def scaled_sides_long(diagnostics, cell_mask, axis, thresh):
    """K3's function on lines of any length, bit-equal to it: per masked
    diagnostic K9 for the median, :func:`side_centre`, K9 on the
    magnitudes for the MAD, :func:`side_scale`; the rFFT diagnostic the
    same with an all-False mask and the NaN-line flags.  Each step is its
    kernel on the card and its plain version on the CPU.
    :func:`scaled_sides` takes it on lines past the cluster kernel's
    capacity (:func:`scaled_sides_route` ``"long"``)."""
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


def _sides_lines(nb: int, nsub: int, nchan: int, axis: int):
    """K3's line addressing of (nb, nsub, nchan) planes along ``axis``:
    ``(n, nlines, line_stride, elem_stride, lpa, archive_stride)``, line
    l of ``n`` entries ``elem_stride`` apart starting at (l / lpa) *
    archive_stride + (l % lpa) * line_stride (``scaled_sides.cu``)."""
    if axis == 0:
        return nsub, nb * nchan, 1, nchan, nchan, nsub * nchan
    return nchan, nb * nsub, nchan, 1, nb * nsub, 0


def _check_sides(diagnostics, cell_mask):
    """The planes' real dtype, batch and (nsub, nchan), checked."""
    batched = cell_mask.dim() == 3
    nb = cell_mask.shape[0] if batched else 1
    nsub, nchan = cell_mask.shape[-2:]
    lead = (nb,) if batched else ()
    real = _real_of(*diagnostics)
    for i, d in enumerate(diagnostics):
        _require(d, f"diagnostics[{i}]", real, lead + (nsub, nchan))
    _require(cell_mask, "cell_mask", torch.bool, lead + (nsub, nchan))
    return real, nb, nsub, nchan


def scaled_sides_cluster(diagnostics, cell_mask, axis, thresh):
    """K3's function on lines over one block (:func:`scaled_sides_route`
    ``"cluster"``), one thread-block cluster a line: the cluster kernel
    on the card (its plan :func:`scaled_sides_cluster_geometry`; a batch
    of (B, nsub, nchan) planes in one launch, read in place), a
    ``ValueError`` on lines past its capacity; :func:`scaled_sides_plain`
    on the CPU.  Bit-equal to K3 and to the plain version.  A launch the
    card refuses, or a cluster it cannot schedule, raises."""
    if axis not in (0, 1):
        raise ValueError("axis must be 0 or 1")
    if not _on_card(*diagnostics, cell_mask):
        return scaled_sides_plain(diagnostics, cell_mask, axis, thresh)
    real, nb, nsub, nchan = _check_sides(diagnostics, cell_mask)
    n, nlines, line_stride, elem_stride, lpa, archive_stride = \
        _sides_lines(nb, nsub, nchan, axis)
    plan = scaled_sides_cluster_geometry(n, axis, _key_bytes(real))
    outs = [torch.empty_like(diagnostics[0]) for _ in range(4)]
    lib = load_library()
    with torch.cuda.device(cell_mask.device):
        rc = lib.icln_sides_cluster(
            *(_ptr(d) for d in diagnostics), _ptr(cell_mask),
            *(_ptr(o) for o in outs), n, plan.slice, nlines, line_stride,
            elem_stride, lpa, archive_stride, _inv_thresh(thresh, real),
            plan.cluster, plan.lines, plan.diags, plan.threads, plan.smem,
            int(real == torch.float64), _stream(cell_mask))
    if real == torch.float64:
        scaled_sides_cluster.launches_f64[axis] += 1
    else:
        scaled_sides_cluster.launches[axis] += 1
    _check_rc(rc, f"scaled_sides_cluster(axis={axis})")
    return tuple(outs)


scaled_sides_cluster.launches = [0, 0]
scaled_sides_cluster.launches_f64 = [0, 0]


def scaled_sides(diagnostics, cell_mask, axis, thresh):
    """All four scaled sides of one orientation: ``axis=0`` scales each
    channel down the subints (channel threshold), ``axis=1`` each subint
    across channels.  On the card by :func:`scaled_sides_route`: kernel
    K3 where a line fits a block, :func:`scaled_sides_cluster` where it
    fits a cluster of blocks, :func:`scaled_sides_long` above;
    :func:`scaled_sides_plain` on the CPU.  Bit-equal to the reference's
    ``scaled_sides_pallas``.  A batch of (B, nsub, nchan) planes is one
    launch of K3 or the cluster kernel: along axis 1 its B * nsub rows,
    along axis 0 its B * nchan columns, each archive's read in place
    through K3's per-archive stride (no transposed copy); lines past a
    cluster take :func:`scaled_sides_long` archive by archive."""
    if axis not in (0, 1):
        raise ValueError("axis must be 0 or 1")
    if not _on_card(*diagnostics, cell_mask):
        return scaled_sides_plain(diagnostics, cell_mask, axis, thresh)
    real, nb, nsub, nchan = _check_sides(diagnostics, cell_mask)
    n, nlines, line_stride, elem_stride, lpa, archive_stride = \
        _sides_lines(nb, nsub, nchan, axis)
    route = scaled_sides_route(n, real)
    if route == "cluster":
        return scaled_sides_cluster(diagnostics, cell_mask, axis, thresh)
    if route == "long":
        if cell_mask.dim() == 2:
            return scaled_sides_long(diagnostics, cell_mask, axis, thresh)
        return _stack_each(
            lambda *a: scaled_sides_long(a[:4], a[4], axis, thresh), nb,
            *((d, True) for d in diagnostics), (cell_mask, True))
    plan = scaled_sides_geometry(n, axis, _key_bytes(real))
    outs = [torch.empty_like(diagnostics[0]) for _ in range(4)]
    lib = load_library()
    with torch.cuda.device(cell_mask.device):
        rc = lib.icln_scaled_sides(
            *(_ptr(d) for d in diagnostics), _ptr(cell_mask),
            *(_ptr(o) for o in outs), n, nlines, line_stride, elem_stride,
            lpa, archive_stride, _inv_thresh(thresh, real), plan.lines,
            plan.diags, plan.threads, plan.smem, int(real == torch.float64),
            _stream(cell_mask))
    if real == torch.float64:
        scaled_sides.launches_f64[axis] += 1
    else:
        scaled_sides.launches[axis] += 1
    _check_rc(rc, f"scaled_sides(axis={axis})")
    return tuple(outs)


scaled_sides.launches = [0, 0]
scaled_sides.launches_f64 = [0, 0]


# --------------------------------------------------------------------------
# combine: max of sides -> 4-way median -> zap
# --------------------------------------------------------------------------

def median4_keys(a, b, c, d):
    """``np.median`` of four planes elementwise, as the reference's
    ``_median4``: min/max network on ordered keys, ``lo*0.5 + hi*0.5``,
    NaN wherever any input is NaN; float32 or float64 planes."""
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
    :func:`combine_zap_plain` on the CPU; elementwise, so a batch's (B,
    nsub, nchan) planes are one launch over their cells."""
    if not _on_card(*chan_sides, *sub_sides, orig_weights):
        return combine_zap_plain(chan_sides, sub_sides, orig_weights)
    shape = tuple(orig_weights.shape)
    real = _real_of(*chan_sides, *sub_sides, orig_weights)
    for i, p in enumerate((*chan_sides, *sub_sides, orig_weights)):
        _require(p, f"plane {i}", real, shape)
    new_w = torch.empty_like(orig_weights)
    scores = torch.empty_like(orig_weights)
    lib = load_library()
    with torch.cuda.device(orig_weights.device):
        rc = lib.icln_combine_zap(
            *(_ptr(p) for p in chan_sides), *(_ptr(p) for p in sub_sides),
            _ptr(orig_weights), _ptr(new_w), _ptr(scores),
            orig_weights.numel(), int(real == torch.float64),
            _stream(orig_weights))
    _count(combine_zap, orig_weights)
    _check_rc(rc, "combine_zap")
    return new_w, scores


combine_zap.launches = 0
combine_zap.launches_f64 = 0


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
    # one sequence of the three launches above
    _count(fused_combine, orig_weights)
    return out


fused_combine.launches = 0
fused_combine.launches_f64 = 0


_CUBE_WRAPPERS = (weighted_marginals, cell_diagnostics_disp,
                  cell_diagnostics_two_read, cell_diagnostics_dedisp,
                  shard_diagnostics_disp, shard_diagnostics_dedisp)
# the wrappers with FFT builds past the DFT tables (cell_fft.cu and
# cell_fft_global.cu), their float32, bf16 and float64 launches counted
# apart
_FFT_WRAPPERS = _CUBE_WRAPPERS[1:]


# the wrappers with a float64 build
_F64_WRAPPERS = (weighted_marginals, cell_diagnostics_disp,
                 cell_diagnostics_two_read, cell_diagnostics_dedisp,
                 shard_diagnostics_disp, shard_diagnostics_dedisp,
                 combine_zap, fused_combine, masked_median, side_centre,
                 side_scale)


def reset_launch_counts() -> None:
    for fn in _CUBE_WRAPPERS:
        fn.launches = fn.launches_bf16 = 0
    for fn in _F64_WRAPPERS:
        fn.launches = fn.launches_f64 = 0
    for fn in _FFT_WRAPPERS:
        for route in ("fft", "fftg"):
            for sfx in ("", "_bf16", "_f64"):
                setattr(fn, f"launches_{route}{sfx}", 0)
    for fn in (scaled_sides, scaled_sides_cluster):
        fn.launches = [0, 0]
        fn.launches_f64 = [0, 0]


reset_launch_counts()


def launch_counts() -> dict:
    """Every wrapper's launches, the cube kernels' bf16 builds as
    ``<name>_bf16``, the float64 builds as ``<name>_f64`` and the cell
    diagnostics' FFT builds as ``<name>_fft``, ``<name>_fft_bf16`` and
    ``<name>_fft_f64`` (K2f) and ``<name>_fftg``, ``<name>_fftg_bf16`` and
    ``<name>_fftg_f64`` (K2g)."""
    return {
        **{fn.__name__: fn.launches for fn in _CUBE_WRAPPERS},
        "scaled_sides_axis0": scaled_sides.launches[0],
        "scaled_sides_axis1": scaled_sides.launches[1],
        "scaled_sides_cluster_axis0": scaled_sides_cluster.launches[0],
        "scaled_sides_cluster_axis1": scaled_sides_cluster.launches[1],
        "combine_zap": combine_zap.launches,
        "fused_combine": fused_combine.launches,
        "masked_median": masked_median.launches,
        "side_centre": side_centre.launches,
        "side_scale": side_scale.launches,
        **{fn.__name__ + "_bf16": fn.launches_bf16 for fn in _CUBE_WRAPPERS},
        **{fn.__name__ + "_f64": fn.launches_f64 for fn in _F64_WRAPPERS
           if fn not in (side_centre, side_scale)},
        "scaled_sides_axis0_f64": scaled_sides.launches_f64[0],
        "scaled_sides_axis1_f64": scaled_sides.launches_f64[1],
        **{f"scaled_sides_cluster_axis{a}_f64":
           scaled_sides_cluster.launches_f64[a] for a in (0, 1)},
        "side_centre_f64": side_centre.launches_f64,
        "side_scale_f64": side_scale.launches_f64,
        **{f"{fn.__name__}_{route}{sfx}":
           getattr(fn, f"launches_{route}{sfx}")
           for route in ("fft", "fftg") for fn in _FFT_WRAPPERS
           for sfx in ("", "_bf16", "_f64")},
    }
