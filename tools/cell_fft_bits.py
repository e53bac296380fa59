"""Hold the FFT builds of two trees of the package bit for bit on the
card: the cluster build (``cell_fft.cu``, K2f) and the split rows of the
device-memory build (``cell_fft_global.cu``, K2g).

    python tools/cell_fft_bits.py TREE_A TREE_B

Each tree runs in a process of its own (``PYTHONPATH=<tree>``, its own
kernel library built into its own ``_build/``) through the routed
wrappers of K2 with and without the Nyquist term, K7 and K6, on fixed
operands made with numpy (seed the profile's length: normal noise, a
Gaussian pulse, 15% of the weights zero), at the shapes whose routes
both trees take with K2f (clusters of 8, 4 and 2 blocks and the
radix-3 and radix-5 stages, in float32, bf16 storage and float64) and
with K2g's split row (chip_smoke.py's (L5a) and (L5c) archives' shapes
in float32, and at small width in bf16 and float64).  It
prints how many of the planes differ in any bit, and the card's name and
power limit; exits 1 where any does.  Needs a CUDA device.
"""

import os
import subprocess
import sys
import tempfile

import numpy as np

# (storage, nsub, nchan, nbin): clusters of 8 and 4 blocks, the radix-3
# and radix-5 stages, bf16, float64's cluster of 2 and radix-3 stage
SHAPES = (("float32", 8, 32, 65536), ("float32", 16, 64, 32768),
          ("float32", 8, 32, 24576), ("float32", 8, 32, 20480),
          ("bfloat16", 8, 32, 65536), ("float64", 16, 64, 16384),
          ("float64", 8, 32, 24576))
# K2g's split rows: (L5a) 32 x 256 x 60000 and (L5c) 16 x 64 x 524288 in
# float32, and at small width in bf16 and float64 (46,656 = 2^6 3^6: six
# odd stages, past float64's five)
SPLIT_SHAPES = (("float32", 32, 256, 60000), ("float32", 16, 64, 524288),
                ("bfloat16", 4, 16, 60000), ("bfloat16", 2, 8, 524288),
                ("float64", 4, 16, 46656), ("float64", 2, 8, 262144))


def planes(out):
    """K2f's and K2g's split-row planes of every form and shape, saved
    to ``out`` (.npz), in the tree on ``sys.path``."""
    import torch

    from iterative_cleaner_torch.stats import kernels as K

    dev = torch.device("cuda")
    res = {}
    for storage, nsub, nchan, nbin in SHAPES + SPLIT_SHAPES:
        rng = np.random.default_rng(nbin)
        real = torch.float64 if storage == "float64" else torch.float32
        t = np.exp(-0.5 * ((np.arange(nbin) - nbin / 3) / (nbin / 64)) ** 2)
        cube = rng.standard_normal((nsub, nchan, nbin)) + 3.0 * t
        rot = np.stack([np.roll(t, 5 * c) for c in range(nchan)])
        nyq = rng.standard_normal((nchan, nbin)) * 1e-3
        w = rng.random((nsub, nchan))
        w[w < 0.15] = 0.0
        win = np.ones(nbin)
        win[nbin // 4: nbin // 3] = 0.5

        def up(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev, real)

        c = up(cube).to(getattr(torch, storage))
        b = (up(cube) * 0.5).to(c.dtype)
        r, n, tt, wt, wn = up(rot), up(nyq), up(t), up(w), up(win)
        m = wt == 0
        route = K.cell_stats_route(nbin, c.element_size())
        if (storage, nsub, nchan, nbin) in SHAPES and route != "fft":
            raise SystemExit(f"{nbin} bins of {storage}: not K2f's route")
        if (storage, nsub, nchan, nbin) in SPLIT_SHAPES and (
                route != "fft_global" or K.cell_fft_global_plan(
                    nbin, c.element_size()).mode != "split"):
            raise SystemExit(f"{nbin} bins of {storage}: not K2g's split")
        for form, got in (
                ("disp", K.cell_diagnostics_disp(c, r, n, tt, wt, m)),
                ("disp_no_nyquist",
                 K.cell_diagnostics_disp(c, r, None, tt, wt, m)),
                ("two_read", K.cell_diagnostics_two_read(c, b, r, tt, wt, m)),
                ("dedisp", K.cell_diagnostics_dedisp(c, tt, wn, wt, m))):
            for i, p in enumerate(got):
                build = "K2f" if route == "fft" else "K2g"
                res[f"{build}_{storage}_{nsub}x{nchan}x{nbin}_{form}_{i}"] \
                    = p.cpu().numpy()
        del c, b
    np.savez(out, **res)


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--planes":
        planes(sys.argv[2])
        return 0
    if len(sys.argv) != 3:
        raise SystemExit(__doc__)
    with tempfile.TemporaryDirectory() as tmp:
        saved = []
        for k, tree in enumerate(sys.argv[1:]):
            out = os.path.join(tmp, f"tree{k}.npz")
            env = dict(os.environ, PYTHONPATH=os.path.abspath(tree))
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--planes", out], env=env, check=True,
                           cwd=os.path.abspath(tree))
            saved.append(np.load(out))
        a, b = saved
        bad = [k for k in a.files if k not in b.files
               or not np.array_equal(a[k].view(np.uint8), b[k].view(np.uint8))]
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True
        ).stdout.strip()
        for build, what in (("K2f_", "K2f"), ("K2g_", "K2g split")):
            keys = [k for k in a.files if k.startswith(build)]
            print(f"{what} planes of {sys.argv[1]} and {sys.argv[2]}: "
                  f"{len(keys)} compared, "
                  f"{sum(k in bad for k in keys)} differ in bits "
                  f"{[k for k in bad if k in keys][:5]} [{card}]")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
