"""Hold the cluster FFT build (``cell_fft.cu``, K2f) of two trees of the
package bit for bit on the card.

    python tools/cell_fft_bits.py TREE_A TREE_B

Each tree runs in a process of its own (``PYTHONPATH=<tree>``, its own
kernel library built into its own ``_build/``) through the routed
wrappers of K2 with and without the Nyquist term, K7 and K6, on fixed
operands made with numpy (seed the profile's length: normal noise, a
Gaussian pulse, 15% of the weights zero), at the shapes whose routes
both trees take with K2f: clusters of 8, 4 and 2 blocks and the
radix-3 and radix-5 stages, in float32, bf16 storage and float64.  It
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


def planes(out):
    """K2f's planes of every form and shape, saved to ``out`` (.npz), in
    the tree on ``sys.path``."""
    import torch

    from iterative_cleaner_torch.stats import kernels as K

    dev = torch.device("cuda")
    res = {}
    for storage, nsub, nchan, nbin in SHAPES:
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
        if K.cell_stats_route(nbin, c.element_size()) != "fft":
            raise SystemExit(f"{nbin} bins of {storage}: not K2f's route")
        for form, got in (
                ("disp", K.cell_diagnostics_disp(c, r, n, tt, wt, m)),
                ("disp_no_nyquist",
                 K.cell_diagnostics_disp(c, r, None, tt, wt, m)),
                ("two_read", K.cell_diagnostics_two_read(c, b, r, tt, wt, m)),
                ("dedisp", K.cell_diagnostics_dedisp(c, tt, wn, wt, m))):
            for i, p in enumerate(got):
                res[f"{storage}_{nsub}x{nchan}x{nbin}_{form}_{i}"] = \
                    p.cpu().numpy()
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
        print(f"K2f planes of {sys.argv[1]} and {sys.argv[2]}: {len(a.files)} "
              f"compared, {len(bad)} differ in bits {bad[:5]} [{card}]")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
