"""The ``-z`` zap plot: the cleaned archive's zap scores as an image.

matplotlib is imported when a plot is drawn, not with the module: the
cleaner does not need it otherwise, and where it is missing ``-z``
raises ``ImportError`` naming it."""

from __future__ import annotations

import numpy as np


def save_zap_plot(scores: np.ndarray, ar_name: str, chanthresh: float,
                  subintthresh: float) -> str:
    """The original cleaner's presentation: coolwarm with vmin/vmax
    pinched around the zap threshold (red zapped, blue kept), the y axis
    inverted, the thresholds in the title, saved as
    ``<name>_<cthresh>_<sthresh>.png`` in the working directory; returns
    that name."""
    try:
        import matplotlib
    except ImportError as exc:
        raise ImportError("-z/--print_zap draws its plot with matplotlib, "
                          "which is not installed") from exc

    matplotlib.use("Agg")
    import matplotlib.cm as cm
    import matplotlib.pyplot as plt

    plt.imshow(scores.T, vmin=0.999, vmax=1.001, aspect="auto",
               interpolation="nearest", cmap=cm.coolwarm)
    plt.gca().invert_yaxis()
    plt.title("%s cthresh=%s sthresh=%s" % (ar_name, chanthresh, subintthresh))
    out = "%s_%s_%s.png" % (ar_name, chanthresh, subintthresh)
    plt.savefig(out, bbox_inches="tight")
    plt.close()
    return out
