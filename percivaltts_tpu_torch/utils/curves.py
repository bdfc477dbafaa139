"""Training-curve plotting (the port's copy of
``percivaltts_tpu/utils/curves.py``).

The JSONL metrics log is the record (crash-safe, machine-readable); this
module renders its epoch records to a PNG on demand (``cli plot``) with
matplotlib's Agg backend, imported when a plot is drawn.
"""

from __future__ import annotations

import os
from typing import Optional

from percivaltts_tpu_torch.utils.logging import read_metrics


def plot_curves(metrics_path: str, out_path: Optional[str] = None) -> str:
    """Render epoch loss/validation curves from a metrics.jsonl file."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("plotting the training curves needs matplotlib; install it, or "
                          f"read {metrics_path} with utils.logging.read_metrics") from e

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    epochs = read_metrics(metrics_path, kind="epoch")
    if not epochs:
        raise ValueError(f"{metrics_path}: no epoch records to plot")
    out_path = out_path or os.path.join(
        os.path.dirname(metrics_path) or ".", "curves.png"
    )

    xs = [e["epoch"] for e in epochs]
    fig, axes = plt.subplots(1, 2, figsize=(11, 4))

    ax = axes[0]
    for key, label in (("loss", "train loss"), ("valid", "validation cost")):
        ys = [e.get(key) for e in epochs]
        if any(y is not None and y == y for y in ys):
            ax.plot(xs, ys, label=label)
    ax.set_xlabel("epoch")
    ax.set_ylabel("cost")
    ax.legend()
    ax.grid(alpha=0.3)

    ax = axes[1]
    plotted = False
    for key in ("w_dist", "gp", "lse", "gen_adv"):
        ys = [e.get(key) for e in epochs]
        if any(y is not None for y in ys):
            ax.plot(xs, ys, label=key)
            plotted = True
    if plotted:
        ax.set_xlabel("epoch")
        ax.set_ylabel("WGAN terms")
        ax.legend()
        ax.grid(alpha=0.3)
    else:
        ax.axis("off")

    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path
